"""Batched device NFA: chain lowering, slot/capture layout, block runner.

Port of `siddhi_tpu/core/nfa_device.py`: every chain its device block
lowers, for the `seq` and `chunk` families (K2 over persistent slot
state, or over a flush's own-chunks from fresh state: `_expand_flat`
and its replay dedup) and, where the plan picks them, `scan` and `dfa`:

  * chains of positions joined by `->` (pattern) or `,` (sequence
    strictness), an `every` head or a one-shot head, a query-level or
    per-position `within`, one or several input streams;
  * count quantifiers `<m:n>`, `<m:>`, `+` anywhere in the chain (the
    epsilon cascade of min-0 counts, `_landing_from`), adjacent counts, a
    count in the final position (every collection at or past min emits;
    emissions of a still-collecting slot leave through the E direct-emit
    lanes, and a burst wider than E raises `of_lanes`, which the plan
    answers by doubling E and re-running the block);
  * logical `and`/`or` positions, at the head, below it or in a
    sequence; an `or` leaves the loser NULL; a side may be absent (`not A
    and e2=B`, `not A for T or e2=B`): an `and` dies when the absent side
    arrives, an `or` disarms that side's deadline, and a side's deadline
    passage advances the pair;
  * absent positions (`not B[...] for T`): entering one arms a deadline,
    a forbidden arrival kills the partial match, and a deadline at or
    before an event's (or a timer tick's) timestamp fires before that
    event is processed, advancing the slot -- a completion then carries
    the deadline as its timestamp;
  * init slots (`ChainSpec.needs_init_slot`: an absent head, a logical
    head with an absent side, a min-0 count head): each lane arms slot 0
    on its first event (an unpartitioned plan also on a timer tick, at
    the plan's START anchor `__anchor__`), with `first_ts = NO_FIRST`
    until the first capture stamps it;
  * slot forking (`_fork_slots`) for `every` below the head: an `every`
    absent (the deadline forks a clone that advances, the standing arm
    re-arms one period later; an arrival re-arms it) and an `every`
    stream position (a clone advances with the capture, the slot stays a
    standing arm); clones that find no free slot count in `of_slots`, and
    the plan grows A and re-runs the block;
  * indexed captures `e[i]`, `e[last]`, `e[last-1]`, with per-index
    presence rows for indices a match may leave unfilled, presence rows
    for every maybe-absent ref a selector reads (the host turns a zero
    presence into a NULL column value), and `e1 is null` / `e1[i] is
    null` as a read of such a row in a selector, `having` or a later
    position's filter;
  * fused multi-query lanes (core/multi_query.py): the partition axis
    holds query instances, events arrive as broadcast (T, 1) grids, lifted
    constants are per-lane parameters and every match carries its lane's
    `__qid__`;
  * event-only conjuncts run over the whole (T, P) grid (K1 pre-masks),
    capture-dependent conjuncts per slot and step (inside K2);
  * selectors and `having` over captures run on the compacted match rows
    (K1 again).

The JAX device block refuses some shapes and sends them to its host
matcher; so does this one: they raise DeviceNFAUnsupported naming the
host matcher -- `e[last-2]` and beyond, selectors deriving a value from a
maybe-absent ref, NULL routing in a fused group, and the JAX refusals of
`lower_chain` (`every` around a logical or count below the head or around
an absent-logical or optional-count head, an optional-count run landing
on a non-stream state).  `core/build.py` plans such a query on the host
matcher (`interp/engine.py` InterpPatternQueryPlan) with a RuntimeWarning
under `@app:devicePatterns('auto')` or `'prefer'`, and lets the refusal
raise under `'always'`.

Precision (`f64`, `@app:devicePrecision('f64')`; the JAX package's
`NFAKernel(..., f64=True)`): DOUBLE travels, computes, captures and
emits in float32 by default (`F32_MODE`) and in float64 under f64.
FLOAT stays float32 in both modes, so under f64 the one `f` capture
group holds widened FLOAT rows beside DOUBLE rows, as `caps_f` does in
the JAX package; a program reads a FLOAT row as a float64 load cast back
to float32 (exact: the value was a widened float32).

State (a dict of tensors, partition axis P minor, as in the JAX package):
  occ (A, P) i32        0 = free, p = stationed at position p-1,
                        S+1 = parked completion awaiting a drain lane
  first_ts (A, P) i32   head timestamp offset (the `within` anchor)
  head_seq (A, P) i32   head seq offset (emission tie order)
  cnt (Kc, A, P) i32    occurrence counters (count positions)
  cnt_on (Kc, A, P) bool still collecting
  narm (Kc, A, P) bool  successor armed (set at the exact min crossing,
                        consumed by the successor's match)
  fl (Kl, A, P) i32     logical fill bits (1 = left side, 2 = right)
  caps_f (Kf, A, P) f32 (f64 under f64), caps_i (Ki, A, P) i32,
  caps_l (Kl', A, P) i64
                        capture rows (only the columns something reads);
                        caps_i also holds presence rows and the parked
                        completion's ts/seq
  dl (Ka, A, P) i32     absent deadlines, one row per absent node with a
                        waiting time, in position and node order
                        (NO_DEADLINE = disarmed)
  armed0 (P,) bool      entry arm (stays True for `every`)
  of_slots (P,) i32     heads dropped for want of a free slot
  of_lanes (P,) i32     direct emissions that found no lane (E too narrow)
  init (P,) bool        the lane's init slot is armed (init-slot chains
                        only)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..query import ast
from .expr import (F32_MODE, VT_BOOL, VT_F32, VT_F64, VT_OF_TORCH,
                   CompiledExpr, ExprError, LaneParams, MultiStreamContext,
                   Node, compile_expression, compute_dtypes, emit_program,
                   subst, timestamp_node, torch_dtype)
from .planner import PlanError
from .schema import StringTable, dtype_of

LOCAL_SPAN = 1 << 30            # i32 offset budget (rebase before overflow)
NO_FIRST = LOCAL_SPAN           # first_ts sentinel of init slots
NO_DEADLINE = 2 ** 31 - 1       # dl sentinel: no deadline armed
UNBOUNDED = 10 ** 9             # NFACompiler's normalization of <m:> counts
MAX_NODES = 32                  # nodes of one chain (K2's match bit words)
MAX_COUNTS = 32                 # count positions (K2's per-slot bit words)
MAX_LOGICALS = 16               # logical positions (2 fill bits each)

# kinds of a position in K2's tables
K_STREAM, K_ABSENT, K_COUNT, K_LOGICAL = range(4)
# capture-write modes: the value written into a row when a node captures
W_SRC, W_ONE, W_PREV, W_IDX, W_PRES_GE = range(5)


class DeviceNFAUnsupported(PlanError):
    """A pattern shape outside the device algebra."""


HOST_MATCHER = (" (the host matcher runs it: interp/engine.py "
                "InterpPatternQueryPlan)")


class PatternFilterContext(MultiStreamContext):
    """Unqualified attributes in a state's filter resolve to the state's
    own (arriving) event first."""

    def __init__(self, schemas: dict, strings, own_ref: str):
        super().__init__(schemas, strings)
        self.own_ref = own_ref

    def resolve(self, var: ast.Variable):
        if var.stream_ref is None and var.index is None \
                and var.attribute in self.schemas[self.own_ref].types:
            return (f"{self.own_ref}.{var.attribute}",
                    self.schemas[self.own_ref].type_of(var.attribute))
        return super().resolve(var)


@dataclass
class PNode:
    """One state of the chain: its stream and its conjuncts."""
    ref: str
    stream_id: str
    scode: int
    kind: str = "stream"                            # "stream" | "absent"
    waiting_ms: Optional[int] = None                # absent `for T`
    pre_conjs: list = field(default_factory=list)   # event-only -> (T, P)
    step_conjs: list = field(default_factory=list)  # capture-referencing
    step_asts: list = field(default_factory=list)   # raw AST per step conj
    #   (parallel to step_conjs; nfa_parallel lowers monotone comparisons
    #   over earlier captures into segment-tree threshold hops)


@dataclass
class Position:
    """One chain position: a single state, a count, or a logical pair."""
    nodes: list                     # [PNode] (2 for logical)
    op: Optional[str] = None        # None | "and" | "or"
    min_count: int = 1
    max_count: int = 1
    within_ms: Optional[int] = None
    sticky: bool = False            # `every` arm (head or below it)
    # state-row assignments (set by the kernel)
    cnt_row: Optional[int] = None   # counter row (count positions)
    log_row: Optional[int] = None   # fill-bit row (logical positions)
    dl_rows: Optional[dict] = None  # node index -> deadline row (absent
    #                                 nodes with `for`)

    @property
    def node(self) -> PNode:
        return self.nodes[0]

    @property
    def is_count(self) -> bool:
        return (self.min_count, self.max_count) != (1, 1)

    @property
    def refs(self) -> list:
        return [n.ref for n in self.nodes]


@dataclass
class ChainSpec:
    positions: list
    stream_ids: list                # distinct stream ids, scode order
    schemas: dict                   # ref -> StreamSchema
    is_sequence: bool
    every_head: bool

    @property
    def S(self) -> int:
        return len(self.positions)

    @property
    def all_nodes(self) -> list:
        return [n for p in self.positions for n in p.nodes]

    def maybe_absent_refs(self) -> set:
        """Refs that can be NULL in an emitted match: or-sides, absent
        nodes and min-0 counts."""
        out = set()
        for p in self.positions:
            if p.op is not None:
                out.update(p.refs)
            if p.is_count and p.min_count == 0:
                out.update(p.refs)
            for n in p.nodes:
                if n.kind == "absent":
                    out.add(n.ref)
        return out

    @property
    def needs_init_slot(self) -> bool:
        """An absent head or a min-0 count head pre-registers a partial
        match before any event (the JAX package's init slot)."""
        head = self.positions[0]
        return (any(n.kind == "absent" for n in head.nodes)
                or (head.is_count and head.min_count == 0))


def _conjuncts(e: ast.Expression) -> list:
    if isinstance(e, ast.And):
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def lower_chain(state_input, schemas_by_stream: dict, strings: StringTable,
                filters_by_node: list,
                param_extra: Optional[dict] = None) -> ChainSpec:
    """Validate + lower a StateInputStream into a device position chain
    (siddhi_tpu/core/nfa_device.py:209), logical partners grouped into
    one position.  `param_extra` resolves a fused group's `__qparam<i>`
    variables."""
    from ..interp.nfa import NFACompiler
    from ..query.ast import StateType

    comp = NFACompiler()
    entries, _exits = comp.lower(state_input.state)
    nodes = comp.nodes
    is_sequence = state_input.type == StateType.SEQUENCE
    qw = state_input.within.millis if state_input.within else None
    if len(entries) == 1:
        head_ids = [entries[0].id]
    elif len(entries) == 2 and entries[0].partner_id == entries[1].id:
        head_ids = [entries[0].id, entries[1].id]
    else:
        raise DeviceNFAUnsupported("unsupported entry structure")

    stream_ids, scode_of = [], {}

    def scode(sid: str) -> int:
        if sid not in schemas_by_stream:
            raise DeviceNFAUnsupported(f"unknown stream {sid!r}")
        if sid not in scode_of:
            scode_of[sid] = len(stream_ids)
            stream_ids.append(sid)
        return scode_of[sid]

    positions: list = []
    seen: set = set()
    cur = head_ids
    while cur:
        n0 = nodes[cur[0]]
        group = [n0] + ([nodes[n0.partner_id]] if n0.partner_id is not None
                        else [])
        for g in group:
            if g.id in seen:
                raise DeviceNFAUnsupported("cyclic state graph")
            seen.add(g.id)
        pos = Position([PNode(g.ref, g.stream_id, scode(g.stream_id), g.kind,
                              g.waiting_ms) for g in group])
        if n0.partner_id is not None:
            pos.op = n0.partner_op
        pos.min_count, pos.max_count = n0.min_count, n0.max_count
        w = n0.within_ms if n0.within_ms is not None else qw
        if w is not None and w >= LOCAL_SPAN:
            raise DeviceNFAUnsupported("within > ~12 days (i32 ms offsets)")
        pos.within_ms = w
        pos.sticky = bool(n0.sticky)
        positions.append(pos)
        cur = [n0.next_id] if n0.next_id is not None else []
    if len(seen) != len(nodes):
        raise DeviceNFAUnsupported("non-linear state graph")

    # the JAX package's support matrix (nfa_device.py:278-310), word for
    # word; its host matcher runs these shapes
    S = len(positions)
    for i, pos in enumerate(positions):
        if pos.sticky and i != 0 and (pos.op is not None or pos.is_count):
            raise DeviceNFAUnsupported(
                "`every`-wrapped logical/count state below the head"
                + HOST_MATCHER)
        if pos.sticky and i == 0 and (
                (pos.op is not None
                 and any(n.kind == "absent" for n in pos.nodes))
                or (pos.is_count and pos.min_count == 0)):
            raise DeviceNFAUnsupported(
                "`every`-wrapped absent-logical or optional-count head"
                + HOST_MATCHER)
        if pos.min_count == 0 and i > 0 and positions[i - 1].is_count \
                and positions[i - 1].min_count >= 1:
            # an optional-count run after a counting state keeps the
            # station at the counting state with a chained arm; the chain
            # must land on a plain (1,1) stream position
            k = i
            while k < S and positions[k].is_count \
                    and positions[k].min_count == 0:
                k += 1
            if (k >= S or positions[k].is_count
                    or positions[k].op is not None
                    or positions[k].nodes[0].kind == "absent"
                    or positions[k].sticky):
                raise DeviceNFAUnsupported(
                    "optional count run after a counting state landing on "
                    "a non-stream state" + HOST_MATCHER)
    spec = ChainSpec(positions, stream_ids,
                     {n.ref: schemas_by_stream[n.stream_id]
                      for p in positions for n in p.nodes},
                     is_sequence, positions[0].sticky)
    if len(spec.all_nodes) > MAX_NODES:
        raise DeviceNFAUnsupported(f"more than {MAX_NODES} pattern states")

    by_ref = {n.ref: n for n in spec.all_nodes}
    for host_n, elem_filters in zip(nodes, filters_by_node):
        pn = by_ref[host_n.ref]
        conjs: list = []
        for f in elem_filters:
            conjs.extend(_conjuncts(f.expr))
        ctx = PatternFilterContext(spec.schemas, strings, pn.ref)
        if param_extra:
            ctx.extra = dict(param_extra)
        own = {f"{pn.ref}.{a.name}" for a in spec.schemas[pn.ref].attributes}
        own.add("__timestamp__")
        own.update(param_extra or ())
        for c in conjs:
            try:
                ce = compile_expression(c, ctx)
            except ExprError as e:
                raise DeviceNFAUnsupported(f"filter not device-compilable: "
                                           f"{e}") from None
            if ce.type != ast.AttrType.BOOL:
                raise DeviceNFAUnsupported("non-boolean filter")
            if set(ce.reads) <= own:
                pn.pre_conjs.append(ce)
            elif host_n.id in head_ids:
                raise DeviceNFAUnsupported(
                    "head filter references later captures")
            else:
                pn.step_conjs.append(ce)
                pn.step_asts.append(c)
    return spec


def _base_ref(refpart: str):
    """'e1' -> ('e1', None); 'e1[last]' -> ('e1', 'last')."""
    if "[" in refpart and refpart.endswith("]"):
        base, idx = refpart[:-1].split("[", 1)
        return base, idx
    return refpart, None


def _index_want(cidx: str) -> int:
    """Occurrences a count must have collected for index `cidx` to be
    filled: [last] 1, [last-1] 2, [i] i + 1."""
    return 1 if cidx == "last" else 2 if cidx == "last-1" else int(cidx) + 1


def pow2_at_least(n: int, lo: int = 8) -> int:
    return max(lo, 1 << max(0, math.ceil(math.log2(max(1, n)))))


def f64_mode(app) -> bool:
    """Does the app ask for `@app:devicePrecision('f64')`?"""
    prec = ast.find_annotation(app.annotations, "app:devicePrecision")
    return prec is not None and str(prec.element()).lower() == "f64"


def pattern_np_dtype(t: ast.AttrType, f64: bool):
    """Grid and parameter dtype of an attribute on the pattern path:
    DOUBLE travels as float32 unless the plan runs in f64."""
    if t == ast.AttrType.DOUBLE and not f64:
        return np.float32
    return dtype_of(t)


def _and_all(conjs: list) -> Optional[Node]:
    out = None
    for ce in conjs:
        out = ce.node if out is None else \
            Node("and", ast.AttrType.BOOL, (out, ce.node))
    return out


TS_SUBST = {"__timestamp__": timestamp_node("__ts__")}


class NFAKernel:
    """Layout of one chain's device state, grids and output rows, plus the
    block runner: K1 pre-masks -> K2 block -> (host decides retries) ->
    K1 selector/having over the compacted matches.

    A block reads `ev`: "__ts__", "__seq__" (T, G) i32 offsets,
    "__valid__" (T, G) bool, "__tick__" (T, G) bool (timer ticks, when
    present), "__scode__" (T, G) i32 (several streams), one (T, G) grid per
    key of `grid_keys` ("<scode>.<attr>"), and the int base "__base_ts__";
    G is P, or 1 when the events broadcast to every lane (fused
    multi-query lanes).  A chunk block (the `chunk` family; P is its K
    lanes) holds flat (F,) event arrays instead, no `__valid__`, and
    `__chunk__` = (T, CS, nev, prev_seq): lane l reads events [l*CS,
    l*CS + T), arms heads on its first CS, and drops completions at or
    before prev_seq.  It returns the raw match table: `out_i` (rows
    `lane_names_i`, M) i32, `out_f` (rows_f, M) f32, `out_l` (rows_l, M)
    i64, and `meta` = [matches found (may exceed M), heads dropped so far,
    earliest deadline of a live slot (NO_DEADLINE when none), direct
    emissions that found no lane].

    `params` (a LaneParams) holds a fused group's per-lane constants,
    `broadcast` marks its lanes (events shared, a `__qid__` row per
    match), `playback` lets deadlines fire on events as well as on timer
    ticks (the JAX package's `dl_fire` rule), `E` is the number of
    emission lanes per step, and `init_on_tick` lets an init-slot chain
    arm a lane's slot on a timer tick as well as on its first event (an
    unpartitioned plan; its blocks then carry the START anchor as the int
    "__anchor__", the deadline base of the armed slot).  `f64` is the
    plan's precision (see the module docstring): `out_f` and `caps_f` are
    then float64."""

    def __init__(self, spec: ChainSpec, sel_fns: dict,
                 having: Optional[CompiledExpr], P: int, A: int,
                 params: Optional[LaneParams] = None,
                 broadcast: bool = False, playback: bool = False,
                 E: Optional[int] = None, init_on_tick: bool = False,
                 f64: bool = False):
        self.spec = spec
        self.f64 = f64
        self.mode = None if f64 else F32_MODE
        self.fdt = torch.float64 if f64 else torch.float32
        self.sel_fns = sel_fns
        self.having = having
        self.P, self.A = P, A
        self.S = spec.S
        self.E = E if E is not None else (1 if spec.S == 1 else min(A, 2))
        self.params = params
        self.broadcast = broadcast
        self.playback = playback
        self.needs_init = spec.needs_init_slot
        self.init_on_tick = init_on_tick
        kc = kl = ka = 0
        for pos in spec.positions:
            pos.cnt_row = pos.log_row = None
            if pos.is_count:
                pos.cnt_row = kc
                kc += 1
            if pos.op is not None:
                pos.log_row = kl
                kl += 1
            pos.dl_rows = {}
            for ni, n in enumerate(pos.nodes):
                if n.kind == "absent" and n.waiting_ms is not None:
                    pos.dl_rows[ni] = ka
                    ka += 1
        if kc > MAX_COUNTS or kl > MAX_LOGICALS:
            raise DeviceNFAUnsupported(
                f"more than {MAX_COUNTS} count or {MAX_LOGICALS} logical "
                f"positions")
        self.Kc, self.Kl, self.Ka = kc, kl, ka
        self.has_absent = any(n.kind == "absent" for n in spec.all_nodes)
        # the K2 instantiation with init slots, forks and absent sides
        self.ext = self.needs_init or any(
            p.sticky for p in spec.positions[1:]) or any(
            p.op is not None and any(n.kind == "absent" for n in p.nodes)
            for p in spec.positions)
        self._maybe_absent = spec.maybe_absent_refs()

        # ---- capture rows: only the columns something downstream reads
        #      (nfa_device.py:446-534 of the JAX package) -----------------
        cap_keys: set = set()
        for pos in spec.positions:
            for n in pos.nodes:
                for ce in n.step_conjs:
                    for k in ce.reads:
                        if k != "__timestamp__" and "." in k and \
                                k.split(".", 1)[0] != n.ref:
                            cap_keys.add(k)
        sel_rparts: set = set()
        for ce in list(sel_fns.values()) + ([having] if having else []):
            for k in ce.reads:
                if k.startswith("__present__.") or (
                        "." in k and not k.startswith("__")):
                    cap_keys.add(k)
        for ce in sel_fns.values():
            for k in ce.reads:
                if "." in k and not k.startswith("__"):
                    sel_rparts.add(k.split(".", 1)[0])
        sel_refs = {_base_ref(rp)[0] for rp in sel_rparts}
        for r in self._maybe_absent & sel_refs:
            cap_keys.add(f"__present__.{r}")
        for k in cap_keys:
            if k.startswith("__present__."):
                continue
            refpart, _attr = k.split(".", 1)
            base, cidx = _base_ref(refpart)
            if base not in spec.schemas:
                raise DeviceNFAUnsupported(f"unresolvable capture key {k!r}")
            if cidx is not None and cidx not in ("last", "last-1") \
                    and not cidx.isdigit():
                raise DeviceNFAUnsupported(
                    f"indexed capture {k!r} ({cidx!r} beyond [last-1])"
                    + HOST_MATCHER)
        # indexed captures a match may leave UNFILLED (fewer occurrences
        # than the index needs) are NULL at the host: a presence row per
        # such index read by the selector; a predicate or `having` cannot
        # read one (no NULL on the device)
        minc_of = {p.nodes[0].ref: p.min_count
                   for p in spec.positions if p.is_count}
        maybe_unfilled = set()
        for k in cap_keys:
            if k.startswith("__present__."):
                continue
            refpart = k.split(".", 1)[0]
            base, cidx = _base_ref(refpart)
            if cidx is not None and base in minc_of \
                    and _index_want(cidx) > minc_of[base]:
                maybe_unfilled.add(refpart)
        if maybe_unfilled:
            conjs = [c for n_ in spec.all_nodes for c in n_.step_conjs]
            if having is not None:
                conjs.append(having)
            for ce in conjs:
                for k in ce.reads:
                    if "." in k and k.split(".", 1)[0] in maybe_unfilled:
                        raise DeviceNFAUnsupported(
                            f"predicate reads maybe-unfilled indexed "
                            f"capture {k!r}")
        self._maybe_unfilled = maybe_unfilled
        self._unfilled_sel = sorted(maybe_unfilled & sel_rparts)
        for rp in self._unfilled_sel:
            cap_keys.add(f"__present__.{rp}")

        self._key_type: dict = {}
        for k in sorted(cap_keys):
            if k.startswith("__present__."):
                self._key_type[k] = ast.AttrType.BOOL
                continue
            refpart, attr = k.split(".", 1)
            self._key_type[k] = spec.schemas[_base_ref(refpart)[0]].type_of(
                attr)
        with compute_dtypes(self.mode):
            grp = {k: "i" if k.startswith("__present__.") else
                   self._group_of(torch_dtype(t))
                   for k, t in self._key_type.items()}
        self.rows_f = [k for k in sorted(cap_keys) if grp[k] == "f"]
        self.rows_l = [k for k in sorted(cap_keys) if grp[k] == "l"]
        self.rows_i = [k for k in sorted(cap_keys) if grp[k] == "i"]
        head = spec.positions[0]
        self.parked = spec.S > 1 or self.has_absent or head.op is not None \
            or head.is_count
        if self.parked:
            self.rows_i += ["__comp_ts__", "__comp_seq__"]
        self._row_of = {k: ("f", i) for i, k in enumerate(self.rows_f)}
        self._row_of.update({k: ("i", i) for i, k in enumerate(self.rows_i)})
        self._row_of.update({k: ("l", i) for i, k in enumerate(self.rows_l)})

        # selector outputs that may come back NULL: bare variables over a
        # maybe-absent ref or a maybe-unfilled index (anything derived
        # from one would have to evaluate the NULL on the device)
        self.null_outputs: dict = {}     # out name -> ref or indexed refpart
        for name, ce in sel_fns.items():
            rparts = {k.split(".", 1)[0] for k in ce.reads
                      if "." in k and not k.startswith("__")}
            hit = set()
            for rp in rparts:
                base, cidx = _base_ref(rp)
                if cidx is not None:
                    if rp in maybe_unfilled:
                        hit.add(rp)
                elif base in self._maybe_absent:
                    hit.add(base)
            if not hit:
                continue
            if broadcast:
                raise DeviceNFAUnsupported(
                    "fused selector over maybe-absent refs (null routing)"
                    + HOST_MATCHER)
            if ce.is_var and len(hit) == 1:
                self.null_outputs[name] = next(iter(hit))
            else:
                raise DeviceNFAUnsupported(
                    f"selector output {name!r} derives from a maybe-absent "
                    f"ref (only bare variables null-reconstruct)"
                    + HOST_MATCHER)

        self.lane_names_i = list(self.rows_i) + ["__head_seq__"]
        if broadcast:
            self.lane_names_i.append("__qid__")
        # (T, P) grids shipped per block: attrs some predicate or capture
        # row reads (pattern_plan.py _needed_grid_attrs in the JAX package)
        keys: set = set()
        for nd in spec.all_nodes:
            for ce in nd.pre_conjs + nd.step_conjs:
                keys.update(k for k in ce.reads if "." in k)
        keys.update(k for k in self._row_of if not k.startswith("__"))
        ref_scode = {nd.ref: nd.scode for nd in spec.all_nodes}
        grid = set()
        for k in keys:
            refpart, attr = k.split(".", 1)
            ref, _idx = _base_ref(refpart)
            if ref in ref_scode and attr in spec.schemas[ref].types:
                grid.add((ref_scode[ref], attr,
                          spec.schemas[ref].type_of(attr)))
        self.grid_attrs = sorted(grid, key=lambda g: (g[0], g[1]))
        self.grid_keys = [f"{s}.{a}" for s, a, _t in self.grid_attrs]
        if not self.parked:
            self.lane_names_i += ["__comp_ts__", "__comp_seq__"]
        self._build_tables()

        # ---- VM programs ---------------------------------------------------
        C = len(self.grid_keys)
        grid_vt = {k: VT_OF_TORCH[self.grid_dtype(t)]
            for k, (_s, _a, t) in zip(self.grid_keys, self.grid_attrs)}
        fvt = VT_F64 if f64 else VT_F32
        # under f64 a FLOAT capture sits widened in the float64 group: its
        # programs read it as a float64 load cast back to float32
        narrow = {k: Node("cast", ast.AttrType.FLOAT, (Node(
            "var", ast.AttrType.DOUBLE, key=k),)) for k in self.rows_f
            if f64 and self._key_type[k] == ast.AttrType.FLOAT}
        cap_slot = {}
        for k, (g, r) in self._row_of.items():
            if k.startswith("__") and not k.startswith("__present__."):
                continue
            off = {"f": C, "i": C + len(self.rows_f),
                   "l": C + len(self.rows_f) + len(self.rows_i)}[g]
            vt = VT_BOOL if self._key_type[k] == ast.AttrType.BOOL else \
                {"f": fvt, "i": 1, "l": 2}[g]
            cap_slot[k] = (off + r, vt)
        self.ts_slot = C + len(self.rows_f) + len(self.rows_i) + \
            len(self.rows_l)

        def own_slots(n: PNode) -> dict:
            out = {f"{n.ref}.{a.name}": (self.grid_keys.index(gk), grid_vt[gk])
                   for a in spec.schemas[n.ref].attributes
                   for gk in [f"{n.scode}.{a.name}"] if gk in self.grid_keys}
            out["__ts__"] = (self.ts_slot, 1)
            return out

        try:
            with compute_dtypes(self.mode):
                self.pre_progs = []
                for n in spec.all_nodes:
                    tree = _and_all(n.pre_conjs)
                    if tree is not None:
                        tree = subst(tree, TS_SUBST)
                        slots = own_slots(n)
                        slots["__ts__"] = (len(self.grid_keys), 1)
                        self.pre_progs.append(emit_program(tree, slots))
                    else:
                        self.pre_progs.append(None)
                self.step_trees, self.step_progs = [], []
                for n in spec.all_nodes:
                    tree = _and_all(n.step_conjs)
                    if tree is not None:
                        tree = subst(tree, {**TS_SUBST, **narrow})
                        slots = dict(cap_slot)
                        slots.update(own_slots(n))
                        self.step_progs.append(emit_program(tree, slots))
                    else:
                        self.step_progs.append(None)
                    self.step_trees.append(tree)
                # selector / having over the match table: out_i, out_f,
                # out_l rows become K1 columns in that order
                msl = {}
                col = 0
                for k in self.lane_names_i:
                    if k in self._key_type:
                        msl[k] = (col, VT_BOOL if self._key_type[k] ==
                                  ast.AttrType.BOOL else 1)
                    col += 1
                for k in self.rows_f:
                    msl[k] = (col, fvt)
                    col += 1
                for k in self.rows_l:
                    msl[k] = (col, 2)
                    col += 1
                msl["__comp_ts__"] = (self.lane_names_i.index("__comp_ts__"),
                                      1)
                mts = {"__timestamp__": timestamp_node("__comp_ts__"),
                       **narrow}
                self.sel_names = list(sel_fns)
                raw = [ce.node for ce in sel_fns.values()]
                self.sel_progs = [emit_program(subst(t, mts), msl)
                                  for t in raw]
                self.having_prog = None
                if having is not None:
                    h = subst(having.node, dict(zip(self.sel_names, raw)))
                    self.having_prog = emit_program(subst(h, mts), msl)
        except ExprError as e:
            raise DeviceNFAUnsupported(f"not in the device VM: {e}") from None

    # -- capture writes (shared by K2 and its plain version) ---------------

    def capture_values(self, n: PNode) -> list:
        """Rows written when stream node n captures its event
        (`_capture_values`): (key, mode, src, arg) with src a grid column
        index; the plain and [last] columns take the event's value, the
        ref's presence row 1."""
        out = []
        for a in self.spec.schemas[n.ref].attributes:
            gk = f"{n.scode}.{a.name}"
            if gk not in self.grid_keys:
                continue
            for k in (f"{n.ref}.{a.name}", f"{n.ref}[last].{a.name}"):
                if k in self._row_of:
                    out.append((k, W_SRC, self.grid_keys.index(gk), 0))
        pk = f"__present__.{n.ref}"
        if pk in self._row_of:
            out.append((pk, W_ONE, 0, 0))
        return out

    def count_capture_values(self, n: PNode) -> list:
        """Rows written when count node n collects an occurrence
        (`_count_capture_values`): [last-1] takes the old [last] (listed
        first: read before any write), the plain and [last] columns the
        event's value, [i] the event's value when this is occurrence i+1,
        presence 1, and a per-index presence row 1 once the count reaches
        its index."""
        prev, rest = [], []
        for a in self.spec.schemas[n.ref].attributes:
            gk = f"{n.scode}.{a.name}"
            if gk not in self.grid_keys:
                continue
            src = self.grid_keys.index(gk)
            lk, pk = f"{n.ref}[last].{a.name}", f"{n.ref}[last-1].{a.name}"
            if pk in self._row_of and lk in self._row_of:
                prev.append((pk, W_PREV, 0, self._row_of[lk][1]))
            for k in (f"{n.ref}.{a.name}", lk):
                if k in self._row_of:
                    rest.append((k, W_SRC, src, 0))
        pk = f"__present__.{n.ref}"
        if pk in self._row_of:
            rest.append((pk, W_ONE, 0, 0))
        for k in self._row_of:
            if k.startswith("__"):
                continue
            refpart, attr = k.split(".", 1)
            base, cidx = _base_ref(refpart)
            gk = f"{n.scode}.{attr}"
            if base == n.ref and cidx is not None and cidx.isdigit() \
                    and gk in self.grid_keys:
                rest.append((k, W_IDX, self.grid_keys.index(gk),
                             int(cidx) + 1))
        for rp in self._unfilled_sel:
            base, cidx = _base_ref(rp)
            if base == n.ref:
                rest.append((f"__present__.{rp}", W_PRES_GE, 0,
                             _index_want(cidx)))
        return prev + rest

    def presence_rows(self, refs: Optional[set] = None) -> list:
        """caps_i rows of the presence keys (base and per-index) of `refs`
        (every presence row when None): what `_present_zero` clears when a
        slot enters a position or is reused."""
        return [i for i, k in enumerate(self.rows_i)
                if k.startswith("__present__.") and
                (refs is None or _base_ref(k[len("__present__."):])[0]
                 in refs)]

    def landing(self, pi: int) -> int:
        """Station after position pi, skipping mid-chain min-0 counts
        (`_landing_from`): the positions between pi and it are armed on
        the way (never past S-1)."""
        t = pi + 1
        while (t < self.S - 1 and self.spec.positions[t].is_count
               and self.spec.positions[t].min_count == 0):
            t += 1
        return t

    def _build_tables(self) -> None:
        """K2's per-position, per-node and capture-write tables."""
        spec = self.spec
        nodes = spec.all_nodes
        self.node_pos, self.pos_node = [], []
        for pi, pos in enumerate(spec.positions):
            self.pos_node.append(len(self.node_pos))
            self.node_pos.extend([pi] * len(pos.nodes))
        writes: list = []

        def add(entries) -> tuple:
            off = len(writes)
            for key, mode, src, arg in entries:
                g, r = self._row_of[key]
                writes.append(("fil".index(g), r, mode, src, arg))
            return off, len(entries)
        self.node_cw = [add(self.capture_values(n)) for n in nodes]
        self.node_cc = [add(self.count_capture_values(n)) if
                        spec.positions[self.node_pos[gi]].is_count
                        else (0, 0) for gi, n in enumerate(nodes)]
        self.writes = writes
        self.node_pres_row = [
            self._row_of[f"__present__.{n.ref}"][1]
            if f"__present__.{n.ref}" in self._row_of else -1
            for n in nodes]
        pz: list = []
        self.pos_pz = []
        for pos in spec.positions:
            rows = self.presence_rows(set(pos.refs))
            self.pos_pz.append((len(pz), len(rows)))
            pz.extend(rows)
        self.all_pz = (len(pz), len(self.presence_rows()))
        pz.extend(self.presence_rows())
        self.pz_rows = pz

    @staticmethod
    def _group_of(dt) -> str:
        if dt in (torch.float32, torch.float64):
            return "f"
        if dt == torch.int64:
            return "l"
        return "i"

    def np_dtype(self, t: ast.AttrType):
        """Grid dtype: DOUBLE travels as float32 unless the kernel runs
        in f64."""
        return pattern_np_dtype(t, self.f64)

    def grid_dtype(self, t: ast.AttrType) -> torch.dtype:
        """`np_dtype` as a torch dtype."""
        return torch.from_numpy(np.zeros(0, self.np_dtype(t))).dtype

    def with_shape(self, P: int, A: int, E: Optional[int] = None
                   ) -> "NFAKernel":
        """The same chain at another partition/slot count (or E)."""
        return NFAKernel(self.spec, self.sel_fns, self.having, P, A,
                         self.params, self.broadcast, self.playback,
                         self.E if E is None else E, self.init_on_tick,
                         self.f64)

    def comp_rows(self) -> tuple:
        """caps_i rows of the parked completion's ts and seq (-1 when the
        chain emits its head directly)."""
        if not self.parked:
            return -1, -1
        return (self.rows_i.index("__comp_ts__"),
                self.rows_i.index("__comp_seq__"))

    def init_state(self, device) -> dict:
        P, A = self.P, self.A

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)
        # an init-slot chain's state also holds its lanes' `init` flags
        # (the JAX package's layout)
        init = {"init": z((P,), torch.bool)} if self.needs_init else {}
        return {**init, "occ": z((A, P), torch.int32),
                "first_ts": torch.full((A, P), NO_FIRST if self.needs_init
                                       else 0, dtype=torch.int32,
                                       device=device),
                "head_seq": z((A, P), torch.int32),
                "cnt": z((self.Kc, A, P), torch.int32),
                "cnt_on": z((self.Kc, A, P), torch.bool),
                "narm": z((self.Kc, A, P), torch.bool),
                "fl": z((self.Kl, A, P), torch.int32),
                "caps_f": z((len(self.rows_f), A, P), self.fdt),
                "caps_i": z((len(self.rows_i), A, P), torch.int32),
                "caps_l": z((len(self.rows_l), A, P), torch.int64),
                "dl": torch.full((self.Ka, A, P), NO_DEADLINE,
                                 dtype=torch.int32, device=device),
                "armed0": torch.ones((P,), dtype=torch.bool, device=device),
                "of_slots": z((P,), torch.int32),
                "of_lanes": z((P,), torch.int32)}

    # -- the block -----------------------------------------------------------

    def pre_mask_rows(self, ev: dict):
        """K1's row map for the pre-masks: the (T, P) grid; over broadcast
        (T, 1) events row r reads event r // P of lane r % P; over a chunk
        block's flat events (never fused) row r is event r."""
        from ..kernels.expr_eval import RowMap
        if "__chunk__" in ev:
            return None
        if ev["__ts__"].shape[1] == self.P:
            return RowMap(qparams=self.params, lane_mod=self.P)
        return RowMap(col_div=self.P, lane_mod=self.P, qparams=self.params)

    def pre_masks(self, ev: dict) -> list:
        """K1 over the flattened (T*P,) grid, or once over the F flat
        events of a chunk block (each lane's halo reads the same bits):
        one bit-packed mask per chain node with event-only conjuncts (None
        where it has none), every node's program in one launch."""
        n = ev["__ts__"].shape[0] * (1 if "__chunk__" in ev else self.P)
        return pre_mask_words(self.pre_progs, self.pre_mask_cols(ev), n,
                              ev["__base_ts__"], self.pre_mask_rows(ev))

    def pre_mask_cols(self, ev: dict) -> list:
        """K1's input columns for the pre-masks: the flattened grids, then
        the ts grid."""
        return [ev[k].reshape(-1) for k in self.grid_keys] + \
            [ev["__ts__"].reshape(-1)]

    def run_block(self, state: dict, ev: dict, M: int):
        """(state', out) for one (T, P) block; out holds the raw match
        table and meta (see class docstring)."""
        from ..kernels.nfa_block import nfa_block
        return nfa_block(self, state, ev, self.pre_masks(ev), M)

    def select_rows(self, out: dict):
        """K1's row map for the selector: a fused group's match row reads
        the parameters of its `__qid__` lane."""
        from ..kernels.expr_eval import RowMap
        if self.params is None:
            return None
        return RowMap(lane_col=out["out_i"][self.lane_names_i.index(
            "__qid__")], qparams=self.params)

    def select(self, out: dict, n: int, base_ts: int):
        """K1 over the first n match rows: selector columns and the
        `having` mask words (None without having)."""
        from ..kernels.expr_eval import expr_eval
        return expr_eval(self.select_cols(out), self.having_prog,
                         self.sel_progs, n, {"__base_ts__": base_ts},
                         use="select", rows=self.select_rows(out))

    @staticmethod
    def select_cols(out: dict) -> list:
        """K1's input columns for the selector: every match-table row."""
        return [*out["out_i"], *out["out_f"], *out["out_l"]]


def pre_mask_words(progs: list, cols: list, n: int, base_ts,
                   rows=None) -> list:
    """K1 `pre_mask`: every program of `progs` (one per chain node, None
    where a node has no event-only conjunct) over rows [0, n) in ONE
    launch; the word arrays in `progs`' order, None in place."""
    from ..kernels.expr_eval import expr_masks
    live = [p for p in progs if p is not None]
    words = iter(expr_masks(cols, live, n, {"__base_ts__": base_ts},
                            use="pre_mask", rows=rows) if live else ())
    return [None if p is None else next(words) for p in progs]
