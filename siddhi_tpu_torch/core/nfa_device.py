"""Batched device NFA: chain lowering, slot/capture layout, block runner.

Port of `siddhi_tpu/core/nfa_device.py` for the `seq` family and the
pattern algebra of this slice:

  * chains of single-stream positions joined by `->` (pattern) or `,`
    (sequence strictness), an `every` head or a one-shot head, a
    query-level or per-position `within`, one or several input streams;
  * absent positions below the head (`-> not B[...] for T`): entering one
    arms a deadline, a forbidden arrival kills the partial match, and a
    deadline at or before an event's (or a timer tick's) timestamp fires
    before that event is processed, advancing the slot -- a completion
    then carries the deadline as its timestamp;
  * fused multi-query lanes (core/multi_query.py): the partition axis
    holds query instances, events arrive as broadcast (T, 1) grids, lifted
    constants are per-lane parameters and every match carries its lane's
    `__qid__`;
  * event-only conjuncts run over the whole (T, P) grid (K1 pre-masks),
    capture-dependent conjuncts per slot and step (inside K2);
  * selectors and `having` over captures run on the compacted match rows
    (K1 again).

Count quantifiers, logical and/or, absent heads and init slots, `every`
around absent states, `every` below the head, selectors over maybe-absent
refs (presence rows), `@app:devicePrecision('f64')` and presence tests
raise DeviceNFAUnsupported naming the feature; they are later slices.

State (a dict of tensors, partition axis P minor, as in the JAX package):
  occ (A, P) i32        0 = free, p = stationed at position p-1,
                        S+1 = parked completion awaiting a drain lane
  first_ts (A, P) i32   head timestamp offset (the `within` anchor)
  head_seq (A, P) i32   head seq offset (emission tie order)
  caps_f (Kf, A, P) f32, caps_i (Ki, A, P) i32, caps_l (Kl, A, P) i64
                        capture rows (only the columns something reads);
                        caps_i also holds the parked completion's ts/seq
  dl (Ka, A, P) i32     absent deadlines, one row per absent position
                        (NO_DEADLINE = disarmed)
  armed0 (P,) bool      entry arm (stays True for `every`)
  of_slots (P,) i32     heads dropped for want of a free slot
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..query import ast
from .expr import (F32_MODE, VT_BOOL, VT_OF_TORCH, CompiledExpr, ExprError,
                   LaneParams, MultiStreamContext, Node, compile_expression,
                   compute_dtypes, emit_program, subst, timestamp_node,
                   torch_dtype)
from .planner import PlanError
from .schema import StringTable, dtype_of

LOCAL_SPAN = 1 << 30            # i32 offset budget (rebase before overflow)
NO_FIRST = LOCAL_SPAN           # first_ts sentinel of init slots
NO_DEADLINE = 2 ** 31 - 1       # dl sentinel: no deadline armed


class DeviceNFAUnsupported(PlanError):
    """A pattern shape outside this slice's device algebra."""


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
    node: PNode
    within_ms: Optional[int] = None
    sticky: bool = False
    dl_row: Optional[int] = None    # deadline row (absent with `for`)


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
        return [p.node for p in self.positions]

    def maybe_absent_refs(self) -> set:
        """Refs that can be NULL in an emitted match: the absent nodes
        (or-sides and optional counts are later slices)."""
        return {p.node.ref for p in self.positions
                if p.node.kind == "absent"}


def _conjuncts(e: ast.Expression) -> list:
    if isinstance(e, ast.And):
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def lower_chain(state_input, schemas_by_stream: dict, strings: StringTable,
                filters_by_node: list,
                param_extra: Optional[dict] = None) -> ChainSpec:
    """Validate + lower a StateInputStream into a device position chain
    (siddhi_tpu/core/nfa_device.py:209 for this slice's algebra).
    `param_extra` resolves a fused group's `__qparam<i>` variables."""
    from ..interp.nfa import NFACompiler
    from ..query.ast import StateType

    comp = NFACompiler()
    entries, _exits = comp.lower(state_input.state)
    nodes = comp.nodes
    is_sequence = state_input.type == StateType.SEQUENCE
    qw = state_input.within.millis if state_input.within else None
    for n in nodes:
        if n.partner_id is not None and any(
                m.kind == "absent" for m in (n, nodes[n.partner_id])):
            raise DeviceNFAUnsupported(
                "absent states inside logical positions (`not A and B`) "
                "are a later slice")
        if n.partner_id is not None:
            raise DeviceNFAUnsupported(
                f"logical `{n.partner_op}` states are a later slice")
        if n.kind == "absent" and n.sticky:
            raise DeviceNFAUnsupported(
                "`every`-wrapped (sticky) absent states (slot forking, "
                "`_fork_slots`) are a later slice")
        if n.kind == "absent" and n.id == entries[0].id:
            raise DeviceNFAUnsupported(
                "absent heads and init slots (`needs_init_slot`) are a "
                "later slice")
        if (n.min_count, n.max_count) != (1, 1):
            raise DeviceNFAUnsupported(
                "count quantifiers (`<m:n>`, `+`) are a later slice")
    if len(entries) != 1:
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
    cur = entries[0].id
    while cur is not None:
        n0 = nodes[cur]
        if n0.id in seen:
            raise DeviceNFAUnsupported("cyclic state graph")
        seen.add(n0.id)
        w = n0.within_ms if n0.within_ms is not None else qw
        if w is not None and w >= LOCAL_SPAN:
            raise DeviceNFAUnsupported("within > ~12 days (i32 ms offsets)")
        if n0.sticky and positions:
            raise DeviceNFAUnsupported("`every` below the head is a later "
                                       "slice")
        positions.append(Position(PNode(n0.ref, n0.stream_id,
                                        scode(n0.stream_id), n0.kind,
                                        n0.waiting_ms), w,
                                  bool(n0.sticky)))
        cur = n0.next_id
    if len(seen) != len(nodes):
        raise DeviceNFAUnsupported("non-linear state graph")

    schemas = {p.node.ref: schemas_by_stream[p.node.stream_id]
               for p in positions}
    spec = ChainSpec(positions, stream_ids, schemas, is_sequence,
                     positions[0].sticky)
    by_ref = {p.node.ref: p.node for p in positions}
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
            elif host_n.id == entries[0].id:
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


def pow2_at_least(n: int, lo: int = 8) -> int:
    return max(lo, 1 << max(0, math.ceil(math.log2(max(1, n)))))


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
    multi-query lanes).  It returns the raw match table: `out_i` (rows
    `lane_names_i`, M) i32, `out_f` (rows_f, M) f32, `out_l` (rows_l, M)
    i64, and `meta` = [matches found (may exceed M), heads dropped so far,
    earliest deadline of a live slot (NO_DEADLINE when none)].

    `params` (a LaneParams) holds a fused group's per-lane constants,
    `broadcast` marks its lanes (events shared, a `__qid__` row per
    match), and `playback` lets deadlines fire on events as well as on
    timer ticks (the JAX package's `dl_fire` rule)."""

    def __init__(self, spec: ChainSpec, sel_fns: dict,
                 having: Optional[CompiledExpr], P: int, A: int,
                 params: Optional[LaneParams] = None,
                 broadcast: bool = False, playback: bool = False):
        self.spec = spec
        self.sel_fns = sel_fns
        self.having = having
        self.P, self.A = P, A
        self.S = spec.S
        self.E = 1 if spec.S == 1 else min(A, 2)
        self.params = params
        self.broadcast = broadcast
        self.playback = playback
        ka = 0
        for pos in spec.positions:
            pos.dl_row = None
            if pos.node.kind == "absent" and pos.node.waiting_ms is not None:
                pos.dl_row = ka
                ka += 1
        self.Ka = ka
        self.has_absent = any(n.kind == "absent" for n in spec.all_nodes)
        absent = spec.maybe_absent_refs()
        for name, ce in list(sel_fns.items()) + (
                [("having", having)] if having else []):
            hit = {_base_ref(k.split(".", 1)[0])[0] for k in ce.reads
                   if "." in k and not k.startswith("__")} & absent
            if hit and broadcast:
                raise DeviceNFAUnsupported(
                    "fused selector over maybe-absent refs (null routing)")
            if hit:
                raise DeviceNFAUnsupported(
                    f"selector output {name!r} reads the maybe-absent ref "
                    f"{sorted(hit)[0]!r} (presence rows and null "
                    f"reconstruction are a later slice)")

        cap_keys: set = set()
        for pos in spec.positions:
            for ce in pos.node.step_conjs:
                for k in ce.reads:
                    if k != "__timestamp__" and "." in k and \
                            k.split(".", 1)[0] != pos.node.ref:
                        cap_keys.add(k)
        for ce in list(sel_fns.values()) + ([having] if having else []):
            for k in ce.reads:
                if "." in k and not k.startswith("__"):
                    cap_keys.add(k)
        self._key_type: dict = {}
        for k in sorted(cap_keys):
            refpart, attr = k.split(".", 1)
            base, cidx = _base_ref(refpart)
            if base not in spec.schemas:
                raise DeviceNFAUnsupported(f"unresolvable capture key {k!r}")
            if cidx is not None and cidx != "last":
                raise DeviceNFAUnsupported(
                    f"indexed capture {k!r} (count positions are a later "
                    f"slice)")
            self._key_type[k] = spec.schemas[base].type_of(attr)
        with compute_dtypes(F32_MODE):
            grp = {k: self._group_of(torch_dtype(t))
                   for k, t in self._key_type.items()}
        self.rows_f = [k for k in sorted(cap_keys) if grp[k] == "f"]
        self.rows_l = [k for k in sorted(cap_keys) if grp[k] == "l"]
        self.rows_i = [k for k in sorted(cap_keys) if grp[k] == "i"]
        self.parked = spec.S > 1          # an absent head is refused above
        if self.parked:
            self.rows_i += ["__comp_ts__", "__comp_seq__"]
        self._row_of = {k: ("f", i) for i, k in enumerate(self.rows_f)}
        self._row_of.update({k: ("i", i) for i, k in enumerate(self.rows_i)})
        self._row_of.update({k: ("l", i) for i, k in enumerate(self.rows_l)})
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

        # ---- capture writes per position: (group, row, src) with src a
        #      grid column index, -1 = event ts, -2 = event seq ----------
        self.cap_writes: list = []
        for pi, pos in enumerate(spec.positions):
            n = pos.node
            cw = []
            for a in spec.schemas[n.ref].attributes:
                gk = f"{n.scode}.{a.name}"
                if gk not in self.grid_keys:
                    continue
                for k in (f"{n.ref}.{a.name}", f"{n.ref}[last].{a.name}"):
                    if k in self._row_of:
                        g, r = self._row_of[k]
                        cw.append((g, r, self.grid_keys.index(gk)))
            if pi > 0:
                for k, src in (("__comp_ts__", -1), ("__comp_seq__", -2)):
                    g, r = self._row_of[k]
                    cw.append((g, r, src))
            self.cap_writes.append(cw)

        # ---- VM programs ---------------------------------------------------
        C = len(self.grid_keys)
        grid_vt = {k: VT_OF_TORCH[torch.from_numpy(np.zeros(
            0, self.np_dtype(t))).dtype]
            for k, (_s, _a, t) in zip(self.grid_keys, self.grid_attrs)}
        cap_slot = {}
        for k, (g, r) in self._row_of.items():
            if k.startswith("__"):
                continue
            off = {"f": C, "i": C + len(self.rows_f),
                   "l": C + len(self.rows_f) + len(self.rows_i)}[g]
            vt = VT_BOOL if self._key_type[k] == ast.AttrType.BOOL else \
                {"f": 3, "i": 1, "l": 2}[g]
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
            with compute_dtypes(F32_MODE):
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
                        tree = subst(tree, TS_SUBST)
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
                    msl[k] = (col, 3)
                    col += 1
                for k in self.rows_l:
                    msl[k] = (col, 2)
                    col += 1
                msl["__comp_ts__"] = (self.lane_names_i.index("__comp_ts__"),
                                      1)
                mts = {"__timestamp__": timestamp_node("__comp_ts__")}
                self.sel_names = list(sel_fns)
                sel_trees = [subst(ce.node, mts) for ce in sel_fns.values()]
                self.sel_progs = [emit_program(t, msl) for t in sel_trees]
                self.having_prog = None
                if having is not None:
                    h = subst(having.node, dict(zip(self.sel_names,
                                                    sel_trees)))
                    self.having_prog = emit_program(subst(h, mts), msl)
        except ExprError as e:
            raise DeviceNFAUnsupported(f"not in the device VM: {e}") from None

    @staticmethod
    def _group_of(dt) -> str:
        if dt in (torch.float32, torch.float64):
            return "f"
        if dt == torch.int64:
            return "l"
        return "i"

    @staticmethod
    def np_dtype(t: ast.AttrType):
        """Grid dtype: DOUBLE travels as float32 on the pattern path."""
        return np.float32 if t == ast.AttrType.DOUBLE else dtype_of(t)

    def with_shape(self, P: int, A: int) -> "NFAKernel":
        """The same chain at another partition/slot count."""
        return NFAKernel(self.spec, self.sel_fns, self.having, P, A,
                         self.params, self.broadcast, self.playback)

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
        return {"occ": z((A, P), torch.int32),
                "first_ts": z((A, P), torch.int32),
                "head_seq": z((A, P), torch.int32),
                "caps_f": z((len(self.rows_f), A, P), torch.float32),
                "caps_i": z((len(self.rows_i), A, P), torch.int32),
                "caps_l": z((len(self.rows_l), A, P), torch.int64),
                "dl": torch.full((self.Ka, A, P), NO_DEADLINE,
                                 dtype=torch.int32, device=device),
                "armed0": torch.ones((P,), dtype=torch.bool, device=device),
                "of_slots": z((P,), torch.int32)}

    # -- the block -----------------------------------------------------------

    def pre_mask_rows(self, ev: dict):
        """K1's row map for the pre-masks: the (T, P) grid; over broadcast
        (T, 1) events row r reads event r // P of lane r % P."""
        from ..kernels.expr_eval import RowMap
        if ev["__ts__"].shape[1] == self.P:
            return RowMap(qparams=self.params, lane_mod=self.P)
        return RowMap(col_div=self.P, lane_mod=self.P, qparams=self.params)

    def pre_masks(self, ev: dict) -> list:
        """K1 over the flattened (T*P,) grid: one bit-packed mask per chain
        node with event-only conjuncts (None where it has none)."""
        from ..kernels.expr_eval import expr_eval
        T = ev["__ts__"].shape[0]
        cols = self.pre_mask_cols(ev)
        rows = self.pre_mask_rows(ev)
        out = []
        for prog in self.pre_progs:
            if prog is None:
                out.append(None)
                continue
            words, _ = expr_eval(cols, prog, [], T * self.P,
                                 {"__base_ts__": ev["__base_ts__"]},
                                 use="pre_mask", rows=rows)
            out.append(words)
        return out

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
