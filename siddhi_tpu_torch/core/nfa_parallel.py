"""Parallel-in-time NFA plan families `scan` and `dfa`: lowering,
classifier, block.

Port of `siddhi_tpu/core/nfa_parallel.py` for the pattern algebra of this
slice (chains of single positions joined by `->` or `,`, an `every` or
one-shot head, `within` on every position, one or several streams,
event-only pre-conjuncts, one monotone threshold conjunct per hop or, in a
strict sequence, any step conjunction).  First-match semantics make the
automaton deterministic given a head event, so every event of a flush is
simulated as a candidate head at once and each hop is answered in
O(log F):

  * a threshold hop `own.attr OP f(earlier captures)` is "the first index
    >= s whose masked value beats v": a descent of a perfect segment tree
    over the hop's column (K3 builds it, K4 walks it);
  * a static hop (no capture-dependent conjunct) is the same query on a
    tree of its node mask;
  * the `within` killer is the first event at or after s whose timestamp
    passes head ts + W: a query on the i64 max-tree of the timestamps;
  * a strict-sequence hop reads the event at s directly.

Blocks carry no device state: the plan replays the last `within` window of
events at the next flush and K5 drops completions at or before the
previous flush's last seq (per lane for partitioned grids).

The `dfa` family (`@app:patternFamily('dfa')`; automatic selection takes
`scan` first, as the JAX package does) is the same block with the chase
nodes -- the static hops below the head and both sides of a logical
position, at most 8 -- answered from bit-packed tables instead of trees:
one symbol bit per chase node an event, stride-4 block tables (K11
`dfa_tables`), and K4's `dfa` lookup mode (`_dfa_tables`, `_dfa_next`
of the JAX module).  K3 then builds no mask tree for those nodes;
threshold hops, counts and the `within` killer keep their trees.

Lanes are partition keys, each with its own row of events, or the query
instances of a fused multi-query group: those share ONE row of events
(the JAX package's shared leaves, nfa_parallel.py:646-672) with its
replay tail and dedup seq, and differ in their `__qparam` constants and
one-shot flags; K5 tags each match with its lane's `__qid__`.  No kernel bounds the chain: programs,
trees, loads and row sources travel in device tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..query import ast
from .expr import (F32_MODE, VT_OF_TORCH, ExprError, Program,
                   compile_expression, compute_dtypes, emit_program, subst,
                   torch_dtype)
from .nfa_device import (TS_SUBST, UNBOUNDED, ChainSpec, NFAKernel,
                         PatternFilterContext, _and_all, _base_ref,
                         _index_want, pow2_at_least)

STRIDE = 4                # dfa family: events per precomposed transition
_OFF_BITS = 3             # bits per packed first-hit offset (0..STRIDE)
NUMERIC = (ast.AttrType.INT, ast.AttrType.LONG,
           ast.AttrType.FLOAT, ast.AttrType.DOUBLE)
# how K5 resolves a count capture's index: the emitting occurrence (a
# final count's plain/[last] read), select of occurrence q + arg ([last]
# arg 0, [last-1] arg -1), or of the fixed occurrence arg ([i]: i + 1)
CNT_COMP, CNT_Q, CNT_FIXED = range(3)
# single-arm (non-`every`) resolution flag per lane
ARM_NONE, ARM_PENDING, ARM_RESOLVED = 0, 1, 2


class ParallelUnsupported(Exception):
    """Chain shape outside the parallel family's sound subset."""


@dataclass
class HopThreshold:
    """One monotone capture-dependent conjunct: own_col OP rhs(captures)."""
    own_key: str                  # "e2.price" -- the arriving event's column
    op: str                       # "gt" | "ge" | "lt" | "le"
    rhs: object                   # CompiledExpr over earlier-ref captures
    own_type: ast.AttrType = ast.AttrType.DOUBLE


@dataclass
class HopNode:
    """One lowered stream node inside a chase position."""
    ref: str
    scode: int
    pre_conjs: list = field(default_factory=list)   # CompiledExpr, event-only
    threshold: Optional[HopThreshold] = None
    step_conjs: list = field(default_factory=list)  # sequence-mode direct eval

    @property
    def is_static(self) -> bool:
        return self.threshold is None and not self.step_conjs


@dataclass
class PPos:
    """One chain position lowered for the state chase."""
    kind: str                     # "single" | "count" | "logical"
    nodes: list                   # [HopNode]; 2 for logical
    within_ms: int = 0
    op: Optional[str] = None      # "and" | "or" (logical)
    min_count: int = 1
    max_count: int = 1


@dataclass
class ParallelProgram:
    positions: list               # [PPos], index = chain position
    stream_ids: list
    schemas: dict                 # ref -> StreamSchema
    ref_of: dict                  # ref -> (position index, node index)
    sequence: bool = False        # strict `,` succession
    single_arm: bool = False      # non-`every` head (one instance ever)

    @property
    def S(self) -> int:
        return len(self.positions)

    @property
    def count_refs(self) -> set:
        return {p.nodes[0].ref for p in self.positions if p.kind == "count"}


_FLIP = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge"}
_OPN = {ast.CompareOp.GT: "gt", ast.CompareOp.GE: "ge",
        ast.CompareOp.LT: "lt", ast.CompareOp.LE: "le"}


def _own_var(e, node, schemas) -> Optional[str]:
    """Attr name when `e` is a plain Variable over the node's OWN event
    (qualified with its ref, or unqualified resolving to its schema --
    PatternFilterContext resolution order), else None."""
    if not isinstance(e, ast.Variable) or e.index is not None:
        return None
    if e.stream_ref == node.ref:
        return e.attribute
    if e.stream_ref is None and e.attribute in schemas[node.ref].types:
        return e.attribute
    return None


def lower_parallel(spec: ChainSpec, strings,
                   param_extra: Optional[dict] = None) -> ParallelProgram:
    """Lower a ChainSpec into a state-chase program, or raise
    ParallelUnsupported with the ineligibility reason (the JAX package's
    words and refusals, nfa_parallel.py:177-270, so the two plans report
    the same `families` entry)."""
    if spec.S < 2:
        raise ParallelUnsupported("single-position chain (no scan depth)")
    sequence = bool(spec.is_sequence)
    single_arm = not spec.every_head
    positions: list = []
    ref_of: dict = {}
    count_refs: set = set()
    or_refs: set = set()
    S = spec.S
    for pi, pos in enumerate(spec.positions):
        for n in pos.nodes:
            if n.kind != "stream":
                raise ParallelUnsupported("absent (`not ... for`) position")
        if pos.sticky and pi > 0:
            raise ParallelUnsupported("`every` below the head")
        if pos.within_ms is None:
            raise ParallelUnsupported(
                "position without a `within` bound (stateless tail replay "
                "needs a finite horizon)")
        if pos.op is not None:
            if pi == 0:
                raise ParallelUnsupported("logical and/or head")
            if sequence:
                raise ParallelUnsupported(
                    "logical and/or position in a strict sequence")
            if spec.positions[pi - 1].is_count:
                raise ParallelUnsupported("logical position after a count "
                                          "(no station to consume the arm)")
            nodes = []
            for n in pos.nodes:
                if n.step_conjs:
                    raise ParallelUnsupported(
                        "capture-dependent filter on a logical position")
                nodes.append(HopNode(n.ref, n.scode, list(n.pre_conjs)))
            pp = PPos("logical", nodes, pos.within_ms, op=pos.op)
            if pos.op == "or":
                or_refs.update(n.ref for n in pos.nodes)
        elif pos.is_count:
            if sequence:
                raise ParallelUnsupported(
                    "count quantifier in a strict sequence")
            if pos.min_count < 1:
                raise ParallelUnsupported(
                    "optional count quantifier (min 0 arms on entry)")
            if pi > 0 and spec.positions[pi - 1].is_count:
                raise ParallelUnsupported("adjacent count positions")
            if pi == S - 1 and (pos.max_count >= UNBOUNDED
                                or pos.max_count - pos.min_count + 1 > 8):
                raise ParallelUnsupported(
                    "unbounded or wide count in the final position "
                    "(one emission lane per allowed occurrence)")
            n = pos.nodes[0]
            if n.step_conjs:
                raise ParallelUnsupported(
                    "capture-dependent filter on a count position")
            pp = PPos("count", [HopNode(n.ref, n.scode, list(n.pre_conjs))],
                      pos.within_ms, min_count=pos.min_count,
                      max_count=pos.max_count)
            count_refs.add(n.ref)
        else:
            n = pos.nodes[0]
            hop = HopNode(n.ref, n.scode, list(n.pre_conjs))
            if n.step_conjs:
                if pi == 0:
                    raise ParallelUnsupported("head filter reads captures")
                if sequence:
                    # the strict next event is KNOWN (j+1): evaluate the
                    # conjunction directly, no monotonicity needed
                    hop.step_conjs = list(n.step_conjs)
                    _check_step_reads(n.step_conjs, n.ref, ref_of,
                                      count_refs, param_extra)
                else:
                    if len(n.step_conjs) > 1:
                        raise ParallelUnsupported(
                            "multiple capture-dependent conjuncts on one "
                            "position (first-match of a conjunction is not "
                            "decomposable)")
                    hop.threshold = _lower_threshold(
                        n, n.step_asts[0], spec, strings, ref_of,
                        param_extra, count_refs, or_refs)
            pp = PPos("single", [hop], pos.within_ms)
        positions.append(pp)
        for ni, hn in enumerate(pp.nodes):
            ref_of[hn.ref] = (pi, ni)
    return ParallelProgram(positions, list(spec.stream_ids),
                           dict(spec.schemas), ref_of, sequence=sequence,
                           single_arm=single_arm)


def _check_step_reads(step_conjs, own_ref, ref_of, count_refs=(),
                      param_extra=None):
    """Sequence-mode step conjuncts: reads must be the own event's
    columns, earlier frozen captures, params or __timestamp__."""
    for ce in step_conjs:
        for k in ce.reads:
            if k == "__timestamp__" or (param_extra and k in param_extra):
                continue
            if "." not in k:
                raise ParallelUnsupported(
                    f"step filter reads non-capture key {k!r}")
            base = _base_ref(k.split(".", 1)[0])[0]
            if base == own_ref:
                continue
            if base in count_refs:
                raise ParallelUnsupported(
                    "step filter reads a still-collecting count capture")
            if base not in ref_of:
                raise ParallelUnsupported(
                    f"step filter reads unresolved key {k!r}")


def _lower_threshold(node, cond, spec, strings, ref_of,
                     param_extra=None, count_refs=(),
                     or_refs=()) -> HopThreshold:
    """`own.attr OP expr(earlier captures)` -> HopThreshold, else raise."""
    if not isinstance(cond, ast.Compare) or cond.op not in _OPN:
        raise ParallelUnsupported(
            "capture-dependent filter is not a <,<=,>,>= comparison")
    own_l = _own_var(cond.left, node, spec.schemas)
    own_r = _own_var(cond.right, node, spec.schemas)
    if (own_l is None) == (own_r is None):
        raise ParallelUnsupported(
            "comparison must have the arriving event's attribute on "
            "exactly one side")
    attr = own_l if own_l is not None else own_r
    op = _OPN[cond.op] if own_l is not None else _FLIP[_OPN[cond.op]]
    own_t = spec.schemas[node.ref].type_of(attr)
    if own_t not in NUMERIC:
        raise ParallelUnsupported(
            f"threshold attribute {attr!r} is not numeric")
    rhs_ast = cond.right if own_l is not None else cond.left
    ctx = PatternFilterContext(spec.schemas, strings, node.ref)
    if param_extra:
        ctx.extra = dict(param_extra)
    try:
        rhs = compile_expression(rhs_ast, ctx)
    except ExprError as e:
        raise ParallelUnsupported(f"threshold rhs not compilable: {e}")
    if rhs.type not in NUMERIC:
        raise ParallelUnsupported("threshold rhs is not numeric")
    ok_reads = set()
    for r in ref_of:
        for a in spec.schemas[r].attributes:
            ok_reads.add(f"{r}.{a.name}")
    ok_reads.update(param_extra or ())
    bad = set(rhs.reads) - ok_reads
    if bad:
        raise ParallelUnsupported(
            f"threshold rhs reads non-capture keys {sorted(bad)!r} "
            f"(own event / timestamp / later positions)")
    for k in rhs.reads:
        if "." not in k:
            continue
        base = _base_ref(k.split(".", 1)[0])[0]
        if base in count_refs:
            raise ParallelUnsupported(
                "threshold rhs reads a still-collecting count capture")
        if base in or_refs:
            raise ParallelUnsupported(
                "threshold rhs reads a maybe-absent `or` capture")
    return HopThreshold(f"{node.ref}.{attr}", op, rhs, own_t)


def classify_parallel(spec: ChainSpec, kernel: NFAKernel, strings,
                      param_extra: Optional[dict] = None) -> dict:
    """{'scan': True | reason, 'dfa': True | reason} for one lowered
    chain.  True means the family is sound for this ChainSpec; a string is
    the ineligibility reason (the plan's `families` entry), as
    classify_parallel of the JAX package (nfa_parallel.py:345-383) gives
    it."""
    try:
        prog = lower_parallel(spec, strings, param_extra)
        count_refs = prog.count_refs
        logical_refs = {n.ref for p in prog.positions
                        if p.kind == "logical" for n in p.nodes}
        for ce in (list(kernel.sel_fns.values())
                   + ([kernel.having] if kernel.having else [])):
            is_having = kernel.having is not None and ce is kernel.having
            for k in ce.reads:
                if "." not in k or k.startswith("__"):
                    continue
                base, cidx = _base_ref(k.split(".", 1)[0])
                if cidx is not None:
                    if base in count_refs and (
                            cidx in ("last", "last-1") or cidx.isdigit()):
                        pass            # rank/select-resolvable
                    elif cidx == "last" and base in prog.ref_of:
                        pass            # [last] over a (1,1) ref == plain
                    else:
                        raise ParallelUnsupported(
                            f"indexed capture read {k!r} outside a count "
                            f"position")
                if is_having and base in logical_refs:
                    raise ParallelUnsupported(
                        "having reads a capture of a logical (maybe-"
                        "absent) position")
    except ParallelUnsupported as e:
        return {"scan": str(e), "dfa": str(e)}
    return _classify_prog(prog)


def _chase_lanes(prog: ParallelProgram) -> list:
    """Static chase nodes (pi, ni) that resolve via next-match pointers --
    the `dfa` family's bit-packable symbol lanes (nfa_parallel.py:385 of
    the JAX package).  Count positions resolve via rank/select and
    threshold hops via the segment tree; neither consumes a symbol bit."""
    lanes = []
    for pi, pos in enumerate(prog.positions):
        if pi == 0:
            continue
        if pos.kind == "single" and pos.nodes[0].is_static:
            lanes.append((pi, 0))
        elif pos.kind == "logical":
            lanes.extend((pi, ni) for ni in range(len(pos.nodes)))
    return lanes


def _classify_prog(prog: ParallelProgram) -> dict:
    """Family verdicts for a successfully lowered chase program, the JAX
    package's reasons word for word (`_classify_prog` :401)."""
    out = {"scan": True}
    lanes = _chase_lanes(prog)
    if prog.sequence:
        out["dfa"] = ("strict sequence (consecutive-event steps leave "
                      "nothing to bit-pack)")
    elif len(lanes) > 8:
        out["dfa"] = ("more than 8 positions (symbol words bit-pack one "
                      "position per u32 lane bit)")
    elif not lanes:
        out["dfa"] = ("no static transition to bit-pack (every hop is "
                      "threshold- or count-dependent)")
    else:
        out["dfa"] = True
    return out


def grid_dtype(t: ast.AttrType) -> torch.dtype:
    """Torch dtype of an attribute's (L, F) grid (DOUBLE travels as
    float32 on the pattern path)."""
    return torch.from_numpy(np.zeros(0, NFAKernel.np_dtype(t))).dtype


def lane_grid(ev: dict, key: str) -> torch.Tensor:
    """An event grid as (L, F): a fused group's one shared row of events
    expanded (a view) to every lane."""
    L = ev["__nev__"].shape[0]
    g = ev[key]
    return g if g.shape[0] == L else g.expand(L, g.shape[1])


def tree_vt(own: torch.dtype, rhs: torch.dtype) -> int:
    """VM type of a threshold tree: the promotion of both comparison
    sides, int32 widened to int64 so the sentinel lies strictly outside
    the value range (`_tree_dtype` of the JAX package)."""
    dt = torch.promote_types(own, rhs)
    if dt == torch.int32:
        dt = torch.int64
    return VT_OF_TORCH[dt]


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@dataclass
class TreeSpec:
    """One segment tree K3 builds per lane: heap type, max or min, the
    leaf column (None: the constant 1 of a static hop's mask tree), the
    flat chain node whose node mask gates the leaves (None: validity
    only), and whether the column is a per-lane (L, F) tensor (a rank
    column) rather than an event grid."""
    vt: int
    agg: str
    src: Optional[str]
    node: Optional[int]
    lane: bool = False


@dataclass
class HopSpec:
    """What K4 does at one position below the head."""
    kind: str       # "static" | "threshold" | "strict" | "logical" |
    #                 "count" | "final" (a count in the final position)
    within: int
    tree: int = -1                # TreeSpec index (static/threshold/left)
    op: str = "gt"                # threshold compare (static: gt 0)
    prog: Optional[Program] = None    # rhs, or the strict step conjunction
    tree2: int = -1               # logical: the right side's tree
    dfa: tuple = (-1, -1)         # `dfa`: chase lanes (static; sides)
    is_or: bool = False           # logical: `or` (else `and`)
    prev: tuple = (-1, -1)        # logical `and`: prev columns per side
    sides: tuple = (-1, -1)       # logical: idx rows of the sides
    bits: tuple = (-1, -1)        # logical `or`: presence bits per side
    rank: int = -1                # count: its rank column / tree
    min_count: int = 1
    max_count: int = 1


class ParallelChainKernel:
    """Stateless block of the `scan` family over an (L, F) lane grid (the
    flat block is L = 1): K1 pre-masks -> K3 trees -> K6 ranks and prev
    pointers -> K3 rank trees -> K4 chase -> K5 dedup and compaction into
    the NFAKernel's match table, whose rows the plan's selector pass (K1)
    and unpack read exactly as for `seq`.  With family `dfa` the chase
    nodes (`_chase_lanes`, flat nodes `dfa_nodes`) get no K3 mask tree:
    K11 builds their symbol tables and K4 looks their first hits up there.

    `ev` holds "__flat.__ts__", "__flat.__seq__" (G, F) i32 offsets from
    the flush's bases, "__flat.__scode__" (several streams), one
    "__flat.<scode>.<attr>" (G, F) grid per key of `nfak.grid_keys`,
    "__nev__" (L,) i32 events per lane, "__prev_seq__" (L,) i32 (the
    lane's last emitted completion seq), "__arm_done__" (L,) i32 for
    one-shot heads, "__lane_qid__" (L,) i32 for fused lanes, and the ints
    "__base_ts__", "__base_seq__".  G is L, or 1 when the lanes are a
    fused group's query instances sharing one row of events.

    K4's `idx` rows: row pi-1 holds the event index resolved at position
    pi >= 1 (a count's: its min-th occurrence; a final count's: its
    entry), then two rows per logical position (each side's capture
    index), then, for a final count, one row per candidate occurrence c
    (its completion index).  K4 and K5 address them as `loc` = row + 1,
    0 meaning the head and -1 the hop's start s."""

    def __init__(self, prog: ParallelProgram, nfak: NFAKernel,
                 family: str = "scan"):
        self.prog = prog
        self.nfak = nfak
        self.family = family
        self.S = S = prog.S
        self.multi = len(prog.stream_ids) > 1
        self.grid_keys = list(nfak.grid_keys)
        self.pos_node = list(nfak.pos_node)
        nodes = nfak.spec.all_nodes
        self.node_scode = [n.scode for n in nodes]
        scode_of = {n.ref: n.scode for n in nodes}

        def col_key(ref: str, attr: str) -> str:
            key = f"{scode_of[ref]}.{attr}"
            if key not in self.grid_keys:
                raise ParallelUnsupported(f"no grid column for {ref}.{attr}")
            return f"__flat.{key}"

        # ---- K4's index rows -------------------------------------------
        self.pos_row = {pi: pi - 1 for pi in range(1, S)}
        self.side_row: dict = {}          # logical side ref -> idx row
        self.pres_bit: dict = {}          # `or` side ref -> presence bit
        r = S - 1
        for li, pos in enumerate(p for p in prog.positions
                                 if p.kind == "logical"):
            for ni, hn in enumerate(pos.nodes):
                self.side_row[hn.ref] = r
                r += 1
                if pos.op == "or":
                    self.pres_bit[hn.ref] = 2 * li + ni
        last = prog.positions[-1]
        self.final_count = last.kind == "count"
        self.C = last.max_count - last.min_count + 1 \
            if self.final_count else 1
        if self.final_count:
            self.comp_rows = list(range(r, r + self.C))
            r += self.C
        else:
            self.comp_rows = [S - 2]
        self.n_idx = r
        self.counts = [pi for pi, p in enumerate(prog.positions)
                       if p.kind == "count"]
        self.rank_of = {pi: ci for ci, pi in enumerate(self.counts)}
        self.rank_trees = [TreeSpec(VT_OF_TORCH[torch.int64], "max",
                                    f"__rank.{ci}", None, lane=True)
                           for ci in range(len(self.counts))]
        self.prev_nodes: list = []        # flat node of each prev column

        def loc_of(base: str) -> int:
            pi, _ni = prog.ref_of[base]
            if pi == 0:
                return 0
            if base in self.side_row:
                return self.side_row[base] + 1
            return self.pos_row[pi] + 1

        # VM loads of K4's programs: (column key, loc)
        self.loads: list = []

        def slot(key: str, loc: int) -> int:
            if (key, loc) not in self.loads:
                self.loads.append((key, loc))
            return self.loads.index((key, loc))

        key_vt = {f"__flat.{si}.{a}": VT_OF_TORCH[grid_dtype(t)]
                  for si, a, t in nfak.grid_attrs}
        key_vt["__flat.__ts__"] = VT_OF_TORCH[torch.int32]

        def capture_slots(reads, own: Optional[str]) -> dict:
            out = {}
            for k in reads:
                if k == "__timestamp__" or "." not in k:
                    continue        # lane parameters: the VM's qparam
                refpart, attr = k.split(".", 1)
                base = _base_ref(refpart)[0]
                key = col_key(base, attr)
                out[k] = (slot(key, -1 if base == own else loc_of(base)),
                          key_vt[key])
            return out

        def mask_tree(gi: int) -> int:
            self.trees.append(TreeSpec(VT_OF_TORCH[torch.int32], "max",
                                       None, gi))
            return len(self.trees) - 1

        # `dfa`: the chase nodes' symbol bits (in _chase_lanes order)
        chase = _chase_lanes(prog) if family == "dfa" else []
        if family == "dfa" and not 1 <= len(chase) <= 8:
            raise ParallelUnsupported(f"{len(chase)} chase nodes for dfa")
        self.dfa_nodes = [self.pos_node[pi] + ni for pi, ni in chase]
        lane_of = {pn: i for i, pn in enumerate(chase)}

        def hit(pi: int, ni: int) -> tuple:
            """(tree, chase lane) answering a static first-hit: the lane
            under `dfa`, else a mask tree."""
            if (pi, ni) in lane_of:
                return -1, lane_of[(pi, ni)]
            return mask_tree(self.pos_node[pi] + ni), -1

        self.trees: list = []
        self.hops: list = []
        self.ts_tree = -1
        if not prog.sequence:
            self.ts_tree = 0
            self.trees.append(TreeSpec(VT_OF_TORCH[torch.int64], "max",
                                       "__flat.__ts__", None))
        try:
            with compute_dtypes(F32_MODE):
                for pi in range(1, S):
                    pos = prog.positions[pi]
                    gi = self.pos_node[pi]
                    hop = pos.nodes[0]
                    if pos.kind == "logical":
                        prev = [-1, -1]
                        if pos.op == "and":
                            for ni in range(2):
                                prev[ni] = len(self.prev_nodes)
                                self.prev_nodes.append(gi + ni)
                        (tl, dl), (tr, dr) = hit(pi, 0), hit(pi, 1)
                        self.hops.append(HopSpec(
                            "logical", pos.within_ms, tl, tree2=tr,
                            dfa=(dl, dr), is_or=pos.op == "or",
                            prev=tuple(prev),
                            sides=tuple(self.side_row[n.ref]
                                        for n in pos.nodes),
                            bits=tuple(self.pres_bit.get(n.ref, -1)
                                       for n in pos.nodes)))
                    elif pos.kind == "count":
                        self.hops.append(HopSpec(
                            "final" if pi == S - 1 else "count",
                            pos.within_ms, rank=self.rank_of[pi],
                            min_count=pos.min_count,
                            max_count=pos.max_count))
                    elif prog.sequence:
                        prog_ = None
                        if hop.step_conjs:
                            # the arriving event's columns and timestamp
                            # load at s, earlier captures at their index
                            reads = set().union(*[ce.reads for ce in
                                                  hop.step_conjs])
                            slots = capture_slots(reads, hop.ref)
                            slots["__ts__"] = (slot("__flat.__ts__", -1),
                                               key_vt["__flat.__ts__"])
                            prog_ = emit_program(subst(
                                _and_all(hop.step_conjs), TS_SUBST), slots)
                        self.hops.append(HopSpec("strict", pos.within_ms,
                                                 prog=prog_))
                    elif hop.threshold is not None:
                        th = hop.threshold
                        own_key = col_key(hop.ref,
                                          th.own_key.split(".", 1)[1])
                        vt = tree_vt(grid_dtype(th.own_type),
                                     torch_dtype(th.rhs.type))
                        rhs = emit_program(th.rhs.node,
                                           capture_slots(th.rhs.reads, None))
                        self.trees.append(TreeSpec(
                            vt, "max" if th.op in ("gt", "ge") else "min",
                            own_key, gi))
                        self.hops.append(HopSpec(
                            "threshold", pos.within_ms, len(self.trees) - 1,
                            th.op, rhs))
                    else:
                        tree, lane = hit(pi, 0)
                        self.hops.append(HopSpec("static", pos.within_ms,
                                                 tree, dfa=(lane, -1)))
        except ExprError as e:
            raise ParallelUnsupported(f"not in the device VM: {e}") from None
        head = prog.positions[0]
        self.head = HopSpec("count", head.within_ms,
                            rank=self.rank_of[0], min_count=head.min_count,
                            max_count=head.max_count) \
            if head.kind == "count" else None

        # K5's match-table rows: per row of out_i / out_f / out_l, its
        # source -- ("col", column key, loc), ("cnt", column key, count
        # position, mode, arg), ("pres_bit", bit), ("pres_cnt", count
        # position, want), ("one",), or ("comp_ts",) / ("comp_seq",) /
        # ("head_seq",) / ("qid",)
        def row_src(name: str):
            if name in ("__comp_ts__", "__comp_seq__", "__head_seq__",
                        "__qid__"):
                return (name[2:-2],)
            if name.startswith("__present__."):
                base, cidx = _base_ref(name[len("__present__."):])
                pi = prog.ref_of[base][0]
                if prog.positions[pi].kind == "count":
                    return ("pres_cnt", pi,
                            1 if cidx is None else _index_want(cidx))
                if base in self.pres_bit:
                    return ("pres_bit", self.pres_bit[base])
                return ("one",)
            refpart, attr = name.split(".", 1)
            base, cidx = _base_ref(refpart)
            pi = prog.ref_of[base][0]
            key = col_key(base, attr)
            if prog.positions[pi].kind != "count":
                return ("col", key, loc_of(base))
            if cidx is None or cidx == "last":
                mode, arg = (CNT_COMP, 0) if pi == S - 1 else (CNT_Q, 0)
            elif cidx == "last-1":
                mode, arg = CNT_Q, -1
            else:
                mode, arg = CNT_FIXED, int(cidx) + 1
            return ("cnt", key, pi, mode, arg)
        self.rows = {"i": [row_src(n) for n in nfak.lane_names_i],
                     "f": [row_src(n) for n in nfak.rows_f],
                     "l": [row_src(n) for n in nfak.rows_l]}

    @staticmethod
    def leaves(F: int) -> int:
        """Leaf count of a lane's trees; also the `not found` index."""
        return pow2_at_least(F, lo=2)

    # -- K1 pre-masks over the flattened grid -----------------------------

    def pre_mask_cols(self, ev: dict) -> list:
        return [ev[f"__flat.{k}"].reshape(-1) for k in self.grid_keys] + \
            [ev["__flat.__ts__"].reshape(-1)]

    def pre_mask_rows(self, ev: dict):
        """K1's row map over the (L*F,) lane grid: row r is event r % F of
        lane r // F, read from the lane's own row of events or from the
        one row a fused group shares."""
        from ..kernels.expr_eval import RowMap
        G, F = ev["__flat.__ts__"].shape
        return RowMap(col_mod=F if G == 1 else 0, lane_div=F,
                      qparams=self.nfak.params)

    def pre_masks(self, ev: dict) -> list:
        """One bit-packed word array per chain node over the (L*F,)
        lane grid (None where the node has no event-only conjunct)."""
        from ..kernels.expr_eval import expr_eval
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        cols = self.pre_mask_cols(ev)
        rows = self.pre_mask_rows(ev)
        out = []
        for prog in self.nfak.pre_progs:
            if prog is None:
                out.append(None)
                continue
            words, _ = expr_eval(cols, prog, [], L * F,
                                 {"__base_ts__": ev["__base_ts__"]},
                                 use="pre_mask", rows=rows)
            out.append(words)
        return out

    def rank_cols(self, masks: list) -> list:
        """K6 columns of the `rank` use: each count position's node mask
        over the flattened (L*F,) lane grid."""
        return [("sum", masks[self.pos_node[pi]].reshape(-1), False)
                for pi in self.counts]

    def prev_cols(self, masks: list) -> list:
        """K6 columns of the `prev` use: the lane-local event index (no
        values: K6 derives it from `period`), masked by each `and`
        side's node mask."""
        return [("max", None, True, masks[gi].reshape(-1))
                for gi in self.prev_nodes]

    def lane_scans(self, ev: dict, masks: list) -> tuple:
        """K6 over the flattened (L*F,) lane grid, one segment per lane:
        the inclusive occurrence rank of each count position's node mask
        (`use="rank"`) and the prev-match pointer of each `and` side
        (`use="prev"`, the i64 minimum before the lane's first match);
        each an (L, F) int64 tensor."""
        from ..kernels.win_scan import win_scan
        L, F = masks[0].shape
        out = []
        for use, cols in (("rank", self.rank_cols(masks)),
                          ("prev", self.prev_cols(masks))):
            out.append([r.view(L, F) for r in win_scan(
                cols, L * F, use=use, period=F)] if cols else [])
        return tuple(out)

    def run_block(self, ev: dict, M: int) -> dict:
        """K1 pre-masks -> K3 -> (`dfa`: K11) -> K6 -> K3 rank trees -> K4
        -> K5: the match table of one (L, F) block (see scan_compact for
        its layout)."""
        from ..kernels.dfa_tables import dfa_tables
        from ..kernels.scan_chase import scan_chase
        from ..kernels.scan_compact import scan_compact
        from ..kernels.seg_tree import node_masks, seg_tree
        pre = self.pre_masks(ev)
        heaps = seg_tree(self, ev, pre)
        tables = dfa_tables(self, ev, pre) if self.dfa_nodes else None
        ranks, prevs, rheaps = [], [], []
        if self.counts or self.prev_nodes:
            ranks, prevs = self.lane_scans(ev, node_masks(self, ev, pre))
            rheaps = seg_tree(self, ev, pre, self.rank_trees,
                              {f"__rank.{ci}": r
                               for ci, r in enumerate(ranks)})
        chase = scan_chase(self, ev, pre, heaps, ranks, rheaps, prevs,
                           tables)
        return scan_compact(self, ev, chase, ranks, rheaps, M)
