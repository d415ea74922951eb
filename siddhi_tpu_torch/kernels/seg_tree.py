"""K3 `seg_tree`: the segment trees of one `scan` block, and first-hit.

Replaces `_build_heap` (siddhi_tpu/core/nfa_parallel.py:499), called in
`_block_impl` (:861, :874) for the `within` killer's timestamp max-tree and
one tree per threshold hop, and `_next_static_scan` (:580) for static hops,
which here become a first-hit on a tree of the hop's node mask.  Every
tree is a perfect binary tree in heap layout per lane (1-based: root at 1,
leaves at [Lt, 2Lt), slot 0 unused), Lt = pow2_at_least(F, lo=2).  Leaves
whose node mask is off (padding, another stream, a failed pre-conjunct)
or whose value is NaN hold the sentinel (-inf / INT_MIN for max trees,
+inf / INT_MAX for min trees), so NaN never reaches an ancestor.

Design (csrc/seg_tree.cu): a warp builds a (lane, tree) of up to 1024
leaves -- one lane only for a tree the plan marks `shared`
(`TreeSpec.shared`: a fused group's tree whose leaves read the group's
one row of events, gated by no lane parameter), which K3 builds once
into a (1, 2 Lt) heap that K4 reads at lane stride 0.  Rows of 32
leaves, a leaf a thread, read coalesced with four rows of loads in
flight, written, and reduced by shuffles over the row's 5 levels, the
row roots by shuffles over the levels above; no shared memory and no
block barrier.  Each tree type, max/min and source element size runs its
own instantiation, which the warp picks from the tree's entry, so no
type switch is left in the build.  A node keeps its left child on ties, as `build_heap_plain`
does, so a heap's bytes (+0.0 and -0.0 too) are the plain version's.  A
lane's trees at the C4 shapes (512 leaves) finish in one launch; a
larger tree (C3's flat 2^19 leaves, C5's 2^14) builds 1024-leaf
subtrees, a block of a leaf a thread each (the rows by shuffles, the
warp roots after one barrier), then a launch reduces their roots the
same way (`Launch.params.launched` after a
launch: the kernel launches of the call).  The plan builds each
distinct tree once (core/nfa_parallel.py `same_leaves`: C4's two hops
over `price` share one tree).  The trees' sources, types, node masks and
heap pointers travel in a device table (kernels/table.py), so no tree
count is fixed.  A fused multi-query group's lanes share one row of
events (stride 0) and keep a tree each where their own pre-masks (lane
parameters) gate it; C5's trees (timestamps, `price > e1.price` hops)
are the same in all 250 lanes and are built once.  Bound on the H100:
bytes -- the leaf columns and masks read once, each heap (2 Lt entries)
written once.

The count positions of the `scan` family add a second launch
(`use="rank"`, counted apart): one i64 max-tree per count position over
its occurrence rank column, an (L, F) tensor per lane that K6 computed
(`_build_heap(r, valid, L, "max", int64)` at nfa_parallel.py:845), whose
leaves are gated by the lane's valid events only.  K4 and K5 answer
rank/select -- the first index >= s whose rank reaches r -- as a `ge`
first-hit on it.

`seg_tree()` launches the kernel for CUDA tensors and runs the plain
version, `seg_tree_plain()` (level-wise torch.maximum / minimum), for CPU
tensors.  `first_hit_plain()` is the plain version of the descent that K4
and K5 run (csrc/seg_tree.cuh).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import TORCH_OF_VT, VT_F64, VT_OF_TORCH
from ..core.nfa_parallel import lane_grid
from .build import load
from .expr_eval import unpack_mask
from .table import DeviceTable, Launch, checked_ptr, stream_of


SUB, WARPS = 1024, 8             # csrc/seg_tree.cu ST_SUB, ST_WARPS


class _Params(ctypes.Structure):
    _fields_ = [("L", ctypes.c_int), ("F", ctypes.c_int),
                ("Lt", ctypes.c_int), ("n_trees", ctypes.c_int),
                ("cnt", ctypes.c_int), ("from_heap", ctypes.c_int),
                ("ev_stride", ctypes.c_int), ("lane_trees", ctypes.c_int),
                ("max_lanes", ctypes.c_int),
                ("launched", ctypes.c_int),
                ("nev", ctypes.c_void_p), ("scode", ctypes.c_void_p),
                ("src", ctypes.c_void_p), ("src_vt", ctypes.c_void_p),
                ("vt", ctypes.c_void_p), ("agg", ctypes.c_void_p),
                ("pre", ctypes.c_void_p), ("node_scode", ctypes.c_void_p),
                ("heap", ctypes.c_void_p), ("src_stride", ctypes.c_void_p),
                ("lanes", ctypes.c_void_p)]


def sentinel(dt: torch.dtype, agg: str):
    if dt.is_floating_point:
        return float("-inf") if agg == "max" else float("inf")
    info = torch.iinfo(dt)
    return info.min if agg == "max" else info.max


def node_masks(k, ev: dict, pre: list) -> list:
    """(L, F) bool node mask per chain node: the lane's valid events, of
    the node's stream, passing its event-only conjuncts."""
    ts = lane_grid(ev, "__flat.__ts__")
    L, F = ts.shape
    valid = torch.arange(F, device=ts.device)[None, :] < \
        ev["__nev__"].to(torch.int64)[:, None]
    out = []
    for pi, words in enumerate(pre):
        m = valid
        if k.multi:
            m = m & (lane_grid(ev, "__flat.__scode__") == k.node_scode[pi])
        if words is not None:
            m = m & unpack_mask(words, L * F).view(L, F)
        out.append(m)
    return out


def build_heap_plain(vals: Optional[torch.Tensor], mask: torch.Tensor,
                     Lt: int, agg: str, dt: torch.dtype) -> torch.Tensor:
    """(L, F) leaves -> (L, 2 Lt) heap; `vals` None means the constant 1."""
    L, F = mask.shape
    sent = sentinel(dt, agg)
    if vals is None:
        vals = torch.ones((L, F), dtype=dt, device=mask.device)
    v = vals.to(dt)
    keep = mask
    if dt.is_floating_point:
        keep = keep & ~torch.isnan(v)
    v = torch.where(keep, v, torch.full_like(v, sent))
    lvl = torch.full((L, Lt), sent, dtype=dt, device=mask.device)
    lvl[:, :F] = v
    levels = [lvl]
    while lvl.shape[1] > 1:     # the right child only where strictly better
        a, b = lvl[:, 0::2], lvl[:, 1::2]
        lvl = torch.where(b > a if agg == "max" else b < a, b, a)
        levels.append(lvl)
    return torch.cat([torch.full((L, 1), sent, dtype=dt, device=mask.device)]
                     + levels[::-1], dim=1)


def seg_tree_plain(k, ev: dict, masks: list, trees=None,
                   cols=None) -> list:
    F = ev["__flat.__ts__"].shape[1]
    Lt = k.leaves(F)
    valid = torch.arange(F, device=masks[0].device)[None, :] < \
        ev["__nev__"].to(torch.int64)[:, None]
    out = []
    for t in (k.trees if trees is None else trees):
        mask = valid.expand_as(masks[0]) if t.node is None else masks[t.node]
        src = None if t.src is None else \
            cols[t.src] if t.lane else lane_grid(ev, t.src)
        if t.shared:                # lane 0's leaves stand for every lane's
            mask = mask[:1]
            src = None if src is None else src[:1]
        out.append(build_heap_plain(src, mask, Lt, t.agg,
                                    TORCH_OF_VT[t.vt]))
    return out


def first_hit_plain(heap: torch.Tensor, Lt: int, s: torch.Tensor,
                    v: torch.Tensor, op: str,
                    lanes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First leaf index >= s whose value satisfies OP v, Lt when none, per
    query; heap (L, 2 Lt), s and v (L, Q), or, with `lanes`, s, v and
    lanes of one shape, query i asking lane lanes[i]'s tree.  `ge`/`le`
    become strict compares against the adjacent representable value in
    the heap type (`_first_hit` of the JAX package), so a sentinel never
    satisfies them."""
    if lanes is None:
        lanes = torch.arange(heap.shape[0], device=heap.device)[:, None] \
            .expand(s.shape)
    flat = heap.reshape(-1)
    base = lanes.to(torch.int64) * (2 * Lt)
    dt = heap.dtype
    va = v.to(dt)
    if op in ("ge", "le"):
        if dt.is_floating_point:
            to = torch.full_like(va, float("-inf") if op == "ge"
                                 else float("inf"))
            va = torch.nextafter(va, to)
        else:
            va = va - 1 if op == "ge" else va + 1
        op = "gt" if op == "ge" else "lt"

    def cmp(a):
        return a > va if op == "gt" else a < va
    P = max(Lt.bit_length() - 1, 0)
    l = torch.clamp(s.to(torch.int64), 0, Lt) + Lt
    found = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
    fnode = torch.zeros_like(l)
    for i in range(P + 1):
        r = (2 * Lt) >> i
        odd = (l & 1) == 1
        nv = flat[base + torch.clamp(l, 0, 2 * Lt - 1)]
        take = odd & (l < r) & cmp(nv) & ~found
        fnode = torch.where(take, l, fnode)
        found = found | take
        l = (l + odd.to(torch.int64)) >> 1
    for _ in range(P):
        internal = found & (fnode < Lt)
        left = 2 * fnode
        lv = flat[base + torch.clamp(left, 0, 2 * Lt - 1)]
        fnode = torch.where(internal, torch.where(cmp(lv), left, left + 1),
                            fnode)
    return torch.where(found, fnode - Lt,
                       torch.full_like(fnode, Lt)).to(torch.int32)


def seg_tree(k, ev: dict, pre: list, trees=None, cols=None) -> list:
    """Trees of ParallelChainKernel `k` for block `ev`: one (L, 2 Lt) heap
    per entry of `trees` (default `k.trees`; `k.rank_trees` with `cols`,
    their (L, F) rank columns by key, is the `rank` use), (1, 2 Lt) for a
    tree the plan marks `shared` (the same in every lane of a fused
    group).  `pre` holds the K1 pre-mask words per chain node (or
    None)."""
    dev = ev["__flat.__ts__"].device
    if dev.type == "cpu":
        return seg_tree_plain(k, ev, node_masks(k, ev, pre), trees, cols)
    if dev.type != "cuda":
        raise ValueError(f"seg_tree: unsupported device {dev}")
    if not (k.trees if trees is None else trees):
        return []               # a strict sequence reads events directly
    return prepare(k, ev, pre, trees, cols)()


def prepare(k, ev: dict, pre: list, trees=None, cols=None) -> Launch:
    """Allocate the heaps and upload the parameter table of one K3
    launch (see `seg_tree`)."""
    ts = ev["__flat.__ts__"]
    dev = ts.device
    if dev.type != "cuda":
        raise ValueError(f"seg_tree: unsupported device {dev}")
    G, F = ts.shape
    L = ev["__nev__"].shape[0]
    Lt = k.leaves(F)
    keep: list = []
    ptr = checked_ptr(keep, dev, "seg_tree")
    p = _Params()
    p.L, p.F, p.Lt = L, F, Lt
    p.ev_stride = F if G == L else 0
    p.nev = ptr(ev["__nev__"], torch.int32)
    if k.multi:
        p.scode = ptr(ev["__flat.__scode__"], torch.int32)
    use_rank = trees is not None
    trees = k.trees if trees is None else trees
    heaps, src, src_vt, pre_p, node_sc, stride = [], [], [], [], [], []
    if G != 1 and any(t.shared for t in trees):
        raise ValueError("seg_tree: a shared tree needs one row of events")
    for t in trees:
        if t.src is not None:
            col = cols[t.src] if t.lane else ev[t.src]
            want = (L, F) if t.lane else (G, F)
            if col.shape != want:
                raise ValueError(f"seg_tree: {t.src} is not {want}")
            src.append(ptr(col))
            src_vt.append(VT_OF_TORCH[col.dtype])
        else:
            src.append(0)
            src_vt.append(0)
        stride.append(F if t.lane else p.ev_stride)
        node_sc.append(k.node_scode[t.node] if t.node is not None
                       and k.multi else -1)
        pre_p.append(ptr(pre[t.node], torch.int32) if t.node is not None
                     and pre[t.node] is not None else 0)
        heaps.append(torch.empty((1 if t.shared else L, 2 * Lt),
                                 dtype=TORCH_OF_VT[t.vt], device=dev))
    tab = DeviceTable()
    tab.field(p, "src", src, "u8")
    tab.field(p, "src_vt", src_vt, "i4")
    tab.field(p, "vt", [t.vt for t in trees], "i4")
    tab.field(p, "agg", [0 if t.agg == "max" else 1 for t in trees], "i4")
    tab.field(p, "pre", pre_p, "u8")
    tab.field(p, "node_scode", node_sc, "i4")
    tab.field(p, "heap", [ptr(h) for h in heaps], "u8")
    tab.field(p, "src_stride", stride, "i4")
    tab.field(p, "lanes", [h.shape[0] for h in heaps], "i4")
    p.n_trees = len(trees)
    p.lane_trees = sum(h.shape[0] for h in heaps)
    p.max_lanes = max((h.shape[0] for h in heaps), default=1)
    keep.append(tab.upload(dev))
    lib = load("seg_tree")
    fn = lib.seg_tree_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # a launch that builds a float64 tree (a threshold hop over DOUBLE
    # under @app:devicePrecision('f64')) counts apart
    use = "seg_tree:rank" if use_rank else "seg_tree:f64" if any(
        t.vt == VT_F64 for t in trees) else "seg_tree"
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "seg_tree_launch", use, keep, heaps)
    # the first launch's grid, beside the block (chip_smoke, kernel_ab):
    # WARPS warps a block, a warp a lane's tree of up to SUB leaves, or a
    # block of SUB threads a lane's SUB-leaf subtree
    subs = Lt // min(Lt, SUB)
    p.blocks = (-(-p.max_lanes // WARPS) if subs == 1 else
                p.max_lanes * subs) * len(trees)
    p.warps = p.lane_trees * (1 if subs == 1 else subs * SUB // 32)
    launch.params = p
    return launch
