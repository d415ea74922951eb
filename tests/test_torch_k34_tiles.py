"""K3 and K4 of the `scan` family as redesigned for the H100, on the CPU.

K4 (`scan_chase`) runs a lane's heads in blocks sized to the lane (one
block a lane up to `LANE_MAX` heads, `lane_geometry` in
kernels/scan_chase.py) and descends its heaps four levels at once on the
way up and two levels a step on the way down (csrc/seg_tree.cuh
`first_hit_t`, which K5 shares).  K3 (`seg_tree`) builds each distinct
tree of a lane once: the plan merges trees that select the same leaves
(core/nfa_parallel.py `same_leaves`).  These tests hold:

- the per-lane launch's geometry;
- the kernels' descent (up four levels a chunk, down two levels a step)
  against `first_hit_plain`, for every start, op and type, on random
  trees with ties, +0.0 and -0.0, and sentinels, and on sparse trees of
  C3's sizes;
- the tree merge: C4 builds 2 trees where it built 3, its two hops
  reading one; trees stay apart for a pre-conjunct on one node, another
  stream, `<` against `>`, and a lane-parameter pre-mask; each variant's
  rows equal `siddhi_tpu`'s at a small size.

The card holds the kernels to their plain versions on the same shapes
(tests/test_torch_gpu.py, `k34`)."""
import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.expr import (TORCH_OF_VT, VT_F32, VT_F64, VT_I32,
                                        VT_I64)
from siddhi_tpu_torch.kernels.scan_chase import LANE_MAX, lane_geometry
from siddhi_tpu_torch.kernels.seg_tree import build_heap_plain, first_hit_plain
from test_torch_pattern_e2e import STOCK, part, run, tape
from test_torch_shared_trees import _fused, _kernels, _rows

PREFER = "@app:devicePatterns('prefer')\n"

# ---------------------------------------------------------------------------
# the per-lane geometry


@pytest.mark.parametrize("F", [1, 2, 31, 32, 33, 322, 326, 384, 385, 512,
                               513, 1000, 1024, 2048, 5000, 1 << 19])
def test_lane_geometry_covers_the_heads_in_full_warps(F):
    """Whole warps, at most LANE_MAX threads a block, the fewest blocks a
    lane that LANE_MAX allows (one up to LANE_MAX heads), fewer than a
    warp of idle threads a block."""
    threads = lane_geometry(F)
    assert threads % 32 == 0 and 32 <= threads <= LANE_MAX
    blocks = -(-F // threads)
    assert blocks == -(-F // LANE_MAX)
    assert blocks * threads - F < 32 * blocks


# ---------------------------------------------------------------------------
# the descent


def _descent(heap, Lt: int, s, v, op: str):
    """csrc/seg_tree.cuh first_hit_t over one lane's heap: up in chunks
    of four levels (all four nodes read, the lowest hit taken), down two
    levels a step (the left child and both children's left children
    read); ge/le made strict against the adjacent value first, as
    first_hit does."""
    dt = heap.dtype
    va = v.to(dt)
    if op in ("ge", "le"):
        if dt.is_floating_point:
            va = torch.nextafter(va, torch.full_like(
                va, float("-inf") if op == "ge" else float("inf")))
        else:
            va = va - 1 if op == "ge" else va + 1
        op = "gt" if op == "ge" else "lt"

    def node(i):
        return heap[torch.clamp(i, 0, 2 * Lt - 1)]

    def beats(a):
        return a > va if op == "gt" else a < va
    P = Lt.bit_length() - 1
    l = torch.clamp(s, 0, Lt) + Lt
    fnode = torch.zeros_like(l)         # 0: none yet
    for i0 in range(0, P + 1, 4):       # up, four levels a chunk
        at, cand = [], []
        for k in range(4):
            odd = (l & 1) == 1
            at.append(l)
            cand.append((i0 + k <= P) & odd & (l < (2 * Lt) >> (i0 + k)))
            l = (l + odd.to(l.dtype)) >> 1
        hit = torch.zeros_like(l)
        for k in range(3, -1, -1):
            x = node(torch.where(cand[k], at[k], torch.ones_like(l)))
            hit = torch.where(cand[k] & beats(x), at[k], hit)
        fnode = torch.where(fnode == 0, hit, fnode)
    found = fnode > 0
    while bool((found & (fnode < Lt)).any()):     # down, two levels a step
        c = 2 * fnode
        leaf = c >= Lt
        one = torch.where(beats(node(c)), c, c + 1)
        two = torch.where(beats(node(c)),
                          torch.where(beats(node(2 * c)), 2 * c, 2 * c + 1),
                          torch.where(beats(node(2 * c + 2)), 2 * c + 2,
                                      2 * c + 3))
        fnode = torch.where(found & (fnode < Lt),
                            torch.where(leaf, one, two), fnode)
    return torch.where(found, fnode - Lt, torch.full_like(fnode, Lt))


@pytest.mark.parametrize("vt", [VT_I32, VT_I64, VT_F32, VT_F64])
@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("Lt", [2, 4, 8, 32, 64, 512, 1024, 2048])
def test_descent_equals_first_hit_plain(vt, agg, Lt):
    """Every start s in [-1, Lt + 1], both ops of the tree's direction and
    a threshold from the leaves' own values (ties), over random trees of
    few distinct values, +0.0 and -0.0, NaN and masked leaves
    (sentinels)."""
    dt = TORCH_OF_VT[vt]
    rng = np.random.default_rng(Lt + vt * 7 + (agg == "min"))
    F = max(2, Lt - Lt // 5)
    vals = rng.integers(-3, 4, F).astype(np.float64)
    if dt.is_floating_point:
        vals[rng.random(F) < 0.2] = 0.0
        vals[rng.random(F) < 0.2] = -0.0
        vals[rng.random(F) < 0.05] = np.nan
    mask = torch.from_numpy(rng.random((1, F)) < 0.7)
    heap = build_heap_plain(torch.from_numpy(vals)[None].to(dt), mask, Lt,
                            agg, dt)[0]
    s = torch.arange(-1, Lt + 2)
    ops = ("gt", "ge") if agg == "max" else ("lt", "le")
    for thr in sorted({float(x) for x in vals if x == x}) + [-0.0]:
        v = torch.full(s.shape, thr, dtype=torch.float64)
        for op in ops:
            want = first_hit_plain(heap[None], Lt, s[None], v[None], op)[0]
            got = _descent(heap, Lt, s, v, op)
            assert torch.equal(got.to(torch.int32), want), (op, thr)


@pytest.mark.parametrize("Lt", [1 << 15, 1 << 19])
@pytest.mark.parametrize("vt", [VT_I64, VT_F32])
def test_descent_on_sparse_trees_of_flat_lanes(Lt, vt):
    """C3-sized trees (2^15 and 2^19 leaves, the timestamp tree's type
    and a float32 tree) over a sparse tree with hits far from most
    starts, so descents climb and fall through many levels."""
    rng = np.random.default_rng(Lt + vt)
    dt = TORCH_OF_VT[vt]
    vals = np.where(rng.random(Lt) < 0.0005, rng.integers(0, 100, Lt), -1)
    heap = build_heap_plain(torch.from_numpy(vals)[None].to(dt),
                            torch.ones((1, Lt), dtype=torch.bool), Lt,
                            "max", dt)[0]
    s = torch.from_numpy(rng.integers(0, Lt, 4096))
    v = torch.from_numpy(rng.integers(-1, 99, 4096).astype(np.float64))
    for op in ("gt", "ge"):
        want = first_hit_plain(heap[None], Lt, s[None], v[None], op)[0]
        got = _descent(heap, Lt, s, v, op)
        assert torch.equal(got.to(torch.int32), want), op
        assert bool((want < Lt).any()) and bool((want == Lt).any())


# ---------------------------------------------------------------------------
# each distinct tree built once


C4_CHAIN = ("from every e1=StockStream[price > 100] -> "
            "e2=StockStream[{e2}] -> e3=StockStream[{e3}] within 1 sec "
            "select e1.price as p1, e2.price as p2, e3.price as p3 "
            "insert into Out;")
SAME = {
    "c4": ("price > e1.price", "price > e2.price"),
    "static_twice": ("volume > 500", "volume > 500"),
}
APART = {
    "pre_conjunct": ("price > e1.price", "volume > 500 and price > e2.price"),
    "lt_vs_gt": ("price > e1.price", "price < e2.price"),
    "static_other_mask": ("volume > 500", "volume > 700"),
}
TWO_STREAMS = ("define stream A (k string, x double);\n"
               "define stream B (k string, x double);\n" + part(
                   "from every e1=A[x > 3.0] -> e2=A[x > e1.x] -> "
                   "e3={s}[x > e2.x] within 100 ms select e1.x as a, "
                   "e2.x as b, e3.x as c insert into Out;",
                   "k of A, k of B"))


def _kernel(app: str):
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    plan = rt.plans()[0]
    assert plan.family == "scan", plan.family
    return plan._par_kern


def _app(e2: str, e3: str) -> str:
    return STOCK + part(C4_CHAIN.format(e2=e2, e3=e3))


def _same_rows(app: str, sends) -> int:
    got, rt = run(siddhi_tpu_torch, app, sends, device="cpu")
    want, _jrt = run(siddhi_tpu, PREFER + app, sends)
    assert got == want
    return len(got)


def test_c4_builds_two_trees_its_hops_one():
    """C4 (replay.C4): the timestamp tree and one `price` max-tree, which
    both threshold hops read (3 trees before the merge); neither shared."""
    from siddhi_tpu_torch.replay import C4, C4_HEAD
    k = _kernel(C4_HEAD + C4)
    assert len(k.trees) == 2 and k.ts_tree == 0
    assert [h.kind for h in k.hops] == ["threshold", "threshold"]
    assert k.hops[0].tree == k.hops[1].tree == 1
    t = k.trees[1]
    assert (t.src, t.agg, t.node) == ("__flat.0.price", "max", 1)
    assert not any(t.shared for t in k.trees)


@pytest.mark.parametrize("name", sorted(SAME))
def test_trees_with_the_same_leaves_are_one(name):
    k = _kernel(_app(*SAME[name]))
    assert len(k.trees) == 2
    assert k.hops[0].tree == k.hops[1].tree != k.ts_tree
    assert _same_rows(_app(*SAME[name]), tape("c4", flushes=2, n=400,
                                               seed=11)) > 5


@pytest.mark.parametrize("name", sorted(APART))
def test_trees_whose_gates_differ_stay_apart(name):
    k = _kernel(_app(*APART[name]))
    assert len(k.trees) == 3
    assert len({k.ts_tree, k.hops[0].tree, k.hops[1].tree}) == 3
    assert _same_rows(_app(*APART[name]), tape("c4", flushes=2, n=400,
                                                seed=12)) > 0


def _two_stream_tape(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    sends, t = [], 1_700_000_000_000
    for _f in range(2):
        for off, sid in enumerate(("A", "B")):
            keys = np.array([f"K{i}" for i in rng.integers(0, 4, n)])
            x = np.round(rng.uniform(0, 12, n) * 4) / 4
            sends.append((sid, {"k": keys, "x": x},
                          t + off * 3 + 7 * np.arange(n)))
        t += 7 * n
    return sends


@pytest.mark.parametrize("stream", ["A", "B"])
def test_a_hop_of_another_stream_keeps_its_tree(stream):
    """e3 on A reads A's `x` as e2 does: one tree; on B another stream's
    column and node: its own tree."""
    app = TWO_STREAMS.format(s=stream)
    k = _kernel(app)
    assert len(k.trees) == (2 if stream == "A" else 3)
    assert (k.hops[0].tree == k.hops[1].tree) == (stream == "A")
    assert _same_rows(app, _two_stream_tape(300, 13)) > 0


GATED_TWICE = ("from every e1=S[price > {lo}] -> e2=S[v > {i} and price > "
               "e1.price] -> e3=S[v > {i} and price > e2.price] within 1 sec "
               "select e1.price as a, e3.price as b")
EVERY_TWICE = ("from every e1=S[price > {lo}] -> e2=S[price > e1.price] -> "
               "e3=S[price > e2.price] within 1 sec "
               "select e1.price as a, e3.price as b")


@pytest.mark.parametrize("body", ["gated", "every"])
def test_a_lane_parameter_pre_mask_never_shares_a_tree(body):
    """A fused group: two hops gated by the same lane-parameter pre-mask
    (`v > {i}`) keep a tree each (two lanes' parameters could differ
    where the programs agree), per lane; without the gate the two hops'
    trees are one, shared by the lanes.  Rows equal `siddhi_tpu`'s."""
    app = _fused(GATED_TWICE if body == "gated" else EVERY_TWICE)
    (k,) = _kernels(app)
    assert k.nfak.broadcast
    if body == "gated":
        assert len(k.trees) == 3 and k.hops[0].tree != k.hops[1].tree
        assert not any(k.trees[h.tree].shared for h in k.hops)
    else:
        assert len(k.trees) == 2 and k.hops[0].tree == k.hops[1].tree
        assert all(t.shared for t in k.trees)
    rng = np.random.default_rng(21)
    prices = np.round(rng.uniform(95, 112, 300) * 4) / 4
    ts = 1000 + 20 * np.arange(300)
    got = _rows(siddhi_tpu_torch, app, prices, ts)
    assert got == _rows(siddhi_tpu, PREFER + app, prices, ts)


def test_a_chain_of_ten_distinct_trees():
    """Nine threshold hops, each gated by a pre-conjunct of its own
    (`volume > i`): ten trees (the timestamp tree beside nine), past the
    nine the kernels once had room for, rows equal `siddhi_tpu`'s."""
    app = STOCK + part(
        "from every e1=StockStream[price > 120] -> " + " -> ".join(
            f"e{i}=StockStream[volume > {i} and price > e{i - 1}.price - "
            f"{i}.0]" for i in range(2, 11)) +
        " within 10 sec select " + ", ".join(
            f"e{i}.price as p{i}" for i in range(1, 11)) +
        " insert into Out;")
    k = _kernel(app)
    assert len(k.trees) == 10
    assert sorted(h.tree for h in k.hops) == list(range(1, 10))
    assert _same_rows(app, tape("c4", flushes=2, n=300, seed=7)) > 5
