"""Lane-invariant trees of a fused `scan` group, on the CPU.

A fused multi-query group's lanes share one row of events.  A tree whose
leaves read that row (timestamps, a threshold hop's column, a static
hop's mask) and whose gating node reads no lane parameter is the same in
every lane: the plan marks it `shared` (`TreeSpec.shared`,
core/nfa_parallel.py `lane_invariant`), K3 builds it once into a (1, 2
Lt) heap and K4 reads it at lane stride 0.  These tests check which
trees the plan marks, that a shared tree from `seg_tree_plain` equals
each lane's own tree, and that a fused group's rows still equal the JAX
package's, in float32 and under @app:devicePrecision('f64').  The card
holds K3 and K4 to their plain versions on the same blocks
(tests/test_torch_gpu.py, `shared_trees`)."""
import dataclasses

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.expr import decode_word
from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
from siddhi_tpu_torch.kernels.seg_tree import node_masks, seg_tree_plain
from siddhi_tpu_torch.replay import C4, C4_HEAD, F64, PARAM_APP, c5_app

S = "define stream S (sym string, price double, v int);\n"


def _fused(body, n: int = 8, dbl: str = ".0") -> str:
    """`n` same-shape queries whose constants differ (lifted to lane
    parameters); `{i}` is the query index, `{lo}` its head constant."""
    return S + "\n".join(
        f"@info(name='q{i}') " + body.format(i=i, lo=f"{100 + i % 6}{dbl}")
        + f" insert into Out{i % 2};" for i in range(n))


EVERY = ("from every e1=S[price > {lo}] -> e2=S[price > e1.price] -> "
         "e3=S[price > e2.price] within 1 sec "
         "select e1.price as a, e3.price as b")
GATED = ("from every e1=S[price > {lo}] -> e2=S[v > {i} and price > "
         "e1.price] within 1 sec select e1.price as a, e2.price as b")
COUNT = ("from every e1=S[price > {lo}]<1:3> -> e2=S[price < 95.0] "
         "within 1 sec select e1[0].price as a, e2.price as b")


def _kernels(app: str) -> list:
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    return [k for k in (getattr(getattr(p, "inner", p), "_par_kern", None)
                        for p in rt.plans()) if k is not None]


@pytest.mark.parametrize("f64", [False, True])
def test_c5_group_trees_are_shared(f64):
    """c5_app(32)'s two `scan` groups: the timestamp tree and the hops'
    `price > e1.price` / `price > e2.price` tree are lane-invariant; the
    second group's two hops gate the same leaves and share one tree."""
    app = F64 + c5_app(32, frac=1e-6) if f64 else c5_app(32)
    kerns = _kernels(app)
    assert [len(k.trees) for k in kerns] == [2, 2]
    assert [len(k.hops) for k in kerns] == [1, 2]
    assert all(h.tree == 1 for k in kerns for h in k.hops)
    for k in kerns:
        assert k.nfak.broadcast and all(t.shared for t in k.trees)
        assert k.trees[k.ts_tree].src == "__flat.__ts__"
        assert k.trees[k.ts_tree].node is None
        assert {t.src for t in k.trees[1:]} == {"__flat.0.price"}
        assert all(k.nfak.pre_progs[t.node] is None for t in k.trees[1:])


def test_a_lane_parameter_pre_mask_keeps_its_tree_per_lane():
    """A hop gated by a lifted constant (`v > {i}`: a pre-mask over a
    lane parameter) keeps a tree per lane; the timestamp tree is shared.
    PARAM_APP's `price > e1.price + {i % 3}.5` hops read their lane
    parameter in K4's right-hand side, not in the tree, so their trees
    are shared."""
    (k,) = _kernels(_fused(GATED))
    assert k.family == "scan" and k.nfak.broadcast
    ts, hop = k.trees
    assert ts.shared and ts.node is None
    assert not hop.shared and k.nfak.pre_progs[hop.node] is not None
    (k,) = _kernels(PARAM_APP)
    assert all(t.shared for t in k.trees)
    assert k.hops[0].kind == "threshold" and any(
        decode_word(w)[0] == "qparam" for w in k.hops[0].prog.words[::2])


def test_rank_trees_and_unfused_trees_are_never_shared():
    """Rank trees read a per-lane rank column; an unfused (partitioned)
    block's lanes hold different events."""
    (k,) = _kernels(_fused(COUNT))
    assert k.rank_trees and not any(t.shared for t in k.rank_trees)
    (k,) = _kernels(C4_HEAD + C4)
    assert not k.nfak.broadcast and not any(t.shared for t in k.trees)


def _blocks(app: str, n: int = 600, seed: int = 3) -> list:
    """The `scan` blocks a CPU run of `app` hands run_block."""
    blocks = []
    run = ParallelChainKernel.run_block

    def rec(kern, ev, M):
        blocks.append((kern, ev))
        return run(kern, ev, M)
    ParallelChainKernel.run_block = rec
    try:
        rt = siddhi_tpu_torch.SiddhiManager(device="cpu") \
            .create_app_runtime(app)
        h = rt.input_handler("S")
        rng = np.random.default_rng(seed)
        code = rt.strings.encode("A")
        for half in range(2):
            h.send_batch({"sym": np.full(n // 2, code, np.int32),
                          "price": np.round(rng.uniform(95, 112, n // 2)
                                            * 4) / 4,
                          "v": rng.integers(0, 9, n // 2).astype(np.int32)},
                         1000 + 7 * np.arange(half * n // 2,
                                              (half + 1) * n // 2))
            rt.flush()
    finally:
        ParallelChainKernel.run_block = run
    return blocks


@pytest.mark.parametrize("body", ["every", "gated"])
def test_a_shared_tree_equals_every_lanes_own_tree(body):
    """seg_tree_plain's (1, 2 Lt) heap of a shared tree equals the tree
    each lane would build for itself from its own node mask."""
    blocks = _blocks(_fused(EVERY if body == "every" else GATED))
    assert blocks
    for kern, ev in blocks:
        L = ev["__nev__"].shape[0]
        masks = node_masks(kern, ev, kern.pre_masks(ev))
        heaps = seg_tree_plain(kern, ev, masks)
        own = seg_tree_plain(kern, ev, masks, [
            dataclasses.replace(t, shared=False) for t in kern.trees])
        assert any(t.shared for t in kern.trees)
        for t, h, o in zip(kern.trees, heaps, own):
            assert h.shape[0] == (1 if t.shared else L) and o.shape[0] == L
            assert bool((o == h).all()), t


def _rows(pkg, app: str, prices, ts) -> dict:
    rt = pkg.SiddhiManager(**({"device": "cpu"} if pkg is siddhi_tpu_torch
                              else {})).create_app_runtime(app)
    got = {f"Out{j}": [] for j in range(2)}
    for j in range(2):
        rt.add_callback(f"Out{j}", lambda evs, g=got[f"Out{j}"]:
                        g.extend((e.timestamp, e.data) for e in evs))
    h = rt.input_handler("S")
    for p, t in zip(prices, ts):
        h.send(("A", float(p), 1), timestamp=int(t))
    rt.flush()
    return got


@pytest.mark.parametrize("f64", [False, True])
def test_fused_rows_equal_jax(f64):
    """A fused `scan` group whose trees are all shared gives the JAX
    package's rows, in float32 on the quarter grid and under f64 on
    prices 1e-6 apart (where float32 would give other rows)."""
    rng = np.random.default_rng(9)
    n = 300
    if f64:
        prices = 100.0 + rng.integers(0, 40, n) * 1e-6 + \
            rng.integers(0, 8, n)
        app = "@app:devicePatterns('prefer')\n" + F64 + \
            _fused(EVERY, 12, dbl=".000001")
    else:
        prices = np.round(rng.uniform(95, 112, n) * 4) / 4
        app = _fused(EVERY, 12)
    ts = 1000 + 20 * np.arange(n)
    (k,) = _kernels(app)
    assert all(t.shared for t in k.trees) and k.nfak.f64 == f64
    got = _rows(siddhi_tpu_torch, app, prices, ts)
    want = _rows(siddhi_tpu, app, prices, ts)
    assert got == want
    assert sum(len(v) for v in got.values()) > 20
