"""The pattern algebra of the `scan` family (K3, K4, K5, K6 plain
versions) against the JAX package: counts by rank/select, logical
`and`/`or` stations through first-hits and prev-match pointers, a final
count's candidate fan-out, indexed captures and NULL rows.

The primitives first: the inclusive occurrence ranks (K6 `rank`) and the
`ge` first-hit on their max-tree (K3 `rank`, the descent of K4/K5) are
rank/select, held against a brute-force search and against the JAX
package's `_first_hit` on `_build_heap` of `jnp.cumsum`; the prev-match
pointers (K6 `prev`) against brute force and `_prev_static_scan`.  Then
whole apps through `siddhi_tpu` (`@app:devicePatterns('always')`) and
the port at device="cpu" at their default families, which must agree:
equal rows with NULLs (None) in place, tolerance 0."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import siddhi_tpu
from siddhi_tpu.core.nfa_parallel import (_build_heap, _first_hit,
                                          _prev_static_scan)
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.kernels.seg_tree import build_heap_plain, first_hit_plain
from siddhi_tpu_torch.kernels.win_scan import I64_MIN, win_scan
from siddhi_tpu_torch.replay import (C4A_BODY, C4N_BODY, C4O_BODY, STOCK,
                                     partitioned)
from siddhi_tpu_torch.weights import stateless_state_from_jax

DEV = "@app:devicePatterns('always')\n"


def _lanes(seed: int, L: int = 5, F: int = 37, p: float = 0.3):
    rng = np.random.default_rng(seed)
    mask = rng.random((L, F)) < p
    nev = rng.integers(F // 2, F + 1, size=L)
    valid = np.arange(F)[None, :] < nev[:, None]
    return mask & valid, valid


def _segments(form: str, L: int, F: int) -> dict:
    """K6's lane segments: derived from the period (the main path's form)
    or given as explicit start flags."""
    if form == "period":
        return {"period": F}
    return {"flags": torch.from_numpy((np.arange(L * F) % F) == 0)}


@pytest.mark.parametrize("form", ["period", "flags"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_select_matches_brute_force_and_jax(seed, form):
    """select(s, r): the first index >= s whose inclusive rank reaches r,
    L when none -- K6's segmented count (one segment per lane) and a `ge`
    first-hit on K3's i64 rank max-tree."""
    mask, valid = _lanes(seed)
    L, F = mask.shape
    Lt = 64
    rank = win_scan([("sum", torch.from_numpy(mask.reshape(-1)), False)],
                    L * F, use="rank", **_segments(form, L, F))[0].view(L, F)
    np.testing.assert_array_equal(rank.numpy(), np.cumsum(mask, axis=1))
    heap = build_heap_plain(rank, torch.from_numpy(valid), Lt, "max",
                            torch.int64)
    rng = np.random.default_rng(seed + 10)
    s = rng.integers(0, F + 2, size=(L, 40))
    r = rng.integers(0, 12, size=(L, 40))
    got = first_hit_plain(heap, Lt, torch.from_numpy(s),
                          torch.from_numpy(r), "ge").numpy()
    for lane in range(L):
        want = np.full(40, Lt)
        for q in range(40):
            hits = [i for i in range(max(s[lane, q], 0), F)
                    if valid[lane, i] and rank[lane, i] >= r[lane, q]]
            if hits:
                want[q] = hits[0]
        np.testing.assert_array_equal(got[lane], want)
        jheap = _build_heap(jnp.cumsum(jnp.asarray(mask[lane]).astype(
            jnp.int32)), jnp.asarray(valid[lane]), Lt, "max",
            jnp.dtype(jnp.int64))
        np.testing.assert_array_equal(np.asarray(jheap),
                                      heap[lane].numpy())
        jgot = _first_hit(jheap, Lt, jnp.asarray(s[lane].astype(np.int32)),
                          jnp.asarray(r[lane]), "ge")
        np.testing.assert_array_equal(np.asarray(jgot), got[lane])


@pytest.mark.parametrize("form", ["period", "flags"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prev_scan_matches_brute_force_and_jax(seed, form):
    """prev[t]: the last index <= t with the side's mask set -- K6's
    segmented max of the lane-local index masked by the node mask (the
    i64 minimum before the first match, where JAX holds -1).  With a
    period the kernel makes the index itself (no values); with flags it
    reads an index column."""
    mask, _valid = _lanes(seed, p=0.2)
    L, F = mask.shape
    jidx = None if form == "period" else torch.arange(F).repeat(L)
    prev = win_scan([("max", jidx, True, torch.from_numpy(mask.reshape(-1)))],
                    L * F, use="prev", **_segments(form, L, F))[0].view(
                        L, F).numpy()
    want = np.where(prev == I64_MIN, -1, prev)
    for lane in range(L):
        brute = [max([i for i in range(t + 1) if mask[lane, i]], default=-1)
                 for t in range(F)]
        np.testing.assert_array_equal(want[lane], brute)
        np.testing.assert_array_equal(
            want[lane], np.asarray(_prev_static_scan(jnp.asarray(
                mask[lane]))))


def tape_sends(keys: int, n: int, seed: int, flush: int = 512):
    rng = np.random.default_rng(seed)
    flushes = []
    for st in range(0, n, flush):
        m = min(flush, n - st)
        flushes.append((rng.integers(0, keys, size=m).astype(np.int32),
                        np.round(rng.uniform(90.0, 130.0, size=m) * 4) / 4,
                        rng.integers(1, 1000, size=m).astype(np.int32),
                        1_700_000_000_000 + np.arange(st, st + m,
                                                      dtype=np.int64)))

    def feed(rt, lo=0, hi=None):
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                         dtype=np.int32)
        for sym, price, vol, ts in flushes[lo:hi]:
            h.send_batch({"symbol": codes[sym], "price": price,
                          "volume": vol}, ts)
            rt.flush()
    feed.n_flushes = len(flushes)
    return feed


def run(pkg, app: str, feed, **kw):
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    rows: list = []
    rt.add_callback("Out", lambda evs: rows.extend(
        (e.timestamp, e.data) for e in evs))
    if pkg is siddhi_tpu:
        rt.start()
    feed(rt)
    return rows, rt


def families(jrt, trt) -> tuple:
    jf = [p.family for p in jrt._plans if isinstance(p, JPlan)]
    return jf, [p.family for p in trt.plans()]


SCAN_APPS = {
    "c4n": C4N_BODY,
    "c4o": C4O_BODY,
    "c4a": C4A_BODY,
    "two_counts_separated": (
        "from every e1=StockStream[price > 124]<1:2> -> "
        "e2=StockStream[price < 100] -> e3=StockStream[price > 126]<1:2> "
        "within 1 sec select e1[0].price as a, e2.price as b, "
        "e3[0].price as c, e3[last].price as d insert into Out;"),
    "count_mid_indices": (
        "from every e1=StockStream[price > 120] -> "
        "e2=StockStream[price > 125]<2:4> -> e3=StockStream[price < 95] "
        "within 1 sec select e1.price as a, e2[0].price as b, "
        "e2[last].price as c, e2[last-1].price as d, e2[3].price as f, "
        "e3.price as g insert into Out;"),
    "final_count": (
        "from every e1=StockStream[price > 110] -> "
        "e2=StockStream[price < 95]<2:5> within 1 sec select e1.price as a, "
        "e2[0].price as b, e2[last].price as c, e2[last-1].price as d, "
        "e2[3].price as f insert into Out;"),
    "and_then_threshold": (
        "from every e1=StockStream[price > 110] -> "
        "e2=StockStream[price < 100] and e3=StockStream[volume > 900] -> "
        "e4=StockStream[price > e2.price] within 1 sec select e1.price as a, "
        "e2.price as b, e3.volume as c, e4.price as d insert into Out;"),
    "or_then_count": (
        "from every e1=StockStream[price > 115] -> "
        "e2=StockStream[price < 95] or e3=StockStream[volume > 950] -> "
        "e4=StockStream[price > 120]<1:3> within 1 sec "
        "select e2.price as b, e3.volume as c, e4[last].price as d "
        "insert into Out;"),
}


@pytest.mark.parametrize("keys", [8, 32])
@pytest.mark.parametrize("name", sorted(SCAN_APPS))
def test_scan_apps_match_jax(name, keys):
    """At the default family both packages run `scan`; the rows are
    equal, NULLs in place."""
    app = f"@app:partitionCapacity({keys})\n" + partitioned(SCAN_APPS[name])
    feed = tape_sends(keys, 2000, seed=keys + len(name))
    want, jrt = run(siddhi_tpu, DEV + app, feed)
    got, trt = run(siddhi_tpu_torch, app, feed, device="cpu")
    assert families(jrt, trt) == (["scan"], ["scan"])
    assert got == want and got
    if name == "c4o":
        assert any(r[2] is None for _t, r in got)


def test_one_shot_count_head_unpartitioned():
    """A one-shot (non-`every`) count head on the flat block: one match
    at most, the arm resolved, equal to JAX."""
    app = STOCK + ("@info(name='q') from e1=StockStream[price > 120]<2:3> "
                   "-> e2=StockStream[price < 95] within 1 sec "
                   "select e1[0].price as a, e1[1].price as b, "
                   "e2.price as c insert into Out;")
    feed = tape_sends(4, 1500, seed=3)
    want, jrt = run(siddhi_tpu, DEV + app, feed)
    got, trt = run(siddhi_tpu_torch, app, feed, device="cpu")
    assert families(jrt, trt) == (["scan"], ["scan"])
    assert got == want and len(got) == 1


@pytest.mark.parametrize("name", ["c4n", "c4o"])
def test_stateless_state_carried_over_from_jax(name):
    """The JAX `scan` plan's replay tails and dedup seqs after half the
    tape load into the port's plan (`weights.stateless_state_from_jax`),
    which continues the tape with the JAX plan's rows."""
    app = "@app:partitionCapacity(8)\n" + partitioned(SCAN_APPS[name])
    feed = tape_sends(8, 2048, seed=5, flush=256)
    half = feed.n_flushes // 2
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    want: list = []
    jrt.add_callback("Out", lambda evs: want.extend(
        (e.timestamp, e.data) for e in evs))
    jrt.start()
    feed(jrt, 0, half)
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    assert jplan.family == "scan"
    d = stateless_state_from_jax(jplan.state_dict())
    strings, seq, n_before = jrt.strings.state(), jrt._seq, len(want)
    feed(jrt, half)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    trt.strings.restore(strings)
    trt._seq = seq
    got: list = []
    trt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, e.data) for e in evs))
    trt.plans()[0].load_state_dict(d)
    feed(trt, half)
    assert got == want[n_before:] and got


@pytest.mark.parametrize("body,reason", [
    ("from every e1=StockStream[price > 110] or e2=StockStream[price < 95] "
     "-> e3=StockStream[price > 120] within 1 sec select e3.price as c "
     "insert into Out;", "logical and/or head"),
    ("from every e1=StockStream[price > 110]<1:2> -> "
     "e2=StockStream[price < 95]<1:2> -> e3=StockStream[price > 120] "
     "within 1 sec select e3.price as c insert into Out;",
     "adjacent count"),
    ("from every e1=StockStream[price > 110] -> "
     "e2=StockStream[price < 95]<1:9> within 1 sec select e1.price as c "
     "insert into Out;", "wide count"),
    ("from every e1=StockStream[price > 110] -> "
     "e2=StockStream[price > e1.price]<1:3> -> e3=StockStream[price < 95] "
     "within 1 sec select e3.price as c insert into Out;",
     "capture-dependent filter on a count"),
    ("from every e1=StockStream[price > 110]<1:3> -> "
     "e2=StockStream[price < 95] or e3=StockStream[volume > 990] within "
     "1 sec select e1[0].price as c insert into Out;",
     "logical position after a count"),
])
def test_scan_refusals_keep_the_jax_family(body, reason):
    """Where the JAX package refuses `scan`, the port does too, with the
    same reason, and both run the same rows on another family."""
    app = "@app:partitionCapacity(8)\n" + partitioned(body)
    feed = tape_sends(8, 1024, seed=4)
    want, jrt = run(siddhi_tpu, DEV + app, feed)
    got, trt = run(siddhi_tpu_torch, app, feed, device="cpu")
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    tplan = trt.plans()[0]
    assert reason in tplan.families["scan"]
    assert tplan.families["scan"] == jplan.families["scan"]
    assert tplan.family == jplan.family
    assert got == want


def test_fused_count_lanes_and_individual_logicals_match_jax():
    """Eight same-shape count queries fuse into one multi-query plan
    (lanes = queries, `scan`, rank/select per lane); eight `and` queries
    selecting maybe-absent refs plan one by one in both packages (NULL
    routing through fused lanes is a later slice here and absent there):
    equal rows per output stream, the same plans."""
    parts = [STOCK]
    for i in range(8):
        parts.append(
            f"@info(name='q{i}') from every e1=StockStream[price > {118 + i}]"
            f"<1:2> -> e2=StockStream[price < {96 - i % 3}] within 1 sec "
            f"select e1[0].price as a, e1[last].price as b, e2.price as c "
            f"insert into Out{i % 2};")
        parts.append(
            f"@info(name='r{i}') from every e1=StockStream[price > {118 + i}]"
            f" -> e2=StockStream[price < {96 - i % 3}] and "
            f"e3=StockStream[volume > {900 + i}] within 1 sec select "
            f"e1.price as a, e2.price as b, e3.volume as c insert into "
            f"Out{2 + i % 2};")
    app = "\n".join(parts)

    def go(pkg, **kw):
        rt = pkg.SiddhiManager(**kw).create_app_runtime(
            (DEV if pkg is siddhi_tpu else "") + app)
        out: list = []
        for j in range(4):
            rt.add_callback(f"Out{j}", lambda evs, j=j: out.extend(
                (j, e.timestamp, e.data) for e in evs))
        if pkg is siddhi_tpu:
            rt.start()
        rng = np.random.default_rng(1)
        h = rt.input_handler("StockStream")
        for f in range(3):
            n = 600
            h.send_batch({"symbol": np.array(["K0"] * n),
                          "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
                          "volume": rng.integers(1, 1000, n).astype(np.int32)},
                         1_700_000_000_000 + f * n + np.arange(n))
            rt.flush()
        plans = rt._plans if pkg is siddhi_tpu else rt.plans()
        return out, sorted(type(p).__name__ for p in plans)
    want, jplans = go(siddhi_tpu)
    with pytest.warns(RuntimeWarning, match="null routing"):
        got, tplans = go(siddhi_tpu_torch, device="cpu")
    assert tplans == jplans
    assert tplans.count("MultiQueryDevicePatternPlan") == 1
    assert got == want and got
