"""The `scan` plan family of the port against siddhi_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages; every
comparison has tolerance 0.  Covered: the segment-tree build and the
first-hit descent (`_build_heap`, `_first_hit` of
siddhi_tpu.core.nfa_parallel) against the port's plain versions; one
lane-grid block and one flat block against `ParallelChainKernel.block_fn`
of the JAX package, row for row; the plan family and the `scan` entry of
`families`; output rows of whole tapes, with the scenarios of
tests/test_plan_families.py (out-of-order timestamps, a NaN threshold
column, many small flushes, a quiet lane's held tail, hot-added keys) and
a lane resuming after a long gap; a `scan` stream taken over mid-tape
through `weights.stateless_state_from_jax`.  The JAX package runs each
app under `@app:devicePatterns('prefer')`, where it runs its own `scan`
block; its rows are computed once per app and tape (`jax_rows`)."""
import copy
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core import nfa_parallel as jpar
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.autotune import AutotuneError
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.kernels.seg_tree import build_heap_plain, first_hit_plain
from siddhi_tpu_torch.weights import stateless_state_from_jax

from test_torch_pattern_e2e import APPS, C4_BODY, STOCK, part, run, tape

PREFER = "@app:devicePatterns('prefer')\n"
C3S = STOCK + ("@info(name='q') from every e1=StockStream[price > 100] -> "
               "e2=StockStream[price < 95] within 1 sec "
               "select e1.price as p1, e2.price as p2 insert into Out;")
SCAN_APPS = {"c3": APPS["c3"], "c4": APPS["c4"], "c3s": C3S,
             "sequence": APPS["sequence"], "two_stream": APPS["two_stream"]}
FAMILY_APPS = dict(APPS, c3s=C3S, **{
    "one_shot_within": STOCK + "from e1=StockStream[price > 125] -> "
                       "e2=StockStream[price > e1.price] within 1 sec "
                       "select e1.price as a, e2.price as b insert into Out;",
    "one_shot_part": STOCK + part(
        "from e1=StockStream[price > 125] -> e2=StockStream[price > "
        "e1.price] within 1 sec select e1.price as a insert into Out;"),
    "ne_threshold": STOCK + part(
        "from every e1=StockStream[price > 125] -> e2=StockStream[price != "
        "e1.price] within 1 sec select e1.price as a insert into Out;"),
    "le_long": "define stream S (k string, x long, y int);\n" + part(
        "from every e1=S[x > 3] -> e2=S[x <= e1.y] within 1 sec "
        "select e1.x as a, e2.x as b insert into Out;", "k of S"),
})


# ---------------------------------------------------------------------------
# segment tree and first-hit
# ---------------------------------------------------------------------------

DTYPES = {"i32": np.int32, "i64": np.int64, "f32": np.float32,
          "f64": np.float64}
TORCH = {np.int32: torch.int32, np.int64: torch.int64,
         np.float32: torch.float32, np.float64: torch.float64}
F_LEAVES, L_LEAVES = 100, 128


def _leaves(dt, seed=0):
    """100 seeded leaf values with duplicates and extremes (NaN for
    floats), and a mask."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-6, 7, F_LEAVES).astype(dt)
    if np.issubdtype(dt, np.floating):
        v = (v / 4).astype(dt)
        v[rng.integers(0, F_LEAVES, 6)] = np.nan
    else:
        v[3] = np.iinfo(np.int32).min
        v[5] = np.iinfo(np.int32).max
    return v, rng.random(F_LEAVES) < 0.7


def _jax_heap(dt, agg):
    v, m = _leaves(dt)
    return np.asarray(jpar._build_heap(jnp.asarray(v), jnp.asarray(m),
                                       L_LEAVES, agg, jnp.dtype(dt)))


@pytest.mark.parametrize("agg", ["max", "min"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_build_heap_matches_jax(dt, agg):
    v, m = _leaves(DTYPES[dt])
    got = build_heap_plain(torch.from_numpy(v)[None], torch.from_numpy(m)[None],
                           L_LEAVES, agg, TORCH[DTYPES[dt]])[0].numpy()
    np.testing.assert_array_equal(got, _jax_heap(DTYPES[dt], agg))
    assert not np.isnan(got).any()


@pytest.mark.parametrize("op", ["gt", "ge", "lt", "le"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_first_hit_matches_jax(dt, op):
    """Queries from s = 0, F-1, F, past F and past the leaves, against
    values in the leaves (ties), INT32_MIN, 0 and NaN right-hand sides:
    equal to a brute-force scan of the leaves, and to the JAX package's
    descent.  One known exception, a fault of the JAX package (ROADMAP
    section C): XLA's CPU back end flushes denormals, so its `>=`/`<=`
    rewrite against nextafter(0) -- a denormal -- misses leaves equal to
    0; there the port keeps the exact comparison.  An int32 tree's `>=`
    against INT32_MIN wraps (v - 1) in both packages: that is why a
    threshold tree over int32 is widened to int64 (`tree_vt`), and the
    i64 case holds the INT32_MIN right-hand side exactly."""
    npdt = DTYPES[dt]
    heap = _jax_heap(npdt, "max" if op in ("gt", "ge") else "min")
    rng = np.random.default_rng(1)
    Q = 64
    s = np.concatenate([[0, F_LEAVES - 1, F_LEAVES, F_LEAVES + 7, L_LEAVES,
                         L_LEAVES + 3], rng.integers(0, F_LEAVES, Q - 6)]
                       ).astype(np.int32)
    v = rng.integers(-7, 8, Q).astype(npdt)
    if np.issubdtype(npdt, np.floating):
        v = (v / 4).astype(npdt)
        v[7] = np.nan
    v[8] = np.iinfo(np.int32).min
    v[9] = 0
    want = np.asarray(jpar._first_hit(jnp.asarray(heap), L_LEAVES,
                                      jnp.asarray(s), jnp.asarray(v), op))
    got = first_hit_plain(torch.from_numpy(heap.copy())[None], L_LEAVES,
                          torch.from_numpy(s)[None], torch.from_numpy(v)[None],
                          op)[0].numpy()
    vals, mask = _leaves(npdt)
    keep = mask & ~np.isnan(vals) if np.issubdtype(npdt, np.floating) \
        else mask
    cmp = {"gt": np.greater, "ge": np.greater_equal, "lt": np.less,
           "le": np.less_equal}[op]
    exact = np.array([next((j for j in range(max(int(q), 0), F_LEAVES)
                            if keep[j] and cmp(vals[j], x)), L_LEAVES)
                      for q, x in zip(s, v)])
    wraps = (npdt == np.int32) & (op == "ge") & (v == np.iinfo(np.int32).min)
    np.testing.assert_array_equal(got[~wraps], exact[~wraps])
    flushed = np.issubdtype(npdt, np.floating) & (op in ("ge", "le")) & \
        (v == 0)
    np.testing.assert_array_equal(got[~flushed], want[~flushed])
    assert (got < F_LEAVES).any() and (got == L_LEAVES).any()


# ---------------------------------------------------------------------------
# one block against the JAX block
# ---------------------------------------------------------------------------

def _plans(app):
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(app)
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    prt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    return jplan, prt.plans()[0]


@pytest.mark.parametrize("lanes", [True, False], ids=["c4_lanes", "c3_flat"])
def test_block_matches_jax_block_fn(lanes):
    """Seeded (L, F) grids (empty lanes, nev < F, prev_seq cutting some
    completions, timestamps that let the `within` killer fire): the
    port's match table unpacks to the JAX block's rows, in the same
    order, and to the same per-lane counts."""
    app = ("@app:partitionCapacity(16)\n" + STOCK + part(C4_BODY) if lanes
           else PREFER + APPS["c3"])
    jplan, pplan = _plans(app)
    assert jplan.family == pplan.family == "scan"
    rng = np.random.default_rng(3)
    L, F = (16, 200) if lanes else (1, 3000)
    nev = rng.integers(0, F + 1, L).astype(np.int32)
    if lanes:
        nev[0], nev[1], nev[2] = 0, F, F
    ts = np.cumsum(rng.integers(0, 120 if lanes else 1, (L, F)), 1
                   ).astype(np.int32)
    seq = np.arange(L * F, dtype=np.int32).reshape(L, F)
    prev = np.full(L, -(1 << 30), np.int32)
    prev[1::3] = seq[1::3, F // 3]
    price = (np.round(rng.uniform(90, 130, (L, F)) * 4) / 4).astype(
        np.float32)
    base = 1_700_000_000_000
    ev = {"__flat.__ts__": ts, "__flat.__seq__": seq, "__nev__": nev,
          "__prev_seq__": prev, "__flat.0.price": price}
    kern = jplan._parallel_kernel()
    jev = dict(ev, __base_ts__=np.int64(base), __base_seq__=np.int64(0))
    if not lanes:
        jev = {k: (v[0] if k.startswith("__flat.") or v.ndim == 1 else v)
               for k, v in jev.items()}
    jout = kern.block_fn((L, F) if lanes else F, F)({}, jev)[1]
    ipack = np.asarray(jout["i"])
    fpack = np.asarray(jout["f"]) if "f" in jout else None
    jplan._ts_base, jplan._seq_base = base, 0
    want = (jplan._unpack_lanes(ipack, fpack) if lanes
            else jplan._unpack_block(ipack, fpack, int(ipack[0, 0])))
    tev = {k: torch.from_numpy(v) for k, v in ev.items()}
    tev.update(__base_ts__=base, __base_seq__=0)
    out = pplan._par_kern.run_block(tev, L * F)
    pplan._ts_base, pplan._seq_base = base, 0
    got = pplan._unpack(out, int(out["meta"][0]))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert sorted(got[3]) == sorted(want[3])
    for nm in got[3]:
        np.testing.assert_array_equal(got[3][nm], want[3][nm])
    jn = ipack[:, 0, 0] if lanes else ipack[0, :1]
    np.testing.assert_array_equal(out["lane_n"].numpy(), jn)
    assert len(got[0]) > 20 and (jn < nev).any()


# ---------------------------------------------------------------------------
# family selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FAMILY_APPS))
def test_family_matches_jax(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jplan, pplan = _plans(PREFER + FAMILY_APPS[name])
    assert pplan.family == jplan.family
    assert pplan.families["scan"] == jplan.families["scan"]
    assert pplan.families["seq"] is True
    if name in ("c3", "c4", "sequence", "two_stream", "c3s",
                "one_shot_within", "le_long"):
        assert pplan.family == "scan"
    assert pplan.families["dfa"] == jplan.families["dfa"]
    assert pplan.families["chunk"] == jplan.families["chunk"]


def test_forced_families():
    """`seq` and `scan` can be asked for; `scan` on an ineligible shape
    warns and falls back; an unknown name is a build error."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_app_runtime("@app:patternFamily('seq')\n" + APPS["c4"])
    assert rt.plans()[0].family == "seq"
    rt = mgr.create_app_runtime("@app:patternFamily('scan')\n" + APPS["c4"])
    assert rt.plans()[0].family == "scan"
    with pytest.warns(RuntimeWarning, match="not eligible"):
        rt = mgr.create_app_runtime("@app:patternFamily('scan')\n" +
                                    APPS["having"])
    assert rt.plans()[0].family == "seq"
    with pytest.raises(AutotuneError, match="unknown family"):
        mgr.create_app_runtime("@app:patternFamily('warp')\n" + APPS["c4"])
    assert issubclass(AutotuneError, PlanError)


def test_unpartitioned_scan_runs_as_one_lane():
    """An unpartitioned `scan` plan is the lane grid with one lane: its
    state is lane 0's replay tail and last completion seq, and it never
    drops a head."""
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        APPS["c3"])
    plan = rt.plans()[0]
    assert plan.family == "scan"
    for sid, cols, ts in tape("c3", flushes=2, n=50):
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    d = plan.state_dict()
    assert set(d["lane_tail"]["part"].tolist()) == {0}
    assert d["lane_prev"].tolist() == [int(d["lane_tail"]["seq"].max())]
    assert plan.dropped == 0


# ---------------------------------------------------------------------------
# rows of whole tapes
# ---------------------------------------------------------------------------

def _one_key(prices, dts, key="K"):
    """One flush of one key: [(stream, columns, timestamps)]."""
    n = len(prices)
    return [("StockStream", {"symbol": np.array([key] * n),
                             "price": np.array(prices, dtype=np.float64),
                             "volume": np.ones(n, np.int32)},
             1_700_000_000_000 + np.array(dts, dtype=np.int64))]


def _out_of_order(name):
    """The app's tape with 10% of the timestamps moved up to 3 s back or
    forward."""
    sends = tape(name, seed=5)
    rng = np.random.default_rng(5)
    out = []
    for sid, cols, ts in sends:
        ts = ts.copy()
        hit = rng.random(len(ts)) < 0.1
        ts[hit] += rng.integers(-3000, 3000, int(hit.sum()))
        out.append((sid, cols, ts))
    return out


def _small_flushes(name):
    """15 flushes of 60 events 9 ms apart: the tail spans flushes."""
    return [(sid, cols, ts[0] + (ts - ts[0]) * 9 // 7)
            for sid, cols, ts in tape(name.split("_")[0], flushes=15, n=60,
                                      seed=8)]


def _nan_tape(name):
    sends = tape(name, seed=9)
    rng = np.random.default_rng(9)
    for _sid, cols, _ts in sends:
        if "price" in cols:
            cols["price"][rng.random(len(cols["price"])) < 0.05] = np.nan
    return sends


def _hot_keys(_name):
    """Keys K0-K4 in the first flush, K0-K7 in the next two."""
    sends = tape("c4", flushes=3, n=300, seed=10)
    for i, (_sid, cols, _ts) in enumerate(sends):
        cols["symbol"] = np.array([f"K{int(k[1:]) % (5 if i == 0 else 8)}"
                                   for k in cols["symbol"]])
    return sends


def _quiet_lane(_name):
    """Key A arms a head, a flush where only B speaks (A's tail is held
    aside), then A completes from its held tail."""
    return (_one_key([110.0], [0], "A") + _one_key([101.0], [1], "B")
            + _one_key([102.0], [2], "B")
            + _one_key([120.0, 130.0], [3, 4], "A"))


def _long_gap(_name):
    """Keys K8-K15 go quiet for 2^31 ms while K0-K7 speak, then resume:
    their held tails come back with offsets that saturate low (expired,
    already deduped) instead of pinning the live lanes' bases."""
    first, second, third = tape("c4", flushes=3, n=300, seed=11)
    gap = 1 << 31
    sid, cols, ts = second
    cols["symbol"] = np.array([f"K{int(k[1:]) % 8}" for k in cols["symbol"]])
    return [first, (sid, cols, ts + gap), (third[0], third[1],
                                            third[2] + gap)]


SCENARIOS = {
    # two_stream's plain tape is test_torch_pattern_e2e's default case
    "tape": (["c3", "c4", "c3s", "sequence"],
             lambda n: tape(n if n != "c3s" else "c3")),
    "out_of_order": (["c3", "c4", "c3s", "two_stream"], _out_of_order),
    "out_of_order_kill": (["c3"], lambda _n: _one_key(
        [101.0, 50.0, 150.0, 102.0, 103.0], [0, 2000, 500, 2100, 2200])),
    "nan_threshold": (["c3", "c4"], _nan_tape),
    "nan_threshold_one_key": (["c3"], lambda _n: _one_key(
        [101.0, 90.0, 91.0, 92.0, np.nan, 150.0, 93.0, 94.0, 95.0, 160.0,
         96.0, 97.0], [10 * i for i in range(12)])),
    "small_flushes": (["c3", "c4_1s", "sequence"], _small_flushes),
    "quiet_lane": (["c4_hour"], _quiet_lane),
    "hot_keys": (["c4"], _hot_keys),
    "long_gap": (["c4"], _long_gap),
}
TAPE_APPS = dict(SCAN_APPS, c4_hour=APPS["c4"].replace("within 10 sec",
                                                       "within 1 hour"),
                 c4_1s=APPS["c4"].replace("within 10 sec", "within 1 sec"))
CASES = [(s, a) for s, (apps, _f) in SCENARIOS.items() for a in apps]


def _sends(scenario, app):
    return SCENARIOS[scenario][1](app)


@functools.lru_cache(maxsize=None)
def jax_rows(scenario: str, app: str):
    """The JAX package's `scan` rows for one scenario, and what the port
    needs to take over after the first half of the tape (state_dict,
    string table, event seq, rows so far)."""
    sends = _sends(scenario, app)
    rt = siddhi_tpu.SiddhiManager().create_app_runtime(PREFER +
                                                       TAPE_APPS[app])
    jplan = next(p for p in rt._plans if isinstance(p, JPlan))
    assert jplan.family == "scan"
    out, carried = [], None
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    for i, (sid, cols, ts) in enumerate(sends):
        if i == len(sends) // 2:
            # deep copy: the JAX state_dict hands out `lane_prev` itself,
            # which the next flushes update in place
            carried = (copy.deepcopy(jplan.state_dict()),
                       rt.strings.state(), rt._seq, len(out))
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    return out, carried


@pytest.mark.parametrize("scenario,app", CASES)
def test_rows_equal_jax(scenario, app):
    got, rt = run(siddhi_tpu_torch, TAPE_APPS[app], _sends(scenario, app),
                  device="cpu")
    plan = rt.plans()[0]
    assert plan.family == "scan"
    want = jax_rows(scenario, app)[0]
    assert len(got) == len(want)
    assert got == want
    if scenario == "out_of_order_kill":
        assert [d for _t, d in got] == [(102.0, 103.0)]
    elif scenario == "nan_threshold_one_key":
        assert [d for _t, d in got] == [(101.0, 150.0), (150.0, 160.0)]
    elif scenario == "quiet_lane":
        assert (110.0, 120.0, 130.0) in [d for _t, d in got]
    else:
        assert len(got) > 10
    if scenario == "hot_keys":
        assert len(plan._key_to_part) == 8
    if scenario == "long_gap":
        assert plan._ts_base > int(_sends(scenario, app)[0][2][-1]) + (1 << 30)


def test_quiet_lane_tail_is_held_aside():
    """While only B speaks, A's tail stays out of the grid but is kept."""
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        TAPE_APPS["c4_hour"])
    plan = rt.plans()[0]
    lanes = []
    orig = plan._par_kern.run_block

    def spy(ev, M):
        lanes.append(ev["__nev__"].shape[0])
        return orig(ev, M)
    plan._par_kern.run_block = spy
    for sid, cols, ts in _quiet_lane("c4_hour")[:3]:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    assert lanes == [1, 1, 1]
    assert len(set(plan._lane_tail["part"].tolist())) == 2


@pytest.mark.parametrize("app", ["c4", "c3"])
def test_scan_state_carried_from_jax(app):
    """The first half of the tape on the JAX package's `scan` plan, its
    replay tails and dedup seqs carried into the port's, the second half
    on the port: equal to the JAX package's rows for the whole tape."""
    sends = _sends("tape", app)
    want, (d, strings, seq, n_before) = jax_rows("tape", app)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        TAPE_APPS[app])
    rt.strings.restore(strings)
    rt._seq = seq
    plan = rt.plans()[0]
    plan.load_state_dict(stateless_state_from_jax(d))
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, e.data) for e in evs))
    for sid, cols, ts in sends[len(sends) // 2:]:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    assert got == want[n_before:] and got
    # a `seq` plan's slot state cannot continue a stateless plan
    with pytest.raises(ValueError, match="stateless"):
        plan.load_state_dict({"state": {}, "key_to_part": {}})


LONG_CHAIN = STOCK + part(
    "from every e1=StockStream[price > 120] -> " + " -> ".join(
        f"e{i}=StockStream[price > e{i - 1}.price - {i}.0]"
        for i in range(2, 11)) +
    " within 10 sec select " + ", ".join(
        f"e{i}.price as p{i}, e{i}.volume as v{i}, e{i}.symbol as s{i}"
        for i in range(1, 11)) +
    " insert into Out;")


def test_scan_past_the_old_kernel_limits_runs_scan():
    """A chain past the fixed parameter blocks the scan kernels had (8
    positions, 9 trees, 32 match-table rows) runs the `scan` family in
    both packages -- the kernels take their programs, trees, loads and
    row sources from device tables now -- with equal rows.  Its nine
    hops' `price` max-trees gate the same leaves (one stream, no
    pre-mask), so the plan builds one of them beside the timestamp tree
    (tests/test_torch_k34_tiles.py has a chain of ten distinct trees)."""
    sends = tape("c4", flushes=2, n=300, seed=7)
    jax_out, jrt = run(siddhi_tpu, PREFER + LONG_CHAIN, sends)
    got, rt = run(siddhi_tpu_torch, LONG_CHAIN, sends, device="cpu")
    plan = rt.plans()[0]
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    assert plan.family == jplan.family == "scan"
    kern = plan._par_kern
    assert kern.S == 10 and len(kern.trees) == 2
    assert {h.tree for h in kern.hops} == {1}
    assert sum(map(len, kern.rows.values())) == 33
    assert got == jax_out and len(got) > 5
