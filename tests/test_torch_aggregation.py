"""Incremental aggregation of the port against siddhi_tpu on the CPU.

The same sends, made from a numpy seed, go through `siddhi_tpu` (JAX on
the CPU: its device-resident step by default, its host reduce under
`@app:deviceAggregations('off')`, its per-batch device reduce under
`'always'`) and through `siddhi_tpu_torch` on `device="cpu"` (K10's and
K6's plain versions).  Stores compare as `state_dict()`, the JAX one after
`agg_state_from_jax` maps its string codes; query rows compare in order.

Tolerance 0 wherever both sides fold in the same order: the default path
(each segment in batch order on both sides, merged as `old op new`), the
host path (the same numpy code), the fold-order canaries, carried state
and the matrix app.  The `'always'` path scans in another order than
JAX's associative scan, so it equals JAX with tolerance 0 only where every
f64 prefix is exact (the quarter grid); on raw doubles its counts, min
and max stay exact and each sum is within (len - 1) 2^-53 sum|v| of the
exact sum on either side, so the two within twice that.
"""
import math

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.planner import PlanError as JPlanError

import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.kernels.agg_merge import agg_merge_plain
from siddhi_tpu_torch.kernels.win_scan import win_scan_plain
from siddhi_tpu_torch.query.ast import Duration
from siddhi_tpu_torch.replay import (MATRIX_APP, MATRIX_PERS, matrix_query,
                                     matrix_tape)
from siddhi_tpu_torch.weights import agg_state_from_jax

OFF = "@app:deviceAggregations('off')\n"
ALWAYS = "@app:deviceAggregations('always')\n"


def _app(select, group_by, durations, header="", agg_header=""):
    gb = f"group by {group_by}\n" if group_by else ""
    return (f"{header}"
            f"define stream S (k string, k2 string, v double, w double, "
            f"ts long);\n"
            f"{agg_header}"
            f"define aggregation A\nfrom S\nselect {select}\n{gb}"
            f"aggregate by ts every {durations};\n")


def _rows(rng, n, nk=4, nk2=3, span_ms=400_000):
    """n events over ~span_ms of event time, raw uniform doubles."""
    ts0 = 1_700_000_000_000
    ts = np.sort(ts0 + rng.integers(0, span_ms, n))
    return [(f"K{rng.integers(0, nk)}", f"G{rng.integers(0, nk2)}",
             float(rng.uniform(-50, 150)), float(rng.uniform(0, 9)),
             int(t)) for t in ts]


def _runtime(pkg, app):
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    mgr = pkg.SiddhiManager(**kw)
    return mgr, mgr.create_app_runtime(app)


def _feed(rt, rows, stream="S"):
    rt.input_handler(stream).send(rows)
    rt.flush()


def _run(pkg, app, batches, agg_id="A"):
    mgr, rt = _runtime(pkg, app)
    rt.start()
    for b in batches:
        _feed(rt, b)
    return rt, rt.aggregations[agg_id]


def _jax_state(jrt, prt, agg_id="A"):
    """The JAX store in the port's string codes."""
    return agg_state_from_jax(jrt.aggregations[agg_id].state_dict(),
                              jrt.strings, prt.strings,
                              prt.aggregations[agg_id].string_keys)


def _same_nan(a, b) -> bool:
    """Stores equal, NaN equal to NaN (and -0.0 apart from +0.0)."""
    if a.keys() != b.keys():
        return False
    for dv in a:
        if a[dv].keys() != b[dv].keys():
            return False
        for k in a[dv]:
            for x, y in zip(a[dv][k], b[dv][k]):
                if not (math.isnan(x) and math.isnan(y)) and \
                        (x != y or math.copysign(1, x) != math.copysign(1, y)):
                    return False
    return True


# ---------------------------------------------------------------------------
# the forced-path matrix (tests/test_aggregation_device.py:58-65): every
# base, group-by arity 0/1/2, duration ladders up to `day`
# ---------------------------------------------------------------------------

MATRIX = [
    ("sum(v) as s", "k", "sec, min"),
    ("avg(v) as a", "k, k2", "sec, min, hour"),
    ("min(v) as lo, max(v) as hi", None, "sec"),
    ("count() as n", "k", "sec, min"),
    ("sum(v) as s, avg(w) as a, min(v) as lo, max(w) as hi, count() as n",
     "k, k2", "sec, min, hour, day"),
    ("sum(v) as s, avg(v) as a", None, "sec, min"),
]


@pytest.mark.parametrize("header,path", [("", "device-resident"),
                                         (OFF, "host")])
@pytest.mark.parametrize("select,group_by,durations", MATRIX)
def test_forced_path_matrix_equals_jax(select, group_by, durations, header,
                                       path):
    batches = [_rows(np.random.default_rng(17 + i), 257 + 31 * i)
               for i in range(4)]
    app = _app(select, group_by, durations, header=header)
    prt, pagg = _run(siddhi_tpu_torch, app, batches)
    jrt, _ = _run(siddhi_tpu, app, batches)
    assert prt.explain()["aggregations"]["A"]["path"] == path
    assert pagg.state_dict() == _jax_state(jrt, prt)


def test_default_and_host_paths_are_byte_identical():
    """The port's own two paths agree bit for bit (K10's plain fold and
    the numpy reduce fold each segment in batch order)."""
    sel = "sum(v) as s, avg(w) as a, min(v) as lo, max(w) as hi, count() as n"
    batches = [_rows(np.random.default_rng(40 + i), 300) for i in range(3)]
    _, dev = _run(siddhi_tpu_torch, _app(sel, "k, k2", "sec, min, hour"),
                  batches)
    _, host = _run(siddhi_tpu_torch, _app(sel, "k, k2", "sec, min, hour",
                                          header=OFF), batches)
    assert dev.device_plan is not None and host.device_plan is None
    assert dev.state_dict() == host.state_dict()


# ---------------------------------------------------------------------------
# fold-order canaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("header", ["", OFF])
def test_sum_folds_in_event_order(header):
    """[1e16, 1, -1e16, 1] in one segment: 1.0 folded in order (JAX's
    segment_sum and bincount both give it)."""
    rows = [("A", "x", v, 0.0, 1000 + i)
            for i, v in enumerate([1e16, 1.0, -1e16, 1.0])]
    app = _app("sum(v) as s", "k", "sec", header=header)
    prt, pagg = _run(siddhi_tpu_torch, app, [rows])
    jrt, _ = _run(siddhi_tpu, app, [rows])
    assert pagg.state_dict() == _jax_state(jrt, prt)
    assert pagg.state_dict()["store"]["sec"][(1000, (1,))] == [1.0]


def test_nan_and_signed_zeros_in_min_max_equal_jax():
    """NaN propagates through min and max, -0.0 is below +0.0 in either
    order (jnp.minimum/maximum), over several batches so the merge sees
    them too."""
    vals = [[0.0, -0.0, 1.5], [-0.0, 0.0], [2.0, float("nan"), -1.0],
            [float("nan"), 3.0], [-0.0], [0.0]]
    keys = ["A", "B", "C", "D", "E", "E"]
    batches = [[(k, "x", v, -v, 1000 + 10 * j + i)
                for i, v in enumerate(vs)]
               for j, (k, vs) in enumerate(zip(keys, vals))]
    app = _app("min(v) as lo, max(v) as hi, min(w) as lo2, max(w) as hi2",
               "k", "sec, min")
    prt, pagg = _run(siddhi_tpu_torch, app, batches)
    jrt, _ = _run(siddhi_tpu, app, batches)
    got, want = pagg.state_dict(), _jax_state(jrt, prt)
    assert _same_nan(got["store"], want["store"])
    lo = got["store"]["sec"][(1000, (prt.strings.encode("A"),))][0]
    assert lo == 0.0 and math.copysign(1, lo) < 0


def _pmin(a, x):
    """jnp.minimum on Python floats."""
    return a if (a != a or a < x or (a == x and math.copysign(1, a) < 0)) \
        else x


def _pmax(a, x):
    return a if (a != a or a > x or (a == x and math.copysign(1, a) > 0)) \
        else x


def _op(op, a, x):
    return _pmin(a, x) if op == "min" else _pmax(a, x) if op == "max" \
        else a + x


def _fold(ops, segs, vals):
    """Brute-force sequential folds: per segment (event indices in order)
    and base, Python floats from the identity."""
    ident = {"sum": 0.0, "count": 0.0, "min": math.inf, "max": -math.inf}
    out = []
    for seg in segs:
        row = []
        for op, r in ops:
            a = ident[op]
            for e in seg:
                a = _op(op, a, 1.0 if op == "count" else float(vals[r][e]))
            row.append(a)
        out.append(row)
    return out


def _segments(rng, lens):
    """(order, seg_off, segs): segments of the given lengths over shuffled
    event indices, each segment's events in increasing (batch) order."""
    n = int(sum(lens))
    perm = rng.permutation(n)
    segs, off = [], [0]
    for ln in lens:
        segs.append(sorted(perm[off[-1]:off[-1] + ln].tolist()))
        off.append(off[-1] + ln)
    order = np.concatenate([np.asarray(s, np.int64) for s in segs])
    return order, np.asarray(off), segs


@pytest.mark.parametrize("lens", [[1, 3, 2, 7, 1] * 8,            # vectorized
                                  [3] * 20 + [40, 90, 700],       # host tail
                                  [2000]])                        # one chain
def test_plain_merge_folds_each_segment_in_order(lens):
    rng = np.random.default_rng(len(lens))
    order, off, segs = _segments(rng, lens)
    n, m = len(order), len(lens)
    vals = rng.uniform(-1, 1, (2, n)) * np.exp(rng.uniform(-30, 30, (2, n)))
    vals[0, rng.integers(0, n, 3)] = np.nan
    vals[1, rng.integers(0, n, 5)] = -0.0
    ops = [("sum", 0), ("count", -1), ("min", 1), ("max", 0), ("sum", 1)]
    cap = 2 * m
    pre = rng.uniform(-5, 5, (cap, len(ops)))
    slot = rng.permutation(cap)[:m]
    fresh = rng.integers(0, 2, m)
    bases = torch.from_numpy(pre.copy())
    agg_merge_plain(bases, torch.from_numpy(vals),
                    torch.from_numpy(order.astype(np.int32)),
                    torch.from_numpy(off.astype(np.int32)),
                    torch.from_numpy(slot.astype(np.int32)),
                    torch.from_numpy(fresh.astype(np.int32)),
                    [o for o, _ in ops], [r for _, r in ops])
    want = pre.copy()
    for j, part in enumerate(_fold(ops, segs, vals)):
        if not fresh[j]:
            part = [_op(op, o, x) for (op, _r), o, x in
                    zip(ops, want[slot[j]].tolist(), part)]
        want[slot[j]] = part
    got = bases.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert np.array_equal(np.signbit(got), np.signbit(want))


def test_plain_merge_differs_from_a_reversed_fold():
    """The canary can fail: folding [1e16, 1, -1e16, 1] backwards gives 0,
    the plain version's forward fold 1."""
    vals = torch.tensor([[1e16, 1.0, -1e16, 1.0]], dtype=torch.float64)
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    fwd = agg_merge_plain(torch.zeros(1, 1, dtype=torch.float64), vals,
                          i32(0, 1, 2, 3), i32(0, 4), i32(0), i32(1),
                          ["sum"], [0])
    rev = agg_merge_plain(torch.zeros(1, 1, dtype=torch.float64), vals,
                          i32(3, 2, 1, 0), i32(0, 4), i32(0), i32(1),
                          ["sum"], [0])
    assert float(fwd[0, 0]) == 1.0 and float(rev[0, 0]) == 0.0


def test_win_scan_agg_min_max_follow_jnp():
    """K6's min/max plain columns: NaN propagates, -0.0 below +0.0
    in either order, resets at the flags."""
    x = torch.tensor([0.0, -0.0, 2.0, -0.0, 0.0, float("nan"), 1.0, 0.5],
                     dtype=torch.float64)
    flags = torch.tensor([1, 0, 0, 1, 0, 1, 0, 1], dtype=torch.bool)
    lo, hi = win_scan_plain([("min", x, False), ("max", x, False)], 8,
                            flags=flags)
    assert lo.tolist()[:5] == [0.0, -0.0, -0.0, -0.0, -0.0]
    assert torch.signbit(lo[:5]).tolist() == [False, True, True, True, True]
    assert hi.tolist()[:5] == [0.0, 0.0, 2.0, -0.0, 0.0]
    assert torch.signbit(hi[:5]).tolist() == [False, False, False, True,
                                              False]
    assert math.isnan(lo[5]) and math.isnan(lo[6]) and lo[7] == 0.5
    assert math.isnan(hi[6])


# ---------------------------------------------------------------------------
# the per-batch device path ('always')
# ---------------------------------------------------------------------------

_ALWAYS_BODY = """
define stream Trades (sym string, price double, vol long);
define aggregation TradeAgg
from Trades select sym, sum(price) as total, avg(price) as ap,
                  min(price) as lo, max(price) as hi, count() as n
group by sym
aggregate every sec, min, hour;
"""


def _always_sends(rng, quarter: bool):
    """tests/test_aggregation.py:156-185's sends (quarter-grid prices in
    [10, 50), one hour of arrival times); raw doubles when not `quarter`."""
    sends = []
    for _ in range(500):
        p = float(rng.uniform(10, 50))
        sends.append((f"S{int(rng.integers(6))}",
                      float(np.round(p * 4) / 4) if quarter else p,
                      int(rng.integers(1, 100)),
                      1_700_000_000_000 + int(rng.integers(0, 3_600_000))))
    return sends


def _run_always(pkg, sends, header=ALWAYS):
    mgr, rt = _runtime(pkg, header + _ALWAYS_BODY)
    h = rt.input_handler("Trades")
    rt.start()
    for i, (sym, p, v, ts) in enumerate(sends):
        h.send((sym, p, v), timestamp=ts)
        if i % 97 == 96:
            rt.flush()
    rt.flush()
    return rt


def test_always_path_equals_jax_on_the_quarter_grid():
    sends = _always_sends(np.random.default_rng(9), quarter=True)
    prt = _run_always(siddhi_tpu_torch, sends)
    jrt = _run_always(siddhi_tpu, sends)
    assert prt.explain()["aggregations"]["TradeAgg"]["path"] == "device-batch"
    assert prt.aggregations["TradeAgg"].state_dict() == \
        _jax_state(jrt, prt, "TradeAgg")
    q = ("from TradeAgg within 1700000000000L, 1800000000000L per '{}' "
         "select sym, total, ap, lo, hi, n")
    for per in ("sec", "min", "hours"):
        assert prt.query(q.format(per)) == jrt.query(q.format(per))


@pytest.mark.parametrize("group_by,durations", [
    ("k", "sec, min, hour"), ("k, k2", "sec, min"), (None, "sec, hour")])
def test_reduce_device_equals_the_jax_program(group_by, durations):
    """Row 10 alone: the port's `_reduce_device` (chained stable sorts,
    segment starts, K6 `agg`) against the JAX package's jitted program on
    the same batch: the same segments in the same order, the same first
    rows and bucket starts, and equal bases (quarter-grid values: every
    f64 prefix exact)."""
    sel = "sum(v) as s, avg(w) as a, min(v) as lo, max(w) as hi, count() as n"
    app = _app(sel, group_by, durations, header=ALWAYS)
    p = _runtime(siddhi_tpu_torch, app)[1].aggregations["A"]
    j = _runtime(siddhi_tpu, app)[1].aggregations["A"]
    rng = np.random.default_rng(len(durations))
    n = 1500
    ts = np.sort(1_700_000_000_000 + rng.integers(0, 200_000, n))
    gints = [rng.integers(0, 5, n).astype(np.int64)
             for _ in (group_by or "").split(",") if group_by]
    cols = {c: np.round(rng.uniform(-50, 150, n) * 4) / 4 for c in "vw"}
    # the JAX program takes a value column per site, the port one per
    # distinct argument (counts none)
    got = p._reduce_device(ts, gints, [cols[s.arg] for s in p.row_sites])
    want = j._reduce_device(ts, gints, [
        np.ones(n) if s.name == "count" else cols[s.arg] for s in p.sites])
    for dur, (gb, gr, gred), (wb, wr, wred) in zip(p.durations, got, want):
        w = dur.approx_millis
        segs = np.stack([ts // w * w, *gints], axis=1)
        assert len(gr) == len(np.unique(segs, axis=0))
        assert np.array_equal(gb, wb) and np.array_equal(gr, wr)
        for a, b in zip(gred, wred):
            assert np.array_equal(a, np.asarray(b))


def test_always_path_within_the_fold_bound_on_raw_doubles():
    sends = _always_sends(np.random.default_rng(10), quarter=False)
    prt = _run_always(siddhi_tpu_torch, sends)
    jrt = _run_always(siddhi_tpu, sends)
    got = prt.aggregations["TradeAgg"].state_dict()["store"]
    want = _jax_state(jrt, prt, "TradeAgg")["store"]
    # each segment's count and sum of |v| over the f32-rounded prices
    stats: dict = {}
    for sym, p, _v, ts in sends:
        for dur in (Duration.SECONDS, Duration.MINUTES, Duration.HOURS):
            w = dur.approx_millis
            k = (dur.value, (ts // w * w, (prt.strings.encode(sym),)))
            c, s = stats.get(k, (0, 0.0))
            stats[k] = (c + 1, s + abs(float(np.float32(p))))
    assert got.keys() == want.keys()
    checked = 0
    for dv in got:
        assert got[dv].keys() == want[dv].keys()
        for key, g in got[dv].items():
            w_ = want[dv][key]
            n, sabs = stats[(dv, key)]
            # total, ap's sum: within twice the one-sided fold bound
            for i in (0, 1):
                assert abs(g[i] - w_[i]) <= 2 * (n - 1) * 2.0 ** -53 * sabs
            assert g[2:] == w_[2:]          # count, min, max, count
            checked += 1
    assert checked > 100


# ---------------------------------------------------------------------------
# lifecycle (tests/test_aggregation_device.py:104-290)
# ---------------------------------------------------------------------------

def test_incremental_merge_across_batches():
    app = _app("k, sum(v) as s, min(v) as lo, max(v) as hi, count() as n",
               "k", "sec")
    rows1 = [("A", "x", 10.25, 0.0, 1000), ("A", "x", 2.5, 0.0, 1500)]
    rows2 = [("A", "x", -4.0, 0.0, 1200), ("A", "x", 100.0, 0.0, 1900)]
    rt, agg = _run(siddhi_tpu_torch, app, [rows1, rows2])
    rows = rt.query("from A within 0L, 10000L per 'sec' "
                    "select k, s, lo, hi, n")
    assert rows == [(1000, ("A", 108.75, -4.0, 100.0, 4))]
    assert agg.device_plan.live_buckets(Duration.SECONDS) == 1


@pytest.mark.parametrize("header", ["", OFF])
def test_purge_evicts_old_buckets(header):
    rows = ([("A", "x", 1.0, 0.0, 1_000)] + [("A", "x", 2.0, 0.0, 5_000)] +
            [("B", "x", 3.0, 0.0, 600_000)])
    app = _app("k, sum(v) as s", "k", "sec, min", header=header,
               agg_header="@purge(retention='1 min')\n")
    rt, agg = _run(siddhi_tpu_torch, app, [rows[:2]])
    assert agg.retention_ms == {Duration.SECONDS: 60_000,
                                Duration.MINUTES: 60_000}
    assert agg.evicted[Duration.SECONDS] == 0
    _feed(rt, rows[2:])
    assert agg.evicted == {Duration.SECONDS: 2, Duration.MINUTES: 1}
    assert rt.query("from A within 0L, 4000000000000L per 'sec' "
                    "select k, s") == [(600_000, ("B", 3.0))]
    ex = rt.explain()["aggregations"]["A"]
    assert ex["evicted"] == {"SECONDS": 2, "MINUTES": 1}
    assert ex["retention_ms"] == {"SECONDS": 60_000, "MINUTES": 60_000}
    jrt, _ = _run(siddhi_tpu, app, [rows[:2], rows[2:]])
    assert agg.state_dict() == _jax_state(jrt, rt)


@pytest.mark.parametrize("purge", [
    "@purge(retention='1 min')\n", "@purge('90 sec')\n",
    "@purge(sec='2 min', min='1 hour')\n",
    "@purge(retention='1 hour', sec='2 min')\n",
    "@purge(enable='false')\n", ""])
def test_purge_retention_parses_like_jax(purge):
    app = _app("sum(v) as s", "k", "sec, min, hour", agg_header=purge)
    _, p = _run(siddhi_tpu_torch, app, [])
    _, j = _run(siddhi_tpu, app, [])
    assert {d.value: v for d, v in p.retention_ms.items()} == \
        {d.value: v for d, v in j.retention_ms.items()}


def test_eviction_frees_slots_for_reuse():
    app = _app("sum(v) as s", "k", "sec", header="@app:aggCapacity(8)\n",
               agg_header="@purge(retention='2 sec')\n")
    rt, agg = _run(siddhi_tpu_torch, app, [])
    for k in range(40):      # 40 buckets through an 8-slot ring
        _feed(rt, [("A", "x", 1.0, 0.0, 1_000 * k)])
    assert agg.device_plan.capacity(Duration.SECONDS) == 8
    assert agg.evicted[Duration.SECONDS] >= 30
    assert agg.device_plan.live_buckets(Duration.SECONDS) <= 4
    assert agg.metrics()["durations"]["SECONDS"]["capacity"] == 8


def test_capacity_annotation_and_growth():
    batches = [_rows(np.random.default_rng(3), 400, nk=6, nk2=1,
                     span_ms=90_000)]
    app = _app("sum(v) as s, count() as n", "k", "sec",
               header="@app:aggCapacity(8)\n")
    prt, agg = _run(siddhi_tpu_torch, app, batches)
    cap = agg.device_plan.capacity(Duration.SECONDS)
    live = agg.device_plan.live_buckets(Duration.SECONDS)
    assert cap >= live > 8 and agg.device_plan.rings[
        Duration.SECONDS].bases.shape == (cap, 2)
    _, host = _run(siddhi_tpu_torch, _app("sum(v) as s, count() as n", "k",
                                          "sec", header=OFF), batches)
    assert agg.state_dict() == host.state_dict()
    jrt, _ = _run(siddhi_tpu, app, batches)
    assert agg.state_dict() == _jax_state(jrt, prt)


@pytest.mark.parametrize("case,durations,header,env,path,reason", [
    ("default", "sec, min", "", None, "device-resident", None),
    ("off", "sec", OFF, None, "host", "deviceAggregations('off')"),
    ("never", "sec", "@app:deviceAggregations('never')\n", None, "host",
     "deviceAggregations('never')"),
    ("env", "sec", "", "off", "host", "SIDDHI_AGG_DEVICE"),
    ("calendar", "sec, month", "", None, "host", "calendar"),
    ("always", "sec", ALWAYS, None, "device-batch", None),
    ("always calendar", "sec, year", ALWAYS, None, "host", "calendar")])
def test_placement_and_explain(monkeypatch, case, durations, header, env,
                               path, reason):
    if env is not None:
        monkeypatch.setenv("SIDDHI_AGG_DEVICE", env)
    app = _app("k, sum(v) as s", "k", durations, header=header)
    rt, agg = _run(siddhi_tpu_torch, app, [])
    ex = rt.explain()["aggregations"]["A"]
    assert ex["path"] == path
    assert ex["durations"] == [d.name for d in agg.durations]
    jrt, _ = _run(siddhi_tpu, app, [])
    jex = jrt.explain()["aggregations"]["A"]
    assert jex["path"] == path
    if reason is None:
        assert "demotions" not in ex
    else:
        assert [d["rule_id"] for d in ex["demotions"]] == ["D-AGG"]
        assert reason in ex["demotions"][0]["reason"]
        assert ex["demotions"] == jex["demotions"]
    # every path aggregates the same rows
    _feed(rt, [("A", "x", 1.5, 0.0, 1000), ("A", "x", 2.0, 0.0, 1500)])
    assert rt.query("from A within 0L, 10000L per 'sec' "
                    "select k, s") == [(1000, ("A", 3.5))]


def test_metrics():
    rt, agg = _run(siddhi_tpu_torch, _app("k, sum(v) as s", "k", "sec, min"),
                   [[("A", "x", 1.0, 0.0, 1000), ("B", "x", 2.0, 0.0, 2000)]])
    m = agg.metrics()
    assert m["device"] and m["resident"] and m["groups"] == 2
    assert m["durations"]["SECONDS"]["buckets"] == 2
    assert m["durations"]["SECONDS"]["capacity"] == 1024


def test_device_plan_failure_raises(monkeypatch):
    """No quiet fallback: a device plan that cannot be built fails the
    app (the JAX package would move the aggregation to the host)."""
    import siddhi_tpu_torch.core.agg_device as ad

    def boom(*a, **k):
        raise RuntimeError("no device plan")
    monkeypatch.setattr(ad.DeviceAggregationPlan, "__init__", boom)
    with pytest.raises(RuntimeError, match="no device plan"):
        _runtime(siddhi_tpu_torch, _app("sum(v) as s", "k", "sec"))


# ---------------------------------------------------------------------------
# store queries (tests/test_aggregation.py:41-150)
# ---------------------------------------------------------------------------

APP = """
    define stream Trades (sym string, price double, vol long, ts long);
    define aggregation TradeAgg
      from Trades
      select sym, sum(price) as total, avg(price) as avgPrice,
             count() as n, min(price) as lo, max(price) as hi
      group by sym
      aggregate by ts every sec, min, hour;
"""
TRADES = [("A", 10.0, 1, 1000), ("A", 20.0, 1, 1400), ("B", 5.0, 1, 1900),
          ("A", 30.0, 1, 2100), ("B", 7.0, 1, 2500)]


@pytest.mark.parametrize("header", ["", OFF, ALWAYS])
@pytest.mark.parametrize("query,want", [
    ("from TradeAgg within 0L, 100000L per 'seconds' select sym, total, n",
     [(1000, ("A", 30.0, 2)), (1000, ("B", 5.0, 1)),
      (2000, ("A", 30.0, 1)), (2000, ("B", 7.0, 1))]),
    ("from TradeAgg within 0L, 100000L per 'minutes' "
     "select sym, total, avgPrice, lo, hi",
     [(0, ("A", 60.0, 20.0, 10.0, 30.0)), (0, ("B", 12.0, 6.0, 5.0, 7.0))]),
    ("from TradeAgg on sym == 'A' within 0L, 100000L per 'minutes' "
     "select sym, n", [(0, ("A", 3))]),
    ("from TradeAgg within 2000L, 3000L per 'seconds' select sym, total",
     [(2000, ("A", 30.0)), (2000, ("B", 7.0))]),
    ("from TradeAgg on total > 20.0 within 0L, 100000L per 'hours' "
     "select sym, total, AGG_TIMESTAMP as t", [(0, ("A", 60.0, 0))]),
    ("from TradeAgg within 0L, 100000L per 'sec' select *",
     [(1000, ("A", 30.0, 15.0, 2, 10.0, 20.0)),
      (1000, ("B", 5.0, 5.0, 1, 5.0, 5.0)),
      (2000, ("A", 30.0, 30.0, 1, 30.0, 30.0)),
      (2000, ("B", 7.0, 7.0, 1, 7.0, 7.0))])])
def test_store_queries_equal_jax(header, query, want):
    prt = _runtime(siddhi_tpu_torch, header + APP)[1]
    jrt = _runtime(siddhi_tpu, header + APP)[1]
    for rt in (prt, jrt):
        _feed(rt, TRADES, "Trades")
    got = prt.query(query)
    assert sorted(got) == want
    assert got == jrt.query(query)
    assert prt.query(query) == got          # the cached compiled query


def test_store_query_cache_is_bounded():
    rt = _runtime(siddhi_tpu_torch, APP)[1]
    for i in range(70):
        rt.query(f"from TradeAgg within 0L, {100000 + i}L per 'sec' "
                 f"select total")
    assert len(rt._store_cache) == 64
    schema, rows = rt.query_with_schema(
        "from TradeAgg within 0L, 10L per 'sec' select sym, n")
    assert schema.names == ["sym", "n"] and rows == []


def test_wildcard_within_pattern():
    app = """
        define stream S (x int, ts long);
        define aggregation A from S select sum(x) as s
            aggregate by ts every hour, day;
    """
    base = 1496313000000       # 2017-06-01 10:30 UTC
    out = {}
    for pkg in (siddhi_tpu_torch, siddhi_tpu):
        rt = _runtime(pkg, app)[1]
        rt.input_handler("S").send([(5, base), (6, base + 3_600_000)])
        rt.flush()
        out[pkg] = [rt.query(f"from A within '{day} **:**:**' per 'hours' "
                             f"select s")
                    for day in ("2017-06-01", "2017-06-02")] + [
            rt.query("from A within '2017-06-** **:**:**' per 'days' "
                     "select s"),
            rt.query("from A within '2017-06-01 10:**:**' per 'hours' "
                     "select s")]
    assert sorted(r for _t, r in out[siddhi_tpu_torch][0]) == [(5,), (6,)]
    assert out[siddhi_tpu_torch][1] == []
    assert out[siddhi_tpu_torch] == out[siddhi_tpu]


def test_arrival_time_when_no_aggregate_by():
    app = """
        @app:playback
        define stream S (x int);
        define aggregation A from S select sum(x) as s every sec;
    """
    got = {}
    for pkg in (siddhi_tpu_torch, siddhi_tpu):
        rt = _runtime(pkg, app)[1]
        h = rt.input_handler("S")
        for x, t in ((1, 1000), (2, 1500), (3, 2200)):
            h.send((x,), timestamp=t)
        rt.flush()
        got[pkg] = rt.query("from A within 0L, 10000L per 'seconds' "
                            "select s")
    assert got[siddhi_tpu_torch] == [(1000, (3,)), (2000, (3,))]
    assert got[siddhi_tpu_torch] == got[siddhi_tpu]


@pytest.mark.parametrize("app,query", [
    ("define stream S (x int);\n"
     "define aggregation A from S select distinctCount(x) as d every sec;",
     None),
    ("define stream S (x string);\n"
     "define aggregation A from S select sum(x) as d every sec;", None),
    (APP, "from TradeAgg within 0L, 10000L per 'days' select total"),
    (APP, "from TradeAgg within 0L, 10000L select total"),
    (APP, "from Trades within 0L, 10000L per 'sec' select price"),
    (APP, "from Nowhere within 0L, 10000L per 'sec' select price"),
    (APP + "define stream Probe (sym string);\n"
     "from Probe as p join TradeAgg as a on a.sym == p.sym "
     "within 0L, 100000L per 'minutes' "
     "select p.sym as sym, a.total as total insert into O;", None)])
def test_refusals_raise_plan_error(app, query):
    if query is None:
        with pytest.raises(PlanError):
            _runtime(siddhi_tpu_torch, app)
        return
    rt = _runtime(siddhi_tpu_torch, app)[1]
    _feed(rt, TRADES, "Trades")
    with pytest.raises(PlanError):
        rt.query(query)


def test_aggregation_join_names_the_host_join():
    app = APP + ("define stream Probe (sym string);\n"
                 "from Probe as p join TradeAgg as a on a.sym == p.sym "
                 "within 0L, 100000L per 'minutes' "
                 "select p.sym as sym, a.total as total insert into O;")
    with pytest.raises(PlanError, match="host join"):
        _runtime(siddhi_tpu_torch, app)
    _runtime(siddhi_tpu, app)       # the JAX package runs it on its host join


def test_jax_refuses_what_the_port_refuses_for_unsupported_aggregators():
    app = ("define stream S (x int);\n"
           "define aggregation A from S select distinctCount(x) as d "
           "every sec;")
    with pytest.raises(JPlanError):
        _runtime(siddhi_tpu, app)


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("header", ["", OFF])
def test_jax_state_carries_into_the_port(header):
    """A JAX store after half the tape, loaded into a port runtime whose
    string table numbers the keys differently, then the second half fed
    to both: equal stores and rows."""
    sel = "k, k2, sum(v) as s, avg(w) as a, min(v) as lo, max(w) as hi, " \
        "count() as n"
    app = _app(sel, "k, k2", "sec, min, hour", header=header)
    batches = [_rows(np.random.default_rng(60 + i), 200, span_ms=200_000)
               for i in range(4)]
    jrt, jagg = _run(siddhi_tpu, app, batches[:2])
    mgr, prt = _runtime(siddhi_tpu_torch, app)
    for s in ("G2", "K3", "zz", "G0", "K1"):     # other codes than JAX's
        prt.strings.encode(s)
    pagg = prt.aggregations["A"]
    pagg.load_state_dict(agg_state_from_jax(
        jagg.state_dict(), jrt.strings, prt.strings, pagg.string_keys))
    for b in batches[2:]:
        _feed(jrt, b)
        _feed(prt, b)
    assert pagg.state_dict() == _jax_state(jrt, prt)
    q = "from A within 0L, 4000000000000L per '{}' select k, k2, s, a, n"
    for per in ("sec", "min", "hour"):
        assert sorted(prt.query(q.format(per))) == \
            sorted(jrt.query(q.format(per)))


def test_state_dict_round_trip():
    app = _app("k, sum(v) as s, min(v) as lo, count() as n", "k",
               "sec, min", header="@app:aggCapacity(8)\n")
    batches = [_rows(np.random.default_rng(70 + i), 150, span_ms=60_000)
               for i in range(4)]
    whole, wagg = _run(siddhi_tpu_torch, app, batches)
    half, hagg = _run(siddhi_tpu_torch, app, batches[:2])
    mgr, rt2 = _runtime(siddhi_tpu_torch, app)
    rt2.strings.restore(half.strings.state())
    agg2 = rt2.aggregations["A"]
    agg2.load_state_dict(hagg.state_dict())
    assert agg2.state_dict() == hagg.state_dict()
    assert agg2.device_plan.capacity(Duration.SECONDS) >= \
        agg2.device_plan.live_buckets(Duration.SECONDS) > 8
    for b in batches[2:]:
        _feed(rt2, b)
    assert agg2.state_dict() == wagg.state_dict()


# ---------------------------------------------------------------------------
# the slice whole: bench.py's aggregation matrix at its smoke scale
# ---------------------------------------------------------------------------

def _matrix_run(pkg, head, tape, query_every):
    rt = _runtime(pkg, MATRIX_APP(head))[1]
    h = rt.input_handler("Trades")
    mid = []
    for i, (cols, ts) in enumerate(tape):
        h.send_batch(cols, ts)
        if query_every and (i + 1) % query_every == 0:
            mid.append(rt.query(matrix_query()))
    rt.flush()
    return rt, mid, {per: rt.query(matrix_query(per)) for per in MATRIX_PERS}


@pytest.mark.parametrize("keys,query_every", [(8, 0), (64, 0), (64, 1)])
def test_matrix_app_equals_jax(keys, query_every):
    """bench.py `--matrix --smoke`: 8 batches of 512 at 8 and 64 keys, and
    the `mixed` cell (a store query after every batch); rows per sec, min
    and hour equal to JAX's in order, stores equal."""
    tape = matrix_tape(8, 512, keys)
    prt, pmid, prows = _matrix_run(siddhi_tpu_torch, "", tape, query_every)
    jrt, jmid, jrows = _matrix_run(siddhi_tpu, "", tape, query_every)
    assert prt.explain()["aggregations"]["Roll"]["path"] == "device-resident"
    assert all(prows[per] for per in MATRIX_PERS)
    assert prows == jrows and pmid == jmid
    assert len(pmid) == (8 if query_every else 0)
    assert prt.aggregations["Roll"].state_dict() == \
        _jax_state(jrt, prt, "Roll")


def test_value_rows_one_per_distinct_argument():
    """The matrix app's five sites read two value rows: `p * v` (computed)
    and `p` once for avg, min and max; count reads none.  K10 gets those
    two rows and points every base at its own (count at -1)."""
    agg = _runtime(siddhi_tpu_torch, MATRIX_APP(""))[1].aggregations["Roll"]
    assert [s.arg for s in agg.row_sites] == [None, "p"]
    assert agg.base_ops == ["sum", "sum", "count", "min", "max", "count"]
    assert agg.base_rows == [0, 1, -1, 1, 1, -1]
    record: list = []
    agg.device_plan.record = record
    h = agg.rt.input_handler("Trades")
    cols, ts = matrix_tape(1, 64, 8)[0]
    h.send_batch(cols, ts)
    agg.rt.flush()
    assert len(record) == len(agg.durations)
    _name, (_pre, vals, *_rest), kw = record[0]
    assert tuple(vals.shape) == (2, 64) and kw["rows"] == agg.base_rows
    p, v = cols["p"].astype(np.float64), cols["v"].astype(np.float64)
    assert np.array_equal(vals[1].numpy(), p)
    assert np.array_equal(vals[0].numpy(), p * v)
