"""Window + aggregation plans of the port against siddhi_tpu on the CPU.

The JAX side runs `siddhi_tpu` under `@app:deviceWindows('always')` (its
device plan, XLA on the CPU), the port `SiddhiManager(device="cpu")` (the
plain versions of K1 and K6-K8).  Tapes come from numpy seeds and are
flushed in seeded random batch sizes; each app's JAX rows are computed
once (`jax_rows`) and shared.

Tolerance:
  * 0 on quarter-grid prices whose sums stay below 2^22: every f32 and
    f64 prefix is exact there, in any fold order, so the JAX package's
    f32 prefix differences and the port's f64 ones give the same bits;
  * on a 0.01-grid tape the port sums in f64 and the JAX package in f32.
    Each sum of the JAX package is a difference of two f32 prefixes over
    the N = C + T entries of its step, each off by at most
    ceil(log2 N) * 2^-24 * sum|v| (a pairwise or sequential fold), so the
    rows differ by at most 2 * ceil(log2 N) * 2^-24 * sum|v| over the
    window's events before the batch and the batch's up to the row,
    divided by the count for avg (`test_cent_grid_within_the_prefix_bound`).
Also covered: boundary tapes (events exactly D apart, windows exactly L
long), carry growth, NaN in min/max, state carried over from a JAX plan,
the LONG-sum fault of the JAX device path, and K6-K8's plain versions
against numpy brute force."""
import functools
import math

import warnings

import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.core.window_device import \
    DeviceWindowAggPlan as JWindowPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.core.window_device import DeviceWindowAggPlan
from siddhi_tpu_torch.weights import window_state_from_jax

HEAD = "@app:playback define stream S (sym string, p double, v long);\n"
HEAD_ET = ("@app:playback define stream S (sym string, p double, v long, "
           "et long);\n")
DEV = "@app:deviceWindows('always')\n"


def tape(kind: str, n: int, seed: int) -> list:
    """(ts, row) rows from a numpy seed.  kind: "q4" quarter-grid prices in
    [-50, 150), "cent" the 0.01 grid, "et" an event-time column too,
    "nan" quarter grid with NaN prices, "zero" prices of -1, -0.0, +0.0
    and 1, "long" LONG values past 2^24."""
    rng = np.random.default_rng(seed)
    ts = 1000 + np.cumsum(rng.integers(0, 400, n))
    syms = rng.integers(0, 3, n)
    grid = 100 if kind == "cent" else 4
    p = np.round(rng.uniform(-50, 150, n) * grid) / grid
    if kind == "nan":
        p[rng.choice(n, 3, replace=False)] = np.nan
    if kind == "zero":
        p = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0]), n)
    v = rng.integers(1, 10, n)
    if kind == "long":
        v = 10_000_001 + np.arange(n)
    rows = []
    if kind == "et":
        ts = 1000 + np.cumsum(rng.integers(1, 50, n))
        et = 50_000 + np.cumsum(rng.integers(0, 300, n))
        for i in range(n):
            rows.append((int(ts[i]), (f"s{syms[i]}", float(p[i]), int(v[i]),
                                      int(et[i]))))
        return rows
    for i in range(n):
        rows.append((int(ts[i]), (f"s{syms[i]}", float(p[i]), int(v[i]))))
    return rows


def batch_sizes(n: int, seed: int, hi: int = 7) -> list:
    rng = np.random.default_rng(seed + 1000)
    out, left = [], n
    while left > 0:
        out.append(min(left, int(rng.integers(1, hi + 1))))
        left -= out[-1]
    return out


def feed(rt, rows, sizes, out_stream="O"):
    out = []
    rt.add_callback(out_stream, lambda evs: out.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    h = rt.input_handler("S")
    i = 0
    for n in sizes:
        for ts, row in rows[i:i + n]:
            h.send(row, timestamp=ts)
        rt.flush()
        i += n
    rt.flush()
    return out


def run_port(app: str, rows, sizes):
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    assert any(isinstance(p, DeviceWindowAggPlan) for p in rt.plans())
    return feed(rt, rows, sizes)


@functools.lru_cache(maxsize=None)
def jax_rows(app: str, kind: str, n: int, seed: int, hi: int = 7,
             mode: str = "always") -> list:
    rows = tape(kind, n, seed)
    m = siddhi_tpu.SiddhiManager()
    rt = m.create_app_runtime(f"@app:deviceWindows('{mode}')\n" + app)
    if mode == "always":
        assert any(isinstance(p, JWindowPlan) for p in rt._plans)
    out = feed(rt, rows, batch_sizes(n, seed, hi))
    m.shutdown()
    return out


def port_rows(app: str, kind: str, n: int, seed: int, hi: int = 7) -> list:
    return run_port(app, tape(kind, n, seed), batch_sizes(n, seed, hi))


def canon(rows: list) -> list:
    """Rows with NaN made comparable (NaN != NaN in a tuple compare)."""
    return [(t, tuple("nan" if isinstance(x, float) and math.isnan(x) else x
                      for x in r)) for t, r in rows]


QUERIES = [
    "from S#window.length(5) select sym, sum(p) as s, count() as c "
    "insert into O;",
    "from S#window.length(1) select sum(p) as s insert into O;",
    "from S#window.length(7) select sym, sum(p) as s group by sym "
    "insert into O;",
    "from S#window.length(4) select min(p) as lo, max(p) as hi, avg(p) as m "
    "insert into O;",
    "from S#window.time(1 sec) select sum(p) as s, count() as c "
    "insert into O;",
    "from S#window.time(700 milliseconds) select sym, avg(p) as m "
    "group by sym insert into O;",
    "from S#window.lengthBatch(4) select sym, sum(p) as s group by sym "
    "insert into O;",
    "from S#window.lengthBatch(3) select min(p) as lo, max(p) as hi "
    "insert into O;",
    "from S[p > 0]#window.length(5) select sym, sum(p) as s insert into O;",
    "from S#window.length(6) select sym, sum(p) as s group by sym "
    "having s > 100.0 insert into O;",
    "from S#window.time(2 sec) select sum(v) as sv, avg(p) as ap "
    "group by sym insert into O;",
    "from S#window.length(9) select sym, min(p) as lo, max(p) as hi "
    "group by sym insert into O;",
    "from S#window.length(4) select sym, max(p) as hi, sum(v) as sv "
    "group by sym having hi > 50.0 insert into O;",
    "from S#window.time(800) select sym, min(p) as lo group by sym "
    "insert into O;",
    "from S#window.length(6) select sym, sum(p) as s group by sym "
    "order by s insert into O;",
    "from S#window.length(6) select sym, sum(p) as s group by sym "
    "order by s desc limit 2 insert into O;",
    "from S#window.lengthBatch(8) select sym, count() as c group by sym "
    "order by sym limit 2 offset 1 insert into O;",
    "from S[v > 3]#window.time(1500) select sym, max(p) as hi, "
    "count() as n, avg(v) as av group by sym having n > 1 insert into O;",
    "from S[p < 120.0]#window.lengthBatch(5) select sum(p) + 1.5 as s1, "
    "min(v) as lv, max(v) * 2 as hv insert into O;",
    "from S#window.length(3) select sym, p, v * 2 as v2, "
    "sum(p) - p as rest, eventTimestamp() as t insert into O;",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_matches_jax(qi):
    app = HEAD + QUERIES[qi]
    want = jax_rows(app, "q4", 120, qi + 10)
    assert want
    assert port_rows(app, "q4", 120, qi + 10) == want


@pytest.mark.parametrize("q", [
    "from S#window.length(6) select min(p) as lo, max(p) as hi, "
    "avg(p) as ap, sum(p) as sp, sum(v) as sv, avg(v) as av, count() as c "
    "insert into O;",
    "from S#window.time(900) select sym, min(p) as lo, max(p) as hi, "
    "avg(p) as ap, sum(v) as sv, avg(v) as av group by sym insert into O;",
    "from S#window.lengthBatch(5) select sym, min(p) as lo, avg(p) as ap, "
    "sum(p) as sp, max(v) as mv, sum(v) as sv group by sym insert into O;",
])
def test_sites_share_value_columns(q):
    """Aggregates over one argument and dtype share one value column (p:
    the compute float; v: i64 for sum/avg, the compute float for min/max),
    and a column only the aggregates read is not among the row columns."""
    app = HEAD + q
    plan = next(iter(siddhi_tpu_torch.SiddhiManager(device="cpu")
                     .create_app_runtime(app).plans()))
    want_cols = 3 if "max(v)" in q else 2
    assert len(plan._vcols) == want_cols
    assert "p" not in plan.row_cols and "v" not in plan.row_cols
    assert sorted(k for k in plan.state if k.startswith("v.")) == \
        [f"v.{j}" for j in range(want_cols)]
    want = jax_rows(app, "q4", 120, 77)
    assert want
    assert port_rows(app, "q4", 120, 77) == want


ET_QUERIES = [
    "from S#window.externalTime(et, 700) select sym, avg(p) as ap, "
    "count() as c group by sym insert into O;",
    "from S#window.externalTime(et, 500) select sum(p) as s, min(p) as lo "
    "insert into O;",
    "from S#window.externalTimeBatch(et, 700) select sum(p) as s, "
    "count() as c insert into O;",
    "from S#window.externalTimeBatch(et, 900) select sym, max(p) as hi, "
    "avg(v) as av group by sym insert into O;",
    "from S[p > 20.0]#window.externalTimeBatch(et, 400) select sym, "
    "sum(v) as sv group by sym having sv > 5 insert into O;",
]


@pytest.mark.parametrize("qi", range(len(ET_QUERIES)))
def test_external_time_matches_jax(qi):
    app = HEAD_ET + ET_QUERIES[qi]
    want = jax_rows(app, "et", 150, qi + 60)
    assert want
    assert port_rows(app, "et", 150, qi + 60) == want


@pytest.mark.parametrize("q", [
    "from S#window.length(5) select avg(p) as m, sum(p) as s insert into O;",
    "from S#window.time(900) select sym, sum(p) as s, min(p) as lo, "
    "avg(v) as av group by sym insert into O;",
    "from S#window.lengthBatch(4) select sym, avg(p) as m, max(p) as hi "
    "group by sym insert into O;",
])
def test_f64_precision_matches_jax(q):
    app = "@app:devicePrecision('f64')\n" + HEAD + q
    want = jax_rows(app, "q4", 90, 42)
    got = port_rows(app, "q4", 90, 42)
    assert got == want
    plan = next(p for p in siddhi_tpu_torch.SiddhiManager(device="cpu")
                .create_app_runtime(app).plans())
    assert plan.f64


def test_external_time_batch_filtered_first_batch_anchor():
    """A fully filtered first batch must not latch the bucket anchor
    (the JAX package's test of the same name, window_device.py:755)."""
    rng = np.random.default_rng(7)
    ts = 1000 + np.cumsum(rng.integers(1, 50, 60))
    et = 50_000 + np.cumsum(rng.integers(0, 300, 60))
    p = np.round(rng.uniform(-50, 90, 60) * 4) / 4
    p[:6] = -np.round(rng.uniform(1, 90, 6) * 4) / 4
    rows = [(int(ts[i]), ("s0", float(p[i]), 1, int(et[i])))
            for i in range(60)]
    app = HEAD_ET + ("from S[p > 0]#window.externalTimeBatch(et, 700) "
                     "select sum(p) as s, count() as c insert into O;")
    sizes = [6] + [5] * 11
    m = siddhi_tpu.SiddhiManager()
    want = feed(m.create_app_runtime(DEV + app), rows, sizes)
    assert want
    assert run_port(app, rows, sizes) == want


def _window_sum_bound(q_kind: str, span: int, rows, sizes, C: int):
    """Per output row: 2 * ceil(log2 N) * 2^-24 * sum|p| over the window's
    events before the row's batch and the batch's events up to the row."""
    p = np.abs(np.array([r[1][1] for r in rows]))
    ts = np.array([r[0] for r in rows])
    bounds, start = [], 0
    for n in sizes:
        T = 8
        while T < n:
            T *= 2
        if q_kind == "length":
            lo = max(0, start - span)
        else:
            lo = int(np.searchsorted(ts[:start], ts[start - 1] - span,
                                     side="right")) if start else 0
        before = p[lo:start].sum()
        for j in range(n):
            s = before + p[start:start + j + 1].sum()
            bounds.append(2 * math.ceil(math.log2(C + T)) * 2.0 ** -24 * s)
        start += n
    return bounds


@pytest.mark.parametrize("kind,span", [("length", 50), ("time", 3000)])
def test_cent_grid_within_the_prefix_bound(kind, span):
    q = (f"from S#window.{kind}({span}) select sum(p) as s, avg(p) as a, "
         f"count() as c insert into O;")
    app = HEAD + q
    rows = tape("cent", 400, 17)
    sizes = batch_sizes(400, 17, hi=60)
    want = jax_rows(app, "cent", 400, 17, 60)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    got = feed(rt, rows, sizes)
    C = rt.plans()[0].C
    bounds = _window_sum_bound(kind, span, rows, sizes, C)
    assert len(got) == len(want) == len(bounds)
    exact_rows = 0
    for (tg, g), (tw, w), b in zip(got, want, bounds):
        assert tg == tw and g[2] == w[2]
        assert abs(g[0] - w[0]) <= b, (g, w, b)
        assert abs(g[1] - w[1]) <= b / g[2], (g, w, b)
        exact_rows += g == w
    assert exact_rows < len(got)        # the tape does reach f32 rounding


@pytest.mark.parametrize("q,kind", [
    # events exactly D apart: the one D old has left (side="right")
    ("from S#window.time(1000) select sum(p) as s, count() as c, "
     "min(p) as lo insert into O;", "time"),
    ("from S#window.time(1000) select sym, max(p) as hi, count() as c "
     "group by sym insert into O;", "time"),
    # windows exactly L long, batches of L
    ("from S#window.length(4) select sum(p) as s, count() as c, "
     "max(p) as hi insert into O;", "length"),
    ("from S#window.lengthBatch(4) select sum(p) as s, count() as c "
     "insert into O;", "length"),
    ("from S#window.externalTimeBatch(et, 1000) select sum(p) as s, "
     "count() as c insert into O;", "et"),
])
def test_boundary_tapes(q, kind):
    rng = np.random.default_rng(5)
    n = 48
    p = np.round(rng.uniform(0, 100, n) * 4) / 4
    if kind == "time":       # pairs 1000 ms apart and ties on one stamp
        ts = 1000 + 1000 * (np.arange(n) // 2) + 1000 * (np.arange(n) % 2)
    else:
        ts = 1000 + 1000 * np.arange(n)
    rows = [(int(ts[i]), (f"s{i % 2}", float(p[i]), i)
             + ((int(ts[i]),) if kind == "et" else ()))
            for i in range(n)]
    app = (HEAD_ET if kind == "et" else HEAD) + q
    sizes = [4] * (n // 4)
    m = siddhi_tpu.SiddhiManager()
    want = feed(m.create_app_runtime(DEV + app), rows, sizes)
    assert want
    assert run_port(app, rows, sizes) == want


def test_time_window_carry_grows():
    """A carry of 8 slots (C doubling through the overflow retry) gives the
    JAX plan's rows with its own carry of 8."""
    app = HEAD + ("from S#window.time(1 hour) select sym, count() as c, "
                  "sum(p) as s group by sym insert into O;")
    rows = tape("q4", 200, 3)
    sizes = [50, 70, 80]
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    jp = jrt._plans[0]
    jp.C = 8
    jp.state = jp._init_state()
    want = feed(jrt, rows, sizes)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    plan = rt.plans()[0]
    plan.C = 8
    plan.state = plan._init_state()
    assert feed(rt, rows, sizes) == want
    assert plan.C == 256 == jp.C


def test_external_time_batch_carry_grows():
    """One event-time bucket outgrows the 1024-slot carry."""
    app = HEAD_ET + ("from S#window.externalTimeBatch(et, 100000) "
                     "select sym, sum(p) as s, count() as c group by sym "
                     "insert into O;")
    rng = np.random.default_rng(9)
    n = 3000
    ts = 1000 + np.arange(n)
    et = 10_000 + 40 * np.arange(n)
    p = np.round(rng.uniform(0, 100, n) * 4) / 4
    rows = [(int(ts[i]), (f"s{i % 3}", float(p[i]), 1, int(et[i])))
            for i in range(n)]
    sizes = [1000] * 3
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    want = feed(jrt, rows, sizes)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    got = feed(rt, rows, sizes)
    assert got == want and len(want) > 2000
    assert rt.plans()[0].C == jrt._plans[0].C == 2048


MIN_MAX_QUERIES = [
    "from S#window.length(4) select min(p) as lo, max(p) as hi "
    "insert into O;",
    "from S#window.time(900) select sym, min(p) as lo, max(p) as hi "
    "group by sym insert into O;",
    "from S#window.lengthBatch(3) select sym, min(p) as lo, max(p) as hi "
    "group by sym insert into O;",
]


@pytest.mark.parametrize("q", MIN_MAX_QUERIES)
def test_nan_price_in_min_max(q):
    """A NaN price propagates through min/max as jnp.minimum/maximum do."""
    app = HEAD + q
    want = canon(jax_rows(app, "nan", 80, 23))
    assert any("nan" in r for _t, r in want)
    assert canon(port_rows(app, "nan", 80, 23)) == want


def signed(rows: list) -> list:
    """Rows with each float's sign bit beside it (-0.0 == 0.0 otherwise)."""
    return [(t, tuple((x, math.copysign(1.0, x)) if isinstance(x, float)
                      else x for x in r)) for t, r in rows]


@pytest.mark.parametrize("q", MIN_MAX_QUERIES[:2])
def test_signed_zero_in_min_max(q):
    """-0.0 counts below +0.0 in min/max whichever side it is on, as
    jnp.minimum/maximum do in the JAX sliding windows' range reductions.
    The tumbling query is not compared: inside the JAX package's jitted
    associative_scan, XLA on the CPU folds min(+0.0, -0.0) to +0.0 where
    jnp.minimum alone gives -0.0, so no one rule matches it there."""
    app = HEAD + q
    want = signed(jax_rows(app, "zero", 80, 29))
    assert any((0.0, -1.0) in r for _t, r in want)
    assert signed(port_rows(app, "zero", 80, 29)) == want


@pytest.mark.parametrize("q", [
    "from S#window.time(1500) select sym, sum(p) as s, max(p) as hi, "
    "count() as c group by sym insert into O;",
    "from S#window.lengthBatch(5) select sym, avg(p) as m, sum(v) as sv "
    "group by sym insert into O;",
    "from S[p > 0]#window.length(6) select sum(p) as s, min(v) as lv "
    "insert into O;",
])
def test_state_carried_from_jax(q):
    """Run the JAX plan on the first 70 events, carry its state_dict() and
    string table into the port, and continue both: equal rows."""
    app = HEAD + q
    rows = tape("q4", 130, 31)
    sizes = batch_sizes(130, 31)
    cut = 0
    head_sizes = []
    while cut < 70:
        head_sizes.append(sizes[len(head_sizes)])
        cut += head_sizes[-1]
    tail_sizes = sizes[len(head_sizes):]
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    feed(jrt, rows[:cut], head_sizes)
    d = jrt._plans[0].state_dict()
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rt.strings.restore(jrt.strings.state())
    rt.plans()[0].load_state_dict(window_state_from_jax(d, "cpu"))
    got = feed(rt, rows[cut:], tail_sizes)
    want = feed(jrt, rows[cut:], tail_sizes)
    assert got == want and want


def test_long_sum_follows_the_host_interpreter():
    """The JAX device path sums LONG in the compute float (f32) and rounds
    (window_device.py:568); its host interpreter sums exactly, and so does
    the port (i64)."""
    app = HEAD + "from S#window.length(4) select sum(v) as sv insert into O;"
    host = jax_rows(app, "long", 40, 1, mode="never")
    device = jax_rows(app, "long", 40, 1)
    got = port_rows(app, "long", 40, 1)
    assert got == host
    assert device != host
    assert got[1][1] == (20_000_003,) and device[1][1] == (20_000_004,)


def test_planning_routes_and_refusals():
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    c2 = ("define stream StockStream (symbol string, price double, "
          "volume int);\n@info(name='q') from StockStream#window.length(1000)"
          " select avg(price) as ap insert into Out;")
    plan = mgr.create_app_runtime(c2).plans()[0]
    assert isinstance(plan, DeviceWindowAggPlan) and plan.C == 1024
    # the shapes that raised while the host interpreter was a later slice
    # plan it now: by annotation or shape without a word, on a device
    # refusal with a RuntimeWarning (and under 'always' the refusal raises)
    from siddhi_tpu_torch.interp.engine import InterpSingleQueryPlan
    always = "@app:deviceWindows('always')\n"
    for app, refused in [
            ("@app:deviceWindows('never')\n" + HEAD +
             "from S#window.length(3) select sum(p) as s insert into O;",
             None),
            (HEAD + "from S#window.length(3) select sym insert into O;",
             None),
            (HEAD + "from S#window.sort(3, p) select sum(p) as s "
             "insert into O;", "window sort"),
            (HEAD + "from S#window.length(3) select stddev(p) as s "
             "insert into O;", "stddev"),
            (HEAD + "from S#window.length(3) select max(sym) as s "
             "insert into O;", "STRING")]:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rt = mgr.create_app_runtime(app)
        assert [type(p) for p in rt.plans()] == [InterpSingleQueryPlan]
        msgs = [str(x.message) for x in w]
        if refused is None:
            assert not msgs, msgs
            continue
        assert len(msgs) == 1 and "runs on the host interpreter" in msgs[0]
        assert refused in msgs[0], msgs
        with pytest.raises(PlanError, match=r"deviceWindows\('always'\) "
                           r"but unsupported"):
            mgr.create_app_runtime(always + app)


def test_window_state_round_trip():
    """state_dict() -> load_state_dict() continues a plan exactly."""
    app = HEAD + ("from S#window.externalTimeBatch(v, 3) select sym, "
                  "sum(p) as s group by sym insert into O;")
    rows = tape("q4", 60, 8)
    rows = [(t, (r[0], r[1], 1000 + i)) for i, (t, r) in enumerate(rows)]
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    first = feed(rt, rows[:30], [30])
    rt2 = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rt2.strings.restore(rt.strings.state())
    rt2.plans()[0].load_state_dict(rt.plans()[0].state_dict())
    rest = feed(rt2, rows[30:], [30])
    assert first + rest == run_port(app, rows, [30, 30]) and rest


# -- K6-K8 plain versions against numpy brute force ---------------------------

def test_win_scan_plain_matches_brute_force():
    from siddhi_tpu_torch.kernels.win_scan import win_scan_plain
    import torch
    rng = np.random.default_rng(0)
    n = 3000
    valid = rng.random(n) < 0.8
    flags = rng.random(n) < 0.01
    f = np.round(rng.uniform(-100, 100, n) * 4) / 4
    f[rng.choice(n, 2, replace=False)] = np.nan
    i = rng.integers(-10**12, 10**12, n)
    cols = [("sum", torch.from_numpy(f), True),
            ("sum", torch.from_numpy(i), True),
            ("sum", None, True),
            ("min", torch.from_numpy(f.astype(np.float32)), True),
            ("max", torch.from_numpy(f), False),
            ("max", torch.from_numpy(i), False),
            ("max", torch.from_numpy(i), True)]
    outs = win_scan_plain(cols, n, torch.from_numpy(valid),
                          torch.from_numpy(flags))
    ident = {"sum": 0, "min": np.inf, "max": -np.inf}
    for (op, vals, masked), got in zip(cols, outs):
        v = np.ones(n, np.int64) if vals is None else vals.numpy()
        want = np.empty(n, dtype=got.numpy().dtype)
        acc = None
        for j in range(n):
            x = v[j]
            if masked and not valid[j]:
                x = ident[op] if v.dtype.kind == "f" else \
                    {"sum": 0, "max": -2**63}[op]
            if acc is None or flags[j]:
                acc = x
            elif op == "sum":
                acc = acc + x
            elif op == "min":       # jnp.minimum: NaN, then -0.0 < +0.0
                acc = acc if (acc < x or acc != acc or (
                    acc == x and math.copysign(1.0, acc) < 0)) else x
            else:
                acc = acc if (acc > x or acc != acc or (
                    acc == x and math.copysign(1.0, acc) > 0)) else x
            want[j] = acc
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kind", ["length", "time"])
def test_win_range_plain_matches_brute_force(kind, grouped):
    import torch
    from siddhi_tpu_torch.kernels.win_range import win_range_plain
    rng = np.random.default_rng(1 + grouped)
    N, first = 700, 200
    m = N - first
    valid = rng.random(N) < 0.85
    clock = np.cumsum(rng.integers(0, 30, N)).astype(np.int64)
    vcnt = np.cumsum(valid).astype(np.int64)
    span = 40 if kind == "length" else 300
    p = np.round(rng.uniform(-100, 100, N) * 4) / 4
    seg = np.where(valid, rng.integers(0, 4, N), N).astype(np.int64)
    key = seg * N + np.arange(N)
    order = np.argsort(key, kind="stable")
    sv = valid[order] if grouped else valid
    sp = p[order] if grouped else p
    pfx = np.cumsum(np.where(sv, sp, 0.0))
    cnt = np.cumsum(sv).astype(np.int64)
    t = torch.from_numpy
    sites = [("sum", t(pfx), None, None, torch.float32),
             ("avg", t(pfx), t(cnt), None, torch.float32),
             ("sum", t(cnt), None, None, torch.int64),
             ("min", None, None, t(sp.astype(np.float32)), torch.float32),
             ("max", None, None, t(sp), torch.float64)]
    outs, start_k = win_range_plain(
        sites, n=N, first=first, m=m, kind=kind, span=span, last=N - 1,
        vcnt=t(vcnt), clock=t(clock),
        groups=(t(key[order]),) if grouped else None,
        valid=t(sv))
    for e in range(m):
        i = first + e
        if kind == "length":
            members = [j for j in range(i + 1) if valid[j]][-span:]
            lo_pos = members[0] if members else i
            inwin = [j for j in range(lo_pos, i + 1) if valid[j]]
        else:
            inwin = [j for j in range(i + 1)
                     if valid[j] and clock[j] > clock[i] - span]
        if grouped:
            inwin = [j for j in inwin if seg[j] == seg[i]]
        if not valid[i]:
            continue
        s = sum(p[j] for j in inwin)
        assert outs[0][e].item() == np.float32(s)
        assert outs[1][e].item() == np.float32(np.float32(s) /
                                                np.float32(len(inwin)))
        assert outs[2][e].item() == len(inwin)
        assert outs[3][e].item() == np.float32(min(p[j] for j in inwin))
        assert outs[4][e].item() == max(p[j] for j in inwin)
    if kind == "length":
        want_k = int(np.searchsorted(vcnt, max(vcnt[-1] - span, 0),
                                     side="right"))
    else:
        want_k = int(np.searchsorted(clock, clock[-1] - span, side="right"))
    assert int(start_k[0]) == want_k


def test_win_compact_plain_matches_brute_force():
    import torch
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    from siddhi_tpu_torch.kernels.win_compact import win_compact_plain
    rng = np.random.default_rng(2)
    n, T = 1000, 1024
    keep = rng.random(n) < 0.3
    a = rng.integers(0, 1 << 40, n)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    c = rng.random(n) < 0.5
    cols = [torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)]
    for mask in (pack_mask(torch.from_numpy(keep)), None):
        outs, k = win_compact_plain(cols, [2 ** 62, 0.5, True], n, T, mask)
        sel = keep if mask is not None else np.ones(n, bool)
        kk = int(sel.sum())
        assert int(k[0]) == kk
        for o, src, fill in zip(outs, (a, b, c), (2 ** 62, 0.5, True)):
            o = o.numpy()
            np.testing.assert_array_equal(o[:kk], src[sel])
            assert (o[kk:] == fill).all() and len(o) == T
