"""The port's single-stream host interpreter (`interp/engine.py`
InterpSingleQueryPlan over `interp/windows.py`, the selector, the rate
limiters and the stream functions) against the JAX package's on the CPU.

Both fold in Python floats, so the comparisons with the JAX package have
tolerance 0: the same seeded tape goes through both in the same mode and
every query callback's current and removed rows must be equal, in order.
Covered: all fourteen window types (with current and expired rows),
windowless aggregation, every output rate limit, `log` and `pol2cart`,
`@app:deviceWindows('never')` and `@app:deviceFilters('never')`, the
routing rules, and carry-over of a JAX host plan's state.  The port's
device window plan is held to its host plan within rel 2e-5, abs 2e-4,
the JAX package's own bound for that comparison
(tests/test_window_device.py:44)."""
import functools
import warnings

import numpy as np
import pytest

import siddhi_tpu

import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import FilterProjectPlan, PlanError
from siddhi_tpu_torch.core.window_device import DeviceWindowAggPlan
from siddhi_tpu_torch.interp.engine import InterpSingleQueryPlan
from siddhi_tpu_torch.weights import host_state_from_jax

S = "define stream S (sym string, price double, volume int, et long);\n"
HOST = "@app:deviceWindows('never')\n"     # aggregating windows too

# (name, query, clock): clock "wall" (set_time before the tape, after
# every flush and past it) or "playback"
QUERIES = [
    ("length", "from S#window.length(5) select sym, price "
     "insert all events into O;", "wall"),
    ("length_batch", "from S#window.lengthBatch(4) select sym, "
     "sum(price) as t, count() as n group by sym insert all events into O;",
     "wall"),
    ("time", "from S#window.time(1 sec) select sym, avg(price) as a, "
     "max(volume) as hi group by sym insert all events into O;", "wall"),
    ("time_batch", "from S#window.timeBatch(1 sec) select sym, "
     "sum(volume) as t insert all events into O;", "wall"),
    ("external_time", "from S#window.externalTime(et, 1 sec) select sym, "
     "min(price) as lo insert all events into O;", "playback"),
    ("external_time_batch", "from S#window.externalTimeBatch(et, 1 sec) "
     "select sym, count() as n group by sym insert all events into O;",
     "playback"),
    ("time_length", "from S#window.timeLength(2 sec, 4) select sym, price "
     "insert all events into O;", "wall"),
    ("batch", "from S#window.batch() select sym, sum(price) as t "
     "insert all events into O;", "wall"),
    ("session", "from S#window.session(400 milliseconds, sym) select sym, "
     "count() as n insert all events into O;", "wall"),
    ("sort", "from S#window.sort(3, price, 'desc') select sym, price "
     "insert all events into O;", "wall"),
    ("delay", "from S#window.delay(300 milliseconds) select sym, price "
     "insert into O;", "wall"),
    ("frequent", "from S#window.frequent(2, sym) select sym, price "
     "insert all events into O;", "wall"),
    ("lossy_frequent", "from S#window.lossyFrequent(0.3, 0.1, sym) "
     "select sym, price insert all events into O;", "wall"),
    ("cron", "from S#window.cron('*/2 * * * * ?') select sym, "
     "sum(price) as t insert all events into O;", "wall"),
    ("agg_no_window", "from S select sym, sum(price) as t, count() as n, "
     "stddev(price) as sd, distinctCount(volume) as d group by sym "
     "having n > 1 insert into O;", "wall"),
    ("agg_forever", "from S[price > 10] select minForever(price) as lo, "
     "maxForever(volume) as hi insert into O;", "wall"),
    ("order_limit", "from S#window.lengthBatch(6) select sym, price "
     "order by price desc limit 3 offset 1 insert into O;", "wall"),
    ("rate_events", "from S select sym, price output every 3 events "
     "insert into O;", "wall"),
    ("rate_first_events", "from S select sym, price output first every 3 "
     "events insert into O;", "wall"),
    ("rate_last_events", "from S select sym, price output last every 3 "
     "events insert into O;", "wall"),
    ("rate_time", "from S select sym, price output every 1 sec "
     "insert into O;", "wall"),
    ("rate_first_time", "from S select sym, price output first every "
     "1 sec insert into O;", "wall"),
    ("rate_snapshot", "from S#window.length(3) select sym, price output "
     "snapshot every 1 sec insert into O;", "wall"),
    ("rate_grouped_first", "from S select sym, sum(price) as t group by "
     "sym output first every 3 events insert into O;", "wall"),
    ("rate_grouped_last", "from S select sym, sum(price) as t group by "
     "sym output last every 1 sec insert into O;", "wall"),
    ("log", "from S[volume > 50]#log('seen', price) select sym, price "
     "insert into O;", "wall"),
    ("pol2cart", "from S#pol2cart(price, volume) select sym, x, y "
     "insert into O;", "wall"),
    ("expired_only", "from S#window.length(3) select sym, price "
     "insert expired events into O;", "wall"),
]


def tape(n: int = 300, seed: int = 0) -> list:
    """(row, ts): 4 symbols, prices on the quarter grid in [0, 60),
    volumes 0-99, `et` the arrival time, gaps of 1-249 ms."""
    rng = np.random.default_rng(seed)
    t, out = 1_000_000, []
    for _ in range(n):
        t += int(rng.integers(1, 250))
        out.append(((f"K{int(rng.integers(0, 4))}",
                     float(np.round(rng.uniform(0, 60) * 4) / 4),
                     int(rng.integers(0, 100)), t), t))
    return out


def run(pkg, text: str, ss: list, clock: str, flush: int = 20,
        carry=None, stop=None):
    """Send the tape row by row to S, flushing every `flush` events (on
    the wall clock `set_time` before the tape, after each flush and 3 s
    past the tape); returns (query q's ("cur"|"exp", ts, row) in order,
    runtime)."""
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    rt = pkg.SiddhiManager(**kw).create_app_runtime(text)
    out = []

    def cb(_ts, cur, exp):
        out.extend(("cur", e.timestamp, e.data) for e in cur or ())
        out.extend(("exp", e.timestamp, e.data) for e in exp or ())
    rt.add_query_callback("q", cb)
    if carry is not None:
        carry(rt)
    elif clock == "wall":
        rt.set_time(ss[0][1] - 1)
    h = rt.input_handler("S")
    for i, (row, ts) in enumerate(ss[:stop]):
        h.send(row, timestamp=ts)
        if i % flush == flush - 1:
            rt.flush()
            if clock == "wall":
                rt.set_time(ts)
    rt.flush()
    if clock == "wall" and stop is None:
        rt.set_time(ss[-1][1] + 3000)
    return out, rt


def app(query: str, clock: str, head: str = HOST) -> str:
    return (head + ("@app:playback\n" if clock == "playback" else "") + S +
            "@info(name='q') " + query)


@functools.lru_cache(maxsize=None)
def jax_rows(text: str, clock: str) -> list:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run(siddhi_tpu, text, tape(), clock)[0]


@pytest.mark.parametrize("name,query,clock", QUERIES,
                         ids=[q[0] for q in QUERIES])
def test_host_single_equals_jax(name, query, clock, capsys):
    """Each query on the host interpreter in both packages: equal current
    and expired rows, in order, tolerance 0."""
    text = app(query, clock)
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # no device refusal on the way
        got, rt = run(siddhi_tpu_torch, text, tape(), clock)
    printed = capsys.readouterr().out
    assert [type(p) for p in rt.plans()] == [InterpSingleQueryPlan]
    want = jax_rows(text, clock)
    assert got == want, name
    assert len(got) > 2, f"{name}: tape too quiet"
    if "all events" in query and name not in ("agg_forever",):
        assert any(k == "exp" for k, _t, _r in got), name
    if name == "log":
        assert printed.count("q: seen, ") == len(got)


@pytest.mark.parametrize("mode", ["never", "auto"])
def test_device_windows_never(mode):
    """A window with aggregates runs the device window plan by default and
    the host interpreter under deviceWindows('never'); the host rows equal
    the JAX package's under 'never', and the device plan's equal the host
    plan's within the JAX package's bound for that comparison."""
    query = ("from S#window.length(40) select sym, avg(price) as a, "
             "sum(volume) as sv, min(price) as lo, max(price) as hi, "
             "count() as n group by sym insert into O;")
    head = "@app:deviceWindows('never')\n" if mode == "never" else ""
    got, rt = run(siddhi_tpu_torch, app(query, "wall", head), tape(), "wall")
    host = jax_rows(app(query, "wall", "@app:deviceWindows('never')\n"),
                    "wall")
    if mode == "never":
        assert [type(p) for p in rt.plans()] == [InterpSingleQueryPlan]
        assert got == host
        return
    assert [type(p) for p in rt.plans()] == [DeviceWindowAggPlan]
    assert len(got) == len(host) > 100
    differ = 0
    for (k1, t1, r1), (k2, t2, r2) in zip(got, host):
        assert (k1, t1, r1[0]) == (k2, t2, r2[0])
        assert r1[1:] == pytest.approx(r2[1:], rel=2e-5, abs=2e-4)
        differ += r1 != r2
    assert differ < len(got)


@pytest.mark.parametrize("mode", ["never", "auto"])
def test_device_filters_never(mode):
    """A filter/projection runs K1's plan by default and the host
    interpreter under deviceFilters('never'), with the JAX package's rows
    under 'never' in both cases."""
    query = ("from S[price > 30 and volume % 3 != 1] select sym, "
             "price * 2 as p2, volume / 7 as q insert into O;")
    head = "@app:deviceFilters('never')\n" if mode == "never" else ""
    got, rt = run(siddhi_tpu_torch, app(query, "wall", head), tape(), "wall")
    want = jax_rows(app(query, "wall", "@app:deviceFilters('never')\n"),
                    "wall")
    kind = InterpSingleQueryPlan if mode == "never" else FilterProjectPlan
    assert [type(p) for p in rt.plans()] == [kind]
    assert got == want and len(got) > 20


def test_device_refusals_demote_with_a_warning():
    """A window query the device window plan refuses and a filter K1's VM
    cannot compile run on the host with a RuntimeWarning naming the query
    under the default modes, and raise under 'always'."""
    for query, always, words in [
            ("from S#window.sort(3, price) select sum(price) as s "
             "insert into O;", "@app:deviceWindows('always')\n",
             "window sort"),
            ("from S#window.length(3) select stddev(price) as s "
             "insert into O;", "@app:deviceWindows('always')\n", "stddev"),
            ("from S[math:log(price + 1.0) > 3] select sym insert into O;",
             "@app:deviceFilters('always')\n", "math:log")]:
        with pytest.warns(RuntimeWarning, match=f"query 'q' runs on the "
                          f"host interpreter: .*{words}"):
            got, rt = run(siddhi_tpu_torch, app(query, "wall", ""), tape(),
                          "wall")
        assert [type(p) for p in rt.plans()] == [InterpSingleQueryPlan]
        assert got == jax_rows(app(query, "wall", ""), "wall") and got
        with pytest.raises(PlanError, match=words):
            siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
                app(query, "wall", always))


def test_fault_and_inner_streams_still_raise():
    for q in ("from !S select sym insert into O;",
              "from #S select sym insert into O;"):
        with pytest.raises(PlanError, match="fault/inner streams"):
            siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
                S + q)


CARRY = [q for q in QUERIES if q[0] in (
    "length", "time", "time_batch", "session", "sort", "frequent",
    "lossy_frequent", "agg_no_window", "rate_grouped_last", "rate_snapshot")]


@pytest.mark.parametrize("name,query,clock", CARRY,
                         ids=[q[0] for q in CARRY])
def test_jax_state_carries_into_the_port(name, query, clock):
    """A JAX host plan's state_dict() halfway through the tape (window,
    aggregator banks with their types, rate limiter), passed through
    host_state_from_jax into a port runtime that takes the JAX string
    table, seq and clock: the rows from there on equal the JAX package's."""
    text = app(query, clock)
    ss = tape()
    half = 160                      # on a flush boundary
    jrows, jrt = run(siddhi_tpu, text, ss, clock, stop=half)
    st = host_state_from_jax(jrt._plans[0].state_dict())

    def carry(rt):
        rt.strings.restore(jrt.strings.state())
        rt._seq = jrt._seq
        rt._clock_ms = jrt._clock_ms
        rt.plans()[0].load_state_dict(st)
    got, _ = run(siddhi_tpu_torch, text, ss[half:], clock, carry=carry)
    assert jrows + got == jax_rows(text, clock) and got, name
