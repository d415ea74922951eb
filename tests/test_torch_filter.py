"""Single-stream filter/projection queries (BASELINE config 1 and the
shapes of test_filter_e2e.py) through both packages: the port on the CPU
(K1's plain version) must emit the JAX package's rows, row for row."""
import warnings

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import PlanError

STOCK = "define stream StockStream (symbol string, price double, volume int);\n"


def _rows(pkg, app, sends, outs, **kw):
    mgr = pkg.SiddhiManager(**kw)
    rt = mgr.create_app_runtime(app)
    got = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, lambda evs, o=o: got[o].extend(
            (e.timestamp, e.data) for e in evs))
    rt.start()
    for sid, kind, payload, ts in sends:
        h = rt.input_handler(sid)
        if kind == "rows":
            for i, row in enumerate(payload):
                h.send(row, timestamp=ts + i)
        else:
            h.send_batch(payload, ts)
    rt.flush()
    mgr.shutdown()
    return got


def _both(app, sends, outs=("Out",)):
    want = _rows(siddhi_tpu, app, sends, outs)
    got = _rows(siddhi_tpu_torch, app, sends, outs, device="cpu")
    assert got == want
    return got


def _stock_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"symbol": np.array([f"K{i}" for i in rng.integers(0, 8, n)]),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "volume": rng.integers(-50, 1000, n).astype(np.int32)}


def test_c1_columnar_flushes():
    app = STOCK + ("@info(name='q') from StockStream[price > 100] "
                   "select * insert into Out;")
    sends = [("StockStream", "batch", _stock_batch(3000, s),
              1_700_000_000_000 + 3000 * s) for s in range(3)]
    got = _both(app, sends)
    assert len(got["Out"]) > 1000


@pytest.mark.parametrize("query", [
    "from StockStream[price > 100.0] select symbol, price insert into Out;",
    "from StockStream[symbol == 'K3'] select price insert into Out;",
    "from StockStream[volume % 2 == 0] select * insert into Out;",
    "from StockStream select volume / 7 as q, volume % 7 as r, "
    "price * 2 + volume as c insert into Out;",
    "from StockStream[ifThenElse(volume > 500, price > 110, price < 95)] "
    "select symbol, volume > 300 as big insert into Out;",
    "from StockStream[price > 100] select symbol, price * 2 as dbl "
    "having dbl > 230 insert into Out;",
    "from StockStream[price > 100] select symbol, price having price < 110 "
    "insert into Out;",
    "from StockStream[price > 100] select * limit 5 insert into Out;",
    "from StockStream[1 == 1] select 7 as seven, symbol insert into Out;",
    "from StockStream select symbol, eventTimestamp() as t, "
    "convert(price, 'long') as lp insert into Out;",
    "from StockStream[not (price > 100) and volume < 100 or symbol != 'K1'] "
    "select math:abs(volume - 500) as d, maximum(price, volume) as m "
    "insert into Out;",
])
def test_filter_shapes_row_for_row(query):
    app = STOCK + query
    rows = [("K1", 75.5, 100), ("K3", 151.25, 2), ("K2", 90.0, 3),
            ("K3", 500.5, 4), ("K7", 101.0, -7), ("K1", 109.75, 900)]
    sends = [("StockStream", "rows", rows, 1000),
             ("StockStream", "batch", _stock_batch(500, 1), 5000)]
    _both(app, sends)


def test_chained_queries_and_autoflush():
    app = STOCK + """
        from StockStream[price > 100] select symbol, price insert into Mid;
        from Mid[price < 120] select symbol, price * 10 as p10 insert into Out;
    """
    rows = [(f"K{i % 5}", 90.0 + (i % 41), i) for i in range(2500)]
    _both(app, [("StockStream", "rows", rows, 0)], outs=("Mid", "Out"))


@pytest.mark.parametrize("query", [
    "from StockStream#window.length(5) select symbol, price insert into Out;",
    "from StockStream select count() as c group by symbol insert into Out;",
    "from StockStream[math:log(price) > 4] select * insert into Out;",
])
def test_later_slices_raise_plan_error(query):
    """These shapes raised PlanError while the host interpreter was a
    later slice; they plan it now (a window without aggregates and
    windowless aggregation have no device plan; `math:log` is not in K1's
    VM, so it demotes with a RuntimeWarning and raises under
    `@app:deviceFilters('always')`) and emit the JAX package's rows."""
    from siddhi_tpu_torch.interp.engine import InterpSingleQueryPlan
    app = STOCK + "@info(name='q') " + query
    demoted = "math:log" in query
    if demoted:
        with pytest.raises(PlanError, match="math:log"):
            siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
                "@app:deviceFilters('always')\n" + app)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
            app)
    assert [type(p) for p in rt.plans()] == [InterpSingleQueryPlan]
    assert bool([x for x in w if "runs on the host interpreter" in
                 str(x.message)]) == demoted
    rows = [(f"K{i % 5}", 90.0 + (i % 41), i) for i in range(300)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _both(app, [("StockStream", "rows", rows, 0)])
    assert len(got["Out"]) > 100
