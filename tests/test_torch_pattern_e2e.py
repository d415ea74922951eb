"""The port's main path as a whole: pattern and sequence apps through
siddhi_tpu_torch.SiddhiManager(device="cpu") (the kernels' plain
versions) against siddhi_tpu on the same seeded tapes, row for row.  Each
app is compared with the JAX package at its default settings (where both
pick the same plan family: `scan` for the within-bounded chains, `seq`
otherwise) and with the sequential `seq` family forced in both; slot
growth and match-buffer retries are forced with tiny slot counts on
`seq`; slot state carried over from the JAX package continues to the JAX
package's result; the shapes once refused at create (init slots, forks,
absent `and` sides) give the JAX package's rows; options outside the
port raise when the app is created.  The JAX package's rows and the port's are
computed once per app and tape (`jax_rows`, `port_rows`) and shared by
the tests that compare them."""
import functools

import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.nfa_device import NFAKernel
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.weights import nfa_state_from_jax

STOCK = "define stream StockStream (symbol string, price double, volume int);\n"
C4_BODY = """from every e1=StockStream[price > 100] -> e2=StockStream[price > e1.price]
    -> e3=StockStream[price > e2.price] within 10 sec
  select e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;"""


def part(body, key="symbol of StockStream"):
    return f"partition with ({key}) begin @info(name='q') {body} end;"


APPS = {
    "c3": STOCK + "@info(name='q') from every e1=StockStream[price > 100] "
                  "-> e2=StockStream[price > e1.price] within 1 sec "
                  "select e1.price as p1, e2.price as p2 insert into Out;",
    "c4": "@app:partitionCapacity(16)\n@app:deviceSlots(32)\n" + STOCK +
          part(C4_BODY),
    "flagship": "@app:partitionCapacity(8)\n"
                "define stream StockStream (symbol string, price double);\n" +
                part("from every e1=StockStream[price > 100.0] -> "
                     "e2=StockStream[price > e1.price] -> "
                     "e3=StockStream[price > e2.price] select e1.price as p1, "
                     "e2.price as p2, e3.price as p3 insert into Out;"),
    "sequence": STOCK + part(
        "from every e1=StockStream[price > 120], "
        "e2=StockStream[price < e1.price] within 1 sec "
        "select e1.symbol as s, e1.price as p1, e2.price as p2 "
        "insert into Out;"),
    "one_shot": STOCK + part(
        "from e1=StockStream[price > 125] -> "
        "e2=StockStream[price > e1.price] select e1.price as p1, "
        "e2.price as p2, e2.volume as v insert into Out;"),
    "having": STOCK + part(
        "from every e1=StockStream[price > 110] -> "
        "e2=StockStream[price > e1.price and volume > e1.volume] "
        "within 2 sec select e1.price as p1, e2.price as p2, "
        "e2.volume - e1.volume as dv having p2 - p1 > 5.0 and dv > 100 "
        "insert into Out;"),
    "single_state": STOCK + part(
        "from every e1=StockStream[price > 127] select e1.symbol as s, "
        "e1.price as p insert into Out;"),
    "two_stream": "define stream A (k string, x int);\n"
                  "define stream B (k string, y double);\n" +
                  part("from every e1=A[x > 3] -> e2=B[y > e1.x] "
                       "within 100 ms select e1.k as k, e1.x as x, "
                       "e2.y as y insert into Out;", "k of A, k of B"),
    # one LONG capture row: see test_two_long_captures_match_host_matcher
    "types": "define stream T (k string, i int, l long, f float, b bool, "
             "d double, s string);\n" +
             part("from every e1=T[i > 2 and b] -> e2=T[l > e1.i and "
                  "(s == e1.s or f > e1.f)] within 50 ms "
                  "select e1.i as i1, e2.l as l2, e1.f as f1, e2.b as b2, "
                  "e1.s as s1, e2.d as d2, e2.i - e1.i as di, "
                  "e2.l / e1.i as q insert into Out;", "k of T"),
}
TWO_LONGS = APPS["types"].replace("l > e1.i", "l > e1.l")
STREAMS = {"two_stream": ("A", "B"), "types": ("T",)}


def tape(app: str, flushes: int = 3, n: int = 600, seed: int = 0) -> list:
    """[(stream, columns, timestamps)], events 7 ms apart, 16 keys; the
    streams of a two-stream app share each flush's time range."""
    rng = np.random.default_rng(seed)
    sends, t = [], 1_700_000_000_000
    for _f in range(flushes):
        for off, sid in enumerate(STREAMS.get(app, ("StockStream",))):
            keys = np.array([f"K{i}" for i in rng.integers(0, 16, n)])
            q4 = np.round(rng.uniform(90.0, 130.0, n) * 4) / 4
            if sid == "StockStream":
                cols = {"symbol": keys, "price": q4,
                        "volume": rng.integers(1, 1000, n).astype(np.int32)}
                if app == "flagship":
                    del cols["volume"]
            elif sid == "A":
                cols = {"k": keys, "x": rng.integers(0, 10, n).astype(
                    np.int32)}
            elif sid == "B":
                cols = {"k": keys, "y": np.round(rng.uniform(0, 12, n) * 4) / 4}
            else:
                cols = {"k": keys, "i": rng.integers(0, 9, n).astype(np.int32),
                        "l": rng.integers(-50, 50, n).astype(np.int64),
                        "f": (np.round(rng.uniform(-4, 4, n) * 4) / 4
                              ).astype(np.float32),
                        "b": rng.integers(0, 2, n).astype(bool),
                        "d": q4,
                        "s": np.array([f"S{i}" for i in
                                       rng.integers(0, 3, n)])}
            sends.append((sid, cols, t + off * 3 + 7 * np.arange(n)))
        t += 7 * n
    return sends


def run(pkg, app, sends, **kw):
    mgr = pkg.SiddhiManager(**kw)
    rt = mgr.create_app_runtime(app)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    for sid, cols, ts in sends:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    return out, rt


SEQ_JAX = "@app:devicePatterns('prefer')\n@app:patternFamily('seq')\n"
SEQ = "@app:patternFamily('seq')\n"       # the port's K2 path


@functools.lru_cache(maxsize=None)
def jax_rows(name: str, variant: str):
    """The JAX package's rows for APPS[name] on tape(name), at its default
    settings or with the `seq` family.  With `seq` it also returns what
    the port needs to take over after the first half of the tape: the
    plan's state_dict, the string table, the event seq and the rows so far
    (None otherwise)."""
    sends = tape(name)
    rt = siddhi_tpu.SiddhiManager().create_app_runtime(
        (SEQ_JAX if variant == "seq" else "") + APPS[name])
    out, carried = [], None
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    for i, (sid, cols, ts) in enumerate(sends):
        if variant == "seq" and i == len(sends) // 2:
            jplan = next(p for p in rt._plans if isinstance(p, JPlan))
            carried = (jplan.state_dict(), rt.strings.state(), rt._seq,
                       len(out))
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    return out, carried


@functools.lru_cache(maxsize=None)
def port_rows(name: str, variant: str = "default") -> list:
    """The port's rows for APPS[name], at its default settings or with
    `seq` forced (K2 then carries every app)."""
    head = SEQ if variant == "seq" else ""
    return run(siddhi_tpu_torch, head + APPS[name], tape(name),
               device="cpu")[0]


@pytest.mark.parametrize("variant", ["default", "seq"])
@pytest.mark.parametrize("name", sorted(APPS))
def test_pattern_rows_equal_jax(name, variant):
    got = port_rows(name, variant)
    assert got == jax_rows(name, variant)[0]
    if name != "one_shot":
        assert len(got) > 5, "tape too quiet to test anything"


def test_two_long_captures_match_host_matcher():
    """Two LONG capture rows (e1.l, e2.l).  The JAX package's device NFA
    mislabels them when it unpacks matches (nfa_device.py _drain_done
    stacks every hi row before every lo row, while _ilane_names expects
    hi/lo pairs), so the oracle here is its sequential host matcher,
    `@app:devicePatterns('never')`; the port keeps int64 rows whole."""
    sends = tape("types")
    want, _ = run(siddhi_tpu, "@app:devicePatterns('never')\n" +
                     TWO_LONGS, sends)
    got, _ = run(siddhi_tpu_torch, TWO_LONGS, sends, device="cpu")
    assert sorted(got) == sorted(want) and len(got) > 5


def test_slot_growth_and_match_buffer_retries(monkeypatch):
    """deviceSlots(2): heads run out of slots, the plan doubles A and re-runs
    the block from its pre-state; the first flush's matches overflow the
    initial match buffer and re-run with a bigger M.  Rows stay equal."""
    app = APPS["c4"].replace("deviceSlots(32)", "deviceSlots(2)")
    sends = tape("c4", flushes=2, n=1500, seed=3)
    calls = []
    orig = NFAKernel.run_block

    def spy(self, state, ev, M):
        st, out = orig(self, state, ev, M)
        calls.append((self.A, M, int(out["meta"][0]), int(out["meta"][1])))
        return st, out
    monkeypatch.setattr(NFAKernel, "run_block", spy)
    got, rt = run(siddhi_tpu_torch, SEQ + app, sends, device="cpu")
    want, _ = run(siddhi_tpu, SEQ_JAX + app, sends)
    assert got == want and got
    plan = rt.plans()[0]
    assert plan.kernel.A > 2 and plan.dropped == 0
    assert any(n > M for _a, M, n, _o in calls), "no match-buffer retry"
    assert any(o > 0 for _a, _M, _n, o in calls), "no slot exhaustion"


def test_slot_cap_drops_like_jax():
    """At the deviceSlotCap ceiling heads are dropped -- the same ones."""
    app = APPS["c4"].replace("deviceSlots(32)",
                             "deviceSlots(2)\n@app:deviceSlotCap(4)")
    sends = tape("c4", flushes=2, n=1500, seed=4)
    with pytest.warns(RuntimeWarning):
        got, rt = run(siddhi_tpu_torch, SEQ + app, sends, device="cpu")
    with pytest.warns(RuntimeWarning):
        want, jrt = run(siddhi_tpu, SEQ_JAX + app, sends)
    assert got == want
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    assert rt.plans()[0].dropped == jplan.dropped > 0


def test_rebase_after_a_long_gap():
    """On `seq`, a flush 2^31 ms after the last one pushes the i32 offsets
    past their budget: the plan rebases its ts/seq bases and the slot state (ancient
    slots clamp and expire) exactly where the JAX package does."""
    sends = tape("c4", flushes=3, n=400, seed=6)
    sid, cols, ts = sends[2]
    sends[2] = (sid, cols, ts + (1 << 31))
    sends.append(("StockStream", tape("c4", 1, 400, seed=7)[0][1],
                  ts[-1] + (1 << 31) + 7 + 7 * np.arange(400)))
    want, _ = run(siddhi_tpu, SEQ_JAX + APPS["c4"], sends)
    got, rt = run(siddhi_tpu_torch, SEQ + APPS["c4"], sends, device="cpu")
    assert got == want and got
    assert rt.plans()[0]._ts_base > int(sends[0][2][0])


@pytest.mark.parametrize("name", ["c4", "types"])
def test_state_carried_from_jax(name):
    """First half of the tape on the JAX package (seq family), its plan
    state carried into the port (seq family too), second half on the
    port: equal to the
    JAX package's rows for the whole tape."""
    sends = tape(name)
    want, (d, strings, seq, n_before) = jax_rows(name, "seq")
    d = dict(d, state=nfa_state_from_jax(d["state"], "cpu"))

    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_app_runtime(SEQ + APPS[name])
    rt.strings.restore(strings)
    rt._seq = seq
    rt.plans()[0].load_state_dict(d)
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, e.data) for e in evs))
    for sid, cols, ts in sends[len(sends) // 2:]:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    assert got == want[n_before:]
    assert got


@pytest.mark.parametrize("body,feature", [
    ("from e1=StockStream[price > 100]<0:5> -> "
     "e2=StockStream[price > 120] select e2.price as p insert into Out;",
     "count"),
    ("from not StockStream[price > 120] for 1 sec -> "
     "e2=StockStream[price > 100] select e2.price as p insert into Out;",
     "absent"),
    ("from every e1=StockStream[price > 100] -> not StockStream[price > 130] "
     "and e2=StockStream[price < 95] "
     "select e1.price as p insert into Out;", "logical"),
    ("from e1=StockStream[price > 100] -> every e2=StockStream[price > 110] "
     "select e2.price as p insert into Out;", "every"),
])
def test_unsupported_shapes_raise_at_create(body, feature):
    """The shapes this file once showed refused at create -- a min-0
    count head, an absent head, an absent `and` side, `every` below the
    head -- now plan on the port's `seq` family and give the JAX package's
    rows on the file's tape (under playback, so deadlines fire)."""
    app = "@app:playback\n" + STOCK + part(body)
    sends = tape("c4", flushes=2, n=400)
    want, _ = run(siddhi_tpu, "@app:devicePatterns('prefer')\n" + app, sends)
    got, rt = run(siddhi_tpu_torch, app, sends, device="cpu")
    assert got == want and got, feature
    assert rt.plans()[0].family == "seq"


@pytest.mark.parametrize("head,feature", [
    ("@app:devicePrecision('f64')\n", "f64"),
    ("@app:patternFamily('dfa')\n", "family"),
])
def test_unsupported_options_raise_at_create(head, feature):
    """f64 raises at create.  A `dfa` request is ported: C4 has no static
    chase node, so it warns with the JAX package's reason and runs `scan`,
    as the JAX package does."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    if feature == "family":
        with pytest.warns(RuntimeWarning, match="'dfa' is not eligible"):
            plan = mgr.create_app_runtime(head + APPS["c4"]).plans()[0]
        with pytest.warns(RuntimeWarning, match="'dfa' is not eligible"):
            jrt = siddhi_tpu.SiddhiManager().create_app_runtime(
                "@app:devicePatterns('prefer')\n" + head + APPS["c4"])
        jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
        assert plan.families["dfa"] == jplan.families["dfa"]
        assert "no static transition" in plan.families["dfa"]
        assert plan.family == jplan.family == "scan"
        return
    with pytest.raises(PlanError, match=feature):
        mgr.create_app_runtime(head + APPS["c4"])


@pytest.mark.parametrize("name", ["c3", "c4", "fused"])
def test_device_patterns_never_raises(name):
    """`@app:devicePatterns('never')` sends patterns to the JAX package's
    host matcher, a later slice of the port: creating the app raises
    PlanError naming it, unpartitioned, partitioned or fusable alike (no
    device plan is built behind the annotation's back)."""
    app = APPS.get(name) or STOCK + "\n".join(
        f"@info(name='q{i}') from every e1=StockStream[price > {100 + i}] "
        f"-> e2=StockStream[price > e1.price] within 1 sec "
        f"select e1.price as p1 insert into Out;" for i in range(8))
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(PlanError, match=r"devicePatterns\('never'\) needs "
                       r"the host matcher"):
        mgr.create_app_runtime("@app:devicePatterns('never')\n" + app)
    assert mgr.create_app_runtime("@app:devicePatterns('prefer')\n" + app)
