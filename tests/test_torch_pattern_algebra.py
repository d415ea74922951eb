"""The pattern algebra of the `seq` family (K2's plain version) against
the JAX package: count quantifiers (`<m:n>`, `<m:>`, `+`, min 0 below the
head, adjacent counts, a final count), logical `and`/`or` (at the head,
below it, in a sequence), indexed captures (`e[i]`, `e[last]`,
`e[last-1]`) and NULL rows.

Every case runs through `siddhi_tpu` (`@app:devicePatterns('always')`,
its device NFA) and through the port at device="cpu"; the rows must be
equal with NULLs (None) in place, tolerance 0 (prices on the quarter
grid are exact in float32), and the port must pick the JAX package's
family (`chunk` included: where JAX picks it, so does the port).  Also: a final count whose emissions outrun the E lanes (the
plan doubles E and re-runs the block), slot state carried over from a
JAX plan mid-tape (`weights.nfa_state_from_jax`, counters, fill bits and
presence rows included), the shapes once refused (init slots, forks,
absent `and` sides) against the JAX device block, and the shapes the JAX
device block refuses too, raising a PlanError naming the feature and the
host matcher."""
import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.replay import (C4A_BODY, C4N_BODY, C4NS_BODY,
                                     C4O_BODY, STOCK, partitioned)
from siddhi_tpu_torch.weights import nfa_state_from_jax

DEV = "@app:devicePatterns('always')\n"
SEQ = "@app:patternFamily('seq')\n"


def _send(rt, sends):
    handlers: dict = {}
    for sid, row, ts in sends:
        h = handlers.get(sid) or handlers.setdefault(sid, rt.input_handler(sid))
        h.send(row, timestamp=ts)
    rt.flush()


def run_jax(app: str, sends, out: str = "O"):
    rt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    rows: list = []
    rt.add_callback(out, lambda evs: rows.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    _send(rt, sends)
    fam = [p.family for p in rt._plans if isinstance(p, JPlan)]
    assert fam, "the JAX device plan did not engage"
    return rows, fam[0], rt


def run_port(app: str, sends, out: str = "O"):
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rows: list = []
    rt.add_callback(out, lambda evs: rows.extend(
        (e.timestamp, e.data) for e in evs))
    _send(rt, sends)
    return rows, rt.plans()[0].family, rt


def port_family(jax_family: str) -> str:
    """The port's family for the JAX package's: the same, every family
    being ported."""
    return jax_family


def both(app: str, sends, out: str = "O"):
    """Rows and families of both engines; asserts equal rows and the
    JAX package's family."""
    want, jfam, _ = run_jax(app, sends, out)
    got, tfam, trt = run_port(app, sends, out)
    assert got == want, (len(got), len(want),
                         sorted(set(map(str, got)) - set(map(str, want)))[:3],
                         sorted(set(map(str, want)) - set(map(str, got)))[:3])
    assert tfam == port_family(jfam), (tfam, jfam)
    return got, tfam, trt


COUNT_BODY = """
define stream T (temp double);
@info(name='q') from e1=T[temp > 30]<2:3> -> e2=T[temp < 10]
select e1[0].temp as t0, e1[1].temp as t1, e2.temp as tl insert into O;
"""
UNFILLED_BODY = """
define stream T (temp double);
@info(name='q') from every e1=T[temp > 30]<1:3> -> e2=T[temp < 10]
select e1[0].temp as a, e1[1].temp as b, e2.temp as c insert into O;
"""
AB = "define stream A (x int);\ndefine stream B (y int);\n"

# tests/test_nfa_device_algebra.py:46-250, with their sends and, where
# the JAX file pins them, the expected rows
CASES = {
    "count_basic": (COUNT_BODY, [("T", (31.0,), 1000), ("T", (32.0,), 1001),
                                 ("T", (5.0,), 1002)],
                    [(31.0, 32.0, 5.0)]),
    "count_max_and_survivor": (
        COUNT_BODY, [("T", (31.0,), 1000), ("T", (32.0,), 1001),
                     ("T", (33.0,), 1002), ("T", (5.0,), 1003),
                     ("T", (4.0,), 1004)], None),
    "count_plus_sequence_every": (
        "define stream S (v int);\n@info(name='q') from every "
        "e1=S[v > 0]+, e2=S[v == 0] select e1[0].v as first, "
        "e1[last].v as last_, e2.v as z insert into O;",
        [("S", (1,), 1000), ("S", (2,), 1001), ("S", (0,), 1002),
         ("S", (3,), 1003), ("S", (0,), 1004), ("S", (0,), 1005)], None),
    "logical_and": (
        AB + "define stream C (z int);\n@info(name='q') from e1=A and e2=B "
        "-> e3=C select e1.x as x, e2.y as y, e3.z as z insert into O;",
        [("B", (2,), 1000), ("C", (9,), 1001), ("A", (1,), 1002),
         ("C", (3,), 1003)], [(1, 2, 3)]),
    "logical_or_null_side": (
        AB + "@info(name='q') from e1=A or e2=B select e1.x as x, "
        "e2.y as y insert into O;", [("B", (42,), 1000)], [(None, 42)]),
    "logical_and_head_every": (
        AB + "@info(name='q') from every e1=A and e2=B select e1.x as x, "
        "e2.y as y insert into O;",
        [("A", (1,), 1000), ("B", (2,), 1001), ("A", (3,), 1002),
         ("B", (4,), 1003)], None),
    "logical_or_head_every_chain": (
        AB + "@info(name='q') from every e1=A[x > 5] or e2=B[y > 5] -> "
        "e3=A[x < 3] select e1.x as x, e2.y as y, e3.x as z insert into O;",
        [("A", (7,), 1000), ("B", (9,), 1001), ("A", (1,), 1002),
         ("B", (8,), 1003), ("A", (2,), 1004)], None),
    "indexed_capture_unfilled_null": (
        UNFILLED_BODY, [("T", (32.0,), 1000), ("T", (5.0,), 1001),
                        ("T", (41.0,), 1002), ("T", (4.0,), 1003)],
        [(32.0, None, 5.0), (41.0, None, 4.0)]),
    "indexed_capture_filled_then_unfilled": (
        UNFILLED_BODY, [("T", (32.0,), 1000), ("T", (33.0,), 1001),
                        ("T", (5.0,), 1002), ("T", (41.0,), 1003),
                        ("T", (4.0,), 1004)], None),
    "absent_ref_selected_null": (
        "@app:playback\n" + AB + "@info(name='q') from e1=A -> not e2=B for "
        "1 sec select e1.x as x, e2.y as y insert into O;",
        [("A", (7,), 1000), ("A", (8,), 2500)], [(7, None)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_algebra_cases_match_jax(name):
    body, sends, expect = CASES[name]
    got, _fam, _rt = both(body, sends)
    if expect is not None:
        assert sorted(r for _t, r in got) == sorted(expect)


# tests/test_nfa_device_algebra.py:311-343, the in-scope R4 queries
R4 = {
    "min0_mid": (
        "from every e1=S[p > 120] -> e2=S[p > 125]<0:2> -> e3=S[p < 95] "
        "within 1 sec select e1.p as a, e3.p as c insert into O;"),
    "min0_final": (
        "from every e1=S[p > 124] -> e2=S[p > e1.p]<0:3> within 1 sec "
        "select e1.p as a, e2[last].p as b insert into O;"),
    "adjacent_counts": (
        "from every e1=S[p > 122]<1:2> -> e2=S[p < 96]<1:2> -> "
        "e3=S[p > 128] within 1 sec select e1[0].p as a, e2[0].p as b, "
        "e3.p as c insert into O;"),
    "two_counts_separated": (
        "from every e1=S[p > 124]<1:2> -> e2=S[p < 100] -> "
        "e3=S[p > 126]<1:2> within 1 sec select e1[0].p as a, e2.p as b, "
        "e3[0].p as c insert into O;"),
    "sequence_logical_or": (
        "from every e1=S[p > 118], e2=S[p < 100] or e3=S[p > 127] "
        "within 1 sec select e1.p as a, e2.p as b, e3.p as c insert into O;"),
    "sequence_logical_and": (
        "from every e1=S[p > 126], e2=S[p > 90] and e3=S[p > 95] "
        "within 1 sec select e1.p as a insert into O;"),
}
R4_SEEDS = {n: i + 11 for i, n in enumerate(R4)}


def r4_sends(seed: int, n: int = 220):
    rng = np.random.default_rng(seed)
    ps = np.round(rng.uniform(88, 132, size=n) * 4) / 4
    ts = 1_000_000 + np.cumsum(rng.integers(1, 25, size=n))
    return [("S", (float(p),), int(t)) for p, t in zip(ps, ts)]


@pytest.mark.parametrize("name", sorted(R4))
def test_r4_algebra_on_seq_matches_jax(name):
    body = "define stream S (p double);\n@info(name='q') " + R4[name]
    for trial in range(2):
        got, fam, _rt = both(SEQ + body, r4_sends(R4_SEEDS[name] + 100 * trial))
        assert fam == "seq"
        assert got


def tape_sends(keys: int, n: int, seed: int, flush: int = 512, dt: int = 1):
    """`send_batch` flushes of the benchmark tape shape (uniform keys,
    quarter-grid prices), as (rt) -> None."""
    rng = np.random.default_rng(seed)
    flushes = []
    for st in range(0, n, flush):
        m = min(flush, n - st)
        flushes.append((rng.integers(0, keys, size=m).astype(np.int32),
                        np.round(rng.uniform(90.0, 130.0, size=m) * 4) / 4,
                        rng.integers(1, 1000, size=m).astype(np.int32),
                        1_700_000_000_000 + np.arange(st, st + m,
                                                      dtype=np.int64) * dt))

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


def run_tape(pkg, app: str, feed, **kw):
    mgr = pkg.SiddhiManager(**kw)
    rt = mgr.create_app_runtime(app)
    rows: list = []
    rt.add_callback("Out", lambda evs: rows.extend(
        (e.timestamp, e.data) for e in evs))
    if pkg is siddhi_tpu:
        rt.start()
    feed(rt)
    return rows, rt


APPS = {"c4n": C4N_BODY, "c4ns": C4NS_BODY, "c4o": C4O_BODY,
        "c4a": C4A_BODY}


@pytest.mark.parametrize("keys", [8, 48])
@pytest.mark.parametrize("name", sorted(APPS))
def test_the_four_apps_on_seq_match_jax(name, keys):
    """The four apps of C4's shape (replay.C4N etc.), `seq` forced on both
    engines: equal rows, NULLs in place (C4O's losers)."""
    head = f"@app:partitionCapacity({keys})\n" + SEQ
    app = head + partitioned(APPS[name])
    feed = tape_sends(keys, 2000, seed=keys)
    want, jrt = run_tape(siddhi_tpu, DEV + app, feed)
    got, trt = run_tape(siddhi_tpu_torch, app, feed, device="cpu")
    assert trt.plans()[0].family == "seq"
    assert got == want and got
    if name == "c4o":
        assert any(r[2] is None for _t, r in got)
        assert any(r[1] is None for _t, r in got)


def test_c4ns_runs_seq_by_default_like_jax():
    """The capture-dependent count (`e2=S[price > e1.price]<2:4>`) is not
    `scan`-eligible in either package: both run `seq` by default."""
    app = "@app:partitionCapacity(8)\n" + partitioned(C4NS_BODY)
    got, fam, _rt = both(app, [], out="Out")
    assert fam == "seq" and got == []


def test_final_count_burst_doubles_the_lanes():
    """A final count `<1:6>` collecting in many slots at once emits more
    matches per event than E lanes: the plan counts the lost emissions
    (of_lanes), doubles E and re-runs the block from the old state, so no
    row is lost (equal to JAX)."""
    body = ("from every e1=StockStream[price > 100] -> "
            "e2=StockStream[price > 90]<1:6> within 1 sec "
            "select e1.price as a, e2[last].price as b, e2[2].price as c "
            "insert into Out;")
    app = "@app:partitionCapacity(4)\n@app:deviceSlots(8)\n" + SEQ + \
        partitioned(body)
    feed = tape_sends(4, 600, seed=9, flush=300)
    want, _ = run_tape(siddhi_tpu, DEV + app, feed)
    got, rt = run_tape(siddhi_tpu_torch, app, feed, device="cpu")
    plan = rt.plans()[0]
    assert plan.family == "seq" and plan.kernel.E > 2
    assert got == want and len(got) > 1000
    assert int(plan.state["of_lanes"].sum()) == 0


@pytest.mark.parametrize("name", ["c4ns", "c4o", "adjacent"])
def test_state_carried_over_from_jax_mid_tape(name):
    """The JAX `seq` plan's slot state after half the tape -- stations,
    counters (`cnt`, `cnt_on`, `narm`), fill bits (`fl`), captures and
    presence rows -- loads into the port's plan, which continues the tape
    with the JAX plan's rows."""
    body = {"c4ns": C4NS_BODY, "c4o": C4O_BODY,
            "adjacent": "from every e1=StockStream[price > 122]<1:2> -> "
                        "e2=StockStream[price < 96]<1:2> -> "
                        "e3=StockStream[price > 128] within 1 sec select "
                        "e1[0].price as a, e2[0].price as b, e2[last].price "
                        "as b2, e3.price as c insert into Out;"}[name]
    app = "@app:partitionCapacity(8)\n@app:deviceSlots(8)\n" + SEQ + \
        partitioned(body)
    feed = tape_sends(8, 2048, seed=21, flush=256)
    half = feed.n_flushes // 2
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(DEV + app)
    want: list = []
    jrt.add_callback("Out", lambda evs: want.extend(
        (e.timestamp, e.data) for e in evs))
    jrt.start()
    feed(jrt, 0, half)
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    d = jplan.state_dict()
    np_state = {k: np.asarray(v) for k, v in d["state"].items()}
    assert np_state["cnt"].size or np_state["fl"].size
    strings, seq, n_before = jrt.strings.state(), jrt._seq, len(want)
    feed(jrt, half)

    trt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    trt.strings.restore(strings)
    trt._seq = seq
    got: list = []
    trt.add_callback("Out", lambda evs: got.extend(
        (e.timestamp, e.data) for e in evs))
    tplan = trt.plans()[0]
    tplan.load_state_dict({**d, "state": nfa_state_from_jax(np_state,
                                                            "cpu")})
    feed(trt, half)
    assert got == want[n_before:] and got


def test_logical_after_count_never_completes_like_the_jax_device():
    """A logical position right after a count is never entered on the
    device: the count keeps the station and arms its successor, and only
    a (1,1) stream successor consumes that arm (nfa_device.py:984-1003).
    The JAX device NFA therefore emits nothing where its host matcher
    emits matches (ROADMAP C); the port follows the
    device."""
    body = ("define stream S (p double);\n@info(name='q') from every "
            "e1=S[p > 120]<1:2> -> e2=S[p < 95] or e3=S[p > 126] "
            "within 1 sec select e1[0].p as a, e2.p as b, e3.p as c "
            "insert into O;")
    sends = r4_sends(3, 300)
    got, fam, _rt = both(body, sends)
    assert fam == "chunk" and got == []
    host_rt = siddhi_tpu.SiddhiManager().create_app_runtime(
        "@app:devicePatterns('never')\n" + body)
    host: list = []
    host_rt.add_callback("O", lambda evs: host.extend(evs))
    host_rt.start()
    _send(host_rt, sends)
    assert host


@pytest.mark.parametrize("body,feature", [
    ("from e1=StockStream[price > 110]<1:3> -> e2=StockStream[price < 95] "
     "select e1[last-2].price as a insert into Out;", "last-2"),
    ("from e1=StockStream[price > 110] -> e2=StockStream[price < 95] or "
     "e3=StockStream[volume > 990] select e3.volume is null as n "
     "insert into Out;", "null"),
    ("from e1=StockStream[price > 110] -> e2=StockStream[price < 95] or "
     "e3=StockStream[volume > 990] select e3.volume + 1 as v "
     "insert into Out;", "maybe-absent"),
])
def test_later_slice_shapes_raise_naming_the_feature(body, feature):
    """The shapes the JAX device block refuses too (its host matcher runs
    them) raise PlanError naming the feature and the host matcher."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(PlanError, match=feature) as e:
        mgr.create_app_runtime(STOCK + "@info(name='q') " + body)
    assert "host matcher" in str(e.value)


@pytest.mark.parametrize("body,feature", [
    ("from every not StockStream[price > 128] for 1 sec -> "
     "e2=StockStream[price > 100] within 2 sec select e2.price as p "
     "insert into Out;", "sticky"),
    ("from e1=StockStream[price > 110]<0:2> -> e2=StockStream[price < 95] "
     "select e2.price as p insert into Out;", "init slot"),
    ("from e1=StockStream[price > 110] -> every e2=StockStream[price < 95] "
     "select e2.price as p insert into Out;", "every"),
    ("from e1=StockStream[price > 110] -> not StockStream[price > 125] and "
     "e2=StockStream[price < 95] select e1.price as p insert into Out;",
     "logical"),
])
def test_once_refused_shapes_match_jax(body, feature):
    """The shapes this file once showed refused -- an `every` absent head,
    a min-0 count head (init slots), `every` below the head (the stream
    fork), an absent `and` side -- partitioned over 8 keys under
    playback: the JAX device block's rows and family (`seq`)."""
    app = "@app:playback\n" + partitioned(body)
    feed = tape_sends(8, 3000, 40 + len(feature), flush=500, dt=20)
    want, jrt = run_tape(siddhi_tpu, DEV + app, feed)
    got, rt = run_tape(siddhi_tpu_torch, app, feed, device="cpu")
    assert got == want and got, feature
    assert rt.plans()[0].family == "seq" and rt.plans()[0].kernel.ext
