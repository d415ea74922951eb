"""Init slots, slot forking and absent logical sides of the port (K2's
plain version) against the JAX package's device block on the CPU.

The shapes are the JAX package's own: absent heads, a logical head with
an absent side and min-0 count heads (`ChainSpec.needs_init_slot`, the
shapes of tests/test_nfa_init_slot.py), `every` around an absent state at
the head or below it and `every` on a stream position below the head
(`_fork_slots`), absent sides of `and`/`or` (the logical-absent matrix of
tests/test_pattern_matrix.py), and `is null` over pattern presence in a
selector, in `having` and in a later position's filter, on `seq` and on
`scan`.  Every app runs through `siddhi_tpu` under
`@app:devicePatterns('prefer')` (its device block; the test asserts the
JAX plan is a DevicePatternPlan) and through the port at device="cpu";
rows are compared in order with None in place, tolerance 0.  Also: K2's
plain version against the JAX package's jitted block on recorded blocks
with fired deadlines, forks and timer ticks; a fork overflow that grows
A; the slot state of a JAX plan carried over mid-tape (a pending init
slot and a sticky deadline); the START anchor through a snapshot; the
JAX device block's own refusals, word for word.

`e1 is null` over a bare ref does not parse as a presence test in the
JAX package (it reads as an attribute and fails); the port compiles it
to the ref's presence row, and the tests hold it to the JAX package's
`e1[0] is null` (a count ref) or to the NULL of the ref's column."""
import functools

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.nfa_device import NO_FIRST
from siddhi_tpu_torch.kernels.expr_eval import unpack_mask
from siddhi_tpu_torch.kernels.nfa_block import nfa_block_plain
from siddhi_tpu_torch.replay import C4O_BODY, partitioned
from siddhi_tpu_torch.weights import nfa_state_from_jax

PREFER = "@app:devicePatterns('prefer')\n"
ALWAYS = "@app:devicePatterns('always')\n"
T0 = 1_000_000
HEAD = """
@app:playback
define stream S1 (sym string, price double);
define stream S2 (sym string, price double);
define stream S3 (sym string, price double);
"""


def _run(pkg, app: str, sends, marks=(), anchor=True, every=1, **kw):
    """Rows (ts, data) of stream O: `set_time(T0 - 1)` anchors the clock
    (unless `anchor` is False), the events are sent in time order and
    flushed `every` events, the marks are `set_time` calls in time order
    with the events."""
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    out = []
    rt.add_callback("O", lambda evs: out.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    if pkg is siddhi_tpu:
        rt.start()
    if anchor:
        rt.set_time(T0 - 1)
    marks = sorted(marks)
    mi = 0
    for i, (sid, row, ts) in enumerate(sorted(sends, key=lambda s: s[2])):
        while mi < len(marks) and marks[mi] <= ts:
            rt.set_time(marks[mi])
            mi += 1
        rt.input_handler(sid).send(row, timestamp=ts)
        if i % every == every - 1:
            rt.flush()
    for t in marks[mi:]:
        rt.set_time(t)
    rt.flush()
    return out, rt


def jax_run(app: str, sends, marks=(), anchor=True, every=1):
    out, rt = _run(siddhi_tpu, PREFER + app, sends, marks, anchor, every)
    assert any(isinstance(p, JPlan) for p in rt._plans), \
        "the JAX device block did not engage"
    return out, rt


def port_run(app: str, sends, marks=(), anchor=True, every=1):
    return _run(siddhi_tpu_torch, app, sends, marks, anchor, every,
                device="cpu")


def both(body: str, sends, marks=(), jax_body=None, anchor=True, every=1):
    """The port's rows for HEAD + body, asserted equal to the JAX device
    block's for HEAD + (jax_body or body), on the JAX package's family
    (`seq` for init slots and absent states, `chunk` for a within-bounded
    `every` chain)."""
    want, jrt = jax_run(HEAD + (jax_body or body), sends, marks, anchor,
                        every)
    got, rt = port_run(HEAD + body, sends, marks, anchor, every)
    assert got == want, (len(got), len(want), got[:4], want[:4])
    jfam = [p.family for p in jrt._plans if isinstance(p, JPlan)]
    assert [rt.plans()[0].family] == jfam
    return got, rt


def fuzz_sends(seed: int, n: int = 40, lo: int = 10, hi: int = 120):
    rng = np.random.default_rng(seed)
    ts = T0 + np.cumsum(rng.integers(lo, hi, size=n))
    return [(("S1", "S2", "S3")[int(rng.integers(0, 3))],
             (f"E{i}", float(rng.integers(5, 40))), int(ts[i]))
            for i in range(n)]


# ---------------------------------------------------------------------------
# the shapes of tests/test_nfa_init_slot.py
# ---------------------------------------------------------------------------

ENGAGED_SHAPES = {
    "absent_head": "from not S1[price>20] for 1 sec -> e2=S2[price>30] "
                   "select e2.sym as b insert into O;",
    "every_absent_head": "from every not S1[price>10] for 1 sec -> "
                         "e2=S2[price>20] select e2.sym as b insert into O;",
    "seq_absent_tail": "from e1=S1[price>10], not S2[price>20] for 1 sec "
                       "select e1.sym as a insert into O;",
    "min0_head": "from e1=S1[price>10]<0:3> -> e2=S2[price>20] "
                 "select e2.sym as b insert into O;",
    "every_absent_mid": "from e1=S1[price>10] -> every not S2[price>20] "
                        "for 1 sec -> e3=S3[price>30] "
                        "select e1.sym as a, e3.sym as b insert into O;",
}

FUZZ_SHAPES = [
    "from not S1[price>20] for 300 milliseconds -> e2=S2[price>30] "
    "select e2.sym as b insert into O;",
    "from every not S1[price>15] for 250 milliseconds -> e2=S2[price>25] "
    "select e2.sym as b insert into O;",
    "from e1=S1[price>10], not S2[price>20] for 200 milliseconds "
    "select e1.sym as a insert into O;",
    "from e1=S1[price>10]<0:2> -> e2=S2[price>20] "
    "select e2.sym as b insert into O;",
    "from e1=S1[price>10] -> every not S2[price>15] for 250 milliseconds "
    "-> e3=S3[price>20] select e1.sym as a, e3.sym as b insert into O;",
]


@pytest.mark.parametrize("name", list(ENGAGED_SHAPES))
def test_engaged_shape_equal_jax(name):
    """Each shape runs on the port's `seq` plan (with the EXT kernel but
    for the absent tail of a sequence, which K2 ran before) and gives the
    JAX device block's rows on a tape with quiet periods."""
    sends = fuzz_sends(7, n=30, lo=50, hi=400)
    _got, rt = both(ENGAGED_SHAPES[name], sends, [sends[-1][2] + 1500])
    assert rt.plans()[0].kernel.ext == (name != "seq_absent_tail")


@pytest.mark.parametrize("si", range(len(FUZZ_SHAPES)))
def test_fuzz_shapes_equal_jax(si):
    """The fuzz tapes of tests/test_nfa_init_slot.py (seeds 100 + si, four
    trials of 40 events), a `set_time` 500 ms past the last event."""
    rng = np.random.default_rng(100 + si)
    total = 0
    for _trial in range(4):
        n = 40
        ts = T0 + np.cumsum(rng.integers(10, 120, size=n))
        sends = [(("S1", "S2", "S3")[int(rng.integers(0, 3))],
                  (f"E{i}", float(rng.integers(5, 40))), int(ts[i]))
                 for i in range(n)]
        got, _rt = both(FUZZ_SHAPES[si], sends, [int(ts[-1]) + 500])
        total += len(got)
    if si != 2:     # the strict sequence's tapes break its contiguity
        assert total > 0


def test_min0_head_scenarios():
    body = ("from e1=S1[price>10]<0:3> -> e2=S2[price>20] "
            "select e1.sym as a, e2.sym as b insert into O;")
    got, _ = both(body, [("S2", ("B", 25.0), T0 + 100)])
    assert [r for _t, r in got] == [(None, "B")]
    got, _ = both(body, [("S1", ("A", 15.0), T0), ("S1", ("A2", 16.0),
                                                    T0 + 50),
                         ("S2", ("B", 25.0), T0 + 100)])
    assert got and got[0][1][1] == "B"


def test_seq_absent_mid_strictness():
    body = ("from e1=S1[price>10], not S2[price>20] for 1 sec, "
            "e3=S3[price>30] select e1.sym as a, e3.sym as b insert into O;")
    got, _ = both(body, [("S1", ("A", 15.0), T0),
                         ("S3", ("C", 35.0), T0 + 1100)], [T0 + 1050])
    broken, _ = both(body, [("S1", ("A", 15.0), T0),
                            ("S3", ("C", 35.0), T0 + 500),
                            ("S3", ("C2", 36.0), T0 + 1100)], [T0 + 1050])
    assert [r for _t, r in got] == [("A", "C")] and broken == []


def test_every_absent_head_rearms():
    body = ("from every not S1[price>10] for 1 sec -> e2=S2[price>20] "
            "select e2.sym as b insert into O;")
    got, _ = both(body, [("S2", ("B1", 25.0), T0 + 1200),
                         ("S2", ("B2", 26.0), T0 + 2400)],
                  [T0 + 1100, T0 + 2300])
    assert len(got) >= 2


def test_rebase_keeps_no_first():
    """A > 2^30 ms jump rebases the ts offsets; an unstarted init slot
    keeps its NO_FIRST anchor instead of turning ancient."""
    body = ("from e1=S1[price>10]<0:3> -> e2=S2[price>20] "
            "within 1000 sec select e2.sym as b insert into O;")
    jump = 4_000_000_000
    got, rt = both(body, [("S2", ("miss", 5.0), T0),
                          ("S2", ("B", 25.0), T0 + jump)])
    assert [r for _t, r in got] == [("B",)]


def test_playback_anchor_without_set_time():
    """Before the clock is set, a playback plan anchors at the earliest
    buffered event, not at the wall clock."""
    body = ("from not S1[price>20] for 1 sec -> e2=S2[price>30] "
            "select e2.sym as b insert into O;")
    sends = [("S1", ("x", 5.0), T0), ("S2", ("B", 35.0), T0 + 1200)]
    got, _ = both(body, sends, [T0 + 1100], anchor=False)
    assert [r for _t, r in got] == [("B",)]


def test_start_anchor_survives_a_snapshot():
    """The START anchor travels in state_dict(): a plan restored late
    keeps the original deadline (the JAX package's behaviour)."""
    body = ("from not S1[price>20] for 1 sec -> e2=S2[price>30] "
            "select e2.sym as b insert into O;")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        HEAD + body)
    rt.set_time(T0)
    rt.flush()
    plan = rt.plans()[0]
    assert plan.next_wakeup() == T0 + 1000
    d = plan.state_dict()
    assert d["start_anchor"] == T0

    rt2 = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        HEAD + body)
    out = []
    rt2.add_callback("O", lambda evs: out.extend(tuple(e.data)
                                                 for e in evs))
    rt2.set_time(T0 + 9000)
    rt2.plans()[0].load_state_dict(d)
    assert rt2.plans()[0].next_wakeup() == T0 + 1000
    rt2.set_time(T0 + 9500)
    rt2.input_handler("S2").send(("late", 35.0), timestamp=T0 + 9600)
    rt2.flush()
    want, _ = jax_run(HEAD + body, [("S2", ("late", 35.0), T0 + 9600)],
                      [T0 + 9500])
    assert out == [r for _t, r in want] == [("late",)]


# ---------------------------------------------------------------------------
# absent sides of and/or (tests/test_pattern_matrix.py:174-215)
# ---------------------------------------------------------------------------

NOT_AND = ("from e1=S1[price>10] -> not S2[price>20] and e3=S3[price>30] "
           "select e1.sym as a, e3.sym as c insert into O;")
NOT_AND_HEAD = ("from not S1[price>10] and e2=S2[price>20] -> "
                "e3=S3[price>30] select e2.sym as b, e3.sym as c "
                "insert into O;")
NOT_FOR_AND = ("from e1=S1[price>10] -> not S2[price>20] for 1 sec and "
               "e3=S3[price>30] select e1.sym as a insert into O;")
NOT_FOR_OR = ("from e1=S1[price>10] -> not S2[price>20] for 1 sec or "
              "e3=S3[price>30] select e1.sym as a, e3.sym as c "
              "insert into O;")
LOGICAL_ABSENT_CASES = {
    "and_quiet": (NOT_AND, [("S1", ("A", 15.0), T0),
                            ("S3", ("C", 35.0), T0 + 300)], [], 1),
    "and_e2": (NOT_AND, [("S1", ("A", 15.0), T0),
                         ("S2", ("B", 25.0), T0 + 100),
                         ("S3", ("C", 35.0), T0 + 300)], [], 0),
    "and_head_quiet": (NOT_AND_HEAD, [("S2", ("B", 25.0), T0),
                                      ("S3", ("C", 35.0), T0 + 300)], [], 1),
    "and_head_e1": (NOT_AND_HEAD, [("S1", ("A", 15.0), T0 - 10),
                                   ("S2", ("B", 25.0), T0),
                                   ("S3", ("C", 35.0), T0 + 300)], [], 0),
    "for_and_quiet": (NOT_FOR_AND, [("S1", ("A", 15.0), T0),
                                    ("S3", ("C", 35.0), T0 + 400)],
                      [T0 + 1100], 1),
    "for_and_e2": (NOT_FOR_AND, [("S1", ("A", 15.0), T0),
                                 ("S2", ("B", 25.0), T0 + 200),
                                 ("S3", ("C", 35.0), T0 + 400)],
                   [T0 + 1100], 0),
    "for_or_e3": (NOT_FOR_OR, [("S1", ("A", 15.0), T0),
                               ("S3", ("C", 35.0), T0 + 400)],
                  [T0 + 1100], 1),
    "for_or_quiet": (NOT_FOR_OR, [("S1", ("A", 15.0), T0)], [T0 + 1100], 1),
    "for_or_e2_only": (NOT_FOR_OR, [("S1", ("A", 15.0), T0),
                                    ("S2", ("B", 25.0), T0 + 200)],
                       [T0 + 1100], 0),
    "for_or_e2_then_e3": (NOT_FOR_OR, [("S1", ("A", 15.0), T0),
                                       ("S2", ("B", 25.0), T0 + 200),
                                       ("S3", ("C", 35.0), T0 + 500)],
                          [T0 + 1100], 1),
}


@pytest.mark.parametrize("name", list(LOGICAL_ABSENT_CASES))
def test_logical_absent_matrix(name):
    body, sends, ticks, expected = LOGICAL_ABSENT_CASES[name]
    got, _ = both(body, sends, ticks)
    assert len(got) == expected, (name, got)


def test_for_or_quiet_emits_null_e3():
    got, _ = both(NOT_FOR_OR, [("S1", ("A", 15.0), T0)], [T0 + 1100])
    assert [r for _t, r in got] == [("A", None)]


# ---------------------------------------------------------------------------
# `every` below the head (tests/test_nfa_device_algebra.py:313-325)
# ---------------------------------------------------------------------------

EVERY_BELOW = {
    "every_below": (
        "from e1=S[p > 120] -> every e2=S[p > e1.p] within 1 sec "
        "select e1.p as a, e2.p as b insert into O;"),
    "every_below_3state": (
        "from e1=S[p > 124] -> every e2=S[p > e1.p] -> e3=S[p < 95] "
        "within 1 sec select e1.p as a, e2.p as b, e3.p as c insert into O;"),
    "every_head_and_below": (
        "from every e1=S[p > 124] -> every e2=S[p > e1.p] "
        "within 500 milliseconds select e1.p as a, e2.p as b "
        "insert into O;"),
}


def stock_sends(seed: int, n: int = 220):
    rng = np.random.default_rng(seed)
    ps = np.round(rng.uniform(88, 132, size=n) * 4) / 4
    ts = 1_000_000 + np.cumsum(rng.integers(1, 25, size=n))
    return [("S", (float(p),), int(t)) for p, t in zip(ps, ts)]


@pytest.mark.parametrize("name", list(EVERY_BELOW))
def test_every_below_the_head_equal_jax(name):
    app = "define stream S (p double);\n" + EVERY_BELOW[name]
    total = 0
    for seed in (41, 42):
        sends = stock_sends(seed, 330)
        want, _ = jax_run(app, sends, anchor=False, every=8)
        got, rt = port_run(app, sends, anchor=False, every=8)
        assert got == want
        assert rt.plans()[0].kernel.ext
        total += len(got)
    assert total > 3


def test_fork_overflow_grows_the_slots():
    """Two slots a lane cannot hold the clones of `every e2`: the plan
    grows A (a growth caused by clones without a free slot) and re-runs
    the block, ending at the JAX `seq` plan's rows and slot count."""
    app = ("@app:deviceSlots(2)\n@app:patternFamily('seq')\n"
           "define stream S (p double);\n"
           + EVERY_BELOW["every_head_and_below"])
    sends = stock_sends(43)
    want, jrt = jax_run(app, sends, anchor=False)
    got, rt = port_run(app, sends, anchor=False)
    plan = rt.plans()[0]
    assert got == want and got
    assert plan.kernel.A > 2 and plan.growths["forks"] > 0
    jplan = [p for p in jrt._plans if isinstance(p, JPlan)][0]
    assert plan.kernel.A == jplan.kernel.A


# ---------------------------------------------------------------------------
# `is null` over pattern presence
# ---------------------------------------------------------------------------

def test_is_null_in_selector_having_and_filter():
    """The selector's `e1 is null` and `e1[0] is null`, `having e1[0] is
    null` and a later filter's `e1[0] is null` / `e1 is null` over a min-0
    count, each equal to the JAX package's `e1[0] is null`."""
    sends = fuzz_sends(3, n=60)
    marks = [sends[-1][2] + 2500]
    base = ("from every e0=S2[price>25] -> e1=S1[price>30]<0:2> -> "
            "e3=S3[price>20{f}] within 2 sec select e1[0].sym as a, "
            "{n} as none, e3.sym as c {h}insert into O;")
    jax_sel = base.format(f="", n="e1[0] is null", h="")
    got, _ = both(base.format(f="", n="e1 is null", h=""), sends, marks,
                  jax_body=jax_sel, every=6)
    assert any(r[1] for _t, r in got) and not all(r[1] for _t, r in got)
    assert all(r[1] == (r[0] is None) for _t, r in got)
    both(jax_sel, sends, marks, every=6)
    having = base.format(f="", n="e1[0] is null", h="having e1[0] is null ")
    got, _ = both(having, sends, marks, every=6)
    assert got and all(r[1] for _t, r in got)
    filt = base.format(f=" and e1[0] is null", n="e1[0] is null", h="")
    got, _ = both(filt.replace("e1[0] is null]", "e1 is null]"), sends,
                  marks, jax_body=filt, every=6)
    assert got and all(r[0] is None for _t, r in got)


def test_is_null_over_an_or_side_on_seq_and_scan():
    """`e3 is null` beside C4O's columns, on `seq` (forced) and on the
    default family (`scan`, its presence row from K5): true exactly where
    the JAX package's e3.volume is NULL."""
    body = C4O_BODY.replace("e3.volume as v3", "e3.volume as v3, "
                            "e3 is null as no_e3")
    rng = np.random.default_rng(5)
    n = 1000
    cols = {"symbol": np.array([f"K{i}" for i in rng.integers(0, 8, n)]),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "volume": rng.integers(1, 1000, n).astype(np.int32)}
    ts = 1_700_000_000_000 + 3 * np.arange(n)

    def rows(pkg, app, **kw):
        rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        if pkg is siddhi_tpu:
            rt.start()
        for lo in range(0, n, 500):
            rt.input_handler("StockStream").send_batch(
                {k: v[lo:lo + 500] for k, v in cols.items()}, ts[lo:lo + 500])
            rt.flush()
        return out, rt
    for head in ("", "@app:patternFamily('seq')\n"):
        want, _ = rows(siddhi_tpu, PREFER + head + partitioned(C4O_BODY))
        got, rt = rows(siddhi_tpu_torch, head + partitioned(body),
                       device="cpu")
        assert rt.plans()[0].family == ("seq" if head else "scan")
        assert [(t, r[:3]) for t, r in got] == want
        assert all(r[3] == (r[2] is None) for _t, r in got)
        assert any(r[3] for _t, r in got) and not all(r[3] for _t, r in got)


# ---------------------------------------------------------------------------
# partitioned lanes, fused groups
# ---------------------------------------------------------------------------

PART_STREAMS = ("@app:playback\ndefine stream A (k string, x int);\n"
                "define stream B (k string, y int);\n")


def part_sends(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    t, out = T0, []
    for _ in range(n):
        t += int(rng.integers(1, 200))
        sid = ("A", "B")[int(rng.integers(0, 2))]
        out.append((sid, (f"K{int(rng.integers(0, 4))}",
                          int(rng.integers(0, 10))), t))
    return out


@pytest.mark.parametrize("body", [
    "from every not A[x > 8] for 500 milliseconds -> e2=B[y > 6] "
    "within 2 sec select e2.k as k, e2.y as y insert into O;",
    "from every e1=A[x > 6] -> every not B[y > 8] for 300 milliseconds -> "
    "e3=A[x > e1.x] within 3 sec select e1.x as x1, e3.x as x3 "
    "insert into O;",
    "from every e1=A[x > 7] -> e2=B[y > 5] or not A[x > 8] for 400 "
    "milliseconds within 2 sec select e1.x as x, e2.y as y insert into O;",
])
def test_partitioned_lanes_equal_jax(body):
    """Each key's lane arms its init slot on its own first event."""
    app = PART_STREAMS + ("partition with (k of A, k of B) begin "
                          f"@info(name='q') {body} end;")
    sends = part_sends(11)

    def run(pkg, app, **kw):
        """Flushes of 20 events."""
        rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
        out = []
        rt.add_callback("O", lambda evs: out.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        for i, (sid, row, ts) in enumerate(sends):
            rt.input_handler(sid).send(row, timestamp=ts)
            if i % 20 == 19:
                rt.flush()
        rt.flush()
        return out, rt
    want, _ = run(siddhi_tpu, PREFER + app)
    got, rt = run(siddhi_tpu_torch, app, device="cpu")
    assert got == want and len(got) > 3
    assert rt.plans()[0].P >= 4


def test_fused_absent_heads_equal_jax():
    """Eight absent-head queries differing in constants fuse into one
    plan of 8 lanes (each armed on a tick at the START anchor) and give
    the JAX package's rows query by query."""
    qs = "\n".join(
        f"@info(name='q{i}') from not S1[price > {30 + i}] for "
        f"300 milliseconds -> e2=S2[price > {10 + 2 * i}] select e2.sym as b "
        f"insert into O;" for i in range(8))
    sends = fuzz_sends(21, n=60, lo=20, hi=200)
    marks = [T0 + 200, sends[-1][2] + 1000]
    want, _ = _run(siddhi_tpu, PREFER + HEAD + qs, sends, marks)
    got, rt = port_run(HEAD + qs, sends, marks)
    plans = rt.plans()
    assert len(plans) == 1 and plans[0].n_queries == 8
    assert sorted(got) == sorted(want) and got


# ---------------------------------------------------------------------------
# the block against the JAX block; state carried over from the JAX plan
# ---------------------------------------------------------------------------

def _jax_blocks(app: str, sends, marks) -> list:
    """Every block the JAX plan ran: (kernel, T, M, state in, ev)."""
    blocks = []
    orig = JPlan._call_block

    def spy(self, kern, T, M, st, ev):
        blocks.append((kern, T, M, {k: np.asarray(v) for k, v in st.items()},
                       dict(ev)))
        return orig(self, kern, T, M, st, ev)
    JPlan._call_block = spy
    try:
        jax_run(app, sends, marks)
    finally:
        JPlan._call_block = orig
    return blocks


@functools.lru_cache(maxsize=None)
def _recorded(which: str):
    bodies = {
        "fork": "from every not S1[price>36] for 250 milliseconds -> "
                "e2=S2[price>25] within 2 sec select e2.sym as b, "
                "e2.price as p insert into O;",
        "logical": NOT_FOR_OR.replace("from e1", "from every e1"),
        "stream_fork": "from every e1=S1[price>30] -> every "
                       "e2=S2[price>e1.price] -> e3=S3[price>20] within 1 sec "
                       "select e1.sym as a, e2.sym as b, e3.sym as c "
                       "insert into O;"}
    sends = fuzz_sends(17, n=80)
    marks = [int(s[2]) + 5 for s in sends[::9]] + [sends[-1][2] + 2500]
    app = "@app:patternFamily('seq')\n" + HEAD + bodies[which]
    return app, _jax_blocks(app, sends, marks)


@pytest.mark.parametrize("which", ["fork", "logical", "stream_fork"])
def test_plain_block_matches_jax_block(which):
    """K2's plain version on every block the JAX plan ran (ticks, fired
    deadlines, forks among them) gives the JAX block's new state, match
    count, earliest deadline and match rows."""
    app, blocks = _recorded(which)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    kern0 = rt.plans()[0].kernel
    ticks = forks = 0
    for jk, T, M, st, ev in blocks:
        before = int((st["occ"] != 0).sum())
        a, p = st["occ"].shape
        kern = kern0.with_shape(p, a)
        state = nfa_state_from_jax(st, "cpu")
        tev = {k: torch.from_numpy(np.array(v)) for k, v in ev.items()
               if k not in ("__base_ts__", "__base_seq__", "__anchor__")}
        tev["__base_ts__"] = int(ev["__base_ts__"])
        if "__anchor__" in ev:
            tev["__anchor__"] = int(ev["__anchor__"])
        pre = [None if w is None else unpack_mask(w, T * p).view(T, p)
               for w in kern.pre_masks(tev)]
        new, out = nfa_block_plain(kern, state, tev, pre, M)
        jnew, jout = jk.block_fn(T, M)(dict(st), ev)
        for key in ("occ", "first_ts", "head_seq", "caps_i", "caps_f", "dl",
                    "fl", "armed0", "of_slots", "init"):
            if key in jnew:
                np.testing.assert_array_equal(new[key].numpy(), np.asarray(
                    jnew[key]), err_msg=key)
        ipack = np.asarray(jout["i"])
        n, dlm = int(ipack[0, 0]), int(ipack[0, 3])
        assert int(out["meta"][0]) == n and int(out["meta"][2]) == dlm
        li, names = kern.lane_names_i, jk.out_names
        rows = sorted(zip(*[out["out_i"][li.index(c)][:n].tolist() for c in
                            ("__comp_ts__", "__comp_seq__",
                             "__head_seq__")]))
        jrows = sorted(zip(*[ipack[1 + names.index(c)][:n].tolist()
                             for c in ("__timestamp__", "__seq__",
                                       "__head_seq__")]))
        assert rows == jrows
        ticks += "__tick__" in ev
        # an init-slot chain gains slots only by arming a lane or forking
        armed = int(np.asarray(jnew["init"]).sum()) - int(st["init"].sum()) \
            if "init" in st else 0
        forks += int((np.asarray(jnew["occ"]) != 0).sum()) > before + armed
    assert len(blocks) > 5
    if which != "stream_fork":      # the chains with deadlines
        assert ticks
    if which == "fork":
        assert forks


def test_state_carried_over_mid_tape():
    """The first half of a tape on the JAX package, its slot state (a
    pending init slot, sticky deadlines) carried into the port, the second
    half on the port: the rows of the whole tape equal the JAX plan's."""
    body = ("from every not S1[price>36] for 250 milliseconds -> "
            "e2=S2[price>25] within 2 sec select e2.sym as b, e2.price as p "
            "insert into O;")
    sends = fuzz_sends(23, n=80)
    half = len(sends) // 2
    want, _ = jax_run(HEAD + body, sends)
    first, jrt = jax_run(HEAD + body, sends[:half])
    jplan = [p for p in jrt._plans if isinstance(p, JPlan)][0]
    d = jplan.state_dict()
    st = d["state"]
    assert bool(np.asarray(st["init"]).all())
    assert (np.asarray(st["dl"]) != 2 ** 31 - 1).any()
    assert (np.asarray(st["first_ts"]) == int(NO_FIRST)).any()
    d = dict(d, state=nfa_state_from_jax(st, "cpu"))
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        HEAD + body)
    rt.strings.restore(jrt.strings.state())
    rt._seq = jrt._seq
    rt._clock_ms = jrt._clock_ms
    rt.plans()[0].load_state_dict(d)
    got = []
    rt.add_callback("O", lambda evs: got.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    for sid, row, ts in sends[half:]:
        rt.input_handler(sid).send(row, timestamp=ts)
        rt.flush()
    assert first + got == want and got


REFUSALS = [
    ("from e1=S1[price>10] -> every (e2=S2[price>20] or e3=S3[price>30]) "
     "select e1.sym as a insert into O;",
     "`every`-wrapped logical/count state below the head"),
    ("from every (not S1[price>10] and e2=S2[price>20]) -> e3=S3[price>30] "
     "select e3.sym as c insert into O;",
     "`every`-wrapped absent-logical or optional-count head"),
    ("from e1=S1[price>10]<1:2> -> e2=S2[price>20]<0:2> -> "
     "not S3[price>30] for 1 sec select e1[0].sym as a insert into O;",
     "optional count run after a counting state landing on a non-stream "
     "state"),
]


@pytest.mark.parametrize("body,words", REFUSALS)
def test_jax_device_refusals_name_the_host_matcher(body, words):
    """The JAX device block's own refusals (`lower_chain`), word for word,
    naming the host matcher that runs them there (its `prefer` plans no
    device block for them); the port raises them under
    `@app:devicePatterns('always')`."""
    from siddhi_tpu_torch.core.planner import PlanError
    with pytest.raises(PlanError) as e:
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
            ALWAYS + HEAD + body)
    assert words in str(e.value) and "host matcher" in str(e.value)
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(PREFER + HEAD + body)
    assert not any(isinstance(p, JPlan) for p in jrt._plans)


@pytest.mark.parametrize("body,words", REFUSALS)
def test_jax_device_refusals_run_on_the_host_matcher(body, words):
    """The same texts under the default mode: the port plans its host
    matcher with a RuntimeWarning naming the query and the refusal, and
    gives the rows of the JAX package's 'prefer' (its host matcher)."""
    from siddhi_tpu_torch.interp.engine import InterpPatternQueryPlan
    sends = [s for seed in range(4) for s in fuzz_sends(
        seed, n=60, lo=30, hi=400)]
    sends = [(sid, row, T0 + i * 97) for i, (sid, row, _ts) in
             enumerate(sends)]
    with pytest.warns(RuntimeWarning, match=r"runs on the host matcher: "
                      r".*" + words.split()[0]):
        got, rt = port_run(HEAD + body, sends)
    assert [type(p) for p in rt.plans()] == [InterpPatternQueryPlan]
    want, _ = _run(siddhi_tpu, PREFER + HEAD + body, sends)
    assert got == want and got
