"""Absent (`not ... for`) positions of the port against siddhi_tpu on the CPU.

Inputs come from numpy seeds and go to both packages; every comparison
has tolerance 0.  Covered: `e1=A -> not B for 1 sec` and `e1=A -> not B
for 500 milliseconds -> e3=C` (tests/test_nfa_device_algebra.py:122 and
:159), an `every` head with a capture-reading forbidden filter,
unpartitioned and partitioned, under `@app:playback` (deadlines fire on
events) and on the wall clock with `set_time` (deadlines fire on timer
ticks); K2's plain version against the JAX package's jitted block on
recorded blocks with live deadlines and on a tick block; the `dl` rebase;
the absent shapes once refused (an `every` absent, an absent head, an
absent `and` side), now equal to the JAX block; and the selector over an
absent ref that stays refused.  The JAX package runs each
unpartitioned app under `@app:devicePatterns('prefer')`, its device NFA."""
import functools

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.nfa_device import (NO_DEADLINE,
                                              DeviceNFAUnsupported)
from siddhi_tpu_torch.kernels.expr_eval import unpack_mask
from siddhi_tpu_torch.kernels.nfa_block import nfa_block_plain
from siddhi_tpu_torch.weights import nfa_state_from_jax

PREFER = "@app:devicePatterns('prefer')\n"
AB = "define stream A (k string, x int);\ndefine stream B (k string, y int);\n"
ABC = AB + "define stream C (k string, z int);\n"
BODIES = {
    "not_for": (AB, "from e1=A -> not B for 1 sec select e1.x as x "
                    "insert into O;"),
    "every_not_for": (AB, "from every e1=A[x > 3] -> not B[y > e1.x] for "
                          "1 sec select e1.x as x insert into O;"),
    "not_for_then": (ABC, "from every e1=A[x > 2] -> not B[y < 3] for 500 "
                          "milliseconds -> e3=C[z > e1.x] select e1.x as x, "
                          "e3.z as z insert into O;"),
}


def app_text(name: str, partitioned: bool, playback: bool) -> str:
    streams, body = BODIES[name]
    head = "@app:playback\n" if playback else ""
    if partitioned:
        keys = ", ".join(f"k of {s}" for s in "ABC" if f"stream {s} " in
                         streams)
        return (head + streams + f"partition with ({keys}) begin "
                f"@info(name='q') {body} end;")
    return head + streams + "@info(name='q') " + body


def sends(name: str, seed: int = 0, n: int = 240) -> list:
    """(stream, row, ts): random streams, 3 keys, gaps of 1-249 ms."""
    rng = np.random.default_rng(seed)
    streams = ["A", "B"] + (["C"] if "C" in BODIES[name][0] else [])
    t, out = 1000, []
    for _ in range(n):
        t += int(rng.integers(1, 250))
        sid = streams[int(rng.integers(0, len(streams)))]
        out.append((sid, (f"K{int(rng.integers(0, 3))}",
                          int(rng.integers(0, 10))), t))
    return out


def run(pkg, text: str, ss: list, clock: bool, **kw):
    """Flush every 20 events; with `clock`, `set_time` after each flush
    and 3 s past the last event (deadlines then fire on timer ticks)."""
    rt = pkg.SiddhiManager(**kw).create_app_runtime(text)
    out = []
    rt.add_callback("O", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    for i, (sid, row, ts) in enumerate(ss):
        rt.input_handler(sid).send(row, timestamp=ts)
        if i % 20 == 19:
            rt.flush()
            if clock:
                rt.set_time(ts + 1)
    rt.flush()
    if clock:
        rt.set_time(ss[-1][2] + 3000)
    return out, rt


@functools.lru_cache(maxsize=None)
def both(name: str, partitioned: bool, playback: bool, clock: bool):
    text = app_text(name, partitioned, playback)
    ss = sends(name)
    want, _ = run(siddhi_tpu, PREFER + text, ss, clock)
    got, rt = run(siddhi_tpu_torch, text, ss, clock, device="cpu")
    return got, want, rt


@pytest.mark.parametrize("mode", ["playback", "set_time"])
@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_absent_rows_equal_jax(name, partitioned, mode):
    got, want, rt = both(name, partitioned, mode == "playback",
                         mode == "set_time")
    assert got == want
    plan = rt.plans()[0]
    assert plan.family == "seq"
    assert plan.families["scan"] == ("absent state (timer-driven deadlines "
                                     "need device state)")
    if name != "not_for":
        assert len(got) > 3, "tape too quiet to test anything"


def test_deadlines_fire_on_ticks_only_off_playback():
    """On the wall clock nothing fires before `set_time` reaches the
    deadline; the tick then completes the match with the deadline as its
    timestamp, and the wakeup drops to None once the last one fired."""
    text = app_text("not_for_then", False, False).replace(
        "-> e3=C[z > e1.x] ", "").replace(", e3.z as z", "")
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        text)
    out = []
    rt.add_callback("O", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    h = rt.input_handler("A")
    h.send(("K0", 5), timestamp=1000)
    h.send(("K0", 7), timestamp=1100)
    rt.flush()
    plan = rt.plans()[0]
    assert out == [] and plan.next_wakeup() == 1500
    rt.set_time(1550)
    assert out == [(1500, (5,))] and plan.next_wakeup() == 1600
    rt.set_time(5000)
    assert out == [(1500, (5,)), (1600, (7,))]
    assert plan.next_wakeup() is None


def _jax_blocks(text: str, ss: list, clock: bool) -> list:
    """Every block the JAX plan ran: (kernel, T, M, state in, ev, out)."""
    blocks = []
    orig = JPlan._call_block

    def spy(self, kern, T, M, st, ev):
        st2, out = orig(self, kern, T, M, st, ev)
        blocks.append((kern, T, M, {k: np.asarray(v) for k, v in
                                    st.items()}, dict(ev),
                       {k: np.asarray(v) for k, v in out.items()}))
        return st2, out
    JPlan._call_block = spy
    try:
        run(siddhi_tpu, PREFER + text, ss, clock)
    finally:
        JPlan._call_block = orig
    return blocks


@pytest.mark.parametrize("which", ["live_deadlines", "tick"])
def test_plain_block_matches_jax_block(which):
    """K2's plain version on a block the JAX plan ran -- one whose input
    state holds armed deadlines, and a timer tick -- gives the JAX block's
    new state (deadlines included), match count, earliest deadline and
    match rows."""
    name = "every_not_for"
    text = app_text(name, True, False)
    blocks = _jax_blocks(text, sends(name), clock=True)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        text)
    kern0 = rt.plans()[0].kernel

    def live_dl(st):
        occ = st["occ"]
        return bool(((st["dl"] != NO_DEADLINE) & (occ > 0)
                     & (occ <= kern0.S)).any())
    pick = [b for b in blocks if ("__tick__" in b[4]) == (which == "tick")
            and live_dl(b[3])]
    assert pick, f"no {which} block with live deadlines was recorded"
    jk, T, M, st, ev, jout = pick[-1]
    a, p = st["occ"].shape
    kern = kern0.with_shape(p, a)
    state = nfa_state_from_jax(st, "cpu")
    tev = {k: torch.from_numpy(np.array(v)) for k, v in ev.items()
           if k not in ("__base_ts__", "__base_seq__")}
    tev["__base_ts__"] = int(ev["__base_ts__"])
    pre = [None if w is None else unpack_mask(w, T * p).view(T, p)
           for w in kern.pre_masks(tev)]
    new, out = nfa_block_plain(kern, state, tev, pre, M)
    jnew = jk.block_fn(T, M)({k: v for k, v in st.items()}, ev)[0]
    for key in ("occ", "first_ts", "head_seq", "caps_i", "caps_f", "dl",
                "armed0", "of_slots"):
        np.testing.assert_array_equal(new[key].numpy(), np.asarray(
            jnew[key]), err_msg=key)
    ipack = jout["i"]
    n, dlm = int(ipack[0, 0]), int(ipack[0, 3])
    assert int(out["meta"][0]) == n and int(out["meta"][2]) == dlm
    names = jk.out_names
    jrows = sorted(zip(*[ipack[1 + names.index(c)][:n]
                         for c in ("__timestamp__", "__seq__",
                                   "__head_seq__", "x")]))
    li = kern.lane_names_i
    rows = sorted(zip(*[out["out_i"][li.index(c)][:n].tolist() for c in
                        ("__comp_ts__", "__comp_seq__", "__head_seq__",
                         "e1.x")]))
    assert rows == [tuple(int(v) for v in r) for r in jrows]
    if which == "tick":
        assert n > 0, "the tick fired nothing"


def test_deadline_rows_survive_a_rebase():
    """Rebasing the ts offsets moves armed deadlines with them and leaves
    disarmed ones (NO_DEADLINE) alone."""
    text = app_text("not_for", False, False)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        text)
    rt.input_handler("A").send(("K0", 1), timestamp=1000)
    rt.flush()
    plan = rt.plans()[0]
    dl = plan.state["dl"].clone()
    armed = dl != NO_DEADLINE
    assert int(armed.sum()) == 1
    plan._rebase(plan._ts_base + 300, plan._seq_base)
    new = plan.state["dl"]
    assert torch.equal(new[armed], dl[armed] - 300)
    assert bool((new[~armed] == NO_DEADLINE).all())
    assert plan.next_wakeup() == 2000


@pytest.mark.parametrize("body,what", [
    ("from every e1=A -> every not B for 1 sec select e1.x as x "
     "insert into O;", "sticky"),
    ("from not B for 1 sec -> e2=A select e2.x as x insert into O;",
     "absent heads"),
    ("from e1=A -> not B for 1 sec and e3=A select e1.x as x "
     "insert into O;", "inside logical"),
])
def test_absent_shapes_of_later_slices_raise(body, what):
    """The absent shapes this file once showed refused -- an `every`
    around an absent final state (the deadline forks a completing clone),
    an absent head (the init slot), an absent side of `and` -- under
    playback, against the JAX device block, rows in order."""
    text = "@app:playback\n" + AB + "@info(name='q') " + body
    rng = np.random.default_rng(3)
    ts = 1000 + np.cumsum(rng.integers(100, 700, size=120))
    # no B in the first 25 events: the absent head, anchored at the
    # first flush's clock, can wait out its second
    ss = [("B" if i >= 25 and rng.random() < 0.15 else "A",
           (f"K{int(rng.integers(0, 3))}", int(rng.integers(0, 10))), int(t))
          for i, t in enumerate(ts)]
    want, _ = run(siddhi_tpu, PREFER + text, ss, False)
    got, rt = run(siddhi_tpu_torch, text, ss, False, device="cpu")
    assert got == want and got, what
    assert rt.plans()[0].kernel.ext


MAYBE_ABSENT = ("from every e1=A[x > 2] -> not e2=B for 150 ms select e1.x "
                "as x, e2.y + 1 as y insert into O;")


def test_selector_over_an_absent_ref_is_a_later_slice():
    """A selector deriving a value from a maybe-absent ref stays refused
    by the device block, as in the JAX device block (its host matcher runs
    it): under `@app:devicePatterns('always')` the refusal raises."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(DeviceNFAUnsupported, match="maybe-absent") as e:
        mgr.create_app_runtime("@app:devicePatterns('always')\n" + AB +
                               "@info(name='q') from e1=A -> not "
                               "e2=B for 1 sec select e1.x as x, e2.y + 1 "
                               "as y insert into O;")
    assert "host matcher" in str(e.value)


def test_selector_over_an_absent_ref_runs_on_the_host_matcher():
    """Under the default mode the same shape plans the host matcher with a
    RuntimeWarning and gives the rows of the JAX package's 'prefer' (its
    host matcher) under playback, the absent ref's column NULL."""
    from siddhi_tpu_torch.interp.engine import InterpPatternQueryPlan
    text = "@app:playback\n" + AB + "@info(name='q') " + MAYBE_ABSENT
    ss = sends("not_for", seed=5)
    with pytest.warns(RuntimeWarning, match="maybe-absent"):
        got, rt = run(siddhi_tpu_torch, text, ss, False, device="cpu")
    assert [type(p) for p in rt.plans()] == [InterpPatternQueryPlan]
    assert all(row[1] is None for _t, row in got)
    want, _ = run(siddhi_tpu, PREFER + text, ss, False)
    assert got == want and got
