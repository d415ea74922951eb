"""Fused multi-query lanes of the port against siddhi_tpu on the CPU.

Structurally identical pattern queries fuse into one plan whose lanes are
the query instances (BASELINE config 5).  Inputs come from numpy seeds
and go to both packages; every comparison has tolerance 0 on rows, stream
by stream and in order.  Covered: the cases of tests/test_multi_query.py
(fused equals the JAX package's fused plan and its host matcher, mixed
shapes group separately, small groups stay individual), a one-shot
fused `scan` group (per-lane arms), `@app:fusedLanes` packing, query
callbacks per lane, the scaled config 5 app `c5_app(32)` (four fused
groups of 8 lanes, families `scan`, `seq`, `seq`, `scan` as in the JAX
package) with trailing deadlines fired by `set_time`, and a JAX fused
plan's state continued by the port through `weights`."""
import copy
import functools

import numpy as np
import pytest

import siddhi_tpu
from siddhi_tpu.core.multi_query import \
    MultiQueryDevicePatternPlan as JMulti

import siddhi_tpu_torch
from siddhi_tpu_torch.core.multi_query import (MIN_GROUP,
                                               MultiQueryDevicePatternPlan)
from siddhi_tpu_torch.replay import PARAM_APP, c5_app
from siddhi_tpu_torch.weights import (nfa_state_from_jax,
                                      stateless_state_from_jax)

def _app(n_queries=12, shapes=(0,)):
    """tests/test_multi_query.py's app: every-within chains (shape 0) and
    one-shot `not ... for` deadlines (shape 1) over four output streams."""
    parts = ["define stream S (sym string, price double);"]
    for i in range(n_queries):
        lo = 100 + (i % 8)
        shape = shapes[i % len(shapes)]
        if shape == 0:
            parts.append(
                f"@info(name='q{i}') from every e1=S[price > {lo}.0] -> "
                f"e2=S[price > e1.price] within 1 sec "
                f"select e1.price as a{i}, e2.price as b{i} "
                f"insert into Out{i % 4};")
        elif shape == 1:
            parts.append(
                f"@info(name='q{i}') from e1=S[price > {lo + 1}.0] -> "
                f"not S[price < {lo - 20}.0] for 500 milliseconds "
                f"select e1.price as a{i} insert into Out{i % 4};")
        else:
            parts.append(
                f"@info(name='q{i}') from e1=S[price > {lo + 2}.0] -> "
                f"e2=S[price > e1.price] within 1 sec "
                f"select e1.price as a{i}, e2.price as b{i} "
                f"insert into Out{i % 4};")
    return "\n".join(parts)


def _tape(n=250, seed=4):
    rng = np.random.default_rng(seed)
    return [(float(np.round(rng.uniform(95, 112) * 4) / 4), 1000 + k * 20)
            for k in range(n)]


def _run(pkg, app, sends, n_out=4, **kw):
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    got = {f"Out{j}": [] for j in range(n_out)}
    for j in range(n_out):
        rt.add_callback(f"Out{j}", lambda evs, g=got[f"Out{j}"]:
                        g.extend((e.timestamp, e.data) for e in evs))
    h = rt.input_handler("S")
    for p, ts in sends:
        h.send(("A", p), timestamp=ts)
    rt.flush()
    return got, rt


def _fused(rt, cls):
    return [p for p in getattr(rt, "_plans", []) if isinstance(p, cls)]


@pytest.mark.parametrize("case", ["every", "one_shot_scan"])
def test_fused_equals_jax_fused_and_host(case):
    app = _app(12, shapes=(0,) if case == "every" else (2,))
    sends = _tape()
    got, rt = _run(siddhi_tpu_torch, app, sends, device="cpu")
    fused = _fused(rt, MultiQueryDevicePatternPlan)
    assert len(fused) == 1 and fused[0].n_queries == 12
    assert fused[0].family == "scan"
    jax_fused, jrt = _run(siddhi_tpu, app, sends)
    assert [p.inner.family for p in _fused(jrt, JMulti)] == ["scan"]
    host, _ = _run(siddhi_tpu, "@app:devicePatterns('never')\n" + app, sends)
    assert got == jax_fused
    for k in got:
        assert sorted(got[k]) == sorted(host[k])
    assert sum(len(v) for v in got.values()) > 0
    if case == "one_shot_scan":
        assert fused[0].inner._arm_done.all()


def test_mixed_shapes_group_separately():
    app = "@app:playback\n" + _app(16, shapes=(0, 1))
    sends = _tape(300)
    got, rt = _run(siddhi_tpu_torch, app, sends, device="cpu")
    fused = _fused(rt, MultiQueryDevicePatternPlan)
    assert sorted(p.n_queries for p in fused) == [8, 8]
    assert sorted(p.family for p in fused) == ["scan", "seq"]
    jax_fused, _ = _run(siddhi_tpu, app, sends)
    host, _ = _run(siddhi_tpu, "@app:devicePatterns('never')\n" + app, sends)
    assert got == jax_fused
    for k in got:
        assert sorted(got[k]) == sorted(host[k])


def test_small_groups_stay_individual():
    app = _app(MIN_GROUP - 1)
    got, rt = _run(siddhi_tpu_torch, app, _tape(40), device="cpu")
    assert not _fused(rt, MultiQueryDevicePatternPlan)
    assert len(rt.plans()) == MIN_GROUP - 1


def test_fused_lane_packing():
    """@app:fusedLanes(8) splits 20 queries into packs of 8 and 12 (the
    tail of 4 joins the previous pack), as the JAX package does."""
    app = "@app:fusedLanes(8)\n" + _app(20)
    sends = _tape()
    got, rt = _run(siddhi_tpu_torch, app, sends, device="cpu")
    assert [p.n_queries for p in _fused(rt, MultiQueryDevicePatternPlan)] \
        == [8, 12]
    want, jrt = _run(siddhi_tpu, app, sends)
    assert [p.n_queries for p in _fused(jrt, JMulti)] == [8, 12]
    assert got == want


def test_query_callbacks_see_their_own_lane():
    app = _app(12)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    per_q = {}
    for i in range(12):
        rt.add_query_callback(f"q{i}", lambda ts, ins, rem, i=i:
                              per_q.setdefault(i, []).extend(
                                  e.data for e in ins))
    stream = []
    rt.add_callback("Out1", lambda evs: stream.extend(e.data for e in evs))
    h = rt.input_handler("S")
    for p, ts in _tape():
        h.send(("A", p), timestamp=ts)
    rt.flush()
    assert per_q and all(i % 4 == 1 for i in per_q if i in (1, 5, 9))
    assert sorted(stream) == sorted(per_q.get(1, []) + per_q.get(5, []) +
                                    per_q.get(9, []))
    with pytest.raises(KeyError, match="unknown query"):
        rt.add_query_callback("q99", print)


# ---------------------------------------------------------------------------
# config 5, scaled
# ---------------------------------------------------------------------------

def c5_tape(n_events=1024, batch=512, seed=0, dt_ms=50):
    """bench.py's make_tape with 8 symbols, quarter-grid prices in
    90-130, events dt_ms apart."""
    rng = np.random.default_rng(seed)
    tape, ts0 = [], 1_700_000_000_000
    for start in range(0, n_events, batch):
        n = min(batch, n_events - start)
        tape.append({
            "symbol": np.array([f"K{i}" for i in rng.integers(0, 8, n)]),
            "price": np.round(rng.uniform(90.0, 130.0, n) * 4) / 4,
            "volume": rng.integers(1, 1000, n).astype(np.int32),
            "ts": ts0 + np.arange(start, start + n, dtype=np.int64) * dt_ms})
    return tape


def run_c5(pkg, app, tape, until=None, carry_at=None, **kw):
    """Feed the tape flush by flush, then `set_time` 1 s past the last
    event; returns ({stream: rows}, runtime, rows set_time emitted).
    `carry_at` = (flush index, fn(rt)) calls fn before that flush."""
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    got = {f"Out{j}": [] for j in range(16)}
    for j in range(16):
        rt.add_callback(f"Out{j}", lambda evs, g=got[f"Out{j}"]:
                        g.extend((e.timestamp, e.data) for e in evs))
    h = rt.input_handler("StockStream")
    for i, f in enumerate(tape):
        if carry_at is not None and i == carry_at[0]:
            carry_at[1](rt)
        h.send_batch({k: f[k] for k in ("symbol", "price", "volume")},
                     f["ts"])
        rt.flush()
    before = sum(len(v) for v in got.values())
    rt.set_time(int(tape[-1]["ts"][-1]) + 1000 if until is None else until)
    return got, rt, sum(len(v) for v in got.values()) - before


@functools.lru_cache(maxsize=None)
def c5_rows(prefix: int):
    """(port rows, port runtime, JAX rows, JAX runtime, rows set_time
    emitted in each) for c5_app(32) on the tape, or on its first `prefix`
    events as one flush when prefix > 0."""
    tape = c5_tape()
    if prefix:
        tape = [{k: v[:prefix] for k, v in tape[0].items()}]
    app = c5_app(32)
    got, rt, late = run_c5(siddhi_tpu_torch, app, tape, device="cpu")
    want, jrt, jlate = run_c5(siddhi_tpu, app, tape)
    return got, rt, want, jrt, late, jlate


def test_c5_scaled_plans_the_jax_groups():
    _got, rt, _want, jrt, _l, _jl = c5_rows(0)
    fused = rt.plans()
    assert [type(p) for p in fused] == [MultiQueryDevicePatternPlan] * 4
    assert [p.n_queries for p in fused] == [8] * 4
    jfused = _fused(jrt, JMulti)
    assert [p.family for p in fused] == [p.inner.family for p in jfused] \
        == ["scan", "seq", "seq", "scan"]
    assert [p.name for p in fused] == [p.name for p in jfused]
    assert fused[1].inner.families["scan"] == \
        "position without a `within` bound"
    assert fused[2].inner.families["scan"] == \
        "absent state (timer-driven deadlines need device state)"
    assert fused[0].inner.families["chunk"] == "fused multi-query lane kernel"


def test_c5_scaled_rows_equal_jax():
    got, _rt, want, _jrt, _l, _jl = c5_rows(0)
    assert got == want
    assert sum(len(v) for v in got.values()) > 100


def test_c5_trailing_deadlines_fire_on_set_time():
    """The tape's first 24 events as one flush: shape-2 lanes armed at
    0.95 s are left waiting out their 500 ms, and `set_time` fires them
    through tick blocks, with the deadline as each row's timestamp."""
    got, rt, want, _jrt, late, jlate = c5_rows(24)
    assert got == want
    assert late == jlate > 0
    plan = rt.plans()[2]
    assert plan.next_wakeup() is None


def _query_rows(rt, names) -> dict:
    rows = {n: [] for n in names}
    for n in names:
        rt.add_query_callback(n, lambda ts, ins, rem, g=rows[n]:
                              g.extend((e.timestamp, e.data) for e in ins))
    return rows


@pytest.mark.parametrize("group", [2, 3])
def test_c5_state_carried_from_jax(group):
    """A JAX fused plan's state taken mid-tape -- the `seq` group of
    `not ... for` lanes with deadlines still armed (group 2), a `scan`
    group with its replay tail (group 3) -- loads into the port through
    `weights` and continues to the JAX run's remaining rows, query by
    query."""
    app = c5_app(32)
    tape = c5_tape(1536, 512)
    tape[0] = {k: v[:24] for k, v in tape[0].items()}   # cut at 1.15 s
    names = [f"q{i}" for i in range(group, 32, 4)]
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(app)
    want = _query_rows(jrt, names)
    h = jrt.input_handler("StockStream")
    carried = {}
    for i, f in enumerate(tape):
        if i == 1:
            d = _fused(jrt, JMulti)[group].state_dict()
            carried = {"state": copy.deepcopy(d),
                       "strings": copy.deepcopy(jrt.strings.state()),
                       "seq": jrt._seq, "clock": jrt._clock_ms,
                       "n": {q: len(v) for q, v in want.items()}}
        h.send_batch({k: f[k] for k in ("symbol", "price", "volume")},
                     f["ts"])
        jrt.flush()
    jrt.set_time(int(tape[-1]["ts"][-1]) + 1000)

    d = carried["state"]
    if group == 2:
        st = d["state"]
        live = (st["occ"] > 0) & (st["occ"] <= 2) & (st["dl"] < 2 ** 31 - 1)
        assert live.any(), "no deadline armed at the cut"
        d = dict(d, state=nfa_state_from_jax(st, "cpu"))
    else:
        d = stateless_state_from_jax(d)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    got = _query_rows(rt, names)
    rt.strings.restore(carried["strings"])
    rt._seq, rt._clock_ms = carried["seq"], carried["clock"]
    plan = rt.plans()[group]
    plan.load_state_dict(d)
    if group == 2:
        assert plan.next_wakeup() is not None
    h = rt.input_handler("StockStream")
    for f in tape[1:]:
        h.send_batch({k: f[k] for k in ("symbol", "price", "volume")},
                     f["ts"])
        rt.flush()
    rt.set_time(int(tape[-1]["ts"][-1]) + 1000)
    rest = {q: v[carried["n"][q]:] for q, v in want.items()}
    assert got == rest
    assert sum(len(v) for v in got.values()) > 0


def test_constants_in_hops_and_selectors_match_the_host_matcher():
    """Lifted constants in a threshold hop's right-hand side (K4), in a
    sequence step (K2) and in the selector (K1 by `__qid__`).  The JAX
    package's fused plan fails to build on a capture-dependent conjunct
    with a lifted constant (a ValueError at nfa_device.py:517; ROADMAP
    section C), so the reference is its host matcher."""
    rng = np.random.default_rng(3)
    sends = [(float(np.round(rng.uniform(88, 115) * 4) / 4), 1000 + 37 * k)
             for k in range(400)]

    def run(pkg, app, **kw):
        rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
        got = {f"Out{j}": [] for j in range(4)}
        for s, g in got.items():
            rt.add_callback(s, lambda evs, g=g: g.extend(
                (e.timestamp, e.data) for e in evs))
        h = rt.input_handler("S")
        for i, (p, ts) in enumerate(sends):
            h.send(("A", p, i % 50), timestamp=ts)
            if i % 100 == 99:
                rt.flush()
        rt.flush()
        return got, rt
    got, rt = run(siddhi_tpu_torch, PARAM_APP, device="cpu")
    assert [(p.family, p.n_queries) for p in rt.plans()] == \
        [("scan", 10), ("seq", 10)]
    host, _ = run(siddhi_tpu, "@app:devicePatterns('never')\n" + PARAM_APP)
    for k in got:
        assert sorted(got[k]) == sorted(host[k])
    assert all(got[k] for k in got)
