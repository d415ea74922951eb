"""The `chunk` plan family of the port against siddhi_tpu on the CPU.

`chunk` runs K2 over K own-chunks of each flush's flat event buffer
(lane l reads T events from l*CS, arms heads only on its own CS; halo
reads extend pending matches), from fresh slot state, with the last
`within` window of events replayed at the next flush and completions at
or before the previous flush's last seq dropped.  The JAX package picks
it for an unpartitioned, unfused `every` chain bounded by `within` that
`scan` refuses, and runs it when `@app:patternFamily('chunk')` asks.
Covered, each against the JAX package with tolerance 0 (rows in order,
None in place): the shapes of tests/test_nfa_chunked.py under forced
`chunk` over many small flushes; the `scan`-ineligible shapes of
tests/test_plan_families.py at default selection, with their `families`
reasons; the lane geometry (K, CS, T) flush by flush, dense and
halo-dominated; the eligibility reasons; the match-buffer, slot and
E-lane retries; out-of-order timestamps; snapshot and restore, and a
JAX `chunk` plan's state carried into the port; K2's plain version in
chunk mode against the JAX block on the flat blocks the JAX plan ran."""
import warnings

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.multi_query import \
    MultiQueryDevicePatternPlan as JMulti
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.pattern_plan import chunk_geometry
from siddhi_tpu_torch.weights import stateless_state_from_jax

HEAD = "define stream S (sym string, price double, volume int);\n" \
       "@info(name='q') "
JDEV = "@app:devicePatterns('always')\n"
CHUNK = "@app:patternFamily('chunk')\n"

# tests/test_nfa_chunked.py:18-44
SHAPES = {
    "two_state": (
        "from every e1=S[price > 100] -> e2=S[price > e1.price] within 1 sec "
        "select e1.price as p1, e2.price as p2 insert into Out;"),
    "three_state": (
        "from every e1=S[price > 100] -> e2=S[price > e1.price] "
        "-> e3=S[price > e2.price] within 2 sec "
        "select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;"),
    "count": (
        "from every e1=S[price > 110]<1:3> -> e2=S[price < 95] within 1 sec "
        "select e1[0].price as a, e1[last].price as b, e2.price as c "
        "insert into Out;"),
    "logical_and": (
        "from every e1=S[price > 120] -> e2=S[price < 100] and "
        "e3=S[price > 125] within 1 sec "
        "select e1.price as a, e2.price as b, e3.price as c insert into Out;"),
    "logical_or": (
        "from every e1=S[price > 120] -> e2=S[price < 92] or "
        "e3=S[price > 127] within 1 sec "
        "select e1.price as a, e2.price as b, e3.price as c insert into Out;"),
    "sequence": (
        "from every e1=S[price > 115], e2=S[price > e1.price] within 1 sec "
        "select e1.price as a, e2.price as b insert into Out;"),
    "head_count": (
        "from every e1=S[price > 118]<2:4> within 1 sec "
        "select e1[0].price as a, e1[1].price as b insert into Out;"),
}
# tests/test_plan_families.py:144-169, the shapes with `within`
INELIGIBLE = {
    "every_mid": (
        "from every e1=S[price > 127] -> every e2=S[price < 91] "
        "within 200 milliseconds select e1.price as a, e2.price as b "
        "insert into Out;"),
    "optional_count": (
        "from every e1=S[price > 110] -> e2=S[price < 100]<0:3> -> "
        "e3=S[price > 124] within 1 sec select e1.price as a, "
        "e2[last].price as b, e3.price as c insert into Out;"),
    "adjacent_counts": (
        "from every e1=S[price > 118]<1:2> -> e2=S[price < 97]<1:2> -> "
        "e3=S[price > 124] within 1 sec select e1[last].price as a, "
        "e2[last].price as b, e3.price as c insert into Out;"),
    "conjunction_step": (
        "from every e1=S[price > 110] -> "
        "e2=S[price > e1.price and volume > e1.volume] within 1 sec "
        "select e1.price as a, e2.price as b insert into Out;"),
}
TS0 = 1_700_000_000_000


def sends_of(n=900, batches=6, seed=11, dt=9, keys=4, start=0):
    """[(columns, timestamps)] per flush: the tapes of
    tests/test_nfa_chunked.py (quarter-grid prices 90-130, dt ms apart)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        m = n // batches
        idx = start + b * m + np.arange(m)
        out.append(({"sym": np.array([f"K{k}" for k in
                                      rng.integers(0, keys, m)]),
                     "price": np.round(rng.uniform(90, 130, m) * 4) / 4,
                     "volume": rng.integers(1, 1000, m).astype(np.int32)},
                    TS0 + idx * dt))
    return out


def run(pkg, app: str, sends, rt=None, **kw):
    """Rows (timestamp, data) of `app` over `sends`, one flush each."""
    if rt is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    rows = []
    rt.add_callback("Out", lambda evs: rows.extend(
        (e.timestamp, e.data) for e in evs))
    rt.start()
    for cols, ts in sends:
        rt.input_handler("S").send_batch(cols, ts)
        rt.flush()
    return rows, rt


def jplan(rt):
    return next(p for p in rt._plans if isinstance(p, JPlan))


def both(app: str, sends, jax_head: str = ""):
    """(JAX rows, JAX plan, port rows, port plan) for one app and tape."""
    want, jrt = run(siddhi_tpu, JDEV + jax_head + app, sends)
    got, trt = run(siddhi_tpu_torch, app, sends, device="cpu")
    return want, jplan(jrt), got, trt.plans()[0]


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow)
    if n in ("head_count", "count") else n for n in SHAPES])
def test_forced_chunk_shapes_equal_jax(name):
    """The chunked corpus under forced `chunk`, 6 flushes 9 ms apart (the
    replay tail spans flushes): both engage `chunk`, equal rows."""
    want, jp, got, tp = both(CHUNK + HEAD + SHAPES[name], sends_of())
    assert jp.family == tp.family == "chunk"
    assert got == want and got


@pytest.mark.parametrize("name", sorted(INELIGIBLE))
def test_scan_ineligible_shapes_run_chunk_by_default(name):
    """Shapes `scan` refuses pick `chunk` with no annotation in both
    packages, with equal `families` reasons, and equal rows."""
    want, jp, got, tp = both(HEAD + INELIGIBLE[name],
                             sends_of(n=600, batches=3, dt=7, seed=3))
    assert jp.family == tp.family == "chunk"
    for fam in ("chunk", "scan", "dfa"):
        assert tp.families[fam] == jp.families[fam], fam
    assert isinstance(tp.families["scan"], str)
    assert got == want


def _spy_jax_chunks(plan, seen: list):
    """Record (K, CS, T) of every chunk block the JAX plan dispatches."""
    orig = plan._dispatch_chunk

    def spy(ev, K, T, M, ts_base, seq_base):
        seen.append((K, int(ev["__cs__"]), T))
        return orig(ev, K, T, M, ts_base, seq_base)
    plan._dispatch_chunk = spy


@pytest.mark.parametrize("tape", ["dense", "sparse"])
def test_chunk_geometry_equals_jax(tape):
    """K, CS and T of every flush equal the JAX plan's, on a dense tape
    (CS above the halo) and a halo-dominated one (events 400 ms apart
    within 1 sec: fewer, longer chunks)."""
    sends = sends_of() if tape == "dense" else \
        sends_of(n=300, batches=3, dt=400, seed=7)
    app = CHUNK + HEAD + SHAPES["two_state"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jrt = siddhi_tpu.SiddhiManager().create_app_runtime(JDEV + app)
    jp = jplan(jrt)
    jseen: list = []
    _spy_jax_chunks(jp, jseen)
    want, _ = run(siddhi_tpu, "", sends, rt=jrt)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    tp = trt.plans()[0]
    tseen: list = []
    orig = tp._dispatch_chunk

    def spy(ev, tsmono, W, ts_base, seq_base):
        out = orig(ev, tsmono, W, ts_base, seq_base)
        tseen.append(tp.chunk_geometry)
        return out
    tp._dispatch_chunk = spy
    got, _ = run(siddhi_tpu_torch, "", sends, rt=trt)
    assert [(K, CS, T) for K, CS, _H, T in tseen] == jseen
    for K, CS, H, T in tseen:
        assert T == max(64, 1 << (CS + H - 1).bit_length())
    assert got == want and got


def test_chunk_geometry_function():
    """chunk_geometry: pow2 K with the floor of 8, CS = ceil(N / K), H the
    longest halo past a chunk's end, T = pow2(CS + H) >= 64."""
    ts = np.arange(1000, dtype=np.int64) * 10
    assert chunk_geometry(ts, 95, 64) == (64, 16, 9, 64)
    assert chunk_geometry(ts[:3], 95, 64) == (8, 1, 2, 64)
    K, CS, H, T = chunk_geometry(ts, 5000, 64)      # halo-dominated
    assert K == 8 and CS == 125 and H == 500 and T == 1024


def _families(pkg, app: str) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rt = (pkg.SiddhiManager(device="cpu") if pkg is siddhi_tpu_torch
              else pkg.SiddhiManager()).create_app_runtime(app)
    if pkg is siddhi_tpu_torch:
        p = rt.plans()[0]
        return dict(getattr(p, "inner", p).families)
    p = next(p for p in rt._plans if isinstance(p, (JPlan, JMulti)))
    return dict(getattr(p, "inner", p).families)


FUSED = "\n".join(
    f"@info(name='q{i}') from every e1=S[price > {100 + i}] -> "
    f"e2=S[price > e1.price] within 1 sec select e1.price as a "
    f"insert into Out;" for i in range(8))
ELIGIBILITY = {
    "lanes0": "@app:deviceChunkLanes(0)\n" + HEAD + SHAPES["two_state"],
    "lanes1": "@app:deviceChunkLanes(1)\n" + HEAD + SHAPES["two_state"],
    "lanes2": "@app:deviceChunkLanes(2)\n" + HEAD + SHAPES["two_state"],
    "partitioned": "define stream S (sym string, price double, volume int);"
                   "\npartition with (sym of S) begin @info(name='q') "
                   + SHAPES["two_state"] + " end;",
    "fused": "define stream S (sym string, price double, volume int);\n"
             + FUSED,
    "non_every": HEAD + SHAPES["two_state"].replace("every ", ""),
}


@pytest.mark.parametrize("name", sorted(ELIGIBILITY))
def test_chunk_eligibility_reasons_equal_jax(name):
    """`@app:deviceChunkLanes(0)` and `(1)`, partitioned, fused and
    non-`every` chains: the `chunk` verdict (True or the reason) equals
    the JAX package's, and so do the others."""
    app = ELIGIBILITY[name]
    jf = _families(siddhi_tpu, JDEV + app)
    tf = _families(siddhi_tpu_torch, app)
    assert tf == jf
    assert (jf["chunk"] is True) == (name == "lanes2")


RETRIES = {
    # a final count fanning out past the first M bucket
    "m_burst": ("@app:deviceSlots(32)\n" + HEAD +
                "from every e1=S[price > 95] -> e2=S[price > 91]<1:6> "
                "within 100 milliseconds select e1.price as a, "
                "e2[last].price as b insert into Out;",
                dict(n=600, batches=2, dt=2, seed=5)),
    # two slots a lane: heads dropped until A grows
    "slots": ("@app:deviceSlots(2)\n" + HEAD + SHAPES["two_state"],
              dict(n=600, batches=3, dt=9, seed=5)),
    # a final count collecting in many slots at once: E lanes overflow
    "e_lanes": ("@app:deviceSlots(16)\n" + HEAD +
                "from every e1=S[price > 100] -> e2=S[price > 90]<1:4> "
                "within 40 milliseconds select e1.price as a, "
                "e2[last].price as b insert into Out;",
                dict(n=600, batches=2, dt=3, seed=9)),
}


@pytest.mark.parametrize("name", sorted(RETRIES))
def test_chunk_retries_equal_jax(name):
    """The match-buffer, slot and E-lane retries re-run the flush's block
    as the JAX plan does: equal rows, and the same M hint, A and E."""
    app, kw = RETRIES[name]
    want, jp, got, tp = both(CHUNK + app, sends_of(**kw))
    assert jp.family == tp.family == "chunk"
    assert got == want and got
    assert (tp._m_hint, tp._chunk_A, tp._chunk_E) == \
        (jp._m_hint, jp._chunk_A, jp._chunk_E)
    assert tp.dropped == jp.dropped == 0
    if name == "m_burst":
        assert tp._m_hint > 512          # past the first bucket of ~350
    if name == "slots":
        assert tp._chunk_A > 2
    if name == "e_lanes":
        assert tp._chunk_E is not None and tp._chunk_E > 2


def test_slot_cap_drops_like_jax():
    """At the slot cap the lost heads count in `dropped`, with the JAX
    package's warning, equal to its `chunk_of_dropped`."""
    app = "@app:deviceSlots(2)\n@app:deviceSlotCap(2)\n" + CHUNK + HEAD + \
        SHAPES["two_state"]
    sends = sends_of(n=600, batches=3, dt=9, seed=5)
    want, jp, got, tp = both(app, sends)
    assert got == want
    assert tp.dropped == jp.dropped > 0
    assert tp.state_dict()["of_dropped"] == \
        jp.state_dict()["chunk_of_dropped"]


def test_out_of_order_timestamps_equal_jax():
    """tests/test_plan_families.py:374-411: a regressed timestamp widens
    the halo and the tail; the instance the sequential kernel expires
    stays expired."""
    app = CHUNK + HEAD + SHAPES["two_state"]
    sends = [(0, 101.0), (2000, 50.0), (500, 150.0), (2100, 102.0),
             (2200, 103.0)]
    tape = [({"sym": np.array(["K"] * len(sends)),
              "price": np.array([p for _d, p in sends]),
              "volume": np.ones(len(sends), np.int32)},
             TS0 + np.array([d for d, _p in sends]))]
    want, jp, got, tp = both(app, tape)
    assert [r for _t, r in got] == [(102.0, 103.0)]
    assert got == want and tp.family == "chunk"
    # and across flushes: a regression in a later flush
    tape2 = sends_of(n=600, batches=3, dt=9, seed=4)
    for cols, ts in tape2[1:]:
        ts[::7] -= 1500
    want, _jp, got, _tp = both(app, tape2)
    assert got == want and got


def test_snapshot_restore_mid_tape():
    """The port's state_dict after half the flushes (replay tail, dedup
    seq) restored into a fresh runtime continues the stream exactly."""
    app = CHUNK + HEAD + SHAPES["three_state"]
    sends = sends_of(n=1200, batches=6, dt=9, seed=2)
    ref, _rt = run(siddhi_tpu_torch, app, sends, device="cpu")
    rows, rt1 = run(siddhi_tpu_torch, app, sends[:3], device="cpu")
    d = rt1.plans()[0].state_dict()
    assert d["family"] == "chunk" and d["lane_tail"] is not None
    rt2 = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rt2.strings.restore(rt1.strings.state())
    rt2._seq = rt1._seq
    rt2.plans()[0].load_state_dict(d)
    more, _ = run(siddhi_tpu_torch, "", sends[3:], rt=rt2)
    assert rows + more == ref and more


def test_state_carried_from_jax_chunk_plan():
    """The first half of the tape on the JAX package's `chunk` plan, its
    flat replay tail, dedup seq and drop count carried into the port's
    through weights.stateless_state_from_jax, the second half on the port:
    equal to the JAX rows of the whole tape."""
    app = CHUNK + HEAD + SHAPES["two_state"]
    sends = sends_of(n=1200, batches=6, dt=9, seed=8)
    want, _ = run(siddhi_tpu, JDEV + app, sends)
    first, jrt = run(siddhi_tpu, JDEV + app, sends[:3])
    d = jplan(jrt).state_dict()
    assert d["chunk_tail"] is not None
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rt.strings.restore(jrt.strings.state())
    rt._seq = jrt._seq
    plan = rt.plans()[0]
    plan.load_state_dict(stateless_state_from_jax(d))
    assert plan.dropped == d["chunk_of_dropped"]
    got, _ = run(siddhi_tpu_torch, "", sends[3:], rt=rt)
    assert first + got == want and got


@pytest.mark.parametrize("name", ["three_state", "logical_or", "every_mid"])
def test_plain_block_matches_jax_chunk_block(name):
    """K2's plain version in chunk mode against the JAX block on the flat
    blocks the JAX plan ran (`__cs__`, `__prev_seq__`, halo reads, the
    dedup): the same match table, row for row after sorting."""
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block_plain
    from siddhi_tpu_torch.replay import block_masks
    app = CHUNK + HEAD + (SHAPES.get(name) or INELIGIBLE[name])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jrt = siddhi_tpu.SiddhiManager().create_app_runtime(JDEV + app)
    jp = jplan(jrt)
    blocks: list = []
    orig = jp._dispatch_chunk

    def spy(ev, K, T, M, ts_base, seq_base):
        blocks.append((dict(ev), K, T, M, ts_base, seq_base))
        return orig(ev, K, T, M, ts_base, seq_base)
    jp._dispatch_chunk = spy
    run(siddhi_tpu, "", sends_of(n=600, batches=3, dt=9, seed=6), rt=jrt)
    tp = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        app).plans()[0]
    assert len(blocks) >= 3          # a retry re-dispatches a flush
    # both re-run each block at the slot and lane widths the plan ended at
    tp._chunk_A, tp._chunk_E = jp._chunk_A, jp._chunk_E
    for ev, K, T, M, ts_base, seq_base in blocks:
        jk = jp._chunk_kernel(K)
        _st, out = jk.block_fn(T, M)(jk.init_state(), ev)
        ipack = np.asarray(out["i"])
        fpack = np.asarray(out["f"]) if "f" in out else None
        n = int(ipack[0, 0])
        jp._ts_base, jp._seq_base = ts_base, seq_base
        want = jp._unpack_block(ipack, fpack, n)

        F = ev["__flat.__ts__"].shape[0]
        tev = {k[len("__flat."):]: torch.from_numpy(np.asarray(v))
               for k, v in ev.items() if k.startswith("__flat.")}
        if "seq" not in tev and "__seq__" not in tev:
            tev["__seq__"] = torch.from_numpy(
                (np.asarray(ev["__seq0__"]) + np.arange(F)).astype(np.int32))
        tev["__base_ts__"] = int(ev["__base_ts__"])
        tev["__chunk__"] = (T, int(ev["__cs__"]), int(ev["__nev__"]),
                            int(ev["__prev_seq__"]))
        tk = tp._chunk_kernel(K)
        assert (tk.A, tk.E) == (jk.A, jk.E)
        st0 = tk.init_state("cpu")
        pre = tk.pre_masks(tev)
        _nst, tout = nfa_block_plain(tk, st0, tev, block_masks(tk, tev, pre),
                                     M)
        assert int(tout["meta"][0]) == n
        assert int(tout["meta"][1]) == int(ipack[0, 1])
        tp._ts_base, tp._seq_base = ts_base, seq_base
        got = tp._unpack(tout, n)
        if want is None or got is None:
            assert want is None and got is None
            continue
        jo = np.lexsort((want[2], want[1]))
        to = np.lexsort((got[2], got[1]))
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(a[jo], b[to])
        for k in want[3]:
            np.testing.assert_array_equal(want[3][k][jo], got[3][k][to])
