"""`@app:devicePrecision('f64')` on the port's pattern paths against
siddhi_tpu under the same annotation, on the CPU (the kernels' plain
versions), row for row with tolerance 0.

Tapes are raw doubles 1e-6 apart (`replay.raw_tape`: closer than
float32's step near 100), so float32 and float64 give other rows: the
f32 case here shows that the tape tests precision.  Covered: C4 on `scan`
and `seq`; the algebra and family apps C4N (`scan`, counts), C4A (`scan`,
`and`), C4F (`seq`, K2's EXT instantiation with forks and slot growth),
C3X (`chunk`) and C3SD (`dfa`); a fused group of eight lanes whose lifted
DOUBLE constants are float64 lane parameters; the `types` app, where a
FLOAT capture sits widened in the float64 group beside DOUBLE ones and
its selector output stays float32; one K2 block against the JAX
NFAKernel(f64=True) block, the new state leaf for leaf; and a JAX plan's
f64 slot state continued by the port mid-tape.  The JAX package's
`>=`/`<=` threshold hop against 0 misses x == 0 in float64 as it does in
float32 (ROADMAP section C); the port keeps the exact comparison."""
import functools

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch import replay
from siddhi_tpu_torch.kernels.seg_tree import build_heap_plain, \
    first_hit_plain
from siddhi_tpu_torch.weights import nfa_state_from_jax, nfa_state_to_numpy

F64 = replay.F64
PREFER = "@app:devicePatterns('prefer')\n"
SMALL = "@app:partitionCapacity(16)\n@app:deviceSlots(32)\n"
KEYS = 16
APPS = {
    "c4": SMALL + replay.C4,
    "c4_seq": replay.C4_SEQ + SMALL + replay.C4,
    "c4n": SMALL + replay.C4N,
    "c4a": SMALL + replay.C4A,
    "c4f": "@app:partitionCapacity(16)\n" + replay.C4F,
    "c3x": "@app:deviceSlots(64)\n" + replay.C3X,
    "c3sd": replay.C3SD,
}
FAMILY = {"c4": "scan", "c4_seq": "seq", "c4n": "scan", "c4a": "scan",
          "c4f": "seq", "c3x": "chunk", "c3sd": "dfa"}
# C4's tape: prices 100-103 (C4's chain climbs from 100); the algebra and
# family apps select from C4's full range, 90-130
WIDE = {"c4n", "c4a", "c4f", "c3x", "c3sd"}


def stock_sends(flushes: int = 3, n: int = 600, seed: int = 0,
                lo: float = 100.0, levels: int = 3) -> list:
    """replay.raw_tape as (stream, columns, timestamps) sends, 16 keys as
    strings, events 7 ms apart."""
    tape = replay.raw_tape(flushes * n, n, KEYS, seed=seed, dt_ms=7, lo=lo,
                           levels=levels)
    names = np.array([f"K{i}" for i in range(KEYS)])
    return [("StockStream", {"symbol": names[f["sym_idx"]],
                             "price": f["price"], "volume": f["volume"]},
             f["ts"]) for f in tape]


def run(pkg, app, sends, outs=("Out",), **kw):
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    got = []
    for o in outs:
        rt.add_callback(o, lambda evs, o=o: got.extend(
            (o, e.timestamp, e.data) for e in evs))
    rt.start()
    for sid, cols, ts in sends:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    return got, rt


def jplans(rt):
    return [p for p in rt._plans if isinstance(p, JPlan)]


@functools.lru_cache(maxsize=None)
def rows(name: str, prec: str = F64):
    """(JAX rows, port rows, port runtime) of APPS[name] on the raw tape
    under `prec`."""
    app = prec + APPS[name]
    sends = stock_sends(lo=90.0, levels=40) if name in WIDE else \
        stock_sends()
    want, jrt = run(siddhi_tpu, PREFER + app, sends)
    got, rt = run(siddhi_tpu_torch, app, sends, device="cpu")
    return want, got, rt, jrt


@pytest.mark.parametrize("name", sorted(APPS))
def test_rows_equal_jax_under_f64(name):
    """Each app's rows equal the JAX device's under the same annotation,
    in order; the plan runs the JAX package's family in f64."""
    want, got, rt, jrt = rows(name)
    assert got == want and got, name
    plan = rt.plans()[0]
    assert plan.f64 and plan.kernel.f64
    assert plan.family == FAMILY[name] == jplans(jrt)[0].family
    assert all(isinstance(r[2][0], float) for r in got if r[2][0] is not None)


def test_float32_gives_other_rows():
    """The same tape under float32 (no annotation) gives other rows on
    both packages -- the f64 rows above are a test of precision."""
    want32, got32, _rt, _jrt = rows("c4", "")
    want64, got64, _rt, _jrt = rows("c4")
    assert got32 == want32
    assert sorted(got32) != sorted(got64)
    assert len(got32) != len(got64)


def test_fused_group_lane_parameters_are_f64():
    """Eight same-shape queries fuse into one plan whose lifted DOUBLE
    constants (1e-5 apart: float32 rounds them onto each other's
    neighbourhood) are float64 lane parameters; every lane's rows equal
    the JAX fused plan's under f64."""
    parts = [replay.STOCK.strip()]
    for i in range(8):
        parts.append(
            f"@info(name='q{i}') from every e1=StockStream[price > "
            f"{100 + 1e-5 * (i + 1):.5f}] -> e2=StockStream[price > "
            f"e1.price] within 40 ms select e1.price as a{i}, "
            f"e2.price as b{i} insert into Out{i % 2};")
    app = F64 + "\n".join(parts)
    sends = stock_sends(flushes=2, n=500, seed=5)
    outs = ("Out0", "Out1")
    want, jrt = run(siddhi_tpu, PREFER + app, sends, outs)
    got, rt = run(siddhi_tpu_torch, app, sends, outs, device="cpu")
    (plan,) = rt.plans()
    assert plan.n_queries == 8
    assert all(v.dtype == torch.float64 for v in plan.inner.params.values)
    assert got == want and got


TYPES_HEAD = ("define stream T (k string, i int, l long, f float, "
              "b bool, d double, s string);\npartition with (k of T) "
              "begin @info(name='q') ")
# `seq`: a FLOAT capture in a conjunction with DOUBLE ones (K2)
TYPES = TYPES_HEAD + (
    "from every e1=T[i > 2 and b] -> e2=T[l > e1.i and "
    "(s == e1.s or f > e1.f) and d > e1.d] within 50 ms "
    "select e1.i as i1, e2.l as l2, e1.f as f1, e2.b as b2, "
    "e1.s as s1, e1.d as d1, e2.d as d2, e2.f - e1.f as df, "
    "e2.i - e1.i as di insert into Out; end;")
# `scan`: a float64 threshold tree over a DOUBLE column, one over a FLOAT
# column against a DOUBLE right-hand side (float32 leaves widened), and a
# FLOAT column widened into K5's float64 rows
TYPES_SCAN = TYPES_HEAD + (
    "from every e1=T[i > 2 and b] -> e2=T[d > e1.d] -> "
    "e3=T[f > e2.d - 99.0] within 50 ms select e1.i as i1, e1.f as f1, "
    "e1.d as d1, e2.d as d2, e3.f as f3, e3.f - e1.f as df "
    "insert into Out; end;")


def types_sends(flushes: int = 3, n: int = 600, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    sends, t = [], 1_700_000_000_000
    for _f in range(flushes):
        cols = {"k": np.array([f"K{i}" for i in rng.integers(0, 16, n)]),
                "i": rng.integers(0, 9, n).astype(np.int32),
                "l": rng.integers(-50, 50, n).astype(np.int64),
                "f": (1.0 + rng.integers(0, 1024, n) * 2.0 ** -20
                      ).astype(np.float32),
                "b": rng.integers(0, 2, n).astype(bool),
                "d": 100.0 + rng.integers(0, 1000, n) * 1e-6,
                "s": np.array([f"S{i}" for i in rng.integers(0, 3, n)])}
        sends.append(("T", cols, t + 7 * np.arange(n)))
        t += 7 * n
    return sends


@pytest.mark.parametrize("family", ["scan", "seq"])
def test_float_capture_beside_double(family):
    """FLOAT stays float32 under f64: a FLOAT capture row is widened into
    the float64 group (as the JAX package's caps_f), conjuncts and the
    selector read it back as float32 (`f1`, `df` stay FLOAT), DOUBLE
    captures stay float64 (`d1`)."""
    app = F64 + (TYPES if family == "seq" else TYPES_SCAN)
    sends = types_sends()
    want, _jrt = run(siddhi_tpu, PREFER + app, sends)
    got, rt = run(siddhi_tpu_torch, app, sends, device="cpu")
    assert got == want and got
    plan = rt.plans()[0]
    assert {"e1.f", "e1.d"} <= set(plan.kernel.rows_f)
    assert plan.family == family
    col = {nm: np.array([r[2][i] for r in got])
           for i, nm in enumerate(plan._names)}
    # values that only float64 keeps apart reached the selector
    assert not np.array_equal(col["d1"], col["d1"].astype(np.float32))
    for nm in ("f1", "df"):
        assert np.array_equal(col[nm], col[nm].astype(np.float32)), nm


BLOCK_APP = """define stream S (sym string, p double, f float);
partition with (sym of S)
begin
  @info(name='q')
  from every e1=S[p > 100.0] -> e2=S[p > e1.p and f >= e1.f] -> e3=S[p > e2.p]
  select e1.p as p1, e2.p as p2, e3.p as p3, e2.f as f2 insert into M;
end;
"""
P, T = 16, 32


def _block(seed: int, t0: int) -> dict:
    rng = np.random.default_rng(seed)
    valid = np.ones((T, P), bool)
    valid[T - 5:, ::3] = False
    return {"__ts__": (t0 + np.cumsum(np.ones((T, P), np.int32), axis=0)
                       ).astype(np.int32),
            "__seq__": (t0 * P + np.arange(T * P, dtype=np.int32)
                        ).reshape(T, P),
            "__valid__": valid,
            "0.p": 100.0 + rng.integers(0, 1000, (T, P)) * 1e-6 +
            rng.integers(0, 2, (T, P)),
            "0.f": (rng.integers(0, 8, (T, P)) * 2.0 ** -20 + 1.0
                    ).astype(np.float32),
            "__base_ts__": np.int64(1_700_000_000_000),
            "__base_seq__": np.int64(0)}


def test_block_matches_jax_f64_kernel():
    """K2's plain version against the JAX NFAKernel(f64=True) block on the
    same (T, P) grids, twice in a row: new state leaf for leaf (caps_f in
    float64, the FLOAT capture widened), match tables equal; the JAX
    state converts to the port's through weights.nfa_state_from_jax."""
    head = (F64 + f"@app:partitionCapacity({P})\n@app:deviceSlots(8)\n"
            "@app:patternFamily('seq')\n")
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(PREFER + head +
                                                        BLOCK_APP)
    (jplan,) = jplans(jrt)
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        head + BLOCK_APP)
    tplan = trt.plans()[0]
    assert jplan.kernel.f64 and tplan.kernel.f64
    assert jplan.kernel.rows_f == tplan.kernel.rows_f
    assert tplan.state["caps_f"].dtype == torch.float64
    for plan in (jplan, tplan):
        plan._ts_base, plan._seq_base = 1_700_000_000_000, 0
    jstate, tstate, M = jplan.state, tplan.state, 4096
    for b in range(2):
        ev = _block(seed=b, t0=b * T)
        jst, out = jplan.kernel.block_fn(T, M)(jstate, ev)
        ipack = np.asarray(out["i"])
        n = int(ipack[0, 0])
        assert 0 < n <= M
        jtab = jplan._unpack_block(ipack, np.asarray(out["f"]), n)
        tev = {k: torch.from_numpy(np.asarray(v)) for k, v in ev.items()
               if np.ndim(v)}
        tev["__base_ts__"] = int(ev["__base_ts__"])
        tst, tout = tplan.kernel.run_block(tstate, tev, M)
        assert tout["out_f"].dtype == torch.float64
        assert int(tout["meta"][0]) == n
        ttab = tplan._unpack(tout, n)
        for jt, tt in ((jtab, ttab),):
            o_j, o_t = np.lexsort((jt[2], jt[1])), np.lexsort((tt[2], tt[1]))
            for a, b_ in zip(jt[:3], tt[:3]):
                np.testing.assert_array_equal(a[o_j], b_[o_t])
            for k in jt[3]:
                np.testing.assert_array_equal(jt[3][k][o_j], tt[3][k][o_t])
                assert jt[3][k].dtype == tt[3][k].dtype, k
        jnp_state = {k: np.asarray(v) for k, v in jst.items()}
        tnp = nfa_state_to_numpy(tst)
        for k, v in tnp.items():
            np.testing.assert_array_equal(v, jnp_state[k], err_msg=k)
            assert v.dtype == jnp_state[k].dtype, k
        conv = nfa_state_to_numpy(nfa_state_from_jax(jnp_state, "cpu"))
        for k, v in conv.items():
            np.testing.assert_array_equal(v, tnp[k], err_msg=k)
        jstate, tstate = jst, tst


def test_state_carried_from_jax_mid_tape():
    """A JAX `seq` plan's f64 slot state after the first half of the tape,
    loaded into the port through weights.nfa_state_from_jax, continues to
    the JAX package's rows for the second half."""
    app = F64 + APPS["c4_seq"]
    sends = stock_sends(flushes=4, n=400, seed=2)
    half = len(sends) // 2
    want, _ = run(siddhi_tpu, PREFER + app, sends)
    first, jrt = run(siddhi_tpu, PREFER + app, sends[:half])
    (jplan,) = jplans(jrt)
    d = jplan.state_dict()
    assert np.asarray(d["state"]["caps_f"]).dtype == np.float64
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    rt.strings.restore(jrt.strings.state())
    rt._seq = jrt._seq
    plan = rt.plans()[0]
    state = nfa_state_from_jax({k: np.asarray(v) for k, v in
                                d["state"].items()}, "cpu")
    plan.load_state_dict({**d, "state": state})
    got = []
    rt.add_callback("Out", lambda evs: got.extend(
        ("Out", e.timestamp, e.data) for e in evs))
    for sid, cols, ts in sends[half:]:
        rt.input_handler(sid).send_batch(cols, ts)
        rt.flush()
    assert first + got == want and got


def test_first_hit_f64_against_zero_is_exact():
    """A float64 `>=` threshold hop against 0: the port's descent finds the
    leaf equal to 0, as a brute-force scan does; the JAX package's
    compares against nextafter(0) -- a denormal its CPU back end flushes --
    and misses it, in float64 as in float32 (ROADMAP section C)."""
    import jax.numpy as jnp
    import siddhi_tpu.core.nfa_parallel as jpar
    v = np.array([0.0, 1.0, 0.0, -1.0])
    heap = build_heap_plain(torch.from_numpy(v)[None],
                            torch.ones((1, 4), dtype=torch.bool), 4, "max",
                            torch.float64)
    jheap = jpar._build_heap(jnp.asarray(v), jnp.ones(4, bool), 4, "max",
                             jnp.float64)
    np.testing.assert_array_equal(heap[0].numpy(), np.asarray(jheap))
    got = first_hit_plain(heap, 4, torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros((1, 1), dtype=torch.float64), "ge")
    assert int(got) == 0
    jgot = jpar._first_hit(jheap, 4, jnp.zeros(1, jnp.int32),
                           jnp.zeros(1, jnp.float64), "ge")
    assert int(np.asarray(jgot)[0]) == 1
