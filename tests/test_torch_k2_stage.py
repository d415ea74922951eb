"""K2's event stage at its edges, on a CUDA card (marker `gpu`).

K2 (csrc/nfa_block.cuh) reads every event field, pre-mask bit and event
column of its T-step loop from a ring of 64-step tiles in shared memory,
filled ahead with cp.async (fused lanes: the broadcast rows in one ring a
block, shared by its warps).  Each case runs a small app through the
facade on the card, records the blocks its plan hands K2, reshapes some
of them where the stage has an edge, and holds each block's kernel
launch to `nfa_block_plain` with tolerance 0 (state, meta and sorted
match rows; the input state untouched):

- `t_tail`, `t_short`: T not a multiple of TT, and T below it;
- `chunk_halo`: a chunk block whose halo crosses a tile edge, whose last
  lanes read past the flat events (clipped to F - 1) and whose nev stops
  short of F;
- `bcast_params`: fused lanes (broadcast rows in the block's ring) with
  per-lane parameters, also cut to T = 100 and T = 20;
- `ticks`: timer-tick steps from `set_time` on the wall clock;
- `multi_stream`: a chain over two streams (stream codes);
- `long_bool`: LONG and BOOL event columns (with INT, FLOAT, DOUBLE and
  string codes);
- `double_f64`: a DOUBLE column in float64 under
  @app:devicePrecision('f64');
- `wide`: A > 128 (the wide instantiation);
- `m_overflow`: a block whose matches overflow M, then retried with a
  bigger M from the same, untouched state.

`test_k2_phases_build_matches_plain` holds scripts/k2_phases.py's
-DNFA_PHASES build of nfa_block.cu to the plain version the same way.

Run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_k2_stage.py`;
without one every test skips (decided inside the `cuda` fixture)."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch.replay import (C3H, C3K, C4, C4_SEQ, F64, PARAM_APP,
                                     block_masks, make_tape, sorted_rows)

pytestmark = pytest.mark.gpu

CASES = ("t_tail", "t_short", "chunk_halo", "bcast_params", "ticks",
         "multi_stream", "long_bool", "double_f64", "wide", "m_overflow")

TWO = ("@app:patternFamily('seq')\n@app:partitionCapacity(16)\n"
       "define stream A (k string, x int);\n"
       "define stream B (k string, y double);\n"
       "partition with (k of A, k of B) begin "
       "from every e1=A[x > 3] -> e2=B[y > e1.x] -> e3=A[x < e2.y] "
       "within 100 ms select e1.x as a, e2.y as b, e3.x as c "
       "insert into Out; end;")
TYPES = ("@app:patternFamily('seq')\n@app:partitionCapacity(16)\n"
         "define stream T (k string, i int, l long, f float, b bool, "
         "d double, s string);\n"
         "partition with (k of T) begin "
         "from every e1=T[i > 2] -> e2=T[l > e1.l and b != e1.b and "
         "(s == e1.s or f > e1.f)] within 50 ms "
         "select e1.i as i1, e1.l as l1, e2.l as l2, e1.b as b1, e2.b as b2, "
         "e2.d as d2, e1.s as s1 insert into Out; end;")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _record(monkeypatch) -> list:
    """Every block the plans hand K2, as (kernel, state, ev, M)."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    blocks = []
    orig = NFAKernel.run_block

    def rec(self, state, ev, M):
        blocks.append((self, state, ev, M))
        return orig(self, state, ev, M)
    monkeypatch.setattr(NFAKernel, "run_block", rec)
    return blocks


def _stock(app: str, dev, tape, keys: int, set_times=()):
    rt = siddhi_tpu_torch.SiddhiManager(device=dev).create_app_runtime(app)
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    for f in tape:
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
    for t in set_times:
        rt.set_time(t)
    return rt


def _typed(app: str, dev, streams: tuple, n: int = 600, flushes: int = 3):
    """TWO's or TYPES' streams, 16 keys, events 7 ms apart (the streams of
    a flush share its time range)."""
    rt = siddhi_tpu_torch.SiddhiManager(device=dev).create_app_runtime(app)
    rng = np.random.default_rng(7)
    t = 1_700_000_000_000
    for _f in range(flushes):
        for off, sid in enumerate(streams):
            keys = np.array([f"K{i}" for i in rng.integers(0, 16, n)])
            if sid == "A":
                cols = {"k": keys, "x": rng.integers(0, 10, n).astype(
                    np.int32)}
            elif sid == "B":
                cols = {"k": keys,
                        "y": np.round(rng.uniform(0, 12, n) * 4) / 4}
            else:
                cols = {"k": keys, "i": rng.integers(0, 9, n).astype(np.int32),
                        "l": rng.integers(-50, 50, n).astype(np.int64),
                        "f": (np.round(rng.uniform(-4, 4, n) * 4) / 4
                              ).astype(np.float32),
                        "b": rng.integers(0, 2, n).astype(bool),
                        "d": rng.uniform(-1e3, 1e3, n),
                        "s": np.array([f"S{i}" for i in
                                       rng.integers(0, 3, n)])}
            rt.input_handler(sid).send_batch(
                cols, t + off * 3 + 7 * np.arange(n))
        rt.flush()
        t += 7 * n
    return rt


def _params(rt) -> None:
    """PARAM_APP (replay.py): fused groups with lifted constants in a
    threshold hop, a sequence step and the selector."""
    rng = np.random.default_rng(3)
    n = 2048
    price = np.round(rng.uniform(88, 115, n) * 4) / 4
    h = rt.input_handler("S")
    for lo in range(0, n, 512):
        m = len(price[lo:lo + 512])
        h.send_batch({"sym": np.array(["A"] * m), "price": price[lo:lo + m],
                      "v": (np.arange(lo, lo + m) % 50).astype(np.int32)},
                     1000 + 37 * np.arange(lo, lo + m))
        rt.flush()


def _cut(ev: dict, T: int) -> dict:
    """A (T, P) or (T, 1) grid block's first T steps."""
    return {k: v[:T] if isinstance(v, torch.Tensor) and v.dim() == 2
            else v for k, v in ev.items()}


def _same(kern, state: dict, ev: dict, M: int) -> tuple:
    """One K2 launch against nfa_block_plain on the same block: equal
    state, meta and (within M) sorted rows, the input state untouched;
    returns (TT, warps a block, matches)."""
    from siddhi_tpu_torch.kernels import nfa_block as k2
    pre = kern.pre_masks(ev)
    before = {k: v.clone() for k, v in state.items()}
    launch = k2.prepare(kern, state, ev, pre, M)
    new_k, out_k = launch()
    new_p, out_p = k2.nfa_block_plain(kern, state, ev,
                                      block_masks(kern, ev, pre), M)
    torch.cuda.synchronize()
    assert set(new_k) == set(new_p)
    for key in new_p:
        assert torch.equal(new_k[key], new_p[key]), key
    assert torch.equal(out_k["meta"], out_p["meta"])
    n = int(out_k["meta"][0])
    if n <= M:
        assert torch.equal(sorted_rows(kern, out_k), sorted_rows(kern, out_p))
    for key, v in before.items():
        assert torch.equal(state[key], v), key
    return launch.params.tt, launch.params.wpb, n


@pytest.mark.parametrize("case", CASES)
def test_k2_stage_edges_match_plain(cuda, case, monkeypatch):
    blocks = _record(monkeypatch)
    checks = []                 # (kernel, state, ev, M)
    if case in ("t_tail", "t_short", "m_overflow", "wide"):
        slots = 256 if case == "wide" else 32
        app = (f"@app:partitionCapacity(64)\n@app:deviceSlots({slots})\n" +
               C4_SEQ + C4)
        _stock(app, cuda, make_tape(2 * 8192, 8192, 64, seed=11), 64)
        grid = [b for b in blocks if "__tick__" not in b[2]]
        assert grid
        if case == "wide":
            assert all(b[0].A > 128 for b in grid)
            checks = grid
        elif case == "m_overflow":
            kern, state, ev, M = grid[-1]
            n = _same(kern, state, ev, M)[2]
            assert 8 < n <= M
            tiny = n // 4       # the overflow, then the retry from `state`
            assert _same(kern, state, ev, tiny)[2] == n
            checks = [(kern, state, ev, M)]
        else:
            T = 100 if case == "t_tail" else 20
            assert all(b[2]["__ts__"].shape[0] > T for b in grid)
            checks = [(k, s, _cut(ev, T), M) for k, s, ev, M in grid]
    elif case == "chunk_halo":
        _stock("@app:deviceSlots(32)\n" + C3K, cuda,
               make_tape(8192, 8192, 8, seed=23), 8)
        kern, _s, ev, _m = blocks[-1]
        F, K = ev["__ts__"].shape[0], kern.P
        cs = -(-F // K) + 3               # the last lanes start past F
        prev = int(ev["__seq__"][F // 3])
        for T, nev in ((cs + 70, F - 11), (cs + 70, F), (cs, F - 1)):
            assert K * cs > F and (cs + 70) // 64 > cs // 64
            checks.append((kern, kern.init_state(cuda),
                           dict(ev, __chunk__=(T, cs, nev, prev)), 1 << 16))
        checks.append((kern, kern.init_state(cuda), ev, 1 << 16))
    elif case == "bcast_params":
        rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(
            PARAM_APP)
        _params(rt)
        checks = [b for b in blocks if b[0].broadcast]
        assert checks and all(b[0].params is not None for b in checks)
        kern, state, ev, M = checks[-1]
        assert ev["__ts__"].shape[0] > 100
        checks += [(kern, state, _cut(ev, T), M) for T in (100, 20)]
    elif case == "ticks":
        tape = make_tape(4096, 4096, 8, seed=17)
        ts0 = int(tape[0]["ts"][0])
        rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(
            C3H)
        rt.set_time(ts0 - 1000)
        rt.set_time(ts0 - 1)
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}") for i in range(8)],
                         dtype=np.int32)
        f = tape[0]
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
        for t in (ts0 + 5000, int(f["ts"][-1]) + 1000):
            rt.set_time(t)
        checks = list(blocks)
        assert any("__tick__" in b[2] for b in checks)
    elif case == "multi_stream":
        _typed(TWO, cuda, ("A", "B"))
        checks = list(blocks)
        assert checks and len(checks[0][0].spec.stream_ids) > 1
    else:
        app = (F64 + TYPES) if case == "double_f64" else TYPES
        _typed(app, cuda, ("T",))
        checks = list(blocks)
        dts = {checks[0][2][key].dtype for key in checks[0][0].grid_keys}
        want = {torch.float64} if case == "double_f64" else \
            {torch.int64, torch.bool}
        assert checks and want <= dts
    found = 0
    for kern, state, ev, M in checks:
        got_tt, wpb, n = _same(kern, state, ev, M)
        assert got_tt == 64 and wpb >= 1
        found += n
        if case == "t_short":
            assert ev["__ts__"].shape[0] < got_tt
    assert found > 0


def test_k2_phases_build_matches_plain(cuda, monkeypatch):
    """The -DNFA_PHASES form of K2 (scripts/k2_phases.py) computes what
    the shipped one does, and its marks count every phase of a step."""
    import importlib.util
    import os
    from siddhi_tpu_torch.kernels import nfa_block as k2
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "k2_phases.py")
    spec = importlib.util.spec_from_file_location("k2_phases", path)
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    blocks = _record(monkeypatch)
    app = "@app:partitionCapacity(64)\n@app:deviceSlots(32)\n" + C4_SEQ + C4
    _stock(app, cuda, make_tape(2 * 8192, 8192, 64, seed=11), 64)
    kern, state, ev, M = [b for b in blocks if "__tick__" not in b[2]][-1]
    name = phases.lib_name(kern, ev)
    lib = phases.build_phases((name,))[name]
    pre = kern.pre_masks(ev)
    launch = k2.prepare(kern, state, ev, pre, M)
    _ms, cycles = phases.run_phases(lib, name, launch, reps=1)
    new_k, out_k = launch.outputs
    new_p, out_p = k2.nfa_block_plain(kern, state, ev,
                                      block_masks(kern, ev, pre), M)
    torch.cuda.synchronize()
    for key in new_p:
        assert torch.equal(new_k[key], new_p[key]), key
    assert torch.equal(out_k["meta"], out_p["meta"])
    assert 0 < int(out_k["meta"][0]) <= M
    assert torch.equal(sorted_rows(kern, out_k), sorted_rows(kern, out_p))
    assert all(cycles[ph] > 0 for ph in ("issue", "slots", "drain", "head",
                                         "rest", "prep")), cycles
