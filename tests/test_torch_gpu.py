"""Kernels against their plain versions on a CUDA card (marker `gpu`).

Run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py` (the card
machine has no JAX, which tests/conftest.py imports); without one every
test skips (the decision is taken inside the `cuda`
fixture, never at import).  K1 must match its plain version bit for bit
(the VM is built with --fmad=false); K2 must leave the same state and
the same match rows (sorted) as its plain version; K3-K5 (the `scan`
family) must give the same heaps, chase results and match table as
theirs on every block a run hands them; K6-K8 (the window kernels) the
same scans, range reductions and compacted columns as theirs on data
whose f64 prefixes are exact (and K6, on raw doubles, the same bits on
every run, those of the emulation of its association), and the window
configs the CPU run's rows; K2's EXT instantiation (init slots, forks, absent logical sides)
the same state and rows as its plain version on the chip_smoke phase
apps at A = 32, 64 and 256, after fork overflows and on timer ticks; K10 (`agg_merge`) the same ring as its plain version bit for bit
(NaN and the sign of zero included), K6 use `agg` the same scans, and
the aggregation matrix app the CPU run's stores and rows; K2's chunk
mode (chain, algebra, EXT and the wide instantiation at A = 256) the
same state and rows as its plain version on every chunk block; K11
`dfa_tables` and K4's `dfa` mode the same tables and chase as theirs on
flat, keyed, logical and fused `dfa` blocks."""
import numpy as np
import pytest
import torch

import siddhi_tpu_torch
from siddhi_tpu_torch.core.expr import (F32_MODE, VT_OF_TORCH,
                                        SingleStreamContext,
                                        compile_expression, compute_dtypes,
                                        emit_program)
from siddhi_tpu_torch.core.schema import StreamSchema, StringTable
from siddhi_tpu_torch.kernels import LAUNCHES, reset_launches
from siddhi_tpu_torch.query import parse, parse_expression
from siddhi_tpu_torch.replay import (C2, C2_GROUPED, C2B, C3E, C3H, C3K,
                                     C3SD, C3X, C4, C4A_BODY, C4D, C4D_BODY,
                                     C4F,
                                     C4F_BODY,
                                     C4H, C4L_AND, C4L_OR, C4N_BODY,
                                     C4NS_BODY, C4O_BODY, C4Z, CHUNK, DFA,
                                     PARAM_APP, PLAYBACK, STOCK, c5_app,
                                     make_tape, partitioned, sorted_rows)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


EXPRS = ["price > 100 and volume % 3 != 0 or symbol == 'K2'",
         "volume / 7 - big % 5 + convert(price, 'long')",
         "price * 2.5 - ratio / 3.0",
         "ifThenElse(flag, maximum(ratio, price), minimum(price, 100))"]


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("text", EXPRS)
def test_expr_eval_kernel_matches_plain(cuda, text, f32):
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval, expr_eval_plain
    schema = StreamSchema.of(parse(
        "define stream S (symbol string, price double, volume int, big long,"
        " ratio float, flag bool);").stream_definitions["S"])
    strings = StringTable()
    for i in range(8):
        strings.encode(f"K{i}")
    rng = np.random.default_rng(0)
    n = 100_003
    host = {"big": rng.integers(-2**40, 2**40, n),
            "flag": rng.integers(0, 2, n).astype(bool),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "ratio": rng.uniform(-3, 3, n).astype(np.float32),
            "symbol": rng.integers(1, 9, n).astype(np.int32),
            "volume": rng.integers(-9, 1000, n).astype(np.int32)}
    keys = sorted(host)
    cols = [torch.from_numpy(host[k]).to(cuda) for k in keys]
    ce = compile_expression(parse_expression(text),
                            SingleStreamContext(schema, strings))
    with compute_dtypes(F32_MODE if f32 else None):
        prog = emit_program(ce.node, {k: (i, VT_OF_TORCH[c.dtype]) for i, (k, c)
                                      in enumerate(zip(keys, cols))})
    is_mask = prog.vt == 0
    before = LAUNCHES["expr_eval:filter"]
    args = (cols, prog, []) if is_mask else (cols, None, [prog])
    wk, ok = expr_eval(*args, n, use="filter")
    wp, op = expr_eval_plain(*args, n)
    torch.cuda.synchronize()
    assert LAUNCHES["expr_eval:filter"] == before + 1
    if is_mask:
        assert torch.equal(wk, wp)
    else:
        assert ok[0].dtype == op[0].dtype and torch.equal(ok[0], op[0])


@pytest.mark.parametrize("slots", [32, 64, 4, 160])
def test_nfa_block_kernel_matches_plain(cuda, slots):
    from siddhi_tpu_torch.kernels.expr_eval import unpack_mask
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    app = (f"@app:partitionCapacity(256)\n@app:deviceSlots({slots})\n"
           "define stream S (symbol string, price double, volume int);\n"
           "partition with (symbol of S) begin "
           "from every e1=S[price > 100] -> e2=S[price > e1.price and "
           "volume > e1.volume] -> e3=S[price > e2.price] within 10 sec "
           "select e1.price as p1, e3.volume - e1.volume as dv "
           "insert into Out; end;")
    rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(app)
    kern = rt.plans()[0].kernel
    rng = np.random.default_rng(1)
    T, P = 128, kern.P
    ev = {"__ts__": torch.from_numpy(np.cumsum(rng.integers(
              1, 30, (T, P)), 0).astype(np.int32)).to(cuda),
          "__seq__": torch.arange(T * P, dtype=torch.int32,
                                  device=cuda).view(T, P),
          "__valid__": torch.from_numpy(rng.random((T, P)) < 0.9).to(cuda),
          "0.price": torch.from_numpy((np.round(rng.uniform(
              90, 130, (T, P)) * 4) / 4).astype(np.float32)).to(cuda),
          "0.volume": torch.from_numpy(rng.integers(
              1, 1000, (T, P)).astype(np.int32)).to(cuda),
          "__base_ts__": 1_700_000_000_000}
    state = kern.init_state(cuda)
    for _block in range(2):
        pre = kern.pre_masks(ev)
        sk, ok = nfa_block(kern, state, ev, pre, 1 << 16)
        masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
                 for w in pre]
        sp, op = nfa_block_plain(kern, state, ev, masks, 1 << 16)
        torch.cuda.synchronize()
        for k in sk:
            assert torch.equal(sk[k], sp[k]), k
        assert torch.equal(ok["meta"], op["meta"])
        n = int(ok["meta"][0])
        assert n > 0

        def rows(o):
            r = torch.cat([o["out_i"][:, :n].double(),
                           o["out_f"][:, :n].double()])
            ci = kern.lane_names_i.index("__comp_seq__")
            hi = kern.lane_names_i.index("__head_seq__")
            return r[:, torch.argsort(r[ci] * 2.0 ** 32 + r[hi])]
        assert torch.equal(rows(ok), rows(op))
        state = sk
        ev = dict(ev, __ts__=ev["__ts__"] + int(ev["__ts__"].max()),
                  __seq__=ev["__seq__"] + T * P)


SEQ_ALGEBRA = {
    # a count with a capture-dependent conjunct (`seq` by default)
    "count": ("@app:deviceSlots(8)\n" + partitioned(C4NS_BODY), 40, 3000),
    # `or` with NULL losers and `and` on K2 (the logical station)
    "or": ("@app:patternFamily('seq')\n" + partitioned(C4O_BODY), 40,
           3000),
    "and": ("@app:patternFamily('seq')\n" + partitioned(C4A_BODY), 40,
            3000),
    # a final count collecting in many slots at once: more emissions per
    # event than E lanes, so the plan doubles E and re-runs the block
    "burst": ("@app:patternFamily('seq')\n@app:deviceSlots(8)\n" +
              partitioned(
                  "from every e1=StockStream[price > 100] -> "
                  "e2=StockStream[price > 90]<1:6> within 1 sec "
                  "select e1.price as a, e2[last].price as b, e2[2].price "
                  "as c insert into Out;"), 4, 600),
}


@pytest.mark.parametrize("name", sorted(SEQ_ALGEBRA))
def test_nfa_block_algebra_matches_plain(cuda, name, monkeypatch):
    """K2's count and logical paths: every accepted block the `seq` plan
    ran (state, meta, sorted rows) equal to the plain version, the rows
    equal to the CPU run's with NULLs in place."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.replay import check_seq_block
    app, keys, n = SEQ_ALGEBRA[name]
    app = f"@app:partitionCapacity({keys})\n" + app
    blocks = []
    orig = NFAKernel.run_block

    def rec(self, state, ev, M):
        new, out = orig(self, state, ev, M)
        blocks.append((self, state, ev, M, int(out["meta"][0])))
        return new, out
    monkeypatch.setattr(NFAKernel, "run_block", rec)
    tape = make_tape(n, n // 2, keys, seed=13)

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                         dtype=np.int32)
        for f in tape:
            h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                          "volume": f["volume"]}, f["ts"])
            rt.flush()
        assert rt.plans()[0].family == "seq"
        return out, rt
    got, rt = run(cuda)
    lost = 0
    for kern, state, ev, M, n_found in blocks:
        if n_found > M:
            continue                # an M overflow's first try
        err = check_seq_block(kern, state, ev, M)
        lost += err["lost"]
        assert max(v for key, v in err.items()
                   if key not in ("matches", "lost")) == 0.0
    if name == "burst":
        assert lost > 0 and rt.plans()[0].kernel.E > 2
    blocks.clear()
    want, _rt = run("cpu")
    assert got == want and got
    if name == "or":
        assert any(r[2] is None for _t, r in got)


# K2's EXT instantiation (init slots, forks, absent logical sides) on the
# chip_smoke phase apps, small: (app, keys, events, flush, ms apart); the
# slot counts take the narrow (A = 32, 64) and the wide (A = 256)
# instantiations, and C4F grows from 4 slots through fork overflows
EXT_APPS = {
    "c4h": (C4H, 16, 6000, 3000, 40),
    "c4h_a64": ("@app:deviceSlots(64)\n" + C4H, 16, 6000, 3000, 40),
    "c4z": (C4Z, 16, 6000, 3000, 40),
    "c4f": (C4F, 4, 2400, 1200, 25),
    "c4f_a256": ("@app:deviceSlots(256)\n" + PLAYBACK + partitioned(C4F_BODY),
                 4, 2400, 1200, 25),
    "c4l_or": (C4L_OR, 16, 6000, 3000, 40),
    "c4l_and": (C4L_AND, 16, 6000, 3000, 40),
}


def _run_ext(app, tape, keys, device, set_times=()):
    rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(app)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    for f in tape:
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
    for t in set_times:
        rt.set_time(t)
    return out, rt


@pytest.mark.parametrize("name", sorted(EXT_APPS) + ["c3h"])
def test_nfa_block_ext_matches_plain(cuda, name, monkeypatch):
    """K2's EXT instantiation: every accepted block the `seq` plan ran
    (state, meta, sorted rows) equal to the plain version, EXT launched,
    the rows equal to the CPU run's.  C3H, unpartitioned on the wall
    clock, arms its init slot on a timer tick at the START anchor."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.replay import check_seq_block
    blocks = []
    orig = NFAKernel.run_block

    def rec(self, state, ev, M):
        new, out = orig(self, state, ev, M)
        blocks.append((self, state, ev, M, int(out["meta"][0])))
        return new, out
    monkeypatch.setattr(NFAKernel, "run_block", rec)
    if name == "c3h":
        tape = make_tape(4096, 4096, 8, seed=17)
        ts0 = int(tape[0]["ts"][0])
        app, keys = C3H, 8
        marks = (ts0 + 5000, int(tape[-1]["ts"][-1]) + 1000)

        def run(device):
            rt = siddhi_tpu_torch.SiddhiManager(
                device=device).create_app_runtime(app)
            out = []
            rt.add_callback("Out", lambda evs: out.extend(
                (e.timestamp, e.data) for e in evs))
            rt.set_time(ts0 - 1000)
            assert rt.plans()[0].next_wakeup() == ts0 - 900
            rt.set_time(ts0 - 1)
            h = rt.input_handler("StockStream")
            codes = np.array([rt.strings.encode(f"K{i}") for i in range(8)],
                             dtype=np.int32)
            f = tape[0]
            h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                          "volume": f["volume"]}, f["ts"])
            rt.flush()
            for t in marks:
                rt.set_time(t)
            return out, rt
    else:
        app, keys, n, flush, dt = EXT_APPS[name]
        app = f"@app:partitionCapacity({keys})\n" + app
        tape = make_tape(n, flush, keys, seed=19, dt_ms=dt)

        def run(device):
            return _run_ext(app, tape, keys, device)
    reset_launches()
    got, rt = run(cuda)
    assert LAUNCHES["nfa_block:ext"] > 0 and LAUNCHES["nfa_block"] == 0
    plan = rt.plans()[0]
    assert plan.family == "seq" and plan.kernel.ext
    ticks = 0
    for kern, state, ev, M, n_found in blocks:
        if n_found > M:
            continue                # an M overflow's first try
        err = check_seq_block(kern, state, ev, M)
        assert max(v for key, v in err.items()
                   if key not in ("matches", "lost")) == 0.0
        ticks += "__tick__" in ev
    if name == "c3h":
        assert ticks
    if name.startswith("c4f"):
        assert plan.kernel.A > (4 if name == "c4f" else 128)
    if name == "c4f":
        assert plan.growths["forks"] > 0
    blocks.clear()
    want, _rt = run("cpu")
    assert got == want and got


def test_c4_end_to_end_on_the_card(cuda):
    """A small C4 tape through device='cuda' and device='cpu' on the `seq`
    family: equal rows, and both kernels launched."""
    from siddhi_tpu_torch.kernels import reset_launches
    app = ("@app:partitionCapacity(64)\n@app:deviceSlots(8)\n"
           "@app:patternFamily('seq')\n"
           "define stream StockStream (symbol string, price double, "
           "volume int);\npartition with (symbol of StockStream) begin "
           "from every e1=StockStream[price > 100] -> "
           "e2=StockStream[price > e1.price] -> "
           "e3=StockStream[price > e2.price] within 10 sec "
           "select e1.price as p1, e2.price as p2, e3.price as p3 "
           "insert into Out; end;")
    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        for f in range(3):
            n = 5000
            r = np.random.default_rng(f)
            rt.input_handler("StockStream").send_batch(
                {"symbol": np.array([f"K{i}" for i in r.integers(0, 50, n)]),
                 "price": np.round(r.uniform(90, 130, n) * 4) / 4,
                 "volume": r.integers(1, 1000, n).astype(np.int32)},
                1_700_000_000_000 + f * n + np.arange(n))
            rt.flush()
        return out
    reset_launches()
    got = run(cuda)
    assert min(LAUNCHES[k] for k in ("nfa_block", "expr_eval:pre_mask",
                                     "expr_eval:select")) > 0
    assert got == run("cpu") and got


# ---------------------------------------------------------------------------
# the `scan` family: K3 seg_tree, K4 scan_chase, K5 scan_compact
# ---------------------------------------------------------------------------

C4_SCAN = ("define stream StockStream (symbol string, price double, "
           "volume int);\npartition with (symbol of StockStream) begin "
           "from every e1=StockStream[price > 100] -> "
           "e2=StockStream[price > e1.price] -> "
           "e3=StockStream[price > e2.price] within 10 sec "
           "select e1.price as p1, e2.price as p2, e3.price as p3 "
           "insert into Out; end;")
C3_SCAN = ("define stream StockStream (symbol string, price double, "
           "volume int);\nfrom every e1=StockStream[price > 100] -> "
           "e2=StockStream[price > e1.price] within 1 sec "
           "select e1.price as p1, e2.price as p2 insert into Out;")
TWO = ("define stream A (k string, x int);\n"
       "define stream B (k string, y double);\n"
       "partition with (k of A, k of B) begin "
       "from every e1=A[x > 3] -> e2=B[y > e1.x] -> e3=A[x < e2.y] "
       "within 100 ms select e1.x as a, e2.y as b, e3.x as c "
       "insert into Out; end;")
# name -> (app, keys, flushes, events per flush, tape options)
SCAN_APPS = {
    # the pattern algebra on `scan`: a count head (rank/select, K6 rank,
    # K3 rank trees), `or` with NULL losers, `and` (K6 prev pointers), a
    # final count's fan-out with [i]/[last-1] captures
    "count_head": ("@app:partitionCapacity(64)\n" + partitioned(C4N_BODY),
                   50, 3, 20000, {}),
    # (_feed's volumes lie in [90, 130))
    "or": ("@app:partitionCapacity(64)\n" + partitioned(C4O_BODY.replace(
        "volume > 990", "volume > 125")), 50, 3, 20000, {}),
    "and": ("@app:partitionCapacity(64)\n" + partitioned(C4A_BODY.replace(
        "volume > 990", "volume > 125")), 50, 3, 20000, {}),
    "final_count": ("@app:partitionCapacity(64)\n" + partitioned(
        "from every e1=StockStream[price > 110] -> "
        "e2=StockStream[price < 95]<2:5> within 1 sec select e1.price as a, "
        "e2[0].price as b, e2[last].price as c, e2[last-1].price as d, "
        "e2[3].price as f insert into Out;"), 50, 3, 20000, {}),
    "c4": ("@app:partitionCapacity(64)\n" + C4_SCAN, 50, 3, 20000, {}),
    # NaN prices and 10% of the timestamps moved back or forward
    "c4_nan_ooo": ("@app:partitionCapacity(64)\n" + C4_SCAN, 50, 3, 20000,
                   {"nan": True, "ooo": True}),
    # 2^18 + tail events: a 2^19-leaf flat tree, two K3 passes
    "c3": (C3_SCAN, 50, 2, 1 << 18, {}),
    "c3s": (C3_SCAN.replace("price > e1.price", "price < 95"), 50, 2, 30000,
            {}),
    "sequence": ("define stream StockStream (symbol string, price double, "
                 "volume int);\npartition with (symbol of StockStream) "
                 "begin from every e1=StockStream[price > 120], "
                 "e2=StockStream[price < e1.price and volume > e1.volume] "
                 "within 1 sec select e1.price as p1, e2.price as p2 "
                 "insert into Out; end;", 20, 2, 20000, {}),
    "one_shot": (C3_SCAN.replace("every ", "").replace(
        "price > 100", "price > 125"), 50, 3, 3000, {}),
    "le_long": ("define stream StockStream (symbol string, price long, "
                "volume int);\nfrom every e1=StockStream[price > 100] -> "
                "e2=StockStream[price <= e1.volume] within 1 sec "
                "select e1.price as p1, e2.volume as v insert into Out;",
                50, 2, 20000, {"long_price": True}),
    # two streams: node masks test the stream code; an int column against
    # a double right-hand side compares in a float32 tree
    "two_stream": (TWO, 30, 3, 20000, {"two": True}),
}


def _feed(rt, keys: int, flushes: int, n: int, long_price=False, nan=False,
          ooo=False, two=False):
    rng = np.random.default_rng(7)
    for f in range(flushes):
        ts = 1_700_000_000_000 + f * n + np.arange(n)
        if ooo:
            hit = rng.random(n) < 0.1
            ts[hit] += rng.integers(-3000, 3000, int(hit.sum()))
        ks = np.array([f"K{i}" for i in rng.integers(0, keys, n)])
        if two:
            rt.input_handler("A").send_batch(
                {"k": ks, "x": rng.integers(0, 10, n).astype(np.int32)},
                2 * ts)
            rt.input_handler("B").send_batch(
                {"k": np.array([f"K{i}" for i in rng.integers(0, keys, n)]),
                 "y": np.round(rng.uniform(0, 12, n) * 4) / 4}, 2 * ts + 1)
            rt.flush()
            continue
        price = np.round(rng.uniform(90, 130, n) * 4) / 4
        if nan:
            price[rng.random(n) < 0.05] = np.nan
        if long_price:
            price = price.astype(np.int64)
        rt.input_handler("StockStream").send_batch(
            {"symbol": ks, "price": price,
             "volume": rng.integers(90, 130, n).astype(np.int32)}, ts)
        rt.flush()


@pytest.mark.parametrize("name", sorted(SCAN_APPS))
def test_scan_kernels_match_plain(cuda, name, monkeypatch):
    """Every block the `scan` plan hands ParallelChainKernel.run_block:
    K3's heaps, K4's status and indices, K5's match table equal their
    plain versions (tolerance 0), and the rows equal the CPU run's."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    from siddhi_tpu_torch.replay import check_scan_block
    app, keys, flushes, n, opts = SCAN_APPS[name]
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        _feed(rt, keys, flushes, n, **opts)
        assert rt.plans()[0].family == "scan"
        return out
    reset_launches()
    got = run(cuda)
    uses = {k for k, v in LAUNCHES.items() if v}
    assert blocks
    for k, ev, M in blocks:
        err = check_scan_block(k, ev, M)
        assert max(v for key, v in err.items() if key != "matches") == 0.0
    if blocks[0][0].counts:
        assert {"win_scan:rank", "seg_tree:rank"} <= uses
    if blocks[0][0].prev_nodes:
        assert "win_scan:prev" in uses
    blocks.clear()
    assert got == run("cpu")
    if name != "one_shot":
        assert len(got) > 20


def test_c4_scan_end_to_end_on_the_card(cuda):
    """C4 at default settings runs `scan` on the card: K3, K4 and K5
    launched, K2 not; rows equal to the CPU run."""
    from siddhi_tpu_torch.kernels import reset_launches

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            "@app:partitionCapacity(64)\n" + C4_SCAN)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        _feed(rt, 50, 3, 5000)
        return out
    reset_launches()
    got = run(cuda)
    assert min(LAUNCHES[k] for k in ("seg_tree", "scan_chase", "scan_compact",
                                     "expr_eval:pre_mask",
                                     "expr_eval:select")) > 0
    assert LAUNCHES["nfa_block"] == 0
    assert got == run("cpu") and got


def _fused_scan(body: str, n: int = 12, dbl: str = ".0") -> str:
    """`n` same-shape queries over StockStream, fused into one lane group
    (constants lifted to lane parameters; `{i}` the query index, `{lo}`
    its head constant)."""
    return STOCK + "\n".join(
        f"@info(name='q{i}') " + body.format(i=i, lo=f"{110 + i % 6}{dbl}")
        + " insert into Out;" for i in range(n))


FUSED_EVERY = ("from every e1=StockStream[price > {lo}] -> "
               "e2=StockStream[price > e1.price] -> "
               "e3=StockStream[price > e2.price] within 1 sec "
               "select e1.price as a, e3.price as b")
# name -> (app, flushes, events a flush, trees shared)
SHARED_APPS = {
    # C5's shape: every tree the same in all lanes, built once
    "c5_shape": (_fused_scan(FUSED_EVERY), 3, 20000, "all"),
    # a hop gated by a lane parameter keeps a tree per lane beside the
    # shared timestamp tree
    "gated": (_fused_scan(
        "from every e1=StockStream[price > {lo}] -> "
        "e2=StockStream[volume > 9{i} and price > e1.price] within 1 sec "
        "select e1.price as a, e2.price as b"), 3, 20000, "some"),
    # float64 trees under @app:devicePrecision('f64')
    "f64": ("@app:devicePrecision('f64')\n" + _fused_scan(
        FUSED_EVERY, dbl=".000001"), 3, 20000, "all"),
}


@pytest.mark.parametrize("name", sorted(SHARED_APPS))
def test_shared_trees_match_plain(cuda, name, monkeypatch):
    """A fused `scan` group's lane-invariant trees: K3 builds each once (a
    (1, 2 Lt) heap, lanes x trees no longer launched) and K4 reads it at
    lane stride 0; K3's heaps, K4's chase and K5's table equal their plain
    versions on every block (tolerance 0), and the rows equal the CPU
    run's."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree
    from siddhi_tpu_torch.replay import check_scan_block
    app, flushes, n, which = SHARED_APPS[name]
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        _feed(rt, 8, flushes, n)
        assert rt.plans()[0].family == "scan"
        return out
    got = run(cuda)
    assert blocks
    for k, ev, M in blocks:
        shared = [t.shared for t in k.trees]
        assert all(shared) if which == "all" else any(shared) and \
            not all(shared)
        L = ev["__nev__"].shape[0]
        heaps = seg_tree(k, ev, k.pre_masks(ev))
        assert [h.shape[0] for h in heaps] == [1 if s else L for s in shared]
        err = check_scan_block(k, ev, M)
        assert max(v for key, v in err.items() if key != "matches") == 0.0
    blocks.clear()
    assert got == run("cpu") and len(got) > 20


# ---------------------------------------------------------------------------
# fused multi-query lanes: lane parameters, broadcast events, deadlines,
# timer ticks, the __qid__ row
# ---------------------------------------------------------------------------

LANE_EXPRS = ["price > __qparam0 and volume < __qparam1 or big == __qparam2",
              "price * __qparam3 - volume / __qparam1"]


@pytest.mark.parametrize("grid", ["T,P", "L,F", "select"])
@pytest.mark.parametrize("text", LANE_EXPRS)
def test_expr_eval_lane_params_match_plain(cuda, text, grid):
    """K1 with per-lane parameters: on a (T, P) grid over broadcast (T,)
    columns (lane = column), on an (L, F) grid over shared (F,) columns
    (lane = row), and over match rows whose lane is a `__qid__` column."""
    from siddhi_tpu_torch.core.expr import LaneParams
    from siddhi_tpu_torch.kernels.expr_eval import (RowMap, expr_eval,
                                                    expr_eval_plain)
    from siddhi_tpu_torch.query.ast import AttrType
    schema = StreamSchema.of(parse(
        "define stream S (price double, volume int, big long);"
    ).stream_definitions["S"])
    rng = np.random.default_rng(2)
    P, E = 37, 5003
    host = {"big": rng.integers(-5, 5, E),
            "price": np.round(rng.uniform(90, 130, E) * 4) / 4,
            "volume": rng.integers(-9, 1000, E).astype(np.int32)}
    params = LaneParams({
        "__qparam0": rng.integers(95, 125, P).astype(np.int32),
        "__qparam1": rng.integers(-3, 500, P).astype(np.int32),
        "__qparam2": rng.integers(-5, 5, P).astype(np.int64),
        "__qparam3": (np.round(rng.uniform(0, 3, P) * 4) / 4
                      ).astype(np.float32)}, cuda)
    types = [AttrType.INT, AttrType.INT, AttrType.LONG, AttrType.DOUBLE]
    keys = sorted(host)
    cols = [torch.from_numpy(host[k]).to(cuda) for k in keys]
    ctx = SingleStreamContext(schema, StringTable(), extra={
        f"__qparam{i}": (f"__qparam{i}", t) for i, t in enumerate(types)})
    ce = compile_expression(parse_expression(text), ctx)
    with compute_dtypes(F32_MODE):
        prog = emit_program(ce.node, {k: (i, VT_OF_TORCH[c.dtype]) for i, (k, c)
                                      in enumerate(zip(keys, cols))})
    if grid == "T,P":
        n, rows = E * P, RowMap(col_div=P, lane_mod=P, qparams=params)
    elif grid == "L,F":
        n, rows = E * P, RowMap(col_mod=E, lane_div=E, qparams=params)
    else:
        n = E
        rows = RowMap(lane_col=torch.from_numpy(rng.integers(
            0, P, E).astype(np.int32)).to(cuda), qparams=params)
    args = (cols, prog, []) if prog.vt == 0 else (cols, None, [prog])
    wk, ok = expr_eval(*args, n, use="pre_mask", rows=rows)
    wp, op = expr_eval_plain(*args, n, None, rows)
    torch.cuda.synchronize()
    if prog.vt == 0:
        assert torch.equal(wk, wp)
    else:
        assert ok[0].dtype == op[0].dtype and torch.equal(ok[0], op[0])


def _c5_head_tape(n_events, seed=5):
    rng = np.random.default_rng(seed)
    return {"symbol": np.array([f"K{i}" for i in rng.integers(0, 8, n_events)]),
            "price": np.round(rng.uniform(90.0, 130.0, n_events) * 4) / 4,
            "volume": rng.integers(1, 1000, n_events).astype(np.int32),
            "ts": 1_700_000_000_000 + 50 * np.arange(n_events,
                                                     dtype=np.int64)}


def _feed_param_app(rt, n=2048, seed=3):
    """PARAM_APP (replay.py): fused groups with lifted constants in a
    threshold hop's right-hand side (K4), a sequence step (K2) and the
    selector (K1 by `__qid__`)."""
    rng = np.random.default_rng(seed)
    price = np.round(rng.uniform(88, 115, n) * 4) / 4
    h = rt.input_handler("S")
    for lo in range(0, n, 512):
        h.send_batch({"sym": np.array(["A"] * len(price[lo:lo + 512])),
                      "price": price[lo:lo + 512],
                      "v": (np.arange(lo, lo + len(price[lo:lo + 512]))
                            % 50).astype(np.int32)},
                     1000 + 37 * np.arange(lo, lo + len(price[lo:lo + 512])))
        rt.flush()


MID_ABSENT = ("@app:playback\n"
              "define stream StockStream (symbol string, price double, "
              "volume int);\n" + "\n".join(
                  f"@info(name='q{i}') from every e1=StockStream[price > "
                  f"{110 + i}] -> not StockStream[price < {95 + i}] for 300 "
                  f"milliseconds -> e3=StockStream[price > e1.price] "
                  f"select e1.price as p1, e3.price as p3 insert into "
                  f"Out{i % 4};" for i in range(8)))


@pytest.mark.parametrize("case", ["c5_prefix", "mid_absent", "params"])
def test_nfa_block_broadcast_absent_and_ticks_match_plain(cuda, case,
                                                          monkeypatch):
    """K2 on fused lanes (broadcast (T, 1) events, per-lane parameters in
    pre-masks and step programs, `__qid__` rows) with absent deadlines
    firing on events and on timer ticks: every block the plans ran
    equals the plain version, and the rows equal the CPU run's."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.kernels.expr_eval import unpack_mask
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    app = c5_app(32) if case == "c5_prefix" else MID_ABSENT
    tape = _c5_head_tape(600)
    if case == "c5_prefix":     # up to the first arming of a `not` lane
        cut = int(np.flatnonzero(tape["price"] > 124)[0]) + 1
        tape = {k: v[:cut] for k, v in tape.items()}
    blocks = []
    orig = NFAKernel.run_block

    def rec(self, state, ev, M):
        blocks.append((self, state, ev, M))
        return orig(self, state, ev, M)
    monkeypatch.setattr(NFAKernel, "run_block", rec)

    if case == "params":
        app = PARAM_APP

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            app)
        out = []
        for j in range(16 if case == "c5_prefix" else 4):
            rt.add_callback(f"Out{j}", lambda evs, j=j: out.extend(
                (j, e.timestamp, e.data) for e in evs))
        if case == "params":
            _feed_param_app(rt)
            return out
        h = rt.input_handler("StockStream")
        for lo in range(0, len(tape["ts"]), 200):
            h.send_batch({k: tape[k][lo:lo + 200]
                          for k in ("symbol", "price", "volume")},
                         tape["ts"][lo:lo + 200])
            rt.flush()
        rt.set_time(int(tape["ts"][-1]) + 2000)
        return out
    got = run(cuda)
    assert (case == "params") != any("__tick__" in ev
                                     for _k, _s, ev, _m in blocks)
    for kern, state, ev, M in blocks:
        T, P = ev["__ts__"].shape[0], kern.P
        assert ev["__ts__"].shape[1] == 1 and kern.broadcast
        pre = kern.pre_masks(ev)
        sk, ok = nfa_block(kern, state, ev, pre, M)
        masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
                 for w in pre]
        sp, op = nfa_block_plain(kern, state, ev, masks, M)
        torch.cuda.synchronize()
        for k in sk:
            assert torch.equal(sk[k], sp[k]), k
        assert torch.equal(ok["meta"], op["meta"])
        n = min(int(ok["meta"][0]), M)
        assert torch.equal(sorted_rows(kern, ok), sorted_rows(kern, op))
        assert n == 0 or "__qid__" in kern.lane_names_i
    blocks.clear()
    assert got == run("cpu") and got


@pytest.mark.parametrize("case", ["c5", "params"])
def test_scan_compact_qid_matches_plain(cuda, case, monkeypatch):
    """K3-K5 on fused `scan` lanes (one shared row of events, per-lane
    pre-masks and trees, lane parameters in K4's threshold programs, the
    `__qid__` row): every block equals the plain versions, and the rows
    equal the CPU run's."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    from siddhi_tpu_torch.replay import check_scan_block
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)
    tape = _c5_head_tape(2048)

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(
            c5_app(64) if case == "c5" else PARAM_APP)
        out = []
        for j in range(16 if case == "c5" else 4):
            rt.add_callback(f"Out{j}", lambda evs, j=j: out.extend(
                (j, e.timestamp, e.data) for e in evs))
        if case == "params":
            _feed_param_app(rt)
            return out
        h = rt.input_handler("StockStream")
        for lo in range(0, 2048, 1024):
            h.send_batch({k: tape[k][lo:lo + 1024]
                          for k in ("symbol", "price", "volume")},
                         tape["ts"][lo:lo + 1024])
            rt.flush()
        return out
    got = run(cuda)
    assert blocks
    for k, ev, M in blocks:
        assert ev["__flat.__ts__"].shape[0] == 1 and "__qid__" in \
            k.nfak.lane_names_i
        err = check_scan_block(k, ev, M)
        assert err["matches"] > 0
        assert max(v for key, v in err.items() if key != "matches") == 0.0
    blocks.clear()
    assert got == run("cpu") and got


# -- the window kernels (K6-K8) and the window plans --------------------------

def _win_inputs(cuda, n, seed):
    rng = np.random.default_rng(seed)
    f = np.round(rng.uniform(-100, 100, n) * 4) / 4     # exact f64 prefixes
    f[rng.choice(n, min(n, 3), replace=False)] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    return {"valid": t(rng.random(n) < 0.9), "flags": t(rng.random(n) < 0.002),
            "f64": t(np.where(np.isnan(f), 1.0, f)), "f32n": t(f.astype(
                np.float32)), "i64": t(rng.integers(-2**40, 2**40, n)),
            "i32": t(rng.integers(-1000, 1000, n).astype(np.int32)),
            "clock": t(np.cumsum(rng.integers(0, 3, n))),
            "rng": rng, "t": t}


def _same_scans(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))
        assert torch.equal(torch.isnan(a.double()), torch.isnan(b.double()))


@pytest.mark.parametrize("n", [1, 1000, 1025, 132_096, (1 << 20) + 3])
@pytest.mark.parametrize("segmented", [False, True])
def test_win_scan_kernel_matches_plain(cuda, n, segmented):
    from siddhi_tpu_torch.kernels.win_scan import win_scan, win_scan_plain
    x = _win_inputs(cuda, n, 3)
    cols = [("sum", x["f64"], True), ("sum", x["i64"], True),
            ("sum", None, True), ("sum", x["valid"], False),
            ("min", x["f32n"], True), ("max", x["f32n"], True),
            ("max", x["clock"], False), ("max", x["i32"], True)]
    flags = x["flags"] if segmented else None
    before = LAUNCHES["win_scan"]
    got = win_scan(cols, n, x["valid"], flags)
    want = win_scan_plain(cols, n, x["valid"], flags)
    torch.cuda.synchronize()
    assert LAUNCHES["win_scan"] == before + 1
    _same_scans(got, want)


@pytest.mark.parametrize("case", ["tile_flags", "col_valid", "period322",
                                  "period1500", "period_col_valid"])
def test_win_scan_look_back_edges(cuda, case):
    """K6's look-back against the plain version, tolerance 0: segment
    starts on and around tile boundaries (a tile whose first entry starts
    a segment takes no carry), all five ops masked by the shared and by
    their own valid flags, and `period` mode (322: every tile holds a
    start, 1500: some do not) with the pattern family's count and index
    columns."""
    from siddhi_tpu_torch.kernels.win_scan import TILE, win_scan, \
        win_scan_plain
    n = 40 * TILE + 77
    x = _win_inputs(cuda, n, 11)
    rng, t = x["rng"], x["t"]
    own = [t(rng.random(n) < p) for p in (0.5, 0.97, 0.3)]
    cols = [("sum", x["f64"], True), ("sum", x["i64"], True),
            ("min", x["f32n"], True), ("max", x["f32n"], True),
            ("max", x["i32"], True)]
    flags = period = None
    if case == "tile_flags":
        f = np.zeros(n, bool)
        f[[k * TILE + d for k in range(1, 40) for d in (-1, 0, 1)
           if k % 3]] = True
        f[::5 * TILE] = True
        flags = t(f)
    if case in ("col_valid", "period_col_valid"):
        cols = [c + (own[i % 3],) for i, c in enumerate(cols)]
    if case.startswith("period"):
        period = 1500 if case == "period1500" else 322
        cols += [("sum", own[0], False), ("sum", None, True, own[1]),
                 ("max", None, True, own[2])]
    kw = {"period": period} if period else {}
    got = win_scan(cols, n, x["valid"], flags, **kw)
    want = win_scan_plain(cols, n, x["valid"], flags, **kw)
    torch.cuda.synchronize()
    _same_scans(got, want)


def test_win_scan_graph_replays_reset_the_look_back(cuda):
    """One prepared K6 launch captured in a CUDA graph and replayed three
    times over new inputs copied into the same tensors: each result equals
    the plain version, so the launch clears the tile counter and status
    words it left behind (a stale inclusive prefix would carry the last
    replay's sums)."""
    from siddhi_tpu_torch.kernels import win_scan as k6
    n = 132_096
    x = _win_inputs(cuda, n, 12)
    vals, valid = x["f64"].clone(), x["valid"].clone()
    cols = [("sum", None, True), ("sum", vals, True), ("max", vals, True)]
    launch = k6.prepare(cols, n, valid)
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        launch()
    for r in range(3):
        y = _win_inputs(cuda, n, 100 + r)
        vals.copy_(y["f64"] * (r + 1))
        valid.copy_(y["valid"])
        graph.replay()
        torch.cuda.synchronize()
        _same_scans(launch.outputs, k6.win_scan_plain(cols, n, valid))


@pytest.mark.parametrize("n", [4 * 1024 + 5, 301 * 1024 + 9, (1 << 20) + 3])
def test_win_scan_repeats_its_bits_on_raw_doubles(cuda, n):
    """K6's association depends on the data alone, never on which tiles
    finished first: on raw doubles (where f64 sums round) five runs of one
    call give the same bits, equal to the CPU emulation of the association
    (tests/torch_k6_association.py) at 5 tiles, at 302 (two look-back
    windows) and at 1025 (five), and to the plain version's, which folds
    float sums in the same association, on the CPU and on the card."""
    from torch_k6_association import k6_emulate

    from siddhi_tpu_torch.kernels.win_scan import win_scan, win_scan_plain
    rng = np.random.default_rng(13)
    v = torch.from_numpy(rng.uniform(-1, 1, n) * np.exp(rng.uniform(
        -20, 20, n)))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    cols = [("sum", v, True), ("min", v, True), ("sum", None, True)]
    dev = [(op, x.to(cuda) if x is not None else None, m)
           for op, x, m in cols]
    runs = [win_scan(dev, n, valid.to(cuda)) for _ in range(5)]
    torch.cuda.synchronize()
    bits = [[c.cpu().view(torch.int64) for c in r] for r in runs]
    emulated = [c.view(torch.int64) for c in k6_emulate(cols, n, valid)]
    for r in bits:
        assert all(torch.equal(a, b) for a, b in zip(r, emulated))
    first = [c.cpu() for c in runs[0]]
    for want in (win_scan_plain(cols, n, valid),
                 [c.cpu() for c in win_scan_plain(dev, n, valid.to(cuda))]):
        assert torch.equal(first[0].view(torch.int64),
                           want[0].view(torch.int64))
        _same_scans(first, want)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kind", ["length", "time"])
def test_win_range_kernel_matches_plain(cuda, kind, grouped):
    from siddhi_tpu_torch.kernels.win_range import win_range, win_range_plain
    from siddhi_tpu_torch.kernels.win_scan import win_scan_plain
    N, C = 132_096, 1024
    x = _win_inputs(cuda, N, 4)
    valid, t = x["valid"], x["t"]
    seg = torch.where(valid, t(x["rng"].integers(0, 8, N)),
                      torch.full((N,), N, device=cuda))
    key = seg * N + torch.arange(N, device=cuda)
    ks, order = torch.sort(key)
    sv = valid[order] if grouped else valid
    sp = x["f64"][order] if grouped else x["f64"]
    sf = x["f32n"][order] if grouped else x["f32n"]
    vcnt, clock = win_scan_plain([("sum", None, True),
                                  ("max", x["clock"], False)], N, valid)
    pfx, ipfx, cnt = win_scan_plain([("sum", sp, True),
                                     ("sum", x["i64"], True),
                                     ("sum", None, True)], N, sv)
    sites = [("sum", pfx, None, None, torch.float32),
             ("avg", pfx, cnt, None, torch.float32),
             ("avg", ipfx, cnt, None, torch.float64),
             ("sum", ipfx, None, None, torch.int64),
             ("sum", cnt, None, None, torch.int64),
             ("min", None, None, sf, torch.float32),
             ("max", None, None, sp, torch.float64)]
    kw = dict(n=N, first=C, m=N - C - 77, kind=kind,
              span=1000 if kind == "length" else 700, last=N - 78,
              vcnt=vcnt, clock=clock,
              groups=(ks,) if grouped else None, valid=sv)
    before = LAUNCHES["win_range"]
    got, sk = win_range(sites, **kw)
    want, sp_ = win_range_plain(sites, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["win_range"] == before + 1
    assert torch.equal(sk, sp_)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))


K7_CASES = ("degenerate", "first_mid", "grouped_degenerate", "grouped_large",
            "grouped_many", "grouped_short", "grouped_straddle", "large",
            "many_tiles", "short", "two_tiles")


@pytest.mark.parametrize("case", K7_CASES)
def test_win_range_tiles_match_plain(cuda, case):
    """K7 at the edges of its tiles (tests/torch_k7_cases.py): ranges in
    one sub-block, in one tile, across two tiles and across some 270 (the
    tile table's top levels), n off a multiple of the tile, the first
    output off a tile's start, time(0) ungrouped and grouped, segments
    straddling tiles, past 2^20 entries (the tile table built from L2)
    ungrouped and grouped;
    min/max in f32 and f64 over -0, +0, +-inf and NaN.
    Every output has the plain version's bits (NaN by position) and each
    call counts one launch: three kernel launches with a min/max site
    (two with one tile), one with sums alone."""
    from torch_k7_cases import CASES, LARGE, make_call, same_bits

    from siddhi_tpu_torch.kernels import win_range as k7
    sites, kw = make_call(case, 2, cuda)
    assert set(CASES) | set(LARGE) == set(K7_CASES)
    for use in (sites, [s for s in sites if s[0] in ("sum", "avg")]):
        before = LAUNCHES["win_range"]
        launch = k7.prepare(use, **kw)
        got, sk = launch()
        want, sp = k7.win_range_plain(use, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["win_range"] == before + 1
        assert torch.equal(sk, sp)
        assert all(same_bits(a, b) for a, b in zip(got, want))
        p = launch.params
        mm = p.n_mm > 0
        assert p.launched == 1 + mm + (mm and p.tlevels > 1)
        assert p.ntiles == -(-kw["n"] // k7.TILE)
        assert p.tlevels == k7.levels_for(p.ntiles)
        assert p.n_mm == sum(s[0] in ("min", "max") for s in use)
        assert p.qtiles == (p.ntiles if kw["groups"] is not None else
                            (kw["first"] + kw["m"] - 1) // k7.TILE
                            - kw["first"] // k7.TILE + 1)


# name -> (app, keys, flushes, events a flush, mutations): lanes over
# several of K5's 1024-candidate tiles
K5_APPS = {
    "c4": ("@app:partitionCapacity(64)\n" + C4_SCAN, 2, 2, 6000,
           ("empty_tiles", "m_small")),
    "count_head": ("@app:partitionCapacity(64)\n" + partitioned(C4N_BODY),
                   2, 2, 6000, ("empty_tiles", "m_small")),
    "and": ("@app:partitionCapacity(64)\n" + partitioned(C4A_BODY.replace(
        "volume > 990", "volume > 125")), 2, 2, 6000, ("m_small",)),
    "final_count": SCAN_APPS["final_count"][:1] + (2, 2, 6000,
                                                  ("empty_tiles", "m_small")),
    "one_shot": (C3_SCAN.replace("every ", "").replace(
        "price > 100", "price > 125"), 1, 1, 5000, ("late_h0",)),
    "f64": ("@app:devicePrecision('f64')\n@app:partitionCapacity(64)\n"
            + C4_SCAN, 2, 2, 6000, ("m_small",)),
}


def _k5_blocks(cuda, name, monkeypatch):
    """The `scan` blocks a card run of K5_APPS[name] (or c5_app(64) on
    3000-event flushes, `qid`) hands ParallelChainKernel.run_block."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)
    if name == "qid":
        rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(
            c5_app(64))
        tape = _c5_head_tape(6000)
        h = rt.input_handler("StockStream")
        for lo in range(0, 6000, 3000):
            h.send_batch({k: tape[k][lo:lo + 3000]
                          for k in ("symbol", "price", "volume")},
                         tape["ts"][lo:lo + 3000])
            rt.flush()
    else:
        app, keys, flushes, n, _m = K5_APPS[name]
        rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(
            app)
        _feed(rt, keys, flushes, n)
    monkeypatch.setattr(ParallelChainKernel, "run_block", orig)
    assert blocks
    return blocks


def _k5_inputs(kern, ev):
    """K4's chase (plain version) and the rank columns and trees of one
    block, the inputs K5 takes."""
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase_plain
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree_plain
    from siddhi_tpu_torch.replay import scan_inputs
    pre = kern.pre_masks(ev)
    masks, ranks, prevs, rcols = scan_inputs(kern, ev, pre)
    heaps = seg_tree_plain(kern, ev, masks)
    rheaps = seg_tree_plain(kern, ev, masks, kern.rank_trees, rcols)
    chase = scan_chase_plain(kern, ev, masks, heaps, ranks, rheaps, prevs)
    return list(chase), ranks, rheaps


def _k5_same(out_k, out_p, M):
    from siddhi_tpu_torch.replay import same
    n = int(out_p["meta"][0])
    for key in ("meta", "lane_n", "arm"):
        assert torch.equal(out_k[key], out_p[key]), key
    for key in ("out_i", "out_f", "out_l"):
        assert same(out_k[key][:, :min(n, M)], out_p[key][:, :min(n, M)]), key
    return n


@pytest.mark.parametrize("name", sorted(K5_APPS) + ["qid"])
def test_scan_compact_tiles_match_plain(cuda, name, monkeypatch):
    """K5 on lanes over several of its 1024-candidate tiles (per-lane
    lanes of 3000+ events; counts and a final count's C candidates a
    head; `and`; f64 rows; a fused group's shared row with `__qid__`;
    a one-shot head): each block as the run handed it, and changed so
    that whole tiles hold no live candidate (`empty_tiles`), the
    one-shot head's h0 lies in a later tile (`late_h0`) or M is a third
    of the matches (`m_small`: every match counted, the first M written).
    Counts, flags and the match table equal the plain version's; each
    call counts one launch and launches one kernel."""
    from siddhi_tpu_torch.kernels import scan_compact as k5
    blocks = _k5_blocks(cuda, name, monkeypatch)
    muts = ("as_is",) + (K5_APPS[name][4] if name in K5_APPS else
                         ("empty_tiles", "m_small"))
    counter = "scan_compact:f64" if blocks[0][0].f64 else "scan_compact"
    seen = 0
    for kern, ev, M in blocks:
        F = ev["__flat.__ts__"].shape[1]
        chase, ranks, rheaps = _k5_inputs(kern, ev)
        for mut in muts:
            status, idx, cand, pres = chase
            m = M
            if mut == "empty_tiles":
                cand = cand.clone()
                cand[:, :k5.TILE] = 0
                cand[:, 2 * k5.TILE:3 * k5.TILE] = 0
            elif mut == "late_h0":
                status = status.clone()
                status[:, :min(F - 1, k5.TILE + 100)] &= ~4
            want = k5.scan_compact_plain(kern, ev, (status, idx, cand, pres),
                                         ranks, rheaps, M)
            if mut == "m_small":
                m = max(int(want["meta"][0]) // 3, 1)
                want = k5.scan_compact_plain(
                    kern, ev, (status, idx, cand, pres), ranks, rheaps, m)
            before = LAUNCHES[counter]
            launch = k5.prepare(kern, ev, (status, idx, cand, pres), ranks,
                                rheaps, m)
            got = launch()
            torch.cuda.synchronize()
            assert LAUNCHES[counter] == before + 1
            assert launch.params.launched == 1
            seen += _k5_same(got, want, m)
    assert seen > 0
    assert max(k5.tiles_for(k, ev["__flat.__ts__"].shape[1])
               for k, ev, _m in blocks) > 2


def test_scan_compact_graph_replays_and_two_streams(cuda, monkeypatch):
    """A prepared K5 launch captured in a CUDA graph and replayed three
    times gives the plain version's table each time (the launcher's
    memset, captured with the kernel, zeroes its ticket and look-back
    words; the kernel writes meta, lane_n and arm), and two prepared
    launches in flight at once on two streams each give theirs (each
    launch owns its look-back state)."""
    from siddhi_tpu_torch.kernels import scan_compact as k5
    blocks = _k5_blocks(cuda, "count_head", monkeypatch)
    (ka, eva, Ma), (kb, evb, Mb) = blocks[-2], blocks[-1]
    ina, inb = _k5_inputs(ka, eva), _k5_inputs(kb, evb)
    want_a = k5.scan_compact_plain(ka, eva, *ina, Ma)
    want_b = k5.scan_compact_plain(kb, evb, *inb, Mb)
    launch = k5.prepare(ka, eva, *ina, Ma)
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        launch()
    for _ in range(3):
        for key in ("meta", "lane_n", "arm"):
            launch.outputs[key].fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        _k5_same(launch.outputs, want_a, Ma)
    la, lb = k5.prepare(ka, eva, *ina, Ma), k5.prepare(kb, evb, *inb, Mb)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.cuda.stream(s1):
            la()
        with torch.cuda.stream(s2):
            lb()
        torch.cuda.synchronize()
        _k5_same(la.outputs, want_a, Ma)
        _k5_same(lb.outputs, want_b, Mb)


def _bits(t):
    """A tensor's bits, as integers of its width (NaN payloads, -0.0 and
    bool bytes compared exactly)."""
    return t.view({1: torch.uint8, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _k8_inputs(cuda, n, density, masked, ncols=6, seed=5):
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    x = _win_inputs(cuda, max(n, 1), seed)
    mask = None
    if masked:
        keep = torch.from_numpy(x["rng"].random(n) < density)
        mask = pack_mask(keep).to(cuda) if n else \
            torch.zeros(1, dtype=torch.int32, device=cuda)
    base = [(x["clock"], 2 ** 62), (x["f32n"], -0.0), (x["i32"], -7),
            (x["valid"], True), (x["f64"], float("nan")), (x["i64"], 0)]
    pairs = [base[j % len(base)] for j in range(ncols)]
    return [c for c, _f in pairs], [f for _c, f in pairs], mask


def _k8_same(got, want):
    (outs, k), (pouts, pk) = got, want
    assert torch.equal(k, pk)
    for a, b in zip(outs, pouts):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n,T", [(1, 1), (5, 8), (1000, 1024), (1025, 1025),
                                 (3001, 3001), (131_072, 131_072),
                                 (100_000, 131_072), (777, 65_536), (0, 64)])
@pytest.mark.parametrize("masked,density", [(False, 1.0), (True, 0.0),
                                            (True, 1.0), (True, 0.4)])
def test_win_compact_kernel_matches_plain(cuda, n, T, masked, density):
    """K8 against its plain version bit for bit (NaN payloads, -0.0, bool
    bytes, the per-column pads and k) over 1-, 4- and 8-byte columns:
    masks of density 0, 1 and 0.4 over many tiles, n off the word grid,
    T far above n; one kernel launch a call (the launcher's count), a
    memset besides only in the masked form over more than one tile."""
    from siddhi_tpu_torch.kernels import win_compact as k8
    cols, fills, mask = _k8_inputs(cuda, n, density, masked)
    before = LAUNCHES["win_compact"]
    launch = k8.prepare(cols, fills, n, T, mask)
    got = launch()
    torch.cuda.synchronize()
    assert LAUNCHES["win_compact"] == before + 1
    assert launch.params.launched == 1
    assert (launch.params.state is not None) == (
        masked and k8.tiles_below(n) > 1)
    _k8_same(got, k8.win_compact_plain(cols, fills, n, T, mask))


@pytest.mark.parametrize("masked", [False, True])
def test_win_compact_kernel_many_columns(cuda, masked):
    """More columns than the parameter block carries (their descriptors
    from a device table), every width mixed, equal to the plain version."""
    from siddhi_tpu_torch.kernels import win_compact as k8
    n, T = 40_000, 65_536
    cols, fills, mask = _k8_inputs(cuda, n, 0.4, masked, ncols=k8.INLINE + 5)
    launch = k8.prepare(cols, fills, n, T, mask)
    assert launch.params.table is not None
    got = launch()
    torch.cuda.synchronize()
    _k8_same(got, k8.win_compact_plain(cols, fills, n, T, mask))


def test_win_compact_graph_replays_and_two_streams(cuda):
    """A prepared masked K8 launch over many tiles captured in a CUDA
    graph and replayed three times gives the plain version's outputs each
    time (the launcher's memset, captured with the kernel, zeroes the
    ticket and look-back words), and two prepared launches in flight at
    once on two streams each give theirs (each launch owns its state)."""
    from siddhi_tpu_torch.kernels import win_compact as k8
    ca, fa, ma = _k8_inputs(cuda, 131_072, 0.4, True, seed=8)
    cb, fb, mb = _k8_inputs(cuda, 100_003, 0.7, True, seed=9)
    want_a = k8.win_compact_plain(ca, fa, 131_072, 147_456, ma)
    want_b = k8.win_compact_plain(cb, fb, 100_003, 131_072, mb)
    launch = k8.prepare(ca, fa, 131_072, 147_456, ma)
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        launch()
    for _ in range(3):
        for o in launch.outputs[0]:
            _bits(o).fill_(0x5A)
        launch.outputs[1].fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        _k8_same(launch.outputs, want_a)
    la = k8.prepare(ca, fa, 131_072, 147_456, ma)
    lb = k8.prepare(cb, fb, 100_003, 131_072, mb)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.cuda.stream(s1):
            la()
        with torch.cuda.stream(s2):
            lb()
        torch.cuda.synchronize()
        _k8_same(la.outputs, want_a)
        _k8_same(lb.outputs, want_b)


@pytest.mark.parametrize("which", ["c2", "c2_grouped", "c2b"])
def test_window_configs_match_the_cpu_run(cuda, which):
    """BASELINE config 2, the grouped filtered time window and C2B on a
    shortened tape: the card's rows equal the CPU run's, K6-K8 and both K1
    window uses launched, and every kernel call the plan recorded equal to
    its plain version."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import check_window_calls, run_window
    app = {"c2": C2, "c2_grouped": C2_GROUPED, "c2b": C2B}[which]
    tape = make_tape(3 * 8192, 8192, 8, seed=11)
    calls: list = []
    kernels.reset_launches()
    got, _ms, rt = run_window(app, tape, "cuda", calls)
    launches = dict(kernels.LAUNCHES)
    want, _ms, _rt = run_window(app, tape, "cpu")
    assert got == want and got
    err = check_window_calls(calls)
    assert err and max(err.values()) == 0.0
    used = ["expr_eval:window_args", "expr_eval:window_select",
            "win_scan", "win_compact"] + (["win_range"] if which != "c2b"
                                          else [])
    assert all(launches[k] > 0 for k in used), launches


@pytest.mark.parametrize("which", ["j6", "j6o", "j6u"])
def test_join_configs_match_the_cpu_run(cuda, which):
    """bench.py's config 6 join (J6), its filtered full outer variant with
    a computed column (J6O) and the windowless unidirectional one (J6U) on
    a shortened bench tape: the card's rows equal the CPU run's in order
    (NULLs in place), K9 launched (K1 `join_filter` in J6O), and every
    recorded K9 and K1 call equal to its plain version, tolerance 0."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import (JOIN_APP, JOIN_OUTER, JOIN_UNI,
                                         check_join_calls, join_tape,
                                         run_join)
    app = {"j6": JOIN_APP, "j6o": JOIN_OUTER, "j6u": JOIN_UNI}[which]
    tape = join_tape(3 * 4096, 4096, seed=7)
    calls: list = []
    kernels.reset_launches()
    got, _ms, _rt = run_join(app, tape, "cuda", calls)
    launches = dict(kernels.LAUNCHES)
    want, _ms, _rt = run_join(app, tape, "cpu")
    assert got == want and got
    err = check_join_calls(calls)
    assert err["pairs"] > 0
    assert max(v for k, v in err.items() if k != "pairs") == 0.0
    k9 = [kw for n, _a, kw in calls if n == "join_probe"]
    assert launches["join_probe"] == len(k9) > 0
    assert (launches["expr_eval:join_filter"] > 0) == (which == "j6o")
    if which == "j6u":
        assert all(kw["Mw"] == 1024 for kw in k9)       # left probes only
    if which == "j6o":
        assert any(r[1] is None and r[2] is None for _t, r in got)


@pytest.mark.parametrize("M", [16, 1 << 16])
@pytest.mark.parametrize("outer", [False, True])
def test_join_probe_kernel_matches_plain(cuda, M, outer):
    """K9 alone on random sides against its plain version: a window of
    1024 over 1000 probes with both pass filters, a residual `on` and
    computed columns of every VM value type, at a capacity far below the
    pair total (written within M, the total still reported) and above it."""
    from siddhi_tpu_torch.core.expr import (F32_MODE, MultiStreamContext,
                                            VT_OF_TORCH, compile_expression,
                                            compute_dtypes, emit_program)
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    from siddhi_tpu_torch.kernels.join_probe import (join_probe,
                                                     join_probe_plain)
    from siddhi_tpu_torch.replay import same
    schema = StreamSchema.of(parse(
        "define stream S (k int, p float, v long, f bool);"
    ).stream_definitions["S"])
    ctx = MultiStreamContext({"a": schema, "b": schema}, StringTable())
    rng = np.random.default_rng(5)
    n_p, n_o, NO, Lo = 1000, 3000, 1024, 700

    def cols(n):
        return {"k": torch.from_numpy(rng.integers(0, 4, n).astype(
                    np.int32)),
                "p": torch.from_numpy(rng.uniform(-5, 5, n).astype(
                    np.float32)),
                "v": torch.from_numpy(rng.integers(-9, 9, n)),
                "f": torch.from_numpy(rng.integers(0, 2, n).astype(bool))}
    pc, mc, bc = cols(n_p), cols(NO), cols(n_o)
    keys = ["a.k", "a.p", "b.k", "b.p", "b.v", "b.f"]
    slots = {k: (i, VT_OF_TORCH[(pc if k[0] == "a" else bc)[k[2:]].dtype])
             for i, k in enumerate(keys)}
    with compute_dtypes(F32_MODE):
        def prog(text):
            return emit_program(compile_expression(parse_expression(text),
                                                   ctx).node, slots)
        on = prog("a.k == b.k and a.p > b.p - 1.5")
        outs = [prog(t) for t in ("a.p * b.p + 0.25", "b.v * 3 + a.k",
                                  "a.k - b.k", "b.f or a.p > 0")]
    seq = np.sort(rng.permutation(np.arange(10_000, 10_000 + n_p + n_o)))
    pick = np.zeros(len(seq), bool)
    pick[rng.choice(len(seq), n_p, replace=False)] = True
    args = ([pc["k"], pc["p"]],
            [(mc[c], bc[c]) for c in ("k", "p", "v", "f")],
            torch.from_numpy(seq[pick]), torch.from_numpy(seq[~pick]),
            pack_mask(torch.from_numpy(rng.random(n_p) < 0.8)),
            pack_mask(torch.from_numpy(rng.random(n_o) < 0.7)))
    kw = dict(n_p=n_p, n_o=n_o, Lo=Lo, NO=NO, Mw=1024, on=on, outs=outs,
              M=M, outer=outer)
    want = join_probe_plain(*args, **kw)
    dev = [[t.to(cuda) for t in a] if isinstance(a, list) and a and
           torch.is_tensor(a[0]) else
           [(m.to(cuda), b.to(cuda)) for m, b in a] if isinstance(a, list)
           else a.to(cuda) for a in args]
    before = LAUNCHES["join_probe"]
    got = join_probe(*dev, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["join_probe"] == before + 1
    assert int(want[0][0]) > 1 << 10
    flat_g = [got[0], got[1], got[2], *got[3], got[4]]
    flat_w = [want[0], want[1], want[2], *want[3], want[4]]
    for g, w in zip(flat_g, flat_w):
        assert same(None if g is None else g.cpu(), w)
    # two prepared launches in flight at once on two streams, each with
    # the look-back state its launcher zeroes, each the plain version's
    from siddhi_tpu_torch.kernels.join_probe import prepare
    la, lb = prepare(*dev, **kw), prepare(*dev, **kw)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.cuda.stream(s1):
            ga = la()
        with torch.cuda.stream(s2):
            gb = lb()
        torch.cuda.synchronize()
        assert la.params.launched == lb.params.launched == 2
        for got in (ga, gb):
            flat_g = [got[0], got[1], got[2], *got[3], got[4]]
            for g, w in zip(flat_g, flat_w):
                assert same(None if g is None else g.cpu(), w)


def _agg_segments(rng, lens, dev, nrows=2, nb=7):
    """K10 inputs: segments of the given lengths over shuffled events (each
    in increasing event order), value rows with NaN and signed zeros, a
    ring with a pre-state, distinct slots, fresh flags."""
    n, m = int(sum(lens)), len(lens)
    perm = rng.permutation(n)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    order = np.concatenate([np.sort(perm[off[i]:off[i + 1]])
                            for i in range(m)]).astype(np.int32)
    vals = rng.uniform(-1, 1, (nrows, n)) * \
        np.exp(rng.uniform(-30, 30, (nrows, n)))
    vals[0, rng.integers(0, n, 3)] = np.nan
    vals[1, rng.integers(0, n, 5)] = -0.0
    vals[1, rng.integers(0, n, 5)] = 0.0
    cap = 2 * m
    pre = rng.uniform(-5, 5, (cap, nb))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(pre), t(vals), t(order), t(off),
            t(rng.permutation(cap)[:m].astype(np.int32)),
            t((rng.uniform(size=m) < 0.5).astype(np.int32)))


_AGG_EDGES = [31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1025]


@pytest.mark.parametrize("case", ["small", "mixed", "canary", "chain",
                                  "edges", "long_and_short", "nan_zero",
                                  "nb40", "nb70", "nb400"])
def test_agg_merge_kernel_matches_plain(cuda, case):
    """K10 against its plain version, tolerance 0 (NaN equal to NaN, the
    sign of zero compared too): random short segments, a mix of short and
    long ones, the [1e16, 1, -1e16, 1] canary, one segment of 2^17 events
    (a global rollup's hour bucket), lengths on both sides of the warp and
    of the 256-event chunk, four 2^15-event segments beside 2000 short
    ones, an all-NaN and an only-+-0.0 segment, and 40, 70 and 400 bases
    (two lanes' worth; a second pass over each segment on 70 value rows,
    whose stage no longer fits 256-event chunks; seven passes on 400
    value rows, 160 of them min/max rows, more than one stage of all the
    rows would fit in shared memory)."""
    from siddhi_tpu_torch.kernels.agg_merge import agg_merge, agg_merge_plain
    rng = np.random.default_rng(5)
    lens = {"small": [1, 3, 2, 7, 1] * 500, "mixed": [3] * 2000 + [40, 900],
            "canary": [4], "chain": [1 << 17], "edges": _AGG_EDGES,
            "long_and_short": [1 << 15] * 4 + [3] * 2000,
            "nan_zero": [40, 300, 5]}.get(case, _AGG_EDGES + [7, 1])
    ops = ["sum", "count", "min", "max", "sum", "min", "max"]
    rows = [0, -1, 1, 0, 1, 0, 1]
    nrows = 2
    if case.startswith("nb"):
        nb = int(case[2:])
        nrows = 20 if nb == 40 else nb
        kinds = ["sum", "min", "sum", "max", "count"]
        ops = [kinds[b % 5] for b in range(nb)]
        rows = [-1 if op == "count" else b % nrows
                for b, op in enumerate(ops)]
    pre, vals, order, off, slot, fresh = _agg_segments(
        rng, lens, cuda, nrows, len(ops))
    if case == "canary":
        vals[0] = torch.tensor([1e16, 1.0, -1e16, 1.0], dtype=torch.float64)
        order = torch.arange(4, dtype=torch.int32, device=cuda)
    if case == "nan_zero":
        seg0, seg1 = order[:40].long(), order[40:340].long()
        vals[:, seg0] = float("nan")
        zeros = torch.from_numpy(np.where(rng.random(300) < 0.5, -0.0, 0.0))
        vals[:, seg1] = zeros.to(cuda)
    before = LAUNCHES["agg_merge"]
    got = agg_merge(pre.clone(), vals, order, off, slot, fresh, ops, rows)
    want = agg_merge_plain(pre.clone(), vals, order, off, slot, fresh, ops,
                           rows)
    torch.cuda.synchronize()
    assert LAUNCHES["agg_merge"] == before + 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    if case == "canary":
        s = int(slot[0])
        assert float(got[s, 0]) == (1.0 if int(fresh[0]) else
                                    float(pre[s, 0]) + 1.0)
    if case == "nan_zero":
        s0, s1 = int(slot[0]), int(slot[1])
        assert bool(torch.isnan(got[s0, [0, 2, 3]]).all())
        if int(fresh[1]):
            assert got[s1, 0] == 0 and got[s1, 2] == 0 and got[s1, 3] == 0


def test_agg_merge_graph_time_under_the_chain(cuda):
    """The chain probe (one thread, 2^17 dependent f64 adds) runs and
    returns the exact sum, and K10 on one 2^17-event segment takes at most
    twice the probe's time in a CUDA graph: the design keeps only the
    ordered add on the chain."""
    from siddhi_tpu_torch.kernels import agg_merge as k10
    n = 1 << 17
    probe = k10.chain_probe(n, cuda)
    assert float(probe()[0]) == float(n)
    rng = np.random.default_rng(6)
    pre, vals, order, off, slot, fresh = _agg_segments(rng, [n], cuda)
    ops = ["sum", "count", "min", "max", "sum", "min", "max"]
    rows = [0, -1, 1, 0, 1, 0, 1]
    launch = k10.prepare(pre, vals, order, off, slot, fresh, ops, rows)

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(5):
                fn()
        g.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5
    assert graph_ms(launch) <= 2 * graph_ms(probe)


@pytest.mark.parametrize("n", [7, 4096, 131_072])
def test_win_scan_agg_matches_plain(cuda, n):
    """K6 use `agg`: f64 sums of f32-rounded values (exact prefixes here),
    counts, and jnp.minimum/maximum with signed zeros and NaN, reset at
    segment flags."""
    from siddhi_tpu_torch.kernels.win_scan import win_scan, win_scan_plain
    rng = np.random.default_rng(n)
    v = np.float32(np.round(rng.uniform(-100, 100, n) * 4) / 4)
    v[rng.integers(0, n, 3)] = 0.0
    v[rng.integers(0, n, 3)] = -0.0
    if n > 7:
        v[rng.integers(0, n, 2)] = np.nan
    x = torch.from_numpy(v.astype(np.float64)).to(cuda)
    flags = torch.from_numpy(rng.uniform(size=n) < 0.05).to(cuda)
    flags[0] = True
    cols = [("sum", x, False), ("sum", None, False), ("min", x, False),
            ("max", x, False)]
    before = LAUNCHES["win_scan:agg"]
    got = win_scan(cols, n, flags=flags, use="agg")
    want = win_scan_plain(cols, n, flags=flags)
    torch.cuda.synchronize()
    assert LAUNCHES["win_scan:agg"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(torch.isnan(a.double()), torch.isnan(b.double()))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("head,kernel", [
    ("", "agg_merge"),
    ("@app:deviceAggregations('always')\n", "win_scan:agg")])
@pytest.mark.parametrize("group_by", [True, False])
def test_agg_matrix_matches_the_cpu_run(cuda, head, kernel, group_by):
    """bench.py's aggregation matrix app (grouped and global) on a short
    tape: the card's stores and query rows equal the CPU run's, K10 (or K6
    `agg` under 'always') launched three times a flush and no other, and
    every recorded call equal to its plain version."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import (MATRIX_APP, agg_rows,
                                         check_agg_calls, matrix_tape,
                                         run_agg)
    app = MATRIX_APP(head, group_by)
    tape = matrix_tape(4, 4096, 256)
    calls: list = []
    kernels.reset_launches()
    _ms, _q, _r, rt = run_agg(app, tape, "cuda", calls, query_every=2)
    launches = dict(kernels.LAUNCHES)
    _ms, _q, _r, ref = run_agg(app, tape, "cpu")
    assert agg_rows(rt) == agg_rows(ref)
    assert rt.aggregations["Roll"].state_dict() == \
        ref.aggregations["Roll"].state_dict()
    other = "win_scan:agg" if kernel == "agg_merge" else "agg_merge"
    assert launches[kernel] == 3 * len(tape) == len(calls)
    assert launches[other] == 0
    err = check_agg_calls(calls)
    assert err == {kernel: 0.0}


# ---------------------------------------------------------------------------
# the stateless `chunk` family (K2 over own-chunks with halo reads) and the
# `dfa` family (K11 symbol tables, K4's lookup mode)
# ---------------------------------------------------------------------------

CHUNK_COUNT = CHUNK + STOCK + (
    "@info(name='q') from every e1=StockStream[price > 110]<1:3> -> "
    "e2=StockStream[price < 95] within 1 sec select e1[0].price as a, "
    "e1[last].price as b, e2.price as c insert into Out;\n")
# name -> (app, events a flush, flushes, dt ms): the chain, algebra and EXT
# instantiations in chunk mode, the wide one at A = 256, and slot growth
CHUNK_APPS = {"chain": (C3K, 8192, 2, 1), "conj": (C3X, 8192, 2, 1),
              "count": (CHUNK_COUNT, 8192, 2, 1), "ext": (C3E, 8192, 2, 1),
              "a256": ("@app:deviceSlots(256)\n" + C3K, 4096, 2, 1),
              "growth": ("@app:deviceSlots(2)\n" + C3K, 4096, 2, 1)}


def _run_stream(app, tape, keys, device):
    rt = siddhi_tpu_torch.SiddhiManager(device=device).create_app_runtime(app)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    for f in tape:
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
    return out, rt


@pytest.mark.parametrize("name", sorted(CHUNK_APPS))
def test_nfa_block_chunk_matches_plain(cuda, name, monkeypatch):
    """K2 in chunk mode: every accepted chunk block (state, meta, sorted
    rows, from fresh state) equal to the plain version, launched as
    `nfa_block:chunk` and nothing else of K2, the rows equal to the CPU
    run's in order."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.replay import check_chunk_block
    app, n, flushes, dt = CHUNK_APPS[name]
    tape = make_tape(n * flushes, n, 8, seed=23, dt_ms=dt)
    blocks = []
    orig = NFAKernel.run_block

    def rec(self, state, ev, M):
        new, out = orig(self, state, ev, M)
        blocks.append((self, ev, M, int(out["meta"][0])))
        return new, out
    monkeypatch.setattr(NFAKernel, "run_block", rec)
    reset_launches()
    got, rt = _run_stream(app, tape, 8, cuda)
    plan = rt.plans()[0]
    assert plan.family == "chunk"
    assert LAUNCHES["nfa_block:chunk"] > 0
    assert LAUNCHES["nfa_block"] == LAUNCHES["nfa_block:ext"] == 0
    for kern, ev, M, n_found in blocks:
        if n_found > M:
            continue                # an M overflow's first try
        err = check_chunk_block(kern, ev, M)
        assert max(v for key, v in err.items()
                   if key not in ("matches", "lost")) == 0.0
    if name == "a256":
        assert plan._chunk_A == 256
    if name == "growth":
        assert plan._chunk_A > 2
    blocks.clear()
    want, _rt = _run_stream(app, tape, 8, "cpu")
    assert got == want and got


DFA_FUSED = DFA + STOCK + "\n".join(
    f"@info(name='q{i}') from every e1=StockStream[price > {110 + i}] -> "
    f"e2=StockStream[price < {96 - i % 3}] within 1 sec "
    f"select e1.price as p1, e2.price as p2 insert into Out;"
    for i in range(8)) + "\n"
DFA_OR = DFA + STOCK + (
    "@info(name='q') from every e1=StockStream[price > 122] -> "
    "e2=StockStream[price < 95] or e3=StockStream[price > 126] within "
    "1 sec select e1.price as a, e2.price as b, e3.price as c "
    "insert into Out;\n")
# name -> (app, keys, events a flush, flushes)
DFA_APPS = {"c3sd": (C3SD, 8, 8192, 2),
            "c4d": ("@app:partitionCapacity(64)\n" + C4D, 64, 8192, 2),
            "or": (DFA_OR, 8, 8192, 2), "fused": (DFA_FUSED, 8, 4096, 2)}


@pytest.mark.parametrize("name", sorted(DFA_APPS))
def test_dfa_kernels_match_plain(cuda, name, monkeypatch):
    """K11 and K4's `dfa` mode (with K1, K3, K5) equal to their plain
    versions on every block the `dfa` plan ran: flat, an (L, F) grid of
    keys, a logical pair, and a fused group's shared row; no mask tree
    built for a chase node; rows equal to the CPU run's."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    from siddhi_tpu_torch.replay import check_dfa_block
    app, keys, n, flushes = DFA_APPS[name]
    tape = make_tape(n * flushes, n, keys, seed=29)
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)
    reset_launches()
    got, rt = _run_stream(app, tape, keys, cuda)
    assert rt.plans()[0].family == "dfa"
    assert LAUNCHES["dfa_tables"] > 0 and LAUNCHES["scan_chase:dfa"] > 0
    assert LAUNCHES["scan_chase"] == 0 and LAUNCHES["nfa_block"] == 0
    assert blocks
    for k, ev, M in blocks:
        assert all(t.node is None or t.node not in k.dfa_nodes
                   for t in k.trees)
        err = check_dfa_block(k, ev, M)
        assert max(v for key, v in err.items() if key != "matches") == 0.0
    blocks.clear()
    want, _rt = _run_stream(app, tape, keys, "cpu")
    assert got == want and got


# @app:devicePrecision('f64'): name -> (app, keys, events a flush, flushes,
# ms between events, the raw tape's (lo, levels), family, the float64
# kernel forms it must launch).  K2's chain, EXT, wide (A = 256) and chunk instantiations in
# float64, K3/K4 on float64 trees, K5's float64 rows, float64 lane
# parameters, and a FLOAT capture widened beside DOUBLE ones (both
# families)
C4_SMALL = "@app:partitionCapacity(64)\n@app:deviceSlots(32)\n" + C4
F64_TYPES = ("define stream StockStream (symbol string, price double, "
             "volume int, f float);\npartition with (symbol of StockStream) "
             "begin @info(name='q') from every e1=StockStream[price > 100] "
             "-> e2=StockStream[price > e1.price and f >= e1.f] -> "
             "e3=StockStream[f > e2.price - 100.0] within 10 sec select "
             "e1.price as p1, e1.f as f1, e3.f - e1.f as df, e3.price as p3 "
             "insert into Out; end;")
F64_TYPES_SCAN = F64_TYPES.replace(" and f >= e1.f", "")
F64_FUSED = STOCK + "\n".join(
    f"@info(name='q{i}') from every e1=StockStream[price > "
    f"{100 + 1e-5 * (i + 1):.5f}] -> e2=StockStream[price > e1.price] "
    f"within 40 ms select e1.price as a{i}, e2.price as b{i} "
    f"insert into Out;" for i in range(8))
F64_APPS = {
    "c4": (C4_SMALL, 64, 8192, 2, 1, (100.0, 3), "scan",
           ("seg_tree:f64", "scan_chase:f64", "scan_compact:f64")),
    "c4_seq": ("@app:patternFamily('seq')\n" + C4_SMALL, 64, 8192, 2, 1,
               (100.0, 3), "seq", ("nfa_block:f64",)),
    "c4_a256": ("@app:patternFamily('seq')\n@app:deviceSlots(256)\n" +
                C4_SMALL, 64, 4096, 1, 1, (100.0, 3), "seq",
                ("nfa_block:f64",)),
    "c4f": ("@app:partitionCapacity(16)\n" + C4F, 4, 1200, 2, 25,
            (90.0, 40), "seq", ("nfa_block:ext:f64",)),
    "c3k": (C3K, 8, 8192, 2, 1, (90.0, 40), "chunk",
            ("nfa_block:chunk:f64",)),
    "c3e": (C3E, 8, 8192, 2, 1, (90.0, 40), "chunk",
            ("nfa_block:chunk:f64",)),
    "c3sd": (C3SD, 8, 8192, 2, 1, (90.0, 40), "dfa",
             ("dfa_tables", "scan_chase:dfa", "scan_compact:f64")),
    "c4d": ("@app:partitionCapacity(64)\n" + C4D, 64, 8192, 2, 1,
            (90.0, 40), "dfa", ("dfa_tables", "scan_chase:dfa:f64", "seg_tree:f64",
                    "scan_compact:f64")),
    "fused": (F64_FUSED, 8, 4096, 2, 1, (100.0, 3), "scan",
              ("seg_tree:f64", "scan_chase:f64", "scan_compact:f64")),
    "types_seq": ("@app:partitionCapacity(64)\n" + F64_TYPES, 64, 8192, 2,
                  1, (100.0, 3), "seq", ("nfa_block:f64",)),
    "types_scan": ("@app:partitionCapacity(64)\n" + F64_TYPES_SCAN, 64,
                   8192, 2, 1, (100.0, 3), "scan",
                   ("seg_tree:f64", "scan_chase:f64", "scan_compact:f64")),
}


@pytest.mark.parametrize("name", sorted(F64_APPS))
def test_f64_kernels_match_plain(cuda, name, monkeypatch):
    """Under @app:devicePrecision('f64') on a raw-double tape: the plan's
    family in float64, its float64 kernel forms launched and no float32
    form of K2 or K5; every block it ran (K2: state, meta and sorted rows;
    `scan`/`dfa`: K1, K3, K6, K4, K5) equal to the plain versions,
    tolerance 0; rows equal to the CPU run's."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    from siddhi_tpu_torch.replay import (F64, check_chunk_block,
                                         check_scan_block, check_seq_block,
                                         raw_tape)
    app, keys, n, flushes, dt, (lo, levels), family, uses = F64_APPS[name]
    app = F64 + app
    tape = raw_tape(n * flushes, n, keys, seed=31, dt_ms=dt, lo=lo,
                    levels=levels)
    if name.startswith("types"):
        rng = np.random.default_rng(3)      # float32, near price - 100
        for f in tape:
            f["f"] = (rng.integers(0, 1024, len(f["price"])) *
                      2.0 ** -20).astype(np.float32)
    seq_b, scan_b = [], []
    run_seq, run_scan = NFAKernel.run_block, ParallelChainKernel.run_block

    def rec_seq(self, state, ev, M):
        new, out = run_seq(self, state, ev, M)
        seq_b.append((self, state, ev, M, int(out["meta"][0])))
        return new, out

    def rec_scan(self, ev, M):
        scan_b.append((self, ev, M))
        return run_scan(self, ev, M)
    monkeypatch.setattr(NFAKernel, "run_block", rec_seq)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec_scan)

    def run(device):
        rt = siddhi_tpu_torch.SiddhiManager(
            device=device).create_app_runtime(app)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                         dtype=np.int32)
        for f in tape:
            cols = {"symbol": codes[f["sym_idx"]], "price": f["price"],
                    "volume": f["volume"]}
            if "f" in f:
                cols["f"] = f["f"]
            h.send_batch(cols, f["ts"])
            rt.flush()
        return out, rt
    reset_launches()
    got, rt = run(cuda)
    plan = rt.plans()[0]
    inner = getattr(plan, "inner", plan)
    assert inner.f64 and inner.family == family
    assert all(LAUNCHES[u] > 0 for u in uses), LAUNCHES
    assert all(LAUNCHES[u] == 0 for u in ("nfa_block", "nfa_block:ext",
                                          "nfa_block:chunk", "scan_compact"))
    if name == "c4_a256":
        assert inner.kernel.A > 128
    if name == "c4f":
        assert inner.kernel.A > 4 and inner.growths["forks"] > 0
    if name == "fused":
        assert all(v.dtype == torch.float64 for v in inner.params.values)
    for kern, state, ev, M, n_found in seq_b:
        if n_found > M:
            continue                # an M overflow's first try
        assert kern.fdt == torch.float64
        err = check_chunk_block(kern, ev, M) if "__chunk__" in ev else \
            check_seq_block(kern, state, ev, M)
        assert max(v for key, v in err.items()
                   if key not in ("matches", "lost")) == 0.0
    for k, ev, M in scan_b:
        err = check_scan_block(k, ev, M)
        assert max(v for key, v in err.items() if key != "matches") == 0.0
    assert seq_b or scan_b
    seq_b.clear()
    scan_b.clear()
    want, _rt = run("cpu")
    assert got == want and got


# ---------------------------------------------------------------------------
# K1's tiles (R rows a thread, several programs a launch, the register
# stacks) and K11's tiles (many blocks a lane, the look-back)
# ---------------------------------------------------------------------------

TILE_MASKS = ["price > 100", "not flag",
              "volume < 500 and flag or symbol == 'K3'",
              "(price + volume) * 2.0 > (big - 3) * (ratio + 4) and "
              "(price - volume) < big + ratio * 2.0"]


def _tile_programs(keys, cols, texts, f32=False, extra=None):
    types = {"symbol": "string", "price": "double", "volume": "int",
             "big": "long", "ratio": "float", "flag": "bool",
             "p64": "double", "p32": "float", "q": "int"}
    schema = StreamSchema.of(parse(
        "define stream S (" + ", ".join(f"{k} {types[k]}" for k in keys)
        + ");").stream_definitions["S"])
    strings = StringTable()
    for i in range(8):
        strings.encode(f"K{i}")
    ctx = SingleStreamContext(schema, strings, extra=extra or {})
    progs = []
    for text in texts:
        ce = compile_expression(parse_expression(text), ctx)
        with compute_dtypes(F32_MODE if f32 else None):
            progs.append(emit_program(ce.node, {
                k: (i, VT_OF_TORCH[c.dtype])
                for i, (k, c) in enumerate(zip(keys, cols))}))
    return progs


def _tile_cols(cuda, n, seed):
    rng = np.random.default_rng(seed)
    host = {"big": rng.integers(-2**40, 2**40, n),
            "flag": rng.integers(0, 2, n).astype(bool),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "ratio": rng.uniform(-3, 3, n).astype(np.float32),
            "symbol": rng.integers(1, 9, n).astype(np.int32),
            "volume": rng.integers(-9, 1000, n).astype(np.int32)}
    host["volume"][::97] = 0
    keys = sorted(host)
    return keys, [torch.from_numpy(host[k]).to(cuda) for k in keys]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 2047, 2048,
                               2049, 65_537])
def test_expr_eval_tiles_match_plain(cuda, n):
    """K1 at the edges of its tiles (8 rows a thread, 256 a warp, 2048 a
    block): several mask programs in one launch (fused compares alone,
    the register stack of depth 2, and deeper programs on the
    local-memory stack), and a mask with output programs (integer / and
    %, casts, select)."""
    from siddhi_tpu_torch.kernels.expr_eval import (depth_class, expr_eval,
                                                    expr_eval_plain,
                                                    expr_masks,
                                                    expr_masks_plain)
    keys, cols = _tile_cols(cuda, n, n)
    masks = _tile_programs(keys, cols, TILE_MASKS)
    assert [depth_class(masks[:i + 1]) for i in range(4)] == [-1, 2, 0, 0]
    for group in (masks[:1], masks[:2], masks[:3], masks):
        before = LAUNCHES["expr_eval:pre_mask"]
        got = expr_masks(cols, group, n, use="pre_mask")
        want = expr_masks_plain(cols, group, n)
        torch.cuda.synchronize()
        assert LAUNCHES["expr_eval:pre_mask"] == before + 1
        for a, b in zip(got, want):
            assert a.shape == (-(-n // 32),) and torch.equal(a, b)
    outs = _tile_programs(keys, cols, [
        "volume / 7 + volume % 5 * 3", "big / volume - big % 3",
        "ifThenElse(flag, big, volume)", "convert(price, 'int')",
        "ratio * ratio + ratio"]) + _tile_programs(
        keys, cols, ["price * 2.5 - ratio / 3.0 + volume"], f32=True)
    wk, ok = expr_eval(cols, masks[2], outs, n, use="filter")
    wp, op = expr_eval_plain(cols, masks[2], outs, n)
    torch.cuda.synchronize()
    assert torch.equal(wk, wp)
    for a, b in zip(ok, op):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_expr_eval_last_tile_at_the_row_limit(cuda):
    """K1 over the most rows a launch takes (2^31 - 1, a lane grid over
    32-row columns; the last tile's end, 2^31, does not fit an int): the
    last tile is part-full, so no row at or past n sets a bit, on the
    stackless kernel and on the register stack."""
    from siddhi_tpu_torch.kernels.expr_eval import (MAX_ROWS, RowMap,
                                                    expr_masks,
                                                    expr_masks_plain)
    F, n = 32, MAX_ROWS
    keys, cols = _tile_cols(cuda, F, 7)
    cols[keys.index("price")][n % F] = 120.0    # row n's element: true
    cols[keys.index("flag")][n % F] = False
    masks = _tile_programs(keys, cols, TILE_MASKS[:2])
    rows = RowMap(col_mod=F)
    tail = n - (n // 1024 - 4) * 1024       # from a multiple of F on
    for group in (masks[:1], masks):
        got = expr_masks(cols, group, n, use="pre_mask", rows=rows)
        want = expr_masks_plain(cols, group, tail, rows=rows)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.shape == (-(-n // 32),)
            assert torch.equal(a[-b.shape[0]:], b)
        del got


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("L,F", [(300, 7), (64, 31), (100, 33), (9, 257),
                                 (250, 8233)])
@pytest.mark.parametrize("grid", ["L,F", "T,P", "select"])
def test_expr_eval_lane_straddles_match_plain(cuda, grid, L, F, f64):
    """K1 with lane parameters where a thread's 8 rows straddle lanes
    (F < 32, F not a multiple of 32, F > 256): the lane grid over shared
    (F,) columns, the (T, P) grid over broadcast columns, match rows
    with a lane column; float32 and float64 parameters; every program
    of the block in one launch."""
    from siddhi_tpu_torch.core.expr import LaneParams
    from siddhi_tpu_torch.kernels.expr_eval import (RowMap, expr_masks,
                                                    expr_masks_plain)
    from siddhi_tpu_torch.query.ast import AttrType
    rng = np.random.default_rng(L * F)
    dt = np.float64 if f64 else np.float32
    params = LaneParams({
        "__qparam0": (100 + np.round(rng.uniform(0, 20, L) * 4) / 4
                      ).astype(dt),
        "__qparam1": rng.integers(-3, 900, L).astype(np.int32)}, cuda)
    extra = {"__qparam0": ("__qparam0",
                           AttrType.DOUBLE if f64 else AttrType.FLOAT),
             "__qparam1": ("__qparam1", AttrType.INT)}
    n = L * F
    m = F if grid != "select" else n
    keys, cols = _tile_cols(cuda, m, F)
    progs = _tile_programs(keys, cols, [
        "price > __qparam0", "volume < __qparam1",
        "price > __qparam0 and volume > __qparam1 or flag"],
        f32=not f64, extra=extra)
    if grid == "L,F":
        rows = RowMap(col_mod=F, lane_div=F, qparams=params)
    elif grid == "T,P":
        rows = RowMap(col_div=L, lane_mod=L, qparams=params)
        n = F * L
    else:
        rows = RowMap(lane_col=torch.from_numpy(rng.integers(
            0, L, n).astype(np.int32)).to(cuda), qparams=params)
    got = expr_masks(cols, progs, n, use="pre_mask", rows=rows)
    want = expr_masks_plain(cols, progs, n, None, rows)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _k11_block(cuda, L, F, nk, kind, seed, fused=False):
    """A synthetic `dfa` block: nk chase nodes' pre-mask words over the
    (L*F,) lane grid and their plain tables."""
    import types as _t

    from siddhi_tpu_torch.kernels.dfa_tables import dfa_tables_plain
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    rng = np.random.default_rng(seed)
    m = np.zeros((nk, L, F), bool)
    for k in range(nk):
        if kind == "first":
            m[k, :, 0] = True
        elif kind == "last":
            m[k, :, F - 1] = True
        elif kind == "sparse":
            m[k] = rng.random((L, F)) < 2e-5
        elif kind == "dense":
            m[k] = rng.random((L, F)) < 0.3
    nev = rng.integers(max(F - 50, 0), F + 1, L).astype(np.int32)
    valid = np.arange(F)[None, :] < nev[:, None]
    k = _t.SimpleNamespace(dfa_nodes=list(range(nk)), multi=False,
                           node_scode=[-1] * nk)
    ev = {"__flat.__ts__": torch.zeros((1 if fused else L, F),
                                       dtype=torch.int32, device=cuda),
          "__nev__": torch.from_numpy(nev).to(cuda)}
    pre = [pack_mask(torch.from_numpy(m[j].reshape(-1))).to(cuda)
           for j in range(nk)]
    want = dfa_tables_plain([torch.from_numpy(m[j] & valid).to(cuda)
                             for j in range(nk)])
    return k, ev, pre, want


@pytest.mark.parametrize("L,F,nk,kind", [
    (1, 263_145, 1, "first"), (1, 263_145, 2, "none"),
    (1, 263_147, 3, "last"), (1, 263_145, 4, "sparse"),
    (3, 20_001, 8, "dense"), (1000, 326, 2, "dense"), (8, 40_003, 1,
                                                       "first"),
    (5, 1, 1, "dense"), (2, 1025, 5, "sparse")])
def test_dfa_tables_tiles_match_plain(cuda, L, F, nk, kind):
    """K11 over lanes of many tiles (C3SD's 263,145 events: 257 tiles):
    a lane whose only hit is its first block (the carry crosses every
    tile), lanes with no hit, a hit only in the last block, sparse and
    dense hits, F not a multiple of 4, 1-8 chase nodes, lanes of one
    tile (C4D's shape); the tables equal the plain version's, and again
    on a second launch and on CUDA-graph replays (the launcher's memset,
    captured with the kernel, zeroes the look-back state), and two
    launches in flight at once on two streams each give them."""
    from siddhi_tpu_torch.kernels import dfa_tables as k11
    k, ev, pre, want = _k11_block(cuda, L, F, nk, kind, L * F + nk)
    launch = k11.prepare(k, ev, pre)
    W, T = k11.tile_geometry(-(-F // 4))
    assert (launch.params.W, launch.params.T) == (W, T)
    for _ in range(2):
        got = launch()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    for _ in range(3):
        for t in got:
            t.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert launch.params.launched == 1
    la, lb = k11.prepare(k, ev, pre), k11.prepare(k, ev, pre)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.cuda.stream(s1):
            ga = la()
        with torch.cuda.stream(s2):
            gb = lb()
        torch.cuda.synchronize()
        for got in (ga, gb):
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_dfa_tables_fused_lanes_share_a_row(cuda):
    """K11 over a fused group's lanes (one shared row of events, each
    lane its own pre-mask words), lanes of several tiles."""
    from siddhi_tpu_torch.kernels.dfa_tables import dfa_tables
    k, ev, pre, want = _k11_block(cuda, 12, 3001, 2, "dense", 7, fused=True)
    got = dfa_tables(k, ev, pre)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K3 (typed warp-per-tree builds) and K4 (blocks sized to the lane, the
# shared descent) at the shapes around their edges
# ---------------------------------------------------------------------------

_K34_W = " within 10 sec "
# hop kinds, each with its trees: (body, what its trees are)
K34_BODIES = {
    # f32 max-tree beside the i64 timestamp tree (f64 under f64)
    "threshold_max": "from every e1=StockStream[price > 100] -> "
                     "e2=StockStream[price > e1.price] -> "
                     "e3=StockStream[price > e2.price]" + _K34_W +
                     "select e1.price as p1, e3.price as p3 insert into Out;",
    # i64 min- and max-trees (volume int against volume int)
    "threshold_i64": "from every e1=StockStream[price > 100] -> "
                     "e2=StockStream[volume < e1.volume] -> "
                     "e3=StockStream[volume > e2.volume]" + _K34_W +
                     "select e1.price as p1, e3.volume as v3 "
                     "insert into Out;",
    # an i32 mask tree (static hop) and an f32 (f64) min-tree
    "static_min": "from every e1=StockStream[price > 120] -> "
                  "e2=StockStream[volume > 125] -> "
                  "e3=StockStream[price < e1.price]" + _K34_W +
                  "select e1.price as p1, e3.price as p3 insert into Out;",
    "count_head": C4N_BODY,
    "count_below": "from every e1=StockStream[price > 125] -> "
                   "e2=StockStream[price < 95]<2:3> -> "
                   "e3=StockStream[price > e1.price] within 1 sec "
                   "select e1.price as p1, e2[0].price as q0, "
                   "e3.price as p3 insert into Out;",
    "final_count": "from every e1=StockStream[price > 125] -> "
                   "e2=StockStream[price < 95]<1:3> within 1 sec "
                   "select e1.price as p1, e2[0].price as q0, "
                   "e2[last].price as ql insert into Out;",
    "and": C4A_BODY,
    "or": C4O_BODY,
}
# name -> (lanes, events a lane): Lt 2 ... 2048 per lane (up to 1024 one
# K4 block a lane, 2048 several; K3 a warp a tree up to 1024 leaves, a
# block a subtree past it), 2^15 and 2^19 in one flat lane
K34_SHAPES = {"lt2": (64, 2), "lt32": (64, 32), "lt512": (32, 512),
              "lt1024": (16, 1024), "lt2048": (8, 2048),
              "flat15": (1, 1 << 15), "flat19": (1, 1 << 19)}
K34_CASES = ([(s, "threshold_max", f) for s in K34_SHAPES
              for f in (False, True)] +
             [(s, b, f) for s in ("lt32", "lt512", "lt2048", "flat15")
              for b in K34_BODIES if b != "threshold_max"
              for f in (False, True)] +
             [(s, "dfa", False) for s in ("lt32", "lt512", "flat15")])


def _k34_app(body: str, f64: bool, lanes: int) -> str:
    if body == "dfa":
        head, body = DFA, C4D_BODY
    else:
        head, body = "", K34_BODIES[body]
    head += ("@app:devicePrecision('f64')\n" if f64 else "") + \
        f"@app:partitionCapacity({max(lanes, 2)})\n"
    if lanes == 1:
        return head + STOCK + "@info(name='q') " + body
    return head + partitioned(body)


def _k34_blocks(cuda, app: str, lanes: int, per: int, monkeypatch,
                seed: int = 1) -> list:
    """The `scan` blocks of one flush of lanes x per events (event i of
    key i % lanes, 1 ms apart: `per` events in every lane) on the card."""
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev, M))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)
    rt = siddhi_tpu_torch.SiddhiManager(device=cuda).create_app_runtime(app)
    rng = np.random.default_rng(seed)
    n = lanes * per
    rt.input_handler("StockStream").send_batch(
        {"symbol": np.array([f"K{i % lanes}" for i in range(n)]),
         "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
         "volume": rng.integers(90, 130, n).astype(np.int32)},
        1_700_000_000_000 + np.arange(n))
    rt.flush()
    monkeypatch.setattr(ParallelChainKernel, "run_block", orig)
    assert rt.plans()[0].family in ("scan", "dfa") and blocks
    return blocks


@pytest.mark.parametrize("shape,body,f64", K34_CASES)
def test_k34_kernels_match_plain(cuda, shape, body, f64, monkeypatch):
    """K3's heaps (their bytes, +0.0 and -0.0 apart) and K4's status,
    index rows, candidates and presence bits equal their plain versions
    (tolerance 0) on every block, with K5 and K1 after them
    (replay.check_scan_block), at Lt 2 ... 2^19, over i32 mask trees, i64,
    f32 and f64 max- and min-trees, rank trees, threshold, static, count
    (head, below, final) and logical hops, and `dfa`; K3 launches a kernel
    per 10 tree levels, K4 one, in blocks of lane_geometry's threads."""
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import seg_tree as k3
    from siddhi_tpu_torch.replay import check_scan_block, scan_inputs
    lanes, per = K34_SHAPES[shape]
    blocks = _k34_blocks(cuda, _k34_app(body, f64, lanes), lanes, per,
                         monkeypatch)
    for kern, ev, M in blocks:
        F = ev["__flat.__ts__"].shape[1]
        Lt = kern.leaves(F)
        assert F == per
        err = check_scan_block(kern, ev, M)
        assert max(v for key, v in err.items() if key != "matches") == 0.0
        pre = kern.pre_masks(ev)
        if kern.trees:
            l3 = k3.prepare(kern, ev, pre)
            l3()
            assert l3.params.launched == -(-(Lt.bit_length() - 1) // 10)
        heaps = k3.seg_tree(kern, ev, pre)
        _m, ranks, prevs, rcols = scan_inputs(kern, ev, pre)
        rheaps = k3.seg_tree(kern, ev, pre, kern.rank_trees, rcols) \
            if kern.rank_trees else []
        tables = None
        if kern.dfa_nodes:
            from siddhi_tpu_torch.kernels.dfa_tables import dfa_tables
            tables = dfa_tables(kern, ev, pre)
        l4 = k4.prepare(kern, ev, pre, heaps, ranks, rheaps, prevs, tables)
        l4()
        torch.cuda.synchronize()
        p = l4.params
        assert p.launched == 1 and not p.compact
        assert p.threads == k4.lane_geometry(F)
        assert p.blocks == lanes * -(-F // p.threads)


def test_k34_graph_replays_and_two_streams(cuda, monkeypatch):
    """Prepared K3 and K4 launches captured in CUDA graphs and replayed
    three times over outputs filled with garbage give the plain versions'
    heaps and chase each time (nothing carries between launches), and
    two blocks' launches in flight at once on two streams each give
    theirs."""
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import seg_tree as k3
    from siddhi_tpu_torch.replay import bits, same, scan_inputs
    cases = []
    for body, lanes, per in (("count_head", 32, 512),
                             ("threshold_max", 1, 1 << 15)):
        kern, ev, _M = _k34_blocks(cuda, _k34_app(body, False, lanes), lanes,
                                   per, monkeypatch)[-1]
        pre = kern.pre_masks(ev)
        masks, ranks, prevs, rcols = scan_inputs(kern, ev, pre)
        heaps = k3.seg_tree_plain(kern, ev, masks)
        rheaps = k3.seg_tree_plain(kern, ev, masks, kern.rank_trees, rcols)
        chase = k4.scan_chase_plain(kern, ev, masks, heaps, ranks, rheaps,
                                    prevs)
        cases.append((k3.prepare(kern, ev, pre), heaps,
                      k4.prepare(kern, ev, pre, heaps, ranks, rheaps, prevs),
                      chase))

    def check(l3, heaps, l4, chase):
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   zip(bits(l3.outputs), bits(heaps)))
        assert all(same(a, b) for a, b in zip(l4.outputs, chase))
    for l3, heaps, l4, chase in cases:
        l3()
        l4()
        check(l3, heaps, l4, chase)
        g3, g4 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(g3, capture_error_mode="relaxed"):
            l3()
        with torch.cuda.graph(g4, capture_error_mode="relaxed"):
            l4()
        for _ in range(3):
            for t in l3.outputs:
                t.view(torch.uint8).fill_(0xA5)
            for t in l4.outputs:
                t.view(torch.uint8).fill_(0x5A)
            g3.replay()
            g4.replay()
            check(l3, heaps, l4, chase)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(3):
        for (l3, _h, l4, _c), s in zip(cases, (s1, s2)):
            with torch.cuda.stream(s):
                l3()
                l4()
        for case in cases:
            check(*case)


def test_mixed_device_and_host_queries_match_the_cpu_run(cuda):
    """chip_smoke phase 46's app on the card: the device query plans
    `scan` and launches K1 and K3-K5, each host query plans where the
    routing puts it with its RuntimeWarning (per-key host clones for the
    `e[last-2]` selector, the `group by` aggregate and the range
    partition, the host matcher for `output every 5 events`), and every
    query's rows equal the CPU run's."""
    from siddhi_tpu_torch.replay import (MIXED, MIXED_QUERIES,
                                         mixed_placement, run_mixed)
    tape = make_tape(2 * 4096, 4096, 1000, seed=46)
    reset_launches()
    got, _ms, rt, warned = run_mixed(MIXED, tape, "cuda")
    launches = dict(LAUNCHES)
    assert mixed_placement(rt) == {"dev": "device:scan", "last2": "clones",
                                   "agg": "clones", "rate": "host",
                                   "range": "clones"}
    assert sorted(w.split(" runs on ")[0] for w in warned) == [
        "query 'agg'", "query 'last2'", "query 'range'", "query 'rate'"]
    for k in ("seg_tree", "scan_chase", "scan_compact", "expr_eval:pre_mask"):
        assert launches.get(k, 0) > 0, launches
    assert not launches.get("nfa_block", 0)
    want, _ms, _rt, _w = run_mixed(MIXED, tape, "cpu")
    for q in MIXED_QUERIES:
        assert sorted(got[q]) == sorted(want[q]) and got[q], q
