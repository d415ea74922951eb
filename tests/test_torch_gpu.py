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
                                     C3SD, C3X, C4A_BODY, C4D, C4F, C4F_BODY,
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
    windows) and at 1025 (five), and within the rounding bound of the
    plain version's sums (2 (i + 1) 2^-53 sum|v| at entry i)."""
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
    want = win_scan_plain(cols, n, valid)
    bound = 2 * torch.arange(1, n + 1) * 2.0 ** -53 * torch.cumsum(
        torch.where(valid, v.abs(), torch.zeros_like(v)), 0)
    assert bool(((first[0] - want[0]).abs() <= bound).all())
    _same_scans(first[1:], want[1:])


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
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=cuda)
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
              groups=(ks, seg, rank) if grouped else None, valid=sv)
    before = LAUNCHES["win_range"]
    got, sk = win_range(sites, **kw)
    want, sp_ = win_range_plain(sites, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["win_range"] == before + 1
    assert torch.equal(sk, sp_)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("n,T", [(5, 8), (1000, 1024), (131_072, 131_072),
                                 (100_000, 131_072)])
@pytest.mark.parametrize("masked", [False, True])
def test_win_compact_kernel_matches_plain(cuda, n, T, masked):
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    from siddhi_tpu_torch.kernels.win_compact import (win_compact,
                                                      win_compact_plain)
    x = _win_inputs(cuda, n, 5)
    mask = pack_mask(torch.from_numpy(x["rng"].random(n) < 0.4).to(cuda)) \
        if masked else None
    cols = [x["clock"], x["f32n"], x["i32"], x["valid"]]
    fills = [2 ** 62, 0, 0, 0]
    before = LAUNCHES["win_compact"]
    (got, k), (want, kp) = (win_compact(cols, fills, n, T, mask),
                            win_compact_plain(cols, fills, n, T, mask))
    torch.cuda.synchronize()
    assert LAUNCHES["win_compact"] == before + 1
    assert torch.equal(k, kp)
    for a, b in zip(got, want):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


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
