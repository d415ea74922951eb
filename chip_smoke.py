#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (siddhi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit);
  2. build every kernel from siddhi_tpu_torch/csrc (one nvcc per source,
     all at once), timed;
  3. K1 expr_eval vs its plain version at N = 2^18 rows: C1's filter,
     integer arithmetic with truncating / and %, string equality,
     and/or/not, float32-mode arithmetic -- masks and columns equal;
  4. the main path, BASELINE config 4 (partitioned 3-step pattern) at
     default settings, which run the `scan` family: 4 flushes of 2^18
     events over 1000 keys through SiddhiManager(device="cuda")
     send_batch, with the launch counts set to 0 just before and read
     just after (K3, K4, K5 and K1 launched, K2 not); every block the
     plan hands ParallelChainKernel.run_block is recorded.  The same tape
     through device="cpu" (the plain versions) must give equal rows;
     events/s and ms per flush;
  5. K3 seg_tree, K4 scan_chase, K5 scan_compact and K1 (pre-masks,
     selector) against their plain versions on the recorded blocks:
     heaps, chase status and indices, match tables equal;
  6. config 3 unpartitioned (bench.py's C3 text): 2 flushes of 2^18
     events through the flat `scan` block (a 2^19-leaf tree), counted,
     recorded, checked against the CPU run and phase 5's comparisons;
  7. config 4 with @app:patternFamily('seq') (the K2 path): 2 flushes,
     counted, checked against the CPU run, and K2 and K1 against their
     plain versions on its recorded blocks: new state, sorted match rows,
     masks and selector columns equal;
  8. config 1 (filter) at 2^20 events, run and checked the same way, and
     K1 on its filter program against the plain version;
  9. config 5 (bench.py's c5_app(1000): 1000 mixed pattern/sequence
     queries with `not ... for` and `within`, four fused plans of 250
     lanes, families scan/seq/seq/scan): 4 flushes of 2^13 events 50 ms
     apart, then set_time 1 s past the last event, counted (K1-K5 all
     launched) and checked against the CPU run; a second run of the same
     app on the tape's first events leaves deadlines pending for
     set_time's timer ticks; K1-K5 against their plain versions on every
     block both runs recorded (K2 blocks with fired deadlines and tick
     blocks required); ms per flush, events/s and query-events/s;
 10. config 2 (bench.py's C2: `#window.length(1000) select avg(price)`),
     2 flushes of 2^17 events over 8 symbols, counted (K1 `window_args`
     and `window_select`, K6 win_scan, K7 win_range, K8 win_compact) and
     recorded (every kernel call of the window plan, through its `record`
     hook), rows equal to the CPU run and `ap` equal to the exact f64
     sliding mean rounded to f32; every recorded call of K1, K6-K8 equal
     to its plain version; then a timing run, not recorded, of 8 flushes:
     the median ms of its 7 steady flushes and events/s from it;
 11. the grouped, filtered `time(10 sec)` window with min/max/avg/count
     and `having` (its carry grows from 1024 slots through the overflow
     retry), checked the same way;
 12. C2B (bench.py: `externalTimeBatch(et, 64)` grouped, et = arrival
     time), the tumbling path (K6 segmented, no K7), checked the same way;
 13. one JSON line {"kernels": [...]}, one entry per kernel and K1 use:
     launches on its path, error against the plain version, device time
     (a CUDA graph of 20 calls replayed, so the wrappers' host dispatch
     is not in it; that is `dispatch_ms`), plain time, bound and,
     where one PyTorch call computes the same function, that call's
     time; the card's name and power limit; then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Every comparison has tolerance 0: the kernels are built with --fmad=false
and compute what the plain versions compute.
Exits non-zero without a CUDA card, or when the package is not beside it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

STOCK = "define stream StockStream (symbol string, price double, volume int);\n"
C1 = STOCK + ("@info(name='q') from StockStream[price > 100] "
              "select * insert into Out;\n")
C4 = STOCK + """
partition with (symbol of StockStream)
begin
  @info(name='q')
  from every e1=StockStream[price > 100] -> e2=StockStream[price > e1.price]
    -> e3=StockStream[price > e2.price] within 10 sec
  select e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;
end;
"""
C4_HEAD = "@app:partitionCapacity(1000)\n@app:deviceSlots(32)\n"
C4_SEQ = "@app:patternFamily('seq')\n"
C3 = STOCK + ("@info(name='q') from every e1=StockStream[price > 100] -> "
              "e2=StockStream[price > e1.price] within 1 sec "
              "select e1.price as p1, e2.price as p2 insert into Out;\n")
C2 = STOCK + ("@info(name='q') from StockStream#window.length(1000) "
              "select avg(price) as ap insert into Out;\n")
C2_GROUPED = STOCK + (
    "@info(name='q') from StockStream[volume > 100]#window.time(10 sec) "
    "select symbol, min(price) as lo, max(price) as hi, avg(price) as ap, "
    "count() as n group by symbol having n > 10 insert into Out;\n")
C2B = ("define stream StockStream (symbol string, price double, volume int, "
       "et long);\n@info(name='q') from StockStream"
       "#window.externalTimeBatch(et, 64) select symbol, sum(price) as sp, "
       "count() as c group by symbol insert into Out;\n")
C2_FLUSH, C2_FLUSHES, C2_SYMBOLS = 1 << 17, 2, 8
C2_TIMED = 8            # flushes of the timing run (the first is not steady)
KEYS, FLUSH, N_FLUSH, C1_EVENTS = 1000, 1 << 18, 4, 1 << 20
SEQ_FLUSHES, C3_FLUSHES = 2, 2
C5_QUERIES, C5_FLUSH, C5_FLUSHES, C5_DT, C5_SYMBOLS = 1000, 1 << 13, 4, 50, 8


def c5_app(n_queries=1000):
    """bench.py:226-266 (BASELINE config 5), copied: 1k concurrent mixed
    pattern/sequence queries with `not`/`within` over one shared input
    stream, under @app:playback."""
    parts = ["@app:playback\n" + STOCK]   # historical tape: event-time
    for i in range(n_queries):            # deadlines fire in-scan, not via
        lo = 123 + (i % 6)                # the wall-clock pump
        shape = i % 4
        if shape == 0:
            parts.append(
                f"@info(name='q{i}') from every e1=StockStream[price > {lo}] -> "
                f"e2=StockStream[price > e1.price] within 1 sec "
                f"select e1.price as p1, e2.price as p2 insert into Out{i % 16};")
        elif shape == 1:
            parts.append(
                f"@info(name='q{i}') from e1=StockStream[price > {lo}], "
                f"e2=StockStream[price > e1.price] "
                f"select e1.price as p1, e2.price as p2 insert into Out{i % 16};")
        elif shape == 2:
            parts.append(
                f"@info(name='q{i}') from e1=StockStream[price > {lo + 1}] -> "
                f"not StockStream[price < {lo - 30}] for 500 milliseconds "
                f"select e1.price as p1 insert into Out{i % 16};")
        else:
            parts.append(
                f"@info(name='q{i}') from every e1=StockStream[price > {lo}] -> "
                f"e2=StockStream[price > e1.price] -> "
                f"e3=StockStream[price > e2.price] within 2 sec "
                f"select e1.price as p1, e3.price as p3 insert into Out{i % 16};")
    return "\n".join(parts) + "\n"
K1_SRC = "siddhi_tpu_torch/csrc/expr_eval.cu"
CSRC = "siddhi_tpu_torch/csrc"
PAR = "siddhi_tpu/core/nfa_parallel.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def make_tape(np, n_events: int, batch: int, keys: int, seed: int = 0,
              dt_ms: int = 1):
    """The benchmark tape shape: uniform keys, prices on the quarter grid
    (exact in float32), volumes, dt_ms apart, one dict per flush."""
    rng = np.random.default_rng(seed)
    tape = []
    ts0 = 1_700_000_000_000
    for start in range(0, n_events, batch):
        n = min(batch, n_events - start)
        tape.append({
            "sym_idx": rng.integers(0, keys, size=n).astype(np.int32),
            "price": np.round(rng.uniform(90.0, 130.0, size=n) * 4) / 4,
            "volume": rng.integers(1, 1000, size=n).astype(np.int32),
            "ts": ts0 + np.arange(start, start + n, dtype=np.int64) * dt_ms})
    return tape


def graph_ms(torch, call, prepare, reps: int = 20) -> tuple:
    """(device ms, host dispatch ms) per call of the wrapper `call`.  The
    device time replays `reps` rounds of the launches `prepare()` returns
    (the wrapper's kernel launches, their parameter tables uploaded
    beforehand: a graph cannot capture that copy) captured in one CUDA
    graph and timed with CUDA events, so the wrapper's Python, ctypes and
    table upload are not in it.  The host dispatch time is the wall clock
    of `reps` eager calls with no synchronisation inside."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    launches = prepare()
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for launch in launches:
                launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def event_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per eager call of `fn` between CUDA events, for a call
    that synchronises inside (and so cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it) on the H100: bytes over HBM, operations
    over the float32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def k1_work(torch, cols, mask_prog, out_progs, n: int, rows=None) -> tuple:
    """(bytes, operations) K1 needs for rows [0, n): each column element a
    program loads read once (a broadcast or shared column once, not once
    per lane), each lane parameter once, each output and the mask words
    written once, one operation per row for each VM instruction other
    than a load, a parameter or a constant."""
    from siddhi_tpu_torch.core.expr import TORCH_OF_VT, decode_word
    loaded, qparams, ops = set(), False, 0
    for prog in [p for p in (mask_prog, *out_progs) if p is not None]:
        for j in range(0, len(prog.words), 2):
            op = decode_word(prog.words[j])[0]
            if op == "load":
                loaded.add(prog.words[j + 1])
            elif op == "qparam":
                qparams = True
            elif op != "const":
                ops += n
    elems = n
    if rows is not None and (rows.col_mod or rows.col_div > 1):
        elems = rows.col_mod or -(-n // rows.col_div)
    nbytes = sum(elems * cols[s].element_size() for s in loaded)
    if qparams and rows is not None and rows.qparams is not None:
        nbytes += rows.qparams.bits.numel() * 8
    nbytes += sum(n * torch.empty(0, dtype=TORCH_OF_VT[p.vt]).element_size()
                  for p in out_progs)
    if mask_prog is not None:
        nbytes += -(-n // 32) * 4
    return nbytes, ops


def phase_k1(torch, np, n: int) -> float:
    """K1 against its plain version over seeded columns with edge values;
    returns the largest difference of a computed column (0 when equal)."""
    from siddhi_tpu_torch.core.expr import (F32_MODE, SingleStreamContext,
                                            compile_expression,
                                            compute_dtypes, emit_program)
    from siddhi_tpu_torch.core.schema import StreamSchema, StringTable
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval,
                                                    expr_eval_plain)
    from siddhi_tpu_torch.query import ast, parse_expression
    rng = np.random.default_rng(1)
    T = ast.AttrType
    schema = StreamSchema("S", (ast.Attribute("symbol", T.STRING),
                                ast.Attribute("price", T.DOUBLE),
                                ast.Attribute("volume", T.INT),
                                ast.Attribute("big", T.LONG),
                                ast.Attribute("ratio", T.FLOAT),
                                ast.Attribute("flag", T.BOOL)))
    strings = StringTable()
    for i in range(16):
        strings.encode(f"K{i}")
    host = {"symbol": rng.integers(1, 17, n).astype(np.int32),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "volume": rng.integers(-1000, 1000, n).astype(np.int32),
            "big": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "ratio": rng.uniform(-3, 3, n).astype(np.float32),
            "flag": rng.integers(0, 2, n).astype(bool)}
    host["volume"][::97] = 0                    # divisors of zero
    host["big"][::89] = -1
    host["big"][0] = -2**63
    keys = sorted(host)
    cols = [torch.from_numpy(host[k]).cuda() for k in keys]
    ctx = SingleStreamContext(schema, strings)

    def prog(text, f32=False):
        ce = compile_expression(parse_expression(text), ctx)
        with compute_dtypes(F32_MODE if f32 else None):
            slots = {k: (i, {"symbol": 1, "price": 4, "volume": 1,
                             "big": 2, "ratio": 3, "flag": 0}[k])
                     for i, k in enumerate(keys)}
            return emit_program(ce.node, slots)
    cases = [
        ("price > 100", []),
        ("(price > 110 and volume < 500) or not (symbol != 'K7') or flag",
         ["volume / 7 + volume % 5 * 3", "big / volume - big % 3",
          "price * 2.5 - volume / 3.0", "ifThenElse(flag, big, volume)",
          "maximum(ratio, price)", "convert(price, 'int')"]),
        ("symbol == 'K3'", ["ratio * ratio + ratio"]),
    ]
    f32_outs = [prog("price * 2.5 - ratio / 3.0 + volume", f32=True),
                prog("ratio * 1.5 + price", f32=True)]
    err = 0.0
    for mask_text, out_texts in cases:
        mask_p = prog(mask_text)
        outs_p = [prog(t) for t in out_texts] + f32_outs
        w_k, o_k = expr_eval(cols, mask_p, outs_p, n, use="filter")
        w_p, o_p = expr_eval_plain(cols, mask_p, outs_p, n)
        torch.cuda.synchronize()
        if not torch.equal(w_k, w_p):
            raise SystemExit(f"K1 mask mismatch for {mask_text!r}")
        for t, a, b in zip(out_texts + ["f32a", "f32b"], o_k, o_p):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise SystemExit(f"K1 output mismatch for {t!r}")
            if a.dtype != torch.bool:
                err = max(err, float((a.double() - b.double()).abs().max()))
        log(f"  K1 {mask_text!r} + {len(outs_p)} outputs: equal")
    return err


def run_app(pkg, np, app: str, tape, keys: int, device: str, stream="Out"):
    """Feed the tape flush by flush through the public facade; matches
    arrive as columnar batches (the bench's way: no per-row decode inside
    the timed region) and are decoded to rows afterwards."""
    mgr = pkg.SiddhiManager(device=device)
    rt = mgr.create_app_runtime(app)
    batches = []
    rt.add_batch_callback(stream, batches.append)
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    per_flush = []
    for f in tape:
        t0 = time.perf_counter()
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
    out = [(int(t), row) for b in batches
           for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return out, per_flush, rt


def run_seq_path(pkg, np, tape) -> tuple:
    """Phase 7: C4 on the `seq` family through the facade on the card,
    launch counts from 0; returns (rows, ms per flush, launches, runtime,
    recorded blocks).  A recorded block is (kernel, state in, event grid,
    M, meta) exactly as the plan called `NFAKernel.run_block`; recording
    launches nothing."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    blocks = []
    run_block = NFAKernel.run_block

    def recording(kern, state, ev, M):
        new, out = run_block(kern, state, ev, M)
        blocks.append((kern, state, ev, M, out["meta"]))
        return new, out
    NFAKernel.run_block = recording
    kernels.reset_launches()
    rows, per_flush, rt = run_app(pkg, np, C4_SEQ + C4_HEAD + C4, tape,
                                  KEYS, "cuda")
    launches = dict(kernels.LAUNCHES)
    NFAKernel.run_block = run_block
    return rows, per_flush, launches, rt, blocks


def run_scan_path(pkg, np, app: str, tape) -> tuple:
    """Phases 4 and 6: an app on its default (`scan`) family through the
    facade on the card, launch counts from 0; returns (rows, ms per
    flush, launches, runtime, recorded blocks).  A recorded block is
    (kernel, event grid, M) exactly as the plan called
    `ParallelChainKernel.run_block`; recording launches nothing."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    blocks = []
    run_block = ParallelChainKernel.run_block

    def recording(kern, ev, M):
        blocks.append((kern, ev, M))
        return run_block(kern, ev, M)
    ParallelChainKernel.run_block = recording
    kernels.reset_launches()
    rows, per_flush, rt = run_app(pkg, np, app, tape, KEYS, "cuda")
    launches = dict(kernels.LAUNCHES)
    ParallelChainKernel.run_block = run_block
    if rt.plans()[0].family != "scan":
        raise SystemExit(f"expected the scan family, got "
                         f"{rt.plans()[0].family}")
    return rows, per_flush, launches, rt, blocks


def run_c5(pkg, np, tape, device: str, record: bool = False):
    """Config 5 through the facade: the tape flush by flush, then
    `set_time` 1 s past its last event, launch counts from 0 just before
    the first flush and read just after `set_time`.  Returns (rows as
    (stream, ts, row) in arrival order, ms per flush, set_time ms,
    launches, runtime, recorded `seq` blocks, recorded `scan` blocks); a
    recorded block is what the plan handed NFAKernel.run_block (kernel,
    state in, event grid, M, meta) or ParallelChainKernel.run_block
    (kernel, event grid, M), recording launching nothing."""
    import torch
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    seq_blocks, scan_blocks = [], []
    run_seq, run_scan = NFAKernel.run_block, ParallelChainKernel.run_block

    def rec_seq(kern, state, ev, M):
        new, out = run_seq(kern, state, ev, M)
        seq_blocks.append((kern, state, ev, M, out["meta"]))
        return new, out

    def rec_scan(kern, ev, M):
        scan_blocks.append((kern, ev, M))
        return run_scan(kern, ev, M)
    if record:
        NFAKernel.run_block, ParallelChainKernel.run_block = rec_seq, rec_scan
    try:
        rt = pkg.SiddhiManager(device=device).create_app_runtime(
            c5_app(C5_QUERIES))
        batches = []
        for j in range(16):
            rt.add_batch_callback(f"Out{j}",
                                  lambda b, j=j: batches.append((j, b)))
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}")
                          for i in range(C5_SYMBOLS)], dtype=np.int32)

        def sync():
            if device == "cuda":
                torch.cuda.synchronize()
        kernels.reset_launches()
        per_flush = []
        for f in tape:
            t0 = time.perf_counter()
            h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                          "volume": f["volume"]}, f["ts"])
            rt.flush()
            sync()
            per_flush.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rt.set_time(int(tape[-1]["ts"][-1]) + 1000)
        sync()
        set_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
    finally:
        NFAKernel.run_block, ParallelChainKernel.run_block = run_seq, run_scan
    rows = [(j, int(t), row) for j, b in batches
            for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return rows, per_flush, set_ms, launches, rt, seq_blocks, scan_blocks


def check_c5_rows(label: str, dev_out: list, ref_out: list) -> None:
    """Equal to the CPU run, stream by stream in arrival order, and true
    to each shape (stream j carries queries of shape j % 4)."""
    if dev_out != ref_out or not dev_out:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(dev_out)} vs {len(ref_out)}")
    for j, _ts, row in dev_out:
        ok = row[0] > 124 if j % 4 == 2 else (row[0] > 123 and
                                             row[1] > row[0])
        if not ok:
            raise SystemExit(f"{label} row of Out{j} breaks its pattern: "
                             f"{row}")


def phase_c5(torch, np, pkg) -> dict:
    """Config 5 at 1000 queries (four fused plans of 250 lanes) on the
    card and on the CPU, then every kernel against its plain version on
    the blocks the card run recorded.  The tape resolves every one-shot
    `not ... for` lane within its first seconds, so the final `set_time`
    finds no deadline left; the timer-tick blocks come from the same app
    on the tape's first events up to the first such lane's arming, one
    flush and a `set_time` (its rows, too, equal the CPU run's)."""
    tape = make_tape(np, C5_FLUSH * C5_FLUSHES, C5_FLUSH, C5_SYMBOLS,
                     seed=5, dt_ms=C5_DT)
    rows, per_flush, set_ms, launches, rt, seq_b, scan_b = run_c5(
        pkg, np, tape, "cuda", record=True)
    plans = rt.plans()
    fams = [getattr(p, "family", None) for p in plans]
    if [getattr(p, "n_queries", 0) for p in plans] != [250] * 4 or \
            fams != ["scan", "seq", "seq", "scan"]:
        raise SystemExit(f"C5 planned {[(p.name, f) for p, f in zip(plans, fams)]}")
    need_launches("C5", launches, ("expr_eval:pre_mask", "expr_eval:select",
                                   "nfa_block", "seg_tree", "scan_chase",
                                   "scan_compact"))
    ref, cpu_flush, _s, _l, _rt, _b, _c = run_c5(pkg, np, tape, "cpu")
    check_c5_rows("C5", rows, ref)
    steady = per_flush[1:]
    eps = C5_FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c5] {len(rows)} rows equal to the CPU run; families {fams}; "
        f"launches {launches}; per flush ms "
        f"{[round(x, 1) for x in per_flush]}, set_time {set_ms:.1f} ms (cpu "
        f"{[round(x) for x in cpu_flush]})")
    log(f"[c5] {eps:.0f} events/s, {eps * C5_QUERIES:.0f} query-events/s "
        f"over the {len(steady)} steady flushes of {C5_FLUSH} events")

    # the tick run: first lane of shape 2 arms on the first price > 124
    first = int(np.flatnonzero(tape[0]["price"] > 124)[0]) + 1
    prefix = [{k: v[:first] for k, v in tape[0].items()}]
    t_rows, _f, _s, _l, _rt, t_seq, _t = run_c5(pkg, np, prefix, "cuda",
                                                record=True)
    t_ref = run_c5(pkg, np, prefix, "cpu")[0]
    check_c5_rows("C5 tick run", t_rows, t_ref)
    log(f"[c5 ticks] {first} events, then set_time: {len(t_rows)} rows "
        f"equal to the CPU run")

    # K2 is timed on the last block: the absent group's widest
    blocks = sorted(seq_b + t_seq, key=lambda b: (b[0].has_absent,
                                                  b[2]["__ts__"].shape[0]))
    k2 = phase_blocks(torch, blocks, "c5 seq")
    if not k2["fired_blocks"] or not k2["tick_blocks"]:
        raise SystemExit(f"C5 K2 blocks: {k2['fired_blocks']} with fired "
                         f"deadlines, {k2['tick_blocks']} ticks")
    scan = phase_scan_blocks(torch, scan_b, "c5")
    return {"rows": len(rows), "ms_per_flush": per_flush,
            "set_time_ms": set_ms, "cpu_ms_per_flush": cpu_flush,
            "events_per_s": eps, "query_events_per_s": eps * C5_QUERIES,
            "launches": launches, "k2": k2, "scan": scan,
            "tick_rows": len(t_rows)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def distinct(*tensors) -> list:
    """The tensors without repeats (by address): a column that reaches a
    kernel through two arguments is read once."""
    seen: set = set()
    out = []
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append(t)
    return out


def max_err(torch, a, b) -> float:
    """Largest |a - b| over the entries finite in both (0 when none)."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0


def phase_scan_blocks(torch, blocks, label: str) -> dict:
    """Phase 5: K3, K4, K5 and K1 against their plain versions on every
    block a `scan` run recorded, each kernel on the same inputs as its
    plain version; the last block is timed."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import scan_compact as k5
    from siddhi_tpu_torch.kernels import seg_tree as k3
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval_plain
    from siddhi_tpu_torch.kernels.scan_chase import (scan_chase,
                                                     scan_chase_plain)
    from siddhi_tpu_torch.kernels.scan_compact import (scan_compact,
                                                       scan_compact_plain)
    from siddhi_tpu_torch.kernels.seg_tree import (node_masks, seg_tree,
                                                   seg_tree_plain)
    err = {"seg_tree": 0.0, "scan_chase": 0.0, "scan_compact": 0.0,
           "pre_mask": 0.0, "select": 0.0}
    for b, (kern, ev, M) in enumerate(blocks):
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        params = {"__base_ts__": ev["__base_ts__"]}
        pre = kern.pre_masks(ev)
        cols = kern.pre_mask_cols(ev)
        rows = kern.pre_mask_rows(ev)
        for w, pr in zip(pre, kern.nfak.pre_progs):
            if pr is not None and not torch.equal(
                    w, expr_eval_plain(cols, pr, [], L * F, params,
                                       rows)[0]):
                raise SystemExit(f"[{label}] K1 pre-mask differs (block {b})")
        masks = node_masks(kern, ev, pre)
        hk, hp = seg_tree(kern, ev, pre), seg_tree_plain(kern, ev, masks)
        for a, c in zip(hk, hp):
            if a.dtype != c.dtype or not torch.equal(a, c):
                raise SystemExit(f"[{label}] K3 heap differs (block {b})")
            err["seg_tree"] = max(err["seg_tree"], max_err(torch, a, c))
        sk, ik = scan_chase(kern, ev, pre, hp)
        sp, ip = scan_chase_plain(kern, ev, masks, hp)
        if not (torch.equal(sk, sp) and torch.equal(ik, ip)):
            raise SystemExit(f"[{label}] K4 status/indices differ (block "
                             f"{b})")
        err["scan_chase"] = max(err["scan_chase"], max_err(torch, ik, ip))
        ok = scan_compact(kern, ev, sp, ip, M)
        op = scan_compact_plain(kern, ev, sp, ip, M)
        torch.cuda.synchronize()
        n = int(op["meta"][0])
        for key in ("meta", "lane_n", "arm"):
            if not torch.equal(ok[key], op[key]):
                raise SystemExit(f"[{label}] K5 {key} differs (block {b})")
        for key in ("out_i", "out_f", "out_l"):
            if not torch.equal(ok[key][:, :n], op[key][:, :n]):
                raise SystemExit(f"[{label}] K5 {key} differs (block {b})")
            if n and ok[key].shape[0]:
                err["scan_compact"] = max(err["scan_compact"], max_err(
                    torch, ok[key][:, :n], op[key][:, :n]))
        nfak = kern.nfak
        hw, sel = nfak.select(ok, n, ev["__base_ts__"])
        hp_, selp = expr_eval_plain(nfak.select_cols(ok), nfak.having_prog,
                                    nfak.sel_progs, n, params,
                                    nfak.select_rows(ok))
        if (hw is None) != (hp_ is None) or (hw is not None and not
                                             torch.equal(hw, hp_)) or \
                not all(torch.equal(a, c) for a, c in zip(sel, selp)):
            raise SystemExit(f"[{label}] K1 selector differs (block {b})")
        for a, c in zip(sel, selp):
            if n and a.dtype != torch.bool:
                err["select"] = max(err["select"], max_err(torch, a, c))
        log(f"  [{label}] block {b}: L={L} F={F} trees={len(hk)} "
            f"matches={n}: K3 heaps, K4 chase, K5 table, K1 pre-masks and "
            f"selector equal to their plain versions")

    kern, ev, M = blocks[-1]
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    Lt = kern.leaves(F)
    params = {"__base_ts__": ev["__base_ts__"]}
    pre = kern.pre_masks(ev)
    masks = node_masks(kern, ev, pre)
    heaps = seg_tree(kern, ev, pre)
    alive: list = []
    status, idx = scan_chase_plain(kern, ev, masks, heaps, alive)
    out = scan_compact(kern, ev, status, idx, M)
    n = int(out["meta"][0])
    res = {"L": L, "F": F, "Lt": Lt, "M": M, "matches": n,
           "blocks": len(blocks), "err": err, "alive": alive}
    pre_used = [w for w in pre if w is not None]
    # K3: leaf columns, masks and lane counts read once, every heap
    # written once; one compare per internal node
    srcs = {t.src for t in kern.trees if t.src is not None}
    k3_bytes = nbytes(ev["__nev__"], *[ev[c] for c in srcs], *pre_used,
                      *heaps)
    k3_ops = len(heaps) * L * Lt
    ms, host = graph_ms(torch, lambda: seg_tree(kern, ev, pre),
                        lambda: [k3.prepare(kern, ev, pre)])
    res["seg_tree"] = {"ms": ms, "dispatch_ms": host, "bytes": k3_bytes,
                       "ops": k3_ops, "library_ms": None,
                       "plain_ms": wall_ms(torch, lambda: seg_tree_plain(
                           kern, ev, masks))}
    # K4: grids, masks, VM columns and the heaps read once, status and
    # indices written once; per head still alive at a hop, two descents
    # (the killer's and the hop's) of 2 log2(Lt) compares each
    vm_cols = {key for key, _pos in kern.loads}
    k4_bytes = nbytes(ev["__flat.__ts__"], ev["__nev__"],
                      *[ev[c] for c in vm_cols], *pre_used, *heaps,
                      status, idx)
    k4_ops = sum(alive) * 4 * max(Lt.bit_length() - 1, 1)
    ms, host = graph_ms(torch, lambda: scan_chase(kern, ev, pre, heaps),
                        lambda: [k4.prepare(kern, ev, pre, heaps)])
    res["scan_chase"] = {"ms": ms, "dispatch_ms": host, "bytes": k4_bytes,
                         "ops": k4_ops, "library_ms": None,
                         "plain_ms": wall_ms(torch, lambda: scan_chase_plain(
                             kern, ev, masks, heaps))}
    # K5: status, indices, seq/ts grids, the captured columns and the
    # lanes' dedup seqs read once, the n match rows written once; the
    # library yardstick is torch.nonzero of the candidate mask
    row_cols = {src[1] for srcs_ in kern.rows.values() for src in srcs_
                if src[0] == "col"}
    k5_bytes = nbytes(status, idx, ev["__flat.__seq__"], ev["__flat.__ts__"],
                      ev["__prev_seq__"], *[ev[c] for c in row_cols])
    k5_bytes += n * (4 * out["out_i"].shape[0] + 4 * out["out_f"].shape[0] +
                     8 * out["out_l"].shape[0]) + 8 + 8 * L
    k5_ops = L * F
    cand = (status & 1).view(-1).bool()
    lib_ms = event_ms(torch, lambda: torch.nonzero(cand))
    ms, host = graph_ms(torch, lambda: scan_compact(kern, ev, status, idx,
                                                    M),
                        lambda: [k5.prepare(kern, ev, status, idx, M)])
    res["scan_compact"] = {"ms": ms, "dispatch_ms": host, "bytes": k5_bytes,
                           "ops": k5_ops, "library_ms": lib_ms,
                           "plain_ms": wall_ms(torch, lambda:
                                               scan_compact_plain(
                                                   kern, ev, status, idx,
                                                   M))}
    # K1 on the scan block: pre-masks over the (L*F,) grid, selector
    # over the match table
    cols = kern.pre_mask_cols(ev)
    rows = kern.pre_mask_rows(ev)
    progs = [p for p in kern.nfak.pre_progs if p is not None]
    nb = ops = 0
    for prog in progs:
        b_, o_ = k1_work(torch, cols, prog, [], L * F, rows)
        nb, ops = nb + b_, ops + o_
    ms, host = graph_ms(torch, lambda: kern.pre_masks(ev), lambda: [
        k1.prepare(cols, p, [], L * F, params, use="pre_mask", rows=rows)
        for p in progs])
    res["pre_mask"] = {
        "ms": ms / len(progs), "dispatch_ms": host / len(progs),
        "plain_ms": wall_ms(torch, lambda: [
            expr_eval_plain(cols, p, [], L * F, params, rows)
            for p in progs]) / len(progs),
        "bytes": nb / len(progs), "ops": ops / len(progs),
        "library_ms": None}
    nfak = kern.nfak
    sel_cols = nfak.select_cols(out)
    sel_rows = nfak.select_rows(out)
    nb, ops = k1_work(torch, sel_cols, nfak.having_prog, nfak.sel_progs, n,
                      sel_rows)
    ms, host = graph_ms(torch, lambda: nfak.select(out, n,
                                                   ev["__base_ts__"]),
                        lambda: [k1.prepare(sel_cols, nfak.having_prog,
                                            nfak.sel_progs, n, params,
                                            use="select", rows=sel_rows)])
    res["select"] = {
        "ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
        "library_ms": None,
        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
            sel_cols, nfak.having_prog, nfak.sel_progs, n, params,
            sel_rows))}
    return res


def sorted_rows(torch, kern, out: dict):
    """The match rows in (completion seq, head seq, lane) order."""
    n = int(out["meta"][0])
    rows = torch.cat([out["out_i"][:, :n].double(),
                      out["out_f"][:, :n].double(),
                      out["out_l"][:, :n].double()])
    order = torch.arange(n, device=rows.device)
    for name in ("__qid__", "__head_seq__", "__comp_seq__"):
        if name in kern.lane_names_i:
            r = rows[kern.lane_names_i.index(name)]
            order = order[torch.argsort(r[order], stable=True)]
    return rows[:, order]


def phase_blocks(torch, blocks, label: str = "c4 seq") -> dict:
    """K2 and K1 against their plain versions on every block a `seq` run
    accepted (an M overflow's first try is re-run by the plan with a
    larger M and is left out), counting the blocks in which absent
    deadlines fired and the timer ticks; K2 is timed on the last block
    that is not a tick (K1 is timed on the `scan` blocks)."""
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval_plain,
                                                    unpack_mask)
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    accepted = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
    if not accepted:
        raise SystemExit(f"[{label}] recorded no accepted block")
    err = {"nfa_block": 0.0, "pre_mask": 0.0, "select": 0.0}
    fired = ticks = 0
    for b, (kern, state, ev, M) in enumerate(accepted):
        T, P = ev["__ts__"].shape[0], kern.P
        params = {"__base_ts__": ev["__base_ts__"]}
        pre = kern.pre_masks(ev)
        pre_cols = kern.pre_mask_cols(ev)
        rows = kern.pre_mask_rows(ev)
        for w, pr in zip(pre, kern.pre_progs):
            if pr is not None and not torch.equal(
                    w, expr_eval_plain(pre_cols, pr, [], T * P, params,
                                       rows)[0]):
                raise SystemExit(f"[{label}] K1 pre-mask differs (block {b})")
        new_k, out_k = nfa_block(kern, state, ev, pre, M)
        masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
                 for w in pre]
        t0 = time.perf_counter()
        new_p, out_p = nfa_block_plain(kern, state, ev, masks, M)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for key in new_k:
            if not torch.equal(new_k[key], new_p[key]):
                raise SystemExit(f"[{label}] K2 state {key!r} differs "
                                 f"(block {b})")
        if not torch.equal(out_k["meta"], out_p["meta"]):
            raise SystemExit(f"[{label}] K2 meta differs: "
                             f"{out_k['meta'].tolist()} vs "
                             f"{out_p['meta'].tolist()}")
        rk, rp = sorted_rows(torch, kern, out_k), sorted_rows(torch, kern,
                                                              out_p)
        if not torch.equal(rk, rp):
            raise SystemExit(f"[{label}] K2 match rows differ (block {b})")
        n = int(out_k["meta"][0])
        if n:
            err["nfa_block"] = max(err["nfa_block"],
                                   float((rk - rp).abs().max()))
        # a chain ending in an absent position completes only when a
        # deadline fires, so each of its matches is a fired deadline
        n_fired = n if kern.spec.positions[-1].node.kind == "absent" else 0
        fired += n_fired > 0
        tick = "__tick__" in ev
        ticks += tick
        sel_cols = kern.select_cols(out_k)
        hw, sel = kern.select(out_k, n, ev["__base_ts__"])
        hp, selp = expr_eval_plain(sel_cols, kern.having_prog,
                                   kern.sel_progs, n, params,
                                   kern.select_rows(out_k))
        if (hw is None) != (hp is None) or (hw is not None and not
                                            torch.equal(hw, hp)) or \
                not all(torch.equal(a, c) for a, c in zip(sel, selp)):
            raise SystemExit(f"[{label}] K1 selector differs (block {b})")
        for a, c in zip(sel, selp):
            if n and a.dtype != torch.bool:
                err["select"] = max(err["select"], float(
                    (a.double() - c.double()).abs().max()))
        log(f"  [{label}] block {b}: T={T} P={P} A={kern.A} M={M} "
            f"matches={n} of_slots={int(out_k['meta'][1])} deadlines fired="
            f"{n_fired}{' (tick)' if tick else ''}: K2 state and rows, K1 "
            f"pre-masks and selector equal to their plain versions")

    timed = [b for b in accepted if "__tick__" not in b[2]] or accepted
    kern, state, ev, M = timed[-1]
    T, P = ev["__ts__"].shape[0], kern.P
    pre = kern.pre_masks(ev)
    out = nfa_block(kern, state, ev, pre, M)[1]
    n = int(out["meta"][0])
    res = {"T": T, "P": P, "A": kern.A, "M": M, "matches": n,
           "blocks": len(accepted), "err": err, "fired_blocks": fired,
           "tick_blocks": ticks}
    # K2: the grids, pre-mask words, state in and out and the match rows,
    # each moved once; one station test per slot and lane for each event
    tensors = [v for v in ev.values() if torch.is_tensor(v)]
    k2_bytes = sum(v.numel() * v.element_size() for v in tensors)
    k2_bytes += sum(w.numel() * 4 for w in pre if w is not None)
    k2_bytes += 2 * sum(v.numel() * v.element_size() for v in state.values())
    k2_bytes += n * (len(kern.lane_names_i) * 4 + len(kern.rows_f) * 4 +
                     len(kern.rows_l) * 8) + 12
    lanes = P if ev["__valid__"].shape[1] == 1 else 1
    k2_ops = int(ev["__valid__"].sum()) * kern.A * lanes
    ms, host = graph_ms(torch, lambda: nfa_block(kern, state, ev, pre, M),
                        lambda: [k2.prepare(kern, state, ev, pre, M)],
                        reps=10)
    res["nfa_block"] = {"ms": ms, "dispatch_ms": host, "plain_ms": plain_ms,
                        "bytes": k2_bytes, "ops": k2_ops, "library_ms": None}
    return res


def phase_c1(torch, np, pkg) -> dict:
    """Phase 8: config 1 through the facade on the card (launch counts
    from 0) and on the CPU, then K1 on the plan's filter program over the
    batch's columns against its plain version."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval, expr_eval_plain
    tape = make_tape(np, C1_EVENTS, C1_EVENTS, KEYS, seed=2)
    kernels.reset_launches()
    rows, ms, rt = run_app(pkg, np, C1, tape, KEYS, "cuda")
    launches = dict(kernels.LAUNCHES)
    ref, _, _ = run_app(pkg, np, C1, tape, KEYS, "cpu")
    if rows != ref or not rows or launches["expr_eval:filter"] == 0:
        raise SystemExit(f"C1 differs or skipped the kernel: {len(rows)} "
                         f"vs {len(ref)}, {launches}")
    plan = rt.plans()[0]
    cols = [torch.from_numpy(np.ascontiguousarray(tape[0][k])).cuda()
            for k in plan._slot_keys]
    n = C1_EVENTS
    args = (cols, plan._mask_prog, plan._out_progs, n)
    wk, ok = expr_eval(*args, use="filter")
    wp, op = expr_eval_plain(*args)
    if not torch.equal(wk, wp) or not all(torch.equal(a, b)
                                          for a, b in zip(ok, op)):
        raise SystemExit("K1 filter differs from its plain version at C1")
    from siddhi_tpu_torch.kernels import expr_eval as k1
    k_ms, host = graph_ms(torch, lambda: expr_eval(*args, use="filter"),
                          lambda: [k1.prepare(*args, use="filter")])
    nbytes, ops = k1_work(torch, cols, plan._mask_prog, plan._out_progs, n)
    log(f"[c1] {len(rows)} rows equal to the CPU run; launches {launches}; "
        f"{ms[0]:.1f} ms for {n} events")
    return {"rows": len(rows), "ms": ms, "events": n, "launches": launches,
            "filter": {"ms": k_ms, "dispatch_ms": host,
                       "plain_ms": wall_ms(torch,
                                           lambda: expr_eval_plain(*args)),
                       "bytes": nbytes, "ops": ops, "library_ms": None}}


def _same(torch, a, b) -> bool:
    """Equal dtype, shape and values, NaN equal to NaN."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and \
            torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


def _flat(res) -> list:
    """A window kernel's result as a flat list of tensors (or None)."""
    if res is None or hasattr(res, "dtype"):
        return [res]
    return [t for r in res for t in _flat(r)]


def check_window_calls(torch, calls, label: str) -> dict:
    """K1 (window uses), K6, K7 and K8 against their plain versions on
    every call a window run recorded, tolerance 0 (NaN equal to NaN);
    returns the largest |kernel - plain| per kernel name or K1 use."""
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval_plain
    from siddhi_tpu_torch.kernels.win_compact import win_compact_plain
    from siddhi_tpu_torch.kernels.win_range import win_range_plain
    from siddhi_tpu_torch.kernels.win_scan import win_scan_plain
    from siddhi_tpu_torch.core.window_device import KERNELS
    plain = {"win_scan": win_scan_plain, "win_range": win_range_plain,
             "win_compact": win_compact_plain}
    err: dict = {}
    for j, (name, a, kw) in enumerate(calls):
        got = KERNELS[name](*a, **kw)
        if name == "expr_eval":
            key = f"expr_eval:{kw['use']}"
            want = expr_eval_plain(*a)
        else:
            key = name
            want = plain[name](*a, **kw)
        torch.cuda.synchronize()
        g, w = _flat(got), _flat(want)
        if len(g) != len(w) or not all(_same(torch, x, y)
                                       for x, y in zip(g, w)):
            raise SystemExit(f"[{label}] {key} differs from its plain "
                             f"version (call {j})")
        e = max([max_err(torch, x, y) for x, y in zip(g, w)
                 if x is not None and x.numel()] or [0.0])
        err[key] = max(err.get(key, 0.0), e)
    log(f"  [{label}] {len(calls)} kernel calls equal to their plain "
        f"versions: {sorted(err)}")
    return err


def window_work(name: str, a: tuple, kw: dict, out) -> tuple:
    """(bytes, operations) of one K6, K7 or K8 call and its result: each
    distinct input read once, each output written once."""
    if name == "win_scan":
        cols, n = a[0], a[1]
        valid, flags = (list(a[2:]) + [kw.get("valid"),
                                       kw.get("flags")])[:2]
        # one combine per column and entry
        nb = nbytes(*distinct(*[v[:n] for _o, v, _m in cols
                                if v is not None], valid, flags), *out)
        return nb, n * len(cols)
    if name == "win_range":
        sites = a[0]
        n, m = kw["n"], kw["m"]
        groups = kw["groups"] or ()
        n_mm = sum(s[0] in ("min", "max") for s in sites)
        # `valid` is read only by the min/max tables' build
        ins = [kw["vcnt"] if kw["kind"] == "length" else kw["clock"],
               *groups, kw["valid"] if n_mm else None]
        for _op, pfx, cnt, vals, _dt in sites:
            ins += [pfx, cnt, vals]
        outs, start_k = out
        # plus the two table rows of each min/max site, read at random as
        # 32-byte sectors
        nb = nbytes(*distinct(*[t[:n] for t in ins if t is not None]),
                    *outs, start_k) + m * n_mm * 2 * 32
        log2n = max(n - 1, 1).bit_length()
        return nb, m * (log2n * (2 if groups else 1) + 2 * len(sites))
    cols, _fills, n = a[:3]
    mask = a[4] if len(a) > 4 else kw.get("mask")
    outs, k = out
    return nbytes(*distinct(*[c[:n] for c in cols], mask), *outs, k), n


def window_kernel_metrics(torch, calls) -> dict:
    """Device, dispatch, plain and library time, bytes and operations of
    each window kernel (and K1 use) on its largest recorded call."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import win_compact as k8
    from siddhi_tpu_torch.kernels import win_range as k7
    from siddhi_tpu_torch.kernels import win_scan as k6
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval_plain,
                                                    unpack_mask)
    from siddhi_tpu_torch.core.window_device import KERNELS
    mods = {"win_scan": k6, "win_range": k7, "win_compact": k8}
    size = {"win_scan": lambda a, kw: a[1],
            "win_range": lambda a, kw: kw["n"],
            "win_compact": lambda a, kw: a[3],
            "expr_eval": lambda a, kw: a[3]}
    best: dict = {}
    for name, a, kw in calls:
        key = f"expr_eval:{kw['use']}" if name == "expr_eval" else name
        if key not in best or size[name](a, kw) >= size[name](*best[key][1:]):
            best[key] = (name, a, kw)
    res = {}
    for key, (name, a, kw) in best.items():
        fn = KERNELS[name]
        if name == "expr_eval":
            cols, mask_p, out_p, n = a
            ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
                k1.prepare(*a, **kw)])
            nb, ops = k1_work(torch, cols, mask_p, out_p, n)
            res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb,
                        "ops": ops, "library_ms": None, "n": n,
                        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
                            *a))}
            continue
        plain = getattr(mods[name], f"{name}_plain")
        ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
            mods[name].prepare(*a, **kw)])
        out = fn(*a, **kw)
        nb, ops = window_work(name, a, kw, out)
        lib = None
        if name == "win_scan":
            f64 = torch.zeros(a[1], dtype=torch.float64, device="cuda")
            lib = event_ms(torch, lambda: torch.cumsum(f64, 0))
        elif name == "win_compact":
            cols, _fills, n = a[:3]
            mask = a[4] if len(a) > 4 else kw.get("mask")
            keep = torch.ones(n, dtype=torch.bool, device="cuda") \
                if mask is None else unpack_mask(mask, n)
            lib = event_ms(torch, lambda: [c.index_select(
                0, torch.nonzero(keep).flatten()) for c in cols])
        res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
                    "library_ms": lib, "n": size[name](a, kw),
                    "plain_ms": wall_ms(torch, lambda: plain(*a, **kw))}
    return res


def phase_window(torch, np, label: str, app: str, seed: int,
                 want_kernels, plan_check=None) -> dict:
    """One window config on the card (launch counts from 0 just before its
    first flush, read just after its last; every kernel call recorded) and
    on the CPU: equal rows (tolerance 0), every kernel of the path
    launched, every recorded call equal to the plain version.  Then a
    timing run on the card, nothing recorded (the recording keeps every
    intermediate tensor alive, so the allocator cannot reuse them): ms per
    flush, the median of its steady flushes and events/s from that median;
    the kernels' times."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import run_window
    tape = make_tape(np, C2_FLUSH * C2_TIMED, C2_FLUSH, C2_SYMBOLS,
                     seed=seed)
    main = tape[:C2_FLUSHES]
    calls: list = []
    kernels.reset_launches()
    rows, per_flush, rt = run_window(app, main, "cuda", calls)
    launches = dict(kernels.LAUNCHES)
    ref, cpu_flush, _rt = run_window(app, main, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    need_launches(label, launches, want_kernels)
    plan = rt.plans()[0]
    if plan_check is not None:
        plan_check(plan, rows, main)
    _none, timed, _rt = run_window(app, tape, "cuda", rows=False)
    steady = sorted(timed[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    eps = C2_FLUSH / (med / 1e3)
    log(f"[{label}] {len(rows)} rows equal to the CPU run; C={plan.C}; "
        f"launches {launches}; recorded run ms per flush "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); timing run ms per flush "
        f"{[round(x, 2) for x in timed]}: median of {len(steady)} steady "
        f"{med:.2f} ms, {eps:.0f} events/s")
    err = check_window_calls(torch, calls, label)
    metrics = window_kernel_metrics(torch, calls)
    return {"rows": len(rows), "recorded_ms_per_flush": per_flush,
            "ms_per_flush": timed, "median_steady_ms": med, "C": plan.C,
            "cpu_ms_per_flush": cpu_flush, "events_per_s": eps,
            "launches": launches, "err": err, "kernels": metrics,
            "calls": len(calls)}


def check_c2_mean(np):
    """Config 2's `ap` against the exact f64 sliding mean of the last 1000
    prices, rounded to f32 (quarter-grid prices: the f64 prefixes are
    exact, and f32 division of exact operands rounds once)."""
    def check(plan, rows, tape):
        p = np.concatenate([f["price"] for f in tape])
        c = np.concatenate([[0.0], np.cumsum(p)])
        i = np.arange(1, len(p) + 1)
        lo = np.maximum(i - 1000, 0)
        mean = (c[i] - c[lo]) / (i - lo)
        ap = np.array([r[0] for _t, r in rows])
        if len(ap) != len(p) or not np.array_equal(
                mean.astype(np.float32), ap.astype(np.float32)):
            raise SystemExit("C2 ap differs from the exact sliding mean")
        log(f"  [c2] {len(ap)} ap values equal to the exact f64 sliding "
            f"mean rounded to f32")
    return check


def kernel_entry(name, source, replaces, launches, err, m) -> dict:
    bound_ms, by = bound(m["bytes"], m["ops"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": m["ms"], "dispatch_ms": m["dispatch_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
            "bound_by": by, "library_ms": m["library_ms"]}


def check_rows(label: str, dev_out: list, ref_out: list) -> None:
    if sorted(dev_out) != sorted(ref_out) or not dev_out:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(dev_out)} vs {len(ref_out)}")
    for _ts, row in dev_out:
        if not (row[0] > 100 and all(b > a for a, b in zip(row, row[1:]))):
            raise SystemExit(f"{label} row breaks the pattern: {row}")


def need_launches(label: str, launches: dict, used, unused=()) -> None:
    if min(launches[k] for k in used) == 0 or \
            any(launches[k] for k in unused):
        raise SystemExit(f"{label}: launches {launches} (expected "
                         f"{list(used)} above 0, {list(unused)} at 0)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import build

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. K1 vs plain over a battery of programs
    t0 = time.perf_counter()
    k1_err = phase_k1(torch, np, 1 << 18)
    log(f"[k1] equal to plain ({time.perf_counter() - t0:.1f} s)")

    # 4. the main path: C4 at default settings (`scan`) on the card, then
    #    the same tape on the CPU
    scan_k = ("seg_tree", "scan_chase", "scan_compact",
              "expr_eval:pre_mask", "expr_eval:select")
    tape = make_tape(np, FLUSH * N_FLUSH, FLUSH, KEYS)
    dev_out, per_flush, c4_launches, rt, blocks = run_scan_path(
        pkg, np, C4_HEAD + C4, tape)
    plan = rt.plans()[0]
    ref_out, cpu_flush, _ = run_app(pkg, np, C4_HEAD + C4, tape, KEYS, "cpu")
    check_rows("C4", dev_out, ref_out)
    need_launches("C4", c4_launches, scan_k, ("nfa_block",))
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c4] {len(dev_out)} matches equal to the CPU run; family "
        f"{plan.family}; launches {c4_launches}; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s "
        f"(blocks={plan.blocks_run})")

    # 5. K3, K4, K5 and K1 vs plain on the main path's own blocks
    t0 = time.perf_counter()
    c4b = phase_scan_blocks(torch, blocks, "c4")
    log(f"[c4 blocks] {c4b['blocks']} blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    del blocks

    # 6. C3 unpartitioned: the flat block
    c3_tape = make_tape(np, FLUSH * C3_FLUSHES, FLUSH, KEYS, seed=3)
    c3_out, c3_flush, c3_launches, _rt, c3_blocks = run_scan_path(
        pkg, np, C3, c3_tape)
    c3_ref, c3_cpu, _ = run_app(pkg, np, C3, c3_tape, KEYS, "cpu")
    check_rows("C3", c3_out, c3_ref)
    need_launches("C3", c3_launches, scan_k, ("nfa_block",))
    c3b = phase_scan_blocks(torch, c3_blocks, "c3")
    log(f"[c3] {len(c3_out)} matches equal to the CPU run; launches "
        f"{c3_launches}; per flush ms {[round(x, 1) for x in c3_flush]} "
        f"(cpu {[round(x) for x in c3_cpu]}); Lt={c3b['Lt']}")
    del c3_blocks

    # 7. C4 on the `seq` family: the K2 path
    seq_tape = tape[:SEQ_FLUSHES]
    seq_out, seq_flush, seq_launches, seq_rt, seq_blocks = run_seq_path(
        pkg, np, seq_tape)
    seq_ref, seq_cpu, _ = run_app(pkg, np, C4_SEQ + C4_HEAD + C4, seq_tape,
                                  KEYS, "cpu")
    check_rows("C4 seq", seq_out, seq_ref)
    need_launches("C4 seq", seq_launches,
                  ("nfa_block", "expr_eval:pre_mask", "expr_eval:select"),
                  ("seg_tree", "scan_chase", "scan_compact"))
    sp = seq_rt.plans()[0]
    log(f"[c4 seq] {len(seq_out)} matches equal to the CPU run; launches "
        f"{seq_launches}; per flush ms {[round(x, 1) for x in seq_flush]} "
        f"(cpu {[round(x) for x in seq_cpu]}) (P={sp.P} A={sp.kernel.A} "
        f"blocks={sp.blocks_run})")
    t0 = time.perf_counter()
    blk = phase_blocks(torch, seq_blocks)
    log(f"[seq blocks] {blk['blocks']} blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    del seq_blocks

    # 8. C1 filter
    c1 = phase_c1(torch, np, pkg)

    # 9. C5: 1000 fused queries, absent deadlines, timer ticks
    t0 = time.perf_counter()
    c5 = phase_c5(torch, np, pkg)
    log(f"[c5 blocks] {c5['k2']['blocks']} K2 blocks ({c5['k2']['fired_blocks']} "
        f"with fired deadlines, {c5['k2']['tick_blocks']} ticks) and "
        f"{c5['scan']['blocks']} scan blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # 10-12. the window configs: C2 (the main path of this slice), the
    #        grouped filtered time window (carry growth), C2B (tumbling)
    win_k = ("expr_eval:window_args", "expr_eval:window_select", "win_scan",
             "win_compact")
    t0 = time.perf_counter()
    c2 = phase_window(torch, np, "c2", C2, 20, win_k + ("win_range",),
                      check_c2_mean(np))

    def grown(plan, _rows, _tape):
        if plan.C <= DeviceWindowAggPlan.C_START:
            raise SystemExit(f"C2 grouped: the carry did not grow ({plan.C})")
    from siddhi_tpu_torch.core.window_device import DeviceWindowAggPlan
    c2g = phase_window(torch, np, "c2 grouped", C2_GROUPED, 21,
                       win_k + ("win_range",), grown)
    c2b = phase_window(torch, np, "c2b", C2B, 22, win_k)
    log(f"[windows] {time.perf_counter() - t0:.1f} s")

    # 13. results
    nfa_dev = "siddhi_tpu/core/nfa_device.py"
    win = "siddhi_tpu/core/window_device.py"

    def werr(key):
        return max(ph["err"].get(key, 0.0) for ph in (c2, c2g, c2b))
    entries = [
        ("expr_eval:filter", K1_SRC, "siddhi_tpu/core/planner.py:301",
         c1["launches"]["expr_eval:filter"], k1_err, c1["filter"]),
        ("expr_eval:pre_mask", K1_SRC, f"{nfa_dev}:1489",
         c4_launches["expr_eval:pre_mask"],
         max(c4b["err"]["pre_mask"], c3b["err"]["pre_mask"]),
         c4b["pre_mask"]),
        ("expr_eval:select", K1_SRC, f"{nfa_dev}:1619",
         c4_launches["expr_eval:select"],
         max(c4b["err"]["select"], c3b["err"]["select"]), c4b["select"]),
        ("nfa_block", f"{CSRC}/nfa_block.cu", f"{nfa_dev}:1486",
         seq_launches["nfa_block"], blk["err"]["nfa_block"],
         blk["nfa_block"]),
        ("seg_tree", f"{CSRC}/seg_tree.cu", f"{PAR}:499",
         c4_launches["seg_tree"],
         max(c4b["err"]["seg_tree"], c3b["err"]["seg_tree"]),
         c4b["seg_tree"]),
        ("scan_chase", f"{CSRC}/scan_chase.cu", f"{PAR}:796",
         c4_launches["scan_chase"],
         max(c4b["err"]["scan_chase"], c3b["err"]["scan_chase"]),
         c4b["scan_chase"]),
        ("scan_compact", f"{CSRC}/scan_compact.cu", f"{PAR}:1056",
         c4_launches["scan_compact"],
         max(c4b["err"]["scan_compact"], c3b["err"]["scan_compact"]),
         c4b["scan_compact"]),
        ("expr_eval:pre_mask (lane params)", K1_SRC, f"{PAR}:685",
         c5["launches"]["expr_eval:pre_mask"],
         max(c5["scan"]["err"]["pre_mask"], c5["k2"]["err"]["pre_mask"]),
         c5["scan"]["pre_mask"]),
        ("nfa_block (absent, broadcast)", f"{CSRC}/nfa_block.cu",
         f"{nfa_dev}:803", c5["launches"]["nfa_block"],
         c5["k2"]["err"]["nfa_block"], c5["k2"]["nfa_block"]),
        ("scan_compact (qid)", f"{CSRC}/scan_compact.cu", f"{PAR}:1146",
         c5["launches"]["scan_compact"], c5["scan"]["err"]["scan_compact"],
         c5["scan"]["scan_compact"]),
        ("expr_eval:window_args", K1_SRC, f"{win}:827",
         c2["launches"]["expr_eval:window_args"],
         werr("expr_eval:window_args"),
         c2["kernels"]["expr_eval:window_args"]),
        ("expr_eval:window_select", K1_SRC, f"{win}:594",
         c2["launches"]["expr_eval:window_select"],
         werr("expr_eval:window_select"),
         c2["kernels"]["expr_eval:window_select"]),
        ("win_scan", f"{CSRC}/win_scan.cu", f"{win}:109",
         c2["launches"]["win_scan"], werr("win_scan"),
         c2["kernels"]["win_scan"]),
        ("win_range", f"{CSRC}/win_range.cu", f"{win}:99",
         c2["launches"]["win_range"], werr("win_range"),
         c2["kernels"]["win_range"]),
        ("win_compact", f"{CSRC}/win_compact.cu", f"{win}:803",
         c2["launches"]["win_compact"], werr("win_compact"),
         c2["kernels"]["win_compact"]),
        ("win_range (grouped)", f"{CSRC}/win_range.cu", f"{win}:148",
         c2g["launches"]["win_range"], werr("win_range"),
         c2g["kernels"]["win_range"]),
        ("win_scan (segmented)", f"{CSRC}/win_scan.cu", f"{win}:163",
         c2b["launches"]["win_scan"], werr("win_scan"),
         c2b["kernels"]["win_scan"])]
    res = {"kernels": [kernel_entry(*e) for e in entries]}
    for e, (*_rest, m) in zip(res["kernels"], entries):
        lib = "" if e["library_ms"] is None else \
            f", library {e['library_ms']:.4f} ms"
        log(f"  {e['name']}: device {e['ms']:.4f} ms, host dispatch "
            f"{m['dispatch_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
            f"bound {e['bound_ms']:.5f} ms ({e['bound_by']}){lib}, "
            f"{e['launches']} launches")
    for label, blk, names in (
            (f"the C3 flat block (Lt={c3b['Lt']})", c3b,
             ("seg_tree", "scan_chase", "scan_compact")),
            (f"a C5 fused block (L={c5['scan']['L']}, F={c5['scan']['F']})",
             c5["scan"], ("seg_tree", "scan_chase", "select")),
            (f"a C5 fused seq block (T={c5['k2']['T']}, P={c5['k2']['P']})",
             c5["k2"], ())):
        for name in names:
            m = blk[name]
            lib = "" if m["library_ms"] is None else \
                f", library {m['library_ms']:.4f} ms"
            log(f"  {name} at {label}: device {m['ms']:.4f} ms, host "
                f"dispatch {m['dispatch_ms']:.4f} ms, plain "
                f"{m['plain_ms']:.3f} ms, bound "
                f"{bound(m['bytes'], m['ops'])[0]:.5f} ms{lib}")
    for label, ph in (("C2 grouped", c2g), ("C2B", c2b)):
        for name, m in sorted(ph["kernels"].items()):
            lib = "" if m["library_ms"] is None else \
                f", library {m['library_ms']:.4f} ms"
            log(f"  {name} at {label} (n={m['n']}): device {m['ms']:.4f} ms, "
                f"host dispatch {m['dispatch_ms']:.4f} ms, plain "
                f"{m['plain_ms']:.3f} ms, bound "
                f"{bound(m['bytes'], m['ops'])[0]:.5f} ms{lib}, "
                f"{ph['launches'].get(name, 0)} launches")
    detail = {"card": smi, "c4": {"events_per_s": eps,
                                  "ms_per_flush": per_flush,
                                  "cpu_ms_per_flush": cpu_flush,
                                  "matches": len(dev_out),
                                  "flush_events": FLUSH,
                                  "launches": c4_launches, "blocks": c4b},
              "c3": {"ms_per_flush": c3_flush, "cpu_ms_per_flush": c3_cpu,
                     "matches": len(c3_out), "launches": c3_launches,
                     "blocks": c3b},
              "c4_seq": {"ms_per_flush": seq_flush,
                         "cpu_ms_per_flush": seq_cpu,
                         "matches": len(seq_out), "launches": seq_launches,
                         "blocks": blk},
              "c1": c1, "c5": c5, "c2": c2, "c2_grouped": c2g, "c2b": c2b}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**res, **detail}, fh, indent=1)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
