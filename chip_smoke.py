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
  4. the main path, BASELINE config 4 (partitioned 3-step pattern): 4
     flushes of 2^18 events over 1000 keys through
     SiddhiManager(device="cuda") send_batch, with the launch counts set
     to 0 just before and read just after; every block the plan hands the
     NFA kernel is recorded.  The same tape through device="cpu" (the
     plain versions) must give equal rows; events/s and ms per flush;
  5. K2 nfa_block and K1 (pre-masks, selector) against their plain
     versions on the recorded blocks: new state, sorted match rows, masks
     and selector columns equal;
  6. config 1 (filter) at 2^20 events, run and checked the same way, and
     K1 on its filter program against the plain version;
  7. one JSON line {"kernels": [...]}, one entry per kernel and K1 use:
     launches on its path, error against the plain version, device time
     (a CUDA graph of 20 calls replayed, so the wrappers' host dispatch
     is not in it; that is printed on its own), plain time and bound;
     the card's name and power limit; then the last line
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
KEYS, FLUSH, N_FLUSH, C1_EVENTS = 1000, 1 << 18, 4, 1 << 20
K1_SRC = "siddhi_tpu_torch/csrc/expr_eval.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def make_tape(np, n_events: int, batch: int, keys: int, seed: int = 0):
    """The benchmark tape shape: uniform keys, prices on the quarter grid
    (exact in float32), volumes, 1 ms apart, one dict per flush."""
    rng = np.random.default_rng(seed)
    tape = []
    ts0 = 1_700_000_000_000
    for start in range(0, n_events, batch):
        n = min(batch, n_events - start)
        tape.append({
            "sym_idx": rng.integers(0, keys, size=n).astype(np.int32),
            "price": np.round(rng.uniform(90.0, 130.0, size=n) * 4) / 4,
            "volume": rng.integers(1, 1000, size=n).astype(np.int32),
            "ts": ts0 + np.arange(start, start + n, dtype=np.int64)})
    return tape


def graph_ms(torch, fn, reps: int = 20) -> tuple:
    """(device ms, host dispatch ms) per call of `fn`.  The device time
    replays `reps` calls captured in one CUDA graph, timed with CUDA
    events, so the wrapper's Python and ctypes work before each launch is
    not in it.  The host dispatch time is the wall clock of `reps` eager
    calls with no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


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


def k1_work(torch, cols, mask_prog, out_progs, n: int) -> tuple:
    """(bytes, operations) K1 needs for rows [0, n): each column a program
    loads read once, each output and the mask words written once, one
    operation per row for each VM instruction other than a load or a
    constant."""
    from siddhi_tpu_torch.core.expr import TORCH_OF_VT, decode_word
    loaded, ops = set(), 0
    for prog in [p for p in (mask_prog, *out_progs) if p is not None]:
        for j in range(0, len(prog.words), 2):
            op = decode_word(prog.words[j])[0]
            if op == "load":
                loaded.add(prog.words[j + 1])
            elif op != "const":
                ops += n
    nbytes = sum(n * cols[s].element_size() for s in loaded)
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


def run_c4_main_path(pkg, np, tape) -> tuple:
    """Phase 4: C4 through the facade on the card, launch counts from 0;
    returns (rows, ms per flush, launches, runtime, recorded blocks).  A
    recorded block is (kernel, state in, event grid, M, meta) exactly as
    the plan called `NFAKernel.run_block`; recording launches nothing."""
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
    rows, per_flush, rt = run_app(pkg, np, C4_HEAD + C4, tape, KEYS, "cuda")
    launches = dict(kernels.LAUNCHES)
    NFAKernel.run_block = run_block
    return rows, per_flush, launches, rt, blocks


def sorted_rows(torch, kern, out: dict):
    n = int(out["meta"][0])
    rows = torch.cat([out["out_i"][:, :n].double(),
                      out["out_f"][:, :n].double(),
                      out["out_l"][:, :n].double()])
    ci = kern.lane_names_i.index("__comp_seq__")
    hi = kern.lane_names_i.index("__head_seq__")
    key = rows[ci] * 2.0 ** 32 + rows[hi]
    return rows[:, torch.argsort(key)]


def phase_blocks(torch, blocks) -> dict:
    """Phase 5: K2 and K1 against their plain versions on every block the
    main path accepted (an M overflow's first try is re-run by the plan
    with a larger M and is left out); the last block, whose slot state
    the earlier flushes built, is timed."""
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval_plain,
                                                    unpack_mask)
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    accepted = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
    if not accepted:
        raise SystemExit("C4 recorded no accepted block")
    err = {"nfa_block": 0.0, "pre_mask": 0.0, "select": 0.0}
    for b, (kern, state, ev, M) in enumerate(accepted):
        T, P = ev["__ts__"].shape
        params = {"__base_ts__": ev["__base_ts__"]}
        pre = kern.pre_masks(ev)
        pre_cols = kern.pre_mask_cols(ev)
        for w, pr in zip(pre, kern.pre_progs):
            if pr is not None and not torch.equal(
                    w, expr_eval_plain(pre_cols, pr, [], T * P, params)[0]):
                raise SystemExit(f"K1 pre-mask differs (block {b})")
        new_k, out_k = nfa_block(kern, state, ev, pre, M)
        masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
                 for w in pre]
        t0 = time.perf_counter()
        new_p, out_p = nfa_block_plain(kern, state, ev, masks, M)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for key in new_k:
            if not torch.equal(new_k[key], new_p[key]):
                raise SystemExit(f"K2 state {key!r} differs (block {b})")
        if not torch.equal(out_k["meta"], out_p["meta"]):
            raise SystemExit(f"K2 meta differs: {out_k['meta'].tolist()} vs "
                             f"{out_p['meta'].tolist()}")
        rk, rp = sorted_rows(torch, kern, out_k), sorted_rows(torch, kern,
                                                              out_p)
        if not torch.equal(rk, rp):
            raise SystemExit(f"K2 match rows differ (block {b})")
        n = int(out_k["meta"][0])
        if n:
            err["nfa_block"] = max(err["nfa_block"],
                                   float((rk - rp).abs().max()))
        sel_cols = kern.select_cols(out_k)
        hw, sel = kern.select(out_k, n, ev["__base_ts__"])
        hp, selp = expr_eval_plain(sel_cols, kern.having_prog,
                                   kern.sel_progs, n, params)
        if (hw is None) != (hp is None) or (hw is not None and not
                                            torch.equal(hw, hp)) or \
                not all(torch.equal(a, c) for a, c in zip(sel, selp)):
            raise SystemExit(f"K1 selector differs (block {b})")
        for a, c in zip(sel, selp):
            if n and a.dtype != torch.bool:
                err["select"] = max(err["select"], float(
                    (a.double() - c.double()).abs().max()))
        log(f"  block {b}: T={T} P={P} A={kern.A} M={M} matches={n} "
            f"of_slots={int(out_k['meta'][1])}: K2 state and rows, K1 "
            f"pre-masks and selector equal to their plain versions")

    kern, state, ev, M = accepted[-1]
    T, P = ev["__ts__"].shape
    params = {"__base_ts__": ev["__base_ts__"]}
    pre = kern.pre_masks(ev)
    out = nfa_block(kern, state, ev, pre, M)[1]
    n = int(out["meta"][0])
    res = {"T": T, "P": P, "A": kern.A, "M": M, "matches": n,
           "blocks": len(accepted), "err": err}
    # K2: the grids, pre-mask words, state in and out and the match rows,
    # each moved once; one station test per slot for each live event
    tensors = [v for v in ev.values() if torch.is_tensor(v)]
    k2_bytes = sum(v.numel() * v.element_size() for v in tensors)
    k2_bytes += sum(w.numel() * 4 for w in pre if w is not None)
    k2_bytes += 2 * sum(v.numel() * v.element_size() for v in state.values())
    k2_bytes += n * (len(kern.lane_names_i) * 4 + len(kern.rows_f) * 4 +
                     len(kern.rows_l) * 8) + 8
    k2_ops = int(ev["__valid__"].sum()) * kern.A
    ms, host = graph_ms(torch, lambda: nfa_block(kern, state, ev, pre, M),
                        reps=10)
    res["nfa_block"] = {"ms": ms, "dispatch_ms": host, "plain_ms": plain_ms,
                        "bytes": k2_bytes, "ops": k2_ops}
    # K1 pre-mask: one launch per chain node with event-only conjuncts
    pre_cols = kern.pre_mask_cols(ev)
    progs = [p for p in kern.pre_progs if p is not None]
    nbytes = ops = 0
    for prog in progs:
        b_, o_ = k1_work(torch, pre_cols, prog, [], T * P)
        nbytes, ops = nbytes + b_, ops + o_
    ms, host = graph_ms(torch, lambda: kern.pre_masks(ev))
    res["pre_mask"] = {
        "ms": ms / len(progs), "dispatch_ms": host / len(progs),
        "plain_ms": wall_ms(torch, lambda: [
            expr_eval_plain(pre_cols, p, [], T * P, params)
            for p in progs]) / len(progs),
        "bytes": nbytes / len(progs), "ops": ops / len(progs)}
    # K1 selector over this block's match rows
    sel_cols = kern.select_cols(out)
    nbytes, ops = k1_work(torch, sel_cols, kern.having_prog, kern.sel_progs,
                          n)
    ms, host = graph_ms(torch, lambda: kern.select(out, n, ev["__base_ts__"]))
    res["select"] = {
        "ms": ms, "dispatch_ms": host,
        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
            sel_cols, kern.having_prog, kern.sel_progs, n, params)),
        "bytes": nbytes, "ops": ops}
    return res


def phase_c1(torch, np, pkg) -> dict:
    """Phase 6: config 1 through the facade on the card (launch counts
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
    k_ms, host = graph_ms(torch, lambda: expr_eval(*args, use="filter"))
    nbytes, ops = k1_work(torch, cols, plan._mask_prog, plan._out_progs, n)
    log(f"[c1] {len(rows)} rows equal to the CPU run; launches {launches}; "
        f"{ms[0]:.1f} ms for {n} events")
    return {"rows": len(rows), "ms": ms, "events": n, "launches": launches,
            "filter": {"ms": k_ms, "dispatch_ms": host,
                       "plain_ms": wall_ms(torch,
                                           lambda: expr_eval_plain(*args)),
                       "bytes": nbytes, "ops": ops}}


def kernel_entry(name, source, replaces, launches, err, m) -> dict:
    bound_ms, by = bound(m["bytes"], m["ops"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


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

    # 4. the main path: C4 on the card, then the same tape on the CPU
    tape = make_tape(np, FLUSH * N_FLUSH, FLUSH, KEYS)
    dev_out, per_flush, c4_launches, rt, blocks = run_c4_main_path(pkg, np,
                                                                    tape)
    plan = rt.plans()[0]
    ref_out, cpu_flush, _ = run_app(pkg, np, C4_HEAD + C4, tape, KEYS, "cpu")
    if sorted(dev_out) != sorted(ref_out) or not dev_out:
        raise SystemExit(f"C4 rows differ: {len(dev_out)} vs {len(ref_out)}")
    for _ts, (p1, p2, p3) in dev_out:
        if not (p1 > 100 and p2 > p1 and p3 > p2):
            raise SystemExit(f"C4 row breaks the pattern: {(p1, p2, p3)}")
    c4_kernels = ("nfa_block", "expr_eval:pre_mask", "expr_eval:select")
    if min(c4_launches[k] for k in c4_kernels) == 0:
        raise SystemExit(f"C4 did not launch every kernel: {c4_launches}")
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c4] {len(dev_out)} matches equal to the CPU run; launches "
        f"{c4_launches}; per flush ms {[round(x, 1) for x in per_flush]} "
        f"(cpu {[round(x) for x in cpu_flush]}); {eps:.0f} events/s "
        f"(P={plan.P} A={plan.kernel.A} blocks={plan.blocks_run})")

    # 5. K2 and K1 vs plain on the main path's own blocks
    t0 = time.perf_counter()
    blk = phase_blocks(torch, blocks)
    log(f"[blocks] {blk['blocks']} blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    del blocks

    # 6. C1 filter
    c1 = phase_c1(torch, np, pkg)

    # 7. results
    nfa_dev = "siddhi_tpu/core/nfa_device.py"
    res = {"kernels": [
        kernel_entry("expr_eval:filter", K1_SRC,
                     "siddhi_tpu/core/planner.py:301",
                     c1["launches"]["expr_eval:filter"], k1_err,
                     c1["filter"]),
        kernel_entry("expr_eval:pre_mask", K1_SRC, f"{nfa_dev}:1489",
                     c4_launches["expr_eval:pre_mask"],
                     blk["err"]["pre_mask"], blk["pre_mask"]),
        kernel_entry("expr_eval:select", K1_SRC, f"{nfa_dev}:1619",
                     c4_launches["expr_eval:select"], blk["err"]["select"],
                     blk["select"]),
        kernel_entry("nfa_block", "siddhi_tpu_torch/csrc/nfa_block.cu",
                     f"{nfa_dev}:1486", c4_launches["nfa_block"],
                     blk["err"]["nfa_block"], blk["nfa_block"])]}
    for e, m in zip(res["kernels"], (c1["filter"], blk["pre_mask"],
                                     blk["select"], blk["nfa_block"])):
        log(f"  {e['name']}: device {e['ms']:.4f} ms, host dispatch "
            f"{m['dispatch_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
            f"bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
            f"{e['launches']} launches")
    detail = {"card": smi, "c4": {"events_per_s": eps,
                                  "ms_per_flush": per_flush,
                                  "cpu_ms_per_flush": cpu_flush,
                                  "matches": len(dev_out),
                                  "flush_events": FLUSH,
                                  "launches": c4_launches},
              "c1": c1, "blocks": blk}
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
