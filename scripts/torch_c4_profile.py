#!/usr/bin/env python3
"""Where a C4 (C5, C2, J6) flush spends its time in the PyTorch/CUDA port.

    python3 scripts/torch_c4_profile.py [--config c4|c5|c2|c2g|c2b|
                                         c4n|c4ns|c4a|c4o|c4h|c4f|c4l|
                                         j6|j6w|j6o|j6u|agg|aggw|aggg]
                                        [--out FILE]

Runs BASELINE config 4 (partitioned `every e1 -> e2 -> e3 within 10 sec`,
1000 keys, 2^18-event flushes, the chip_smoke.py tape) through
siddhi_tpu_torch on the CUDA card at default settings (the `scan`
family), or with `--config c5` config 5 (chip_smoke.py's c5_app(1000):
four fused plans of 250 query lanes; 2^13-event flushes 50 ms apart,
8 symbols), or a window config of chip_smoke.py (`c2`: BASELINE config
2, `length(1000) select avg(price)`; `c2g`: the grouped, filtered
`time(10 sec)` window; `c2b`: `externalTimeBatch(et, 64)` grouped; 2^17-
event flushes over 8 symbols), or one of its pattern-algebra apps at
C4's shape (`c4n`: a count head on `scan`; `c4ns`: a count with a
capture filter on `seq`; `c4a`: `and` on `scan`; `c4o`: `or` with NULLs
on `seq`; K2's EXT instantiation under playback: `c4h` an `every`
absent head, `c4f` `every` below the head from 4 slots a lane, `c4l` an
absent `or` side), or one of its join configs on bench.py's config 6 tape (`j6`:
bench.py's JOIN_APP at 4096-event flushes; `j6w`: 2^17-event flushes;
`j6o`: the filtered full outer join; `j6u`: the unidirectional one;
each flush one send_batch to L, one to R), or one of its aggregation
cells on bench.py's matrix tape (`agg`: A7, bench.py's `_matrix_app`
rollup at 4096-event flushes over 1024 keys; `aggw`: A7W, 2^17-event
flushes; `aggg`: A7G, the global rollup at 2^17; each flush one
send_batch to Trades), warms with one flush, then
profiles the
next FLUSHES (4) with
cProfile (host clock; each flush ends in torch.cuda.synchronize).
Device waits show up inside the calls that pull results to the host
(`Tensor.cpu`).  Prints the flush times (an aggregation reports its live
sec buckets in place of matches) and the functions with the most
cumulative and own time.  Then TRACED (2) more flushes run under
torch.profiler: device time per kernel and copy, and the device's busy
share of the traced wall time (the rest is the card's idle share).
Needs a CUDA card.
"""
import argparse
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSHES, TRACED = 4, 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("c4", "c5", "c2", "c2g", "c2b",
                                         "c4n", "c4ns", "c4a", "c4o", "c4h",
                                         "c4f", "c4l", "j6", "j6w", "j6o",
                                         "j6u", "agg", "aggw", "aggg"),
                    default="c4")
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_c4_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import siddhi_tpu_torch as pkg

    algebra = {a[0]: a[1] for a in chip_smoke.ALGEBRA}
    algebra.update({("c4l" if e[0] == "c4l_or" else e[0]): e[1]
                    for e in chip_smoke.EXT})
    joins = {j[0]: j for j in chip_smoke.JOINS}
    aggs = {"agg": ("a7", True), "aggw": ("a7w", True),
            "aggg": ("a7g", False)}
    if args.config in aggs:
        label, grouped = aggs[args.config]
        keys = chip_smoke.AGG_KEYS
        flush = {a[0]: a[2] for a in chip_smoke.AGGS}[label]
        app, outs = chip_smoke.MATRIX_APP("", grouped), []
    elif args.config in joins:
        keys, flush, dt = 1000, joins[args.config][2], 1
        app, outs = joins[args.config][1], ["Out"]
    elif args.config == "c4":
        keys, flush, dt = 1000, 1 << 18, 1
        app, outs = chip_smoke.C4_HEAD + chip_smoke.C4, ["Out"]
    elif args.config in algebra:
        keys, flush, dt = 1000, 1 << 18, 1
        app, outs = algebra[args.config], ["Out"]
    elif args.config.startswith("c2"):
        keys, flush, dt = chip_smoke.C2_SYMBOLS, chip_smoke.C2_FLUSH, 1
        app = {"c2": chip_smoke.C2, "c2g": chip_smoke.C2_GROUPED,
               "c2b": chip_smoke.C2B}[args.config]
        outs = ["Out"]
    else:
        keys, flush, dt = (chip_smoke.C5_SYMBOLS, chip_smoke.C5_FLUSH,
                           chip_smoke.C5_DT)
        app = chip_smoke.c5_app(chip_smoke.C5_QUERIES)
        outs = [f"Out{j}" for j in range(16)]
    # a flush: the (stream, tape entry) pairs sent before its flush()
    n_tape = flush * (FLUSHES + TRACED + 1)
    if args.config in aggs:
        tape = [[("Trades", f)] for f in chip_smoke.matrix_tape(
            FLUSHES + TRACED + 1, flush, keys)]
    elif args.config in joins:
        tape = [[("L", f["L"]), ("R", f["R"])]
                for f in chip_smoke.join_tape(n_tape, flush)]
    else:
        tape = [[("StockStream", f)] for f in chip_smoke.make_tape(
            n_tape, flush, keys, seed=5, dt_ms=dt)]
    rt = pkg.SiddhiManager().create_app_runtime(app)
    got = [0]
    for o in outs:
        rt.add_batch_callback(o, lambda b: got.__setitem__(0, got[0] + b.n))
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)

    def feed(sends):
        for sid, f in sends:
            if sid == "Trades":             # a matrix tape entry
                rt.input_handler(sid).send_batch(*f)
                continue
            cols = {"symbol": codes[f["sym_idx"]], "price": f["price"],
                    "volume": f["volume"]}
            if args.config == "c2b":
                cols["et"] = f["ts"]            # event time = arrival
            rt.input_handler(sid).send_batch(cols, f["ts"])
        rt.flush()
        torch.cuda.synchronize()

    feed(tape[0])           # warm: build, first M, a window's carry growth
    prof = cProfile.Profile()
    ms = []
    for f in tape[1:FLUSHES + 1]:
        t0 = time.perf_counter()
        prof.enable()
        feed(f)
        prof.disable()
        ms.append((time.perf_counter() - t0) * 1e3)
    if args.config in aggs:
        got[0] = rt.aggregations["Roll"].metrics()["durations"][
            "SECONDS"]["buckets"]
    buf = io.StringIO()
    buf.write(f"card {torch.cuda.get_device_name(0)}; {args.config.upper()} "
              f"flushes of {flush} events over {keys} keys; ms per flush "
              f"(profiled) "
              f"{[round(x, 1) for x in ms]}; matches {got[0]}\n")
    st = pstats.Stats(prof, stream=buf)
    st.sort_stats("cumulative").print_stats(30)
    st.sort_stats("tottime").print_stats(20)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for f in tape[FLUSHES + 1:]:
            feed(f)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side activity only (kernels, copies, fills): a host op's
    # device time repeats its kernels' and would count them twice
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in tp.key_averages()
           if e.self_device_time_total > 0 and
           str(e.device_type).endswith("CUDA")]
    dev.sort(key=lambda x: -x[2])
    busy = sum(d for _k, _c, d in dev)
    buf.write(f"\ntorch.profiler over {TRACED} flushes: wall {wall_us / 1e3:.1f}"
              f" ms, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.2f}"
              f"%), idle {100 - 100 * busy / wall_us:.2f}%\n")
    for k, c, d in dev[:25]:
        buf.write(f"  {d / 1e3:9.3f} ms  {c:5d}x  {k}\n")
    report = buf.getvalue()
    print(report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
