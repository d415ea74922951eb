#!/usr/bin/env python3
"""Device times of K2 (`nfa_block`), K6 (`win_scan`) and K10
(`agg_merge`) on the calls their main paths make, checkout by checkout.

    python3 scripts/kernel_ab.py ROOT [ROOT ...]

Runs each checkout (a directory holding chip_smoke.py and
siddhi_tpu_torch) in a subprocess of its own, in the order given (repeat
them to interleave, e.g. parent, change, change, parent, so that a drift
of the card shows).  Each run builds that checkout's kernels and drives
chip_smoke.py's phases through its own facade on the card, recording what
the plans hand the kernels: C4 under @app:patternFamily('seq') (2
flushes of 2^18 events over 1000 keys) and config 5 (c5_app(1000), 4
flushes of 2^13 events 50 ms apart, then set_time), C2 (2 flushes of
2^17 events), C4N and C4A (4 and 2 flushes of 2^18), A7 (24 flushes of
4096 events over 1024 keys), A7W and A7G (4 flushes of 2^17, A7G without
`group by`) and A7A (2 flushes of 2^17 under
@app:deviceAggregations('always')).  It then times the call chip_smoke.py
times for each kernel use: K2 on the last accepted C4 `seq` block that
is not a timer tick and on config 5's widest block of its absent group;
K6 on C2's widest window call (`window`), on the last C4N block's rank
columns (`rank`), on the last C4A block's prev columns (`prev`) and on
A7A's widest call (`agg`); K10 on the widest call of A7, A7W and A7G (on
a copy of the ring) -- each a CUDA graph of prepared launches (10 for
K2, 20 else) replayed between CUDA events (chip_smoke.graph_ms), the
least of three graphs.  Prints one JSON line per run: the checkout, the
card's name and power limit, and the device times in ms.  Needs a CUDA
card.
"""
import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import agg_merge as k10
    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels import win_scan as k6
    from siddhi_tpu_torch.replay import (MATRIX_APP, matrix_tape, run_agg,
                                         run_window)
    build.build_all()

    def best(call, prepare, reps=20) -> float:
        return min(cs.graph_ms(torch, call, prepare, reps)[0]
                   for _ in range(3))

    def k6_ms(a, kw) -> float:
        return best(lambda: k6.win_scan(*a, **kw),
                    lambda: [k6.prepare(*a, **kw)])

    def k2_ms(blocks) -> float:
        acc = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
        kern, state, ev, m = [b for b in acc if "__tick__" not in b[2]][-1]
        pre = kern.pre_masks(ev)
        return best(lambda: k2.nfa_block(kern, state, ev, pre, m),
                    lambda: [k2.prepare(kern, state, ev, pre, m)], reps=10)

    out = {"root": root}
    tape = cs.make_tape(cs.FLUSH * cs.SEQ_FLUSHES, cs.FLUSH, cs.KEYS)
    out["k2_c4_seq"] = k2_ms(cs.run_recorded(
        pkg, np, cs.C4_SEQ + cs.C4_HEAD + cs.C4, tape)[5])
    tape = cs.make_tape(cs.C5_FLUSH * cs.C5_FLUSHES, cs.C5_FLUSH,
                        cs.C5_SYMBOLS, seed=5, dt_ms=cs.C5_DT)
    c5 = cs.run_c5(pkg, np, tape, "cuda", record=True)[5]
    out["k2_c5"] = k2_ms(sorted(c5, key=lambda b: (
        b[0].has_absent, b[2]["__ts__"].shape[0])))
    calls: list = []
    tape = cs.make_tape(cs.C2_FLUSH * cs.C2_FLUSHES, cs.C2_FLUSH,
                        cs.C2_SYMBOLS, seed=20)
    run_window(cs.C2, tape, "cuda", calls)
    _n, a, kw = max((c for c in calls if c[0] == "win_scan"),
                    key=lambda c: c[1][1])
    out["k6_window"] = k6_ms(a, kw)
    for label, use, cols_of in (("c4n", "rank", "rank_cols"),
                                ("c4a", "prev", "prev_cols")):
        _l, app, flushes, _f, seed, _e, _n = [
            x for x in cs.ALGEBRA if x[0] == label][0]
        tape = cs.make_tape(cs.FLUSH * flushes, cs.FLUSH, cs.KEYS,
                            seed=seed)
        blocks = cs.run_recorded(pkg, np, app, tape)[4]
        kern, ev, _m = blocks[-1]
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        masks = cs.scan_inputs(kern, ev, kern.pre_masks(ev))[0]
        cols = getattr(kern, cols_of)(masks)
        out[f"k6_{use}"] = k6_ms((cols, L * F), {"use": use, "period": F})
    for label, flushes, batch, grouped, _q, always in cs.AGGS:
        if label == "a7m":
            continue
        calls = []
        head = "@app:deviceAggregations('always')\n" if always else ""
        run_agg(MATRIX_APP(head, grouped),
                matrix_tape(flushes, batch, cs.AGG_KEYS), "cuda", calls)
        if always:
            _n, a, kw = max(calls, key=lambda c: c[1][1])
            out["k6_agg"] = k6_ms(a, kw)
            continue
        # the widest call: segments x bases plus the longest segment
        _n, a, kw = max(calls, key=lambda c: c[1][4].shape[0] * len(
            c[2]["ops"]) + cs.agg_merge_work(torch, c[1], c[2])[2])
        scratch = a[0].clone()
        out[f"k10_{label}"] = best(
            lambda: k10.agg_merge(scratch, *a[1:], **kw),
            lambda: [k10.prepare(scratch, *a[1:], **kw)])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return {"card": smi, **out}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(f"kernel_ab: {root} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
