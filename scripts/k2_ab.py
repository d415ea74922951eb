#!/usr/bin/env python3
"""K2's device time on C4 `seq` and config 5 blocks, checkout by checkout.

    python3 scripts/k2_ab.py ROOT [ROOT ...]

Runs each checkout (a directory holding chip_smoke.py and
siddhi_tpu_torch) in a subprocess of its own, in the order given (repeat
them to interleave, e.g. parent, change, change, parent, so that a drift
of the card shows).  Each run builds that checkout's kernels, drives
chip_smoke.py's C4 under @app:patternFamily('seq') (2 flushes of 2^18
events over 1000 keys) and config 5 (c5_app(1000), 4 flushes of 2^13
events 50 ms apart, then set_time) through its own facade on the card,
records the blocks the plans hand NFAKernel.run_block and times K2 on
the block chip_smoke.py times (the last accepted block that is not a
timer tick; for config 5 the widest block of the absent group) -- a
CUDA graph of 10 prepared launches replayed between CUDA events, as
chip_smoke.graph_ms does.  Prints one JSON line per run: the checkout,
the card's name and power limit, and the two device times in ms.
Needs a CUDA card.
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
    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block
    build.build_all()

    def timed(blocks) -> float:
        acc = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
        kern, state, ev, M = [b for b in acc if "__tick__" not in b[2]][-1]
        pre = kern.pre_masks(ev)
        return cs.graph_ms(torch, lambda: nfa_block(kern, state, ev, pre, M),
                           lambda: [k2.prepare(kern, state, ev, pre, M)],
                           reps=10)[0]
    tape = cs.make_tape(cs.FLUSH * cs.SEQ_FLUSHES, cs.FLUSH, cs.KEYS)
    seq = cs.run_recorded(pkg, np, cs.C4_SEQ + cs.C4_HEAD + cs.C4, tape)[5]
    c5_tape = cs.make_tape(cs.C5_FLUSH * cs.C5_FLUSHES, cs.C5_FLUSH,
                           cs.C5_SYMBOLS, seed=5, dt_ms=cs.C5_DT)
    c5 = cs.run_c5(pkg, np, c5_tape, "cuda", record=True)[5]
    c5 = sorted(c5, key=lambda b: (b[0].has_absent, b[2]["__ts__"].shape[0]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": smi, "c4_seq_ms": timed(seq),
            "c5_ms": timed(c5)}


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
            print(f"k2_ab: {root} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
