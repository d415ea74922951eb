#!/usr/bin/env python3
"""C3K and C3X (chip_smoke.py's `chunk` phases 32-33) at several
@app:deviceChunkLanes counts on the card.

    python3 scripts/chunk_lanes.py [K ...]        (default: 64 128 256)

For each lane count K, each app runs its chip_smoke tape (2 flushes of
2^17 events over 8 keys) through the facade on the card, recording the
blocks its plan hands K2.  Per run it prints one JSON line: the app, K,
the chunk geometry (K, CS, H, T) and A the plan ended at, ms per flush,
the rows (which must equal the K = 64 run's, in order) and K2's device
ms on the last chunk block the plan kept (a CUDA graph of 10 prepared
launches, the least of three; chip_smoke.graph_ms), with the card's name
and power limit.  Needs a CUDA card.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels import nfa_block as k2
    if not torch.cuda.is_available():
        print("chunk_lanes: needs a CUDA card", file=sys.stderr)
        return 1
    lanes = [int(x) for x in sys.argv[1:]] or [64, 128, 256]
    build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for label, app, n, flushes, keys, seed, _fam, _cmp in cs.STATELESS:
        if label not in ("c3k", "c3x"):
            continue
        tape = cs.make_tape(n * flushes, n, keys, seed=seed)
        base = None
        for K in lanes:
            rows, per_flush, launches, rt, _s, seq_b = cs.run_recorded(
                pkg, np, f"@app:deviceChunkLanes({K})\n" + app, tape, keys)
            plan = rt.plans()[0]
            if base is None:
                base = rows
            if rows != base or not rows:
                raise SystemExit(f"[{label} K={K}] rows differ from the "
                                 f"K={lanes[0]} run: {len(rows)} vs "
                                 f"{len(base)}")
            kern, _st, ev, M, _meta = [b for b in seq_b if cs.chunk_kept(
                b[0], b[4].cpu(), b[3], plan.A_CAP)][-1]
            state = kern.init_state(ev["__ts__"].device)
            pre = kern.pre_masks(ev)
            ms = min(cs.graph_ms(
                torch, lambda: k2.nfa_block(kern, state, ev, pre, M),
                lambda: [k2.prepare(kern, state, ev, pre, M)], 10)[0]
                for _ in range(3))
            print(json.dumps({
                "app": label, "lanes": K, "geometry": plan.chunk_geometry,
                "A": plan._chunk_A, "ms_per_flush": per_flush,
                "rows": len(rows), "k2_launches": launches["nfa_block:chunk"],
                "k2_ms": ms, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
