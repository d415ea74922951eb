#!/usr/bin/env python3
"""Where K2's (`nfa_block`) cycles go on the card, phase by phase.

    python3 scripts/k2_phases.py [BLOCK ...]

Builds K2's sources a second time with -DNFA_PHASES (into
siddhi_tpu_torch/_build/phases/): each warp then sums its clock
(clock64) between marks in csrc/nfa_block.cuh into seven phases -- the
event stage's next tile copies issued, the slot steps (steps 0-4: node
matches and the VM, deadlines, counts, stations, capture writes), the
drain, the head allocation, the rest (state in and out, the drain rounds
after the last step), the wait for a tile to land and its hand-over
into node words and flags (phase "wait" includes, for fused lanes, the
block's warps meeting at the tile).  It records the blocks chip_smoke.py's
K2 phases hand K2 (c4_seq, c5, c4ns, c4o, c4f -- the widest --, c3k,
c3x, c4_seq_f64, on chip_smoke's tapes; the BLOCKs named, else all),
builds the sources they need, launches the instrumented kernel on the block
chip_smoke.py times for each, with the parameter block the port's own
wrapper prepares, and prints one JSON line a block: its shape, the
instrumented launch's device ms (CUDA events around one launch, after
one warm-up launch) and each phase's cycles per warp-step (the warps'
summed cycles over P * T), with the card's name and power limit.  The
marks cost cycles of their own: compare phases within a run, and take
K2's time from chip_smoke.py or kernel_ab.py.  Needs a CUDA card.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("issue", "slots", "drain", "head", "rest", "wait", "prep")


def build_phases(names) -> dict:
    """The NFA_PHASES build of each K2 source: name -> ctypes library."""
    from siddhi_tpu_torch.kernels import build
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        out = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DNFA_PHASES", "-o",
               out, os.path.join(build.CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name}.cu -DNFA_PHASES failed:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def run_phases(lib, name: str, launch, reps: int = 2) -> tuple:
    """Launch the NFA_PHASES library `lib` (source `name`) on a K2 launch
    prepared by kernels/nfa_block.py `prepare`, `reps` times (its match
    count reset before each, so each launch gives the wrapper's outputs,
    `launch.outputs`); returns the last launch's device ms (CUDA events)
    and its cycles summed over the warps, phase by phase."""
    import torch

    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels.table import stream_of
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nfa_block_phases.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * len(PHASES))()
    meta = launch.outputs[1]["meta"]
    meta0 = meta.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _rep in range(reps):
        meta.copy_(meta0)
        start.record()
        build.check(fn(ctypes.addressof(launch.params),
                       stream_of(meta.device)), name)
        end.record()
        torch.cuda.synchronize()
        build.check(lib.nfa_block_phases(ctypes.addressof(out)),
                    "nfa_block_phases")
    return start.elapsed_time(end), dict(zip(PHASES, out))


def lib_name(kern, ev) -> str:
    """The source kernels/nfa_block.py `prepare` launches for a block."""
    return "nfa_block" + ("_wide" if kern.A > 128 else
                          "_chunk" if "__chunk__" in ev else "") + \
        ("_ext" if kern.ext else "") + ("_f64" if kern.f64 else "")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels import nfa_block as k2
    if not torch.cuda.is_available():
        print("k2_phases: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build_all(("expr_eval",))
    want = set(sys.argv[1:])

    def on(label: str) -> bool:
        return not want or label.replace(" ", "_") in want

    def last(blocks, widest=False):
        acc = [b[:4] for b in blocks if int(b[4][0]) <= b[3] and
               "__tick__" not in b[2]]
        if widest:
            acc.sort(key=lambda b: b[0].A)
        return acc[-1]

    def chunk_last(blocks, cap):
        kern, _st, ev, m, _meta = [b for b in blocks if cs.chunk_kept(
            b[0], b[4].cpu(), b[3], cap)][-1]
        return kern, kern.init_state(ev["__ts__"].device), ev, m

    chosen = []
    if on("c4 seq"):
        tape = cs.make_tape(cs.FLUSH * cs.SEQ_FLUSHES, cs.FLUSH, cs.KEYS)
        chosen.append(("c4 seq", last(cs.run_recorded(
            pkg, np, cs.C4_SEQ + cs.C4_HEAD + cs.C4, tape)[5])))
    if on("c5"):
        tape = cs.make_tape(cs.C5_FLUSH * 4, cs.C5_FLUSH, cs.C5_SYMBOLS,
                            seed=5, dt_ms=cs.C5_DT)
        c5 = cs.run_c5(pkg, np, tape, "cuda", record=True)[5]
        chosen.append(("c5", last(sorted(c5, key=lambda b: (
            b[0].has_absent, b[2]["__ts__"].shape[0])))))
    for label, app, flushes, family, seed, _x, _n in cs.ALGEBRA:
        if family == "seq" and on(label):
            tape = cs.make_tape(cs.FLUSH * flushes, cs.FLUSH, cs.KEYS,
                                seed=seed)
            chosen.append((label, last(cs.run_recorded(pkg, np, app,
                                                       tape)[5])))
    if on("c4f"):
        label, app, seed = [x for x in cs.EXT if x[0] == "c4f"][0]
        tape = cs.make_tape(cs.FLUSH * cs.EXT_FLUSHES, cs.FLUSH, cs.KEYS,
                            seed=seed)
        chosen.append(("c4f", last(cs.run_recorded(pkg, np, app, tape)[5],
                                   widest=True)))
    for label, app, n, flushes, keys, seed, _f, _c in cs.STATELESS:
        if label in ("c3k", "c3x") and on(label):
            tape = cs.make_tape(n * flushes, n, keys, seed=seed)
            rt, seq_b = cs.run_recorded(pkg, np, app, tape, keys)[3:6:2]
            chosen.append((label, chunk_last(seq_b, rt.plans()[0].A_CAP)))
    if on("c4 seq f64"):
        label, app, n, flushes, keys, seed, band = [
            x for x in cs.F64_PHASES if x[0] == "c4 seq f64"][0][:7]
        tape = cs.raw_tape(n * flushes, n, keys, seed=seed, lo=band[0],
                           levels=band[1])
        chosen.append(("c4 seq f64", last(cs.run_recorded(
            pkg, np, app, tape, keys)[5])))
    libs = build_phases(sorted({lib_name(b[0], b[2]) for _l, b in chosen}))

    for label, (kern, state, ev, M) in chosen:
        name = lib_name(kern, ev)
        launch = k2.prepare(kern, state, ev, kern.pre_masks(ev), M)
        ms, cycles = run_phases(libs[name], name, launch)
        T = ev["__chunk__"][0] if "__chunk__" in ev else ev["__ts__"].shape[0]
        steps = kern.P * T
        print(json.dumps({
            "block": label, "source": name, "T": T, "P": kern.P, "A": kern.A,
            "tt": launch.params.tt, "wpb": launch.params.wpb, "ms": ms,
            "cycles_per_step": {ph: n / steps for ph, n in cycles.items()},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
