"""K4 `scan_chase`: the stateless state chase of one `scan` block.

Replaces the chase of `_block_impl` (siddhi_tpu/core/nfa_parallel.py
:887-974 for single positions; `_first_hit` :523 inside it, `killer`
:867, `threshold_next` :871, `step_fail` :896), which the JAX package
vmaps over the lane axis (`_make_lane_block` :646).  Every event of the
block is a candidate head; per position below the head it finds the
first event from s = (previous match) + 1 that completes the hop, and
checks that it lands before the `within` killer (the first event past
head ts + W, matching or not).  Static and threshold hops are first-hit
descents in K3's trees; a strict-sequence hop reads the event at s.

Design (csrc/scan_chase.cu, descents in csrc/seg_tree.cuh): one thread
per (lane, head), the hop loop in registers; threshold right-hand sides
and strict step conjunctions run the predicate VM (csrc/expr_vm.cuh) on
the captures at the indices resolved so far, which the thread keeps in
its own column of the `idx` output, so no chain length is fixed; a
fused group's `__qparam` operands read the lane's parameters.  Hop
tables, loads, heap pointers and programs travel in a device table
(kernels/table.py), the programs staged in shared memory.  A head stops
at its first failed hop.  Bound on the H100: bytes -- the timestamp and
pre-mask grids read once, the status and index grids written once; the
descents read 2 log2(Lt) tree nodes per query, which stay in the 50 MB
L2 at the C4 and C3 shapes (16 and 12 MB of trees).

Output: `status` (L, F) uint8 (bit 1 ok, bit 2 dead, bit 4 the head's
node mask) and `idx` (S-1, L, F) int32, the event index resolved at each
position below the head (0 where the head is not ok).  `scan_chase()`
launches the kernel for CUDA tensors and runs `scan_chase_plain()` (the
JAX chase as vector ops over the (L, F) grid) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import VT_OF_TORCH, decode_word
from ..core.nfa_parallel import lane_grid
from .build import load
from .expr_eval import (merge_programs, program_table, stage_bytes,
                        vm_run_plain)
from .seg_tree import first_hit_plain, node_masks
from .table import DeviceTable, Launch, checked_ptr, stream_of

_KIND = {"static": 0, "threshold": 1, "strict": 2}
_OP = {"gt": 0, "ge": 1, "lt": 2, "le": 3}


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "Lt", "S", "is_seq", "ts_tree", "n_loads", "ev_stride",
        "P", "n_words", "n_consts", "stage")] + [
        (n, ctypes.c_void_p) for n in (
            "nev", "ts", "scode", "qparams", "pre", "node_scode",
            "hop_kind", "hop_within", "hop_tree", "hop_op", "prog_off",
            "prog_len", "prog_vt", "heap", "heap_vt", "load_col",
            "load_vt", "load_pos", "status", "idx", "consts", "words")]


def _vm_plain(k, prog, ev: dict, at: list, s: torch.Tensor) -> torch.Tensor:
    """One VM program per head over the (L, F) grid: each load reads its
    column at its position's resolved index (or at s), each `qparam` the
    lane's parameter."""
    L, F = s.shape
    words, consts, _o, _l = merge_programs(
        [prog], {"__base_ts__": ev["__base_ts__"]})
    used = {words[i + 1] for i in range(0, len(words), 2)
            if decode_word(words[i])[0] == "load"}
    cols = []
    for slot, (key, pos) in enumerate(k.loads):
        if slot not in used:        # another hop's load: never read
            cols.append(s.reshape(-1))
            continue
        where = at[pos] if pos >= 0 else s
        cols.append(torch.gather(lane_grid(ev, key), 1, where).reshape(-1))
    qcols = None
    if k.nfak.params is not None:
        qcols = [v[:, None].expand(L, F).reshape(-1)
                 for v in k.nfak.params.values]
    return vm_run_plain(words, consts, cols, L * F, qcols).reshape(L, F)


def scan_chase_plain(k, ev: dict, masks: list, heaps: list,
                     alive: Optional[list] = None):
    """The chase over the (L, F) grid; `alive`, when given, receives the
    number of heads still ok on entering each hop (the work K4 does)."""
    ts = lane_grid(ev, "__flat.__ts__")
    L, F = ts.shape
    Lt = k.leaves(F)
    dev = ts.device
    nev = ev["__nev__"].to(torch.int64)[:, None]
    j0 = torch.arange(F, device=dev).expand(L, F)
    ts64 = ts.to(torch.int64)
    head = masks[0]
    ok = head.clone()
    dead = torch.zeros_like(ok)
    at = [j0]
    j = j0
    for pi in range(1, k.S):
        hop = k.hops[pi - 1]
        s = j + 1
        if alive is not None:
            alive.append(int(ok.sum()))
        if hop.kind == "strict":
            sc = torch.clamp(s, 0, F - 1)
            m = torch.gather(masks[pi], 1, sc)
            if hop.prog is not None:
                m = m & _vm_plain(k, hop.prog, ev, at, sc).to(torch.bool)
            expired = torch.gather(ts64, 1, sc) > ts64 + hop.within
            have = s < nev
            jn = torch.where(have & m & ~expired, s, torch.full_like(s, Lt))
            dead = dead | (ok & have & (expired | ~m))
            ok = ok & (jn < F)
        else:
            kl = first_hit_plain(heaps[k.ts_tree], Lt, s, ts64 + hop.within,
                                 "gt").to(torch.int64)
            heap = heaps[hop.tree]
            if hop.kind == "threshold":
                v, op = _vm_plain(k, hop.prog, ev, at, s), hop.op
            else:
                v, op = torch.zeros((L, F), dtype=heap.dtype,
                                    device=dev), "gt"
            jn = first_hit_plain(heap, Lt, s, v, op).to(torch.int64)
            good = jn < kl
            dead = dead | (ok & ~good & (kl < F))
            ok = ok & good
        j = torch.clamp(jn, 0, F - 1)
        at.append(j)
    idx = torch.stack([torch.where(ok, a, torch.zeros_like(a))
                       for a in at[1:]]).to(torch.int32)
    status = (ok.to(torch.uint8) | (dead.to(torch.uint8) << 1)
              | (head.to(torch.uint8) << 2))
    return status, idx


def scan_chase(k, ev: dict, pre: list, heaps: list):
    """(status, idx) of ParallelChainKernel `k` for block `ev`, its K1
    pre-mask words `pre` (per position, or None) and K3 `heaps`."""
    if ev["__flat.__ts__"].device.type == "cpu":
        return scan_chase_plain(k, ev, node_masks(k, ev, pre), heaps)
    return prepare(k, ev, pre, heaps)()


def prepare(k, ev: dict, pre: list, heaps: list) -> Launch:
    """Allocate status and indices and upload the parameter table of one
    K4 launch (see `scan_chase`)."""
    ts = ev["__flat.__ts__"]
    dev = ts.device
    if dev.type != "cuda":
        raise ValueError(f"scan_chase: unsupported device {dev}")
    G, F = ts.shape
    L = ev["__nev__"].shape[0]
    keep: list = []
    ptr = checked_ptr(keep, dev, "scan_chase")
    p = _Params()
    p.L, p.F, p.Lt, p.S = L, F, k.leaves(F), k.S
    p.is_seq, p.ts_tree, p.n_loads = int(k.prog.sequence), k.ts_tree, \
        len(k.loads)
    p.ev_stride = F if G == L else 0
    p.nev = ptr(ev["__nev__"], torch.int32)
    p.ts = ptr(ts, torch.int32)
    if k.multi:
        p.scode = ptr(ev["__flat.__scode__"], torch.int32)
    if k.nfak.params is not None:
        p.qparams = ptr(k.nfak.params.bits, torch.int64)
        p.P = k.nfak.params.P
    S = k.S
    kind, within, tree, op, vt = [0] * S, [0] * S, [0] * S, [0] * S, [0] * S
    progs, pidx = [], []
    for pi, hop in enumerate(k.hops, start=1):
        kind[pi], within[pi] = _KIND[hop.kind], hop.within
        tree[pi], op[pi] = max(hop.tree, 0), _OP[hop.op]
        if hop.prog is not None:
            pidx.append(pi)
            progs.append(hop.prog)
            vt[pi] = hop.prog.vt
    words, consts, offs, lens = merge_programs(
        progs, {"__base_ts__": ev["__base_ts__"]})
    off, ln = [0] * S, [0] * S
    for pi, o, n in zip(pidx, offs, lens):
        off[pi], ln[pi] = o, n
    tab = DeviceTable()
    tab.field(p, "pre", [0 if w is None else ptr(w, torch.int32)
                         for w in pre], "u8")
    tab.field(p, "node_scode", [k.node_scode[pi] if k.multi else -1
                                for pi in range(S)], "i4")
    tab.field(p, "hop_kind", kind, "i4")
    tab.field(p, "hop_within", within, "i4")
    tab.field(p, "hop_tree", tree, "i4")
    tab.field(p, "hop_op", op, "i4")
    tab.field(p, "prog_off", off, "i4")
    tab.field(p, "prog_len", ln, "i4")
    tab.field(p, "prog_vt", vt, "i4")
    tab.field(p, "heap", [ptr(h) for h in heaps] or [0], "u8")
    tab.field(p, "heap_vt", [VT_OF_TORCH[h.dtype] for h in heaps] or [0],
              "i4")
    cols = [ev[key] for key, _pos in k.loads]
    tab.field(p, "load_col", [ptr(c) for c in cols] or [0], "u8")
    tab.field(p, "load_vt", [VT_OF_TORCH[c.dtype] for c in cols] or [0],
              "i4")
    tab.field(p, "load_pos", [pos for _key, pos in k.loads] or [0], "i4")
    program_table(tab, p, words, consts)
    status = torch.empty((L, F), dtype=torch.uint8, device=dev)
    idx = torch.empty((max(S - 1, 1), L, F), dtype=torch.int32, device=dev)
    p.status, p.idx = ptr(status), ptr(idx)
    keep.append(tab.upload(dev))
    smem = stage_bytes(words, consts) if p.stage else 0
    lib = load("scan_chase")
    fn = lib.scan_chase_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), smem, stream_of(dev)),
                  "scan_chase_launch", "scan_chase", keep,
                  (status, idx[:S - 1]))
