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
the captures at the indices resolved so far.  A head stops at its first
failed hop.  Bound on the H100: bytes -- the timestamp and pre-mask grids
read once, the status and index grids written once; the descents read
2 log2(Lt) tree nodes per query, which stay in the 50 MB L2 at the C4 and
C3 shapes (16 and 12 MB of trees).

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
from . import LAUNCHES
from .build import check, load
from .expr_eval import merge_programs, vm_run_plain
from .seg_tree import first_hit_plain, node_masks

MAXS, MAXT, MAXLOAD, MAXWORDS, MAXCONST = 8, 9, 24, 256, 32  # scan_chase.cu
_KIND = {"static": 0, "threshold": 1, "strict": 2}
_OP = {"gt": 0, "ge": 1, "lt": 2, "le": 3}


class _Params(ctypes.Structure):
    _fields_ = [("L", ctypes.c_int), ("F", ctypes.c_int),
                ("Lt", ctypes.c_int), ("S", ctypes.c_int),
                ("is_seq", ctypes.c_int), ("ts_tree", ctypes.c_int),
                ("n_loads", ctypes.c_int), ("pad0", ctypes.c_int),
                ("nev", ctypes.c_void_p), ("ts", ctypes.c_void_p),
                ("scode", ctypes.c_void_p),
                ("pre", ctypes.c_void_p * MAXS),
                ("node_scode", ctypes.c_int * MAXS),
                ("hop_kind", ctypes.c_int * MAXS),
                ("hop_within", ctypes.c_int * MAXS),
                ("hop_tree", ctypes.c_int * MAXS),
                ("hop_op", ctypes.c_int * MAXS),
                ("prog_off", ctypes.c_int * MAXS),
                ("prog_len", ctypes.c_int * MAXS),
                ("prog_vt", ctypes.c_int * MAXS),
                ("heap", ctypes.c_void_p * MAXT),
                ("heap_vt", ctypes.c_int * MAXT),
                ("load_col", ctypes.c_void_p * MAXLOAD),
                ("load_vt", ctypes.c_int * MAXLOAD),
                ("load_pos", ctypes.c_int * MAXLOAD),
                ("status", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("consts", ctypes.c_longlong * MAXCONST),
                ("words", ctypes.c_int * MAXWORDS)]


def _vm_plain(k, prog, ev: dict, at: list, s: torch.Tensor) -> torch.Tensor:
    """One VM program per head over the (L, F) grid: each load reads its
    column at its position's resolved index (or at s)."""
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
        cols.append(torch.gather(ev[key], 1, where).reshape(-1))
    return vm_run_plain(words, consts, cols, L * F).reshape(L, F)


def scan_chase_plain(k, ev: dict, masks: list, heaps: list,
                     alive: Optional[list] = None):
    """The chase over the (L, F) grid; `alive`, when given, receives the
    number of heads still ok on entering each hop (the work K4 does)."""
    ts = ev["__flat.__ts__"]
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
    ts = ev["__flat.__ts__"]
    dev = ts.device
    if dev.type == "cpu":
        return scan_chase_plain(k, ev, node_masks(k, ev, pre), heaps)
    if dev.type != "cuda":
        raise ValueError(f"scan_chase: unsupported device {dev}")
    L, F = ts.shape
    if k.S > MAXS or len(heaps) > MAXT or len(k.loads) > MAXLOAD:
        raise ValueError(f"scan_chase: S={k.S} (<= {MAXS}), {len(heaps)} "
                         f"trees (<= {MAXT}), {len(k.loads)} loads "
                         f"(<= {MAXLOAD}) exceed the kernel's limits")
    keep = []

    def ptr(t: torch.Tensor, dt=None) -> int:
        if t.device != dev or not t.is_contiguous() or \
                (dt is not None and t.dtype != dt):
            raise ValueError(f"scan_chase: bad tensor {t.dtype} {t.device} "
                             f"{tuple(t.shape)}")
        keep.append(t)
        return t.data_ptr()
    p = _Params()
    p.L, p.F, p.Lt, p.S = L, F, k.leaves(F), k.S
    p.is_seq, p.ts_tree, p.n_loads = int(k.prog.sequence), k.ts_tree, \
        len(k.loads)
    p.nev = ptr(ev["__nev__"], torch.int32)
    p.ts = ptr(ts, torch.int32)
    if k.multi:
        p.scode = ptr(ev["__flat.__scode__"], torch.int32)
    for pi in range(k.S):
        p.pre[pi] = 0 if pre[pi] is None else ptr(pre[pi], torch.int32)
        p.node_scode[pi] = k.node_scode[pi] if k.multi else -1
    progs, pidx = [], []
    for pi, hop in enumerate(k.hops, start=1):
        p.hop_kind[pi] = _KIND[hop.kind]
        p.hop_within[pi] = hop.within
        p.hop_tree[pi] = max(hop.tree, 0)
        p.hop_op[pi] = _OP[hop.op]
        if hop.prog is not None:
            pidx.append(pi)
            progs.append(hop.prog)
            p.prog_vt[pi] = hop.prog.vt
    words, consts, offs, lens = merge_programs(
        progs, {"__base_ts__": ev["__base_ts__"]})
    if len(words) > MAXWORDS or len(consts) > MAXCONST:
        raise ValueError("scan_chase: hop programs exceed the VM budget")
    for pi, o, ln in zip(pidx, offs, lens):
        p.prog_off[pi], p.prog_len[pi] = o, ln
    for i, c in enumerate(consts):
        p.consts[i] = c
    for i, w in enumerate(words):
        p.words[i] = w
    for i, h in enumerate(heaps):
        p.heap[i] = ptr(h)
        p.heap_vt[i] = VT_OF_TORCH[h.dtype]
    for i, (key, pos) in enumerate(k.loads):
        col = ev[key]
        p.load_col[i] = ptr(col)
        p.load_vt[i] = VT_OF_TORCH[col.dtype]
        p.load_pos[i] = pos
    status = torch.empty((L, F), dtype=torch.uint8, device=dev)
    idx = torch.empty((k.S - 1, L, F), dtype=torch.int32, device=dev)
    p.status, p.idx = ptr(status), ptr(idx)
    lib = load("scan_chase")
    fn = lib.scan_chase_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ctypes.byref(p),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
          "scan_chase_launch")
    LAUNCHES["scan_chase"] += 1
    return status, idx
