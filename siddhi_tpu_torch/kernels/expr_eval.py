"""K1 `expr_eval`: the predicate/projection VM over typed columns.

Replaces three jitted device programs of the JAX package:
  * `FilterProjectPlan._make_step` (siddhi_tpu/core/planner.py:306): filter
    mask & having mask, computed selector columns, the mask bit-packed into
    32-bit words (bit j of word w = row 32w+j, planner.py:324-330);
  * `NFAKernel._pre_masks` (siddhi_tpu/core/nfa_device.py:1489): the
    event-only conjuncts over the whole (T, P) event grid;
  * the pattern selector and `having` over the compacted match rows
    (nfa_device.py:1619-1640, inside the block program there).

Design (csrc/expr_eval.cu, VM in csrc/expr_vm.cuh): one thread per row
interprets one mask program (optional) and K output programs over C typed
input columns; the mask leaves as `__ballot_sync` words, one per warp.
One VM compiled from the repo's sources serves every query, so nothing is
generated per query.  Bound on the H100: bytes -- each input column read
once, each output written once, over 3.35 TB/s; the interpreter's
instruction dispatch is the work per row, a few dozen instructions for
the repo's predicates.

`expr_eval()` launches the kernel for CUDA tensors and runs the plain
version, `expr_eval_plain()` (the same programs interpreted with torch ops
over whole columns), for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import (TORCH_OF_VT, VT_BOOL, VT_OF_TORCH, Program,
                         apply_op, bits_const, cast_to, const_tensor,
                         decode_word)
from . import LAUNCHES
from .build import check, load

MAXC, MAXOUT, MAXCONST, MAXWORDS = 32, 16, 48, 512   # csrc/expr_eval.cu


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong),
                ("n_cols", ctypes.c_int), ("n_out", ctypes.c_int),
                ("has_mask", ctypes.c_int), ("pad0", ctypes.c_int),
                ("mask_words", ctypes.c_void_p),
                ("cols", ctypes.c_void_p * MAXC),
                ("outs", ctypes.c_void_p * MAXOUT),
                ("col_vt", ctypes.c_int * MAXC),
                ("out_vt", ctypes.c_int * MAXOUT),
                ("prog_off", ctypes.c_int * (MAXOUT + 1)),
                ("prog_len", ctypes.c_int * (MAXOUT + 1)),
                ("consts", ctypes.c_longlong * MAXCONST),
                ("words", ctypes.c_int * MAXWORDS)]


def merge_programs(progs: list, params: Optional[dict] = None):
    """One word array + one constant pool for several programs: returns
    (words, consts, offsets, lengths) with const operands re-indexed."""
    words, consts, offs, lens = [], [], [], []
    for p in progs:
        vals = p.resolve_consts(params)
        offs.append(len(words))
        for i in range(0, len(p.words), 2):
            w, arg = p.words[i], p.words[i + 1]
            if decode_word(w)[0] == "const":
                v = vals[arg]
                if v not in consts:
                    consts.append(v)
                arg = consts.index(v)
            words.extend([w, arg])
        lens.append(len(p.words))
    return words, consts, offs, lens


def vm_run_plain(words: list, consts: list, cols: list, n: int
                 ) -> torch.Tensor:
    """Interpret one VM program over whole columns (the plain version of
    the per-row loop in csrc/expr_vm.cuh)."""
    dev = cols[0].device if cols else torch.device("cpu")
    stack: list = []
    for i in range(0, len(words), 2):
        op, vt, vt2 = decode_word(words[i])
        arg = words[i + 1]
        if op == "load":
            col = cols[arg][:n]
            stack.append(col.to(torch.bool) if vt == VT_BOOL else col)
        elif op == "const":
            stack.append(const_tensor(bits_const(consts[arg], vt),
                                      TORCH_OF_VT[vt], dev))
        elif op == "cast":
            stack.append(cast_to(stack.pop(), TORCH_OF_VT[vt]))
        else:
            k = 3 if op == "select" else 1 if op in (
                "not", "abs", "sqrt", "floor", "ceil") else 2
            args = stack[-k:]
            del stack[-k:]
            stack.append(apply_op(op, args))
    (out,) = stack
    return out.expand(n) if out.dim() == 0 else out


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (ceil(n/32),) int32 words, bit j of word w = row 32w+j."""
    n = mask.shape[0]
    pad = -(-n // 32) * 32
    m = torch.zeros(pad, dtype=torch.int64, device=mask.device)
    m[:n] = mask.to(torch.int64)
    w = (m.view(-1, 32) << torch.arange(32, device=mask.device)).sum(1)
    return (w - (w >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> torch.arange(32, device=words.device)) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def expr_eval_plain(cols: list, mask_prog: Optional[Program],
                    out_progs: list, n: int, params: Optional[dict] = None):
    words, consts, offs, lens = merge_programs(
        ([mask_prog] if mask_prog is not None else []) + list(out_progs),
        params)
    progs = [words[o:o + ln] for o, ln in zip(offs, lens)]
    mask_words = None
    if mask_prog is not None:
        mask_words = pack_mask(vm_run_plain(progs.pop(0), consts, cols, n))
    outs = [vm_run_plain(p, consts, cols, n) for p in progs]
    return mask_words, outs


def expr_eval(cols: list, mask_prog: Optional[Program], out_progs: list,
              n: int, params: Optional[dict] = None, *, use: str):
    """Run the mask program and the output programs over rows [0, n) of
    `cols` (1-d tensors; a program's load of slot i reads cols[i]).
    `use` ("filter", "pre_mask" or "select") names the launch counter.
    Returns (mask words int32 (ceil(n/32),) or None, [output tensors])."""
    counter = f"expr_eval:{use}"
    if counter not in LAUNCHES:
        raise ValueError(f"expr_eval: unknown use {use!r}")
    dev = cols[0].device if cols else None
    if dev is None or dev.type == "cpu":
        return expr_eval_plain(cols, mask_prog, out_progs, n, params)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    if len(cols) > MAXC or len(out_progs) > MAXOUT:
        raise ValueError(f"expr_eval: {len(cols)} columns / {len(out_progs)} "
                         f"outputs exceed {MAXC}/{MAXOUT}")
    progs = ([mask_prog] if mask_prog is not None else []) + list(out_progs)
    words, consts, offs, lens = merge_programs(progs, params)
    if len(words) > MAXWORDS or len(consts) > MAXCONST:
        raise ValueError(f"expr_eval: programs of {len(words)} words / "
                         f"{len(consts)} constants exceed "
                         f"{MAXWORDS}/{MAXCONST}")
    p = _Params()
    p.n = n
    p.n_cols, p.n_out = len(cols), len(out_progs)
    p.has_mask = int(mask_prog is not None)
    for i, c in enumerate(cols):
        if c.device != dev or not c.is_contiguous() or c.dim() != 1 \
                or c.shape[0] < n or c.dtype not in VT_OF_TORCH:
            raise ValueError(f"expr_eval: column {i} must be a contiguous "
                             f"1-d {dev} tensor of >= {n} rows")
        p.cols[i] = c.data_ptr()
        p.col_vt[i] = VT_OF_TORCH[c.dtype]
    outs = []
    for i, prog in enumerate(out_progs):
        o = torch.empty(n, dtype=TORCH_OF_VT[prog.vt], device=dev)
        outs.append(o)
        p.outs[i] = o.data_ptr()
        p.out_vt[i] = prog.vt
    for i, (o, ln) in enumerate(zip(offs, lens)):
        p.prog_off[i], p.prog_len[i] = o, ln
    for i, c in enumerate(consts):
        p.consts[i] = c
    for i, w in enumerate(words):
        p.words[i] = w
    mask_words = None
    if mask_prog is not None:
        mask_words = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
        p.mask_words = mask_words.data_ptr()
    if n > 0:
        lib = load("expr_eval")
        fn = lib.expr_eval_launch
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        check(fn(ctypes.byref(p),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
              "expr_eval_launch")
        LAUNCHES[counter] += 1
    return mask_words, outs
