"""K1 `expr_eval`: the predicate/projection VM over typed columns.

Replaces five jitted device programs of the JAX package:
  * `FilterProjectPlan._make_step` (siddhi_tpu/core/planner.py:306): filter
    mask & having mask, computed selector columns, the mask bit-packed into
    32-bit words (bit j of word w = row 32w+j, planner.py:324-330);
  * `NFAKernel._pre_masks` (siddhi_tpu/core/nfa_device.py:1489): the
    event-only conjuncts over the whole (T, P) event grid;
  * the pattern selector and `having` over the compacted match rows
    (nfa_device.py:1619-1640, inside the block program there);
  * inside the window step (siddhi_tpu/core/window_device.py:545): the
    filter mask and the aggregates' argument values over the batch rows
    (:827-838, :562-569; use `window_args`), the selector and `having`
    over the aggregates (`finish`, :594-606; use `window_select`);
  * the join block's side filters (siddhi_tpu/core/join_device.py
    `side_pass`, :283-292; use `join_filter`), their mask words in the
    layout of `bits32` (:273-281), which K9 `join_probe` reads.

Design (csrc/expr_eval.cu, VM in csrc/expr_vm.cuh): one thread per row
interprets one mask program (optional) and K output programs over C typed
input columns; the mask leaves as `__ballot_sync` words, one per warp.
One VM compiled from the repo's sources serves every query, so nothing is
generated per query.  Programs, constants and column pointers travel in
a device table (kernels/table.py); each block stages the programs in
shared memory.  Bound on the H100: bytes -- each input column read once,
each output written once, over 3.35 TB/s; the interpreter's instruction
dispatch is the work per row, a few dozen instructions for the repo's
predicates.

A `RowMap` says which input element and which lane a row reads, so one
launch covers the fused multi-query grids without copying events: on a
(T, P) grid of broadcast (T, 1) event columns row r reads element r // P
of lane r % P; on an (L, F) lane grid over shared (F,) columns, element
r % F of lane r // F; the selector reads the lane of each match row from
its `__qid__` row.  The lane picks the row's `__qparam<i>` values.

`expr_eval()` launches the kernel for CUDA tensors and runs the plain
version, `expr_eval_plain()` (the same programs interpreted with torch ops
over whole columns), for CPU tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.expr import (TORCH_OF_VT, VT_BOOL, VT_OF_TORCH, LaneParams,
                         Program, apply_op, bits_const, cast_to, const_tensor,
                         decode_word)
from . import LAUNCHES
from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of

STAGE_BYTES = 32 * 1024     # programs staged in shared memory up to this


@dataclass
class RowMap:
    """Row r reads element (r // col_div) % col_mod of every column
    (col_mod 0: no modulo) and belongs to lane lane_col[r] when lane_col
    is given, else (r // lane_div) % lane_mod; `qparams` is the lane
    parameter table its `qparam` operands read."""
    col_div: int = 1
    col_mod: int = 0
    lane_div: int = 1
    lane_mod: int = 0
    lane_col: Optional[torch.Tensor] = None
    qparams: Optional[LaneParams] = None

    def elements(self, n: int, dev) -> Optional[torch.Tensor]:
        if self.col_div == 1 and self.col_mod == 0:
            return None
        e = torch.arange(n, device=dev) // self.col_div
        return e % self.col_mod if self.col_mod else e

    def lanes(self, n: int, dev) -> torch.Tensor:
        if self.lane_col is not None:
            return self.lane_col[:n].to(torch.int64)
        ln = torch.arange(n, device=dev) // self.lane_div
        return ln % self.lane_mod if self.lane_mod else ln


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong),
                ("col_div", ctypes.c_longlong), ("col_mod", ctypes.c_longlong),
                ("lane_div", ctypes.c_longlong),
                ("lane_mod", ctypes.c_longlong),
                ("n_cols", ctypes.c_int), ("n_out", ctypes.c_int),
                ("has_mask", ctypes.c_int), ("P", ctypes.c_int),
                ("n_words", ctypes.c_int), ("n_consts", ctypes.c_int),
                ("stage", ctypes.c_int), ("pad0", ctypes.c_int),
                ("mask_words", ctypes.c_void_p),
                ("lane_col", ctypes.c_void_p),
                ("qparams", ctypes.c_void_p),
                ("cols", ctypes.c_void_p), ("outs", ctypes.c_void_p),
                ("col_vt", ctypes.c_void_p), ("out_vt", ctypes.c_void_p),
                ("prog_off", ctypes.c_void_p), ("prog_len", ctypes.c_void_p),
                ("consts", ctypes.c_void_p), ("words", ctypes.c_void_p)]


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


def program_table(tab: DeviceTable, p, words: list, consts: list) -> None:
    """The VM sections of a parameter block: `words`, `consts`, their
    sizes and whether a block stages them in shared memory."""
    tab.field(p, "words", words or [0], "i4")
    tab.field(p, "consts", consts or [0], "i8")
    p.n_words, p.n_consts = len(words), len(consts)
    p.stage = int(stage_bytes(words, consts) <= STAGE_BYTES)


def stage_bytes(words: list, consts: list) -> int:
    return 8 * len(consts) + 4 * len(words) + 8


def vm_run_plain(words: list, consts: list, cols: list, n: int,
                 qcols: Optional[list] = None) -> torch.Tensor:
    """Interpret one VM program over whole columns (the plain version of
    the per-row loop in csrc/expr_vm.cuh); `qcols[i]` holds each row's
    value of `__qparam<i>`."""
    dev = cols[0].device if cols else torch.device("cpu")
    stack: list = []
    for i in range(0, len(words), 2):
        op, vt, vt2 = decode_word(words[i])
        arg = words[i + 1]
        if op == "load":
            col = cols[arg][:n]
            stack.append(col.to(torch.bool) if vt == VT_BOOL else col)
        elif op == "qparam":
            stack.append(qcols[arg][:n])
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
                    out_progs: list, n: int, params: Optional[dict] = None,
                    rows: Optional[RowMap] = None):
    words, consts, offs, lens = merge_programs(
        ([mask_prog] if mask_prog is not None else []) + list(out_progs),
        params)
    progs = [words[o:o + ln] for o, ln in zip(offs, lens)]
    qcols = None
    if rows is not None:
        dev = cols[0].device if cols else torch.device("cpu")
        el = rows.elements(n, dev)
        if el is not None:
            cols = [c[el] for c in cols]
        if rows.qparams is not None:
            ln = rows.lanes(n, dev)
            qcols = [v[ln] for v in rows.qparams.values]
    mask_words = None
    if mask_prog is not None:
        mask_words = pack_mask(vm_run_plain(progs.pop(0), consts, cols, n,
                                            qcols))
    outs = [vm_run_plain(p, consts, cols, n, qcols) for p in progs]
    return mask_words, outs


def prepare(cols: list, mask_prog: Optional[Program], out_progs: list,
            n: int, params: Optional[dict] = None, *, use: str,
            rows: Optional[RowMap] = None) -> Launch:
    """Allocate the outputs and upload the parameter table of one K1
    launch on the columns' CUDA device (see `expr_eval`)."""
    counter = f"expr_eval:{use}"
    if counter not in LAUNCHES:
        raise ValueError(f"expr_eval: unknown use {use!r}")
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    rows = rows or RowMap()
    keep: list = []
    ptr = checked_ptr(keep, dev, "expr_eval")
    progs = ([mask_prog] if mask_prog is not None else []) + list(out_progs)
    words, consts, offs, lens = merge_programs(progs, params)
    p = _Params()
    p.n = n
    p.col_div, p.col_mod = rows.col_div, rows.col_mod
    p.lane_div, p.lane_mod = rows.lane_div, rows.lane_mod
    p.n_cols, p.n_out = len(cols), len(out_progs)
    p.has_mask = int(mask_prog is not None)
    if rows.lane_col is not None:
        p.lane_col = ptr(rows.lane_col, torch.int32)
    if rows.qparams is not None:
        p.qparams = ptr(rows.qparams.bits, torch.int64)
        p.P = rows.qparams.P
    need = n if p.col_mod == 0 and p.col_div == 1 else \
        (rows.col_mod or -(-n // p.col_div))
    col_ptrs, col_vts = [], []
    for i, c in enumerate(cols):
        if c.device != dev or not c.is_contiguous() or c.dim() != 1 \
                or c.shape[0] < need or c.dtype not in VT_OF_TORCH:
            raise ValueError(f"expr_eval: column {i} must be a contiguous "
                             f"1-d {dev} tensor of >= {need} rows")
        col_ptrs.append(ptr(c))
        col_vts.append(VT_OF_TORCH[c.dtype])
    outs = []
    for prog in out_progs:
        o = torch.empty(n, dtype=TORCH_OF_VT[prog.vt], device=dev)
        outs.append(o)
    tab = DeviceTable()
    tab.field(p, "cols", col_ptrs or [0], "u8")
    tab.field(p, "col_vt", col_vts or [0], "i4")
    tab.field(p, "outs", [ptr(o) for o in outs] or [0], "u8")
    tab.field(p, "out_vt", [prog.vt for prog in out_progs] or [0], "i4")
    tab.field(p, "prog_off", offs or [0], "i4")
    tab.field(p, "prog_len", lens or [0], "i4")
    program_table(tab, p, words, consts)
    keep.append(tab.upload(dev))
    mask_words = None
    if mask_prog is not None:
        mask_words = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
        p.mask_words = ptr(mask_words)
    lib = load("expr_eval")
    fn = lib.expr_eval_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                  "expr_eval_launch", counter, keep, (mask_words, outs))


def expr_eval(cols: list, mask_prog: Optional[Program], out_progs: list,
              n: int, params: Optional[dict] = None, *, use: str,
              rows: Optional[RowMap] = None):
    """Run the mask program and the output programs over rows [0, n) of
    `cols` (1-d tensors; a program's load of slot i reads cols[i] at the
    row's element of `rows`, by default the row itself).  `use`
    ("filter", "pre_mask", "select", "window_args", "window_select" or
    "join_filter") names the launch counter.
    Returns (mask words int32 (ceil(n/32),) or None, [output tensors])."""
    if f"expr_eval:{use}" not in LAUNCHES:
        raise ValueError(f"expr_eval: unknown use {use!r}")
    dev = cols[0].device if cols else None
    if dev is None or dev.type == "cpu":
        return expr_eval_plain(cols, mask_prog, out_progs, n, params, rows)
    launch = prepare(cols, mask_prog, out_progs, n, params, use=use,
                     rows=rows)
    if n == 0:
        return launch.outputs
    return launch()
