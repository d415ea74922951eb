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

Design (csrc/expr_eval.cu, the VM's operations in csrc/expr_vm.cuh):
one launch evaluates several programs over the same rows -- every
pre-mask program of a block, as the JAX pass does, or a mask program
and K output programs -- each into its own mask words (`__ballot_sync`,
one word per 32 rows) or output column.  The host decodes each program
once (`decoded`, kept on the Program): an instruction becomes a 16-byte
record with its stack slot (`Program.stack_slots`) and its constant's
bits, and each launch fills in only its loads' column pointers and
storage types, its launch-time constants and its lane parameters' rows
(`decode_programs`); one VM compiled from the repo's sources serves
every query, so nothing is generated per query.  A block stages the
records in shared memory once; a thread evaluates R rows 32 apart
(coalesced reads, one whole mask word a ballot; R = 8 for a launch that
fills the card with it, 2 for a smaller one, `rows_a_thread`) with a
register stack of depth 2 (`depth_class`; deeper programs keep the
stack in local memory; a launch of two-operand compares alone, every
pre-mask of the main paths, no stack: `fused_compare`), and steps the
row map by additions (`row_fields`).  Bound on the H100: bytes -- each
input column read once, each output and mask word written once.

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
import functools
import struct
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.expr import (OPCODES, TORCH_OF_VT, VT_BOOL, VT_F64, VT_I64,
                         VT_OF_TORCH, LaneParams, Program, apply_op,
                         bits_const, cast_to, const_tensor, decode_word)
from . import LAUNCHES
from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of

STAGE_BYTES = 32 * 1024     # programs staged in shared memory up to this
ROWS = (8, 2)               # rows a thread: many rows, few (`rows_a_thread`)
REG_STACK = 2               # register stack; deeper: local memory (class 0)
MAX_ROWS = 2 ** 31 - 1      # rows a launch (the kernel's row map is 32-bit)
INS_DTYPE = np.dtype([("op", "u1"), ("vt", "u1"), ("vt2", "u1"),
                      ("slot", "u1"), ("pad", "i4"), ("arg", "i8")])
PROG_DTYPE = np.dtype([("first", "i4"), ("len", "i4"), ("sink_vt", "i4"),
                       ("fused", "i4"), ("sink", "u8")])
_ARG = struct.Struct("<q")            # INS_DTYPE's `arg`, at byte 8
_PROG = struct.Struct("<iiiiQ")       # a PROG_DTYPE record
_COMPARES = ("lt", "le", "gt", "ge", "eq", "ne")


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


class _Div(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint) for n in (
        "d", "magic", "shift", "step_q", "step_r", "pad")]


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n", "n_ins", "n_progs", "tiles", "stage", "lanes", "smem",
        "grid", "wpb", "esel", "lsel", "depth", "rows", "pad0")] + [
        (n, _Div) for n in ("cd", "cm", "ld", "lm", "dv")] + [
        (n, ctypes.c_void_p) for n in ("lane_col", "ins", "progs")]


def int_divider(d: int) -> tuple:
    """(d, magic, shift, 32 // d, 32 % d) for x // d = (umulhi(x, magic)
    + x) >> shift over x < 2^31 (PyTorch's IntDivider); d = 0 (no
    modulo) gives zeros."""
    if d == 0:
        return 0, 0, 0, 0, 0
    if not 1 <= d <= MAX_ROWS:
        raise ValueError(f"expr_eval: divisor {d} out of range")
    shift = (d - 1).bit_length()
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return d, magic, shift, 32 // d, 32 % d


@functools.lru_cache(maxsize=None)
def _divider(d: int) -> _Div:
    return _Div(*int_divider(d))


def rows_a_thread(n: int, sms: int) -> int:
    """Rows a thread of a launch of n rows on a card of `sms` SMs: 8 when
    every SM gets a full block of 256 threads at 8 rows each, else 2 (at
    8 a thread a smaller launch leaves SMs idle and its latency grows:
    on the card 2 was the faster below that, 8 above)."""
    return ROWS[0] if n >= ROWS[0] * 256 * sms else ROWS[1]


_SMS: dict = {}


def sm_count(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def row_fields(rows: "RowMap", lanes: bool) -> tuple:
    """How the kernel steps a row's element and lane (`lanes`: the
    programs read lane parameters through the map): (esel, lsel, dv),
    each field 0 (the row itself / no lane), 1 (r % dv), 2 (r // dv) or
    3 (its own map, (r // div) % mod) -- one counter over dv serves both
    fields where they divide by the same number (the lane grid: element
    r % F, lane r // F; the (T, P) grids: element r // P or r, lane
    r % P)."""
    def field(div, mod):
        if div == 1 and mod == 0:
            return 0, 1
        if div == 1:
            return 1, mod
        if mod == 0:
            return 2, div
        return 3, 0
    esel, ediv = field(rows.col_div, rows.col_mod)
    lsel, ldiv = field(rows.lane_div, rows.lane_mod) if lanes else (0, 1)
    if lanes and lsel == 0:     # lane r: its own map, no shared counter
        lsel = 3
    if esel in (1, 2) and lsel in (1, 2) and ediv != ldiv:
        lsel = 3
    dv = ediv if esel in (1, 2) else ldiv if lsel in (1, 2) else 0
    return esel, lsel, dv


def fused_compare(prog: Program) -> int:
    """The kernel's fused path for a program that only compares two
    operands -- push a [cast a] push b [cast b] compare, each push a
    load, a constant or a lane parameter: 1, plus 2 where a is cast and
    4 where b is; 0 for any other program (the stack interpreter)."""
    ops = [decode_word(prog.words[i])[0] for i in range(0, len(prog.words),
                                                         2)]
    pushes = ("load", "const", "qparam")
    if not 3 <= len(ops) <= 5 or ops[0] not in pushes or \
            ops[-1] not in _COMPARES:
        return 0
    mid = ops[1:-1]
    shapes = {("p",): 1, ("c", "p"): 3, ("p", "c"): 5, ("c", "p", "c"): 7}
    key = tuple("p" if o in pushes else "c" if o == "cast" else "x"
                for o in mid)
    return shapes.get(key, 0)


def depth_class(progs: list) -> int:
    """The kernel instantiation for a launch: -1 (no stack) where every
    program is a fused compare, else REG_STACK (the stack in registers)
    where every program fits in it, 0 (the stack in local memory) for a
    deeper one."""
    if all(decoded(p).fused for p in progs):
        return -1
    return REG_STACK if max(p.depth for p in progs) <= REG_STACK else 0


def _vm_bits(bits: int, vt: int) -> int:
    """A constant's 64 bits as the VM's `vm_const` leaves them (the low
    32 for a 32-bit type), as an int64."""
    if vt in (VT_I64, VT_F64):
        return int(np.int64(np.uint64(bits & (2 ** 64 - 1))))
    return bits & 0xFFFFFFFF


class Form(NamedTuple):
    """A program's instruction records as the host decodes them once
    (INS_DTYPE's bytes; a load's column pointer and storage type, a
    launch-time constant's bits and a lane parameter's address left for
    each launch to fill in), where those go, and its fused-compare
    code."""
    recs: bytes
    loads: tuple                # (record, column) of each load
    qparams: tuple              # (record, parameter row) of each qparam
    named: tuple                # (record, pool index, vt): launch-time consts
    fused: int                  # `fused_compare`


def _decode(prog: Program) -> Form:
    n = len(prog.words) // 2
    recs = np.zeros(n, dtype=INS_DTYPE)
    at: dict = {"load": [], "qparam": [], "const": []}
    for k in range(n):
        op, vt, vt2 = decode_word(prog.words[2 * k])
        arg = prog.words[2 * k + 1]
        recs[k] = (OPCODES[op], vt, vt2, prog.stack_slots[k], 0, 0)
        if op == "const" and not isinstance(prog.consts[arg], str):
            recs["arg"][k] = _vm_bits(prog.consts[arg], vt)
        elif op in at:
            at[op].append((k, arg, vt) if op == "const" else (k, arg))
    return Form(recs.tobytes(), tuple(at["load"]), tuple(at["qparam"]),
                tuple(at["const"]), fused_compare(prog))


def decoded(prog: Program) -> Form:
    """The program's records, decoded on first use and kept on it."""
    if prog.decoded is None:
        prog.decoded = _decode(prog)
    return prog.decoded


def decode_programs(progs: list, params: Optional[dict], col_ptrs: list,
                    col_vts: list, qparams: Optional[LaneParams]) -> tuple:
    """The instruction records of one launch of `progs` (INS_DTYPE) and
    each program's (first record, length): each program's decoded
    records with its loads' column pointers and storage types, its
    launch-time constants' bits and its `qparam` operands' addresses (of
    their parameter's P lane values) filled in."""
    forms = [decoded(p) for p in progs]
    buf = bytearray(b"".join(f.recs for f in forms))
    size = INS_DTYPE.itemsize
    spans, first = [], 0
    for prog, f in zip(progs, forms):
        spans.append((first, len(f.recs) // size))
        for k, col in f.loads:
            at = size * (first + k)
            buf[at + 2] = col_vts[col]
            _ARG.pack_into(buf, at + 8, col_ptrs[col])
        for k, row in f.qparams:
            _ARG.pack_into(buf, size * (first + k) + 8,
                           qparams.bits.data_ptr() + 8 * row * qparams.P)
        if f.named:
            vals = prog.resolve_consts(params)
            for k, arg, vt in f.named:
                _ARG.pack_into(buf, size * (first + k) + 8,
                               _vm_bits(vals[arg], vt))
        first += spans[-1][1]
    return np.frombuffer(buf, dtype=INS_DTYPE), spans


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


def _plain_env(cols: list, n: int, rows: Optional[RowMap]) -> tuple:
    """The columns at each row's element and each row's lane parameters
    (`qcols[i]`), as the row map says."""
    qcols = None
    if rows is not None:
        dev = cols[0].device if cols else torch.device("cpu")
        el = rows.elements(n, dev)
        if el is not None:
            cols = [c[el] for c in cols]
        if rows.qparams is not None:
            ln = rows.lanes(n, dev)
            qcols = [v[ln] for v in rows.qparams.values]
    return cols, qcols


def expr_eval_plain(cols: list, mask_prog: Optional[Program],
                    out_progs: list, n: int, params: Optional[dict] = None,
                    rows: Optional[RowMap] = None):
    words, consts, offs, lens = merge_programs(
        ([mask_prog] if mask_prog is not None else []) + list(out_progs),
        params)
    progs = [words[o:o + ln] for o, ln in zip(offs, lens)]
    cols, qcols = _plain_env(cols, n, rows)
    mask_words = None
    if mask_prog is not None:
        mask_words = pack_mask(vm_run_plain(progs.pop(0), consts, cols, n,
                                            qcols))
    outs = [vm_run_plain(p, consts, cols, n, qcols) for p in progs]
    return mask_words, outs


def expr_masks_plain(cols: list, progs: list, n: int,
                     params: Optional[dict] = None,
                     rows: Optional[RowMap] = None) -> list:
    """The plain version of `expr_masks`: each program's mask words."""
    words, consts, offs, lens = merge_programs(progs, params)
    cols, qcols = _plain_env(cols, n, rows)
    return [pack_mask(vm_run_plain(words[o:o + ln], consts, cols, n, qcols))
            for o, ln in zip(offs, lens)]


def _prepare(cols: list, progs: list, sinks: list, n_masks: int, n: int,
             params: Optional[dict], use: str, rows: Optional[RowMap],
             outputs) -> Launch:
    """One K1 launch of `progs` over rows [0, n), program i into
    `sinks[i]`: mask words for the first `n_masks`, an output column of
    the program's type for the rest; `outputs` is what the launch
    returns."""
    counter = f"expr_eval:{use}"
    if counter not in LAUNCHES:
        raise ValueError(f"expr_eval: unknown use {use!r}")
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    if not progs or n > MAX_ROWS:
        raise ValueError(f"expr_eval: {len(progs)} programs over {n} rows "
                         f"(1 or more programs, at most {MAX_ROWS} rows)")
    rows = rows or RowMap()
    keep: list = []
    ptr = checked_ptr(keep, dev, "expr_eval")
    need = n if rows.col_mod == 0 and rows.col_div == 1 else \
        (rows.col_mod or -(-n // rows.col_div))
    col_ptrs, col_vts = [], []
    for i, c in enumerate(cols):
        if c.device != dev or not c.is_contiguous() or c.dim() != 1 \
                or c.shape[0] < need or c.dtype not in VT_OF_TORCH:
            raise ValueError(f"expr_eval: column {i} must be a contiguous "
                             f"1-d {dev} tensor of >= {need} rows")
        col_ptrs.append(ptr(c))
        col_vts.append(VT_OF_TORCH[c.dtype])
    p = _Params()
    p.rows = rows_a_thread(n, sm_count(dev))
    p.n, p.n_progs, p.tiles = n, len(progs), -(-n // (32 * p.rows))
    p.depth = depth_class(progs)
    qparams = rows.qparams
    if qparams is not None and any(len(decoded(pr).qparams)
                                   for pr in progs):
        keep.append(qparams.bits)
        if rows.lane_col is not None:
            p.lanes = 2
            p.lane_col = ptr(rows.lane_col, torch.int32)
        else:
            p.lanes = 1
    p.esel, p.lsel, dv = row_fields(rows, p.lanes == 1)
    p.cd, p.cm = _divider(rows.col_div), _divider(rows.col_mod)
    p.ld, p.lm = _divider(rows.lane_div), _divider(rows.lane_mod)
    p.dv = _divider(dv)
    recs, spans = decode_programs(progs, params, col_ptrs, col_vts, qparams)
    table = np.frombuffer(b"".join(
        _PROG.pack(first, length, -1 if i < n_masks else prog.vt,
                   decoded(prog).fused, ptr(sink))
        for i, ((first, length), prog, sink) in enumerate(zip(
            spans, progs, sinks))), dtype=PROG_DTYPE)
    p.n_ins = len(recs)
    p.smem = recs.nbytes + table.nbytes
    p.stage = int(p.smem <= STAGE_BYTES)
    tab = DeviceTable()
    tab.field(p, "ins", recs, INS_DTYPE)
    tab.field(p, "progs", table, PROG_DTYPE)
    keep.append(tab.upload(dev))
    fn = load("expr_eval").expr_eval_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "expr_eval_launch", counter, keep, outputs)
    launch.params = p        # .depth, .rows, .tiles; the launcher sets
    return launch            # .grid and .wpb


def prepare(cols: list, mask_prog: Optional[Program], out_progs: list,
            n: int, params: Optional[dict] = None, *, use: str,
            rows: Optional[RowMap] = None) -> Launch:
    """Allocate the outputs and upload the parameter table of one K1
    launch on the columns' CUDA device (see `expr_eval`)."""
    dev = cols[0].device
    mask_words = None
    if mask_prog is not None:
        mask_words = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
    outs = [torch.empty(n, dtype=TORCH_OF_VT[prog.vt], device=dev)
            for prog in out_progs]
    progs = ([mask_prog] if mask_prog is not None else []) + list(out_progs)
    sinks = ([mask_words] if mask_prog is not None else []) + outs
    return _prepare(cols, progs, sinks, int(mask_prog is not None), n,
                    params, use, rows, (mask_words, outs))


def prepare_masks(cols: list, progs: list, n: int,
                  params: Optional[dict] = None, *, use: str,
                  rows: Optional[RowMap] = None) -> Launch:
    """One K1 launch of every mask program in `progs` (see
    `expr_masks`)."""
    dev = cols[0].device
    words = [torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
             for _ in progs]
    return _prepare(cols, list(progs), words, len(words), n, params, use,
                    rows, words)


def expr_eval(cols: list, mask_prog: Optional[Program], out_progs: list,
              n: int, params: Optional[dict] = None, *, use: str,
              rows: Optional[RowMap] = None):
    """Run the mask program and the output programs over rows [0, n) of
    `cols` (1-d tensors; a program's load of slot i reads cols[i] at the
    row's element of `rows`, by default the row itself), in one launch.
    `use` ("filter", "pre_mask", "select", "window_args", "window_select"
    or "join_filter") names the launch counter.
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


def expr_masks(cols: list, progs: list, n: int,
               params: Optional[dict] = None, *, use: str,
               rows: Optional[RowMap] = None) -> list:
    """Every mask program of `progs` over rows [0, n) in ONE launch (a
    block's pre-masks, as the JAX package evaluates them in one fused
    pass): one int32 word array (ceil(n/32),) per program."""
    if f"expr_eval:{use}" not in LAUNCHES:
        raise ValueError(f"expr_eval: unknown use {use!r}")
    dev = cols[0].device if cols else None
    if dev is None or dev.type == "cpu":
        return expr_masks_plain(cols, progs, n, params, rows)
    launch = prepare_masks(cols, progs, n, params, use=use, rows=rows)
    if n == 0:
        return launch.outputs
    return launch()
