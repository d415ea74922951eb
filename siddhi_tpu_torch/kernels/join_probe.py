"""K9 `join_probe`: one probe direction of the device window join.

Replaces the jitted join block of the JAX package
(siddhi_tpu/core/join_device.py, `DeviceJoinPlan._block_fn` :261, jit
:409) for one direction: window membership by rank arithmetic and the
`on` condition over the pairs (`probes`, :294-327), the count-then-compact
of the matched (a, b) pairs into M slots (`compact_pairs`, :329-336), the
computed selector columns over the pairs (`computed_cols`, :338-357) and,
for an outer side, the miss words of the probes that matched nothing
(:382-385, bit j of word w = probe 32w + j as `bits32` packs them).  The
plan launches it once per triggering direction (left probes the right
window, right probes the left); the side filters run before it on K1
(use `join_filter`).

Inputs of one direction: the probe side's columns (rows [0, n_p)), seqs
and pass words; the opposite side's columns as (mirror, batch) pairs --
the mirror holds its window content before the batch, Lo = `Lo` valid
rows of NO = max(window length, 1), the batch n_o rows sorted by seq --,
its seqs and pass words; its window length Mw (0: windowless, nothing
visible).  A pass-word tensor of None means every row passes.  Programs
of the predicate VM (core/expr.py `emit_program`): `on` (or None: every
visible pair matches) and the computed selector outputs; a load of slot
i < len(p_cols) reads the probe's column i at the pair's probe, slot
len(p_cols) + j the opposite union column j at the pair's union index.

Union indices are the JAX package's: mirror slot p is p, the j-th batch
row is NO + j.  A probe a sees the opposite positions [max(nlt - Mw, 0),
nlt), nlt = Lo + #(passed batch rows with a smaller seq) (a strict `<`,
so in a self-join an event never sees itself), where position p < Lo is
mirror slot p and p >= Lo the (p - Lo)-th passed batch row.  Pairs go in
(a, then b) order, JAX's flat-grid order; past M slots they are counted
and not written.

Returns (total, pa, pb, outs, miss): total a (1,) int64 tensor (the pair
count, which may exceed M), pa / pb the (M,) int32 probe and union
indices (-1 past the total), outs one (M,) column per computed program
(0 past the total), miss the (ceil(n_p/32),) int32 words when `outer`,
else None.

Design (csrc/join_probe.cu): O(T_p * Mw) pair tests instead of JAX's
dense (T_p, NO + T_o) grid, in one kernel launch a direction (two under
an opposite filter, whose ranks come first from a single-pass
look-back scan).  Persistent blocks take tiles of TP consecutive probes
(TP = 4..32: the most that still gives four tiles a streaming
multiprocessor, fewer where a tile's match bitmap, TP x (Mw + 32) bits,
would pass 32 KB; past one probe's worth the bitmaps go to device
memory), stage the opposite columns of the tile's window 256 positions
at a time in a cp.async ring in shared memory, run `on` once per
visible pair from there (four probes a pass, the interpreter's stacks in
shared memory, as deep as `on` needs: `Program.depth`), keep the match
bits, take the tile's first pair slot from a decoupled look-back over the
earlier tiles' counts and write the pairs in (a, then b) order; the last
block to finish fills the slots past the total.  The look-back state is
each prepared launch's own tensor, zeroed by a memset in the launcher
before the kernels, so its replays (a CUDA graph's too) start clean and
no two launches share it: a call is one memset and one kernel launch
(two under an opposite filter).  `Launch.params` after a launch holds
its geometry: `tp`, `ntiles`, `chunk` and `group` (the kernel's window
positions a ring slot and probes a pass, which its launcher checks
against CHUNK and GROUP, the sizes the shared-memory layout was made
for) and `launched`, the kernels it launched.  `join_probe_plain`
computes the same function with torch ops on (chunk, Mw) position grids
built by the same rank arithmetic; it is used for CPU tensors (the
tests) and by the checks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import TORCH_OF_VT, VT_OF_TORCH, Program
from .build import load
from .expr_eval import merge_programs, pack_mask, program_table, \
    stage_bytes, unpack_mask, vm_run_plain
from .table import DeviceTable, Launch, checked_ptr, stream_of

THREADS = 256                   # a probe block's threads (JP_THREADS)
CHUNK = 256                     # window positions a ring slot (JP_CHUNK)
GROUP = 4                       # probes one pass of `on` tests (JP_GROUP)
RANK_TILE = 256 * 32            # opposite events a rank tile
BITS_BYTES = 32 * 1024          # a tile's match bitmap in shared memory
BLOCKS_PER_SM = 4               # persistent probe blocks a multiprocessor
SMEM_MAX = 227 * 1024
PLAIN_GRID = 1 << 22            # pair positions per chunk of the plain version


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_p", "n_o", "Lo", "NO", "Mw", "M", "n_pc", "n_oc", "n_out",
        "has_on", "n_words", "n_consts", "stage", "tp", "rw", "ntiles",
        "nrt", "chunk", "group", "launched", "off_vt", "off_probe", "off_win", "off_bits",
        "off_stack", "smem")] + \
        [(n, ctypes.c_void_p) for n in (
            "p_cols", "o_mcols", "o_bcols", "p_vt", "o_vt", "p_seq", "o_seq",
            "p_pass", "o_pass", "outs", "out_vt", "prog_off", "prog_len",
            "consts", "words", "o_rank", "o_idx", "state", "gbits",
            "total", "pa", "pb", "miss")]


def geometry(n_p: int, Mw: int, has_on: bool, sms: int) -> tuple:
    """(TP, bitmap words a probe, bitmap in shared memory): probes a tile
    halve from 32 down to 4 until the tiles give every multiprocessor
    four, and further (down to 1) until a tile's bitmap fits BITS_BYTES;
    a single probe's that does not fit goes to device memory."""
    tp = 32
    while tp > 4 and n_p < BLOCKS_PER_SM * sms * tp:
        tp //= 2
    rw = (Mw + 30) // 32 + 1 if Mw > 0 else 1
    if not has_on:
        return tp, rw, True
    while tp > 1 and 4 * tp * rw > BITS_BYTES:
        tp //= 2
    return tp, rw, 4 * tp * rw <= BITS_BYTES


def _pass_mask(words: Optional[torch.Tensor], n: int, dev) -> torch.Tensor:
    if words is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return unpack_mask(words, n)


def visible(p_seq, o_seq, p_pass, o_pass, n_p: int, n_o: int, Lo: int,
            Mw: int) -> tuple:
    """(lo, hi) int64 (n_p,): the opposite positions [lo, hi) each probe
    sees (lo == hi for a probe that fails its filter), and the batch index
    of every passed opposite row in rank order."""
    dev = p_seq.device
    opass = _pass_mask(o_pass, n_o, dev)
    excl = torch.zeros(n_o + 1, dtype=torch.int64, device=dev)
    excl[1:] = torch.cumsum(opass.to(torch.int64), 0)
    c = torch.searchsorted(o_seq[:n_o].contiguous(),
                           p_seq[:n_p].contiguous(), side="left")
    hi = Lo + excl[c]
    lo = torch.clamp(hi - Mw, min=0) if Mw > 0 else hi.clone()
    lo = torch.where(_pass_mask(p_pass, n_p, dev), lo, hi)
    return lo, hi, torch.nonzero(opass).flatten()


def _pair_cols(p_cols, o_cols, n_o: int, NO: int, a, b) -> list:
    """The VM's slot columns gathered at pairs (a, b)."""
    out = [c[a] for c in p_cols]
    for mc, bc in o_cols:
        out.append(torch.cat([mc[:NO], bc[:n_o]])[b])
    return out


def join_probe_plain(p_cols: list, o_cols: list, p_seq, o_seq, p_pass,
                     o_pass, *, n_p: int, n_o: int, Lo: int, NO: int,
                     Mw: int, on: Optional[Program], outs: list, M: int,
                     outer: bool) -> tuple:
    """The plain PyTorch version of K9 (see the module docstring)."""
    dev = p_seq.device
    lo, hi, o_idx = visible(p_seq, o_seq, p_pass, o_pass, n_p, n_o, Lo, Mw)
    o_idx = torch.cat([o_idx, torch.zeros(1, dtype=torch.int64,
                                          device=dev)])
    words, consts, offs, lens = merge_programs(
        ([on] if on is not None else []) + list(outs))
    progs = [words[o:o + ln] for o, ln in zip(offs, lens)]
    on_words = progs.pop(0) if on is not None else None
    width = int((hi - lo).max()) if n_p else 0
    chunk = max(1, PLAIN_GRID // max(width, 1))
    counts = torch.zeros(n_p, dtype=torch.int64, device=dev)
    a_parts, b_parts = [], []
    for s in range(0, n_p if width else 0, chunk):
        e = min(n_p, s + chunk)
        k = torch.arange(width, device=dev)
        pos = lo[s:e, None] + k
        ok = pos < hi[s:e, None]
        b = torch.where(pos < Lo, pos,
                        NO + o_idx[torch.clamp(pos - Lo, 0, len(o_idx) - 1)])
        b = torch.where(ok, b, torch.zeros_like(b))
        a = torch.arange(s, e, device=dev)[:, None].expand_as(b)
        m = ok
        if on_words is not None:
            cols = _pair_cols(p_cols, o_cols, n_o, NO, a.reshape(-1),
                              b.reshape(-1))
            m = ok & vm_run_plain(on_words, consts, cols, ok.numel()).to(
                dev).view(ok.shape)
        counts[s:e] = m.sum(1)
        a_parts.append(a[m])
        b_parts.append(b[m])
    total = int(counts.sum())
    k = min(total, M)
    pa = torch.full((M,), -1, dtype=torch.int32, device=dev)
    pb = torch.full((M,), -1, dtype=torch.int32, device=dev)
    a_all = torch.cat(a_parts)[:k] if a_parts else pa[:0].long()
    b_all = torch.cat(b_parts)[:k] if b_parts else pb[:0].long()
    pa[:k] = a_all.to(torch.int32)
    pb[:k] = b_all.to(torch.int32)
    cols = _pair_cols(p_cols, o_cols, n_o, NO, a_all, b_all)
    out_cols = []
    for prog, words_k in zip(outs, progs):
        o = torch.zeros(M, dtype=TORCH_OF_VT[prog.vt], device=dev)
        o[:k] = vm_run_plain(words_k, consts, cols, k).to(dev)
        out_cols.append(o)
    miss = None
    if outer:
        miss = pack_mask(_pass_mask(p_pass, n_p, dev) & (counts == 0))
    return (torch.tensor([total], dtype=torch.int64, device=dev), pa, pb,
            out_cols, miss)


def prepare(p_cols: list, o_cols: list, p_seq, o_seq, p_pass, o_pass, *,
            n_p: int, n_o: int, Lo: int, NO: int, Mw: int,
            on: Optional[Program], outs: list, M: int,
            outer: bool) -> Launch:
    """Allocate the outputs and scratch and upload the parameter table of
    one K9 launch on the probe seqs' CUDA device (see `join_probe`)."""
    dev = p_seq.device
    if dev.type != "cuda":
        raise ValueError(f"join_probe: unsupported device {dev}")
    if n_p < 1 or M < 1 or not 0 <= Lo <= NO or n_o < 0 or Mw < 0:
        raise ValueError(f"join_probe: bad sizes n_p={n_p} n_o={n_o} "
                         f"Lo={Lo} NO={NO} Mw={Mw} M={M}")
    keep: list = []
    ptr = checked_ptr(keep, dev, "join_probe")

    def column(t, rows: int, what: str) -> int:
        if t.device != dev or not t.is_contiguous() or t.dim() != 1 or \
                t.shape[0] < rows or t.dtype not in VT_OF_TORCH:
            raise ValueError(f"join_probe: {what} must be a contiguous 1-d "
                             f"{dev} tensor of >= {rows} rows")
        return ptr(t)

    def words_of(t, rows: int, what: str):
        if t is None:
            return None
        if t.shape[0] < -(-rows // 32):
            raise ValueError(f"join_probe: {what} needs {-(-rows // 32)} "
                             f"words")
        return ptr(t, torch.int32)

    p = _Params()
    p.n_p, p.n_o, p.Lo, p.NO, p.Mw, p.M = n_p, n_o, Lo, NO, Mw, M
    p.n_pc, p.n_oc, p.n_out = len(p_cols), len(o_cols), len(outs)
    p.has_on = int(on is not None)
    if p_seq.dtype != torch.int64 or o_seq.dtype != torch.int64 or \
            p_seq.shape[0] < n_p or o_seq.shape[0] < n_o:
        raise ValueError("join_probe: seqs must be int64 covering the rows")
    p.p_seq, p.o_seq = ptr(p_seq), ptr(o_seq)
    p.p_pass = words_of(p_pass, n_p, "p_pass")
    p.o_pass = words_of(o_pass, n_o, "o_pass")
    progs = ([on] if on is not None else []) + list(outs)
    words, consts, offs, lens = merge_programs(progs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p.tp, p.rw, shared_bits = geometry(n_p, Mw, on is not None, sms)
    p.ntiles = -(-n_p // p.tp)
    p.chunk, p.group = CHUNK, GROUP
    p.nrt = max(1, -(-n_o // RANK_TILE)) if o_pass is not None else 0
    grid = min(p.ntiles, BLOCKS_PER_SM * sms)
    o_rank = torch.empty(n_o + 1, dtype=torch.int32, device=dev)
    o_idx = torch.empty(max(n_o, 1), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    pa = torch.empty(M, dtype=torch.int32, device=dev)
    pb = torch.empty(M, dtype=torch.int32, device=dev)
    out_cols = [torch.empty(M, dtype=TORCH_OF_VT[prog.vt], device=dev)
                for prog in outs]
    miss = torch.empty(-(-n_p // 32), dtype=torch.int32, device=dev) \
        if outer else None
    gbits = None
    if on is not None and not shared_bits:
        gbits = torch.empty(grid * p.tp * p.rw, dtype=torch.int32,
                            device=dev)
    # the look-back state (the probe ticket and finish counter, the rank
    # ticket, a word per rank tile and per probe tile): the launch's own,
    # zeroed by a memset in the launcher before its kernels
    state = torch.empty(3 + p.nrt + p.ntiles, dtype=torch.int64, device=dev)
    for name, t in (("o_rank", o_rank), ("o_idx", o_idx), ("state", state),
                    ("gbits", gbits), ("total", total), ("pa", pa),
                    ("pb", pb), ("miss", miss)):
        if t is not None:
            setattr(p, name, ptr(t))
    tab = DeviceTable()
    tab.field(p, "p_cols", [column(c, n_p, f"probe column {i}")
                            for i, c in enumerate(p_cols)] or [0], "u8")
    tab.field(p, "p_vt", [VT_OF_TORCH[c.dtype] for c in p_cols] or [0], "i4")
    tab.field(p, "o_mcols", [column(m, NO, f"mirror column {i}")
                             for i, (m, _b) in enumerate(o_cols)] or [0],
              "u8")
    tab.field(p, "o_bcols", [column(b, n_o, f"batch column {i}")
                             for i, (_m, b) in enumerate(o_cols)] or [0],
              "u8")
    for i, (m, b) in enumerate(o_cols):
        if m.dtype != b.dtype:
            raise ValueError(f"join_probe: opposite column {i} has mirror "
                             f"{m.dtype} and batch {b.dtype}")
    tab.field(p, "o_vt", [VT_OF_TORCH[m.dtype] for m, _b in o_cols] or [0],
              "i4")
    tab.field(p, "outs", [ptr(o) for o in out_cols] or [0], "u8")
    tab.field(p, "out_vt", [prog.vt for prog in outs] or [0], "i4")
    tab.field(p, "prog_off", offs or [0], "i4")
    tab.field(p, "prog_len", lens or [0], "i4")
    program_table(tab, p, words, consts)
    _smem_layout(p, stage_bytes(words, consts),
                 on.depth if on is not None else 0, shared_bits)
    keep.append(tab.upload(dev))
    lib = load("join_probe")
    fn = lib.join_probe_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = Launch(lambda: fn(ctypes.byref(p), grid, stream_of(dev)),
                    "join_probe_launch", "join_probe", keep,
                    (total, pa, pb, out_cols, miss))
    launch.params = p     # .tp, .ntiles, .chunk, .group; .launched: the last
    return launch         # launch's kernels


def _smem_layout(p: _Params, prog_bytes: int, depth: int,
                 shared_bits: bool) -> None:
    """Byte offsets of the probe kernel's dynamic shared memory: the
    staged programs, the columns' value types, the tile's probe rows,
    the two ring slots of staged opposite columns, the match bitmap and
    the `on` program's stacks (`depth` entries of GROUP values a thread;
    0 without `on`)."""
    def up(x: int) -> int:
        return -(-x // 16) * 16
    has_on = depth > 0
    off = up(prog_bytes) if p.stage else 0
    p.off_vt = off
    off = up(off + 4 * (p.n_pc + p.n_oc))
    p.off_probe = off
    off += 8 * p.n_pc * p.tp if has_on else 0
    p.off_win = off
    off += 2 * p.n_oc * CHUNK * 8 if has_on else 0
    p.off_bits = off
    off += 4 * p.tp * p.rw if has_on and shared_bits else 0
    p.off_stack = off
    off += depth * GROUP * THREADS * 8
    if off > SMEM_MAX:
        raise ValueError(f"join_probe: {p.n_oc} opposite columns need "
                         f"{off} bytes of shared memory a block")
    p.smem = off


def join_probe(p_cols: list, o_cols: list, p_seq, o_seq, p_pass, o_pass,
               **kw) -> tuple:
    """Launch K9 for CUDA tensors, run `join_probe_plain` for CPU ones
    (keywords: n_p, n_o, Lo, NO, Mw, on, outs, M, outer; see the module
    docstring)."""
    if p_seq.device.type == "cpu":
        return join_probe_plain(p_cols, o_cols, p_seq, o_seq, p_pass,
                                o_pass, **kw)
    return prepare(p_cols, o_cols, p_seq, o_seq, p_pass, o_pass, **kw)()
