"""K8 `win_compact`: stable compaction of masked rows to the front.

Replaces `compact` inside the window step of the JAX package
(siddhi_tpu/core/window_device.py:803-807, used at :835-838): the
filter-passing events of a batch move to slots 0..k-1 of T-slot buffers,
in arrival order, with the timestamps and every column the step carries;
the slots k..T-1 take a per-column pad (the timestamp pad 2^62, zeros).
The window plan also compacts its output rows with it (the
`emit & having` mask of K1's `window_select` use).

Design (csrc/win_compact.cu): the mask comes as K1's ballot words (bit j
of word w = row 32w+j), or is absent (rows 0..n-1 kept); per-block kept
counts, one block's exclusive scan of them, then a block scan and the
scatter of every column, each thread writing the pad into its own slots
>= k.  JAX's `.at[].set(mode="drop")` scatters the pads to index T and
drops them; torch raises on such an index, and no pad is scattered here.
Bound on the H100: bytes (mask words and n rows per column read once, T
slots per column written once).

`win_compact()` launches the kernel for CUDA tensors and runs
`win_compact_plain()` (nonzero + index_select) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import VT_OF_TORCH, const_bits
from .build import load
from .expr_eval import unpack_mask
from .table import DeviceTable, Launch, checked_ptr, stream_of

TILE = 1024                     # csrc/win_scan.cuh WS_TILE


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("T", ctypes.c_longlong),
                ("n_cols", ctypes.c_int), ("nblocks", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("mask", "blk", "k_out", "in_", "out",
                                       "vt", "fill")]


def _check(cols: list, fills: list, n: int, T: int) -> None:
    if len(cols) != len(fills) or T < n:
        raise ValueError(f"win_compact: {len(cols)} columns, {len(fills)} "
                         f"fills, n={n}, T={T}")


def win_compact_plain(cols: list, fills: list, n: int, T: int,
                      mask: Optional[torch.Tensor] = None):
    _check(cols, fills, n, T)
    dev = cols[0].device
    keep = torch.ones(n, dtype=torch.bool, device=dev) if mask is None \
        else unpack_mask(mask, n)
    idx = torch.nonzero(keep).flatten()
    k = idx.shape[0]
    outs = []
    for c, fill in zip(cols, fills):
        o = torch.full((T,), fill, dtype=c.dtype, device=dev)
        o[:k] = c[idx]
        outs.append(o)
    return outs, torch.tensor([k], dtype=torch.int32, device=dev)


def prepare(cols: list, fills: list, n: int, T: int,
            mask: Optional[torch.Tensor] = None) -> Launch:
    """Allocate the outputs and upload the parameter table of one K8
    launch (see `win_compact`)."""
    _check(cols, fills, n, T)
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"win_compact: unsupported device {dev}")
    keep: list = []
    ptr = checked_ptr(keep, dev, "win_compact")
    p = _Params()
    p.n, p.T, p.n_cols = n, T, len(cols)
    p.nblocks = max(1, -(-T // TILE))
    if mask is not None:
        p.mask = ptr(mask, torch.int32)
    blk = torch.empty(p.nblocks, dtype=torch.int32, device=dev)
    k = torch.empty(1, dtype=torch.int32, device=dev)
    p.blk, p.k_out = ptr(blk), ptr(k)
    outs = [torch.empty(T, dtype=c.dtype, device=dev) for c in cols]
    vts = []
    for c in cols:
        if c.dim() != 1 or c.shape[0] < n or c.dtype not in VT_OF_TORCH:
            raise ValueError(f"win_compact: column {c.dtype} "
                             f"{tuple(c.shape)} for n={n}")
        vts.append(VT_OF_TORCH[c.dtype])
    tab = DeviceTable()
    tab.field(p, "in_", [ptr(c) for c in cols] or [0], "u8")
    tab.field(p, "out", [ptr(o) for o in outs] or [0], "u8")
    tab.field(p, "vt", vts or [0], "i4")
    tab.field(p, "fill", [const_bits(f, vt) for f, vt in zip(fills, vts)]
              or [0], "i8")
    keep.append(tab.upload(dev))
    lib = load("win_compact")
    fn = lib.win_compact_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                  "win_compact_launch", "win_compact", keep, (outs, k))


def win_compact(cols: list, fills: list, n: int, T: int,
                mask: Optional[torch.Tensor] = None):
    """Compact the rows r < n whose bit is set in `mask` (int32 ballot
    words, or None: every row < n) of the 1-d `cols` into T-slot outputs
    padded with `fills`.  Returns ([outputs], k int32 (1,) tensor)."""
    dev = cols[0].device
    if dev.type == "cpu":
        return win_compact_plain(cols, fills, n, T, mask)
    return prepare(cols, fills, n, T, mask)()
