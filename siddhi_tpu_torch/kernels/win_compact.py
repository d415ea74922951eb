"""K8 `win_compact`: stable compaction of masked rows to the front.

Replaces `compact` inside the window step of the JAX package
(siddhi_tpu/core/window_device.py:803-807, used at :835-838): the
filter-passing events of a batch move to slots 0..k-1 of T-slot buffers,
in arrival order, with the timestamps and every column the step carries;
the slots k..T-1 take a per-column pad (the timestamp pad 2^62, zeros).
The window plan also compacts its output rows with it (the
`emit & having` mask of K1's `window_select` use).

Design (csrc/win_compact.cu): one kernel launch a call, every copy
instantiated by the column's width (1, 4 or 8 bytes: the bits move, the
value type is never read), the columns ordered by width.  Without a mask
(k = n, row r to slot r) a plain copy in 16-byte units plus the pad fill:
no scan, no look-back state, no memset.  With K1's ballot words (bit j
of word w = row 32w+j): tiles of 1024 rows take their first slot from a
decoupled look-back over the word popcounts (state zeroed by a memset in
the launcher when more than one tile lies below n), list their kept rows
in shared memory and write them to consecutive slots; each tile also
writes its own pads without waiting for k (its dropped rows' slots in
[k, n), its own slots at or above n).  JAX's `.at[].set(mode="drop")`
scatters the pads to index T and drops them; no pad is scattered here.
Bound on the H100: bytes (mask words and n rows per column read once, T
slots per column written once).

Host dispatch: one device allocation a call (the look-back state, k and
every output, as views of one byte buffer), the column descriptors in
the parameter block up to INLINE columns (a device table only past
that, so the usual call uploads nothing), the launcher resolved once.

`win_compact()` launches the kernel for CUDA tensors and runs
`win_compact_plain()` (nonzero + index_select) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core.expr import VT_OF_TORCH, const_bits
from .build import load
from .expr_eval import unpack_mask
from .table import DeviceTable, Launch, checked_ptr, stream_of

TILE = 1024         # csrc/win_compact.cu WC_TILE: rows of a masked tile
INLINE = 16         # WC_INLINE: column descriptors in the parameter block
ALIGN = 128         # each output's first byte: a line (16 for the copies)
WIDTHS = (8, 4, 1)  # the kernel's width groups, in its order


class _Col(ctypes.Structure):
    _fields_ = [("in_", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("fill", ctypes.c_ulonglong), ("width", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("T", ctypes.c_longlong),
                ("n_cols", ctypes.c_int), ("launched", ctypes.c_int),
                ("n_w", ctypes.c_int * 3), ("pad", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("mask", "state", "k_out", "table")
    ] + [("inl", _Col * INLINE)]


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


def tiles_below(n: int) -> int:
    """Masked tiles holding rows below n: the look-back's tiles."""
    return -(-n // TILE)


def fill_bits(fill, dtype: torch.dtype, width: int) -> int:
    """The pad's bits in a column of `dtype`, `width` bytes an element
    (what torch.full stores)."""
    if dtype == torch.bool:
        return 1 if fill else 0
    return const_bits(fill, VT_OF_TORCH[dtype]) & ((1 << (8 * width)) - 1)


def layout(n: int, T: int, widths: list, masked: bool) -> tuple:
    """(state bytes, k's offset, each output's offset, size) of a call's
    one byte buffer: the look-back state (masked, more than one tile below
    n: the ticket and a word a tile), k, then each output on a line of its
    own."""
    nstate = 8 * (1 + tiles_below(n)) if masked and tiles_below(n) > 1 \
        else 0
    offs, size = [], -(-(nstate + 4) // ALIGN) * ALIGN
    for w in widths:
        offs.append(size)
        size += -(-T * w // ALIGN) * ALIGN
    return nstate, nstate, offs, size


def width_order(widths: list) -> tuple:
    """(the columns in the kernel's order -- by width 8, 4, 1, stable --
    and the columns of each width)."""
    order = sorted(range(len(widths)), key=lambda i: -widths[i])
    return order, [widths.count(w) for w in WIDTHS]


_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        fn = load("win_compact").win_compact_launch
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def prepare(cols: list, fills: list, n: int, T: int,
            mask: Optional[torch.Tensor] = None) -> Launch:
    """Allocate the outputs (and the look-back state) of one K8 launch
    and fill its parameter block (see `win_compact`)."""
    _check(cols, fills, n, T)
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"win_compact: unsupported device {dev}")
    keep: list = []
    ptr = checked_ptr(keep, dev, "win_compact")
    p = _Params()
    p.n, p.T, p.n_cols = n, T, len(cols)
    widths = []
    for c in cols:
        if c.dim() != 1 or c.shape[0] < n or c.dtype not in VT_OF_TORCH:
            raise ValueError(f"win_compact: column {c.dtype} "
                             f"{tuple(c.shape)} for n={n}")
        widths.append(c.element_size())
    if mask is not None:
        if mask.shape[0] < -(-n // 32):
            raise ValueError(f"win_compact: {mask.shape[0]} mask words for "
                             f"n={n}")
        p.mask = ptr(mask, torch.int32)
    nstate, kpos, offs, size = layout(n, T, widths, mask is not None)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    base = ptr(buf)
    if nstate:
        p.state = base
    p.k_out = base + kpos
    k = buf[kpos:kpos + 4].view(torch.int32)
    outs = [buf[o:o + T * w].view(c.dtype)
            for o, w, c in zip(offs, widths, cols)]
    order, n_w = width_order(widths)
    p.n_w[:] = n_w
    descs = p.inl if len(cols) <= INLINE else (_Col * len(cols))()
    for j, i in enumerate(order):
        d = descs[j]
        d.in_ = ptr(cols[i])
        d.out = base + offs[i]
        d.fill = fill_bits(fills[i], cols[i].dtype, widths[i])
        d.width = widths[i]
    if len(cols) > INLINE:
        tab = DeviceTable()
        tab.field(p, "table", np.frombuffer(bytes(descs), np.uint8),
                  np.uint8)
        keep.append(tab.upload(dev))
    fn = _launch_fn()
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "win_compact_launch", "win_compact", keep, (outs, k))
    launch.params = p     # .launched: the last call's kernel launches
    return launch


def win_compact(cols: list, fills: list, n: int, T: int,
                mask: Optional[torch.Tensor] = None):
    """Compact the rows r < n whose bit is set in `mask` (int32 ballot
    words, or None: every row < n) of the 1-d `cols` into T-slot outputs
    padded with `fills`.  Returns ([outputs], k int32 (1,) tensor)."""
    dev = cols[0].device
    if dev.type == "cpu":
        return win_compact_plain(cols, fills, n, T, mask)
    return prepare(cols, fills, n, T, mask)()
