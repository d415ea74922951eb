"""K6 `win_scan`: multi-column inclusive segmented scans for the window step.

Replaces the scans of the JAX package's window step
(siddhi_tpu/core/window_device.py): the sliding prefix sums (`jnp.cumsum`
:630, `_segmented_prefix` :109 over the group-sorted order), the valid
count (:617), the monotone clock (the cummax at :611), the tumbling
running aggregates with resets at bucket and group boundaries
(`_mono_running_*` :189/:199, `_seg_running_*` :163/:168), and the dense
group ids of `group_seg` (the cumsum of the boundary flags, :588).

A column is `(op, values, masked)` or `(op, values, masked, valid_c)`:
op "sum", "min" or "max" (min and max over floats, max also over
integers, as i64, for the clock); values a 1-d tensor of N entries, or
None: for a sum a count (the value 1), for a max the entry's index within
its segment of `period` entries; masked: an entry whose valid flag is off
adds the identity (0, +inf, -inf, or the i64 minimum), the flag being
the column's own `valid_c` when given, else `valid`.  Sums of floats accumulate in f64 and of integers and
bools in i64, whatever the compute precision (the JAX package sums f32
in f32 mode; see PERF.md and tests/test_torch_window.py for the bound
that difference obeys); min/max keep the input dtype and follow
`jnp.minimum`/`jnp.maximum` (`jmin`/`jmax`: NaN propagates, -0.0 below
+0.0 in either order).  `flags` (bool, N) starts a new segment at every set entry, for every column; `period` > 0 instead starts
one at every multiple of `period`.

Design (csrc/win_scan.cu, combine in csrc/win_scan.cuh): the segmented
pair (flag, value) combine; one single-pass kernel over 1024-entry tiles
with a look-back over tile aggregates -- a block takes its tile from an
atomic counter, stages its entries of every column in shared memory,
scans them and publishes each column's aggregate (a 16-byte word of
value and status); its carry is the nearest predecessor's aggregate where
that tile holds a segment start, else one block scan over the aggregates
of the earlier tiles of its window of 256 tiles, with the previous
window's inclusive prefix (published by that window's last tile) in
front where no start was met; all columns in one walk.  The launch clears
that state (the tile counter, the words) with a memset before the
kernel, so a CUDA graph can replay it.  Bound on the H100: bytes (each
input read once, each output written once).  The association is fixed
by the data, never by which tiles finished first, so a call gives the
same bits on every run.  `win_scan_plain` folds the float sums in that
association (`_k6_sums`: per thread a serial fold of 4 entries, warp and
block Hillis-Steele scans, the look-back windows of 256 tiles, as vector
ops over the tiles), so the kernel equals it with tolerance 0 on raw
doubles too; tests/torch_k6_association.py states the association again
on Python scalars and holds `win_scan_plain` to it bit for bit.  The
integer sums, counts, min and max, whose association cannot change a
bit, keep a log-step Hillis-Steele scan.

The `scan` pattern family uses K6 on its (L, F) lane grid, flattened,
with `period` = F (a segment per lane): `use="rank"` for the inclusive
occurrence ranks of its count positions (a sum over the node mask,
`jnp.cumsum` at nfa_parallel.py:843) and `use="prev"` for the prev-match
pointers of its `and` sides (a max over the lane-local event index,
values None, masked by the side's node mask, `_prev_static_scan` :589; the i64 minimum where the
lane has no match yet, -1 there).  Each use has its own launch counter.

The incremental aggregation's per-batch path (`use="agg"`,
`@app:deviceAggregations('always')`, core/aggregation.py) scans each
duration's (bucket, group)-sorted batch with resets at the segment starts:
f64 sums, counts, min and max (`_reduce_device`,
siddhi_tpu/core/aggregation.py:463-532).

`win_scan()` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import VT_OF_TORCH
from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of

TILE = 1024                     # csrc/win_scan.cuh WS_TILE
THREADS, ITEMS, WARP = 256, 4, 32   # WS_THREADS, WS_ITEMS, a warp
LOOKBACK = THREADS              # tiles in a look-back window
SUM_F, SUM_I, MIN_F, MAX_F, MAX_I = range(5)
I64_MIN = -2 ** 63


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("n_cols", ctypes.c_int),
                ("ntiles", ctypes.c_int), ("period", ctypes.c_longlong)] + [
        (f, ctypes.c_void_p) for f in (
            "valid", "flags", "in_", "out", "in_vt", "out_vt", "op",
            "masked", "col_valid", "scratch")]
COUNTER = {"window": "win_scan", "rank": "win_scan:rank",
           "prev": "win_scan:prev", "agg": "win_scan:agg"}


def column_kind(op: str, values: Optional[torch.Tensor],
                period: int = 0) -> tuple:
    """(kernel op, output dtype) of a column."""
    isf = values is not None and values.dtype.is_floating_point
    if op == "sum":
        return (SUM_F, torch.float64) if isf else (SUM_I, torch.int64)
    if values is None and op == "max" and period > 0:
        return MAX_I, torch.int64
    if values is None or op not in ("min", "max"):
        raise ValueError(f"win_scan: bad column ({op!r}, {values})")
    if isf:
        return (MIN_F if op == "min" else MAX_F), values.dtype
    if op == "max":
        return MAX_I, torch.int64
    raise ValueError("win_scan: min over integers is not a window column")


def _device(cols: list, valid, flags) -> torch.device:
    for t in [c[1] for c in cols] + [c[3] for c in cols if len(c) > 3] \
            + [valid, flags]:
        if t is not None:
            return t.device
    raise ValueError("win_scan: a column without values needs `valid`, "
                     "`flags` or its own valid flags")


def jmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum: NaN propagates, -0.0 below +0.0 (MinF in
    csrc/win_scan.cuh; K10 agg_merge folds with it too)."""
    return torch.where(torch.isnan(a) | (a < b) | ((a == b) & torch.signbit(a)),
                       a, b)


def jmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.maximum, the mirror of `jmin`."""
    return torch.where(torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a)),
                       a, b)


def _identity(kop: int):
    return {SUM_F: 0.0, SUM_I: 0, MIN_F: float("inf"), MAX_F: float("-inf"),
            MAX_I: I64_MIN}[kop]


def combine(kop: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(left, right), the kernel's (csrc/win_scan.cuh)."""
    if kop in (SUM_F, SUM_I):
        return a + b
    if kop == MIN_F:
        return jmin(a, b)
    if kop == MAX_F:
        return jmax(a, b)
    return torch.maximum(a, b)


def _seg(fa, va, fb, vb):
    """seg_combine of csrc/win_scan.cuh for float sums: (flag, value)
    pairs of tensors, b the right operand."""
    return fa | fb, torch.where(fb, vb, va + vb)


def _hillis(f, v):
    """Inclusive segmented shfl_up scan along the last dim, offsets 1, 2,
    4, ... as block_seg_scan runs them."""
    o, n = 1, v.shape[-1]
    while o < n:
        nf, nv = _seg(f[..., :-o], v[..., :-o], f[..., o:], v[..., o:])
        f = torch.cat([f[..., :o], nf], -1)
        v = torch.cat([v[..., :o], nv], -1)
        o *= 2
    return f, v


def _block_scan(f, v):
    """block_seg_scan over the last dim (THREADS elements): each thread's
    exclusive prefix and the block's total, in the kernel's association
    (warp scans, then a scan of the warp totals)."""
    sh = f.shape[:-1]
    wf, wv = _hillis(f.reshape(*sh, -1, WARP), v.reshape(*sh, -1, WARP))
    tf, tv = _hillis(wf[..., -1], wv[..., -1])
    ef = torch.cat([torch.zeros_like(wf[..., :1]), wf[..., :-1]], -1)
    ev = torch.cat([torch.zeros_like(wv[..., :1]), wv[..., :-1]], -1)
    xf, xv = _seg(tf[..., :-1, None], tv[..., :-1, None], ef[..., 1:, :],
                  ev[..., 1:, :])
    exf = torch.cat([ef[..., :1, :], xf], -2).reshape(*sh, -1)
    exv = torch.cat([ev[..., :1, :], xv], -2).reshape(*sh, -1)
    return exf, exv, tf[..., -1], tv[..., -1]


def _k6_sums(x: torch.Tensor, f: torch.Tensor,
             window: int = LOOKBACK) -> torch.Tensor:
    """Inclusive segmented f64 sums of x (starts at f) in K6's association
    (csrc/win_scan.cu): tiles of TILE entries, THREADS threads folding
    ITEMS entries each, the block scan; a tile's carry is its nearest
    predecessor's aggregate where that tile holds a segment start, else
    the block scan of the aggregates of the earlier tiles of its
    look-back window (`window` tiles, padded with the identity to
    THREADS), behind the previous window's inclusive prefix where no
    start was met; a tile whose first entry starts a segment, and tile 0,
    take none.  Windows run in order, the tiles of one window at once."""
    n, dev = x.shape[0], x.device
    nt = max(1, -(-n // TILE))
    pad = nt * TILE - n
    xv = torch.cat([x, x.new_zeros(pad)]).view(nt, THREADS, ITEMS)
    fv = torch.cat([f, f.new_zeros(pad)]).view(nt, THREADS, ITEMS)
    af = torch.zeros((nt, THREADS), dtype=torch.bool, device=dev)
    av = torch.zeros((nt, THREADS), dtype=x.dtype, device=dev)
    for k in range(ITEMS):
        af, av = _seg(af, av, fv[..., k], xv[..., k])
    exf, exv, known, tot = _block_scan(af, av)
    known[0] = True
    runf = torch.zeros(nt, dtype=torch.bool, device=dev)
    runv = torch.zeros(nt, dtype=x.dtype, device=dev)
    inc = None                  # the previous window's inclusive prefix
    for base in range(0, nt, window):
        hi = min(base + window, nt)
        if hi - base > 1:       # tiles base + 1 .. hi - 1
            m = hi - base - 1
            have = torch.arange(THREADS, device=dev)[None, :] <= \
                torch.arange(m, device=dev)[:, None]
            wf = torch.zeros((m, THREADS), dtype=torch.bool, device=dev)
            wv = torch.zeros((m, THREADS), dtype=x.dtype, device=dev)
            wf[:, :m] = known[base:hi - 1]
            wv[:, :m] = tot[base:hi - 1]
            wf, wv = wf & have, torch.where(have, wv, torch.zeros_like(wv))
            _xf, _xv, bf, bv = _block_scan(wf, wv)
            pk = known[base:hi - 1]
            runf[base + 1:hi] = pk | bf
            runv[base + 1:hi] = torch.where(pk, tot[base:hi - 1], bv)
        if inc is not None:
            rf, rv = runf[base:hi], runv[base:hi]
            first = torch.arange(base, hi, device=dev) == base
            runv[base:hi] = torch.where(rf, rv, torch.where(
                first, inc.expand(hi - base), inc + rv))
            runf[base:hi] = True
        last = base + window - 1
        if last < nt:
            inc = torch.where(known[last], tot[last], runv[last] + tot[last])
    none = fv[:, 0, 0].clone()
    none[0] = True
    runv = torch.where(none, torch.zeros_like(runv), runv)
    af = exf
    av = torch.where(exf, exv, runv[:, None] + exv)
    out = []
    for k in range(ITEMS):
        af, av = _seg(af, av, fv[..., k], xv[..., k])
        out.append(av)
    return torch.stack(out, -1).reshape(-1)[:n]


def win_scan_plain(cols: list, n: int, valid: Optional[torch.Tensor] = None,
                   flags: Optional[torch.Tensor] = None,
                   period: int = 0) -> list:
    outs = []
    dev = _device(cols, valid, flags)
    if period > 0:
        flags = torch.arange(n, device=dev) % period == 0
    for op, values, masked, *own in cols:
        kop, odt = column_kind(op, values, period)
        acc = torch.float64 if kop in (SUM_F, MIN_F, MAX_F) else torch.int64
        if values is not None:
            x = values[:n].to(acc)
        elif kop == MAX_I:
            x = torch.arange(n, device=dev) % period
        else:
            x = torch.ones(n, dtype=acc, device=dev)
        vc = own[0] if own else valid
        if masked and vc is not None:
            x = torch.where(vc[:n], x, torch.full_like(x, _identity(kop)))
        f = flags[:n].clone() if flags is not None else \
            torch.zeros(n, dtype=torch.bool, device=dev)
        if kop == SUM_F:
            outs.append(_k6_sums(x, f).to(odt))
            continue
        d = 1
        while d < n:            # segmented Hillis-Steele: (f, v) pairs
            left, lf = x[:-d], f[:-d]
            x = torch.cat([x[:d], torch.where(f[d:], x[d:],
                                              combine(kop, left, x[d:]))])
            f = torch.cat([f[:d], f[d:] | lf])
            d *= 2
        outs.append(x.to(odt))
    return outs


def prepare(cols: list, n: int, valid: Optional[torch.Tensor] = None,
            flags: Optional[torch.Tensor] = None, use: str = "window",
            period: int = 0) -> Launch:
    """Allocate the outputs and scratch and upload the parameter table of
    one K6 launch (see `win_scan`)."""
    dev = _device(cols, valid, flags)
    if dev.type != "cuda":
        raise ValueError(f"win_scan: unsupported device {dev}")
    keep: list = []
    ptr = checked_ptr(keep, dev, "win_scan")
    p = _Params()
    p.n, p.n_cols, p.period = n, len(cols), period
    p.ntiles = max(1, -(-n // TILE))
    if valid is not None:
        p.valid = ptr(valid, torch.bool)
    if flags is not None and period <= 0:
        p.flags = ptr(flags, torch.bool)
    rows = {"in": [], "out": [], "in_vt": [], "out_vt": [], "op": [],
            "masked": [], "col_valid": []}
    outs = []
    for op, values, masked, *own in cols:
        kop, odt = column_kind(op, values, period)
        if values is not None and (values.dim() != 1 or values.shape[0] < n
                                   or values.dtype not in VT_OF_TORCH):
            raise ValueError(f"win_scan: column {values.dtype} "
                             f"{tuple(values.shape)} for n={n}")
        o = torch.empty(n, dtype=odt, device=dev)
        outs.append(o)
        for key, v in (("in", ptr(values) if values is not None else 0),
                       ("out", ptr(o)),
                       ("in_vt", VT_OF_TORCH[values.dtype]
                        if values is not None else 0),
                       ("out_vt", VT_OF_TORCH[odt]), ("op", kop),
                       ("masked", int(masked)),
                       ("col_valid", ptr(own[0], torch.bool) if own
                        else 0)):
            rows[key].append(v)
    # the look-back state, cleared by each launch: the tile counter (two
    # longs, keeping the words 16-byte aligned), then a (value, status) word
    # per column and tile
    scratch = torch.empty(2 + 2 * len(cols) * p.ntiles, dtype=torch.int64,
                          device=dev)
    p.scratch = ptr(scratch)
    tab = DeviceTable()
    for key, dt in (("in", "u8"), ("out", "u8"), ("in_vt", "i4"),
                    ("out_vt", "i4"), ("op", "i4"), ("masked", "i4"),
                    ("col_valid", "u8")):
        tab.field(p, "in_" if key == "in" else key, rows[key] or [0], dt)
    keep.append(tab.upload(dev))
    lib = load("win_scan")
    fn = lib.win_scan_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                  "win_scan_launch", COUNTER[use], keep, outs)


def win_scan(cols: list, n: int, valid: Optional[torch.Tensor] = None,
             flags: Optional[torch.Tensor] = None, use: str = "window",
             period: int = 0) -> list:
    """Inclusive segmented scans of the first n entries of each column
    (see the module docstring); returns one output tensor per column.
    `use` names the launch counter (`window`, `rank`, `prev`, `agg`)."""
    if _device(cols, valid, flags).type == "cpu":
        return win_scan_plain(cols, n, valid, flags, period)
    return prepare(cols, n, valid, flags, use, period)()

