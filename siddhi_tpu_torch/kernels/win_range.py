"""K7 `win_range`: per-event range reductions of the sliding windows.

Replaces the range half of `step_sliding` in the JAX package
(siddhi_tpu/core/window_device.py:608-670): each batch event's left edge
(`searchsorted(..., side="right")` over the valid count for length(L),
over the monotone clock for time(D) -- an event exactly D old has
expired), its window sum as a prefix difference (:624-633; per group
`_seg_window_sum` :141), min/max over [left, i] from a log2 sparse table
(`_sparse_table` :84, `_range_reduce` :99, `_seg_window_minmax` :148),
avg = sum / max(count, 1) in the compute dtype (:652), and the carry's
first kept entry `start_k` (:663-670).

Inputs, all over the N scanned entries of [carry | batch]: `vcnt` (i64
valid count, arrival order) or `clock` (i64 monotone clock), and for a
grouped query `groups` = (ks,): the sorted (segment * N + position) keys
(slot s holds entry ks[s] % N of segment ks[s] // N).  The prefixes
and the min/max values are in the scanned order (arrival, or
group-sorted); `valid` in the same order marks the entries a min/max
site may see.  A site is (op, prefix, count prefix, values, output dtype) with op
"sum" (f64 prefix -> rounded to the output dtype; i64 prefix -> i64),
"avg" (sum and count in the output dtype, then divided), "min" or "max".
Outputs cover entries first .. first+m-1.

Design (csrc/win_range.cu): the scanned order is cut into tiles of
TILE entries, each of 32 sub-blocks.  A first launch (only with a
min/max site) writes each entry's prefix and suffix in its sub-block and
in its tile, each tile's table over its sub-blocks and the tile
extremes; a second (with more than one tile) a sparse table over the
tile extremes (O(n) arrays in all, `scratch_size`); the last runs a
thread a scanned slot s, which answers the entry whose range ends there
(grouped: entry ks[s] % n): it searches the left edge, reads two
prefixes per sum site and, per min/max site, at most four of those
arrays (a loop over at most 32 values inside one sub-block).  No launch
keeps state for another, so a prepared call allocates no zeroed buffer.
The parameter block's `launched` holds the kernels the last call
launched (1, 2 or 3).  Bound on the H100: bytes -- the inputs and
outputs once.

`win_range()` launches the kernel for CUDA tensors and runs
`win_range_plain()` (torch.searchsorted and gathers) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.expr import VT_OF_TORCH
from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of
from .win_scan import MAX_F, MIN_F, combine

OPS = {"sum": 0, "avg": 1, "min": 2, "max": 3}
KINDS = {"length": 0, "time": 1}


TILE = 1024                 # csrc/win_range.cu WR_TILE
LEVELS = 6                  # WR_LEVELS: a tile's table over its 32 sub-blocks


class _Params(ctypes.Structure):
    _fields_ = [(f, ctypes.c_longlong) for f in (
        "n", "first", "m", "span", "last")] + [
        (f, ctypes.c_int) for f in ("kind", "grouped", "n_sites", "n_mm",
                                    "ntiles", "t0", "qtiles", "tlevels",
                                    "launched")] + [
        (f, ctypes.c_void_p) for f in (
            "vcnt", "clock", "ks", "valid", "start_k", "op", "pfx",
            "pfx_vt", "cnt", "vals", "val_vt", "scr", "out", "out_vt")]


def scratch_size(n: int, ntiles: int) -> int:
    """Doubles of one min/max site's arrays (csrc/win_range.cu Scratch):
    four of n, the tiles' sub-block tables and the tile table."""
    return 4 * n + ntiles * LEVELS * (TILE // 32) + ntiles * levels_for(
        ntiles)


def geometry(n: int, first: int, m: int, grouped: bool) -> tuple:
    """(tiles of the n scanned entries, the query launch's first tile, its
    tiles): every tile when grouped (a batch entry's slot may lie
    anywhere), else the tiles of slots first .. first+m-1."""
    ntiles = max(-(-n // TILE), 1)
    if grouped or m < 1:
        t0 = 0 if grouped else min(first // TILE, ntiles - 1)
        return ntiles, t0, ntiles if grouped else 1
    t0 = first // TILE
    return ntiles, t0, (first + m - 1) // TILE - t0 + 1


def levels_for(n: int) -> int:
    """Sparse-table rows over n entries, as the JAX package's
    `_sparse_table` builds them: 1 + ceil(log2 n)."""
    j, w = 1, 1
    while w < n:
        j, w = j + 1, w * 2
    return j


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int64 x >= 1, exact (window_device.py:74)."""
    res = torch.zeros_like(x)
    for shift in (32, 16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        res = torch.where(m, res + shift, res)
        x = torch.where(m, x >> shift, x)
    return res


def _left_edges(kind: str, span: int, n: int, idx, vcnt, clock):
    if kind == "length":
        want = torch.clamp(vcnt[idx] - span, min=0)
        return torch.searchsorted(vcnt[:n], want, right=True)
    return torch.searchsorted(clock[:n], clock[idx] - span, right=True)


def start_k_plain(kind: str, span: int, n: int, last: int, vcnt, clock):
    if kind == "length":
        tot = vcnt[n - 1:n]
        return torch.searchsorted(vcnt[:n], torch.clamp(tot - span, min=0),
                                  right=True)
    at = clock[max(last, 0):max(last, 0) + 1]
    return torch.searchsorted(clock[:n], at - span, right=True)


def win_range_plain(sites: list, *, n: int, first: int, m: int, kind: str,
                    span: int, last: int, vcnt=None, clock=None,
                    groups=None, valid: Optional[torch.Tensor] = None):
    ref = vcnt if vcnt is not None else clock
    dev = ref.device
    i = first + torch.arange(m, dtype=torch.int64, device=dev)
    left = _left_edges(kind, span, n, i, vcnt, clock)
    if groups is not None:
        # slot s holds entry ks[s] % n of segment ks[s] // n
        ks = groups[0][:n]
        rank = torch.empty_like(ks)
        rank[ks % n] = torch.arange(n, dtype=torch.int64, device=dev)
        hi = rank[i]
        lo = torch.searchsorted(ks, ks[hi] // n * n + left)
    else:
        lo, hi = left, i

    def diff(pfx):
        before = torch.where(lo > 0, pfx[torch.clamp(lo - 1, min=0)],
                             torch.zeros((), dtype=pfx.dtype, device=dev))
        return pfx[hi] - before
    outs = []
    for op, pfx, cnt, vals, odt in sites:
        if op == "sum":
            outs.append(diff(pfx).to(odt))
        elif op == "avg":
            s = diff(pfx).to(odt)
            c = diff(cnt).to(odt)
            outs.append(s / torch.clamp(c, min=1))
        else:
            kop = MAX_F if op == "max" else MIN_F
            neutral = float("-inf") if op == "max" else float("inf")
            v = vals[:n]
            if valid is not None:
                v = torch.where(valid[:n], v, torch.full_like(v, neutral))
            rows = [v]
            w = 1
            while w < n:
                prev = rows[-1]
                shifted = torch.cat([prev[w:], torch.full((w,), neutral,
                                                          dtype=v.dtype,
                                                          device=dev)])
                rows.append(combine(kop, prev, shifted))
                w *= 2
            table = torch.stack(rows)
            lo2 = torch.minimum(lo, hi)
            j = torch.clamp(floor_log2(torch.clamp(hi - lo2 + 1, min=1)),
                            max=len(rows) - 1)
            half = torch.ones_like(j) << j
            r = combine(kop, table[j, lo2], table[j, hi - half + 1])
            outs.append(r.to(odt))
    return outs, start_k_plain(kind, span, n, last, vcnt, clock)


def prepare(sites: list, *, n: int, first: int, m: int, kind: str,
            span: int, last: int, vcnt=None, clock=None, groups=None,
            valid: Optional[torch.Tensor] = None) -> Launch:
    """Allocate outputs and the min/max sites' arrays and upload the
    parameter table of one K7 call (see `win_range`)."""
    ref = vcnt if vcnt is not None else clock
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"win_range: unsupported device {dev}")
    keep: list = []
    ptr = checked_ptr(keep, dev, "win_range")
    p = _Params()
    p.n, p.first, p.m, p.span, p.last = n, first, m, span, last
    p.kind, p.grouped, p.n_sites = KINDS[kind], int(groups is not None), \
        len(sites)
    if kind == "length":
        p.vcnt = ptr(vcnt, torch.int64)
    else:
        p.clock = ptr(clock, torch.int64)
    if groups is not None:
        p.ks = ptr(groups[0], torch.int64)
    if valid is not None:
        p.valid = ptr(valid, torch.bool)
    start_k = torch.empty(1, dtype=torch.int64, device=dev)
    p.start_k = ptr(start_k)
    p.n_mm = sum(s[0] in ("min", "max") for s in sites)
    p.ntiles, p.t0, p.qtiles = geometry(n, first, m, groups is not None)
    p.tlevels = levels_for(p.ntiles)
    stride = scratch_size(n, p.ntiles)
    scratch = None
    if p.n_mm:
        scratch = torch.empty(p.n_mm * stride, dtype=torch.float64,
                              device=dev)
    rows = {k: [] for k in ("op", "pfx", "pfx_vt", "cnt", "vals", "val_vt",
                            "scr", "out", "out_vt")}
    outs = []
    j = 0
    for op, pfx, cnt, vals, odt in sites:
        o = torch.empty(m, dtype=odt, device=dev)
        outs.append(o)
        scr_p = 0
        if op in ("min", "max"):
            scr_p = ptr(scratch) + 8 * j * stride
            j += 1
        for key, v in (("op", OPS[op]),
                       ("pfx", ptr(pfx) if pfx is not None else 0),
                       ("pfx_vt", VT_OF_TORCH[pfx.dtype]
                        if pfx is not None else 0),
                       ("cnt", ptr(cnt, torch.int64) if cnt is not None
                        else 0),
                       ("vals", ptr(vals) if vals is not None else 0),
                       ("val_vt", VT_OF_TORCH[vals.dtype]
                        if vals is not None else 0),
                       ("scr", scr_p), ("out", ptr(o)),
                       ("out_vt", VT_OF_TORCH[odt])):
            rows[key].append(v)
    tab = DeviceTable()
    for key, vals_ in rows.items():
        tab.field(p, key, vals_ or [0],
                  "u8" if key in ("pfx", "cnt", "vals", "scr", "out")
                  else "i4")
    keep.append(tab.upload(dev))
    lib = load("win_range")
    fn = lib.win_range_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "win_range_launch", "win_range", keep, (outs, start_k))
    launch.params = p     # .ntiles, .qtiles; .launched: the last call's
    return launch


def win_range(sites: list, *, n: int, first: int, m: int, kind: str,
              span: int, last: int, vcnt=None, clock=None, groups=None,
              valid: Optional[torch.Tensor] = None):
    """Window aggregates of entries first .. first+m-1 and the carry's
    `start_k` (see the module docstring).  Returns ([outputs], start_k
    int64 (1,) tensor)."""
    ref = vcnt if vcnt is not None else clock
    kw = dict(n=n, first=first, m=m, kind=kind, span=span, last=last,
              vcnt=vcnt, clock=clock, groups=groups, valid=valid)
    if ref.device.type == "cpu":
        return win_range_plain(sites, **kw)
    return prepare(sites, **kw)()
