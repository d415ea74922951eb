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
grouped query `groups` = (ks, seg, rank): the sorted (segment * N +
position) keys, each arrival entry's segment and its sorted slot.  The
prefixes and the min/max values are in the scanned order (arrival, or
group-sorted); `valid` in the same order marks the entries a table may
see.  A site is (op, prefix, count prefix, values, output dtype) with op
"sum" (f64 prefix -> rounded to the output dtype; i64 prefix -> i64),
"avg" (sum and count in the output dtype, then divided), "min" or "max".
Outputs cover entries first .. first+m-1.

Design (csrc/win_range.cu): the tables (one row of N doubles per level)
are built by the same launch, one pass per level, then one thread per
entry does its binary searches and reads.  Bound on the H100: bytes --
the inputs once, the outputs once, and every prefix or table read at a
random slot as one 32-byte sector.

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


class _Params(ctypes.Structure):
    _fields_ = [(f, ctypes.c_longlong) for f in (
        "n", "first", "m", "span", "last")] + [
        (f, ctypes.c_int) for f in ("kind", "grouped", "n_sites",
                                    "levels")] + [
        (f, ctypes.c_void_p) for f in (
            "vcnt", "clock", "ks", "seg", "rank", "valid", "start_k", "op",
            "pfx", "pfx_vt", "cnt", "vals", "val_vt", "table", "out",
            "out_vt")]


def levels_for(n: int) -> int:
    """Sparse-table rows of the JAX package's `_sparse_table`: 1 +
    ceil(log2 n)."""
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
        ks, seg, rank = groups
        hi = rank[i]
        lo = torch.searchsorted(ks[:n], seg[i] * n + left)
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
    """Allocate outputs and tables and upload the parameter table of one K7
    launch (see `win_range`)."""
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
        ks, seg, rank = groups
        p.ks, p.seg, p.rank = (ptr(ks, torch.int64), ptr(seg, torch.int64),
                               ptr(rank, torch.int64))
    if valid is not None:
        p.valid = ptr(valid, torch.bool)
    start_k = torch.empty(1, dtype=torch.int64, device=dev)
    p.start_k = ptr(start_k)
    minmax = any(s[0] in ("min", "max") for s in sites)
    p.levels = levels_for(n) if minmax else 0
    rows = {k: [] for k in ("op", "pfx", "pfx_vt", "cnt", "vals", "val_vt",
                            "table", "out", "out_vt")}
    outs = []
    for op, pfx, cnt, vals, odt in sites:
        o = torch.empty(m, dtype=odt, device=dev)
        outs.append(o)
        tab_p = 0
        if op in ("min", "max"):
            table = torch.empty(p.levels * n, dtype=torch.float64, device=dev)
            tab_p = ptr(table)
        for key, v in (("op", OPS[op]),
                       ("pfx", ptr(pfx) if pfx is not None else 0),
                       ("pfx_vt", VT_OF_TORCH[pfx.dtype]
                        if pfx is not None else 0),
                       ("cnt", ptr(cnt, torch.int64) if cnt is not None
                        else 0),
                       ("vals", ptr(vals) if vals is not None else 0),
                       ("val_vt", VT_OF_TORCH[vals.dtype]
                        if vals is not None else 0),
                       ("table", tab_p), ("out", ptr(o)),
                       ("out_vt", VT_OF_TORCH[odt])):
            rows[key].append(v)
    tab = DeviceTable()
    for key, vals_ in rows.items():
        tab.field(p, key, vals_ or [0],
                  "u8" if key in ("pfx", "cnt", "vals", "table", "out")
                  else "i4")
    keep.append(tab.upload(dev))
    lib = load("win_range")
    fn = lib.win_range_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                  "win_range_launch", "win_range", keep, (outs, start_k))


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
