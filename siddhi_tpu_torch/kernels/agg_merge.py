"""K10 `agg_merge`: fold a batch's aggregation segments in event order and
merge them into a device-resident bucket ring, in place.

Replaces `DeviceAggregationPlan._make_step` (siddhi_tpu/core/
agg_device.py:102, jitted at :98): per base, `segment_sum` /
`segment_min` / `segment_max` over the batch's segment ids, a gather of
the ring rows at the host-assigned slots, `old op new` (a fresh slot takes
the partial) and the scatter back.  Byte identity with the JAX package
(its device and host paths agree bit for bit, agg_device.py:22-27) needs
each segment folded in batch order, so the inputs are the segments'
events in that order:

  bases   (capacity, nb) f64 ring, merged in place (the JAX step donates
          its ring the same way);
  vals    (rows, n) f64 value rows, one per distinct site argument;
  order   (n,) i32 the stable argsort of the segment ids (each segment's
          events in batch order); seg_off (m + 1,) i32 segment offsets;
  slot    (m,) i32 ring row of each segment (distinct); fresh (m,) i32;
  ops     per base "sum", "count", "min" or "max"; rows per base its
          value row (-1 for counts, which read none).

min/max follow jnp.minimum / jnp.maximum (K6's `jmin`/`jmax`, MinF/MaxF
of csrc/win_scan.cuh): NaN propagates, -0.0 is below +0.0 whichever side
it is on.

Design (csrc/agg_merge.cu): one thread per segment walks its events in
order for every base (a serial fold: no atomics, no tree), the per-base
op and row in a device table per launch.  Bound on the H100: bytes, or the
longest segment's chain of dependent adds (a global rollup's hour bucket).

`agg_merge_plain` is the same function in torch: it steps k = 0, 1, ...
and folds the k-th event of every segment that long in one vectorized op,
so each segment folds in event order by construction; once fewer than
`VEC_MIN` segments are left, their remaining events fold in a host loop
over the same values (a segment of 2^17 events would otherwise cost 2^17
torch steps).  The tests and the CPU runs use it; a CUDA tensor launches
the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of
from .win_scan import jmax, jmin

OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
VEC_MIN = 16        # segments left below which the plain fold goes to the host


class _Params(ctypes.Structure):
    _fields_ = [("m", ctypes.c_longlong), ("n", ctypes.c_longlong),
                ("nb", ctypes.c_int), ("pad_", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in (
            "bases", "vals", "order", "seg_off", "slot", "fresh", "op",
            "row")]


def _py_min(a: float, b: float) -> float:
    if a != a or a < b or (a == b and math.copysign(1.0, a) < 0):
        return a
    return b


def _py_max(a: float, b: float) -> float:
    if a != a or a > b or (a == b and math.copysign(1.0, a) > 0):
        return a
    return b


_IDENTITY = {"sum": 0.0, "count": 0.0, "min": math.inf, "max": -math.inf}


def _fold(ops: list, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """op(acc, x) per base (the columns), acc and x (k, nb)."""
    out = torch.empty_like(acc)
    for b, op in enumerate(ops):
        a, v = acc[:, b], x[:, b]
        out[:, b] = jmin(a, v) if op == "min" else jmax(a, v) \
            if op == "max" else a + v
    return out


def agg_merge_plain(bases: torch.Tensor, vals: torch.Tensor,
                    order: torch.Tensor, seg_off: torch.Tensor,
                    slot: torch.Tensor, fresh: torch.Tensor, ops: list,
                    rows: list) -> torch.Tensor:
    m, nb = slot.shape[0], len(ops)
    if m == 0 or nb == 0:
        return bases
    dev = bases.device
    n = order.shape[0]
    ones = torch.ones(1, n, dtype=torch.float64, device=dev)
    vrows = torch.cat([ones if op == "count" else vals[r:r + 1]
                       for op, r in zip(ops, rows)])          # (nb, n)
    off = seg_off.long()
    lens = (off[1:] - off[:-1]).cpu()
    by_len = torch.argsort(lens, descending=True, stable=True)
    lens_s = lens[by_len].tolist()
    by_len_d = by_len.to(dev)
    start_s = off[:-1][by_len_d]
    acc = torch.tensor([_IDENTITY[op] for op in ops], dtype=torch.float64,
                       device=dev).repeat(m, 1)               # by length
    order_l = order.long()
    k, active = 0, m
    while active and lens_s[active - 1] <= k:
        active -= 1
    while active >= VEC_MIN:
        ev = order_l[start_s[:active] + k]
        acc[:active] = _fold(ops, acc[:active], vrows[:, ev].T)
        k += 1
        while active and lens_s[active - 1] <= k:
            active -= 1
    if active:
        # the few long segments left: the rest of each, in event order
        lo = start_s[:active].cpu().tolist()
        tail = acc[:active].cpu().tolist()
        vhost = vrows.cpu().numpy()
        order_h = order_l.cpu().numpy()
        for i in range(active):
            ev = order_h[lo[i] + k:lo[i] + lens_s[i]]
            for b, op in enumerate(ops):
                a = tail[i][b]
                f = _py_min if op == "min" else _py_max if op == "max" \
                    else None
                for x in vhost[b, ev].tolist():
                    a = a + x if f is None else f(a, x)
                tail[i][b] = a
        acc[:active] = torch.tensor(tail, dtype=torch.float64, device=dev)
    part = torch.empty_like(acc)
    part[by_len_d] = acc
    s = slot.long()
    merged = _fold(ops, bases[s], part)
    bases[s] = torch.where(fresh.bool()[:, None], part, merged)
    return bases


def prepare(bases: torch.Tensor, vals: torch.Tensor, order: torch.Tensor,
            seg_off: torch.Tensor, slot: torch.Tensor, fresh: torch.Tensor,
            ops: list, rows: list) -> Launch:
    """Check the tensors and upload the per-base table of one K10 launch
    (see `agg_merge`)."""
    dev = bases.device
    if dev.type != "cuda":
        raise ValueError(f"agg_merge: unsupported device {dev}")
    m, nb = slot.shape[0], len(ops)
    if bases.dim() != 2 or bases.shape[1] != nb or vals.dim() != 2 or \
            seg_off.shape[0] != m + 1 or fresh.shape[0] != m or \
            len(rows) != nb or vals.shape[1] != order.shape[0]:
        raise ValueError(f"agg_merge: shapes bases {tuple(bases.shape)}, "
                         f"vals {tuple(vals.shape)}, order "
                         f"{tuple(order.shape)}, seg_off "
                         f"{tuple(seg_off.shape)}, {m} slots, {nb} bases")
    keep: list = []
    ptr = checked_ptr(keep, dev, "agg_merge")
    p = _Params()
    p.m, p.n, p.nb = m, vals.shape[1], nb
    p.bases = ptr(bases, torch.float64)
    p.vals = ptr(vals, torch.float64)
    p.order = ptr(order, torch.int32)
    p.seg_off = ptr(seg_off, torch.int32)
    p.slot = ptr(slot, torch.int32)
    p.fresh = ptr(fresh, torch.int32)
    tab = DeviceTable()
    tab.field(p, "op", [OPS[op] for op in ops] or [0], "i4")
    tab.field(p, "row", [max(r, 0) for r in rows] or [0], "i4")
    keep.append(tab.upload(dev))
    fn = load("agg_merge").agg_merge_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                  "agg_merge_launch", "agg_merge", keep, bases)


def agg_merge(bases: torch.Tensor, vals: torch.Tensor, order: torch.Tensor,
              seg_off: torch.Tensor, slot: torch.Tensor, fresh: torch.Tensor,
              ops: list, rows: list) -> torch.Tensor:
    """Merge one batch's segments into `bases` in place (see the module
    docstring); returns `bases`."""
    if bases.device.type == "cpu":
        return agg_merge_plain(bases, vals, order, seg_off, slot, fresh, ops,
                               rows)
    return prepare(bases, vals, order, seg_off, slot, fresh, ops, rows)()

