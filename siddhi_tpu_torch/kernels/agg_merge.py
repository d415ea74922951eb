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

Design (csrc/agg_merge.cu): two warps per segment, one for the sums and
counts, one for min/max, each walking the segment in chunks of 512, 128
or 32 events (chosen at launch from the mean segment length, as far as
the stage fits in shared memory), `order` loaded two chunks ahead and
the value rows its bases read staged one chunk ahead (cp.async into a
double-buffered shared stage, one row per distinct value row); lane b of
the sum warp folds base b in event order from the stage (every lane the
same dependent add, no tree, no atomics); each lane of the min/max warp
folds its own events of every chunk (any order gives the same value, NaN
by `isnan`), and one butterfly of warp shuffles reduces them after the
walk; counts are `hi - lo`; the merge with the ring row follows the
walk.  Bases go in passes of 64, a launch each over every segment with a
stage of its own bases' value rows only, so any number of bases fits.
The per-base op, stage rows and the min/max list sit in a device table
per launch.  Bound on the H100: bytes, or the longest segment's chain of
dependent adds (a global rollup's hour bucket), which `chain_probe`
measures.

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

from .build import check, load
from .table import DeviceTable, Launch, checked_ptr, stream_of
from .win_scan import jmax, jmin

OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
VEC_MIN = 16        # segments left below which the plain fold goes to the host
PASS = 64           # bases a pass over the segments (csrc/agg_merge.cu AG_PASS)


class _Params(ctypes.Structure):
    """One pass of at most PASS bases (csrc/agg_merge.cu AggParams)."""
    _fields_ = [("m", ctypes.c_longlong), ("n", ctypes.c_longlong),
                ("nb", ctypes.c_int), ("stride", ctypes.c_int),
                ("ns", ctypes.c_int * 2), ("n_mm", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in (
            "bases", "vals", "order", "seg_off", "slot", "fresh", "op",
            "sidx", "srow_sum", "srow_mm", "mm")]


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


def stage_tables(ops: list, rows: list) -> list:
    """The kernel's tables, one launch a pass of PASS bases: for each pass
    its bases' ops, the stage rows of the sum warp and of the min/max warp
    (each distinct value row one of the pass's bases reads), each base's
    stage row in its warp's stage (`sidx`) and the pass's min/max bases
    (`mm`, counted from the pass's first base)."""
    out = []
    for b0 in range(0, len(ops), PASS):
        part = list(zip(ops[b0:b0 + PASS], rows[b0:b0 + PASS]))
        srow = [sorted({r for op, r in part if op == "sum"}),
                sorted({r for op, r in part if op in ("min", "max")})]
        out.append({
            "ops": [op for op, _r in part], "srow": srow,
            "sidx": [0 if op == "count" else srow[op != "sum"].index(r)
                     for op, r in part],
            "mm": [b for b, (op, _r) in enumerate(part)
                   if op in ("min", "max")]})
    return out


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
    passes = stage_tables(ops, rows)
    params = (_Params * max(1, len(passes)))()
    tab = DeviceTable()
    for q, (p, t) in enumerate(zip(params, passes)):
        p.m, p.n, p.nb, p.stride = m, vals.shape[1], len(t["ops"]), nb
        p.ns[0], p.ns[1] = len(t["srow"][0]), len(t["srow"][1])
        p.n_mm = len(t["mm"])
        p.bases = ptr(bases, torch.float64) + 8 * PASS * q
        p.vals = ptr(vals, torch.float64)
        p.order = ptr(order, torch.int32)
        p.seg_off = ptr(seg_off, torch.int32)
        p.slot = ptr(slot, torch.int32)
        p.fresh = ptr(fresh, torch.int32)
        tab.field(p, "op", [OPS[op] for op in t["ops"]], "i4")
        tab.field(p, "sidx", t["sidx"], "i4")
        tab.field(p, "srow_sum", t["srow"][0] or [0], "i4")
        tab.field(p, "srow_mm", t["srow"][1] or [0], "i4")
        tab.field(p, "mm", t["mm"] or [0], "i4")
    keep.append(tab.upload(dev))
    fn = load("agg_merge").agg_merge_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Launch(lambda: fn(params, len(passes), stream_of(dev)),
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


def chain_probe(n: int, device):
    """A launch of the chain-bound probe (csrc/agg_merge.cu): one thread
    doing `n` dependent f64 adds from registers, K10's bound at a segment
    of n events.  Not on any path and not counted; returns a callable
    that enqueues it on the current stream."""
    out = torch.empty(1, dtype=torch.float64, device=device)
    fn = load("agg_merge").agg_chain_probe_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        check(fn(n, 1.0, out.data_ptr(), stream_of(device)),
              "agg_chain_probe_launch")
        return out
    return launch
