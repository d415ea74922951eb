"""Device-resident incremental aggregation: the bucket rings on the card.

Port of `siddhi_tpu/core/agg_device.py`.  The host path
(core/aggregation.py) reduces every micro-batch with numpy and merges the
few unique (bucket, group) segments into per-duration dict stores.  This
module keeps the bucket state itself on the device: one f64 ring per
duration (`[capacity, n_bases]`, a CUDA tensor of the runtime's device),
merged in place by K10 `agg_merge` (kernels/agg_merge.py) and pulled to
the host only on a store query, a snapshot or a restore.

Per batch and duration:

  host    the (bucket, group) segment ids from one np.unique over int64
          views (runtime side), slot assignment against the ring (dict
          lookups on the few unique segments, never per event), the
          stable order of the events by segment and the segment offsets;
          one upload of those int32 arrays;
  device  K10: each segment's bases folded in batch order and merged as
          `old op new` into its slot (a fresh slot takes the partial).

The fold order is the host path's (both fold each segment's events in
batch order from the identity, both merge as `old op new`), so the two
paths give byte-identical stores, as in the JAX package.  Exact sizes
replace the JAX step's pow-2 pads and its scratch row: no padded segment
exists, so none is written.

Slot lifecycle: the ring starts at `agg_capacity_for(rt)` slots
(`@app:aggCapacity`, else 1024) and doubles on the device when full (a
zeroed tensor and one copy); @purge retention frees slots on the host only
(the stale device row is overwritten on reuse).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.agg_merge import agg_merge
from ..query.ast import Duration

__all__ = ["DeviceAggregationPlan"]


class _DurationRing:
    """Host-side slot directory of one duration's device base matrix."""

    __slots__ = ("key_to_slot", "slot_keys", "free", "bases", "dirty")

    def __init__(self, capacity: int, n_bases: int, device: torch.device):
        self.key_to_slot: dict = {}
        self.slot_keys: list = [None] * capacity
        self.free: list = list(range(capacity - 1, -1, -1))
        self.bases = torch.zeros((capacity, n_bases), dtype=torch.float64,
                                 device=device)
        self.dirty = False

    @property
    def capacity(self) -> int:
        return len(self.slot_keys)

    def live(self) -> int:
        return len(self.key_to_slot)


class DeviceAggregationPlan:
    """Device-resident per-duration bucket stores of one
    AggregationRuntime.  The runtime keeps parsing, filtering, retention
    policy and the query and snapshot surfaces; this plan owns the rings
    and the K10 merge.  `record`, when a list, receives every K10 call as
    ("agg_merge", args, kwargs), the ring's state before the call cloned
    in args[0] (replay.check_agg_calls)."""

    def __init__(self, agg, capacity: int, device: torch.device):
        self.agg = agg
        self.device = device
        self.n_bases = agg.n_bases
        self.rings = {d: _DurationRing(capacity, self.n_bases, device)
                      for d in agg.durations}
        self.record: Optional[list] = None

    # -- ingest ---------------------------------------------------------------

    def upload_values(self, vals: list, n: int) -> torch.Tensor:
        """The batch's value rows (one per distinct site argument, none
        for counts: `agg.row_sites`), (rows, n) f64 on the device: one
        H2D shared by every duration's merge."""
        host = np.empty((len(vals), n), dtype=np.float64)
        for i, v in enumerate(vals):
            host[i] = v
        return torch.from_numpy(host).to(self.device)

    def ingest(self, dur: Duration, buckets: np.ndarray, gkeys: list,
               inv: np.ndarray, vals: torch.Tensor) -> None:
        """Merge one batch's segments into `dur`'s ring.  `buckets`/`gkeys`
        describe the m unique segments (the host path's dict keys), `inv`
        maps each of the n events onto its segment, `vals` is
        `upload_values`' tensor."""
        ring = self.rings[dur]
        m, n = len(gkeys), len(inv)
        # slot assignment (the only per-segment host work)
        slot_of = np.empty(m, dtype=np.int32)
        fresh_of = np.zeros(m, dtype=np.int32)
        for j in range(m):
            key = (int(buckets[j]), gkeys[j])
            slot = ring.key_to_slot.get(key)
            if slot is None:
                if not ring.free:
                    self._grow(ring)
                slot = ring.free.pop()
                ring.key_to_slot[key] = slot
                ring.slot_keys[slot] = key
                fresh_of[j] = 1
            slot_of[j] = slot
        # one upload: [order | seg_off | slot | fresh], int32
        pack = np.empty(n + 3 * m + 1, dtype=np.int32)
        pack[:n] = np.argsort(inv, kind="stable")
        pack[n] = 0
        np.cumsum(np.bincount(inv, minlength=m), out=pack[n + 1:n + m + 1])
        pack[n + m + 1:n + 2 * m + 1] = slot_of
        pack[n + 2 * m + 1:] = fresh_of
        t = torch.from_numpy(pack).to(self.device)
        args = (vals, t[:n], t[n:n + m + 1], t[n + m + 1:n + 2 * m + 1],
                t[n + 2 * m + 1:])
        kw = {"ops": self.agg.base_ops, "rows": self.agg.base_rows}
        if self.record is not None:
            self.record.append(("agg_merge", (ring.bases.clone(), *args), kw))
        agg_merge(ring.bases, *args, **kw)
        ring.dirty = True

    def _grow(self, ring: _DurationRing) -> None:
        """Double the ring on the device: a zeroed tensor and one copy."""
        old_cap = ring.capacity
        grown = torch.zeros((2 * old_cap, self.n_bases), dtype=torch.float64,
                            device=self.device)
        grown[:old_cap] = ring.bases
        ring.bases = grown
        ring.slot_keys.extend([None] * old_cap)
        ring.free.extend(range(2 * old_cap - 1, old_cap - 1, -1))

    # -- eviction (host-side slot frees; no device traffic) -------------------

    def evict_before(self, dur: Duration, cutoff_ms: int) -> int:
        ring = self.rings[dur]
        doomed = [k for k in ring.key_to_slot if k[0] < cutoff_ms]
        for key in doomed:
            slot = ring.key_to_slot.pop(key)
            ring.slot_keys[slot] = None
            ring.free.append(slot)
        if doomed:
            ring.dirty = True    # the materialized dict view is stale now
        return len(doomed)

    # -- host materialization (query / snapshot / restore) --------------------

    def sync_into(self, store: dict) -> None:
        """Rebuild the runtime's per-duration dict stores from the rings:
        one D2H pull per dirty duration, so a steady ingest stream pays
        nothing until somebody asks."""
        for dur, ring in self.rings.items():
            if not ring.dirty:
                continue
            host = ring.bases.cpu().numpy()
            keys = list(ring.key_to_slot)
            slots = np.fromiter(ring.key_to_slot.values(), dtype=np.int64,
                                count=len(keys))
            store[dur] = dict(zip(keys, host[slots].tolist()))
            ring.dirty = False

    def load_from(self, store: dict) -> None:
        """Reset the rings from restored dict stores (the inverse of
        sync_into): one H2D per duration."""
        for dur, ring in self.rings.items():
            entries = store.get(dur, {})
            cap = ring.capacity
            while cap < len(entries):
                cap *= 2
            ring.key_to_slot = {}
            ring.slot_keys = [None] * cap
            ring.free = list(range(cap - 1, -1, -1))
            host = np.zeros((cap, self.n_bases), dtype=np.float64)
            for key, bases in sorted(entries.items()):
                slot = ring.free.pop()
                ring.key_to_slot[key] = slot
                ring.slot_keys[slot] = key
                host[slot] = bases
            ring.bases = torch.from_numpy(host).to(self.device)
            ring.dirty = False

    # -- telemetry ------------------------------------------------------------

    def live_buckets(self, dur: Duration) -> int:
        return self.rings[dur].live()

    def capacity(self, dur: Duration) -> int:
        return self.rings[dur].capacity
