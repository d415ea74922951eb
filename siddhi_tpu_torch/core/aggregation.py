"""Incremental (multi-granularity) aggregation: `define aggregation A from S
select sum(price) as total group by sym aggregate by ts every sec ... year`
and its `within ... per` store queries.

Port of `siddhi_tpu/core/aggregation.py`.  Every micro-batch computes
(bucket, group) segment ids per duration and reduces the sum/count/min/max
bases of the selector's aggregates over them (avg is sum and count); the
few unique segments merge into per-duration bucket stores.  Reducing raw
events per duration equals the reference's bucket-of-buckets cascade, with
no dependency between durations.  Buckets are never finalized: queries
read running and past buckets alike.

Placement (siddhi_tpu/core/aggregation.py:252-312):
  default        the device-resident rings (core/agg_device.py, K10
                 `agg_merge`): bucket state on the card, pulled on query;
  'always'       `@app:deviceAggregations('always')`: the per-batch
                 device reduce (`_reduce_device`: chained stable sorts and
                 K6 `win_scan` use `agg`), stores on the host;
  'off'          (also 'never', 'false', 'host', or SIDDHI_AGG_DEVICE=off)
                 the host numpy reduce;
  calendar       month/year durations bucket by calendar on the host.
Each choice other than the default is recorded with its reason in
`demotions` (rule D-AGG), which `rt.explain()` reports.  Unlike the JAX
package, a device plan that fails to build or launch raises: nothing moves
to the host quietly.  The mesh form of `_reduce_device` (a vmap over
event shards) is a later slice.
"""
from __future__ import annotations

import datetime as _dt
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..interp.aggregators import extract_aggregators
from ..interp.expr import PyExprContext, compile_py
from ..kernels.win_scan import win_scan
from ..query import ast
from ..query.ast import AttrType, Duration
from .batch import EventBatch
from .planner import PlanError, QueryPlan
from .schema import StreamSchema

AGG_TIMESTAMP = "AGG_TIMESTAMP"
RESIDENT, BATCH, HOST = "device-resident", "device-batch", "host"

# base-field decomposition (reference: aggregator/incremental/
# Incremental{Sum,Count,Avg,Min,Max}AttributeAggregator)
BASES = {
    "sum": ("sum",),
    "count": ("count",),
    "avg": ("sum", "count"),
    "min": ("min",),
    "max": ("max",),
}

_DUR_NAMES = {
    "sec": Duration.SECONDS, "seconds": Duration.SECONDS,
    "min": Duration.MINUTES, "minutes": Duration.MINUTES,
    "hour": Duration.HOURS, "hours": Duration.HOURS,
    "day": Duration.DAYS, "days": Duration.DAYS,
    "week": Duration.WEEKS, "weeks": Duration.WEEKS,
    "month": Duration.MONTHS, "months": Duration.MONTHS,
    "year": Duration.YEARS, "years": Duration.YEARS,
}


def duration_of(name: str) -> Duration:
    d = _DUR_NAMES.get(name.strip().lower())
    if d is None:
        raise PlanError(f"unknown aggregation duration {name!r}")
    return d


def parse_span_ms(text) -> int:
    """'1 hour' / '90 sec' / bare ms integer -> milliseconds."""
    s = str(text).strip()
    parts = s.split()
    if len(parts) == 2:
        return int(float(parts[0]) * duration_of(parts[1]).approx_millis)
    try:
        return int(s)
    except ValueError:
        raise PlanError(f"cannot parse retention span {text!r} "
                        f"(want e.g. '1 hour' or ms)") from None


def _parse_retention(ad: ast.AggregationDefinition) -> dict:
    """@purge on a `define aggregation` -> {Duration: retention_ms}.

    Forms (reference: @purge/@retentionPeriod on aggregations):
      @purge(retention='1 hour')            uniform retention
      @purge('1 hour')                      same, positional
      @purge(retention='1 hour', sec='2 min')   per-duration override
      @purge(enable='false', ...)           disabled
    Returns {} when absent or disabled: every bucket is kept."""
    ann = ast.find_annotation(ad.annotations, "purge")
    if ann is None:
        return {}
    if str(ann.element("enable", "true")).lower() in ("false", "off"):
        return {}
    out: dict = {}
    default = ann.element("retention")
    if default is not None:
        for d in ad.durations:
            out[d] = parse_span_ms(default)
    seen = set()
    for name, dur in _DUR_NAMES.items():
        if dur in seen or dur not in ad.durations:
            continue
        v = ann.element(name) if len(ann.elements) > 1 or default is None \
            else None
        if v is not None and v != default:
            out[dur] = parse_span_ms(v)
            seen.add(dur)
    if not out:
        raise PlanError(
            f"aggregation {ad.id!r}: @purge needs a retention span "
            f"(e.g. @purge(retention='1 hour'))")
    return out


def bucket_starts(ts: np.ndarray, dur: Duration) -> np.ndarray:
    """Bucket start (ms) per timestamp; months and years on calendar
    boundaries through numpy datetime64 truncation."""
    if dur == Duration.MONTHS:
        d = ts.astype("datetime64[ms]").astype("datetime64[M]")
        return d.astype("datetime64[ms]").astype(np.int64)
    if dur == Duration.YEARS:
        d = ts.astype("datetime64[ms]").astype("datetime64[Y]")
        return d.astype("datetime64[ms]").astype(np.int64)
    w = dur.approx_millis
    return (ts // w) * w


class _Site:
    """One aggregator call site in the aggregation's selector."""
    __slots__ = ("name", "key", "arg", "arg_fn", "in_type", "out_type")

    def __init__(self, name, key, arg, arg_fn, in_type, out_type):
        self.name = name          # sum/count/avg/min/max
        self.key = key            # env placeholder "__agg<i>"
        self.arg = arg            # column name if a plain variable, else None
        self.arg_fn = arg_fn      # per-row evaluator of the argument
        self.in_type = in_type
        self.out_type = out_type


class AggregationRuntime(QueryPlan):
    """Ingest plan and queryable per-duration bucket store.  `record`,
    when a list, receives every K6 call of the 'always' path as
    ("win_scan", args, kwargs) (the resident plan's K10 calls go to
    `device_plan.record`)."""

    def __init__(self, rt, ad: ast.AggregationDefinition):
        self.rt = rt
        self.ad = ad
        self.name = f"#aggregation_{ad.id}"
        inp = ad.input
        if inp.stream_id not in rt.schemas:
            raise PlanError(f"aggregation {ad.id!r}: unknown input stream "
                            f"{inp.stream_id!r}")
        if inp.window is not None:
            raise PlanError(f"aggregation {ad.id!r}: windows not allowed")
        self.in_schema = rt.schemas[inp.stream_id]
        self.input_streams = (inp.stream_id,)
        self.output_target = None
        self.durations = tuple(ad.durations)
        if not self.durations:
            raise PlanError(f"aggregation {ad.id!r}: no durations")
        self.record: Optional[list] = None

        ctx = PyExprContext({inp.alias: self.in_schema,
                             inp.stream_id: self.in_schema},
                            default_ref=inp.alias, tables=rt.tables)
        self.filters = [compile_py(f.expr, ctx)[0] for f in inp.filters]

        # event-time source (reference: `aggregate by <attr>`)
        self.by_attr = None
        if ad.by_attribute is not None:
            self.by_attr = ad.by_attribute.attribute
            if self.in_schema.type_of(self.by_attr) != AttrType.LONG:
                raise PlanError(f"aggregation {ad.id!r}: aggregate-by "
                                f"attribute must be long (epoch ms)")

        # group-by columns (plain variables, the reference's restriction)
        self.group_attrs: list[str] = []
        for g in ad.selector.group_by:
            if g.stream_ref not in (None, inp.alias, inp.stream_id):
                raise PlanError(f"aggregation {ad.id!r}: bad group-by ref")
            self.group_attrs.append(g.attribute)

        # selector: aggregator calls become placeholder sites
        if ad.selector.select_all:
            raise PlanError(f"aggregation {ad.id!r}: select * not allowed; "
                            f"name the aggregates")
        raw_sites: list = []
        rewritten: list[tuple[str, ast.Expression]] = []
        for oa in ad.selector.attributes:
            rewritten.append((oa.name,
                              extract_aggregators(oa.expr, raw_sites, ctx)))
        self.sites: list[_Site] = []
        for s in raw_sites:
            if s.name not in BASES:
                raise PlanError(
                    f"aggregation {ad.id!r}: {s.name}() has no incremental "
                    f"decomposition (reference supports sum/count/avg/min/max)")
            if s.out_type is None:
                raise PlanError(f"aggregation {ad.id!r}: {s.name}() over "
                                f"{s.in_type}")
            arg = s.arg.attribute if isinstance(s.arg, ast.Variable) and \
                len(s.arg_fns) == 1 and \
                s.arg.attribute in self.in_schema.types else None
            self.sites.append(_Site(s.name, s.key, arg,
                                    s.arg_fns[0] if s.arg_fns else None,
                                    s.in_type, s.out_type))

        # output row evaluators over {group attrs, AGG_TIMESTAMP, __agg*}
        extra = {a: (a, self.in_schema.type_of(a)) for a in self.group_attrs}
        extra[AGG_TIMESTAMP] = (AGG_TIMESTAMP, AttrType.LONG)
        extra.update({s.key: (s.key, s.out_type) for s in self.sites})
        octx = PyExprContext({}, extra=extra, tables=rt.tables)
        self.out_fns: list = []
        names, types = [], []
        for nm, expr in rewritten:
            f, t = compile_py(expr, octx)
            self.out_fns.append(f)
            names.append(nm)
            types.append(t)
        self.out_schema = StreamSchema(ad.id, tuple(
            ast.Attribute(n, t) for n, t in zip(names, types)))
        # positions of the string group attributes (their keys are codes)
        self.string_keys = tuple(
            i for i, a in enumerate(self.group_attrs)
            if self.in_schema.type_of(a) == AttrType.STRING)

        # the value rows: one per distinct site argument (a plain column
        # once, each computed argument its own); each base reads its
        # site's row, counts none (-1)
        self.row_sites: list[_Site] = []
        row_of: dict = {}
        self.base_ops: list[str] = []
        self.base_rows: list[int] = []
        for i, s in enumerate(self.sites):
            r = -1
            if s.name != "count" and s.arg_fn is not None:
                key = s.arg if s.arg is not None else i
                if key not in row_of:
                    row_of[key] = len(self.row_sites)
                    self.row_sites.append(s)
                r = row_of[key]
            for b in BASES[s.name]:
                self.base_ops.append(b)
                self.base_rows.append(-1 if b == "count" else r)

        # per-duration bucket stores:
        # (bucket_start_ms, group_key_tuple) -> [base floats ...]
        self.n_bases = len(self.base_ops)
        self.store: dict = {d: {} for d in self.durations}

        # @purge retention: buckets whose start falls behind the newest
        # seen start minus the duration's retention are evicted on ingest
        self.retention_ms: dict = _parse_retention(ad)
        self.evicted: dict = {d: 0 for d in self.durations}
        self._newest: dict = {d: None for d in self.durations}

        da = ast.find_annotation(rt.app.annotations, "app:deviceAggregations")
        mode = str(da.element()).lower() if da is not None else "auto"
        calendar = (Duration.MONTHS in self.durations
                    or Duration.YEARS in self.durations)
        self.device_plan = None
        self.demotions: list = []
        self._plan_device(rt, mode, calendar)

    def _plan_device(self, rt, mode: str, calendar: bool) -> None:
        """Set `path`, `explain()`'s name of the placement
        (`device-resident`, `device-batch` or `host`), build the resident
        plan, or record why the host path was chosen (D-AGG)."""
        env = os.environ.get("SIDDHI_AGG_DEVICE", "").lower()
        self.path = HOST
        if mode in ("always", "true") and not calendar:
            self.path = BATCH
            return
        if mode in ("off", "never", "false", "host"):
            reason = f"@app:deviceAggregations({mode!r}) chose the host path"
        elif env in ("0", "off", "host"):
            reason = "SIDDHI_AGG_DEVICE env opt-out chose the host path"
        elif calendar:
            reason = ("month/year durations need calendar (datetime64) "
                      "bucket truncation \u2014 host path")
        else:
            from .agg_device import DeviceAggregationPlan
            from .autotune import agg_capacity_for
            self.device_plan = DeviceAggregationPlan(
                self, agg_capacity_for(rt), rt.device)
            self.path = RESIDENT
            return
        self.demotions.append({"query": self.ad.id, "rule_id": "D-AGG",
                               "reason": reason,
                               "alternative": "device-agg"})

    # -- ingest (vectorized segmented reduction) -----------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        n = batch.n
        if n == 0:
            return []
        ts = (batch.columns[self.by_attr].astype(np.int64)
              if self.by_attr else batch.timestamps)
        keep = None
        if self.filters:
            rows = batch.rows(self.rt.strings)
            names = self.in_schema.names
            keep = np.fromiter(
                (all(f(dict(zip(names, r), __timestamp__=int(t)))
                     for f in self.filters)
                 for t, r in zip(batch.timestamps, rows)),
                dtype=bool, count=n)
            if not keep.any():
                return []

        # rows whose group key or aggregate argument is NULL would be
        # bucketed or summed as their fill values: mask them out
        if batch.nulls:
            null_mask = np.zeros(n, dtype=bool)
            for a in self.group_attrs:
                if a in batch.nulls:
                    null_mask |= batch.nulls[a]
            for s in self.sites:
                if s.arg is not None and s.arg in batch.nulls:
                    null_mask |= batch.nulls[s.arg]
            if null_mask.any():
                keep = ~null_mask if keep is None else (keep & ~null_mask)
                if not keep.any():
                    return []

        gcols = [batch.columns[a] for a in self.group_attrs]
        vals = self._value_rows(batch)
        if keep is not None:
            ts = ts[keep]
            gcols = [c[keep] for c in gcols]
            vals = [v[keep] for v in vals]

        # integer views of the group columns for an exact vectorized unique
        gints = [self._int_view(c) for c in gcols]
        if self.path == RESIDENT:
            self._ingest_device_resident(ts, gints, gcols, vals)
            self._enforce_retention()
            return []
        if self.path == BATCH:
            per_dur = self._reduce_device(ts, gints, vals)
        else:
            per_dur = self._reduce_host(ts, gints, vals)
        for dur, (buckets_of, rows_any, reduced) in zip(self.durations,
                                                        per_dur):
            st = self.store[dur]
            for j in range(len(rows_any)):
                r = int(rows_any[j])
                gkey = tuple(self._decode_gval(c[r]) for c in gcols)
                key = (int(buckets_of[j]), gkey)
                new = [float(red[j]) for red in reduced]
                old = st.get(key)
                st[key] = new if old is None else self._merge(old, new)
            if len(buckets_of):
                top = int(buckets_of.max())
                if self._newest[dur] is None or top > self._newest[dur]:
                    self._newest[dur] = top
        self._enforce_retention()
        return []

    def _ingest_device_resident(self, ts, gints, gcols, vals) -> None:
        """Per duration the host computes the batch's unique (bucket,
        group) segments (the host reduce's np.unique, so keys match bit
        for bit) and the device plan merges them into the ring with K10;
        the value rows go up once for all durations."""
        vals_t = self.device_plan.upload_values(vals, len(ts))
        for dur in self.durations:
            buckets = bucket_starts(ts, dur)
            segs = np.stack([buckets, *gints], axis=1) if gints \
                else buckets[:, None]
            uniq, inv = np.unique(segs, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            m = len(uniq)
            first_rows = np.empty(m, dtype=np.int64)
            first_rows[inv[::-1]] = np.arange(len(inv))[::-1]
            gkeys = [tuple(self._decode_gval(c[int(r)]) for c in gcols)
                     for r in first_rows]
            self.device_plan.ingest(dur, uniq[:, 0], gkeys, inv, vals_t)
            top = int(uniq[:, 0].max())
            if self._newest[dur] is None or top > self._newest[dur]:
                self._newest[dur] = top

    def _enforce_retention(self) -> None:
        """@purge: drop buckets older than the newest start minus the
        retention.  Device rings evict on the host only (the slot frees;
        the stale device row is overwritten on reuse)."""
        if not self.retention_ms:
            return
        for dur in self.durations:
            r = self.retention_ms.get(dur)
            newest = self._newest[dur]
            if r is None or newest is None:
                continue
            cutoff = newest - r
            if self.path == RESIDENT:
                self.evicted[dur] += self.device_plan.evict_before(
                    dur, cutoff)
                continue
            st = self.store[dur]
            doomed = [k for k in st if k[0] < cutoff]
            for k in doomed:
                del st[k]
            self.evicted[dur] += len(doomed)

    def _reduce_host(self, ts, gints, vals):
        """numpy segmented reduction; per duration (bucket start of each
        segment, a row of each segment, reduced[nb][m])."""
        out = []
        for dur in self.durations:
            buckets = bucket_starts(ts, dur)
            segs = np.stack([buckets, *gints], axis=1) if gints \
                else buckets[:, None]
            uniq, inv = np.unique(segs, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            m = len(uniq)
            reduced: list[np.ndarray] = []
            for base, r in zip(self.base_ops, self.base_rows):
                if base == "sum":
                    reduced.append(np.bincount(inv, weights=vals[r],
                                               minlength=m))
                elif base == "count":
                    reduced.append(np.bincount(inv, minlength=m).astype(float))
                elif base == "min":
                    acc = np.full(m, np.inf)
                    np.minimum.at(acc, inv, vals[r])
                    reduced.append(acc)
                elif base == "max":
                    acc = np.full(m, -np.inf)
                    np.maximum.at(acc, inv, vals[r])
                    reduced.append(acc)
            first_rows = np.empty(m, dtype=np.int64)
            first_rows[inv[::-1]] = np.arange(len(inv))[::-1]
            out.append((uniq[:, 0], first_rows, reduced))
        return out

    def _reduce_device(self, ts, gints, vals):
        """The per-batch device reduce (`@app:deviceAggregations('always')`,
        siddhi_tpu/core/aggregation.py:463-585): per duration, the events
        sorted by (bucket, group keys, position) with chained stable sorts
        (`jnp.lexsort`'s key order), segment starts where a sorted key
        changes, and K6 (use `agg`) scanning the f32-rounded values in f64
        with resets at the starts.  One pull of (order, starts, runs) for
        every duration; the host picks each segment's end and first row."""
        dev = self.rt.device
        n = len(ts)
        nb = self.n_bases
        keys = torch.from_numpy(np.stack(
            [np.asarray(ts, np.int64), *gints])).to(dev)
        # the JAX program's f32 values (aggregation.py:549), read in f64
        v32 = np.empty((len(vals), n), dtype=np.float32)
        for i, v in enumerate(vals):
            v32[i] = v
        v64 = torch.from_numpy(v32).to(dev).double()
        ints, floats = [], []
        for dur in self.durations:
            w = dur.approx_millis
            bucket = torch.div(keys[0], w, rounding_mode="floor") * w
            sort_keys = [bucket, *keys[1:]]
            order = torch.arange(n, device=dev)
            for k in reversed(sort_keys):       # least significant first
                order = order[torch.sort(k[order], stable=True).indices]
            starts = torch.zeros(n, dtype=torch.bool, device=dev)
            starts[0] = True
            for k in sort_keys:
                sk = k[order]
                starts[1:] |= sk[1:] != sk[:-1]
            cols = [("sum", None, False) if b == "count" else
                    (b, v64[r][order], False)
                    for b, r in zip(self.base_ops, self.base_rows)]
            kw = {"flags": starts, "use": "agg"}
            if self.record is not None:
                self.record.append(("win_scan", (cols, n), kw))
            runs = win_scan(cols, n, **kw)
            ints.append(torch.stack([order, starts.long()]))
            floats.append(torch.stack([r.double() for r in runs])
                          if runs else torch.empty(0, n, dtype=torch.float64,
                                                   device=dev))
        ipack = torch.cat(ints).cpu().numpy()
        fpack = torch.cat(floats).cpu().numpy()
        out = []
        for di, dur in enumerate(self.durations):
            order = ipack[2 * di]
            sidx = np.flatnonzero(ipack[2 * di + 1])
            ends = np.concatenate([sidx[1:], [n]]) - 1
            rows_any = order[sidx]
            runs = fpack[di * nb:(di + 1) * nb]
            out.append((bucket_starts(ts[rows_any], dur), rows_any,
                        [runs[bi][ends] for bi in range(nb)]))
        return out

    def _merge(self, a: list, b: list) -> list:
        return [x + y if base in ("sum", "count") else
                min(x, y) if base == "min" else max(x, y)
                for base, x, y in zip(self.base_ops, a, b)]

    def _value_rows(self, batch: EventBatch) -> list:
        """One f64 column per value row (`row_sites`): plain arguments
        straight from the batch, others through their per-row host
        closures."""
        vals = []
        rows = None
        for s in self.row_sites:
            if s.arg is not None:
                vals.append(batch.columns[s.arg].astype(np.float64))
            else:
                if rows is None:
                    rows = batch.rows(self.rt.strings)
                names = self.in_schema.names
                vals.append(np.fromiter(
                    (float(s.arg_fn(dict(zip(names, r)))) for r in rows),
                    dtype=np.float64, count=batch.n))
        return vals

    @staticmethod
    def _int_view(col: np.ndarray) -> np.ndarray:
        if col.dtype.kind in "iub":
            return col.astype(np.int64)
        if col.dtype.kind == "f":
            v = col.astype(np.float64)
            v = np.where(v == 0.0, 0.0, v)     # -0.0 keys with +0.0
            return v.view(np.int64)            # exact bit key otherwise
        raise PlanError("unsupported group-by column type")

    @staticmethod
    def _decode_gval(v):
        """A numpy scalar as a Python one (a stable dict key); string codes
        decode in rows_between."""
        return v.item() if isinstance(v, np.generic) else v

    # -- query side (within/per selection) -----------------------------------

    def _materialize(self) -> None:
        """Pull the device rings into the dict stores (dirty durations
        only): every read surface calls this first, so both paths share
        one store format."""
        if self.path == RESIDENT:
            self.device_plan.sync_into(self.store)

    def rows_between(self, per: Duration, t0: Optional[int],
                     t1: Optional[int]) -> list:
        """Output rows [(bucket_start, env, row)] for the buckets of `per`
        whose start lies in [t0, t1)."""
        if per not in self.store:
            raise PlanError(
                f"aggregation {self.ad.id!r}: per-duration {per.value!r} not "
                f"in defined range {[d.value for d in self.durations]}")
        self._materialize()
        out = []
        for (start, gkey), bases in sorted(self.store[per].items()):
            if t0 is not None and start < t0:
                continue
            if t1 is not None and start >= t1:
                continue
            env = {AGG_TIMESTAMP: start, "__timestamp__": start}
            for a, v in zip(self.group_attrs, gkey):
                if self.in_schema.type_of(a) == AttrType.STRING:
                    v = self.rt.strings.decode(int(v))
                env[a] = v
            i = 0
            for s in self.sites:
                if s.name == "avg":
                    sm, ct = bases[i], bases[i + 1]
                    env[s.key] = (sm / ct) if ct else None
                elif s.name == "count":
                    env[s.key] = int(bases[i])
                elif s.name in ("min", "max"):
                    env[s.key] = self._cast(bases[i], s.in_type)
                else:
                    env[s.key] = self._cast(bases[i], s.out_type)
                i += len(BASES[s.name])
            row_env = dict(env)
            row = [f(env) for f in self.out_fns]
            for nm, v in zip(self.out_schema.names, row):
                row_env[nm] = v
            out.append((start, row_env, row))
        return out

    @staticmethod
    def _cast(v: float, t: Optional[AttrType]):
        if t in (AttrType.INT, AttrType.LONG):
            return int(v)
        return float(v)

    # -- snapshot ------------------------------------------------------------

    def state_dict(self) -> dict:
        self._materialize()
        return {"store": {d.value: {k: list(v) for k, v in s.items()}
                          for d, s in self.store.items()}}

    def load_state_dict(self, d: dict) -> None:
        by_val = {x.value: x for x in Duration}
        self.store = {by_val[dv]: {k: list(v) for k, v in s.items()}
                      for dv, s in d["store"].items()}
        for dur in self.durations:           # tolerate missing durations
            self.store.setdefault(dur, {})
        for dur, st in self.store.items():
            self._newest[dur] = (max(k[0] for k in st) if st else None)
        if self.path == RESIDENT:
            self.device_plan.load_from(self.store)

    # -- telemetry -------------------------------------------------------------

    def group_count(self) -> int:
        """Distinct live group keys on the finest duration."""
        fine = self.durations[0]
        resident = self.path == RESIDENT
        keys = (self.device_plan.rings[fine].key_to_slot if resident
                else self.store[fine])
        return len({g for (_b, g) in keys})

    def metrics(self) -> dict:
        resident = self.path == RESIDENT
        durs = {}
        for d in self.durations:
            live = (self.device_plan.live_buckets(d) if resident
                    else len(self.store[d]))
            ent = {"buckets": live, "evicted": self.evicted[d]}
            if resident:
                ent["capacity"] = self.device_plan.capacity(d)
            r = self.retention_ms.get(d) if self.retention_ms else None
            if r is not None:
                ent["retention_ms"] = r
            durs[d.name] = ent
        return {"device": self.path != HOST, "resident": resident,
                "groups": self.group_count(),
                "durations": durs}


# ---------------------------------------------------------------------------
# within / per evaluation
# ---------------------------------------------------------------------------

def parse_time_point(v) -> int:
    """'2017-06-01 04:05:50' / epoch-ms long -> epoch ms (UTC)."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d"):
            try:
                t = _dt.datetime.strptime(s, fmt).replace(
                    tzinfo=_dt.timezone.utc)
                return int(t.timestamp() * 1000)
            except ValueError:
                continue
    raise PlanError(f"cannot interpret time point {v!r}")


def within_range_of(expr, value_fn_compiler, now_fn) -> Callable:
    """Compile a `within` clause to env -> (t0, t1).

    Forms: `within start, end` (two points), `within '2017-06-** ...'`
    (a wildcard pattern: the span it covers), `within 1 day` (a trailing
    window ending now)."""
    if expr is None:
        return lambda env: (None, None)
    if isinstance(expr, ast.FunctionCall) and expr.name == "withinRange":
        f0 = value_fn_compiler(expr.args[0])
        f1 = value_fn_compiler(expr.args[1])
        return lambda env: (parse_time_point(f0(env)),
                            parse_time_point(f1(env)))
    if isinstance(expr, ast.TimeConstant):
        ms = expr.millis
        return lambda env: (now_fn() - ms, None)
    f = value_fn_compiler(expr)

    def rng(env):
        v = f(env)
        if isinstance(v, str) and "*" in v:
            return _wildcard_range(v)
        return (parse_time_point(v), None)
    return rng


def _wildcard_range(pat: str) -> tuple[int, int]:
    """'2017-06-** **:**:**' -> (start, end) of the covered span:
    wildcards floor to their minimum for the start, and the finest fully
    specified component is incremented for the end."""
    pat = pat.strip()
    if len(pat) == 10:                  # date only
        pat = pat + " **:**:**"
    comps = _split_dt(pat)
    lo_v, hi_v = [], []
    for c, mn in zip(comps, [1, 1, 1, 0, 0, 0]):
        if "*" in c:
            lo_v.append(mn)
            hi_v.append(None)
        else:
            lo_v.append(int(c))
            hi_v.append(int(c))
    start = _dt.datetime(*lo_v, tzinfo=_dt.timezone.utc)
    last_fixed = max(i for i, h in enumerate(hi_v) if h is not None)
    if last_fixed == 0:
        end = start.replace(year=start.year + 1)
    elif last_fixed == 1:
        end = (start.replace(day=1) + _dt.timedelta(days=32)).replace(day=1)
    else:
        end = start + (_dt.timedelta(days=1), _dt.timedelta(hours=1),
                       _dt.timedelta(minutes=1),
                       _dt.timedelta(seconds=1))[min(last_fixed, 5) - 2]
    return int(start.timestamp() * 1000), int(end.timestamp() * 1000)


def _split_dt(pat: str) -> list:
    """'YYYY-MM-DD HH:MM:SS' -> 6 components."""
    date, _, time = pat.partition(" ")
    d = (date.split("-") + ["**", "**"])[:3]
    t = (time.split(":") + ["**", "**", "**"])[:3] if time else ["**"] * 3
    return d + t


def per_duration_of(expr) -> Duration:
    if isinstance(expr, ast.Constant):
        return duration_of(str(expr.value))
    if isinstance(expr, ast.Variable) and expr.stream_ref is None:
        return duration_of(expr.attribute)
    raise PlanError("per must be a constant duration like 'seconds'")


class AggStoreExec:
    """`from A [on cond] within ... per ... select ...`"""

    def __init__(self, agg: AggregationRuntime, sq: ast.StoreQuery):
        self.agg = agg
        if sq.per is None:
            raise PlanError("aggregation store query needs `per`")
        self.per = per_duration_of(sq.per)
        empty = PyExprContext({}, tables=agg.rt.tables)
        self.within_fn = within_range_of(
            sq.within, lambda e: compile_py(e, empty)[0],
            lambda: agg.rt.now_ms())
        octx = PyExprContext({agg.ad.id: agg.out_schema},
                             default_ref=agg.ad.id, tables=agg.rt.tables)
        on = None
        for f in sq.input.filters:
            on = f.expr if on is None else ast.And(on, f.expr)
        self.cond = compile_py(on, octx)[0] if on is not None else None
        sel = sq.selector
        if sel.select_all:
            self.sel_fns = None
            self.out_schema = agg.out_schema
        else:
            extra = {a.name: (a.name, a.type)
                     for a in agg.out_schema.attributes}
            extra[AGG_TIMESTAMP] = (AGG_TIMESTAMP, AttrType.LONG)
            sctx = PyExprContext({}, extra=extra, tables=agg.rt.tables)
            self.sel_fns = []
            names, types = [], []
            for oa in sel.attributes:
                f, t = compile_py(oa.expr, sctx)
                self.sel_fns.append(f)
                names.append(oa.name)
                types.append(t)
            self.out_schema = StreamSchema(f"#store_{agg.ad.id}", tuple(
                ast.Attribute(n, t) for n, t in zip(names, types)))

    def execute(self) -> list:
        t0, t1 = self.within_fn({})
        out = []
        for start, row_env, row in self.agg.rows_between(self.per, t0, t1):
            if self.cond is not None and not self.cond(row_env):
                continue
            if self.sel_fns is None:
                out.append((start, tuple(row)))
            else:
                out.append((start, tuple(f(row_env) for f in self.sel_fns)))
        return out
