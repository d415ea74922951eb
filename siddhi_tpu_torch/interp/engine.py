"""Sequential (host) query engine -- the reference-semantics backend.

Port of `siddhi_tpu/interp/engine.py`: event-at-a-time execution
mirroring the reference's processor chains (filter -> stream functions ->
window -> selector -> output rate limiter -> callback).  Host plans work
on the batches' decoded rows (numpy columns in, Python values through
the closures of `interp/expr.py`, numpy columns out) and touch no
tensor; they are the JAX package's host plans, not a stand-in for any
kernel.  `core/build.py` routes a query here under
`@app:devicePatterns('never')`, `deviceWindows('never')` or
`deviceFilters('never')`, for shapes no device plan has (a window without
aggregates, windowless aggregation, output rate limiting, stream
functions, aggregating or rate-limited patterns) and, under 'auto' or
'prefer', when a device planner refuses a query at plan time (always
with a RuntimeWarning).

  * `InterpSelector`: group-by banks of aggregators, `having`, `order by`,
    `limit`/`offset`, and its state;
  * the output rate limiters (`make_rate_limiter`): per event, per time,
    snapshot, and per-group first/last;
  * `make_window` over the fourteen host windows (`interp/windows.py`),
    the window and stream-function registries (no extension metadata:
    the extension registry is a later slice) with `log` and `pol2cart`;
  * `InterpSingleQueryPlan` (without the JAX package's named-window
    branch: named windows are a later slice, ROADMAP A6) and
    `InterpPatternQueryPlan` (the seq-ordered buffer, playback deadlines
    before each event, `on_timer`/`next_wakeup`, `state_dict`).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Optional

import numpy as np

from ..query import ast
from ..query.ast import AttrType
from ..core.batch import EventBatch
from ..core.planner import OutputBatch, PlanError, QueryPlan
from ..core.runtime import Event
from ..core.schema import TIMESTAMP_DTYPE, StreamSchema, StringTable, dtype_of
from .aggregators import AggSite, extract_aggregators, make_aggregator
from .expr import PyExprContext, compile_py
from .nfa import collect_filters
from . import windows as W

CURRENT, EXPIRED, RESET = W.CURRENT, W.EXPIRED, W.RESET


def rows_batch(schema: StreamSchema, strings: StringTable,
               rows: list) -> EventBatch:
    """[(ts, row)] -> an EventBatch in the schema's column dtypes.  A None
    in a typed column becomes its neutral fill (NaN, False, 0) with the
    row marked in `nulls`, which `EventBatch.rows` turns back into None
    (the JAX package's BatchBuilder.append, siddhi_tpu/core/batch.py:193)."""
    n = len(rows)
    ts = np.fromiter((t for t, _r in rows), dtype=TIMESTAMP_DTYPE, count=n)
    cols, nulls = {}, {}
    for j, a in enumerate(schema.attributes):
        vals = [r[j] for _t, r in rows]
        isnull = [v is None for v in vals]
        if a.type == AttrType.STRING:
            col = np.fromiter((strings.encode(v) for v in vals),
                              dtype=dtype_of(a.type), count=n)
        elif a.type == AttrType.OBJECT:
            col = np.empty(n, dtype=object)
            col[:] = vals
        else:
            fill = float("nan") if a.type in (AttrType.FLOAT,
                                              AttrType.DOUBLE) else \
                False if a.type == AttrType.BOOL else 0
            col = np.asarray([fill if v is None else v for v in vals],
                             dtype=dtype_of(a.type))
        if any(isnull) and a.type != AttrType.STRING:
            nulls[a.name] = np.asarray(isnull, dtype=bool)
        cols[a.name] = col
    return EventBatch(schema, ts, cols, n, np.arange(n, dtype=np.int64),
                      nulls or None)


def _host_sites(expr: ast.Expression, sites: list, ctx) -> ast.Expression:
    """extract_aggregators with each new site's output type taken from
    its host aggregator (every aggregator name, not only the incremental
    ones; siddhi_tpu/interp/engine.py:44-74)."""
    n0 = len(sites)
    out = extract_aggregators(expr, sites, ctx)
    for s in sites[n0:]:
        s.out_type = make_aggregator(s.name, s.in_type).type
    return out


# ---------------------------------------------------------------------------
# selector
# ---------------------------------------------------------------------------

class InterpSelector:
    """QuerySelector analog (reference: core:query/selector/QuerySelector.java:76):
    group-by keyed aggregator banks, having, order-by, limit/offset."""

    def __init__(self, selector: ast.Selector, ctx: PyExprContext,
                 in_schema: Optional[StreamSchema], out_stream_id: str):
        self.selector = selector
        self.sites: list[AggSite] = []
        names, types, fns = [], [], []
        if selector.select_all:
            if in_schema is None:
                raise PlanError("select * needs a single input schema")
            for a in in_schema.attributes:
                f, t = compile_py(ast.Variable(a.name), ctx)
                names.append(a.name)
                types.append(t)
                fns.append(f)
        else:
            for oa in selector.attributes:
                rewritten = _host_sites(oa.expr, self.sites, ctx)
                site_extra = {s.key: (s.key, s.out_type) for s in self.sites}
                ctx2 = PyExprContext(ctx.schemas, {**ctx.extra, **site_extra},
                                     ctx.default_ref, tables=ctx.tables)
                f, t = compile_py(rewritten, ctx2)
                names.append(oa.name)
                types.append(t)
                fns.append(f)
        self.names, self.types, self.fns = names, types, fns
        self.group_fns = [compile_py(g, ctx)[0] for g in selector.group_by]
        self.having = None
        if selector.having is not None:
            extra = {n: (n, t) for n, t in zip(names, types)}
            extra.update({s.key: (s.key, s.out_type) for s in self.sites})
            hctx = PyExprContext(ctx.schemas, {**ctx.extra, **extra},
                                 ctx.default_ref, tables=ctx.tables)
            h_rewritten = _host_sites(selector.having, self.sites, hctx)
            extra.update({s.key: (s.key, s.out_type) for s in self.sites})
            hctx = PyExprContext(ctx.schemas, {**ctx.extra, **extra},
                                 ctx.default_ref, tables=ctx.tables)
            self.having, _ = compile_py(h_rewritten, hctx)
        self.order_by = [(compile_py(ob.var, PyExprContext(
            ctx.schemas, {n: (n, t) for n, t in zip(names, types)},
            ctx.default_ref))[0], ob.order == ast.OrderDir.DESC)
            for ob in selector.order_by]
        # group key -> [Aggregator]
        self._groups: dict = defaultdict(self._new_bank)
        self.out_schema = StreamSchema(out_stream_id, tuple(
            ast.Attribute(n, t) for n, t in zip(names, types)))

    def _new_bank(self):
        return [make_aggregator(s.name, s.in_type) for s in self.sites]

    def _bank_for(self, env) -> list:
        key = tuple(f(env) for f in self.group_fns) if self.group_fns else ()
        return self._groups[key]

    def process(self, kind: str, env: dict):
        """Run one window-emitted event through the selector.
        Returns an output row (list) or None (reset/having-filtered)."""
        if kind == RESET:
            for bank in self._groups.values():
                for a in bank:
                    a.reset()
            return None
        bank = self._bank_for(env)
        for site, agg in zip(self.sites, bank):
            v = site.arg_fns[0](env) if site.arg_fns else None
            if kind == CURRENT:
                agg.add(v)
            else:
                agg.remove(v)
        for site, agg in zip(self.sites, bank):
            env[site.key] = agg.value()
        row = [f(env) for f in self.fns]
        if self.having is not None:
            for n, v in zip(self.names, row):
                env[n] = v
            if not self.having(env):
                return None
        return row

    def order_limit(self, rows: list) -> list:
        """Apply order-by / offset / limit to one output chunk of (ts, row)."""
        for fn, desc in reversed(self.order_by):
            rows.sort(key=lambda tr: fn(dict(zip(self.names, tr[1]))), reverse=desc)
        off = self.selector.offset or 0
        if off:
            rows = rows[off:]
        if self.selector.limit is not None:
            rows = rows[:self.selector.limit]
        return rows

    def state(self):
        # group keys are tuples of scalars — serialize structurally (never
        # repr/eval: snapshots must not be able to execute code on restore)
        return [(k, [a.state() for a in bank])
                for k, bank in self._groups.items()]

    def restore(self, st):
        self._groups.clear()
        if isinstance(st, dict):     # legacy snapshot format: drop aggregates
            st = []
        for k, states in st:
            bank = self._new_bank()
            for a, s in zip(bank, states):
                a.restore(s)
            self._groups[tuple(k)] = bank


# ---------------------------------------------------------------------------
# output rate limiting (reference: core:query/output/ratelimit/*, 12 impls)
# ---------------------------------------------------------------------------

class RateLimiter:
    """Pass-through base; subclasses buffer/emit per policy."""
    needs_timer = False

    def feed(self, kind: str, ts: int, row: list) -> list:
        return [(kind, ts, row)]

    def on_timer(self, now_ms: int) -> list:
        return []

    def next_wakeup(self) -> Optional[int]:
        return None

    def state(self) -> dict:
        return {}

    def restore(self, st) -> None:
        pass


class EventRateLimiter(RateLimiter):
    def __init__(self, count: int, mode: ast.RateType):
        self.count = count
        self.mode = mode
        self.buf: list = []
        self.n = 0

    def feed(self, kind, ts, row):
        if kind != CURRENT:
            return []        # rate limiting applies to output (current) events
        self.n += 1
        if self.mode == ast.RateType.FIRST:
            first = self.n % self.count == 1 or self.count == 1
            return [(kind, ts, row)] if first else []
        self.buf.append((kind, ts, row))
        if self.n % self.count == 0:
            out, self.buf = self.buf, []
            if self.mode == ast.RateType.LAST:
                return [out[-1]]
            return out
        return []

    def state(self):
        return {"buf": self.buf, "n": self.n}

    def restore(self, st):
        self.buf, self.n = list(st["buf"]), st["n"]


class TimeRateLimiter(RateLimiter):
    needs_timer = True

    def __init__(self, millis: int, mode: ast.RateType):
        self.millis = millis
        self.mode = mode
        self.buf: list = []
        self.window_start: Optional[int] = None
        self.emitted_this_window = False

    def feed(self, kind, ts, row):
        if kind != CURRENT:
            return []
        if self.window_start is None:
            self.window_start = ts
        if self.mode == ast.RateType.FIRST:
            if not self.emitted_this_window:
                self.emitted_this_window = True
                return [(kind, ts, row)]
            return []
        self.buf.append((kind, ts, row))
        return []

    def on_timer(self, now_ms):
        if self.window_start is None:
            return []
        out = []
        while now_ms >= self.window_start + self.millis:
            self.window_start += self.millis
            self.emitted_this_window = False
            if self.buf:
                if self.mode == ast.RateType.LAST:
                    out.append(self.buf[-1])
                else:
                    out.extend(self.buf)
                self.buf = []
        return out

    def next_wakeup(self):
        if self.window_start is None:
            return None
        return self.window_start + self.millis

    def state(self):
        return {"buf": self.buf, "ws": self.window_start,
                "em": self.emitted_this_window}

    def restore(self, st):
        self.buf = list(st["buf"])
        self.window_start = st["ws"]
        self.emitted_this_window = st["em"]


class SnapshotRateLimiter(RateLimiter):
    """Emits, every interval, the latest live output rows (reference:
    WrappedSnapshotOutputRateLimiter re-plays window snapshots)."""
    needs_timer = True

    def __init__(self, millis: int):
        self.millis = millis
        self.live: dict = {}       # source seq -> (ts, row)
        self.seq = 0
        self.window_start: Optional[int] = None

    def feed(self, kind, ts, row):
        if self.window_start is None:
            self.window_start = ts
        if kind == CURRENT:
            self.live[self.seq] = (ts, row)
            self.seq += 1
        elif kind == EXPIRED and self.live:
            self.live.pop(next(iter(self.live)), None)
        return []

    def on_timer(self, now_ms):
        if self.window_start is None:
            return []
        out = []
        while now_ms >= self.window_start + self.millis:
            self.window_start += self.millis
            out.extend((CURRENT, now_ms, row) for _, row in self.live.values())
        return out

    def next_wakeup(self):
        if self.window_start is None:
            return None
        return self.window_start + self.millis

    def state(self):
        return {"live": list(self.live.items()), "seq": self.seq,
                "ws": self.window_start}

    def restore(self, st):
        self.live = dict(st["live"])
        self.seq = st["seq"]
        self.window_start = st["ws"]


class GroupedRateLimiter(RateLimiter):
    """Per-group first/last rate limiting (reference: the GroupByPer*
    OutputRateLimiter family, e.g. core:query/output/ratelimit/event/
    GroupByPerEventOutputRateLimiter.java): one child limiter per group
    key, keyed by the selected group-by columns."""

    def __init__(self, factory: Callable, key_idx: list):
        self.factory = factory
        self.key_idx = key_idx
        self.subs: dict = {}
        self.needs_timer = factory().needs_timer

    def _sub(self, row):
        key = tuple(row[i] for i in self.key_idx)
        sub = self.subs.get(key)
        if sub is None:
            sub = self.subs[key] = self.factory()
        return sub

    def feed(self, kind, ts, row):
        return self._sub(row).feed(kind, ts, row)

    def on_timer(self, now_ms):
        out = []
        for sub in self.subs.values():
            out.extend(sub.on_timer(now_ms))
        return out

    def next_wakeup(self):
        ws = [w for s in self.subs.values()
              for w in [s.next_wakeup()] if w is not None]
        return min(ws) if ws else None

    def state(self):
        return {"groups": [(k, s.state()) for k, s in self.subs.items()]}

    def restore(self, st):
        self.subs = {}
        for k, sub_st in st["groups"]:
            sub = self.factory()
            sub.restore(sub_st)
            self.subs[tuple(k)] = sub


def _group_key_positions(selector) -> Optional[list]:
    """Output-row positions of the group-by attributes (None when the
    selection doesn't carry them — falls back to a global limiter)."""
    if selector is None or not selector.group_by or selector.select_all:
        return None
    pos = []
    for g in selector.group_by:
        for i, oa in enumerate(selector.attributes):
            e = oa.expr
            if isinstance(e, ast.Variable) and e.attribute == g.attribute \
                    and e.index is None:
                pos.append(i)
                break
        else:
            return None
    return pos


def make_rate_limiter(rate, selector=None) -> Optional[RateLimiter]:
    if rate is None:
        return None
    if isinstance(rate, ast.EventOutputRate):
        factory = lambda: EventRateLimiter(rate.count, rate.type)
    elif isinstance(rate, ast.TimeOutputRate):
        factory = lambda: TimeRateLimiter(rate.millis, rate.type)
    elif isinstance(rate, ast.SnapshotOutputRate):
        return SnapshotRateLimiter(rate.millis)
    else:
        raise PlanError(f"unknown output rate {rate}")
    # per-group first/last (reference GroupByPer* limiter family)
    if rate.type in (ast.RateType.FIRST, ast.RateType.LAST):
        pos = _group_key_positions(selector)
        if pos is not None:
            return GroupedRateLimiter(factory, pos)
    return factory()


# ---------------------------------------------------------------------------
# window factory
# ---------------------------------------------------------------------------

def _const(e, what="argument"):
    if isinstance(e, ast.TimeConstant):
        return e.millis
    if isinstance(e, ast.Constant):
        return e.value
    raise PlanError(f"window {what} must be constant, got {e}")


def make_window(h: ast.WindowHandler, ctx: PyExprContext,
                schema: StreamSchema) -> W.Window:
    name = h.name.lower()
    args = h.args

    def getter(i):
        f, _ = compile_py(args[i], ctx)
        return lambda ev_env: f(ev_env)

    def ev_getter(i):
        f, _ = compile_py(args[i], ctx)
        names = schema.names
        def g(ev):
            env = dict(zip(names, ev.data))
            env["__timestamp__"] = ev.timestamp
            return f(env)
        return g

    if name == "length":
        return W.LengthWindow(int(_const(args[0])))
    if name == "lengthbatch":
        return W.LengthBatchWindow(int(_const(args[0])))
    if name == "time":
        return W.TimeWindow(int(_const(args[0])))
    if name == "timebatch":
        start = int(_const(args[1])) if len(args) > 1 else None
        return W.TimeBatchWindow(int(_const(args[0])), start)
    if name == "externaltime":
        return W.ExternalTimeWindow(ev_getter(0), int(_const(args[1])))
    if name == "externaltimebatch":
        start = int(_const(args[2])) if len(args) > 2 else None
        return W.ExternalTimeBatchWindow(ev_getter(0), int(_const(args[1])), start)
    if name == "timelength":
        return W.TimeLengthWindow(int(_const(args[0])), int(_const(args[1])))
    if name == "batch":
        return W.BatchWindow()
    if name == "session":
        key = ev_getter(1) if len(args) > 1 else None
        latency = int(_const(args[2])) if len(args) > 2 else 0
        return W.SessionWindow(int(_const(args[0])), key, latency)
    if name == "sort":
        desc = False
        if len(args) > 2 and isinstance(args[2], ast.Constant):
            desc = str(args[2].value).lower() == "desc"
        return W.SortWindow(int(_const(args[0])), ev_getter(1), desc)
    if name == "delay":
        return W.DelayWindow(int(_const(args[0])))
    if name == "frequent":
        key = ev_getter(1) if len(args) > 1 else None
        return W.FrequentWindow(int(_const(args[0])), key)
    if name == "lossyfrequent":
        err = float(_const(args[1])) if len(args) > 1 else None
        key = ev_getter(2) if len(args) > 2 else None
        return W.LossyFrequentWindow(float(_const(args[0])), err, key)
    if name == "cron":
        return W.CronWindow(str(_const(args[0])))
    builder = WINDOW_TYPES.get((h.namespace.lower() if h.namespace else None,
                                name))
    if builder is not None:
        return builder(args, ctx, schema)
    raise PlanError(f"unknown window type {h.name!r}")


# extension point: custom window processors (reference: @Extension windows
# discovered by SiddhiExtensionLoader; here an explicit registry)
WINDOW_TYPES: dict = {}


def register_window_type(name: str, builder,
                         namespace: Optional[str] = None) -> None:
    """builder(args: tuple[ast expr], ctx: PyExprContext, schema) -> Window"""
    WINDOW_TYPES[(namespace.lower() if namespace else None,
                  name.lower())] = builder


# ---------------------------------------------------------------------------
# stream functions (reference: core:query/processor/stream/
# LogStreamProcessor.java, Pol2CartStreamProcessor; extension point ≅
# @Extension StreamFunctionProcessor)
# ---------------------------------------------------------------------------

STREAM_FUNCTIONS: dict = {}


def register_stream_function(name: str, builder,
                             namespace: Optional[str] = None) -> None:
    """builder(args, ctx, in_schema, query_name) ->
    (out_schema, fn(Event) -> list[row_tuple])"""
    STREAM_FUNCTIONS[(namespace.lower() if namespace else None,
                      name.lower())] = builder


def _log_stream_fn(args, ctx, in_schema, query_name):
    msg_fns = [compile_py(a, ctx)[0] for a in args]
    names = in_schema.names

    def fn(ev: Event) -> list:
        env = dict(zip(names, ev.data))
        env["__timestamp__"] = ev.timestamp
        extra = ", ".join(str(f(env)) for f in msg_fns)
        prefix = f"{query_name}: " + (f"{extra}, " if extra else "")
        print(f"{prefix}{ev.timestamp}, {ev.data}")
        return [ev.data]
    return in_schema, fn


def _pol2cart_stream_fn(args, ctx, in_schema, query_name):
    import math as _m
    theta_f = compile_py(args[0], ctx)[0]
    rho_f = compile_py(args[1], ctx)[0]
    z_f = compile_py(args[2], ctx)[0] if len(args) > 2 else None
    names = in_schema.names
    extra = (ast.Attribute("x", AttrType.DOUBLE),
             ast.Attribute("y", AttrType.DOUBLE)) + (
        (ast.Attribute("z", AttrType.DOUBLE),) if z_f else ())
    out_schema = StreamSchema(in_schema.id, in_schema.attributes + extra)

    def fn(ev: Event) -> list:
        env = dict(zip(names, ev.data))
        env["__timestamp__"] = ev.timestamp
        theta, rho = theta_f(env), rho_f(env)
        x = rho * _m.cos(_m.radians(theta))
        y = rho * _m.sin(_m.radians(theta))
        row = ev.data + ((x, y, z_f(env)) if z_f else (x, y))
        return [row]
    return out_schema, fn


register_stream_function("log", _log_stream_fn)
register_stream_function("pol2cart", _pol2cart_stream_fn)


# ---------------------------------------------------------------------------
# single-stream query plan
# ---------------------------------------------------------------------------

class InterpSingleQueryPlan(QueryPlan):
    """from S[f]#window.w(...) select ... group by ... having ...
    output rate ... insert <events_for> into Target — sequential backend
    (siddhi_tpu/interp/engine.py:570-749 without its named-window branch:
    the port has no named windows yet, ROADMAP A6)."""

    def __init__(self, name: str, rt, q: ast.Query, inp: ast.SingleInputStream,
                 target: Optional[str]):
        self.name = name
        self.rt = rt
        schema = rt.schemas[inp.stream_id]
        self.in_schema = schema
        self.input_streams = (inp.stream_id,)
        self.output_target = target
        self.events_for = getattr(q.output, "events_for", ast.OutputEventsFor.CURRENT)
        ctx = PyExprContext({inp.alias: schema, inp.stream_id: schema},
                            default_ref=inp.alias, tables=rt.tables)
        self.ctx = ctx
        self.filters = [compile_py(f.expr, ctx)[0] for f in inp.filters]
        # stream functions chain (reference: StreamFunctionProcessor
        # subclasses; extension point instead of hardcoded built-ins).
        # Filters apply first, then stream functions in handler order.
        self._stream_fns: list = []
        work_schema = schema
        for h in inp.handlers:
            if isinstance(h, ast.StreamFunction):
                key = (h.namespace.lower() if h.namespace else None,
                       h.name.lower())
                builder = STREAM_FUNCTIONS.get(key)
                if builder is None:
                    raise PlanError(f"query {name!r}: unknown stream function "
                                    f"{h.name!r}")
                hctx = PyExprContext({inp.alias: work_schema,
                                      inp.stream_id: work_schema},
                                     default_ref=inp.alias, tables=rt.tables)
                work_schema, fn = builder(h.args, hctx, work_schema, name)
                self._stream_fns.append(fn)
        self.work_schema = work_schema
        sctx = ctx if work_schema is schema else PyExprContext(
            {inp.alias: work_schema, inp.stream_id: work_schema},
            default_ref=inp.alias, tables=rt.tables)
        self.window: Optional[W.Window] = None
        wh = inp.window
        if wh is not None:
            self.window = make_window(wh, sctx, work_schema)
        self.sel = InterpSelector(q.selector, sctx, work_schema,
                                  target or f"#{name}")
        self.out_schema = self.sel.out_schema
        self.rate = make_rate_limiter(q.rate, q.selector)
        self._names = work_schema.names
        self._in_names = schema.names

    # -- helpers -------------------------------------------------------------

    def _env_of(self, ev: Event) -> dict:
        env = dict(zip(self._names, ev.data))
        env["__timestamp__"] = ev.timestamp
        return env

    def _run_selector(self, emissions: list) -> list:
        """window emissions [(kind, ev)] -> [(kind, ts, row)] post-rate-limit."""
        out = []
        for kind, ev in emissions:
            if kind == RESET:
                self.sel.process(RESET, {})
                continue
            env = self._env_of(ev)
            row = self.sel.process(kind, env)
            if row is None:
                continue
            out.append((kind, ev.timestamp, row))
        # order-by/limit apply per chunk on current rows
        if self.sel.order_by or self.sel.selector.limit is not None \
                or self.sel.selector.offset:
            cur = [(t, r) for k, t, r in out if k == CURRENT]
            cur = self.sel.order_limit(cur)
            out = [(k, t, r) for k, t, r in out if k != CURRENT] + \
                  [(CURRENT, t, r) for t, r in cur]
        if self.rate is not None:
            out2 = []
            for k, t, r in out:
                out2.extend(self.rate.feed(k, t, r))
            out = out2
        return out

    def _to_output_batches(self, rows: list) -> list:
        """[(kind, ts, row)] -> [OutputBatch] honoring events_for."""
        want_current = self.events_for in (ast.OutputEventsFor.CURRENT,
                                           ast.OutputEventsFor.ALL)
        want_expired = self.events_for in (ast.OutputEventsFor.EXPIRED,
                                           ast.OutputEventsFor.ALL)
        cur = [(t, r) for k, t, r in rows if k == CURRENT and want_current]
        exp = [(t, r) for k, t, r in rows if k == EXPIRED and want_expired]
        out = []
        for subset, is_exp in ((cur, False), (exp, True)):
            if not subset:
                continue
            out.append(OutputBatch(self.output_target, rows_batch(
                self.out_schema, self.rt.strings, subset), is_expired=is_exp))
        return out

    # -- QueryPlan interface -------------------------------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        kind = CURRENT
        rows = batch.rows(self.rt.strings)
        emitted: list = []
        for ts, row in zip(batch.timestamps, rows):
            ev = Event(int(ts), row)
            env = dict(zip(self._in_names, ev.data))
            env["__timestamp__"] = ev.timestamp
            if any(not f(env) for f in self.filters):
                continue
            evs = [ev]
            for fn in self._stream_fns:
                evs = [Event(e.timestamp, r) for e in evs for r in fn(e)]
            now = self.rt.now_ms() if not self.rt._playback else ev.timestamp
            for e2 in evs:
                if self.window is None:
                    emitted.append((kind, e2))
                else:
                    emitted.extend(self.window.process(e2, now))
        if isinstance(self.window, W.BatchWindow):
            emitted.extend(self.window.end_chunk(self.rt.now_ms()))
        out_rows = self._run_selector(emitted)
        return self._to_output_batches(out_rows)

    def on_timer(self, now_ms: int) -> list:
        rows = []
        if self.window is not None:
            rows.extend(self._run_selector(self.window.on_timer(now_ms)))
        if self.rate is not None:
            rows.extend(self.rate.on_timer(now_ms))
        return self._to_output_batches(rows)

    def next_wakeup(self) -> Optional[int]:
        cands = []
        if self.window is not None:
            w = self.window.next_wakeup()
            if w is not None:
                cands.append(w)
        if self.rate is not None:
            w = self.rate.next_wakeup()
            if w is not None:
                cands.append(w)
        return min(cands) if cands else None

    def state_dict(self) -> dict:
        return {
            "window": self.window.state() if self.window else None,
            "selector": self.sel.state(),
            "rate": self.rate.state() if self.rate else None,
        }

    def load_state_dict(self, d: dict) -> None:
        if self.window is not None and d.get("window") is not None:
            self.window.restore(d["window"])
        self.sel.restore(d["selector"])
        if self.rate is not None and d.get("rate") is not None:
            self.rate.restore(d["rate"])


# ---------------------------------------------------------------------------
# pattern / sequence query plan
# ---------------------------------------------------------------------------

class InterpPatternQueryPlan(QueryPlan):
    """from [every] e1=A[...] -> e2=B[...] within T select ... — sequential
    backend over the NFA matcher (reference call stack: SURVEY §3.3)."""

    def __init__(self, name: str, rt, q: ast.Query,
                 state_input, target: Optional[str]):
        from .nfa import NFACompiler, PatternMatcher
        from ..query.ast import StateType
        self.name = name
        self.rt = rt
        self.output_target = target
        self.events_for = getattr(q.output, "events_for", ast.OutputEventsFor.CURRENT)

        comp = NFACompiler()
        entries, _exits = comp.lower(state_input.state)
        self.nodes = comp.nodes
        qw = state_input.within.millis if state_input.within else None
        self.matcher = PatternMatcher(
            self.nodes, [n.id for n in entries],
            state_input.type == StateType.SEQUENCE, qw)

        # schemas per ref + per stream for filter/selector contexts
        schemas: dict = {}
        for n in self.nodes:
            if n.stream_id not in rt.schemas:
                raise PlanError(f"query {name!r}: unknown stream {n.stream_id!r}")
            schemas[n.ref] = rt.schemas[n.stream_id]
        self.matcher._schema_names = {
            sid: rt.schemas[sid].names for sid in {n.stream_id for n in self.nodes}}
        self.input_streams = tuple(dict.fromkeys(n.stream_id
                                                 for n in self.nodes))

        # node filters: current event attrs unqualified + own ref; other refs
        for n, elem_filters in zip(self.nodes, collect_filters(state_input.state)):
            if elem_filters:
                own = rt.schemas[n.stream_id]
                ctx = PyExprContext({**schemas, n.ref: own}, default_ref=n.ref,
                                    tables=rt.tables)
                fns = [compile_py(f.expr, ctx)[0] for f in elem_filters]
                if len(fns) == 1:
                    n.filter_fn = fns[0]
                else:
                    n.filter_fn = lambda env, _fns=fns: all(f(env) for f in _fns)

        # selector over capture refs
        sel_ast = q.selector
        if sel_ast.select_all:
            # select * on patterns: concatenation of each ref's attributes
            attrs = []
            seen = set()
            for n in self.nodes:
                for a in rt.schemas[n.stream_id].attributes:
                    nm = a.name if a.name not in seen else f"{n.ref}_{a.name}"
                    seen.add(nm)
                    attrs.append(ast.OutputAttribute(
                        ast.Variable(a.name, stream_ref=n.ref), nm))
            sel_ast = ast.Selector(False, tuple(attrs), sel_ast.group_by,
                                   sel_ast.having, sel_ast.order_by,
                                   sel_ast.limit, sel_ast.offset)
        ctx = PyExprContext(schemas, tables=rt.tables)
        self.sel = InterpSelector(sel_ast, ctx, None, target or f"#{name}")
        self.out_schema = self.sel.out_schema
        self.rate = make_rate_limiter(q.rate, q.selector)
        self._buffer: list = []      # (seq, stream_id, Event)

    # -- QueryPlan interface -------------------------------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        rows = batch.rows(self.rt.strings)
        seqs = batch.seqs if batch.seqs is not None else range(batch.n)
        for seq, ts, row in zip(seqs, batch.timestamps, rows):
            self._buffer.append((int(seq), stream_id, Event(int(ts), row)))
        return []

    def finalize(self) -> list:
        if not self._buffer:
            return []
        now = self.rt.now_ms()
        if self.rt._playback and self.rt._clock_ms is None:
            # playback, virtual clock not yet entered: anchor absent
            # wait-clocks on the event timeline, not the wall clock
            now = min(ev.timestamp for _seq, _sid, ev in self._buffer)
        self.matcher.start(now)
        buf = sorted(self._buffer, key=lambda t: t[0])
        self._buffer = []
        out_rows: list = []
        for _seq, sid, ev in buf:
            if self.rt._playback:
                # fire absent-state deadlines that precede this event
                while True:
                    w = self.matcher.next_wakeup()
                    if w is None or w > ev.timestamp:
                        break
                    out_rows.extend(self._matches_to_rows(
                        self.matcher.on_timer(w)))
            out_rows.extend(self._matches_to_rows(
                self.matcher.on_event(sid, ev)))
        if self.sel.order_by or self.sel.selector.limit is not None \
                or self.sel.selector.offset:
            cur = [(t, r) for _k, t, r in out_rows]
            out_rows = [(CURRENT, t, r) for t, r in self.sel.order_limit(cur)]
        if self.rate is not None:
            out_rows = [r for k, t, row in out_rows
                        for r in self.rate.feed(k, t, row)]
        return self._to_batches(out_rows)

    def on_timer(self, now_ms: int) -> list:
        self.matcher.start(now_ms)
        rows = self._matches_to_rows(self.matcher.on_timer(now_ms))
        if self.rate is not None:
            rows = [r for k, t, row in rows for r in self.rate.feed(k, t, row)]
            rows.extend(self.rate.on_timer(now_ms))
        return self._to_batches(rows)

    def next_wakeup(self):
        self.matcher.start(self.rt.now_ms())
        cands = []
        w = self.matcher.next_wakeup()
        if w is not None:
            cands.append(w)
        if self.rate is not None:
            w = self.rate.next_wakeup()
            if w is not None:
                cands.append(w)
        return min(cands) if cands else None

    # -- helpers -------------------------------------------------------------

    def _matches_to_rows(self, matches: list) -> list:
        rows = []
        for m in matches:
            env = self.matcher.env_of_captures(m["captures"])
            env["__timestamp__"] = m["ts"]
            row = self.sel.process(CURRENT, env)
            if row is not None:
                rows.append((CURRENT, m["ts"], row))
        return rows

    def _to_batches(self, rows: list) -> list:
        if not rows or self.events_for == ast.OutputEventsFor.EXPIRED:
            return []
        return [OutputBatch(self.output_target, rows_batch(
            self.out_schema, self.rt.strings,
            [(t, r) for _k, t, r in rows]))]

    def state_dict(self) -> dict:
        return {"matcher": self.matcher.state(),
                "selector": self.sel.state(),
                "rate": self.rate.state() if self.rate else None}

    def load_state_dict(self, d: dict) -> None:
        self.matcher.restore(d["matcher"])
        self.sel.restore(d["selector"])
        if self.rate is not None and d.get("rate") is not None:
            self.rate.restore(d["rate"])
