"""Engine facade: SiddhiManager / SiddhiAppRuntime / InputHandler.

Port of `siddhi_tpu/core/runtime.py`, kept lean for this slice: events
accumulate into per-stream columnar builders; `flush()` (or a builder
reaching `batch_capacity`, 2048 as in the JAX package) drains them as
micro-batches through the plans, and outputs reach callbacks.  Pattern
and join plans buffer what they are sent (a join both its streams, one
stream for a self-join) and run their device blocks when the drain round
settles, so one `send_batch` is one flush of the NFA or the join.

Time: `set_time(ms)` advances the virtual clock and fires the plans'
due timers (absent-pattern deadlines) in wakeup order, draining after
each; under `@app:playback` the clock follows the events' timestamps.

Annotations read: `@app:partitionCapacity`, `@app:deviceSlots`,
`@app:deviceSlotCap`, `@app:playback`, `@app:fusedLanes`, the
placement modes `@app:devicePatterns`, `@app:deviceWindows`,
`@app:deviceFilters` ('never' plans the host interpreter, core/build.py)
and `@app:deviceJoins` ('never' raises: the host join is a later slice),
`@app:devicePrecision('f64')`, and by the aggregations
`@app:deviceAggregations` and `@app:aggCapacity`.  Store queries on
aggregations: `query()` / `query_with_schema()`; `explain()` reports the
aggregations' placement.  No autotuning, write-ahead log, replication,
telemetry or network serving: those are later slices.

The runtime runs on `device` ("cuda" by default).  Without a CUDA card it
raises unless the caller asked for the CPU, where every kernel wrapper
runs its plain PyTorch version.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..query import ast as qast
from ..query.parser import parse
from .batch import BatchBuilder, EventBatch
from .planner import OutputBatch, PlanError, QueryPlan
from .schema import StreamSchema, StringTable, dtype_of


@dataclass
class Event:
    """Host-side decoded event; `uid` (0 = unassigned) is kept by the host
    windows when they re-stamp an expired event."""
    timestamp: int
    data: tuple
    uid: int = 0

    def __iter__(self):
        return iter(self.data)


class InputHandler:
    def __init__(self, runtime: "SiddhiAppRuntime", stream_id: str):
        self._rt = runtime
        self.stream_id = stream_id

    def send(self, data, timestamp: Optional[int] = None) -> None:
        """One row tuple, a list of row tuples, or an Event."""
        self._rt.send(self.stream_id, data, timestamp)

    def send_batch(self, columns: dict, timestamps=None) -> None:
        """Columnar ingest: one micro-batch straight from numpy arrays
        (string attributes as str arrays or pre-encoded int32 codes)."""
        self._rt.send_columnar(self.stream_id, columns, timestamps)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "siddhi_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class SiddhiAppRuntime:
    def __init__(self, app: qast.SiddhiApp, device: torch.device):
        self.app = app
        self.device = device
        self.strings = StringTable()
        self.batch_capacity = 2048
        self._playback = qast.find_annotation(app.annotations,
                                              "app:playback") is not None
        self._clock_ms: Optional[int] = None
        pc = qast.find_annotation(app.annotations, "app:partitionCapacity")
        self.partition_capacity = int(pc.element()) if pc is not None else 1024
        ds = qast.find_annotation(app.annotations, "app:deviceSlots")
        self.device_slots = int(ds.element()) if ds is not None else 16
        self.device_patterns = self._mode(app, "app:devicePatterns")
        self.device_joins = self._mode(app, "app:deviceJoins")
        self.device_windows = self._mode(app, "app:deviceWindows")
        self.device_filters = self._mode(app, "app:deviceFilters")
        self.schemas: dict = {sid: StreamSchema.of(sd)
                              for sid, sd in app.stream_definitions.items()}
        self._plans: list = []
        self._known_query_names: set = set()
        self._query_callbacks: dict = defaultdict(list)
        self._subscribers: dict = defaultdict(list)
        self._stream_callbacks: dict = defaultdict(list)
        self._batch_callbacks: dict = defaultdict(list)
        self._builders: dict = {}
        self._pending: list = []
        self._seq = 0
        self.tables: dict = {}          # tables are a later slice: empty
        self.aggregations: dict = {}    # id -> AggregationRuntime
        self._store_cache: dict = {}    # store-query text -> compiled, LRU
        from .build import build_app
        build_app(self)

    @staticmethod
    def _mode(app: qast.SiddhiApp, name: str) -> str:
        """A placement annotation's value, lower case ('auto' when absent)."""
        a = qast.find_annotation(app.annotations, name)
        return str(a.element()).lower() if a is not None else "auto"

    def _register_plan(self, plan: QueryPlan) -> None:
        self._plans.append(plan)
        self._known_query_names.update(
            getattr(plan, "query_names", None) or
            [getattr(plan, "callback_name", plan.name)])
        for sid in plan.input_streams:
            self._subscribers[sid].append(plan)
        tgt = plan.output_target
        if tgt is not None and plan.out_schema is not None:
            have = self.schemas.get(tgt)
            want = plan.out_schema
            if have is None:
                self.schemas[tgt] = StreamSchema(tgt, want.attributes)
            elif [a.type for a in have.attributes] != \
                    [a.type for a in want.attributes]:
                raise PlanError(
                    f"query {plan.name!r} inserts into {tgt!r} with "
                    f"mismatched schema {want.attributes} vs "
                    f"{have.attributes}")

    # -- public API ----------------------------------------------------------

    def input_handler(self, stream_id: str) -> InputHandler:
        if stream_id not in self.schemas:
            raise KeyError(f"unknown stream {stream_id!r}")
        return InputHandler(self, stream_id)

    getInputHandler = input_handler

    def add_callback(self, stream_id: str, fn: Callable) -> None:
        """StreamCallback: fn(list[Event]) on every batch reaching stream_id."""
        self._stream_callbacks[stream_id].append(fn)

    def add_batch_callback(self, stream_id: str, fn: Callable) -> None:
        """Columnar StreamCallback: fn(EventBatch), no row decode (decode
        with batch.rows(rt.strings))."""
        self._batch_callbacks[stream_id].append(fn)

    def add_query_callback(self, query_name: str, fn: Callable) -> None:
        """QueryCallback: fn(timestamp_ms, in_events, removed_events) on
        every batch the query emits (a fused query's own rows only)."""
        if query_name not in self._known_query_names:
            raise KeyError(f"unknown query {query_name!r}; have "
                           f"{sorted(self._known_query_names)}")
        self._query_callbacks[query_name].append(fn)

    def plans(self) -> list:
        return list(self._plans)

    def start(self) -> None:
        pass

    # -- on-demand (store) queries (siddhi_tpu/core/runtime.py:746-786) ------

    def query(self, text: str) -> list:
        """Run a store query against an aggregation (`from A [on cond]
        within t0, t1 per 'min' select ...`) after a flush; returns
        [(timestamp_ms, row_tuple)].  The compiled form is cached per
        text."""
        return self.query_with_schema(text)[1]

    def query_with_schema(self, text: str) -> tuple:
        """query() plus the compiled output schema: (StreamSchema, rows).
        The 64 most recent texts stay compiled (least recently used
        first out)."""
        from ..query.parser import parse_store_query
        from .store import compile_store_query
        exec_ = self._store_cache.pop(text, None)
        if exec_ is None:
            if len(self._store_cache) >= 64:
                self._store_cache.pop(next(iter(self._store_cache)))
            exec_ = compile_store_query(self, parse_store_query(text))
        self._store_cache[text] = exec_
        self.flush()
        return exec_.out_schema, exec_.execute()

    def explain(self) -> dict:
        """Placement of the app's aggregations, in the form of the JAX
        package's explain() (siddhi_tpu/core/placement.py:274-292): per
        aggregation its path (`device-resident`, `device-batch` or
        `host`), durations, retention, evictions and the D-AGG records of
        a path other than the default."""
        aggs = {}
        for an, a in sorted(self.aggregations.items()):
            ent = {"path": a.path, "durations": [d.name for d in a.durations]}
            if a.retention_ms:
                ent["retention_ms"] = {d.name: v for d, v in sorted(
                    a.retention_ms.items(), key=lambda kv: kv[0].approx_millis)}
            if any(a.evicted.values()):
                ent["evicted"] = {d.name: k for d, k in a.evicted.items() if k}
            if a.demotions:
                ent["demotions"] = list(a.demotions)
            aggs[an] = ent
        return {"aggregations": aggs}

    def shutdown(self) -> None:
        """Nothing to stop: the port runs no threads or sockets."""

    def now_ms(self) -> int:
        if self._clock_ms is not None:
            return self._clock_ms
        return int(time.time() * 1000)

    def set_time(self, ms: int) -> None:
        """Advance the virtual clock to `ms`, firing the plans' due timers
        in wakeup order (siddhi_tpu/core/runtime.py:913)."""
        self.flush()
        if self._clock_ms is None:
            self._clock_ms = ms
        self._fire_timers(ms)
        self._clock_ms = ms
        self._drain()

    def _fire_timers(self, upto_ms: int) -> None:
        """Fire the earliest due wakeup of every plan, drain, repeat until
        nothing is due by `upto_ms` (each tick disarms what it fired, so
        the earliest wakeup only moves forward)."""
        for _ in range(1_000_000):
            due = [(w, p) for p in self._plans
                   for w in [p.next_wakeup()] if w is not None and w <= upto_ms]
            if not due:
                return
            w0 = min(w for w, _ in due)
            self._clock_ms = w0
            for w, plan in due:
                if w <= w0:
                    for ob in plan.on_timer(w0):
                        self._emit(plan, ob)
            self._drain()
        raise RuntimeError("runaway timer loop")

    # -- ingest ----------------------------------------------------------------

    def _builder(self, stream_id: str) -> BatchBuilder:
        b = self._builders.get(stream_id)
        if b is None:
            b = self._builders[stream_id] = BatchBuilder(
                self.schemas[stream_id], self.strings, self.batch_capacity)
        return b

    def send(self, stream_id: str, data, timestamp: Optional[int] = None
             ) -> None:
        b = self._builder(stream_id)
        if isinstance(data, Event):
            rows = [(data.timestamp if timestamp is None else timestamp,
                     data.data)]
        elif data and isinstance(data, list) and \
                isinstance(data[0], (tuple, list, Event)):
            rows = [(r.timestamp, r.data) if isinstance(r, Event) else
                    (self.now_ms() if timestamp is None else timestamp, r)
                    for r in data]
        else:
            rows = [(self.now_ms() if timestamp is None else timestamp,
                     tuple(data))]
        for ts, row in rows:
            if self._playback:
                self._clock_ms = ts
            self._seq += 1
            b.append(ts, row, self._seq)
        if b.full:
            self.flush()

    def send_columnar(self, stream_id: str, columns: dict,
                      timestamps=None) -> None:
        """One columnar micro-batch (see InputHandler.send_batch); rows
        buffered by `send` merge ahead of it in the same batch."""
        schema = self.schemas.get(stream_id)
        if schema is None:
            raise PlanError(f"unknown stream {stream_id!r}")
        missing = [a.name for a in schema.attributes if a.name not in columns]
        if missing:
            raise ValueError(
                f"stream {stream_id!r}: send_batch missing columns {missing}")
        cols, n = {}, None
        for a in schema.attributes:
            v = columns[a.name]
            arr = self.strings.encode_many(v) if a.type == \
                qast.AttrType.STRING else np.asarray(v, dtype=dtype_of(a.type))
            if arr.ndim != 1 or (n is not None and arr.shape[0] != n):
                raise ValueError(f"stream {stream_id!r}: column {a.name!r} "
                                 f"must be 1-d with one value per row")
            n = arr.shape[0]
            cols[a.name] = arr
        if not n:
            return
        if timestamps is None:
            ts = np.full(n, self.now_ms(), dtype=np.int64)
        else:
            ts = np.atleast_1d(np.asarray(timestamps, dtype=np.int64))
            if ts.shape[0] == 1 and n > 1:
                ts = np.full(n, int(ts[0]), dtype=np.int64)
            if ts.shape[0] != n:
                raise ValueError(f"stream {stream_id!r}: {ts.shape[0]} "
                                 f"timestamps for {n} rows")
            if self._playback:
                self._clock_ms = int(ts.max())
        seqs = np.arange(self._seq + 1, self._seq + 1 + n, dtype=np.int64)
        self._seq += n
        b = self._builder(stream_id)
        b.append_columnar(ts, cols, seqs)
        self._pending.append((stream_id, b.freeze_and_clear()))
        self._drain()

    def flush(self) -> None:
        """Drain every builder through the plans; callbacks fire here."""
        for sid, b in self._builders.items():
            if len(b):
                self._pending.append((sid, b.freeze_and_clear()))
        self._drain()

    # -- dispatch ----------------------------------------------------------------

    def _drain(self) -> None:
        guard = 0
        while True:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("runaway stream recursion "
                                   "(insert-into cycle?)")
            if not self._pending:
                progressed = False
                for plan in self._plans:
                    for ob in plan.finalize():
                        self._emit(plan, ob)
                        progressed = True
                if not self._pending and not progressed:
                    return
                continue
            sid, batch = self._pending.pop(0)
            for cb in self._batch_callbacks.get(sid, ()):
                cb(batch)
            for cb in self._stream_callbacks.get(sid, ()):
                cb(self._decode(batch))
            for plan in self._subscribers.get(sid, ()):
                for ob in plan.process(sid, batch):
                    self._emit(plan, ob)

    def _emit(self, plan: QueryPlan, ob: OutputBatch) -> None:
        if ob.batch.n == 0:
            return
        cbs = self._query_callbacks.get(
            ob.callback_name or getattr(plan, "callback_name", plan.name), ())
        if cbs:
            ts_last = int(ob.batch.timestamps[-1])
            for cb in cbs:
                events = self._decode(ob.batch)
                if ob.is_expired:
                    cb(ts_last, None, events)
                else:
                    cb(ts_last, events, None)
        if ob.target is not None:
            # derived events arrive "now": stamp global seqs so downstream
            # multi-input plans merge them in true order
            n = ob.batch.n
            ob.batch.seqs = np.arange(self._seq + 1, self._seq + 1 + n,
                                      dtype=np.int64)
            self._seq += n
            self._pending.append((ob.target, ob.batch))

    def _decode(self, batch: EventBatch) -> list:
        rows = batch.rows(self.strings)
        return [Event(int(ts), row) for ts, row in zip(batch.timestamps, rows)]


class SiddhiManager:
    """Creates app runtimes on one device ("cuda" unless asked otherwise)."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self._runtimes: list = []

    def create_app_runtime(self, app: Union[str, qast.SiddhiApp]
                           ) -> SiddhiAppRuntime:
        if isinstance(app, str):
            app = parse(app)
        rt = SiddhiAppRuntime(app, self.device)
        self._runtimes.append(rt)
        return rt

    createSiddhiAppRuntime = create_app_runtime

    def shutdown(self) -> None:
        for rt in self._runtimes:
            rt.shutdown()
        self._runtimes.clear()
