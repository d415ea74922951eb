"""Host window processors — sequential reference semantics.

Port of `siddhi_tpu/interp/windows.py`, all fourteen types: one class per
in-core window of the reference
(reference: core:query/processor/stream/window/*.java, 15 impls; the
current/expired/reset event protocol is documented in the reference's
docs/documentation/siddhi-architecture.md:243-268).

Protocol here: `process(ev, now_ms) -> list[(kind, ev)]` returns the emitted
chunk in reference order (EXPIRED entries precede the CURRENT event that
displaced them; RESET clears aggregators); `on_timer(now_ms)` emits
time-driven expirations; `next_wakeup()` tells the scheduler when to call
back.  Events are runtime.Event objects (timestamp + data tuple).
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Optional

from ..core.runtime import Event

CURRENT = "current"
EXPIRED = "expired"
RESET = "reset"


class Window:
    needs_timer = False

    def process(self, ev: Event, now_ms: int) -> list:
        raise NotImplementedError

    def on_timer(self, now_ms: int) -> list:
        return []

    def next_wakeup(self) -> Optional[int]:
        return None

    # events currently held (for joins `find` and named-window queries)
    def contents(self) -> list:
        return []

    def state(self) -> dict:
        return {}

    def restore(self, st: dict) -> None:
        pass


class LengthWindow(Window):
    """Sliding last-N (reference: LengthWindowProcessor.java — expired
    event is inserted before the displacing current event)."""

    def __init__(self, length: int):
        self.length = length
        self.buf: deque = deque()

    def process(self, ev, now_ms):
        out = []
        if self.length == 0:
            # zero-length: event expires immediately
            return [(CURRENT, ev), (EXPIRED, Event(now_ms, ev.data, ev.uid)), (RESET, ev)]
        if len(self.buf) >= self.length:
            old = self.buf.popleft()
            out.append((EXPIRED, Event(now_ms, old.data, old.uid)))
        out.append((CURRENT, ev))
        self.buf.append(ev)
        return out

    def contents(self):
        return list(self.buf)

    def state(self):
        return {"buf": [(e.timestamp, e.data) for e in self.buf]}

    def restore(self, st):
        self.buf = deque(Event(t, d) for t, d in st["buf"])


class LengthBatchWindow(Window):
    """Tumbling N (reference: LengthBatchWindowProcessor.java): emits the
    batch of N currents, the previous batch as expired, then RESET."""

    def __init__(self, length: int):
        self.length = length
        self.cur: list = []
        self.prev: list = []

    def process(self, ev, now_ms):
        self.cur.append(ev)
        if len(self.cur) < self.length:
            return []
        out = []
        for old in self.prev:
            out.append((EXPIRED, Event(now_ms, old.data, old.uid)))
        if out:
            out.append((RESET, ev))
        for e in self.cur:
            out.append((CURRENT, e))
        self.prev = self.cur
        self.cur = []
        return out

    def contents(self):
        return list(self.cur)

    def state(self):
        return {"cur": [(e.timestamp, e.data) for e in self.cur],
                "prev": [(e.timestamp, e.data) for e in self.prev]}

    def restore(self, st):
        self.cur = [Event(t, d) for t, d in st["cur"]]
        self.prev = [Event(t, d) for t, d in st["prev"]]


class TimeWindow(Window):
    """Sliding time window (reference: TimeWindowProcessor.java):
    every event expires `duration` ms after arrival, via scheduler."""
    needs_timer = True

    def __init__(self, duration_ms: int):
        self.duration = duration_ms
        self.buf: deque = deque()     # events in arrival order

    def process(self, ev, now_ms):
        out = self._expire(now_ms)
        out.append((CURRENT, ev))
        self.buf.append(ev)
        return out

    def _expire(self, now_ms):
        out = []
        while self.buf and self.buf[0].timestamp + self.duration <= now_ms:
            old = self.buf.popleft()
            out.append((EXPIRED, Event(old.timestamp + self.duration, old.data, old.uid)))
        return out

    def on_timer(self, now_ms):
        return self._expire(now_ms)

    def next_wakeup(self):
        if self.buf:
            return self.buf[0].timestamp + self.duration
        return None

    def contents(self):
        return list(self.buf)

    def state(self):
        return {"buf": [(e.timestamp, e.data) for e in self.buf]}

    def restore(self, st):
        self.buf = deque(Event(t, d) for t, d in st["buf"])


class TimeBatchWindow(Window):
    """Tumbling time window (reference: TimeBatchWindowProcessor.java):
    collects for `duration`, then emits currents + previous as expired."""
    needs_timer = True

    def __init__(self, duration_ms: int, start_time: Optional[int] = None):
        self.duration = duration_ms
        self.start: Optional[int] = start_time
        self.cur: list = []
        self.prev: list = []

    def process(self, ev, now_ms):
        if self.start is None:
            self.start = ev.timestamp
        out = self._maybe_flush(now_ms)
        self.cur.append(ev)
        return out

    def _maybe_flush(self, now_ms):
        out = []
        while self.start is not None and now_ms >= self.start + self.duration:
            end = self.start + self.duration
            for old in self.prev:
                out.append((EXPIRED, Event(end, old.data, old.uid)))
            if self.prev:
                out.append((RESET, None))
            for e in self.cur:
                out.append((CURRENT, e))
            self.prev = self.cur
            self.cur = []
            self.start = end
            if not self.cur and not self.prev and now_ms < end + self.duration:
                break
        return out

    def on_timer(self, now_ms):
        return self._maybe_flush(now_ms)

    def next_wakeup(self):
        if self.start is not None and (self.cur or self.prev):
            return self.start + self.duration
        return None

    def contents(self):
        return list(self.cur)

    def state(self):
        return {"cur": [(e.timestamp, e.data) for e in self.cur],
                "prev": [(e.timestamp, e.data) for e in self.prev],
                "start": self.start}

    def restore(self, st):
        self.cur = [Event(t, d) for t, d in st["cur"]]
        self.prev = [Event(t, d) for t, d in st["prev"]]
        self.start = st["start"]


class ExternalTimeWindow(Window):
    """Sliding window over an event-time attribute (reference:
    ExternalTimeWindowProcessor.java) — no scheduler; expiry driven by the
    timestamps arriving on the stream itself."""

    def __init__(self, ts_getter, duration_ms: int):
        self.get_ts = ts_getter        # ev -> event-time long
        self.duration = duration_ms
        self.buf: deque = deque()

    def process(self, ev, now_ms):
        t = self.get_ts(ev)
        out = []
        while self.buf and self.get_ts(self.buf[0]) + self.duration <= t:
            old = self.buf.popleft()
            out.append((EXPIRED, Event(self.get_ts(old) + self.duration, old.data, old.uid)))
        out.append((CURRENT, ev))
        self.buf.append(ev)
        return out

    def contents(self):
        return list(self.buf)

    def state(self):
        return {"buf": [(e.timestamp, e.data) for e in self.buf]}

    def restore(self, st):
        self.buf = deque(Event(t, d) for t, d in st["buf"])


class ExternalTimeBatchWindow(Window):
    """Tumbling over an event-time attribute (reference:
    ExternalTimeBatchWindowProcessor.java, simplified: bucket boundaries at
    start + k*duration, flush when an event crosses the boundary)."""

    def __init__(self, ts_getter, duration_ms: int, start_time: Optional[int] = None):
        self.get_ts = ts_getter
        self.duration = duration_ms
        self.start = start_time
        self.cur: list = []
        self.prev: list = []

    def process(self, ev, now_ms):
        t = self.get_ts(ev)
        out = []
        if self.start is None:
            self.start = t if self.start is None else self.start
        while t >= self.start + self.duration:
            end = self.start + self.duration
            if self.cur or self.prev:
                for old in self.prev:
                    out.append((EXPIRED, Event(end, old.data, old.uid)))
                if self.prev:
                    out.append((RESET, None))
                for e in self.cur:
                    out.append((CURRENT, e))
                self.prev = self.cur
                self.cur = []
            self.start = end
        self.cur.append(ev)
        return out

    def contents(self):
        return list(self.cur)

    def state(self):
        return {"cur": [(e.timestamp, e.data) for e in self.cur],
                "prev": [(e.timestamp, e.data) for e in self.prev],
                "start": self.start}

    def restore(self, st):
        self.cur = [Event(t, d) for t, d in st["cur"]]
        self.prev = [Event(t, d) for t, d in st["prev"]]
        self.start = st["start"]


class TimeLengthWindow(Window):
    """Sliding window bounded by both time and count (reference:
    TimeLengthWindowProcessor.java)."""
    needs_timer = True

    def __init__(self, duration_ms: int, length: int):
        self.duration = duration_ms
        self.length = length
        self.buf: deque = deque()

    def process(self, ev, now_ms):
        out = self._expire(now_ms)
        if len(self.buf) >= self.length:
            old = self.buf.popleft()
            out.append((EXPIRED, Event(now_ms, old.data, old.uid)))
        out.append((CURRENT, ev))
        self.buf.append(ev)
        return out

    def _expire(self, now_ms):
        out = []
        while self.buf and self.buf[0].timestamp + self.duration <= now_ms:
            old = self.buf.popleft()
            out.append((EXPIRED, Event(old.timestamp + self.duration, old.data, old.uid)))
        return out

    def on_timer(self, now_ms):
        return self._expire(now_ms)

    def next_wakeup(self):
        return self.buf[0].timestamp + self.duration if self.buf else None

    def contents(self):
        return list(self.buf)

    def state(self):
        return {"buf": [(e.timestamp, e.data) for e in self.buf]}

    def restore(self, st):
        self.buf = deque(Event(t, d) for t, d in st["buf"])


class BatchWindow(Window):
    """Chunk-batch window (reference: BatchWindowProcessor.java): each
    incoming micro-chunk is the batch; previous chunk expires."""

    def __init__(self):
        self.prev: list = []
        self._chunk: list = []

    # engine feeds events one at a time but marks chunk boundaries
    def process(self, ev, now_ms):
        self._chunk.append(ev)
        return []

    def end_chunk(self, now_ms) -> list:
        if not self._chunk:
            return []
        out = []
        for old in self.prev:
            out.append((EXPIRED, Event(now_ms, old.data, old.uid)))
        if self.prev:
            out.append((RESET, None))
        for e in self._chunk:
            out.append((CURRENT, e))
        self.prev = self._chunk
        self._chunk = []
        return out

    def contents(self):
        return list(self.prev)

    def state(self):
        return {"prev": [(e.timestamp, e.data) for e in self.prev]}

    def restore(self, st):
        self.prev = [Event(t, d) for t, d in st["prev"]]


class SessionWindow(Window):
    """Session window with gap (+ optional allowed latency), per session key
    (reference: SessionWindowProcessor.java:577 LoC; simplified — sessions
    close `gap` ms after the last event; closed sessions emit their events
    as EXPIRED batch)."""
    needs_timer = True

    def __init__(self, gap_ms: int, key_getter=None, allowed_latency_ms: int = 0):
        self.gap = gap_ms
        self.key = key_getter or (lambda ev: "")
        self.latency = allowed_latency_ms
        self.sessions: dict = {}      # key -> [events]
        self.last_ts: dict = {}

    def process(self, ev, now_ms):
        out = self._close(now_ms)
        k = self.key(ev)
        self.sessions.setdefault(k, []).append(ev)
        self.last_ts[k] = ev.timestamp
        out.append((CURRENT, ev))
        return out

    def _close(self, now_ms):
        out = []
        for k in list(self.sessions):
            if self.last_ts[k] + self.gap + self.latency <= now_ms:
                for e in self.sessions[k]:
                    out.append((EXPIRED, Event(now_ms, e.data, e.uid)))
                out.append((RESET, None))
                del self.sessions[k]
                del self.last_ts[k]
        return out

    def on_timer(self, now_ms):
        return self._close(now_ms)

    def next_wakeup(self):
        if not self.last_ts:
            return None
        return min(self.last_ts.values()) + self.gap + self.latency

    def contents(self):
        return [e for evs in self.sessions.values() for e in evs]

    def state(self):
        return {"sessions": {k: [(e.timestamp, e.data) for e in v]
                             for k, v in self.sessions.items()},
                "last": dict(self.last_ts)}

    def restore(self, st):
        self.sessions = {k: [Event(t, d) for t, d in v]
                         for k, v in st["sessions"].items()}
        self.last_ts = dict(st["last"])


class SortWindow(Window):
    """Keeps the top/bottom N by sort key (reference: SortWindowProcessor.java):
    when over capacity, evicts the greatest (asc) / least (desc) element."""

    def __init__(self, length: int, key_getter, descending: bool = False):
        self.length = length
        self.key = key_getter
        self.desc = descending
        self.keys: list = []
        self.evs: list = []

    def process(self, ev, now_ms):
        k = self.key(ev)
        if self.desc:
            k = _Neg(k)
        i = bisect.bisect_right(self.keys, k)
        self.keys.insert(i, k)
        self.evs.insert(i, ev)
        out = [(CURRENT, ev)]
        if len(self.evs) > self.length:
            evicted = self.evs.pop()
            self.keys.pop()
            out.append((EXPIRED, Event(now_ms, evicted.data, evicted.uid)))
        return out

    def contents(self):
        return list(self.evs)

    def state(self):
        return {"evs": [(e.timestamp, e.data) for e in self.evs]}

    def restore(self, st):
        self.evs = [Event(t, d) for t, d in st["evs"]]
        self.keys = [(_Neg(self.key(e)) if self.desc else self.key(e)) for e in self.evs]


class _Neg:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, o):
        return o.v < self.v

    def __le__(self, o):
        return o.v <= self.v

    def __eq__(self, o):
        return o.v == self.v


class DelayWindow(Window):
    """Delays events by T (reference: DelayWindowProcessor.java): events
    emerge as CURRENT only after T ms."""
    needs_timer = True

    def __init__(self, duration_ms: int):
        self.duration = duration_ms
        self.buf: deque = deque()

    def process(self, ev, now_ms):
        self.buf.append(ev)
        return self._release(now_ms)

    def _release(self, now_ms):
        out = []
        while self.buf and self.buf[0].timestamp + self.duration <= now_ms:
            old = self.buf.popleft()
            out.append((CURRENT, Event(old.timestamp, old.data, old.uid)))
        return out

    def on_timer(self, now_ms):
        return self._release(now_ms)

    def next_wakeup(self):
        return self.buf[0].timestamp + self.duration if self.buf else None

    def contents(self):
        return list(self.buf)

    def state(self):
        return {"buf": [(e.timestamp, e.data) for e in self.buf]}

    def restore(self, st):
        self.buf = deque(Event(t, d) for t, d in st["buf"])


class FrequentWindow(Window):
    """Misra-Gries frequent-items window (reference:
    FrequentWindowProcessor.java): keeps events whose key is among the
    top-N candidates; evicted keys' events expire."""

    def __init__(self, count: int, key_getter=None):
        self.count = count
        self.key = key_getter or (lambda ev: ev.data)
        self.counts: dict = {}
        self.events: dict = {}      # key -> latest event

    def process(self, ev, now_ms):
        k = self.key(ev)
        out = []
        if k in self.counts:
            self.counts[k] += 1
            out.append((EXPIRED, Event(now_ms, self.events[k].data, self.events[k].uid)))
            self.events[k] = ev
            out.append((CURRENT, ev))
        elif len(self.counts) < self.count:
            self.counts[k] = 1
            self.events[k] = ev
            out.append((CURRENT, ev))
        else:
            # decrement all; drop zeros (their events expire)
            for kk in list(self.counts):
                self.counts[kk] -= 1
                if self.counts[kk] == 0:
                    out.append((EXPIRED, Event(now_ms, self.events[kk].data, self.events[kk].uid)))
                    del self.counts[kk]
                    del self.events[kk]
        return out

    def contents(self):
        return list(self.events.values())

    def state(self):
        return {"counts": dict(self.counts),
                "events": {k: (e.timestamp, e.data) for k, e in self.events.items()}}

    def restore(self, st):
        self.counts = dict(st["counts"])
        self.events = {k: Event(t, d) for k, (t, d) in st["events"].items()}


class LossyFrequentWindow(Window):
    """Lossy-counting frequent window (reference:
    LossyFrequentWindowProcessor.java)."""

    def __init__(self, support: float, error: Optional[float] = None, key_getter=None):
        self.support = support
        self.error = error if error is not None else support / 10.0
        self.key = key_getter or (lambda ev: ev.data)
        self.width = int(1.0 / self.error)
        self.total = 0
        self.counts: dict = {}     # key -> [count, bucket_delta]
        self.events: dict = {}

    def process(self, ev, now_ms):
        k = self.key(ev)
        self.total += 1
        bucket = (self.total // self.width) + 1
        out = []
        if k in self.counts:
            self.counts[k][0] += 1
            out.append((EXPIRED, Event(now_ms, self.events[k].data, self.events[k].uid)))
        else:
            self.counts[k] = [1, bucket - 1]
        self.events[k] = ev
        out.append((CURRENT, ev))
        if self.total % self.width == 0:
            for kk in list(self.counts):
                c, d = self.counts[kk]
                if c + d <= bucket:
                    out.append((EXPIRED, Event(now_ms, self.events[kk].data, self.events[kk].uid)))
                    del self.counts[kk]
                    del self.events[kk]
        return out

    def contents(self):
        thresh = (self.support - self.error) * self.total
        return [self.events[k] for k, (c, d) in self.counts.items() if c >= thresh]

    def state(self):
        return {"counts": {k: list(v) for k, v in self.counts.items()},
                "events": {k: (e.timestamp, e.data) for k, e in self.events.items()},
                "total": self.total}

    def restore(self, st):
        self.counts = {k: list(v) for k, v in st["counts"].items()}
        self.events = {k: Event(t, d) for k, (t, d) in st["events"].items()}
        self.total = st["total"]


class CronWindow(Window):
    """Cron-scheduled tumbling window (reference: CronWindowProcessor.java).
    Uses a simplified cron evaluator (utils.cron)."""
    needs_timer = True

    def __init__(self, cron_expr: str):
        from ..utils.cron import CronSchedule
        self.cron = CronSchedule(cron_expr)
        self.cur: list = []
        self.prev: list = []
        self._next: Optional[int] = None

    def process(self, ev, now_ms):
        if self._next is None:
            self._next = self.cron.next_fire(now_ms)
        self.cur.append(ev)
        return []

    def on_timer(self, now_ms):
        if self._next is None or now_ms < self._next:
            return []
        out = []
        for old in self.prev:
            out.append((EXPIRED, Event(now_ms, old.data, old.uid)))
        if self.prev:
            out.append((RESET, None))
        for e in self.cur:
            out.append((CURRENT, e))
        self.prev = self.cur
        self.cur = []
        self._next = self.cron.next_fire(now_ms)
        return out

    def next_wakeup(self):
        return self._next

    def contents(self):
        return list(self.cur)

    def state(self):
        return {"cur": [(e.timestamp, e.data) for e in self.cur],
                "prev": [(e.timestamp, e.data) for e in self.prev],
                "next": self._next}

    def restore(self, st):
        self.cur = [Event(t, d) for t, d in st["cur"]]
        self.prev = [Event(t, d) for t, d in st["prev"]]
        self._next = st["next"]
