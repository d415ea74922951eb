"""Minimal quartz-style cron evaluator for cron windows.

Port of `siddhi_tpu/utils/cron.py` (the reference uses the Quartz
library: core:query/processor/stream/window/CronWindowProcessor.java).

Supports 6-field quartz expressions "sec min hour dom mon dow" with
`*`, `*/n`, lists `a,b,c`, ranges `a-b`, and `?`.  Evaluation is
second-granular in UTC.
"""
from __future__ import annotations

import datetime as _dt
from typing import Optional


class CronError(Exception):
    pass


def _parse_field(spec: str, lo: int, hi: int) -> Optional[frozenset]:
    """None means 'any'."""
    if spec in ("*", "?"):
        return None
    vals: set = set()
    for part in spec.split(","):
        if part.startswith("*/"):
            step = int(part[2:])
            vals.update(range(lo, hi + 1, step))
        elif "-" in part and not part.lstrip("-").isdigit():
            a, b = part.split("-", 1)
            vals.update(range(int(a), int(b) + 1))
        elif "/" in part:
            base, step = part.split("/", 1)
            vals.update(range(int(base), hi + 1, int(step)))
        else:
            vals.add(int(part))
    for v in vals:
        if not lo <= v <= hi:
            raise CronError(f"cron value {v} out of range [{lo},{hi}]")
    return frozenset(vals)


class CronSchedule:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) == 5:            # standard cron: prepend seconds=0
            fields = ["0"] + fields
        if len(fields) not in (6, 7):   # quartz allows optional year; ignore it
            raise CronError(f"bad cron expression {expr!r}")
        self.sec = _parse_field(fields[0], 0, 59)
        self.min = _parse_field(fields[1], 0, 59)
        self.hour = _parse_field(fields[2], 0, 23)
        self.dom = _parse_field(fields[3], 1, 31)
        self.mon = _parse_field(fields[4], 1, 12)
        self.dow = _parse_field(fields[5], 0, 7)
        if self.dow is not None:
            # quartz: 1=SUN..7=SAT; python weekday(): Mon=0..Sun=6.
            # normalize quartz 1-7 -> python 6,0,1,...,5 ; accept 0 as SUN too.
            conv = set()
            for v in self.dow:
                v = v % 7          # 7->0 (SUN)
                conv.add((v - 1) % 7 if v else 6)
            self.dow = frozenset(conv)

    def _match(self, t: _dt.datetime) -> bool:
        return ((self.sec is None or t.second in self.sec)
                and (self.min is None or t.minute in self.min)
                and (self.hour is None or t.hour in self.hour)
                and (self.dom is None or t.day in self.dom)
                and (self.mon is None or t.month in self.mon)
                and (self.dow is None or t.weekday() in self.dow))

    def next_fire(self, after_ms: int) -> int:
        """Next fire time strictly after `after_ms` (epoch millis, UTC)."""
        t = _dt.datetime.fromtimestamp(after_ms // 1000 + 1, tz=_dt.timezone.utc)
        t = t.replace(microsecond=0)
        # bounded scan: seconds granularity with fast-forward on mismatch
        for _ in range(4 * 366 * 24 * 60 * 60):   # hard bound ~4 years
            if self.mon is not None and t.month not in self.mon:
                if t.month == 12:
                    t = t.replace(year=t.year + 1, month=1, day=1,
                                  hour=0, minute=0, second=0)
                else:
                    t = t.replace(month=t.month + 1, day=1, hour=0,
                                  minute=0, second=0)
                continue
            if (self.dom is not None and t.day not in self.dom) or \
                    (self.dow is not None and t.weekday() not in self.dow):
                t = (t + _dt.timedelta(days=1)).replace(hour=0, minute=0, second=0)
                continue
            if self.hour is not None and t.hour not in self.hour:
                t = (t + _dt.timedelta(hours=1)).replace(minute=0, second=0)
                continue
            if self.min is not None and t.minute not in self.min:
                t = (t + _dt.timedelta(minutes=1)).replace(second=0)
                continue
            if self.sec is not None and t.second not in self.sec:
                t = t + _dt.timedelta(seconds=1)
                continue
            return int(t.timestamp() * 1000)
        raise CronError("no cron fire time found within 4 years")
