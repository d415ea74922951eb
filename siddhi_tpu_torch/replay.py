"""Replay a column tape through a window app, flush by flush.

The shared runner of `chip_smoke.py`'s window phases and the card tests:
each flush is one `send_batch` of the tape's columns on `StockStream`
(symbol codes `K<i>`, `price`, `volume`, and `et` = the arrival time when
the app declares it) and one `flush()`, timed on the host clock around
work that ends in `torch.cuda.synchronize()` on a card.  With `record`
(a list), every window plan of the app appends each kernel call it makes
as (name, args, kwargs) (`DeviceWindowAggPlan.record`)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .core.runtime import SiddhiManager
from .core.window_device import DeviceWindowAggPlan


def run_window(app: str, tape: list, device: str,
               record: Optional[list] = None, rows: bool = True) -> tuple:
    """Feed `tape` (dicts of `ts`, `sym_idx`, `price`, `volume` arrays, one
    per flush) through `app` on `device`; returns (rows as (ts, row) in
    output order, or None when `rows` is false; ms per flush; runtime)."""
    rt = SiddhiManager(device=device).create_app_runtime(app)
    if record is not None:
        for p in rt.plans():
            if isinstance(p, DeviceWindowAggPlan):
                p.record = record
    batches: list = []
    rt.add_batch_callback("Out", batches.append)
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(64)],
                     dtype=np.int32)
    per_flush = []
    for f in tape:
        cols = {"symbol": codes[f["sym_idx"]], "price": f["price"],
                "volume": f["volume"]}
        if "et long" in app:
            cols["et"] = f["ts"]
        t0 = time.perf_counter()
        h.send_batch(cols, f["ts"])
        rt.flush()
        if device == "cuda":
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
    out = [(int(t), row) for b in batches
           for t, row in zip(b.timestamps, b.rows(rt.strings))] \
        if rows else None
    return out, per_flush, rt
