"""Columnar event micro-batches (struct-of-arrays) + host-side accumulator.

Port of `siddhi_tpu/core/batch.py` (`EventBatch`, `BatchBuilder`) without
the upload pad pools: the host accumulates rows into per-attribute numpy
buffers, and `freeze()` yields an EventBatch whose columns the plans move
to the device as one tensor each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ..query.ast import AttrType
from .schema import TIMESTAMP_DTYPE, StreamSchema, StringTable, dtype_of


@dataclass
class EventBatch:
    """One micro-batch of events for a single stream."""
    schema: StreamSchema
    timestamps: np.ndarray            # (n,) int64 ms
    columns: dict                     # name -> (n,) ndarray
    n: int
    seqs: Optional[np.ndarray] = None  # (n,) int64 global arrival order
    nulls: Optional[dict] = None      # name -> (n,) bool, True = NULL

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def rows(self, strings: Optional[StringTable] = None) -> list[tuple]:
        """Decode back to row tuples (strings decoded if a table is given)."""
        nulls = self.nulls or {}
        cols = []
        for a in self.schema.attributes:
            arr = self.columns[a.name]
            if a.type == AttrType.STRING and strings is not None:
                dec = strings._to_str
                col = [dec[c] if 0 <= c < len(dec) else None
                       for c in arr.tolist()]
            else:
                col = arr.tolist()
            a_nulls = nulls.get(a.name)
            if a_nulls is not None and a_nulls.any():
                col = [None if nn else v
                       for v, nn in zip(col, a_nulls.tolist())]
            cols.append(col)
        return list(zip(*cols)) if cols else [()] * self.n

    @classmethod
    def empty(cls, schema: StreamSchema) -> "EventBatch":
        cols = {a.name: np.empty(0, dtype=dtype_of(a.type))
                for a in schema.attributes}
        return cls(schema, np.empty(0, dtype=TIMESTAMP_DTYPE), cols, 0,
                   np.empty(0, dtype=np.int64))


class BatchBuilder:
    """Mutable row accumulator -> EventBatch (the per-stream ingest buffer
    behind InputHandler)."""

    def __init__(self, schema: StreamSchema, strings: StringTable,
                 capacity: int = 1024):
        self.schema = schema
        self.strings = strings
        self.capacity = capacity
        self._pieces: list = []       # (ts, cols, seqs, n) in arrival order
        self._clear_rows()

    def _clear_rows(self) -> None:
        self._ts: list[int] = []
        self._seqs: list[int] = []
        self._cols: dict[str, list] = {a.name: []
                                       for a in self.schema.attributes}

    def __len__(self) -> int:
        return len(self._ts) + sum(p[3] for p in self._pieces)

    @property
    def full(self) -> bool:
        return len(self._ts) >= self.capacity

    def append(self, timestamp: int, row: Sequence[Any], seq: int) -> None:
        attrs = self.schema.attributes
        if len(row) != len(attrs):
            raise ValueError(
                f"stream {self.schema.id!r} expects {len(attrs)} attributes "
                f"{self.schema.names}, got {len(row)}: {row!r}")
        for a, v in zip(attrs, row):
            if v is None and a.type != AttrType.STRING:
                raise ValueError(
                    f"stream {self.schema.id!r}: null {a.type.name} value "
                    f"for {a.name!r} (device columns carry no nulls)")
        self._ts.append(int(timestamp))
        self._seqs.append(seq)
        for a, v in zip(attrs, row):
            if a.type == AttrType.STRING:
                v = self.strings.encode(v)
            self._cols[a.name].append(v)

    def append_columnar(self, timestamps: np.ndarray, columns: dict,
                        seqs: np.ndarray) -> None:
        """Adopt an already-columnar segment (arrays in their device dtype,
        strings pre-encoded) without copying."""
        n = int(len(timestamps))
        if n:
            self._seal_rows()
            self._pieces.append((timestamps, columns, seqs, n))

    def _seal_rows(self) -> None:
        n = len(self._ts)
        if not n:
            return
        cols = {a.name: np.asarray(self._cols[a.name], dtype=dtype_of(a.type))
                for a in self.schema.attributes}
        self._pieces.append((np.asarray(self._ts, dtype=TIMESTAMP_DTYPE),
                             cols, np.asarray(self._seqs, dtype=np.int64), n))
        self._clear_rows()

    def freeze_and_clear(self) -> EventBatch:
        self._seal_rows()
        pieces, self._pieces = self._pieces, []
        if not pieces:
            return EventBatch.empty(self.schema)
        if len(pieces) == 1:
            ts, cols, seqs, n = pieces[0]
            return EventBatch(self.schema, ts, cols, n, seqs)
        cols = {a.name: np.concatenate([p[1][a.name] for p in pieces])
                for a in self.schema.attributes}
        return EventBatch(self.schema, np.concatenate([p[0] for p in pieces]),
                          cols, sum(p[3] for p in pieces),
                          np.concatenate([p[2] for p in pieces]))
