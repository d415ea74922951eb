"""Schema layer: attribute types -> columnar numpy dtypes.

Port of `siddhi_tpu/core/schema.py` without the JAX import and without the
process-wide x64 switch: PyTorch keeps int64/float64 tensors as they are.
An event batch is a struct-of-arrays, one fixed-dtype array per attribute;
strings are dictionary-encoded to int32 codes at ingest, so string
predicates become integer compares on the device.

dtype policy (unchanged from the JAX package):
  STRING -> int32 dictionary code      INT    -> int32
  LONG   -> int64                      FLOAT  -> float32
  DOUBLE -> float64 (device pattern paths compute it in float32)
  BOOL   -> bool                       OBJECT -> host-only
Timestamps -> int64 milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..query.ast import AttrType, Attribute, StreamDefinition

TIMESTAMP_DTYPE = np.int64
STRING_CODE_DTYPE = np.int32

_DTYPE_OF = {
    AttrType.STRING: STRING_CODE_DTYPE,
    AttrType.INT: np.int32,
    AttrType.LONG: np.int64,
    AttrType.FLOAT: np.float32,
    AttrType.DOUBLE: np.float64,
    AttrType.BOOL: np.bool_,
}


def dtype_of(t: AttrType, float64: bool = False):
    if t == AttrType.OBJECT:
        return np.dtype(object)
    if float64 and t == AttrType.DOUBLE:
        return np.float64
    return np.dtype(_DTYPE_OF[t])


class StringTable:
    """Bidirectional string <-> int32 code dictionary, shared per app.

    Code 0 is reserved for None/absent so device-side null checks are `== 0`.
    """

    __slots__ = ("_to_code", "_to_str")

    def __init__(self):
        self._to_code: dict[str, int] = {}
        self._to_str: list[Optional[str]] = [None]

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return 0
        c = self._to_code.get(s)
        if c is None:
            c = len(self._to_str)
            self._to_code[s] = c
            self._to_str.append(s)
        return c

    def decode(self, code: int) -> Optional[str]:
        return self._to_str[code]

    def encode_many(self, values) -> np.ndarray:
        """Vectorized encode: the dict is consulted once per DISTINCT value.
        New values get codes in first-appearance order, so the dictionary
        is identical to the one the per-row path builds."""
        arr = np.asarray(values)
        if arr.dtype.kind in "iu":              # pre-encoded dict codes
            return arr.astype(STRING_CODE_DTYPE, copy=False)
        if arr.dtype.kind == "U" and arr.ndim == 1:
            uniq, first, inv = np.unique(arr, return_index=True,
                                         return_inverse=True)
            codes = np.empty(len(uniq), dtype=STRING_CODE_DTYPE)
            for j in np.argsort(first, kind="stable").tolist():
                codes[j] = self.encode(uniq[j])
            return codes[inv]
        return np.asarray([self.encode(v) for v in values],
                          dtype=STRING_CODE_DTYPE)

    def __len__(self) -> int:
        return len(self._to_str)

    def state(self) -> list:
        return list(self._to_str)

    def restore(self, strings: list) -> None:
        self._to_str = list(strings)
        self._to_code = {s: i for i, s in enumerate(strings) if s is not None}


@dataclass
class StreamSchema:
    """Compile-time schema of one stream."""
    id: str
    attributes: tuple[Attribute, ...]

    def __post_init__(self):
        self.index_of = {a.name: i for i, a in enumerate(self.attributes)}
        self.types = {a.name: a.type for a in self.attributes}

    @classmethod
    def of(cls, d: StreamDefinition) -> "StreamSchema":
        return cls(d.id, tuple(d.attributes))

    @property
    def names(self) -> list[str]:
        return [a.name for a in self.attributes]

    def dtype(self, name: str):
        return dtype_of(self.types[name])

    def type_of(self, name: str) -> AttrType:
        try:
            return self.types[name]
        except KeyError:
            raise KeyError(f"stream {self.id!r} has no attribute {name!r}; "
                           f"has {self.names}") from None
