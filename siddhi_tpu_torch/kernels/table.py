"""One launch's parameter arrays in one device buffer.

The kernels take their scalars in a `__grid_constant__` parameter block
and everything of variable length -- VM programs and constant pools,
column and row-source pointers, per-position and per-tree tables -- in
sections of ONE device buffer: the host packs the sections into one byte
array, one copy moves it to the card, and the block carries a pointer per
section.  So no chain, program or match table is bounded by a fixed array
in the block.

The copy comes from pageable host memory, which a CUDA graph cannot
capture: each wrapper therefore splits into `prepare(...)` (allocate the
outputs, pack and upload the table) and the returned `Launch`, whose
call only resets what the kernel accumulates into and launches, and can
be captured and replayed.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch


class DeviceTable:
    """Sections appended on the host (8-byte aligned), uploaded once."""

    def __init__(self):
        self._parts: list = []
        self._size = 0
        self._fixups: list = []       # (struct, field, offset)
        self.tensor = None

    def add(self, values, dtype) -> int:
        """Append one section; returns its byte offset."""
        a = np.ascontiguousarray(np.asarray(values, dtype=dtype)).reshape(-1)
        raw = a.view(np.uint8)
        off = self._size
        pad = -len(raw) % 8
        self._parts.append(raw)
        if pad:
            self._parts.append(np.zeros(pad, np.uint8))
        self._size += len(raw) + pad
        return off

    def field(self, struct, name: str, values, dtype) -> None:
        """Append a section and point `struct.name` at it on upload."""
        self._fixups.append((struct, name, self.add(values, dtype)))

    def upload(self, device) -> torch.Tensor:
        buf = np.concatenate(self._parts) if self._parts else \
            np.zeros(8, np.uint8)
        self.tensor = torch.from_numpy(buf).to(device)
        base = self.tensor.data_ptr()
        for struct, name, off in self._fixups:
            setattr(struct, name, ctypes.c_void_p(base + off))
        return self.tensor


class Launch:
    """A prepared kernel launch: `fn()` resets what the kernel accumulates
    into and enqueues it on the current stream (the entry point returns a
    cudaError_t), `keep` holds every tensor whose pointer the parameter
    block carries, `outputs` is what the wrapper returns."""

    def __init__(self, fn, what: str, counter: str, keep: list, outputs):
        self._fn = fn
        self.what = what
        self.counter = counter
        self.keep = keep
        self.outputs = outputs
        self.params = None      # the wrapper's parameter block, where kept

    def __call__(self):
        from . import LAUNCHES, PARAMS
        from .build import check
        check(self._fn(), self.what)
        LAUNCHES[self.counter] += 1
        if self.counter in PARAMS:
            PARAMS[self.counter].append(self.params)
        return self.outputs


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def checked_ptr(keep: list, dev, what: str):
    """ptr(tensor, dtype=None) -> data pointer of a contiguous tensor on
    `dev` (kept alive in `keep`); raises on anything else."""
    def ptr(t: torch.Tensor, dt=None) -> int:
        if t.device != dev or not t.is_contiguous() or \
                (dt is not None and t.dtype != dt):
            raise ValueError(f"{what}: bad tensor {t.dtype} {t.device} "
                             f"{tuple(t.shape)}")
        keep.append(t)
        return t.data_ptr()
    return ptr
