"""siddhi_tpu_torch: the PyTorch/CUDA port of siddhi_tpu.

A stream-processing and complex-event-processing engine whose hot paths
are hand-written CUDA kernels for Hopper (csrc/): the predicate VM
(`kernels/expr_eval.py`), the batched pattern NFA
(`kernels/nfa_block.py`), the `scan` family's trees, chase and
compaction, the window scans, ranges and compaction, and the join probe
(`kernels/join_probe.py`).  The facade matches the JAX package's:

    from siddhi_tpu_torch import SiddhiManager
    rt = SiddhiManager().create_app_runtime(app_text)   # device="cuda"

`SiddhiManager(device="cpu")` runs every kernel's plain PyTorch version.
This package imports torch and numpy, never jax nor siddhi_tpu.
"""
from .core.batch import EventBatch
from .core.runtime import Event, SiddhiAppRuntime, SiddhiManager
from .core.schema import StreamSchema
from .query import parse

__all__ = ["SiddhiManager", "SiddhiAppRuntime", "StreamSchema", "EventBatch",
           "Event", "parse"]
