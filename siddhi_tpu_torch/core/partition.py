"""Partitioned queries on the device partition axis.

Port of `plan_partition` (siddhi_tpu/core/partition.py:248) and
`_columnar_key_fn` (:308), value-key device path only: every partitioned
pattern whose input streams all carry a value key (`symbol of S`) becomes
one DevicePatternPlan whose lanes are the keys.  Range partitions,
computed keys, inner (`#`) streams and non-pattern queries inside a
partition raise PlanError: the JAX package runs them as per-key host
clones, which are not ported.
"""
from __future__ import annotations

from ..query import ast
from .batch import EventBatch
from .planner import PlanError, output_target_of


def input_stream_ids(q: ast.Query) -> list:
    """Input stream ids; inner (#) streams come back with a '#' prefix."""
    def sid_of(s: ast.SingleInputStream) -> str:
        return f"#{s.stream_id}" if s.is_inner else s.stream_id

    inp = q.input
    if isinstance(inp, ast.SingleInputStream):
        return [sid_of(inp)]
    if isinstance(inp, ast.JoinInputStream):
        return [sid_of(inp.left), sid_of(inp.right)]
    out: list = []

    def walk(e):
        if isinstance(e, (ast.StreamStateElement,
                          ast.AbsentStreamStateElement)):
            out.append(sid_of(e.stream))
        elif isinstance(e, ast.CountStateElement):
            walk(e.stream)
        elif isinstance(e, ast.LogicalStateElement):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.NextStateElement):
            walk(e.state)
            walk(e.next)
        elif isinstance(e, ast.EveryStateElement):
            walk(e.state)
    walk(inp.state)
    return out


def plan_partition(rt, part: ast.Partition, index: int) -> None:
    from .pattern_plan import DevicePatternPlan
    if any(pk.expr is None for pk in part.keys):
        raise PlanError("range partitions are a later slice of the port")
    value_keys = {pk.stream_id: pk.expr for pk in part.keys}
    for qi, q in enumerate(part.queries):
        name = q.name(f"query_p{index}_{qi}")
        if not isinstance(q.input, ast.StateInputStream):
            raise PlanError(
                f"query {name!r}: partitioned non-pattern queries (per-key "
                f"host clones) are a later slice of the port")
        if rt.device_patterns == "never":
            raise PlanError(f"query {name!r}: devicePatterns('never') needs "
                            f"the host matcher, which is a later slice of "
                            f"the port")
        sids = set(input_stream_ids(q))
        if not sids <= set(value_keys):
            raise PlanError(
                f"query {name!r}: pattern consumes streams without value "
                f"partition keys ({sorted(sids - set(value_keys))})")
        key_fns = {s: _columnar_key_fn(rt, s, value_keys[s]) for s in sids}
        rt._register_plan(DevicePatternPlan(
            name, rt, q, q.input, output_target_of(q),
            partitions=rt.partition_capacity, part_key_fns=key_fns,
            slots=rt.device_slots))


def _columnar_key_fn(rt, stream_id: str, expr: ast.Expression):
    """batch -> key column (string keys are their dictionary codes)."""
    schema = rt.schemas[stream_id]
    if isinstance(expr, ast.Variable) and expr.stream_ref in (None, stream_id):
        name = expr.attribute
        if name not in schema.types:
            raise PlanError(f"partition key: unknown attribute {name!r}")

        def fn(batch: EventBatch):
            return batch.columns[name]
        return fn
    raise PlanError("computed partition keys are a later slice of the port")
