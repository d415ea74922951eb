"""App builder: walks the AST's execution elements and instantiates plans.

Port of `siddhi_tpu/core/build.py` for this slice: single-stream
filter/projection queries become FilterProjectPlans, pattern/sequence
queries DevicePatternPlans (an unpartitioned pattern runs with P = 1, as
the JAX package does under `@app:devicePatterns('prefer')`), and value
partitions go to `partition.plan_partition`.  Every other construct
raises PlanError naming the slice it belongs to.
"""
from __future__ import annotations

from ..query import ast
from .planner import (FilterProjectPlan, PlanError, output_target_of,
                      selector_has_aggregators)

_LATER = "is a later slice of the port"


def build_app(rt) -> None:
    app = rt.app
    for what, defs in (("tables", app.table_definitions),
                       ("named windows", app.window_definitions),
                       ("triggers", app.trigger_definitions),
                       ("script functions", app.function_definitions),
                       ("incremental aggregations",
                        app.aggregation_definitions)):
        if defs:
            raise PlanError(f"{what}: {_LATER}")
    for i, elem in enumerate(app.execution_elements):
        if isinstance(elem, ast.Query):
            rt._register_plan(plan_query(rt, elem, f"query_{i}"))
        elif isinstance(elem, ast.Partition):
            from .partition import plan_partition
            plan_partition(rt, elem, index=i)
        else:
            raise PlanError(f"unknown execution element {type(elem).__name__}")


def plan_query(rt, q: ast.Query, default_name: str):
    name = q.name(default_name)
    target = output_target_of(q)
    inp = q.input
    if isinstance(inp, ast.SingleInputStream):
        if inp.is_fault or inp.is_inner:
            raise PlanError(f"query {name!r}: fault/inner streams {_LATER}")
        if inp.stream_id not in rt.schemas:
            raise PlanError(f"query {name!r}: unknown input stream "
                            f"{inp.stream_id!r}")
        if inp.window is not None:
            raise PlanError(f"query {name!r}: windows {_LATER}")
        if selector_has_aggregators(q.selector) or q.selector.group_by:
            raise PlanError(f"query {name!r}: aggregation {_LATER}")
        if q.rate is not None:
            raise PlanError(f"query {name!r}: output rate limiting {_LATER}")
        if any(isinstance(h, ast.StreamFunction) for h in inp.handlers):
            raise PlanError(f"query {name!r}: stream functions {_LATER}")
        return FilterProjectPlan(
            name, rt.schemas[inp.stream_id], inp.alias,
            [f.expr for f in inp.filters], q.selector, rt.strings, target,
            rt.device, q.selector.limit, q.selector.offset,
            events_for=q.output.events_for)
    if isinstance(inp, ast.StateInputStream):
        from .pattern_plan import DevicePatternPlan
        return DevicePatternPlan(name, rt, q, inp, target,
                                 slots=rt.device_slots)
    if isinstance(inp, ast.JoinInputStream):
        raise PlanError(f"query {name!r}: joins {_LATER}")
    raise PlanError(f"query {name!r}: input {type(inp).__name__} {_LATER}")
