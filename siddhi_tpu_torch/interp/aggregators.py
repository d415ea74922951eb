"""Aggregate sites of a selector and their output types.

Port of the parts of the JAX package's host interpreter that the device
window plan and the incremental aggregation read: `extract_aggregators`
and `AggSite` (siddhi_tpu/interp/engine.py:33-74), the output types of the
incremental aggregators (siddhi_tpu/interp/aggregators.py:37-136), and
`_collect_site_args` (siddhi_tpu/core/window_device.py:1130).  Without a
context a site keeps its argument's AST, and the window plan takes the
argument's type from the port's expression compiler; with a host
expression context (`interp/expr.py`) it also carries the compiled per-row
argument (`arg_fns`), `in_type` and `out_type`, as the JAX package's
sites do for its aggregation runtime.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.planner import AGGREGATOR_NAMES
from ..query import ast
from ..query.ast import AttrType

INCREMENTAL = ("sum", "count", "avg", "min", "max")
_INTS = (AttrType.INT, AttrType.LONG)
_NUMERIC = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


@dataclass
class AggSite:
    """One aggregator call, replaced by the variable `key` (`__agg<i>`)."""
    name: str                       # lower-case aggregator name
    arg: Optional[ast.Expression]   # its first argument, or None
    key: str
    arg_fns: list = field(default_factory=list)   # compiled host getters
    in_type: Optional[AttrType] = None
    out_type: Optional[AttrType] = None


def extract_aggregators(expr: ast.Expression, sites: list,
                        ctx=None) -> ast.Expression:
    """Replace aggregator calls with placeholder variables, appending an
    AggSite per call in traversal order.  With `ctx` (a PyExprContext)
    each site compiles its arguments and takes its types; `out_type` is
    None for an aggregator without an incremental form."""
    if isinstance(expr, ast.FunctionCall) and expr.namespace is None \
            and expr.name.lower() in AGGREGATOR_NAMES:
        key = f"__agg{len(sites)}"
        site = AggSite(expr.name.lower(),
                       expr.args[0] if expr.args else None, key)
        if ctx is not None:
            from .expr import compile_py
            fns = [compile_py(a, ctx) for a in expr.args]
            site.arg_fns = [f for f, _t in fns]
            site.in_type = fns[0][1] if fns else None
            try:
                site.out_type = out_type(site.name, site.in_type)
            except ValueError:
                site.out_type = None
        sites.append(site)
        return ast.Variable(key)

    def sub(e):
        return extract_aggregators(e, sites, ctx)
    if isinstance(expr, ast.Math):
        return ast.Math(sub(expr.left), expr.op, sub(expr.right))
    if isinstance(expr, ast.Compare):
        return ast.Compare(sub(expr.left), expr.op, sub(expr.right))
    if isinstance(expr, ast.And):
        return ast.And(sub(expr.left), sub(expr.right))
    if isinstance(expr, ast.Or):
        return ast.Or(sub(expr.left), sub(expr.right))
    if isinstance(expr, ast.Not):
        return ast.Not(sub(expr.expr))
    if isinstance(expr, ast.FunctionCall):
        return ast.FunctionCall(expr.name, tuple(sub(a) for a in expr.args),
                                expr.namespace)
    return expr


def out_type(name: str, in_type: Optional[AttrType]) -> AttrType:
    """Output type of an incremental aggregator: sum gives LONG over
    INT/LONG and DOUBLE over FLOAT/DOUBLE, count LONG, avg DOUBLE, min and
    max their input type.  Raises ValueError for anything else."""
    if name == "count":
        return AttrType.LONG
    if name not in INCREMENTAL:
        raise ValueError(f"aggregator {name}()")
    if in_type is None:
        raise ValueError(f"{name}() needs an argument")
    if in_type not in _NUMERIC:
        raise ValueError(f"{name}() over non-numeric ({in_type.name}) column")
    if name == "sum":
        return AttrType.LONG if in_type in _INTS else AttrType.DOUBLE
    if name == "avg":
        return AttrType.DOUBLE
    return in_type
