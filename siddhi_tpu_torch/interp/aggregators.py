"""Aggregate sites of a selector and their output types.

Port of the parts of the JAX package's host interpreter that the device
window plan reads: `extract_aggregators` and `AggSite`
(siddhi_tpu/interp/engine.py:33-74), the output types of the
incremental aggregators (siddhi_tpu/interp/aggregators.py:37-136), and
`_collect_site_args` (siddhi_tpu/core/window_device.py:1130).  There is no
host evaluator here: a site keeps its argument's AST, and the plan takes
the argument's type from the port's expression compiler.
"""
from __future__ import annotations

from dataclasses import dataclass
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


def extract_aggregators(expr: ast.Expression, sites: list) -> ast.Expression:
    """Replace aggregator calls with placeholder variables, appending an
    AggSite per call in traversal order."""
    if isinstance(expr, ast.FunctionCall) and expr.namespace is None \
            and expr.name.lower() in AGGREGATOR_NAMES:
        key = f"__agg{len(sites)}"
        sites.append(AggSite(expr.name.lower(),
                             expr.args[0] if expr.args else None, key))
        return ast.Variable(key)
    if isinstance(expr, ast.Math):
        return ast.Math(extract_aggregators(expr.left, sites), expr.op,
                        extract_aggregators(expr.right, sites))
    if isinstance(expr, ast.Compare):
        return ast.Compare(extract_aggregators(expr.left, sites), expr.op,
                           extract_aggregators(expr.right, sites))
    if isinstance(expr, ast.And):
        return ast.And(extract_aggregators(expr.left, sites),
                       extract_aggregators(expr.right, sites))
    if isinstance(expr, ast.Or):
        return ast.Or(extract_aggregators(expr.left, sites),
                      extract_aggregators(expr.right, sites))
    if isinstance(expr, ast.Not):
        return ast.Not(extract_aggregators(expr.expr, sites))
    if isinstance(expr, ast.FunctionCall):
        return ast.FunctionCall(expr.name, tuple(
            extract_aggregators(a, sites) for a in expr.args), expr.namespace)
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
