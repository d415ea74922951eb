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

Below them, the host interpreter's attribute aggregators with the
current/expired/reset protocol (siddhi_tpu/interp/aggregators.py:15-316):
sum, count, avg, min/max over a sorted multiset (exact removal),
minForever/maxForever, stdDev, distinctCount, and/or, unionSet, and
`make_aggregator`.  The host selector (`interp/engine.py`) keeps one bank
of them per group key.  Custom aggregators (the JAX package's extension
registry) are a later slice.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Optional

from ..core.expr import ExprError
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


# -- host aggregators (siddhi_tpu/interp/aggregators.py:15-316) ------------

class Aggregator:
    type: AttrType = AttrType.DOUBLE

    def add(self, v):
        raise NotImplementedError

    def remove(self, v):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def value(self):
        raise NotImplementedError

    def state(self):
        return self.__dict__.copy()

    def restore(self, st):
        self.__dict__.update(st)


class SumAgg(Aggregator):
    def __init__(self, in_type: AttrType):
        self.type = AttrType.LONG if in_type in (AttrType.INT, AttrType.LONG) \
            else AttrType.DOUBLE
        self.s = None

    def add(self, v):
        if v is None:
            return
        self.s = v if self.s is None else self.s + v

    def remove(self, v):
        if v is None or self.s is None:
            return
        self.s -= v

    def reset(self):
        self.s = None

    def value(self):
        return self.s


class CountAgg(Aggregator):
    type = AttrType.LONG

    def __init__(self, in_type=None):
        self.n = 0

    def add(self, v):
        self.n += 1

    def remove(self, v):
        self.n -= 1

    def reset(self):
        self.n = 0

    def value(self):
        return self.n


class AvgAgg(Aggregator):
    type = AttrType.DOUBLE

    def __init__(self, in_type=None):
        self.s = 0.0
        self.n = 0

    def add(self, v):
        if v is None:
            return
        self.s += v
        self.n += 1

    def remove(self, v):
        if v is None:
            return
        self.s -= v
        self.n -= 1

    def reset(self):
        self.s, self.n = 0.0, 0

    def value(self):
        return None if self.n == 0 else self.s / self.n


class _OrderedAgg(Aggregator):
    """min/max with expiry — sorted multiset (reference keeps deques and
    recomputes; a sorted list gives O(log n) adds and exact removal)."""

    def __init__(self, in_type: AttrType):
        self.type = in_type
        self.vals: list = []

    def add(self, v):
        if v is None:
            return
        bisect.insort(self.vals, v)

    def remove(self, v):
        if v is None:
            return
        i = bisect.bisect_left(self.vals, v)
        if i < len(self.vals) and self.vals[i] == v:
            self.vals.pop(i)

    def reset(self):
        self.vals = []


class MinAgg(_OrderedAgg):
    def value(self):
        return self.vals[0] if self.vals else None


class MaxAgg(_OrderedAgg):
    def value(self):
        return self.vals[-1] if self.vals else None


class MinForeverAgg(Aggregator):
    def __init__(self, in_type: AttrType):
        self.type = in_type
        self.m = None

    def add(self, v):
        if v is not None and (self.m is None or v < self.m):
            self.m = v

    def remove(self, v):      # forever aggregators ignore expiry
        pass

    def reset(self):
        pass

    def value(self):
        return self.m


class MaxForeverAgg(MinForeverAgg):
    def add(self, v):
        if v is not None and (self.m is None or v > self.m):
            self.m = v


class StdDevAgg(Aggregator):
    type = AttrType.DOUBLE

    def __init__(self, in_type=None):
        self.n = 0
        self.s = 0.0
        self.sq = 0.0

    def add(self, v):
        if v is None:
            return
        self.n += 1
        self.s += v
        self.sq += v * v

    def remove(self, v):
        if v is None:
            return
        self.n -= 1
        self.s -= v
        self.sq -= v * v

    def reset(self):
        self.n, self.s, self.sq = 0, 0.0, 0.0

    def value(self):
        if self.n < 1:
            return None
        mean = self.s / self.n
        var = max(self.sq / self.n - mean * mean, 0.0)
        return math.sqrt(var)


class DistinctCountAgg(Aggregator):
    type = AttrType.LONG

    def __init__(self, in_type=None):
        self.counts: dict = {}

    def add(self, v):
        self.counts[v] = self.counts.get(v, 0) + 1

    def remove(self, v):
        c = self.counts.get(v)
        if c is not None:
            if c <= 1:
                del self.counts[v]
            else:
                self.counts[v] = c - 1

    def reset(self):
        self.counts = {}

    def value(self):
        return len(self.counts)


class AndAgg(Aggregator):
    type = AttrType.BOOL

    def __init__(self, in_type=None):
        self.false_n = 0
        self.n = 0

    def add(self, v):
        self.n += 1
        if not v:
            self.false_n += 1

    def remove(self, v):
        self.n -= 1
        if not v:
            self.false_n -= 1

    def reset(self):
        self.n = self.false_n = 0

    def value(self):
        return self.false_n == 0


class OrAgg(Aggregator):
    type = AttrType.BOOL

    def __init__(self, in_type=None):
        self.true_n = 0

    def add(self, v):
        if v:
            self.true_n += 1

    def remove(self, v):
        if v:
            self.true_n -= 1

    def reset(self):
        self.true_n = 0

    def value(self):
        return self.true_n > 0


class UnionSetAgg(Aggregator):
    type = AttrType.OBJECT

    def __init__(self, in_type=None):
        self.counts: dict = {}

    def add(self, v):
        if isinstance(v, (set, frozenset, list, tuple)):
            for x in v:
                self.counts[x] = self.counts.get(x, 0) + 1
        elif v is not None:
            self.counts[v] = self.counts.get(v, 0) + 1

    def remove(self, v):
        items = v if isinstance(v, (set, frozenset, list, tuple)) else [v]
        for x in items:
            c = self.counts.get(x)
            if c is not None:
                if c <= 1:
                    del self.counts[x]
                else:
                    self.counts[x] = c - 1

    def reset(self):
        self.counts = {}

    def value(self):
        return set(self.counts)


AGGREGATOR_CLASSES = {
    "sum": SumAgg, "count": CountAgg, "avg": AvgAgg, "min": MinAgg,
    "max": MaxAgg, "minforever": MinForeverAgg, "maxforever": MaxForeverAgg,
    "stddev": StdDevAgg, "distinctcount": DistinctCountAgg,
    "and": AndAgg, "or": OrAgg, "unionset": UnionSetAgg,
}


def make_aggregator(name: str, in_type: Optional[AttrType]) -> Aggregator:
    cls = AGGREGATOR_CLASSES.get(name.lower())
    if cls is None:
        raise ExprError(f"unknown aggregator {name!r}")
    return cls(in_type)


def aggregator_out_type(name: str, in_type: Optional[AttrType]) -> AttrType:
    return make_aggregator(name, in_type).type
