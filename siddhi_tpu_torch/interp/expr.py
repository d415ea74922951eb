"""Host (sequential) expression evaluator: AST -> Python closures.

Port of `PyExprContext` and `compile_py` (siddhi_tpu/interp/expr.py), the
first piece of the host interpreter: one closure per AST node, evaluated
per event over a dict env.  The device join plan (core/join_device.py)
evaluates its computed selector outputs with it on an outer join's miss
rows, where the other side is NULL and the device programs have no value
to read.  The incremental aggregation (core/aggregation.py) evaluates its
input filters, non-plain aggregate arguments (`sum(p * v)`), output rows
and store queries' `on` conditions and selectors with it.

Env convention matches core/expr.py: keys "attr", "ref.attr",
"ref[i].attr", "__timestamp__".  Values are Python scalars; strings stay
str.  Null (None) follows Siddhi semantics: comparisons and arithmetic
with null yield None (conditions treat None as false).  Not ported here:
script functions (`define function`, a later slice) and `in Table`
(tables are a later slice); both raise ExprError.
"""
from __future__ import annotations

import math
import time
import uuid
from typing import Callable, Optional

from ..core.expr import ExprError, promote
from ..query import ast
from ..query.ast import AttrType, CompareOp, MathOp

PyFn = Callable[[dict], object]


class PyExprContext:
    """Resolution for the host evaluator, the protocol of core/expr.py's
    contexts with string constants kept as strings (siddhi_tpu/interp/
    expr.py:31-72): `schemas`: ref -> StreamSchema; `extra`: name ->
    (env key, AttrType) for names outside any schema (an aggregation's
    group attributes, `AGG_TIMESTAMP`, the `__agg<i>` placeholders);
    `default_ref`: the home of unqualified attributes when several
    schemas hold one; `tables`: id -> table for `in Table` (kept for the
    JAX package's signature; tables are a later slice, so it stays
    empty)."""

    def __init__(self, schemas: dict, extra: Optional[dict] = None,
                 default_ref: Optional[str] = None,
                 tables: Optional[dict] = None):
        self.schemas = schemas
        self.extra = extra or {}
        self.default_ref = default_ref
        self.tables = tables or {}

    def resolve(self, var: ast.Variable) -> tuple[str, AttrType]:
        ref = var.stream_ref
        if ref is None:
            if var.attribute in self.extra:
                return self.extra[var.attribute]
            hits = [(r, s) for r, s in self.schemas.items()
                    if var.attribute in s.types]
            if len(hits) > 1 and self.default_ref is not None:
                hits = [h for h in hits if h[0] == self.default_ref]
            if not hits:
                raise ExprError(f"unknown attribute {var.attribute!r}")
            if len(hits) > 1:
                raise ExprError(f"ambiguous attribute {var.attribute!r}")
            r, s = hits[0]
            key = var.attribute if len(self.schemas) == 1 or \
                r == self.default_ref else f"{r}.{var.attribute}"
            return key, s.type_of(var.attribute)
        if ref not in self.schemas:
            raise ExprError(f"unknown stream reference {ref!r}; have "
                            f"{list(self.schemas)}")
        s = self.schemas[ref]
        if var.index is not None:
            return f"{ref}[{var.index}].{var.attribute}", \
                s.type_of(var.attribute)
        if ref == self.default_ref:
            # a qualified self-reference (`S.x` in `from S[...]`): the
            # single-stream env carries unqualified keys
            return var.attribute, s.type_of(var.attribute)
        return f"{ref}.{var.attribute}", s.type_of(var.attribute)


# -- function registry (host) ------------------------------------------------

PY_FUNCTIONS: dict = {}


def register_py_function(name: str, builder,
                         namespace: Optional[str] = None) -> None:
    """builder(args: list[(PyFn, AttrType)]) -> (PyFn, AttrType)"""
    PY_FUNCTIONS[(namespace, name.lower())] = builder


def _num_guard(f):
    def g(*vals):
        if any(v is None for v in vals):
            return None
        return f(*vals)
    return g


_ORDER = {CompareOp.LT: lambda a, b: a < b, CompareOp.LE: lambda a, b: a <= b,
          CompareOp.GT: lambda a, b: a > b, CompareOp.GE: lambda a, b: a >= b}
_ALL_CMP = {**_ORDER, CompareOp.EQ: lambda a, b: a == b,
            CompareOp.NEQ: lambda a, b: a != b}


def compile_py(expr: ast.Expression,
               ctx: PyExprContext) -> tuple[PyFn, AttrType]:
    if isinstance(expr, ast.Constant):
        v = expr.value
        return (lambda env: v), expr.type
    if isinstance(expr, ast.TimeConstant):
        ms = expr.millis
        return (lambda env: ms), AttrType.LONG
    if isinstance(expr, ast.Variable):
        key, t = ctx.resolve(expr)
        return (lambda env: env.get(key)), t
    if isinstance(expr, ast.Compare):
        lf, lt = compile_py(expr.left, ctx)
        rf, rt = compile_py(expr.right, ctx)
        op = expr.op
        if AttrType.STRING in (lt, rt) or AttrType.BOOL in (lt, rt):
            if op not in (CompareOp.EQ, CompareOp.NEQ) and \
                    AttrType.STRING not in (lt, rt):
                raise ExprError(f"bad comparison {lt} {op} {rt}")
        cmpf = _ALL_CMP[op]
        return (lambda env: _nz(lf(env), rf(env), cmpf)), AttrType.BOOL
    if isinstance(expr, ast.And):
        lf, _ = compile_py(expr.left, ctx)
        rf, _ = compile_py(expr.right, ctx)
        return (lambda env: bool(lf(env)) and bool(rf(env))), AttrType.BOOL
    if isinstance(expr, ast.Or):
        lf, _ = compile_py(expr.left, ctx)
        rf, _ = compile_py(expr.right, ctx)
        return (lambda env: bool(lf(env)) or bool(rf(env))), AttrType.BOOL
    if isinstance(expr, ast.Not):
        f, _ = compile_py(expr.expr, ctx)
        return (lambda env: not bool(f(env))), AttrType.BOOL
    if isinstance(expr, ast.Math):
        return _compile_math(expr, ctx)
    if isinstance(expr, ast.FunctionCall):
        return _compile_fn(expr, ctx)
    if isinstance(expr, ast.IsNull):
        if expr.expr is not None:
            f, _ = compile_py(expr.expr, ctx)
            return (lambda env: f(env) is None), AttrType.BOOL
        ref = expr.stream_ref
        key = f"{ref}.__present__" if expr.index is None \
            else f"{ref}[{expr.index}].__present__"
        return (lambda env: not env.get(key, False)), AttrType.BOOL
    if isinstance(expr, ast.In):
        raise ExprError("'in Table' needs tables, which are a later slice")
    raise ExprError(f"cannot evaluate {type(expr).__name__}")


def _nz(a, b, f):
    if a is None or b is None:
        return False
    return f(a, b)


def _compile_math(expr: ast.Math, ctx) -> tuple[PyFn, AttrType]:
    lf, lt = compile_py(expr.left, ctx)
    rf, rt = compile_py(expr.right, ctx)
    if expr.op == MathOp.ADD and AttrType.STRING in (lt, rt):
        raise ExprError("cannot add strings")   # Siddhi has no string +
    t = promote(lt, rt)
    is_int = t in (AttrType.INT, AttrType.LONG)
    if expr.op == MathOp.ADD:
        f = _num_guard(lambda a, b: a + b)
    elif expr.op == MathOp.SUB:
        f = _num_guard(lambda a, b: a - b)
    elif expr.op == MathOp.MUL:
        f = _num_guard(lambda a, b: a * b)
    elif expr.op == MathOp.DIV:
        if is_int:      # Java semantics: truncate toward zero
            f = _num_guard(lambda a, b: None if b == 0 else int(a / b))
        else:
            f = _num_guard(lambda a, b: None if b == 0 else a / b)
    elif expr.op == MathOp.MOD:
        if is_int:
            f = _num_guard(lambda a, b: None if b == 0
                           else int(math.fmod(a, b)))
        else:
            f = _num_guard(lambda a, b: None if b == 0 else math.fmod(a, b))
    else:
        raise ExprError(f"bad op {expr.op}")
    return (lambda env: f(lf(env), rf(env))), t


_CONVERT = {"string": AttrType.STRING, "int": AttrType.INT,
            "long": AttrType.LONG, "float": AttrType.FLOAT,
            "double": AttrType.DOUBLE, "bool": AttrType.BOOL}


def _first_present(fns):
    def co(env):
        for f, _ in fns:
            v = f(env)
            if v is not None:
                return v
        return None
    return co


def _promoted(fns) -> AttrType:
    t = fns[0][1]
    for _, ft in fns[1:]:
        t = promote(t, ft)
    return t


def _compile_fn(expr: ast.FunctionCall, ctx) -> tuple[PyFn, AttrType]:
    name = expr.name.lower()
    ns = expr.namespace.lower() if expr.namespace else None
    if ns is None:
        if name == "ifthenelse":
            c, _ = compile_py(expr.args[0], ctx)
            a, at = compile_py(expr.args[1], ctx)
            b, bt = compile_py(expr.args[2], ctx)
            t = at if at == bt else promote(at, bt)
            return (lambda env: a(env) if c(env) else b(env)), t
        if name == "coalesce":
            fns = [compile_py(a, ctx) for a in expr.args]
            return _first_present(fns), fns[0][1]
        if name in ("convert", "cast"):
            f, _ft = compile_py(expr.args[0], ctx)
            if not isinstance(expr.args[1], ast.Constant):
                raise ExprError("convert target must be literal")
            t = _CONVERT[str(expr.args[1].value).lower()]
            caster = _CASTERS[t]
            return (lambda env: caster(f(env))), t
        if name == "createset":
            f, _ft = compile_py(expr.args[0], ctx)

            def cs(env):
                v = f(env)
                return set() if v is None else {v}
            return cs, AttrType.OBJECT
        if name == "sizeofset":
            f, _ft = compile_py(expr.args[0], ctx)
            return (lambda env: len(f(env) or ())), AttrType.INT
        if name == "uuid":
            return (lambda env: str(uuid.uuid4())), AttrType.STRING
        if name == "currenttimemillis":
            return (lambda env: int(time.time() * 1000)), AttrType.LONG
        if name == "eventtimestamp":
            return (lambda env: env.get("__timestamp__")), AttrType.LONG
        if name.startswith("instanceof"):
            kind = name[len("instanceof"):]
            _f, ft = compile_py(expr.args[0], ctx)
            expected = {"integer": AttrType.INT, "long": AttrType.LONG,
                        "float": AttrType.FLOAT, "double": AttrType.DOUBLE,
                        "boolean": AttrType.BOOL,
                        "string": AttrType.STRING}.get(kind)
            ok = ft == expected
            return (lambda env: ok), AttrType.BOOL
        if name in ("maximum", "minimum"):
            fns = [compile_py(a, ctx) for a in expr.args]
            pick = max if name == "maximum" else min
            return (lambda env: pick(v for v in (f(env) for f, _ in fns)
                                     if v is not None)), _promoted(fns)
        if name == "default":
            f, ft = compile_py(expr.args[0], ctx)
            d, _ = compile_py(expr.args[1], ctx)
            return (lambda env: f(env) if f(env) is not None else d(env)), ft
    builder = PY_FUNCTIONS.get((ns, name))
    if builder is None:
        raise ExprError(f"unknown function {(ns + ':') if ns else ''}"
                        f"{name}()")
    return builder([compile_py(a, ctx) for a in expr.args])


def _to_str(v):
    return None if v is None else str(v)


def _to_int(v):
    if v is None:
        return None
    try:
        return int(float(v)) if isinstance(v, str) else int(v)
    except ValueError:
        return None


def _to_float(v):
    if v is None:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def _to_bool(v):
    if v is None:
        return None
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


_CASTERS = {AttrType.STRING: _to_str, AttrType.INT: _to_int,
            AttrType.LONG: _to_int, AttrType.FLOAT: _to_float,
            AttrType.DOUBLE: _to_float, AttrType.BOOL: _to_bool}


# -- built-in host function library (str:*, math:*) --------------------------

def _guarded(pyf, out: Optional[AttrType]):
    """A builder over `pyf` that yields None when an argument is None;
    `out` None: the first argument's type (DOUBLE without arguments)."""
    def build(args):
        fns = [f for f, _ in args]
        ot = out or (args[0][1] if args else AttrType.DOUBLE)

        def fn(env):
            vals = [f(env) for f in fns]
            if any(v is None for v in vals):
                return None
            return pyf(*vals)
        return fn, ot
    return build


for _name, _f, _t in [
        ("concat", lambda *a: "".join(str(x) for x in a), AttrType.STRING),
        ("length", len, AttrType.INT), ("upper", str.upper, AttrType.STRING),
        ("lower", str.lower, AttrType.STRING),
        ("contains", lambda a, b: b in a, AttrType.BOOL),
        ("startsWith", str.startswith, AttrType.BOOL),
        ("endsWith", str.endswith, AttrType.BOOL),
        ("trim", str.strip, AttrType.STRING),
        ("replaceAll", lambda s, a, b: s.replace(a, b), AttrType.STRING),
        ("substr", lambda s, a, b=None: s[int(a):] if b is None
         else s[int(a):int(a) + int(b)], AttrType.STRING)]:
    register_py_function(_name, _guarded(_f, _t), "str")

for _name, _f, _t in [
        ("abs", abs, None), ("sqrt", math.sqrt, AttrType.DOUBLE),
        ("log", math.log, AttrType.DOUBLE), ("exp", math.exp, AttrType.DOUBLE),
        ("floor", math.floor, AttrType.DOUBLE),
        ("ceil", math.ceil, AttrType.DOUBLE),
        ("sin", math.sin, AttrType.DOUBLE), ("cos", math.cos, AttrType.DOUBLE),
        ("round", round, None), ("power", pow, None)]:
    register_py_function(_name, _guarded(_f, _t), "math")
