"""Expression compiler: AST expression trees -> one typed tree, two back ends.

Port of `siddhi_tpu/core/expr.py` (`compile_expression`).  The JAX package
closes each expression over jnp calls; here the compiler builds a small
typed tree (`Node`) once, and two back ends read it:

  (a) `CompiledExpr.fn(env)` evaluates the tree with torch ops over a dict
      of column tensors -- the plain version, also used by the plain NFA
      block for capture-dependent conjuncts;
  (b) `emit_program(...)` lowers the tree to a postfix program for the
      predicate VM (`csrc/expr_vm.cuh`): int32 words (opcode word, operand
      word) plus a constant pool of 64-bit raw values.  The CUDA kernels
      K1 (`kernels/expr_eval.py`), K2 (`kernels/nfa_block.py`) and K4
      (`kernels/scan_chase.py`) run it.

A fused multi-query plan lifts each query's constants into variables
`__qparam<i>` (core/multi_query.py).  Both back ends read them per lane:
the VM through the `qparam` operand (params[i, lane] of a `LaneParams`
table, each kernel stating which lane a row belongs to), the torch back
end through (P,) vectors in its env.

Type rules follow Java numeric promotion (widest of INT < LONG < FLOAT <
DOUBLE wins), integer `/` and `%` truncate toward zero (XLA semantics for
the corner cases: x / 0 = -1, x % 0 = x, MIN / -1 = MIN), float -> int
casts saturate with NaN -> 0, and strings compare as dictionary codes.
Inside `compute_dtypes(F32_MODE)` DOUBLE computes in float32, as the JAX
package's device pattern paths do.  Anything the VM cannot express raises
ExprError (the planners turn it into PlanError) when the query is planned.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..query import ast
from ..query.ast import AttrType, CompareOp, MathOp


class ExprError(Exception):
    pass


# ---------------------------------------------------------------------------
# variable resolution (copied from the JAX package)
# ---------------------------------------------------------------------------

class ExprContext:
    def resolve(self, var: ast.Variable) -> tuple[str, AttrType]:
        raise NotImplementedError

    def resolve_string_constant(self, s: str) -> int:
        raise NotImplementedError


class SingleStreamContext(ExprContext):
    """Variables resolve against a single stream schema (+ optional alias)."""

    def __init__(self, schema, strings, alias: Optional[str] = None,
                 extra: Optional[dict] = None):
        self.schema = schema
        self.strings = strings
        self.alias = alias or schema.id
        self.extra = extra or {}

    def resolve(self, var: ast.Variable) -> tuple[str, AttrType]:
        if var.stream_ref is not None and var.stream_ref not in (
                self.alias, self.schema.id):
            raise ExprError(
                f"unknown stream reference {var.stream_ref!r} (stream is "
                f"{self.schema.id!r} / alias {self.alias!r})")
        if var.attribute in self.extra and var.stream_ref is None:
            return self.extra[var.attribute]
        return var.attribute, self.schema.type_of(var.attribute)

    def resolve_string_constant(self, s: str) -> int:
        return self.strings.encode(s)


class MultiStreamContext(ExprContext):
    """Variables resolve against several named schemas (patterns): env keys
    are "<ref>.<attr>", indexed refs "<ref>[<idx>].<attr>"."""

    def __init__(self, schemas: dict, strings, extra: Optional[dict] = None):
        self.schemas = schemas
        self.strings = strings
        self.extra = extra or {}

    def resolve(self, var: ast.Variable) -> tuple[str, AttrType]:
        if var.stream_ref is None:
            if var.attribute in self.extra:
                return self.extra[var.attribute]
            hits = [(ref, s) for ref, s in self.schemas.items()
                    if var.attribute in s.types]
            if not hits:
                raise ExprError(f"unknown attribute {var.attribute!r}")
            if len(hits) > 1:
                raise ExprError(
                    f"ambiguous attribute {var.attribute!r} (in "
                    f"{[r for r, _ in hits]}); qualify with stream ref")
            ref, schema = hits[0]
            return f"{ref}.{var.attribute}", schema.type_of(var.attribute)
        ref = var.stream_ref
        if ref not in self.schemas:
            raise ExprError(f"unknown stream reference {ref!r}; "
                            f"have {list(self.schemas)}")
        schema = self.schemas[ref]
        if var.index is not None:
            return (f"{ref}[{var.index}].{var.attribute}",
                    schema.type_of(var.attribute))
        return f"{ref}.{var.attribute}", schema.type_of(var.attribute)

    def resolve_string_constant(self, s: str) -> int:
        return self.strings.encode(s)


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

_NUM_RANK = {AttrType.INT: 0, AttrType.LONG: 1, AttrType.FLOAT: 2,
             AttrType.DOUBLE: 3}
_RANK_NUM = {v: k for k, v in _NUM_RANK.items()}


def promote(a: AttrType, b: AttrType) -> AttrType:
    if a not in _NUM_RANK or b not in _NUM_RANK:
        raise ExprError(f"cannot apply arithmetic to {a}/{b}")
    return _RANK_NUM[max(_NUM_RANK[a], _NUM_RANK[b])]


# VM value types (the `vt` field of an instruction word)
VT_BOOL, VT_I32, VT_I64, VT_F32, VT_F64 = range(5)
TORCH_OF_VT = {VT_BOOL: torch.bool, VT_I32: torch.int32, VT_I64: torch.int64,
               VT_F32: torch.float32, VT_F64: torch.float64}
VT_OF_TORCH = {v: k for k, v in TORCH_OF_VT.items()}
VT_OF_TORCH[torch.uint8] = VT_BOOL
_TORCH_OF = {AttrType.INT: torch.int32, AttrType.LONG: torch.int64,
             AttrType.FLOAT: torch.float32, AttrType.DOUBLE: torch.float64,
             AttrType.BOOL: torch.bool, AttrType.STRING: torch.int32}

_DTYPE_OVERRIDES: contextvars.ContextVar = contextvars.ContextVar(
    "siddhi_torch_dtype_overrides", default=None)


@contextmanager
def compute_dtypes(overrides: Optional[dict]):
    """Override AttrType -> torch dtype while evaluating or emitting."""
    tok = _DTYPE_OVERRIDES.set(overrides)
    try:
        yield
    finally:
        _DTYPE_OVERRIDES.reset(tok)


F32_MODE = {AttrType.DOUBLE: torch.float32}


def torch_dtype(t: AttrType) -> torch.dtype:
    o = _DTYPE_OVERRIDES.get()
    if o is not None and t in o:
        return o[t]
    return _TORCH_OF[t]


def vt_of(t: AttrType) -> int:
    return VT_OF_TORCH[torch_dtype(t)]


# ---------------------------------------------------------------------------
# the typed tree
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Node:
    """op: var | const | param | cast | add sub mul div mod |
    lt le gt ge eq ne | and or not | select | min max | abs sqrt floor ceil.
    `type` is the AttrType; casts and constants take their device dtype
    from it at evaluation (so compute_dtypes applies)."""
    op: str
    type: AttrType
    args: tuple = ()
    key: Optional[str] = None       # var: env key; param: launch-time name
    value: object = None            # const


@dataclass
class CompiledExpr:
    node: Node
    type: AttrType
    reads: frozenset
    is_var: bool = False

    def fn(self, env: dict) -> torch.Tensor:
        """Plain torch back end: evaluate over env (key -> tensor)."""
        return eval_node(self.node, env)


def _cast(n: Node, t: AttrType) -> Node:
    return Node("cast", t, (n,))


def _ce(node: Node, reads, is_var=False) -> CompiledExpr:
    return CompiledExpr(node, node.type, frozenset(reads), is_var)


def compile_expression(expr: ast.Expression, ctx: ExprContext) -> CompiledExpr:
    if isinstance(expr, ast.Constant):
        if expr.type == AttrType.STRING:
            code = ctx.resolve_string_constant(expr.value)
            return _ce(Node("const", AttrType.STRING, value=code), ())
        if expr.type not in _TORCH_OF:
            raise ExprError(f"constant of type {expr.type} on the device")
        return _ce(Node("const", expr.type, value=expr.value), ())
    if isinstance(expr, ast.TimeConstant):
        return _ce(Node("const", AttrType.LONG, value=expr.millis), ())
    if isinstance(expr, ast.Variable):
        key, t = ctx.resolve(expr)
        if t not in _TORCH_OF:
            raise ExprError(f"variable {key!r} of type {t} on the device")
        return _ce(Node("var", t, key=key), [key], is_var=True)
    if isinstance(expr, ast.Compare):
        return _compile_compare(expr, ctx)
    if isinstance(expr, (ast.And, ast.Or)):
        l = compile_expression(expr.left, ctx)
        r = compile_expression(expr.right, ctx)
        _want_bool(l, r)
        op = "and" if isinstance(expr, ast.And) else "or"
        return _ce(Node(op, AttrType.BOOL, (l.node, r.node)),
                   l.reads | r.reads)
    if isinstance(expr, ast.Not):
        e = compile_expression(expr.expr, ctx)
        _want_bool(e)
        return _ce(Node("not", AttrType.BOOL, (e.node,)), e.reads)
    if isinstance(expr, ast.Math):
        return _compile_math(expr, ctx)
    if isinstance(expr, ast.FunctionCall):
        return _compile_function(expr, ctx)
    if isinstance(expr, ast.IsNull):
        return _compile_is_null(expr, ctx)
    if isinstance(expr, ast.In):
        raise ExprError("'in Table' needs tables, which are a later slice")
    raise ExprError(f"cannot compile expression node {type(expr).__name__}")


def _want_bool(*exprs: CompiledExpr):
    for e in exprs:
        if e.type != AttrType.BOOL:
            raise ExprError(f"expected bool operand, got {e.type}")


_CMP = {CompareOp.LT: "lt", CompareOp.LE: "le", CompareOp.GT: "gt",
        CompareOp.GE: "ge", CompareOp.EQ: "eq", CompareOp.NEQ: "ne"}


def _compile_compare(expr: ast.Compare, ctx) -> CompiledExpr:
    l = compile_expression(expr.left, ctx)
    r = compile_expression(expr.right, ctx)
    ln, rn = l.node, r.node
    if AttrType.STRING in (l.type, r.type):
        if l.type != r.type:
            raise ExprError(f"cannot compare {l.type} with {r.type}")
        if expr.op not in (CompareOp.EQ, CompareOp.NEQ):
            raise ExprError("strings support only ==/!= on device")
    elif AttrType.BOOL in (l.type, r.type):
        if l.type != r.type or expr.op not in (CompareOp.EQ, CompareOp.NEQ):
            raise ExprError(f"bad bool comparison {l.type} {expr.op} {r.type}")
    else:
        t = promote(l.type, r.type)
        ln, rn = _cast(ln, t), _cast(rn, t)
    return _ce(Node(_CMP[expr.op], AttrType.BOOL, (ln, rn)), l.reads | r.reads)


_MATH = {MathOp.ADD: "add", MathOp.SUB: "sub", MathOp.MUL: "mul",
         MathOp.DIV: "div", MathOp.MOD: "mod"}


def _compile_math(expr: ast.Math, ctx) -> CompiledExpr:
    l = compile_expression(expr.left, ctx)
    r = compile_expression(expr.right, ctx)
    t = promote(l.type, r.type)
    if expr.op not in _MATH:
        raise ExprError(f"unknown math op {expr.op}")
    return _ce(Node(_MATH[expr.op], t, (_cast(l.node, t), _cast(r.node, t))),
               l.reads | r.reads)


_CONVERT_TYPES = {"string": AttrType.STRING, "int": AttrType.INT,
                  "long": AttrType.LONG, "float": AttrType.FLOAT,
                  "double": AttrType.DOUBLE, "bool": AttrType.BOOL}
_FLOATS = (AttrType.FLOAT, AttrType.DOUBLE)


def _reads(args) -> frozenset:
    return frozenset().union(*[a.reads for a in args])


def _compile_function(expr: ast.FunctionCall, ctx) -> CompiledExpr:
    name = expr.name.lower()
    ns = expr.namespace.lower() if expr.namespace else None
    if ns is None and name in ("convert", "cast"):
        src = compile_expression(expr.args[0], ctx)
        if not isinstance(expr.args[1], ast.Constant):
            raise ExprError(f"{name} target type must be a literal")
        target = _CONVERT_TYPES[str(expr.args[1].value).lower()]
        if target == AttrType.STRING or src.type == AttrType.STRING:
            if src.type == target:
                return src
            raise ExprError("string<->numeric conversion is a host-side op")
        return _ce(_cast(src.node, target), src.reads)
    if ns is None and name == "eventtimestamp":
        return _ce(Node("var", AttrType.LONG, key="__timestamp__"),
                   ["__timestamp__"])
    if ns is None and name.startswith("instanceof"):
        kind = name[len("instanceof"):]
        src = compile_expression(expr.args[0], ctx)
        expected = {"integer": AttrType.INT, "long": AttrType.LONG,
                    "float": AttrType.FLOAT, "double": AttrType.DOUBLE,
                    "boolean": AttrType.BOOL, "string": AttrType.STRING}.get(kind)
        return _ce(Node("const", AttrType.BOOL, value=src.type == expected),
                   src.reads)
    args = [compile_expression(a, ctx) for a in expr.args]
    if ns is None and name == "ifthenelse":
        c, a, b = args
        if c.type != AttrType.BOOL:
            raise ExprError("ifThenElse condition must be bool")
        t = a.type if a.type == b.type else promote(a.type, b.type)
        return _ce(Node("select", t, (c.node, _cast(a.node, t),
                                      _cast(b.node, t))), _reads(args))
    if ns is None and name == "coalesce":
        if args[0].type != AttrType.STRING:
            return args[0]          # numeric device columns are never null
        out = args[0].node
        for a in args[1:]:
            zero = Node("const", AttrType.STRING, value=0)
            out = Node("select", AttrType.STRING,
                       (Node("ne", AttrType.BOOL, (out, zero)), out, a.node))
        return _ce(out, _reads(args))
    if ns is None and name in ("maximum", "minimum"):
        t = args[0].type
        for a in args[1:]:
            t = promote(t, a.type)
        out = _cast(args[0].node, t)
        for a in args[1:]:
            out = Node("max" if name == "maximum" else "min", t,
                       (out, _cast(a.node, t)))
        return _ce(out, _reads(args))
    if ns == "math" and name == "abs":
        a = args[0]
        t = AttrType.DOUBLE if a.type in _FLOATS else a.type
        return _ce(_cast(Node("abs", a.type, (a.node,)), t), a.reads)
    if ns == "math" and name in ("sqrt", "floor", "ceil"):
        a = args[0]
        if a.type not in _FLOATS:
            raise ExprError(f"math:{name} over {a.type} is not in the "
                            f"device VM (float input only)")
        return _ce(_cast(Node(name, a.type, (a.node,)), AttrType.DOUBLE),
                   a.reads)
    raise ExprError(f"function {ns + ':' if ns else ''}{name}() is not in "
                    f"the device VM of this port")


def _compile_is_null(expr: ast.IsNull, ctx) -> CompiledExpr:
    v = expr.expr
    if isinstance(v, ast.Variable) and v.stream_ref is None \
            and v.index is None and v.attribute in getattr(ctx, "schemas",
                                                           {}):
        # `e1 is null` parses as a bare variable: where `e1` is no
        # attribute but a pattern ref, it tests the ref's presence
        try:
            ctx.resolve(v)
        except ExprError:
            expr = ast.IsNull(stream_ref=v.attribute)
    if expr.expr is not None:
        e = compile_expression(expr.expr, ctx)
        if e.type == AttrType.STRING:
            zero = Node("const", AttrType.STRING, value=0)
            return _ce(Node("eq", AttrType.BOOL, (e.node, zero)), e.reads)
        return _ce(Node("const", AttrType.BOOL, value=False), e.reads)
    # `e1 is null` / `e1[i] is null`: the pattern's presence row of the
    # ref (or of the index), which the NFA keeps among its capture rows
    key = f"__present__.{expr.stream_ref}" if expr.index is None \
        else f"__present__.{expr.stream_ref}[{expr.index}]"
    var = Node("var", AttrType.BOOL, key=key)
    return _ce(Node("not", AttrType.BOOL, (var,)), [key])


# ---------------------------------------------------------------------------
# shared torch semantics (the plain back end and the VM interpreter)
# ---------------------------------------------------------------------------

def int_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncating integer division, XLA corner cases (x/0 = -1,
    MIN/-1 = MIN) without torch's divide-by-zero error."""
    zero = b == 0
    neg1 = b == -1
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(neg1, -a, q)            # two's-complement: -MIN == MIN
    return torch.where(zero, torch.full_like(q, -1), q)


def int_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncated remainder (Java %), x % 0 = x, MIN % -1 = 0."""
    zero = b == 0
    neg1 = b == -1
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    r = torch.fmod(a, safe)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def cast_to(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """astype with saturating float -> int (NaN -> 0), as XLA and CUDA's
    cvt.rzi do."""
    if x.dtype == dt:
        return x
    if dt in (torch.int32, torch.int64) and x.dtype.is_floating_point:
        info = torch.iinfo(dt)
        xd = x.to(torch.float64)
        hi = xd >= float(info.max)
        lo = xd <= float(info.min)
        bad = hi | lo | torch.isnan(xd)
        out = torch.where(bad, torch.zeros_like(xd), xd).to(dt)
        out = torch.where(hi, torch.full_like(out, info.max), out)
        return torch.where(lo, torch.full_like(out, info.min), out)
    return x.to(dt)


def apply_op(op: str, args: list) -> torch.Tensor:
    """One tree/VM operation on tensors (operands already cast)."""
    if op == "add":
        return args[0] + args[1]
    if op == "sub":
        return args[0] - args[1]
    if op == "mul":
        return args[0] * args[1]
    if op in ("div", "mod"):
        a, b = args
        if a.dtype.is_floating_point:
            return a / b if op == "div" else torch.fmod(a, b)
        return int_div(a, b) if op == "div" else int_mod(a, b)
    if op == "lt":
        return args[0] < args[1]
    if op == "le":
        return args[0] <= args[1]
    if op == "gt":
        return args[0] > args[1]
    if op == "ge":
        return args[0] >= args[1]
    if op == "eq":
        return args[0] == args[1]
    if op == "ne":
        return args[0] != args[1]
    if op == "and":
        return args[0] & args[1]
    if op == "or":
        return args[0] | args[1]
    if op == "not":
        return ~args[0]
    if op == "select":
        return torch.where(args[0], args[1], args[2])
    if op == "min":
        return torch.minimum(args[0], args[1])
    if op == "max":
        return torch.maximum(args[0], args[1])
    if op == "abs":
        return torch.abs(args[0])
    if op == "sqrt":
        return torch.sqrt(args[0])
    if op == "floor":
        return torch.floor(args[0])
    if op == "ceil":
        return torch.ceil(args[0])
    raise ExprError(f"unknown op {op!r}")


def const_tensor(value, dt: torch.dtype, device=None) -> torch.Tensor:
    return torch.tensor(value, dtype=dt, device=device)


def eval_node(node: Node, env: dict) -> torch.Tensor:
    if node.op in ("var", "param"):
        return env[node.key]
    if node.op == "const":
        dev = next((v.device for v in env.values()
                    if isinstance(v, torch.Tensor)), None)
        return const_tensor(node.value, torch_dtype(node.type), dev)
    if node.op == "cast":
        return cast_to(eval_node(node.args[0], env), torch_dtype(node.type))
    return apply_op(node.op, [eval_node(a, env) for a in node.args])


# ---------------------------------------------------------------------------
# VM lowering (back end b)
# ---------------------------------------------------------------------------

OPCODES = {"load": 1, "const": 2, "cast": 3, "add": 4, "sub": 5, "mul": 6,
           "div": 7, "mod": 8, "lt": 9, "le": 10, "gt": 11, "ge": 12,
           "eq": 13, "ne": 14, "and": 15, "or": 16, "not": 17, "select": 18,
           "min": 19, "max": 20, "abs": 21, "sqrt": 22, "floor": 23,
           "ceil": 24, "qparam": 25}
QPARAM = "__qparam"                 # lifted per-lane constants: __qparam<i>
OPNAMES = {v: k for k, v in OPCODES.items()}
VM_STACK = 16                       # csrc/expr_vm.cuh VM_STACK


def encode_word(op: str, vt: int, vt2: int = 0) -> int:
    return OPCODES[op] | (vt << 8) | (vt2 << 12)


def decode_word(w: int) -> tuple:
    return OPNAMES[w & 0xFF], (w >> 8) & 0xF, (w >> 12) & 0xF


def const_bits(value, vt: int) -> int:
    """Raw 64-bit pool entry for a constant of value type vt."""
    if vt == VT_F64:
        return int(np.float64(value).view(np.int64))
    if vt == VT_F32:
        return int(np.float32(value).view(np.int32))
    return int(value)


def bits_const(bits: int, vt: int):
    if vt == VT_F64:
        return float(np.int64(bits).view(np.float64))
    if vt == VT_F32:
        return float(np.int32(bits).view(np.float32))
    if vt == VT_BOOL:
        return bool(bits)
    return int(bits)


@dataclass
class Program:
    """Postfix VM program: `words` (opcode, operand) int32 pairs, `consts`
    pool entries (an int of raw bits, or a str naming a launch-time
    parameter resolved by `resolve_consts`), `vt` of the result, `depth`
    the deepest stack it reaches, `stack_slots` the stack slot each
    instruction writes (a push: the new top; an operation: its first
    operand's).  `decoded` holds K1's instruction records of the program,
    made by its first launch on the card (kernels/expr_eval.py
    `decoded`)."""
    words: list
    consts: list
    vt: int
    depth: int
    stack_slots: list
    decoded: object = field(default=None, repr=False, compare=False)

    def resolve_consts(self, params: Optional[dict] = None) -> list:
        out = []
        for c in self.consts:
            if isinstance(c, str):
                name, vt = c.split(":")
                out.append(const_bits(params[name], int(vt)))
            else:
                out.append(c)
        return out


def subst(node: Node, mapping: dict) -> Node:
    """Replace `var` nodes whose key is in mapping (no recursion into the
    replacements): derived keys (`__timestamp__`) and `having` over
    selector outputs become plain trees before evaluation or lowering."""
    if node.op == "var" and node.key in mapping:
        return mapping[node.key]
    if not node.args:
        return node
    return Node(node.op, node.type,
                tuple(subst(a, mapping) for a in node.args),
                node.key, node.value)


def emit_program(node: Node, slots: dict) -> Program:
    """Lower a tree to a VM program.  `slots` maps each env key the tree
    reads to (slot index, vt) of a device column.  Raises ExprError for a
    key without a column or a tree deeper than the VM stack."""
    words: list = []
    consts: list = []
    stack_slots: list = []
    depth = [0, 0]

    def push(word: int, arg: int) -> None:
        words.extend([word, arg])
        stack_slots.append(depth[0])
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])

    def add_const(entry, vt: int) -> int:
        if entry not in consts:
            consts.append(entry)
        push(encode_word("const", vt), consts.index(entry))
        return vt

    def rec(n: Node) -> int:
        if n.op == "param":
            return add_const(f"{n.key}:{vt_of(n.type)}", vt_of(n.type))
        if n.op == "var" and n.key.startswith(QPARAM) and n.key not in slots:
            vt = vt_of(n.type)
            push(encode_word("qparam", vt), int(n.key[len(QPARAM):]))
            return vt
        if n.op == "var":
            if n.key not in slots:
                raise ExprError(f"VM: no device column for {n.key!r}")
            slot, vt = slots[n.key]
            push(encode_word("load", vt), slot)
            return vt
        if n.op == "const":
            vt = vt_of(n.type)
            return add_const(const_bits(n.value, vt), vt)
        if n.op == "cast":
            src = rec(n.args[0])
            vt = vt_of(n.type)
            if vt != src:
                words.extend([encode_word("cast", vt, src), 0])
                stack_slots.append(depth[0] - 1)
            return vt
        vts = [rec(a) for a in n.args]
        if n.op in ("and", "or", "not"):
            vt = VT_BOOL
        elif n.op in ("lt", "le", "gt", "ge", "eq", "ne"):
            if vts[0] != vts[1]:
                raise ExprError(f"VM: compare of mixed types {vts}")
            vt = VT_BOOL
        elif n.op == "select":
            if vts[1] != vts[2]:
                raise ExprError(f"VM: select of mixed types {vts}")
            vt = vts[1]
        else:
            if len(vts) == 2 and vts[0] != vts[1]:
                raise ExprError(f"VM: {n.op} of mixed types {vts}")
            vt = vts[0]
        operand_vt = vts[0] if n.op in ("lt", "le", "gt", "ge", "eq",
                                        "ne") else vt
        words.extend([encode_word(n.op, operand_vt), 0])
        depth[0] -= len(vts) - 1
        stack_slots.append(depth[0] - 1)
        return vt

    vt = rec(node)
    if depth[1] > VM_STACK:
        raise ExprError(f"expression needs a VM stack of {depth[1]} "
                        f"(> {VM_STACK})")
    return Program(words, consts, vt, depth[1], stack_slots)


def qparam_bits(values: np.ndarray) -> np.ndarray:
    """(P,) parameter values -> their raw 64-bit VM words (the pool
    encoding of `const_bits`, by the array's dtype)."""
    a = np.asarray(values)
    if a.dtype == np.float32:
        return a.view(np.int32).astype(np.int64)
    if a.dtype == np.float64:
        return a.view(np.int64).copy()
    return a.astype(np.int64)


class LaneParams:
    """Per-lane parameter table of a fused multi-query plan: `values[i]`
    the (P,) tensor of `__qparam<i>` (its dtype is the program's), `bits`
    the (n_params, P) int64 raw words the VM's `qparam` operand reads."""

    def __init__(self, params: dict, device):
        names = sorted(params, key=lambda k: int(k[len(QPARAM):]))
        if names != [f"{QPARAM}{i}" for i in range(len(names))]:
            raise ValueError(f"lane parameters must be {QPARAM}0..n-1, got "
                             f"{names}")
        arrs = [np.asarray(params[k]) for k in names]
        self.P = len(arrs[0]) if arrs else 0
        self.values = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrs]
        bits = np.stack([qparam_bits(a) for a in arrs]) if arrs else \
            np.zeros((0, 0), np.int64)
        self.bits = torch.from_numpy(bits).to(device)

    def env(self) -> dict:
        """The torch back end's view: name -> (P,) tensor."""
        return {f"{QPARAM}{i}": v for i, v in enumerate(self.values)}


def timestamp_node(offset_key: str) -> Node:
    """`__timestamp__` on the device paths: i32 offset column + the plan's
    int64 base (a launch-time parameter)."""
    return Node("add", AttrType.LONG,
                (Node("param", AttrType.LONG, key="__base_ts__"),
                 _cast(Node("var", AttrType.INT, key=offset_key),
                       AttrType.LONG)))
