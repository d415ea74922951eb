"""Query planner: AST Query -> executable plan over columnar batches.

Port of `siddhi_tpu/core/planner.py`: `QueryPlan`, `OutputBatch`,
`PlanError`, `compile_selector`, `output_target_of`, and the stateless
`FilterProjectPlan`, whose jitted step (planner.py:306-333) becomes one
launch of K1 (`kernels/expr_eval.py`): the filter & having mask travels
bit-packed, computed selector columns come back as tensors, and
pass-through columns never leave the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..query import ast
from ..query.ast import AttrType
from .batch import EventBatch
from .expr import (VT_OF_TORCH, CompiledExpr, ExprError, Node,
                   SingleStreamContext, compile_expression, emit_program,
                   subst)
from .schema import StreamSchema, StringTable, dtype_of

AGGREGATOR_NAMES = {
    "sum", "avg", "count", "min", "max", "minforever", "maxforever",
    "stddev", "distinctcount", "and", "or", "unionset",
}


class PlanError(Exception):
    pass


class DeviceFilterUnsupported(PlanError):
    """A filter or projection the device VM (K1) cannot compile; raised at
    plan time only, so `core/build.py` can place the query on the host
    interpreter instead."""


def selector_has_aggregators(selector: ast.Selector) -> bool:
    def walk(e) -> bool:
        if isinstance(e, ast.FunctionCall):
            if e.namespace is None and e.name.lower() in AGGREGATOR_NAMES:
                return True
            return any(walk(a) for a in e.args)
        if isinstance(e, (ast.Math, ast.Compare, ast.And, ast.Or)):
            return walk(e.left) or walk(e.right)
        if isinstance(e, ast.Not):
            return walk(e.expr)
        return False
    return any(walk(a.expr) for a in selector.attributes)


@dataclass
class CompiledSelector:
    """Projection part of a selector (no aggregators)."""
    names: list
    types: list
    exprs: list                    # CompiledExpr per output
    having: Optional[CompiledExpr]
    passthrough: list              # env key when the output is a bare variable

    def out_schema(self, stream_id: str) -> StreamSchema:
        return StreamSchema(stream_id, tuple(
            ast.Attribute(n, t) for n, t in zip(self.names, self.types)))

    def having_tree(self) -> Optional[Node]:
        """`having` with output names replaced by what they compute."""
        if self.having is None:
            return None
        return subst(self.having.node, {
            nm: ce.node for nm, ce in zip(self.names, self.exprs)})


def compile_selector(selector: ast.Selector, ctx,
                     in_schema: Optional[StreamSchema]) -> CompiledSelector:
    """Compile projection expressions. select * requires in_schema."""
    names, types, exprs, passthrough = [], [], [], []
    if selector.select_all:
        if in_schema is None:
            raise PlanError("select * not supported for this input type")
        out_attrs = [(a.name, ast.Variable(a.name))
                     for a in in_schema.attributes]
    else:
        out_attrs = [(oa.name, oa.expr) for oa in selector.attributes]
    for nm, expr in out_attrs:
        ce = compile_expression(expr, ctx)
        names.append(nm)
        types.append(ce.type)
        exprs.append(ce)
        passthrough.append(ctx.resolve(expr)[0]
                           if isinstance(expr, ast.Variable) else None)
    having = None
    if selector.having is not None:
        import copy
        hctx = copy.copy(ctx)
        hctx.extra = {**getattr(ctx, "extra", {}),
                      **{n: (n, t) for n, t in zip(names, types)}}
        having = compile_expression(selector.having, hctx)
        if having.type != AttrType.BOOL:
            raise PlanError("having must be boolean")
    return CompiledSelector(names, types, exprs, having, passthrough)


@dataclass
class OutputBatch:
    """A produced batch plus where it should go; `callback_name` names the
    query whose callbacks see it when that is not the plan's name (the
    lanes of a fused multi-query plan); `is_expired` marks a host plan's
    expired events (query callbacks get them as removed events)."""
    target: Optional[str]          # stream id, or None for `return`
    batch: EventBatch
    callback_name: Optional[str] = None
    is_expired: bool = False


class QueryPlan:
    """Base: stateful executable for one query."""

    name: str
    input_streams: tuple
    output_target: Optional[str]
    out_schema: Optional[StreamSchema]

    def process(self, stream_id: str, batch: EventBatch) -> list:
        raise NotImplementedError

    def finalize(self) -> list:
        """Called when a drain round settles; buffering plans flush here."""
        return []

    def next_wakeup(self) -> Optional[int]:
        """Earliest timer (ms) the plan needs, or None."""
        return None

    def on_timer(self, now_ms: int) -> list:
        """Fire the plan's timers due by `now_ms`."""
        return []

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


def tree_reads(node: Node) -> set:
    if node.op == "var":
        return {node.key}
    out: set = set()
    for a in node.args:
        out |= tree_reads(a)
    return out


class FilterProjectPlan(QueryPlan):
    """`from S[p>100] select a, b+1 as c insert into O` -- stateless, one
    K1 launch per batch."""

    def __init__(self, name: str, in_schema: StreamSchema, alias: str,
                 filters: list, selector: ast.Selector,
                 strings: StringTable, output_target: Optional[str],
                 device: torch.device, limit: Optional[int] = None,
                 offset: Optional[int] = None,
                 events_for: ast.OutputEventsFor = ast.OutputEventsFor.CURRENT):
        self.name = name
        self.device = device
        self.emits_nothing = events_for == ast.OutputEventsFor.EXPIRED
        self.in_schema = in_schema
        self.input_streams = (in_schema.id,)
        self.output_target = output_target
        self.limit, self.offset = limit, offset
        ctx = SingleStreamContext(in_schema, strings, alias)
        try:
            filt = None
            if filters:
                f = filters[0]
                for g in filters[1:]:
                    f = ast.And(f, g)
                filt = compile_expression(f, ctx)
                if filt.type != AttrType.BOOL:
                    raise PlanError(f"filter must be boolean in query {name!r}")
            self._sel = compile_selector(selector, ctx, in_schema)
        except ExprError as e:
            raise DeviceFilterUnsupported(f"query {name!r}: {e}") from None
        self.out_schema = self._sel.out_schema(output_target or f"#{name}")
        mask = filt.node if filt is not None else None
        h = self._sel.having_tree()
        if h is not None:
            mask = h if mask is None else Node("and", AttrType.BOOL, (mask, h))
        self._mask_tree = mask
        self._computed = [i for i, pt in enumerate(self._sel.passthrough)
                          if pt is None]
        trees = ([mask] if mask is not None else []) + \
            [self._sel.exprs[i].node for i in self._computed]
        reads = set().union(*[tree_reads(t) for t in trees]) if trees else set()
        self._slot_keys = sorted(reads)
        slots = {k: (i, VT_OF_TORCH[torch.from_numpy(
                     np.zeros(0, dtype=self._host_dtype(k))).dtype])
                 for i, k in enumerate(self._slot_keys)}
        try:
            self._mask_prog = emit_program(mask, slots) \
                if mask is not None else None
            self._out_progs = [emit_program(t, slots) for t in trees[
                1 if mask is not None else 0:]]
        except ExprError as e:
            raise DeviceFilterUnsupported(f"query {name!r}: {e}") from None

    def _host_dtype(self, key: str):
        if key == "__timestamp__":
            return np.int64
        return dtype_of(self.in_schema.type_of(key))

    def process(self, stream_id: str, batch: EventBatch) -> list:
        if batch.n == 0 or self.emits_nothing:
            return []
        from ..kernels.expr_eval import expr_eval, unpack_mask
        host = dict(batch.columns)
        host["__timestamp__"] = batch.timestamps
        if self._mask_prog is None and not self._out_progs:
            mask = np.ones(batch.n, dtype=bool)     # pure pass-through
            outs = []
        else:
            cols = [torch.from_numpy(np.ascontiguousarray(host[k])).to(
                self.device) for k in self._slot_keys]
            if not cols:    # constant programs still need a row count
                cols = [torch.zeros(batch.n, dtype=torch.int32,
                                    device=self.device)]
            words, outs = expr_eval(cols, self._mask_prog, self._out_progs,
                                    batch.n, use="filter")
            mask = np.ones(batch.n, dtype=bool) if words is None else \
                unpack_mask(words.cpu(), batch.n).numpy()
            outs = [o.cpu().numpy() for o in outs]
        if not mask.any():
            return []
        ts = batch.timestamps[mask]
        cols_out = {}
        it = iter(outs)
        for nm, t, pt in zip(self._sel.names, self._sel.types,
                             self._sel.passthrough):
            arr = host[pt] if pt is not None else next(it)
            cols_out[nm] = arr[mask].astype(dtype_of(t))
        if self.offset:
            ts = ts[self.offset:]
            cols_out = {k: v[self.offset:] for k, v in cols_out.items()}
        if self.limit is not None:
            ts = ts[:self.limit]
            cols_out = {k: v[:self.limit] for k, v in cols_out.items()}
        return [OutputBatch(self.output_target,
                            EventBatch(self.out_schema, ts, cols_out, len(ts)))]


def output_target_of(q: ast.Query) -> Optional[str]:
    if isinstance(q.output, ast.InsertInto):
        if q.output.is_fault:
            raise PlanError("fault streams are a later slice")
        return q.output.target
    if isinstance(q.output, ast.ReturnAction):
        return None
    raise PlanError(f"output action {type(q.output).__name__} needs tables, "
                    f"which are a later slice")
