"""Lowering of a pattern's StateElement tree into linked nodes.

Port of the part of `siddhi_tpu/interp/nfa.py` that the device chain
lowering needs (`NFACompiler`, imported at siddhi_tpu/core/nfa_device.py:218)
plus `_collect_filters` (siddhi_tpu/interp/engine.py).  The sequential host
matcher itself is not ported: every pattern runs on the device NFA.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

from ..query import ast
from ..core.planner import PlanError

FINAL = None


@dataclass
class Node:
    id: int
    stream_id: str
    ref: str
    filter_fn: Optional[Callable]          # env -> bool
    kind: str = "stream"                   # "stream" | "absent"
    min_count: int = 1
    max_count: int = 1
    within_ms: Optional[int] = None        # expiry for PMs pending here
    waiting_ms: Optional[int] = None       # absent: `for T`
    next_id: Optional[int] = FINAL
    sticky: bool = False                   # `every`-armed entry
    partner_id: Optional[int] = None       # logical pair
    partner_op: Optional[str] = None       # "and" | "or"
    is_entry: bool = False


class NFACompiler:
    def __init__(self):
        self.nodes: list[Node] = []
        self._anon = itertools.count()

    def _new_node(self, stream: ast.SingleInputStream, kind: str = "stream",
                  waiting_ms=None) -> Node:
        ref = stream.ref_id or f"_s{next(self._anon)}"
        n = Node(id=len(self.nodes), stream_id=stream.stream_id, ref=ref,
                 filter_fn=None, kind=kind, waiting_ms=waiting_ms)
        self.nodes.append(n)
        return n

    def lower(self, elem: ast.StateElement, within: Optional[int] = None
              ) -> tuple[list[Node], list[Node]]:
        """Returns (entry_nodes, exit_nodes)."""
        if isinstance(elem, ast.StreamStateElement):
            n = self._new_node(elem.stream)
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.AbsentStreamStateElement):
            n = self._new_node(elem.stream, kind="absent",
                               waiting_ms=elem.waiting_time.millis
                               if elem.waiting_time else None)
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.CountStateElement):
            n = self._new_node(elem.stream.stream)
            n.min_count = elem.min_count
            n.max_count = elem.max_count if elem.max_count != ast.CountStateElement.ANY \
                else 10**9
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.LogicalStateElement):
            ln = self._lower_logical_side(elem.left)
            rn = self._lower_logical_side(elem.right)
            ln.partner_id, rn.partner_id = rn.id, ln.id
            ln.partner_op = rn.partner_op = elem.op
            w = _min_ms(within, elem.within)
            ln.within_ms = rn.within_ms = w
            return [ln, rn], [ln, rn]
        if isinstance(elem, ast.NextStateElement):
            e1, x1 = self.lower(elem.state, within)
            e2, x2 = self.lower(elem.next, within)
            for x in x1:
                x.next_id = e2[0].id   # logical pairs register both (see advance)
            return e1, x2
        if isinstance(elem, ast.EveryStateElement):
            w = _min_ms(within, elem.within)
            e, x = self.lower(elem.state, w)
            for n in e:
                n.sticky = True
            return e, x
        raise PlanError(f"cannot lower state element {type(elem).__name__}")

    def _lower_logical_side(self, side: ast.StateElement) -> Node:
        if isinstance(side, ast.StreamStateElement):
            return self._new_node(side.stream)
        if isinstance(side, ast.AbsentStreamStateElement):
            return self._new_node(side.stream, kind="absent",
                                  waiting_ms=side.waiting_time.millis
                                  if side.waiting_time else None)
        raise PlanError("logical and/or sides must be simple stream states")


def _min_ms(a: Optional[int], b) -> Optional[int]:
    bm = b.millis if isinstance(b, ast.TimeConstant) else b
    if a is None:
        return bm
    if bm is None:
        return a
    return min(a, bm)


def collect_filters(elem) -> list:
    """Filters per lowered node, in the same order NFACompiler.lower
    creates nodes (depends on tree shape)."""
    out: list = []

    def walk(e):
        if isinstance(e, ast.StreamStateElement):
            out.append(e.stream.filters)
        elif isinstance(e, ast.AbsentStreamStateElement):
            out.append(e.stream.filters)
        elif isinstance(e, ast.CountStateElement):
            out.append(e.stream.stream.filters)
        elif isinstance(e, ast.LogicalStateElement):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.NextStateElement):
            walk(e.state)
            walk(e.next)
        elif isinstance(e, ast.EveryStateElement):
            walk(e.state)
        else:
            raise PlanError(f"unknown state element {type(e).__name__}")

    walk(elem)
    return out
