"""The join selector's `select *` expansion.

Port of `_join_selector` (siddhi_tpu/interp/joins.py:416-430), the one
piece of the JAX package's host join that its device join plan reads
(core/join_device.py).  The host join itself is a later slice.
"""
from __future__ import annotations

from ..query import ast


def _join_selector(sel: ast.Selector, plan) -> ast.Selector:
    """Expand `select *` to both sides' attributes (left then right; a
    second use of a name gets the side's ref as a prefix, `b_price`).
    `plan.left` / `plan.right` carry `schema` and `ref`."""
    if not sel.select_all:
        return sel
    attrs = []
    seen = set()
    for side in (plan.left, plan.right):
        for a in side.schema.attributes:
            nm = a.name if a.name not in seen else f"{side.ref}_{a.name}"
            seen.add(nm)
            attrs.append(ast.OutputAttribute(
                ast.Variable(a.name, stream_ref=side.ref), nm))
    return ast.Selector(False, tuple(attrs), sel.group_by, sel.having,
                        sel.order_by, sel.limit, sel.offset)
