"""On-demand (store) queries: `rt.query("from A within ... per ... select ...")`.

Port of the aggregation branch of `siddhi_tpu/core/store.py`
(`StoreQueryExec`, :23-43 and :114): a store query on an incremental
aggregation compiles into an `AggStoreExec` (core/aggregation.py:
`within`/`per` bucket selection), re-executed against its live state.  Store queries on tables and named windows, and update/delete
actions, raise PlanError: tables and named windows are a later slice of
the port.
"""
from __future__ import annotations

from ..query import ast
from .aggregation import AggStoreExec
from .planner import PlanError


def compile_store_query(rt, sq: ast.StoreQuery) -> AggStoreExec:
    """One compiled store query, re-executable against live state
    (`.execute()` gives the decoded rows [(timestamp, tuple)],
    `.out_schema` their schema)."""
    sid = sq.input.stream_id
    agg = rt.aggregations.get(sid)
    if agg is None:
        raise PlanError(f"store query on {sid!r}: only incremental "
                        f"aggregations are queryable in the port; tables "
                        f"and named windows are a later slice of the port")
    if sq.action is not None and not isinstance(sq.action, ast.ReturnAction):
        raise PlanError(f"store query on {sid!r}: update/delete/insert "
                        f"actions need tables, a later slice of the port")
    return AggStoreExec(agg, sq)
