"""Partitioned queries: `partition with (expr of Stream, ...) begin ... end`.

Port of `siddhi_tpu/core/partition.py`, both of its strategies, chosen per
inner pattern query:

1. Device axis: a pattern whose input streams all carry value keys (`sym
   of S`, or a computed key such as `v % 4 of S`) lowers to ONE
   DevicePatternPlan whose lanes are the keys (`_columnar_key_fn`).
2. Host clones (`PartitionGroup`): under `@app:devicePatterns('never')`,
   when the device planner refuses the pattern (DeviceNFAUnsupported), or
   when it reads a stream with no value key (range partitions, `v < 10 as
   'lo' or ...`), the query's AST is rewritten per key -- its streams get
   the per-instance synthetic ids `#p<idx>/<inst>/Stream` -- and planned
   like any query (the host matcher) when the key's first event arrives;
   the group splits each arriving batch by key, keeping the original seqs
   (cross-stream order inside an instance), and enqueues the pieces under
   the synthetic ids.  Under 'always' those cases raise instead.

Partitioned non-pattern queries raise PlanError: their clones are filters,
windows and joins over keyed streams, which wait for the host join
(ROADMAP A4) and tables (A6).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np

from ..query import ast
from .batch import EventBatch
from .planner import PlanError, QueryPlan, output_target_of
from .schema import StreamSchema


def _rewrite_state(elem, ren: Callable):
    if isinstance(elem, ast.StreamStateElement):
        return dataclasses.replace(elem, stream=ren(elem.stream))
    if isinstance(elem, ast.AbsentStreamStateElement):
        return dataclasses.replace(elem, stream=ren(elem.stream))
    if isinstance(elem, ast.CountStateElement):
        return dataclasses.replace(elem, stream=_rewrite_state(elem.stream, ren))
    if isinstance(elem, ast.LogicalStateElement):
        return dataclasses.replace(elem, left=_rewrite_state(elem.left, ren),
                                   right=_rewrite_state(elem.right, ren))
    if isinstance(elem, ast.NextStateElement):
        return dataclasses.replace(elem, state=_rewrite_state(elem.state, ren),
                                   next=_rewrite_state(elem.next, ren))
    if isinstance(elem, ast.EveryStateElement):
        return dataclasses.replace(elem, state=_rewrite_state(elem.state, ren))
    raise PlanError(f"cannot rewrite state element {type(elem).__name__}")


def rewrite_query(q: ast.Query, rename: dict) -> ast.Query:
    """Clone a pattern query's AST with stream ids substituted (aliases
    preserved); the port clones pattern queries only."""

    def ren_stream(s: ast.SingleInputStream) -> ast.SingleInputStream:
        key = f"#{s.stream_id}" if s.is_inner else s.stream_id
        new_id = rename.get(key)
        if new_id is None:
            return s
        # keep references resolving against the original name
        return dataclasses.replace(s, stream_id=new_id, is_inner=False,
                                   ref_id=s.ref_id or s.stream_id)

    inp = dataclasses.replace(q.input,
                              state=_rewrite_state(q.input.state, ren_stream))
    out = q.output
    tgt = _output_key(out)
    if tgt is not None and tgt in rename:
        kw = {"target": rename[tgt]}
        if getattr(out, "is_inner", False):
            kw["is_inner"] = False
        out = dataclasses.replace(out, **kw)
    return dataclasses.replace(q, input=inp, output=out)


def _output_key(out) -> Optional[str]:
    tgt = getattr(out, "target", None)
    if tgt is None:
        return None
    return f"#{tgt}" if getattr(out, "is_inner", False) else tgt


def input_stream_ids(q: ast.Query) -> list:
    """Input stream ids; inner (#) streams come back with a '#' prefix."""
    def sid_of(s: ast.SingleInputStream) -> str:
        return f"#{s.stream_id}" if s.is_inner else s.stream_id

    inp = q.input
    if isinstance(inp, ast.SingleInputStream):
        return [sid_of(inp)]
    if isinstance(inp, ast.JoinInputStream):
        return [sid_of(inp.left), sid_of(inp.right)]
    out: list = []

    def walk(e):
        if isinstance(e, (ast.StreamStateElement,
                          ast.AbsentStreamStateElement)):
            out.append(sid_of(e.stream))
        elif isinstance(e, ast.CountStateElement):
            walk(e.stream)
        elif isinstance(e, ast.LogicalStateElement):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.NextStateElement):
            walk(e.state)
            walk(e.next)
        elif isinstance(e, ast.EveryStateElement):
            walk(e.state)
    walk(inp.state)
    return out


class PartitionGroup(QueryPlan):
    """Routes keyed events to per-key query instances (strategy 2) and owns
    lazily-created clones (siddhi_tpu/core/partition.py:124-246): each
    clone is a host matcher plan named `<query>#<instance>` whose
    callbacks are the query's.  Device-axis pattern plans (strategy 1)
    register themselves as ordinary plans and bypass this group."""

    out_schema = None
    output_target = None

    def __init__(self, rt, part: ast.Partition, index: int,
                 clone_queries: list):
        from ..interp.expr import PyExprContext, compile_py
        self.rt = rt
        self.part = part
        self.index = index
        self.name = f"#partition_{index}"
        self.clone_queries = clone_queries      # queries run via cloning
        self.key_fns: dict = {}                 # sid -> fn(env) -> key | None
        for pk in part.keys:
            schema = rt.schemas.get(pk.stream_id)
            if schema is None:
                raise PlanError(f"partition: unknown stream {pk.stream_id!r}")
            ctx = PyExprContext({pk.stream_id: schema}, default_ref=pk.stream_id)
            if pk.expr is not None:
                f, _t = compile_py(pk.expr, ctx)
                self.key_fns[pk.stream_id] = f
            else:
                cases = [(compile_py(c.condition, ctx)[0], c.key)
                         for c in pk.ranges]

                def range_fn(env, _cases=cases):
                    for cond, label in _cases:
                        if cond(env):
                            return label
                    return None                  # no range -> dropped
                self.key_fns[pk.stream_id] = range_fn

        # only route streams the clone-strategy queries actually consume
        needed = {sid for q in clone_queries for sid in input_stream_ids(q)
                  if not sid.startswith("#")}
        missing = needed - set(self.key_fns)
        if missing:
            raise PlanError(
                f"partition: inner queries consume unkeyed streams {sorted(missing)}")
        self.input_streams = tuple(sid for sid in self.key_fns if sid in needed)
        self._key_index: dict = {}               # key -> instance number
        self._instances: set = set()             # instance numbers built

    # -- instance management -------------------------------------------------

    def _syn(self, inst: int, sid: str) -> str:
        base = sid[1:] if sid.startswith("#") else sid
        return f"#p{self.index}/{inst}/{base}"

    def _ensure_instance(self, inst: int) -> None:
        if inst in self._instances:
            return
        self._instances.add(inst)
        from ..interp.engine import InterpPatternQueryPlan
        from .build import _host_plan
        rt = self.rt
        # synthetic schemas for this instance's renamed streams
        rename: dict = {}
        inner_ids = set()
        for q in self.clone_queries:
            for sid in input_stream_ids(q):
                inner_ids.add(sid)
            tgt = _output_key(q.output)
            if tgt is not None and tgt.startswith("#"):
                inner_ids.add(tgt)
        for sid in inner_ids:
            if sid.startswith("#") or sid in self.key_fns:
                rename[sid] = self._syn(inst, sid)
        for sid, syn in rename.items():
            if syn not in rt.schemas and sid in rt.schemas:
                rt.schemas[syn] = StreamSchema(
                    syn, rt.schemas[sid].attributes)
        for qi, q in enumerate(self.clone_queries):
            q2 = rewrite_query(q, rename)
            base = q.name(f"query_p{self.index}_{qi}")
            # a clone is a host plan whatever the mode: the device lane
            # axis is the other strategy, not a one-lane plan per key
            plan = _host_plan(InterpPatternQueryPlan, base, rt, q2,
                              q2.input, output_target_of(q2))
            plan.name = f"{base}#{inst}"
            plan.callback_name = base
            rt._register_plan(plan)

    # -- QueryPlan interface -------------------------------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        if batch.n == 0:
            return []
        fn = self.key_fns[stream_id]
        rows = batch.rows(self.rt.strings)
        names = batch.schema.names
        keys = []
        for ts, row in zip(batch.timestamps, rows):
            env = dict(zip(names, row))
            env["__timestamp__"] = int(ts)
            keys.append(fn(env))
        arr = np.asarray([self._key_index.setdefault(k, len(self._key_index))
                          if k is not None else -1 for k in keys],
                         dtype=np.int64)
        for inst in np.unique(arr):
            if inst < 0:
                continue
            inst = int(inst)
            self._ensure_instance(inst)
            m = arr == inst
            sub = EventBatch(
                batch.schema, batch.timestamps[m],
                {k: v[m] for k, v in batch.columns.items()}, int(m.sum()),
                batch.seqs[m] if batch.seqs is not None else None,
                {k: v[m] for k, v in batch.nulls.items()}
                if batch.nulls else None)
            # direct enqueue preserves original seqs (cross-stream order
            # matters inside pattern instances); _emit would re-stamp them
            self.rt._pending.append((self._syn(inst, stream_id), sub))
        return []

    def state_dict(self) -> dict:
        # keys are plain hashables (str/int/float/bool) — store them as-is
        return {"key_index": list(self._key_index.items())}

    def load_state_dict(self, d: dict) -> None:
        self._key_index = dict(d["key_index"])
        for inst in set(self._key_index.values()):
            self._ensure_instance(inst)


def plan_partition(rt, part: ast.Partition, index: int) -> None:
    """Split the inner pattern queries between the device partition axis
    and per-key host clones (siddhi_tpu/core/partition.py:248-305), then
    register the group receiver if any clone query remains."""
    from .nfa_device import DeviceNFAUnsupported
    from .pattern_plan import DevicePatternPlan

    mode = rt.device_patterns
    value_keys = {pk.stream_id: pk.expr for pk in part.keys
                  if pk.expr is not None}
    clone_queries: list = []
    for qi, q in enumerate(part.queries):
        name = q.name(f"query_p{index}_{qi}")
        if not isinstance(q.input, ast.StateInputStream):
            raise PlanError(
                f"query {name!r}: partitioned non-pattern queries (per-key "
                f"host clones of filters, windows and joins) wait for the "
                f"host join (ROADMAP A4) and tables (A6)")
        used = False
        if mode != "never":
            sids = set(input_stream_ids(q))
            if sids <= set(value_keys):
                try:
                    key_fns = {s: _columnar_key_fn(rt, s, value_keys[s])
                               for s in sids}
                    rt._register_plan(DevicePatternPlan(
                        name, rt, q, q.input, output_target_of(q),
                        partitions=rt.partition_capacity,
                        part_key_fns=key_fns, slots=rt.device_slots))
                    used = True
                except DeviceNFAUnsupported as e:
                    if mode == "always":
                        raise
                    warnings.warn(f"query {name!r} runs on per-key host "
                                  f"clones: {e}", RuntimeWarning,
                                  stacklevel=3)
            else:
                why = (f"pattern consumes streams without value partition "
                       f"keys ({sorted(sids - set(value_keys))})")
                if mode == "always":
                    raise PlanError(f"query {name!r}: {why}")
                warnings.warn(f"query {name!r} runs on per-key host clones: "
                              f"{why}", RuntimeWarning, stacklevel=3)
        if not used:
            clone_queries.append(q)
    if clone_queries:
        group = PartitionGroup(rt, part, index, clone_queries)
        rt._plans.append(group)
        for sid in group.input_streams:
            rt._subscribers[sid].append(group)
        for qi, q in enumerate(clone_queries):      # the clones' names
            rt._known_query_names.add(q.name(f"query_p{index}_{qi}"))


def _columnar_key_fn(rt, stream_id: str, expr: ast.Expression):
    """batch -> key column: a plain attribute's column (string keys are
    their dictionary codes), or a computed key evaluated row by row by the
    host closures (siddhi_tpu/core/partition.py:308-324)."""
    schema = rt.schemas[stream_id]
    if isinstance(expr, ast.Variable) and expr.stream_ref in (None, stream_id):
        name = expr.attribute
        if name not in schema.types:
            raise PlanError(f"partition key: unknown attribute {name!r}")

        def fn(batch: EventBatch):
            return batch.columns[name]
        return fn
    from ..interp.expr import PyExprContext, compile_py
    ctx = PyExprContext({stream_id: schema}, default_ref=stream_id)
    f, _t = compile_py(expr, ctx)
    names = schema.names

    def computed(batch: EventBatch) -> np.ndarray:
        rows = batch.rows(rt.strings)
        return np.asarray([f(dict(zip(names, r))) for r in rows])
    return computed
