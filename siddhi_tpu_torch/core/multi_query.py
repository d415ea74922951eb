"""Multi-query device batching: structurally identical pattern queries
become LANES of one batched plan.

Port of `siddhi_tpu/core/multi_query.py` (the JAX module imports no JAX at
module level, but the port keeps its own copy: it imports nothing of the
JAX package).  BASELINE config 5, "1k concurrent queries over a shared
InputHandler", maps onto the partition axis of the device plans: queries
that share an AST shape and differ only in constants compile once, each
lifted constant becoming a per-lane parameter `__qparam<i>`.  Every event
broadcasts to all lanes, and each match carries its lane id (`__qid__`)
so the host routes it to that query's output stream.

Grouping is automatic in core/build.py: >= MIN_GROUP pattern queries with
equal shape signatures (and no rate/having/limit) fuse, packed into
kernels of at most `@app:fusedLanes(N)` lanes; everything else plans
individually.  `@app:devicePatterns('never')` disables it.

A fused group's inner DevicePatternPlan picks its family as the JAX
package's does: `scan` where eligible, `dfa` when
`@app:patternFamily('dfa')` asks and a static hop exists (the lanes'
pre-masks over the one shared row of events feed K11's tables), `seq`
otherwise; `chunk` is refused there with the JAX package's reason
("fused multi-query lane kernel"), the lane axis being the queries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..query import ast

MIN_GROUP = 8


# ---------------------------------------------------------------------------
# shape signature + constant lifting
# ---------------------------------------------------------------------------

def _sig(node, consts: Optional[list] = None):
    """Canonical shape token tree: constants -> type tokens (collected in
    order into `consts` when given)."""
    if isinstance(node, ast.Constant):
        if consts is not None:
            consts.append(node)
        return ("const", node.type.name)
    if isinstance(node, ast.TimeConstant):
        return ("timeconst", node.millis)   # within/for stay literal
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        out = [type(node).__name__]
        for f in dataclasses.fields(node):
            out.append((f.name, _sig(getattr(node, f.name), consts)))
        return tuple(out)
    if isinstance(node, (tuple, list)):
        return tuple(_sig(x, consts) for x in node)
    if isinstance(node, (str, int, float, bool)) or node is None:
        return node
    if isinstance(node, ast.AttrType) or hasattr(node, "name"):
        return getattr(node, "name", str(node))
    return str(node)


def _has_string_const(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.type == ast.AttrType.STRING
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return any(_has_string_const(getattr(node, f.name))
                   for f in dataclasses.fields(node))
    if isinstance(node, (tuple, list)):
        return any(_has_string_const(x) for x in node)
    return False


def query_signature(q: ast.Query):
    """Hashable shape signature of a pattern query (constants abstracted);
    None when the query can't participate in fusion."""
    if not isinstance(q.input, ast.StateInputStream):
        return None
    if q.rate is not None or q.selector.having is not None \
            or q.selector.group_by or q.selector.order_by \
            or q.selector.limit is not None or q.selector.offset \
            or q.selector.select_all:
        return None
    if not isinstance(q.output, ast.InsertInto):
        return None
    if getattr(q.output, "events_for",
               ast.OutputEventsFor.CURRENT) != ast.OutputEventsFor.CURRENT:
        return None
    if _has_string_const(q.input) or any(_has_string_const(oa.expr)
                                         for oa in q.selector.attributes):
        return None        # string params need interning: not lifted yet
    # output NAMES may differ per query; the target stream SCHEMA shape
    # must match (routing is per-lane)
    return ("pattern", _sig(q.input), _sig(tuple(
        ("attr", _sig(oa.expr)) for oa in q.selector.attributes)))


class _Lifter:
    """Rewrites constants into __qparam<i> variables (resolved through
    ctx.extra) and records each instance's constant values."""

    def __init__(self):
        self.types: list = []       # AttrType per param slot

    def lift(self, node, counter: list):
        if isinstance(node, ast.Constant):
            i = counter[0]
            counter[0] += 1
            if i == len(self.types):
                self.types.append(node.type)
            return ast.Variable(f"__qparam{i}")
        if isinstance(node, ast.TimeConstant):
            # time constants stay literal: `within 1 sec` feeds the
            # kernel's per-position within, parameterized separately
            return node
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                nv = self.lift(v, counter)
                if nv is not v:
                    changes[f.name] = nv
            return dataclasses.replace(node, **changes) if changes else node
        if isinstance(node, tuple):
            out = tuple(self.lift(x, counter) for x in node)
            return out if any(a is not b for a, b in zip(out, node)) else node
        return node

    @staticmethod
    def const_values(node, acc: list):
        if isinstance(node, ast.Constant):
            acc.append(node.value)
            return
        if isinstance(node, ast.TimeConstant):
            return
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                _Lifter.const_values(getattr(node, f.name), acc)
        elif isinstance(node, (tuple, list)):
            for x in node:
                _Lifter.const_values(x, acc)


def plan_query_group(rt, queries: list, names: list):
    """Build one MultiQueryDevicePatternPlan for a same-shape group, or
    raise DeviceNFAUnsupported (the queries then plan individually)."""
    from .nfa_device import DeviceNFAUnsupported

    proto = queries[0]
    lifter = _Lifter()
    counter = [0]
    lifted = _lift_query(proto, lifter, counter)
    n_params = counter[0]

    # per-instance parameter matrix (P queries x n_params)
    values = []
    for q in queries:
        acc: list = []
        _Lifter.const_values(q.input, acc)
        for oa in q.selector.attributes:
            _Lifter.const_values(oa.expr, acc)
        if len(acc) != n_params:
            raise DeviceNFAUnsupported("constant-count mismatch in group")
        values.append(acc)
    return MultiQueryDevicePatternPlan(
        names[0] + f"__x{len(queries)}", rt, lifted, lifted.input,
        param_types=lifter.types, param_values=values,
        targets=[_target_of(q) for q in queries],
        out_names=[[oa.name for oa in q.selector.attributes]
                   for q in queries],
        query_names=names)


def _lift_query(q: ast.Query, lifter: _Lifter, counter: list) -> ast.Query:
    new_input = lifter.lift(q.input, counter)
    new_attrs = tuple(dataclasses.replace(oa, expr=lifter.lift(oa.expr,
                                                               counter))
                      for oa in q.selector.attributes)
    return dataclasses.replace(
        q, input=new_input,
        selector=dataclasses.replace(q.selector, attributes=new_attrs))


def _target_of(q: ast.Query) -> str:
    return q.output.target


# ---------------------------------------------------------------------------
# the fused plan
# ---------------------------------------------------------------------------

class MultiQueryDevicePatternPlan:
    """One device pattern plan whose lanes are query INSTANCES (not
    partition keys): events broadcast to every lane; emitted matches route
    to their lane's output stream.  The JAX package pads the lane axis to
    a multiple of its device mesh (multi_query.py:233-240); the port has
    no mesh, so P is the number of queries and no lane is padding."""

    def __init__(self, name, rt, q, state_input, param_types, param_values,
                 targets, out_names, query_names):
        from .nfa_device import NFAKernel
        from .pattern_plan import DevicePatternPlan
        from .schema import StreamSchema

        self.name = name
        self.rt = rt
        self.query_names = query_names
        self.targets = targets
        self.per_q_names = out_names
        P = len(param_values)
        extra = {f"__qparam{i}": (f"__qparam{i}", t)
                 for i, t in enumerate(param_types)}
        # parameters in the device pattern path's types: DOUBLE as float32
        # (the port refuses @app:devicePrecision('f64') in the plan below);
        # a selector over maybe-absent refs, which would need NULL
        # routing, is refused by the plan's kernel
        params = {f"__qparam{i}": np.asarray(
                      [v[i] for v in param_values]).astype(
                      NFAKernel.np_dtype(t))
                  for i, t in enumerate(param_types)}
        self.inner = DevicePatternPlan(
            name, rt, q, state_input, target=targets[0], partitions=P,
            part_key_fns=None, slots=rt.device_slots, param_extra=extra,
            broadcast_events=True, params=params)
        self.n_queries = P
        # each query's output schema; register the target streams'
        self._schemas = [StreamSchema(tgt, tuple(
            ast.Attribute(nm, t) for nm, t in
            zip(out_names[qi], self.inner._types)))
            for qi, tgt in enumerate(targets)]
        for tgt, schema in zip(targets, self._schemas):
            rt.schemas.setdefault(tgt, schema)
        self.input_streams = self.inner.input_streams
        self.output_target = None          # routed per lane
        self.out_schema = None

    def process(self, stream_id, batch):
        return self.inner.process(stream_id, batch)

    def finalize(self):
        """Every lane's matches since the last call, one OutputBatch per
        query in query order, each sorted by (completion seq, head seq)
        and named for that query's callbacks (`callback_name`).  The rows
        are grouped by lane with one stable sort of the (seq, head seq)
        order (the JAX package masks the table once per query)."""
        from .batch import EventBatch
        from .planner import OutputBatch
        from .schema import TIMESTAMP_DTYPE

        outs = self.inner.finalize_multi()
        if not outs:
            return []
        tss, seqs, hseqs, data, qids = outs
        order = np.lexsort((hseqs, seqs))
        order = order[np.argsort(qids[order], kind="stable")]
        qs = qids[order]
        starts = np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]])
        ends = np.r_[starts[1:], len(qs)]
        res = []
        for a, b in zip(starts.tolist(), ends.tolist()):
            qi = int(qs[a])
            rows = order[a:b]
            cols = {nm: data[src][rows] for nm, src
                    in zip(self.per_q_names[qi], self.inner._names)}
            ob = OutputBatch(self.targets[qi], EventBatch(
                self._schemas[qi], tss[rows].astype(TIMESTAMP_DTYPE), cols,
                b - a, seqs[rows]))
            ob.callback_name = self.query_names[qi]
            res.append(ob)
        return res

    def on_timer(self, now_ms):
        self.inner.on_timer(now_ms)      # deadline ticks; matches surface
        return self.finalize()           # through the buffered path

    def next_wakeup(self):
        return self.inner.next_wakeup()

    @property
    def family(self) -> str:
        return self.inner.family

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, d):
        self.inner.load_state_dict(d)

