"""Device window + aggregation plans.

Port of `siddhi_tpu/core/window_device.py` (`DeviceWindowAggPlan`): `from
S[f]#window.<kind>(..) select <aggs> [group by ..] [having ..] [order by
.. limit .. offset ..]` for the sliding kinds `length`, `time` and
`externalTime` and the tumbling kinds `lengthBatch` and
`externalTimeBatch`, over sum/count/avg/min/max.  A micro-batch of T
events is one step over the concatenated [carry | batch] sequence of N =
C + T entries, where the carry is a right-packed, fixed-capacity buffer
of the events still inside a window (C doubles on overflow, and the
batch is redone from the state before it).

The JAX step is one jitted program; here it is a short chain of
hand-written CUDA kernels and torch glue (cat, sort, gathers):
  * K1 `expr_eval`, use `window_args`: the filter mask (ballot words) and
    each aggregate's argument over the raw batch rows;
  * K8 `win_compact`: the filter-passing events to the front (timestamps,
    window clock, the carried columns, the argument values); k is read
    back once per step where a filter or an argument gave a mask (without
    one, k is the batch's n);
  * K6 `win_scan`: the valid count, the monotone clock, the prefix sums
    (f64 for floats, i64 for integers and counts), the dense group ids,
    and the tumbling kinds' running aggregates with segment resets;
  * K7 `win_range` (sliding kinds): left edges, prefix differences,
    sparse-table min/max, avg, the carry's `start_k`;
  * K1, use `window_select`: the selector and `having` over the
    aggregates (tumbling: AND the rows that emit), then K8 compacts the
    output rows.
Aggregates over one argument share its value column: min(price),
max(price) and avg(price) compute, carry and gather one column.  Every
kernel call goes through `_kernel`, which also appends it to `record`
when that is a list (the card's checks replay the calls).
Sums are exact in i64 over INT/LONG (the JAX device path sums in the
compute float and rounds LONG sums; the port follows the host
interpreter there) and run in f64 over FLOAT/DOUBLE before rounding to
the compute dtype; min/max and avg compute in the compute dtype as the
JAX package does (`@app:devicePrecision('f64')` or f32).

Rows follow `_materialize` of the JAX package: sliding kinds emit one row
per filter-passing event, stamped with its arrival timestamp; tumbling
kinds emit completed buckets, carried events of earlier batches with
their own timestamps; rows leave in arrival order before `order by`.
Unsupported shapes raise DeviceWindowUnsupported (a PlanError) at plan
time; `core/build.py` then places the query on the host interpreter
(`interp/engine.py` InterpSingleQueryPlan) with a RuntimeWarning, as the
JAX package demotes them, or raises under `@app:deviceWindows('always')`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..interp.aggregators import extract_aggregators, out_type
from ..kernels.expr_eval import expr_eval
from ..kernels.win_compact import win_compact
from ..kernels.win_range import win_range
from ..kernels.win_scan import win_scan
from ..query import ast
from ..query.ast import AttrType
from .batch import EventBatch
from .expr import (VT_OF_TORCH, ExprError, Node, SingleStreamContext,
                   cast_to, compile_expression, compute_dtypes, emit_program,
                   eval_node, subst, torch_dtype, F32_MODE)
from .planner import OutputBatch, PlanError, QueryPlan
from .schema import TIMESTAMP_DTYPE, StreamSchema, dtype_of

TS_PAD = 2 ** 62                    # compacted pads (window_device.py:837)
EXT_START_SENTINEL = -(2 ** 62)     # externalTimeBatch: no anchor yet
_TUMBLING = ("lengthbatch", "externaltimebatch")


class DeviceWindowUnsupported(PlanError):
    """A window query shape outside the device window plan."""
KERNELS = {"expr_eval": expr_eval, "win_scan": win_scan,
           "win_range": win_range, "win_compact": win_compact}


def pow2_at_least(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceWindowAggPlan(QueryPlan):
    """One window + aggregation query as one device step per batch."""

    C_START = 1024          # initial carry capacity of the time kinds
    L_CAP = 1 << 16         # longer length windows are not planned
    record: Optional[list] = None   # (name, args, kwargs) of kernel calls

    def __init__(self, name: str, rt, q: ast.Query,
                 inp: ast.SingleInputStream, target: Optional[str]):
        self.name = name
        self.rt = rt
        self.device = rt.device
        self.output_target = target
        prec = ast.find_annotation(rt.app.annotations, "app:devicePrecision")
        self.f64 = prec is not None and str(prec.element()).lower() == "f64"
        self._mode = None if self.f64 else F32_MODE
        self.fdt = torch.float64 if self.f64 else torch.float32

        def unsupported(what: str) -> PlanError:
            return DeviceWindowUnsupported(
                f"query {name!r}: {what} on the device window plan")
        if q.rate is not None:
            raise unsupported("output rate limiting")
        if q.output.events_for != ast.OutputEventsFor.CURRENT:
            raise unsupported("expired-events output")
        self._order_by = list(q.selector.order_by)
        self.limit, self.offset = q.selector.limit, q.selector.offset
        if any(isinstance(h, ast.StreamFunction) for h in inp.handlers):
            raise unsupported("stream functions")
        schema = rt.schemas[inp.stream_id]
        self.in_schema = schema
        self.input_streams = (inp.stream_id,)
        if any(a.type == AttrType.OBJECT for a in schema.attributes):
            raise unsupported("object columns")
        self._parse_window(inp.window, schema, unsupported)
        try:
            self._compile(q, inp, schema, unsupported)
        except ExprError as e:
            raise unsupported(str(e)) from None
        self.state = self._init_state()

    # -- planning -------------------------------------------------------------

    def _parse_window(self, wh: ast.WindowHandler, schema, unsupported):
        wname = wh.name.lower()
        if wh.namespace is not None:
            raise unsupported(f"namespaced window {wname}")

        def const(i):
            a = wh.args[i]
            if isinstance(a, ast.TimeConstant):
                return a.millis
            if isinstance(a, ast.Constant):
                return a.value
            raise unsupported("a non-constant window argument")

        def ext_attr(what):
            var = wh.args[0]
            if not isinstance(var, ast.Variable):
                raise unsupported(f"{what} timestamp that is not an "
                                  f"attribute")
            at = schema.types.get(var.attribute)
            if at not in (AttrType.INT, AttrType.LONG):
                raise unsupported(f"{what} timestamp attribute that is not "
                                  f"int/long")
            return var.attribute

        self._ext_ts_attr = None
        self.L = self.D = 0
        if wname in ("length", "lengthbatch"):
            self.kind = wname
            self.L = int(const(0))
            if self.L <= 0 or self.L > self.L_CAP:
                raise unsupported(f"{wh.name}({self.L})")
            self.C = pow2_at_least(self.L)
        elif wname == "time":
            self.kind, self.D, self.C = "time", int(const(0)), self.C_START
        elif wname == "externaltime":
            # sliding over an event-time attribute: the `time` kind with
            # the clock read from the column
            self.kind = "time"
            self._ext_ts_attr = ext_attr("externalTime")
            self.D, self.C = int(const(1)), self.C_START
        elif wname == "externaltimebatch":
            if len(wh.args) > 2:
                raise unsupported("externalTimeBatch start-time/timeout "
                                  "arguments")
            self.kind = "externaltimebatch"
            self._ext_ts_attr = ext_attr("externalTimeBatch")
            self.D, self.C = int(const(1)), self.C_START
        else:
            raise unsupported(f"window {wh.name}")

    def _compile(self, q, inp, schema, unsupported):
        strings = self.rt.strings
        ctx = SingleStreamContext(schema, strings, inp.alias)
        self._filter = None
        if inp.filters:
            f = inp.filters[0].expr
            for g in inp.filters[1:]:
                f = ast.And(f, g.expr)
            self._filter = compile_expression(f, ctx)
            if self._filter.type != AttrType.BOOL:
                raise PlanError(f"filter must be boolean in {self.name!r}")
        self.group_keys = [ctx.resolve(g)[0] for g in q.selector.group_by]
        sel = q.selector
        if sel.select_all:
            raise unsupported("select * with aggregation")
        raw_sites: list = []
        rewritten = [(oa.name, extract_aggregators(oa.expr, raw_sites))
                     for oa in sel.attributes]
        having_re = extract_aggregators(sel.having, raw_sites) \
            if sel.having is not None else None
        if not raw_sites:
            raise unsupported("a selector without aggregates")
        # (name, argument CompiledExpr or None, output type)
        self.sites = []
        for s in raw_sites:
            arg = compile_expression(s.arg, ctx) if s.arg is not None \
                else None
            try:
                ot = out_type(s.name, arg.type if arg is not None else None)
            except ValueError as e:
                raise unsupported(str(e)) from None
            self.sites.append((s.name, arg, ot))
        extra = {f"__agg{i}": (f"__agg{i}", s[2])
                 for i, s in enumerate(self.sites)}
        octx = SingleStreamContext(schema, strings, inp.alias, extra)
        out_fns = [compile_expression(e, octx) for _n, e in rewritten]
        names = [n for n, _e in rewritten]
        types = [ce.type for ce in out_fns]
        having = None
        if having_re is not None:
            hctx = SingleStreamContext(schema, strings, inp.alias, {
                **extra, **{n: (n, t) for n, t in zip(names, types)}})
            having = compile_expression(having_re, hctx)
            if having.type != AttrType.BOOL:
                raise PlanError("having must be boolean")
        for ob in self._order_by:
            if ob.var.attribute not in names:
                raise unsupported(f"order by {ob.var.attribute!r}, not an "
                                  f"output column")
        self.out_schema = StreamSchema(self.output_target or f"#{self.name}",
                                       tuple(ast.Attribute(n, t) for n, t
                                             in zip(names, types)))
        self._having_tree = None if having is None else subst(
            having.node, {n: ce.node for n, ce in zip(names, out_fns)})
        # the rows read the group keys, the selector and `having`; the
        # filter and the aggregates' arguments only feed K1 window_args
        row_reads: set = set(self.group_keys)
        for ce in out_fns:
            row_reads |= ce.reads
        if having is not None:
            row_reads |= having.reads - set(names)
        if self.kind == "externaltimebatch":
            row_reads.add(self._ext_ts_attr)    # the bucket clock rides along
        reads = set(row_reads)
        if self._filter is not None:
            reads |= self._filter.reads
        for _nm, arg, _t in self.sites:
            if arg is not None:
                reads |= arg.reads
        if self._ext_ts_attr is not None and self.kind == "time" \
                and "__timestamp__" in reads:
            # the window clock is the column; expressions would need the
            # arrival time as well (the JAX package refuses this too)
            raise unsupported("externalTime with expressions that read the "
                              "event timestamp")
        if self._ext_ts_attr is not None:
            reads.add(self._ext_ts_attr)
        unknown = sorted(k for k in reads if k not in schema.types
                         and k != "__timestamp__"
                         and not k.startswith("__agg"))
        if unknown:
            raise unsupported(f"unresolved columns {unknown}")
        self.cols = sorted(k for k in reads if k in schema.types)
        self.row_cols = sorted(k for k in row_reads if k in schema.types)
        self._programs(out_fns)

    def _col_dtype(self, key: str) -> torch.dtype:
        """Device dtype of an event column (DOUBLE in the compute dtype)."""
        if key == "__timestamp__":
            return torch.int64
        with compute_dtypes(self._mode):
            return torch_dtype(self.in_schema.type_of(key))

    def _site_dtype(self, i: int) -> Optional[torch.dtype]:
        """Dtype of site i's argument values: i64 for sums and averages
        over INT/LONG, the compute dtype otherwise; None for count()."""
        nm, arg, _t = self.sites[i]
        if nm == "count":
            return None
        if nm in ("sum", "avg") and arg.type in (AttrType.INT, AttrType.LONG):
            return torch.int64
        return self.fdt

    def _value_columns(self) -> None:
        """One value column per distinct (argument, dtype): `_vcols[j]` is
        (argument node, dtype), `_site_col[i]` site i's column (None for
        count())."""
        self._vcols: list = []
        self._site_col: list = []
        for i, (_nm, arg, _t) in enumerate(self.sites):
            dt = self._site_dtype(i)
            if dt is None:
                self._site_col.append(None)
                continue
            key = (arg.node, dt)
            if key not in self._vcols:
                self._vcols.append(key)
            self._site_col.append(self._vcols.index(key))

    def _agg_dtype(self, i: int) -> torch.dtype:
        with compute_dtypes(self._mode):
            return torch_dtype(self.sites[i][2])

    def _programs(self, out_fns: list) -> None:
        """VM programs of the two K1 uses: window_args over the raw batch
        columns, window_select over the row columns and the aggregates."""
        def slots_of(keys):
            return {k: (i, VT_OF_TORCH[self._col_dtype(k)])
                    for i, k in enumerate(keys)}
        self._arg_keys = sorted(set(self.cols) | {"__timestamp__"})
        self._sel_keys = sorted(set(self.row_cols) | {"__timestamp__"})
        self._value_columns()
        slots = slots_of(self._arg_keys)
        with compute_dtypes(self._mode):
            self._filter_prog = emit_program(self._filter.node, slots) \
                if self._filter is not None else None
            self._arg_progs = [emit_program(Node(
                "cast", AttrType.LONG if dt == torch.int64 else
                AttrType.DOUBLE, (node,)), slots) for node, dt in self._vcols]
        slots = slots_of(self._sel_keys)
        base, n_sites = len(self._sel_keys), len(self.sites)
        for i in range(n_sites):
            slots[f"__agg{i}"] = (base + i, VT_OF_TORCH[self._agg_dtype(i)])
        emit = None
        if self.kind in _TUMBLING:     # the rows that emit: one more column
            slots["__emit__"] = (base + n_sites, VT_OF_TORCH[torch.bool])
            emit = Node("var", AttrType.BOOL, key="__emit__")
        mask = self._having_tree
        if emit is not None:
            mask = emit if mask is None else Node("and", AttrType.BOOL,
                                                  (emit, mask))
        with compute_dtypes(self._mode):
            self._out_progs = [emit_program(ce.node, slots) for ce in out_fns]
            self._row_prog = emit_program(mask, slots) \
                if mask is not None else None

    # -- state ----------------------------------------------------------------

    def _carry_cols(self) -> list:
        """Event columns the carry keeps: the row columns for the tumbling
        kinds (their rows emit later), the group keys for the sliding ones
        (the aggregates' arguments ride as values, `v.<j>`)."""
        return list(self.row_cols) if self.kind in _TUMBLING \
            else sorted(self.group_keys)

    def _init_state(self) -> dict:
        C, dev = self.C, self.device
        st = {"ts": torch.full((C,), -TS_PAD, dtype=torch.int64, device=dev),
              "valid": torch.zeros(C, dtype=torch.bool, device=dev),
              "seen": torch.zeros((), dtype=torch.int64, device=dev)}
        if self.kind == "externaltimebatch":
            st["start"] = torch.full((), EXT_START_SENTINEL,
                                     dtype=torch.int64, device=dev)
        for k in self._carry_cols():
            st[f"c.{k}"] = torch.zeros(C, dtype=self._col_dtype(k),
                                       device=dev)
        for j, (_node, dt) in enumerate(self._vcols):
            st[f"v.{j}"] = torch.zeros(C, dtype=dt, device=dev)
        return st

    def _grow(self, new_c: int) -> None:
        old = self.state
        self.C = new_c
        st = self._init_state()
        for k, v in old.items():
            if v.dim() == 0:
                st[k] = v
            else:
                st[k][-v.shape[0]:] = v         # keep right-packing
        self.state = st

    # -- the step -------------------------------------------------------------

    def _kernel(self, name: str, *a, **kw):
        """Every kernel call of the step (recorded when `record` is set)."""
        if self.record is not None:
            self.record.append((name, a, kw))
        return KERNELS[name](*a, **kw)

    def process(self, stream_id: str, batch: EventBatch) -> list:
        if batch.n == 0:
            return []
        dev = self.device
        env = {"__timestamp__": torch.from_numpy(
            np.ascontiguousarray(batch.timestamps)).to(dev)}
        for c in self.cols:
            a = batch.columns[c]
            if not self.f64 and a.dtype == np.float64:
                a = a.astype(np.float32)
            env[c] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        while True:
            res = self._step(self.state, env, batch.n)
            if res is None:
                return []
            if not bool(res["overflow"]):
                break
            # carry overflow: double C and redo the batch from its state
            self._grow(2 * self.C)
        self.state = res["state"]
        return self._materialize(res)

    def _step(self, state: dict, env: dict, n: int) -> Optional[dict]:
        """One batch: returns the new state, the overflow flag and the
        output rows (still on the device), or None when no event passes
        the filter (the state is then unchanged)."""
        C = self.C
        T = pow2_at_least(n)
        N = C + T
        dev = self.device
        # K1 window_args: the filter mask and the arguments' values
        cols = [env[k] for k in self._arg_keys]
        words, vals = None, []
        if self._filter_prog is not None or self._arg_progs:
            words, vals = self._kernel("expr_eval", cols, self._filter_prog,
                                       self._arg_progs, n, use="window_args")
        # K8: the passing events to the front of T slots
        ext_clock = self._ext_ts_attr is not None and self.kind == "time"
        srcs = [env["__timestamp__"]]
        fills = [TS_PAD]
        if ext_clock:
            srcs.append(env[self._ext_ts_attr].to(torch.int64))
            fills.append(TS_PAD)
        srcs += [env[c] for c in self.row_cols] + list(vals)
        fills += [0] * (len(self.row_cols) + len(vals))
        packed, k_t = self._kernel("win_compact", srcs, fills, n, T, words)
        # no filter and no arguments: every row below n is kept (the JAX
        # mask arange(T) < nvalid), so k needs no read-back
        k = n if words is None else int(k_t[0])
        if k == 0:
            return None
        bts = packed[0]
        off = 2 if ext_clock else 1
        nr = len(self.row_cols)
        bcols = dict(zip(self.row_cols, packed[off:off + nr]))
        valid = torch.cat([state["valid"],
                           torch.arange(T, device=dev) < k])
        vals_all = [torch.cat([state[f"v.{j}"], v])
                    for j, v in enumerate(packed[off + nr:])]
        if self.kind in _TUMBLING:
            return self._step_tumbling(state, bts, bcols, valid, vals_all,
                                       C, N, k)
        clock_b = packed[1] if ext_clock else bts
        return self._step_sliding(state, bts, clock_b, bcols, valid,
                                  vals_all, C, N, k)

    def _group_seg(self, keys: dict, valid: torch.Tensor, N: int):
        """Dense group ids per entry, invalid entries N (window_device.py
        :571-592): chained stable sorts stand in for jnp.lexsort, float
        keys compare as f64 bits with -0.0 folded into 0.0, and K6 counts
        the boundary flags."""
        ks = []
        for g in self.group_keys:
            c = keys[g]
            if c.dtype.is_floating_point:
                c = c.to(torch.float64)
                c = torch.where(c == 0.0, torch.zeros_like(c), c).view(
                    torch.int64)
            else:
                c = c.to(torch.int64)
            ks.append(c)
        order = torch.arange(N, device=valid.device)
        for kk in reversed(ks):
            order = order[torch.sort(kk[order], stable=True).indices]
        diff = torch.zeros(N, dtype=torch.bool, device=valid.device)
        diff[0] = True
        for kk in ks:
            s = kk[order]
            diff[1:] |= s[1:] != s[:-1]
        seg_sorted = self._kernel("win_scan", [("sum", diff, False)], N)[0] - 1
        seg = torch.empty_like(seg_sorted)
        seg[order] = seg_sorted
        return torch.where(valid, seg, torch.full_like(seg, N))

    @staticmethod
    def _sorted_by(seg: torch.Tensor, N: int) -> tuple:
        """(order, sorted keys) of the (segment * N + position) keys."""
        key = seg * N + torch.arange(N, device=seg.device)
        ks, order = torch.sort(key)
        return order, ks

    def _step_sliding(self, state, bts, clock_b, bcols, valid, vals_all,
                      C, N, k):
        time_kind = self.kind == "time"
        grouped = bool(self.group_keys)
        col = self._site_col
        # K6 in arrival order: the monotone clock, the valid count and,
        # ungrouped, the prefix sums (one per value column a sum reads)
        specs = [("sum", None, True)]
        if time_kind:
            specs.append(("max", torch.cat([state["ts"], clock_b]), False))
        sums = sorted({col[i] for i, s in enumerate(self.sites)
                       if s[0] in ("sum", "avg")})
        if not grouped:
            specs += [("sum", vals_all[j], True) for j in sums]
        scanned = self._kernel("win_scan", specs, N, valid=valid)
        vcnt = scanned[0]
        clock = scanned[1] if time_kind else None
        groups, svalid, svals = None, valid, vals_all
        if grouped:
            keys = {g: torch.cat([state[f"c.{g}"], bcols[g]])
                    for g in self.group_keys}
            seg = self._group_seg(keys, valid, N)
            order, ks = self._sorted_by(seg, N)
            groups = (ks,)
            svalid = valid[order]
            used = {col[i] for i in range(len(self.sites))} - {None}
            svals = {j: vals_all[j][order] for j in used}
            pfx = self._kernel("win_scan", [("sum", svals[j], True)
                                            for j in sums]
                               + [("sum", None, True)], N, valid=svalid)
            cnt = pfx[-1]
            pfx = dict(zip(sums, pfx))
        else:
            pfx = dict(zip(sums, scanned[2 if time_kind else 1:]))
            cnt = vcnt
        sites = []
        for i, (nm, _arg, _ot) in enumerate(self.sites):
            j = col[i]
            if nm == "count":
                sites.append(("sum", cnt, None, None, torch.int64))
            elif nm == "sum":
                sites.append(("sum", pfx[j], None, None, torch.int64
                              if pfx[j].dtype == torch.int64 else self.fdt))
            elif nm == "avg":
                sites.append(("avg", pfx[j], cnt, None, self.fdt))
            else:
                sites.append((nm, None, None, svals[j], self.fdt))
        aggs, start_k = self._kernel(
            "win_range", sites, n=N, first=C, m=k,
            kind="time" if time_kind else "length",
            span=self.D if time_kind else self.L, last=C + k - 1,
            vcnt=vcnt, clock=clock, groups=groups, valid=svalid)
        aggs = [cast_to(a, self._agg_dtype(i)) for i, a in enumerate(aggs)]
        # the carry: the last C entries ending at C + k, minus departures
        keep = (torch.arange(N, device=valid.device) >= start_k) & valid
        mono = clock if time_kind else torch.cat([state["ts"], clock_b])
        new = {"seen": state["seen"] + k, "ts": mono[k:k + C].clone(),
               "valid": keep[k:k + C].clone()}
        for g in self._carry_cols():
            new[f"c.{g}"] = torch.cat([state[f"c.{g}"], bcols[g]])[k:k + C]
        for j, v in enumerate(vals_all):
            new[f"v.{j}"] = v[k:k + C].clone()
        cols = [bcols[c] if c in bcols else bts for c in self._sel_keys]
        return self._select(new, keep.sum() > C, cols + aggs, k, bts)

    def _step_tumbling(self, state, bts, bcols, valid, vals_all, C, N, k):
        grouped = bool(self.group_keys)
        dev = valid.device
        all_ts = torch.cat([state["ts"], bts])
        cols_all = {c: torch.cat([state[f"c.{c}"], bcols[c]])
                    for c in self.row_cols}
        neg1 = torch.full((N,), -1, dtype=torch.int64, device=dev)
        if self.kind == "lengthbatch":
            # admission index: carried events keep their old positions
            base = state["seen"] - state["valid"].sum()
            vrank = self._kernel("win_scan", [("sum", None, True)], N,
                                 valid=valid)[0] - 1
            gidx = base + vrank
            brel = torch.where(valid, torch.div(vrank, self.L,
                                                rounding_mode="floor"), neg1)
            total = base + valid.sum()
            completed = torch.div(total, self.L, rounding_mode="floor") \
                * self.L
            emit = valid & (gidx < completed)
            pend = valid & (gidx >= completed)
            extra = {"seen": total}
        else:
            ets = cols_all[self._ext_ts_attr].to(torch.int64)
            idx0 = torch.argmax(valid.to(torch.uint8))     # first valid
            start = torch.where((state["start"] == EXT_START_SENTINEL)
                                & valid.any(), ets[idx0], state["start"])
            b = torch.where(valid, torch.div(ets - start, self.D,
                                             rounding_mode="floor"), neg1)
            brel = torch.where(valid, b - b[idx0], neg1)
            blast = b.max()
            emit = valid & (b < blast)
            pend = valid & (b == blast)
            extra = {"seen": state["seen"] + k, "start": start}
        order = None
        if grouped:
            seg = self._group_seg({g: cols_all[g] for g in self.group_keys},
                                  valid, N)
            segk = torch.where(valid, brel * (N + 1) + seg,
                               torch.full_like(seg, (N + 2) * (N + 1)))
            order, _ks = self._sorted_by(segk, N)
            segk = segk[order]
        else:
            segk = brel
        flags = torch.ones(N, dtype=torch.bool, device=dev)
        flags[1:] = segk[1:] != segk[:-1]
        svalid = valid if order is None else valid[order]
        # one running scan per (op, value column), gathered once: sum(x)
        # and avg(x) share x's sum, count() and avg the count (a sum of
        # the valid entries, column None)
        sv = vals_all if order is None else [v[order] for v in vals_all]
        specs, at = [], {}
        for i, (nm, _arg, _ot) in enumerate(self.sites):
            j = self._site_col[i]
            for key in {"count": [("sum", None)], "avg": [("sum", j), (
                    "sum", None)]}.get(nm, [(nm, j)]):
                if key not in at:
                    at[key] = len(specs)
                    specs.append((key[0], None if key[1] is None
                                  else sv[key[1]], True))
        run = self._kernel("win_scan", specs, N, valid=svalid, flags=flags)
        if order is not None:
            back = []
            for r in run:
                out = torch.empty_like(r)
                out[order] = r
                back.append(out)
            run = back
        aggs = []
        for i, (nm, _arg, _ot) in enumerate(self.sites):
            j = self._site_col[i]
            if nm == "count":
                a = run[at[("sum", None)]]
            elif nm == "avg":
                a = run[at[("sum", j)]].to(self.fdt) / torch.clamp(
                    run[at[("sum", None)]].to(self.fdt), min=1)
            else:
                a = run[at[(nm, j)]]
            aggs.append(cast_to(a, self._agg_dtype(i)))
        new = {"ts": all_ts[k:k + C].clone(), "valid": pend[k:k + C].clone(),
               **extra}
        for c in self._carry_cols():
            new[f"c.{c}"] = cols_all[c][k:k + C].clone()
        for j, v in enumerate(vals_all):
            new[f"v.{j}"] = v[k:k + C].clone()
        overflow = pend.sum() > C if self.kind == "externaltimebatch" \
            else torch.zeros((), dtype=torch.bool, device=dev)
        cols = [cols_all[c] if c in cols_all else all_ts
                for c in self._sel_keys]
        return self._select(new, overflow, cols + aggs + [emit], N, all_ts)

    def _select(self, new: dict, overflow, cols: list, m: int, ts):
        """K1 window_select over m rows (selector + row mask), then K8
        compacts the rows that emit."""
        words, outs = self._kernel("expr_eval", cols, self._row_prog,
                                   self._out_progs, m, use="window_select")
        if words is not None:
            packed, cnt = self._kernel("win_compact", [ts] + outs,
                                       [0] * (1 + len(outs)), m, m, words)
            ts, outs = packed[0], packed[1:]
        else:
            cnt = torch.tensor([m], dtype=torch.int32)
        return {"state": new, "overflow": overflow, "ts": ts, "outs": outs,
                "rows": cnt}

    # -- rows -----------------------------------------------------------------

    def _materialize(self, res: dict) -> list:
        n = int(res["rows"][0])
        if n == 0:
            return []
        ts = res["ts"][:n].cpu().numpy().astype(TIMESTAMP_DTYPE)
        cols = {}
        for a, o in zip(self.out_schema.attributes, res["outs"]):
            cols[a.name] = o[:n].cpu().numpy().astype(dtype_of(a.type))
        ts, cols = self._order_limit(ts, cols)
        out = EventBatch(self.out_schema, ts, cols, len(ts))
        return [OutputBatch(self.output_target, out)]

    def _order_limit(self, ts_out, cols):
        """order by / offset / limit over one output chunk on the host
        (window_device.py:1046-1076: a stable multi-key sort by rank)."""
        if not (self._order_by or self.limit is not None or self.offset):
            return ts_out, cols
        order = np.arange(len(ts_out))
        for ob in reversed(self._order_by):
            col = cols[ob.var.attribute]
            if self.out_schema.type_of(ob.var.attribute) == AttrType.STRING \
                    and col.dtype.kind in "iu":
                dec = self.rt.strings._to_str
                col = np.array([dec[c] if 0 <= c < len(dec) else ""
                                for c in col.tolist()])
            _u, ranks = np.unique(col, return_inverse=True)
            k = ranks[order].astype(np.int64)
            if ob.order == ast.OrderDir.DESC:
                k = -k
            order = order[np.argsort(k, kind="stable")]
        ts_out = ts_out[order]
        cols = {k2: v[order] for k2, v in cols.items()}
        off = self.offset or 0
        if off:
            ts_out = ts_out[off:]
            cols = {k2: v[off:] for k2, v in cols.items()}
        if self.limit is not None:
            ts_out = ts_out[:self.limit]
            cols = {k2: v[:self.limit] for k2, v in cols.items()}
        return ts_out, cols

    # -- state in and out -----------------------------------------------------

    def device_metrics(self) -> dict:
        fill = int(self.state["valid"].sum())
        return {"window_capacity": int(self.C), "window_fill": fill,
                "window_fill_ratio": round(fill / max(self.C, 1), 4)}

    def state_dict(self) -> dict:
        return {"state": {k: v.cpu().numpy().copy()
                          for k, v in self.state.items()}, "C": self.C}

    def load_state_dict(self, d: dict) -> None:
        """Load a state_dict() of this plan, or a JAX plan's turned into
        tensors (`weights.window_state_from_jax`): its carry holds the
        arguments' columns, from which the values `v.<j>` are computed."""
        self.C = int(d.get("C", self.C))
        src = {k: torch.as_tensor(v).to(self.device)
               for k, v in d["state"].items()}
        st = self._init_state()
        for key in st:
            if key in src:
                st[key] = src[key].to(st[key].dtype).clone()
        env = {k[2:]: v for k, v in src.items() if k.startswith("c.")}
        env["__timestamp__"] = src["ts"]
        for j, (node, dt) in enumerate(self._vcols):
            if f"v.{j}" in src:
                continue
            tgt = AttrType.LONG if dt == torch.int64 else AttrType.DOUBLE
            with compute_dtypes(self._mode):
                v = eval_node(Node("cast", tgt, (node,)), env)
            st[f"v.{j}"] = v.expand(self.C).to(dt).clone()
        self.state = st
