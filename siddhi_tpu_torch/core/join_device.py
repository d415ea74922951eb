"""Device window-join plan: each flush probes the opposite window on the card.

Port of `siddhi_tpu/core/join_device.py` (`DeviceJoinPlan`).  Reference
semantics (core:query/input/stream/join/JoinProcessor.java:62-126): each
arriving event, after its side's filters, probes the OPPOSITE side's
current window content with the `on` condition and emits one joined
event per match, in arrival order; outer joins emit null-filled rows for
probes with no match; `unidirectional` restricts which side triggers.

One flush (the events both sides buffered since the last one, each side
sorted by arrival seq) runs:
  * K1 `expr_eval`, use `join_filter`: each filtered side's filters as
    one mask over its batch rows, ballot words in `bits32`'s layout;
  * K9 `join_probe` once per triggering direction (left probes the right
    window, right probes the left): window visibility by rank arithmetic
    (an opposite event at window position p is visible to probe a iff
    nlt(a) - M <= p < nlt(a), nlt(a) the opposite arrivals before a), the
    `on` program over the visible pairs, the pairs compacted into M
    slots, the computed selector columns over them, an outer side's miss
    words;
  * one pull of everything (`_pull`), then, when a direction's pair
    total exceeds M, both directions again at M = pow2(total, 32) (K9
    writes fresh outputs, so a retry is a plain re-launch), exactly as
    the JAX package re-dispatches its block.
The window contents are mirrored on the host (at most the window length
per side): the mirror is both the upload for the next flush and the
source of the pass-through outputs, which gather on the host at full
precision (DOUBLE computes in f32 on the card, as in the JAX package), so
the plan keeps no device state (state = the mirrors).

Supported: stream-stream joins whose sides are windowless or carry
#window.length(N), any `on`/filters/projection the VM compiles,
inner/left/right/full outer, unidirectional.  Everything else raises
DeviceJoinUnsupported with the JAX package's reason; core/build.py turns
it into PlanError, since the host join interpreter the JAX package
demotes such shapes to is a later slice.  Not ported: the dispatch
pipeline's depth (core/pipeline.py; the port runs depth 0, and rows are
the same at any depth), telemetry, fault injection and placement
records.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.expr_eval import expr_eval
from ..kernels.join_probe import join_probe
from ..kernels.join_probe import prepare as prepare_probe
from ..query import ast
from .batch import EventBatch
from .expr import (VT_OF_TORCH, ExprError, F32_MODE, MultiStreamContext,
                   Node, SingleStreamContext, compile_expression,
                   compute_dtypes, emit_program, torch_dtype)
from .nfa_device import pow2_at_least as pow2
from .planner import (OutputBatch, PlanError, QueryPlan,
                      selector_has_aggregators, tree_reads)
from .schema import TIMESTAMP_DTYPE, StreamSchema, dtype_of

KERNELS = {"expr_eval": expr_eval, "join_probe": join_probe}
MISS_POS = 1 << 60          # a miss row sorts after its probe's pairs


class DeviceJoinUnsupported(Exception):
    """Join shape needs the host interpreter (a later slice)."""


class _Side:
    """One join side: schema, length window, compiled filters, mirror."""

    def __init__(self, inp: ast.SingleInputStream, rt):
        if inp.stream_id in getattr(rt, "tables", {}) or \
                inp.stream_id in getattr(rt, "aggregations", {}) or \
                inp.stream_id in getattr(rt, "named_windows", {}):
            raise DeviceJoinUnsupported("table/aggregation/named-window side")
        if inp.stream_id not in rt.schemas:
            raise PlanError(f"join: unknown stream {inp.stream_id!r}")
        self.ref = inp.alias
        self.stream_id = inp.stream_id
        self.schema = rt.schemas[inp.stream_id]
        for h in inp.handlers:
            if isinstance(h, ast.StreamFunction):
                raise DeviceJoinUnsupported("stream function on join side")
        self.win_len = 0                   # 0 = windowless (retains nothing)
        if inp.window is not None:
            w = inp.window
            if w.namespace is not None or w.name.lower() != "length":
                raise DeviceJoinUnsupported(f"window {w.name!r} on join side")
            if len(w.args) != 1 or not isinstance(w.args[0], ast.Constant):
                raise DeviceJoinUnsupported("non-constant window length")
            self.win_len = int(w.args[0].value)
            if self.win_len <= 0 or self.win_len > (1 << 16):
                raise DeviceJoinUnsupported("window length out of range")
        ctx = SingleStreamContext(self.schema, rt.strings, alias=self.ref)
        try:
            self.filters = [compile_expression(f.expr, ctx)
                            for f in inp.filters]
        except ExprError as e:
            raise DeviceJoinUnsupported(f"filter: {e}")
        for ce in self.filters:
            if ce.type != ast.AttrType.BOOL:
                raise DeviceJoinUnsupported("non-boolean side filter")
        self.filter_prog = None
        self.filter_keys: list = []
        if self.filters:
            tree = self.filters[0].node
            for ce in self.filters[1:]:
                tree = Node("and", ast.AttrType.BOOL, (tree, ce.node))
            # the row count rides on the timestamp column
            self.filter_keys = sorted(tree_reads(tree) | {"__timestamp__"})
            with compute_dtypes(F32_MODE):
                slots = {k: (i, VT_OF_TORCH[self.device_dtype(k)])
                         for i, k in enumerate(self.filter_keys)}
                try:
                    self.filter_prog = emit_program(tree, slots)
                except ExprError as e:
                    raise DeviceJoinUnsupported(f"filter: {e}")
        # host mirror of the window content, oldest first, columnar
        self.mirror_cols = {a.name: np.empty(0, dtype=dtype_of(a.type))
                            for a in self.schema.attributes}
        self.mirror_ts = np.empty(0, dtype=np.int64)
        self.mirror_seq = np.empty(0, dtype=np.int64)

    def device_dtype(self, attr: str) -> torch.dtype:
        """A column's dtype on the card (DOUBLE as f32, timestamps i64)."""
        if attr == "__timestamp__":
            return torch.int64
        with compute_dtypes(F32_MODE):
            return torch_dtype(self.schema.type_of(attr))

    @property
    def mirror_n(self) -> int:
        return len(self.mirror_ts)

    def update_mirror(self, batch_cols, batch_ts, batch_seq, passed) -> None:
        if self.win_len == 0:
            return
        for k in self.mirror_cols:
            self.mirror_cols[k] = np.concatenate(
                [self.mirror_cols[k], batch_cols[k][passed]])[-self.win_len:]
        self.mirror_ts = np.concatenate(
            [self.mirror_ts, batch_ts[passed]])[-self.win_len:]
        self.mirror_seq = np.concatenate(
            [self.mirror_seq, batch_seq[passed]])[-self.win_len:]

    def state(self) -> dict:
        return {"cols": {k: v.copy() for k, v in self.mirror_cols.items()},
                "ts": self.mirror_ts.copy(), "seq": self.mirror_seq.copy()}

    def restore(self, st: dict) -> None:
        self.mirror_cols = {k: np.asarray(v) for k, v in st["cols"].items()}
        self.mirror_ts = np.asarray(st["ts"], dtype=np.int64)
        self.mirror_seq = np.asarray(st["seq"], dtype=np.int64)


class _Direction:
    """One probing direction's K9 programs: `probe` probes `other`'s
    window; slot i < len(p_keys) loads the probe's column p_keys[i]
    ("ref.attr" or "__timestamp__"), slot len(p_keys) + j the opposite
    column o_keys[j]."""

    def __init__(self, key: str, probe: _Side, other: _Side, on, outs: list):
        self.key, self.probe, self.other = key, probe, other
        trees = ([on.node] if on is not None else []) + \
            [ce.node for ce in outs]
        reads = set().union(*[tree_reads(t) for t in trees]) if trees \
            else set()
        pre = f"{probe.ref}."
        self.p_keys = sorted(k for k in reads if k == "__timestamp__" or
                             k.startswith(pre))
        self.o_keys = sorted(k for k in reads if k not in self.p_keys)
        bad = [k for k in self.o_keys if not k.startswith(f"{other.ref}.")]
        if bad:
            raise ExprError(f"no join column for {bad}")
        slots = {}
        for i, k in enumerate(self.p_keys):
            attr = k if k == "__timestamp__" else k[len(pre):]
            slots[k] = (i, VT_OF_TORCH[probe.device_dtype(attr)])
        for j, k in enumerate(self.o_keys):
            attr = k.split(".", 1)[1]
            slots[k] = (len(self.p_keys) + j,
                        VT_OF_TORCH[other.device_dtype(attr)])
        with compute_dtypes(F32_MODE):
            self.on = emit_program(on.node, slots) if on is not None \
                else None
            self.outs = [emit_program(ce.node, slots) for ce in outs]


class DeviceJoinPlan(QueryPlan):
    """`from A#window.length(N) as a join B#window.length(M) as b
    on <cond> select ... insert into O` on K1 and K9."""

    record: Optional[list] = None   # (name, args, kwargs) of kernel calls

    def __init__(self, name: str, rt, q: ast.Query,
                 inp: ast.JoinInputStream, target: Optional[str]):
        self.name = name
        self.rt = rt
        self.device = rt.device
        self.output_target = target
        self.events_for = getattr(q.output, "events_for",
                                  ast.OutputEventsFor.CURRENT)
        if q.rate is not None:
            raise DeviceJoinUnsupported("output rate limiting")
        sel = q.selector
        if sel.group_by or sel.order_by or sel.having is not None \
                or selector_has_aggregators(sel):
            raise DeviceJoinUnsupported("group-by/order-by/having selector")
        if inp.per is not None or inp.within is not None:
            raise DeviceJoinUnsupported("within/per (aggregation join)")
        if sel.limit is not None or sel.offset:
            raise DeviceJoinUnsupported("limit/offset")

        self.left = _Side(inp.left, rt)
        self.right = _Side(inp.right, rt)
        if self.left.ref == self.right.ref:
            raise PlanError(f"join {name!r}: both sides named "
                            f"{self.left.ref!r}; alias one with `as`")
        self.join_type = inp.join_type
        self.trigger = inp.trigger          # "all" | "left" | "right"

        schemas = {self.left.ref: self.left.schema,
                   self.right.ref: self.right.schema}
        ctx = MultiStreamContext(schemas, rt.strings)
        on = None
        if inp.on is not None:
            try:
                on = compile_expression(inp.on, ctx)
            except ExprError as e:
                raise DeviceJoinUnsupported(f"on: {e}")
            if on.type != ast.AttrType.BOOL:
                raise DeviceJoinUnsupported("non-boolean on condition")

        # selector: pass-through outputs gather host-side; computed ones
        # evaluate on the card over the matched pairs
        from ..interp.joins import _join_selector
        sel = _join_selector(sel, self)
        names, types, fns, passthrough = [], [], [], []
        for oa in sel.attributes:
            try:
                ce = compile_expression(oa.expr, ctx)
            except ExprError as e:
                raise DeviceJoinUnsupported(f"selector: {e}")
            names.append(oa.name)
            types.append(ce.type)
            fns.append(ce)
            passthrough.append(next(iter(ce.reads)) if ce.is_var else None)
        self._names, self._types = names, types
        self._passthrough = passthrough
        self.out_schema = StreamSchema(target or f"#{name}", tuple(
            ast.Attribute(n, t) for n, t in zip(names, types)))
        # miss rows (outer joins): evaluated by host closures (null side)
        self._py_sel = None
        if any(pt is None for pt in passthrough) and self._any_outer():
            from ..interp.expr import PyExprContext, compile_py
            pctx = PyExprContext(schemas)
            try:
                self._py_sel = [compile_py(oa.expr, pctx)[0]
                                for oa in sel.attributes]
            except Exception:
                raise DeviceJoinUnsupported(
                    "outer-join selector not host-evaluable for miss rows")
        computed = [ce for ce, pt in zip(fns, passthrough) if pt is None]
        # the probing directions' programs, built now so that whatever
        # the VM cannot run fails at plan time
        try:
            self._dirs = [
                _Direction(k, p, o, on, computed)
                for k, p, o, trig in (("L", self.left, self.right, "left"),
                                      ("R", self.right, self.left, "right"))
                if self.trigger in ("all", trig)]
        except ExprError as e:
            raise DeviceJoinUnsupported(f"selector: {e}")
        self.input_streams = tuple(dict.fromkeys((self.left.stream_id,
                                                  self.right.stream_id)))
        self._buffered: list = []
        self._m_hint = 16
        # K9 calls per probing side ("L": left probes the right window),
        # an overflow's re-launch included
        self.probe_calls = {"L": 0, "R": 0}
        # the parameter block of each recorded K9 launch on the card, in
        # call order (`launched`, `tp`, `chunk`: what it ran)
        self.probe_params: list = []

    def _any_outer(self) -> bool:
        return self.join_type in (ast.JoinType.LEFT_OUTER,
                                  ast.JoinType.RIGHT_OUTER,
                                  ast.JoinType.FULL_OUTER)

    def _outer_for(self, side_name: str) -> bool:
        return (self.join_type == ast.JoinType.FULL_OUTER
                or (self.join_type == ast.JoinType.LEFT_OUTER
                    and side_name == "left")
                or (self.join_type == ast.JoinType.RIGHT_OUTER
                    and side_name == "right"))

    # -- QueryPlan interface ---------------------------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        if batch.n:
            self._buffered.append((stream_id, batch))
        return []

    def _side_arrays(self, side: _Side, bufs):
        """Concatenate this side's buffered batches into (T,) arrays in
        arrival (seq) order."""
        mine = [b for sid, b in bufs if sid == side.stream_id]
        n = sum(b.n for b in mine)
        cols = {}
        for a in side.schema.attributes:
            # ORIGINAL dtype: pass-through outputs gather from these
            # host-side at full precision; the upload downcasts its own
            # copies (f32 DOUBLE policy)
            col = np.empty(n, dtype=dtype_of(a.type))
            o = 0
            for b in mine:
                col[o:o + b.n] = b.columns[a.name]
                o += b.n
            cols[a.name] = col
        ts = np.concatenate([b.timestamps for b in mine]) if mine \
            else np.empty(0, np.int64)
        seq = np.concatenate(
            [b.seqs if b.seqs is not None else np.arange(b.n)
             for b in mine]) if mine else np.empty(0, np.int64)
        order = np.argsort(seq, kind="stable")
        return ({k: v[order] for k, v in cols.items()}, ts[order],
                seq[order], n)

    def finalize(self) -> list:
        """Run the buffered flush.  A failure before the mirrors advance
        restores the buffer (the flush may be retried); once they advance
        the flush is past its point of no return and nothing is restored."""
        if not self._buffered:
            return []
        snapshot = list(self._buffered)
        self._finalize_retry_ok = True
        try:
            return self._finalize_impl()
        except Exception:
            if self._finalize_retry_ok:
                self._buffered = snapshot
            raise

    def _kernel(self, name: str, *a, **kw):
        """Every kernel call of a flush (recorded when `record` is set;
        a recorded K9 launch on the card keeps its parameter block in
        `probe_params`)."""
        if self.record is None:
            return KERNELS[name](*a, **kw)
        self.record.append((name, a, kw))
        if name != "join_probe" or a[2].device.type == "cpu":
            return KERNELS[name](*a, **kw)
        launch = prepare_probe(*a, **kw)
        out = launch()
        self.probe_params.append(launch.params)
        return out

    def _upload(self, side: _Side, cols: dict, ts, seq, n: int) -> dict:
        """One side's batch and mirror on the card, DOUBLE as f32."""
        dev = self.device
        NO = max(side.win_len, 1)
        ev = {"n": n, "Lo": side.mirror_n, "NO": NO,
              "__timestamp__": torch.from_numpy(ts).to(dev),
              "__seq__": torch.from_numpy(seq).to(dev)}
        for a in side.schema.attributes:
            dt = side.device_dtype(a.name)
            ev[a.name] = torch.from_numpy(cols[a.name]).to(dev, dt)
            mc = torch.zeros(NO, dtype=dt)
            mc[:side.mirror_n] = torch.from_numpy(
                side.mirror_cols[a.name]).to(dt)
            ev[f"m.{a.name}"] = mc.to(dev)
        return ev

    def _side_pass(self, side: _Side, ev: dict):
        """K1 `join_filter`: the side's filters as pass words, or None
        when every row passes."""
        if side.filter_prog is None or ev["n"] == 0:
            return None
        cols = [ev[k] for k in side.filter_keys]
        words, _ = self._kernel("expr_eval", cols, side.filter_prog, [],
                                ev["n"], use="join_filter")
        return words

    def _probe(self, d: _Direction, evs: dict, passes: dict, M: int):
        p, o = evs[d.key], evs["R" if d.key == "L" else "L"]
        self.probe_calls[d.key] += 1
        p_cols = [p[k if k == "__timestamp__" else k.split(".", 1)[1]]
                  for k in d.p_keys]
        o_cols = [(o[f"m.{a}"], o[a])
                  for a in (k.split(".", 1)[1] for k in d.o_keys)]
        return self._kernel(
            "join_probe", p_cols, o_cols, p["__seq__"], o["__seq__"],
            passes[d.key], passes["R" if d.key == "L" else "L"],
            n_p=p["n"], n_o=o["n"], Lo=o["Lo"], NO=o["NO"],
            Mw=d.other.win_len, on=d.on, outs=d.outs, M=M,
            outer=self._outer_for("left" if d.key == "L" else "right"))

    def _pull(self, passes: dict, res: dict, ns: dict) -> dict:
        """Every result of the flush in ONE device-to-host copy: the pair
        totals, pass words, pairs, miss words and computed columns packed
        into one int32 vector, unpacked here as numpy arrays."""
        parts, layout = [], []

        def put(key, t):
            if t is None:
                return
            v = t.reshape(-1)
            if v.dtype == torch.bool:
                v = v.to(torch.int32)
            iv = v.view(torch.int32)
            layout.append((key, v.dtype, iv.numel()))
            parts.append(iv)
        for k in ("L", "R"):
            put(("pass", k), passes[k])
        for k, (total, pa, pb, outs, miss) in res.items():
            put(("total", k), total)
            put(("pa", k), pa)
            put(("pb", k), pb)
            put(("miss", k), miss)
            for j, o in enumerate(outs):
                put(("out", k, j), o)
        host = torch.cat(parts).cpu().numpy() if parts else \
            np.empty(0, np.int32)
        out, at = {}, 0
        for key, dt, n in layout:
            v = host[at:at + n]
            at += n
            if dt == torch.int64:
                v = v.view(np.int64)
            elif dt == torch.float32:
                v = v.view(np.float32)
            out[key] = v
        for k in ("L", "R"):
            w = out.pop(("pass", k), None)
            out[("pass", k)] = np.ones(ns[k], bool) if w is None else \
                _unbits(w, ns[k])
        return out

    def _finalize_impl(self) -> list:
        bufs, self._buffered = self._buffered, []
        lc, lts, lseq, ln = self._side_arrays(self.left, bufs)
        rc, rts, rseq, rn = self._side_arrays(self.right, bufs)
        if ln == 0 and rn == 0:
            return []
        # the mirrors the probe sees: _assemble gathers from these
        snap = {key: ({k: v.copy() for k, v in s.mirror_cols.items()},
                      s.mirror_n)
                for key, s in (("L", self.left), ("R", self.right))}
        evs = {"L": self._upload(self.left, lc, lts, lseq, ln),
               "R": self._upload(self.right, rc, rts, rseq, rn)}
        passes = {"L": self._side_pass(self.left, evs["L"]),
                  "R": self._side_pass(self.right, evs["R"])}
        dirs = [d for d in self._dirs if evs[d.key]["n"]]
        M = max(self._m_hint, 16)
        while True:
            res = {d.key: self._probe(d, evs, passes, M) for d in dirs}
            host = self._pull(passes, res, {"L": ln, "R": rn})
            tot = {k: int(host[("total", k)][0]) for k in res}
            if max(tot.values(), default=0) <= M:
                break
            M = pow2(max(tot.values()), lo=32)
        self._m_hint = max(self._m_hint, M)
        pl, pr = host[("pass", "L")], host[("pass", "R")]
        self._finalize_retry_ok = False     # the mirrors advance now
        self.left.update_mirror(lc, lts, lseq, pl)
        self.right.update_mirror(rc, rts, rseq, pr)
        meta = dict(lc=lc, rc=rc, lts=lts, rts=rts, lseq=lseq, rseq=rseq,
                    ln=ln, rn=rn)
        return self._assemble(meta, snap, host, tot)

    def _assemble(self, me: dict, snap: dict, host: dict, tot: dict) -> list:
        """Merge pair and miss rows in the reference's arrival order
        (probe seq, left-probe-first, opposite position)."""
        if self.events_for == ast.OutputEventsFor.EXPIRED:
            return []
        names, types, passthrough = self._names, self._types, \
            self._passthrough
        segs = []       # (sort_seq, side_rank, pos, ts, row_cols, nulls)
        sides = {"L": (self.left, me["lc"], me["lts"], me["lseq"], me["ln"]),
                 "R": (self.right, me["rc"], me["rts"], me["rseq"], me["rn"])}

        def union_col(okey, name):
            side, cols, _ts, _seq, n = sides[okey]
            w = max(side.win_len, 1)
            u = np.zeros(w + n, dtype=dtype_of(side.schema.type_of(name)))
            mc, mn = snap[okey]
            u[:mn] = mc[name][:mn]
            u[w:w + n] = cols[name]
            return u

        for k, rank in (("L", 0), ("R", 1)):
            npairs = tot.get(k, 0)
            if npairs == 0:
                continue
            okey = "R" if k == "L" else "L"
            probe, p_cols, p_ts, p_seq, _n = sides[k]
            a = host[("pa", k)][:npairs]
            b = host[("pb", k)][:npairs]
            cols_out, j = {}, 0
            for nm, pt in zip(names, passthrough):
                if pt is None:
                    cols_out[nm] = host[("out", k, j)][:npairs]
                    j += 1
                    continue
                ref, attr = pt.split(".", 1)
                cols_out[nm] = p_cols[attr][a] if ref == probe.ref \
                    else union_col(okey, attr)[b]
            segs.append((p_seq[a], np.full(npairs, rank, np.int8),
                         b.astype(np.int64), p_ts[a], cols_out, None))

        for k, rank, other in (("L", 0, self.right), ("R", 1, self.left)):
            miss = host.get(("miss", k))
            if miss is None:
                continue
            probe, p_cols, p_ts, p_seq, n = sides[k]
            idx = np.flatnonzero(_unbits(miss, n))
            if idx.size:
                segs.append(self._miss_rows(probe, other, idx, p_cols, p_ts,
                                            p_seq, rank))
        if not segs:
            return []
        tot_rows = sum(len(s[0]) for s in segs)
        seq_all = np.concatenate([s[0] for s in segs])
        rank_all = np.concatenate([s[1] for s in segs])
        pos_all = np.concatenate([np.asarray(s[2], np.int64) for s in segs])
        ts_all = np.concatenate([s[3] for s in segs])
        order = np.lexsort((pos_all, rank_all, seq_all))
        cols, nulls_out = {}, {}
        for nm, t in zip(names, types):
            parts, nparts = [], []
            for s in segs:
                parts.append(np.asarray(s[4][nm]))
                nl = (s[5] or {}).get(nm)
                nparts.append(nl if nl is not None
                              else np.zeros(len(s[0]), bool))
            cols[nm] = np.concatenate(parts).astype(dtype_of(t))[order]
            nl = np.concatenate(nparts)[order]
            if nl.any():
                nulls_out[nm] = nl
        out = EventBatch(self.out_schema,
                         ts_all[order].astype(TIMESTAMP_DTYPE), cols,
                         tot_rows, nulls=nulls_out or None)
        return [OutputBatch(self.output_target, out)]

    def _miss_rows(self, probe: _Side, other: _Side, idx, p_cols, p_ts,
                   p_seq, rank: int) -> tuple:
        """An outer side's probes without a match: the other side NULL;
        computed outputs over it evaluate on the host (`_py_sel`)."""
        names, types, passthrough = self._names, self._types, \
            self._passthrough
        cols_out, nulls = {}, {}
        if all(pt is not None for pt in passthrough):
            for nm, t, pt in zip(names, types, passthrough):
                ref, attr = pt.split(".", 1)
                if ref == probe.ref:
                    cols_out[nm] = p_cols[attr][idx]
                else:
                    cols_out[nm] = np.zeros(idx.size, dtype=dtype_of(t))
                    nulls[nm] = np.ones(idx.size, bool)
        else:
            rows = []
            dec = self.rt.strings._to_str
            attrs = [(a.name, f"{probe.ref}.{a.name}",
                      a.type == ast.AttrType.STRING)
                     for a in probe.schema.attributes]
            nulls_env = {f"{other.ref}.{nm2}": None
                         for nm2 in other.schema.names}
            for i in idx:
                env = dict(nulls_env)
                for nm2, key, is_str in attrs:
                    v = p_cols[nm2][i]
                    if is_str:
                        c = int(v)
                        v = dec[c] if 0 <= c < len(dec) else None
                    elif isinstance(v, np.generic):
                        v = v.item()
                    env[key] = v
                    env[nm2] = v
                env["__timestamp__"] = int(p_ts[i])
                rows.append([f(env) for f in self._py_sel])
            for j, (nm, t) in enumerate(zip(names, types)):
                vals = [r[j] for r in rows]
                isnull = np.array([v is None for v in vals])
                filled = [0 if v is None else v for v in vals]
                if t == ast.AttrType.STRING:
                    enc = self.rt.strings.encode
                    filled = [v if isinstance(v, (int, np.integer))
                              else enc(v) for v in filled]
                cols_out[nm] = np.asarray(filled, dtype=dtype_of(t))
                if isnull.any():
                    nulls[nm] = isnull
        return (p_seq[idx], np.full(idx.size, rank, np.int8),
                np.full(idx.size, MISS_POS, np.int64), p_ts[idx], cols_out,
                nulls or None)

    # -- snapshot ---------------------------------------------------------

    def state_dict(self) -> dict:
        return {"left": self.left.state(), "right": self.right.state()}

    def load_state_dict(self, d: dict) -> None:
        self.left.restore(d["left"])
        self.right.restore(d["right"])


def _unbits(words: np.ndarray, n: int) -> np.ndarray:
    """int32 mask words -> (n,) bool, bit j of word w = row 32w + j."""
    b = ((words.view(np.uint32)[:, None]
          >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    return b.reshape(-1)[:n]
