"""Device pattern/sequence query plan -- host wrapper around NFAKernel.

Port of `siddhi_tpu/core/pattern_plan.py` (`DevicePatternPlan`, family
`seq` only).  Buffers per-stream micro-batches, merges them by global
arrival seq, buckets events into dense (T, P) blocks (one event per
partition per step, T a power of two up to T_CAP), runs one block per
chunk (K1 pre-masks, K2, K1 selector/having), and compacts the matches
into an output EventBatch sorted by (completion seq, head seq).

Timestamps and seqs travel as i32 offsets from per-plan bases; the plan
rebases the slot state before offsets can overflow.  Partition growth
doubles P as keys arrive; slot exhaustion doubles A up to A_CAP
(`@app:deviceSlotCap`) and re-runs from the pre-block state; a match
buffer overflow re-runs the block with a bigger M.  Both retries are exact
because a block never updates its input state.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..query import ast
from .batch import EventBatch
from .expr import ExprError, MultiStreamContext, compile_expression
from .nfa_device import (LOCAL_SPAN, ChainSpec, DeviceNFAUnsupported,
                         NFAKernel, lower_chain, pow2_at_least)
from .planner import (OutputBatch, QueryPlan, selector_has_aggregators)
from .schema import TIMESTAMP_DTYPE, StreamSchema, dtype_of

_I32 = np.int32


def _m_bucket(n: int) -> int:
    """Match-buffer capacity bucket: pow2 up to 16K, then 16K multiples."""
    if n <= 16384:
        return pow2_at_least(n, lo=16)
    return -(-n // 16384) * 16384


class DevicePatternPlan(QueryPlan):
    """from [every] e1=A[...] -> e2=B[...] within T -- batched device NFA."""

    A_CAP = 512      # default adaptive slot-growth ceiling (@app:deviceSlotCap)

    def __init__(self, name: str, rt, q: ast.Query, state_input,
                 target: Optional[str], partitions: int = 1,
                 part_key_fns: Optional[dict] = None, slots: int = 16):
        from ..interp.nfa import collect_filters
        self.name = name
        self.rt = rt
        self.device = rt.device
        cap = ast.find_annotation(rt.app.annotations, "app:deviceSlotCap")
        if cap is not None:
            self.A_CAP = int(cap.element())
        prec = ast.find_annotation(rt.app.annotations, "app:devicePrecision")
        if prec is not None and str(prec.element()).lower() == "f64":
            raise DeviceNFAUnsupported(
                "@app:devicePrecision('f64') is a later slice")
        fam = ast.find_annotation(rt.app.annotations, "app:patternFamily")
        if fam is not None and str(fam.element()).lower() not in ("seq",
                                                                   "auto"):
            raise DeviceNFAUnsupported(
                f"pattern family {fam.element()!r} is a later slice (this "
                f"port runs the sequential `seq` family)")
        self.output_target = target
        self.events_for = getattr(q.output, "events_for",
                                  ast.OutputEventsFor.CURRENT)
        if q.rate is not None:
            raise DeviceNFAUnsupported("output rate limiting")
        if q.selector.group_by or q.selector.order_by \
                or selector_has_aggregators(q.selector):
            raise DeviceNFAUnsupported("group-by/order-by/aggregating selector")
        self.limit, self.offset = q.selector.limit, q.selector.offset

        self.spec: ChainSpec = lower_chain(
            state_input, rt.schemas, rt.strings,
            collect_filters(state_input.state))
        self.input_streams = tuple(self.spec.stream_ids)
        self.P = partitions
        self.part_key_fns = part_key_fns        # stream_id -> fn(batch)->keys
        self._key_to_part: dict = {}

        sel = q.selector
        sctx = MultiStreamContext(self.spec.schemas, rt.strings)
        names, types, fns = [], [], []
        try:
            if sel.select_all:
                seen = set()
                for nd in self.spec.all_nodes:
                    for a in self.spec.schemas[nd.ref].attributes:
                        nm = a.name if a.name not in seen \
                            else f"{nd.ref}_{a.name}"
                        seen.add(nm)
                        fns.append(compile_expression(
                            ast.Variable(a.name, stream_ref=nd.ref), sctx))
                        names.append(nm)
            else:
                for oa in sel.attributes:
                    fns.append(compile_expression(oa.expr, sctx))
                    names.append(oa.name)
            types = [ce.type for ce in fns]
            having = None
            if sel.having is not None:
                import copy
                hctx = copy.copy(sctx)
                hctx.extra = {n: (n, t) for n, t in zip(names, types)}
                having = compile_expression(sel.having, hctx)
        except ExprError as e:
            raise DeviceNFAUnsupported(f"selector/having: {e}") from None
        self._names, self._types = names, types
        self.out_schema = StreamSchema(target or f"#{name}", tuple(
            ast.Attribute(n, t) for n, t in zip(names, types)))
        self.kernel = NFAKernel(self.spec, dict(zip(names, fns)), having,
                                self.P, slots)
        self.state = self.kernel.init_state(self.device)
        self._ts_base: Optional[int] = None
        self._seq_base: Optional[int] = None
        self._m_hint = 16
        self._of_slots_seen = 0
        self._last_seq = 0
        self._buffered: list = []
        self._scode = {sid: i for i, sid in enumerate(self.spec.stream_ids)}
        self.blocks_run = 0

    @property
    def dropped(self) -> int:
        """Heads lost to slot exhaustion at the A_CAP ceiling."""
        return int(self.state["of_slots"].sum())

    def part_of(self, stream_id: str, batch: EventBatch) -> np.ndarray:
        """Partition index per event; grows the key map (host side).  New
        keys of one batch get lanes in sorted key order."""
        if self.part_key_fns is None:
            return np.zeros(batch.n, dtype=_I32)
        keys = self.part_key_fns[stream_id](batch)
        uniq, inv = np.unique(keys, return_inverse=True)
        k2p = self._key_to_part
        parts_u = np.empty(len(uniq), dtype=_I32)
        for j, k in enumerate(uniq.tolist()):
            p = k2p.get(k)
            if p is None:
                if len(k2p) >= self.P:
                    self._resize(2 * self.P, self.kernel.A)
                p = k2p[k] = len(k2p)
            parts_u[j] = p
        return parts_u[inv]

    def _resize(self, P: int, A: int) -> None:
        """Pad the partition (last) and slot axes with fresh state (the
        JAX package's `_grow` and `_grow_slots`)."""
        kern = self.kernel.with_shape(P, A)
        fresh = kern.init_state(self.device)
        old = self.state
        new = {}
        for k, f in fresh.items():
            o = old[k]
            if o.dim() == 1:
                f[:o.shape[0]] = o
            elif o.dim() == 2:
                f[:o.shape[0], :o.shape[1]] = o
            else:
                f[:, :o.shape[1], :o.shape[2]] = o
            new[k] = f
        self.state, self.kernel, self.P = new, kern, P

    def _rebase(self, min_ts: int, min_seq: int) -> None:
        """Shift the ts/seq bases forward and the slot offsets with them;
        ancient slots clamp to -LOCAL_SPAN (`within` then expires them)."""
        st = dict(self.state)
        if self._ts_base is not None and min_ts > self._ts_base:
            d = min_ts - self._ts_base
            ft = st["first_ts"]
            st["first_ts"] = torch.where(
                ft == LOCAL_SPAN, ft,
                torch.clamp(ft.to(torch.int64) - d, min=-LOCAL_SPAN
                            ).to(torch.int32))
            self._ts_base = min_ts
        if self._seq_base is not None and min_seq > self._seq_base:
            d = min_seq - self._seq_base
            st["head_seq"] = torch.clamp(
                st["head_seq"].to(torch.int64) - d, min=-LOCAL_SPAN
            ).to(torch.int32)
            self._seq_base = min_seq
        self.state = st

    # -- QueryPlan interface ---------------------------------------------

    def process(self, stream_id: str, batch: EventBatch) -> list:
        if batch.n:
            self._buffered.append((stream_id, batch))
        return []

    def finalize(self) -> list:
        return self._rows_to_batches(self._finalize_chunks())

    def _finalize_chunks(self) -> list:
        if not self._buffered:
            return []
        bufs, self._buffered = self._buffered, []
        N = sum(b.n for _s, b in bufs)
        ts = np.empty(N, dtype=np.int64)
        seq = np.empty(N, dtype=np.int64)
        scode = np.empty(N, dtype=_I32)
        part = np.empty(N, dtype=_I32)
        cols: dict = {}
        for si, attr, t in self.kernel.grid_attrs:
            cols[f"{si}.{attr}"] = np.zeros(N, dtype=NFAKernel.np_dtype(t))
        o = 0
        for sid, b in bufs:
            si = self._scode[sid]
            sl = slice(o, o + b.n)
            ts[sl] = b.timestamps
            seq[sl] = b.seqs
            scode[sl] = si
            part[sl] = self.part_of(sid, b)
            for sj, attr, _t in self.kernel.grid_attrs:
                if sj == si:
                    cols[f"{si}.{attr}"][sl] = b.columns[attr]
            o += b.n
        order = np.lexsort((seq,))
        ts, seq, scode, part = ts[order], seq[order], scode[order], part[order]
        cols = {k: v[order] for k, v in cols.items()}
        by_part = np.lexsort((seq, part))
        idx_within = np.empty(N, dtype=np.int64)
        sp = part[by_part]
        chg = np.r_[True, sp[1:] != sp[:-1]]
        run_start = np.flatnonzero(chg)
        run_id = np.cumsum(chg) - 1
        idx_within[by_part] = np.arange(N) - run_start[run_id]

        # i32 offset bases chosen from the flush MAX (headroom restored even
        # when a stale event pins the minimum; older events clamp low)
        budget = LOCAL_SPAN - (1 << 16)
        if self._ts_base is None:
            self._ts_base = max(int(ts.min()), int(ts.max()) - budget)
            self._seq_base = max(int(seq.min()), int(seq.max()) - budget)
        if int(ts.max()) - self._ts_base >= budget \
                or int(seq.max()) - self._seq_base >= budget:
            self._rebase(max(int(ts.min()), int(ts.max()) - budget),
                         max(int(seq.min()), int(seq.max()) - budget))
        ts32 = np.clip(ts - self._ts_base, -LOCAL_SPAN, LOCAL_SPAN).astype(_I32)
        seq32 = np.clip(seq - self._seq_base, -LOCAL_SPAN,
                        LOCAL_SPAN).astype(_I32)
        self._last_seq = max(self._last_seq, int(seq.max()))

        T_CAP = min(8192, max(512, (1 << 19) // max(self.P, 1)))
        multi = len(self.spec.stream_ids) > 1
        chunk_evs: list = []
        for c in range(int(idx_within.max()) // T_CAP + 1):
            m = (idx_within >= c * T_CAP) & (idx_within < (c + 1) * T_CAP)
            if not m.any():
                continue
            t_local = idx_within[m] - c * T_CAP
            T = pow2_at_least(int(t_local.max()) + 1)
            chunk_evs.append((self._grid(T, t_local, part[m], ts32[m],
                                         seq32[m], scode[m] if multi else None,
                                         {k: v[m] for k, v in cols.items()}),
                              T))
        return self._run_chunks(chunk_evs)

    def _grid(self, T: int, t_local, pm, ts32, seq32, scode, cols) -> dict:
        """Dense (T, P) block on the plan's device."""
        P = self.P

        def g(vals, dtype, fill=0):
            a = np.full((T, P), fill, dtype=dtype)
            a[t_local, pm] = vals
            return torch.from_numpy(a).to(self.device)
        ev = {"__ts__": g(ts32, _I32), "__seq__": g(seq32, _I32),
              "__valid__": g(True, bool)}
        if scode is not None:
            ev["__scode__"] = g(scode, _I32, -1)
        for k, v in cols.items():
            ev[k] = g(v, v.dtype)
        ev["__base_ts__"] = int(self._ts_base)
        return ev

    def _run_chunks(self, chunk_evs: list) -> list:
        """Run blocks in order; an M overflow re-runs the block from its
        pre-state with a bigger buffer, slot exhaustion grows A and
        restarts from the exhausted block (dropped heads change all the
        state downstream)."""
        results: list = []
        i = 0
        while i < len(chunk_evs):
            ev, T = chunk_evs[i]
            M = max(self._m_hint, _m_bucket(2 * T))
            pre = self.state
            while True:
                st, out = self.kernel.run_block(pre, ev, M)
                self.blocks_run += 1
                n, ofs = (int(v) for v in out["meta"].cpu())
                if n <= M:
                    break
                M = _m_bucket(n)
            self._m_hint = max(self._m_hint, M)
            if ofs > self._of_slots_seen and self.kernel.A < self.A_CAP:
                self._resize(self.P, min(2 * self.kernel.A, self.A_CAP))
                continue            # re-run this block from `pre`, wider
            if ofs > self._of_slots_seen:
                warnings.warn(
                    f"pattern {self.name!r}: pending-match slots hit the "
                    f"deviceSlotCap ceiling ({self.A_CAP}); {ofs} partial "
                    f"matches dropped so far (raise @app:deviceSlotCap)",
                    RuntimeWarning, stacklevel=2)
                self._of_slots_seen = ofs
            self.state = st
            results.append(self._unpack(out, n))
            i += 1
        return results

    def _unpack(self, out: dict, n: int):
        """Columnar match table (tss, seqs, hseqs, data) of one block."""
        if n == 0:
            return None
        words, sel = self.kernel.select(out, n, self._ts_base)
        k = self.kernel
        oi = out["out_i"][:, :n].cpu().numpy()
        valid = np.ones(n, dtype=bool)
        if words is not None:
            from ..kernels.expr_eval import unpack_mask
            valid = unpack_mask(words.cpu(), n).numpy()
            if not valid.any():
                return None
        row = {nm: oi[i] for i, nm in enumerate(k.lane_names_i)}
        tss = row["__comp_ts__"][valid].astype(np.int64) + self._ts_base
        seqs = row["__comp_seq__"][valid].astype(np.int64) + self._seq_base
        hseqs = row["__head_seq__"][valid]
        data = {nm: s.cpu().numpy()[valid].astype(dtype_of(t))
                for nm, t, s in zip(self._names, self._types, sel)}
        return tss, seqs, hseqs, data

    def _rows_to_batches(self, chunks: list) -> list:
        chunks = [c for c in chunks if c is not None]
        if not chunks or self.events_for == ast.OutputEventsFor.EXPIRED:
            return []
        tss = np.concatenate([c[0] for c in chunks])
        seqs = np.concatenate([c[1] for c in chunks])
        hseqs = np.concatenate([c[2] for c in chunks])
        data = {nm: np.concatenate([c[3][nm] for c in chunks])
                for nm in self._names}
        # emit in completion order; same-event ties by head arrival
        o = np.lexsort((hseqs, seqs))
        if self.offset:
            o = o[self.offset:]
        if self.limit is not None:
            o = o[:self.limit]
        if not len(o):
            return []
        batch = EventBatch(self.out_schema, tss[o].astype(TIMESTAMP_DTYPE),
                           {nm: data[nm][o] for nm in self._names}, len(o),
                           seqs[o])
        return [OutputBatch(self.output_target, batch)]

    # -- snapshot ------------------------------------------------------------

    def state_dict(self) -> dict:
        return {"state": {k: v.cpu() for k, v in self.state.items()},
                "key_to_part": dict(self._key_to_part),
                "ts_base": self._ts_base, "seq_base": self._seq_base,
                "last_seq": self._last_seq}

    def load_state_dict(self, d: dict) -> None:
        """Restore from `state_dict()`; `d["state"]` may also come from
        `weights.nfa_state_from_jax` (the JAX plan's slot state)."""
        st = {k: torch.as_tensor(v).to(self.device)
              for k, v in d["state"].items()}
        a, p = st["occ"].shape
        if p != self.P or a != self.kernel.A:
            self.kernel = self.kernel.with_shape(p, a)
            self.P = p
        missing = set(self.kernel.init_state("cpu")) - set(st)
        if missing:
            raise ValueError(f"pattern state lacks {sorted(missing)}")
        self.state = st
        self._key_to_part = dict(d["key_to_part"])
        self._ts_base = d.get("ts_base")
        self._seq_base = d.get("seq_base")
        self._last_seq = int(d.get("last_seq") or self._seq_base or 0)
        self._of_slots_seen = int(st["of_slots"].sum())
