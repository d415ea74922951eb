"""K5 `scan_compact`: dedup and compaction of one `scan` block.

Replaces the emission tail of `_block_impl` (siddhi_tpu/core/
nfa_parallel.py): the candidates of each head (one, or C for a final
count, :1009-1027), the dedup of replayed completions `seq[comp] >
prev_seq` per lane (:1031), the one-shot head's filter and resolution
flag (:1034-1053), the exclusive prefix count and scatter of candidates
into M match rows, c-major (:1056-1072), and the gathers of the captured
columns the selector reads (:1079-1137): single positions at the index
K4 resolved, logical sides at theirs, count captures by rank/select at
the match (:1097-1131: with q the occurrences collected by the match --
min + c for a final count, the rank at the completion less the base,
capped at max, elsewhere -- [last] is occurrence q, [last-1] q - 1 and
[i] i + 1, each present when q reaches it) and the presence rows (an
`or` side's win, a count's fill), all vmapped there over the lane axis.

Design (csrc/scan_compact.cu): the lanes are compacted into ONE match
table, lane-major, each lane's rows c-major and in head order (the JAX
cumsum's order over its (C, F) candidates), with the rows of the
NFAKernel's table (`lane_names_i`, `rows_f`, `rows_l`): captured columns,
presence rows, the completion's ts and seq offsets, the head's seq
offset.  The selector pass (K1) and the plan's unpack then read it as
they read the sequential kernel's. One kernel launch a call: blocks take
(lane, tile) tiles of 1024 candidates from a ticket, run the live test
once a candidate (a one-shot head's h0 from a look-back over the lane's
earlier tiles), take their first match slot from a decoupled look-back
over the earlier tiles' counts and write a warp's matches row by row;
count captures run a `ge` first-hit on K3's rank tree
(csrc/seg_tree.cuh). The row sources are decoded once per kernel
(`row_sources`, kept on it) into 40-byte records; a call patches their
column pointers. The look-back state is each prepared launch's own; the
launcher zeroes it with a memset before each launch, so a call is one
kernel launch and one memset (`launched` in the parameter block counts
the kernels). A fused multi-query
group's lanes share one row of events (stride 0) and each match row
carries its lane's `__qid__` (`__lane_qid__[lane]`, the JAX package's
nfa_parallel.py:1146). Bound on the H100: bytes -- status, candidates,
comp indices and seq read once per candidate, each match row written
once.

Outputs: `out_i` (len(lane_names_i), M) int32, `out_f` (len(rows_f), M)
float32 (float64 under @app:devicePrecision('f64'): a DOUBLE column is
copied, a FLOAT column widened), `out_l` (len(rows_l), M) int64 (the
first meta[0] columns
written), `meta` [matches, 0], `lane_n` (L,) matches per lane and `arm`
(L,) the one-shot flag (ARM_NONE / ARM_PENDING / ARM_RESOLVED).
`scan_compact()` launches the kernel for CUDA tensors and runs
`scan_compact_plain()` (cumsum and index compaction) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.expr import VT_OF_TORCH
from ..core.nfa_device import UNBOUNDED
from ..core.nfa_parallel import CNT_COMP, CNT_FIXED, CNT_Q, lane_grid
from .build import load
from .seg_tree import first_hit_plain
from .table import DeviceTable, Launch, checked_ptr, stream_of

TILE = 1024                         # csrc/scan_compact.cu CP_TILE
ARM_NONE, ARM_PENDING, ARM_RESOLVED = 0, 1, 2
_KIND = {"col": 0, "comp_ts": 1, "comp_seq": 2, "head_seq": 3, "qid": 4,
         "cnt": 5, "pres_bit": 6, "pres_cnt": 7, "one": 8}
_GROUP = {"i": 0, "f": 1, "l": 2}
# csrc/scan_compact.cu RowSrc
ROW = np.dtype([("col", "<u8"), ("vt", "<i4"), ("kind", "<i4"),
                ("pos", "<i4"), ("group", "<i4"), ("index", "<i4"),
                ("cnt", "<i4"), ("mode", "<i4"), ("arg", "<i4")])


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "S", "M", "single", "ntiles", "n_rows", "ev_stride",
        "C", "Lt", "alg", "f64", "launched")] + [
        (n, ctypes.c_void_p) for n in (
            "seq", "ts", "prev", "arm_done", "lane_qid", "status", "idx",
            "cand", "pres", "comp_row", "rank", "rank_heap", "cnt_rank",
            "cnt_min", "cnt_max", "cnt_entry", "state", "lane_cnt", "arm",
            "meta", "out_i", "out_f", "out_l", "rows")]


def tiles_for(k, F: int) -> int:
    """Tiles of one lane's candidates (C * F, or F without a count or
    logical position), at least one."""
    return max(-(-((k.C if alg_of(k) else 1) * F) // TILE), 1)


def alg_of(k) -> bool:
    """The kernel's algebra instantiation: a count or logical position."""
    return k.head is not None or any(
        h.kind in ("logical", "count", "final") for h in k.hops)


def row_sources(k):
    """The kernel's row sources, decoded once and kept on it: (the ROW
    records with the column pointers to patch, [(record, column key,
    the dtypes its group takes, the group)], the static int sections,
    whether a row is `__qid__`)."""
    got = getattr(k, "_k5_rows", None)
    if got is not None:
        return got
    # the column types each row group takes (a FLOAT column widens into
    # a float64 row under f64)
    takes = {"i": (torch.int32, torch.bool), "l": (torch.int64,),
             "f": (torch.float32, torch.float64) if k.f64 else
             (torch.float32,)}
    recs, cols = [], []
    for g, srcs in k.rows.items():
        for ri, src in enumerate(srcs):
            pos = cnt = mode = arg = 0
            if src[0] in ("col", "cnt"):
                cols.append((len(recs), src[1], takes[g], g))
                if src[0] == "col":
                    pos = src[2]
                else:
                    cnt, mode, arg = src[2], src[3], src[4]
            elif src[0] == "pres_bit":
                arg = src[1]
            elif src[0] == "pres_cnt":
                cnt, arg = src[1], src[2]
            recs.append((0, 0, _KIND[src[0]], pos, _GROUP[g], ri, cnt, mode,
                         arg))
    positions = k.prog.positions
    static = {"comp_row": np.asarray(k.comp_rows, np.int32),
              "cnt_rank": np.asarray([k.rank_of.get(pi, -1)
                                      for pi in range(k.S)], np.int32),
              "cnt_min": np.asarray([q.min_count for q in positions],
                                    np.int32),
              "cnt_max": np.asarray([min(q.max_count, UNBOUNDED)
                                     for q in positions], np.int32),
              "cnt_entry": np.asarray([count_entry(k, pi)
                                       for pi in range(k.S)], np.int32)}
    k._k5_rows = (np.array(recs or [(0,) * 9], dtype=ROW), cols, static,
                  any(src[0] == "qid" for srcs in k.rows.values()
                      for src in srcs))
    return k._k5_rows


def _alloc(k, M: int, L: int, dev, rows=torch.zeros, ints=None) -> dict:
    """The match table; meta, lane_n and arm as views of `ints` (2 + 2 L
    int32, zeros when not given)."""
    nfak = k.nfak
    if ints is None:
        ints = torch.zeros(2 + 2 * L, dtype=torch.int32, device=dev)
    return {"out_i": rows((len(nfak.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(nfak.rows_f), M), dtype=nfak.fdt,
                          device=dev),
            "out_l": rows((len(nfak.rows_l), M), dtype=torch.int64,
                          device=dev),
            "meta": ints[:2], "lane_n": ints[2:2 + L],
            "arm": ints[2 + L:2 + 2 * L]}


def count_entry(k, pi: int) -> int:
    """loc of the event a count at position pi enters on (its rank
    base): -1 for a count head (the head itself is occurrence 1)."""
    if pi == 0:
        return -1
    return 0 if pi == 1 else k.pos_row[pi - 1] + 1


def scan_compact_plain(k, ev: dict, chase, ranks: list, rheaps: list,
                       M: int) -> dict:
    status, idx, cand, pres = chase
    seq, ts = lane_grid(ev, "__flat.__seq__"), lane_grid(ev, "__flat.__ts__")
    L, F = seq.shape
    C, Lt = k.C, k.leaves(F)
    dev = seq.device
    j0 = torch.arange(F, device=dev).expand(L, F)
    comps = torch.stack([idx[r] for r in k.comp_rows]).to(torch.int64)
    live = torch.stack([((cand.to(torch.int64) >> c) & 1) != 0
                        for c in range(C)])
    live = live & torch.stack([torch.gather(seq, 1, comps[c])
                               > ev["__prev_seq__"][:, None]
                               for c in range(C)])
    out = _alloc(k, M, L, dev)
    if k.prog.single_arm:
        head = (status & 4) != 0
        h0 = torch.where(head, j0, torch.full_like(j0, F)).min(1).values
        live = live & (j0 == h0[:, None])[None]
        done = ev.get("__arm_done__")
        if done is not None:
            live = live & (done[:, None] == 0)[None]
        r0 = torch.gather(status, 1, torch.clamp(h0, 0, F - 1)[:, None]
                          )[:, 0] & 3
        arm = torch.where(h0 < F, torch.where(
            r0 != 0, ARM_RESOLVED, ARM_PENDING), ARM_NONE)
        if done is not None:
            arm = torch.where(done != 0, ARM_RESOLVED, arm)
        out["arm"] = arm.to(torch.int32)
    flat = live.permute(1, 0, 2).reshape(-1)        # lane, c, head
    n = int(flat.sum())
    out["meta"][0] = n
    out["lane_n"] = live.sum((0, 2)).to(torch.int32)
    sel = torch.nonzero(flat).flatten()[:M]
    lanes = sel // (C * F)
    cc = sel % (C * F) // F
    heads = sel % F
    comp = comps[cc, lanes, heads]

    def at(loc: int) -> torch.Tensor:
        return heads if loc == 0 else \
            idx[loc - 1].to(torch.int64)[lanes, heads]

    def count_ctx(pi: int):
        """(s, ra, q) of the count at position pi for every match."""
        rank = ranks[k.rank_of[pi]]
        pos = k.prog.positions[pi]
        entry = count_entry(k, pi)
        if entry < 0:
            s, ra = heads, rank[lanes, heads] - 1
        else:
            e = at(entry)
            s, ra = e + 1, rank[lanes, e]
        if pi == k.S - 1:
            q = pos.min_count + cc
        else:
            q = rank[lanes, comp] - ra
            if pos.max_count < UNBOUNDED:
                q = torch.clamp(q, max=pos.max_count)
        return s, ra, q

    for g, srcs in k.rows.items():
        dst = out[f"out_{g}"]
        for r, src in enumerate(srcs):
            kind = src[0]
            if kind == "comp_ts":
                v = ts[lanes, comp]
            elif kind == "comp_seq":
                v = seq[lanes, comp]
            elif kind == "head_seq":
                v = seq[lanes, heads]
            elif kind == "qid":
                v = ev["__lane_qid__"][lanes]
            elif kind == "col":
                v = lane_grid(ev, src[1])[lanes, at(src[2])]
            elif kind == "one":
                v = torch.ones_like(heads)
            elif kind == "pres_bit":
                v = (pres.to(torch.int64)[lanes, heads] >> src[1]) & 1
            elif kind == "pres_cnt":
                v = (count_ctx(src[1])[2] >= src[2]).to(torch.int64)
            else:
                _kind, key, pi, mode, arg = src
                if mode == CNT_COMP:
                    i = comp
                else:
                    s, ra, q = count_ctx(pi)
                    want = q + arg if mode == CNT_Q else \
                        torch.full_like(q, arg)
                    i = torch.clamp(first_hit_plain(
                        rheaps[k.rank_of[pi]], Lt, s, ra + want, "ge",
                        lanes=lanes).to(torch.int64), 0, F - 1)
                v = lane_grid(ev, key)[lanes, i]
            dst[r, :len(sel)] = v.to(dst.dtype)
    return out


def scan_compact(k, ev: dict, chase, ranks: list, rheaps: list,
                 M: int) -> dict:
    """Match table of ParallelChainKernel `k` for block `ev` from K4's
    `chase` = (status, idx, cand, pres), the K6 rank columns and K3 rank
    trees, with room for M rows (see the module docstring)."""
    if ev["__flat.__seq__"].device.type == "cpu":
        return scan_compact_plain(k, ev, chase, ranks, rheaps, M)
    return prepare(k, ev, chase, ranks, rheaps, M)()


def prepare(k, ev: dict, chase, ranks: list, rheaps: list,
            M: int) -> Launch:
    """Allocate the match table and the look-back state and upload the
    parameter table of one K5 launch (see `scan_compact`)."""
    status, idx, cand, pres = chase
    seq = ev["__flat.__seq__"]
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError(f"scan_compact: unsupported device {dev}")
    G, F = seq.shape
    L = ev["__nev__"].shape[0]
    keep: list = []
    ptr = checked_ptr(keep, dev, "scan_compact")
    recs, cols, static, qid = row_sources(k)
    p = _Params()
    p.L, p.F, p.S, p.M = L, F, k.S, M
    p.single, p.ntiles = int(k.prog.single_arm), tiles_for(k, F)
    p.ev_stride = F if G == L else 0
    p.C, p.Lt = k.C, k.leaves(F)
    p.alg = int(alg_of(k))
    p.f64 = int(k.f64)
    p.seq = ptr(seq, torch.int32)
    p.ts = ptr(ev["__flat.__ts__"], torch.int32)
    p.prev = ptr(ev["__prev_seq__"], torch.int32)
    if k.prog.single_arm and ev.get("__arm_done__") is not None:
        p.arm_done = ptr(ev["__arm_done__"], torch.int32)
    if "__lane_qid__" in ev:
        p.lane_qid = ptr(ev["__lane_qid__"], torch.int32)
    elif qid:
        raise ValueError("scan_compact: a __qid__ row without __lane_qid__")
    p.status = ptr(status, torch.uint8)
    p.idx = ptr(idx, torch.int32)
    p.cand = ptr(cand, torch.uint8)
    p.pres = ptr(pres, torch.int32)
    # one buffer: the look-back state (a ticket, a count word and an h0
    # word a tile; the launcher zeroes it), then meta, lane_n and arm
    # (int32, written by the kernel)
    nstate = 1 + 2 * L * p.ntiles
    buf = torch.empty(nstate + (3 + 2 * L) // 2, dtype=torch.int64,
                      device=dev)
    ints = buf[nstate:].view(torch.int32)
    out = _alloc(k, M, L, dev, torch.empty, ints)
    p.state = ptr(buf)
    p.meta = ptr(buf) + 8 * nstate
    p.lane_cnt, p.arm = p.meta + 8, p.meta + 8 + 4 * L
    p.out_i, p.out_f, p.out_l = (ptr(out["out_i"]), ptr(out["out_f"]),
                                 ptr(out["out_l"]))
    rows = recs
    if cols:
        rows = recs.copy()
        for r, key, takes, g in cols:
            col = ev[key]
            if col.dtype not in takes:
                raise ValueError(f"scan_compact: {key} is {col.dtype}, "
                                 f"row group {g!r}")
            rows[r]["col"] = ptr(col)
            rows[r]["vt"] = VT_OF_TORCH[col.dtype]
    p.n_rows = sum(len(srcs) for srcs in k.rows.values())
    tab = DeviceTable()
    tab.field(p, "rows", rows.view(np.uint8), np.uint8)
    for key, a in static.items():
        tab.field(p, key, a, np.int32)
    tab.field(p, "rank", [ptr(r, torch.int64) for r in ranks] or [0], "u8")
    tab.field(p, "rank_heap", [ptr(h, torch.int64) for h in rheaps] or [0],
              "u8")
    keep.append(tab.upload(dev))
    lib = load("scan_compact")
    fn = lib.scan_compact_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "scan_compact_launch",
                    "scan_compact:f64" if k.f64 else "scan_compact", keep,
                    out)
    launch.params = p     # .ntiles; .launched: the last call's kernels
    return launch
