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
they read the sequential kernel's.  Passes: per-lane first head
(one-shot heads only), live counts per 1024-candidate tile, one block's
exclusive scan of the tile counts, and the block-scan scatter, whose
count captures run a `ge` first-hit on K3's rank tree (csrc/
seg_tree.cuh).  The row sources travel in a device table
(kernels/table.py), so no table width is fixed.  A fused multi-query
group's lanes share one row of events (stride 0) and each match row
carries its lane's `__qid__` (`__lane_qid__[lane]`, the JAX package's
nfa_parallel.py:1146).  Bound on the H100: bytes -- status, candidates,
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


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "S", "M", "single", "ntiles", "n_rows", "ev_stride",
        "C", "Lt", "alg", "f64")] + [
        (n, ctypes.c_void_p) for n in (
            "seq", "ts", "prev", "arm_done", "lane_qid", "status", "idx",
            "cand", "pres", "comp_row", "rank", "rank_heap", "cnt_rank",
            "cnt_min", "cnt_max", "cnt_entry", "h0", "tile_off",
            "lane_cnt", "arm", "meta", "out_i", "out_f", "out_l",
            "row_col", "row_vt", "row_kind", "row_pos", "row_group",
            "row_index", "row_cnt", "row_mode", "row_arg")]


def _alloc(k, M: int, L: int, dev, rows=torch.zeros) -> dict:
    nfak = k.nfak
    return {"out_i": rows((len(nfak.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(nfak.rows_f), M), dtype=nfak.fdt,
                          device=dev),
            "out_l": rows((len(nfak.rows_l), M), dtype=torch.int64,
                          device=dev),
            "meta": torch.zeros(2, dtype=torch.int32, device=dev),
            "lane_n": torch.zeros(L, dtype=torch.int32, device=dev),
            "arm": torch.zeros(L, dtype=torch.int32, device=dev)}


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
    """Allocate the match table and upload the parameter table of one K5
    launch (see `scan_compact`)."""
    status, idx, cand, pres = chase
    seq = ev["__flat.__seq__"]
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError(f"scan_compact: unsupported device {dev}")
    G, F = seq.shape
    L = ev["__nev__"].shape[0]
    keep: list = []
    ptr = checked_ptr(keep, dev, "scan_compact")
    ntiles = -(-(k.C * F) // TILE)
    p = _Params()
    p.L, p.F, p.S, p.M = L, F, k.S, M
    p.single, p.ntiles = int(k.prog.single_arm), ntiles
    p.ev_stride = F if G == L else 0
    p.C, p.Lt = k.C, k.leaves(F)
    p.alg = int(k.head is not None or any(
        h.kind in ("logical", "count", "final") for h in k.hops))
    p.f64 = int(k.f64)
    p.seq = ptr(seq, torch.int32)
    p.ts = ptr(ev["__flat.__ts__"], torch.int32)
    p.prev = ptr(ev["__prev_seq__"], torch.int32)
    if k.prog.single_arm and ev.get("__arm_done__") is not None:
        p.arm_done = ptr(ev["__arm_done__"], torch.int32)
    if "__lane_qid__" in ev:
        p.lane_qid = ptr(ev["__lane_qid__"], torch.int32)
    p.status = ptr(status, torch.uint8)
    p.idx = ptr(idx, torch.int32)
    p.cand = ptr(cand, torch.uint8)
    p.pres = ptr(pres, torch.int32)
    h0 = torch.full((L,), F, dtype=torch.int32, device=dev)
    h0_init = h0.clone()
    tile_off = torch.empty(L * ntiles + 1, dtype=torch.int32, device=dev)
    out = _alloc(k, M, L, dev, torch.empty)
    p.h0, p.tile_off = ptr(h0), ptr(tile_off)
    p.lane_cnt, p.arm, p.meta = (ptr(out["lane_n"]), ptr(out["arm"]),
                                 ptr(out["meta"]))
    p.out_i, p.out_f, p.out_l = (ptr(out["out_i"]), ptr(out["out_f"]),
                                 ptr(out["out_l"]))
    rows = {"col": [], "vt": [], "kind": [], "pos": [], "group": [],
            "index": [], "cnt": [], "mode": [], "arg": []}
    # the column types each row group takes (a FLOAT column widens into
    # a float64 row under f64)
    takes = {"i": (torch.int32, torch.bool), "l": (torch.int64,),
             "f": (torch.float32, torch.float64) if k.f64 else
             (torch.float32,)}
    for g, srcs in k.rows.items():
        gi = _GROUP[g]
        for ri, src in enumerate(srcs):
            col_p, vt, pos, cnt, mode, arg = 0, 0, 0, 0, 0, 0
            if src[0] in ("col", "cnt"):
                col = ev[src[1]]
                if col.dtype not in takes[g]:
                    raise ValueError(f"scan_compact: {src[1]} is "
                                     f"{col.dtype}, row group {g!r}")
                col_p, vt = ptr(col), VT_OF_TORCH[col.dtype]
                if src[0] == "col":
                    pos = src[2]
                else:
                    cnt, mode, arg = src[2], src[3], src[4]
            elif src[0] == "pres_bit":
                arg = src[1]
            elif src[0] == "pres_cnt":
                cnt, arg = src[1], src[2]
            elif src[0] == "qid" and not p.lane_qid:
                raise ValueError("scan_compact: a __qid__ row without "
                                 "__lane_qid__")
            for key, v in (("col", col_p), ("vt", vt),
                           ("kind", _KIND[src[0]]), ("pos", pos),
                           ("group", gi), ("index", ri), ("cnt", cnt),
                           ("mode", mode), ("arg", arg)):
                rows[key].append(v)
    p.n_rows = len(rows["kind"])
    tab = DeviceTable()
    for key in rows:
        tab.field(p, f"row_{key}", rows[key] or [0],
                  "u8" if key == "col" else "i4")
    positions = k.prog.positions
    tab.field(p, "comp_row", k.comp_rows, "i4")
    tab.field(p, "rank", [ptr(r, torch.int64) for r in ranks] or [0], "u8")
    tab.field(p, "rank_heap", [ptr(h, torch.int64) for h in rheaps] or [0],
              "u8")
    tab.field(p, "cnt_rank", [k.rank_of.get(pi, -1)
                              for pi in range(k.S)], "i4")
    tab.field(p, "cnt_min", [q.min_count for q in positions], "i4")
    tab.field(p, "cnt_max", [min(q.max_count, UNBOUNDED)
                             for q in positions], "i4")
    tab.field(p, "cnt_entry", [count_entry(k, pi) for pi in range(k.S)],
              "i4")
    keep.append(tab.upload(dev))
    lib = load("scan_compact")
    fn = lib.scan_compact_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        h0.copy_(h0_init)
        return fn(ctypes.byref(p), stream_of(dev))
    return Launch(run, "scan_compact_launch",
                  "scan_compact:f64" if k.f64 else "scan_compact",
                  keep + [h0_init], out)
