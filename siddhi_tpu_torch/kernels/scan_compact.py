"""K5 `scan_compact`: dedup and compaction of one `scan` block.

Replaces the emission tail of `_block_impl` (siddhi_tpu/core/
nfa_parallel.py): the dedup of replayed completions `seq[comp] >
prev_seq` per lane (:1031), the one-shot head's filter and resolution
flag (:1034-1053), the exclusive prefix count and scatter of candidates
into M match rows (:1056-1072) and the gathers of the captured columns
the selector reads (:1079-1137), all vmapped there over the lane axis.

Design (csrc/scan_compact.cu): the lanes are compacted into ONE match
table, lane-major, each lane's rows in head order (the JAX cumsum's
order), with the rows of the NFAKernel's table (`lane_names_i`, `rows_f`,
`rows_l`): captured columns at the indices K4 resolved, the completion's
ts and seq offsets, the head's seq offset.  The selector pass (K1) and
the plan's unpack then read it as they read the sequential kernel's.
Passes: per-lane first head (one-shot heads only), live counts per
1024-candidate tile, one block's exclusive scan of the tile counts, and
the block-scan scatter.  The row sources travel in a device table
(kernels/table.py), so no table width is fixed.  A fused multi-query
group's lanes share one row of events (stride 0) and each match row
carries its lane's `__qid__` (`__lane_qid__[lane]`, the JAX package's
nfa_parallel.py:1146).  Bound on the H100: bytes -- status, comp index
and seq read once per candidate, each match row written once.

Outputs: `out_i` (len(lane_names_i), M) int32, `out_f` (len(rows_f), M)
float32, `out_l` (len(rows_l), M) int64 (the first meta[0] columns
written), `meta` [matches, 0], `lane_n` (L,) matches per lane and `arm`
(L,) the one-shot flag (ARM_NONE / ARM_PENDING / ARM_RESOLVED).
`scan_compact()` launches the kernel for CUDA tensors and runs
`scan_compact_plain()` (cumsum and index compaction) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.expr import VT_OF_TORCH
from ..core.nfa_parallel import lane_grid
from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of

TILE = 1024                         # csrc/scan_compact.cu CP_TILE
ARM_NONE, ARM_PENDING, ARM_RESOLVED = 0, 1, 2
_KIND = {"col": 0, "comp_ts": 1, "comp_seq": 2, "head_seq": 3, "qid": 4}
_GROUP = {"i": (0, torch.int32), "f": (1, torch.float32),
          "l": (2, torch.int64)}


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "S", "M", "single", "ntiles", "n_rows", "ev_stride")] + [
        (n, ctypes.c_void_p) for n in (
            "seq", "ts", "prev", "arm_done", "lane_qid", "status", "idx",
            "h0", "tile_off", "lane_cnt", "arm", "meta", "out_i", "out_f",
            "out_l", "row_col", "row_vt", "row_kind", "row_pos",
            "row_group", "row_index")]


def _alloc(k, M: int, L: int, dev, rows=torch.zeros) -> dict:
    nfak = k.nfak
    return {"out_i": rows((len(nfak.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(nfak.rows_f), M), dtype=torch.float32,
                          device=dev),
            "out_l": rows((len(nfak.rows_l), M), dtype=torch.int64,
                          device=dev),
            "meta": torch.zeros(2, dtype=torch.int32, device=dev),
            "lane_n": torch.zeros(L, dtype=torch.int32, device=dev),
            "arm": torch.zeros(L, dtype=torch.int32, device=dev)}


def scan_compact_plain(k, ev: dict, status: torch.Tensor,
                       idx: torch.Tensor, M: int) -> dict:
    seq, ts = lane_grid(ev, "__flat.__seq__"), lane_grid(ev, "__flat.__ts__")
    L, F = seq.shape
    dev = seq.device
    j0 = torch.arange(F, device=dev).expand(L, F)
    ok = (status & 1) != 0
    comp = idx[k.S - 2].to(torch.int64)
    live = ok & (torch.gather(seq, 1, comp) > ev["__prev_seq__"][:, None])
    out = _alloc(k, M, L, dev)
    if k.prog.single_arm:
        head = (status & 4) != 0
        h0 = torch.where(head, j0, torch.full_like(j0, F)).min(1).values
        live = live & (j0 == h0[:, None])
        done = ev.get("__arm_done__")
        if done is not None:
            live = live & (done[:, None] == 0)
        r0 = torch.gather(status, 1, torch.clamp(h0, 0, F - 1)[:, None]
                          )[:, 0] & 3
        arm = torch.where(h0 < F, torch.where(
            r0 != 0, ARM_RESOLVED, ARM_PENDING), ARM_NONE)
        if done is not None:
            arm = torch.where(done != 0, ARM_RESOLVED, arm)
        out["arm"] = arm.to(torch.int32)
    flat = live.reshape(-1)
    n = int(flat.sum())
    out["meta"][0] = n
    out["lane_n"] = live.sum(1).to(torch.int32)
    sel = torch.nonzero(flat).flatten()[:M]
    heads = j0.reshape(-1)[sel]
    lanes = sel // F

    def at(pos: int) -> torch.Tensor:
        return heads if pos == 0 else \
            idx[pos - 1].to(torch.int64).reshape(-1)[sel]
    cidx = at(k.S - 1)
    for g, srcs in k.rows.items():
        dst = out[f"out_{g}"]
        for r, src in enumerate(srcs):
            if src[0] == "comp_ts":
                v = ts[lanes, cidx]
            elif src[0] == "comp_seq":
                v = seq[lanes, cidx]
            elif src[0] == "head_seq":
                v = seq[lanes, heads]
            elif src[0] == "qid":
                v = ev["__lane_qid__"][lanes]
            else:
                v = lane_grid(ev, src[1])[lanes, at(src[2])]
            dst[r, :len(sel)] = v.to(dst.dtype)
    return out


def scan_compact(k, ev: dict, status: torch.Tensor, idx: torch.Tensor,
                 M: int) -> dict:
    """Match table of ParallelChainKernel `k` for block `ev` from K4's
    `status` and `idx`, with room for M rows (see the module docstring)."""
    if ev["__flat.__seq__"].device.type == "cpu":
        return scan_compact_plain(k, ev, status, idx, M)
    return prepare(k, ev, status, idx, M)()


def prepare(k, ev: dict, status: torch.Tensor, idx: torch.Tensor,
            M: int) -> Launch:
    """Allocate the match table and upload the parameter table of one K5
    launch (see `scan_compact`)."""
    seq = ev["__flat.__seq__"]
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError(f"scan_compact: unsupported device {dev}")
    G, F = seq.shape
    L = ev["__nev__"].shape[0]
    keep: list = []
    ptr = checked_ptr(keep, dev, "scan_compact")
    ntiles = -(-F // TILE)
    p = _Params()
    p.L, p.F, p.S, p.M = L, F, k.S, M
    p.single, p.ntiles = int(k.prog.single_arm), ntiles
    p.ev_stride = F if G == L else 0
    p.seq = ptr(seq, torch.int32)
    p.ts = ptr(ev["__flat.__ts__"], torch.int32)
    p.prev = ptr(ev["__prev_seq__"], torch.int32)
    if k.prog.single_arm and ev.get("__arm_done__") is not None:
        p.arm_done = ptr(ev["__arm_done__"], torch.int32)
    if "__lane_qid__" in ev:
        p.lane_qid = ptr(ev["__lane_qid__"], torch.int32)
    p.status = ptr(status, torch.uint8)
    p.idx = ptr(idx, torch.int32)
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
            "index": []}
    for g, srcs in k.rows.items():
        gi, want = _GROUP[g]
        for ri, src in enumerate(srcs):
            col_p, vt, pos = 0, 0, 0
            if src[0] == "col":
                col = ev[src[1]]
                if col.dtype != want and not (g == "i" and col.dtype ==
                                              torch.bool):
                    raise ValueError(f"scan_compact: {src[1]} is "
                                     f"{col.dtype}, row group {g!r}")
                col_p, vt, pos = ptr(col), VT_OF_TORCH[col.dtype], src[2]
            elif src[0] == "qid" and not p.lane_qid:
                raise ValueError("scan_compact: a __qid__ row without "
                                 "__lane_qid__")
            for key, v in (("col", col_p), ("vt", vt),
                           ("kind", _KIND[src[0]]), ("pos", pos),
                           ("group", gi), ("index", ri)):
                rows[key].append(v)
    p.n_rows = len(rows["kind"])
    tab = DeviceTable()
    for key in rows:
        tab.field(p, f"row_{key}", rows[key] or [0],
                  "u8" if key == "col" else "i4")
    keep.append(tab.upload(dev))
    lib = load("scan_compact")
    fn = lib.scan_compact_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        h0.copy_(h0_init)
        return fn(ctypes.byref(p), stream_of(dev))
    return Launch(run, "scan_compact_launch", "scan_compact",
                  keep + [h0_init], out)
