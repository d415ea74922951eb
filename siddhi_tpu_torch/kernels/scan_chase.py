"""K4 `scan_chase`: the stateless state chase of one `scan` block.

Replaces the chase of `_block_impl` (siddhi_tpu/core/nfa_parallel.py
:880-1027: single positions, counts by rank/select, logical stations,
the final count's candidate fan-out; `_first_hit` :523 inside it,
`killer` :863, `threshold_next` :869, `step_fail` :891), which the JAX
package vmaps over the lane axis (`_make_lane_block` :646).  Every event
of the block is a candidate head; per position below the head it finds
the first event from s = (previous match) + 1 that completes the hop,
and checks that it lands before the `within` killer (the first event
past head ts + W, matching or not):
  * static and threshold hops are first-hit descents in K3's trees; a
    strict-sequence hop reads the event at s;
  * a count (head or below) is rank/select: with ra its rank base (the
    head's rank less one, or the rank at the entry event, which is not
    an occurrence), its min-th occurrence is the first index >= s whose
    inclusive rank reaches ra + min, a `ge` first-hit on the count's
    rank tree; the next hop then takes the count's `within`;
  * a logical position finds each side's first match (first-hits on the
    sides' mask trees): `or` completes at their min, `and` at their max;
    an `or` side captures its own first match and is present only if it
    won, an `and` side captures its last match at or before the
    completion (the prev-match pointer that K6 scanned);
  * a final count fans out into C = max - min + 1 candidates per head:
    occurrence min + c, live when it lands before the killer.

Design (csrc/scan_chase.cu, descents in csrc/seg_tree.cuh): a thread a
(lane, head), the hop loop in registers; threshold right-hand sides and
strict step conjunctions run the predicate VM (csrc/expr_vm.cuh) on the
captures at the indices resolved so far, which the thread keeps in its
own column of the `idx` output, so no chain length is fixed; a fused
group's `__qparam` operands read the lane's parameters.  A descent is a
chain of up to 2 log2(Lt) dependent node loads, so latency, not bytes,
sets the pace: the descent takes four levels' nodes at once on the way
up and two levels a step on the way down, through the read-only cache,
where a lane's heaps stay between its heads' descents.  Per-lane rows
(C4, C4N, C4A, C4F64, C4D, C3): blocks sized to the lane, one block a
lane up to `LANE_MAX` heads, its warps covering the lane's F heads in
full warps, past that equal whole-warp tiles (`lane_geometry`; C3's one
flat lane of 2^19 heads).  In a fused group every lane reads a tree K3 built
once for the group (`TreeSpec.shared`, a (1, 2 Lt) heap) at lane stride
0 from L2, and a 256-thread tile first moves its live heads (a tenth of
C5's pass their lane's head filter) to its first threads, so the chase
runs in full warps.  Hop tables, loads, heap pointers and programs
travel in a device table (kernels/table.py), the programs staged in
shared memory.  A head stops at its first failed hop.  Bound on the
H100: bytes -- the timestamp and pre-mask grids read once, the status
and index grids written once.

In `dfa` mode (the `dfa` family; launches counted as `scan_chase:dfa`)
a static hop's or a logical side's first hit is the table lookup of
`_dfa_next` (nfa_parallel.py:777): the suffix word of K11 at s, else the
packed word of the next block with a hit, else Lt -- the same index the
descent of a mask tree gives, without the tree.

Output: `status` (L, F) uint8 (bit 1 resolved-live: the head's chain
completed, or, with a final count, its last candidate did; bit 2 dead;
bit 4 the head's node mask), `idx` (n_idx, L, F) int32 (the rows of
ParallelChainKernel), `cand` (L, F) uint8 (bit c: candidate c live) and
`pres` (L, F) int32 (bit b: the `or` side with presence bit b won); all
0 where the head's chain failed.  `scan_chase()` launches the kernel for
CUDA tensors and runs `scan_chase_plain()` (the JAX chase as vector ops
over the (L, F) grid) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core.expr import VT_OF_TORCH, decode_word
from ..core.nfa_parallel import lane_grid
from .build import load
from .dfa_tables import dfa_next_plain
from .expr_eval import (merge_programs, program_table, stage_bytes,
                        vm_run_plain)
from .seg_tree import first_hit_plain, node_masks
from .table import DeviceTable, Launch, checked_ptr, stream_of

_KIND = {"static": 0, "threshold": 1, "strict": 2, "logical": 3,
         "count": 4, "final": 5}
_OP = {"gt": 0, "ge": 1, "lt": 2, "le": 3}


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "Lt", "S", "is_seq", "ts_tree", "n_loads", "ev_stride",
        "P", "n_words", "n_consts", "stage", "n_idx", "C", "head_node",
        "head_rank", "head_min", "head_within", "alg", "dfa",
        "NB", "compact", "logLt", "threads", "launched")] + [
        (n, ctypes.c_void_p) for n in (
            "nev", "ts", "scode", "qparams", "pre", "node_scode",
            "pos_node", "hop_kind", "hop_within", "hop_tree", "hop_op",
            "hop_vt", "hop_tree2", "hop_prev_l", "hop_prev_r",
            "hop_side_l", "hop_side_r", "hop_bit_l", "hop_bit_r",
            "hop_rank", "hop_min", "hop_row", "prog_off", "prog_len",
            "heap", "heap_vt", "heap_lane", "rank", "rank_heap", "prev",
            "comp_row",
            "load_col", "load_vt", "load_pos", "status", "idx", "cand",
            "pres", "consts", "words", "hop_dfa_l", "hop_dfa_r",
            "dfa_suffix", "dfa_packed", "dfa_nblk")]

THREADS = 256               # csrc/scan_chase.cu SC_THREADS: a fused tile
LANE_MAX = 384              # SC_LANE_MAX: threads of a per-lane block


def lane_geometry(F: int) -> int:
    """Threads (heads) a block of a per-lane launch: the lane's F heads
    in the fewest blocks of at most LANE_MAX threads, each of equal whole
    warps (one block a lane up to LANE_MAX heads)."""
    per = -(-F // -(-F // LANE_MAX))        # heads a block
    return 32 * -(-per // 32)


def _vm_plain(k, prog, ev: dict, at: list, s: torch.Tensor) -> torch.Tensor:
    """One VM program per head over the (L, F) grid: each load reads its
    column at the index its loc resolved (at[loc]: the head, or an idx
    row), or at s (loc -1), each `qparam` the lane's parameter."""
    L, F = s.shape
    words, consts, _o, _l = merge_programs(
        [prog], {"__base_ts__": ev["__base_ts__"]})
    used = {words[i + 1] for i in range(0, len(words), 2)
            if decode_word(words[i])[0] == "load"}
    cols = []
    for slot, (key, pos) in enumerate(k.loads):
        if slot not in used:        # another hop's load: never read
            cols.append(s.reshape(-1))
            continue
        where = at[pos] if pos >= 0 else s
        cols.append(torch.gather(lane_grid(ev, key), 1, where).reshape(-1))
    qcols = None
    if k.nfak.params is not None:
        qcols = [v[:, None].expand(L, F).reshape(-1)
                 for v in k.nfak.params.values]
    return vm_run_plain(words, consts, cols, L * F, qcols).reshape(L, F)


def scan_chase_plain(k, ev: dict, masks: list, heaps: list,
                     ranks: list = (), rheaps: list = (), prevs: list = (),
                     tables: Optional[tuple] = None,
                     alive: Optional[list] = None):
    """The chase over the (L, F) grid; `tables` are K11's (`dfa`), and
    `alive`, when given, receives the number of heads still ok on
    entering each hop (the work K4 does)."""
    ts = lane_grid(ev, "__flat.__ts__")
    L, F = ts.shape
    Lt = k.leaves(F)
    dev = ts.device
    nev = ev["__nev__"].to(torch.int64)[:, None]
    j0 = torch.arange(F, device=dev).expand(L, F)
    ts64 = ts.to(torch.int64)
    head = masks[k.pos_node[0]]
    ok = head.clone()
    dead = torch.zeros_like(ok)
    rows = [torch.zeros((L, F), dtype=torch.int64, device=dev)
            for _ in range(k.n_idx)]
    cand = torch.zeros((L, F), dtype=torch.int64, device=dev)
    pres = torch.zeros((L, F), dtype=torch.int64, device=dev)
    live = None

    def killer(s, within):
        return first_hit_plain(heaps[k.ts_tree], Lt, s, ts64 + within,
                               "gt").to(torch.int64)

    def select(ci, s, r):
        return first_hit_plain(rheaps[ci], Lt, s, r, "ge").to(torch.int64)

    def step(jn, kl):
        nonlocal ok, dead
        good = jn < kl
        dead = dead | (ok & ~good & (kl < F))
        ok = ok & good

    def first(tree: int, lane: int, s):
        """First node-mask hit >= s: K11's tables for a chase lane, else
        the hop's mask tree."""
        if lane >= 0:
            return dfa_next_plain(tables, lane, s, Lt)
        return first_hit_plain(heaps[tree], Lt, s, torch.zeros(
            (L, F), dtype=torch.int32, device=dev), "gt").to(torch.int64)
    j = j0
    pend = None                 # within of a count awaiting its successor
    if k.head is not None:
        h = k.head
        ra = torch.gather(ranks[h.rank], 1, j0) - 1
        jn = select(h.rank, j0, ra + h.min_count)
        step(jn, killer(j0 + 1, h.within))
        j = torch.clamp(jn, 0, F - 1)
        pend = h.within
    for pi in range(1, k.S):
        hop = k.hops[pi - 1]
        s = j + 1
        if alive is not None:
            alive.append(int(ok.sum()))
        if hop.kind == "strict":
            sc = torch.clamp(s, 0, F - 1)
            m = torch.gather(masks[k.pos_node[pi]], 1, sc)
            if hop.prog is not None:
                m = m & _vm_plain(k, hop.prog, ev, [j0] + rows, sc
                                  ).to(torch.bool)
            expired = torch.gather(ts64, 1, sc) > ts64 + hop.within
            have = s < nev
            jn = torch.where(have & m & ~expired, s, torch.full_like(s, Lt))
            dead = dead | (ok & have & (expired | ~m))
            ok = ok & (jn < F)
            j = torch.clamp(jn, 0, F - 1)
        elif hop.kind in ("static", "threshold"):
            kl = killer(s, hop.within if pend is None else pend)
            pend = None
            if hop.kind == "threshold":
                v = _vm_plain(k, hop.prog, ev, [j0] + rows, s)
                jn = first_hit_plain(heaps[hop.tree], Lt, s, v, hop.op
                                     ).to(torch.int64)
            else:
                jn = first(hop.tree, hop.dfa[0], s)
            step(jn, kl)
            j = torch.clamp(jn, 0, F - 1)
        elif hop.kind == "logical":
            jl = first(hop.tree, hop.dfa[0], s)
            jr = first(hop.tree2, hop.dfa[1], s)
            if hop.is_or:
                jd = torch.minimum(jl, jr)
            else:
                jd = torch.where((jl < F) & (jr < F), torch.maximum(jl, jr),
                                 torch.full_like(jl, Lt))
            step(jd, killer(s, hop.within))
            j = torch.clamp(jd, 0, F - 1)
            for ni, jside in enumerate((jl, jr)):
                if hop.is_or:
                    rows[hop.sides[ni]] = torch.clamp(jside, 0, F - 1)
                    pres |= (jside == jd).to(torch.int64) << hop.bits[ni]
                else:
                    rows[hop.sides[ni]] = torch.clamp(torch.gather(
                        prevs[hop.prev[ni]], 1, j), 0, F - 1)
        elif hop.kind == "count":
            ra = torch.gather(ranks[hop.rank], 1, j)
            jn = select(hop.rank, j + 1, ra + hop.min_count)
            step(jn, killer(j + 1, hop.within))
            j = torch.clamp(jn, 0, F - 1)
            pend = hop.within
        else:                           # the final count's candidates
            ra = torch.gather(ranks[hop.rank], 1, j)
            kl = killer(j + 1, hop.within)
            for c in range(k.C):
                jc = select(hop.rank, j + 1, ra + hop.min_count + c)
                live = ok & (jc < kl)
                cand |= live.to(torch.int64) << c
                rows[k.comp_rows[c]] = torch.clamp(jc, 0, F - 1)
        rows[k.pos_row[pi]] = j
    if live is None:                    # no final count: one candidate
        live = ok
        cand = ok.to(torch.int64)
    idx = torch.stack([torch.where(ok, r, torch.zeros_like(r))
                       for r in rows]).to(torch.int32) if rows else \
        torch.zeros((0, L, F), dtype=torch.int32, device=dev)
    cand = torch.where(ok, cand, torch.zeros_like(cand)).to(torch.uint8)
    pres = torch.where(ok, pres, torch.zeros_like(pres)).to(torch.int32)
    status = (live.to(torch.uint8) | (dead.to(torch.uint8) << 1)
              | (head.to(torch.uint8) << 2))
    return status, idx, cand, pres


def scan_chase(k, ev: dict, pre: list, heaps: list, ranks: list = (),
               rheaps: list = (), prevs: list = (),
               tables: Optional[tuple] = None):
    """(status, idx, cand, pres) of ParallelChainKernel `k` for block
    `ev`, its K1 pre-mask words `pre` (per chain node, or None), K3
    `heaps`, with counts or `and` positions the K6 rank columns, K3 rank
    trees and K6 prev columns, and in the `dfa` family K11's tables."""
    if ev["__flat.__ts__"].device.type == "cpu":
        return scan_chase_plain(k, ev, node_masks(k, ev, pre), heaps,
                                ranks, rheaps, prevs, tables)
    return prepare(k, ev, pre, heaps, ranks, rheaps, prevs, tables)()


def _static_tables(k) -> dict:
    """The sections of K4's parameter table that depend on the kernel
    alone -- the hop tables, the programs' offsets and lengths in the
    merged word array, the loads' locations, the candidates' rows -- as
    int32 arrays: built on a kernel's first launch and kept on it
    (`_k4_static`), so a launch packs only what changes."""
    st = getattr(k, "_k4_static", None)
    if st is not None:
        return st
    S = k.S
    cols = {"kind": [0] * S, "within": [0] * S, "tree": [0] * S,
            "dfa_l": [-1] * S, "dfa_r": [-1] * S,
            "op": [0] * S, "vt": [0] * S, "tree2": [0] * S,
            "prev_l": [-1] * S, "prev_r": [-1] * S, "side_l": [0] * S,
            "side_r": [0] * S, "bit_l": [-1] * S, "bit_r": [-1] * S,
            "rank": [-1] * S, "min": [0] * S, "row": [0] * S}
    progs, pidx = [], []
    for pi, hop in enumerate(k.hops, start=1):
        for key, v in (("kind", _KIND[hop.kind]), ("within", hop.within),
                       ("tree", max(hop.tree, 0)), ("op", _OP[hop.op]),
                       ("tree2", max(hop.tree2, 0)),
                       ("prev_l", hop.prev[0]), ("prev_r", hop.prev[1]),
                       ("side_l", hop.sides[0]), ("side_r", hop.sides[1]),
                       ("bit_l", hop.bits[0]), ("bit_r", hop.bits[1]),
                       ("rank", hop.rank), ("min", hop.min_count),
                       ("row", k.pos_row[pi]), ("dfa_l", hop.dfa[0]),
                       ("dfa_r", hop.dfa[1])):
            cols[key][pi] = v
        if hop.prog is not None:
            pidx.append(pi)
            progs.append(hop.prog)
            cols["vt"][pi] = hop.prog.vt
    off, ln, at = [0] * S, [0] * S, 0
    for pi, prog in zip(pidx, progs):    # merge_programs' layout
        off[pi], ln[pi] = at, len(prog.words)
        at += len(prog.words)
    fields = [("node_scode", [sc if k.multi else -1 for sc in k.node_scode]),
              ("pos_node", k.pos_node)] + [
        (f"hop_{key}", v) for key, v in cols.items()] + [
        ("prog_off", off), ("prog_len", ln), ("comp_row", k.comp_rows),
        ("load_pos", [loc for _key, loc in k.loads] or [0])]
    st = {"fields": [(name, np.asarray(v, np.int32)) for name, v in fields],
          "progs": progs}
    k._k4_static = st
    return st


def prepare(k, ev: dict, pre: list, heaps: list, ranks: list = (),
            rheaps: list = (), prevs: list = (),
            tables: Optional[tuple] = None) -> Launch:
    """Allocate the outputs and upload the parameter table of one K4
    launch (see `scan_chase`)."""
    ts = ev["__flat.__ts__"]
    dev = ts.device
    if dev.type != "cuda":
        raise ValueError(f"scan_chase: unsupported device {dev}")
    G, F = ts.shape
    L = ev["__nev__"].shape[0]
    keep: list = []
    ptr = checked_ptr(keep, dev, "scan_chase")
    p = _Params()
    p.L, p.F, p.Lt, p.S = L, F, k.leaves(F), k.S
    p.is_seq, p.ts_tree, p.n_loads = int(k.prog.sequence), k.ts_tree, \
        len(k.loads)
    p.ev_stride = F if G == L else 0
    # a fused group's lanes (one shared row): compact the live heads
    p.compact = int(p.ev_stride == 0)
    p.n_idx, p.C = k.n_idx, k.C
    p.head_node = k.pos_node[0]
    if k.head is not None:
        p.head_rank, p.head_min, p.head_within = (k.head.rank,
                                                  k.head.min_count,
                                                  k.head.within)
    else:
        p.head_rank = -1
    p.alg = int(k.head is not None or any(
        h.kind in ("logical", "count", "final") for h in k.hops))
    p.nev = ptr(ev["__nev__"], torch.int32)
    p.ts = ptr(ts, torch.int32)
    if k.multi:
        p.scode = ptr(ev["__flat.__scode__"], torch.int32)
    if k.nfak.params is not None:
        p.qparams = ptr(k.nfak.params.bits, torch.int64)
        p.P = k.nfak.params.P
    if tables is not None:
        p.dfa, p.NB = 1, tables[1].shape[1]
        p.dfa_suffix = ptr(tables[0], torch.int32)
        p.dfa_packed = ptr(tables[1], torch.int32)
        p.dfa_nblk = ptr(tables[2], torch.int32)
    st = _static_tables(k)
    words, consts, _o, _l = merge_programs(
        st["progs"], {"__base_ts__": ev["__base_ts__"]})
    tab = DeviceTable()
    tab.field(p, "pre", [0 if w is None else ptr(w, torch.int32)
                         for w in pre], "u8")
    for name, arr in st["fields"]:
        tab.field(p, name, arr, "i4")
    tab.field(p, "heap", [ptr(h) for h in heaps] or [0], "u8")
    tab.field(p, "heap_vt", [VT_OF_TORCH[h.dtype] for h in heaps] or [0],
              "i4")
    for h in heaps:
        if h.shape[0] not in (1, L):
            raise ValueError(f"scan_chase: a heap of {h.shape[0]} lanes")
    # a (1, 2 Lt) heap: a tree the same in every lane, read at stride 0
    tab.field(p, "heap_lane", [int(h.shape[0] == L) for h in heaps] or [0],
              "i4")
    p.logLt = p.Lt.bit_length() - 1
    p.threads = THREADS if p.compact else lane_geometry(F)
    tab.field(p, "rank", [ptr(r, torch.int64) for r in ranks] or [0], "u8")
    tab.field(p, "rank_heap", [ptr(h, torch.int64) for h in rheaps] or [0],
              "u8")
    tab.field(p, "prev", [ptr(v, torch.int64) for v in prevs] or [0], "u8")
    lcols = [ev[key] for key, _loc in k.loads]
    tab.field(p, "load_col", [ptr(c) for c in lcols] or [0], "u8")
    tab.field(p, "load_vt", [VT_OF_TORCH[c.dtype] for c in lcols] or [0],
              "i4")
    program_table(tab, p, words, consts)
    status = torch.empty((L, F), dtype=torch.uint8, device=dev)
    idx = torch.empty((max(k.n_idx, 1), L, F), dtype=torch.int32, device=dev)
    cand = torch.empty((L, F), dtype=torch.uint8, device=dev)
    pres = torch.empty((L, F), dtype=torch.int32, device=dev)
    p.status, p.idx, p.cand, p.pres = ptr(status), ptr(idx), ptr(cand), \
        ptr(pres)
    keep.append(tab.upload(dev))
    smem = stage_bytes(words, consts) if p.stage else 0
    lib = load("scan_chase")
    fn = lib.scan_chase_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # a launch that descends a float64 tree (a threshold hop over DOUBLE
    # under @app:devicePrecision('f64')) counts apart
    use = ("scan_chase:dfa" if tables is not None else "scan_chase") + (
        ":f64" if any(h.dtype == torch.float64 for h in heaps) else "")
    launch = Launch(lambda: fn(ctypes.byref(p), smem, stream_of(dev)),
                    "scan_chase_launch", use, keep,
                    (status, idx[:k.n_idx], cand, pres))
    # what the launch uses, beside the block (chip_smoke, kernel_ab)
    p.smem, p.blocks = smem, L * -(-F // p.threads)
    launch.params = p
    return launch
