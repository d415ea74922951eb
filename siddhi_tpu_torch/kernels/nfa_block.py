"""K2 `nfa_block`: the sequential batched NFA over one (T, P) event block.

Replaces the jitted `_block_impl` of the JAX package
(siddhi_tpu/core/nfa_device.py:1486, 1560): `lax.scan` over T of `_step`
(:726) with `_alloc_head` (:1328) and the E-lane `_drain_done` (:1428),
ceil(A/E) drain rounds after the scan (:1581-1592), and the cumsum +
scatter compaction of emissions into a flat (M,) buffer.

Design (csrc/nfa_block.cu): one warp per partition lane, one thread per
slot (a thread loops over A/32 slots when slot growth took A past 32).
The T loop runs inside the kernel with slot stations in registers and
capture rows in shared memory; the two-phase commit of `_step` holds
because every slot reads only its own captures and the pre-event station.
Head allocation takes the lowest free slot (`__ballot_sync` + `__ffs`,
the `cumsum == 1` rule at nfa_device.py:1097) after advances and drains;
the drain ranks parked slots with a ballot and `__popc` and emits the
first E; capture-dependent conjuncts run the predicate VM of
csrc/expr_vm.cuh.  Matches append to the (M,) rows through one atomicAdd
per warp; the host sorts by (seq, head_seq), so their order inside the
buffer does not matter.  The kernel reads `state_in` and writes a fresh
`state_out`: an M overflow or slot exhaustion is retried by the plan from
the old state, as the functional JAX state allows.

Bound on the H100: bytes -- the (T, P) grids, the state in and out and
the match rows, each moved once, over 3.35 TB/s (about 4 us at the C4
shapes).  Its real limit is the T-long chain of dependent steps inside
each warp: the kernel cannot finish before one warp has walked T events.

`nfa_block()` launches the kernel for CUDA tensors and runs the plain
version, `nfa_block_plain()` (a Python loop over T of vector ops on
(A, P) tensors, mirroring `_step`), for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.expr import VT_OF_TORCH, Node
from ..query.ast import AttrType
from . import LAUNCHES
from .build import check, load
from .expr_eval import merge_programs, unpack_mask

MAXS, MAXC, MAXW, MAXWORDS, MAXCONST = 8, 16, 48, 384, 32  # csrc/nfa_block.cu
MAX_A = 512


class _Params(ctypes.Structure):
    _fields_ = [("T", ctypes.c_int), ("P", ctypes.c_int),
                ("A", ctypes.c_int), ("S", ctypes.c_int),
                ("E", ctypes.c_int), ("is_seq", ctypes.c_int),
                ("every_head", ctypes.c_int), ("multi", ctypes.c_int),
                ("Kf", ctypes.c_int), ("Ki", ctypes.c_int),
                ("Kl", ctypes.c_int), ("C", ctypes.c_int),
                ("M", ctypes.c_int), ("ts_slot", ctypes.c_int),
                ("wpb", ctypes.c_int),
                ("ts", ctypes.c_void_p), ("seq", ctypes.c_void_p),
                ("valid", ctypes.c_void_p), ("scode", ctypes.c_void_p),
                ("ev", ctypes.c_void_p * MAXC), ("ev_vt", ctypes.c_int * MAXC),
                ("pos_scode", ctypes.c_int * MAXS),
                ("pos_within", ctypes.c_int * MAXS),
                ("pre", ctypes.c_void_p * MAXS),
                ("prog_off", ctypes.c_int * MAXS),
                ("prog_len", ctypes.c_int * MAXS),
                ("cw_off", ctypes.c_int * MAXS),
                ("cw_len", ctypes.c_int * MAXS),
                ("cw_group", ctypes.c_int * MAXW),
                ("cw_row", ctypes.c_int * MAXW),
                ("cw_src", ctypes.c_int * MAXW),
                ("occ_in", ctypes.c_void_p), ("first_in", ctypes.c_void_p),
                ("hseq_in", ctypes.c_void_p), ("capf_in", ctypes.c_void_p),
                ("capi_in", ctypes.c_void_p), ("capl_in", ctypes.c_void_p),
                ("armed_in", ctypes.c_void_p), ("ofs_in", ctypes.c_void_p),
                ("occ_out", ctypes.c_void_p), ("first_out", ctypes.c_void_p),
                ("hseq_out", ctypes.c_void_p), ("capf_out", ctypes.c_void_p),
                ("capi_out", ctypes.c_void_p), ("capl_out", ctypes.c_void_p),
                ("armed_out", ctypes.c_void_p), ("ofs_out", ctypes.c_void_p),
                ("out_i", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
                ("out_l", ctypes.c_void_p), ("meta", ctypes.c_void_p),
                ("consts", ctypes.c_longlong * MAXCONST),
                ("words", ctypes.c_int * MAXWORDS)]

_GROUP = {"f": 0, "i": 1, "l": 2}


def _alloc_out(k, M: int, dev, rows=torch.zeros) -> dict:
    """Match rows, allocated by `rows` (the kernel writes only the first
    meta[0] columns and takes torch.empty), and the zeroed meta counts."""
    return {"out_i": rows((len(k.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(k.rows_f), M), dtype=torch.float32,
                          device=dev),
            "out_l": rows((len(k.rows_l), M), dtype=torch.int64, device=dev),
            "meta": torch.zeros(2, dtype=torch.int32, device=dev)}


def nfa_block(k, state: dict, ev: dict, pre: list, M: int):
    """Run one block of NFAKernel `k`: (state', out).  `pre` holds the
    bit-packed pre-mask words per chain node (or None)."""
    dev = state["occ"].device
    if dev.type == "cpu":
        T, P = ev["__ts__"].shape
        masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
                 for w in pre]
        return nfa_block_plain(k, state, ev, masks, M)
    if dev.type != "cuda":
        raise ValueError(f"nfa_block: unsupported device {dev}")
    return _launch(k, state, ev, pre, M, dev)


def _launch(k, state: dict, ev: dict, pre: list, M: int, dev):
    T, P = ev["__ts__"].shape
    spec = k.spec
    if P != k.P or state["occ"].shape != (k.A, k.P):
        raise ValueError("nfa_block: grid/state shape does not match kernel")
    if k.A > MAX_A or spec.S > MAXS or len(k.grid_keys) > MAXC:
        raise ValueError(f"nfa_block: A={k.A} (<= {MAX_A}), S={spec.S} "
                         f"(<= {MAXS}), {len(k.grid_keys)} grid columns "
                         f"(<= {MAXC}) exceed the kernel's limits")
    p = _Params()
    p.T, p.P, p.A, p.S, p.E = T, P, k.A, spec.S, k.E
    p.is_seq, p.every_head = int(spec.is_sequence), int(spec.every_head)
    p.multi = int(len(spec.stream_ids) > 1)
    p.Kf, p.Ki, p.Kl = len(k.rows_f), len(k.rows_i), len(k.rows_l)
    p.C, p.M, p.ts_slot = len(k.grid_keys), M, k.ts_slot
    keep = []                       # tensors whose pointers we pass

    def ptr(t: torch.Tensor, dt=None) -> int:
        if t.device != dev or not t.is_contiguous() or \
                (dt is not None and t.dtype != dt):
            raise ValueError(f"nfa_block: bad tensor {t.dtype} {t.device}")
        keep.append(t)
        return t.data_ptr()
    p.ts = ptr(ev["__ts__"], torch.int32)
    p.seq = ptr(ev["__seq__"], torch.int32)
    p.valid = ptr(ev["__valid__"], torch.bool)
    if p.multi:
        p.scode = ptr(ev["__scode__"], torch.int32)
    for i, key in enumerate(k.grid_keys):
        g = ev[key]
        p.ev[i] = ptr(g)
        p.ev_vt[i] = VT_OF_TORCH[g.dtype]
    progs, pidx = [], []
    for pi, pos in enumerate(spec.positions):
        p.pos_scode[pi] = pos.node.scode
        p.pos_within[pi] = -1 if pos.within_ms is None else pos.within_ms
        p.pre[pi] = 0 if pre[pi] is None else ptr(pre[pi], torch.int32)
        if k.step_progs[pi] is not None:
            pidx.append(pi)
            progs.append(k.step_progs[pi])
    words, consts, offs, lens = merge_programs(
        progs, {"__base_ts__": ev["__base_ts__"]})
    if len(words) > MAXWORDS or len(consts) > MAXCONST:
        raise ValueError("nfa_block: step conjuncts exceed the VM budget")
    for pi, o, ln in zip(pidx, offs, lens):
        p.prog_off[pi], p.prog_len[pi] = o, ln
    for i, c in enumerate(consts):
        p.consts[i] = c
    for i, w in enumerate(words):
        p.words[i] = w
    j = 0
    for pi, cw in enumerate(k.cap_writes):
        p.cw_off[pi], p.cw_len[pi] = j, len(cw)
        for g, r, src in cw:
            if j >= MAXW:
                raise ValueError("nfa_block: too many capture writes")
            p.cw_group[j], p.cw_row[j], p.cw_src[j] = _GROUP[g], r, src
            j += 1
    st = {key: ptr(v) for key, v in state.items()}
    new = {key: torch.empty_like(v) for key, v in state.items()}
    nw = {key: ptr(v) for key, v in new.items()}
    (p.occ_in, p.first_in, p.hseq_in, p.capf_in, p.capi_in, p.capl_in,
     p.armed_in, p.ofs_in) = (st["occ"], st["first_ts"], st["head_seq"],
                              st["caps_f"], st["caps_i"], st["caps_l"],
                              st["armed0"], st["of_slots"])
    (p.occ_out, p.first_out, p.hseq_out, p.capf_out, p.capi_out, p.capl_out,
     p.armed_out, p.ofs_out) = (nw["occ"], nw["first_ts"], nw["head_seq"],
                                nw["caps_f"], nw["caps_i"], nw["caps_l"],
                                nw["armed0"], nw["of_slots"])
    out = _alloc_out(k, M, dev, torch.empty)
    p.out_i, p.out_f, p.out_l, p.meta = (ptr(out["out_i"]),
                                         ptr(out["out_f"]),
                                         ptr(out["out_l"]),
                                         ptr(out["meta"]))
    lib = load("nfa_block")
    fn = lib.nfa_block_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ctypes.byref(p),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
          "nfa_block_launch")
    LAUNCHES["nfa_block"] += 1
    return new, out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _eval(tree: Node, env: dict):
    from ..core.expr import F32_MODE, compute_dtypes, eval_node
    with compute_dtypes(F32_MODE):
        return eval_node(tree, env)


def nfa_block_plain(k, state: dict, ev: dict, masks: list, M: int):
    """Python loop over T of (A, P) vector ops -- `_step` of the JAX
    package restricted to this slice's algebra, then ceil(A/E) drain
    rounds; emissions are compacted in (step, lane, partition) order."""
    spec, A, P, S, E = k.spec, k.A, k.P, k.S, k.E
    PARK = S + 1
    dev = state["occ"].device
    occ = state["occ"].clone()
    first_ts = state["first_ts"].clone()
    head_seq = state["head_seq"].clone()
    caps = {"f": state["caps_f"].clone(), "i": state["caps_i"].clone(),
            "l": state["caps_l"].clone()}
    armed0 = state["armed0"].clone()
    of_slots = state["of_slots"].clone()
    multi = len(spec.stream_ids) > 1
    base = torch.tensor(ev["__base_ts__"], dtype=torch.int64)
    grids = [ev[key] for key in k.grid_keys]
    emitted: list = []          # (i rows, f rows, l rows) per emission
    cap_rows = {"f": k.rows_f, "i": k.rows_i, "l": k.rows_l}

    def caps_env() -> dict:
        env = {}
        for key, (g, r) in k._row_of.items():
            col = caps[g][r]
            if k._key_type.get(key) == AttrType.BOOL:
                col = col != 0
            env[key] = col
        return env

    def own_env(n, t) -> dict:
        env = {}
        for a in spec.schemas[n.ref].attributes:
            gk = f"{n.scode}.{a.name}"
            if gk in k.grid_keys:
                env[f"{n.ref}.{a.name}"] = grids[k.grid_keys.index(gk)][t]
        return env

    def src_val(src: int, t: int):
        if src == -1:
            return ev["__ts__"][t]
        if src == -2:
            return ev["__seq__"][t]
        return grids[src][t]

    def write(mask, pi: int, t: int):
        for g, r, src in k.cap_writes[pi]:
            v = src_val(src, t).to(caps[g].dtype)
            caps[g][r] = torch.where(mask, v, caps[g][r])

    def drain():
        nonlocal occ
        parked = occ == PARK
        rank = torch.cumsum(parked.to(torch.int32), 0) - parked.to(torch.int32)
        for e in range(E):
            sel = parked & (rank == e)
            lanes = torch.nonzero(sel.any(0)).flatten()
            if not len(lanes):
                continue
            slot = sel[:, lanes].to(torch.int8).argmax(0)
            emitted.append((
                torch.cat([caps["i"][:, slot, lanes],
                           head_seq[slot, lanes][None]]),
                caps["f"][:, slot, lanes], caps["l"][:, slot, lanes]))
        occ = torch.where(parked & (rank < E), torch.zeros_like(occ), occ)

    T = ev["__ts__"].shape[0]
    for t in range(T):
        ts, seq = ev["__ts__"][t], ev["__seq__"][t]
        valid = ev["__valid__"][t]
        sc = ev["__scode__"][t] if multi else None
        occ0 = occ
        age = ts[None, :] - first_ts
        expired = torch.zeros((A, P), dtype=torch.bool, device=dev)
        at_pos = []
        for pi, pos in enumerate(spec.positions):
            at = occ0 == pi + 1
            if pos.within_ms is not None:
                exp = at & valid[None, :] & (age > pos.within_ms)
                expired |= exp
                at = at & ~exp
            at_pos.append(at)
        env = None
        occ = occ0.clone()
        complete = torch.zeros((A, P), dtype=torch.bool, device=dev)
        trans = torch.zeros((A, P), dtype=torch.bool, device=dev)
        writes = []
        for pi in range(1, S):
            n = spec.positions[pi].node
            m = valid.clone()
            if multi:
                m &= sc == n.scode
            if masks[pi] is not None:
                m &= masks[pi][t]
            m = m[None, :].expand(A, P) & at_pos[pi]
            if k.step_trees[pi] is not None:
                if env is None:
                    env = caps_env()
                e2 = dict(env)
                e2.update(own_env(n, t))
                e2["__ts__"] = ts
                e2["__base_ts__"] = base
                m = m & _eval(k.step_trees[pi], e2).expand(A, P)
            trans |= m
            writes.append((m, pi))
            if pi == S - 1:
                complete |= m
            else:
                occ = torch.where(m, torch.full_like(occ, pi + 2), occ)
        dead = expired
        occ = torch.where(dead, torch.zeros_like(occ), occ)
        complete &= ~dead
        for m, pi in writes:
            write(m & ~dead, pi, t)
        occ = torch.where(complete, torch.full_like(occ, PARK), occ)
        if spec.is_sequence:
            started = (occ > 0) & (occ < PARK) & (first_ts != (1 << 30))
            kills = started & ~trans & valid[None, :]
            occ = torch.where(kills, torch.zeros_like(occ), occ)
        if k.parked:
            drain()
        n0 = spec.positions[0].node
        ok0 = armed0 & valid
        if multi:
            ok0 &= sc == n0.scode
        if masks[0] is not None:
            ok0 &= masks[0][t]
        if not spec.every_head:
            armed0 = armed0 & ~ok0
        if not k.parked:
            lanes = torch.nonzero(ok0).flatten()
            if len(lanes):
                rows = {g: torch.zeros((len(cap_rows[g]), len(lanes)),
                                       dtype=caps[g].dtype, device=dev)
                        for g in caps}
                for g, r, src in k.cap_writes[0]:
                    rows[g][r] = src_val(src, t)[lanes].to(caps[g].dtype)
                emitted.append((torch.cat([rows["i"], seq[lanes][None],
                                           ts[lanes][None],
                                           seq[lanes][None]]),
                                rows["f"], rows["l"]))
            continue
        free = occ == 0
        has_free = free.any(0)
        do = ok0 & has_free
        of_slots = of_slots + (ok0 & ~has_free).to(torch.int32)
        hot = free & (torch.cumsum(free.to(torch.int32), 0) == 1) & do[None]
        first_ts = torch.where(hot, ts[None, :], first_ts)
        head_seq = torch.where(hot, seq[None, :], head_seq)
        occ = torch.where(hot, torch.full_like(occ, 2), occ)
        write(hot, 0, t)
    if k.parked:
        for _ in range(-(-A // E)):
            drain()

    out = _alloc_out(k, M, dev)
    n = sum(e[0].shape[1] for e in emitted)
    if emitted:
        for key, idx in (("out_i", 0), ("out_f", 1), ("out_l", 2)):
            rows = torch.cat([e[idx] for e in emitted], 1)[:, :M]
            out[key][:, :rows.shape[1]] = rows
    out["meta"][0] = n
    out["meta"][1] = of_slots.sum()
    return ({"occ": occ, "first_ts": first_ts, "head_seq": head_seq,
             "caps_f": caps["f"], "caps_i": caps["i"], "caps_l": caps["l"],
             "armed0": armed0, "of_slots": of_slots}, out)
