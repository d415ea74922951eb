"""K2 `nfa_block`: the sequential batched NFA over one (T, P) event block.

Replaces the jitted `_block_impl` of the JAX package
(siddhi_tpu/core/nfa_device.py:1486, 1560): `lax.scan` over T of `_step`
(:726) with `_alloc_head` (:1328) and the E-lane `_drain_done` (:1428),
ceil(A/E) drain rounds after the scan (:1581-1592), the cumsum + scatter
compaction of emissions into a flat (M,) buffer, and the earliest live
deadline (:1649-1656).

Design (csrc/nfa_block.cu): one warp per partition lane, one thread per
slot (a thread loops over A/32 slots when slot growth took A past 32).
The T loop runs inside the kernel with slot stations in registers and
capture and deadline rows in shared memory; the two-phase commit of
`_step` holds because every slot reads only its own captures and the
pre-event station.  Per event and slot, in the reference order: absent
deadlines at or before the event's timestamp fire first (`dl_fire`: on
timer ticks, and on events under `@app:playback`), advancing the slot or
completing it with the deadline as its timestamp; lazy `within` expiry
(on events and ticks); the station test (stream, pre-mask bit,
capture-dependent conjuncts through the VM of csrc/expr_vm.cuh), where a
forbidden arrival kills an absent station; capture writes; entering an
absent position arms its deadline.  Head allocation takes the lowest
free slot (`__ballot_sync` + `__ffs`, the `cumsum == 1` rule at
nfa_device.py:1097) after advances and drains; the drain ranks parked
slots with a ballot and `__popc` and emits the first E.  Matches append
to the (M,) rows through one atomicAdd per warp; the host sorts by (seq,
head_seq), so their order inside the buffer does not matter.  The kernel
reads `state_in` and writes a fresh `state_out`: an M overflow or slot
exhaustion is retried by the plan from the old state, as the functional
JAX state allows.  Fused multi-query lanes read broadcast (T, 1) event
grids (the lane's pre-masks stay (T, P)), their `__qparam` operands at
the warp's lane, and emit the lane as `__qid__`.  Per-position tables,
column pointers and the programs travel in a device table
(kernels/table.py); each block stages the programs in shared memory.

Bound on the H100: bytes -- the grids, the state in and out and the match
rows, each moved once, over 3.35 TB/s.  Its real limit is the T-long
chain of dependent steps inside each warp: the kernel cannot finish
before one warp has walked T events.

`nfa_block()` launches the kernel for CUDA tensors and runs the plain
version, `nfa_block_plain()` (a Python loop over T of vector ops on
(A, P) tensors, mirroring `_step`), for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.expr import VT_OF_TORCH, Node
from ..core.nfa_device import NO_DEADLINE, NO_FIRST
from ..query.ast import AttrType
from .build import load
from .expr_eval import merge_programs, program_table, stage_bytes, \
    unpack_mask
from .table import DeviceTable, Launch, checked_ptr, stream_of

MAX_A = 512                         # nfa_block.cu: A/32 slots per thread
_GROUP = {"f": 0, "i": 1, "l": 2}
_STATE = ("occ", "first_ts", "head_seq", "caps_f", "caps_i", "caps_l",
          "dl", "armed0", "of_slots")


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "T", "P", "A", "S", "E", "is_seq", "every_head", "multi", "Kf",
        "Ki", "Kl", "Ka", "C", "M", "ts_slot", "wpb", "bcast", "playback",
        "emit_qid", "comp_ts_row", "comp_seq_row", "n_words", "n_consts",
        "stage", "prog_bytes", "pad0")] + [(n, ctypes.c_void_p) for n in (
        "ts", "seq", "valid", "tick", "scode", "qparams", "ev", "ev_vt",
        "pos_scode", "pos_within", "pos_kind", "pos_dl_row",
        "pos_waiting", "pre", "prog_off", "prog_len", "cw_off", "cw_len",
        "cw_group", "cw_row", "cw_src",
        *[f"{k}_in" for k in _STATE], *[f"{k}_out" for k in _STATE],
        "out_i", "out_f", "out_l", "meta", "consts", "words")]


def _alloc_out(k, M: int, dev, rows=torch.zeros) -> dict:
    """Match rows, allocated by `rows` (the kernel writes only the first
    meta[0] columns and takes torch.empty), and the meta counts [matches,
    dropped heads, earliest live deadline]."""
    return {"out_i": rows((len(k.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(k.rows_f), M), dtype=torch.float32,
                          device=dev),
            "out_l": rows((len(k.rows_l), M), dtype=torch.int64, device=dev),
            "meta": torch.tensor([0, 0, NO_DEADLINE], dtype=torch.int32,
                                 device=dev)}


def nfa_block(k, state: dict, ev: dict, pre: list, M: int):
    """Run one block of NFAKernel `k`: (state', out).  `pre` holds the
    bit-packed pre-mask words per chain node (or None)."""
    dev = state["occ"].device
    if dev.type == "cpu":
        T = ev["__ts__"].shape[0]
        masks = [None if w is None else unpack_mask(w, T * k.P).view(T, k.P)
                 for w in pre]
        return nfa_block_plain(k, state, ev, masks, M)
    return prepare(k, state, ev, pre, M)()


def prepare(k, state: dict, ev: dict, pre: list, M: int) -> Launch:
    """Allocate state out and match rows and upload the parameter table
    of one K2 launch (see `nfa_block`)."""
    dev = state["occ"].device
    if dev.type != "cuda":
        raise ValueError(f"nfa_block: unsupported device {dev}")
    T, G = ev["__ts__"].shape
    spec = k.spec
    if G not in (k.P, 1) or state["occ"].shape != (k.A, k.P):
        raise ValueError("nfa_block: grid/state shape does not match kernel")
    if k.A > MAX_A:
        raise ValueError(f"nfa_block: A={k.A} exceeds {MAX_A} slots")
    p = _Params()
    p.T, p.P, p.A, p.S, p.E = T, k.P, k.A, spec.S, k.E
    p.is_seq, p.every_head = int(spec.is_sequence), int(spec.every_head)
    p.multi = int(len(spec.stream_ids) > 1)
    p.Kf, p.Ki, p.Kl, p.Ka = (len(k.rows_f), len(k.rows_i), len(k.rows_l),
                              k.Ka)
    p.C, p.M, p.ts_slot = len(k.grid_keys), M, k.ts_slot
    p.bcast = int(G == 1 and k.P > 1)
    p.playback, p.emit_qid = int(k.playback), int(k.broadcast)
    p.comp_ts_row, p.comp_seq_row = k.comp_rows()
    keep: list = []
    ptr = checked_ptr(keep, dev, "nfa_block")
    p.ts = ptr(ev["__ts__"], torch.int32)
    p.seq = ptr(ev["__seq__"], torch.int32)
    p.valid = ptr(ev["__valid__"], torch.bool)
    if "__tick__" in ev:
        p.tick = ptr(ev["__tick__"], torch.bool)
    if p.multi:
        p.scode = ptr(ev["__scode__"], torch.int32)
    if k.params is not None:
        p.qparams = ptr(k.params.bits, torch.int64)
    tab = DeviceTable()
    tab.field(p, "ev", [ptr(ev[key]) for key in k.grid_keys] or [0], "u8")
    tab.field(p, "ev_vt", [VT_OF_TORCH[ev[key].dtype]
                           for key in k.grid_keys] or [0], "i4")
    pos = spec.positions
    tab.field(p, "pos_scode", [q.node.scode for q in pos], "i4")
    tab.field(p, "pos_within", [-1 if q.within_ms is None else q.within_ms
                                for q in pos], "i4")
    tab.field(p, "pos_kind", [int(q.node.kind == "absent") for q in pos],
              "i4")
    tab.field(p, "pos_dl_row", [-1 if q.dl_row is None else q.dl_row
                                for q in pos], "i4")
    tab.field(p, "pos_waiting", [q.node.waiting_ms or 0 for q in pos], "i4")
    tab.field(p, "pre", [0 if w is None else ptr(w, torch.int32)
                         for w in pre], "u8")
    progs, pidx = [], []
    for pi in range(spec.S):
        if k.step_progs[pi] is not None:
            pidx.append(pi)
            progs.append(k.step_progs[pi])
    words, consts, offs, lens = merge_programs(
        progs, {"__base_ts__": ev["__base_ts__"]})
    off, ln = [0] * spec.S, [0] * spec.S
    for pi, o, n in zip(pidx, offs, lens):
        off[pi], ln[pi] = o, n
    tab.field(p, "prog_off", off, "i4")
    tab.field(p, "prog_len", ln, "i4")
    program_table(tab, p, words, consts)
    p.prog_bytes = stage_bytes(words, consts) if p.stage else 0
    cw_off, cw_len, cw = [], [], []
    for writes in k.cap_writes:
        cw_off.append(len(cw))
        cw_len.append(len(writes))
        cw.extend(writes)
    tab.field(p, "cw_off", cw_off, "i4")
    tab.field(p, "cw_len", cw_len, "i4")
    tab.field(p, "cw_group", [_GROUP[g] for g, _r, _s in cw] or [0], "i4")
    tab.field(p, "cw_row", [r for _g, r, _s in cw] or [0], "i4")
    tab.field(p, "cw_src", [s for _g, _r, s in cw] or [0], "i4")
    new = {key: torch.empty_like(state[key]) for key in _STATE}
    for key in _STATE:
        setattr(p, f"{key}_in", ptr(state[key]))
        setattr(p, f"{key}_out", ptr(new[key]))
    out = _alloc_out(k, M, dev, torch.empty)
    meta0 = out["meta"].clone()
    p.out_i, p.out_f, p.out_l, p.meta = (ptr(out["out_i"]),
                                         ptr(out["out_f"]),
                                         ptr(out["out_l"]),
                                         ptr(out["meta"]))
    keep.append(tab.upload(dev))
    lib = load("nfa_block")
    fn = lib.nfa_block_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        out["meta"].copy_(meta0)
        return fn(ctypes.byref(p), stream_of(dev))
    return Launch(run, "nfa_block_launch", "nfa_block", keep + [meta0],
                  (new, out))


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
    dl = state["dl"].clone()
    armed0 = state["armed0"].clone()
    of_slots = state["of_slots"].clone()
    multi = len(spec.stream_ids) > 1
    base = torch.tensor(ev["__base_ts__"], dtype=torch.int64)
    T = ev["__ts__"].shape[0]

    def grid(key):                  # broadcast (T, 1) events -> (T, P)
        return ev[key].expand(T, P)
    grids = [grid(key) for key in k.grid_keys]
    ts_g, seq_g, valid_g = grid("__ts__"), grid("__seq__"), grid("__valid__")
    tick_g = grid("__tick__") if "__tick__" in ev else None
    sc_g = grid("__scode__") if multi else None
    qenv = k.params.env() if k.params is not None else {}
    lanes_all = torch.arange(P, dtype=torch.int32, device=dev)
    comp_ts_row, comp_seq_row = k.comp_rows()
    emitted: list = []          # (i rows, f rows, l rows) per emission
    cap_rows = {"f": k.rows_f, "i": k.rows_i, "l": k.rows_l}
    no_dl = torch.full_like(dl, NO_DEADLINE)

    def caps_env() -> dict:
        env = dict(qenv)
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
            return ts_g[t]
        if src == -2:
            return seq_g[t]
        return grids[src][t]

    def write(mask, pi: int, t: int):
        for g, r, src in k.cap_writes[pi]:
            v = src_val(src, t).to(caps[g].dtype)
            caps[g][r] = torch.where(mask, v, caps[g][r])

    def enter(tpi: int, mask, at):
        """Arm the deadline of absent position tpi for slots `mask`
        entering it, one waiting period after `at` (_enter_position)."""
        r = spec.positions[tpi].dl_row
        if r is not None:
            w = spec.positions[tpi].node.waiting_ms
            dl[r] = torch.where(mask, at + w, dl[r])

    def node_match(pi: int, t: int, env):
        n = spec.positions[pi].node
        m = valid_g[t].clone()
        if multi:
            m &= sc_g[t] == n.scode
        if masks[pi] is not None:
            m &= masks[pi][t]
        m = m[None, :].expand(A, P)
        if k.step_trees[pi] is not None:
            e2 = dict(env)
            e2.update(own_env(n, t))
            e2["__ts__"] = ts_g[t]
            e2["__base_ts__"] = base
            m = m & _eval(k.step_trees[pi], e2).expand(A, P)
        return m

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
            irows = [caps["i"][:, slot, lanes], head_seq[slot, lanes][None]]
            if k.broadcast:
                irows.append(lanes_all[lanes][None])
            emitted.append((torch.cat(irows), caps["f"][:, slot, lanes],
                            caps["l"][:, slot, lanes]))
        occ = torch.where(parked & (rank < E), torch.zeros_like(occ), occ)

    for t in range(T):
        ts, seq, valid = ts_g[t], seq_g[t], valid_g[t]
        tick = tick_g[t] if tick_g is not None else None
        timey = valid if tick is None else (valid | tick)
        dl_fire = timey if k.playback else (
            tick if tick is not None else torch.zeros_like(valid))
        sc = sc_g[t] if multi else None
        occ0 = occ
        age = ts[None, :] - first_ts
        # absent deadlines at or before this timestamp fire BEFORE the
        # event: the slot advances (or completes with the deadline as
        # its timestamp) and can consume this very event downstream
        complete = torch.zeros((A, P), dtype=torch.bool, device=dev)
        pre_done = []
        for pi, pos in enumerate(spec.positions):
            if pos.node.kind != "absent" or pos.dl_row is None:
                continue
            r = pos.dl_row
            due = (occ0 == pi + 1) & (dl[r] <= ts[None, :]) & \
                dl_fire[None, :]
            dl_at = dl[r].clone()
            if pi == S - 1:
                complete |= due
                pre_done.append((due, dl_at))
            else:
                occ0 = torch.where(due, torch.full_like(occ0, pi + 2), occ0)
                enter(pi + 1, due, dl_at)
            dl[r] = torch.where(due, torch.full_like(dl_at, NO_DEADLINE),
                                dl[r])
        expired = torch.zeros((A, P), dtype=torch.bool, device=dev)
        at_pos = []
        for pi, pos in enumerate(spec.positions):
            at = occ0 == pi + 1
            if pos.within_ms is not None:
                exp = at & timey[None, :] & (age > pos.within_ms)
                expired |= exp
                at = at & ~exp
            at_pos.append(at)
        env = caps_env()
        occ = occ0.clone()
        trans = torch.zeros((A, P), dtype=torch.bool, device=dev)
        kill = torch.zeros((A, P), dtype=torch.bool, device=dev)
        writes, enters = [], []
        for pi in range(1, S):
            m = at_pos[pi] & node_match(pi, t, env)
            if spec.positions[pi].node.kind == "absent":
                kill |= m               # a forbidden arrival
                continue
            trans |= m
            writes.append((m, pi))
            if pi == S - 1:
                complete |= m
            else:
                occ = torch.where(m, torch.full_like(occ, pi + 2), occ)
                enters.append((pi + 1, m))
        dead = expired | kill
        occ = torch.where(dead, torch.zeros_like(occ), occ)
        dl = torch.where(dead[None], no_dl, dl)
        complete &= ~dead
        for m, dl_at in pre_done:
            m = m & ~dead
            caps["i"][comp_ts_row] = torch.where(m, dl_at,
                                                 caps["i"][comp_ts_row])
            caps["i"][comp_seq_row] = torch.where(
                m, seq[None, :].expand(A, P), caps["i"][comp_seq_row])
        for m, pi in writes:
            write(m & ~dead, pi, t)
        occ = torch.where(complete, torch.full_like(occ, PARK), occ)
        for tpi, m in enters:
            enter(tpi, m & ~dead, ts[None, :])
        if spec.is_sequence:
            started = (occ > 0) & (occ < PARK) & (first_ts != NO_FIRST)
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
                irows = [rows["i"], seq[lanes][None]]
                if k.broadcast:
                    irows.append(lanes_all[lanes][None])
                emitted.append((torch.cat(irows + [ts[lanes][None],
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
        dl = torch.where(hot[None], no_dl, dl)
        write(hot, 0, t)
        enter(1, hot, ts[None, :])
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
    live = (occ > 0) & (occ <= S)
    if k.Ka and bool(live.any()):
        out["meta"][2] = torch.where(live[None], dl, no_dl).min()
    return ({"occ": occ, "first_ts": first_ts, "head_seq": head_seq,
             "caps_f": caps["f"], "caps_i": caps["i"], "caps_l": caps["l"],
             "dl": dl, "armed0": armed0, "of_slots": of_slots}, out)
