"""K2 `nfa_block`: the sequential batched NFA over one (T, P) event block.

Replaces the jitted `_block_impl` of the JAX package
(siddhi_tpu/core/nfa_device.py:1486, 1560): `lax.scan` over T of `_step`
(:726) with `_alloc_head` (:1328) and the E-lane `_drain_done` (:1428),
ceil(A/E) drain rounds after the scan (:1581-1592), the cumsum + scatter
compaction of emissions into a flat (M,) buffer, and the earliest live
deadline (:1649-1656).  The whole pattern algebra of the JAX step: absent
deadlines, count collection (station-independent, `:886-945`), the
epsilon cascade of min-0 counts (`_landing_from` :1157), adjacent
counts, the logical station with absent sides (`_logical_step` :1259),
indexed captures and presence rows (`_count_capture_values` :1212,
`_present_zero` :1169), a final count's direct emissions through the E
lanes (`of_lanes`, :1034-1080), the init slot (`:751-790`, `NO_FIRST`
until the first capture, `:1062-1066`) and slot forking (`_fork_slots`
:1117) for `every` around an absent state (the deadline pre-pass,
`:800-860`, and the re-arming arrival, `:971-980`) and `every` on a
stream position below the head (`:1004-1015`).

Design (csrc/nfa_block.cuh, launched from csrc/nfa_block.cu for up to 4
slots a thread and csrc/nfa_block_wide.cu for 8 or 16, from
nfa_block_ext.cu and nfa_block_wide_ext.cu for EXT, and in chunk mode up
to 4 slots a thread from nfa_block_chunk.cu and nfa_block_chunk_ext.cu,
so the `seq` blocks' instantiations carry none of its code): one warp per
partition lane, one thread per slot (a thread loops over A/32 slots when
slot growth took A past 32).  Three instantiations a slot width, chosen
at launch from the chain: the chain step (stream and absent positions),
the algebra step (counts, logicals) and EXT (an init slot, an `every`
below the head, an absent logical side; launches counted apart as
`nfa_block:ext`).  EXT runs the JAX step phase by phase over the
thread's slots with the capture writes deferred to the end of the step,
as JAX defers them; a fork is a warp-wide exchange: sources and free
slots ranked by slot index (ballot + popc), the sources' registers staged
in shared memory, the k-th source's rows copied column to column into
the k-th free slot; clones without one count into `of_slots` and meta[4],
and the plan grows A and re-runs the block.  The init slot is slot 0,
armed by the thread that owns it.
The T loop runs inside the kernel with slot stations, count and logical
flags in registers and capture, counter and deadline rows in shared
memory.  Every step of `_step` is per slot but for the head allocation
and the drain, so each thread runs the JAX step's statements in their
order on its own slots: first every node match (the capture-dependent
conjuncts through the VM of csrc/expr_vm.cuh, on the captures as they
were before the event), then the deadline pre-pass, expiry, count
collection, the stations, the deaths, captures, completions and entries.
A capture write that JAX defers to the end of the step is applied at
once unless the slot dies in that step; the only write whose value
another write of the same step would read -- a count's collection and
its adjacent-count entry in one event -- is left to the entry, which
overwrites every row the collection writes.  Head allocation takes the
lowest free slot (`__ballot_sync` + `__ffs`, the `cumsum == 1` rule at
nfa_device.py:1097) after advances and drains; the drain ranks parked
slots and still-collecting completions with a ballot and `__popc` and
emits the first E, counting the completions that found no lane.
Matches append to the (M,) rows through one atomicAdd per warp; the host
sorts by (seq, head_seq), so their order inside the buffer does not
matter.  The kernel reads `state_in` and writes a fresh `state_out`: an
M overflow, slot exhaustion or lane overflow is retried by the plan from
the old state, as the functional JAX state allows.  Fused multi-query
lanes read broadcast (T, 1) event grids (the lane's pre-masks stay (T,
P)), their `__qparam` operands at the warp's lane, and emit the lane as
`__qid__`.  Chunk blocks (the `chunk` family, `_expand_flat` and the
replay dedup of the JAX package, nfa_device.py:1529, :1598-1604) carry
flat (F,) events and `__chunk__` = (T, CS, nev, prev_seq): warp l reads
event l*CS + t, clipped to F - 1 (valid while below nev), arms heads only
for t < CS, and writes no completion at or before prev_seq; their
launches count as `nfa_block:chunk`.  Per-position, per-node and capture-write tables, column
pointers and the programs travel in a device table (kernels/table.py);
each block stages the programs in shared memory.

Bound on the H100: bytes -- the grids, the state in and out and the match
rows, each moved once, over 3.35 TB/s.  Its real limit is the T-long
chain of dependent steps inside each warp: the kernel cannot finish
before one warp has walked T events.

`nfa_block()` launches the kernel for CUDA tensors and runs the plain
version, `nfa_block_plain()` (a Python loop over T of vector ops on
(A, P) tensors, mirroring `_step` statement for statement), for CPU
tensors.  A failed build or launch raises; nothing falls back.  Both read the
capture-write tables of NFAKernel (`capture_values`,
`count_capture_values`, `presence_rows`).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.expr import VT_OF_TORCH, Node
from ..core.nfa_device import (K_ABSENT, K_COUNT, K_LOGICAL, K_STREAM,
                               NO_DEADLINE, NO_FIRST, W_IDX, W_ONE,
                               W_PRES_GE, W_PREV, W_SRC)
from ..query.ast import AttrType
from .build import load
from .expr_eval import merge_programs, program_table, stage_bytes, \
    unpack_mask
from .table import DeviceTable, Launch, checked_ptr, stream_of

MAX_A = 512                         # nfa_block.cuh: A/32 slots a thread
_STATE = ("occ", "first_ts", "head_seq", "cnt", "cnt_on", "narm", "fl",
          "caps_f", "caps_i", "caps_l", "dl", "armed0", "of_slots",
          "of_lanes", "init")


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "T", "P", "A", "S", "E", "is_seq", "every_head", "multi", "Kf",
        "Ki", "Kl", "Ka", "Kc", "Klog", "C", "M", "ts_slot", "wpb", "bcast",
        "playback", "emit_qid", "comp_ts_row", "comp_seq_row", "n_words",
        "n_consts", "stage", "prog_bytes", "parked", "all_pz_off",
        "all_pz_len", "ext", "needs_init", "init_on_tick", "has_anchor",
        "anchor", "init_land", "chunk", "cs", "nflat", "nev",
        "prev_seq")] + [(n, ctypes.c_void_p) for n in (
        "ts", "seq", "valid", "tick", "scode", "qparams", "ev", "ev_vt",
        "pos_kind", "pos_node", "pos_within", "pos_dl_row", "pos_waiting",
        "pos_min", "pos_max", "pos_cnt", "pos_log", "pos_or", "pos_land",
        "pos_pz_off", "pos_pz_len", "node_scode", "node_pre",
        "node_prog_off", "node_prog_len", "node_cw_off", "node_cw_len",
        "node_cc_off", "node_cc_len", "node_pres", "w_group", "w_row",
        "w_mode", "w_src", "w_arg", "pz_rows",
        *[f"{k}_in" for k in _STATE], *[f"{k}_out" for k in _STATE],
        "out_i", "out_f", "out_l", "meta", "consts", "words",
        "pos_sticky", "node_dl", "node_wait", "node_absent")]


def _alloc_out(k, M: int, dev, rows=torch.zeros) -> dict:
    """Match rows, allocated by `rows` (the kernel writes only the first
    meta[0] columns and takes torch.empty), and the meta counts [matches,
    dropped heads and clones so far, earliest live deadline, lost direct
    emissions, clones of this block that found no free slot]."""
    return {"out_i": rows((len(k.lane_names_i), M), dtype=torch.int32,
                          device=dev),
            "out_f": rows((len(k.rows_f), M), dtype=torch.float32,
                          device=dev),
            "out_l": rows((len(k.rows_l), M), dtype=torch.int64, device=dev),
            "meta": torch.tensor([0, 0, NO_DEADLINE, 0, 0],
                                 dtype=torch.int32, device=dev)}


def nfa_block(k, state: dict, ev: dict, pre: list, M: int):
    """Run one block of NFAKernel `k`: (state', out).  `pre` holds the
    bit-packed pre-mask words per chain node (or None): over the (T, P)
    grid, or over the F flat events of a chunk block."""
    dev = state["occ"].device
    if dev.type == "cpu":
        F = ev["__ts__"].shape[0]
        if "__chunk__" in ev:
            masks = [None if w is None else unpack_mask(w, F) for w in pre]
        else:
            masks = [None if w is None else
                     unpack_mask(w, F * k.P).view(F, k.P) for w in pre]
        return nfa_block_plain(k, state, ev, masks, M)
    return prepare(k, state, ev, pre, M)()


def chunk_grids(k, ev: dict, masks: list) -> tuple:
    """A chunk block's (T, K) grids, gathered from its flat (F,) events:
    lane l reads events [l*CS, l*CS + T), clipped to F - 1
    (`_expand_flat` of the JAX package); `__valid__` is flat index < nev,
    and the returned (T, 1) `can_start` marks the lane's own range (t <
    CS: a halo event extends pending matches but arms no head)."""
    T, cs, nev, _prev = ev["__chunk__"]
    F = ev["__ts__"].shape[0]
    dev = ev["__ts__"].device
    t = torch.arange(T, device=dev)[:, None]
    idx = torch.arange(k.P, device=dev)[None, :] * cs + t
    safe = torch.clamp(idx, max=F - 1)
    out = {key: v[safe] for key, v in ev.items()
           if isinstance(v, torch.Tensor) and v.dim() == 1}
    out["__valid__"] = idx < nev
    out["__base_ts__"] = ev["__base_ts__"]
    return out, [None if m is None else m[safe] for m in masks], t < cs


def pos_kind(pos) -> int:
    if pos.op is not None:
        return K_LOGICAL
    if pos.is_count:
        return K_COUNT
    return K_ABSENT if pos.node.kind == "absent" else K_STREAM


def prepare(k, state: dict, ev: dict, pre: list, M: int) -> Launch:
    """Allocate state out and match rows and upload the parameter table
    of one K2 launch (see `nfa_block`)."""
    dev = state["occ"].device
    if dev.type != "cuda":
        raise ValueError(f"nfa_block: unsupported device {dev}")
    chunk = ev.get("__chunk__")
    T, G = (chunk[0], 1) if chunk is not None else ev["__ts__"].shape
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
    p.Kc, p.Klog = k.Kc, k.Kl
    p.C, p.M, p.ts_slot = len(k.grid_keys), M, k.ts_slot
    p.bcast = int(G == 1 and k.P > 1 and chunk is None)
    # chunk lanes: lane l reads flat events l*CS + t, arms heads for t <
    # CS and drops completions at or before the previous flush's last seq
    p.prev_seq = -(1 << 31)
    if chunk is not None:
        p.chunk, p.cs, p.nev, p.prev_seq = 1, chunk[1], chunk[2], chunk[3]
        p.nflat = ev["__ts__"].shape[0]
    p.playback, p.emit_qid = int(k.playback), int(k.broadcast)
    p.comp_ts_row, p.comp_seq_row = k.comp_rows()
    p.parked = int(k.parked)
    p.all_pz_off, p.all_pz_len = k.all_pz
    p.ext, p.needs_init = int(k.ext), int(k.needs_init)
    p.init_on_tick, p.init_land = int(k.init_on_tick), k.landing(-1)
    if "__anchor__" in ev:
        p.has_anchor, p.anchor = 1, int(ev["__anchor__"])
    keep: list = []
    ptr = checked_ptr(keep, dev, "nfa_block")
    p.ts = ptr(ev["__ts__"], torch.int32)
    p.seq = ptr(ev["__seq__"], torch.int32)
    if chunk is None:
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
    for name, vals in (
            ("pos_kind", [pos_kind(q) for q in pos]),
            ("pos_node", k.pos_node),
            ("pos_within", [-1 if q.within_ms is None else q.within_ms
                            for q in pos]),
            ("pos_dl_row", [q.dl_rows.get(0, -1) if pos_kind(q) == K_ABSENT
                            else -1 for q in pos]),
            ("pos_waiting", [q.node.waiting_ms or 0 for q in pos]),
            ("pos_sticky", [int(q.sticky) for q in pos]),
            ("pos_min", [q.min_count for q in pos]),
            ("pos_max", [q.max_count for q in pos]),
            ("pos_cnt", [-1 if q.cnt_row is None else q.cnt_row
                         for q in pos]),
            ("pos_log", [-1 if q.log_row is None else q.log_row
                         for q in pos]),
            ("pos_or", [int(q.op == "or") for q in pos]),
            ("pos_land", [k.landing(pi) if pi < spec.S - 1 else -1
                          for pi in range(spec.S)]),
            ("pos_pz_off", [o for o, _n in k.pos_pz]),
            ("pos_pz_len", [n for _o, n in k.pos_pz])):
        tab.field(p, name, vals, "i4")
    nodes = spec.all_nodes
    tab.field(p, "node_scode", [n.scode for n in nodes], "i4")
    tab.field(p, "node_dl", [q.dl_rows.get(ni, -1) for q in pos
                             for ni in range(len(q.nodes))], "i4")
    tab.field(p, "node_wait", [n.waiting_ms or 0 for n in nodes], "i4")
    tab.field(p, "node_absent", [int(n.kind == "absent") for n in nodes],
              "i4")
    tab.field(p, "node_pre", [0 if w is None else ptr(w, torch.int32)
                              for w in pre], "u8")
    progs, gidx = [], []
    for gi, prog in enumerate(k.step_progs):
        if prog is not None:
            gidx.append(gi)
            progs.append(prog)
    words, consts, offs, lens = merge_programs(
        progs, {"__base_ts__": ev["__base_ts__"]})
    off, ln = [0] * len(nodes), [0] * len(nodes)
    for gi, o, n in zip(gidx, offs, lens):
        off[gi], ln[gi] = o, n
    tab.field(p, "node_prog_off", off, "i4")
    tab.field(p, "node_prog_len", ln, "i4")
    program_table(tab, p, words, consts)
    p.prog_bytes = stage_bytes(words, consts) if p.stage else 0
    for name, vals in (("node_cw_off", [o for o, _n in k.node_cw]),
                       ("node_cw_len", [n for _o, n in k.node_cw]),
                       ("node_cc_off", [o for o, _n in k.node_cc]),
                       ("node_cc_len", [n for _o, n in k.node_cc]),
                       ("node_pres", k.node_pres_row)):
        tab.field(p, name, vals, "i4")
    for i, name in enumerate(("w_group", "w_row", "w_mode", "w_src",
                              "w_arg")):
        tab.field(p, name, [w[i] for w in k.writes] or [0], "i4")
    tab.field(p, "pz_rows", k.pz_rows or [0], "i4")
    new = {key: torch.empty_like(state[key]) for key in _STATE
           if key in state}
    for key in new:
        setattr(p, f"{key}_in", ptr(state[key]))
        setattr(p, f"{key}_out", ptr(new[key]))
    out = _alloc_out(k, M, dev, torch.empty)
    meta0 = out["meta"].clone()
    p.out_i, p.out_f, p.out_l, p.meta = (ptr(out["out_i"]),
                                         ptr(out["out_f"]),
                                         ptr(out["out_l"]),
                                         ptr(out["meta"]))
    keep.append(tab.upload(dev))
    # csrc/nfa_block[_chunk|_wide][_ext].cu: 8-16 slots a thread past A =
    # 128 (chunk mode or not); up to 128, chunk mode and the EXT
    # instantiation each apart from the others
    name = "nfa_block" + ("_wide" if k.A > 128 else
                          "_chunk" if chunk is not None else "") + \
        ("_ext" if k.ext else "")
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        out["meta"].copy_(meta0)
        return fn(ctypes.byref(p), stream_of(dev))
    use = "nfa_block:chunk" if chunk is not None else \
        "nfa_block:ext" if k.ext else "nfa_block"
    return Launch(run, "nfa_block_launch", use, keep + [meta0], (new, out))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _eval(tree: Node, env: dict):
    from ..core.expr import F32_MODE, compute_dtypes, eval_node
    with compute_dtypes(F32_MODE):
        return eval_node(tree, env)


def nfa_block_plain(k, state: dict, ev: dict, masks: list, M: int):
    """Python loop over T of (A, P) vector ops -- `_step` of the JAX
    package, statement for statement, then ceil(A/E) drain rounds;
    emissions are compacted in (step, lane, partition) order.  A chunk
    block (`__chunk__` = (T, CS, nev, prev_seq) over flat (F,) events and
    masks) is gathered into its (T, K) lane grids first; its heads arm
    only in the lane's own range, and completions at or before prev_seq
    are dropped before the compaction."""
    can_start, prev_seq = None, None
    if "__chunk__" in ev:
        prev_seq = ev["__chunk__"][3]
        ev, masks, can_start = chunk_grids(k, ev, masks)
    spec, A, P, S, E = k.spec, k.A, k.P, k.S, k.E
    PARK = S + 1
    dev = state["occ"].device
    st = {key: state[key].clone() for key in _STATE if key in state}
    occ, first_ts, head_seq = st["occ"], st["first_ts"], st["head_seq"]
    cnt, cnt_on, narm, fl, dl = (st["cnt"], st["cnt_on"], st["narm"],
                                 st["fl"], st["dl"])
    caps = {"f": st["caps_f"], "i": st["caps_i"], "l": st["caps_l"]}
    groups = "fil"
    armed0, of_slots, of_lanes = st["armed0"], st["of_slots"], \
        st["of_lanes"]
    init = st.get("init")
    fork_lost = 0
    nodes = spec.all_nodes
    multi = len(spec.stream_ids) > 1
    base = torch.tensor(ev["__base_ts__"], dtype=torch.int64)
    T = ev["__ts__"].shape[0]

    def grid(key):                  # broadcast (T, 1) events -> (T, P)
        return ev[key].expand(T, P)
    grids = [grid(key) for key in k.grid_keys]
    ts_g, seq_g, valid_g = grid("__ts__"), grid("__seq__"), grid("__valid__")
    tick_g = grid("__tick__") if "__tick__" in ev else None
    sc_g = grid("__scode__") if multi else None
    anchor = ev.get("__anchor__")
    qenv = k.params.env() if k.params is not None else {}
    lanes_all = torch.arange(P, dtype=torch.int32, device=dev)
    slot0 = (torch.arange(A, device=dev) == 0)[:, None]
    comp_ts_row, comp_seq_row = k.comp_rows()
    emitted: list = []          # (i rows, f rows, l rows) per emission
    no_dl = torch.full_like(dl, NO_DEADLINE)
    zeros_ap = torch.zeros((A, P), dtype=torch.bool, device=dev)

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

    def base_match(gi: int, t: int):
        """(P,) stream, validity and pre-mask of node gi at step t."""
        m = valid_g[t].clone()
        if multi:
            m &= sc_g[t] == nodes[gi].scode
        if masks[gi] is not None:
            m &= masks[gi][t]
        return m

    def node_match(gi: int, t: int, env):
        m = base_match(gi, t)[None, :].expand(A, P)
        if k.step_trees[gi] is not None:
            e2 = dict(env)
            e2.update(own_env(nodes[gi], t))
            e2["__ts__"] = ts_g[t]
            e2["__base_ts__"] = base
            m = m & _eval(k.step_trees[gi], e2).expand(A, P)
        return m

    def write(mask, span: tuple, t: int, newc=None, comp=None):
        """Capture writes of one table span for the slots in `mask`; every
        value is computed before any row is written (a [last-1] reads the
        old [last]); `comp` = (ts, seq) of the completion, when any."""
        off, n = span
        vals = []
        for g_i, r, mode, src, arg in k.writes[off:off + n]:
            g = groups[g_i]
            cur = caps[g][r]
            if mode == W_SRC:
                v = grids[src][t].to(cur.dtype)[None, :].expand(A, P)
            elif mode == W_ONE:
                v = torch.ones_like(cur)
            elif mode == W_PREV:
                v = caps[g][arg]
            elif mode == W_IDX:
                v = torch.where(newc == arg,
                                grids[src][t].to(cur.dtype)[None, :], cur)
            else:
                assert mode == W_PRES_GE
                v = torch.where(newc >= arg, torch.ones_like(cur), cur)
            vals.append((g, r, v))
        if comp is not None:
            vals.append(("i", comp_ts_row, comp[0]))
            vals.append(("i", comp_seq_row, comp[1]))
        for g, r, v in vals:
            caps[g][r] = torch.where(mask, v.to(caps[g].dtype)
                                     .expand(A, P), caps[g][r])

    def zero_rows(mask, rows):
        for r in rows:
            caps["i"][r] = torch.where(mask, torch.zeros_like(caps["i"][r]),
                                       caps["i"][r])

    def pz(span):
        off, n = span
        return k.pz_rows[off:off + n]

    def enter(tpi: int, mask, at):
        """State rows of slots `mask` entering position tpi
        (`_enter_position`): a count starts collecting (a min-0 count
        below the final position arms its successor at once), a logical
        pair clears its fill bits, each absent node with a waiting time
        arms its deadline one period after `at`."""
        nonlocal cnt, cnt_on, narm
        tpos = spec.positions[tpi]
        if tpos.is_count:
            c = tpos.cnt_row
            cnt[c] = torch.where(mask, torch.zeros_like(cnt[c]), cnt[c])
            cnt_on[c] = cnt_on[c] | mask
            eps = tpos.min_count == 0 and tpi < S - 1
            narm[c] = torch.where(mask, torch.full_like(narm[c], eps),
                                  narm[c])
        if tpos.log_row is not None:
            r = tpos.log_row
            fl[r] = torch.where(mask, torch.zeros_like(fl[r]), fl[r])
        for ni, r in tpos.dl_rows.items():
            dl[r] = torch.where(mask, at + tpos.nodes[ni].waiting_ms, dl[r])

    def fork(src, occ_):
        """`_fork_slots`: the k-th source slot (by slot index) is cloned
        into the k-th free slot; returns (clone mask, occ').  Clones that
        find no free slot count into `of_slots`."""
        nonlocal first_ts, head_seq, cnt, cnt_on, narm, fl, dl, of_slots, \
            fork_lost
        srci = src.to(torch.int32)
        nfork = torch.cumsum(srci, 0, dtype=torch.int32)
        total = nfork[-1]
        free = occ_ == 0
        freei = free.to(torch.int32)
        dst_rank = torch.cumsum(freei, 0, dtype=torch.int32) - freei
        dst = free & (dst_rank < total[None])
        lost = torch.clamp(total - freei.sum(0, dtype=torch.int32), min=0)
        of_slots = of_slots + lost
        fork_lost += int(lost.sum())
        key = torch.where(src, nfork - srci, torch.full_like(srci, A + 1))
        by_rank = torch.argsort(key, dim=0, stable=True)
        src_of = torch.gather(by_rank, 0, torch.clamp(dst_rank, max=A - 1)
                              .to(torch.int64))

        def cp(row):
            return torch.where(dst, torch.gather(row, 0, src_of), row)

        def cp3(t3):
            if t3.shape[0] == 0:
                return t3
            g = torch.gather(t3, 1, src_of[None].expand(t3.shape))
            return torch.where(dst[None], g, t3)
        first_ts, head_seq = cp(first_ts), cp(head_seq)
        cnt, cnt_on, narm, fl, dl = (cp3(cnt), cp3(cnt_on), cp3(narm),
                                     cp3(fl), cp3(dl))
        for g in groups:
            caps[g] = cp3(caps[g])
        return dst, cp(occ_)

    def drain(emit_now=None):
        nonlocal occ, of_lanes
        parked = occ == PARK
        done = parked if emit_now is None else (parked | emit_now)
        di = done.to(torch.int32)
        rank = torch.cumsum(di, 0) - di
        for e in range(E):
            sel = done & (rank == e)
            lanes = torch.nonzero(sel.any(0)).flatten()
            if not len(lanes):
                continue
            slot = sel[:, lanes].to(torch.int8).argmax(0)
            irows = [caps["i"][:, slot, lanes], head_seq[slot, lanes][None]]
            if k.broadcast:
                irows.append(lanes_all[lanes][None])
            emitted.append((torch.cat(irows), caps["f"][:, slot, lanes],
                            caps["l"][:, slot, lanes]))
        sent = done & (rank < E)
        occ = torch.where(parked & sent, torch.zeros_like(occ), occ)
        if emit_now is not None:
            lost = emit_now & ~parked & ~sent
            of_lanes = of_lanes + lost.sum(0, dtype=torch.int32)

    for t in range(T):
        ts, seq, valid = ts_g[t], seq_g[t], valid_g[t]
        ts_ap, seq_ap = ts[None, :].expand(A, P), seq[None, :].expand(A, P)
        tick = tick_g[t] if tick_g is not None else None
        timey = valid if tick is None else (valid | tick)
        dl_fire = timey if k.playback else (
            tick if tick is not None else torch.zeros_like(valid))
        if k.needs_init:
            # the lane's init slot: slot 0, armed on the lane's first
            # event (or timer tick, `init_on_tick`), its deadlines based
            # at the START anchor when the block carries one
            trig = valid | tick if (k.init_on_tick and tick is not None) \
                else valid
            act = ~init & trig
            init = init | act
            hot0 = slot0 & act[None, :]
            arm = ts if anchor is None else torch.full_like(ts, anchor)
            head = spec.positions[0]
            if head.node.kind == "absent" or head.op is not None:
                occ = torch.where(hot0, torch.ones_like(occ), occ)
                enter(0, hot0, arm[None, :])
            else:               # a min-0 count head: land past it
                land = k.landing(-1)
                occ = torch.where(hot0, torch.full_like(occ, land + 1), occ)
                for tp in range(land + 1):
                    enter(tp, hot0, arm[None, :])
            head_seq = torch.where(hot0, seq_ap, head_seq)
        occ0 = occ.clone()
        env = caps_env()
        age = ts[None, :] - first_ts
        narm0 = narm.clone()
        complete = zeros_ap.clone()
        kill = zeros_ap.clone()
        trans = zeros_ap.clone()
        writes: list = []           # deferred capture writes (mask, fn)
        enters: list = []           # (target position, mask)
        nm = [node_match(gi, t, env) for gi in range(len(nodes))]

        # absent deadlines at or before this timestamp fire BEFORE the
        # event: the slot advances (or completes with the deadline as its
        # timestamp) and can consume this very event downstream; an
        # `every` absent forks a clone that advances while the standing
        # arm re-arms one period after the fired deadline
        for pi, pos in enumerate(spec.positions):
            if pos.op is not None or not pos.dl_rows \
                    or pos.node.kind != "absent":
                continue
            r = pos.dl_rows[0]
            due = (occ0 == pi + 1) & (dl[r] <= ts[None, :]) & \
                dl_fire[None, :]
            if pos.sticky:
                adv, occ0 = fork(due, occ0)
                dl_at = dl[r].clone()
                dl[r] = torch.where(due, dl[r] + max(pos.node.waiting_ms
                                                     or 1, 1), dl[r])
            else:
                adv = due
                dl_at = dl[r].clone()
            first_ts = torch.where(adv & (first_ts == NO_FIRST), dl_at,
                                   first_ts)
            pres = k.node_pres_row[k.pos_node[pi]]
            if pi == S - 1:
                complete |= adv
                writes.append((adv, (0, 0), None, (dl_at, seq_ap),
                               [pres] if pres >= 0 else []))
            else:
                land = k.landing(pi)
                occ0 = torch.where(adv, torch.full_like(occ0, land + 1), occ0)
                for tp in range(pi + 1, land + 1):
                    enter(tp, adv, dl_at)
                rows = [r_ for tp in range(pi + 1, land + 1)
                        for r_ in pz(k.pos_pz[tp])]
                zero_rows(adv, rows + ([pres] if pres >= 0 else []))
            dl[r] = torch.where(adv if pos.sticky else due,
                                torch.full_like(dl_at, NO_DEADLINE), dl[r])
        occ = occ0.clone()

        # lazy, strict `within` expiry per station (on the ages before
        # the deadlines fired)
        expired = zeros_ap.clone()
        at_pos = []
        for pi, pos in enumerate(spec.positions):
            at = occ0 == pi + 1
            if pos.within_ms is not None:
                exp = at & timey[None, :] & (age > pos.within_ms)
                expired |= exp
                at = at & ~exp
            at_pos.append(at)

        def advance(pi_from: int, mask):
            nonlocal occ, complete
            if pi_from == S - 1:
                complete = complete | mask
                return
            land = k.landing(pi_from)
            for tp in range(pi_from + 1, land + 1):
                enters.append((tp, mask))
            occ = torch.where(mask, torch.full_like(occ, land + 1), occ)

        # count collection: station-independent -- a partial match keeps
        # absorbing occurrences while it waits further down the chain
        for pi, pos in enumerate(spec.positions):
            if not pos.is_count:
                continue
            c, gi = pos.cnt_row, k.pos_node[pi]
            collect = cnt_on[c] & nm[gi]
            newc = cnt[c] + collect.to(torch.int32)
            writes.append((collect, k.node_cc[gi], newc.clone(),
                           (ts_ap, seq_ap) if pi == S - 1 else None, None))
            cnt[c] = newc
            cnt_on[c] = cnt_on[c] & (newc < pos.max_count)
            if pi < S - 1:
                cross = collect & (newc == pos.min_count)
                narm[c] = narm[c] | cross
                # optional counts after this one arm their collection
                for tp in range(pi + 1, k.landing(pi)):
                    enters.append((tp, cross))
            trans |= collect
            if pi == S - 1:
                complete = complete | (collect & (newc >= pos.min_count))
            prevp = spec.positions[pi - 1] if pi else None
            if prevp is not None and prevp.is_count:
                # adjacent counts: the previous count's armed successor IS
                # this count -- entry consumes the arm and counts the
                # entering event as occurrence #1
                pc = prevp.cnt_row
                ent = at_pos[pi - 1] & narm0[pc] & nm[gi]
                narm[pc] = narm[pc] & ~ent
                occ = torch.where(ent, torch.full_like(occ, pi + 1), occ)
                trans |= ent
                cnt[c] = torch.where(ent, torch.ones_like(cnt[c]), cnt[c])
                cnt_on[c] = torch.where(ent, torch.full_like(
                    cnt_on[c], pos.max_count > 1), cnt_on[c])
                zero_rows(ent, pz(k.pos_pz[pi]))
                # the entry overwrites every row the collection writes:
                # its values are computed on the captures before it
                writes[-1] = (collect & ~ent,) + writes[-1][1:]
                writes.append((ent, k.node_cc[gi], torch.where(
                    ent, torch.ones_like(newc), torch.zeros_like(newc)),
                    (ts_ap, seq_ap) if pi == S - 1 else None, None))
                if pi == S - 1:
                    complete = complete | (ent & (pos.min_count <= 1))
                else:
                    narm[c] = narm[c] | (ent & (pos.min_count <= 1))

        # per-position station logic
        for pi, pos in enumerate(spec.positions):
            at = at_pos[pi]
            gi = k.pos_node[pi]
            if pos.is_count or (pi == 0 and pos.op is None
                                and pos.node.kind != "absent"):
                continue              # counts above; the head: alloc below
            if pos.op is not None:
                # `_logical_step`: an absent side kills an `and` on
                # arrival and disarms an `or` side; a side's deadline
                # passage advances the pair
                r = pos.log_row
                newbits = fl[r].clone()
                lkill = zeros_ap.clone()
                side_due = zeros_ap.clone()
                need = 0
                for ni, n in enumerate(pos.nodes):
                    m = at & nm[gi + ni]
                    if n.kind == "absent":
                        dr = pos.dl_rows.get(ni)
                        if pos.op == "or":
                            if dr is not None:
                                dl[dr] = torch.where(m, no_dl[dr], dl[dr])
                        else:
                            lkill |= m
                        if dr is not None:
                            due = at & (dl[dr] <= ts[None, :]) & \
                                dl_fire[None, :]
                            side_due |= due
                            dl[dr] = torch.where(due, no_dl[dr], dl[dr])
                        continue
                    need |= 1 << ni
                    newbits = torch.where(m, newbits | (1 << ni), newbits)
                    trans |= m
                    writes.append((m & ~lkill, k.node_cw[gi + ni], None,
                                   (ts_ap, seq_ap), None))
                filled = (newbits != 0) if pos.op == "or" else \
                    ((newbits & need) == need)
                done = at & (filled | side_due) & ~lkill
                advance(pi, done)
                trans |= done
                for dr in pos.dl_rows.values():
                    dl[dr] = torch.where(done | lkill, no_dl[dr], dl[dr])
                fl[r] = torch.where(done, torch.zeros_like(newbits), newbits)
                kill |= lkill
                continue
            if pos.node.kind == "absent":
                arr = at & nm[gi]     # a forbidden arrival
                if not pos.sticky:
                    kill |= arr
                elif pos.dl_rows:     # an `every` arm re-arms its wait
                    r = pos.dl_rows[0]
                    dl[r] = torch.where(arr, ts_ap + (pos.node.waiting_ms
                                                      or 0), dl[r])
                continue
            # (1,1) stream position: eligible when stationed here, or via
            # an armed predecessor count (consumed here), walking back
            # across a run of optional counts
            elig = at
            chain = []
            j = pi - 1
            while j >= 0 and spec.positions[j].is_count:
                chain.append(j)
                elig = elig | (at_pos[j] & narm0[spec.positions[j].cnt_row])
                if spec.positions[j].min_count != 0:
                    break
                j -= 1
            m = elig & nm[gi]
            for j in chain:
                cr = spec.positions[j].cnt_row
                narm[cr] = narm[cr] & ~m
            trans |= m
            if pos.sticky:
                # `every` below the head: the slot stays a standing arm, a
                # clone advances with the capture
                m, occ = fork(m, occ)
                trans |= m
            writes.append((m, k.node_cw[gi], None, (ts_ap, seq_ap), None))
            advance(pi, m)

        dead = expired | kill
        occ = torch.where(dead, torch.zeros_like(occ), occ)
        cnt_on &= ~dead[None]
        narm &= ~dead[None]
        dl = torch.where(dead[None], no_dl, dl)
        complete &= ~dead
        for mask, span, newc, comp, zrows in writes:
            mask = mask & ~dead
            if zrows is not None:           # a final absent's completion
                zero_rows(mask, zrows)
            write(mask, span, t, newc, comp)

        # completion: park (freed at drain) or, while a final count still
        # collects, emit directly keeping the slot
        survivor = zeros_ap
        if spec.positions[S - 1].is_count:
            survivor = cnt_on[spec.positions[S - 1].cnt_row].clone()
        park = complete & ~survivor
        emit_now = complete & survivor
        occ = torch.where(park, torch.full_like(occ, PARK), occ)
        cnt_on &= ~park[None]
        narm &= ~park[None]

        for tpi, mask in enters:
            mask = mask & ~dead
            enter(tpi, mask, ts[None, :])
            zero_rows(mask, pz(k.pos_pz[tpi]))

        if k.needs_init:
            # the first capture stamps the `within` anchor
            first_ts = torch.where(trans & (first_ts == NO_FIRST), ts_ap,
                                   first_ts)
        if spec.is_sequence:
            started = (occ > 0) & (occ < PARK) & (first_ts != NO_FIRST)
            kills = started & ~trans & valid[None, :]
            occ = torch.where(kills, torch.zeros_like(occ), occ)
            cnt_on &= ~kills[None]
            narm &= ~kills[None]

        if k.parked:
            drain(emit_now)
        if k.needs_init:
            continue                  # the init slot is the chain's entry

        # head: slot alloc (or direct single-position emission)
        head = spec.positions[0]
        ok0 = zeros_ap[0].clone()
        for gi in range(len(head.nodes)):
            ok0 |= base_match(gi, t)
        ok0 &= armed0
        if can_start is not None:
            ok0 &= can_start[t]
        if not spec.every_head:
            armed0 = armed0 & ~ok0
        if not k.parked:
            lanes = torch.nonzero(ok0).flatten()
            if len(lanes):
                rows = {g: torch.zeros((caps[g].shape[0], len(lanes)),
                                       dtype=caps[g].dtype, device=dev)
                        for g in caps}
                off, n = k.node_cw[0]
                for g_i, r, mode, src, _arg in k.writes[off:off + n]:
                    g = groups[g_i]
                    rows[g][r] = (grids[src][t][lanes].to(caps[g].dtype)
                                  if mode == W_SRC else 1)
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
        first_ts = torch.where(hot, ts_ap, first_ts)
        head_seq = torch.where(hot, seq_ap, head_seq)
        zero_rows(hot, pz(k.all_pz))
        dl = torch.where(hot[None], no_dl, dl)
        land = k.landing(0) if S > 1 else 0
        if head.op is not None:
            r = head.log_row
            bits = torch.zeros_like(occ)
            for ni in range(2):
                mm = hot & base_match(ni, t)[None, :]
                bits = torch.where(mm, bits | (1 << ni), bits)
                write(mm, k.node_cw[ni], t, comp=(ts_ap, seq_ap))
            occ = torch.where(hot, torch.ones_like(occ), occ)
            fl[r] = torch.where(hot, bits, fl[r])
            if head.op == "or":
                done = hot & (bits != 0)
                occ = torch.where(done, torch.full_like(
                    occ, PARK if S == 1 else land + 1), occ)
                for tp in range(1, land + 1 if S > 1 else 1):
                    enter(tp, done, ts[None, :])
        elif head.is_count:
            c = head.cnt_row
            occ = torch.where(hot, torch.ones_like(occ), occ)
            cnt[c] = torch.where(hot, torch.ones_like(cnt[c]), cnt[c])
            cnt_on[c] = torch.where(hot, torch.full_like(
                cnt_on[c], head.max_count > 1), cnt_on[c])
            if S > 1:
                narm[c] = torch.where(hot, torch.full_like(
                    narm[c], head.min_count <= 1), narm[c])
            write(hot, k.node_cc[0], t, cnt[c].clone(),
                  (ts_ap, seq_ap) if S == 1 else None)
            if S == 1 and head.min_count <= 1:
                occ = torch.where(hot, torch.full_like(occ, PARK), occ)
        else:
            occ = torch.where(hot, torch.full_like(occ, land + 1), occ)
            write(hot, k.node_cw[0], t)
            for tp in range(1, land + 1 if S > 1 else 1):
                enter(tp, hot, ts[None, :])
    if k.parked:
        for _ in range(-(-A // E)):
            drain()

    out = _alloc_out(k, M, dev)
    if emitted and prev_seq is not None:
        # chunk lanes: replayed completions never take a row of M
        r = k.lane_names_i.index("__comp_seq__")
        emitted = [tuple(x[:, e[0][r] > prev_seq] for x in e)
                   for e in emitted]
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
    out["meta"][3] = of_lanes.sum()
    out["meta"][4] = fork_lost
    new = {"occ": occ, "first_ts": first_ts, "head_seq": head_seq,
           "cnt": cnt, "cnt_on": cnt_on, "narm": narm, "fl": fl,
           "caps_f": caps["f"], "caps_i": caps["i"], "caps_l": caps["l"],
           "dl": dl, "armed0": armed0, "of_slots": of_slots,
           "of_lanes": of_lanes}
    if init is not None:
        new["init"] = init
    return new, out
