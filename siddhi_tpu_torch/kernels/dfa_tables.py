"""K11 `dfa_tables`: the stride-4 symbol tables of one `dfa` block.

Replaces `_dfa_tables` (siddhi_tpu/core/nfa_parallel.py:728) and is read
by K4's `dfa` mode as `_dfa_next` (:777) reads the tables there.  The
chase nodes of a block (`_chase_lanes`: the static hops below the head
and both sides of a logical position, at most 8) each own bit k of an
event's symbol word ("matches chase node k": valid, its stream, its
pre-mask).  Over blocks of STRIDE = 4 events, per lane of the (L, F)
grid:

  * `suffix` (L, 4 NB) int32: for every chase node k, the 3 bits at 3k
    hold the offset within the event's block of the node's first hit at
    or after the event (4: none);
  * `packed` (L, NB) int32: that word at each block's first event, the
    block's first-hit offsets for every chase node;
  * `nblk` (nk, L, NB) int32: the first block at or after b holding a hit
    of node k (NB: none), the reverse min-scan over the lane's blocks.

`dfa_next_plain` is the lookup: "the first event >= s matching node k" is
the suffix word at s when its block has a hit after s, else the packed
word of block nblk[k][s // 4 + 1], else Lt (`_dfa_next`), which equals
the first-hit of a K3 tree over the node's mask.

Design (csrc/dfa_tables.cu): a lane's stride-blocks fall into tiles of
32 W (W warps a CUDA block, `tile_geometry`), the grid is tiles x lanes,
and thread j of a tile owns one stride-block: its symbol bits by a shift
of the pre-mask words, its suffix words by find-first-set, stored as one
16-byte vector.  `nblk` comes from each warp's ballot of blocks with a
hit and the warps to its right within the tile, and across tiles from a
reverse decoupled look-back over each tile's first hit block (min: exact,
so the result does not depend on which tiles had finished), whose state
is each prepared launch's own tensor, zeroed by a memset in the launcher
(a lane of more than one tile: one memset and one kernel launch a call;
`launched` in the parameter block counts the kernels).  Words are u32
on the device, stored in int32 (24 bits at most); the plain version
builds them in int64 and masks.  Bound
on the H100: bytes -- pre-mask words and stream codes read once, 4 bytes
an event and 4 (nk + 1) a block written once.

`dfa_tables()` launches the kernel for CUDA tensors and runs the plain
version, `dfa_tables_plain()`, for CPU tensors; a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load
from .table import DeviceTable, Launch, checked_ptr, stream_of

STRIDE = 4            # events per precomposed block transition
OFF_BITS = 3          # bits per packed first-hit offset (0..STRIDE)
MAX_CHASE = 8         # chase nodes a u32 word holds (3 bits each)
MAX_WARPS = 8         # csrc/dfa_tables.cu DFA_MAXW: warps a CUDA block


class _Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "F", "NB", "nk", "ev_stride", "W", "T", "launched")] + [
        (n, ctypes.c_void_p) for n in (
            "nev", "scode", "pre", "node_scode", "suffix", "packed",
            "nblk", "state")]


def tile_geometry(NB: int) -> tuple:
    """(W, T): warps a CUDA block (a stride-block a thread) and tiles a
    lane of NB stride-blocks; a lane of more than one tile has full
    blocks of MAX_WARPS warps."""
    W = min(MAX_WARPS, max(1, -(-NB // 32)))
    return W, max(1, -(-NB // (32 * W)))


def dfa_tables_plain(masks: list) -> tuple:
    """(suffix, packed, nblk) from one (L, F) bool mask per chase node."""
    L, F = masks[0].shape
    dev = masks[0].device
    NB = -(-F // STRIDE)
    Fp = NB * STRIDE
    o = torch.arange(STRIDE, device=dev)
    suffix = torch.zeros((L, NB, STRIDE), dtype=torch.int64, device=dev)
    nblk = []
    for k, m in enumerate(masks):
        bits = torch.zeros((L, Fp), dtype=torch.bool, device=dev)
        bits[:, :F] = m
        offs = torch.where(bits.view(L, NB, STRIDE), o,
                           torch.full_like(o, STRIDE))
        suf = offs.clone()
        for c in range(STRIDE - 2, -1, -1):
            suf[..., c] = torch.minimum(offs[..., c], suf[..., c + 1])
        suffix |= suf << (OFF_BITS * k)
        blk = torch.where(suf[..., 0] < STRIDE,
                          torch.arange(NB, device=dev),
                          torch.full((NB,), NB, device=dev))
        nblk.append(torch.flip(torch.cummin(torch.flip(blk, [1]), 1).values,
                               [1]))
    mask32 = (1 << 32) - 1
    suffix = (suffix & mask32).view(L, Fp)
    return (suffix.to(torch.int32), suffix[:, ::STRIDE].to(torch.int32),
            torch.stack(nblk).to(torch.int32))


def dfa_next_plain(tables: tuple, k: int, s: torch.Tensor,
                   Lt: int) -> torch.Tensor:
    """First index >= s of each lane's row matching chase node k, Lt when
    none; s is (L, Q), row l asking lane l (`_dfa_next`)."""
    suffix, packed, nblk = tables
    NB = packed.shape[1]
    Fp = NB * STRIDE
    s = s.to(torch.int64)
    sc = torch.clamp(s, 0, Fp - 1)
    inb = (torch.gather(suffix, 1, sc).to(torch.int64)
           >> (OFF_BITS * k)) & 7
    b = sc >> 2
    b2 = torch.gather(nblk[k], 1, torch.clamp(b + 1, 0, NB - 1)
                      ).to(torch.int64)
    ok2 = (b + 1 < NB) & (b2 < NB)
    f2 = (torch.gather(packed, 1, torch.clamp(b2, 0, NB - 1)
                       ).to(torch.int64) >> (OFF_BITS * k)) & 7
    none = torch.full_like(s, Lt)
    j = torch.where(inb < STRIDE, b * STRIDE + inb,
                    torch.where(ok2, b2 * STRIDE + f2, none))
    return torch.where(s < Fp, j, none)


def dfa_tables(k, ev: dict, pre: list) -> tuple:
    """The tables of ParallelChainKernel `k` (family `dfa`) for block `ev`
    and its K1 pre-mask words `pre` (per chain node, or None)."""
    if ev["__flat.__ts__"].device.type == "cpu":
        from .seg_tree import node_masks
        masks = node_masks(k, ev, pre)
        return dfa_tables_plain([masks[gi] for gi in k.dfa_nodes])
    return prepare(k, ev, pre)()


def prepare(k, ev: dict, pre: list) -> Launch:
    """Allocate the tables and upload the parameter table of one K11
    launch (see `dfa_tables`)."""
    ts = ev["__flat.__ts__"]
    dev = ts.device
    if dev.type != "cuda":
        raise ValueError(f"dfa_tables: unsupported device {dev}")
    nk = len(k.dfa_nodes)
    if not 1 <= nk <= MAX_CHASE:
        raise ValueError(f"dfa_tables: {nk} chase nodes (1..{MAX_CHASE})")
    G, F = ts.shape
    L = ev["__nev__"].shape[0]
    NB = -(-F // STRIDE)
    keep: list = []
    ptr = checked_ptr(keep, dev, "dfa_tables")
    p = _Params()
    p.L, p.F, p.NB, p.nk = L, F, NB, nk
    p.W, p.T = tile_geometry(NB)
    p.ev_stride = F if G == L else 0
    p.nev = ptr(ev["__nev__"], torch.int32)
    if k.multi:
        p.scode = ptr(ev["__flat.__scode__"], torch.int32)
    tab = DeviceTable()
    tab.field(p, "pre", [0 if pre[gi] is None else ptr(pre[gi], torch.int32)
                         for gi in k.dfa_nodes], "u8")
    tab.field(p, "node_scode", [k.node_scode[gi] if k.multi else -1
                                for gi in k.dfa_nodes], "i4")
    suffix = torch.empty((L, NB * STRIDE), dtype=torch.int32, device=dev)
    packed = torch.empty((L, NB), dtype=torch.int32, device=dev)
    nblk = torch.empty((nk, L, NB), dtype=torch.int32, device=dev)
    p.suffix, p.packed, p.nblk = ptr(suffix), ptr(packed), ptr(nblk)
    if p.T > 1:
        # the look-back state: the ticket, a word per node, lane and tile;
        # the launch's own, zeroed by a memset in the launcher
        p.state = ptr(torch.empty(1 + nk * L * p.T, dtype=torch.int64,
                                  device=dev))
    keep.append(tab.upload(dev))
    fn = load("dfa_tables").dfa_tables_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launch = Launch(lambda: fn(ctypes.byref(p), stream_of(dev)),
                    "dfa_tables_launch", "dfa_tables", keep,
                    (suffix, packed, nblk))
    launch.params = p        # .W warps a block, .T tiles a lane; .launched
    return launch
