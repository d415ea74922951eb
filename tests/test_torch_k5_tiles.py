"""K5 `scan_compact` as the H100 kernel tiles it, on the CPU.

The kernel (csrc/scan_compact.cu) makes one launch: blocks take each
lane's 1024-candidate tiles from a ticket in table order, a thread takes
candidates 256 apart and runs the live test once, a one-shot head's h0
comes from a look-back over the lane's earlier tiles (a minimum), and
each tile's first match slot from a look-back over every earlier tile's
live count (a sum), the walk reading 32 earlier tiles' words at a time,
each either the tile's own value or its inclusive one, down to the
nearest inclusive word.  The lane's last tile writes its count and flag,
the last tile the total.

`k5_model` below is that in numpy, with the words an earlier tile has
published drawn at random (own or inclusive: whatever the race left).
These tests hold it to `scan_compact_plain` on seeded blocks (lanes over
several tiles, tiles with no live candidate, h0 in a later tile, no head
at all, M overflow, C > 1 candidates a head, a fused group's shared row),
and hold the port (plain versions) to the JAX package's `scan` block
through both facades on lanes over several tiles: per-lane and fused
(`__qid__`, one shared row of events) lanes, counts and `and`, a final
count's fan-out, f64 rows and a one-shot head whose h0 lies past the
first tile.  The card
holds the kernel to `scan_compact_plain` (tests/test_torch_gpu.py,
`scan_compact_tiles`)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
from siddhi_tpu_torch.kernels.scan_compact import (ARM_NONE, ARM_PENDING,
                                                   ARM_RESOLVED, TILE,
                                                   scan_compact_plain)
from siddhi_tpu_torch.replay import (C4A_BODY, C4N_BODY, F64, STOCK,
                                     partitioned)

WARPS = 8                       # warps a block (256 threads)
DEV = "@app:devicePatterns('always')\n"


def _look_back(own: dict, incl: dict, g: int, first: int, fold, ident,
               rng) -> int:
    """The exclusive fold over tiles first .. g-1 as the kernel's warp
    walks back: 32 words a round, nearest first, each earlier tile's
    word its own value or its inclusive one at random (tile `first`'s
    always inclusive), stopping at the nearest inclusive word."""
    before = ident
    start = g - 1
    while g > first:
        ks = [start - lane for lane in range(32)]
        words = [("inc" if k == first or rng.random() < 0.5 else "agg")
                 if k >= first else None for k in ks]
        stop = next((lane for lane, w in enumerate(words) if w == "inc"),
                    None)
        for lane, (k, w) in enumerate(zip(ks, words)):
            if w is None or (stop is not None and lane > stop):
                continue
            before = fold(before, incl[k] if w == "inc" else own[k])
        if stop is not None or start - 31 <= first:
            break
        start -= 32
    return before


def k5_model(status, idx, cand, seq, prev, arm_done, comp_rows, C: int,
             alg: bool, single: bool, M: int, seed: int = 0):
    """(meta[0], lane_n, arm, {slot: (lane, c, j)}) as the kernel's
    blocks compute them, taken in ticket order."""
    rng = np.random.default_rng(seed)
    L, F = status.shape
    shared = seq.shape[0] == 1
    nq = C * F if alg else F
    ntiles = max(-(-nq // TILE), 1)
    own_h, inc_h, own_c, inc_c = {}, {}, {}, {}
    slots = {}
    lane_n = np.zeros(L, np.int64)
    arm = np.zeros(L, np.int64)
    total = 0
    for g in range(L * ntiles):
        lane, tile = divmod(g, ntiles)
        g0, base = lane * ntiles, tile * TILE
        h0 = F
        if single:
            qs = np.arange(base, min(base + TILE, F))
            heads = qs[(status[lane, qs] & 4) != 0]
            own_h[g] = int(heads.min()) if len(heads) else F
            h0 = min(own_h[g], _look_back(own_h, inc_h, g, g0, min, F, rng))
            inc_h[g] = h0
        done = single and arm_done is not None and arm_done[lane] != 0
        # thread t = 32 w + l holds candidates base + 256 k + t: slot
        # order (k, w, l) is candidate order
        q = base + np.arange(TILE)
        ok = q < nq
        c = np.where(ok, q // F if alg else 0, 0)
        j = np.where(ok, q - c * F, 0)
        comp = idx[np.asarray(comp_rows)[c], lane, j]
        live = ok & (((cand[lane, j].astype(np.int64) >> c) & 1) != 0)
        live &= seq[0 if shared else lane, comp] > prev[lane]
        if single:
            live &= (j == h0) & (not done)
        per = live.reshape(4, WARPS, 32)
        offs = np.cumsum(per.sum(2).reshape(-1)) - per.sum(2).reshape(-1)
        rank = np.cumsum(per, 2) - per
        in_tile = (offs.reshape(4, WARPS, 1) + rank).reshape(-1)
        own_c[g] = int(live.sum())
        before = _look_back(own_c, inc_c, g, 0, lambda a, b: a + b, 0, rng)
        inc_c[g] = before + own_c[g]
        for t in np.flatnonzero(live):
            pos = before + int(in_tile[t])
            if pos < M:
                slots[pos] = (lane, int(c[t]), int(j[t]))
        if tile == ntiles - 1:
            lane_n[lane] = inc_c[g] - (inc_c[g0 - 1] if g0 else 0)
            flag = ARM_NONE
            if single:
                if h0 < F:
                    flag = ARM_RESOLVED if status[lane, h0] & 3 else \
                        ARM_PENDING
                if done:
                    flag = ARM_RESOLVED
            arm[lane] = flag
        total = inc_c[g]
    return total, lane_n, arm, slots


# name -> (L, F, C, one-shot, shared row, M as a share of the matches,
# change): seeded blocks over several tiles
MODEL_CASES = {
    "lanes": (5, 2600, 1, False, False, 2.0, None),
    "one_lane": (1, 9000, 1, False, False, 2.0, None),
    "empty_tiles": (4, 3500, 1, False, False, 2.0, "empty_tiles"),
    "fan_out": (3, 1500, 4, False, False, 2.0, None),
    "shared_row": (6, 2100, 1, False, True, 2.0, None),
    "late_h0": (5, 3000, 1, True, False, 2.0, "late_h0"),
    "one_shot_fan_out": (4, 900, 3, True, True, 2.0, "late_h0"),
    "m_small": (5, 2600, 2, False, False, 0.3, None),
    "small_f": (40, 7, 1, False, False, 2.0, None),
    # 600 tiles: the count look-back over many rounds of 32
    "many_tiles": (300, 1100, 1, False, False, 2.0, None),
}


def _fake_kernel(C: int, single: bool):
    """What `scan_compact_plain` reads of a ParallelChainKernel, with the
    rows that identify each match: its completion's and its head's seq
    and its lane's query id."""
    nfak = SimpleNamespace(lane_names_i=["__seq__", "__head_seq__",
                                         "__qid__"], rows_f=[], rows_l=[],
                           fdt=torch.float32)
    return SimpleNamespace(
        C=C, comp_rows=list(range(C)), leaves=lambda F: 2, nfak=nfak,
        prog=SimpleNamespace(single_arm=single, positions=[]), S=2,
        rank_of={}, rows={"i": [("comp_seq",), ("head_seq",), ("qid",)],
                          "f": [], "l": []})


def _model_block(name: str, seed: int):
    L, F, C, single, shared, m_share, change = MODEL_CASES[name]
    rng = np.random.default_rng(seed)
    status = rng.integers(0, 4, (L, F)).astype(np.uint8)
    status |= np.where(rng.random((L, F)) < 0.02, 4, 0).astype(np.uint8)
    idx = np.minimum(np.arange(F)[None, None, :] + rng.integers(
        0, 50, (C, L, F)), F - 1).astype(np.int32)
    cand = rng.integers(0, 1 << C, (L, F)).astype(np.uint8)
    cand[rng.random((L, F)) < 0.5] = 0
    seq = (np.arange(F)[None, :] if shared else
           np.arange(L * F).reshape(L, F)).astype(np.int32)
    prev = (rng.integers(-1, F // 4, L) + (
        0 if shared else np.arange(L) * F)).astype(np.int32)
    arm_done = (rng.random(L) < 0.2).astype(np.int32) if single else None
    if single:                          # a head's first candidate live
        cand[(status & 4) != 0] |= 1
    if change == "empty_tiles":
        cand[:, :TILE] = 0
        cand[:, 2 * TILE:3 * TILE] = 0
    elif change == "late_h0":
        status[:, :min(F - 1, TILE + 100) if F > TILE else F // 2] &= 3
        status[0] &= 3                                # a lane with no head
    return (L, F, C, single, shared, m_share), status, idx, cand, seq, prev, \
        arm_done


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_equals_plain(name):
    """The kernel's tiles, ticket order, look-backs and warp-strided
    slots (numpy model) give `scan_compact_plain`'s total, lane counts,
    one-shot flags and match rows (tolerance 0)."""
    (L, F, C, single, shared, m_share), status, idx, cand, seq, prev, \
        arm_done = _model_block(name, 7)
    alg = C > 1
    n0 = k5_model(status, idx, cand, seq, prev, arm_done, list(range(C)),
                  C, alg, single, 1 << 30)[0]
    M = max(int(n0 * m_share), 1)
    total, lane_n, arm, slots = k5_model(status, idx, cand, seq, prev,
                                         arm_done, list(range(C)), C, alg,
                                         single, M, seed=11)
    t = torch.from_numpy
    ev = {"__flat.__seq__": t(seq), "__flat.__ts__": t(seq),
          "__nev__": t(np.full(L, F, np.int32)), "__prev_seq__": t(prev),
          "__lane_qid__": t(np.arange(L, dtype=np.int32) + 7)}
    if arm_done is not None:
        ev["__arm_done__"] = t(arm_done)
    out = scan_compact_plain(_fake_kernel(C, single), ev, (
        t(status), t(idx), t(cand), t(np.zeros((L, F), np.int32))), [], [],
        M)
    assert int(out["meta"][0]) == total
    np.testing.assert_array_equal(out["lane_n"].numpy(), lane_n)
    if single:
        np.testing.assert_array_equal(out["arm"].numpy(), arm)
    n = min(total, M)
    assert sorted(slots) == list(range(n))
    want = np.array([[seq[0 if shared else ln, idx[c, ln, j]],
                      seq[0 if shared else ln, j], ln + 7]
                     for ln, c, j in (slots[p] for p in range(n))],
                    np.int32).reshape(n, 3).T
    np.testing.assert_array_equal(out["out_i"][:, :n].numpy(), want)
    # the cases reach what their names say
    ntiles = -(-(C * F if alg else F) // TILE)
    assert total > 0 and (ntiles > 2 or L * ntiles > 256 or
                          name in ("small_f", "one_shot_fan_out"))
    if name == "m_small":
        assert total > M
    if name == "late_h0":
        h0 = [min(np.flatnonzero(status[ln] & 4), default=F)
              for ln in range(L)]
        assert h0[0] == F and min(h0[1:]) >= TILE


# -- the port against the JAX package through both facades -------------

def _flushes(keys: int, n: int, flush: int, seed: int, late: int = 0):
    """(symbol codes, prices, volumes, ts) flushes: quarter-grid prices
    in [90, 130), the first `late` of them under 100."""
    rng = np.random.default_rng(seed)
    price = np.round(rng.uniform(90.0, 130.0, n) * 4) / 4
    price[:late] = np.round(rng.uniform(90.0, 99.75, late) * 4) / 4
    sym = rng.integers(0, keys, n).astype(np.int32)
    vol = rng.integers(1, 1000, n).astype(np.int32)
    ts = 1_700_000_000_000 + np.arange(n, dtype=np.int64)
    return [(sym[a:a + flush], price[a:a + flush], vol[a:a + flush],
             ts[a:a + flush]) for a in range(0, n, flush)]


def _run(pkg, app: str, flushes, keys: int, outs, **kw):
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    rows: list = []
    for o in outs:
        rt.add_callback(o, lambda evs, o=o: rows.extend(
            (o, e.timestamp, e.data) for e in evs))
    if pkg is siddhi_tpu:
        rt.start()
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    for sym, price, vol, ts in flushes:
        h.send_batch({"symbol": codes[sym], "price": price, "volume": vol},
                     ts)
        rt.flush()
    return rows, rt


def _fused(n_queries: int, one_shot: bool) -> str:
    """n same-shape pattern queries over StockStream (one fused group):
    `every` chains, or one-shot heads."""
    parts = [STOCK]
    for i in range(n_queries):
        head = "" if one_shot else "every "
        parts.append(
            f"@info(name='q{i}') from {head}e1=StockStream[price > "
            f"{100 + i % 8}.0] -> e2=StockStream[price > e1.price] "
            f"within 1 sec select e1.price as a{i}, e2.price as b{i} "
            f"insert into Out{i % 4};")
    return "\n".join(parts)


FINAL = ("from every e1=StockStream[price > 110] -> "
         "e2=StockStream[price < 95]<2:5> within 1 sec select e1.price as "
         "a, e2[0].price as b, e2[last].price as c, e2[last-1].price as d, "
         "e2[3].price as f insert into Out;")
C4_BODY = ("from every e1=StockStream[price > 100] -> "
           "e2=StockStream[price > e1.price] -> "
           "e3=StockStream[price > e2.price] within 10 sec select e1.price "
           "as p1, e2.price as p2, e3.price as p3 insert into Out;")
ONE_SHOT = STOCK + (
    "from e1=StockStream[price > 125] -> e2=StockStream[price > e1.price] "
    "within 1 sec select e1.price as p1, e2.price as p2 insert into Out;")

# name -> (app, keys, events, events a flush, late prices, outputs)
JAX_APPS = {
    "c4": (partitioned(C4_BODY), 2, 6000, 6000, 0, ["Out"]),
    "count_head": (partitioned(C4N_BODY), 2, 6000, 6000, 0, ["Out"]),
    "and": (partitioned(C4A_BODY.replace("volume > 990", "volume > 900")),
            2, 6000, 6000, 0, ["Out"]),
    "final_count": (partitioned(FINAL), 2, 5000, 5000, 0, ["Out"]),
    "f64": (F64 + partitioned(C4_BODY), 2, 6000, 6000, 0, ["Out"]),
    "one_shot_late_h0": (ONE_SHOT, 1, 4000, 4000, 1500, ["Out"]),
    "fused": (_fused(12, False), 1, 3000, 3000, 0,
              [f"Out{j}" for j in range(4)]),
    "fused_one_shot_late_h0": (_fused(12, True), 1, 3000, 3000, 1200,
                               [f"Out{j}" for j in range(4)]),
}


@pytest.mark.parametrize("name", sorted(JAX_APPS))
def test_rows_equal_jax_over_tiles(name, monkeypatch):
    """The port (plain versions) gives the JAX package's rows, in order,
    NULLs in place, on `scan` blocks whose lanes span several of K5's
    tiles."""
    app, keys, n, flush, late, outs = JAX_APPS[name]
    flushes = _flushes(keys, n, flush, seed=len(name), late=late)
    blocks = []
    orig = ParallelChainKernel.run_block

    def rec(self, ev, M):
        blocks.append((self, ev["__flat.__ts__"].shape[1]))
        return orig(self, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", rec)
    got, rt = _run(siddhi_tpu_torch, app, flushes, keys, outs, device="cpu")
    monkeypatch.setattr(ParallelChainKernel, "run_block", orig)
    want, jrt = _run(siddhi_tpu, DEV + app, flushes, keys, outs)
    fams = [getattr(p, "family", None) for p in rt.plans()]
    assert fams == ["scan"]
    assert got == want and len(got) > 0, (len(got), len(want))
    widest = max(F for _k, F in blocks)
    kern = blocks[0][0]
    assert -(-(kern.C * widest) // TILE) > 2
    if name.startswith("fused"):
        assert "__qid__" in kern.nfak.lane_names_i
    if "late_h0" in name:
        assert kern.prog.single_arm and late > TILE
