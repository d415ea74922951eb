"""K8 `win_compact` on the CPU: the plain version, the kernel's index
arithmetic, and the window plans that call it.

The CUDA kernel cannot run here, so its slot arithmetic is emulated in
numpy from the constants of csrc/win_compact.cu and held to
`win_compact_plain`:
  * without a mask, the blocks of `copy_kernel` (a block a run of one
    column's 16-byte units, the columns grouped by width 8, 4, 1), each
    unit copied whole, filled whole or slot by slot as the kernel decides;
  * with ballot words, the tiles of `mask_kernel`: per-word popcounts and
    their exclusive scan in the tile, the tile's first slot (the
    exclusive scan over the earlier tiles' counts, what the look-back
    returns), the kept-row list, and the pads written without k (a
    tile's dropped rows' run ending at n - (r0 - base), its own slots at
    or above n).
Every slot must be written exactly once and every output, and k, must
equal the plain version's bit for bit.  The plain version is held to a
numpy brute force on the edge cases (k = 0, every row kept, n = 1, n off
the word grid, one row past a tile, long pad runs, BOOL/INT/LONG/FLOAT/
DOUBLE columns, NaN payloads and -0.0 as bits).  C2, C2 grouped and C2B
(siddhi_tpu_torch.replay) run on the port's CPU path and on siddhi_tpu
under @app:deviceWindows('always') with equal rows, and the window step
takes k = n without a read-back when K8 gets no mask."""
import os
import re

import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu_torch.core import window_device
from siddhi_tpu_torch.kernels import win_compact as k8
from siddhi_tpu_torch.kernels.expr_eval import pack_mask
from siddhi_tpu_torch.replay import (C2, C2_GROUPED, C2B, make_tape,
                                     run_window)

SRC = os.path.join(os.path.dirname(k8.__file__), os.pardir, "csrc",
                   "win_compact.cu")


def defines() -> dict:
    with open(SRC) as fh:
        text = fh.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define (WC_\w+) (\d+)\b", text)}


WC = defines()
UINT = {1: np.uint8, 4: np.uint32, 8: np.uint64}
DTYPES = [torch.bool, torch.int32, torch.int64, torch.float32,
          torch.float64]


def test_constants_match_the_kernel():
    assert WC["WC_TILE"] == k8.TILE
    assert WC["WC_INLINE"] == k8.INLINE
    assert WC["WC_TILE"] == 32 * 32       # a tile is 32 ballot words
    assert WC["WC_TILE"] % WC["WC_THREADS"] == 0


def column(dtype: torch.dtype, n: int, rng) -> torch.Tensor:
    """n seeded values of `dtype`; floats with NaN payloads and -0.0."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype in (torch.int32, torch.int64):
        info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
        return torch.from_numpy(rng.integers(info.min, info.max, n,
                                             dtype=info.dtype))
    fdt, udt = (np.float32, np.uint32) if dtype == torch.float32 else \
        (np.float64, np.uint64)
    a = rng.uniform(-1e3, 1e3, n).astype(fdt)
    a[rng.random(n) < 0.1] = fdt(-0.0)
    bits = a.view(udt)
    nan = rng.random(n) < 0.05           # quiet NaNs with random payloads
    exp = udt(0x7fc00000) if fdt == np.float32 else \
        udt(0x7ff8000000000000)
    payload = rng.integers(1, 1 << 20, n).astype(udt)
    bits[nan] = exp | payload[nan]
    return torch.from_numpy(bits.view(fdt).copy())


FILLS = {torch.bool: True, torch.int32: -7, torch.int64: 2 ** 62,
         torch.float32: -0.0, torch.float64: float("nan")}


def raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits (bool as its bytes)."""
    a = t.numpy()
    return a.view(UINT[a.itemsize])


def brute(cols, fills, n, T, keep):
    """The compaction row by row in numpy, as bits."""
    outs = []
    for c, f in zip(cols, fills):
        full = torch.full((1,), f, dtype=c.dtype)
        o = np.full(T, raw(full)[0], dtype=UINT[c.element_size()])
        src = raw(c)
        j = 0
        for r in range(n):
            if keep[r]:
                o[j] = src[r]
                j += 1
        outs.append(o)
    return outs, int(keep[:n].sum())


CASES = [  # (n, T, density): k = 0, all kept, n = 1, n % 32 != 0, one row
    # past a tile, T >= 2n, several tiles
    (1000, 1024, 0.0), (1000, 1024, 1.0), (1, 1, 1.0), (1, 32, 0.0),
    (77, 96, 0.5), (1025, 2048, 0.4), (1024, 1024, 0.4), (100, 300, 0.3),
    (3000, 9000, 0.6), (0, 64, 0.5)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,T,density", CASES)
def test_plain_matches_brute_force(n, T, density, masked):
    rng = np.random.default_rng(n + T)
    cols = [column(dt, max(n, 1), rng) for dt in DTYPES]
    fills = [FILLS[dt] for dt in DTYPES]
    keep = rng.random(n) < density if masked else np.ones(n, bool)
    mask = pack_mask(torch.from_numpy(keep)) if masked and n else \
        (torch.zeros(1, dtype=torch.int32) if masked else None)
    outs, k = k8.win_compact_plain(cols, fills, n, T, mask)
    want, kk = brute(cols, fills, n, T, keep)
    assert k.dtype == torch.int32 and int(k[0]) == kk
    for o, w, c in zip(outs, want, cols):
        assert o.dtype == c.dtype and o.shape == (T,)
        np.testing.assert_array_equal(raw(o), w)


NAN = float("nan")
FILL_CASES = [(torch.bool, f) for f in (0, 1, True, False, 0.5, NAN, -0.0)] + [
    (torch.uint8, f) for f in (0, 1, 255, True)] + [
    (torch.int32, f) for f in (0, 1, -1, -7, True, 2 ** 31 - 1)] + [
    (torch.int64, f) for f in (0, -1, 2 ** 62, -2 ** 63, True)] + [
    (dt, f) for dt in (torch.float32, torch.float64)
    for f in (0, 1, -1, 0.5, 0.1, -0.0, NAN, 2 ** 62, -1e30)]


@pytest.mark.parametrize("dtype,fill", FILL_CASES)
def test_fill_bits_are_torch_full_bits(dtype, fill):
    want = raw(torch.full((1,), fill, dtype=dtype))[0]
    width = torch.empty((), dtype=dtype).element_size()
    assert k8.fill_bits(fill, dtype, width) == int(want)


# -- the kernel's index arithmetic, emulated -------------------------------

def emulate(cols, fills, n, T, words):
    """csrc/win_compact.cu's slots in numpy: (outputs as bits, k, how
    often each slot of each output was written)."""
    widths = [c.element_size() for c in cols]
    order, n_w = k8.width_order(widths)
    src = [raw(cols[i]) for i in order]
    fill = [k8.fill_bits(fills[i], cols[i].dtype, widths[i])
            for i in order]
    wd = [widths[i] for i in order]
    out = [np.zeros(T, UINT[w]) for w in wd]
    hits = [np.zeros(T, np.int64) for _ in wd]

    def put(c, slots, vals):
        np.add.at(hits[c], slots, 1)
        out[c][slots] = vals

    if words is None:
        threads, units, run = (WC["WC_THREADS"], WC["WC_UNITS"],
                               WC["WC_THREADS"] * WC["WC_UNITS"] * 16)
        per = [-(-T * w // run) for w in k8.WIDTHS]
        blocks = max(1, sum(p * m for p, m in zip(per, n_w)))
        for b in range(blocks):
            c, left = 0, b
            for g, w in enumerate(k8.WIDTHS):
                if left < per[g] * n_w[g]:
                    c += left // per[g]
                    r = left % per[g]
                    assert wd[c] == w
                    V = 16 // w
                    q, t = np.meshgrid(np.arange(units), np.arange(threads),
                                       indexing="ij")
                    s0 = (((r * units + q) * threads + t) * V).ravel()
                    s0 = s0[s0 < T]
                    for s in s0:        # each unit: whole or slot by slot
                        sl = np.arange(s, min(s + V, T))
                        v = np.where(sl < n, src[c][np.minimum(sl, max(
                            n - 1, 0))] if n else fill[c], fill[c])
                        put(c, sl, v.astype(UINT[w]))
                    break
                left -= per[g] * n_w[g]
                c += n_w[g]
        return out, n, hits, order
    tile = k8.TILE
    below = -(-n // tile)
    tiles = max(1, -(-T // tile))
    w32 = words.numpy().view(np.uint32)
    counts = []
    for g in range(below):            # each lane's word, masked at n
        ws = []
        for j in range(32):
            row = g * tile + 32 * j
            w = int(w32[row >> 5]) if row < n else 0
            if 0 < n - row < 32:
                w &= (1 << (n - row)) - 1
            ws.append(w)
        counts.append(ws)
    pops = [np.array([bin(x).count("1") for x in ws]) for ws in counts]
    totals = [int(p.sum()) for p in pops]
    k = sum(totals)
    for g in range(tiles):
        r0 = g * tile
        cnt = nd = 0
        base = dlo = 0
        lst = np.zeros(0, np.int64)
        if g < below:
            ws, pop = counts[g], pops[g]
            place = np.cumsum(pop) - pop          # exclusive, in the tile
            base = sum(totals[:g])                # the look-back's answer
            lst = np.zeros(totals[g], np.int64)
            for j in range(32):
                for lane in range(32):
                    if (ws[j] >> lane) & 1:
                        below_bits = ws[j] & ((1 << lane) - 1)
                        lst[place[j] + bin(below_bits).count("1")] = \
                            32 * j + lane
            cnt = totals[g]
            rows = min(n - r0, tile)
            nd = rows - cnt
            dlo = n - (r0 - base) - nd
            # the rule: dropped row r goes to n - 1 - (r - pos_r)
            keep_t = np.zeros(rows, bool)
            keep_t[lst] = True
            drop = np.nonzero(~keep_t)[0] + r0
            pos = base + np.cumsum(keep_t)[drop - r0] - keep_t[drop - r0]
            assert sorted(n - 1 - (drop - pos)) == list(range(dlo, dlo + nd))
        plo, phi = max(r0, n), min(r0 + tile, T)
        for c in range(len(wd)):
            put(c, base + np.arange(cnt), src[c][r0 + lst])
            put(c, dlo + np.arange(nd), np.full(nd, fill[c], UINT[wd[c]]))
            if phi > plo:
                put(c, np.arange(plo, phi),
                    np.full(phi - plo, fill[c], UINT[wd[c]]))
    return out, k, hits, order


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,T,density", CASES + [
    (5000, 5000, 0.97), (4097, 16384, 0.02), (2048, 2048, 0.5)])
def test_kernel_slots_match_plain(n, T, density, masked):
    rng = np.random.default_rng(7 * n + T)
    dts = [torch.int64, torch.float32, torch.bool, torch.float64,
           torch.int32, torch.bool, torch.int64]
    cols = [column(dt, max(n, 1), rng) for dt in dts]
    fills = [FILLS[dt] for dt in dts]
    keep = rng.random(n) < density if masked else np.ones(n, bool)
    words = (pack_mask(torch.from_numpy(keep)) if n else
             torch.zeros(1, dtype=torch.int32)) if masked else None
    got, k, hits, order = emulate(cols, fills, n, T, words)
    want, kp = k8.win_compact_plain(cols, fills, n, T, words)
    assert k == int(kp[0])
    for j, i in enumerate(order):
        assert (hits[j] == 1).all()          # every slot exactly once
        np.testing.assert_array_equal(got[j], raw(want[i]))


@pytest.mark.parametrize("widths", [[8, 4], [4, 8, 1, 1, 8], [1] * 20,
                                    [4] * 3])
@pytest.mark.parametrize("n,T,masked", [(131072, 131072, False),
                                        (3691, 3691, True),
                                        (1024, 1024, True), (0, 16, True)])
def test_buffer_layout(widths, n, T, masked):
    """The call's one byte buffer: state, k and outputs apart, each output
    on a 128-byte line (the copies' 16-byte units need 16)."""
    nstate, kpos, offs, size = k8.layout(n, T, widths, masked)
    assert nstate == (8 * (1 + k8.tiles_below(n))
                      if masked and n > k8.TILE else 0)
    spans = [(0, nstate), (kpos, kpos + 4)] + [
        (o, o + T * w) for o, w in zip(offs, widths)]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= size and kpos % 8 == 0
    assert all(o % k8.ALIGN == 0 for o in offs)
    order, n_w = k8.width_order(widths)
    assert [widths[i] for i in order] == sorted(widths, reverse=True)
    assert n_w == [widths.count(w) for w in (8, 4, 1)]
    assert order == sorted(order, key=lambda i: (-widths[i], i))


def test_cuda_only_prepare_refuses_the_cpu():
    with pytest.raises(ValueError):
        k8.prepare([torch.zeros(4)], [0], 4, 4)


# -- the window plans -------------------------------------------------------

def jax_window(app: str, tape: list) -> list:
    """run_window's feed through siddhi_tpu's device window plan."""
    m = siddhi_tpu.SiddhiManager()
    rt = m.create_app_runtime("@app:deviceWindows('always')\n" + app)
    batches: list = []
    rt.add_callback("Out", lambda evs: batches.extend(
        (int(e.timestamp), tuple(e.data)) for e in evs))
    h = rt.input_handler("StockStream")
    codes = [f"K{i}" for i in range(64)]
    for f in tape:
        for j in range(len(f["ts"])):
            row = (codes[f["sym_idx"][j]], float(f["price"][j]),
                   int(f["volume"][j]))
            if "et long" in app:
                row += (int(f["ts"][j]),)
            h.send(row, timestamp=int(f["ts"][j]))
        rt.flush()
    m.shutdown()
    return batches


@pytest.mark.parametrize("which", ["c2", "c2_grouped", "c2b"])
def test_window_cells_match_jax(which):
    """C2, C2 grouped and C2B, the cells whose K8 calls chip_smoke.py
    times, on a seeded tape of 3 flushes of 1500 events (several masked
    tiles, n off the word grid): the port's rows equal siddhi_tpu's."""
    app = {"c2": C2, "c2_grouped": C2_GROUPED, "c2b": C2B}[which]
    tape = make_tape(3 * 1500, 1500, 8, seed=17)
    calls: list = []
    got, _ms, _rt = run_window(app, tape, "cpu", calls)
    want = jax_window(app, tape)
    assert got and [(t, tuple(r)) for t, r in got] == want
    assert any(c[0] == "win_compact" for c in calls)


def test_maskless_step_reads_no_k(monkeypatch):
    """Without a filter or argument programs K8 gets no mask and the
    window step takes k = n: a k tensor that lies changes no row."""
    tape = make_tape(2 * 3000, 3000, 8, seed=5)
    want, _ms, _rt = run_window(C2, tape, "cpu")
    plain = window_device.KERNELS["win_compact"]
    seen = []

    def lying(cols, fills, n, T, mask=None):
        outs, k = plain(cols, fills, n, T, mask)
        seen.append(mask is None)
        return outs, k - 1 if mask is None else k
    monkeypatch.setitem(window_device.KERNELS, "win_compact", lying)
    got, _ms, _rt = run_window(C2, tape, "cpu")
    assert got == want and seen and all(seen)
