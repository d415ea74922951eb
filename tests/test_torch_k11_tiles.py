"""K11 `dfa_tables` as the H100 kernel tiles it, on the CPU.

The kernel splits a lane's stride-blocks into tiles of 32 W (W warps a
CUDA block, `tile_geometry`), builds each tile's suffix and packed words
and its within-tile next-block pointers, and carries `nblk` across tiles
by a reverse look-back over each tile's first hit block.  These tests
hold `dfa_tables_plain` to the JAX package's `_dfa_tables` on lanes that
span several such tiles (tiles without a hit, a lane whose only hit is
its first block so the carry crosses every tile, F not a multiple of 4,
1-8 chase nodes), the tile geometry to its bounds, and the kernel's
two-part composition of `nblk` (a model in numpy of what each tile,
warp and thread computes) to the plain version.  The card holds the
kernel to its plain version (tests/test_torch_gpu.py, `dfa_tables`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.core import nfa_parallel as jpar

from siddhi_tpu_torch.kernels.dfa_tables import (MAX_WARPS, STRIDE,
                                                 dfa_tables_plain,
                                                 tile_geometry)

C3SD_EVENTS = 263_145          # chip_smoke's C3SD block: one lane


def _masks(nk, L, F, kind, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((nk, L, F), bool)
    for k in range(nk):
        if kind == "first":
            m[k, :, 0] = True
        elif kind == "last":
            m[k, :, F - 1] = True
        elif kind == "gaps":          # hits only in every third tile
            tile = 32 * MAX_WARPS * STRIDE
            for t in range(0, -(-F // tile), 3):
                m[k, :, t * tile:(t + 1) * tile] = \
                    rng.random((L, min(tile, F - t * tile))) < 0.01
        elif kind == "random":
            m[k] = rng.random((L, F)) < 0.02 * (k + 1)
    return m


@pytest.mark.parametrize("nk,F,kind", [
    (1, 3001, "first"), (1, 9000, "none"), (2, 5003, "last"),
    (3, 7170, "gaps"), (4, 4097, "random"), (8, 2051, "random"),
    (5, 1029, "first"), (6, 6146, "gaps")])
def test_plain_tables_over_several_tiles_equal_jax(nk, F, kind):
    """`dfa_tables_plain` equals `_dfa_tables` on one lane of several of
    the kernel's tiles."""
    assert tile_geometry(-(-F // STRIDE))[1] > 1
    m = _masks(nk, 1, F, kind, nk * F)
    L2 = max(2, 1 << (F - 1).bit_length())
    jsuf, jpacked, jnblk, NB = jpar.ParallelChainKernel._dfa_tables(
        None, [jnp.asarray(m[k, 0]) for k in range(nk)], F, L2)
    suffix, packed, nblk = dfa_tables_plain(
        [torch.from_numpy(m[k]) for k in range(nk)])
    assert packed.shape == (1, NB) and nblk.shape == (nk, 1, NB)
    np.testing.assert_array_equal(packed[0].numpy(),
                                  np.asarray(jpacked).astype(np.int64))
    for k in range(nk):
        np.testing.assert_array_equal(
            ((suffix[0].to(torch.int64) >> (3 * k)) & 7).numpy(),
            np.asarray(jsuf[k]))
        np.testing.assert_array_equal(nblk[k, 0].numpy(),
                                      np.asarray(jnblk[k]))


@pytest.mark.parametrize("NB", [0, 1, 31, 32, 33, 82, 95, 96, 97, 255,
                                256, 257, 4096, 65_787, 1 << 20])
def test_tile_geometry(NB):
    """Tiles cover the lane; a lane of one tile takes only the warps it
    needs (C4D: 82 stride-blocks, 3 warps); a lane of several takes
    blocks of MAX_WARPS warps (C3SD: 65,787 stride-blocks, 257 tiles)."""
    W, T = tile_geometry(NB)
    assert 1 <= W <= MAX_WARPS and T >= 1
    assert T * 32 * W >= NB and (T - 1) * 32 * W < max(NB, 1)
    if T > 1:
        assert W == MAX_WARPS
    else:
        assert W == max(1, -(-NB // 32))
    assert tile_geometry(-(-C3SD_EVENTS // STRIDE)) == (8, 257)
    assert tile_geometry(-(-326 // STRIDE)) == (3, 1)


def _kernel_model(m: np.ndarray) -> tuple:
    """What the kernel's tiles compute, in numpy: thread j of a tile owns
    stride-block b; its suffix words by find-first-set on its four bits;
    `nblk` from the first set bit at or after b of its warp's ballot,
    else the first hit of the warps to its right, else the carry from the
    tiles to its right (the look-back: the min over their first hits)."""
    nk, L, F = m.shape
    NB = -(-F // STRIDE)
    W, T = tile_geometry(NB)
    bits = np.zeros((nk, L, NB * STRIDE), bool)
    bits[:, :, :F] = m
    nib = bits.reshape(nk, L, NB, STRIDE)
    suffix = np.zeros((L, NB, STRIDE), np.int64)
    for k in range(nk):
        for e in range(STRIDE):
            later = nib[k, :, :, e:]
            off = np.where(later.any(-1), e + later.argmax(-1), STRIDE)
            suffix[:, :, e] |= off << (3 * k)
    nblk = np.full((nk, L, NB), NB, np.int64)
    hit = nib.any(-1)                              # (nk, L, NB)
    for k in range(nk):
        for lane in range(L):
            pad = np.zeros(T * W * 32, bool)
            pad[:NB] = hit[k, lane]
            warps = pad.reshape(T, W, 32)
            first = np.where(warps.any(-1), warps.argmax(-1) +
                             32 * (np.arange(T)[:, None] * W +
                                   np.arange(W)[None, :]), NB)
            tile_first = first.min(1)
            for t in range(T):
                carry = min([NB] + list(tile_first[t + 1:]))   # look-back
                for w in range(W):
                    run = min([carry] + list(first[t, w + 1:]))
                    for j in range(32):
                        b = (t * W + w) * 32 + j
                        if b >= NB:
                            continue
                        h = np.flatnonzero(warps[t, w, j:])
                        nblk[k, lane, b] = b + h[0] if len(h) else run
    return (suffix.reshape(L, -1), suffix[:, :, 0], nblk)


@pytest.mark.parametrize("nk,L,F,kind", [
    (1, 1, 40_000, "first"), (2, 1, 30_001, "gaps"), (3, 2, 9_001, "last"),
    (1, 3, 2_050, "none"), (8, 1, 12_000, "random"), (2, 12, 326, "random"),
    (1, 4, 1, "random")])
def test_kernel_composition_equals_plain(nk, L, F, kind):
    """The kernel's tile, warp and look-back composition of the tables
    equals `dfa_tables_plain` (which equals the JAX package's)."""
    m = _masks(nk, L, F, kind, L * F)
    suffix, packed, nblk = _kernel_model(m)
    ps, pp, pn = dfa_tables_plain([torch.from_numpy(m[k])
                                   for k in range(nk)])
    np.testing.assert_array_equal(suffix, ps.numpy().astype(np.int64))
    np.testing.assert_array_equal(packed, pp.numpy().astype(np.int64))
    np.testing.assert_array_equal(nblk, pn.numpy().astype(np.int64))
