"""K7 `win_range` as the H100 kernel tiles it, on the CPU.

The kernel (csrc/win_range.cu) builds no table over all n entries: a
first launch writes each entry's prefix and suffix in its 32-entry
sub-block and in its 1024-entry tile, each tile's table over its
sub-blocks and a sparse table over the tile extremes, a second reads at
most four of those per range (tests/torch_k7_cases.py models each step
in numpy). These tests hold that model and `win_range_plain` to each
other and to the JAX package's `_sparse_table` / `_range_reduce`
(ungrouped) and `_seg_window_minmax` / `_seg_window_sum` (grouped) with
tolerance 0 -- the same bits, NaN compared by position (its payload may
differ where two NaNs meet) -- on calls with n off a multiple of the
tile, ranges in one sub-block, one tile, two tiles and some 270,
segments straddling tiles, invalid entries, -0, +0, +-inf and NaN, both
window kinds, and on seeded small calls of every shape. The card holds
the kernel to `win_range_plain` on the same calls
(tests/test_torch_gpu.py, `win_range_tiles`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_k7_cases import (CASES, SPECIALS, TILE, make_call, model_minmax,
                            ranges, same_bits, seg_rank)

from siddhi_tpu.core import window_device as jwin

from siddhi_tpu_torch.kernels.win_range import geometry, win_range_plain

SMALL = 6                       # seeded small calls


def small_call(seed: int) -> tuple:
    """A seeded call of up to three tiles: any kind, span and grouping."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 3 * TILE + 40))
    first = int(rng.integers(0, n))
    kind = ("length", "time")[seed % 2]
    span = int(rng.choice([0, 1, 5, 33, 700, 1500, 5000]))
    segs = int(rng.choice([0, 0, 1, 3, 9]))
    CASES[f"small{seed}"] = (n, first, kind, span, segs)
    try:
        sites, kw = make_call(f"small{seed}", seed)
    finally:
        del CASES[f"small{seed}"]
    m = int(rng.integers(0, n - first + 1))
    kw.update(m=m, last=first + m - 1)
    return sites, kw


def _call(case):
    return make_call(case, 1) if isinstance(case, str) else \
        small_call(case)


def _minmax_sites(sites, outs):
    return [(op, vals, odt, o) for (op, _p, _c, vals, odt), o
            in zip(sites, outs) if op in ("min", "max")]


CALLS = sorted(CASES) + list(range(SMALL))


@pytest.mark.parametrize("case", CALLS)
def test_model_equals_plain(case):
    """The kernel's composition (numpy model) gives `win_range_plain`'s
    min/max bits on every output."""
    sites, kw = _call(case)
    outs, _sk = win_range_plain(sites, **kw)
    lo, hi = ranges(kw)
    valid = kw["valid"].numpy()
    for op, vals, odt, o in _minmax_sites(sites, outs):
        got = model_minmax(vals.numpy(), valid, lo, hi, op == "max")
        assert same_bits(torch.from_numpy(got).to(odt), o), (case, op, odt)


def _jax_left(kw):
    n, first, m = kw["n"], kw["first"], kw["m"]
    if kw["kind"] == "length":
        vcnt = jnp.asarray(kw["vcnt"].numpy())
        return jnp.searchsorted(vcnt, jnp.maximum(vcnt - kw["span"], 0),
                                side="right")
    clock = jnp.asarray(kw["clock"].numpy())
    return jnp.searchsorted(clock, clock - kw["span"], side="right")


@pytest.mark.parametrize("case", CALLS)
def test_plain_equals_jax(case):
    """`win_range_plain` against the JAX package's range reductions over
    the whole scanned carry and batch (step_sliding's use of them), the
    batch's outputs compared: min/max bit for bit (NaN by position), the
    quarter-grid sum exactly."""
    sites, kw = _call(case)
    n, first, m = kw["n"], kw["first"], kw["m"]
    outs, _sk = win_range_plain(sites, **kw)
    left = _jax_left(kw)
    gpos = jnp.arange(n, dtype=jnp.int64)
    sv = kw["valid"].numpy()
    if kw["groups"] is None:
        order = np.arange(n)
        seg = None
    else:
        seg_np, rank = seg_rank(kw)
        order = np.empty(n, np.int64)
        order[rank] = np.arange(n)
        seg = jnp.asarray(seg_np)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    valid = sv[inv]                                    # arrival order
    for op, vals, odt, o in _minmax_sites(sites, outs):
        is_max = op == "max"
        v = vals.numpy().astype(np.float64)[inv]
        vv = jnp.where(jnp.asarray(valid), jnp.asarray(v),
                       -jnp.inf if is_max else jnp.inf)
        if seg is None:
            table = jwin._sparse_table(vv, is_max)
            want = jwin._range_reduce(table, jnp.minimum(left, gpos), gpos,
                                      is_max)
        else:
            want = jwin._seg_window_minmax(seg, vv, left, gpos, n, is_max)
        w = torch.from_numpy(np.asarray(want)[first:first + m]).to(odt)
        assert same_bits(o, w), (case, op, odt)
    # the quarter-grid f64 sum (site 0, f32 out): exact prefixes both ways
    clean = np.asarray(torch.diff(sites[0][1], prepend=torch.zeros(
        1, dtype=torch.float64)).numpy())[inv]
    v = jnp.where(jnp.asarray(valid), jnp.asarray(clean), 0.0)
    if seg is None:
        c = jnp.cumsum(v)
        want = c - jnp.where(left > 0, c[jnp.maximum(left - 1, 0)], 0.0)
    else:
        want = jwin._seg_window_sum(seg, v, left, gpos, n)
    w = torch.from_numpy(np.asarray(want)[first:first + m]).to(torch.float32)
    assert same_bits(outs[0], w), case


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_reach_every_composition(case):
    """Each named call reaches the compositions its name promises: ranges
    in one sub-block, inside one tile, across two tiles, across more (the
    tile table), across over 256 tiles (its ninth level) where it says
    so."""
    _sites, kw = make_call(case, 1)
    lo, hi = ranges(kw)
    l = np.minimum(lo, hi)
    span_tiles = hi // TILE - l // TILE
    sub = (l // 32) == (hi // 32)
    want = {"short": sub.any() and (span_tiles == 0).any(),
            "two_tiles": (span_tiles >= 1).any(),
            "first_mid": kw["first"] % TILE != 0 and (span_tiles == 1).any(),
            "many_tiles": span_tiles.max() > 256,
            "degenerate": (lo > hi).any() and (l == hi).all(),
            "grouped_straddle": (span_tiles == 1).any(),
            "grouped_short": sub.any(),
            "grouped_many": span_tiles.max() > 100,
            "grouped_degenerate": (lo > hi).any() and (l == hi).all()}[case]
    assert want
    assert kw["n"] % TILE != 0
    vals = [s[3] for s in _sites if s[0] == "min"]
    raw = vals[-1].numpy()
    for x in SPECIALS:
        hit = np.isnan(raw) if np.isnan(x) else (raw == x) & (
            np.signbit(raw) == np.signbit(x))
        assert hit.any(), x


@pytest.mark.parametrize("n,first,m,grouped", [
    (1, 0, 1, False), (1024, 0, 1024, False), (1025, 1000, 25, False),
    (132_096, 1024, 131_072, False), (147_456, 16_384, 131_072, True),
    (5000, 4999, 0, False), (3 * 1024, 3 * 1024 - 1, 1, True)])
def test_geometry(n, first, m, grouped):
    """The tiles cover n; the query launch covers every output's slot (all
    tiles when grouped, since a batch entry's sorted slot may lie
    anywhere), at least one tile, none past the last."""
    ntiles, t0, q = geometry(n, first, m, grouped)
    assert (ntiles - 1) * TILE < max(n, 1) <= ntiles * TILE
    assert 1 <= q and 0 <= t0 and t0 + q <= ntiles
    if grouped:
        assert (t0, q) == (0, ntiles)
    elif m:
        assert t0 * TILE <= first and first + m - 1 < (t0 + q) * TILE
