"""The fold orders the redesigned K6 and K10 kernels rely on, on the CPU.

K10 (`agg_merge`) folds each sum in event order but reduces min and max
in any order (lane by lane, then a butterfly of shuffles), and K6
(`win_scan`) combines its 1024-entry tiles through a look-back over tile
aggregates, an association of its own.  These tests hold what makes that right:

- `jmin`/`jmax` (jnp.minimum / jnp.maximum: NaN propagates, -0.0 below
  +0.0) give the same bits over any permutation and any tree, NaN compared
  by `isnan`;
- a Python emulation of K6's association (per thread a serial fold of 4
  entries, warp and block Hillis-Steele scans, the nearest predecessor's
  aggregate where it holds a segment start, else a block scan over the
  aggregates of the tile's look-back window, behind the previous window's
  inclusive prefix; `period` mode) equals `win_scan_plain` bit for bit on
  exact data, and `win_scan_plain` equals the JAX window step's scans
  there; on raw doubles the two associations differ in the last bits,
  within the rounding bound of a sum.  The association depends on the
  data alone, so the kernel's runs agree bit for bit (the card tests hold
  the kernel to this emulation on raw doubles);
- `agg_merge_plain` equals the JAX package's jitted `_make_step` bit for
  bit on raw doubles, at lengths around the warp and the kernel's chunks
  and on one 2^15-event segment.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from siddhi_tpu.core import window_device as jwd
from siddhi_tpu.core.agg_device import DeviceAggregationPlan

from siddhi_tpu_torch.kernels.agg_merge import (PASS, agg_merge_plain,
                                                stage_tables)
from siddhi_tpu_torch.kernels.win_scan import (TILE, jmax, jmin,
                                               win_scan_plain)
from torch_k6_association import THREADS, k6_emulate

# ---------------------------------------------------------------------------
# min/max in any order
# ---------------------------------------------------------------------------

_SPECIAL = [math.nan, 0.0, -0.0, math.inf, -math.inf, 1.5, -1.5, 2.0 ** -1074]


def _fold_tree(op, xs, splits):
    """op over xs as the binary tree the split points pick."""
    if len(xs) == 1:
        return xs[0]
    k = 1 + splits.pop() % (len(xs) - 1) if splits else len(xs) // 2
    return op(_fold_tree(op, xs[:k], splits), _fold_tree(op, xs[k:], splits))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if bool(torch.isnan(a)) or bool(torch.isnan(b)):
        return bool(torch.isnan(a)) and bool(torch.isnan(b))
    return bool(a == b) and bool(torch.signbit(a) == torch.signbit(b))


@settings(max_examples=300, deadline=None)
@given(xs=st.lists(st.one_of(st.sampled_from(_SPECIAL),
                             st.floats(allow_nan=True, allow_infinity=True)),
                   min_size=1, max_size=40),
       data=st.data())
def test_min_max_folds_are_order_and_tree_free(xs, data):
    perm = data.draw(st.permutations(range(len(xs))))
    splits = data.draw(st.lists(st.integers(0, 1 << 16),
                                max_size=2 * len(xs)))
    vals = [torch.tensor([x], dtype=torch.float64) for x in xs]
    shuffled = [vals[i] for i in perm]
    for op, ident in ((jmin, math.inf), (jmax, -math.inf)):
        serial = torch.tensor([ident], dtype=torch.float64)
        for v in vals:
            serial = op(serial, v)
        tree = _fold_tree(op, shuffled, list(splits))
        # the identity on either side changes nothing either
        assert _same_bits(serial, tree)
        assert _same_bits(serial, op(tree, torch.tensor(
            [ident], dtype=torch.float64)))


def test_sum_fold_is_not_order_free():
    """The counterexample that keeps K10's sums serial: the canary folds to
    1 forward and to 0 through a tree."""
    xs = [torch.tensor([v], dtype=torch.float64)
          for v in (1e16, 1.0, -1e16, 1.0)]
    forward = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    tree = (xs[0] + xs[1]) + (xs[2] + xs[3])
    assert float(forward) == 1.0 and float(tree) == 0.0


# ---------------------------------------------------------------------------
# K6: the look-back association against the plain version and JAX
# ---------------------------------------------------------------------------

def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.double(), b.double()
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _scan_inputs(n, seed, grid=True):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-100, 100, n)
    if grid:
        v = np.round(v * 4) / 4          # every f64 prefix exact
    return (rng, torch.from_numpy(v),
            torch.from_numpy(rng.random(n) < 0.9),
            torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, n)))


@pytest.mark.parametrize("window", [THREADS, 2])
@pytest.mark.parametrize("case", ["plain", "segmented", "tile_starts",
                                  "period322", "period1500"])
def test_k6_look_back_association_equals_plain_on_exact_data(case, window):
    n = 5 * TILE + 300
    rng, v, valid, big = _scan_inputs(n, 7)
    flags, period = None, 0
    if case == "segmented":
        flags = torch.from_numpy(rng.random(n) < 0.0005)
    if case == "tile_starts":
        fl = np.zeros(n, bool)
        fl[[TILE, 2 * TILE - 1, 3 * TILE + 1, 4 * TILE]] = True
        flags = torch.from_numpy(fl)
    if case.startswith("period"):
        period = int(case[6:])
    own = torch.from_numpy(rng.random(n) < 0.4)
    cols = [("sum", v, True), ("sum", big, True), ("sum", None, True),
            ("min", v, True, own), ("max", v, True)]
    if period:
        cols += [("max", None, True, own), ("sum", own, False)]
    got = k6_emulate(cols, n, valid, flags, period, window)
    want = win_scan_plain(cols, n, valid, flags, period)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _same(g, w)


def test_plain_scans_equal_the_jax_window_scans_on_exact_data():
    """win_scan_plain against the JAX window step's scans: the prefix sum
    (jnp.cumsum), the valid count, and the segmented running sum, min and
    max of the tumbling windows (`_mono_running_*`), quarter-grid values."""
    n = 3 * TILE + 17
    rng, v, valid, _big = _scan_inputs(n, 8)
    flags = torch.from_numpy(rng.random(n) < 0.003)
    flags[0] = True
    seg = jnp.asarray(np.cumsum(flags.numpy()))
    vm = torch.where(valid, v, torch.zeros_like(v))
    s, cnt = win_scan_plain([("sum", v, True), ("sum", None, True)], n,
                            valid)
    assert np.array_equal(s.numpy(), np.asarray(jnp.cumsum(
        jnp.asarray(vm.numpy()))))
    assert np.array_equal(cnt.numpy(), np.asarray(jnp.cumsum(
        jnp.asarray(valid.numpy()).astype(jnp.int64))))
    rs, lo, hi = win_scan_plain([("sum", v, False), ("min", v, False),
                                 ("max", v, False)], n, flags=flags)
    jv = jnp.asarray(v.numpy())
    assert np.array_equal(rs.numpy(), np.asarray(jwd._mono_running_sum(
        seg, jv)))
    assert np.array_equal(lo.numpy(), np.asarray(jwd._mono_running_minmax(
        seg, jv, False)))
    assert np.array_equal(hi.numpy(), np.asarray(jwd._mono_running_minmax(
        seg, jv, True)))


def test_k6_look_back_association_on_raw_doubles():
    """Where f64 rounds, K6's association is not the plain version's: the
    sums differ in the last bits, each within the rounding bound of two
    folds of the prefix (2 (i + 1) 2^-53 sum|v| at entry i); min, max and
    the integer columns stay equal."""
    n = 4 * TILE + 5
    _rng, v, valid, big = _scan_inputs(n, 9, grid=False)
    v = v * torch.exp(torch.from_numpy(np.random.default_rng(3).uniform(
        -20, 20, n)))
    cols = [("sum", v, True), ("min", v, True), ("sum", big, True)]
    got = k6_emulate(cols, n, valid)
    want = win_scan_plain(cols, n, valid)
    diff = (got[0] - want[0]).abs()
    bound = 2 * torch.arange(1, n + 1) * 2.0 ** -53 * torch.cumsum(
        torch.where(valid, v.abs(), torch.zeros_like(v)), 0)
    assert bool((diff <= bound).all())
    assert bool((diff > 0).any())        # the associations do differ
    assert _same(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# K10: the plain merge against the JAX package's jitted step
# ---------------------------------------------------------------------------

_OPS = ["sum", "count", "min", "max", "sum", "min", "max"]
_SITE = [0, 0, 1, 0, 1, 0, 1]       # the JAX step's value row per base


@pytest.mark.parametrize("lens", [
    [31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1025],
    [1 << 15, 3, 1, 2]])
def test_plain_merge_equals_the_jax_step_bit_for_bit(lens):
    rng = np.random.default_rng(len(lens))
    n, m = int(sum(lens)), len(lens)
    inv = rng.permutation(np.repeat(np.arange(m), lens)).astype(np.int32)
    vals = rng.uniform(-1, 1, (2, n)) * np.exp(rng.uniform(-30, 30, (2, n)))
    vals[0, rng.integers(0, n, 3)] = np.nan
    vals[1, rng.integers(0, n, 5)] = -0.0
    vals[1, rng.integers(0, n, 5)] = 0.0
    cap = 2 * m
    pre = rng.uniform(-5, 5, (cap, len(_OPS)))
    slot = rng.permutation(cap)[:m].astype(np.int32)
    fresh = rng.uniform(size=m) < 0.5

    plan = DeviceAggregationPlan.__new__(DeviceAggregationPlan)
    plan._jnp, plan.base_ops, plan.val_of_base = jnp, _OPS, _SITE
    step = jax.jit(plan._make_step())
    mpad = 1 << (m + 1).bit_length()
    slots_p = np.full(mpad, cap, np.int32)
    slots_p[:m] = slot
    fresh_p = np.ones(mpad, bool)
    fresh_p[:m] = fresh
    jbases = np.concatenate([pre, np.zeros((1, len(_OPS)))])
    want = np.asarray(step(jnp.asarray(jbases), jnp.asarray(inv),
                           jnp.asarray(vals), jnp.asarray(slots_p),
                           jnp.asarray(fresh_p)))[:cap]

    order = np.argsort(inv, kind="stable").astype(np.int32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got = agg_merge_plain(
        torch.from_numpy(pre.copy()), torch.from_numpy(vals),
        torch.from_numpy(order), torch.from_numpy(off),
        torch.from_numpy(slot), torch.from_numpy(fresh.astype(np.int32)),
        _OPS, [-1 if op == "count" else r for op, r in zip(_OPS, _SITE)]
    ).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert np.array_equal(np.signbit(got[~np.isnan(got)]),
                          np.signbit(want[~np.isnan(want)]))


@pytest.mark.parametrize("nb", [7, 70, 400])
def test_k10_stage_tables_hold_each_pass_to_its_own_rows(nb):
    """K10 launches once per pass of 64 bases and stages only the value
    rows of that pass's bases, so a warp's stage never holds more than 64
    rows (the shared memory of one segment a block fits at any number of
    bases): each base finds its own value row at its stage index, and each
    pass's min/max bases are its own."""
    kinds = ["sum", "min", "sum", "max", "count"]
    ops = [kinds[b % 5] for b in range(nb)]
    rows = [-1 if op == "count" else b for b, op in enumerate(ops)]
    passes = stage_tables(ops, rows)
    assert len(passes) == -(-nb // PASS)
    assert [op for t in passes for op in t["ops"]] == ops
    for q, t in enumerate(passes):
        assert all(len(w) <= PASS for w in t["srow"])
        for i, op in enumerate(t["ops"]):
            b = q * PASS + i
            if op != "count":
                assert t["srow"][op != "sum"][t["sidx"][i]] == rows[b]
            assert (i in t["mm"]) == (op in ("min", "max"))
