"""K7 `win_range` calls at the edges of its tiles, and a numpy model of
what each block and thread of its kernel (csrc/win_range.cu) computes.

Shared by tests/test_torch_k7_tiles.py (on the CPU: the model against
`win_range_plain` and the JAX package) and tests/test_torch_gpu.py (on a
card: the kernel against `win_range_plain`).  Torch and numpy only.

The kernel cuts the scanned order into tiles of TILE entries and each
tile into sub-blocks of SUB.  Its first launch writes, per min/max site,
each entry's prefix and suffix in its sub-block and in its tile, each
tile's sparse table over its 32 sub-block extremes and the tile
extremes; its second a sparse table over the tile extremes; its last
runs a thread a scanned slot s, which answers the entry whose range
ends there (grouped: entry ks[s] % n), and reduces [l, s] as

- the suffix at l to its tile's end, the tiles between from the tile
  table and the prefix of s's tile to s, when l lies in an earlier tile;
- the same one level down (sub-block suffix, the tile's sub-block table,
  sub-block prefix), when l lies in an earlier sub-block of s's tile;
- a loop over the values, when l and s share a sub-block.
"""
import numpy as np
import torch

TILE = 1024                     # csrc/win_range.cu WR_TILE
SUB = 32                        # a warp's width
SPECIALS = (-0.0, 0.0, np.inf, -np.inf, np.nan)

# name -> (n, first, kind, span, segments (0: ungrouped))
CASES = {
    # ranges inside one sub-block or one tile; n not a multiple of TILE
    "short": (5 * TILE + 77, 1000, "length", 20, 0),
    # ranges across two tiles
    "two_tiles": (9 * TILE + 3, 2000, "length", 1500, 0),
    # the first output off a tile's start
    "first_mid": (7 * TILE + 500, 1500, "time", 700, 0),
    # ranges across some 270 tiles: the tile table's top levels
    "many_tiles": (300 * TILE + 5, TILE, "length", 280_000, 0),
    # time(0): every left edge past its entry, the range [hi, hi]
    "degenerate": (3 * TILE + 1, 100, "time", 0, 0),
    # segments straddling tiles in the sorted order
    "grouped_straddle": (20 * TILE + 11, 3000, "time", 2000, 3),
    "grouped_short": (6 * TILE + 9, 1000, "length", 40, 5),
    "grouped_many": (300 * TILE + 5, TILE, "time", 400_000, 2),
    # grouped time(0): every left edge past its entry
    "grouped_degenerate": (3 * TILE + 1, 100, "time", 0, 4),
}
# on a card only: past 2^20 entries, more tiles than one block of
# table_kernel holds in shared memory (its levels built from L2)
LARGE = {
    "large": (1100 * TILE + 7, 5000, "length", 900_000, 0),
    "grouped_large": (1100 * TILE + 7, TILE, "time", 2_000_000, 3),
}


def min_op(a, b):
    """MinF of csrc/win_scan.cuh: a NaN from either side, -0 below +0."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float64),
                               np.asarray(b, np.float64))
    pick_a = np.isnan(a) | (a < b) | ((a == b) & np.signbit(a))
    return np.where(pick_a, a, b)


def max_op(a, b):
    """MaxF: a NaN from either side, +0 above -0."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float64),
                               np.asarray(b, np.float64))
    pick_a = np.isnan(a) | (a > b) | ((a == b) & ~np.signbit(a))
    return np.where(pick_a, a, b)


def make_call(name: str, seed: int = 0, device="cpu") -> tuple:
    """(sites, kwargs) of one K7 call for case `name`, on `device`: sum,
    count and avg sites over quarter-grid values (exact f64 prefixes),
    min/max sites in f32 and f64 over values with -0, +0, +-inf and NaN
    among them; about 10% of the entries invalid."""
    from siddhi_tpu_torch.kernels.win_scan import win_scan_plain
    n, first, kind, span, segs = {**CASES, **LARGE}[name]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    valid = rng.random(n) < 0.9
    clean = np.round(rng.uniform(-100, 100, n) * 4) / 4
    raw = clean.copy()
    hit = rng.random(n) < 0.03
    raw[hit] = rng.choice(np.array(SPECIALS), int(hit.sum()))
    clock = np.cumsum(rng.integers(0, 3, n))
    vcnt, clk = win_scan_plain([("sum", None, True),
                                ("max", t(clock), False)], n, t(valid))
    groups = None
    order = np.arange(n)
    if segs:
        seg = np.where(valid, rng.integers(0, segs, n), n)
        ks, order_t = torch.sort(t(seg * n + np.arange(n)))
        order = order_t.cpu().numpy()
        groups = (ks,)
    sv = t(valid[order])
    pfx, ipfx, cnt = win_scan_plain([
        ("sum", t(clean[order]), True),
        ("sum", t(rng.integers(-2 ** 40, 2 ** 40, n)[order]), True),
        ("sum", None, True)], n, sv)
    f64 = t(raw[order])
    f32 = t(raw[order].astype(np.float32))
    sites = [("sum", pfx, None, None, torch.float32),
             ("avg", pfx, cnt, None, torch.float32),
             ("avg", ipfx, cnt, None, torch.float64),
             ("sum", ipfx, None, None, torch.int64),
             ("sum", cnt, None, None, torch.int64),
             ("min", None, None, f32, torch.float32),
             ("max", None, None, f32, torch.float32),
             ("min", None, None, f64, torch.float64),
             ("max", None, None, f64, torch.float64)]
    m = n - first - 7
    kw = dict(n=n, first=first, m=m, kind=kind, span=span,
              last=first + m - 1, vcnt=vcnt,
              clock=clk if kind == "time" else None, groups=groups,
              valid=sv)
    return sites, kw


def ranges(kw: dict) -> tuple:
    """(lo, hi) in the scanned order of outputs 0 .. m-1, as the kernel
    searches them (the plain version's left edges)."""
    n, first, m, span = kw["n"], kw["first"], kw["m"], kw["span"]
    i = first + np.arange(m)
    if kw["kind"] == "length":
        vcnt = kw["vcnt"].cpu().numpy()
        left = np.searchsorted(vcnt[:n], np.maximum(vcnt[i] - span, 0),
                               side="right")
    else:
        clock = kw["clock"].cpu().numpy()
        left = np.searchsorted(clock[:n], clock[i] - span, side="right")
    if kw["groups"] is None:
        return left, i
    seg, rank = seg_rank(kw)
    ks = kw["groups"][0].cpu().numpy()
    return np.searchsorted(ks[:n], seg[i] * n + left), rank[i]


def seg_rank(kw: dict) -> tuple:
    """(each arrival entry's segment, its sorted slot) of a grouped
    call, from its sorted keys: slot s holds entry ks[s] % n of segment
    ks[s] // n."""
    n = kw["n"]
    ks = kw["groups"][0].cpu().numpy()[:n]
    seg, rank = np.empty(n, np.int64), np.empty(n, np.int64)
    seg[ks % n], rank[ks % n] = ks // n, np.arange(n)
    return seg, rank


def _scan(x: np.ndarray, op, reverse: bool = False) -> np.ndarray:
    """Inclusive scan of x under op along its last axis."""
    y = x.copy()
    idx = range(y.shape[-1] - 2, -1, -1) if reverse else range(1, y.shape[-1])
    for k in idx:
        y[..., k] = op(y[..., k], y[..., k + 1]) if reverse else \
            op(y[..., k - 1], y[..., k])
    return y


def _sparse(x: np.ndarray, op, levels: int) -> list:
    """Sparse-table levels along the last axis: level j reduces entries
    k .. k + 2^j - 1, clipped at the end."""
    out = [x]
    for j in range(1, levels):
        h = 1 << (j - 1)
        prev = out[-1]
        nxt = prev.copy()
        nxt[..., :-h] = op(prev[..., :-h], prev[..., h:])
        out.append(nxt)
    return out


def _levels_for(n: int) -> int:
    j, w = 1, 1
    while w < n:
        j, w = j + 1, w * 2
    return j


def model_minmax(vals: np.ndarray, valid: np.ndarray, lo, hi,
                 is_max: bool) -> np.ndarray:
    """The kernel's min/max over [min(lo, hi), hi] (scanned order), from
    the arrays its first launch writes and the reads its second makes
    (csrc/win_range.cu); float64 results."""
    op = max_op if is_max else min_op
    neutral = -np.inf if is_max else np.inf
    n = len(vals)
    ntiles = -(-n // TILE)
    subs = TILE // SUB
    v = np.full(ntiles * TILE, neutral)
    v[:n] = np.where(valid, vals.astype(np.float64), neutral)
    # tiles_kernel: a thread an entry, a warp a sub-block, a block a tile
    vs = v.reshape(ntiles, subs, SUB)
    pre32, suf32 = _scan(vs, op), _scan(vs, op, reverse=True)
    sub_ext = pre32[:, :, -1]
    before = np.full_like(sub_ext, neutral)
    before[:, 1:] = _scan(sub_ext, op)[:, :-1]
    after = np.full_like(sub_ext, neutral)
    after[:, :-1] = _scan(sub_ext, op, reverse=True)[:, 1:]
    pre1k = op(before[:, :, None], pre32).reshape(-1)
    suf1k = op(suf32, after[:, :, None]).reshape(-1)
    pre32, suf32 = pre32.reshape(-1), suf32.reshape(-1)
    sub = _sparse(sub_ext, op, 6)                     # (ntiles, 32) each
    tab = _sparse(_scan(sub_ext, op, reverse=True)[:, 0], op,
                  _levels_for(ntiles))
    # query_kernel: a thread a slot
    lo, hi = np.asarray(lo), np.asarray(hi)
    l = np.minimum(lo, hi)
    tl, t = l // TILE, hi // TILE
    sa, sb = l // SUB, hi // SUB
    out = np.empty(len(hi))
    one = sa == sb                                    # inside a sub-block
    acc = v[l[one]]
    for d in range(1, SUB):
        y = l[one] + d
        acc = np.where(y <= hi[one], op(acc, v[np.minimum(y, len(v) - 1)]),
                       acc)
    out[one] = acc
    inn = (tl == t) & ~one                            # inside a tile
    x = op(suf32[l[inn]], pre32[hi[inn]])
    length = sb[inn] - sa[inn] - 1
    j = np.floor(np.log2(np.maximum(length, 1))).astype(int)
    ti, a, b = t[inn], sa[inn] + 1 - t[inn] * subs, \
        sb[inn] - (1 << j) - t[inn] * subs
    mid = op(_pick(sub, j, ti, a), _pick(sub, j, ti, b))
    out[inn] = np.where(length > 0, op(x, mid), x)
    far = tl < t                                      # across tiles
    x = op(suf1k[l[far]], pre1k[hi[far]])
    length = t[far] - tl[far] - 1
    j = np.floor(np.log2(np.maximum(length, 1))).astype(int)
    mid = op(_pick(tab, j, None, tl[far] + 1),
             _pick(tab, j, None, t[far] - (1 << j)))
    out[far] = np.where(length > 0, op(x, mid), x)
    return out


def _pick(levels: list, j, rows, cols) -> np.ndarray:
    """levels[j][rows, cols] (levels[j][cols] when rows is None), j per
    entry; indices clipped where the caller masks the result."""
    got = np.empty(len(cols))
    for jj in np.unique(j):
        sel = j == jj
        lv = levels[jj]
        c = np.clip(cols[sel], 0, lv.shape[-1] - 1)
        got[sel] = lv[c] if rows is None else lv[rows[sel], c]
    return got


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, NaN at the same entries, every other entry the same
    bits (the sign of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ib = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(na, nb) and torch.equal(a[~na].view(ib),
                                               b[~nb].view(ib))
