"""K6's association, emulated in Python on the CPU (torch only, no JAX, so
the card tests can hold the kernel to it too).

csrc/win_scan.cu scans 1024-entry tiles with 256 threads of 4 entries,
combines the threads with warp and block Hillis-Steele scans
(`block_seg_scan` of csrc/win_scan.cuh), and carries between tiles by a
look-back over tile aggregates whose association depends on the data
alone.  `k6_emulate` runs the same combines in the same order on Python
scalars (IEEE doubles, jnp's min/max), so on any input it gives the
kernel's bits.
"""
import torch

from siddhi_tpu_torch.kernels.agg_merge import _py_max, _py_min
from siddhi_tpu_torch.kernels.win_scan import (MAX_F, MAX_I, MIN_F, SUM_I,
                                               TILE, _identity, column_kind)

THREADS, ITEMS = 256, 4           # csrc/win_scan.cuh WS_THREADS, WS_ITEMS


def _seg(kop, a, b):
    """seg_combine of csrc/win_scan.cuh on (flag, value) pairs of Python
    scalars (floats are IEEE doubles, min/max those of jnp)."""
    (fa, va), (fb, vb) = a, b
    if fb:
        return True, vb
    op = {MIN_F: _py_min, MAX_F: _py_max, MAX_I: max}.get(
        kop, lambda x, y: x + y)
    return fa, op(va, vb)


def _hillis(kop, xs):
    """The inclusive shfl_up scan of block_seg_scan over one warp's (or the
    warp totals') elements: offsets 1, 2, 4, ... as the kernel runs them."""
    xs = list(xs)
    o = 1
    while o < len(xs):
        xs = [xs[i] if i < o else _seg(kop, xs[i - o], xs[i])
              for i in range(len(xs))]
        o *= 2
    return xs


def _block_scan(kop, xs):
    """block_seg_scan over WS_THREADS elements: each thread's exclusive
    prefix and the block's total, in the kernel's association."""
    ident = (False, _identity(kop))
    warps = [_hillis(kop, xs[w * 32:(w + 1) * 32])
             for w in range(len(xs) // 32)]
    wtot = _hillis(kop, [w[-1] for w in warps])
    ex = []
    for w, inc in enumerate(warps):
        for lane in range(32):
            e = inc[lane - 1] if lane else ident
            ex.append(_seg(kop, wtot[w - 1], e) if w else e)
    return ex, wtot[-1]


def k6_emulate(cols, n, valid=None, flags=None, period=0, window=THREADS):
    """K6's association, column by column: tiles of 1024 entries, 256
    threads folding 4 entries each, the block scan; a tile's carry is its
    nearest predecessor's aggregate where that tile holds a segment start,
    else the block scan of the aggregates of the earlier tiles of its
    look-back window (`window` tiles, the kernel's 256; padded with the
    identity to 256 entries), with the previous window's inclusive prefix
    in front where no start was met; a tile whose first entry starts a
    segment takes no carry.  A smaller `window` runs the chain of windows
    on a small input."""
    if period > 0:
        flags = torch.arange(n) % period == 0
    f = flags[:n].tolist() if flags is not None else [False] * n
    outs = []
    for op, values, masked, *own in cols:
        kop, odt = column_kind(op, values, period)
        acc_dt = torch.float64 if kop not in (SUM_I, MAX_I) else torch.int64
        if values is not None:
            x = values[:n].to(acc_dt)
        elif kop == MAX_I:
            x = torch.arange(n) % period
        else:
            x = torch.ones(n, dtype=acc_dt)
        vc = own[0] if own else valid
        if masked and vc is not None:
            x = torch.where(vc[:n], x, torch.full_like(x, _identity(kop)))
        xs = x.tolist()
        ntiles = -(-n // TILE)
        ident = (False, _identity(kop))
        words, incs, out = [], {}, []     # words: (holds a start, aggregate)
        for t in range(ntiles):
            items = [(f[i], xs[i]) if i < n else ident
                     for i in range(t * TILE, (t + 1) * TILE)]
            thread = []
            for j in range(THREADS):
                a = ident
                for k in range(ITEMS):
                    a = _seg(kop, a, items[j * ITEMS + k])
                thread.append(a)
            ex, total = _block_scan(kop, thread)
            known = t == 0 or total[0]
            base = t - t % window
            run = ident
            if t > 0 and not items[0][0]:
                if t > base:
                    run = words[t - 1] if words[t - 1][0] else \
                        _block_scan(kop, [words[b] for b in range(base, t)]
                                    + [ident] * (THREADS - t + base))[1]
                if not run[0] and base > 0:
                    inc = incs[base - 1]
                    run = (True, inc if t == base else
                           _seg(kop, (False, inc), (False, run[1]))[1])
            words.append((known, total[1]))
            if t - base == window - 1:
                incs[t] = total[1] if known else \
                    _seg(kop, (False, run[1]), (False, total[1]))[1]
            for j in range(THREADS):
                a = _seg(kop, (False, run[1]), ex[j])
                for k in range(ITEMS):
                    a = _seg(kop, a, items[j * ITEMS + k])
                    if t * TILE + j * ITEMS + k < n:
                        out.append(a[1])
        outs.append(torch.tensor(out, dtype=acc_dt).to(odt))
    return outs
