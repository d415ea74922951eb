"""The `dfa` plan family of the port against siddhi_tpu on the CPU.

`dfa` is the `scan` block with its chase nodes (the static hops below
the head and both sides of a logical position, at most 8) answered from
bit-packed tables: one symbol bit per chase node an event, stride-4
block tables (K11 `dfa_tables`), and K4's lookup mode (`_dfa_tables`,
`_dfa_next` of siddhi_tpu.core.nfa_parallel).  Automatic selection never
picks it (`scan` comes first); `@app:patternFamily('dfa')` does, where
the chain is eligible.  Covered, against the JAX package with tolerance
0: the family verdicts and reasons of every shape of
tests/test_plan_families.py; forced `dfa` on each shape the JAX package
engages it for, rows equal to its forced `dfa` and to the port's own
`scan`; `dfa_tables_plain` against `_dfa_tables` on seeded masks (1-8
chase lanes, F not a multiple of 4, empty and full masks) and the
lookup against a brute-force first hit at every s; partitioned lanes, a
fused group, and the replay tail over many small flushes."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core import nfa_parallel as jpar
from siddhi_tpu.core.multi_query import \
    MultiQueryDevicePatternPlan as JMulti
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.kernels.dfa_tables import (STRIDE, dfa_next_plain,
                                                 dfa_tables_plain)

from test_plan_families import ELIGIBLE, HEAD, INELIGIBLE

JDEV = "@app:devicePatterns('always')\n"
DFA = "@app:patternFamily('dfa')\n"
SCAN = "@app:patternFamily('scan')\n"
TS0 = 1_700_000_000_000
# the shapes the JAX package engages `dfa` for
DFA_SHAPES = sorted(n for n, (_q, fams) in ELIGIBLE.items() if "dfa" in fams)


def sends_of(n=900, batches=3, seed=11, dt=7, keys=4):
    """The tapes of tests/test_plan_families.py `_run`, one send_batch a
    flush."""
    rng = np.random.default_rng(seed)
    out = []
    m = n // batches
    for b in range(batches):
        out.append(({"sym": np.array([f"K{k}" for k in
                                      rng.integers(0, keys, m)]),
                     "price": np.round(rng.uniform(90, 130, m) * 4) / 4,
                     "volume": rng.integers(1, 1000, m).astype(np.int32)},
                    TS0 + (b * m + np.arange(m)) * dt))
    return out


def run(pkg, app: str, sends, outs=("Out",), **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    rows = []
    for o in outs:
        rt.add_callback(o, lambda evs, o=o: rows.extend(
            (o, e.timestamp, e.data) for e in evs))
    rt.start()
    for cols, ts in sends:
        rt.input_handler("S").send_batch(cols, ts)
        rt.flush()
    return rows, rt


def jplan(rt):
    p = next(p for p in rt._plans if isinstance(p, (JPlan, JMulti)))
    return getattr(p, "inner", p)


def tplan(rt):
    p = rt.plans()[0]
    return getattr(p, "inner", p)


@pytest.mark.parametrize("name", sorted(ELIGIBLE) + sorted(INELIGIBLE))
def test_family_verdicts_equal_jax(name):
    """`scan`, `dfa` and `chunk` verdicts (True or the reason, word for
    word) and the family picked at default settings equal the JAX
    package's for every shape of tests/test_plan_families.py."""
    q = (ELIGIBLE.get(name) or INELIGIBLE[name])[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jp = jplan(siddhi_tpu.SiddhiManager().create_app_runtime(
            JDEV + HEAD + q))
        tp = tplan(siddhi_tpu_torch.SiddhiManager(
            device="cpu").create_app_runtime(HEAD + q))
    for fam in ("chunk", "scan", "dfa"):
        assert tp.families[fam] == jp.families[fam], fam
    assert tp.family == jp.family


@pytest.mark.parametrize("name", DFA_SHAPES)
def test_forced_dfa_equal_jax_and_scan(name):
    """Forced `dfa` engages in both packages; its rows equal the JAX
    package's forced `dfa` rows and the port's own `scan` rows."""
    q = ELIGIBLE[name][0]
    sends = sends_of()
    want, jrt = run(siddhi_tpu, DFA + JDEV + HEAD + q, sends)
    got, trt = run(siddhi_tpu_torch, DFA + HEAD + q, sends, device="cpu")
    scan, srt = run(siddhi_tpu_torch, SCAN + HEAD + q, sends, device="cpu")
    assert jplan(jrt).family == tplan(trt).family == "dfa"
    assert tplan(srt).family == "scan"
    assert tplan(trt)._par_kern.dfa_nodes
    assert got == want == scan and got


def _jax_tables(masks: list, F: int):
    L = max(2, 1 << (F - 1).bit_length())
    return jpar.ParallelChainKernel._dfa_tables(
        None, [jnp.asarray(m) for m in masks], F, L), L


@pytest.mark.parametrize("nk,F,fill", [
    (1, 1, 0.5), (1, 37, 0.2), (2, 64, 0.05), (3, 101, 0.5), (5, 257, 0.3),
    (8, 1023, 0.1), (4, 30, 0.0), (6, 45, 1.0)])
def test_dfa_tables_plain_matches_jax(nk, F, fill):
    """The suffix offsets, packed block words and next-block pointers of
    `dfa_tables_plain` equal `_dfa_tables`' on seeded masks; the lookup
    equals `_dfa_next` and a brute-force first hit at every s."""
    rng = np.random.default_rng(nk * 1000 + F)
    masks = [rng.random(F) < fill for _ in range(nk)]
    (jsuf, jpacked, jnblk, NB), L = _jax_tables(masks, F)
    suffix, packed, nblk = dfa_tables_plain(
        [torch.from_numpy(m)[None] for m in masks])
    assert NB == -(-F // STRIDE) and packed.shape == (1, NB)
    np.testing.assert_array_equal(packed[0].numpy(),
                                  np.asarray(jpacked).astype(np.int64))
    s = np.arange(NB * STRIDE + 3)
    for k in range(nk):
        np.testing.assert_array_equal(
            ((suffix[0].to(torch.int64) >> (3 * k)) & 7).numpy(),
            np.asarray(jsuf[k]))
        np.testing.assert_array_equal(nblk[k, 0].numpy(),
                                      np.asarray(jnblk[k]))
        got = dfa_next_plain((suffix, packed, nblk), k,
                             torch.from_numpy(s)[None], L)[0].numpy()
        hits = np.flatnonzero(masks[k])
        brute = np.array([hits[hits >= x][0] if (hits >= x).any() else L
                          for x in s])
        np.testing.assert_array_equal(got, brute)
        jn = np.asarray(jpar.ParallelChainKernel._dfa_next(
            None, k, jnp.asarray(s, jnp.int32), jsuf, jpacked, jnblk, NB, L))
        np.testing.assert_array_equal(got, jn)


PART = ("define stream S (sym string, price double, volume int);\n"
        "@app:partitionCapacity(32)\npartition with (sym of S)\nbegin\n"
        "  @info(name='q')\n  from every e1=S[price > 100] -> "
        "e2=S[price < 96] -> e3=S[price > 124] within 10 sec\n"
        "  select e1.price as p1, e2.price as p2, e3.price as p3 "
        "insert into Out;\nend;\n")
FUSED = "define stream S (sym string, price double, volume int);\n" + \
    "\n".join(f"@info(name='q{i}') from every e1=S[price > {110 + i % 5}] "
              f"-> e2=S[price < {96 - i % 3}] within 1 sec select e1.price "
              f"as p1, e2.price as p2 insert into Out{i % 3};"
              for i in range(10))


@pytest.mark.parametrize("case", ["partitioned", "fused", "tail"])
def test_dfa_lanes_equal_jax(case):
    """Forced `dfa` on partitioned lanes (an (L, F) grid of keys,
    tests/test_plan_families.py:541-580), on a fused group (the lanes
    share one row of events), and over many small flushes (the replay
    tail, `hybrid`): rows equal to the JAX package's, in order."""
    outs = ("Out",)
    if case == "partitioned":
        app, sends = PART, sends_of(n=900, batches=3, keys=16, seed=3)
    elif case == "fused":
        app, sends = FUSED, sends_of(n=600, batches=3, seed=5)
        outs = ("Out0", "Out1", "Out2")
    else:
        app = HEAD + ELIGIBLE["hybrid"][0]
        sends = sends_of(n=900, batches=15, dt=9)
    want, jrt = run(siddhi_tpu, DFA + JDEV + app, sends, outs)
    got, trt = run(siddhi_tpu_torch, DFA + app, sends, outs, device="cpu")
    assert jplan(jrt).family == tplan(trt).family == "dfa"
    if case == "fused":
        assert tplan(trt).broadcast_events
        assert tplan(trt).families["chunk"] == "fused multi-query lane kernel"
    assert got == want and got
