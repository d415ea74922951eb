"""One NFA block, JAX program vs the port's plain block (K2's plain
version) on the same inputs: __graft_entry__._example_block-style (T, P)
grids of random prices for the flagship chain, run from an empty state
and again from the state the first block left.  The new slot state must
be equal leaf for leaf and the match tables equal after sorting by
(completion seq, head seq).  Tolerance 0 (prices are float32 on both)."""
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.weights import nfa_state_from_jax, nfa_state_to_numpy

FLAGSHIP = """
define stream S (sym string, p double);
partition with (sym of S)
begin
  @info(name='q')
  from every e1=S[p > 100.0] -> e2=S[p > e1.p] -> e3=S[p > e2.p]
  select e1.p as p1, e2.p as p2, e3.p as p3 insert into M;
end;
"""
SEQUENCE = """
define stream S (sym string, p double);
partition with (sym of S)
begin
  @info(name='q')
  from every e1=S[p > 110.0], e2=S[p < e1.p] within 20 ms
  select e1.p as p1, e2.p as p2 having p1 - p2 > 2.0 insert into M;
end;
"""
P, T = 16, 32


def _example_block(seed: int, t0: int) -> dict:
    rng = np.random.default_rng(seed)
    valid = np.ones((T, P), bool)
    valid[T - 5:, ::3] = False             # ragged lane tails
    return {"__ts__": (t0 + np.cumsum(np.ones((T, P), np.int32), axis=0)
                       ).astype(np.int32),
            "__seq__": (t0 * P + np.arange(T * P, dtype=np.int32)
                        ).reshape(T, P),
            "__valid__": valid,
            "0.p": (np.round(rng.uniform(90.0, 130.0, size=(T, P)) * 4) / 4
                    ).astype(np.float32),
            "__base_ts__": np.int64(1_700_000_000_000),
            "__base_seq__": np.int64(0)}


def _plans(app: str, slots: int):
    head = f"@app:partitionCapacity({P})\n@app:deviceSlots({slots})\n"
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(
        head + "@app:patternFamily('seq')\n" + app)
    jplan = next(p for p in jrt._plans if isinstance(p, JPlan))
    trt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        head + app)
    tplan = trt.plans()[0]
    for plan in (jplan, tplan):
        plan._ts_base, plan._seq_base = 1_700_000_000_000, 0
    return jplan, tplan


def _table(chunk):
    tss, seqs, hseqs, data = chunk[:4]
    o = np.lexsort((hseqs, seqs))
    return [tss[o], seqs[o], hseqs[o]] + [data[k][o] for k in sorted(data)]


@pytest.mark.parametrize("app,slots", [(FLAGSHIP, 8), (SEQUENCE, 4)],
                         ids=["flagship", "sequence"])
def test_block_matches_jax(app, slots):
    jplan, tplan = _plans(app, slots)
    assert jplan.kernel.rows_f == tplan.kernel.rows_f
    assert jplan.kernel.rows_i == tplan.kernel.rows_i
    jstate = jplan.state
    tstate = tplan.state
    M = 4096
    for b in range(2):
        ev = _example_block(seed=b, t0=b * T)
        jst, out = jplan.kernel.block_fn(T, M)(jstate, ev)
        ipack = np.asarray(out["i"])
        n = int(ipack[0, 0])
        assert 0 < n <= M
        jtab = _table(jplan._unpack_block(ipack, None, n))

        tev = {k: torch.from_numpy(np.asarray(v)) for k, v in ev.items()
               if np.ndim(v)}
        tev["__base_ts__"] = int(ev["__base_ts__"])
        tst, tout = tplan.kernel.run_block(tstate, tev, M)
        assert int(tout["meta"][0]) == n
        assert int(tout["meta"][1]) == int(np.asarray(jst["of_slots"]).sum())
        ttab = _table(tplan._unpack(tout, n))
        assert len(jtab) == len(ttab)
        for a, b_ in zip(jtab, ttab):
            np.testing.assert_array_equal(a, b_)

        jnp_state = {k: np.asarray(v) for k, v in jst.items()}
        tnp = nfa_state_to_numpy(tst)
        for k, v in tnp.items():
            np.testing.assert_array_equal(v, jnp_state[k], err_msg=k)
        # the carried-over JAX state converts to the port's, leaf for leaf
        conv = nfa_state_to_numpy(nfa_state_from_jax(jnp_state, "cpu"))
        for k, v in conv.items():
            np.testing.assert_array_equal(v, tnp[k], err_msg=k)
        jstate, tstate = jst, tst


def test_m_overflow_count_and_retry_are_exact():
    """A too-small match buffer still counts every match (meta[0] > M);
    re-running from the same input state with a bigger M gives the full
    table and an identical new state."""
    _jplan, tplan = _plans(FLAGSHIP, 8)
    ev = {k: torch.from_numpy(np.asarray(v)) for k, v in
          _example_block(seed=0, t0=0).items() if np.ndim(v)}
    ev["__base_ts__"] = 1_700_000_000_000
    st0 = tplan.state
    st_small, out_small = tplan.kernel.run_block(st0, ev, 16)
    n = int(out_small["meta"][0])
    assert n > 16
    st_big, out_big = tplan.kernel.run_block(st0, ev, 4096)
    assert int(out_big["meta"][0]) == n
    for k in st_small:
        assert torch.equal(st_small[k], st_big[k]), k
    big_rows = {tuple(r) for r in torch.cat(
        [out_big["out_i"][:, :n].double(),
         out_big["out_f"][:, :n].double()]).T.tolist()}
    small_rows = torch.cat([out_small["out_i"][:, :16].double(),
                            out_small["out_f"][:, :16].double()]).T.tolist()
    assert all(tuple(r) in big_rows for r in small_rows)
