"""The port's expression compiler against the JAX package's.

Three versions of one expression get the same seeded numpy columns:
  * siddhi_tpu.core.expr.compile_expression (jnp, eager),
  * the port's torch back end (CompiledExpr.fn),
  * the port's VM program run by the plain interpreter of K1
    (kernels/expr_eval.vm_run_plain) -- what the CUDA kernels execute.
Tolerance: 0 (bit-equal values, equal dtypes), in both compute modes
(DOUBLE as float64, and DOUBLE as float32 as on the device pattern paths).
The VM has no transcendental functions (log/exp/sin/cos/power raise at
plan time), so no ulp allowance is needed."""
import numpy as np
import pytest
import torch

import siddhi_tpu.query as jq
from siddhi_tpu.core import expr as jexpr
from siddhi_tpu.core.schema import StreamSchema as JSchema
from siddhi_tpu.core.schema import StringTable as JStrings

import siddhi_tpu_torch.query as tq
from siddhi_tpu_torch.core import expr as texpr
from siddhi_tpu_torch.core.expr import VT_OF_TORCH
from siddhi_tpu_torch.core.schema import StreamSchema as TSchema
from siddhi_tpu_torch.core.schema import StringTable as TStrings
from siddhi_tpu_torch.kernels.expr_eval import (expr_eval, merge_programs,
                                                pack_mask, unpack_mask,
                                                vm_run_plain)

DEF = ("define stream S (symbol string, price double, volume int, "
       "big long, ratio float, flag bool);")
N = 1000

EXPRS = [
    "price > 100",
    "volume / 7 + volume % 5 * 3",
    "big / volume - big % 3",
    "volume / -1 + big / -1",
    "price * 2.5 - volume / 3.0",
    "ratio * ratio + ratio / 3.0",
    "price % 3.5 + ratio % 0.75",
    "(price > 110 and volume < 500) or not (symbol != 'K7') or flag",
    "ifThenElse(flag, big, volume)",
    "ifThenElse(volume > 0, 'K1', symbol) == symbol",
    "maximum(ratio, price, volume)",
    "minimum(volume, 3) + minimum(big, volume)",
    "convert(price * 1e9, 'int') + convert(ratio, 'long')",
    "cast(volume, 'double') / 7 + convert(big, 'float')",
    "math:abs(volume) + math:abs(ratio) + math:abs(big)",
    "math:sqrt(price) + math:floor(ratio) - math:ceil(price / 3)",
    "symbol is null or price is null",
    "coalesce(symbol, 'K1') == 'K1'",
    "eventTimestamp() > 1700000000500L",
    "volume == 3 or big >= 10L or flag == false",
    "instanceOfInteger(volume) and not instanceOfString(price)",
    "-volume * 2 + 7",
]


def _columns(f32: bool) -> dict:
    rng = np.random.default_rng(7)
    cols = {"symbol": rng.integers(0, 17, N).astype(np.int32),
            "price": np.round(rng.uniform(90, 130, N) * 4) / 4,
            "volume": rng.integers(-1000, 1000, N).astype(np.int32),
            "big": rng.integers(-2**40, 2**40, N).astype(np.int64),
            "ratio": rng.uniform(-3, 3, N).astype(np.float32),
            "flag": rng.integers(0, 2, N).astype(bool),
            "__timestamp__": 1_700_000_000_000 + np.arange(N, dtype=np.int64)}
    cols["volume"][::37] = 0
    cols["volume"][5::41] = -1
    cols["big"][::29] = -2**63
    cols["volume"][3] = -2**31
    if f32:
        cols["price"] = cols["price"].astype(np.float32)
    return cols


def _jax(text: str, cols: dict, f32: bool) -> np.ndarray:
    import jax.numpy as jnp
    strings = JStrings()
    for i in range(17):
        strings.encode(f"K{i}")
    schema = JSchema.of(jq.parse(DEF).stream_definitions["S"])
    ce = jexpr.compile_expression(jq.parse_expression(text),
                                  jexpr.SingleStreamContext(schema, strings))
    env = {k: jnp.asarray(v) for k, v in cols.items()}
    with jexpr.compute_dtypes(jexpr.F32_MODE if f32 else None):
        out = np.asarray(ce.fn(env))
    return np.broadcast_to(out, (N,))


def _port(text: str):
    strings = TStrings()
    for i in range(17):
        strings.encode(f"K{i}")
    schema = TSchema.of(tq.parse(DEF).stream_definitions["S"])
    return texpr.compile_expression(tq.parse_expression(text),
                                    texpr.SingleStreamContext(schema, strings))


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32mode"])
@pytest.mark.parametrize("text", EXPRS)
def test_torch_back_end_matches_jax(text, f32):
    cols = _columns(f32)
    want = _jax(text, cols, f32)
    ce = _port(text)
    env = {k: torch.from_numpy(v) for k, v in cols.items()}
    with texpr.compute_dtypes(texpr.F32_MODE if f32 else None):
        got = ce.fn(env).expand(N).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32mode"])
@pytest.mark.parametrize("text", EXPRS)
def test_vm_program_matches_torch_back_end(text, f32):
    cols = _columns(f32)
    keys = sorted(cols)
    tcols = [torch.from_numpy(cols[k]) for k in keys]
    slots = {k: (i, VT_OF_TORCH[t.dtype]) for i, (k, t) in
             enumerate(zip(keys, tcols))}
    ce = _port(text)
    mode = texpr.F32_MODE if f32 else None
    with texpr.compute_dtypes(mode):
        want = ce.fn(dict(zip(keys, tcols))).expand(N)
        prog = texpr.emit_program(ce.node, slots)
    words, consts, _o, _l = merge_programs([prog])
    got = vm_run_plain(words, consts, tcols, N)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the K1 wrapper on CPU tensors: same values, mask bit-packed
    if want.dtype == torch.bool:
        w, _ = expr_eval(tcols, prog, [], N, use="filter")
        assert torch.equal(unpack_mask(w, N), want)
    else:
        _w, (o,) = expr_eval(tcols, None, [prog], N, use="filter")
        np.testing.assert_array_equal(o.numpy(), want.numpy())


def test_mask_bit_order_matches_planner():
    """bit j of word w = row 32w+j, as siddhi_tpu/core/planner.py packs."""
    rng = np.random.default_rng(3)
    m = rng.integers(0, 2, 77).astype(bool)
    words = pack_mask(torch.from_numpy(m)).numpy()
    pad = np.zeros(96, bool)
    pad[:77] = m
    want = (pad.reshape(-1, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    np.testing.assert_array_equal(words.view(np.uint32), want)
    assert torch.equal(unpack_mask(torch.from_numpy(words), 77),
                       torch.from_numpy(m))


@pytest.mark.parametrize("text", ["math:log(price) > 1", "math:sin(ratio)",
                                  "math:sqrt(volume) > 2",
                                  "convert(price, 'string')"])
def test_outside_the_vm_raises_at_plan_time(text):
    with pytest.raises(texpr.ExprError):
        _port(text)


def test_timestamp_parameter_resolves_at_launch():
    node = texpr.timestamp_node("off")
    prog = texpr.emit_program(node, {"off": (0, texpr.VT_I32)})
    words, consts, _o, _l = merge_programs([prog], {"__base_ts__": 10 ** 12})
    got = vm_run_plain(words, consts, [torch.tensor([1, 2], dtype=torch.int32)],
                       2)
    assert got.tolist() == [10 ** 12 + 1, 10 ** 12 + 2]
