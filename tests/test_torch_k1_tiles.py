"""K1 `expr_eval` as the H100 kernel runs it, on the CPU.

The kernel evaluates every pre-mask program of a block in one launch
(`expr_masks`, `pre_mask_words`), from instruction records the host
decodes once a program (`decoded`: each instruction's stack slot from
`Program.stack_slots`, its constant's bits) and fills in a launch
(`decode_programs`: columns, launch-time constants, lane-parameter
rows), with the stack `depth_class` picks, over rows it steps from one
to the next with the divisors of `int_divider`.
These tests hold the block's pre-mask words to the JAX package's
`_pre_masks` (`seq`) and `_node_mask` (`scan`) on the blocks C4A, C4O
and a small config 5's groups run -- lane grids whose F is not a
multiple of 32 and below 32, float32 and float64 lane parameters --
and the host's planning to the plain VM: the records interpreted slot by
slot equal `vm_run_plain`, the row stepping equals the row map, at every
depth class and one deeper.  The card holds the kernel to its plain
version (tests/test_torch_gpu.py, `tiles` and `straddles`)."""
import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core import expr as jexpr
from siddhi_tpu.core.multi_query import \
    MultiQueryDevicePatternPlan as JMulti
from siddhi_tpu.core.pattern_plan import DevicePatternPlan as JPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.expr import (OPNAMES, TORCH_OF_VT, VT_BOOL,
                                        VT_F32, VT_F64, VT_I32, VT_I64,
                                        VT_OF_TORCH, LaneParams,
                                        SingleStreamContext, apply_op,
                                        cast_to, compile_expression,
                                        const_tensor, emit_program)
from siddhi_tpu_torch.core.nfa_device import NFAKernel, pre_mask_words
from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
from siddhi_tpu_torch.core.schema import StreamSchema, StringTable
from siddhi_tpu_torch.kernels.expr_eval import (INS_DTYPE, REG_STACK,
                                                ROWS, RowMap,
                                                decode_programs, decoded,
                                                depth_class, expr_masks,
                                                expr_masks_plain,
                                                fused_compare,
                                                int_divider, merge_programs,
                                                pack_mask, row_fields,
                                                rows_a_thread, unpack_mask,
                                                vm_run_plain)
from siddhi_tpu_torch.kernels.seg_tree import node_masks
from siddhi_tpu_torch.query import parse, parse_expression
from siddhi_tpu_torch.replay import C4A_BODY, C4O_BODY, F64, c5_app

PREFER = "@app:devicePatterns('prefer')\n"
SEQ = "@app:patternFamily('seq')\n"
PART = "@app:partitionCapacity(64)\n@app:deviceSlots(32)\n"
STOCK = ("define stream StockStream (symbol string, price double, "
         "volume int);\n")


def _part(body: str) -> str:
    return (STOCK + "partition with (symbol of StockStream) begin "
            + body + " end;")


# name -> (app, keys, events a flush, flushes, the torch family)
APPS = {"c4a": (PART + _part(C4A_BODY), 40, 3000, 2, "scan"),
        "c4o": (SEQ + PART + _part(C4O_BODY), 40, 3000, 2, "seq"),
        "c5": (c5_app(32), 8, 1000, 2, None),
        "c5_f64": (F64 + c5_app(32, frac=1e-6), 8, 1000, 2, None),
        "c5_short": (c5_app(32), 8, 20, 3, None)}


def _tape(n, flushes, keys, seed):
    rng = np.random.default_rng(seed)
    out = []
    for f in range(flushes):
        out.append(({"symbol": np.array([f"K{k}" for k in
                                         rng.integers(0, keys, n)]),
                     "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
                     "volume": rng.integers(1, 1000, n).astype(np.int32)},
                    1_700_000_000_000 + (f * n + np.arange(n)) * 3))
    return out


def _torch_blocks(app, tape, monkeypatch):
    """Every block the port's plans ran on the CPU: (family, kernel, ev)."""
    blocks = []
    o_scan, o_seq = ParallelChainKernel.run_block, NFAKernel.run_block

    def scan(k, ev, M):
        blocks.append(("scan", k, ev))
        return o_scan(k, ev, M)

    def seq(k, st, ev, M):
        blocks.append(("seq", k, ev))
        return o_seq(k, st, ev, M)
    monkeypatch.setattr(ParallelChainKernel, "run_block", scan)
    monkeypatch.setattr(NFAKernel, "run_block", seq)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    h = rt.input_handler("StockStream")
    for cols, ts in tape:
        h.send_batch(cols, ts)
        rt.flush()
    return blocks, rt


def _jax_plans(app):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rt = siddhi_tpu.SiddhiManager().create_app_runtime(PREFER + app)
    return [getattr(p, "inner", p) for p in rt._plans
            if isinstance(p, (JPlan, JMulti))]


def _jax_seq_masks(jk, kern, ev) -> dict:
    """The JAX `_pre_masks` of the port's (T, P) block, keyed by node."""
    jk = copy.copy(jk)
    jk.P = kern.P
    jev = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
           for k, v in ev.items()}
    with jexpr.compute_dtypes(jk._mode):
        out = jk._pre_masks(jev)
    return {gi: np.asarray(out[f"__pre{gi}__"])
            for gi, n in enumerate(jk.spec.all_nodes) if n.pre_conjs}


def _jax_lane_masks(jk, kern, ev) -> list:
    """The JAX `_node_mask` of every chain node over the port's (L, F)
    block, lane by lane (the lane's own row of events or the shared one,
    its lane parameters)."""
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    nodes = [n for pos in jk.prog.positions for n in pos.nodes]
    params = kern.nfak.params
    out = np.zeros((len(nodes), L, F), bool)
    with jexpr.compute_dtypes(jk._mode):
        for lane in range(L):
            e = {k: jnp.asarray(v[lane if v.shape[0] == L else 0].numpy())
                 for k, v in ev.items()
                 if torch.is_tensor(v) and k.startswith("__flat.")}
            if params is not None:
                e.update({f"__param.__qparam{i}": jnp.asarray(
                    v[lane].numpy()) for i, v in enumerate(params.values)})
            valid = jnp.arange(F) < int(ev["__nev__"][lane])
            for gi, n in enumerate(nodes):
                out[gi, lane] = np.asarray(jk._node_mask(
                    e, n, e["__flat.__ts__"], valid, ev["__base_ts__"]))
    return out


@pytest.mark.parametrize("name", sorted(APPS))
def test_block_pre_masks_equal_jax(name, monkeypatch):
    """Each block's pre-mask words (every program of the block in one
    `expr_masks` call, None where a node has none) equal the JAX
    package's masks of the same events."""
    app, keys, n, flushes, family = APPS[name]
    blocks, rt = _torch_blocks(app, _tape(n, flushes, keys, len(name)),
                               monkeypatch)
    jplans = _jax_plans(app)
    tplans = [getattr(p, "inner", p) for p in rt.plans()]
    assert [p.family for p in jplans] == [p.family for p in tplans]
    if family is not None:
        assert {b[0] for b in blocks} == {family}
    multi = 0
    for fam, kern, ev in blocks:
        nfak = kern.nfak if fam == "scan" else kern
        i = next(i for i, p in enumerate(tplans)
                 if p.kernel.spec is nfak.spec)
        pre = kern.pre_masks(ev)
        assert [w is None for w in pre] == [p is None for p in
                                            nfak.pre_progs]
        multi += sum(w is not None for w in pre) > 1
        if fam == "seq":
            T, P = ev["__ts__"].shape[0], kern.P
            want = _jax_seq_masks(jplans[i].kernel, kern, ev)
            assert sorted(want) == [g for g, w in enumerate(pre)
                                    if w is not None]
            for gi, m in want.items():
                np.testing.assert_array_equal(
                    unpack_mask(pre[gi], T * P).view(T, P).numpy(), m)
        else:
            want = _jax_lane_masks(jplans[i]._parallel_kernel(), kern, ev)
            got = node_masks(kern, ev, pre)
            for gi, m in enumerate(got):
                np.testing.assert_array_equal(m.numpy(), want[gi])
    if name in ("c4a", "c4o"):
        assert multi == len(blocks)      # three programs, one call


def test_pre_mask_words_keep_the_node_order():
    """`pre_mask_words` returns one word array per node in order, None
    where a node has no program, and calls K1 once for all programs."""
    keys, cols, progs = _programs(["price > 100", "volume < 500"])
    calls = []

    def spy(*a, **kw):
        calls.append(len(a[1]))
        return expr_masks(*a, **kw)
    import siddhi_tpu_torch.kernels.expr_eval as k1
    orig = k1.expr_masks
    k1.expr_masks = spy
    try:
        got = pre_mask_words([None, progs[0], None, progs[1]], cols, 100, 0)
        assert pre_mask_words([None, None], cols, 100, 0) == [None, None]
    finally:
        k1.expr_masks = orig
    assert calls == [2]
    assert got[0] is None and got[2] is None
    want = expr_masks_plain(cols, progs, 100, {"__base_ts__": 0})
    assert torch.equal(got[1], want[0]) and torch.equal(got[3], want[1])


TEXTS = ["price > 100",                                            # 2
         "volume < 500 and flag or symbol == 'K3'",                # 3
         "ifThenElse(flag, big, volume) > big % 3",                # 3
         "(price + 1) * (volume + 2) > (big - 3) * (ratio + 4)",   # 4
         "((price + 1) * (volume + 2) > (big - 3) * (ratio + 4)) and "
         "((price - volume) < (big + ratio * 2))",                 # 5
         "volume / 7 + volume % 5 * 3", "big / volume - big % 3",
         "convert(price, 'int')", "maximum(ratio, price)",
         "ratio * ratio + ratio", "not flag"]


def _programs(texts, n=1000, seed=0):
    schema = StreamSchema.of(parse(
        "define stream S (symbol string, price double, volume int, big "
        "long, ratio float, flag bool);").stream_definitions["S"])
    strings = StringTable()
    for i in range(8):
        strings.encode(f"K{i}")
    rng = np.random.default_rng(seed)
    host = {"big": rng.integers(-2**40, 2**40, n),
            "flag": rng.integers(0, 2, n).astype(bool),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "ratio": rng.uniform(-3, 3, n).astype(np.float32),
            "symbol": rng.integers(1, 9, n).astype(np.int32),
            "volume": rng.integers(-9, 1000, n).astype(np.int32)}
    host["volume"][::97] = 0
    host["big"][::89] = -1
    keys = sorted(host)
    cols = [torch.from_numpy(host[k]) for k in keys]
    ctx = SingleStreamContext(schema, strings)
    progs = [emit_program(compile_expression(parse_expression(t), ctx).node,
                          {k: (i, VT_OF_TORCH[c.dtype])
                           for i, (k, c) in enumerate(zip(keys, cols))})
             for t in texts]
    return keys, cols, progs


def _stack_depths(prog) -> list:
    """The stack depth after each instruction (a plain postfix walk)."""
    sp, out = 0, []
    arity = {"select": 3, "cast": 1, "not": 1, "abs": 1, "sqrt": 1,
             "floor": 1, "ceil": 1}
    for i in range(0, len(prog.words), 2):
        op = OPNAMES[prog.words[i] & 0xFF]
        sp += 1 if op in ("load", "const", "qparam") else \
            1 - arity.get(op, 2)
        out.append(sp)
    return out


def test_slots_and_depth_classes():
    """Each instruction writes the slot below the stack depth it leaves
    (`Program.stack_slots`, one a instruction); the deepest slot is the
    program's `depth`; a launch of fused compares alone takes no stack
    (-1), any other the register stack (2) where all its programs fit
    in it, and the local-memory stack (0) past 2."""
    _k, _c, progs = _programs(TEXTS)
    depths = [p.depth for p in progs]
    assert {2, 3, 4, 5} <= set(depths)
    for p in progs:
        slots = p.stack_slots
        assert len(slots) == len(p.words) // 2
        assert [s + 1 for s in slots] == _stack_depths(p)
        assert max(slots) + 1 == p.depth
        assert depth_class([p]) == (-1 if fused_compare(p) else
                                    2 if p.depth <= 2 else 0)
    assert REG_STACK == 2
    assert depth_class(progs[:1]) == -1          # `price > 100` alone
    assert depth_class(progs[10:]) == 2          # `not flag`
    assert depth_class(progs[:2]) == 0 and depth_class(progs) == 0


def test_programs_are_decoded_once():
    """A program's records are decoded on its first launch and kept on it;
    each launch fills its own columns, launch-time constants and lane
    parameters into a copy, so the kept records stay as decoded."""
    n = 100
    keys, cols, progs = _programs(TEXTS[:3] + [
        "price > 100 and volume < 500"], n)
    ts = {k: (i, VT_OF_TORCH[c.dtype]) for i, (k, c) in enumerate(zip(
        keys, cols))}
    schema = StreamSchema.of(parse(
        "define stream S (symbol string, price double, volume int, big "
        "long, ratio float, flag bool);").stream_definitions["S"])
    from siddhi_tpu_torch.query.ast import AttrType
    ctx = SingleStreamContext(schema, StringTable(), extra={
        "__qparam0": ("__qparam0", AttrType.DOUBLE)})
    qp = emit_program(compile_expression(parse_expression(
        "price > __qparam0 and big > 5"), ctx).node, ts)
    # a launch-time constant: the block's base timestamp
    from siddhi_tpu_torch.core.expr import Node
    pb = emit_program(Node("gt", AttrType.BOOL, (
        Node("var", AttrType.LONG, key="big"),
        Node("param", AttrType.LONG, key="__base_ts__"))), ts)
    progs = progs + [qp, pb]
    assert all(p.decoded is None for p in progs)
    forms = [decoded(p) for p in progs]
    assert all(decoded(p) is f for p, f in zip(progs, forms))
    params = LaneParams({"__qparam0": np.arange(5, dtype=np.float64)},
                        "cpu")
    ptrs = [c.data_ptr() for c in cols]
    vts = [VT_OF_TORCH[c.dtype] for c in cols]
    for base, shift in ((7, 0), (-3, 64)):
        recs, spans = decode_programs(progs, {"__base_ts__": base},
                                      [p + shift for p in ptrs], vts,
                                      params)
        assert recs.dtype == INS_DTYPE
        for f, (first, length) in zip(forms, spans):
            r = recs[first:first + length]
            kept = np.frombuffer(f.recs, dtype=INS_DTYPE)
            assert length == len(kept)
            for name in ("op", "vt", "slot"):
                np.testing.assert_array_equal(r[name], kept[name])
            for k, col in f.loads:
                assert r["arg"][k] == ptrs[col] + shift
                assert r["vt2"][k] == vts[col] and kept["arg"][k] == 0
            for k, row in f.qparams:
                assert r["arg"][k] == params.bits.data_ptr() + 8 * row * 5
                assert kept["arg"][k] == 0
        (k, _i, _vt), = forms[-1].named
        first = spans[-1][0]
        assert recs["arg"][first + k] == base
    assert [len(f.loads) for f in forms[-2:]] == [2, 1]
    assert len(forms[-2].qparams) == 1 and not forms[0].qparams


def _const_value(bits: int, vt: int):
    if vt == VT_F64:
        return float(np.int64(bits).view(np.float64))
    if vt == VT_I64:
        return int(bits)
    low = np.uint32(bits & 0xFFFFFFFF)
    if vt == VT_F32:
        return float(low.view(np.float32))
    v = int(low.view(np.int32))
    return bool(v) if vt == VT_BOOL else v


def _interpret(recs, spans, cols, n, params=None, lanes=None,
               elems=None) -> list:
    """The decoded records run slot by slot over whole columns, as the
    kernel runs them (each load's column found by its pointer, each
    constant from its bits, each lane parameter from its row)."""
    by_ptr = {c.data_ptr(): c for c in cols}
    outs = []
    for first, length in spans:
        st: dict = {}
        for r in recs[first:first + length]:
            op, vt, vt2, s = (OPNAMES[int(r["op"])], int(r["vt"]),
                              int(r["vt2"]), int(r["slot"]))
            arg = int(r["arg"])
            if op == "load":
                c = by_ptr[arg]
                c = c[:n] if elems is None else c[elems]
                assert VT_OF_TORCH[c.dtype] == vt2
                st[s] = c.to(torch.bool) if vt == VT_BOOL else c
            elif op == "const":
                st[s] = const_tensor(_const_value(arg, vt), TORCH_OF_VT[vt])
            elif op == "qparam":
                row = (arg - params.bits.data_ptr()) // 8
                i, off = divmod(row, params.P)
                assert off == 0
                st[s] = params.values[i][lanes]
            elif op == "cast":
                st[s] = cast_to(st[s], TORCH_OF_VT[vt])
            else:
                k = 3 if op == "select" else 1 if op in (
                    "not", "abs", "sqrt", "floor", "ceil") else 2
                st[s] = apply_op(op, [st[s + j] for j in range(k)])
        out = st[0]
        outs.append(out.expand(n) if out.dim() == 0 else out)
    return outs


def _same(a, b):
    assert a.dtype == b.dtype
    if a.is_floating_point():
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    else:
        assert torch.equal(a, b)


def test_decoded_records_equal_the_plain_vm():
    """Every program of TEXTS (each depth class and deeper, integer / and
    %, casts, select, min/max, float32 mode) decoded once: run slot by
    slot, the records give the plain VM's values."""
    n = 1000
    keys, cols, progs = _programs(TEXTS, n)
    recs, spans = decode_programs(progs, None, [c.data_ptr() for c in cols],
                                  [VT_OF_TORCH[c.dtype] for c in cols],
                                  None)
    assert recs.dtype.itemsize == 16 and len(spans) == len(progs)
    words, consts, offs, lens = merge_programs(progs)
    for got, o, ln in zip(_interpret(recs, spans, cols, n), offs, lens):
        _same(got, vm_run_plain(words[o:o + ln], consts, cols, n))


@pytest.mark.parametrize("f64", [False, True])
def test_decoded_lane_parameters_equal_the_plain_vm(f64):
    """`qparam` records point at their parameter's row of P lane values,
    float32 and float64, over a lane grid whose F is not a multiple of
    32."""
    L, F = 11, 45
    rng = np.random.default_rng(3)
    dt = np.float64 if f64 else np.float32
    params = LaneParams({"__qparam0": (100 + rng.integers(0, 40, L) / 4
                                       ).astype(dt),
                         "__qparam1": rng.integers(0, 900, L).astype(
                             np.int32)}, "cpu")
    from siddhi_tpu_torch.query.ast import AttrType
    schema = StreamSchema.of(parse(
        "define stream S (price double, volume int);").stream_definitions[
        "S"])
    ctx = SingleStreamContext(schema, StringTable(), extra={
        "__qparam0": ("__qparam0", AttrType.DOUBLE if f64 else
                      AttrType.FLOAT),
        "__qparam1": ("__qparam1", AttrType.INT)})
    cols = [torch.from_numpy(np.round(rng.uniform(90, 130, F) * 4) / 4),
            torch.from_numpy(rng.integers(0, 1000, F).astype(np.int32))]
    from siddhi_tpu_torch.core.expr import F32_MODE, compute_dtypes
    with compute_dtypes(None if f64 else F32_MODE):
        progs = [emit_program(compile_expression(parse_expression(t),
                                                 ctx).node,
                              {"price": (0, VT_F64), "volume": (1, VT_I32)})
                 for t in ("price > __qparam0",
                           "price > __qparam0 and volume < __qparam1")]
    rows = RowMap(col_mod=F, lane_div=F, qparams=params)
    n = L * F
    recs, spans = decode_programs(progs, None, [c.data_ptr() for c in cols],
                                  [VT_F64, VT_I32], params)
    el, ln = rows.elements(n, "cpu"), rows.lanes(n, "cpu")
    got = _interpret(recs, spans, cols, n, params, ln, el)
    want = expr_masks_plain(cols, progs, n, None, rows)
    for g, w in zip(got, want):
        assert torch.equal(pack_mask(g), w)


def _stepped_rows(n, rows: RowMap, R: int) -> tuple:
    """Each row's element and lane as the kernel steps them: a tile's
    thread starts from its first row by multiply-high divisions and adds
    32 rows at a time, R rows a thread, each field from the counter
    `row_fields` picks (csrc/expr_eval.cu k1_rows, K1Ctr)."""
    def div(x, d):
        _d, magic, shift, _q, _r = d
        return ((x * magic >> 32) + x) >> shift

    def init(r, d, m):
        q = div(r, d)
        return [r - q * d[0], (q - div(q, m) * m[0]) if m[0] else q]

    def step(c, d, m):
        c[0] += d[4]
        inc = d[3]
        if c[0] >= d[0]:
            c[0] -= d[0]
            inc += 1
        c[1] += inc
        if m[0] and c[1] >= m[0]:
            c[1] -= m[0]
            if c[1] >= m[0]:
                c[1] %= m[0]
    esel, lsel, dv = row_fields(rows, True)
    cd, cm = int_divider(rows.col_div), int_divider(rows.col_mod)
    ld, lm = int_divider(rows.lane_div), int_divider(rows.lane_mod)
    dvd, none = int_divider(dv), int_divider(0)
    tile = 32 * R
    elem = np.full(-(-n // tile) * tile, -1, np.int64)
    lane = elem.copy()
    for t in range(-(-n // tile)):
        for lid in range(32):
            r0 = t * tile + lid
            a = init(r0, dvd, none) if dv else None
            e, ln = init(r0, cd, cm), init(r0, ld, lm)
            for j in range(R):
                r = r0 + 32 * j
                elem[r] = (r, a and a[0], a and a[1], e[1])[esel]
                lane[r] = (0, a and a[0], a and a[1], ln[1])[lsel]
                if dv:
                    step(a, dvd, none)
                step(e, cd, cm)
                step(ln, ld, lm)
    return elem[:n], lane[:n]


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("rows", [
    RowMap(), RowMap(col_mod=45, lane_div=45), RowMap(col_mod=7, lane_div=7),
    RowMap(col_mod=8233, lane_div=8233), RowMap(col_div=37, lane_mod=37),
    RowMap(col_div=5, lane_mod=5), RowMap(lane_mod=1000),
    RowMap(col_mod=32, lane_div=32), RowMap(col_div=1, lane_mod=3),
    RowMap(lane_div=45), RowMap(col_div=5, col_mod=3, lane_div=2,
                                lane_mod=7)],
    ids=repr)
def test_row_stepping_equals_the_row_map(rows, R):
    """The kernel's row stepping gives every row the element and lane of
    the row map, at both row counts a thread: lane grids with F below 32,
    not a multiple of 32 and C5's 8233, the (T, P) grids, identity."""
    n = 5 * 32 * R + 77
    elem, lane = _stepped_rows(n, rows, R)
    want_e = rows.elements(n, "cpu")
    want_e = np.arange(n) if want_e is None else want_e.numpy()
    np.testing.assert_array_equal(elem, want_e)
    np.testing.assert_array_equal(lane, rows.lanes(n, "cpu").numpy())


@pytest.mark.parametrize("d", [1, 2, 3, 7, 31, 32, 33, 45, 1000, 8233,
                               65_537, 2**20 + 7, 2**31 - 1])
def test_int_divider_divides_every_row_index(d):
    """(umulhi(x, magic) + x) >> shift == x // d for row indices below
    2^31, and the 32-row step constants."""
    d_, magic, shift, sq, sr = int_divider(d)
    assert d_ == d and magic < 2**32 and (sq, sr) == divmod(32, d)
    x = np.concatenate([np.arange(4096), np.random.default_rng(d).integers(
        0, 2**31, 20000), [2**31 - 1, 2**31 - 2, d - 1, d, d + 1]]).astype(
        np.uint64) % np.uint64(2**31)
    q = (((x * np.uint64(magic)) >> np.uint64(32)) + x) >> np.uint64(shift)
    np.testing.assert_array_equal(q, x // np.uint64(d))
    assert int_divider(0) == (0, 0, 0, 0, 0)


def test_rows_a_thread():
    """8 rows a thread where every SM of the card gets a full block of
    256 threads at 8 rows (C5's 2,058,250 rows, C4's 334,000, C1's 2^20
    on 132 SMs), 2 below that (C2's window calls of 131,072 rows, the
    selector's 103,658, J6O's side filter of 2048)."""
    assert ROWS == (8, 2)
    for n in (2_058_250, 334_000, 1 << 20, 8 * 256 * 132):
        assert rows_a_thread(n, 132) == 8
    for n in (131_072, 103_658, 2048, 1, 8 * 256 * 132 - 1):
        assert rows_a_thread(n, 132) == 2


def test_row_fields_share_one_counter():
    """The lane grid and the (T, P) grids step one counter for both the
    element and the lane; other maps step each field on its own."""
    assert row_fields(RowMap(col_mod=8233, lane_div=8233), True) == \
        (1, 2, 8233)
    assert row_fields(RowMap(col_div=1000, lane_mod=1000), True) == \
        (2, 1, 1000)
    assert row_fields(RowMap(lane_mod=1000), True) == (0, 1, 1000)
    assert row_fields(RowMap(), False) == (0, 0, 0)
    assert row_fields(RowMap(), True) == (0, 3, 0)
    assert row_fields(RowMap(col_mod=45, lane_div=44), True) == (1, 3, 45)
    assert row_fields(RowMap(col_div=5, col_mod=3, lane_div=2, lane_mod=7),
                      True) == (3, 3, 0)


def test_fused_compares():
    """Programs that only compare two operands (a load, constant or lane
    parameter each, either cast) take the kernel's fused path -- C1's
    and C4's `price > 100` (a cast constant), C5's `price > __qparam0`
    (a cast parameter); anything else the stack interpreter."""
    _k, _c, progs = _programs(TEXTS + ["volume > 3", "ratio < price",
                                       "convert(volume, 'double') < 2.5"])
    got = [fused_compare(p) for p in progs]
    assert got[0] == 5                      # price > 100: a cast constant
    assert got[1:11] == [0] * 10            # and/or, select, arithmetic
    assert got[11:] == [1, 3, 3]
    from siddhi_tpu_torch.core.expr import F32_MODE, compute_dtypes
    schema = StreamSchema.of(parse("define stream S (price double, v int);"
                                   ).stream_definitions["S"])
    from siddhi_tpu_torch.query.ast import AttrType
    ctx = SingleStreamContext(schema, StringTable(), extra={
        "__qparam0": ("__qparam0", AttrType.INT)})
    with compute_dtypes(F32_MODE):
        c5 = emit_program(compile_expression(parse_expression(
            "price > __qparam0"), ctx).node,
            {"price": (0, VT_F32), "v": (1, VT_I32)})
        c4 = emit_program(compile_expression(parse_expression(
            "price > 100"), ctx).node, {"price": (0, VT_F32),
                                        "v": (1, VT_I32)})
    assert fused_compare(c5) == 5 and fused_compare(c4) == 5
