"""Window joins of the port against siddhi_tpu on the CPU.

Every case runs the same sends, made from a numpy seed, through
`siddhi_tpu` (its DeviceJoinPlan, XLA on the CPU: the default
`@app:deviceJoins('auto')` plans it for every shape here) and through
`siddhi_tpu_torch` (`SiddhiManager(device="cpu")`: K1's and K9's plain
versions).  Rows are compared in order with None in place, tolerance 0:
pass-through columns gather on the host at full precision in both, and
computed DOUBLE columns are the same f32 arithmetic (the JAX block's
`F32_MODE`, the port's VM programs in f32, no FMA contraction) widened to
f64 the same way.

Covered: every shape of tests/test_join_device.py (inner, residual,
non-equality, cross, left/right/full outer, both unidirectional sides,
side filters, computed outputs with and without outer misses, a
windowless side, a self-join, `select *`, per-event against one-flush
feeding), state carried over from a JAX plan (`join_state_from_jax`),
a fuzz over seeds, bench.py's config 6 app on a 2^13-event bench tape,
the refusals, `deviceJoins('always'/'never')`, and K9's plain version
against the JAX block itself (`DeviceJoinPlan._block_fn`) on random
blocks, pair capacity overflow included."""
import numpy as np
import pytest
import torch

import siddhi_tpu
from siddhi_tpu.core.join_device import DeviceJoinPlan as JJoinPlan

import siddhi_tpu_torch
from siddhi_tpu_torch.core.join_device import DeviceJoinPlan
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.kernels import LAUNCHES, reset_launches
from siddhi_tpu_torch.replay import (JOIN_APP, JOIN_OUTER, JOIN_UNI,
                                     join_tape, run_join)
from siddhi_tpu_torch.weights import join_state_from_jax

HEAD = ("define stream L (sym string, lp double, ln int);\n"
        "define stream R (sym string, rp double, rn int);\n")


def run(pkg, app, sends, flush_every=7):
    """(plan types, rows as (ts, row)) of `app` on `sends`, flushing after
    every `flush_every`-th send (0: once at the end)."""
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    rt = pkg.SiddhiManager(**kw).create_app_runtime(app)
    kinds = [type(p).__name__ for p in rt._plans]
    rows = []
    rt.add_callback("O", lambda evs: rows.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    rt.start()
    for i, (sid, row, ts) in enumerate(sends):
        rt.send(sid, row, timestamp=ts)
        if flush_every and i % flush_every == 0:
            rt.flush()
    rt.flush()
    rt.shutdown()
    return kinds, rows


def both(app, sends, flush_every=7, head=HEAD):
    """The port's rows, equal to siddhi_tpu's device join in order."""
    kj, want = run(siddhi_tpu, head + app, sends, flush_every)
    assert "DeviceJoinPlan" in kj, kj
    kp, got = run(siddhi_tpu_torch, head + app, sends, flush_every)
    assert kp == ["DeviceJoinPlan"], kp
    assert got == want, (len(got), len(want), got[:4], want[:4])
    return got


def mk_sends(n, keys=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = "L" if rng.random() < 0.5 else "R"
        row = (f"K{int(rng.integers(keys))}",
               float(rng.integers(1, 40)), int(rng.integers(0, 9)))
        out.append((sid, row, 1000 + i))
    return out


INNER = ("from L#window.length(5) as a join R#window.length(4) as b "
         "on a.sym == b.sym select a.sym as s, a.lp as lp, b.rp as rp "
         "insert into O;")

SHAPES = {
    "inner": (INNER, 80, 3, 0),
    "residual": ("from L#window.length(6) as a join R#window.length(6) as b "
                 "on a.sym == b.sym and a.lp > b.rp "
                 "select a.sym as s, a.lp as lp, b.rp as rp insert into O;",
                 80, 3, 1),
    "non_equality": ("from L#window.length(5) as a join R#window.length(5) "
                     "as b on a.lp < b.rp select a.lp as x, b.rp as y "
                     "insert into O;", 60, 3, 2),
    "cross": ("from L#window.length(3) as a join R#window.length(3) as b "
              "select a.lp as x, b.rp as y insert into O;", 50, 3, 3),
    "unidirectional_left": (
        "from L#window.length(4) as a unidirectional join "
        "R#window.length(4) as b on a.sym == b.sym "
        "select a.lp as x, b.rp as y insert into O;", 60, 3, 5),
    "unidirectional_right": (
        "from L#window.length(4) as a join R#window.length(4) as b "
        "unidirectional on a.sym == b.sym "
        "select a.lp as x, b.rp as y insert into O;", 60, 3, 5),
    "side_filters": ("from L[lp > 10]#window.length(4) as a join "
                     "R[rp < 30]#window.length(4) as b on a.sym == b.sym "
                     "select a.lp as x, b.rp as y insert into O;", 80, 3, 6),
    "computed": ("from L#window.length(4) as a join R#window.length(4) as b "
                 "on a.sym == b.sym select a.lp + b.rp as tot, "
                 "a.lp * 2.0 as dl, a.ln + b.rn as cnt insert into O;",
                 70, 3, 7),
    "windowless_side": ("from L as a join R#window.length(4) as b "
                        "on a.sym == b.sym select a.lp as x, b.rp as y "
                        "insert into O;", 50, 3, 9),
    "select_star": ("from L#window.length(3) as a join R#window.length(3) "
                    "as b on a.sym == b.sym select * insert into O;",
                    40, 3, 11),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_matches_siddhi_tpu(shape):
    app, n, keys, seed = SHAPES[shape]
    assert both(app, mk_sends(n, keys=keys, seed=seed))


@pytest.mark.parametrize("jt", ["left outer join", "right outer join",
                                "full outer join"])
def test_outer_joins(jt):
    app = (f"from L#window.length(4) as a {jt} R#window.length(4) as b "
           f"on a.sym == b.sym "
           f"select a.sym as s, a.lp as lp, b.rp as rp insert into O;")
    out = both(app, mk_sends(70, keys=5, seed=4))
    assert any(None in r for _t, r in out), "outer rows must include nulls"


def test_computed_outputs_outer_misses():
    """Miss rows evaluate the derived output on the host (interp/expr.py)
    with the other side NULL."""
    app = ("from L#window.length(4) as a left outer join "
           "R#window.length(4) as b on a.sym == b.sym "
           "select a.lp + b.rp as tot, a.sym as s insert into O;")
    out = both(app, mk_sends(50, keys=6, seed=8))
    assert any(r[0] is None for _t, r in out)
    assert any(r[0] is not None for _t, r in out)


def test_self_join():
    """Both sides on one stream (one input stream): an event never sees
    itself (strict `<` on seq)."""
    app = ("define stream S (sym string, p double);\n"
           "from S#window.length(4) as a join S#window.length(3) as b "
           "on a.sym == b.sym and a.p > b.p "
           "select a.p as x, b.p as y insert into O;")
    rng = np.random.default_rng(10)
    sends = [("S", (f"K{int(rng.integers(2))}", float(rng.integers(1, 30))),
              1000 + i) for i in range(50)]
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    assert rt.plans()[0].input_streams == ("S",)
    assert both(app, sends, head="")


def test_per_event_flush_matches_one_flush():
    """Window evolution inside one flush equals per-event flushes."""
    sends = mk_sends(60, seed=12)
    _k, fine = run(siddhi_tpu_torch, HEAD + INNER, sends, flush_every=1)
    _k, coarse = run(siddhi_tpu_torch, HEAD + INNER, sends, flush_every=0)
    assert fine == coarse and fine
    _k, want = run(siddhi_tpu, HEAD + INNER, sends, flush_every=1)
    assert fine == want


@pytest.mark.parametrize("seed", range(5))
def test_fuzz(seed):
    shapes = [
        INNER,
        "from L#window.length(7) as a full outer join R#window.length(2) "
        "as b on a.sym == b.sym and a.ln != b.rn "
        "select a.sym as s, a.ln as x, b.rn as y insert into O;",
        "from L[ln > 2]#window.length(3) as a left outer join "
        "R#window.length(5) as b on a.sym == b.sym "
        "select a.sym as s, b.rp as y insert into O;",
    ]
    app = shapes[seed % len(shapes)]
    assert both(app, mk_sends(90, keys=4, seed=100 + seed),
                flush_every=int(np.random.default_rng(seed).integers(1, 13)))


@pytest.mark.parametrize("app", [INNER, SHAPES["side_filters"][0],
                                 SHAPES["computed"][0]],
                         ids=["inner", "side_filters", "computed"])
def test_state_carried_over_from_jax(app):
    """Half the sends on siddhi_tpu, its mirrors carried over with
    join_state_from_jax (and its string table), the rest on the port:
    equal to the JAX run's second half."""
    sends = mk_sends(80, seed=13)
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(HEAD + app)
    jrows = []
    jrt.add_callback("O", lambda evs: jrows.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    jrt.start()
    for sid, row, ts in sends[:40]:
        jrt.send(sid, row, timestamp=ts)
    jrt.flush()
    (jplan,) = [p for p in jrt._plans if isinstance(p, JJoinPlan)]
    state = join_state_from_jax(jplan.state_dict())
    first = len(jrows)
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
        HEAD + app)
    rt.strings.restore(jrt.strings.state())
    rt.plans()[0].load_state_dict(state)
    rows = []
    rt.add_callback("O", lambda evs: rows.extend(
        (e.timestamp, tuple(e.data)) for e in evs))
    for sid, row, ts in sends[40:]:
        jrt.send(sid, row, timestamp=ts)
        rt.send(sid, row, timestamp=ts)
    jrt.flush()
    rt.flush()
    jrt.shutdown()
    assert rows == jrows[first:] and rows
    assert state["left"]["ts"].dtype == np.int64


def test_bench_config_6_tape():
    """bench.py's JOIN_APP on the first 2^13 events of its tape (flushes
    of 4096, 2048 a side), both packages fed by send_batch."""
    tape = join_tape(1 << 13, 4096)
    got, _ms, rt = run_join(JOIN_APP, tape, "cpu")
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(JOIN_APP)
    batches = []
    jrt.add_batch_callback("Out", batches.append)
    jrt.start()
    codes = np.array([jrt.strings.encode(f"K{i}") for i in range(1000)],
                     dtype=np.int32)
    for f in tape:
        for sid in ("L", "R"):
            s = f[sid]
            jrt.input_handler(sid).send_batch(
                {"symbol": codes[s["sym_idx"]], "price": s["price"],
                 "volume": s["volume"]}, timestamps=s["ts"])
        jrt.flush()
    want = [(int(t), row) for b in batches
            for t, row in zip(b.timestamps, b.rows(jrt.strings))]
    jrt.shutdown()
    assert got == want and len(got) > 1000
    assert all(r[1] > r[2] for _t, r in got)


def test_launch_counts_and_recorded_calls():
    """The CPU run counts no kernel launch (the plain versions run), and
    `record` sees each direction's K9 call and the filtered side's K1."""
    calls: list = []
    tape = join_tape(1 << 12, 2048, keys=50, seed=3)
    reset_launches()
    got, _ms, _rt = run_join(JOIN_OUTER, tape, "cpu", record=calls)
    assert LAUNCHES["join_probe"] == 0
    names = [(n, kw.get("use")) for n, _a, kw in calls]
    assert ("expr_eval", "join_filter") in names
    assert sum(n == "join_probe" for n, _u in names) >= 4
    assert any(r[1] is None and r[2] is None for _t, r in got)
    calls.clear()
    run_join(JOIN_UNI, tape, "cpu", record=calls)
    k9 = [kw for n, _a, kw in calls if n == "join_probe"]
    assert k9 and all(kw["Mw"] == 1024 for kw in k9)    # left probes only


@pytest.mark.parametrize("app,reason", [
    ("from L#window.time(1 sec) as a join R#window.length(3) as b "
     "on a.sym == b.sym select a.lp as x insert into O;", "window 'time'"),
    ("from L#window.length(3) as a join R#window.length(3) as b "
     "on a.sym == b.sym select max(a.lp) as m insert into O;",
     "group-by/order-by/having selector"),
    ("from L#window.length(3) as a join R#window.length(3) as b "
     "on a.sym == b.sym select a.lp as x limit 2 insert into O;",
     "limit/offset"),
    ("from L#window.length(0) as a join R#window.length(3) as b "
     "select a.lp as x insert into O;", "window length out of range"),
])
def test_refused_shapes_raise_plan_error(app, reason):
    """Shapes the JAX package demotes to its host join raise PlanError
    with the refusal's reason (the host join is a later slice)."""
    mgr = siddhi_tpu.SiddhiManager()
    jrt = mgr.create_app_runtime(HEAD + app)
    assert not any(isinstance(p, JJoinPlan) for p in jrt._plans)
    mgr.shutdown()
    with pytest.raises(PlanError, match="host join") as ei:
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
            HEAD + app)
    assert reason in str(ei.value)


def test_device_joins_always_and_never():
    bad = ("from L#window.time(1 sec) as a join R#window.length(3) as b "
           "on a.sym == b.sym select a.lp as x insert into O;")
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(PlanError, match=r"deviceJoins\('always'\) but the "
                       r"shape is host-only: window 'time'"):
        mgr.create_app_runtime("@app:deviceJoins('always')\n" + HEAD + bad)
    with pytest.raises(PlanError, match=r"deviceJoins\('never'\).*host join"):
        mgr.create_app_runtime("@app:deviceJoins('never')\n" + HEAD + INNER)
    rt = mgr.create_app_runtime("@app:deviceJoins('always')\n" + HEAD + INNER)
    assert isinstance(rt.plans()[0], DeviceJoinPlan)


# ---------------------------------------------------------------------------
# K9's plain version against the JAX block
# ---------------------------------------------------------------------------

BLOCK_APPS = {
    "residual_outer": (
        "from L[ln > 1]#window.length(6) as a full outer join "
        "R[rp < 35]#window.length(5) as b on a.sym == b.sym and "
        "a.lp > b.rp select a.sym as s, a.lp + b.rp as tot, "
        "a.ln * b.rn as pr, b.rp as y insert into O;"),
    "cross_windowless": (
        "from L as a join R#window.length(7) as b "
        "select a.lp - b.rp as d, eventTimestamp() as t insert into O;"),
    "left_only": (
        "from L#window.length(9) as a unidirectional left outer join "
        "R#window.length(3) as b on a.sym != b.sym "
        "select a.lp as x, convert(b.rn, 'long') + 1 as z insert into O;"),
}


def _block_data(rng, ln, rn, keys, mirrors):
    """Random sides: global seqs interleaved, each side sorted; mirrors
    of `mirrors` = (nL, nR) older events."""
    seq = rng.permutation(np.arange(1000, 1000 + ln + rn))
    side = {}
    for k, n, s in (("L", ln, np.sort(seq[:ln])), ("R", rn,
                                                    np.sort(seq[ln:]))):
        side[k] = {"sym": rng.integers(1, keys + 1, n).astype(np.int32),
                   "p": np.round(rng.uniform(0, 40, n) * 4) / 4,
                   "i": rng.integers(0, 9, n).astype(np.int32),
                   "ts": 5000 + s * 3, "seq": s.astype(np.int64), "n": n}
    mir = {}
    for k, n in zip(("L", "R"), mirrors):
        s = np.arange(n, dtype=np.int64) + 10
        mir[k] = {"sym": rng.integers(1, keys + 1, n).astype(np.int32),
                  "p": np.round(rng.uniform(0, 40, n) * 4) / 4,
                  "i": rng.integers(0, 9, n).astype(np.int32),
                  "ts": 100 + s, "seq": s}
    return side, mir


def _state(mir, names):
    return {"left" if k == "L" else "right": {
        "cols": {names[k][0]: mir[k]["sym"], names[k][1]: mir[k]["p"],
                 names[k][2]: mir[k]["i"]},
        "ts": mir[k]["ts"], "seq": mir[k]["seq"]} for k in ("L", "R")}


def _jax_block(plan, side, names, M):
    """The JAX block's packed result for these sides, unpacked: pair
    totals, pass and miss bits, pairs and computed columns per side."""
    TL, TR = (1 << max(0, int(np.ceil(np.log2(max(side[k]["n"], 1)))))
              for k in ("L", "R"))
    NL, NR = max(plan.left.win_len, 1), max(plan.right.win_len, 1)

    def ev_of(s, k, T, N):
        d, n = side[k], side[k]["n"]
        ev = {"valid": np.zeros(T, bool), "ts64": np.zeros(T, np.int64),
              "seq": np.full(T, 2 ** 62, np.int64), "bT": np.int32(T),
              "mirror_n": np.int32(s.mirror_n)}
        ev["valid"][:n] = True
        ev["ts64"][:n] = d["ts"]
        ev["seq"][:n] = d["seq"]
        for a, src in zip(names[k], ("sym", "p", "i")):
            dt = plan._np_dtype(s.schema.type_of(a))
            col = np.zeros(T, dt)
            col[:n] = d[src]
            ev[a] = col
            mc = np.zeros(N, dt)
            mc[:s.mirror_n] = s.mirror_cols[a].astype(dt)
            ev[f"m.{a}"] = mc
        return ev
    res = plan._block_fn(TL, TR, NL, NR, M)(ev_of(plan.left, "L", TL, NL),
                                            ev_of(plan.right, "R", TR, NR))
    ip = np.asarray(res["i"])
    off = [4]

    def take(n):
        v = ip[off[0]:off[0] + n]
        off[0] += n
        return v

    def bits(w, n):
        return ((w.view(np.uint32)[:, None] >> np.arange(32, dtype=np.uint32))
                & 1).astype(bool).reshape(-1)[:n]
    out = {"total": {"L": int(ip[0]), "R": int(ip[1])},
           "pass": {"L": bits(take(-(-TL // 32)), side["L"]["n"]),
                    "R": bits(take(-(-TR // 32)), side["R"]["n"])},
           "miss": {}}
    for k, T, sn in (("L", TL, "left"), ("R", TR, "right")):
        if plan.trigger in ("all", sn) and plan._outer_for(sn):
            out["miss"][k] = bits(take(-(-T // 32)), side[k]["n"])
    out["a"], out["b"] = {}, {}
    for k in ("L", "R"):
        out["a"][k], out["b"][k] = take(M), take(M)
    out["cols"] = {"L": [], "R": []}
    for t, pt in zip(plan._types, plan._passthrough):
        if pt is not None:
            continue
        for k in ("L", "R"):
            if t.name == "LONG":
                hi, lo = take(M).astype(np.int64), take(M).astype(np.int64)
                out["cols"][k].append((hi << 32) | (lo & 0xFFFFFFFF))
            elif t.name in ("DOUBLE", "FLOAT"):
                out["cols"][k].append(take(M).view(np.float32))
            else:
                out["cols"][k].append(take(M))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("which", sorted(BLOCK_APPS))
def test_plain_k9_matches_the_jax_block(which, seed):
    """The port's K1 join filter and K9 plain version, arranged by the
    port's plan, against the JAX package's jitted block on the same
    random sides and mirrors: pair totals, pass and miss bits, the pairs
    and every computed column, at a capacity M that holds the pairs and
    at one below the pair count (the totals still reported; the writes
    within M, JAX's last slot taking every overflowing pair)."""
    app = HEAD + BLOCK_APPS[which]
    names = {"L": ("sym", "lp", "ln"), "R": ("sym", "rp", "rn")}
    rng = np.random.default_rng(40 + seed)
    side, mir = _block_data(rng, int(rng.integers(1, 40)),
                            int(rng.integers(1, 40)), 3,
                            (int(rng.integers(0, 7)),
                             int(rng.integers(0, 7))))
    jrt = siddhi_tpu.SiddhiManager().create_app_runtime(app)
    (jplan,) = [p for p in jrt._plans if isinstance(p, JJoinPlan)]
    rt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(app)
    plan = rt.plans()[0]
    for p in (jplan, plan):
        st = _state(mir, names)
        for sk, s in (("left", p.left), ("right", p.right)):
            w = s.win_len
            st[sk] = {"cols": {c: v[-w:] if w else v[:0]
                               for c, v in st[sk]["cols"].items()},
                      "ts": st[sk]["ts"][-w:] if w else st[sk]["ts"][:0],
                      "seq": st[sk]["seq"][-w:] if w else st[sk]["seq"][:0]}
        p.load_state_dict(st)
    evs = {}
    for k, s in (("L", plan.left), ("R", plan.right)):
        d = side[k]
        cols = {names[k][0]: d["sym"], names[k][1]: d["p"],
                names[k][2]: d["i"]}
        evs[k] = plan._upload(s, cols, d["ts"], d["seq"], d["n"])
    passes = {k: plan._side_pass(s, evs[k])
              for k, s in (("L", plan.left), ("R", plan.right))}
    full = _jax_block(jplan, side, names, 4096)
    for k in ("L", "R"):
        got = np.ones(side[k]["n"], bool) if passes[k] is None else \
            _bits(passes[k], side[k]["n"])
        assert np.array_equal(got, full["pass"][k])
    dirs = {d.key: d for d in plan._dirs}
    tot = max(full["total"].values())
    for M in sorted({4096, max(tot - 1, 1)}):
        want = full if M == 4096 else _jax_block(jplan, side, names, M)
        for k in ("L", "R"):
            if k not in dirs:
                assert want["total"][k] == 0
                continue
            total, pa, pb, outs, miss = plan._probe(dirs[k], evs, passes, M)
            n = int(total[0])
            assert n == want["total"][k]
            keep = n if n <= M else M - 1
            assert np.array_equal(pa[:keep].numpy(), want["a"][k][:keep])
            assert np.array_equal(pb[:keep].numpy(), want["b"][k][:keep])
            assert bool((pa[min(n, M):] == -1).all())
            for o, w in zip(outs, want["cols"][k]):
                assert np.array_equal(o[:keep].numpy(), w[:keep]), (k, M)
            if k in want["miss"]:
                assert np.array_equal(_bits(miss, side[k]["n"]),
                                      want["miss"][k])
            else:
                assert miss is None


def _bits(words: torch.Tensor, n: int) -> np.ndarray:
    w = words.numpy().view(np.uint32)
    return ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        bool).reshape(-1)[:n]
