"""Replay tapes through the port's apps and hold its kernels against their
plain versions.

Shared by `chip_smoke.py`, `scripts/torch_c4_profile.py` and the card
tests (tests/test_torch_gpu.py):

  * the app texts of the driven configurations: BASELINE configs 1-5
    (`C1`, `C3`, `C4`, `c5_app`, `C2`), the grouped time window and C2B,
    the pattern-algebra apps of C4's partitioned shape (`C4N`, `C4NS`,
    `C4A`, `C4O`), the init-slot, fork and absent-side apps of K2's EXT
    instantiation (`C4H`, `C4Z`, `C4F`, `C4L_OR`, `C4L_AND` under
    @app:playback, and `C3H`, unpartitioned on the wall clock), the
    stateless `chunk` and `dfa` apps (`C3K`: bench.py's C3 under
    `patternFamily('chunk')`; `C3X`, a capture-dependent conjunction, and
    `C3E`, `every` below the head, which pick `chunk` by default; `C3SD`:
    bench.py's static C3S under `patternFamily('dfa')`; `C4D`: C4's
    partitioned head with a static hop and a threshold hop under
    `patternFamily('dfa')`), bench.py's
    config 6 join (`JOIN_APP`) and its filtered
    outer and unidirectional variants (`JOIN_OUTER`, `JOIN_UNI`), and the
    fused lanes' parameter app (`PARAM_APP`);
  * `make_tape`, the benchmark tape: uniform keys, prices on the quarter
    grid, flushes of `batch` events `dt_ms` apart;
  * `join_tape`, bench.py's config 6 tape (`bench_join`), and
    `run_join`, a join app through it, each flush one `send_batch` per
    side and one `flush()`; with `record` (a list) every join plan
    appends each kernel call it makes (`DeviceJoinPlan.record`);
  * `run_window`, a window app flush by flush (each flush one
    `send_batch` and one `flush()`, timed on the host clock around work
    that ends in `torch.cuda.synchronize()` on a card); with `record`
    (a list) every window plan of the app appends each kernel call it
    makes as (name, args, kwargs) (`DeviceWindowAggPlan.record`);
  * bench.py's aggregation matrix (`--matrix`, docs/AGGREGATION.md "The
    workload matrix"): `MATRIX_APP`, `matrix_tape`, `matrix_query`, and
    `run_agg`, an aggregation app through such a tape, each flush one
    `send_batch` (and `flush()`), optionally a store query after every
    `query_every` flushes; with `record` (a list) the aggregation appends
    each K10 call (device-resident rings) or K6 call (`'always'`);
  * the checks: `check_agg_calls` (K10 and K6 use `agg` on the calls an
    aggregation run recorded), `check_window_calls` (K1's window uses and K6-K8 on the
    calls a window run recorded), `check_join_calls` (K1 `join_filter`
    and K9 on the calls a join run recorded), `check_seq_block` (K2 and K1 on a block
    a `seq` plan handed NFAKernel.run_block: every state field, the
    init-slot flags and the deadline rows included), `check_chunk_block`
    (the same on a `chunk` block, from fresh state), `check_scan_block` (K1, K3,
    K6, K3's rank trees, K4 and K5 on a block a `scan` plan handed
    ParallelChainKernel.run_block; K11 and K4's `dfa` mode too on a `dfa`
    block, which `check_dfa_block` asserts), each kernel on the same inputs as its
    plain version, tolerance 0; they raise `KernelMismatch` on the first
    difference and return the largest |kernel - plain| per kernel use;
  * `sorted_rows`, a match table in (completion seq, head seq, lane)
    order (a kernel appends matches in no fixed order).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

STOCK = "define stream StockStream (symbol string, price double, volume int);\n"
C1 = STOCK + ("@info(name='q') from StockStream[price > 100] "
              "select * insert into Out;\n")
C4 = STOCK + """
partition with (symbol of StockStream)
begin
  @info(name='q')
  from every e1=StockStream[price > 100] -> e2=StockStream[price > e1.price]
    -> e3=StockStream[price > e2.price] within 10 sec
  select e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;
end;
"""
C4_HEAD = "@app:partitionCapacity(1000)\n@app:deviceSlots(32)\n"
C4_SEQ = "@app:patternFamily('seq')\n"
C3 = STOCK + ("@info(name='q') from every e1=StockStream[price > 100] -> "
              "e2=StockStream[price > e1.price] within 1 sec "
              "select e1.price as p1, e2.price as p2 insert into Out;\n")
C2 = STOCK + ("@info(name='q') from StockStream#window.length(1000) "
              "select avg(price) as ap insert into Out;\n")
C2_GROUPED = STOCK + (
    "@info(name='q') from StockStream[volume > 100]#window.time(10 sec) "
    "select symbol, min(price) as lo, max(price) as hi, avg(price) as ap, "
    "count() as n group by symbol having n > 10 insert into Out;\n")
C2B = ("define stream StockStream (symbol string, price double, volume int, "
       "et long);\n@info(name='q') from StockStream"
       "#window.externalTimeBatch(et, 64) select symbol, sum(price) as sp, "
       "count() as c group by symbol insert into Out;\n")

# the pattern algebra on C4's partitioned shape: counts and logical and/or
C4N_BODY = (
    "from every e1=StockStream[price > 110]<1:3> -> "
    "e2=StockStream[price < 95] within 1 sec "
    "select e1[0].price as p0, e1[last].price as pl, e2.price as p2 "
    "insert into Out;")
C4NS_BODY = (
    "from every e1=StockStream[price > 100] -> "
    "e2=StockStream[price > e1.price]<2:4> -> e3=StockStream[price < 95] "
    "within 10 sec select e1.price as p1, e2[0].price as p20, "
    "e2[last].price as p2l, e3.price as p3 insert into Out;")
C4O_BODY = (
    "from every e1=StockStream[price > 110] -> e2=StockStream[price < 95] "
    "or e3=StockStream[volume > 990] within 1 sec "
    "select e1.price as p1, e2.price as p2, e3.volume as v3 "
    "insert into Out;")
C4A_BODY = C4O_BODY.replace(" or ", " and ")


def partitioned(body: str) -> str:
    """A pattern query body inside C4's `partition with (symbol)`."""
    return (STOCK + "partition with (symbol of StockStream)\nbegin\n"
            "  @info(name='q')\n  " + body + "\nend;\n")


C4N = partitioned(C4N_BODY)             # `scan`: count head, rank/select
C4NS = partitioned(C4NS_BODY)           # `seq`: count with a capture filter
C4A = partitioned(C4A_BODY)             # `scan`: `and`, prev pointers
C4O = partitioned(C4O_BODY)             # `or`, NULL losers (seq forced)

# init slots, forks and absent sides (K2's EXT instantiation) on C4's
# partitioned shape under @app:playback, and one unpartitioned absent head
# on the wall clock
C4H_BODY = (
    "from every not StockStream[price > 128] for 3 sec -> "
    "e2=StockStream[price < 92] within 10 sec "
    "select e2.price as p2, e2.volume as v2 insert into Out;")
C4Z_BODY = (
    "from e1=StockStream[price > 125]<0:3> -> e2=StockStream[price < 92] "
    "within 10 sec select e1[0].price as p10, e1 is null as none, "
    "e2.price as p2 insert into Out;")
C4F_BODY = (
    "from every e1=StockStream[price > 126] -> every "
    "e2=StockStream[price < 100] -> e3=StockStream[price > e2.price] "
    "within 10 sec select e1.price as p1, e2.price as p2, e3.price as p3 "
    "insert into Out;")
C4L_OR_BODY = (
    "from every e1=StockStream[price > 120] -> e2=StockStream[price < 92] "
    "or not StockStream[price > 128] for 1 sec within 10 sec "
    "select e1.price as p1, e2.price as p2, e2 is null as timed_out "
    "insert into Out;")
C4L_AND_BODY = C4L_OR_BODY.replace(" or ", " and ")
PLAYBACK = "@app:playback\n"
C4H = PLAYBACK + partitioned(C4H_BODY)
C4Z = PLAYBACK + partitioned(C4Z_BODY)
C4F = "@app:deviceSlots(4)\n" + PLAYBACK + partitioned(C4F_BODY)
C4L_OR = PLAYBACK + partitioned(C4L_OR_BODY)
C4L_AND = PLAYBACK + partitioned(C4L_AND_BODY)
C3H = STOCK + ("@info(name='q') from not StockStream[price > 129] for 100 "
               "milliseconds -> e2=StockStream[price < 91] "
               "select e2.price as p2, e2.volume as v2 insert into Out;\n")

# the stateless `chunk` family (K2 over own-chunks with halo reads) and the
# `dfa` family (K11 symbol tables, K4's lookup mode); bench.py:211 (C3S)
CHUNK = "@app:patternFamily('chunk')\n"
DFA = "@app:patternFamily('dfa')\n"
C3K = CHUNK + C3
C3X = STOCK + (
    "@info(name='q') from every e1=StockStream[price > 100] -> "
    "e2=StockStream[price > e1.price and volume > e1.volume] within 1 sec "
    "select e1.price as p1, e2.price as p2 insert into Out;\n")
C3E = STOCK + (
    "@info(name='q') from every e1=StockStream[price > 127] -> "
    "every e2=StockStream[price < 91] within 200 milliseconds "
    "select e1.price as a, e2.price as b insert into Out;\n")
C3S = STOCK + ("@info(name='q') from every e1=StockStream[price > 100] -> "
               "e2=StockStream[price < 95] within 1 sec "
               "select e1.price as p1, e2.price as p2 insert into Out;\n")
C3SD = DFA + C3S
C4D_BODY = (
    "from every e1=StockStream[price > 110] -> e2=StockStream[price < 100] "
    "-> e3=StockStream[price > e1.price] within 10 sec "
    "select e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;")
C4D = DFA + partitioned(C4D_BODY)


# bench.py:438-444 (config 6), copied
JOIN_APP = """
define stream L (symbol string, price double, volume int);
define stream R (symbol string, price double, volume int);
@info(name='q') from L#window.length(1024) as a join R#window.length(1024) as b
on a.symbol == b.symbol and a.price > b.price
select a.symbol as s, a.price as lp, b.price as rp insert into Out;
"""
JOIN_STREAMS = JOIN_APP.split("@info")[0]
# the same streams: a filtered full outer join with a computed column
# (K1 `join_filter`, both miss words, host miss rows), and a windowless
# unidirectional side (one probing direction)
JOIN_OUTER = JOIN_STREAMS + (
    "@info(name='q') from L[volume > 2]#window.length(1024) as a full outer "
    "join R#window.length(256) as b on a.symbol == b.symbol and "
    "a.price > b.price select a.symbol as s, a.price + b.price as tot, "
    "b.volume as bv insert into Out;\n")
JOIN_UNI = JOIN_STREAMS + (
    "@info(name='q') from L as a unidirectional join R#window.length(1024) "
    "as b on a.symbol == b.symbol select a.price as lp, b.price as rp "
    "insert into Out;\n")

# fused lanes with lifted constants in hops and selectors (the card
# tests and tests/test_torch_multi_query.py)
PARAM_APP = "@app:playback\n" + "\n".join(
    ["define stream S (sym string, price double, v int);"] +
    [f"@info(name='q{i}') from every e1=S[price > {100 + i}.0] -> "
     f"e2=S[price > e1.price + {i % 3}.5] within 1 sec "
     f"select e1.price * {i + 1}.0 as a, e2.v + {i} as b "
     f"insert into Out{i % 2};" for i in range(10)] +
    [f"@info(name='q{i}') from every e1=S[price > {100 + i % 7}.0], "
     f"e2=S[price > e1.price - {i % 4}.25 and v != {i}] "
     f"select e1.v * {i} as a insert into Out{2 + i % 2};"
     for i in range(10, 20)])


def c5_app(n_queries=1000):
    """bench.py:226-266 (BASELINE config 5), copied: 1k concurrent mixed
    pattern/sequence queries with `not`/`within` over one shared input
    stream, under @app:playback."""
    parts = ["@app:playback\n" + STOCK]   # historical tape: event-time
    for i in range(n_queries):            # deadlines fire in-scan, not via
        lo = 123 + (i % 6)                # the wall-clock pump
        shape = i % 4
        if shape == 0:
            parts.append(
                f"@info(name='q{i}') from every e1=StockStream[price > {lo}] -> "
                f"e2=StockStream[price > e1.price] within 1 sec "
                f"select e1.price as p1, e2.price as p2 insert into Out{i % 16};")
        elif shape == 1:
            parts.append(
                f"@info(name='q{i}') from e1=StockStream[price > {lo}], "
                f"e2=StockStream[price > e1.price] "
                f"select e1.price as p1, e2.price as p2 insert into Out{i % 16};")
        elif shape == 2:
            parts.append(
                f"@info(name='q{i}') from e1=StockStream[price > {lo + 1}] -> "
                f"not StockStream[price < {lo - 30}] for 500 milliseconds "
                f"select e1.price as p1 insert into Out{i % 16};")
        else:
            parts.append(
                f"@info(name='q{i}') from every e1=StockStream[price > {lo}] -> "
                f"e2=StockStream[price > e1.price] -> "
                f"e3=StockStream[price > e2.price] within 2 sec "
                f"select e1.price as p1, e3.price as p3 insert into Out{i % 16};")
    return "\n".join(parts) + "\n"


def make_tape(n_events: int, batch: int, keys: int, seed: int = 0,
              dt_ms: int = 1) -> list:
    """The benchmark tape shape: uniform keys, prices on the quarter grid
    (exact in float32), volumes, dt_ms apart, one dict per flush."""
    rng = np.random.default_rng(seed)
    tape = []
    ts0 = 1_700_000_000_000
    for start in range(0, n_events, batch):
        n = min(batch, n_events - start)
        tape.append({
            "sym_idx": rng.integers(0, keys, size=n).astype(np.int32),
            "price": np.round(rng.uniform(90.0, 130.0, size=n) * 4) / 4,
            "volume": rng.integers(1, 1000, size=n).astype(np.int32),
            "ts": ts0 + np.arange(start, start + n, dtype=np.int64) * dt_ms})
    return tape


def join_tape(n_events: int, batch: int, keys: int = 1000,
              seed: int = 0) -> list:
    """bench.py's `bench_join` tape: per flush `batch // 2` events to L,
    then as many to R (key index, q4 price in [90, 130), volume 1-8, in
    that order from one numpy generator), timestamps consecutive from
    1_700_000_000_000; one dict per flush, {"L": side, "R": side}."""
    rng = np.random.default_rng(seed)
    half = batch // 2
    ts0 = 1_700_000_000_000
    tape, done = [], 0
    for _ in range(n_events // batch):
        flush = {}
        for sid in ("L", "R"):
            flush[sid] = {
                "sym_idx": rng.integers(0, keys, half),
                "price": np.round(rng.uniform(90, 130, half) * 4) / 4,
                "volume": rng.integers(1, 9, half).astype(np.int32),
                "ts": ts0 + np.arange(done, done + half, dtype=np.int64)}
            done += half
        tape.append(flush)
    return tape


def run_join(app: str, tape: list, device: str, record: Optional[list] = None,
             keys: int = 1000) -> tuple:
    """Feed a `join_tape` through `app` on `device`, flush by flush
    (`send_batch` to L, to R, then `flush()`, timed on the host clock
    around work that ends in `torch.cuda.synchronize()` on a card);
    returns (rows as (ts, row) in output order, ms per flush, runtime)."""
    from .core.join_device import DeviceJoinPlan
    from .core.runtime import SiddhiManager
    rt = SiddhiManager(device=device).create_app_runtime(app)
    if record is not None:
        for p in rt.plans():
            if isinstance(p, DeviceJoinPlan):
                p.record = record
    batches: list = []
    rt.add_batch_callback("Out", batches.append)
    hs = {sid: rt.input_handler(sid) for sid in ("L", "R")}
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    per_flush = []
    for f in tape:
        t0 = time.perf_counter()
        for sid in ("L", "R"):
            s = f[sid]
            hs[sid].send_batch({"symbol": codes[s["sym_idx"]],
                                "price": s["price"], "volume": s["volume"]},
                               s["ts"])
        rt.flush()
        if device == "cuda":
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
    out = [(int(t), row) for b in batches
           for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return out, per_flush, rt


def run_window(app: str, tape: list, device: str,
               record: Optional[list] = None, rows: bool = True) -> tuple:
    """Feed `tape` (dicts of `ts`, `sym_idx`, `price`, `volume` arrays, one
    per flush) through `app` on `device`; returns (rows as (ts, row) in
    output order, or None when `rows` is false; ms per flush; runtime)."""
    from .core.runtime import SiddhiManager
    from .core.window_device import DeviceWindowAggPlan
    rt = SiddhiManager(device=device).create_app_runtime(app)
    if record is not None:
        for p in rt.plans():
            if isinstance(p, DeviceWindowAggPlan):
                p.record = record
    batches: list = []
    rt.add_batch_callback("Out", batches.append)
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(64)],
                     dtype=np.int32)
    per_flush = []
    for f in tape:
        cols = {"symbol": codes[f["sym_idx"]], "price": f["price"],
                "volume": f["volume"]}
        if "et long" in app:
            cols["et"] = f["ts"]
        t0 = time.perf_counter()
        h.send_batch(cols, f["ts"])
        rt.flush()
        if device == "cuda":
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
    out = [(int(t), row) for b in batches
           for t, row in zip(b.timestamps, b.rows(rt.strings))] \
        if rows else None
    return out, per_flush, rt


# the incremental aggregation matrix of bench.py (`_matrix_app`,
# `_matrix_tape`, `_matrix_query`, bench.py:2849-2880)
MATRIX_TS0 = 1_700_000_000_000
MATRIX_PERS = ("sec", "min", "hour")


def MATRIX_APP(head: str = "", group_by: bool = True) -> str:
    """bench.py's `_matrix_app`: a DEBS-shaped rollup of Trades by symbol
    at sec, min and hour; `group_by=False` drops the `group by` (a global
    rollup, one segment per bucket) and `sym` from the selector."""
    return (head +
            "define stream Trades "
            "(sym string, p double, v double, ts long);\n"
            "define aggregation Roll\n"
            "from Trades\n"
            "select " + ("sym, " if group_by else "") +
            "sum(p * v) as turnover, avg(p) as mean, "
            "min(p) as lo, max(p) as hi, count() as n\n"
            + ("group by sym\n" if group_by else "") +
            "aggregate by ts every sec, min, hour;\n")


def matrix_tape(n_batches: int, batch: int, keys: int, seed: int = 13) -> list:
    """bench.py's `_matrix_tape`: batches 1.5 s of event time apart, each
    `batch` events at sorted offsets in [0, 1500) ms, symbols G0..G<keys>,
    p uniform in [10, 500), v in [1, 50); [(columns, timestamps)]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_batches):
        ts = (MATRIX_TS0 + k * 1500
              + np.sort(rng.integers(0, 1500, batch))).astype(np.int64)
        out.append(({"sym": np.array([f"G{i}" for i in
                                      rng.integers(0, keys, batch)]),
                     "p": rng.uniform(10, 500, batch),
                     "v": rng.uniform(1, 50, batch),
                     "ts": ts}, ts))
    return out


def matrix_query(per: str = "min", group_by: bool = True) -> str:
    """bench.py's `_matrix_query`: every bucket of `per` from an hour
    before the tape to a day after (without `sym` for a global rollup)."""
    return (f"from Roll within {MATRIX_TS0 - 3_600_000}L, "
            f"{MATRIX_TS0 + 86_400_000}L per {per!r} select "
            + ("sym, " if group_by else "") + "turnover, mean, lo, hi, n")


def run_agg(app: str, tape: list, device: str, record: Optional[list] = None,
            query_every: int = 0, per: str = "min") -> tuple:
    """Feed a `matrix_tape` through `app` (an aggregation on `Trades`) on
    `device`, flush by flush (`send_batch`, `flush()`, timed on the host
    clock around work that ends in `torch.cuda.synchronize()` on a card);
    after every `query_every` flushes one `rt.query(matrix_query(per))`,
    timed alone.  Returns (ms per flush, ms per store query, the store
    queries' rows, runtime)."""
    from .core.runtime import SiddhiManager
    rt = SiddhiManager(device=device).create_app_runtime(app)
    grouped = bool(rt.aggregations["Roll"].group_attrs)
    if record is not None:
        for agg in rt.aggregations.values():
            agg.record = record
            if agg.device_plan is not None:
                agg.device_plan.record = record
    h = rt.input_handler("Trades")
    per_flush, qlat, qrows = [], [], []
    for i, (cols, ts) in enumerate(tape):
        t0 = time.perf_counter()
        h.send_batch(cols, ts)
        rt.flush()
        if device == "cuda":
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
        if query_every and (i + 1) % query_every == 0:
            t0 = time.perf_counter()
            qrows.append(rt.query(matrix_query(per, grouped)))
            qlat.append((time.perf_counter() - t0) * 1e3)
    return per_flush, qlat, qrows, rt


def agg_rows(rt) -> dict:
    """The matrix query's rows per sec, min and hour, in query order."""
    grouped = bool(rt.aggregations["Roll"].group_attrs)
    return {per: rt.query(matrix_query(per, grouped)) for per in MATRIX_PERS}


# ---------------------------------------------------------------------------
# kernel against plain
# ---------------------------------------------------------------------------

class KernelMismatch(AssertionError):
    """A kernel differs from its plain version."""


def same(a, b) -> bool:
    """Equal dtype, shape and values, NaN equal to NaN."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and \
            torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


def max_err(a, b) -> float:
    """Largest |a - b| over the entries finite in both (0 when none)."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0


def _flat(res) -> list:
    """A kernel's result as a flat list of tensors (or None)."""
    if res is None or hasattr(res, "dtype"):
        return [res]
    return [t for r in res for t in _flat(r)]


def _agree(err: dict, key: str, got, want, what: str) -> None:
    """Record |got - want| under `key`, raising on any difference."""
    g, w = _flat(got), _flat(want)
    if len(g) != len(w) or not all(same(x, y) for x, y in zip(g, w)):
        raise KernelMismatch(f"{key} differs from its plain version "
                             f"({what})")
    e = max([max_err(x, y) for x, y in zip(g, w)
             if x is not None and x.numel()] or [0.0])
    err[key] = max(err.get(key, 0.0), e)


def check_window_calls(calls: list) -> dict:
    """K1 (window uses), K6, K7 and K8 against their plain versions on
    every call a window run recorded, tolerance 0 (NaN equal to NaN);
    returns the largest |kernel - plain| per kernel name or K1 use."""
    from .core.window_device import KERNELS
    from .kernels.expr_eval import expr_eval_plain
    from .kernels.win_compact import win_compact_plain
    from .kernels.win_range import win_range_plain
    from .kernels.win_scan import win_scan_plain
    plain = {"win_scan": win_scan_plain, "win_range": win_range_plain,
             "win_compact": win_compact_plain}
    err: dict = {}
    for j, (name, a, kw) in enumerate(calls):
        got = KERNELS[name](*a, **kw)
        if name == "expr_eval":
            key = f"expr_eval:{kw['use']}"
            want = expr_eval_plain(*a)
        else:
            key = name
            want = plain[name](*a, **kw)
        torch.cuda.synchronize()
        _agree(err, key, got, want, f"call {j}")
    return err


def check_agg_calls(calls: list) -> dict:
    """K10 `agg_merge` (each from its recorded pre-state, kernel and plain
    version on copies of it) and K6 use `agg` against their plain versions
    on every call an aggregation run recorded, tolerance 0 (NaN equal to
    NaN); returns the largest |kernel - plain| per kernel use."""
    from .kernels.agg_merge import agg_merge, agg_merge_plain
    from .kernels.win_scan import win_scan, win_scan_plain
    err: dict = {}
    for j, (name, a, kw) in enumerate(calls):
        if name == "agg_merge":
            got = agg_merge(a[0].clone(), *a[1:], **kw)
            want = agg_merge_plain(a[0].clone(), *a[1:], **kw)
            key = "agg_merge"
        else:
            got = win_scan(*a, **kw)
            want = win_scan_plain(*a, flags=kw["flags"])
            key = "win_scan:agg"
        torch.cuda.synchronize()
        _agree(err, key, got, want, f"call {j}")
    return err


def check_join_calls(calls: list) -> dict:
    """K1 `join_filter` and K9 against their plain versions on every call
    a join run recorded, tolerance 0; returns the largest |kernel - plain|
    per kernel use plus "pairs", the pair totals K9 reported."""
    from .core.join_device import KERNELS
    from .kernels.expr_eval import expr_eval_plain
    from .kernels.join_probe import join_probe_plain
    err: dict = {"pairs": 0}
    for j, (name, a, kw) in enumerate(calls):
        got = KERNELS[name](*a, **kw)
        if name == "expr_eval":
            key = f"expr_eval:{kw['use']}"
            want = expr_eval_plain(*a)
        else:
            key = name
            want = join_probe_plain(*a, **kw)
            err["pairs"] += int(want[0][0])
        torch.cuda.synchronize()
        _agree(err, key, got, want, f"call {j}")
    return err


def sorted_rows(kern, out: dict) -> torch.Tensor:
    """The match rows of an NFAKernel table in (completion seq, head seq,
    lane) order."""
    n = min(int(out["meta"][0]), out["out_i"].shape[1])
    rows = torch.cat([out["out_i"][:, :n].double(),
                      out["out_f"][:, :n].double(),
                      out["out_l"][:, :n].double()])
    order = torch.arange(n, device=rows.device)
    for name in ("__qid__", "__head_seq__", "__comp_seq__"):
        if name in kern.lane_names_i:
            r = rows[kern.lane_names_i.index(name)]
            order = order[torch.argsort(r[order], stable=True)]
    return rows[:, order]


def _check_select(err: dict, nfak, out: dict, n: int, base_ts) -> None:
    """K1 selector and `having` over a match table."""
    from .kernels.expr_eval import expr_eval_plain
    hw, sel = nfak.select(out, n, base_ts)
    hp, selp = expr_eval_plain(nfak.select_cols(out), nfak.having_prog,
                               nfak.sel_progs, n, {"__base_ts__": base_ts},
                               nfak.select_rows(out))
    _agree(err, "expr_eval:select", [hw] + list(sel), [hp] + list(selp),
           "selector")


def _check_pre(err: dict, progs: list, pre: list, cols: list, n: int,
               rows, base_ts) -> None:
    from .kernels.expr_eval import expr_eval_plain
    for w, pr in zip(pre, progs):
        if pr is not None:
            _agree(err, "expr_eval:pre_mask", w, expr_eval_plain(
                cols, pr, [], n, {"__base_ts__": base_ts}, rows)[0],
                "pre-mask")


def block_masks(kern, ev: dict, pre: list) -> list:
    """K2's plain-version masks from pre-mask words: (T, P) grids, or the
    F flat events of a chunk block."""
    from .kernels.expr_eval import unpack_mask
    n = ev["__ts__"].shape[0]
    if "__chunk__" in ev:
        return [None if w is None else unpack_mask(w, n) for w in pre]
    return [None if w is None else unpack_mask(w, n * kern.P).view(
        n, kern.P) for w in pre]


def check_seq_block(kern, state: dict, ev: dict, M: int) -> dict:
    """K1 pre-masks, K2 (new state, meta and sorted match rows) and K1's
    selector on one `seq` (or `chunk`) block, against their plain
    versions; returns {use: largest |kernel - plain|} plus "matches" and
    "lost" (direct emissions that found no lane, K2's meta[3])."""
    from .kernels.nfa_block import nfa_block, nfa_block_plain
    n_pre = ev["__ts__"].shape[0] * (1 if "__chunk__" in ev else kern.P)
    err: dict = {}
    pre = kern.pre_masks(ev)
    _check_pre(err, kern.pre_progs, pre, kern.pre_mask_cols(ev), n_pre,
               kern.pre_mask_rows(ev), ev["__base_ts__"])
    new_k, out_k = nfa_block(kern, state, ev, pre, M)
    new_p, out_p = nfa_block_plain(kern, state, ev,
                                   block_masks(kern, ev, pre), M)
    torch.cuda.synchronize()
    for key in new_p:
        _agree(err, "nfa_block", new_k[key], new_p[key], f"state {key}")
    _agree(err, "nfa_block", out_k["meta"], out_p["meta"], "meta")
    n = int(out_k["meta"][0])
    if n <= M:       # past M, which matches fill the table is append order
        _agree(err, "nfa_block", sorted_rows(kern, out_k),
               sorted_rows(kern, out_p), "match rows")
        _check_select(err, kern, out_k, n, ev["__base_ts__"])
    err["matches"] = n
    err["lost"] = int(out_k["meta"][3])
    return err


def check_chunk_block(kern, ev: dict, M: int) -> dict:
    """check_seq_block on a `chunk` block (flat events, `__chunk__`), from
    the fresh slot state every chunk block starts from."""
    if "__chunk__" not in ev:
        raise ValueError("not a chunk block")
    return check_seq_block(kern, kern.init_state(ev["__ts__"].device), ev,
                           M)


def scan_inputs(k, ev: dict, pre: list) -> tuple:
    """The node masks and K6's rank and prev columns of one `scan` block
    (plain versions), and its rank-column dict for K3."""
    from .kernels.seg_tree import node_masks
    from .kernels.win_scan import win_scan_plain
    masks = node_masks(k, ev, pre)
    L, F = masks[0].shape
    ranks, prevs = [
        [r.view(L, F) for r in win_scan_plain(cols, L * F, period=F)]
        if cols else []
        for cols in (k.rank_cols(masks), k.prev_cols(masks))]
    return masks, ranks, prevs, {f"__rank.{ci}": r
                                 for ci, r in enumerate(ranks)}


def check_scan_block(k, ev: dict, M: int) -> dict:
    """K1 pre-masks, K3 (event trees), K6 (ranks, prev pointers), K3 (rank
    trees), K4, K5 and K1's selector on one `scan` block, each kernel on
    the same inputs as its plain version (the plain results feed the next
    stage); returns {use: largest |kernel - plain|} plus "matches".  On a
    `dfa` block, K11's tables and K4's lookup mode too."""
    from .kernels.dfa_tables import dfa_tables, dfa_tables_plain
    from .kernels.scan_chase import scan_chase, scan_chase_plain
    from .kernels.scan_compact import scan_compact, scan_compact_plain
    from .kernels.seg_tree import seg_tree, seg_tree_plain
    from .kernels.win_scan import win_scan
    err: dict = {}
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    pre = k.pre_masks(ev)
    _check_pre(err, k.nfak.pre_progs, pre, k.pre_mask_cols(ev), L * F,
               k.pre_mask_rows(ev), ev["__base_ts__"])
    masks, ranks, prevs, rcols = scan_inputs(k, ev, pre)
    heaps = seg_tree_plain(k, ev, masks)
    _agree(err, "seg_tree", seg_tree(k, ev, pre), heaps, "heaps")
    for use, cols, want in (("rank", k.rank_cols(masks), ranks),
                            ("prev", k.prev_cols(masks), prevs)):
        if cols:
            _agree(err, f"win_scan:{use}", [r.view(L, F) for r in win_scan(
                cols, L * F, use=use, period=F)], want, use)
    rheaps = seg_tree_plain(k, ev, masks, k.rank_trees, rcols)
    if rheaps:
        _agree(err, "seg_tree:rank", seg_tree(k, ev, pre, k.rank_trees,
                                              rcols), rheaps, "rank trees")
    tables, use = None, "scan_chase"
    if k.dfa_nodes:
        tables = dfa_tables_plain([masks[gi] for gi in k.dfa_nodes])
        _agree(err, "dfa_tables", dfa_tables(k, ev, pre), tables, "tables")
        use = "scan_chase:dfa"
    chase = scan_chase_plain(k, ev, masks, heaps, ranks, rheaps, prevs,
                             tables)
    _agree(err, use, scan_chase(k, ev, pre, heaps, ranks, rheaps, prevs,
                                tables), chase, "chase")
    out_p = scan_compact_plain(k, ev, chase, ranks, rheaps, M)
    out_k = scan_compact(k, ev, chase, ranks, rheaps, M)
    torch.cuda.synchronize()
    n = int(out_p["meta"][0])
    _agree(err, "scan_compact", [out_k[key] for key in ("meta", "lane_n",
                                                        "arm")],
           [out_p[key] for key in ("meta", "lane_n", "arm")], "counts")
    _agree(err, "scan_compact", [out_k[key][:, :n] for key in
                                 ("out_i", "out_f", "out_l")],
           [out_p[key][:, :n] for key in ("out_i", "out_f", "out_l")],
           "match table")
    _check_select(err, k.nfak, out_k, n, ev["__base_ts__"])
    err["matches"] = n
    return err


def check_dfa_block(k, ev: dict, M: int) -> dict:
    """check_scan_block on a `dfa` block: K11 and K4's lookup mode held to
    their plain versions with the rest of the block."""
    if k.family != "dfa" or not k.dfa_nodes:
        raise ValueError("not a dfa block")
    return check_scan_block(k, ev, M)
