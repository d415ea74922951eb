#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (siddhi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit);
  2. build every kernel from siddhi_tpu_torch/csrc (one nvcc per source,
     all at once), timed;
  3. K1 expr_eval vs its plain version at N = 2^18 rows: C1's filter,
     integer arithmetic with truncating / and %, string equality,
     and/or/not, float32-mode arithmetic -- masks and columns equal; the
     mask programs together in one launch (expr_masks) -- words equal;
  4. the main path, BASELINE config 4 (partitioned 3-step pattern) at
     default settings, which run the `scan` family: 4 flushes of 2^18
     events over 1000 keys through SiddhiManager(device="cuda")
     send_batch, with the launch counts set to 0 just before and read
     just after (K3, K4, K5 and K1 launched, K2 not); every block the
     plan hands ParallelChainKernel.run_block is recorded.  The same tape
     through device="cpu" (the plain versions) must give equal rows;
     events/s and ms per flush;
  5. K3 seg_tree, K4 scan_chase, K5 scan_compact and K1 (pre-masks,
     selector) against their plain versions on the recorded blocks:
     heaps, chase status and indices, match tables equal; K1's pre-masks
     timed a launch (every pre-mask program of the block in one launch)
     and a program;
  6. config 3 unpartitioned (bench.py's C3 text): 2 flushes of 2^18
     events through the flat `scan` block (a 2^19-leaf tree), counted,
     recorded, checked against the CPU run and phase 5's comparisons;
  7. config 4 with @app:patternFamily('seq') (the K2 path): 2 flushes,
     counted, checked against the CPU run, and K2 and K1 against their
     plain versions on its recorded blocks: new state, sorted match rows,
     masks and selector columns equal;
  8. config 1 (filter) at 2^20 events, run and checked the same way, and
     K1 on its filter program against the plain version;
  9. config 5 (bench.py's c5_app(1000): 1000 mixed pattern/sequence
     queries with `not ... for` and `within`, four fused plans of 250
     lanes, families scan/seq/seq/scan): 2 flushes of 2^13 events 50 ms
     apart, then set_time 1 s past the last event, counted (K1-K5 all
     launched) and checked against the CPU run; a second run of the same
     app on the tape's first events leaves deadlines pending for
     set_time's timer ticks; K1-K5 against their plain versions on every
     block both runs recorded (K2 blocks with fired deadlines and tick
     blocks required); ms per flush, events/s and query-events/s; the
     trees K3 built against lanes x trees (a `scan` group's lane-invariant
     trees are built once and read by K4 at lane stride 0);
 10. config 2 (bench.py's C2: `#window.length(1000) select avg(price)`),
     2 flushes of 2^17 events over 8 symbols, counted (K1 `window_args`
     and `window_select`, K6 win_scan, K7 win_range, K8 win_compact) and
     recorded (every kernel call of the window plan, through its `record`
     hook), rows equal to the CPU run and `ap` equal to the exact f64
     sliding mean rounded to f32; every recorded call of K1, K6-K8 equal
     to its plain version (K8's outputs and k bit for bit, and one kernel
     launch a call, read from its launcher); then a timing run, not
     recorded, of 8 flushes: the median ms of its 7 steady flushes and
     events/s from it; K8's figures on the widest call of phases 10-12
     each (C2's without a mask, the others masked);
 11. the grouped, filtered `time(10 sec)` window with min/max/avg/count
     and `having` (its carry grows from 1024 slots through the overflow
     retry), checked the same way;
 12. C2B (bench.py: `externalTimeBatch(et, 64)` grouped, et = arrival
     time), the tumbling path (K6 segmented, no K7), checked the same way;
 13. C4N (`every e1=S[price > 110]<1:3> -> e2=S[price < 95] within 1
     sec`, selecting e1[0], e1[last], e2), 4 flushes on its default
     `scan` family: K1, K3 (event trees and `rank` trees), K6 `rank`
     (occurrence ranks on the lane grid), K4 (rank/select), K5 (count
     captures) launched, K2 not;
 14. C4Ns (`e2=S[price > e1.price]<2:4>`, selecting e2[0] and e2[last]),
     2 flushes on `seq` (the JAX package's family for it): K1 and K2's
     count path;
 15. C4A (`e2=S[price < 95] and e3=S[volume > 990]`), 2 flushes on
     `scan`: K6 `prev` (prev-match pointers) besides K1, K3-K5;
 16. C4O (the same with `or`), 2 flushes with @app:patternFamily('seq'):
     K2's logical path, rows with NULL in e3.volume; phases 13-16 at C4's
     shape (1000 keys, 2^18 events a flush), each counted, recorded and
     checked like phase 4 (rows equal to the CPU run with NULLs in place,
     every recorded block's kernels equal to their plain versions);
 17. J6, bench.py's config 6 (`JOIN_APP`: two length windows of 1024,
     1000 keys, `a.symbol == b.symbol and a.price > b.price`) on its own
     tape (seed 0, each flush 2048 events to L, then 2048 to R, one
     `send_batch` each): 8 flushes of 4096 events, K9 `join_probe`
     launched in both directions every flush, K1 `join_filter` not;
 18. J6W: the same app, 2 flushes of 2^17 events (2^16 a side);
 19. J6O: a filtered full outer join with a computed column (K1
     `join_filter`, both miss words, NULL `tot`/`bv` rows), 2 flushes;
 20. J6U: a windowless unidirectional side (K9 for left probes only), 2
     flushes; phases 17-20 each counted (launch counts from 0 just before,
     read just after), recorded (every K1/K9 call of the plan), rows equal
     to the CPU run in order with NULLs in place, every recorded call equal
     to its plain version, then an unrecorded timing run (ms per flush,
     the median of the steady flushes, events/s from it); K9's kernel
     launches a call (every call of the counted run: 1, 2 under an
     opposite filter), and on its widest call its probes a tile and
     window positions a chunk (from the counted run's parameter blocks)
     and pair tests;
 22. A7, bench.py's aggregation matrix (`--matrix`: `_matrix_app`,
     `_matrix_tape` seed 13, `rollup_k1024`; replay.MATRIX_APP: sum(p * v),
     avg(p), min(p), max(p), count() group by sym at sec, min, hour) at
     full scale: 24 flushes of 4096 events over 1024 keys through the
     device-resident rings, K10 `agg_merge` launched 3 times a flush (K6
     `agg` not), the sec ring grown past 1024 slots; every K10 call
     recorded with the ring's state before it; stores and the store
     query's rows per sec, min and hour equal to the CPU run; every
     recorded call equal to its plain version; then an unrecorded timing
     run (the median of the steady flushes, events/s);
 23. A7W: the same app, 4 flushes of 2^17 events;
 24. A7G: the same selector without `group by` (a global rollup: a
     2^17-event segment a flush, K10's serial chain), 4 flushes of 2^17;
 25. A7M: A7 with `rt.query(matrix_query("min"))` after every flush (the
     `mixed` cell): every query's rows equal to the CPU run's, store-query
     p50 and p99 ms (p99 of 24 is their maximum, so it is also given
     without the first query, which compiles it);
 26. A7A: A7W's tape under @app:deviceAggregations('always'), 2 flushes:
     K6 `agg` 3 times a flush (K10 not), stores and rows equal to the CPU
     run, every recorded K6 call equal to its plain version;
 27. C4H (`every not S[price > 128] for 3 sec -> e2=S[price < 92] within
     10 sec`): init slots armed per key, the deadline pre-pass forking a
     clone every quiet period (K2's EXT instantiation, `nfa_block:ext`);
 28. C4Z (`e1=S[price > 125]<0:3> -> e2=S[price < 92]`, selecting
     e1[0].price and `e1 is null`): a min-0 count head, rows with NULL
     p10 and `none` true required;
 29. C4F (`every e1 -> every e2=S[price < 100] -> e3=S[price >
     e2.price]`) from @app:deviceSlots(4): the stream fork; A must end
     above 4 with a growth after clones that found no free slot (growths
     after dropped heads and after lost clones logged apart);
 30. C4L, an absent side of `or` (rows with `timed_out` true and false
     required) and of `and`; phases 27-30 at C4's shape under
     @app:playback, 2 flushes each, counted (K2 EXT and K1 launched, K2's
     other instantiations and K3-K5 not), recorded, rows equal to the CPU
     run in order with NULLs in place, every recorded block's K2 and K1
     equal to their plain versions; ms per flush, events/s, the final A;
     K2 timed at C4H, C4F and C4L `or` (the kernel line's entries);
 31. C3H, an unpartitioned absent head on the wall clock: `set_time` to
     the START anchor (the wakeup before the first block must be anchor
     + 100 ms), a tick arming the init slot (`__anchor__`), 2^13 events in
     one flush, `set_time` past them; rows equal to the CPU run, tick
     blocks among the recorded ones, each equal to the plain version;
 32. C3K, bench.py's C3 under @app:patternFamily('chunk') (8 keys, 2
     flushes of 2^17): K2 over K own-chunks of the flat flush with halo
     reads (`nfa_block:chunk`), K1 pre-masks and selector launched, K3-K5
     and K2's other launches not; K, CS, H, T and A logged (K = 64, T =
     4096 expected); rows equal to the CPU run and to the card's `seq`
     run of the same tape;
 33. C3X, a capture-dependent conjunction (`e2=S[price > e1.price and
     volume > e1.volume]`), which `scan` refuses and which runs `chunk`
     with no annotation: 2 flushes of 2^17;
 34. C3E, `every` below the head (K2's EXT step in chunk lanes: forks),
     `chunk` with no annotation: 2 flushes of 2^16; phases 32-34 each
     counted, recorded, rows equal to the CPU run in order, every block
     the plan kept equal to its plain version (K2 from fresh state, K1);
 35. C3SD, bench.py's static C3S under @app:patternFamily('dfa'): 2
     flushes of 2^18 over 8 keys; K11 `dfa_tables` and K4's `dfa` mode
     (`scan_chase:dfa`) launched with K1, K3 (the `within` killer's tree
     only: no mask tree for the chase node) and K5, K4's tree mode and
     K2 not; rows equal to the CPU run and to the card's `scan` run of the
     same tape, whose K3 and K4 are timed beside K11 and K4 `dfa`; K11's
     tiles a lane logged;
 36. C4D, C4's partitioned head (1000 keys) with a static hop and a
     threshold hop (`e2=S[price < 100] -> e3=S[price > e1.price]`) under
     @app:patternFamily('dfa'): K11 over the (L, F) lane grid; phases 35
     and 36 each counted, recorded, every block's kernels (K11 and K4
     `dfa` included) equal to their plain versions;
 37. C4F64, the f64 slice at full width: C4's deployment (1000 keys,
     deviceSlots(32), 4 flushes of 2^18 events 1 ms apart) under
     @app:devicePrecision('f64') on raw doubles 1e-6 apart
     (replay.raw_tape), its default `scan`: K3, K4 and K5 launched in
     their float64 forms (`seg_tree:f64`, `scan_chase:f64`,
     `scan_compact:f64`), K2 and the float32 forms not; rows equal to the
     CPU run's; the same tape through C4 in float32 on the card gives
     other rows; every recorded block's kernels equal to their plain
     versions; events/s and ms per flush;
 38-42. at a smaller depth, each on a raw-double tape in f64, counted,
     recorded, rows equal to the CPU run's in order, every recorded
     block's kernels equal to their plain versions: C4 on `seq` (K2's
     float64 chain instantiation, `nfa_block:f64`), C4F from
     deviceSlots(4) (EXT, `nfa_block:ext:f64`, A grown after lost
     clones), C4 `seq` at deviceSlots(256) (the wide instantiation, one
     flush of 2^17), C3K (`nfa_block:chunk:f64`, 2 flushes of 2^16) and
     C3SD (`dfa`, `scan_compact:f64`); K2 timed in each of the first
     four, beside its float32 instantiation on the same block's shapes
     (`f32_twin_ms`: the DOUBLE grids and capture rows cast to float32);
 43. C5's fused groups under f64 (c5_app(1000, frac=1e-6): the price
     constants DOUBLE literals, float64 lane parameters), one flush of
     2^13 raw-double events, then set_time: rows equal to the CPU run's,
     every recorded K2 and `scan` block equal to its plain versions;
 44. C2 under f64 on wide-range raw doubles (replay.wide_tape), 2
     flushes of 2^17: every row within the sum bound of the CPU run's
     (K6's float64 sums associate otherwise), the number of rows that
     differ logged; K1, K7, K8 equal to their plain versions on every
     recorded call, K6's sums within the bound, its other columns equal;
 45. the host matcher: C4 (1000 keys, deviceSlots(32)) and C3 under
     @app:devicePatterns('never') through SiddhiManager(device="cuda"),
     4 flushes of 2^15 events (phase 4's 2^18 a flush cut so the host
     runs end near a minute; keys and pattern kept): no kernel launched
     (C4: a PartitionGroup and one host clone a key), rows equal to the
     card's `scan` run on the same tape (sorted), which launches K1 and
     K3-K5; both runs' events/s; one more host flush under cProfile;
 46. replay.MIXED: C4's query on the device beside an `e[last-2]`
     selector and a `group by` aggregate (per-key host clones),
     `output every 5 events` (the host matcher) and a range-partitioned
     pattern (clones), 2 flushes of 2^13: each query planned where the
     routing puts it with one RuntimeWarning per host query, K1 and K3-K5
     launched and held to their plain versions on every recorded block,
     every query's rows equal to the device="cpu" run's;
 47. C1 under @app:deviceFilters('never') (2^18 events) equal to the
     card's K1 run, row for row; C2 under @app:deviceWindows('never') on
     phase 10's tape within rel 2e-5, abs 2e-4 of the device window
     plan's rows (the number that differ logged); no kernel launched by
     either host run; one more C2 host flush under cProfile; the host CPU
     model (lscpu) logged beside the card;
 21. (after 47) one JSON line {"kernels": [...]}, one entry per kernel and K1 use:
     launches on its path, error against the plain version, device time
     (a CUDA graph of 20 calls replayed, so the wrappers' host dispatch
     is not in it; that is `dispatch_ms`), plain time, bound and,
     where one PyTorch call computes the same function, that call's
     time, graph-timed like the kernels (K6's scans also
     `library_flat_ms`: a 1-D cumsum of the same entries and one
     subtraction, PyTorch's fastest form of that work); K10's entries
     also `chain_ms`,
     one thread doing the longest segment's dependent f64 adds from
     registers (the chain that bounds a global rollup); K2's entries also
     `step_ns` (device ns / T) and the event stage's `tt` and `wpb` (the
     steps a tile and warps a block its launch chose); the card's name
     and power limit; then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Every comparison has tolerance 0: the kernels are built with --fmad=false
and compute what the plain versions compute.  App texts, the tape and the
kernel-against-plain checks come from siddhi_tpu_torch/replay.py, shared
with the card tests.
Exits non-zero without a CUDA card, or when the package is not beside it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from siddhi_tpu_torch.replay import (  # noqa: E402  (the checkout's package)
    C1, C2, C2_GROUPED, C2B, C3, C3E, C3H, C3K, C3S, C3SD, C3X, C4, C4_HEAD,
    C4_SEQ, C4A, C4D, C4D_BODY, C4F, C4H, C4L_AND, C4L_OR, C4N, C4NS, C4O,
    C4Z, F64, JOIN_APP, JOIN_OUTER, JOIN_UNI, MATRIX_APP, MIXED,
    MIXED_QUERIES, NEVER, RAW_STEP, agg_rows,
    block_masks, c5_app, check_agg_calls, check_chunk_block, check_dfa_block,
    check_join_calls, join_tape, check_scan_block, check_seq_block,
    check_window_calls, make_tape, matrix_tape, max_err, mixed_placement,
    partitioned, raw_tape, run_mixed, scan_inputs, sorted_rows, wide_tape)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
PEAK_F64_OPS_PER_S = 34e12     # H100 SXM float64 outside the tensor cores

C2_FLUSH, C2_FLUSHES, C2_SYMBOLS = 1 << 17, 2, 8
C2_TIMED = 8            # flushes of the timing run (the first is not steady)
KEYS, FLUSH, N_FLUSH, C1_EVENTS = 1000, 1 << 18, 4, 1 << 20
SEQ_FLUSHES, C3_FLUSHES = 2, 2
# the host plans' phases: C4's and C3's 2^18 events a flush cut to 2^15
# (keys, flushes and the pattern kept) so that phase 45's host runs end
# near a minute; the mixed app at 2 flushes of 2^13 events; C1's 2^20
# events cut to 2^18 for its host run
HOST_FLUSH, MIXED_FLUSH, MIXED_FLUSHES, HOST_C1_EVENTS = \
    1 << 15, 1 << 13, 2, 1 << 18
# the host plans' functions whose cumulative ms cProfile reports
HOST_PATTERN_FNS = ("core/runtime.py:_drain", "core/partition.py:process",
                    "interp/engine.py:process", "interp/engine.py:finalize",
                    "interp/nfa.py:on_event", "interp/nfa.py:_eval",
                    "interp/nfa.py:env_of_captures",
                    "interp/engine.py:_matches_to_rows",
                    "interp/engine.py:rows_batch", "core/batch.py:rows")
HOST_SINGLE_FNS = ("core/runtime.py:_drain", "interp/engine.py:process",
                   "interp/engine.py:_run_selector",
                   "interp/windows.py:process",
                   "interp/engine.py:rows_batch", "core/batch.py:rows")
C5_QUERIES, C5_FLUSH, C5_FLUSHES, C5_DT, C5_SYMBOLS = 1000, 1 << 13, 2, 50, 8
# the pattern-algebra phases: (label, app, flushes, family, seed)
# (label, app, flushes, family, seed, kernel uses it must launch beyond
# its family's, the output column that must hold NULLs or None)
ALGEBRA = (("c4n", C4_HEAD + C4N, 4, "scan", 31,
            ("win_scan:rank", "seg_tree:rank"), None),
           ("c4ns", C4_HEAD + C4NS, 2, "seq", 32, (), None),
           ("c4a", C4_HEAD + C4A, 2, "scan", 33, ("win_scan:prev",), None),
           ("c4o", C4_SEQ + C4_HEAD + C4O, 2, "seq", 34, (), 2))
# the join phases: (label, app, events a flush, flushes, K1 join_filter
# launched, the sides that probe); bench.py's config 6 runs n = 2^15 at
# flushes of 4096 (`bench_join(n=1 << 15, batch=4096)`)
JOINS = (("j6", JOIN_APP, 1 << 12, 8, False, "LR"),
         ("j6w", JOIN_APP, 1 << 17, 2, False, "LR"),
         ("j6o", JOIN_OUTER, 1 << 12, 2, True, "LR"),
         ("j6u", JOIN_UNI, 1 << 12, 2, False, "L"))
JOIN_JAX = "siddhi_tpu/core/join_device.py"
# the aggregation phases (bench.py --matrix, `_matrix_app`/`_matrix_tape`,
# bench.py:2849-2904): (label, flushes, events a flush, group by, a store
# query after every flush, @app:deviceAggregations('always'))
AGGS = (("a7", 24, 1 << 12, True, False, False),
        ("a7w", 4, 1 << 17, True, False, False),
        ("a7g", 4, 1 << 17, False, False, False),
        ("a7m", 24, 1 << 12, True, True, False),
        ("a7a", 2, 1 << 17, True, False, True))
AGG_KEYS = 1024
AGG_JAX = "siddhi_tpu/core/agg_device.py"
# K2's EXT phases (init slots, forks, absent sides): (label, app, seed),
# each 2 flushes of C4's shape under @app:playback; C4F runs C4's head
# with 4 slots a lane in place of 32
EXT_FLUSHES = 2
EXT = (("c4h", C4_HEAD + C4H, 27), ("c4z", C4_HEAD + C4Z, 28),
       ("c4f", "@app:partitionCapacity(1000)\n" + C4F, 29),
       ("c4l_or", C4_HEAD + C4L_OR, 30), ("c4l_and", C4_HEAD + C4L_AND, 30))
C3H_EVENTS = 1 << 13
EXT_TIMED = ("c4h", "c4f", "c4l_or")   # K2 EXT's entries in the kernel line
# the stateless families: (label, app, events a flush, flushes, keys,
# seed, family, the app of the comparison run on the card: `seq` for
# C3K, `scan` for the dfa phases).  The slot count of a chunk lane is set
# to the A its retries reach on these tapes (C3K 32, C3X 64, C3E 128:
# `every e2` forks a clone per live head), so the CPU run does not repeat
# the growth retries
STATELESS = (
    ("c3k", "@app:deviceSlots(32)\n" + C3K, 1 << 17, 2, 8, 32, "chunk",
     C4_SEQ + C3),
    ("c3x", "@app:deviceSlots(64)\n" + C3X, 1 << 17, 2, 8, 33, "chunk",
     None),
    ("c3e", "@app:deviceSlots(128)\n" + C3E, 1 << 16, 2, 8, 34, "chunk",
     None),
    ("c3sd", C3SD, 1 << 18, 2, 8, 35, "dfa",
     "@app:patternFamily('scan')\n" + C3S),
    ("c4d", C4_HEAD + C4D, 1 << 18, 2, KEYS, 36, "dfa",
     C4_HEAD + partitioned(C4D_BODY)))
# the f64 phases (@app:devicePrecision('f64'), replay.F64) at a smaller
# depth than C4F64, each on a raw-double tape (replay.raw_tape): (label,
# app, events a flush, flushes, keys, seed, the tape's (lo, levels),
# family, the f64 kernel forms it must launch, K2 timed)
F64_PHASES = (
    ("c4 seq f64", F64 + C4_SEQ + C4_HEAD + C4, FLUSH, 2, KEYS, 38,
     (100.0, 3), "seq", ("nfa_block:f64",), True),
    ("c4f f64", F64 + "@app:partitionCapacity(1000)\n" + C4F, FLUSH, 2, KEYS,
     39, (90.0, 40), "seq", ("nfa_block:ext:f64",), True),
    ("c4 a256 f64", F64 + C4_SEQ + "@app:partitionCapacity(1000)\n"
     "@app:deviceSlots(256)\n" + C4, FLUSH // 2, 1, KEYS, 40, (100.0, 3),
     "seq", ("nfa_block:f64",), True),
    ("c3k f64", F64 + "@app:deviceSlots(32)\n" + C3K, 1 << 16, 2, 8, 41,
     (90.0, 40), "chunk", ("nfa_block:chunk:f64",), True),
    ("c3sd f64", F64 + C3SD, 1 << 18, 2, 8, 42, (90.0, 40), "dfa",
     ("dfa_tables", "scan_chase:dfa", "scan_compact:f64"), False))
# the float32 forms no f64 phase may launch
F32_FORMS = ("nfa_block", "nfa_block:ext", "nfa_block:chunk", "scan_compact")
SCAN_F64_K = ("seg_tree:f64", "scan_chase:f64", "scan_compact:f64")
CHUNK_K = ("nfa_block:chunk", "expr_eval:pre_mask", "expr_eval:select")
DFA_K = ("dfa_tables", "scan_chase:dfa", "seg_tree", "scan_compact",
         "expr_eval:pre_mask", "expr_eval:select")
SCAN_K = ("seg_tree", "scan_chase", "scan_compact", "expr_eval:pre_mask",
          "expr_eval:select")
SEQ_K = ("nfa_block", "expr_eval:pre_mask", "expr_eval:select")
EXT_K = ("nfa_block:ext", "expr_eval:pre_mask", "expr_eval:select")
K1_SRC = "siddhi_tpu_torch/csrc/expr_eval.cu"
CSRC = "siddhi_tpu_torch/csrc"
PAR = "siddhi_tpu/core/nfa_parallel.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def graph_ms(torch, call, prepare, reps: int = 20) -> tuple:
    """(device ms, host dispatch ms) per call of the wrapper `call`.  The
    device time replays `reps` rounds of the launches `prepare()` returns
    (the wrapper's kernel launches, their parameter tables uploaded
    beforehand: a graph cannot capture that copy) captured in one CUDA
    graph and timed with CUDA events, so the wrapper's Python, ctypes and
    table upload are not in it.  The host dispatch time is the wall clock
    of `reps` eager calls with no synchronisation inside."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    launches = prepare()
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for launch in launches:
                launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def library_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call of the PyTorch call `fn` (a yardstick, used
    nowhere in the port), timed as the kernels are: `reps` calls captured
    in one CUDA graph, replayed between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float, f64: bool = False) -> tuple:
    """(least ms, what bounds it) on the H100: bytes over HBM, operations
    over the float32 peak (the float64 one for a kernel in f64)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / (PEAK_F64_OPS_PER_S if f64 else PEAK_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def k1_work(torch, cols, mask_prog, out_progs, n: int, rows=None,
            masks=()) -> tuple:
    """(bytes, operations) K1 needs for rows [0, n): each column element a
    program loads read once (a broadcast or shared column once, not once
    per lane, nor once per program), each lane parameter once, each
    output and each program's mask words written once, one operation per
    row for each VM instruction other than a load, a parameter or a
    constant; `masks`: more mask programs of the same launch."""
    from siddhi_tpu_torch.core.expr import TORCH_OF_VT, decode_word
    loaded, qparams, ops = set(), False, 0
    for prog in [p for p in (mask_prog, *out_progs, *masks)
                 if p is not None]:
        for j in range(0, len(prog.words), 2):
            op = decode_word(prog.words[j])[0]
            if op == "load":
                loaded.add(prog.words[j + 1])
            elif op == "qparam":
                qparams = True
            elif op != "const":
                ops += n
    elems = n
    if rows is not None and (rows.col_mod or rows.col_div > 1):
        elems = rows.col_mod or -(-n // rows.col_div)
    nbytes = sum(elems * cols[s].element_size() for s in loaded)
    if qparams and rows is not None and rows.qparams is not None:
        nbytes += rows.qparams.bits.numel() * 8
    nbytes += sum(n * torch.empty(0, dtype=TORCH_OF_VT[p.vt]).element_size()
                  for p in out_progs)
    nbytes += -(-n // 32) * 4 * (int(mask_prog is not None) + len(masks))
    return nbytes, ops


def phase_k1(torch, np, n: int) -> float:
    """K1 against its plain version over seeded columns with edge values;
    returns the largest difference of a computed column (0 when equal)."""
    from siddhi_tpu_torch.core.expr import (F32_MODE, SingleStreamContext,
                                            compile_expression,
                                            compute_dtypes, emit_program)
    from siddhi_tpu_torch.core.schema import StreamSchema, StringTable
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval,
                                                    expr_eval_plain,
                                                    expr_masks,
                                                    expr_masks_plain)
    from siddhi_tpu_torch.query import ast, parse_expression
    rng = np.random.default_rng(1)
    T = ast.AttrType
    schema = StreamSchema("S", (ast.Attribute("symbol", T.STRING),
                                ast.Attribute("price", T.DOUBLE),
                                ast.Attribute("volume", T.INT),
                                ast.Attribute("big", T.LONG),
                                ast.Attribute("ratio", T.FLOAT),
                                ast.Attribute("flag", T.BOOL)))
    strings = StringTable()
    for i in range(16):
        strings.encode(f"K{i}")
    host = {"symbol": rng.integers(1, 17, n).astype(np.int32),
            "price": np.round(rng.uniform(90, 130, n) * 4) / 4,
            "volume": rng.integers(-1000, 1000, n).astype(np.int32),
            "big": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "ratio": rng.uniform(-3, 3, n).astype(np.float32),
            "flag": rng.integers(0, 2, n).astype(bool)}
    host["volume"][::97] = 0                    # divisors of zero
    host["big"][::89] = -1
    host["big"][0] = -2**63
    keys = sorted(host)
    cols = [torch.from_numpy(host[k]).cuda() for k in keys]
    ctx = SingleStreamContext(schema, strings)

    def prog(text, f32=False):
        ce = compile_expression(parse_expression(text), ctx)
        with compute_dtypes(F32_MODE if f32 else None):
            slots = {k: (i, {"symbol": 1, "price": 4, "volume": 1,
                             "big": 2, "ratio": 3, "flag": 0}[k])
                     for i, k in enumerate(keys)}
            return emit_program(ce.node, slots)
    cases = [
        ("price > 100", []),
        ("(price > 110 and volume < 500) or not (symbol != 'K7') or flag",
         ["volume / 7 + volume % 5 * 3", "big / volume - big % 3",
          "price * 2.5 - volume / 3.0", "ifThenElse(flag, big, volume)",
          "maximum(ratio, price)", "convert(price, 'int')"]),
        ("symbol == 'K3'", ["ratio * ratio + ratio"]),
    ]
    f32_outs = [prog("price * 2.5 - ratio / 3.0 + volume", f32=True),
                prog("ratio * 1.5 + price", f32=True)]
    err = 0.0
    for mask_text, out_texts in cases:
        mask_p = prog(mask_text)
        outs_p = [prog(t) for t in out_texts] + f32_outs
        w_k, o_k = expr_eval(cols, mask_p, outs_p, n, use="filter")
        w_p, o_p = expr_eval_plain(cols, mask_p, outs_p, n)
        torch.cuda.synchronize()
        if not torch.equal(w_k, w_p):
            raise SystemExit(f"K1 mask mismatch for {mask_text!r}")
        for t, a, b in zip(out_texts + ["f32a", "f32b"], o_k, o_p):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise SystemExit(f"K1 output mismatch for {t!r}")
            if a.dtype != torch.bool:
                err = max(err, float((a.double() - b.double()).abs().max()))
        log(f"  K1 {mask_text!r} + {len(outs_p)} outputs: equal")
    # every case's mask program in one launch (a block's pre-masks)
    masks = [prog(text) for text, _outs in cases]
    got = expr_masks(cols, masks, n, use="pre_mask")
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            got, expr_masks_plain(cols, masks, n))):
        raise SystemExit("K1 masks of one launch differ from the plain "
                         "version's")
    log(f"  K1 {len(masks)} mask programs in one launch: equal")
    return err


def run_app(pkg, np, app: str, tape, keys: int, device: str, stream="Out"):
    """Feed the tape flush by flush through the public facade; matches
    arrive as columnar batches (the bench's way: no per-row decode inside
    the timed region) and are decoded to rows afterwards."""
    mgr = pkg.SiddhiManager(device=device)
    rt = mgr.create_app_runtime(app)
    batches = []
    rt.add_batch_callback(stream, batches.append)
    h = rt.input_handler("StockStream")
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    per_flush = []
    for f in tape:
        t0 = time.perf_counter()
        h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                      "volume": f["volume"]}, f["ts"])
        rt.flush()
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        per_flush.append((time.perf_counter() - t0) * 1e3)
    out = [(int(t), row) for b in batches
           for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return out, per_flush, rt


# id of a recorded `scan` block's event grid -> the parameter blocks of
# the K1 pre-mask, K3, K4, K11 and K5 launches the main path made on that
# block (`run_scan_block`): the geometry the kernel line reports
MAIN_PARAMS: dict = {}
K34_COUNTERS = ("seg_tree", "seg_tree:f64", "seg_tree:rank", "scan_chase",
                "scan_chase:f64", "scan_chase:dfa", "scan_chase:dfa:f64")
RECORDED = ("expr_eval:pre_mask", "dfa_tables", "scan_compact",
            "scan_compact:f64") + K34_COUNTERS


def run_scan_block(run_scan, kern, ev, M):
    """ParallelChainKernel.run_block as the plan calls it, keeping in
    MAIN_PARAMS the parameter blocks of the K1 pre-mask, K3, K4, K11 and
    K5 launches it made (kernels.PARAMS, recorded while a run's launches
    count)."""
    from siddhi_tpu_torch import kernels
    seen = {c: len(kernels.PARAMS.get(c, ())) for c in RECORDED}
    out = run_scan(kern, ev, M)
    MAIN_PARAMS[id(ev)] = {c: kernels.PARAMS.get(c, [])[seen[c]:]
                           for c in RECORDED}
    return out


def main_params(label: str, ev: dict, counter: str, want: int):
    """The parameter block of the one launch under `counter` the main
    path made on the block of `ev`, holding `want` programs (K1)."""
    got = MAIN_PARAMS.get(id(ev), {}).get(counter, [])
    if len(got) != 1 or (want and got[0].n_progs != want):
        raise SystemExit(f"[{label}] {len(got)} {counter} launches on the "
                         f"block (one of {want or 'its'} programs wanted)")
    return got[0]


def k34_main(label: str, kern, ev: dict) -> dict:
    """What the main path's K3 and K4 launches on the block of `ev` used,
    read from their own parameter blocks (`main_params`): K3's kernel
    launches, blocks and building warps and the trees it built against
    lanes x trees (its rank trees' launches apart), K4's blocks, threads
    a block, shared bytes a block and kernel launches.  Raises where a launcher launched other than it should (K3
    a kernel per 10 tree levels, K4 one)."""
    from siddhi_tpu_torch.core.expr import VT_F64
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    Lt = kern.leaves(F)
    out: dict = {}
    passes = -(-(Lt.bit_length() - 1) // 10)
    for key, trees, counter in (
            ("k3", kern.trees, "seg_tree:f64" if any(
                t.vt == VT_F64 for t in kern.trees) else "seg_tree"),
            ("k3_rank", kern.rank_trees, "seg_tree:rank")):
        if not trees:
            continue
        p = main_params(label, ev, counter, 0)
        if p.launched != passes:
            raise SystemExit(f"[{label}] K3 launched {p.launched} kernels "
                             f"for Lt={Lt}, {passes} wanted")
        out[key] = {"launches_a_call": p.launched, "blocks": p.blocks,
                    "warps": p.warps, "trees_built": p.lane_trees,
                    "lanes_x_trees": L * p.n_trees}
    f64 = any(t.vt == VT_F64 for t in kern.trees)
    counter = "scan_chase" + (":dfa" if kern.dfa_nodes else "") + (
        ":f64" if f64 else "")
    p = main_params(label, ev, counter, 0)
    if p.launched != 1:
        raise SystemExit(f"[{label}] K4 launched {p.launched} kernels")
    out["k4"] = {"launches_a_call": p.launched, "blocks": p.blocks,
                 "threads": p.threads, "smem_bytes": p.smem,
                 "compact": bool(p.compact)}
    return out


def k34_line(g: dict) -> str:
    """k34_main's geometry as a log line."""
    parts = [f"{key} {v['launches_a_call']} launch(es), first launch "
             f"{v['blocks']} blocks, {v['warps']} warps building, "
             f"{v['trees_built']} trees built of {v['lanes_x_trees']} "
             f"lanes x trees" for key, v in g.items() if key != "k4"]
    k4 = g["k4"]
    parts.append(
        f"K4 {k4['launches_a_call']} launch, {k4['blocks']} blocks of "
        f"{k4['threads']} threads, {k4['smem_bytes']} shared bytes a block, "
        + ("compacted live heads" if k4["compact"] else "a thread a head"))
    return "; ".join(parts)


def run_c5(pkg, np, tape, device: str, record: bool = False, app=None):
    """Config 5 through the facade: the tape flush by flush, then
    `set_time` 1 s past its last event, launch counts from 0 just before
    the first flush and read just after `set_time`.  Returns (rows as
    (stream, ts, row) in arrival order, ms per flush, set_time ms,
    launches, runtime, recorded `seq` blocks, recorded `scan` blocks); a
    recorded block is what the plan handed NFAKernel.run_block (kernel,
    state in, event grid, M, meta) or ParallelChainKernel.run_block
    (kernel, event grid, M), recording launching nothing.  `app`
    replaces c5_app(C5_QUERIES)."""
    import torch
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    seq_blocks, scan_blocks = [], []
    run_seq, run_scan = NFAKernel.run_block, ParallelChainKernel.run_block

    def rec_seq(kern, state, ev, M):
        new, out = run_seq(kern, state, ev, M)
        seq_blocks.append((kern, state, ev, M, out["meta"]))
        return new, out

    def rec_scan(kern, ev, M):
        scan_blocks.append((kern, ev, M))
        return run_scan_block(run_scan, kern, ev, M)
    if record:
        NFAKernel.run_block, ParallelChainKernel.run_block = rec_seq, rec_scan
    try:
        rt = pkg.SiddhiManager(device=device).create_app_runtime(
            app or c5_app(C5_QUERIES))
        batches = []
        for j in range(16):
            rt.add_batch_callback(f"Out{j}",
                                  lambda b, j=j: batches.append((j, b)))
        h = rt.input_handler("StockStream")
        codes = np.array([rt.strings.encode(f"K{i}")
                          for i in range(C5_SYMBOLS)], dtype=np.int32)

        def sync():
            if device == "cuda":
                torch.cuda.synchronize()
        kernels.reset_launches()
        kernels.record_params(*RECORDED)
        per_flush = []
        for f in tape:
            t0 = time.perf_counter()
            h.send_batch({"symbol": codes[f["sym_idx"]], "price": f["price"],
                          "volume": f["volume"]}, f["ts"])
            rt.flush()
            sync()
            per_flush.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rt.set_time(int(tape[-1]["ts"][-1]) + 1000)
        sync()
        set_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
    finally:
        NFAKernel.run_block, ParallelChainKernel.run_block = run_seq, run_scan
        kernels.record_params()
    rows = [(j, int(t), row) for j, b in batches
            for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return rows, per_flush, set_ms, launches, rt, seq_blocks, scan_blocks


def check_c5_rows(label: str, dev_out: list, ref_out: list) -> None:
    """Equal to the CPU run, stream by stream in arrival order, and true
    to each shape (stream j carries queries of shape j % 4)."""
    if dev_out != ref_out or not dev_out:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(dev_out)} vs {len(ref_out)}")
    for j, _ts, row in dev_out:
        ok = row[0] > 124 if j % 4 == 2 else (row[0] > 123 and
                                             row[1] > row[0])
        if not ok:
            raise SystemExit(f"{label} row of Out{j} breaks its pattern: "
                             f"{row}")


def phase_c5(torch, np, pkg) -> dict:
    """Config 5 at 1000 queries (four fused plans of 250 lanes) on the
    card and on the CPU, then every kernel against its plain version on
    the blocks the card run recorded.  The tape resolves every one-shot
    `not ... for` lane within its first seconds, so the final `set_time`
    finds no deadline left; the timer-tick blocks come from the same app
    on the tape's first events up to the first such lane's arming, one
    flush and a `set_time` (its rows, too, equal the CPU run's)."""
    tape = make_tape(C5_FLUSH * C5_FLUSHES, C5_FLUSH, C5_SYMBOLS,
                     seed=5, dt_ms=C5_DT)
    rows, per_flush, set_ms, launches, rt, seq_b, scan_b = run_c5(
        pkg, np, tape, "cuda", record=True)
    plans = rt.plans()
    fams = [getattr(p, "family", None) for p in plans]
    if [getattr(p, "n_queries", 0) for p in plans] != [250] * 4 or \
            fams != ["scan", "seq", "seq", "scan"]:
        raise SystemExit(f"C5 planned {[(p.name, f) for p, f in zip(plans, fams)]}")
    need_launches("C5", launches, ("expr_eval:pre_mask", "expr_eval:select",
                                   "nfa_block", "seg_tree", "scan_chase",
                                   "scan_compact"))
    ref, cpu_flush, _s, _l, _rt, _b, _c = run_c5(pkg, np, tape, "cpu")
    check_c5_rows("C5", rows, ref)
    steady = per_flush[1:]
    eps = C5_FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c5] {len(rows)} rows equal to the CPU run; families {fams}; "
        f"launches {launches}; per flush ms "
        f"{[round(x, 1) for x in per_flush]}, set_time {set_ms:.1f} ms (cpu "
        f"{[round(x) for x in cpu_flush]})")
    log(f"[c5] {eps:.0f} events/s, {eps * C5_QUERIES:.0f} query-events/s "
        f"over the {len(steady)} steady flushes of {C5_FLUSH} events")

    # the tick run: first lane of shape 2 arms on the first price > 124
    first = int(np.flatnonzero(tape[0]["price"] > 124)[0]) + 1
    prefix = [{k: v[:first] for k, v in tape[0].items()}]
    t_rows, _f, _s, _l, _rt, t_seq, _t = run_c5(pkg, np, prefix, "cuda",
                                                record=True)
    t_ref = run_c5(pkg, np, prefix, "cpu")[0]
    check_c5_rows("C5 tick run", t_rows, t_ref)
    log(f"[c5 ticks] {first} events, then set_time: {len(t_rows)} rows "
        f"equal to the CPU run")

    # K2 is timed on the last block: the absent group's widest
    blocks = sorted(seq_b + t_seq, key=lambda b: (b[0].has_absent,
                                                  b[2]["__ts__"].shape[0]))
    k2 = phase_blocks(torch, blocks, "c5 seq")
    if not k2["fired_blocks"] or not k2["tick_blocks"]:
        raise SystemExit(f"C5 K2 blocks: {k2['fired_blocks']} with fired "
                         f"deadlines, {k2['tick_blocks']} ticks")
    scan = phase_scan_blocks(torch, scan_b, "c5")
    return {"rows": len(rows), "ms_per_flush": per_flush,
            "set_time_ms": set_ms, "cpu_ms_per_flush": cpu_flush,
            "events_per_s": eps, "query_events_per_s": eps * C5_QUERIES,
            "launches": launches, "k2": k2, "scan": scan,
            "tick_rows": len(t_rows)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def distinct(*tensors) -> list:
    """The tensors without repeats (by address): a column that reaches a
    kernel through two arguments is read once."""
    seen: set = set()
    out = []
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append(t)
    return out


def merge_err(total: dict, err: dict) -> None:
    for key, v in err.items():
        if key not in ("matches", "lost"):
            total[key] = max(total.get(key, 0.0), v)


_DESCENTS = {"static": 2, "threshold": 2, "count": 2, "logical": 3,
             "strict": 0}


def k3_read_bytes(kern, ev: dict, pre: list, F: int) -> int:
    """The bytes K3 reads building a block's trees, each once: the leaf
    columns, the lane counts and the pre-mask words of the trees' gating
    nodes -- lane 0's (its first ceil(F/32) words) and its count alone
    where only trees the plan marks shared read them (seg_tree.prepare
    passes pre[t.node]; a shared tree is built from lane 0)."""
    srcs = {t.src for t in kern.trees if t.src is not None}
    nb = nbytes(*[ev[c] for c in srcs])
    nev = ev["__nev__"]
    nb += nbytes(nev) if any(not t.shared for t in kern.trees) else \
        nev.element_size()
    only_shared: dict = {}
    for t in kern.trees:
        if t.node is not None and pre[t.node] is not None:
            only_shared[t.node] = only_shared.get(t.node, True) and t.shared
    for node, lane0 in only_shared.items():
        nb += 4 * -(-F // 32) if lane0 else nbytes(pre[node])
    return nb


def pre_mask_metrics(torch, kern, ev: dict, n: int, params: dict,
                     label: str) -> dict:
    """K1 `pre_mask` on one `scan` block: every pre-mask program of the
    block in one launch, timed a launch (the kernel line's `ms`) and a
    program (`ms_per_program`); the bound counts each column the
    programs load once, whichever programs load it.  Its stack, rows a
    thread, blocks and warps a block are those of the main path's launch
    on the block (`main_params`)."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels.expr_eval import expr_masks_plain
    cols, rows = kern.pre_mask_cols(ev), kern.pre_mask_rows(ev)
    progs = [p for p in kern.nfak.pre_progs if p is not None]
    q = main_params(label, ev, "expr_eval:pre_mask", len(progs))
    nb, ops = k1_work(torch, cols, None, [], n, rows, masks=progs)
    ms, host = graph_ms(torch, lambda: kern.pre_masks(ev), lambda: [
        k1.prepare_masks(cols, progs, n, params, use="pre_mask",
                         rows=rows)])
    return {"ms": ms, "dispatch_ms": host, "programs": len(progs),
            "ms_per_program": ms / len(progs), "depth": q.depth,
            "grid": q.grid, "warps": q.wpb, "rows_a_thread": q.rows,
            "plain_ms": wall_ms(torch, lambda: expr_masks_plain(
                cols, progs, n, params, rows)),
            "bytes": nb, "ops": ops, "library_ms": None}


def phase_scan_blocks(torch, blocks, label: str) -> dict:
    """Phase 5: K1, K3, K6, K3's rank trees, K4 and K5 against their plain
    versions on every block a `scan` run recorded (replay.check_scan_block,
    each kernel on the same inputs as its plain version); the last block
    is timed, every kernel use it runs."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import scan_compact as k5
    from siddhi_tpu_torch.kernels import seg_tree as k3
    from siddhi_tpu_torch.kernels import win_scan as k6
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval_plain
    from siddhi_tpu_torch.kernels.scan_chase import (scan_chase,
                                                     scan_chase_plain)
    from siddhi_tpu_torch.kernels.scan_compact import (scan_compact,
                                                       scan_compact_plain)
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree, seg_tree_plain
    from siddhi_tpu_torch.kernels.win_scan import win_scan, win_scan_plain
    err: dict = {}
    for b, (kern, ev, M) in enumerate(blocks):
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        # the main path's one K5 launch on the block: tiles a lane and the
        # kernels its launcher launched (besides the state's memset)
        k5p = main_params(label, ev, "scan_compact:f64" if kern.f64
                          else "scan_compact", 0)
        if k5p.launched != 1:
            raise SystemExit(f"[{label}] block {b}: K5 launched "
                             f"{k5p.launched} kernels, one wanted")
        e = check_scan_block(kern, ev, M)
        merge_err(err, e)
        geo = k34_main(label, kern, ev)
        log(f"  [{label}] block {b}: L={L} F={F} trees={len(kern.trees)} "
            f"rank trees={len(kern.rank_trees)} prev columns="
            f"{len(kern.prev_nodes)} matches={e['matches']}: "
            f"{sorted(k for k in e if k != 'matches')} equal to their plain "
            f"versions; K5 {k5p.launched} kernel launch (and a memset) of "
            f"{L} x {k5p.ntiles} tiles of {k5.TILE} candidates; "
            f"{k34_line(geo)}")

    kern, ev, M = blocks[-1]
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    Lt = kern.leaves(F)
    params = {"__base_ts__": ev["__base_ts__"]}
    pre = kern.pre_masks(ev)
    masks, ranks, prevs, rcols = scan_inputs(kern, ev, pre)
    heaps = seg_tree(kern, ev, pre)
    rheaps = seg_tree_plain(kern, ev, masks, kern.rank_trees, rcols)
    alive: list = []
    chase = scan_chase_plain(kern, ev, masks, heaps, ranks, rheaps, prevs,
                             alive=alive)
    status, idx, cand, pres = chase
    out = scan_compact(kern, ev, chase, ranks, rheaps, M)
    n = int(out["meta"][0])
    res = {"L": L, "F": F, "Lt": Lt, "M": M, "matches": n,
           "blocks": len(blocks), "err": err, "alive": alive}
    pre_used = [w for w in pre if w is not None]
    log2 = max(Lt.bit_length() - 1, 1)
    # K3: what it reads, every heap written once; one compare per
    # internal node
    k3_bytes = k3_read_bytes(kern, ev, pre, F) + nbytes(*heaps)
    ms, host = graph_ms(torch, lambda: seg_tree(kern, ev, pre),
                        lambda: [k3.prepare(kern, ev, pre)])
    # the trees K3 builds: one for a tree the same in every lane of a
    # fused group (TreeSpec.shared), one per lane for any other
    built = sum(h.shape[0] for h in heaps)
    res["seg_tree"] = {"ms": ms, "dispatch_ms": host, "bytes": k3_bytes,
                       "ops": built * Lt, "library_ms": None,
                       "trees_built": built,
                       "lanes_x_trees": L * len(heaps),
                       **{k: geo.get("k3", {}).get(k) for k in (
                           "launches_a_call", "blocks", "warps")},
                       "plain_ms": wall_ms(torch, lambda: seg_tree_plain(
                           kern, ev, masks))}
    log(f"  [{label}] K3 built {built} trees for {L} lanes x {len(heaps)} "
        f"trees ({sum(1 for t in kern.trees if getattr(t, 'shared', False))} "
        f"lane-invariant, built once)")
    if ranks:
        # K6 ranks: each count's node mask read once and an i32 rank
        # column written once (JAX's cumsum is i32; the kernel writes i64),
        # one add per entry; lane starts come from the period, not memory.
        # The library yardstick is torch.cumsum of the (L, F) mask along
        # the lane
        cols = kern.rank_cols(masks)
        stacked = torch.stack([c[1].view(L, F) for c in cols])
        ms, host = graph_ms(torch, lambda: win_scan(
            cols, L * F, use="rank", period=F), lambda: [
            k6.prepare(cols, L * F, use="rank", period=F)])
        res["win_scan:rank"] = {
            "ms": ms, "dispatch_ms": host,
            "bytes": nbytes(*[c[1] for c in cols]) + 4 * L * F * len(cols),
            "ops": L * F * len(cols),
            "library_ms": library_ms(torch, lambda: torch.cumsum(stacked,
                                                                 dim=2)),
            "plain_ms": wall_ms(torch, lambda: win_scan_plain(
                cols, L * F, period=F))}
        # K3 rank trees: the rank columns and lane counts read once, every
        # i64 heap written once
        ms, host = graph_ms(torch, lambda: seg_tree(
            kern, ev, pre, kern.rank_trees, rcols), lambda: [
            k3.prepare(kern, ev, pre, kern.rank_trees, rcols)])
        res["seg_tree:rank"] = {
            "ms": ms, "dispatch_ms": host,
            "bytes": nbytes(ev["__nev__"], *ranks, *rheaps),
            "ops": len(rheaps) * L * Lt, "library_ms": None,
            **{k: geo["k3_rank"][k] for k in ("launches_a_call", "blocks",
                                               "warps")},
            "plain_ms": wall_ms(torch, lambda: seg_tree_plain(
                kern, ev, masks, kern.rank_trees, rcols))}
    if prevs:
        # K6 prev pointers: each side's node mask read once and an i32
        # pointer column written once (JAX's `mask ? i : -1` max-scan is
        # i32; the kernel writes i64), one max per entry; the index and
        # the lane starts come from the period, not memory.  The library
        # yardstick is torch.cummax of the masked index along the lane
        # (the masking outside the timed call)
        cols = kern.prev_cols(masks)
        j = torch.arange(F, device=masks[0].device)
        masked = torch.stack([torch.where(c[3].view(L, F), j, -1)
                              for c in cols])
        ms, host = graph_ms(torch, lambda: win_scan(
            cols, L * F, use="prev", period=F), lambda: [
            k6.prepare(cols, L * F, use="prev", period=F)])
        res["win_scan:prev"] = {
            "ms": ms, "dispatch_ms": host,
            "bytes": nbytes(*[c[3] for c in cols]) + 4 * L * F * len(cols),
            "ops": L * F * len(cols),
            "library_ms": library_ms(torch, lambda: torch.cummax(masked,
                                                                 dim=2)),
            "plain_ms": wall_ms(torch, lambda: win_scan_plain(
                cols, L * F, period=F))}
    # K4: grids, masks, VM columns, trees, ranks and prev pointers read
    # once, its outputs written once; per head still alive at a hop, the
    # hop's descents (killer, hop tree, both sides of a logical, a final
    # count's C selects) of 2 log2(Lt) compares each
    vm_cols = {key for key, _pos in kern.loads}
    k4_bytes = nbytes(ev["__flat.__ts__"], ev["__nev__"],
                      *[ev[c] for c in vm_cols], *pre_used, *heaps, *ranks,
                      *rheaps, *prevs, status, idx, cand, pres)
    desc = [1 + kern.C if h.kind == "final" else _DESCENTS[h.kind]
            for h in kern.hops]
    k4_ops = sum(a * d for a, d in zip(alive, desc)) * 2 * log2
    if kern.head is not None:
        k4_ops += int(((status & 4) != 0).sum()) * 2 * 2 * log2
    ms, host = graph_ms(torch, lambda: scan_chase(kern, ev, pre, heaps, ranks,
                                                  rheaps, prevs),
                        lambda: [k4.prepare(kern, ev, pre, heaps, ranks,
                                            rheaps, prevs)])
    res["scan_chase"] = {"ms": ms, "dispatch_ms": host, "bytes": k4_bytes,
                         "ops": k4_ops, "library_ms": None,
                         **{k: v for k, v in geo["k4"].items()
                            if k != "compact"},
                         "plain_ms": wall_ms(torch, lambda: scan_chase_plain(
                             kern, ev, masks, heaps, ranks, rheaps, prevs))}
    # K5: status, candidates, presence, indices, seq/ts grids, ranks and
    # rank trees, the captured columns and the lanes' dedup seqs read once,
    # the n match rows written once; the library yardstick is
    # torch.nonzero_static of the candidate mask (nonzero's capturable
    # form: the count taken beforehand; it builds the index list only)
    row_cols = {src[1] for srcs_ in kern.rows.values() for src in srcs_
                if src[0] in ("col", "cnt")}
    k5_bytes = nbytes(status, idx, cand, pres, ev["__flat.__seq__"],
                      ev["__flat.__ts__"], ev["__prev_seq__"], *ranks,
                      *rheaps, *[ev[c] for c in row_cols])
    k5_bytes += n * (4 * out["out_i"].shape[0] + out["out_f"].element_size()
                     * out["out_f"].shape[0] + 8 * out["out_l"].shape[0]) + \
        8 + 8 * L
    candm = cand.view(-1) != 0
    ncand = int(candm.sum())
    lib_ms = library_ms(torch, lambda: torch.nonzero_static(candm,
                                                            size=ncand))
    ms, host = graph_ms(torch, lambda: scan_compact(kern, ev, chase, ranks,
                                                    rheaps, M),
                        lambda: [k5.prepare(kern, ev, chase, ranks, rheaps,
                                            M)])
    res["scan_compact"] = {"ms": ms, "dispatch_ms": host, "bytes": k5_bytes,
                           "ops": L * F * kern.C, "library_ms": lib_ms,
                           "tiles": k5p.ntiles, "tile": k5.TILE,
                           "launches_a_call": k5p.launched,
                           "plain_ms": wall_ms(torch, lambda:
                                               scan_compact_plain(
                                                   kern, ev, chase, ranks,
                                                   rheaps, M))}
    # K1 on the scan block: every pre-mask program of the block over the
    # (L*F,) grid in one launch, selector over the match table
    res["pre_mask"] = pre_mask_metrics(torch, kern, ev, L * F, params,
                                       label)
    nfak = kern.nfak
    sel_cols = nfak.select_cols(out)
    sel_rows = nfak.select_rows(out)
    nb, ops = k1_work(torch, sel_cols, nfak.having_prog, nfak.sel_progs, n,
                      sel_rows)
    ms, host = graph_ms(torch, lambda: nfak.select(out, n,
                                                   ev["__base_ts__"]),
                        lambda: [k1.prepare(sel_cols, nfak.having_prog,
                                            nfak.sel_progs, n, params,
                                            use="select", rows=sel_rows)])
    res["select"] = {
        "ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
        "library_ms": None,
        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
            sel_cols, nfak.having_prog, nfak.sel_progs, n, params,
            sel_rows))}
    return res


def phase_blocks(torch, blocks, label: str = "c4 seq",
                 timed_k2: bool = True) -> dict:
    """K2 and K1 against their plain versions on every block a `seq` run
    accepted (an M overflow's first try is re-run by the plan with a
    larger M and is left out; replay.check_seq_block), counting the blocks
    in which absent deadlines fired, the timer ticks and the blocks whose
    final count's emissions outran the E lanes; K2 is timed on the last
    block that is not a tick (K1 is timed on the `scan` blocks), unless
    `timed_k2` is False (a phase whose K2 time the kernel line does not
    report)."""
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels.expr_eval import unpack_mask
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    accepted = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
    if not accepted:
        raise SystemExit(f"[{label}] recorded no accepted block")
    err: dict = {}
    fired = ticks = lane_retries = 0
    for b, (kern, state, ev, M) in enumerate(accepted):
        T, P = ev["__ts__"].shape[0], kern.P
        e = check_seq_block(kern, state, ev, M)
        merge_err(err, e)
        n = e["matches"]
        lane_retries += e["lost"] > 0
        # a chain ending in an absent position completes only when a
        # deadline fires, so each of its matches is a fired deadline
        n_fired = n if kern.spec.positions[-1].node.kind == "absent" else 0
        fired += n_fired > 0
        tick = "__tick__" in ev
        ticks += tick
        log(f"  [{label}] block {b}: T={T} P={P} A={kern.A} E={kern.E} M={M} "
            f"matches={n} lost lanes={e['lost']} deadlines fired="
            f"{n_fired}{' (tick)' if tick else ''}: K2 state and rows, K1 "
            f"pre-masks and selector equal to their plain versions")

    res = {"blocks": len(accepted), "err": err, "fired_blocks": fired,
           "tick_blocks": ticks, "lane_retry_blocks": lane_retries}
    if not timed_k2:
        return res
    timed = [b for b in accepted if "__tick__" not in b[2]] or accepted
    kern, state, ev, M = timed[-1]
    T, P = ev["__ts__"].shape[0], kern.P
    pre = kern.pre_masks(ev)
    out = nfa_block(kern, state, ev, pre, M)[1]
    n = int(out["meta"][0])
    masks = [None if w is None else unpack_mask(w, T * P).view(T, P)
             for w in pre]
    plain_ms = wall_ms(torch, lambda: nfa_block_plain(kern, state, ev,
                                                      masks, M))
    res.update({"T": T, "P": P, "A": kern.A, "E": kern.E, "M": M,
                "matches": n})
    # K2: the grids, pre-mask words, state in and out and the match rows,
    # each moved once; one station test per slot and lane for each event
    tensors = [v for v in ev.values() if torch.is_tensor(v)]
    k2_bytes = sum(v.numel() * v.element_size() for v in tensors)
    k2_bytes += sum(w.numel() * 4 for w in pre if w is not None)
    k2_bytes += 2 * sum(v.numel() * v.element_size() for v in state.values())
    k2_bytes += n * (len(kern.lane_names_i) * 4 + len(kern.rows_f) *
                     out["out_f"].element_size() + len(kern.rows_l) * 8) + 16
    lanes = P if ev["__valid__"].shape[1] == 1 else 1
    k2_ops = int(ev["__valid__"].sum()) * kern.A * lanes
    ms, host = graph_ms(torch, lambda: nfa_block(kern, state, ev, pre, M),
                        lambda: [k2.prepare(kern, state, ev, pre, M)],
                        reps=10)
    res["nfa_block"] = {"ms": ms, "dispatch_ms": host, "plain_ms": plain_ms,
                        "bytes": k2_bytes, "ops": k2_ops, "library_ms": None,
                        **k2_geometry(torch, k2, kern, state, ev, pre, M,
                                      ms, T)}
    if kern.f64:
        res["nfa_block"].update(f64=True, f32_twin_ms=k2_f32_twin_ms(
            torch, kern, state, ev, M))
    return res


def run_recorded(pkg, np, app: str, tape, keys: int = KEYS,
                 runner=None) -> tuple:
    """An app through the facade on the card, launch counts from 0 just
    before its first flush and read just after its last, recording every
    block its plan hands ParallelChainKernel.run_block (kernel, event
    grid, M) or NFAKernel.run_block (kernel, state in, event grid, M,
    meta); recording launches nothing.  `runner` (run_app's signature)
    feeds the tape, run_app by default.  Returns (rows, ms per flush,
    launches, runtime, scan blocks, seq blocks)."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.core.nfa_parallel import ParallelChainKernel
    scan_b, seq_b = [], []
    run_scan, run_seq = ParallelChainKernel.run_block, NFAKernel.run_block

    def rec_scan(kern, ev, M):
        scan_b.append((kern, ev, M))
        return run_scan_block(run_scan, kern, ev, M)

    def rec_seq(kern, state, ev, M):
        new, out = run_seq(kern, state, ev, M)
        seq_b.append((kern, state, ev, M, out["meta"]))
        return new, out
    ParallelChainKernel.run_block, NFAKernel.run_block = rec_scan, rec_seq
    try:
        kernels.reset_launches()
        kernels.record_params(*RECORDED)
        rows, per_flush, rt = (runner or run_app)(pkg, np, app, tape, keys,
                                                  "cuda")
        launches = dict(kernels.LAUNCHES)
    finally:
        ParallelChainKernel.run_block, NFAKernel.run_block = run_scan, run_seq
        kernels.record_params()
    return rows, per_flush, launches, rt, scan_b, seq_b


def phase_algebra(torch, np, pkg, label: str, app: str, flushes: int,
                  family: str, seed: int, extra, null_col) -> dict:
    """Phases 13-16: a count or logical pattern of C4's shape (1000 keys,
    2^18 events a flush) on the card: the plan's family as the JAX
    package picks it, the family's kernels (and `extra` uses) launched,
    the rows equal to the CPU run's with NULLs in place (and present in
    column `null_col` when given); every recorded block's kernels equal to
    their plain versions; ms per flush and events/s."""
    tape = make_tape(FLUSH * flushes, FLUSH, KEYS, seed=seed)
    rows, per_flush, launches, rt, scan_b, seq_b = run_recorded(
        pkg, np, app, tape)
    plan = rt.plans()[0]
    if plan.family != family:
        raise SystemExit(f"[{label}] planned {plan.family!r}, expected "
                         f"{family!r} ({plan.families})")
    ref, cpu_flush, _rt = run_app(pkg, np, app, tape, KEYS, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"[{label}] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    nulls = sum(1 for _t, r in rows if None in r)
    if null_col is not None and not any(r[null_col] is None
                                        for _t, r in rows):
        raise SystemExit(f"[{label}] no NULL in output column {null_col}")
    if family == "scan":
        need_launches(label, launches, SCAN_K + tuple(extra),
                      ("nfa_block",))
        blk = phase_scan_blocks(torch, scan_b, label)
    else:
        need_launches(label, launches, SEQ_K + tuple(extra),
                      ("seg_tree", "scan_chase", "scan_compact"))
        blk = phase_blocks(torch, seq_b, label)
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[{label}] {len(rows)} rows ({nulls} with NULLs) equal to the CPU "
        f"run; family {plan.family}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s; "
        f"{blk['blocks']} blocks equal to plain")
    return {"rows": len(rows), "null_rows": nulls, "family": plan.family,
            "ms_per_flush": per_flush, "cpu_ms_per_flush": cpu_flush,
            "events_per_s": eps, "launches": launches, "blocks": blk}


def phase_ext(torch, np, pkg, label: str, app: str, seed: int) -> dict:
    """Phases 27-30: an init-slot, fork or absent-side pattern of C4's
    shape (1000 keys, 2^18 events a flush, playback) on the card: the
    `seq` family, K2's EXT instantiation and K1 launched (K2's others and
    K3-K5 not), rows equal to the CPU run's in order with NULLs in place,
    every recorded block's K2 and K1 equal to their plain versions; ms per
    flush, events/s, the A the plan ends at and its growths by cause."""
    tape = make_tape(FLUSH * EXT_FLUSHES, FLUSH, KEYS, seed=seed)
    rows, per_flush, launches, rt, _scan_b, seq_b = run_recorded(
        pkg, np, app, tape)
    plan = rt.plans()[0]
    if plan.family != "seq" or not plan.kernel.ext:
        raise SystemExit(f"[{label}] planned {plan.family!r} "
                         f"(ext={plan.kernel.ext}), expected `seq` with EXT")
    need_launches(label, launches, EXT_K, ("nfa_block", "seg_tree",
                                           "scan_chase", "scan_compact"))
    ref, cpu_flush, _rt = run_app(pkg, np, app, tape, KEYS, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"[{label}] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    if label == "c4z" and not any(r[0] is None and r[1] for _t, r in rows):
        raise SystemExit("[c4z] no row with NULL p10 and `none` true")
    if label == "c4l_or" and {r[2] for _t, r in rows} != {True, False}:
        raise SystemExit("[c4l_or] `timed_out` is not both true and false")
    growths = dict(plan.growths)
    if label == "c4f" and (plan.kernel.A <= 4 or not growths["forks"]):
        raise SystemExit(f"[c4f] A={plan.kernel.A}, growths {growths}: no "
                         f"growth after a fork overflow")
    blk = phase_blocks(torch, seq_b, label, timed_k2=label in EXT_TIMED)
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    nulls = sum(1 for _t, r in rows if None in r)
    log(f"[{label}] {len(rows)} rows ({nulls} with NULLs) equal to the CPU "
        f"run; family {plan.family}; A={plan.kernel.A} (growths: "
        f"{growths['heads']} after dropped heads, {growths['forks']} after "
        f"clones without a free slot); launches "
        f"{ {k: v for k, v in launches.items() if v} }; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s; "
        f"{blk['blocks']} blocks equal to plain")
    return {"rows": len(rows), "null_rows": nulls, "A": plan.kernel.A,
            "growths": growths, "ms_per_flush": per_flush,
            "cpu_ms_per_flush": cpu_flush, "events_per_s": eps,
            "launches": launches, "blocks": blk}


def run_c3h(pkg, np, tape, device: str, record: bool = False):
    """C3H through the facade on the wall clock: `set_time` to the START
    anchor (the absent head's first wakeup is one waiting period later,
    before any block ran), `set_time` past it (a tick arms the init slot
    at the anchor and fires its deadline), the tape as one flush, then
    `set_time` a second past its last event.  Launch counts from 0 just
    before the first `set_time`, read after the last.  Returns (rows, ms
    of the flush, launches, runtime, recorded blocks, wakeup)."""
    import torch
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    blocks = []
    run_seq = NFAKernel.run_block

    def rec_seq(kern, state, ev, M):
        new, out = run_seq(kern, state, ev, M)
        blocks.append((kern, state, ev, M, out["meta"]))
        return new, out
    if record:
        NFAKernel.run_block = rec_seq
    try:
        rt = pkg.SiddhiManager(device=device).create_app_runtime(C3H)
        batches = []
        rt.add_batch_callback("Out", batches.append)
        f = tape[0]
        ts0 = int(f["ts"][0])
        kernels.reset_launches()
        rt.set_time(ts0 - 1000)
        wakeup = rt.plans()[0].next_wakeup()
        rt.set_time(ts0 - 1)
        codes = np.array([rt.strings.encode(f"K{i}") for i in range(KEYS)],
                         dtype=np.int32)
        t0 = time.perf_counter()
        rt.input_handler("StockStream").send_batch(
            {"symbol": codes[f["sym_idx"]], "price": f["price"],
             "volume": f["volume"]}, f["ts"])
        rt.flush()
        if device == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rt.set_time(int(f["ts"][-1]) + 1000)
        launches = dict(kernels.LAUNCHES)
    finally:
        NFAKernel.run_block = run_seq
    rows = [(int(t), row) for b in batches
            for t, row in zip(b.timestamps, b.rows(rt.strings))]
    return rows, ms, launches, rt, blocks, wakeup


def phase_c3h(torch, np, pkg) -> dict:
    """Phase 31: C3H, an unpartitioned absent head on the wall clock: the
    wakeup before the first block is the anchor plus its 100 ms, a tick
    block arms the init slot (`__anchor__`), the rows equal the CPU run's,
    K2 EXT launched, every recorded block (ticks among them) equal to the
    plain version."""
    tape = make_tape(C3H_EVENTS, C3H_EVENTS, KEYS, seed=31)
    ts0 = int(tape[0]["ts"][0])
    rows, ms, launches, rt, blocks, wakeup = run_c3h(pkg, np, tape, "cuda",
                                                     record=True)
    if wakeup != ts0 - 900:
        raise SystemExit(f"[c3h] wakeup {wakeup} before the first block, "
                         f"expected {ts0 - 900}")
    need_launches("c3h", launches, ("nfa_block:ext", "expr_eval:pre_mask"),
                  ("nfa_block",))
    ref = run_c3h(pkg, np, tape, "cpu")[0]
    if rows != ref or not rows:
        raise SystemExit(f"[c3h] rows differ from the CPU run: {len(rows)} "
                         f"vs {len(ref)}")
    blk = phase_blocks(torch, blocks, "c3h", timed_k2=False)
    if not blk["tick_blocks"]:
        raise SystemExit("[c3h] no tick block was recorded")
    log(f"[c3h] {len(rows)} rows equal to the CPU run; wakeup before the "
        f"first block {wakeup} (anchor {ts0 - 1000}); launches "
        f"{ {k: v for k, v in launches.items() if v} }; {ms:.1f} ms for "
        f"{C3H_EVENTS} events; {blk['blocks']} blocks ({blk['tick_blocks']} "
        f"ticks) equal to plain")
    return {"rows": len(rows), "ms": ms, "launches": launches,
            "blocks": blk, "wakeup": wakeup}


def chunk_kept(kern, meta, M: int, cap: int) -> bool:
    """A chunk block the plan kept: no retry followed it (no M overflow,
    no lost E-lane emission, no dropped head below the slot cap)."""
    n, ofs, _dl, ofl, _lost = meta.tolist()
    return n <= M and ofl == 0 and (ofs == 0 or kern.A >= cap)


def phase_chunk_blocks(torch, blocks, label: str, cap: int,
                       timed: bool) -> dict:
    """K2 (chunk mode) and K1 against their plain versions on every chunk
    block the plan kept (replay.check_chunk_block, from fresh state); K2
    timed on the last one when `timed`."""
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels.nfa_block import nfa_block, nfa_block_plain
    kept = [(k, ev, M) for k, _st, ev, M, meta in blocks
            if chunk_kept(k, meta.cpu(), M, cap)]
    if not kept:
        raise SystemExit(f"[{label}] recorded no kept chunk block")
    err: dict = {}
    for b, (kern, ev, M) in enumerate(kept):
        e = check_chunk_block(kern, ev, M)
        merge_err(err, e)
        T, cs, nev, _prev = ev["__chunk__"]
        log(f"  [{label}] block {b}: K={kern.P} T={T} CS={cs} F={nev} "
            f"A={kern.A} E={kern.E} M={M} matches={e['matches']}: K2 state "
            f"and rows, K1 pre-masks and selector equal to their plain "
            f"versions")
    res = {"blocks": len(kept), "err": err}
    if not timed:
        return res
    kern, ev, M = kept[-1]
    T, cs, nev, _prev = ev["__chunk__"]
    state = kern.init_state(ev["__ts__"].device)
    pre = kern.pre_masks(ev)
    out = nfa_block(kern, state, ev, pre, M)[1]
    n = int(out["meta"][0])
    masks = block_masks(kern, ev, pre)
    plain_ms = wall_ms(torch, lambda: nfa_block_plain(kern, state, ev,
                                                      masks, M))
    # the flat events and pre-mask words read once, the fresh state in
    # and out and the match rows moved once; one station test per slot
    # for each (lane, step) cell holding an event (halo reads included)
    tensors = [v for v in ev.values() if torch.is_tensor(v)]
    k2_bytes = sum(v.numel() * v.element_size() for v in tensors)
    k2_bytes += sum(w.numel() * 4 for w in pre if w is not None)
    k2_bytes += 2 * sum(v.numel() * v.element_size() for v in state.values())
    k2_bytes += n * (len(kern.lane_names_i) * 4 + len(kern.rows_f) *
                     out["out_f"].element_size() + len(kern.rows_l) * 8) + 20
    cells = sum(max(0, min(T, nev - lane * cs)) for lane in range(kern.P))
    ms, host = graph_ms(torch, lambda: nfa_block(kern, state, ev, pre, M),
                        lambda: [k2.prepare(kern, state, ev, pre, M)],
                        reps=10)
    res.update({"K": kern.P, "T": T, "CS": cs, "A": kern.A, "M": M,
                "matches": n})
    res["nfa_block:chunk"] = {"ms": ms, "dispatch_ms": host,
                              "plain_ms": plain_ms, "bytes": k2_bytes,
                              "ops": cells * kern.A, "library_ms": None,
                              **k2_geometry(torch, k2, kern, state, ev, pre,
                                            M, ms, T)}
    if kern.f64:
        res["nfa_block:chunk"].update(f64=True, f32_twin_ms=k2_f32_twin_ms(
            torch, kern, state, ev, M))
    return res


def k2_geometry(torch, k2, kern, state, ev, pre, M, ms: float,
                T: int) -> dict:
    """K2's time a step (device ns / T) and the event stage's TT and
    warps a block that one launch on the block chose (csrc/nfa_block.cuh
    nfa_setup)."""
    launch = k2.prepare(kern, state, ev, pre, M)
    launch()
    torch.cuda.synchronize()
    return {"step_ns": ms * 1e6 / T, "tt": launch.params.tt,
            "wpb": launch.params.wpb}


def k2_f32_twin_ms(torch, kern, state, ev, M) -> float:
    """Device ms of K2's float32 instantiation on an f64 block's shapes:
    the same chain with f64 off, its DOUBLE grids and capture rows cast
    to float32 (other values, the same work), graph-timed as the f64
    launch is."""
    from siddhi_tpu_torch.core.nfa_device import NFAKernel
    from siddhi_tpu_torch.kernels import nfa_block as k2
    twin = NFAKernel(kern.spec, kern.sel_fns, kern.having, kern.P, kern.A,
                     kern.params, kern.broadcast, kern.playback, kern.E,
                     kern.init_on_tick)
    ev32 = {k: v.float() if torch.is_tensor(v) and v.dtype == torch.float64
            else v for k, v in ev.items()}
    st32 = dict(state, caps_f=state["caps_f"].float())
    pre = twin.pre_masks(ev32)
    ms, _host = graph_ms(torch, lambda: k2.nfa_block(twin, st32, ev32, pre,
                                                     M),
                         lambda: [k2.prepare(twin, st32, ev32, pre, M)],
                         reps=10)
    return ms


def time_k3_k4(torch, kern, ev, pre, heaps, tables=None) -> dict:
    """Device and dispatch ms of K3 and of K4 (tree or `dfa` mode) on one
    single-position block (no ranks, prev pointers or rank trees)."""
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import seg_tree as k3
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree
    k3_ms, k3_host = graph_ms(torch, lambda: seg_tree(kern, ev, pre),
                              lambda: [k3.prepare(kern, ev, pre)])
    k4_ms, k4_host = graph_ms(
        torch, lambda: scan_chase(kern, ev, pre, heaps, tables=tables),
        lambda: [k4.prepare(kern, ev, pre, heaps, tables=tables)])
    return {"seg_tree": k3_ms, "seg_tree_dispatch": k3_host,
            "scan_chase": k4_ms, "scan_chase_dispatch": k4_host}


def phase_dfa_blocks(torch, blocks, label: str, scan_blocks) -> dict:
    """K1, K3, K11, K4 (`dfa` mode) and K5 against their plain versions on
    every `dfa` block (replay.check_dfa_block); K11 and K4 `dfa` timed on
    the last one, K3 and K4 on the last block of the `scan` run of the
    same tape beside them."""
    from siddhi_tpu_torch.kernels import dfa_tables as k11
    from siddhi_tpu_torch.kernels.dfa_tables import (dfa_tables,
                                                     dfa_tables_plain)
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase_plain
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree, seg_tree_plain
    err: dict = {}
    for b, (kern, ev, M) in enumerate(blocks):
        if any(t.node in kern.dfa_nodes for t in kern.trees):
            raise SystemExit(f"[{label}] K3 built a tree for a chase node")
        e = check_dfa_block(kern, ev, M)
        merge_err(err, e)
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        g34 = k34_main(label, kern, ev)
        log(f"  [{label}] block {b}: L={L} F={F} chase nodes="
            f"{len(kern.dfa_nodes)} trees={len(kern.trees)} matches="
            f"{e['matches']}: {sorted(k for k in e if k != 'matches')} "
            f"equal to their plain versions; {k34_line(g34)}")
    kern, ev, M = blocks[-1]
    L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
    Lt = kern.leaves(F)
    pre = kern.pre_masks(ev)
    masks = scan_inputs(kern, ev, pre)[0]
    heaps = seg_tree(kern, ev, pre)
    chase_masks = [masks[gi] for gi in kern.dfa_nodes]
    tables = dfa_tables(kern, ev, pre)
    nk, NB = len(kern.dfa_nodes), tables[1].shape[1]
    alive: list = []
    status, idx, cand, pres = scan_chase_plain(
        kern, ev, masks, heaps, tables=tables, alive=alive)
    res = {"blocks": len(blocks), "err": err, "L": L, "F": F, "Lt": Lt,
           "chase_nodes": nk}
    pre_chase = [pre[gi] for gi in kern.dfa_nodes if pre[gi] is not None]
    ms, host = graph_ms(torch, lambda: dfa_tables(kern, ev, pre),
                        lambda: [k11.prepare(kern, ev, pre)])
    geo = main_params(label, ev, "dfa_tables", 0)
    # K11: the chase nodes' pre-mask words, the lane counts and (several
    # streams) the stream codes read once, the suffix words, block words
    # and next pointers written once; a bit test per node and event and a
    # min per node and block
    scode = [ev["__flat.__scode__"]] if kern.multi else []
    res["dfa_tables"] = {
        "ms": ms, "dispatch_ms": host, "library_ms": None,
        "bytes": nbytes(ev["__nev__"], *pre_chase, *scode, *tables),
        "ops": L * NB * 4 * nk + L * NB * nk, "tiles": geo.T,
        "warps": geo.W,
        "plain_ms": wall_ms(torch, lambda: dfa_tables_plain(chase_masks))}
    # K4 in `dfa` mode: as K4, the tables in place of the mask trees; per
    # head alive at a hop the killer's descent (2 log2 Lt), a threshold
    # hop's descent, or a static hop's three table reads
    log2 = max(Lt.bit_length() - 1, 1)
    vm_cols = {key for key, _pos in kern.loads}
    per_hop = [2 * log2 + (2 * log2 if h.kind == "threshold" else 3)
               for h in kern.hops]
    t = time_k3_k4(torch, kern, ev, pre, heaps, tables)
    res["scan_chase:dfa"] = {
        "ms": t["scan_chase"], "dispatch_ms": t["scan_chase_dispatch"],
        "library_ms": None,
        "bytes": nbytes(ev["__flat.__ts__"], ev["__nev__"],
                        *[ev[c] for c in vm_cols], *[w for w in pre
                                                     if w is not None],
                        *heaps, *tables, status, idx, cand, pres),
        "ops": sum(a * d for a, d in zip(alive, per_hop)),
        **{k: v for k, v in g34["k4"].items() if k != "compact"},
        "plain_ms": wall_ms(torch, lambda: scan_chase_plain(
            kern, ev, masks, heaps, tables=tables))}
    res["seg_tree"] = {"ms": t["seg_tree"],
                       "dispatch_ms": t["seg_tree_dispatch"],
                       "plain_ms": wall_ms(torch, lambda: seg_tree_plain(
                           kern, ev, masks))}
    skern, sev, _sM = scan_blocks[-1]
    spre = skern.pre_masks(sev)
    st = time_k3_k4(torch, skern, sev, spre, seg_tree(skern, sev, spre))
    res["scan_run"] = {"trees": len(skern.trees), **st}
    log(f"  [{label}] K11 {geo.T} tiles a lane of {32 * geo.W} stride-"
        f"blocks ({L} lanes of {NB})")
    log(f"  [{label}] K11 {ms:.4f} ms + K4 dfa {t['scan_chase']:.4f} ms + K3 "
        f"{t['seg_tree']:.4f} ms ({len(kern.trees)} trees); the `scan` run: "
        f"K3 {st['seg_tree']:.4f} ms ({len(skern.trees)} trees) + K4 "
        f"{st['scan_chase']:.4f} ms")
    return res


def phase_stateless(torch, np, pkg, label: str, app: str, n: int,
                    flushes: int, keys: int, seed: int, family: str,
                    cmp_app) -> dict:
    """Phases 32-36: a `chunk` or `dfa` app on the card: the family,
    launches, rows equal to the CPU run's in order (and to the card's
    `seq` or `scan` run of the same tape), every recorded block's kernels
    equal to their plain versions; ms per flush and events/s, and for
    `chunk` the geometry (K, CS, H, T) and the final A."""
    tape = make_tape(n * flushes, n, keys, seed=seed)
    rows, per_flush, launches, rt, scan_b, seq_b = run_recorded(
        pkg, np, app, tape, keys)
    plan = rt.plans()[0]
    if plan.family != family:
        raise SystemExit(f"[{label}] planned {plan.family!r}, expected "
                         f"{family!r} ({plan.families})")
    if label == "c3x" and "conjunct" not in str(plan.families["scan"]):
        raise SystemExit(f"[c3x] `scan` verdict {plan.families['scan']!r}")
    ref, cpu_flush, _rt = run_app(pkg, np, app, tape, keys, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"[{label}] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    res = {"rows": len(rows), "family": plan.family,
           "ms_per_flush": per_flush, "cpu_ms_per_flush": cpu_flush,
           "launches": launches}
    cmp_scan = None
    if cmp_app is not None:
        cmp_rows, cmp_flush, _l, cmp_rt, cmp_scan, _s = run_recorded(
            pkg, np, cmp_app, tape, keys)
        cmp_fam = cmp_rt.plans()[0].family
        if cmp_rows != rows:
            raise SystemExit(f"[{label}] rows differ from the card's "
                             f"{cmp_fam!r} run: {len(rows)} vs "
                             f"{len(cmp_rows)}")
        res[f"{cmp_fam}_ms_per_flush"] = cmp_flush
    if family == "chunk":
        need_launches(label, launches, CHUNK_K,
                      ("nfa_block", "nfa_block:ext", "seg_tree",
                       "scan_chase", "scan_compact", "dfa_tables",
                       "scan_chase:dfa"))
        blk = phase_chunk_blocks(torch, seq_b, label, plan.A_CAP,
                                 timed=label in ("c3k", "c3x"))
        K, CS, H, T = plan.chunk_geometry
        res.update({"K": K, "CS": CS, "H": H, "T": T,
                    "A": plan._chunk_A})
        geo = f"; K={K} CS={CS} H={H} T={T} A={plan._chunk_A}"
    else:
        need_launches(label, launches, DFA_K,
                      ("scan_chase", "nfa_block", "nfa_block:chunk"))
        one_pre_mask_launch(label, launches, scan_b)
        blk = phase_dfa_blocks(torch, scan_b, label, cmp_scan)
        geo = ""
    steady = per_flush[1:]
    eps = n / (sum(steady) / len(steady) / 1e3)
    log(f"[{label}] {len(rows)} rows equal to the CPU run"
        f"{'' if cmp_app is None else ' and the comparison run'}; family "
        f"{plan.family}{geo}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s; "
        f"{blk['blocks']} blocks equal to plain")
    res.update({"events_per_s": eps, "blocks": blk})
    return res


def phase_c4f64(torch, np, pkg) -> dict:
    """Phase 37: the slice at full width -- C4's deployment (1000 keys,
    deviceSlots(32), 4 flushes of 2^18 events 1 ms apart) under
    @app:devicePrecision('f64') on the raw-double tape, its default
    `scan` family: K3, K4 and K5 launched in their float64 forms (K2 and
    the float32 forms of K5 not), rows equal to the CPU run's, every
    recorded block's kernels equal to their plain versions, the last
    block timed; the same tape through C4 in float32 on the card gives
    other rows (the phase tests precision)."""
    app = F64 + C4_HEAD + C4
    tape = raw_tape(FLUSH * N_FLUSH, FLUSH, KEYS, seed=37)
    rows, per_flush, launches, rt, blocks, _ = run_recorded(pkg, np, app,
                                                             tape)
    plan = rt.plans()[0]
    if plan.family != "scan" or not plan.f64:
        raise SystemExit(f"[c4f64] planned {plan.family!r} (f64 "
                         f"{plan.f64}), expected `scan` in f64")
    need_launches("c4f64", launches,
                  SCAN_F64_K + ("expr_eval:pre_mask", "expr_eval:select"),
                  F32_FORMS + ("nfa_block:f64", "seg_tree", "scan_chase"))
    ref, cpu_flush, _rt = run_app(pkg, np, app, tape, KEYS, "cpu")
    if rows != ref:
        raise SystemExit(f"[c4f64] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    check_rows("C4F64", rows, ref)
    f32_rows, f32_flush, _rt = run_app(pkg, np, C4_HEAD + C4, tape, KEYS,
                                       "cuda")
    if sorted(f32_rows) == sorted(rows):
        raise SystemExit("[c4f64] float32 gives the f64 rows: the tape does "
                         "not test precision")
    blk = phase_scan_blocks(torch, blocks, "c4f64")
    for key in ("seg_tree", "scan_chase", "scan_compact"):
        blk[key]["f64"] = True
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c4f64] {len(rows)} rows equal to the CPU run (float32 on the "
        f"card: {len(f32_rows)} rows, other values); family {plan.family}; "
        f"launches { {k: v for k, v in launches.items() if v} }; per flush "
        f"ms {[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}; float32 "
        f"{[round(x, 1) for x in f32_flush]}); {eps:.0f} events/s; "
        f"{blk['blocks']} blocks equal to plain")
    return {"rows": len(rows), "f32_rows": len(f32_rows),
            "ms_per_flush": per_flush, "cpu_ms_per_flush": cpu_flush,
            "f32_ms_per_flush": f32_flush, "events_per_s": eps,
            "flush_events": FLUSH, "launches": launches, "blocks": blk}


def phase_f64(torch, np, pkg, label: str, app: str, n: int, flushes: int,
              keys: int, seed: int, band: tuple, family: str, need,
              timed: bool) -> dict:
    """Phases 38-42: an f64 app at a smaller depth on a raw-double tape:
    its family in f64, its float64 kernel forms launched and no float32
    form of K2 or K5, rows equal to the CPU run's in order, every
    recorded block's kernels equal to their plain versions (K2 timed on
    the last when `timed`); C4F must grow A after clones without a free
    slot, the A = 256 run must take the wide instantiation."""
    tape = raw_tape(n * flushes, n, keys, seed=seed, lo=band[0],
                    levels=band[1])
    rows, per_flush, launches, rt, scan_b, seq_b = run_recorded(
        pkg, np, app, tape, keys)
    plan = rt.plans()[0]
    if plan.family != family or not plan.f64:
        raise SystemExit(f"[{label}] planned {plan.family!r} (f64 "
                         f"{plan.f64}), expected {family!r} in f64")
    unused = F32_FORMS + (() if family == "dfa" else
                          ("seg_tree", "scan_chase") + SCAN_F64_K)
    need_launches(label, launches, tuple(need) + ("expr_eval:pre_mask",
                                                  "expr_eval:select"),
                  unused)
    ref, cpu_flush, _rt = run_app(pkg, np, app, tape, keys, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"[{label}] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    extra = ""
    if family == "seq":
        A = plan.kernel.A
        if label == "c4f f64" and (A <= 4 or not plan.growths["forks"]):
            raise SystemExit(f"[{label}] A={A}, growths {plan.growths}: no "
                             f"growth after a fork overflow")
        if label == "c4 a256 f64" and A <= 128:
            raise SystemExit(f"[{label}] A={A}: not the wide instantiation")
        blk = phase_blocks(torch, seq_b, label, timed_k2=timed)
        extra = f"; A={A} growths {plan.growths}"
    elif family == "chunk":
        blk = phase_chunk_blocks(torch, seq_b, label, plan.A_CAP, timed)
        extra = f"; K, CS, H, T = {plan.chunk_geometry}, A={plan._chunk_A}"
    else:
        err: dict = {}
        for b, (kern, ev, M) in enumerate(scan_b):
            e = check_dfa_block(kern, ev, M)
            merge_err(err, e)
            log(f"  [{label}] block {b}: matches={e['matches']}: "
                f"{sorted(k for k in e if k != 'matches')} equal to their "
                f"plain versions; {k34_line(k34_main(label, kern, ev))}")
        blk = {"blocks": len(scan_b), "err": err}
    steady = per_flush[1:] or per_flush
    eps = n / (sum(steady) / len(steady) / 1e3)
    log(f"[{label}] {len(rows)} rows equal to the CPU run; family "
        f"{plan.family}{extra}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s; "
        f"{blk['blocks']} blocks equal to plain")
    return {"rows": len(rows), "family": plan.family,
            "ms_per_flush": per_flush, "cpu_ms_per_flush": cpu_flush,
            "events_per_s": eps, "launches": launches, "blocks": blk}


def phase_c5f64(torch, np, pkg) -> dict:
    """Phase 43: config 5's fused groups under f64 (c5_app(1000) with its
    price constants made DOUBLE literals, `frac` = 1e-6: float64 lane
    parameters), one flush of 2^13 raw-double events 50 ms apart, then
    set_time: K1 over f64 lane parameters, K2 f64, K3-K5 in their float64
    forms launched; rows equal to the CPU run's; every recorded block's
    kernels equal to their plain versions, the last `scan` block timed."""
    app = F64 + c5_app(C5_QUERIES, frac=RAW_STEP)
    tape = raw_tape(C5_FLUSH, C5_FLUSH, C5_SYMBOLS, seed=43,
                    dt_ms=C5_DT, lo=90.0, levels=40)
    rows, per_flush, set_ms, launches, rt, seq_b, scan_b = run_c5(
        pkg, np, tape, "cuda", record=True, app=app)
    plans = rt.plans()
    if [getattr(p, "n_queries", 0) for p in plans] != [250] * 4 or \
            not all(p.inner.f64 for p in plans):
        raise SystemExit(f"C5 f64 planned {[p.name for p in plans]}")
    if not any(v.dtype == torch.float64 for p in plans
               for v in p.inner.params.values):
        raise SystemExit("C5 f64: no float64 lane parameter")
    need_launches("C5 f64", launches, ("expr_eval:pre_mask",
                                       "expr_eval:select", "nfa_block:f64")
                  + SCAN_F64_K, F32_FORMS)
    ref = run_c5(pkg, np, tape, "cpu", app=app)[0]
    check_c5_rows("C5 f64", rows, ref)
    k2 = phase_blocks(torch, seq_b, "c5 f64", timed_k2=False)
    scan = phase_scan_blocks(torch, scan_b, "c5 f64")
    log(f"[c5 f64] {len(rows)} rows equal to the CPU run; launches "
        f"{ {k: v for k, v in launches.items() if v} }; per flush ms "
        f"{[round(x, 1) for x in per_flush]}, set_time {set_ms:.1f} ms; "
        f"{k2['blocks']} K2 and {scan['blocks']} scan blocks equal to plain")
    return {"rows": len(rows), "ms_per_flush": per_flush,
            "set_time_ms": set_ms, "launches": launches, "k2": k2,
            "scan": scan}


def phase_c2f64(torch, np) -> dict:
    """Phase 44: C2 under f64 on raw doubles over a wide range
    (replay.wide_tape: signed, magnitudes e^-20 to e^20), 2 flushes of
    2^17: the window path sums the raw doubles in f64, where the sums
    round.  Every row's `ap` equal to the CPU run's bit for bit (the
    plain scans fold in K6's association); K1, K6, K7 and K8 equal to
    their plain versions on every recorded call, tolerance 0.  The sum
    bound (the prefix sums' rounding bound, 2 (i + 1) 2^-53 sum|v| at
    entry i of a step's N = C + T entries, taken at i = N for both
    prefixes of a window, over the window's count, plus one rounding of
    the quotient: what another association could be off by) is logged
    as information."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import run_window
    app = F64 + C2
    tape = wide_tape(C2_FLUSH * C2_FLUSHES, C2_FLUSH, C2_SYMBOLS, seed=44)
    calls: list = []
    kernels.reset_launches()
    rows, per_flush, rt = run_window(app, tape, "cuda", calls)
    launches = dict(kernels.LAUNCHES)
    ref, cpu_flush, _rt = run_window(app, tape, "cpu")
    plan = rt.plans()[0]
    if not plan.f64:
        raise SystemExit("[c2 f64] the window plan is not in f64")
    need_launches("c2 f64", launches, (
        "expr_eval:window_args", "expr_eval:window_select", "win_scan",
        "win_range", "win_compact"))
    if [t for t, _r in rows] != [t for t, _r in ref] or not rows:
        raise SystemExit(f"[c2 f64] rows differ from the CPU run in number "
                         f"or order: {len(rows)} vs {len(ref)}")
    got = np.array([r[0] for _t, r in rows])
    want = np.array([r[0] for _t, r in ref])
    p = np.abs(np.concatenate([f["price"] for f in tape]))
    n_call = plan.C + C2_FLUSH
    flush_of = np.arange(len(p)) // C2_FLUSH
    per = np.array([p[max(0, (f - 1) * C2_FLUSH):(f + 1) * C2_FLUSH].sum()
                    for f in range(C2_FLUSHES)])
    count = np.minimum(np.arange(1, len(p) + 1), 1000)
    bound = 4 * n_call * 2.0 ** -53 * per[flush_of] / count + \
        2.0 ** -52 * np.abs(want)
    diff = np.abs(got - want)
    differ = int((got.view(np.int64) != want.view(np.int64)).sum())
    if len(got) != len(p) or differ:
        raise SystemExit(f"[c2 f64] rows differ from the CPU run's: "
                         f"{differ} `ap` bit patterns of {len(got)}")
    err = check_window_calls(calls, raw_sums=True)
    log(f"[c2 f64] {len(rows)} rows equal to the CPU run's bit for bit "
        f"(the sum bound, information: median {float(np.median(bound)):.6g},"
        f" largest {float(bound.max()):.6g}); C={plan.C}; launches "
        f"{launches}; ms per flush {[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {len(calls)} kernel calls: "
        f"{sorted(k for k in err if not k.endswith('bound'))} equal to "
        f"their plain versions, tolerance 0 (K6's largest sum bound, "
        f"information: {err.get('win_scan:f64_bound', 0.0):.6g})")
    return {"rows": len(rows), "differ": differ,
            "max_abs_diff": float(diff.max()),
            "median_bound": float(np.median(bound)),
            "ms_per_flush": per_flush, "cpu_ms_per_flush": cpu_flush,
            "launches": launches, "err": err, "C": plan.C}


def phase_c1(torch, np, pkg) -> dict:
    """Phase 8: config 1 through the facade on the card (launch counts
    from 0) and on the CPU, then K1 on the plan's filter program over the
    batch's columns against its plain version."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval, expr_eval_plain
    tape = make_tape(C1_EVENTS, C1_EVENTS, KEYS, seed=2)
    kernels.reset_launches()
    rows, ms, rt = run_app(pkg, np, C1, tape, KEYS, "cuda")
    launches = dict(kernels.LAUNCHES)
    ref, _, _ = run_app(pkg, np, C1, tape, KEYS, "cpu")
    if rows != ref or not rows or launches["expr_eval:filter"] == 0:
        raise SystemExit(f"C1 differs or skipped the kernel: {len(rows)} "
                         f"vs {len(ref)}, {launches}")
    plan = rt.plans()[0]
    cols = [torch.from_numpy(np.ascontiguousarray(tape[0][k])).cuda()
            for k in plan._slot_keys]
    n = C1_EVENTS
    args = (cols, plan._mask_prog, plan._out_progs, n)
    wk, ok = expr_eval(*args, use="filter")
    wp, op = expr_eval_plain(*args)
    if not torch.equal(wk, wp) or not all(torch.equal(a, b)
                                          for a, b in zip(ok, op)):
        raise SystemExit("K1 filter differs from its plain version at C1")
    from siddhi_tpu_torch.kernels import expr_eval as k1
    k_ms, host = graph_ms(torch, lambda: expr_eval(*args, use="filter"),
                          lambda: [k1.prepare(*args, use="filter")])
    nbytes, ops = k1_work(torch, cols, plan._mask_prog, plan._out_progs, n)
    log(f"[c1] {len(rows)} rows equal to the CPU run; launches {launches}; "
        f"{ms[0]:.1f} ms for {n} events")
    return {"rows": len(rows), "ms": ms, "events": n, "launches": launches,
            "filter": {"ms": k_ms, "dispatch_ms": host,
                       "plain_ms": wall_ms(torch,
                                           lambda: expr_eval_plain(*args)),
                       "bytes": nbytes, "ops": ops, "library_ms": None}}


def window_work(name: str, a: tuple, kw: dict, out) -> tuple:
    """(bytes, operations) of one K6, K7 or K8 call and its result: each
    distinct input read once, each output written once."""
    if name == "win_scan":
        cols, n = a[0], a[1]
        valid, flags = (list(a[2:]) + [kw.get("valid"),
                                       kw.get("flags")])[:2]
        # one combine per column and entry
        nb = nbytes(*distinct(*[v[:n] for _o, v, _m in cols
                                if v is not None], valid, flags), *out)
        return nb, n * len(cols)
    if name == "win_range":
        sites = a[0]
        n, m = kw["n"], kw["m"]
        groups = kw["groups"]
        n_mm = sum(s[0] in ("min", "max") for s in sites)
        # grouped, the sorted keys alone (slot s holds entry ks[s] % n);
        # `valid` is read only by the min/max sites
        ins = [kw["vcnt"] if kw["kind"] == "length" else kw["clock"],
               groups[0] if groups else None, kw["valid"] if n_mm else None]
        for _op, pfx, cnt, vals, _dt in sites:
            ins += [pfx, cnt, vals]
        outs, start_k = out
        # the function's own bytes: the arrays the design writes between
        # its launches are its cost, not the function's (PERF.md row 8
        # gives them beside the bound)
        nb = nbytes(*distinct(*[t[:n] for t in ins if t is not None]),
                    *outs, start_k)
        log2n = max(n - 1, 1).bit_length()
        return nb, m * (log2n * (2 if groups else 1) + 2 * len(sites))
    cols, _fills, n = a[:3]
    mask = a[4] if len(a) > 4 else kw.get("mask")
    outs, k = out
    return nbytes(*distinct(*[c[:n] for c in cols], mask), *outs, k), n


def k6_library_ms(torch, a: tuple, kw: dict):
    """K6's yardsticks on one call: torch.cumsum along the entries of the
    call's own columns, masked and stacked beforehand ((columns, n) f64),
    so that it does the same scan work; and that work as PyTorch does it
    fastest (`flat`): one 1-D cumsum of the stacked entries, then each
    later column less the total before it (the same sums on exact data;
    two calls).  (None, None) where no PyTorch call computes the call
    (segment starts, or a min or max column)."""
    cols, n = a[0], a[1]
    valid, flags = (list(a[2:]) + [kw.get("valid"), kw.get("flags")])[:2]
    if flags is not None or kw.get("period") or \
            any(op != "sum" for op, *_ in cols):
        return None, None
    rows = []
    for _op, values, masked, *own in cols:
        x = torch.ones(n, dtype=torch.float64, device="cuda") \
            if values is None else values[:n].double()
        vc = own[0] if own else valid
        if masked and vc is not None:
            x = torch.where(vc[:n], x, torch.zeros_like(x))
        rows.append(x)
    stacked = torch.stack(rows)
    flat = stacked.flatten()

    def flat_scan():
        s = torch.cumsum(flat, 0).view(len(rows), n)
        return torch.sub(s[1:], s[:-1, -1:])
    return (library_ms(torch, lambda: torch.cumsum(stacked, dim=1)),
            library_ms(torch, flat_scan))


def window_kernel_metrics(torch, calls) -> dict:
    """Device, dispatch, plain and library time, bytes and operations of
    each window kernel (and K1 use) on its largest recorded call."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import win_compact as k8
    from siddhi_tpu_torch.kernels import win_range as k7
    from siddhi_tpu_torch.kernels import win_scan as k6
    from siddhi_tpu_torch.kernels.expr_eval import (expr_eval_plain,
                                                    unpack_mask)
    from siddhi_tpu_torch.core.window_device import KERNELS
    mods = {"win_scan": k6, "win_range": k7, "win_compact": k8}
    size = {"win_scan": lambda a, kw: a[1],
            "win_range": lambda a, kw: kw["n"],
            "win_compact": lambda a, kw: a[3],
            "expr_eval": lambda a, kw: a[3]}
    best: dict = {}
    for name, a, kw in calls:
        key = f"expr_eval:{kw['use']}" if name == "expr_eval" else name
        if key not in best or size[name](a, kw) >= size[name](*best[key][1:]):
            best[key] = (name, a, kw)
    res = {}
    for key, (name, a, kw) in best.items():
        fn = KERNELS[name]
        if name == "expr_eval":
            cols, mask_p, out_p, n = a
            ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
                k1.prepare(*a, **kw)])
            nb, ops = k1_work(torch, cols, mask_p, out_p, n)
            res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb,
                        "ops": ops, "library_ms": None, "n": n,
                        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
                            *a))}
            continue
        plain = getattr(mods[name], f"{name}_plain")
        ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
            mods[name].prepare(*a, **kw)])
        out = fn(*a, **kw)
        nb, ops = window_work(name, a, kw, out)
        lib = flat = None
        if name == "win_scan":
            lib, flat = k6_library_ms(torch, a, kw)
        elif name == "win_compact":
            cols, _fills, n = a[:3]
            mask = a[4] if len(a) > 4 else kw.get("mask")
            keep = torch.ones(n, dtype=torch.bool, device="cuda") \
                if mask is None else unpack_mask(mask, n)
            k = int(keep.sum())
            lib = library_ms(torch, lambda: [c.index_select(
                0, torch.nonzero_static(keep, size=k).flatten())
                for c in cols])
        res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
                    "library_ms": lib, "n": size[name](a, kw),
                    "plain_ms": wall_ms(torch, lambda: plain(*a, **kw))}
        if flat is not None:
            res[key]["library_flat_ms"] = flat
    return res


def phase_window(torch, np, label: str, app: str, seed: int,
                 want_kernels, plan_check=None) -> dict:
    """One window config on the card (launch counts from 0 just before its
    first flush, read just after its last; every kernel call recorded) and
    on the CPU: equal rows (tolerance 0), every kernel of the path
    launched, every recorded call equal to the plain version.  Then a
    timing run on the card, nothing recorded (the recording keeps every
    intermediate tensor alive, so the allocator cannot reuse them): ms per
    flush, the median of its steady flushes and events/s from that median;
    the kernels' times."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.kernels import win_range as k7
    from siddhi_tpu_torch.replay import run_window
    tape = make_tape(C2_FLUSH * C2_TIMED, C2_FLUSH, C2_SYMBOLS,
                     seed=seed)
    main = tape[:C2_FLUSHES]
    calls: list = []
    kernels.reset_launches()
    kernels.record_params("win_range", "win_compact")
    try:
        rows, per_flush, rt = run_window(app, main, "cuda", calls)
        launches = dict(kernels.LAUNCHES)
        k7_params = list(kernels.PARAMS["win_range"])
        k8_params = list(kernels.PARAMS["win_compact"])
    finally:
        kernels.record_params()
    ref, cpu_flush, _rt = run_window(app, main, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    need_launches(label, launches, want_kernels)
    plan = rt.plans()[0]
    if plan_check is not None:
        plan_check(plan, rows, main)
    _none, timed, _rt = run_window(app, tape, "cuda", rows=False)
    steady = sorted(timed[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    eps = C2_FLUSH / (med / 1e3)
    log(f"[{label}] {len(rows)} rows equal to the CPU run; C={plan.C}; "
        f"launches {launches}; recorded run ms per flush "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); timing run ms per flush "
        f"{[round(x, 2) for x in timed]}: median of {len(steady)} steady "
        f"{med:.2f} ms, {eps:.0f} events/s")
    err = check_window_calls(calls)
    log(f"  [{label}] {len(calls)} kernel calls equal to their plain "
        f"versions: {sorted(err)}")
    metrics = window_kernel_metrics(torch, calls)
    k7_calls = [kw for name, _a, kw in calls if name == "win_range"]
    if len(k7_params) != len(k7_calls):
        raise SystemExit(f"[{label}] {len(k7_params)} K7 launches for "
                         f"{len(k7_calls)} calls")
    for j, p in enumerate(k7_params):
        log(f"  [{label}] K7 call {j}: n={p.n}, {p.ntiles} tiles of "
            f"{k7.TILE}, queries over {p.qtiles} tiles, {p.launched} "
            f"kernel launches, {p.n_mm * 8 * k7.scratch_size(p.n, p.ntiles)}"
            f" bytes of min/max arrays between them")
        if not 1 <= p.launched <= 3:
            raise SystemExit(f"[{label}] K7 call {j} launched {p.launched} "
                             f"kernels, 1 to 3 wanted")
    if k7_params:
        # the widest call's, as window_kernel_metrics picks it
        p = k7_params[max(range(len(k7_calls)),
                          key=lambda j: (k7_calls[j]["n"], j))]
        metrics["win_range"].update(tiles=p.ntiles, tile=k7.TILE,
                                    launches_a_call=p.launched)
    # K8: one kernel launch a call, read from its launcher (a memset of
    # the look-back state besides, masked over more than one tile)
    k8_calls = [a for name, a, _kw in calls if name == "win_compact"]
    if len(k8_params) != len(k8_calls) or any(
            p.launched != 1 for p in k8_params):
        raise SystemExit(f"[{label}] K8: {len(k8_params)} launches for "
                         f"{len(k8_calls)} calls, kernels a launch "
                         f"{sorted({p.launched for p in k8_params})}")
    if k8_params:
        memsets = sum(p.state is not None for p in k8_params)
        log(f"  [{label}] K8: {len(k8_params)} calls, one kernel launch "
            f"each ({memsets} with a memset of the look-back state)")
        metrics["win_compact"]["launches_a_call"] = 1
    return {"rows": len(rows), "recorded_ms_per_flush": per_flush,
            "ms_per_flush": timed, "median_steady_ms": med, "C": plan.C,
            "cpu_ms_per_flush": cpu_flush, "events_per_s": eps,
            "launches": launches, "err": err, "kernels": metrics,
            "calls": len(calls)}


def check_c2_mean(np):
    """Config 2's `ap` against the exact f64 sliding mean of the last 1000
    prices, rounded to f32 (quarter-grid prices: the f64 prefixes are
    exact, and f32 division of exact operands rounds once)."""
    def check(plan, rows, tape):
        p = np.concatenate([f["price"] for f in tape])
        c = np.concatenate([[0.0], np.cumsum(p)])
        i = np.arange(1, len(p) + 1)
        lo = np.maximum(i - 1000, 0)
        mean = (c[i] - c[lo]) / (i - lo)
        ap = np.array([r[0] for _t, r in rows])
        if len(ap) != len(p) or not np.array_equal(
                mean.astype(np.float32), ap.astype(np.float32)):
            raise SystemExit("C2 ap differs from the exact sliding mean")
        log(f"  [c2] {len(ap)} ap values equal to the exact f64 sliding "
            f"mean rounded to f32")
    return check


def join_work(a: tuple, kw: dict, out) -> tuple:
    """(bytes, operations) of one K9 call: each probe column a program
    loads, the seqs and pass words, and the opposite mirror rows (Lo of
    them) and batch rows of each loaded opposite column read once; the
    written pairs, their computed columns, the miss words and the total
    written once.  Operations: one binary search step per probe and
    log2(n_o), and per visible pair (this run's data: the rank arithmetic
    of `visible`) the `on` program's instructions other than loads and
    constants (1 without `on`), per written pair the computed programs'."""
    from siddhi_tpu_torch.core.expr import decode_word
    from siddhi_tpu_torch.kernels.join_probe import visible
    p_cols, o_cols, p_seq, o_seq, p_pass, o_pass = a
    n_p, n_o, Lo, M = kw["n_p"], kw["n_o"], kw["Lo"], kw["M"]

    def work(prog):
        slots, ops = set(), 0
        for j in range(0, len(prog.words), 2):
            op = decode_word(prog.words[j])[0]
            if op == "load":
                slots.add(prog.words[j + 1])
            elif op != "const":
                ops += 1
        return slots, ops
    on_slots, on_ops = work(kw["on"]) if kw["on"] is not None else (set(), 1)
    outs = [work(p) for p in kw["outs"]]
    loaded = on_slots.union(*[s_ for s_, _o in outs])
    nb = 8 * (n_p + n_o)
    for i in loaded:
        if i < len(p_cols):
            nb += n_p * p_cols[i].element_size()
        else:
            nb += (Lo + n_o) * o_cols[i - len(p_cols)][0].element_size()
    nb += sum(-(-n // 32) * 4 for w, n in ((p_pass, n_p), (o_pass, n_o))
              if w is not None)
    total, _pa, _pb, out_cols, miss = out
    k = min(int(total[0]), M)
    nb += k * (8 + sum(c.element_size() for c in out_cols)) + 8
    nb += 0 if miss is None else miss.numel() * 4
    lo, hi, _idx = visible(p_seq, o_seq, p_pass, o_pass, n_p, n_o, Lo,
                           kw["Mw"])
    tests = int((hi - lo).sum())
    ops = n_p * max(n_o, 1).bit_length() + tests * on_ops + \
        k * sum(o_ for _s, o_ in outs)
    return nb, ops, tests


def join_kernel_metrics(torch, calls, probe_params) -> dict:
    """Device, dispatch, plain time, bytes and operations of K9 on its
    widest recorded call (probes x window) and of K1 `join_filter` on its
    largest, as `window_kernel_metrics` does for the window kernels; K9's
    kernel launches, probes a tile and window positions a chunk are those
    of that call on the main path's run (`probe_params`, the plan's
    parameter blocks of its recorded K9 launches, in call order)."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import join_probe as k9
    from siddhi_tpu_torch.kernels.expr_eval import expr_eval_plain
    from siddhi_tpu_torch.core.join_device import KERNELS
    best: dict = {}
    k9_at = 0
    for name, a, kw in calls:
        size = kw["n_p"] * max(kw["Mw"], 1) if name == "join_probe" else a[3]
        key = "join_probe" if name == "join_probe" else \
            f"expr_eval:{kw['use']}"
        if key not in best or size >= best[key][0]:
            best[key] = (size, name, a, kw,
                         probe_params[k9_at] if name == "join_probe" else
                         None)
        k9_at += name == "join_probe"
    res = {}
    for key, (_size, name, a, kw, params) in best.items():
        fn = KERNELS[name]
        if name == "expr_eval":
            cols, mask_p, out_p, n = a
            ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
                k1.prepare(*a, **kw)])
            nb, ops = k1_work(torch, cols, mask_p, out_p, n)
            res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb,
                        "ops": ops, "library_ms": None, "n": n,
                        "plain_ms": wall_ms(torch, lambda: expr_eval_plain(
                            *a))}
            continue
        ms, host = graph_ms(torch, lambda: fn(*a, **kw), lambda: [
            k9.prepare(*a, **kw)])
        nb, ops, tests = join_work(a, kw, fn(*a, **kw))
        res[key] = {"ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
                    "library_ms": None, "n": kw["n_p"], "pair_tests": tests,
                    "launches_a_call": params.launched, "tp": params.tp,
                    "chunk": params.chunk,
                    "plain_ms": wall_ms(torch, lambda: k9.join_probe_plain(
                        *a, **kw))}
    return res


def phase_join(torch, np, label: str, app: str, batch: int, flushes: int,
               filtered: bool, sides: str) -> dict:
    """Phases 17-20: a join app on bench.py's config 6 tape through the
    facade on the card (launch counts from 0 just before its first flush,
    read just after its last; every K1/K9 call recorded) and on the CPU:
    equal rows in order, NULLs in place; K9 launched at least once a flush
    for each side in `sides` and for no other (the plan's per-side tally);
    K1 `join_filter` launched exactly when `filtered`; every recorded call
    equal to its plain version.  Then an unrecorded timing run: ms per
    flush, the median of its steady flushes, events/s from it; the
    kernels' times."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import run_join
    tape = join_tape(batch * flushes, batch)
    calls: list = []
    kernels.reset_launches()
    rows, per_flush, rt = run_join(app, tape, "cuda", calls)
    launches = dict(kernels.LAUNCHES)
    ref, cpu_flush, _rt = run_join(app, tape, "cpu")
    if rows != ref or not rows:
        raise SystemExit(f"[{label}] rows differ from the CPU run: "
                         f"{len(rows)} vs {len(ref)}")
    plan = rt.plans()[0]
    probes = dict(plan.probe_calls)
    # the kernels each K9 call of the run launched: the probe kernel, and
    # the rank scan first under an opposite filter
    want = [2 if a[5] is not None else 1 for name, a, _kw in calls
            if name == "join_probe"]
    got = [q.launched for q in plan.probe_params]
    if got != want:
        raise SystemExit(f"[{label}] K9 kernel launches a call {got}, "
                         f"wanted {want}")
    if any(probes[k] < flushes for k in sides) or \
            any(probes[k] for k in "LR" if k not in sides) or \
            launches["join_probe"] != sum(probes.values()):
        raise SystemExit(f"[{label}] K9 calls per side {probes}, launches "
                         f"{launches['join_probe']}, wanted >= {flushes} "
                         f"for {sides!r}")
    k1 = ("expr_eval:join_filter",)
    need_launches(label, launches, ("join_probe",) + (k1 if filtered else ()),
                  () if filtered else k1)
    nulls = sum(1 for _t, r in rows if None in r)
    if filtered and not nulls:
        raise SystemExit(f"[{label}] an outer join without NULL rows")
    err = check_join_calls(calls)
    log(f"  [{label}] {len(calls)} kernel calls ({err['pairs']} pairs) equal "
        f"to their plain versions")
    _r, timed, _rt = run_join(app, tape, "cuda")
    steady = sorted(timed[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    eps = batch / (med / 1e3)
    log(f"[{label}] {len(rows)} rows ({nulls} with NULLs) equal to the CPU "
        f"run; K9 calls per side {probes}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; recorded run ms per "
        f"flush {[round(x, 2) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); timing run "
        f"{[round(x, 2) for x in timed]}: median of {len(steady)} steady "
        f"{med:.3f} ms, {eps:.0f} events/s")
    metrics = join_kernel_metrics(torch, calls, plan.probe_params)
    k9m = metrics["join_probe"]
    log(f"  [{label}] K9 on its widest call: {k9m['launches_a_call']} kernel "
        f"launch(es) a call, {k9m['tp']} probes a tile, {k9m['chunk']} "
        f"window positions a chunk, {k9m['pair_tests']} pair tests, "
        f"{k9m['ms']:.4f} ms")
    return {"rows": len(rows), "null_rows": nulls, "probe_calls": probes,
            "recorded_ms_per_flush": per_flush, "ms_per_flush": timed,
            "median_steady_ms": med, "events_per_s": eps,
            "cpu_ms_per_flush": cpu_flush, "launches": launches,
            "err": {k: v for k, v in err.items() if k != "pairs"},
            "pairs": err["pairs"], "calls": len(calls), "M": plan._m_hint,
            "kernels": metrics}


def agg_merge_work(torch, a: tuple, kw: dict) -> tuple:
    """(bytes, f64 operations, chain) of one K10 call: `order`, the value
    rows the bases read, `seg_off`, `slot` and `fresh` read once, the m x
    nb ring cells read and written once; an add or compare per event and
    non-count base plus one merge per segment and base; the chain is the
    longest segment (its dependent adds run one after another)."""
    _pre, vals, order, seg_off, slot, fresh = a
    ops_, rows = kw["ops"], kw["rows"]
    n, m, nb = order.shape[0], slot.shape[0], len(ops_)
    read = {r for op, r in zip(ops_, rows) if op != "count"}
    nbytes_ = nbytes(order, seg_off, slot, fresh) + 8 * n * len(read) + \
        16 * m * nb
    lens = (seg_off[1:] - seg_off[:-1])
    chain = int(lens.max()) if m else 0
    return nbytes_, n * sum(op != "count" for op in ops_) + m * nb, chain


def agg_kernel_metrics(torch, calls) -> dict:
    """Device, dispatch, plain and library time, bytes, operations and
    chain of K10 (or K6 use `agg`) on its widest recorded call (segments x
    bases plus the longest segment).  K10 merges in place, so its replays
    run on a scratch copy of the ring."""
    from siddhi_tpu_torch.kernels import agg_merge as k10
    from siddhi_tpu_torch.kernels import win_scan as k6
    best = None
    for name, a, kw in calls:
        size = a[4].shape[0] * len(kw["ops"]) + \
            agg_merge_work(torch, a, kw)[2] if name == "agg_merge" else a[1]
        if best is None or size >= best[0]:
            best = (size, name, a, kw)
    _size, name, a, kw = best
    if name == "win_scan":
        ms, host = graph_ms(torch, lambda: k6.win_scan(*a, **kw),
                            lambda: [k6.prepare(*a, **kw)])
        nb, ops = window_work("win_scan", a, kw, k6.win_scan(*a, **kw))
        return {"ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
                "library_ms": None, "n": a[1],
                "plain_ms": wall_ms(torch, lambda: k6.win_scan_plain(
                    *a, flags=kw["flags"]))}
    pre, rest = a[0], a[1:]
    scratch = pre.clone()
    ms, host = graph_ms(torch, lambda: k10.agg_merge(scratch, *rest, **kw),
                        lambda: [k10.prepare(scratch, *rest, **kw)])
    nb, ops, chain = agg_merge_work(torch, a, kw)
    plain_ms = wall_ms(torch, lambda: k10.agg_merge_plain(
        pre.clone(), *rest, **kw))
    # the library yardstick: scatter_reduce_ of each op kind over the
    # event-order segment ids (no fixed fold order, no merge)
    vals, order, seg_off = rest[0], rest[1].long(), rest[2].long()
    m, n = rest[3].shape[0], order.shape[0]
    inv = torch.empty(n, dtype=torch.long, device=order.device)
    inv[order] = torch.repeat_interleave(
        torch.arange(m, device=order.device), seg_off[1:] - seg_off[:-1])
    ones = torch.ones(1, n, dtype=torch.float64, device=order.device)
    groups = []
    for kind, want in (("sum", ("sum", "count")), ("amin", ("min",)),
                       ("amax", ("max",))):
        src = [ones if op == "count" else vals[r:r + 1]
               for op, r in zip(kw["ops"], kw["rows"]) if op in want]
        if src:
            s_ = torch.cat(src).T.contiguous()
            groups.append((kind, s_, inv[:, None].expand_as(s_).contiguous()))

    def library():
        return [torch.zeros(m, s_.shape[1], dtype=torch.float64,
                            device=s_.device).scatter_reduce_(
            0, idx, s_, kind, include_self=False)
            for kind, s_, idx in groups]
    # the chain bound: one thread doing the longest segment's dependent
    # adds from registers
    probe = k10.chain_probe(chain, order.device)
    chain_ms, _host = graph_ms(torch, probe, lambda: [probe])
    return {"ms": ms, "dispatch_ms": host, "bytes": nb, "ops": ops,
            "f64": True, "chain": chain, "chain_ms": chain_ms, "n": n,
            "m": m, "plain_ms": plain_ms,
            "library_ms": library_ms(torch, library)}


def phase_agg(torch, np, label: str, flushes: int, batch: int,
              grouped: bool, query_every: bool, always: bool) -> dict:
    """Phases 22-26: bench.py's aggregation matrix app on its tape (seed
    13, 1024 keys) through the facade on the card (launch counts from 0
    just before the first flush, read just after the last; every K10 or
    K6 `agg` call recorded with its inputs, K10's with the ring's state
    before it) and on the CPU: equal stores and query rows per sec, min
    and hour (tolerance 0), and with `query_every` equal rows from the
    store query after every flush; K10 launched 3 times a flush (K6 `agg`
    not), or under 'always' K6 `agg` 3 times a flush (K10 not); every
    recorded call equal to its plain version.  Then an unrecorded timing
    run: the median ms of its steady flushes, events/s from it."""
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.query.ast import Duration
    from siddhi_tpu_torch.replay import run_agg
    head = "@app:deviceAggregations('always')\n" if always else ""
    app = MATRIX_APP(head, grouped)
    tape = matrix_tape(flushes, batch, AGG_KEYS)
    calls: list = []           # A7M records nothing: A7 checks its path
    kernels.reset_launches()
    per_flush, qlat, qrows, rt = run_agg(app, tape, "cuda",
                                         None if query_every else calls,
                                         query_every=int(query_every))
    launches = dict(kernels.LAUNCHES)
    cpu_flush, _ql, cpu_q, ref = run_agg(app, tape, "cpu",
                                         query_every=int(query_every))
    agg, ref_agg = rt.aggregations["Roll"], ref.aggregations["Roll"]
    rows = agg_rows(rt)
    if rows != agg_rows(ref) or not all(rows.values()) or \
            agg.state_dict() != ref_agg.state_dict() or qrows != cpu_q:
        raise SystemExit(f"[{label}] stores or rows differ from the CPU run")
    path = rt.explain()["aggregations"]["Roll"]["path"]
    used, unused = ("win_scan:agg", "agg_merge") if always else \
        ("agg_merge", "win_scan:agg")
    if path != ("device-batch" if always else "device-resident") or \
            launches[used] != 3 * flushes or launches[unused]:
        raise SystemExit(f"[{label}] path {path}, launches {launches}")
    cap = None if always else agg.device_plan.capacity(Duration.SECONDS)
    if cap is not None and grouped and cap <= 1024:
        raise SystemExit(f"[{label}] the sec ring did not grow ({cap})")
    err = check_agg_calls(calls)
    if calls:
        log(f"  [{label}] {len(calls)} kernel calls equal to their plain "
            f"versions: {sorted(err)}")
    _ms, _q, _r, _rt = run_agg(app, tape[:1], "cuda")   # warm
    timed, _q, _r, _rt = run_agg(app, tape, "cuda")
    steady = sorted(timed[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    eps = batch / (med / 1e3)
    q = {}
    if qlat:
        ql = sorted(qlat)
        q = {"query_p50_ms": float(np.percentile(ql, 50)),
             "query_p99_ms": float(np.percentile(ql, 99)),
             # without the first query, which compiles it
             "query_p99_warm_ms": float(np.percentile(qlat[1:], 99)),
             "query_ms": qlat}
    live = {per: len(r) for per, r in rows.items()}
    log(f"[{label}] path {path}, buckets {live} equal to the CPU run; sec "
        f"ring {cap}; launches { {k: v for k, v in launches.items() if v} }; "
        f"recorded run ms per flush {[round(x, 2) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); timing run "
        f"{[round(x, 2) for x in timed]}: median of {len(steady)} steady "
        f"{med:.3f} ms, {eps:.0f} events/s"
        + (f"; store query p50 {q['query_p50_ms']:.3f} ms, p99 "
           f"{q['query_p99_ms']:.3f} ms of {len(qlat)} "
           f"({q['query_p99_warm_ms']:.3f} ms without the first, "
           f"compiling one)" if q else ""))
    return {"buckets": live, "ring": cap, "launches": launches, "err": err,
            "recorded_ms_per_flush": per_flush, "ms_per_flush": timed,
            "median_steady_ms": med, "events_per_s": eps,
            "cpu_ms_per_flush": cpu_flush, "flush_events": batch,
            "calls": len(calls), **q,
            "kernels": agg_kernel_metrics(torch, calls) if calls else None}


def host_cpu() -> str:
    """The host CPU as lscpu names it: its `Model name` (which a virtual
    machine may give as `unknown`) with the vendor, family, model and CPU
    count (/proc/cpuinfo's fields where lscpu is missing)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except OSError:
        out = ""
    fields = {}
    for line in out.splitlines():           # newer lscpu indents fields
        k, _, v = line.strip().partition(":")
        fields.setdefault(k.strip(), v.strip())
    if not fields:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                k, _, v = line.partition(":")
                fields.setdefault(k.strip(), v.strip())
        fields = {"Model name": fields.get("model name"),
                  "Vendor ID": fields.get("vendor_id"),
                  "CPU family": fields.get("cpu family"),
                  "Model": fields.get("model")}
    return ", ".join(f"{k} {fields[k]}" for k in (
        "Model name", "Vendor ID", "CPU family", "Model", "CPU(s)")
        if fields.get(k)) or "unknown"


def host_profile(fn, names) -> dict:
    """Run fn() under cProfile; the cumulative ms of each function named
    `file suffix:function` in `names`, keyed `file suffix:function:line`
    (a file may define two functions of one name), and the profiled wall
    ms as `total`."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    out = {"total": (time.perf_counter() - t0) * 1e3}
    for (path, line, func), (_cc, _nc, _tt, ct, _callers) in \
            pstats.Stats(prof).stats.items():
        for nm in names:
            suffix, f = nm.split(":")
            if func == f and path.replace(os.sep, "/").endswith(suffix):
                out[f"{nm}:{line}"] = ct * 1e3
    return out


def feed_flush(rt, np, f: dict, keys: int) -> None:
    """One flush of a make_tape tape into StockStream, as run_app and
    replay.run_window send it."""
    codes = np.array([rt.strings.encode(f"K{i}") for i in range(keys)],
                     dtype=np.int32)
    rt.input_handler("StockStream").send_batch(
        {"symbol": codes[f["sym_idx"]], "price": f["price"],
         "volume": f["volume"]}, f["ts"])
    rt.flush()


def no_launches(label: str) -> None:
    from siddhi_tpu_torch import kernels
    used = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if used:
        raise SystemExit(f"{label}: the host run launched kernels {used}")


def phase_host_patterns(torch, np, pkg) -> dict:
    """Phase 45: the flagship C4 (1000 keys, deviceSlots(32)) and C3 under
    @app:devicePatterns('never') through SiddhiManager(device="cuda"): the
    host matcher (C4: a PartitionGroup and a clone a key) launches no
    kernel; the same tape through the device `scan` plan on the card
    launches K1 and K3-K5 and gives the same rows (sorted: the clones and
    the lanes interleave keys differently).  events/s of both; one more
    host flush under cProfile (host ms of the layers)."""
    from siddhi_tpu_torch import kernels
    scan_k = ("seg_tree", "scan_chase", "scan_compact",
              "expr_eval:pre_mask", "expr_eval:select")
    n = HOST_FLUSH * N_FLUSH
    log(f"[host] C4 and C3 at {N_FLUSH} flushes of {HOST_FLUSH} events "
        f"(phase 4's {FLUSH} a flush cut for the host runs), {KEYS} keys")
    out = {}
    for label, app, kinds in (
            ("c4", C4_HEAD + C4, {"PartitionGroup", "InterpPatternQueryPlan"}),
            ("c3", C3, {"InterpPatternQueryPlan"})):
        tape = make_tape(n + HOST_FLUSH, HOST_FLUSH, KEYS, seed=45)
        kernels.reset_launches()
        host, host_ms, hrt = run_app(pkg, np, NEVER + app, tape[:N_FLUSH],
                                     KEYS, "cuda")
        no_launches(f"{label} host")
        got = {type(p).__name__ for p in hrt.plans()}
        if got != kinds:
            raise SystemExit(f"{label} under 'never' planned {got}")
        kernels.reset_launches()
        dev, dev_ms, drt = run_app(pkg, np, app, tape[:N_FLUSH], KEYS, "cuda")
        launches = dict(kernels.LAUNCHES)
        if drt.plans()[0].family != "scan":
            raise SystemExit(f"{label} device run planned "
                             f"{drt.plans()[0].family!r}")
        need_launches(f"{label} device", launches, scan_k, ("nfa_block",))
        check_rows(f"{label} host", host, dev)
        prof = host_profile(lambda: feed_flush(hrt, np, tape[N_FLUSH], KEYS),
                            HOST_PATTERN_FNS)
        host_eps = n / (sum(host_ms) / 1e3)
        dev_eps = n / (sum(dev_ms) / 1e3)
        log(f"[{label} host] {len(host)} matches equal to the card's `scan` "
            f"run; {len(hrt.plans())} plans, no kernel launched; host "
            f"matcher ms per flush {[round(x, 1) for x in host_ms]}, "
            f"{host_eps:.0f} events/s; device ms per flush "
            f"{[round(x, 1) for x in dev_ms]}, {dev_eps:.0f} events/s "
            f"(launches {launches})")
        log(f"  [{label} host] cProfile of one more flush of {HOST_FLUSH}, "
            f"cumulative ms: " + ", ".join(
                f"{k} {v:.1f}" for k, v in prof.items()))
        out[f"{label}_host"] = {
            "matches": len(host), "events": n, "plans": len(hrt.plans()),
            "host_ms_per_flush": host_ms, "host_events_per_s": host_eps,
            "device_ms_per_flush": dev_ms, "device_events_per_s": dev_eps,
            "device_launches": launches, "profile_ms": prof}
    return out


def phase_mixed(torch, np, pkg) -> dict:
    """Phase 46: replay.MIXED on the card -- C4's query on the device
    beside an `e[last-2]` selector and a `group by` aggregate (per-key
    host clones in C4's partition), `output every 5 events` (the host
    matcher) and a range-partitioned pattern (clones): each query planned
    where the routing puts it, one RuntimeWarning for each host query;
    the device query launches K1 and K3-K5 and every block it recorded
    holds them to their plain versions (phase 5's check); every query's
    rows equal the device="cpu" run's."""
    scan_k = ("seg_tree", "scan_chase", "scan_compact",
              "expr_eval:pre_mask", "expr_eval:select")
    tape = make_tape(MIXED_FLUSH * MIXED_FLUSHES, MIXED_FLUSH, KEYS, seed=46)
    box = {}

    def runner(_pkg, _np, app, tape_, keys, device):
        rows, ms, rt, box["warned"] = run_mixed(app, tape_, device, keys)
        return rows, ms, rt
    rows, ms, launches, rt, blocks, _ = run_recorded(pkg, np, MIXED, tape,
                                                     runner=runner)
    place = mixed_placement(rt)
    want = {"dev": "device:scan", "last2": "clones", "agg": "clones",
            "rate": "host", "range": "clones"}
    if place != want:
        raise SystemExit(f"mixed: planned {place}, expected {want}")
    warned = sorted(w.split(" runs on ")[0] for w in box["warned"])
    if warned != [f"query {q!r}" for q in ("agg", "last2", "range",
                                           "rate")]:
        raise SystemExit(f"mixed: warnings {box['warned']}")
    need_launches("mixed", launches, scan_k, ("nfa_block",))
    ref, cpu_ms, _rt, _w = run_mixed(MIXED, tape, "cpu")
    for q in MIXED_QUERIES:
        if sorted(rows[q]) != sorted(ref[q]) or not rows[q]:
            raise SystemExit(f"mixed {q}: rows differ from the CPU run: "
                             f"{len(rows[q])} vs {len(ref[q])}")
    b = phase_scan_blocks(torch, blocks, "mixed")
    log(f"[mixed] placement {place}; warnings {box['warned']}; rows "
        f"{ {q: len(r) for q, r in rows.items()} } equal to the CPU run; "
        f"launches {launches}; {b['blocks']} device blocks equal to plain; "
        f"ms per flush {[round(x, 1) for x in ms]} (cpu "
        f"{[round(x) for x in cpu_ms]})")
    return {"placement": place, "warnings": box["warned"],
            "rows": {q: len(r) for q, r in rows.items()},
            "launches": launches, "ms_per_flush": ms, "blocks": b["blocks"]}


def phase_host_single(torch, np, pkg) -> dict:
    """Phase 47: C1 under @app:deviceFilters('never') (the host
    interpreter; 2^18 events, C1's 2^20 cut) gives the card's K1 run's
    rows exactly, in order; C2 under @app:deviceWindows('never') on phase
    10's tape (2 flushes of 2^17) gives the device window plan's rows
    within rel 2e-5, abs 2e-4 (the host sums in float64, the device in
    float32), the number of rows that differ logged; neither host run
    launches a kernel.  One more C2 host flush under cProfile."""
    import math

    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.replay import run_window
    tape = make_tape(HOST_C1_EVENTS, HOST_C1_EVENTS, KEYS, seed=2)
    kernels.reset_launches()
    host, host_ms, hrt = run_app(pkg, np, "@app:deviceFilters('never')\n" +
                                 C1, tape, KEYS, "cuda")
    no_launches("c1 host")
    kernels.reset_launches()
    dev, dev_ms, drt = run_app(pkg, np, C1, tape, KEYS, "cuda")
    if not kernels.LAUNCHES["expr_eval:filter"]:
        raise SystemExit("c1 device run launched no K1 filter")
    kinds = (type(hrt.plans()[0]).__name__, type(drt.plans()[0]).__name__)
    if kinds != ("InterpSingleQueryPlan", "FilterProjectPlan") or \
            host != dev or not host:
        raise SystemExit(f"c1 host: {kinds}, {len(host)} rows vs "
                         f"{len(dev)} (or not equal)")
    c1_eps = HOST_C1_EVENTS / (sum(host_ms) / 1e3)
    log(f"[c1 host] {len(host)} rows equal to the card's K1 run; host "
        f"{host_ms[0]:.1f} ms ({c1_eps:.0f} events/s), device "
        f"{dev_ms[0]:.1f} ms for {HOST_C1_EVENTS} events")
    tape = make_tape(C2_FLUSH * (C2_FLUSHES + 1), C2_FLUSH, C2_SYMBOLS,
                     seed=20)
    kernels.reset_launches()
    host, host_ms, hrt = run_window("@app:deviceWindows('never')\n" + C2,
                                    tape[:C2_FLUSHES], "cuda")
    no_launches("c2 host")
    dev, dev_ms, drt = run_window(C2, tape[:C2_FLUSHES], "cuda")
    kinds = (type(hrt.plans()[0]).__name__, type(drt.plans()[0]).__name__)
    if kinds != ("InterpSingleQueryPlan", "DeviceWindowAggPlan") or \
            len(host) != len(dev) or not host:
        raise SystemExit(f"c2 host: {kinds}, {len(host)} rows vs {len(dev)}")
    differ, worst = 0, 0.0
    for (th, rh), (td, rd) in zip(host, dev):
        if th != td or len(rh) != len(rd):
            raise SystemExit(f"c2 host row at {th} vs {td}")
        for a, b in zip(rh, rd):
            if not math.isclose(b, a, rel_tol=2e-5, abs_tol=2e-4):
                raise SystemExit(f"c2 host {rh} vs device {rd} at {th}: "
                                 f"outside rel 2e-5, abs 2e-4")
            worst = max(worst, abs(a - b))
        differ += rh != rd
    # replay.run_window encodes K0..K63
    prof = host_profile(lambda: feed_flush(hrt, np, tape[C2_FLUSHES], 64),
                        HOST_SINGLE_FNS)
    c2_eps = C2_FLUSH * C2_FLUSHES / (sum(host_ms) / 1e3)
    log(f"[c2 host] {len(host)} rows within rel 2e-5, abs 2e-4 of the "
        f"device window plan's, {differ} differ (largest |host - device| "
        f"{worst:.3g}); host ms per flush {[round(x, 1) for x in host_ms]} "
        f"({c2_eps:.0f} events/s), device {[round(x, 2) for x in dev_ms]}")
    log(f"  [c2 host] cProfile of one more flush of {C2_FLUSH}, cumulative "
        f"ms: " + ", ".join(f"{k} {v:.1f}" for k, v in prof.items()))
    return {"c1": {"rows": len(host), "events": HOST_C1_EVENTS,
                   "host_ms": host_ms, "device_ms": dev_ms,
                   "host_events_per_s": c1_eps},
            "c2": {"rows": len(host), "differ": differ, "max_abs": worst,
                   "host_ms_per_flush": host_ms, "device_ms_per_flush": dev_ms,
                   "host_events_per_s": c2_eps, "profile_ms": prof}}


def kernel_entry(name, source, replaces, launches, err, m) -> dict:
    bound_ms, by = bound(m["bytes"], m["ops"], m.get("f64", False))
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": m["ms"], "dispatch_ms": m["dispatch_ms"],
             "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
             "bound_by": by, "library_ms": m["library_ms"]}
    for extra in ("chain_ms", "library_flat_ms", "f32_twin_ms", "step_ns",
                  "tt", "wpb", "pair_tests", "launches_a_call", "tp",
                  "chunk", "trees_built", "lanes_x_trees", "programs",
                  "ms_per_program", "depth", "grid", "tiles", "warps",
                  "rows_a_thread", "tile", "blocks", "threads",
                  "smem_bytes"):
        if extra in m:
            entry[extra] = m[extra]
    return entry


def check_rows(label: str, dev_out: list, ref_out: list) -> None:
    if sorted(dev_out) != sorted(ref_out) or not dev_out:
        raise SystemExit(f"{label} rows differ from the CPU run: "
                         f"{len(dev_out)} vs {len(ref_out)}")
    for _ts, row in dev_out:
        if not (row[0] > 100 and all(b > a for a, b in zip(row, row[1:]))):
            raise SystemExit(f"{label} row breaks the pattern: {row}")


def one_pre_mask_launch(label: str, launches: dict, blocks) -> None:
    """K1 `pre_mask` launched once for each recorded `scan` block with a
    pre-mask program, however many programs the block has (each block's
    launch holding all of them)."""
    want = progs = 0
    for k, ev, _m in blocks:
        n = sum(p is not None for p in k.nfak.pre_progs)
        if n:
            main_params(label, ev, "expr_eval:pre_mask", n)
        want += n > 0
        progs += n
    if launches["expr_eval:pre_mask"] != want:
        raise SystemExit(f"{label}: {launches['expr_eval:pre_mask']} K1 "
                         f"pre-mask launches for {want} blocks")
    log(f"  [{label}] K1 pre-masks: {want} launches for {progs} programs "
        f"over {len(blocks)} blocks")


def need_launches(label: str, launches: dict, used, unused=()) -> None:
    if min(launches[k] for k in used) == 0 or \
            any(launches[k] for k in unused):
        raise SystemExit(f"{label}: launches {launches} (expected "
                         f"{list(used)} above 0, {list(unused)} at 0)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import build

    t_start = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or \
                    "entry function" in line:
                log(f"  {name}: {line.strip()}")

    # 3. K1 vs plain over a battery of programs
    t0 = time.perf_counter()
    k1_err = phase_k1(torch, np, 1 << 18)
    log(f"[k1] equal to plain ({time.perf_counter() - t0:.1f} s)")

    # 4. the main path: C4 at default settings (`scan`) on the card, then
    #    the same tape on the CPU
    scan_k = ("seg_tree", "scan_chase", "scan_compact",
              "expr_eval:pre_mask", "expr_eval:select")
    tape = make_tape(FLUSH * N_FLUSH, FLUSH, KEYS)
    dev_out, per_flush, c4_launches, rt, blocks, _ = run_recorded(
        pkg, np, C4_HEAD + C4, tape)
    plan = rt.plans()[0]
    if plan.family != "scan":
        raise SystemExit(f"C4 planned {plan.family!r}, expected 'scan'")
    ref_out, cpu_flush, _ = run_app(pkg, np, C4_HEAD + C4, tape, KEYS, "cpu")
    check_rows("C4", dev_out, ref_out)
    need_launches("C4", c4_launches, scan_k, ("nfa_block",))
    one_pre_mask_launch("c4", c4_launches, blocks)
    steady = per_flush[1:]
    eps = FLUSH / (sum(steady) / len(steady) / 1e3)
    log(f"[c4] {len(dev_out)} matches equal to the CPU run; family "
        f"{plan.family}; launches {c4_launches}; per flush ms "
        f"{[round(x, 1) for x in per_flush]} (cpu "
        f"{[round(x) for x in cpu_flush]}); {eps:.0f} events/s "
        f"(blocks={plan.blocks_run})")

    # 5. K3, K4, K5 and K1 vs plain on the main path's own blocks
    t0 = time.perf_counter()
    c4b = phase_scan_blocks(torch, blocks, "c4")
    log(f"[c4 blocks] {c4b['blocks']} blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    del blocks

    # 6. C3 unpartitioned: the flat block
    c3_tape = make_tape(FLUSH * C3_FLUSHES, FLUSH, KEYS, seed=3)
    c3_out, c3_flush, c3_launches, c3_rt, c3_blocks, _ = run_recorded(
        pkg, np, C3, c3_tape)
    if c3_rt.plans()[0].family != "scan":
        raise SystemExit("C3 did not plan the `scan` family")
    c3_ref, c3_cpu, _ = run_app(pkg, np, C3, c3_tape, KEYS, "cpu")
    check_rows("C3", c3_out, c3_ref)
    need_launches("C3", c3_launches, scan_k, ("nfa_block",))
    c3b = phase_scan_blocks(torch, c3_blocks, "c3")
    log(f"[c3] {len(c3_out)} matches equal to the CPU run; launches "
        f"{c3_launches}; per flush ms {[round(x, 1) for x in c3_flush]} "
        f"(cpu {[round(x) for x in c3_cpu]}); Lt={c3b['Lt']}")
    del c3_blocks

    # 7. C4 on the `seq` family: the K2 path
    seq_tape = tape[:SEQ_FLUSHES]
    seq_out, seq_flush, seq_launches, seq_rt, _, seq_blocks = run_recorded(
        pkg, np, C4_SEQ + C4_HEAD + C4, seq_tape)
    seq_ref, seq_cpu, _ = run_app(pkg, np, C4_SEQ + C4_HEAD + C4, seq_tape,
                                  KEYS, "cpu")
    check_rows("C4 seq", seq_out, seq_ref)
    need_launches("C4 seq", seq_launches,
                  ("nfa_block", "expr_eval:pre_mask", "expr_eval:select"),
                  ("seg_tree", "scan_chase", "scan_compact"))
    sp = seq_rt.plans()[0]
    log(f"[c4 seq] {len(seq_out)} matches equal to the CPU run; launches "
        f"{seq_launches}; per flush ms {[round(x, 1) for x in seq_flush]} "
        f"(cpu {[round(x) for x in seq_cpu]}) (P={sp.P} A={sp.kernel.A} "
        f"blocks={sp.blocks_run})")
    t0 = time.perf_counter()
    blk = phase_blocks(torch, seq_blocks)
    log(f"[seq blocks] {blk['blocks']} blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")
    del seq_blocks

    # 8. C1 filter
    c1 = phase_c1(torch, np, pkg)

    # 9. C5: 1000 fused queries, absent deadlines, timer ticks
    t0 = time.perf_counter()
    c5 = phase_c5(torch, np, pkg)
    log(f"[c5 blocks] {c5['k2']['blocks']} K2 blocks ({c5['k2']['fired_blocks']} "
        f"with fired deadlines, {c5['k2']['tick_blocks']} ticks) and "
        f"{c5['scan']['blocks']} scan blocks equal to plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # 10-12. the window configs: C2 (the main path of this slice), the
    #        grouped filtered time window (carry growth), C2B (tumbling)
    win_k = ("expr_eval:window_args", "expr_eval:window_select", "win_scan",
             "win_compact")
    t0 = time.perf_counter()
    c2 = phase_window(torch, np, "c2", C2, 20, win_k + ("win_range",),
                      check_c2_mean(np))

    def grown(plan, _rows, _tape):
        if plan.C <= DeviceWindowAggPlan.C_START:
            raise SystemExit(f"C2 grouped: the carry did not grow ({plan.C})")
    from siddhi_tpu_torch.core.window_device import DeviceWindowAggPlan
    c2g = phase_window(torch, np, "c2 grouped", C2_GROUPED, 21,
                       win_k + ("win_range",), grown)
    c2b = phase_window(torch, np, "c2b", C2B, 22, win_k)
    log(f"[windows] {time.perf_counter() - t0:.1f} s")

    # 13-16. the pattern algebra: counts (C4N `scan`, C4Ns `seq`), `and`
    #        (C4A `scan`), `or` with NULLs (C4O `seq`)
    alg = {}
    for label, app, flushes, family, seed, extra, null_col in ALGEBRA:
        t0 = time.perf_counter()
        alg[label] = phase_algebra(torch, np, pkg, label, app, flushes,
                                   family, seed, extra, null_col)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")

    # 17-20. the window joins: config 6 at bench.py's flush (J6) and at
    #        2^17 (J6W), filtered full outer (J6O), unidirectional (J6U)
    joins = {}
    for label, app, batch, flushes, filtered, sides in JOINS:
        t0 = time.perf_counter()
        joins[label] = phase_join(torch, np, label, app, batch, flushes,
                                  filtered, sides)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")

    # 22-26. incremental aggregation: bench.py's matrix rollup at 4096
    #        (A7) and 2^17 (A7W) a flush, a global rollup (A7G), a store
    #        query after every flush (A7M), the per-batch path (A7A)
    aggs = {}
    for label, flushes, batch, grouped, query_every, always in AGGS:
        t0 = time.perf_counter()
        aggs[label] = phase_agg(torch, np, label, flushes, batch, grouped,
                                query_every, always)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")

    # 27-31. K2's EXT instantiation: an `every` absent head (C4H), a min-0
    #        count head with presence (C4Z), `every` below the head with
    #        4 slots (C4F), absent `or`/`and` sides (C4L), an unpartitioned
    #        absent head on the wall clock (C3H)
    ext = {}
    for label, app, seed in EXT:
        t0 = time.perf_counter()
        ext[label] = phase_ext(torch, np, pkg, label, app, seed)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ext["c3h"] = phase_c3h(torch, np, pkg)
    log(f"[c3h phase] {time.perf_counter() - t0:.1f} s")

    # 32-36. the stateless `chunk` (C3K, C3X, C3E) and `dfa` (C3SD, C4D)
    #        families
    sl = {}
    for label, app, n, flushes, keys, seed, family, cmp_app in STATELESS:
        t0 = time.perf_counter()
        sl[label] = phase_stateless(torch, np, pkg, label, app, n, flushes,
                                    keys, seed, family, cmp_app)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")

    # 37-44. @app:devicePrecision('f64'): C4F64 at full width (`scan`,
    #        K3-K5 in float64), then at a smaller depth C4 on `seq`, C4F
    #        (EXT), C4 at A = 256 (wide), C3K (`chunk`), C3SD (`dfa`), C5's
    #        fused groups (float64 lane parameters) and C2's window on
    #        wide-range raw doubles
    t0 = time.perf_counter()
    f64 = {"c4f64": phase_c4f64(torch, np, pkg)}
    log(f"[c4f64 phase] {time.perf_counter() - t0:.1f} s")
    for label, app, n, flushes, keys, seed, band, family, need, timed in \
            F64_PHASES:
        t0 = time.perf_counter()
        f64[label] = phase_f64(torch, np, pkg, label, app, n, flushes, keys,
                               seed, band, family, need, timed)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f64["c5 f64"] = phase_c5f64(torch, np, pkg)
    log(f"[c5 f64 phase] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f64["c2 f64"] = phase_c2f64(torch, np)
    log(f"[c2 f64 phase] {time.perf_counter() - t0:.1f} s")

    # 45-47. the host plans: C4 and C3 on the host matcher against the
    #        card's `scan` run, a device query beside host queries in one
    #        app, C1 and C2 on the host interpreter against the card's runs
    cpu_model = host_cpu()
    log(f"[host] host CPU: {cpu_model}; card: {smi}")
    host = {"cpu": cpu_model}
    for label, fn in (("host patterns", phase_host_patterns),
                      ("mixed", phase_mixed),
                      ("host single", phase_host_single)):
        t0 = time.perf_counter()
        host[label] = fn(torch, np, pkg)
        log(f"[{label} phase] {time.perf_counter() - t0:.1f} s")

    # 21. results
    nfa_dev = "siddhi_tpu/core/nfa_device.py"
    win = "siddhi_tpu/core/window_device.py"

    def werr(key):
        return max(ph["err"].get(key, 0.0) for ph in (c2, c2g, c2b))

    def er(*blks, key):
        """Largest kernel - plain difference of one kernel use over the
        given block phases."""
        return max(b["err"].get(key, 0.0) for b in blks)
    n4, ns, na, no = (alg[x]["blocks"] for x in ("c4n", "c4ns", "c4a",
                                                  "c4o"))

    def launched(label, key):
        return alg[label]["launches"][key]
    entries = [
        ("expr_eval:filter", K1_SRC, "siddhi_tpu/core/planner.py:301",
         c1["launches"]["expr_eval:filter"], k1_err, c1["filter"]),
        ("expr_eval:pre_mask", K1_SRC, f"{nfa_dev}:1489",
         c4_launches["expr_eval:pre_mask"],
         er(c4b, c3b, key="expr_eval:pre_mask"), c4b["pre_mask"]),
        ("expr_eval:select", K1_SRC, f"{nfa_dev}:1619",
         c4_launches["expr_eval:select"],
         er(c4b, c3b, key="expr_eval:select"), c4b["select"]),
        ("nfa_block", f"{CSRC}/nfa_block.cuh", f"{nfa_dev}:1486",
         seq_launches["nfa_block"], er(blk, key="nfa_block"),
         blk["nfa_block"]),
        ("seg_tree", f"{CSRC}/seg_tree.cu", f"{PAR}:499",
         c4_launches["seg_tree"], er(c4b, c3b, key="seg_tree"),
         c4b["seg_tree"]),
        ("scan_chase", f"{CSRC}/scan_chase.cu", f"{PAR}:796",
         c4_launches["scan_chase"], er(c4b, c3b, key="scan_chase"),
         c4b["scan_chase"]),
        ("scan_compact", f"{CSRC}/scan_compact.cu", f"{PAR}:1056",
         c4_launches["scan_compact"], er(c4b, c3b, key="scan_compact"),
         c4b["scan_compact"]),
        ("expr_eval:pre_mask (lane params)", K1_SRC, f"{PAR}:685",
         c5["launches"]["expr_eval:pre_mask"],
         er(c5["scan"], c5["k2"], key="expr_eval:pre_mask"),
         c5["scan"]["pre_mask"]),
        ("nfa_block (absent, broadcast)", f"{CSRC}/nfa_block.cuh",
         f"{nfa_dev}:803", c5["launches"]["nfa_block"],
         er(c5["k2"], key="nfa_block"), c5["k2"]["nfa_block"]),
        ("scan_compact (qid)", f"{CSRC}/scan_compact.cu", f"{PAR}:1146",
         c5["launches"]["scan_compact"], er(c5["scan"], key="scan_compact"),
         c5["scan"]["scan_compact"]),
        ("seg_tree (fused lanes, shared trees)", f"{CSRC}/seg_tree.cu",
         f"{PAR}:499", c5["launches"]["seg_tree"],
         er(c5["scan"], key="seg_tree"), c5["scan"]["seg_tree"]),
        ("scan_chase (fused lanes, shared trees)", f"{CSRC}/scan_chase.cu",
         f"{PAR}:796", c5["launches"]["scan_chase"],
         er(c5["scan"], key="scan_chase"), c5["scan"]["scan_chase"]),
        ("win_scan:rank", f"{CSRC}/win_scan.cu", f"{PAR}:843",
         launched("c4n", "win_scan:rank"), er(n4, key="win_scan:rank"),
         n4["win_scan:rank"]),
        ("seg_tree:rank", f"{CSRC}/seg_tree.cu", f"{PAR}:845",
         launched("c4n", "seg_tree:rank"), er(n4, key="seg_tree:rank"),
         n4["seg_tree:rank"]),
        ("scan_chase (count)", f"{CSRC}/scan_chase.cu", f"{PAR}:898",
         launched("c4n", "scan_chase"), er(n4, key="scan_chase"),
         n4["scan_chase"]),
        ("scan_compact (count)", f"{CSRC}/scan_compact.cu", f"{PAR}:1097",
         launched("c4n", "scan_compact"), er(n4, key="scan_compact"),
         n4["scan_compact"]),
        ("win_scan:prev", f"{CSRC}/win_scan.cu", f"{PAR}:589",
         launched("c4a", "win_scan:prev"), er(na, key="win_scan:prev"),
         na["win_scan:prev"]),
        ("scan_chase (and)", f"{CSRC}/scan_chase.cu", f"{PAR}:967",
         launched("c4a", "scan_chase"), er(na, key="scan_chase"),
         na["scan_chase"]),
        ("scan_compact (and)", f"{CSRC}/scan_compact.cu", f"{PAR}:1078",
         launched("c4a", "scan_compact"), er(na, key="scan_compact"),
         na["scan_compact"]),
        ("nfa_block (count)", f"{CSRC}/nfa_block.cuh", f"{nfa_dev}:886",
         launched("c4ns", "nfa_block"), er(ns, key="nfa_block"),
         ns["nfa_block"]),
        ("nfa_block (or)", f"{CSRC}/nfa_block.cuh", f"{nfa_dev}:1259",
         launched("c4o", "nfa_block"), er(no, key="nfa_block"),
         no["nfa_block"]),
        ("expr_eval:window_args", K1_SRC, f"{win}:827",
         c2["launches"]["expr_eval:window_args"],
         werr("expr_eval:window_args"),
         c2["kernels"]["expr_eval:window_args"]),
        ("expr_eval:window_select", K1_SRC, f"{win}:594",
         c2["launches"]["expr_eval:window_select"],
         werr("expr_eval:window_select"),
         c2["kernels"]["expr_eval:window_select"]),
        ("win_scan", f"{CSRC}/win_scan.cu", f"{win}:109",
         c2["launches"]["win_scan"], werr("win_scan"),
         c2["kernels"]["win_scan"]),
        ("win_range", f"{CSRC}/win_range.cu", f"{win}:99",
         c2["launches"]["win_range"], werr("win_range"),
         c2["kernels"]["win_range"]),
        ("win_compact", f"{CSRC}/win_compact.cu", f"{win}:803",
         c2["launches"]["win_compact"], werr("win_compact"),
         c2["kernels"]["win_compact"]),
        ("win_compact (grouped, masked)", f"{CSRC}/win_compact.cu",
         f"{win}:835", c2g["launches"]["win_compact"], werr("win_compact"),
         c2g["kernels"]["win_compact"]),
        ("win_compact (c2b, masked)", f"{CSRC}/win_compact.cu",
         f"{win}:835", c2b["launches"]["win_compact"], werr("win_compact"),
         c2b["kernels"]["win_compact"]),
        ("win_range (grouped)", f"{CSRC}/win_range.cu", f"{win}:148",
         c2g["launches"]["win_range"], werr("win_range"),
         c2g["kernels"]["win_range"]),
        ("win_scan (segmented)", f"{CSRC}/win_scan.cu", f"{win}:163",
         c2b["launches"]["win_scan"], werr("win_scan"),
         c2b["kernels"]["win_scan"])]
    jerr = max(ph["err"].get("join_probe", 0.0) for ph in joins.values())
    for label, what in (("j6", "join_probe"),
                        ("j6w", "join_probe (2^16 probes a flush side)"),
                        ("j6o", "join_probe (outer, computed column)"),
                        ("j6u", "join_probe (unidirectional)")):
        entries.append((what, f"{CSRC}/join_probe.cu", f"{JOIN_JAX}:261",
                        joins[label]["launches"]["join_probe"], jerr,
                        joins[label]["kernels"]["join_probe"]))
    entries.append(("expr_eval:join_filter", K1_SRC, f"{JOIN_JAX}:283",
                    joins["j6o"]["launches"]["expr_eval:join_filter"],
                    joins["j6o"]["err"].get("expr_eval:join_filter", 0.0),
                    joins["j6o"]["kernels"]["expr_eval:join_filter"]))
    k10_err = max(aggs[x]["err"].get("agg_merge", 0.0)
                  for x in ("a7", "a7w", "a7g"))
    for label, what in (("a7", "agg_merge"),
                        ("a7w", "agg_merge (2^17 a flush)"),
                        ("a7g", "agg_merge (global rollup, 2^17 chain)")):
        entries.append((what, f"{CSRC}/agg_merge.cu", f"{AGG_JAX}:102",
                        aggs[label]["launches"]["agg_merge"], k10_err,
                        aggs[label]["kernels"]))
    entries.append(("win_scan:agg", f"{CSRC}/win_scan.cu",
                    "siddhi_tpu/core/aggregation.py:463",
                    aggs["a7a"]["launches"]["win_scan:agg"],
                    aggs["a7a"]["err"].get("win_scan:agg", 0.0),
                    aggs["a7a"]["kernels"]))
    ext_err = max(ext[x]["blocks"]["err"].get("nfa_block", 0.0)
                  for x in ext)
    for label, what, line in (
            ("c4h", "nfa_block:ext (init slot, sticky absent)", 751),
            ("c4f", "nfa_block:ext (stream fork)", 1004),
            ("c4l_or", "nfa_block:ext (absent or-side)", 1259)):
        entries.append((what, f"{CSRC}/nfa_block.cuh", f"{nfa_dev}:{line}",
                        ext[label]["launches"]["nfa_block:ext"], ext_err,
                        ext[label]["blocks"]["nfa_block"]))
    plan_py = "siddhi_tpu/core/pattern_plan.py"
    k2c_err = max(sl[x]["blocks"]["err"].get("nfa_block", 0.0)
                  for x in ("c3k", "c3x", "c3e"))
    for label, what in (("c3k", "nfa_block:chunk"),
                        ("c3x", "nfa_block:chunk (conjunction)")):
        entries.append((what, f"{CSRC}/nfa_block.cuh",
                        f"{plan_py}:886 + {nfa_dev}:1529",
                        sl[label]["launches"]["nfa_block:chunk"], k2c_err,
                        sl[label]["blocks"]["nfa_block:chunk"]))
    for key, src, line in (("dfa_tables", "dfa_tables.cu", 728),
                           ("scan_chase:dfa", "scan_chase.cu", 777)):
        e_ = max(sl[x]["blocks"]["err"].get(key, 0.0)
                 for x in ("c3sd", "c4d"))
        for label, what in (("c3sd", key), ("c4d", f"{key} (keyed lanes)")):
            entries.append((what, f"{CSRC}/{src}", f"{PAR}:{line}",
                            sl[label]["launches"][key], e_,
                            sl[label]["blocks"][key]))
    # the float64 forms (@app:devicePrecision('f64'), nfa_device.py:404-426
    # and the f64 ParallelChainKernel, nfa_parallel.py:624)
    c4f64 = f64["c4f64"]["blocks"]
    for key, what, src, line in (
            ("seg_tree", "seg_tree:f64", "seg_tree.cu", f"{PAR}:499"),
            ("scan_chase", "scan_chase:f64", "scan_chase.cu", f"{PAR}:796"),
            ("scan_compact", "scan_compact:f64", "scan_compact.cu",
             f"{PAR}:1165"),
            ("select", "expr_eval:select (f64)", None, f"{nfa_dev}:1619")):
        entries.append((what, K1_SRC if src is None else f"{CSRC}/{src}",
                        line, f64["c4f64"]["launches"][
                            "expr_eval:select" if src is None else what],
                        c4f64["err"].get(
                            "expr_eval:select" if src is None else key, 0.0),
                        c4f64[key]))
    k2f_err = max([f64[x]["blocks"]["err"].get("nfa_block", 0.0)
                   for x in ("c4 seq f64", "c4f f64", "c4 a256 f64",
                             "c3k f64")] +
                  [f64["c5 f64"]["k2"]["err"].get("nfa_block", 0.0)])
    for label, what, use, key, line in (
            ("c4 seq f64", "nfa_block:f64", "nfa_block:f64", "nfa_block",
             f"{nfa_dev}:1560"),
            ("c4f f64", "nfa_block:ext:f64 (stream fork)",
             "nfa_block:ext:f64", "nfa_block", f"{nfa_dev}:1004"),
            ("c4 a256 f64", "nfa_block:f64 (wide, A = 256)",
             "nfa_block:f64", "nfa_block", f"{nfa_dev}:1560"),
            ("c3k f64", "nfa_block:chunk:f64", "nfa_block:chunk:f64",
             "nfa_block:chunk", f"{plan_py}:886")):
        entries.append((what, f"{CSRC}/nfa_block.cuh", line,
                        f64[label]["launches"][use], k2f_err,
                        f64[label]["blocks"][key]))
    c5f = f64["c5 f64"]
    for key, line in (("seg_tree", 499), ("scan_chase", 796)):
        entries.append((f"{key}:f64 (fused lanes, shared trees)",
                        f"{CSRC}/{key}.cu", f"{PAR}:{line}",
                        c5f["launches"][f"{key}:f64"],
                        c5f["scan"]["err"].get(key, 0.0), c5f["scan"][key]))
    entries.append(("expr_eval:pre_mask (f64 lane params)", K1_SRC,
                    "siddhi_tpu/core/multi_query.py:215",
                    f64["c5 f64"]["launches"]["expr_eval:pre_mask"],
                    f64["c5 f64"]["scan"]["err"].get(
                        "expr_eval:pre_mask", 0.0),
                    f64["c5 f64"]["scan"]["pre_mask"]))
    res = {"kernels": [kernel_entry(*e) for e in entries]}
    for e, (*_rest, m) in zip(res["kernels"], entries):
        lib = "" if e["library_ms"] is None else \
            f", library {e['library_ms']:.4f} ms"
        chain = "" if "chain_ms" not in e else \
            f", chain {e['chain_ms']:.4f} ms ({m['chain']} adds)"
        if "library_flat_ms" in e:
            lib += f" (flat 1-D scan {e['library_flat_ms']:.4f} ms)"
        if "f32_twin_ms" in e:
            lib += f", float32 on its shapes {e['f32_twin_ms']:.4f} ms"
        if "programs" in e:
            lib += (f", {e['programs']} programs a launch "
                    f"({e['ms_per_program']:.4f} ms a program, register "
                    f"stack {e['depth'] or 'local'}, {e['rows_a_thread']} "
                    f"rows a thread, {e['grid']} blocks of {e['warps']} "
                    f"warps)")
        elif "tile" in e:
            lib += (f", {e['tiles']} tiles of {e['tile']}"
                    f"{' a lane' if 'scan_compact' in e['name'] else ''}, "
                    f"{e['launches_a_call']} kernel launches a call")
        elif "tiles" in e:
            lib += f", {e['tiles']} tiles a lane, {e['warps']} warps a block"
        elif "launches_a_call" in e:
            lib += f", {e['launches_a_call']} kernel launches a call"
        if "step_ns" in e:
            lib += (f", {e['step_ns']:.1f} ns a step (TT {e['tt']}, "
                    f"{e['wpb']} warps a block)")
        log(f"  {e['name']}: device {e['ms']:.4f} ms, host dispatch "
            f"{m['dispatch_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
            f"bound {e['bound_ms']:.5f} ms ({e['bound_by']}){lib}{chain}, "
            f"{e['launches']} launches")
    for label, ph, names in (
            (f"the C3 flat block (Lt={c3b['Lt']})", c3b,
             ("seg_tree", "scan_chase", "scan_compact")),
            (f"a C5 fused block (L={c5['scan']['L']}, F={c5['scan']['F']})",
             c5["scan"], ("seg_tree", "scan_chase", "select")),
            (f"a C5 fused seq block (T={c5['k2']['T']}, P={c5['k2']['P']})",
             c5["k2"], ())):
        for name in names:
            m = ph[name]
            lib = "" if m["library_ms"] is None else \
                f", library {m['library_ms']:.4f} ms"
            log(f"  {name} at {label}: device {m['ms']:.4f} ms, host "
                f"dispatch {m['dispatch_ms']:.4f} ms, plain "
                f"{m['plain_ms']:.3f} ms, bound "
                f"{bound(m['bytes'], m['ops'])[0]:.5f} ms{lib}")
    for label, ph in (("C2 grouped", c2g), ("C2B", c2b)):
        for name, m in sorted(ph["kernels"].items()):
            lib = "" if m["library_ms"] is None else \
                f", library {m['library_ms']:.4f} ms"
            log(f"  {name} at {label} (n={m['n']}): device {m['ms']:.4f} ms, "
                f"host dispatch {m['dispatch_ms']:.4f} ms, plain "
                f"{m['plain_ms']:.3f} ms, bound "
                f"{bound(m['bytes'], m['ops'])[0]:.5f} ms{lib}, "
                f"{ph['launches'].get(name, 0)} launches")
    detail = {"card": smi, "c4": {"events_per_s": eps,
                                  "ms_per_flush": per_flush,
                                  "cpu_ms_per_flush": cpu_flush,
                                  "matches": len(dev_out),
                                  "flush_events": FLUSH,
                                  "launches": c4_launches, "blocks": c4b},
              "c3": {"ms_per_flush": c3_flush, "cpu_ms_per_flush": c3_cpu,
                     "matches": len(c3_out), "launches": c3_launches,
                     "blocks": c3b},
              "c4_seq": {"ms_per_flush": seq_flush,
                         "cpu_ms_per_flush": seq_cpu,
                         "matches": len(seq_out), "launches": seq_launches,
                         "blocks": blk},
              "c1": c1, "c5": c5, "c2": c2, "c2_grouped": c2g, "c2b": c2b,
              **alg, **joins, **aggs, **ext, **sl, **f64, "host": host}
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**res, **detail}, fh, indent=1)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
