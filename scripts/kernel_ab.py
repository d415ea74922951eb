#!/usr/bin/env python3
"""Device times of K1 (`expr_eval`), K2 (`nfa_block`), K3 (`seg_tree`),
K4 (`scan_chase`), K5 (`scan_compact`), K6 (`win_scan`), K7
(`win_range`), K8 (`win_compact`), K9 (`join_probe`), K10 (`agg_merge`)
and K11 (`dfa_tables`) on the calls
their main paths make, checkout by checkout.

    python3 scripts/kernel_ab.py [--k1] [--k2] [--k4] [--k5] [--k7] [--k8]
                                 [--k9] [--k11] ROOT [ROOT ...]
    python3 scripts/kernel_ab.py --host PARENT_ROOT CHANGE_ROOT [ROUNDS]

Runs each checkout (a directory holding chip_smoke.py and
siddhi_tpu_torch) in a subprocess of its own, in the order given (repeat
them to interleave, e.g. parent, change, change, parent, so that a drift
of the card shows).  Each run builds that checkout's kernels and drives
chip_smoke.py's phases through its own facade on the card, recording what
the plans hand the kernels: C4 under @app:patternFamily('seq') and at
its default `scan` (2 flushes of 2^18 events over 1000 keys each) and
config 5 (c5_app(1000), 4
flushes of 2^13 events 50 ms apart, then set_time), C2 (2 flushes of
2^17 events), C4N and C4A (4 and 2 flushes of 2^18), A7 (24 flushes of
4096 events over 1024 keys), A7W and A7G (4 flushes of 2^17, A7G without
`group by`) and A7A (2 flushes of 2^17 under
@app:deviceAggregations('always')), and for K2 also C4Ns and C4O (2
flushes of 2^18), C4F (2 flushes of 2^18 under playback), C3K and C3X
(2 flushes of 2^17 over 8 keys, `chunk`) and C4 `seq` under
@app:devicePrecision('f64') (chip_smoke's raw-double tape).  It then
times the call chip_smoke.py times for each kernel use: K2 on the last
accepted C4 `seq`, C4Ns, C4O and C4 `seq` f64 block that is not a timer
tick, on C4F's widest block, on the last chunk block C3K and C3X kept
(from fresh state) and on config 5's widest block of its absent group
(where K2 stages its events, with the TT and warps a block its launch
chose, `geometry`); K5 on the last C4 `scan` block (its chase from K4's plain version);
K6 on C2's widest window call (`window`), on the last C4N block's rank
columns (`rank`), on the last C4A block's prev columns (`prev`) and on
A7A's widest call (`agg`); K10 on the widest call of A7, A7W and A7G (on
a copy of the ring) -- each a CUDA graph of prepared launches (10 for
K2, 20 else) replayed between CUDA events (chip_smoke.graph_ms), the
least of three graphs.  K9 on the last of the widest recorded calls
(probes x window; chip_smoke.py's choice) of J6, J6W, J6O and J6U (chip_smoke.py's JOINS: bench.py's
config 6 tape through JOIN_APP, JOIN_OUTER and JOIN_UNI; where the
checkout's wrapper reports them, also its kernel launches a call and its
tile geometry, `k9_geometry`); K3 and K4 (`--k4`) on C5's widest `scan`
block (the group with the most trees), on C5 f64's (c5_app(1000,
frac=1e-6) on a raw-double tape) and on the last `scan` or `dfa` block of
C4, C4N, C4A, C4F64, C4D, C3 and C3SD (per-lane trees), K4 over K3's
own heaps, the trees each K3 launch built against lanes x trees
(`k3_trees`) and the launches' kernel launches, blocks, threads and
shared bytes (`k34_geometry`).  K1 (`--k1`): the pre-masks of C5's and C5 f64's widest
`scan` block and of the last C4 `scan` block (`kern.pre_masks`, every
pre-mask program of the block: one launch where the checkout's K1 takes
several programs a launch, `prepare_masks`, else one a program; the
programs and launches a block in `k1_pre`, the time per program beside
the time per block; each use's host dispatch, one eager wrapper call,
the least mean of 10 rounds of 50, in `k1_host`), C1's filter on its 2^20-event batch, the selector
over the last C4 `scan` block's match table (its chase from K4's plain
version), the widest `window_args` and `window_select` calls of C2 and
the widest `join_filter` call of J6O.  K11 (`--k11`): the last `dfa`
block of C3SD (one lane of 2^18 events) and of C4D (1000 lanes), with
the tiles a lane where the checkout's launch reports them
(`k11_geometry`).  K7 (`--k7`): the widest call of C2 and of C2 grouped;
K8 (`--k8`): the widest call of C2, C2 grouped and C2B, with its bound
and a cProfile split of its host dispatch (`k8_geometry`); and K5
(`--k5`): the last `scan` block of C4, C4N, C4A and C4F64 and C5's
widest fused block, each with its host dispatch (`k7_host`, `k8_host`,
`k5_host`, timed as `k1_host`) and geometry (`k7_geometry`,
`k5_geometry`).  `--k1`, `--k2`, `--k4`, `--k5`, `--k7`, `--k8`, `--k9`
and `--k11` time only those kernels (K3 and K4 for `--k4`); several may
be given; none times them all (`--k7` and `--k8` alone build only the
window path's sources).  Prints one JSON line per run: the checkout, the
card's name and power limit, the device times in ms and `ptxas`, each
K1, K2, K3, K4, K5, K7, K8, K9 and K11 source's kernels with their registers and spill stores and
loads (nvcc -Xptxas -v).  Needs a CUDA card.

`--host` times K3's and K4's host dispatch (one eager wrapper call:
pack and upload the parameter table, launch) of two checkouts in ONE
process: a wrapper's dispatch moves up to 2x between processes while a
process keeps its level for its whole run, so times taken a checkout a
process cannot resolve a 10% change.  Both checkouts' siddhi_tpu_torch
load under two names; the per-lane cells of `--k4` (`k34_cells`) run
through each checkout's own facade on the card; each use's eager call
on the run's last `scan` block is then timed in turns (parent, change,
change, parent every round), the mean of 50 calls a turn, ROUNDS rounds
(default 10).  Prints one JSON line: the card's name and power limit,
and per use both checkouts' turns in ms with their medians.
"""
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

KERNEL_SOURCES = ("expr_eval", "nfa_block", "seg_tree", "scan_chase",
                  "scan_compact", "win_range", "win_compact", "join_probe",
                  "dfa_tables")
# the `scan` family's kernels (K1, K3, K4, K5, K6, K11); others build at
# first use
K34_SOURCES = ("expr_eval", "seg_tree", "scan_chase", "scan_compact",
               "win_scan", "dfa_tables")
GROUPS = ("--k1", "--k2", "--k4", "--k5", "--k7", "--k8", "--k9", "--k11")
# the window path's kernels (K1, K6, K7, K8)
WINDOW_SOURCES = ("expr_eval", "win_scan", "win_range", "win_compact")


def ptxas(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) of each entry
    function in one nvcc -Xptxas -v log."""
    rows, name, props = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            rows.append([name, None, None, None])
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and rows and props == name:
            rows[-1][2:] = [int(w) for w in line.replace(",", " ").split()
                            if w.isdigit()][1:3]
        elif "Used" in line and "registers" in line and rows:
            rows[-1][1] = int(line.split("Used")[1].split()[0])
    return rows


def k9_entries(out: dict, cs, best) -> None:
    """K9 on the widest recorded call of each join phase of chip_smoke."""
    from siddhi_tpu_torch.kernels import join_probe as k9
    from siddhi_tpu_torch.replay import join_tape, run_join
    for label, app, batch, flushes, _filtered, _sides in cs.JOINS:
        calls: list = []
        run_join(app, join_tape(batch * flushes, batch), "cuda", calls)
        # chip_smoke's call: the last of the widest (probes x window), a
        # flush past the first, whose windows are full
        k9_calls = [c for c in calls if c[0] == "join_probe"]
        widest = max(c[2]["n_p"] * max(c[2]["Mw"], 1) for c in k9_calls)
        _n, a, kw = [c for c in k9_calls if c[2]["n_p"] * max(
            c[2]["Mw"], 1) == widest][-1]
        out[f"k9_{label}"] = best(lambda: k9.join_probe(*a, **kw),
                                  lambda: [k9.prepare(*a, **kw)])
        launch = k9.prepare(*a, **kw)
        launch()
        params = getattr(launch, "params", None)
        if params is not None:
            out.setdefault("k9_geometry", {})[label] = {
                "launches": params.launched, "tp": params.tp,
                "chunk": params.chunk, "n_p": kw["n_p"], "Mw": kw["Mw"]}


def k1_entries(out: dict, cs, pkg, np, torch, best) -> None:
    """K1 on each of its uses: the pre-masks of C5's, C5 f64's and C4's
    `scan` blocks, C1's filter, C4's selector, C2's window calls and
    J6O's side filter; device ms under the use's key, the wrapper's host
    dispatch ms (one eager call) under k1_host.  `best` returns both."""
    from siddhi_tpu_torch.kernels import expr_eval as k1
    from siddhi_tpu_torch.kernels import scan_compact as k5
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase_plain
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree
    from siddhi_tpu_torch.replay import join_tape, run_join, run_window

    def pre(key, kern, ev) -> None:
        cols, rows = kern.pre_mask_cols(ev), kern.pre_mask_rows(ev)
        progs = [p for p in kern.nfak.pre_progs if p is not None]
        n = ev["__nev__"].shape[0] * ev["__flat.__ts__"].shape[1]
        params = {"__base_ts__": ev["__base_ts__"]}
        if hasattr(k1, "prepare_masks"):
            def prepare():
                return [k1.prepare_masks(cols, progs, n, params,
                                         use="pre_mask", rows=rows)]
        else:
            def prepare():
                return [k1.prepare(cols, p, [], n, params, use="pre_mask",
                                   rows=rows) for p in progs]
        ms, host = best(lambda: kern.pre_masks(ev), prepare)
        out[f"k1_pre_{key}"] = ms
        out.setdefault("k1_host", {})[f"k1_pre_{key}"] = host
        out.setdefault("k1_pre", {})[key] = {
            "rows": n, "programs": len(progs), "launches": len(prepare()),
            "ms_per_program": ms / len(progs)}

    def k1_call(key, a, kw) -> None:
        out[key], out.setdefault("k1_host", {})[key] = best(
            lambda: k1.expr_eval(*a, **kw), lambda: [k1.prepare(*a, **kw)])

    def widest(blocks):
        return max(blocks, key=lambda b: (len(b[0].trees),
                                          b[1]["__flat.__ts__"].shape[1]))
    tape = cs.make_tape(cs.C5_FLUSH * 4, cs.C5_FLUSH, cs.C5_SYMBOLS,
                        seed=5, dt_ms=cs.C5_DT)
    pre("c5", *widest(cs.run_c5(pkg, np, tape, "cuda", record=True)[6])[:2])
    app = cs.F64 + cs.c5_app(cs.C5_QUERIES, frac=cs.RAW_STEP)
    tape = cs.raw_tape(cs.C5_FLUSH, cs.C5_FLUSH, cs.C5_SYMBOLS, seed=43,
                       dt_ms=cs.C5_DT, lo=90.0, levels=40)
    pre("c5_f64", *widest(cs.run_c5(pkg, np, tape, "cuda", record=True,
                                    app=app)[6])[:2])
    tape = cs.make_tape(cs.FLUSH * 2, cs.FLUSH, cs.KEYS)
    kern, ev, m = cs.run_recorded(pkg, np, cs.C4_HEAD + cs.C4, tape)[4][-1]
    pre("c4", kern, ev)
    # the selector over the block's match table
    pre_w = kern.pre_masks(ev)
    masks, ranks, prevs, rcols = cs.scan_inputs(kern, ev, pre_w)
    heaps = seg_tree(kern, ev, pre_w)
    chase = scan_chase_plain(kern, ev, masks, heaps, ranks, [], prevs)
    table = k5.scan_compact(kern, ev, chase, ranks, [], m)
    nfak, n = kern.nfak, int(table["meta"][0])
    k1_call("k1_select_c4", (nfak.select_cols(table), nfak.having_prog,
                             nfak.sel_progs, n,
                             {"__base_ts__": ev["__base_ts__"]}),
            {"use": "select", "rows": nfak.select_rows(table)})
    # C1's filter on its batch
    tape = cs.make_tape(cs.C1_EVENTS, cs.C1_EVENTS, cs.KEYS, seed=2)
    rt = cs.run_app(pkg, np, cs.C1, tape, cs.KEYS, "cuda")[2]
    plan = rt.plans()[0]
    cols = [torch.from_numpy(np.ascontiguousarray(tape[0][k])).cuda()
            for k in plan._slot_keys]
    k1_call("k1_filter_c1", (cols, plan._mask_prog, plan._out_progs,
                             cs.C1_EVENTS), {"use": "filter"})
    # C2's window calls and J6O's side filter: the widest of each use
    calls: list = []
    tape = cs.make_tape(cs.C2_FLUSH * cs.C2_FLUSHES, cs.C2_FLUSH,
                        cs.C2_SYMBOLS, seed=20)
    run_window(cs.C2, tape, "cuda", calls)
    label, app, batch, flushes = [j for j in cs.JOINS if j[0] == "j6o"][0][:4]
    run_join(app, join_tape(batch * flushes, batch), "cuda", calls)
    for use in ("window_args", "window_select", "join_filter"):
        _n, a, kw = max((c for c in calls if c[0] == "expr_eval"
                         and c[2]["use"] == use), key=lambda c: c[1][3])
        k1_call(f"k1_{use}", a, kw)


def k7_entries(out: dict, cs, best) -> None:
    """K7 on the widest call of C2 and of C2 grouped (chip_smoke.py's
    window tapes, 2 flushes of 2^17): device ms under k7_<cell>, the
    wrapper's host dispatch under k7_host, and the call's tiles and
    kernel launches (`k7_geometry`; a checkout without tiles launches a
    pass per sparse-table level)."""
    from siddhi_tpu_torch.kernels import win_range as k7
    from siddhi_tpu_torch.replay import run_window
    for label, app, seed in (("c2", cs.C2, 20), ("c2g", cs.C2_GROUPED, 21)):
        calls: list = []
        tape = cs.make_tape(cs.C2_FLUSH * cs.C2_FLUSHES, cs.C2_FLUSH,
                            cs.C2_SYMBOLS, seed=seed)
        run_window(app, tape, "cuda", calls)
        k7_calls = [c for c in calls if c[0] == "win_range"]
        _n, a, kw = [c for c in k7_calls if c[2]["n"] == max(
            x[2]["n"] for x in k7_calls)][-1]
        out[f"k7_{label}"], out.setdefault("k7_host", {})[f"k7_{label}"] = \
            best(lambda: k7.win_range(*a, **kw),
                 lambda: [k7.prepare(*a, **kw)])
        launch = k7.prepare(*a, **kw)
        launch()
        params = launch.params
        minmax = any(s[0] in ("min", "max") for s in a[0])
        geo = {"n": kw["n"], "m": kw["m"], "sites": [s[0] for s in a[0]]}
        if params is not None:
            # a checkout whose launcher counts its kernels reports them
            geo.update(tiles=params.ntiles, query_tiles=params.qtiles,
                       kernel_launches=getattr(params, "launched", None))
        else:
            geo["kernel_launches"] = k7.levels_for(kw["n"]) + 1 \
                if minmax else 1
        out.setdefault("k7_geometry", {})[label] = geo


def k8_profile(call, calls: int = 400, top: int = 12) -> dict:
    """cProfile of `calls` eager calls of one wrapper (the device
    synchronised once, after them): the total host ms a call and the
    `top` functions by own time, each as ms a call (own, cumulative)."""
    import cProfile
    import pstats
    import torch
    call()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        call()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"ms_a_call": st.total_tt / calls * 1e3,
            "top": [[f"{os.path.basename(f)}:{line}({fn})",
                     tt / calls * 1e3, ct / calls * 1e3]
                    for (f, line, fn), (_cc, _nc, tt, ct, _cal) in rows]}


def k8_entries(out: dict, cs, best) -> None:
    """K8 on the widest call of C2, C2 grouped and C2B (chip_smoke.py's
    window tapes, 2 flushes of 2^17 each; the widest by T, the last of
    equals, as chip_smoke.py picks it): device ms under k8_<cell>, the
    wrapper's host dispatch under k8_host, and under k8_geometry the
    call's n, T, mask, column widths, the kernel launches a call (the
    launcher's count where the checkout's reports it, else its three
    passes past one 1024-row tile), the bound (chip_smoke.py's bytes over
    3.35 TB/s) and a cProfile split of its host dispatch (`k8_profile`)."""
    from siddhi_tpu_torch.kernels import win_compact as k8
    from siddhi_tpu_torch.replay import run_window
    for label, app, seed in (("c2", cs.C2, 20), ("c2g", cs.C2_GROUPED, 21),
                             ("c2b", cs.C2B, 22)):
        calls: list = []
        tape = cs.make_tape(cs.C2_FLUSH * cs.C2_FLUSHES, cs.C2_FLUSH,
                            cs.C2_SYMBOLS, seed=seed)
        run_window(app, tape, "cuda", calls)
        k8_calls = [c for c in calls if c[0] == "win_compact"]
        _n, a, kw = [c for c in k8_calls if c[1][3] == max(
            x[1][3] for x in k8_calls)][-1]
        out[f"k8_{label}"], out.setdefault("k8_host", {})[f"k8_{label}"] = \
            best(lambda: k8.win_compact(*a, **kw),
                 lambda: [k8.prepare(*a, **kw)])
        launch = k8.prepare(*a, **kw)
        res = launch()
        cols, _fills, n, T = a[:4]
        mask = a[4] if len(a) > 4 else kw.get("mask")
        nb, _ops = cs.window_work("win_compact", a, kw, res)
        launched = getattr(launch.params, "launched", None) \
            if getattr(launch, "params", None) is not None else \
            (3 if T > 1024 else 1)
        out.setdefault("k8_geometry", {})[label] = {
            "n": n, "T": T, "masked": mask is not None,
            "widths": [c.element_size() for c in cols],
            "kernel_launches": launched, "bytes": nb,
            "bound_ms": nb / 3.35e12 * 1e3,
            "profile": k8_profile(lambda: k8.win_compact(*a, **kw))}


def k5_entries(out: dict, cs, pkg, np, best) -> None:
    """K5 on the last `scan` block of C4, C4N, C4A and C4F64 (2 flushes
    of 2^18 over 1000 keys each; C4F64 on chip_smoke.py's raw-double
    tape) and on config 5's widest fused `scan` block (the most
    candidates), its chase from K4's plain version: device ms under
    k5_<cell>, the wrapper's host dispatch under k5_host, the block's
    lanes, candidates a lane and matches under k5_geometry."""
    from siddhi_tpu_torch.kernels import scan_compact as k5
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase_plain
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree_plain

    def timed(key, kern, ev, m) -> None:
        pre = kern.pre_masks(ev)
        masks, ranks, prevs, rcols = cs.scan_inputs(kern, ev, pre)
        heaps = seg_tree_plain(kern, ev, masks)
        rheaps = seg_tree_plain(kern, ev, masks, kern.rank_trees, rcols) \
            if ranks else []
        chase = scan_chase_plain(kern, ev, masks, heaps, ranks, rheaps,
                                 prevs)
        args = (kern, ev, chase, ranks, rheaps, m)
        out[f"k5_{key}"], out.setdefault("k5_host", {})[f"k5_{key}"] = \
            best(lambda: k5.scan_compact(*args), lambda: [k5.prepare(*args)])
        L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
        launch = k5.prepare(*args)
        got = launch()
        out.setdefault("k5_geometry", {})[key] = {
            "L": L, "F": F, "C": kern.C, "f64": bool(kern.f64),
            "matches": int(got["meta"][0]),
            "kernel_launches": getattr(launch.params, "launched", None)}

    tape = cs.make_tape(cs.FLUSH * 2, cs.FLUSH, cs.KEYS)
    timed("c4", *cs.run_recorded(pkg, np, cs.C4_HEAD + cs.C4, tape)[4][-1])
    for label in ("c4n", "c4a"):
        _l, app, flushes, _f, seed, _e, _n = [
            x for x in cs.ALGEBRA if x[0] == label][0]
        tape = cs.make_tape(cs.FLUSH * min(flushes, 2), cs.FLUSH, cs.KEYS,
                            seed=seed)
        timed(label, *cs.run_recorded(pkg, np, app, tape)[4][-1])
    tape = cs.raw_tape(cs.FLUSH * 2, cs.FLUSH, cs.KEYS, seed=37)
    timed("c4f64", *cs.run_recorded(pkg, np, cs.F64 + cs.C4_HEAD + cs.C4,
                                    tape)[4][-1])
    tape = cs.make_tape(cs.C5_FLUSH * 4, cs.C5_FLUSH, cs.C5_SYMBOLS,
                        seed=5, dt_ms=cs.C5_DT)
    blocks = cs.run_c5(pkg, np, tape, "cuda", record=True)[6]
    timed("c5", *max(blocks, key=lambda b: b[0].C * b[1][
        "__nev__"].shape[0] * b[1]["__flat.__ts__"].shape[1]))


def k11_entries(out: dict, cs, pkg, np, best) -> None:
    """K11 on the last `dfa` block of C3SD and of C4D."""
    from siddhi_tpu_torch.kernels import dfa_tables as k11
    for label, app, n, flushes, keys, seed, _f, _c in cs.STATELESS:
        if label not in ("c3sd", "c4d"):
            continue
        tape = cs.make_tape(n * flushes, n, keys, seed=seed)
        kern, ev, _m = cs.run_recorded(pkg, np, app, tape, keys)[4][-1]
        pre = kern.pre_masks(ev)
        out[f"k11_{label}"] = best(lambda: k11.dfa_tables(kern, ev, pre),
                                   lambda: [k11.prepare(kern, ev, pre)])
        launch = k11.prepare(kern, ev, pre)
        launch()
        geo = {"L": ev["__nev__"].shape[0], "F": ev["__flat.__ts__"].shape[1],
               "chase_nodes": len(kern.dfa_nodes)}
        params = getattr(launch, "params", None)
        if params is not None:
            geo.update(tiles=params.T, warps=params.W)
        out.setdefault("k11_geometry", {})[label] = geo


def k34_cells(cs) -> list:
    """The per-lane `scan`/`dfa` cells of `--k4` and `--host`: (label,
    app, tape, keys) of C4, C4N, C4A, C4F64, C4D, C3SD and C3."""
    cells = [("c4", cs.C4_HEAD + cs.C4, cs.make_tape(
        cs.FLUSH * 2, cs.FLUSH, cs.KEYS), cs.KEYS)]
    for label in ("c4n", "c4a"):
        _l, app, flushes, _f, seed, _e, _n = [
            x for x in cs.ALGEBRA if x[0] == label][0]
        cells.append((label, app, cs.make_tape(
            cs.FLUSH * min(flushes, 2), cs.FLUSH, cs.KEYS, seed=seed),
            cs.KEYS))
    cells.append(("c4f64", cs.F64 + cs.C4_HEAD + cs.C4,
                  cs.raw_tape(cs.FLUSH * 2, cs.FLUSH, cs.KEYS, seed=37),
                  cs.KEYS))
    for label, app, n, flushes, keys, seed, _f, _c in cs.STATELESS:
        if label in ("c4d", "c3sd"):
            cells.append((label, app, cs.make_tape(n * flushes, n, keys,
                                                   seed=seed), keys))
    cells.append(("c3", cs.C3, cs.make_tape(
        cs.FLUSH * cs.C3_FLUSHES, cs.FLUSH, cs.KEYS, seed=3), cs.KEYS))
    return cells


def k34_entries(out: dict, cs, pkg, np, best) -> None:
    """K3 and K4 on C5's and C5 f64's widest `scan` block (fused groups,
    shared trees) and on the last `scan` or `dfa` block of each of
    `k34_cells` (per-lane trees; C3 and C3SD one flat lane), K4 over K3's
    own heaps (and, in `dfa`, K11's tables): device ms under
    k3_/k4_<cell> (the rank trees under k3r_<cell>), the trees each K3
    launch built against lanes x trees (`k3_trees`) and, where the
    checkout's launchers report them, each launch's kernel launches and
    K4's blocks, threads and shared bytes (`k34_geometry`)."""
    from siddhi_tpu_torch.kernels import dfa_tables as k11
    from siddhi_tpu_torch.kernels import scan_chase as k4
    from siddhi_tpu_torch.kernels import seg_tree as k3

    def timed(key, kern, ev) -> None:
        pre = kern.pre_masks(ev)
        out[f"k3_{key}"] = best(lambda: k3.seg_tree(kern, ev, pre),
                                lambda: [k3.prepare(kern, ev, pre)])
        heaps = k3.seg_tree(kern, ev, pre)
        ranks, rheaps, prevs = [], [], []
        if kern.counts or kern.prev_nodes:
            _m, ranks, prevs, rcols = cs.scan_inputs(kern, ev, pre)
        if ranks:
            rargs = (kern, ev, pre, kern.rank_trees, rcols)
            out[f"k3r_{key}"] = best(lambda: k3.seg_tree(*rargs),
                                     lambda: [k3.prepare(*rargs)])
            rheaps = k3.seg_tree(*rargs)
        tables = k11.dfa_tables(kern, ev, pre) if kern.dfa_nodes else None
        args = (kern, ev, pre, heaps, ranks, rheaps, prevs, tables)
        out[f"k4_{key}"] = best(lambda: k4.scan_chase(*args),
                                lambda: [k4.prepare(*args)])
        L = ev["__nev__"].shape[0]
        out.setdefault("k3_trees", {})[key] = {
            "built": sum(h.shape[0] for h in heaps),
            "lanes_x_trees": L * len(kern.trees)}
        l3, l4 = k3.prepare(kern, ev, pre), k4.prepare(*args)
        l3()
        l4()
        p3, p4 = l3.params, l4.params
        geo = {"L": L, "F": ev["__flat.__ts__"].shape[1],
               "trees": len(kern.trees), "rank_trees": len(rheaps)}
        if p3 is not None:
            geo["k3_launched"] = p3.launched
        if p4 is not None:
            geo.update(k4_launched=p4.launched, k4_blocks=p4.blocks,
                       k4_threads=p4.threads, k4_smem=p4.smem)
        out.setdefault("k34_geometry", {})[key] = geo

    def widest(blocks):
        return max(blocks, key=lambda b: (len(b[0].trees),
                                          b[1]["__flat.__ts__"].shape[1]))
    tape = cs.make_tape(cs.C5_FLUSH * 4, cs.C5_FLUSH, cs.C5_SYMBOLS,
                        seed=5, dt_ms=cs.C5_DT)
    kern, ev, _m = widest(cs.run_c5(pkg, np, tape, "cuda", record=True)[6])
    timed("c5", kern, ev)
    app = cs.F64 + cs.c5_app(cs.C5_QUERIES, frac=cs.RAW_STEP)
    tape = cs.raw_tape(cs.C5_FLUSH, cs.C5_FLUSH, cs.C5_SYMBOLS, seed=43,
                       dt_ms=cs.C5_DT, lo=90.0, levels=40)
    kern, ev, _m = widest(cs.run_c5(pkg, np, tape, "cuda", record=True,
                                    app=app)[6])
    timed("c5_f64", kern, ev)
    for label, app, tape, keys in k34_cells(cs):
        timed(label, *cs.run_recorded(pkg, np, app, tape, keys)[4][-1][:2])


def load_alias(root: str, name: str):
    """`root`'s siddhi_tpu_torch imported as the package `name`."""
    path = os.path.join(root, "siddhi_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_calls(cs, np, pkg, app: str, tape, keys: int) -> dict:
    """use -> a zero-argument eager K3 or K4 wrapper call on the last
    `scan` block a card run of `app` through the aliased package `pkg`
    hands its ParallelChainKernel.run_block."""
    name = pkg.__name__
    cls = importlib.import_module(f"{name}.core.nfa_parallel") \
        .ParallelChainKernel
    blocks, run = [], cls.run_block

    def rec(kern, ev, M):
        blocks.append((kern, ev))
        return run(kern, ev, M)
    cls.run_block = rec
    try:
        cs.run_app(pkg, np, app, tape, keys, "cuda")
    finally:
        cls.run_block = run
    kern, ev = blocks[-1]
    k3 = importlib.import_module(f"{name}.kernels.seg_tree")
    k4 = importlib.import_module(f"{name}.kernels.scan_chase")
    k11 = importlib.import_module(f"{name}.kernels.dfa_tables")
    pre = kern.pre_masks(ev)
    heaps = k3.seg_tree(kern, ev, pre)
    ranks, prevs, rheaps = [], [], []
    out = {"k3": lambda: k3.seg_tree(kern, ev, pre)}
    if kern.counts or kern.prev_nodes:
        ranks, prevs = kern.lane_scans(ev, k3.node_masks(kern, ev, pre))
    if ranks:
        rcols = {f"__rank.{ci}": r for ci, r in enumerate(ranks)}
        out["k3r"] = lambda: k3.seg_tree(kern, ev, pre, kern.rank_trees,
                                         rcols)
        rheaps = out["k3r"]()
    tables = k11.dfa_tables(kern, ev, pre) if kern.dfa_nodes else None
    out["k4"] = lambda: k4.scan_chase(kern, ev, pre, heaps, ranks, rheaps,
                                      prevs, tables)
    return out


def host(parent: str, change: str, rounds: int) -> dict:
    """`--host`: K3's and K4's host dispatch of two checkouts in one
    process, their calls in turns."""
    sys.path.insert(0, change)
    import numpy as np
    import torch

    import chip_smoke as cs
    pkgs = {"parent": load_alias(parent, "siddhi_torch_parent"),
            "change": load_alias(change, "siddhi_torch_change")}
    for pkg in pkgs.values():
        importlib.import_module(f"{pkg.__name__}.kernels.build").build_all(
            K34_SOURCES)

    def turn(call, reps=50) -> float:
        """The mean of `reps` eager calls (no synchronisation inside)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return ms

    out = {"rounds": rounds, "uses": {}}
    for label, app, tape, keys in k34_cells(cs):
        uses: dict = {}
        for side, pkg in pkgs.items():
            for use, call in host_calls(cs, np, pkg, app, tape,
                                        keys).items():
                call()
                uses.setdefault(f"{use}_{label}", {})[side] = call
        for key, by_side in uses.items():
            got: dict = {"parent": [], "change": []}
            for _ in range(rounds):
                for side in ("parent", "change", "change", "parent"):
                    got[side].append(turn(by_side[side]))
            out["uses"][key] = {
                side: {"median": statistics.median(v), "turns": v}
                for side, v in got.items()}
        torch.cuda.empty_cache()
    return finish(out, {})


def one(root: str, only: frozenset = frozenset()) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import siddhi_tpu_torch as pkg
    from siddhi_tpu_torch.kernels import agg_merge as k10
    from siddhi_tpu_torch.kernels import build
    from siddhi_tpu_torch.kernels import nfa_block as k2
    from siddhi_tpu_torch.kernels import scan_compact as k5
    from siddhi_tpu_torch.kernels import win_scan as k6
    from siddhi_tpu_torch.kernels.scan_chase import scan_chase_plain
    from siddhi_tpu_torch.kernels.seg_tree import seg_tree
    from siddhi_tpu_torch.replay import (MATRIX_APP, matrix_tape, run_agg,
                                         run_window)
    # K9 alone needs K1 (side filters) and K9, K3-K5 the `scan` family's
    # kernels; everything else builds all
    build.build_all(("expr_eval", "join_probe") if only == {"--k9"}
                    else K34_SOURCES if only and only <= {"--k4", "--k5"}
                    else WINDOW_SOURCES if only and only <= {"--k7", "--k8"}
                    else build.SOURCES)
    regs = {name: ptxas(log) for name, log in build.BUILD_LOG.items()
            if name.startswith(KERNEL_SOURCES)}
    groups_only = bool(only)        # no K5, K6 or K10 when a group is named

    def best(call, prepare, reps=20) -> float:
        return min(cs.graph_ms(torch, call, prepare, reps)[0]
                   for _ in range(3))

    def host_ms(call, rounds=10, reps=50) -> float:
        """The wrapper's host dispatch ms: the least mean of `rounds`
        rounds of `reps` eager calls (no synchronisation inside one)."""
        call()
        least = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            least = min(least, (time.perf_counter() - t0) / reps * 1e3)
        torch.cuda.synchronize()
        return least

    def best_and_host(call, prepare) -> tuple:
        return best(call, prepare), host_ms(call)

    def k6_ms(a, kw) -> float:
        return best(lambda: k6.win_scan(*a, **kw),
                    lambda: [k6.prepare(*a, **kw)])

    def k2_block_ms(key, kern, state, ev, m) -> None:
        """out[key]: K2 on one block; in a checkout whose K2 stages its
        events, also the TT and warps a block its launch chose
        (out["geometry"][key])."""
        pre = kern.pre_masks(ev)
        out[key] = best(lambda: k2.nfa_block(kern, state, ev, pre, m),
                        lambda: [k2.prepare(kern, state, ev, pre, m)],
                        reps=10)
        launch = k2.prepare(kern, state, ev, pre, m)
        launch()
        params = getattr(launch, "params", None)
        if params is not None:
            out.setdefault("geometry", {})[key] = {
                "tt": params.tt, "wpb": params.wpb,
                "T": ev["__chunk__"][0] if "__chunk__" in ev
                else ev["__ts__"].shape[0]}

    def k2_ms(key, blocks, widest=False) -> None:
        acc = [b[:4] for b in blocks if int(b[4][0]) <= b[3]]
        acc = [b for b in acc if "__tick__" not in b[2]]
        if widest:
            acc.sort(key=lambda b: b[0].A)
        k2_block_ms(key, *acc[-1])

    def k2_chunk_ms(key, blocks, cap) -> None:
        kern, _st, ev, m, _meta = [b for b in blocks if cs.chunk_kept(
            b[0], b[4].cpu(), b[3], cap)][-1]
        k2_block_ms(key, kern, kern.init_state(ev["__ts__"].device), ev, m)

    out = {"root": root}
    if not only or "--k1" in only:
        k1_entries(out, cs, pkg, np, torch, best_and_host)
    if not only or "--k11" in only:
        k11_entries(out, cs, pkg, np, best)
    if not only or "--k7" in only:
        k7_entries(out, cs, best_and_host)
    if not only or "--k8" in only:
        k8_entries(out, cs, best_and_host)
    if not only or "--k5" in only:
        k5_entries(out, cs, pkg, np, best_and_host)
    if only and "--k9" in only:
        k9_entries(out, cs, best)
    if only and "--k4" in only:
        k34_entries(out, cs, pkg, np, best)
    if only and "--k2" not in only:
        return finish(out, regs)
    tape = cs.make_tape(cs.FLUSH * cs.SEQ_FLUSHES, cs.FLUSH, cs.KEYS)
    k2_ms("k2_c4_seq", cs.run_recorded(
        pkg, np, cs.C4_SEQ + cs.C4_HEAD + cs.C4, tape)[5])
    for label, app, flushes, family, seed, _x, _n in cs.ALGEBRA:
        if family == "seq":
            tape = cs.make_tape(cs.FLUSH * flushes, cs.FLUSH, cs.KEYS,
                                seed=seed)
            k2_ms(f"k2_{label}", cs.run_recorded(pkg, np, app, tape)[5])
    label, app, seed = [x for x in cs.EXT if x[0] == "c4f"][0]
    tape = cs.make_tape(cs.FLUSH * cs.EXT_FLUSHES, cs.FLUSH, cs.KEYS,
                        seed=seed)
    k2_ms("k2_c4f", cs.run_recorded(pkg, np, app, tape)[5], widest=True)
    for label, app, n, flushes, keys, seed, _f, _c in cs.STATELESS:
        if label in ("c3k", "c3x"):
            tape = cs.make_tape(n * flushes, n, keys, seed=seed)
            rt, seq_b = cs.run_recorded(pkg, np, app, tape, keys)[3:6:2]
            k2_chunk_ms(f"k2_{label}", seq_b, rt.plans()[0].A_CAP)
    label, app, n, flushes, keys, seed, band = [
        x for x in cs.F64_PHASES if x[0] == "c4 seq f64"][0][:7]
    tape = cs.raw_tape(n * flushes, n, keys, seed=seed, lo=band[0],
                       levels=band[1])
    k2_ms("k2_c4_seq_f64", cs.run_recorded(pkg, np, app, tape, keys)[5])
    if not groups_only:
        kern, ev, m = cs.run_recorded(pkg, np, cs.C4_HEAD + cs.C4, tape)[4][-1]
        pre = kern.pre_masks(ev)
        masks, ranks, prevs, rcols = cs.scan_inputs(kern, ev, pre)
        heaps = seg_tree(kern, ev, pre)
        rheaps = seg_tree(kern, ev, pre, kern.rank_trees, rcols) if ranks \
            else []
        chase = scan_chase_plain(kern, ev, masks, heaps, ranks, rheaps, prevs)
        out["k5_c4"] = best(
            lambda: k5.scan_compact(kern, ev, chase, ranks, rheaps, m),
            lambda: [k5.prepare(kern, ev, chase, ranks, rheaps, m)])
    tape = cs.make_tape(cs.C5_FLUSH * 4, cs.C5_FLUSH, cs.C5_SYMBOLS,
                        seed=5, dt_ms=cs.C5_DT)
    c5 = cs.run_c5(pkg, np, tape, "cuda", record=True)[5]
    k2_ms("k2_c5", sorted(c5, key=lambda b: (
        b[0].has_absent, b[2]["__ts__"].shape[0])))
    if not groups_only:
        calls: list = []
        tape = cs.make_tape(cs.C2_FLUSH * cs.C2_FLUSHES, cs.C2_FLUSH,
                            cs.C2_SYMBOLS, seed=20)
        run_window(cs.C2, tape, "cuda", calls)
        _n, a, kw = max((c for c in calls if c[0] == "win_scan"),
                        key=lambda c: c[1][1])
        out["k6_window"] = k6_ms(a, kw)
        for label, use, cols_of in (("c4n", "rank", "rank_cols"),
                                    ("c4a", "prev", "prev_cols")):
            _l, app, flushes, _f, seed, _e, _n = [
                x for x in cs.ALGEBRA if x[0] == label][0]
            tape = cs.make_tape(cs.FLUSH * flushes, cs.FLUSH, cs.KEYS,
                                seed=seed)
            blocks = cs.run_recorded(pkg, np, app, tape)[4]
            kern, ev, _m = blocks[-1]
            L, F = ev["__nev__"].shape[0], ev["__flat.__ts__"].shape[1]
            masks = cs.scan_inputs(kern, ev, kern.pre_masks(ev))[0]
            cols = getattr(kern, cols_of)(masks)
            out[f"k6_{use}"] = k6_ms((cols, L * F), {"use": use, "period": F})
        for label, flushes, batch, grouped, _q, always in cs.AGGS:
            if label == "a7m":
                continue
            calls = []
            head = "@app:deviceAggregations('always')\n" if always else ""
            run_agg(MATRIX_APP(head, grouped),
                    matrix_tape(flushes, batch, cs.AGG_KEYS), "cuda", calls)
            if always:
                _n, a, kw = max(calls, key=lambda c: c[1][1])
                out["k6_agg"] = k6_ms(a, kw)
                continue
            # the widest call: segments x bases plus the longest segment
            _n, a, kw = max(calls, key=lambda c: c[1][4].shape[0] * len(
                c[2]["ops"]) + cs.agg_merge_work(torch, c[1], c[2])[2])
            scratch = a[0].clone()
            out[f"k10_{label}"] = best(
                lambda: k10.agg_merge(scratch, *a[1:], **kw),
                lambda: [k10.prepare(scratch, *a[1:], **kw)])
        k9_entries(out, cs, best)
        k34_entries(out, cs, pkg, np, best)
    return finish(out, regs)


def finish(out: dict, regs: dict) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return {"card": smi, **out, "ptxas": regs}


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--host"] and len(args) in (3, 4):
        rounds = int(args[3]) if len(args) == 4 else 10
        print(json.dumps(host(*(os.path.abspath(r) for r in args[1:3]),
                              rounds)), flush=True)
        return 0
    only = frozenset(a for a in args if a in GROUPS)
    args = [a for a in args if a not in GROUPS]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(one(os.path.abspath(args[1]), only)), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root] + sorted(only),
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(f"kernel_ab: {root} failed ({proc.returncode}):\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
