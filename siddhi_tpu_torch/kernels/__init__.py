"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for tensors on the CPU; `LAUNCHES` counts kernel launches
(one per launch, nowhere else) so a run can show that the main path went
through the kernels.  K1 is counted per use: the filter/projection step,
the NFA pre-masks, the pattern selector, and the window step's arguments
and selector.  K3-K5 (`seg_tree`, `scan_chase`, `scan_compact`) carry
the `scan` plan family, K6-K8 (`win_scan`, `win_range`, `win_compact`)
the window plans.  The `scan` family's count and logical positions add
two uses of K6 on its lane grid (`win_scan:rank` occurrence ranks,
`win_scan:prev` prev-match pointers) and one of K3 (`seg_tree:rank`,
the max-trees over the ranks).  K9 `join_probe` carries the window
joins (one launch per probing direction), after K1's side filters (use
`join_filter`).  K10 `agg_merge` folds an incremental aggregation's
batch segments into its device-resident bucket rings (one launch per
duration a batch); under `@app:deviceAggregations('always')` the
aggregation's per-batch segmented scans run on K6 (use `agg`).  K2
counts a launch of its EXT instantiation (init slots, slot forking,
absent sides of and/or) as `nfa_block:ext`, a launch over a `chunk`
block's own-chunks as `nfa_block:chunk`, any other as `nfa_block`.  The
`dfa` family adds K11 `dfa_tables` (its stride-4 symbol tables) and
counts K4's launches in its table-lookup mode as `scan_chase:dfa`.
Under `@app:devicePrecision('f64')` the float64 forms count apart, with
`:f64` after the name: K2's float64 instantiations (`nfa_block:f64`,
`nfa_block:ext:f64`, `nfa_block:chunk:f64`), K5's float64 rows
(`scan_compact:f64`), and K3 and K4 where they build or descend a
float64 tree (`seg_tree:f64`, `scan_chase:f64`, `scan_chase:dfa:f64`).
"""
LAUNCHES = {"expr_eval:filter": 0, "expr_eval:pre_mask": 0,
            "expr_eval:select": 0, "expr_eval:window_args": 0,
            "expr_eval:window_select": 0, "expr_eval:join_filter": 0,
            "join_probe": 0, "nfa_block": 0, "nfa_block:ext": 0,
            "nfa_block:chunk": 0, "nfa_block:f64": 0,
            "nfa_block:ext:f64": 0, "nfa_block:chunk:f64": 0,
            "seg_tree": 0, "seg_tree:rank": 0, "seg_tree:f64": 0,
            "scan_chase": 0, "scan_chase:dfa": 0, "scan_chase:f64": 0,
            "scan_chase:dfa:f64": 0, "dfa_tables": 0,
            "scan_compact": 0, "scan_compact:f64": 0,
            "win_scan": 0, "win_scan:rank": 0, "win_scan:prev": 0,
            "win_scan:agg": 0, "win_range": 0, "win_compact": 0,
            "agg_merge": 0}


# counter -> the parameter block of each launch counted there, in launch
# order, for the counters named to `record_params`: what a run's launches
# really ran (K1's grid, warps a block, rows a thread and stack, K11's
# tiles a lane)
PARAMS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def record_params(*counters: str) -> None:
    """From now on keep the parameter block of every launch counted under
    `counters` (what was kept before is dropped; none: keep nothing)."""
    PARAMS.clear()
    PARAMS.update({c: [] for c in counters})
