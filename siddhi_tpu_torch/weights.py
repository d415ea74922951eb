"""Carry device pattern state across from the JAX package.

A stream processor's "weights" are its pattern state.  For the `seq`
family that is the slot state, the stationed partial matches, their
captures and presence rows, count and logical rows, their absent-state
deadlines (`dl`, one row per absent node with a waiting time, in the JAX
package's order) and an init-slot chain's per-lane `init` flags:
`nfa_state_from_jax` turns the `state` entry of a `siddhi_tpu`
DevicePatternPlan.state_dict() (numpy arrays) into this port's state
tensors, and the rest of that dict (key map, ts/seq bases, last seq, the
next deadline, the START anchor `start_anchor`) loads as it is through
DevicePatternPlan.load_state_dict.  A fused multi-query plan's
state_dict() is its inner plan's, lanes being query instances, and
carries over the same way.
`nfa_state_to_numpy` is the inverse view the tests compare with.

A window plan's state is its carry (`ts`, `valid`, `seen`, `start` and
the carried columns `c.<col>`): `window_state_from_jax` turns a JAX
DeviceWindowAggPlan.state_dict() into tensors that the port's plan
loads, deriving there the aggregates' argument values it carries beside
the columns.

A join plan's state is its two host mirrors (each side's window content:
columns, `ts`, `seq`); `join_state_from_jax` copies a JAX
DeviceJoinPlan.state_dict() into the dict the port's plan loads.

An incremental aggregation's state is its per-duration bucket store,
{duration value: {(bucket start, group key): [bases]}}, the same in both
packages; a string group key is the runtime's string code, so
`agg_state_from_jax` maps those codes through both string tables.  The
port's AggregationRuntime.load_state_dict loads the result (and refills
its device rings from it).

The stateless families (`scan`, `dfa`, `chunk`) keep no device state:
their continuity is the replay tail of the last `within` window (per key
when partitioned), the last emitted completion seq (per key), a one-shot
head's resolution flag and, for `chunk`, the heads dropped at the slot
cap.  `stateless_state_from_jax` takes those from a JAX `scan`, `dfa` or
`chunk` plan's state_dict() into the dict the port's plan loads.  The
string table travels apart (`rt.strings.state()` / `restore`), as for
`seq`.
"""
from __future__ import annotations

import numpy as np
import torch

_KEYS = ("occ", "first_ts", "head_seq", "cnt", "cnt_on", "narm", "fl",
         "caps_f", "caps_i", "caps_l", "dl", "armed0", "of_slots",
         "of_lanes")
_DTYPES = {"occ": np.int32, "first_ts": np.int32, "head_seq": np.int32,
           "cnt": np.int32, "cnt_on": np.bool_, "narm": np.bool_,
           "fl": np.int32, "caps_f": np.float32, "caps_i": np.int32,
           "caps_l": np.int64, "dl": np.int32, "armed0": np.bool_,
           "of_slots": np.int32, "of_lanes": np.int32}


def nfa_state_from_jax(np_state: dict, device) -> dict:
    """JAX `seq`-family slot state (numpy) -> the port's state tensors:
    stations, captures and presence rows, count rows (`cnt`, `cnt_on`,
    `narm`), logical fill bits (`fl`), deadlines, the lane counters and,
    for an init-slot chain, the lanes' `init` flags."""
    missing = [k for k in _KEYS if k not in np_state]
    if missing:
        raise ValueError(f"not a `seq`-family NFA state (missing {missing}); "
                         f"stateless families hold no slot state")
    out = {}
    for k in _KEYS:
        a = np.asarray(np_state[k])
        if a.dtype != _DTYPES[k]:
            raise ValueError(f"state leaf {k!r} has dtype {a.dtype}, "
                             f"expected {np.dtype(_DTYPES[k])} (an f64-mode "
                             f"plan is not in this slice)")
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    if np_state.get("init") is not None:
        out["init"] = torch.from_numpy(np.array(
            np_state["init"], dtype=np.bool_, copy=True)).to(device)
    return out


def nfa_state_to_numpy(state: dict) -> dict:
    """The port's state tensors as numpy arrays (JAX leaf names)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _tail(t, part: bool):
    """A JAX replay tail {ts, seq, scode[, part], cols} as fresh arrays;
    an unpartitioned (flat) tail gets lane 0 as its `part`."""
    if t is None:
        return None
    out = {k: np.array(t[k], copy=True) for k in ("ts", "seq", "scode")}
    out["part"] = (np.array(t["part"], copy=True) if part else
                   np.zeros(len(out["ts"]), dtype=np.int32))
    out["cols"] = {}
    for c, v in t["cols"].items():
        a = np.array(v, copy=True)
        if a.dtype == np.float64:
            raise ValueError(f"tail column {c!r} is float64: an f64-mode "
                             f"plan is not in this slice")
        out["cols"][c] = a
    return out


def stateless_state_from_jax(d: dict) -> dict:
    """A JAX stateless-family (`scan`, `dfa`, `chunk`) plan's
    state_dict() -> the dict the port's DevicePatternPlan.load_state_dict
    takes on a plan of the same family.  The port runs an unpartitioned
    pattern as one lane, so the JAX flat tail (`chunk_tail`,
    `chunk_prev_last_seq`) becomes lane 0's, and `chunk_of_dropped` the
    plan's `of_dropped`; a fused
    group's query lanes share that one tail and keep their own one-shot
    flags (`arm_done`).  Every array is copied: the JAX dict aliases the
    live plan's state."""
    if "chunk_prev_last_seq" not in d:
        raise ValueError("not a stateless-family plan state (no replay "
                         "tail); a `seq` plan's slot state loads through "
                         "nfa_state_from_jax")
    arm = d.get("arm_done")
    if d.get("chunk_tail") is not None:
        tail = _tail(d["chunk_tail"], part=False)
        lane_prev = np.array([d["chunk_prev_last_seq"]], dtype=np.int64)
    else:
        tail = _tail(d.get("lane_tail"), part=True)
        lane_prev = np.array(d.get("lane_prev", []), dtype=np.int64)
    return {"key_to_part": dict(d["key_to_part"]),
            "ts_base": d.get("ts_base"), "seq_base": d.get("seq_base"),
            "last_seq": d.get("last_seq"),
            "lane_tail": tail, "lane_prev": lane_prev,
            "arm_done": None if arm is None else np.array(arm, dtype=bool),
            "of_dropped": int(d.get("chunk_of_dropped") or 0)}


def window_state_from_jax(d: dict, device) -> dict:
    """A JAX DeviceWindowAggPlan.state_dict() (numpy) -> the dict the
    port's DeviceWindowAggPlan.load_state_dict takes (same keys, tensors
    on `device`)."""
    return {"C": int(d["C"]),
            "state": {k: torch.from_numpy(np.array(v, copy=True)).to(device)
                      for k, v in d["state"].items()}}


def join_state_from_jax(d: dict) -> dict:
    """A JAX DeviceJoinPlan.state_dict() (host mirrors, numpy) -> the dict
    the port's DeviceJoinPlan.load_state_dict takes: per side the mirror
    columns with their dtypes, `ts` and `seq` as int64, all copied."""
    return {side: {"cols": {k: np.array(v, copy=True)
                            for k, v in d[side]["cols"].items()},
                   "ts": np.array(d[side]["ts"], dtype=np.int64),
                   "seq": np.array(d[side]["seq"], dtype=np.int64)}
            for side in ("left", "right")}


def agg_state_from_jax(d: dict, jax_strings, port_strings,
                       string_keys=()) -> dict:
    """A JAX AggregationRuntime.state_dict() as the port's
    AggregationRuntime.load_state_dict input: each key's string group
    values (the positions `string_keys`, the port runtime's
    `string_keys`) go from the JAX runtime's string codes to the port's
    (`jax_strings`, `port_strings`: the two StringTables, read with
    decode/encode); bases are copied as Python floats."""
    def key(k):
        start, g = k
        return (int(start), tuple(
            port_strings.encode(jax_strings.decode(int(v)))
            if i in string_keys else v for i, v in enumerate(g)))
    return {"store": {dv: {key(k): [float(x) for x in v]
                           for k, v in st.items()}
                      for dv, st in d["store"].items()}}
