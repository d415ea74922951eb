"""Carry device pattern state across from the JAX package.

A stream processor's "weights" are its slot state: the stationed partial
matches and their captures.  `nfa_state_from_jax` turns the `state` entry
of a `siddhi_tpu` DevicePatternPlan.state_dict() (numpy arrays, family
`seq`) into this port's state tensors; the rest of that dict (key map,
ts/seq bases, last seq) loads as it is through
DevicePatternPlan.load_state_dict.  `nfa_state_to_numpy` is the inverse
view the tests compare with.
"""
from __future__ import annotations

import numpy as np
import torch

# leaves of the JAX state that this slice's algebra never fills: count,
# logical and absent rows, init flags, and the direct-emit lane overflow
_UNUSED = ("cnt", "cnt_on", "narm", "fl", "dl", "init", "of_lanes")
_KEYS = ("occ", "first_ts", "head_seq", "caps_f", "caps_i", "caps_l",
         "armed0", "of_slots")
_DTYPES = {"occ": np.int32, "first_ts": np.int32, "head_seq": np.int32,
           "caps_f": np.float32, "caps_i": np.int32, "caps_l": np.int64,
           "armed0": np.bool_, "of_slots": np.int32}


def nfa_state_from_jax(np_state: dict, device) -> dict:
    """JAX `seq`-family slot state (numpy) -> the port's state tensors."""
    for k in _UNUSED:
        v = np_state.get(k)
        if v is not None and np.asarray(v).size and k != "init" \
                and np.any(np.asarray(v) != (0 if k != "dl" else 2**31 - 1)):
            raise ValueError(f"JAX state leaf {k!r} is in use: its pattern "
                             f"algebra is not in this slice")
        if k == "init" and v is not None:
            raise ValueError("init-slot chains are not in this slice")
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
    return out


def nfa_state_to_numpy(state: dict) -> dict:
    """The port's state tensors as numpy arrays (JAX leaf names)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
