"""Geometry annotations of the pattern plans.

Port of `pattern_family_for` (siddhi_tpu/core/autotune.py:437) and
`fused_lane_pack_for` (:462) and `agg_capacity_for` (:477) for the
annotations alone: the tuning cache, which the JAX package consults after
them, is a later slice of the port, and `chunk_lanes_for` comes with the
`chunk` family, which reads it.
"""
from __future__ import annotations

from typing import Optional

from ..query import ast
from .planner import PlanError

PATTERN_FAMILIES = ("seq", "chunk", "scan", "dfa")


class AutotuneError(PlanError):
    """A malformed plan-family annotation (a PlanError, so app creation
    fails with it)."""


def pattern_family_for(rt, q=None) -> Optional[str]:
    """Requested pattern execution family (seq|chunk|scan|dfa), or None
    for automatic selection.  The plan only honours a family its
    eligibility analysis proved sound (DevicePatternPlan.families): an
    ineligible request falls back with a warning."""
    an = ast.find_annotation(rt.app.annotations, "app:patternFamily")
    if an is not None:
        fam = str(an.element()).lower()
        if fam in ("auto", ""):
            return None
        if fam not in PATTERN_FAMILIES:
            raise AutotuneError(
                f"@app:patternFamily({fam!r}): unknown family "
                f"(have {PATTERN_FAMILIES} or 'auto')")
        return fam
    return None


def fused_lane_pack_for(rt) -> int:
    """Fused multi-query lane packing: at most this many query instances
    per fused plan (0 = unbounded, one plan per group), from
    `@app:fusedLanes(N)`."""
    an = ast.find_annotation(rt.app.annotations, "app:fusedLanes")
    return max(0, int(an.element())) if an is not None else 0


AGG_CAPACITY = 1024


def agg_capacity_for(rt) -> int:
    """Initial slot count of a device-resident aggregation ring, per
    duration (core/agg_device.py; the ring doubles when full, so this is
    a starting geometry, not a bound): `@app:aggCapacity(N)` (at least
    8), else `AGG_CAPACITY`."""
    an = ast.find_annotation(rt.app.annotations, "app:aggCapacity")
    return max(8, int(an.element())) if an is not None else AGG_CAPACITY
