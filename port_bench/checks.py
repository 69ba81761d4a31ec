"""Numbers held against limits: the part of the check that every cell shares.

An entry's ``judge`` works out its numbers; ``judge`` here sets each
beside its limit from ``limits/<workload>.json``. A number that is not
finite fails its limit.
"""

from __future__ import annotations

import math


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def judge(nums: dict, limits: dict):
    """({name: {"value", "limit"}} for every limited number, in the
    limits' order; whether all hold)."""
    checks = {k: {"value": nums[k], "limit": float(v)} for k, v in limits.items()}
    return checks, all(within(c["value"], c["limit"]) for c in checks.values())
