"""DistScaleFactor of temporal direct prediction (spec §8.4.1.2.3), the
three functions the B slice needs from the reference package's
decoder/mv.py:293-309, with C-style integer division (truncation toward
zero)."""

from __future__ import annotations


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def dist_scale_factor(cur_poc: int, poc0: int, poc1: int) -> int:
    """DistScaleFactor per spec §8.4.1.2.3 (8-202..8-203); used by both
    temporal direct and implicit weighted prediction."""
    tb = _clip3(-128, 127, cur_poc - poc0)
    td = _clip3(-128, 127, poc1 - poc0)
    tx = _cdiv(16384 + abs(_cdiv(td, 2)), td)
    return _clip3(-1024, 1023, (tb * tx + 32) >> 6)
