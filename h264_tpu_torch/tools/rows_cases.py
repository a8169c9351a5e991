"""Built inputs of the tile-row P pipeline whose motion reaches every edge
of every slab.

``edge_motion(H, W, R)`` makes one reference picture of smoothed noise and
four current pictures that are the same content moved by R pels along
each diagonal, so that the motion search of every tile row picks vectors
of +-R up to the slab's edges (and the sub-8x8 centres their clamp).
The tests hold the windows the pipeline reads inside the slabs on them,
and ``chip_smoke.py`` and the ``gpu`` tests hold the kernel entries
against their plain versions on them.
"""

from __future__ import annotations

import numpy as np

SHIFTS = ((1, 1), (-1, -1), (1, -1), (-1, 1))  # (dy, dx) in units of R


def edge_motion(H: int, W: int, R: int, seed: int = 5):
    """(reference (Y, U, V), [current (Y, U, V)] for the four shifts), all
    int64 numpy planes in 0..255 (chroma unmoved)."""
    rng = np.random.RandomState(seed)
    big = rng.randint(0, 256, (H + 2 * R + 2, W + 2 * R + 2))
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    ref_c = [rng.randint(0, 256, (H // 2, W // 2)) for _ in range(2)]
    ref = (big[R:R + H, R:R + W], *ref_c)
    curs = [(big[R + sy * R:R + sy * R + H, R + sx * R:R + sx * R + W],
             *ref_c) for sy, sx in SHIFTS]
    return ref, curs
