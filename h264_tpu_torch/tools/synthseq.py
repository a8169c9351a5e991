"""Seeded synthetic 4:2:0 test sequences.

The reference package's benchmark sequence (tools/benchseq.py) is built
from a foreman clip that this repository does not ship, so the port's
tests and smoke run use made-up content with the features an intra coder
cares about: smoothed-noise texture, a slow diagonal gradient, hard-edged
bright blocks that move from frame to frame, and film-like grain.
"""

from __future__ import annotations

import numpy as np


def _texture(rng, h: int, w: int) -> np.ndarray:
    t = rng.randint(0, 256, (h, w)).astype(np.float64)
    return (t + np.roll(t, 1, 0) + np.roll(t, 1, 1)
            + np.roll(t, 2, 0) + np.roll(t, 2, 1)) / 5.0


def synthetic_frames(n: int, width: int, height: int, seed: int = 0):
    """n frames of (Y (h, w), U (h/2, w/2), V (h/2, w/2)) uint8 arrays."""
    rng = np.random.RandomState(seed)
    base = _texture(rng, height, width)
    cb = _texture(rng, height // 2, width // 2)
    cr = _texture(rng, height // 2, width // 2)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for i in range(n):
        y = 0.55 * base + 0.45 * ((xx + 2 * yy + 5 * i) % 256)
        for k in range(4):  # moving blocks with hard edges
            by = (height // 5) * (k + 1) - 8 + 2 * i
            bx = (width // 5) * (k + 1) - 16 + 3 * i * (k - 1)
            y[max(by, 0):max(by + 24, 0), max(bx, 0):max(bx + 40, 0)] = 40 + 50 * k
        y = y + rng.normal(0.0, 3.0, y.shape)
        ci = 0.3 * i
        out.append((
            y.clip(0, 255).astype(np.uint8),
            (128 + (cb - 128) * 0.6 + ci).clip(0, 255).astype(np.uint8),
            (128 + (cr - 128) * 0.6 - ci).clip(0, 255).astype(np.uint8),
        ))
    return out


def _sample(canvas, y0: float, x0: float, h: int, w: int) -> np.ndarray:
    """Bilinear (h, w) crop of `canvas` at the fractional origin."""
    iy, ix = int(np.floor(y0)), int(np.floor(x0))
    fy, fx = y0 - iy, x0 - ix
    a = canvas[iy:iy + h + 1, ix:ix + w + 1]
    return ((1 - fy) * (1 - fx) * a[:-1, :-1] + (1 - fy) * fx * a[:-1, 1:]
            + fy * (1 - fx) * a[1:, :-1] + fy * fx * a[1:, 1:])


def moving_frames(n: int, width: int, height: int, seed: int = 0,
                  pan=(0.75, 1.25), fade: float = 0.05):
    """n frames in which motion search, sub-pel refinement, several
    references and weighted prediction all have work to do: a textured
    background that pans by a fractional (dy, dx) per frame and fades
    (luma gain 1 - fade * i), a block that jumps back and forth every
    frame (so the picture two back matches it better than the last one),
    a block moving against the pan, and a patch that turns a new flat
    colour every frame (better coded intra).  Same tuple layout as
    ``synthetic_frames``."""
    rng = np.random.RandomState(seed)
    m = 8 + int(np.ceil(max(abs(pan[0]), abs(pan[1])) * n))
    Hc, Wc = height + 2 * m, width + 2 * m
    canvas = 0.7 * _texture(rng, Hc, Wc) + 0.3 * (
        (np.mgrid[0:Hc, 0:Wc][1] * 2 + np.mgrid[0:Hc, 0:Wc][0]) % 256)
    cb = _texture(rng, Hc // 2 + 1, Wc // 2 + 1)
    cr = _texture(rng, Hc // 2 + 1, Wc // 2 + 1)
    blob = _texture(rng, 24, 32) * 0.5 + 100
    out = []
    for i in range(n):
        oy, ox = m + pan[0] * i, m + pan[1] * i
        y = _sample(canvas, oy, ox, height, width)
        by, bx = height // 4, width // 5 + 8 * (i % 2)
        y[by:by + 24, bx:bx + 32] = blob
        my, mx = height // 2, max(0, width // 2 - 3 * i)
        y[my:my + 16, mx:mx + 24] = blob[:16, :24][:, ::-1] + 40
        py, px = (3 * height) // 4 - 8, (3 * width) // 4
        y[py:py + 16, px:px + 16] = 30 + (i * 67) % 200
        y = y * (1.0 - fade * i) + rng.normal(0.0, 1.5, y.shape)
        u = _sample(cb, oy / 2, ox / 2, height // 2, width // 2)
        v = _sample(cr, oy / 2, ox / 2, height // 2, width // 2)
        out.append((
            y.clip(0, 255).astype(np.uint8),
            (128 + (u - 128) * 0.6).clip(0, 255).astype(np.uint8),
            (128 + (v - 128) * 0.6).clip(0, 255).astype(np.uint8),
        ))
    return out
