"""Sub-pel interpolation for motion compensation (spec §8.4.2.2).

Luma: 6-tap [1,-5,20,20,-5,1] half-pel + quarter-pel averaging; chroma:
bilinear eighth-pel.  Host oracle operates on edge-padded reference
planes (padding == the reference's unrestricted-MV coordinate clamping,
ldecod/src/mc_prediction.c get_block_luma:149).  The encoder-side
precomputed-plane variant (img_luma.c getSubImagesLuma) reuses the same
tap math as whole-plane convolutions.
"""

from __future__ import annotations

import numpy as np

PAD = 32  # enough for 16-pel MBs + 3-tap margin + large MVs clamped first


def pad_plane(plane: np.ndarray, pad: int = PAD) -> np.ndarray:
    return np.pad(plane.astype(np.int32), pad, mode="edge")


def _conv6_h(P: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Unnormalized horizontal 6-tap at half position x0+0.5 (rows y0..)."""
    sl = lambda dx: P[y0 : y0 + h, x0 + dx : x0 + dx + w]
    return (
        sl(-2) - 5 * sl(-1) + 20 * sl(0) + 20 * sl(1) - 5 * sl(2) + sl(3)
    )


def _conv6_v(P: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    sl = lambda dy: P[y0 + dy : y0 + dy + h, x0 : x0 + w]
    return (
        sl(-2) - 5 * sl(-1) + 20 * sl(0) + 20 * sl(1) - 5 * sl(2) + sl(3)
    )


def _clip8(x, max_val):
    return x.clip(0, max_val)


def luma_block(Ppad: np.ndarray, pad: int, x_int: int, y_int: int,
               dx: int, dy: int, w: int, h: int, max_val: int = 255) -> np.ndarray:
    """Predict a w x h luma block at integer position (x_int, y_int) with
    quarter-pel fraction (dx, dy) from the padded plane."""
    x0, y0 = x_int + pad, y_int + pad
    if dx == 0 and dy == 0:
        return Ppad[y0 : y0 + h, x0 : x0 + w].copy()

    def full(ddx, ddy):
        return Ppad[y0 + ddy : y0 + ddy + h, x0 + ddx : x0 + ddx + w]

    def half_h(ddx, ddy):  # b at (x0+ddx+0.5, y0+ddy)
        return _clip8((_conv6_h(Ppad, x0 + ddx, y0 + ddy, w, h) + 16) >> 5, max_val)

    def half_v(ddx, ddy):
        return _clip8((_conv6_v(Ppad, x0 + ddx, y0 + ddy, w, h) + 16) >> 5, max_val)

    def center_j(ddx, ddy):
        # vertical 6-tap over unclipped horizontal intermediates
        b1 = _conv6_h(
            Ppad.astype(np.int64), x0 + ddx, y0 + ddy - 2, w, h + 5
        )
        j1 = (
            b1[0:h] - 5 * b1[1 : h + 1] + 20 * b1[2 : h + 2]
            + 20 * b1[3 : h + 3] - 5 * b1[4 : h + 4] + b1[5 : h + 5]
        )
        return _clip8((j1 + 512) >> 10, max_val).astype(np.int32)

    def avg(a, b):
        return (a.astype(np.int32) + b + 1) >> 1

    if dy == 0:  # horizontal only: a, b, c
        b = half_h(0, 0)
        if dx == 1:
            return avg(full(0, 0), b)
        if dx == 2:
            return b
        return avg(b, full(1, 0))
    if dx == 0:  # vertical only: d, h, n
        hh = half_v(0, 0)
        if dy == 1:
            return avg(full(0, 0), hh)
        if dy == 2:
            return hh
        return avg(hh, full(0, 1))
    if dx == 2 and dy == 2:
        return center_j(0, 0)
    if dx == 2:  # f (dy=1) / q (dy=3): avg of j and b/s
        j = center_j(0, 0)
        b = half_h(0, 0) if dy == 1 else half_h(0, 1)
        return avg(b, j)
    if dy == 2:  # i (dx=1) / k (dx=3): avg of j and h/m
        j = center_j(0, 0)
        hh = half_v(0, 0) if dx == 1 else half_v(1, 0)
        return avg(hh, j)
    # diagonal quarters e, g, p, r: avg of nearest b and h
    b = half_h(0, 0) if dy == 1 else half_h(0, 1)
    hh = half_v(0, 0) if dx == 1 else half_v(1, 0)
    return avg(b, hh)


def chroma_block(Cpad: np.ndarray, pad: int, x_int: int, y_int: int,
                 fx: int, fy: int, w: int, h: int) -> np.ndarray:
    """Bilinear eighth-pel chroma prediction (spec §8.4.2.2.2)."""
    x0, y0 = x_int + pad, y_int + pad
    A = Cpad[y0 : y0 + h, x0 : x0 + w].astype(np.int32)
    B = Cpad[y0 : y0 + h, x0 + 1 : x0 + 1 + w]
    C = Cpad[y0 + 1 : y0 + 1 + h, x0 : x0 + w]
    D = Cpad[y0 + 1 : y0 + 1 + h, x0 + 1 : x0 + 1 + w]
    return (
        (8 - fx) * (8 - fy) * A
        + fx * (8 - fy) * B
        + (8 - fx) * fy * C
        + fx * fy * D
        + 32
    ) >> 6


# ---------------------------------------------------------------------------
# Precomputed half-pel planes (encoder-side strategy, JM img_luma.c
# getSubImagesLuma / UnifiedOneForthPix): compute b (horizontal half),
# h (vertical half), j (center) once per reference frame; every quarter-pel
# position is then an average of two plane samples (spec §8.4.2.2.1).
# Works under numpy or jax.numpy on the PADDED plane (padding == UMV clamp).
# ---------------------------------------------------------------------------

def half_planes(Ppad, max_val: int = 255):
    """From padded int32 plane (Hp, Wp) compute (b, h, j) planes of size
    (Hp-5, Wp-5) aligned so that index [y, x] is the sub-sample at
    (x+0.5, y), (x, y+0.5), (x+0.5, y+0.5) for positions x,y in the
    padded coordinate system offset by 2 (see `plane_origin`)."""
    P = Ppad.astype(Ppad.dtype)
    Hp, Wp = P.shape

    def c6_h(A):
        return (
            A[:, 0:-5] - 5 * A[:, 1:-4] + 20 * A[:, 2:-3]
            + 20 * A[:, 3:-2] - 5 * A[:, 4:-1] + A[:, 5:]
        )

    def c6_v(A):
        return (
            A[0:-5] - 5 * A[1:-4] + 20 * A[2:-3]
            + 20 * A[3:-2] - 5 * A[4:-1] + A[5:]
        )

    b1 = c6_h(P)  # (Hp, Wp-5): half at (x+2.5) -> aligned x+2
    h1 = c6_v(P)  # (Hp-5, Wp)
    j1 = c6_v(b1.astype(P.dtype) if hasattr(b1, "astype") else b1)
    b = ((b1[2:-3, :] + 16) >> 5).clip(0, max_val)
    h = ((h1[:, 2:-3] + 16) >> 5).clip(0, max_val)
    j = ((j1 + 512) >> 10).clip(0, max_val)
    return b, h, j


PLANE_OFF = 2  # half-plane index [y, x] corresponds to padded pixel (y+2, x+2)


def qpel_from_planes(G, b, h, j, y, x, dy, dx):
    """Sample one qpel value at integer (y, x) in padded coords with
    fraction (dy, dx); G is the padded full-pel plane; b/h/j from
    half_planes (with PLANE_OFF alignment).  Scalar/array polymorphic.

    This mirrors the decoder's on-the-fly derivation exactly, so the
    encoder's plane-based prediction is bit-identical to any decoder."""
    yb, xb = y - PLANE_OFF, x - PLANE_OFF

    def avg(p, q):
        return (p + q + 1) >> 1

    if dx == 0 and dy == 0:
        return G[y, x]
    if dy == 0:
        if dx == 1:
            return avg(G[y, x], b[yb, xb])
        if dx == 2:
            return b[yb, xb]
        return avg(b[yb, xb], G[y, x + 1])
    if dx == 0:
        if dy == 1:
            return avg(G[y, x], h[yb, xb])
        if dy == 2:
            return h[yb, xb]
        return avg(h[yb, xb], G[y + 1, x])
    if dx == 2 and dy == 2:
        return j[yb, xb]
    if dx == 2:
        if dy == 1:
            return avg(b[yb, xb], j[yb, xb])
        return avg(j[yb, xb], b[yb + 1, xb])
    if dy == 2:
        if dx == 1:
            return avg(h[yb, xb], j[yb, xb])
        return avg(j[yb, xb], h[yb, xb + 1])
    # both odd: diagonal quarter = avg of nearest b and h
    bb = b[yb, xb] if dy == 1 else b[yb + 1, xb]
    hh = h[yb, xb] if dx == 1 else h[yb, xb + 1]
    return avg(bb, hh)
