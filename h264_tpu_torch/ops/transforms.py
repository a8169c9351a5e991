"""Exact integer transforms (spec §8.5): the 4x4 core transform, its
inverse, the luma/chroma DC Hadamards and the 8x8 forward and inverse
transforms (FRExt).

All functions transform the trailing two axes of (..., N, N) arrays, so
a whole picture's blocks go through one call.  They take torch tensors
(the encoder and the decoder's inter path) or numpy arrays (the
decoder's host reconstruction, as the reference package's ``_np_of``
allows) and return the same kind.  Axis -2 indexes rows (y), axis -1
columns (x); a 1-D pass works along the last axis and the other
direction swaps the trailing axes.  ``>>`` on int32 is an arithmetic
shift, which the H.264 butterflies rely on.
"""

from __future__ import annotations

import numpy as np
import torch


def _swap(x):
    return x.swapaxes(-1, -2)


def _stack(xs, axis: int):
    """Stack torch tensors or numpy arrays along `axis`."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, axis)
    return np.stack(xs, axis=axis)


def _cols(b, n: int):
    return [b[..., i] for i in range(n)]


def _fwd4_1d(b):
    """Forward 4-point butterfly along the last axis."""
    p0, p1, p2, p3 = _cols(b, 4)
    t0 = p0 + p3
    t1 = p1 + p2
    t2 = p1 - p2
    t3 = p0 - p3
    return _stack([t0 + t1, (t3 << 1) + t2, t0 - t1, t3 - (t2 << 1)], -1)


def _inv4_1d(b):
    """Inverse 4-point butterfly along the last axis."""
    w0, w1, w2, w3 = _cols(b, 4)
    e0 = w0 + w2
    e1 = w0 - w2
    e2 = (w1 >> 1) - w3
    e3 = w1 + (w3 >> 1)
    return _stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)


def _had4_1d(b):
    w0, w1, w2, w3 = _cols(b, 4)
    e0 = w0 + w2
    e1 = w0 - w2
    e2 = w1 - w3
    e3 = w1 + w3
    return _stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)


def forward4x4(block):
    """2-D forward core transform of (..., 4, 4) residuals (row pass,
    then column pass; the scaling is absorbed by quantization)."""
    return _swap(_fwd4_1d(_swap(_fwd4_1d(block))))


def inverse4x4(coef):
    """2-D inverse core transform of (..., 4, 4) dequantized coefficients,
    horizontal first as in JM.  Output is the scaled residual: the caller
    adds prediction << 6, rounds by >> 6 and clips."""
    return _swap(_inv4_1d(_swap(_inv4_1d(coef))))


def hadamard4x4(block):
    """4x4 Hadamard (both directions), used for luma DC and SATD."""
    return _swap(_had4_1d(_swap(_had4_1d(block))))


def hadamard2x2(block):
    """2x2 Hadamard of (..., 2, 2) chroma DC arrays (no normalization)."""
    a = block[..., 0, 0]
    b = block[..., 0, 1]
    c = block[..., 1, 0]
    d = block[..., 1, 1]
    top = _stack([a + b + c + d, a - b + c - d], -1)
    bot = _stack([a + b - c - d, a - b - c + d], -1)
    return _stack([top, bot], -2)


def _fwd8_1d(b):
    """Forward 8-point butterfly along the last axis."""
    p = _cols(b, 8)
    s0 = p[0] + p[7]
    s1 = p[1] + p[6]
    s2 = p[2] + p[5]
    s3 = p[3] + p[4]
    b0 = s0 + s3
    b1 = s1 + s2
    b2 = s0 - s3
    b3 = s1 - s2
    d0 = p[0] - p[7]
    d1 = p[1] - p[6]
    d2 = p[2] - p[5]
    d3 = p[3] - p[4]
    b4 = d1 + d2 + ((d0 >> 1) + d0)
    b5 = d0 - d3 - ((d2 >> 1) + d2)
    b6 = d0 + d3 - ((d1 >> 1) + d1)
    b7 = d1 - d2 + ((d3 >> 1) + d3)
    return _stack(
        [b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1), b5 + (b6 >> 2), b0 - b1,
         b6 - (b5 >> 2), (b2 >> 1) - b3, (b4 >> 2) - b7], -1)


def forward8x8(block):
    """2-D forward 8x8 transform of (..., 8, 8) residuals, horizontal pass
    then vertical (lencod/src/transform.c:229): the internal >>1 and >>2
    make the two passes non-commutative."""
    return _swap(_fwd8_1d(_swap(_fwd8_1d(block))))


def _inv8_1d(m):
    """Inverse 8-point butterfly along the last axis."""
    p = _cols(m, 8)
    a0 = p[0] + p[4]
    a4 = p[0] - p[4]
    a2 = (p[2] >> 1) - p[6]
    a6 = p[2] + (p[6] >> 1)
    b0 = a0 + a6
    b2 = a4 + a2
    b4 = a4 - a2
    b6 = a0 - a6
    a1 = -p[3] + p[5] - p[7] - (p[7] >> 1)
    a3 = p[1] + p[7] - p[3] - (p[3] >> 1)
    a5 = -p[1] + p[7] + p[5] + (p[5] >> 1)
    a7 = p[3] + p[5] + p[1] + (p[1] >> 1)
    b1 = a1 + (a7 >> 2)
    b7 = a7 - (a1 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    return _stack(
        [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7],
        -1)


def inverse8x8(coef):
    """2-D inverse 8x8 transform of (..., 8, 8) dequantized coefficients,
    horizontal pass then vertical (ldecod/src/transform8x8.c itrans8x8)."""
    return _swap(_inv8_1d(_swap(_inv8_1d(coef))))
