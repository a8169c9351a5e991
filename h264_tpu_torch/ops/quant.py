"""Quantization / dequantization with exact JM arithmetic.

The normative scale tables (spec §8.5.9 normAdjust4x4 / normAdjust8x8
and the encoder MF table) are generated from their 6-values-per-
position-class structure.  Dequant semantics match the reference decoder
exactly (ldecod/src/macroblock.c:3179/2699, block.c itrans_2, chroma-DC
path macroblock.c:3838-3857).

``qp`` may be a Python int or a 0-d tensor; it selects a table row and
the shifts, so it is read as an int once per call (a 0-d CUDA tensor is
fetched to the host there).  Every function takes int tensors (the
device pipelines, flat scaling) or numpy arrays (the decoder's host
reconstruction and the host-path encoder, with the SPS scaling matrices as
``weight_scale``) and returns the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import rshift_rnd, rshift_rnd_sf

# 4x4 position classes: 0 = both coords even, 1 = both odd, 2 = mixed
_CLASS4 = np.array(
    [[0 if (i % 2 == 0 and j % 2 == 0) else 1 if (i % 2 and j % 2) else 2
      for j in range(4)] for i in range(4)]
)

# normAdjust4x4 (dequant) per qp%6, per class
_V4 = np.array(
    [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
)
# encoder MF (quant) per qp%6, per class
_M4 = np.array(
    [
        [13107, 5243, 8066],
        [11916, 4660, 7490],
        [10082, 4194, 6554],
        [9362, 3647, 5825],
        [8192, 3355, 5243],
        [7282, 2893, 4559],
    ]
)



def _class8(i: int, j: int) -> int:
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


_CLASS8 = np.array([[_class8(i, j) for j in range(8)] for i in range(8)])

# normAdjust8x8 (dequant) per qp%6, per class
_V8 = np.array(
    [
        [20, 18, 32, 19, 25, 24],
        [22, 19, 35, 21, 28, 26],
        [26, 23, 42, 24, 33, 31],
        [28, 25, 45, 26, 35, 33],
        [32, 28, 51, 30, 40, 38],
        [36, 32, 58, 34, 46, 43],
    ]
)

# encoder MF (quant) 8x8 per qp%6, per class
_M8 = np.array(
    [
        [13107, 11428, 20972, 12222, 16777, 15481],
        [11916, 10826, 19174, 11058, 14980, 14290],
        [10082, 8943, 15978, 9675, 12710, 11985],
        [9362, 8228, 14913, 8931, 11984, 11259],
        [8192, 7346, 13159, 7740, 10486, 9777],
        [7282, 6428, 11570, 6830, 9118, 8640],
    ]
)

# (6, 4, 4) and (6, 8, 8) int32 tables
DEQUANT4 = _V4[:, _CLASS4].astype(np.int32)
QUANT4 = _M4[:, _CLASS4].astype(np.int32)
DEQUANT8 = _V8[:, _CLASS8].astype(np.int32)
QUANT8 = _M8[:, _CLASS8].astype(np.int32)
FLAT_SCALE_16 = 16

Q_BITS_4 = 15
Q_BITS_8 = 16


def _per_rem(qp) -> tuple[int, int]:
    return divmod(int(qp), 6)


def inv_level_scale4(qp_rem: int, weight_scale=None) -> np.ndarray:
    """InvLevelScale4x4 = normAdjust4x4 * weightScale (flat 16 by
    default), int32 (4, 4)."""
    w = (FLAT_SCALE_16 if weight_scale is None
         else np.asarray(weight_scale, np.int32))
    return (DEQUANT4[qp_rem] * w).astype(np.int32)


def inv_level_scale8(qp_rem: int, weight_scale=None) -> np.ndarray:
    """InvLevelScale8x8 = normAdjust8x8 * weightScale (flat 16 by
    default), int32 (8, 8)."""
    w = (FLAT_SCALE_16 if weight_scale is None
         else np.asarray(weight_scale, np.int32))
    return (DEQUANT8[qp_rem] * w).astype(np.int32)


def _like(table, x):
    """An int32 numpy table as x's kind: a tensor on x's device for a
    tensor x, the array itself for a numpy x."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(table, dtype=torch.int32, device=x.device)
    return table


def dequant4x4(levels, qp, weight_scale=None):
    """AC 4x4 dequant: rshift_rnd_sf((lev * ILS) << qp_per, 4)
    (ldecod/src/macroblock.c:3179)."""
    per, rem = _per_rem(qp)
    ils = _like(inv_level_scale4(rem, weight_scale), levels)
    return rshift_rnd_sf((levels * ils) << per, 4)


def dequant8x8(levels, qp, weight_scale=None):
    """AC 8x8 dequant: rshift_rnd_sf((lev * ILS8) << qp_per, 6)
    (ldecod/src/macroblock.c:2699)."""
    per, rem = _per_rem(qp)
    ils = _like(inv_level_scale8(rem, weight_scale), levels)
    return rshift_rnd_sf((levels * ils) << per, 6)


def dequant_luma_dc(dc_hadamard, qp, weight_scale=None):
    """Luma 16x16 DC dequant applied AFTER the inverse 4x4 Hadamard:
    rshift_rnd((dc * ILS[0,0]) << qp_per, 6)  (ldecod/src/block.c itrans_2)."""
    per, rem = _per_rem(qp)
    ils00 = int(inv_level_scale4(rem, weight_scale)[0, 0])
    return rshift_rnd((dc_hadamard * ils00) << per, 6)


def dequant_chroma_dc(dc_hadamard, qp_c, weight_scale=None):
    """Chroma DC (4:2:0) dequant after the 2x2 Hadamard:
    (t * ILS[0,0]) >> (5 - per) if per < 5 else << (per - 5) — a
    truncating shift, not a rounding one (ldecod/src/macroblock.c:3844-3853)."""
    per, rem = _per_rem(qp_c)
    t = dc_hadamard * int(inv_level_scale4(rem, weight_scale)[0, 0])
    if per < 5:
        return t >> (5 - per)
    return t << (per - 5)


def _mf_weighted(mf, weight_scale):
    """Encoder MF under a custom scaling matrix: MF * 16 / w with
    truncating division, as JM (q_matrix.c CalculateQuantParam:
    LevelScale = (quant_coef << 4) / ScalingList); `mf` unchanged for flat
    scaling."""
    if weight_scale is None:
        return mf
    w = np.asarray(weight_scale, np.int64)
    return ((mf.astype(np.int64) << 4) // w).astype(np.int32)


def quant4x4(coefs, qp, offset, weight_scale=None):
    """level = sign(c) * ((|c| * MF + offset) >> qbits).

    `offset` is the rounding offset already scaled to qbits (JM
    LevelOffset4x4: base (intra ? 682 : 342) << (qbits - 11))."""
    per, rem = _per_rem(qp)
    mf = _like(_mf_weighted(QUANT4[rem], weight_scale), coefs)
    lev = (abs(coefs) * mf + offset) >> (Q_BITS_4 + per)
    return _copysign(lev, coefs)


def default_offset4(qp, intra: bool) -> int:
    """JM default rounding offset (q_offsets.c OffsetList defaults):
    intra 682/2048, inter 342/2048 of the quantization step, scaled to
    qbits = 15 + qp/6."""
    per, _ = _per_rem(qp)
    return (682 if intra else 342) << (Q_BITS_4 + per - 11)


def quant8x8(coefs, qp, offset, weight_scale=None):
    """8x8 level = sign(c) * ((|c| * MF8 + offset) >> (16 + qp/6))."""
    per, rem = _per_rem(qp)
    mf = _like(_mf_weighted(QUANT8[rem], weight_scale), coefs)
    lev = (abs(coefs) * mf + offset) >> (Q_BITS_8 + per)
    return _copysign(lev, coefs)


def default_offset8(qp, intra: bool) -> int:
    """The 8x8 rounding offset: default_offset4's base scaled to
    qbits = 16 + qp/6."""
    per, _ = _per_rem(qp)
    return (682 if intra else 342) << (Q_BITS_8 + per - 11)


def _quant_dc(dc_hadamard, qp, intra: bool, weight_scale=None):
    per, rem = _per_rem(qp)
    mf00 = int(_mf_weighted(QUANT4[rem], weight_scale)[0, 0])
    offset = default_offset4(qp, intra) * 2
    lev = (abs(dc_hadamard) * mf00 + offset) >> (Q_BITS_4 + per + 1)
    return _copysign(lev, dc_hadamard)


def quant_luma_dc(dc_hadamard, qp, intra: bool = True, weight_scale=None):
    """Quantize the 4x4 Hadamard of luma DC:
    (|c| * MF00 + 2*offset) >> (qbits+1)."""
    return _quant_dc(dc_hadamard, qp, intra, weight_scale)


def quant_chroma_dc(dc_hadamard, qp_c, intra: bool, weight_scale=None):
    """Quantize the 2x2 chroma DC Hadamard:
    (|c| * MF00 + 2*offset) >> (qbits+1)."""
    return _quant_dc(dc_hadamard, qp_c, intra, weight_scale)


def _copysign(mag, src):
    """mag with the sign of src."""
    if isinstance(src, torch.Tensor):
        return torch.where(src < 0, -mag, mag)
    return np.where(src < 0, -mag, mag)
