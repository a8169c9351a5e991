"""Built inputs of K3 ``coarse_search`` and K5 ``inter_luma_tq``, beside
the recorded ones of the P and B pictures.

``coarse_case(content, W, H, NR, wp, seed)`` returns (banks (NR, 4, H+64,
W+64), cur_y (H, W), wp or None), int32 CPU tensors:

- ``random``: random banks and source;
- ``corners``: random banks, and the source's four corner MBs flat at the
  (weighted) value of reference 0's corner sample, so that their cheapest
  cell is the extreme one, whose window lies wholly in the clamped corner
  of the widened bank (``CORNER_CENTRES``);
- ``flat``: flat banks and source, so that every SAD of a reference ties
  and the rate alone decides (at lam_me 0 the first cell wins);
- ``checker``: 0/255 checkerboard banks, the decimated cells at their
  extremes.

With ``wp`` the weights and offsets are the extremes -128 / 127 and random
ones.

``luma_case(content, NC, n_mb, seed)`` returns (pred (NC, n_mb, 16, 16),
orig (n_mb, 16, 16)), int32 CPU tensors:

- ``random``: predictions around the source, residuals up to +-40;
- ``extreme``: residuals of +-255 (a prediction of 0 or 255 against a
  source of the other), block by block;
- ``sparse``: residuals of a few levels in a few samples, MB by MB of an
  amplitude from 0 to 24, so that at QP 28 some 8x8 units drop, some MBs
  drop whole and some keep everything (``drop_kinds`` counts them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder import rd as RD
from ..ops import quant as Q
from ..ops import transforms as TR

COARSE_CONTENTS = ("random", "corners", "flat", "checker")
LUMA_CONTENTS = ("random", "extreme", "sparse")

# the corner MBs' centres in "corners" (top-left, top-right, bottom-left,
# bottom-right), full-pel (cen_x, cen_y)
CORNER_CENTRES = ((-48, -48), (48, -48), (-48, 48), (48, 48))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)


def corner_mbs(W: int, H: int):
    """(my, mx) of the four corner MBs, in CORNER_CENTRES' order."""
    n_my, n_mx = H // 16, W // 16
    return ((0, 0), (0, n_mx - 1), (n_my - 1, 0), (n_my - 1, n_mx - 1))


def coarse_case(content: str, W: int, H: int, NR: int, wp: bool,
                seed: int):
    rs = np.random.RandomState(seed)
    Hp, Wp = H + 64, W + 64
    if content == "flat":
        banks = np.full((NR, 4, Hp, Wp), 100)
        cur = np.full((H, W), 100)
    elif content == "checker":
        yy, xx = np.mgrid[:Hp, :Wp]
        banks = np.broadcast_to(((yy + xx) % 2) * 255, (NR, 4, Hp, Wp))
        cur = rs.randint(0, 2, (H, W)) * 255
    else:
        banks = rs.randint(0, 256, (NR, 4, Hp, Wp))
        cur = rs.randint(0, 256, (H, W))
    wpt = None
    if wp:
        w = rs.randint(-128, 128, NR)
        o = rs.randint(-128, 128, NR)
        w[0], o[0] = (127, 127) if content == "checker" else (40, -7)
        if NR > 1:
            w[1], o[1] = -128, -128
        wpt = (_t(w), _t(o))
    banks = _t(banks)
    if content == "corners":
        g = banks[0, 0]
        for my, mx in corner_mbs(W, H):
            v = g[0 if my == 0 else -1, 0 if mx == 0 else -1]
            if wpt is not None:
                v = RD._wp_affine(v, wpt[0][0], wpt[1][0])
            cur[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = int(v)
    return banks, _t(cur), wpt


def luma_case(content: str, NC: int, n_mb: int, seed: int):
    rs = np.random.RandomState(seed)
    if content == "extreme":
        orig = np.repeat(np.repeat(rs.randint(0, 2, (n_mb, 4, 4)) * 255, 4, 1),
                         4, 2)
        flip = np.repeat(np.repeat(rs.rand(NC, n_mb, 4, 4) < 0.8, 4, 2), 4, 3)
        pred = np.where(flip, 255 - orig[None], orig[None])
    elif content == "sparse":
        pred = rs.randint(0, 256, (NC, n_mb, 16, 16))
        amp = rs.randint(0, 25, (NC, n_mb, 1, 1))
        noise = rs.randint(-1, 2, (NC, n_mb, 16, 16)) * amp
        noise *= rs.rand(NC, n_mb, 16, 16) < 0.05
        orig = (pred[0] + noise[0]).clip(0, 255)
        pred = (orig[None] - noise).clip(0, 255)
    else:
        orig = rs.randint(0, 256, (n_mb, 16, 16))
        pred = (orig[None] + rs.randint(-40, 41, (NC, n_mb, 16, 16))).clip(
            0, 255)
    return _t(pred), _t(orig)


def drop_kinds(pred, orig, qp: int, lam: int) -> dict:
    """How JM's thresholding decides the candidates of (pred, orig) at
    `qp`: 8x8 units dropped alone, MBs dropped whole although a unit kept
    its coefficients, MBs with a kept unit."""
    res = orig - pred
    blk = res.reshape(*res.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    lev = Q.quant4x4(TR.forward4x4(blk), qp, Q.default_offset4(qp, False))
    lev = RD._rdoq4(blk, lev, qp, lam)
    c8 = RD._block4_coeff_cost(lev).reshape(*lev.shape[:-4], 2, 2, 2, 2).sum(
        (-3, -1))
    kept = torch.where(c8 <= 4, 0, c8).sum((-1, -2))
    any_kept = (c8 > 4).any(-1).any(-1)
    return {"units_dropped": int((c8 <= 4).sum()),
            "mbs_dropped_whole": int((any_kept & (kept <= 5)).sum()),
            "mbs_kept": int((kept > 5).sum())}
