"""Built inputs of K3 ``coarse_search`` and ``sub8_search``, K5
``inter_luma_tq`` and ``inter_chroma_tq`` and K7 ``b_direct``, beside the
recorded ones of the P and B pictures.

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

``sub8_case(content, W, H, NR, RS, wp, seed)`` returns the inputs of
``sub8_search`` but ``lam_me``: (banks (NR, 4, H+64, W+64), cur_y (H, W),
u_ref, u_cy, u_cx, u_px, u_py (4 n_mb,), wp or None, RS), int32 CPU
tensors.  The units' references are random, their centres random within
+-CMAX (``sub8_cmax``: the P pipeline's clamp with the coarse stage's
widened bank) and the first four units' at the four corners (+-CMAX,
+-CMAX), so that their windows lie wholly in the clamped margin; the
PMVs reach +-4 (CMAX + RS) quarter-pels.  Contents (``SUB8_CONTENTS``):
``random``; ``flat`` (flat banks and source: every SSD of a partition
ties, so the rate decides, and at lam_me 0 the first cell wins);
``extreme`` (reference 0 all 0, the others 0/255 at random, the source
255 but for a 0/255 right half: SSDs up to 16 x 255^2 a quadrant).

``luma_case(content, NC, n_mb, seed)`` returns (pred (NC, n_mb, 16, 16),
orig (n_mb, 16, 16)), int32 CPU tensors:

- ``random``: predictions around the source, residuals up to +-40;
- ``extreme``: residuals of +-255 (a prediction of 0 or 255 against a
  source of the other), block by block;
- ``sparse``: residuals of a few levels in a few samples, MB by MB of an
  amplitude from 0 to 24, so that at QP 28 some 8x8 units drop, some MBs
  drop whole and some keep everything (``drop_kinds`` counts them).

``chroma_case(content, n_mb, seed, qp_c)`` returns (pred, orig) (n_mb,
2, 8, 8), int32 CPU tensors: ``random`` as above; ``extreme`` residuals of
0 and +-255, sample by sample; ``sparse`` the residual of 0-2 AC levels
of +-1 or +-2 a block at ``qp_c``, so that the planes' AC coefficient
costs land around JM's drop threshold of 4, below it in some planes and
at or above it in others (``chroma_ac_costs`` gives them).

``direct_case(W, H, NR, seed)`` returns the inputs of ``b_direct``:
random banks (NR, 4, H+64, W+64) and (1, 4, H+64, W+64), a colocated
snapshot (H/4, W/4) and the DistScaleFactor and anchor flags of list 0
(reference POCs ``DIRECT_POCS[:NR]`` around a B picture at POC 6 whose
list-1 anchor is POC 8), int32 / bool CPU tensors.  The snapshot holds
intra blocks, units whose list-0 reference is the anchor (unscaled),
indices NR and NR + 1 past the list (clamped to NR - 1 by the lookups),
and mvs up to +-90 pel, so that scaled mvs are negative and windows start
outside the padded banks (``direct_kinds`` counts each).

``i16_case(content, W, H, seed)`` returns a source plane (H, W) for K5
``i16_candidate``, an int32 CPU tensor (``I16_CONTENTS``): ``random``
samples; ``checker``, a 0/255 checkerboard of single samples (residuals
and Hadamard sums at their extremes); ``flat`` (every available mode
predicts the source exactly, so the costs tie and the first available
mode wins); ``gradient``, the ramp 20 + (3 x + 5 y) / 4 wrapped to
20..235, on which PLANE predicts the MBs whose neighbours lie on one
ramp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoder.mv import dist_scale_factor
from ..encoder import rd as RD
from ..encoder import rd_b as RB
from ..encoder import rd_p as RP
from ..ops import quant as Q
from ..ops import transforms as TR

COARSE_CONTENTS = ("random", "corners", "flat", "checker")
SUB8_CONTENTS = ("random", "flat", "extreme")
LUMA_CONTENTS = ("random", "extreme", "sparse")
I16_CONTENTS = ("random", "checker", "flat", "gradient")
# the list-0 reference POCs of direct_case (the anchor, POC 8, second) and
# the B picture's POC
DIRECT_POCS, DIRECT_CUR, DIRECT_ANCHOR = (4, 8, 0), 6, 8

# the corner MBs' centres in "corners" (top-left, top-right, bottom-left,
# bottom-right), full-pel (cen_x, cen_y)
CORNER_CENTRES = ((-48, -48), (48, -48), (-48, 48), (48, 48))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)


def corner_mbs(W: int, H: int):
    """(my, mx) of the four corner MBs, in CORNER_CENTRES' order."""
    n_my, n_mx = H // 16, W // 16
    return ((0, 0), (0, n_mx - 1), (n_my - 1, 0), (n_my - 1, n_mx - 1))


def i16_case(content: str, W: int, H: int, seed: int):
    y, x = np.mgrid[:H, :W]
    if content == "random":
        a = np.random.RandomState(seed).randint(0, 256, (H, W))
    elif content == "checker":
        a = ((x + y) & 1) * 255
    elif content == "flat":
        a = np.full((H, W), 128)
    elif content == "gradient":
        a = 20 + (3 * x + 5 * y) // 4 % 216
    else:
        raise KeyError(content)
    return _t(a)


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


def chroma_case(content: str, n_mb: int, seed: int, qp_c: int = 28):
    rs = np.random.RandomState(seed)
    shape = (n_mb, 2, 8, 8)
    if content == "extreme":
        orig = rs.randint(0, 2, shape) * 255
        pred = np.where(rs.rand(*shape) < 0.8, 255 - orig, orig)
    elif content == "sparse":
        # 0-2 AC levels of +-1 or +-2 a block, reconstructed at qp_c
        pred = rs.randint(0, 256, shape)
        lev = np.zeros((n_mb, 2, 2, 2, 16), np.int64)
        k = rs.randint(0, 3, lev.shape[:-1])
        for i in np.ndindex(k.shape):
            pos = rs.choice(np.arange(1, 16), k[i], replace=False)
            lev[i + (pos,)] = rs.choice([-2, -1, -1, 1, 1, 2], k[i])
        lev = torch.as_tensor(lev.reshape(n_mb, 2, 2, 2, 4, 4))
        rr = TR.inverse4x4(Q.dequant4x4(lev, qp_c))
        res = ((rr + 32) >> 6).transpose(-3, -2).reshape(shape).numpy()
        orig = (pred + res).clip(0, 255)
    else:
        orig = rs.randint(0, 256, shape)
        pred = (orig + rs.randint(-40, 41, shape)).clip(0, 255)
    return _t(pred), _t(orig)


def chroma_ac_costs(pred, orig, qp_c: int, lam: int):
    """Each plane's summed JM AC coefficient cost (from zig-zag position
    1) after quant and RDOQ-lite, (n_mb, 2): JM drops the plane's AC below
    4."""
    res = orig - pred
    blk = res.reshape(*res.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    lev = Q.quant4x4(TR.forward4x4(blk), qp_c, Q.default_offset4(qp_c, False))
    lev[..., 0, 0] = 0
    lev = RD._rdoq4(blk, lev, qp_c, lam)
    return RD._block4_coeff_cost(lev, first=1).sum((-1, -2))


def direct_case(W: int, H: int, NR: int, seed: int):
    rs = np.random.RandomState(seed)
    Hp, Wp = H + 64, W + 64
    H4, W4 = H // 4, W // 4
    banks0 = rs.randint(0, 256, (NR, 4, Hp, Wp))
    banks1 = rs.randint(0, 256, (1, 4, Hp, Wp))
    ci = rs.rand(H4, W4) < 0.2
    cr = rs.randint(0, NR + 2, (H4, W4))  # NR, NR + 1: past the list
    cmx, cmy = (rs.randint(-360, 361, (H4, W4)) for _ in range(2))
    pocs = DIRECT_POCS[:NR]
    dsf = [dist_scale_factor(DIRECT_CUR, p, DIRECT_ANCHOR)
           if p != DIRECT_ANCHOR else 0 for p in pocs]
    eq = np.asarray([p == DIRECT_ANCHOR for p in pocs])
    return (_t(banks0), _t(banks1), torch.as_tensor(ci), _t(cr), _t(cmx),
            _t(cmy), _t(dsf), torch.as_tensor(eq))


def direct_kinds(args) -> dict:
    """How many of ``direct_case``'s units take each branch: intra
    colocated, list-0 reference the anchor, index past the list, scaled
    mv negative, list-0 or list-1 window starting outside the bank."""
    b0, _, ci, *_ = args
    NR, _, Hp, Wp = b0.shape
    idx, l0x, l0y, l1x, l1y = RB.direct_mvs(*args[2:])
    n_mx = (Wp - 64) // 16
    _, _, y0, x0 = RB._units(idx.shape[0], n_mx, "cpu")
    mb, b8 = torch.arange(idx.shape[0])[:, None], torch.arange(4)[None]
    ry = 4 * (mb // n_mx) + 3 * (b8 >> 1)
    rx = 4 * (mb % n_mx) + 3 * (b8 & 1)
    intra = ci[ry, rx]
    eq = args[7][RB._slice_start(idx, NR, 1).long()] & ~intra

    def outside(y, x, my, mx):
        sy = y + (my >> 2) + RD.PAD
        sx = x + (mx >> 2) + RD.PAD
        return (sy < 0) | (sy > Hp - 10) | (sx < 0) | (sx > Wp - 10)

    return {"intra": int(intra.sum()), "anchor": int(eq.sum()),
            "past_list": int((idx >= NR).sum()),
            "negative": int(((l0x < 0) & ~eq & ~intra).sum()),
            "outside_l0": int(outside(y0, x0, l0y, l0x).sum()),
            "outside_l1": int(outside(y0, x0, l1y, l1x).sum())}


def sub8_cmax(RS: int) -> int:
    """The P pipeline's clamp of the sub-8x8 centres with the coarse
    stage (rd_p.p_sub8: the widened padding less RS + 5)."""
    return RP.PADW - RS - 5


def sub8_case(content: str, W: int, H: int, NR: int, RS: int, wp: bool,
              seed: int):
    rs = np.random.RandomState(seed)
    Hp, Wp = H + 64, W + 64
    n = 4 * (H // 16) * (W // 16)
    if content == "flat":
        banks = np.full((NR, 4, Hp, Wp), 100)
        cur = np.full((H, W), 90)
    elif content == "extreme":
        banks = rs.randint(0, 2, (NR, 4, Hp, Wp)) * 255
        banks[0] = 0
        cur = np.full((H, W), 255)
        cur[:, W // 2:] = rs.randint(0, 2, (H, W - W // 2)) * 255
    else:
        banks = rs.randint(0, 256, (NR, 4, Hp, Wp))
        cur = rs.randint(0, 256, (H, W))
    cmax = sub8_cmax(RS)
    cy, cx = (rs.randint(-cmax, cmax + 1, n) for _ in range(2))
    k = min(4, n)
    cy[:k] = np.asarray([-cmax, -cmax, cmax, cmax])[:k]
    cx[:k] = np.asarray([-cmax, cmax, -cmax, cmax])[:k]
    py, px = (rs.randint(-4 * (cmax + RS), 4 * (cmax + RS) + 1, n)
              for _ in range(2))
    wpt = None
    if wp:
        w, o = rs.randint(-128, 128, NR), rs.randint(-128, 128, NR)
        w[0], o[0] = (127, -128) if content == "extreme" else (40, -7)
        if NR > 1:
            w[1], o[1] = -128, 127
        wpt = (_t(w), _t(o))
    return (_t(banks), _t(cur), _t(rs.randint(0, NR, n)), _t(cy), _t(cx),
            _t(px), _t(py), wpt, RS)
