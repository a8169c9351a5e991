"""Built inputs of the decoder's inter reconstruction (K8,
``decode_inter``), from a seed, for the cases real streams rarely reach.

``built_cases(H, W, seed)`` gives the 25 argument arrays of
``_decode_inter`` / ``decode_inter_plain`` (numpy int32, in their order)
for:
  - far mvs whose windows reach the start clip on all four sides
    (luma and chroma), mixed with near ones, every fraction;
  - ref_idx from -1 (list unused) up to 9 (clipped to MAXREF - 1 = 7);
  - three slices: no WP, explicit WP and implicit WP, with log2 weight
    denominators of 0 and >= 1, and uni- and bi-predicted blocks;
  - 8x8-transform MBs beside 4x4 ones, QP 0 and 51 among random QPs,
    scaling-list inverse level scales, MBs that are not inter;
  - levels large enough that the dequant product wraps as int32.
Banks are random samples: K8 and its plain version only read them.
"""

from __future__ import annotations

import numpy as np

from ..encoder.rd import PAD
from ..kernels.decode_inter import MAXREF
from ..ops import quant as Q

NS = 3  # slices: no WP, explicit WP, implicit WP
NB = 4  # reference banks


def clip_sides(mv, H: int, W: int) -> dict:
    """How many 4x4 blocks' luma / chroma windows the decoder's rule
    clips on each side, for mv (2, H4, W4, 2) of list 0 and list 1."""
    H4, W4 = H // 4, W // 4
    y0 = (np.arange(H4) * 4)[:, None]
    x0 = (np.arange(W4) * 4)[None, :]
    out = {}
    for tag, sh, lo, hy, hx, yy, xx in (
            ("luma", 2, -(PAD - 8), H + PAD - 12, W + PAD - 12, y0, x0),
            ("chroma", 3, -(PAD - 4), H // 2 + PAD - 8, W // 2 + PAD - 8,
             y0 >> 1, x0 >> 1)):
        sy = yy + (mv[..., 1] >> sh)
        sx = xx + (mv[..., 0] >> sh)
        out[tag] = {"top": int((sy < lo).sum()), "bottom": int((sy > hy).sum()),
                    "left": int((sx < lo).sum()), "right": int((sx > hx).sum())}
    return out


def built_case(H: int, W: int, seed: int, ly: int, lc: int,
               t8_share=0.5, wrap: bool = False):
    """One set of the 25 argument arrays (numpy int32) at H x W; the
    explicit-WP slice has log2 denominators ly (luma) and lc (chroma)."""
    rs = np.random.RandomState(seed)
    H4, W4 = H // 4, W // 4
    n_my, n_mx = H // 16, W // 16
    nb = n_my * n_mx
    r = lambda lo, hi, *s: rs.randint(lo, hi + 1, s).astype(np.int32)  # noqa

    banks = r(0, 255, NB, 4, H + 2 * PAD, W + 2 * PAD)
    cpads = r(0, 255, NB, 2, H // 2 + 2 * PAD, W // 2 + 2 * PAD)
    refmap = r(0, NB - 1, NS, 2, MAXREF)
    # a third of the blocks far out in each direction, the rest near
    mv = r(-64, 64, 2, H4, W4, 2)
    far = rs.rand(2, H4, W4, 2) < 0.35
    reach = 4 * (max(H, W) + 3 * PAD)
    mv[far] = r(-reach, reach, int(far.sum()))
    ref_idx = r(-1, 7, 2, H4, W4)
    ref_idx[rs.rand(2, H4, W4) < 0.03] = 8 + rs.randint(0, 2)  # clipped to 7
    sid_mb = r(0, NS - 1, n_my, n_mx)
    sid_mb.reshape(-1)[:: 11] = -1  # not coded: the clip takes slice 0
    sid4 = np.repeat(np.repeat(sid_mb, 4, 0), 4, 1).astype(np.int32)

    wp_mode = np.asarray([0, 1, 2], np.int32)
    wp_ly = np.asarray([0, ly, 5], np.int32)
    wp_lc = np.asarray([0, lc, 5], np.int32)
    wy = r(-128, 127, NS, 2, MAXREF)
    oy = r(-128, 127, NS, 2, MAXREF)
    wc = r(-128, 127, NS, 2, MAXREF, 2)
    oc = r(-128, 127, NS, 2, MAXREF, 2)
    wimp = r(-64, 128, NS, MAXREF, MAXREF, 2)

    qp = r(0, 51, nb)
    qp[:: 7] = 0
    qp[3:: 7] = 51
    qpc = r(0, 51, nb, 2)
    t8 = (rs.rand(nb) < t8_share).astype(np.int32)
    sparse = lambda lim, *s: (r(-lim, lim, *s)  # noqa: E731
                              * (rs.rand(*s) < 0.3)).astype(np.int32)
    lev4 = sparse(20, nb, 16, 4, 4)
    lev8 = sparse(20, nb, 4, 8, 8)
    levc = sparse(20, nb, 2, 4, 4, 4)
    dcc = sparse(60, nb, 2, 2, 2)
    if wrap:  # the dequant product and its shift leave int32 here
        lev4[:: 5, 0, 0, 0] = 1 << 22
        lev8[1:: 5, 0, 1, 1] = -(1 << 22)
        levc[2:: 5, 0, 1, 2, 3] = 1 << 23
    inter = (rs.rand(nb) < 0.85).astype(np.int32)

    ws4 = r(4, 64, 6, 4, 4)  # scaling lists (weightScale), then DEQUANT * ws
    ws8 = r(4, 64, 2, 8, 8)
    ils4y = (Q.DEQUANT4 * ws4[3]).astype(np.int32)
    ils8y = (Q.DEQUANT8 * ws8[1]).astype(np.int32)
    ils4c = np.stack([(Q.DEQUANT4 * ws4[4]).astype(np.int32),
                      (Q.DEQUANT4 * ws4[5]).astype(np.int32)])
    return tuple(np.ascontiguousarray(a, np.int32) for a in (
        banks, cpads, refmap, mv, ref_idx, sid4, wp_mode, wp_ly, wp_lc, wy,
        oy, wc, oc, wimp, qp, qpc, t8, lev4, lev8, levc, dcc, inter, ils4y,
        ils8y, ils4c))


def built_cases(H: int, W: int, seed: int):
    """[(name, args)] of the built K8 inputs at H x W (all NS = 3, NB = 4,
    so they share one shape)."""
    return [("far-wp-t8", built_case(H, W, seed, ly=0, lc=3)),
            ("far-wp-4x4", built_case(H, W, seed + 1, ly=5, lc=0,
                                      t8_share=0.0)),
            ("wrap", built_case(H, W, seed + 2, ly=7, lc=1, wrap=True))]
