"""Built inputs for the boundary-strength entry (K6 ``strengths``) that
reach every branch of its rule, in the glue's own layouts.

Two lists (a B picture's fields: per-MB intra, per-unit reference indices,
mvs and list flags, the MB's 4x4 levels): a real IPB stream never takes
some branches, as its list 1 is the anchor and never in list 0, so no edge
sees one picture in both lists of a block (the same-ref rule) or a crossed
pairing.  ``strengths_inputs`` puts the anchor's POC in list 0 and builds,
on a seed, unit rows whose units use both lists on the anchor (same-ref),
rows where list-1-only units sit left of list-0-only units on the anchor
(crossed), rows whose units keep their left neighbour's lists (straight),
random rows, intra MBs, coded blocks, and mvs within a few quarter-pels of
their neighbour's, so the >= 4 test goes both ways.  One list (a P
picture's fields: per-unit reference indices, per-block mvs, and with
``t8`` the 8x8 levels and transform flags): intra MBs, coded blocks,
reference changes and near mvs, and 8x8-transform MBs whose odd edges
must read 0.  ``branches`` counts the edges of each branch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder import strengths as ST

BRANCHES = ("intra_mb_edge", "intra_inside", "coefficients", "unmatched",
            "straight_mv_small", "straight_mv_large", "crossed_mv_small",
            "crossed_mv_large", "same_ref_mv_small", "same_ref_mv_large")
# one list: no crossed or same-ref pairing; 8x8-transform odd edges
BRANCHES_1 = ("intra_mb_edge", "intra_inside", "coefficients", "unmatched",
              "straight_mv_small", "straight_mv_large", "t8_odd")
POCS0 = np.asarray([0, 2, 4], np.int32)
POC1 = 4  # the anchor, list 0's index 2


def _unit_to_mb(a, n_my: int, n_mx: int):
    """(2 n_my, 2 n_mx) per-unit raster -> (n_mb, 4) [MB, unit]."""
    return np.ascontiguousarray(a.reshape(n_my, 2, n_mx, 2).transpose(
        0, 2, 1, 3).reshape(n_my * n_mx, 4))


def per_block(a, n_my: int, n_mx: int):
    """(4 n_my, 4 n_mx) per-block raster -> (n_mb, 4, 4) [MB, unit,
    block of the unit], the layout of P's per-block mvs."""
    return np.ascontiguousarray(a.reshape(n_my, 2, 2, n_mx, 2, 2).transpose(
        0, 3, 1, 4, 2, 5).reshape(n_my * n_mx, 4, 4))


def levels_of(nz4, n_my: int, n_mx: int):
    """(4 n_my, 4 n_mx) coefficient flags -> the MBs' 4x4 levels (n_mb, 4,
    4, 4, 4) [MB, block row, block column] int32: one level 1 in each
    flagged block, else 0."""
    lev = np.zeros((n_my, 4, n_mx, 4, 4, 4), np.int32)
    lev[..., 0, 0] = np.asarray(nz4, bool).reshape(n_my, 4, n_mx, 4)
    return np.ascontiguousarray(lev.transpose(0, 2, 1, 3, 4, 5).reshape(
        n_my * n_mx, 4, 4, 4, 4))


def strengths_inputs(n_my: int, n_mx: int, seed: int, device,
                     lists: int = 2, t8: bool = False):
    """The positional arguments of ``strengths`` for an n_my x n_mx-MB
    picture on `device`: (n_my, n_mx, coef, intra, ref0, mv0x, mv0y,
    coef8, t8, pocs0, use0, mv1x, mv1y, use1, poc1), built on a seed to
    take every branch (module docstring); two lists in a B picture's
    layout, one in a P picture's (with the 8x8 transform's fields when
    `t8`)."""
    rs = np.random.RandomState(seed)
    n_mb = n_my * n_mx
    U = (2 * n_my, 2 * n_mx)
    intra = rs.rand(n_mb) < 0.08
    lev = np.where(rs.rand(n_mb, 4, 4, 4, 4) < 0.01,
                   rs.randint(-3, 4, (n_mb, 4, 4, 4, 4)), 0).astype(np.int32)

    def near(a):
        return a + rs.randint(-5, 6, a.shape).astype(np.int32)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    if lists == 1:
        ref = rs.randint(0, 2, U).astype(np.int32)
        mvx, mvy = (rs.randint(-40, 41, (4 * n_my, 4 * n_mx)).astype(np.int32)
                    for _ in range(2))
        # odd block columns and rows: near their left / upper neighbour's
        for m in (mvx, mvy):
            m[:, 1::2] = near(m[:, 0::2])
            m[1::2, :] = near(m[0::2, :])
        ref[1::2, 1::2] = ref[1::2, 0::2]

        coef8 = t8f = None
        if t8:
            t8m = (rs.rand(n_mb) < 0.3) & ~intra
            lev[t8m] = 0
            lev8 = np.where(rs.rand(n_mb, 2, 2, 8, 8) < 0.004,
                            rs.randint(-3, 4, (n_mb, 2, 2, 8, 8)), 0)
            lev8[~t8m] = 0
            coef8, t8f = t(lev8), t(t8m.astype(np.int32))
        return (n_my, n_mx, t(lev), t(intra, torch.bool),
                t(_unit_to_mb(ref, n_my, n_mx)),
                t(per_block(mvx, n_my, n_mx)), t(per_block(mvy, n_my, n_mx)),
                coef8, t8f, None, None, None, None, None, 0)
    use = rs.randint(0, 3, U)  # 0: list 0, 1: list 1, 2: both
    idx = rs.randint(0, 3, U)
    m0x, m0y, m1x, m1y = (rs.randint(-40, 41, U).astype(np.int32)
                          for _ in range(4))
    # unit rows 0, 4, ...: list-1-only units left of list-0-only units on
    # the anchor (crossed)
    q, p = (slice(0, None, 4), slice(1, None, 2)), (slice(0, None, 4),
                                                    slice(0, None, 2))
    use[p], use[q], idx[q] = 1, 0, 2
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m1x[p]), near(m1y[p]),
                                      near(m0x[p]), near(m0y[p]))
    # rows 1, 5, ...: both lists on the anchor, beside a unit that does too
    q, p = (slice(1, None, 4), slice(1, None, 2)), (slice(1, None, 4),
                                                    slice(0, None, 2))
    use[p], use[q], idx[p], idx[q] = 2, 2, 2, 2
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m0x[p]), near(m0y[p]),
                                      near(m1x[p]), near(m1y[p]))
    # rows 2, 6, ...: odd units keep their left neighbour's lists
    q, p = (slice(2, None, 4), slice(1, None, 2)), (slice(2, None, 4),
                                                    slice(0, None, 2))
    use[q], idx[q] = use[p], idx[p]
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m0x[p]), near(m0y[p]),
                                      near(m1x[p]), near(m1y[p]))
    u0 = _unit_to_mb(use != 1, n_my, n_mx) & ~intra[:, None]
    u1 = _unit_to_mb(use != 0, n_my, n_mx) & ~intra[:, None]
    mb = [t(_unit_to_mb(a, n_my, n_mx)) for a in (idx, m0x, m0y, m1x, m1y)]
    return (n_my, n_mx, t(lev), t(intra, torch.bool), mb[0], mb[1], mb[2],
            None, None, t(POCS0), t(u0, torch.bool), mb[3], mb[4],
            t(u1, torch.bool), POC1)


def branches(args) -> dict:
    """The number of block edges inside the picture that take each branch
    of the rule, both directions, for the arguments `args` of
    ``strengths`` (``BRANCHES`` with two lists, ``BRANCHES_1`` with one)."""
    (n_my, n_mx, coef, intra, ref0, mv0x, mv0y, coef8, t8, pocs0, use0,
     mv1x, mv1y, use1, poc1) = (a.cpu() if isinstance(a, torch.Tensor)
                                else a for a in args)
    two = mv1x is not None
    H4, W4 = 4 * n_my, 4 * n_mx

    def R(x):
        return ST.raster(x, n_my, n_mx, "field")[..., 0]

    nz4 = ST.coded(coef, coef8, n_my, n_mx)
    intra4 = R(intra) if intra is not None else torch.zeros(
        (H4, W4), dtype=torch.bool)
    rid0 = R(ref0)
    m = [R(mv0x), R(mv0y)]
    if two:
        rid0 = torch.where(R(use0), pocs0[rid0.clamp(0, len(pocs0) - 1)
                                          .long()], ST.NONE)
        rid1 = torch.where(R(use1), int(poc1), ST.NONE)
        m += [R(mv1x), R(mv1y)]
    else:
        rid1 = torch.full((H4, W4), ST.NONE)
        m += [torch.zeros_like(m[0])] * 2
    t8r = R(t8) > 0 if t8 is not None else torch.zeros((H4, W4), dtype=bool)
    m0x, m0y, m1x, m1y = m
    count = dict.fromkeys(BRANCHES if two else BRANCHES_1, 0)
    for q, p, edge, odd in (
            ((slice(None), slice(1, None)), (slice(None), slice(0, W4 - 1)),
             (torch.arange(1, W4) % 4 == 0)[None, :].expand(H4, W4 - 1),
             (torch.arange(1, W4) % 2 == 1)[None, :].expand(H4, W4 - 1)),
            ((slice(1, None), slice(None)), (slice(0, H4 - 1), slice(None)),
             (torch.arange(1, H4) % 4 == 0)[:, None].expand(H4 - 1, W4),
             (torch.arange(1, H4) % 2 == 1)[:, None].expand(H4 - 1, W4))):
        zero = t8r[q] & odd
        ei = ~zero & (intra4[q] | intra4[p])
        coef_ = ~zero & ~ei & (nz4[q] | nz4[p])
        rest = ~zero & ~ei & ~coef_
        rq0, rq1, rp0, rp1 = rid0[q], rid1[q], rid0[p], rid1[p]
        matched = (((rq0 == rp0) & (rq1 == rp1))
                   | ((rq0 == rp1) & (rq1 == rp0)))

        def diff(ax, ay, bx, by):
            return ((ax[q] - bx[p]).abs() >= 4) | ((ay[q] - by[p]).abs() >= 4)

        d00 = diff(m0x, m0y, m0x, m0y) | diff(m1x, m1y, m1x, m1y)
        d01 = diff(m0x, m0y, m1x, m1y) | diff(m1x, m1y, m0x, m0y)
        same = rq0 == rq1
        kinds = {"straight": ~same & (rq0 == rp0), "crossed":
                 ~same & (rq0 != rp0), "same_ref": same}
        large = {"straight": d00, "crossed": d01, "same_ref": d00 & d01}
        count["intra_mb_edge"] += int((ei & edge).sum())
        count["intra_inside"] += int((ei & ~edge).sum())
        count["coefficients"] += int(coef_.sum())
        count["unmatched"] += int((rest & ~matched).sum())
        for k, sel in kinds.items():
            mk = rest & matched & sel
            if f"{k}_mv_small" in count:
                count[f"{k}_mv_small"] += int((mk & ~large[k]).sum())
                count[f"{k}_mv_large"] += int((mk & large[k]).sum())
        if not two:
            count["t8_odd"] += int(zero.sum())
    return count
