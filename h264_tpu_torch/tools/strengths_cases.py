"""Built inputs for the B picture's boundary-strength entry (``strengths_b``)
that reach every branch of its two-list pairing rule.

A real IPB stream never takes some of them: its list 1 is the anchor and
never in list 0, so no edge sees the same picture in both lists of a block
(the same-ref rule) or a crossed pairing.  ``strengths_b_inputs`` builds
per-4x4 fields on a seed: POCs drawn from three pictures, blocks whose
lists swap their left neighbour's (crossed), blocks that use one picture
twice beside a neighbour that does too (same-ref), intra MBs, coded
blocks, and mvs within a few quarter-pels of their neighbour's, so the
>= 4 test goes both ways.  ``strengths_b_branches`` counts the edges of
each branch.
"""

from __future__ import annotations

import numpy as np
import torch

_NONE = -(10 ** 9)
BRANCHES = ("intra_mb_edge", "intra_inside", "coefficients", "unmatched",
            "straight_mv_small", "straight_mv_large", "crossed_mv_small",
            "crossed_mv_large", "same_ref_mv_small", "same_ref_mv_large")


def strengths_b_inputs(H4: int, W4: int, seed: int, device):
    """(nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x, m1y) of a (H4, W4)
    field of 4x4 blocks (H4, W4 multiples of 4), on `device`: bool flags
    and int32 POCs and quarter-pel mvs, as ``strengths_b`` takes them."""
    rs = np.random.RandomState(seed)
    shape = (H4, W4)
    pocs = np.asarray([0, 2, 4], np.int32)
    use = rs.randint(0, 3, shape)  # 0: list 0, 1: list 1, 2: both
    v0, v1 = use != 1, use != 0
    r0 = pocs[rs.randint(0, 3, shape)]
    r1 = pocs[rs.randint(0, 3, shape)]
    m0x, m0y, m1x, m1y = (rs.randint(-40, 41, shape).astype(np.int32)
                          for _ in range(4))

    def near(a):
        return a + rs.randint(-5, 6, a.shape).astype(np.int32)

    # rows 0, 4, ...: odd columns swap their left neighbour's lists
    q, p = (slice(0, None, 4), slice(1, None, 2)), (slice(0, None, 4),
                                                    slice(0, None, 2))
    v0[p] = v1[p] = v0[q] = v1[q] = True
    r0[q], r1[q] = r1[p], r0[p]
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m1x[p]), near(m1y[p]),
                                      near(m0x[p]), near(m0y[p]))
    # rows 1, 5, ...: pairs of columns that use one picture in both lists
    q, p = (slice(1, None, 4), slice(1, None, 2)), (slice(1, None, 4),
                                                    slice(0, None, 2))
    v0[p] = v1[p] = v0[q] = v1[q] = True
    r1[p] = r0[p]
    r0[q] = r1[q] = r0[p]
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m0x[p]), near(m0y[p]),
                                      near(m1x[p]), near(m1y[p]))
    # rows 2, 6, ...: odd columns keep their left neighbour's lists
    q, p = (slice(2, None, 4), slice(1, None, 2)), (slice(2, None, 4),
                                                    slice(0, None, 2))
    v0[q], v1[q], r0[q], r1[q] = v0[p], v1[p], r0[p], r1[p]
    m0x[q], m0y[q], m1x[q], m1y[q] = (near(m0x[p]), near(m0y[p]),
                                      near(m1x[p]), near(m1y[p]))
    intra_mb = rs.rand(H4 // 4, W4 // 4) < 0.08
    intra4 = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    nz4 = rs.rand(*shape) < 0.1
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x, m1y))


def strengths_b_branches(args) -> dict:
    """The number of block edges inside the picture that take each branch
    of the pairing rule (``BRANCHES``), both directions, for the inputs
    `args` of ``strengths_b``."""
    nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x, m1y = (a.cpu() for a in args)
    rid0 = torch.where(v0, r0, _NONE)
    rid1 = torch.where(v1, r1, _NONE)
    count = dict.fromkeys(BRANCHES, 0)
    H4, W4 = nz4.shape
    for q, p, edge in (
            ((slice(None), slice(1, None)), (slice(None), slice(0, W4 - 1)),
             (torch.arange(1, W4) % 4 == 0)[None, :].expand(H4, W4 - 1)),
            ((slice(1, None), slice(None)), (slice(0, H4 - 1), slice(None)),
             (torch.arange(1, H4) % 4 == 0)[:, None].expand(H4 - 1, W4))):
        ei = intra4[q] | intra4[p]
        coef = ~ei & (nz4[q] | nz4[p])
        rest = ~ei & ~coef
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
        count["coefficients"] += int(coef.sum())
        count["unmatched"] += int((rest & ~matched).sum())
        for k, sel in kinds.items():
            m = rest & matched & sel
            count[f"{k}_mv_small"] += int((m & ~large[k]).sum())
            count[f"{k}_mv_large"] += int((m & large[k]).sum())
    return count
