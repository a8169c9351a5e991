"""Device RD coding of P pictures: the port of the reference package's
``rd_p_pipeline`` (encoder/rd.py:329-1180) on PyTorch tensors.

Per picture, on the device: the coarse-to-fine motion search (with
``use_cme``, a +-48-pel SAD search on 4x-decimated planes picks each (ref,
MB) centre; without it every centre is zero; then dense per-8x8 SSD grids
+-R around it), partition argmins priced against a
two-pass PMV field, the 49-point quarter-pel SATD refinement of every
partition and sub-8x8 unit, the P_Skip field and prediction, residual
coding of six candidate predictions with RDOQ-lite and JM coefficient
thresholding, the I16 candidate, the winner gather, inter chroma, the
FRExt transform-size decision (High profile), the wavefront intra commit,
boundary strengths and the in-loop filter, and the next reference entry.
The host tail reads the flat ``host_out`` buffer, whose layout is the
reference's.

The per-pixel and per-candidate work goes through the hand-written CUDA
kernels, one entry each (``PKernels``); everything else here is glue on
small tensors: sums of grids, medians, argmins, gathers and ``where``s.
The plain PyTorch version of every kernel entry is the ``*_plain``
function of the same name below: the CPU runs it, and the card compares
the kernels with it.

The pipeline runs the reference's coarse stage when asked (``use_cme``:
its encoder asks for it on one-slice P pictures; its tile-row slices,
``rd_rows.py``, run without it), the FRExt 8x8-transform decision when
asked (``use_t8``), and neither forced intra refresh nor loss-aware RDO
(ROADMAP Queue 1).  The reference's trace-time
experiment switches (``H264_NO_SUB8`` ...) are not carried: at their
defaults they are the identity.  Its ``stage=`` early returns are not
carried either; the stages are the ``p_*`` functions, each filling in a
``PFrame``.

Bank coordinates: with ``use_cme`` the reference widens every bank by
E = 64 samples of edge replication before it searches; here every read
clamps its coordinates to the unwidened (NR, 4, Hp, Wp) bank instead,
which is the same sample, and no widened copy is made.  Without
``use_cme`` the reference reads the unwidened bank through windows whose
starts it clamps; none of them starts outside the bank at R <= 28, so the
per-sample clamps here read the same samples there too.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops import quant as Q
from ..ops import transforms as TR
from ..ops.deblock import ALPHA_TABLE, BETA_TABLE, CLIP_TAB
from . import rd as RD
from .rd import (_QTAB, _REFINE, I32, PAD, _bitlen, _chroma_tq,
                 _coef_bits, _i16_pred_all, _i16_tq, _lam_cost,
                 _mc_chroma_unit, _med3, _mv_bits, _rdoq4, _satd,
                 _threshold_inter_luma, _wp_affine, lam_satd_of)
from .strengths import strengths_plain

# candidate mode indices (winner codes in host_out)
C_P16x16, C_P16x8, C_P8x16, C_P8x8, C_SKIP, C_P16PMV = 0, 1, 2, 3, 4, 5
C_I16 = 6
C_I4 = 7

E = 64  # the reference's bank widening for the coarse search
PADW = PAD + E  # widened padding
RC = 12  # coarse range in 4-pel units: +-48 full-pel
DCO = 2 * RC + 1

_B8OY = (0, 0, 8, 8)
_B8OX = (0, 8, 0, 8)


def _wp(x, wp, ref):
    """Weighted prediction of samples x whose reference index is `ref`
    (broadcastable to x); identity when wp is None."""
    if wp is None:
        return x
    w, o = wp
    return _wp_affine(x, w[ref.long()], o[ref.long()])


def _clampi(x, hi: int):
    return x.clamp(0, hi).long()


# ---------------------------------------------------------------------------
# plain versions of the kernel entries
# ---------------------------------------------------------------------------

def coarse_search_plain(banks, cur_y, wp, lam_me: int):
    """Stage 0 (rd.py:361-418): per (ref, MB) the +-48-pel SAD search on
    4x-decimated planes of the (weighted) widened G plane, priced with
    lambda_me * mv bits; first index on ties.  Returns the full-pel
    centres (cen_x, cen_y), each (NR, n_my, n_mx) int32."""
    NR, _, Hp, Wp = banks.shape
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    dev = banks.device
    iy = _clampi(torch.arange(Hp + 2 * E, device=dev) - E, Hp - 1)
    ix = _clampi(torch.arange(Wp + 2 * E, device=dev) - E, Wp - 1)
    G = banks[:, 0].index_select(1, iy).index_select(2, ix)
    if wp is not None:
        G = _wp_affine(G, wp[0][:, None, None], wp[1][:, None, None])
    Hl, Wl = G.shape[1] // 4, G.shape[2] // 4
    ref_l = G.reshape(NR, Hl, 4, Wl, 4).sum((2, 4), dtype=I32)
    cur_l = cur_y.reshape(H // 4, 4, W // 4, 4).sum((1, 3), dtype=I32)
    curmb = cur_l.reshape(n_my, 4, n_mx, 4).permute(0, 2, 1, 3)
    a = torch.arange(DCO + 3, device=dev)
    rows = (4 * torch.arange(n_my, device=dev) - RC + PADW // 4)[:, None] + a
    cols = (4 * torch.arange(n_mx, device=dev) - RC + PADW // 4)[:, None] + a
    win = ref_l[:, rows[:, None, :, None], cols[None, :, None, :]]
    acc = torch.zeros((NR, n_my, n_mx, DCO, DCO), dtype=I32, device=dev)
    for i in range(4):
        for j in range(4):
            acc += (win[..., i:i + DCO, j:j + DCO]
                    - curmb[..., i, j][..., None, None]).abs()
    coff = torch.arange(-RC, RC + 1, dtype=I32, device=dev) * 16
    cbits = _mv_bits(coff)[None, :] + _mv_bits(coff)[:, None]
    k = (acc + _lam_cost(lam_me, cbits)).reshape(NR, n_my, n_mx, -1).argmin(-1)
    k = k.to(I32)
    return ((k % DCO) - RC) * 4, ((k // DCO) - RC) * 4


def _b8_geometry(H: int, W: int, dev):
    nby, nbx = H // 8, W // 8
    b = torch.arange(nby * nbx, device=dev)
    return (b // nbx) * 8, (b % nbx) * 8, (b // nbx) // 2 * (W // 16) + (
        b % nbx) // 2


def ssd_grid8_plain(banks, cur_y, cen_x, cen_y, wp, R: int):
    """Stage 1 (rd.py:420-459): per (ref, 8x8 block) the dense SSD grid
    of the (weighted) G plane around its MB's centre, (NR, n_b8, D, D)
    int32 with D = 2R + 1; cell (i, j) is mv = cen + (j, i) - R.  SSD as
    sum (cur - ref)^2, which equals the reference's box-sum form exactly
    (every term stays below 2^31)."""
    NR, _, Hp, Wp = banks.shape
    H, W = cur_y.shape
    dev = banks.device
    D, Wn = 2 * R + 1, 2 * R + 8
    by, bx, mb = _b8_geometry(H, W, dev)
    cy = cen_y.reshape(NR, -1)[:, mb]
    cx = cen_x.reshape(NR, -1)[:, mb]
    a = torch.arange(Wn, device=dev)
    rows = _clampi((by + cy - R + PAD)[..., None] + a, Hp - 1)
    cols = _clampi((bx + cx - R + PAD)[..., None] + a, Wp - 1)
    r = torch.arange(NR, device=dev)[:, None, None, None]
    win = banks[r, 0, rows[..., :, None], cols[..., None, :]]
    win = _wp(win, wp, r)
    a8 = torch.arange(8, device=dev)
    cur8 = cur_y[(by[:, None] + a8)[:, :, None], (bx[:, None] + a8)[:, None, :]]
    acc = torch.zeros((NR, by.shape[0], D, D), dtype=I32, device=dev)
    for i in range(8):
        for j in range(8):
            d = win[:, :, i:i + D, j:j + D] - cur8[:, i, j][None, :, None, None]
            acc += d * d
    return acc


def ssd_grid4_plain(banks, cur_y, u_ref, u_cy, u_cx, wp, RS: int):
    """Sub-8x8 grids (rd.py:640-665): per 8x8 unit u (MB-major, u = 4 mb
    + b8) and quadrant q, the (DS, DS) SSD grid of the 4x4 block against
    the unit's reference around the unit's centre.  (nsb, 4, DS, DS)."""
    NR, _, Hp, Wp = banks.shape
    H, W = cur_y.shape
    n_mx = W // 16
    dev = banks.device
    DS, Wn = 2 * RS + 1, 2 * RS + 4
    u = torch.arange(u_ref.shape[0], device=dev)
    mb, b8 = u // 4, u % 4
    q = torch.arange(4, device=dev)
    y0 = (16 * (mb // n_mx) + 8 * (b8 >> 1))[:, None] + 4 * (q >> 1)
    x0 = (16 * (mb % n_mx) + 8 * (b8 & 1))[:, None] + 4 * (q & 1)
    a = torch.arange(Wn, device=dev)
    rows = _clampi((y0 + u_cy[:, None] - RS + PAD)[..., None] + a, Hp - 1)
    cols = _clampi((x0 + u_cx[:, None] - RS + PAD)[..., None] + a, Wp - 1)
    r = u_ref.long()[:, None, None, None]
    win = _wp(banks[r, 0, rows[..., :, None], cols[..., None, :]], wp, r)
    a4 = torch.arange(4, device=dev)
    cb = cur_y[(y0[..., None] + a4)[..., :, None], (x0[..., None] + a4)[..., None, :]]
    acc = torch.zeros((u.shape[0], 4, DS, DS), dtype=I32, device=dev)
    for i in range(4):
        for j in range(4):
            d = win[..., i:i + DS, j:j + DS] - cb[..., i, j][..., None, None]
            acc += d * d
    return acc


# the sub-8x8 partitions in refine_sub's order, each as the quadrants it
# sums: 8x4 top and bottom, 4x8 left and right, then the four 4x4
SUB8_PARTS = ((0, 1), (2, 3), (0, 2), (1, 3), (0,), (1,), (2,), (3,))


def sub8_search_plain(banks, cur_y, u_ref, u_cy, u_cx, u_px, u_py, wp,
                      RS: int, lam_me: int):
    """The sub-8x8 integer search (rd.py:640-677): per 8x8 unit u the
    quadrant grids of ``ssd_grid4_plain``, summed into the eight partition
    grids of ``SUB8_PARTS``, each cell priced with lambda_me times the mv
    rate of cell (i, j) against the unit's PMV (one ``_lam_cost`` of the
    summed bits), and the first minimum over the raster index i * DS + j.
    Returns (2, 8, nsb) int32: the winners' full-pel mvx, then mvy."""
    s44 = ssd_grid4_plain(banks, cur_y, u_ref, u_cy, u_cx, wp, RS)
    nsb, DS = s44.shape[0], 2 * RS + 1
    dgrid = torch.arange(-RS, RS + 1, dtype=I32, device=banks.device) * 4
    u_bx = _mv_bits(u_cx[:, None] * 4 + dgrid - u_px[:, None])
    u_by = _mv_bits(u_cy[:, None] * 4 + dgrid - u_py[:, None])
    rate = _lam_cost(lam_me, u_by[:, :, None] + u_bx[:, None, :])
    parts = torch.stack([s44[:, list(p)].sum(1, dtype=I32)
                         for p in SUB8_PARTS])
    k = (parts + rate).reshape(8, nsb, -1).argmin(-1).to(I32)
    return torch.stack([k % DS - RS + u_cx, k // DS - RS + u_cy])


def _qpel(banks, ref, mvx, mvy, y0, x0, h: int, w: int):
    """Quarter-pel luma samples: ref/y0/x0 (n,), mvx/mvy (n, K) ->
    (n, K, h, w), the rounded mean of the two bank samples `_QTAB` picks
    (rd.py:145), coordinates clamped to the bank."""
    _, _, Hp, Wp = banks.shape
    dev = banks.device
    t = torch.as_tensor(_QTAB, device=dev)[((mvy & 3) * 4 + (mvx & 3)).long()]
    iy = y0[:, None] + (mvy >> 2) + PAD
    ix = x0[:, None] + (mvx >> 2) + PAD
    ay = torch.arange(h, device=dev)
    ax = torch.arange(w, device=dev)
    r = ref.long()[:, None, None, None]

    def tap(p, oy, ox):
        ya = _clampi((iy + t[..., oy])[..., None] + ay, Hp - 1)
        xa = _clampi((ix + t[..., ox])[..., None] + ax, Wp - 1)
        return banks[r, t[..., p].long()[..., None, None], ya[..., :, None],
                     xa[..., None, :]]

    return (tap(0, 1, 2) + tap(3, 4, 5) + 1) >> 1


def qpel_refine_plain(banks, cur_y, ref, imvx, imvy, y0, x0, px, py, wp,
                      lam_satd: int, h: int, w: int):
    """Stage 4 (rd.py:551-589): the 49-point quarter-pel refinement of n
    (h, w) units around their integer mvs, SATD + lambda_satd * mv bits
    against the unit's PMV (px, py), the first minimum in `_REFINE` order.
    Returns (mvx, mvy) (n,) quarter-pel, pred (n, h, w), cost (n,)."""
    dev = banks.device
    offs = torch.as_tensor(_REFINE, device=dev)
    mvx = 4 * imvx[:, None] + offs[:, 0]
    mvy = 4 * imvy[:, None] + offs[:, 1]
    pred = _wp(_qpel(banks, ref, mvx, mvy, y0, x0, h, w), wp,
               ref[:, None, None, None])
    ay = torch.arange(h, device=dev)
    ax = torch.arange(w, device=dev)
    orig = cur_y[(y0[:, None] + ay)[:, :, None], (x0[:, None] + ax)[:, None, :]]
    rate = _mv_bits(mvx - px[:, None]) + _mv_bits(mvy - py[:, None])
    cost = _satd(orig[:, None] - pred) + _lam_cost(lam_satd, rate)
    k = cost.argmin(1)
    ar = torch.arange(ref.shape[0], device=dev)
    return mvx[ar, k], mvy[ar, k], pred[ar, k], cost[ar, k]


def mc_luma_plain(banks, ref, mvx, mvy, y0, x0, wp, h: int, w: int):
    """Quarter-pel MC of n (h, w) units (rd.py:145 `_mc_luma_unit`, and
    the skip prediction of rd.py:848-864), weighted by each unit's
    reference when wp is given.  Returns (n, h, w)."""
    p = _qpel(banks, ref, mvx[:, None], mvy[:, None], y0, x0, h, w)[:, 0]
    return _wp(p, wp, ref[:, None, None])


def mc_chroma_plain(cpads, ref8, mv4x, mv4y):
    """Inter chroma prediction per MB (rd.py:1040-1057): one 1/8-pel
    bilinear 2x2 chroma block per 4x4 luma block, with that block's mv
    and its 8x8 unit's reference; never weighted.  ref8 (n_mb, 4), mv4x/
    mv4y (n_mb, 4 units, 4 subpos).  Returns (n_mb, 2, 8, 8)."""
    n_mb = ref8.shape[0]
    n_mx = (cpads.shape[-1] - 2 * PAD) // 8
    dev = cpads.device
    mb = torch.arange(n_mb, device=dev)[:, None, None]
    b8 = torch.arange(4, device=dev)[None, :, None]
    q = torch.arange(4, device=dev)[None, None, :]
    ly = torch.as_tensor(_B8OY, device=dev)[b8] + (q >> 1) * 4
    lx = torch.as_tensor(_B8OX, device=dev)[b8] + (q & 1) * 4
    yc = (16 * (mb // n_mx) + ly) >> 1
    xc = (16 * (mb % n_mx) + lx) >> 1
    shape = (n_mb, 4, 4)
    g = _mc_chroma_unit(cpads, ref8[:, :, None].expand(shape).reshape(-1),
                        mv4x.reshape(-1), mv4y.reshape(-1),
                        yc.expand(shape).reshape(-1),
                        xc.expand(shape).reshape(-1), 2, 2)
    # [mb, b8y, b8x, qy, qx, ch, h, w] -> (mb, ch, 8, 8)
    g = g.reshape(n_mb, 2, 2, 2, 2, 2, 2, 2)
    return g.permute(0, 5, 1, 3, 6, 2, 4, 7).reshape(n_mb, 2, 8, 8)


def inter_luma_tq_plain(pred, orig, qp: int, lam: int):
    """Inter luma residual coding (rd.py:879-893 `tq_recon`): forward 4x4,
    quant with the inter offset, RDOQ-lite, dequant/inverse, recon, then
    JM thresholding.  pred (..., 16, 16), orig (n_mb, 16, 16) broadcast.
    Returns (lev (..., 4, 4, 4, 4), rec (..., 16, 16), D8 (..., 4),
    cb8 (..., 4)): SSD and coefficient bits per 8x8 unit."""
    res = orig - pred
    blk = res.reshape(*res.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    lev = Q.quant4x4(TR.forward4x4(blk), qp, Q.default_offset4(qp, False))
    lev = _rdoq4(blk, lev, qp, lam)
    rr = TR.inverse4x4(Q.dequant4x4(lev, qp))
    pb = pred.reshape(*pred.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    rec_b = ((rr + (pb << 6) + 32) >> 6).clamp(0, 255)
    rec = rec_b.transpose(-3, -2).reshape(pred.shape)
    return _threshold_inter_luma(lev, rec, pred, orig.expand(pred.shape))


def inter_chroma_tq_plain(pred, orig, qp_c: int, lam: int):
    """Inter chroma residual coding (rd.py:1058-1061): `_chroma_tq` with
    the inter offset, RDOQ-lite on the AC and the JM AC drop.  Returns
    (levc (n, 2, 2, 2, 4, 4), dcc (n, 2, 2, 2), recc (n, 2, 8, 8))."""
    return _chroma_tq(pred, orig, qp_c, intra=False, lam=lam)


def i16_candidate_plain(cur_y, qp: int):
    """The P picture's I16 candidate (rd.py:984-998) from ORIGINAL
    neighbours (zero outside the picture): mode pick, transform, recon.
    Returns (rec16 (n_mb, 16, 16), D16 (n_mb,), cb16 (n_mb,))."""
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    dev = cur_y.device
    padded = torch.nn.functional.pad(cur_y, (1, 0, 1, 0))
    r = torch.arange(n_my, device=dev)
    c = torch.arange(n_mx, device=dev)
    a16 = torch.arange(16, device=dev)
    up = padded[(16 * r)[:, None, None], (16 * c)[None, :, None] + 1 + a16]
    left = padded[(16 * r)[:, None, None] + 1 + a16, (16 * c)[None, :, None]]
    ul = padded[(16 * r)[:, None], (16 * c)[None, :]]
    au = (r > 0)[:, None].expand(n_my, n_mx).reshape(-1)
    al = (c > 0)[None, :].expand(n_my, n_mx).reshape(-1)
    orig = _mb_tiles(cur_y, 16)
    pred, _ = _i16_pred_all(up.reshape(-1, 16), left.reshape(-1, 16),
                            ul.reshape(-1), au, al, orig)
    _, _, rec, D16, cb16 = _i16_tq(pred, orig, qp)
    return rec, D16, cb16


def _blocks8(x):
    """(n, 16, 16) -> (n, 2, 2, 8, 8) [b8y][b8x][y][x]."""
    return x.reshape(-1, 2, 8, 2, 8).transpose(2, 3)


def t8_decide_plain(orig_mb, w_pred, w_rec, w_lev, win, w_sub, is_intra,
                    qp: int, lam: int):
    """The FRExt transform-size decision (rd.py:1071-1113; lencod
    transform8x8.c:1452): every MB's winning prediction re-coded with the
    8x8 transform (forward, quant with the inter offset, dequant, inverse,
    recon) and kept when D_8 + lambda (cb8 + 1) < D_4 + lambda (cb4 + 1),
    strictly, so a tie keeps 4x4; only inter, non-skip winners whose units
    are all at least 8x8 may switch.  orig_mb/w_pred/w_rec (n_mb, 16, 16),
    w_lev (n_mb, 4, 4, 4, 4), win (n_mb,), w_sub (n_mb, 4), is_intra
    (n_mb,) bool.  Returns (w_t8 (n_mb,), w_lev8 (n_mb, 2, 2, 8, 8), w_lev,
    w_rec) with the 4x4 levels zeroed and the recon replaced where 8x8
    wins.

    Level bound: the forward butterflies gain at most 8 per dimension
    (the DC row of a +-255 residual: 64 * 255 = 16320), so at QP 0 the
    largest level is (16320 * 13107 + 10944) >> 16 = 3264 (DC, class 0);
    every other position's gain times its QUANT8 factor is smaller.  So
    `_bitlen` sees levels below 8192, where it equals the reference's."""
    lev8 = Q.quant8x8(TR.forward8x8(_blocks8(orig_mb - w_pred)), qp,
                      Q.default_offset8(qp, False))
    rr8 = TR.inverse8x8(Q.dequant8x8(lev8, qp))
    rec8 = ((rr8 + (_blocks8(w_pred) << 6) + 32) >> 6).clamp(0, 255)
    rec8 = rec8.transpose(2, 3).reshape(-1, 16, 16)
    d8 = orig_mb - rec8
    D_8 = (d8 * d8).sum((-1, -2), dtype=I32)
    a8 = lev8.abs()
    nz8 = a8 > 0
    cb8 = (torch.where(nz8, 2 * _bitlen(a8.clamp(min=1)) + 2, 0).sum(
        (-1, -2), dtype=I32) + torch.where(nz8.any(-1).any(-1), 4, 0)).sum(
        (-1, -2), dtype=I32)
    d4 = orig_mb - w_rec
    D_4 = (d4 * d4).sum((-1, -2), dtype=I32)
    cb4 = _coef_bits(w_lev).sum((-1, -2), dtype=I32)
    ok = (~is_intra) & (win != C_SKIP) & ((win != C_P8x8)
                                          | (w_sub == 0).all(-1))
    use8 = ok & (D_8 + _lam_cost(lam, cb8 + 1) < D_4 + _lam_cost(lam, cb4 + 1))
    u5 = use8[:, None, None, None, None]
    return (use8.to(I32), torch.where(u5, lev8, 0), torch.where(u5, 0, w_lev),
            torch.where(use8[:, None, None], rec8, w_rec))


def _edge_luma(L, S, alpha, beta, clip_row):
    """One luma edge over lines (spec §8.7.2.3/4, rd.py:1741): L (8, ...)
    the samples p3..p0, q0..q3 across the edge, S the bS per line.
    Returns the new p2..q2 (6, ...)."""
    L3, L2, L1, L0, R0, R1, R2, R3 = L
    delta = R0 - L0
    filt = ((S != 0) & (delta.abs() < alpha) & ((R0 - R1).abs() < beta)
            & ((L0 - L1).abs() < beta))
    ap = (L0 - L2).abs() < beta
    aq = (R0 - R2).abs() < beta
    C0 = clip_row[S.clamp(0, 3).long()]
    c0 = C0 + ap.to(I32) + aq.to(I32)
    dif = torch.maximum(torch.minimum(((delta << 2) + (L1 - R1) + 4) >> 3, c0),
                        -c0)
    RL0 = (L0 + R0 + 1) >> 1

    def clipc(v):
        return torch.maximum(torch.minimum(v, C0), -C0)

    nL1 = L1 + torch.where(ap, clipc((L2 + RL0 - (L1 << 1)) >> 1), 0)
    nR1 = R1 + torch.where(aq, clipc((R2 + RL0 - (R1 << 1)) >> 1), 0)
    nL0 = (L0 + dif).clamp(0, 255)
    nR0 = (R0 - dif).clamp(0, 255)
    small = delta.abs() < ((alpha >> 2) + 2)
    sp = ap & small
    sq = aq & small
    sL0 = torch.where(sp, (L2 + 2 * L1 + 2 * L0 + 2 * R0 + R1 + 4) >> 3,
                      (2 * L1 + L0 + R1 + 2) >> 2)
    sL1 = torch.where(sp, (L2 + L1 + L0 + R0 + 2) >> 2, L1)
    sL2 = torch.where(sp, (2 * L3 + 3 * L2 + L1 + L0 + R0 + 4) >> 3, L2)
    sR0 = torch.where(sq, (R2 + 2 * R1 + 2 * R0 + 2 * L0 + L1 + 4) >> 3,
                      (2 * R1 + R0 + L1 + 2) >> 2)
    sR1 = torch.where(sq, (R2 + R1 + R0 + L0 + 2) >> 2, R1)
    sR2 = torch.where(sq, (2 * R3 + 3 * R2 + R1 + R0 + L0 + 4) >> 3, R2)
    strong = S == 4
    out = (torch.where(strong, sL2, L2), torch.where(strong, sL1, nL1),
           torch.where(strong, sL0, nL0), torch.where(strong, sR0, nR0),
           torch.where(strong, sR1, nR1), torch.where(strong, sR2, R2))
    return torch.stack([torch.where(filt, o, x)
                        for o, x in zip(out, (L2, L1, L0, R0, R1, R2))])


def _edge_chroma(L, S, alpha, beta, clip_row):
    """One chroma edge (rd.py:1784): L (4, ...) = p1, p0, q0, q1.
    Returns the new p0, q0 (2, ...)."""
    L1, L0, R0, R1 = L
    delta = R0 - L0
    filt = ((S != 0) & (delta.abs() < alpha) & ((R0 - R1).abs() < beta)
            & ((L0 - L1).abs() < beta))
    c0 = clip_row[S.clamp(0, 3).long()] + 1
    dif = torch.maximum(torch.minimum(((delta << 2) + (L1 - R1) + 4) >> 3, c0),
                        -c0)
    strong = S == 4
    oL0 = torch.where(strong, (2 * L1 + L0 + R1 + 2) >> 2,
                      (L0 + dif).clamp(0, 255))
    oR0 = torch.where(strong, (2 * R1 + R0 + L1 + 2) >> 2,
                      (R0 - dif).clamp(0, 255))
    return torch.stack([torch.where(filt, oL0, L0), torch.where(filt, oR0, R0)])


def _thresholds(qp: int, dev):
    i = min(max(int(qp), 0), 51)
    clip_row = torch.as_tensor(np.asarray(CLIP_TAB)[i, :4], dtype=I32,
                               device=dev)
    return int(ALPHA_TABLE[i]), int(BETA_TABLE[i]), clip_row


def deblock_pad(rec_y, rec_u, rec_v):
    """The planes the filter works on: luma with 4 zero rows above and
    columns left, chroma with 2, so that MB (r, c)'s region starts at
    (16r, 16c) (chroma (8r, 8c)).  Returns (Yp, [Up, Vp])."""
    Yp = torch.nn.functional.pad(rec_y, (4, 0, 4, 0)).contiguous()
    return Yp, [torch.nn.functional.pad(p, (2, 0, 2, 0)).contiguous()
                for p in (rec_u, rec_v)]


def deblock_mbs(Yp, Cp, BSV, BSH, r, c, thr) -> None:
    """Filter the MBs (r, c) (1-D tensors) of the padded planes in place,
    side by side: their regions, luma rows 16r-4..16r+15 and cols
    16c-4..16c+15 (half that in chroma), must be disjoint.  Per MB: luma
    vertical edges 0-3, luma horizontal edges 0-3, then U and V, vertical
    then horizontal.  thr: `_thresholds` of the luma and the chroma QP."""
    dev = Yp.device
    (al, be, cr), (alc, bec, crc) = thr
    a20 = torch.arange(20, device=dev)
    a10 = torch.arange(10, device=dev)
    a4 = torch.arange(4, device=dev)
    iy = (16 * r)[:, None, None] + a20[:, None]
    ix = (16 * c)[:, None, None] + a20
    A = Yp[iy, ix]  # (n, 20, 20)
    sv = BSV[(4 * r)[:, None, None] + a4[:, None], (4 * c)[:, None, None] + a4]
    sh = BSH[(4 * r)[:, None, None] + a4[:, None], (4 * c)[:, None, None] + a4]
    for e in range(4):
        x = 4 + 4 * e
        S = sv[:, :, e].repeat_interleave(4, 1)  # (n, 16) per row
        L = A[:, 4:20, x - 4:x + 4].permute(2, 0, 1)
        A[:, 4:20, x - 3:x + 3] = _edge_luma(L, S, al, be, cr).permute(1, 2, 0)
    for e in range(4):
        y = 4 + 4 * e
        S = sh[:, e, :].repeat_interleave(4, 1)  # (n, 16) per column
        L = A[:, y - 4:y + 4, 4:20].permute(1, 0, 2)
        A[:, y - 3:y + 3, 4:20] = _edge_luma(L, S, al, be, cr).permute(1, 0, 2)
    Yp[iy, ix] = A
    cy = (8 * r)[:, None, None] + a10[:, None]
    cx = (8 * c)[:, None, None] + a10
    for P in Cp:
        C = P[cy, cx]  # (n, 10, 10)
        for e in range(2):
            x = 2 + 4 * e
            S = sv[:, :, 2 * e].repeat_interleave(2, 1)
            L = C[:, 2:10, x - 2:x + 2].permute(2, 0, 1)
            C[:, 2:10, x - 1:x + 1] = _edge_chroma(
                L, S, alc, bec, crc).permute(1, 2, 0)
        for e in range(2):
            y = 2 + 4 * e
            S = sh[:, 2 * e, :].repeat_interleave(2, 1)
            L = C[:, y - 2:y + 2, 2:10].permute(1, 0, 2)
            C[:, y - 1:y + 1, 2:10] = _edge_chroma(
                L, S, alc, bec, crc).permute(1, 0, 2)
        P[cy, cx] = C


def deblock_plain(rec_y, rec_u, rec_v, BSV, BSH, qp: int, qp_c: int):
    """Full-strength in-loop filter (rd.py:1800 `deblock_device_full`).

    The reference filters MBs in raster order.  MB (r, c) reads picture
    rows 16r-4..16r+15 and cols 16c-4..16c+15 (half that in chroma) and
    writes inside them; the MBs of one anti-diagonal t = 2r + c touch
    disjoint regions, and every MB whose region meets (r, c)'s comes
    before it in raster order exactly when it comes on an earlier
    diagonal.  So this version filters one anti-diagonal at a time, its
    MBs side by side (`deblock_mbs`), with the same result.  Returns new
    (Y, U, V) int32 planes."""
    H, W = rec_y.shape
    n_my, n_mx = H // 16, W // 16
    dev = rec_y.device
    thr = (_thresholds(qp, dev), _thresholds(qp_c, dev))
    Yp, Cp = deblock_pad(rec_y, rec_u, rec_v)
    for t in range(2 * n_my + n_mx - 2):
        r0 = max(0, (t - n_mx + 2) // 2)
        r = torch.arange(r0, min(n_my - 1, t // 2) + 1, device=dev)
        deblock_mbs(Yp, Cp, BSV, BSH, r, t - 2 * r, thr)
    return (Yp[4:, 4:].contiguous(), Cp[0][2:, 2:].contiguous(),
            Cp[1][2:, 2:].contiguous())


# ---------------------------------------------------------------------------
# the kernel entries a P picture goes through
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PKernels:
    """The device entries of one P picture: the CUDA kernel wrappers by
    default (``default_kernels``), or their plain versions (``PLAIN``)."""

    coarse_search: object
    ssd_grid8: object
    sub8_search: object
    qpel_refine: object
    mc_luma: object
    mc_chroma: object
    inter_luma_tq: object
    inter_chroma_tq: object
    i16_candidate: object
    strengths: object
    deblock: object
    intra_scan: object
    ref_bank: object
    t8_decide: object

    def names(self):
        return [f.name for f in fields(self)]


PLAIN = PKernels(
    coarse_search_plain, ssd_grid8_plain, sub8_search_plain, qpel_refine_plain,
    mc_luma_plain, mc_chroma_plain, inter_luma_tq_plain,
    inter_chroma_tq_plain, i16_candidate_plain, strengths_plain,
    deblock_plain, RD._intra_scan, RD.ref_entry_plain, t8_decide_plain)


def default_kernels() -> PKernels:
    """The CUDA kernel wrappers (each runs its plain version on a CPU
    tensor)."""
    from ..kernels import deblock as K6
    from ..kernels import inter_tq as K5
    from ..kernels import intra_commit as K1
    from ..kernels import qpel as K4
    from ..kernels import ref_bank as K2
    from ..kernels import search_grid as K3
    from ..kernels import t8 as K9

    return PKernels(
        K3.coarse_search, K3.ssd_grid8, K3.sub8_search, K4.qpel_refine,
        K4.mc_luma, K4.mc_chroma, K5.inter_luma_tq, K5.inter_chroma_tq,
        K5.i16_candidate, K6.strengths, K6.deblock, K1.intra_commit_scan,
        K2.ref_bank, K9.t8_decide)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

class PFrame:
    """Inputs and intermediates of one P picture; each ``p_*`` stage adds
    its results as attributes."""

    def __init__(self, cur_y, cur_u, cur_v, banks, cpads, H: int, W: int,
                 R: int, qp: int, qp_c: int, lam: int, lam_me: int, nref: int,
                 wp=None, k: PKernels | None = None, use_t8: bool = False,
                 use_cme: bool = True, force_intra=None, drift_pen=None):
        self.cur_y, self.cur_u, self.cur_v = cur_y, cur_u, cur_v
        self.banks, self.cpads = banks, cpads
        self.H, self.W, self.R = H, W, R
        self.qp, self.qp_c, self.lam, self.lam_me = (
            int(qp), int(qp_c), int(lam), int(lam_me))
        self.nref = int(nref)
        self.wp = wp
        self.use_t8 = bool(use_t8)
        self.use_cme = bool(use_cme)
        # intra refresh: (n_mb,) bool, MBs that must code intra; loss-aware
        # RDO: (n_mb,) int32 drift penalty on every inter candidate
        self.force_intra, self.drift_pen = force_intra, drift_pen
        self.w_lev8 = None  # the 8x8 levels, made by p_t8 when use_t8
        self.k = k if k is not None else default_kernels()
        self.dev = cur_y.device
        self.NR = banks.shape[0]
        self.n_my, self.n_mx = H // 16, W // 16
        self.n_mb = self.n_my * self.n_mx
        self.D = 2 * R + 1
        # SATD lambda, float32 in the reference's order (rd.py:548)
        self.lam_satd = lam_satd_of(self.lam_me)
        mb = torch.arange(self.n_mb, device=self.dev)
        self.mb_ys = (mb // self.n_mx) * 16
        self.mb_xs = (mb % self.n_mx) * 16

    def ints(self, v):
        return torch.as_tensor(v, dtype=I32, device=self.dev)


def _med_neighbors(f):
    """Median of the left, upper and upper-right neighbours (0 outside)."""
    a = torch.nn.functional.pad(f, (1, 0))[:, :-1]
    b = torch.nn.functional.pad(f, (0, 0, 1, 0))[:-1, :]
    c = torch.nn.functional.pad(f, (0, 1, 1, 0))[:-1, 1:]
    return _med3(a, b, c)


def _mvbits_grid(f: PFrame, px, py):
    """MV rate of every grid cell against the PMV field:
    (NR, n_my, n_mx, D, D); cell (i, j) of ref r is cen[r] + (j, i) - R."""
    dgrid = torch.arange(-f.R, f.R + 1, dtype=I32, device=f.dev) * 4
    gx = f.cen_x[..., None] * 4 + dgrid
    gy = f.cen_y[..., None] * 4 + dgrid
    bits_x = _mv_bits(gx - px[None, ..., None])
    bits_y = _mv_bits(gy - py[None, ..., None])
    return bits_x[:, :, :, None, :] + bits_y[:, :, :, :, None]


def _part_argmin(f: PFrame, grids, mvb):
    """(ref, imvx, imvy) per MB: the minimum over cells per ref, then the
    first ref with the least minimum, then its first cell."""
    cost = grids + _lam_cost(f.lam_me, mvb)
    cost = cost + (_lam_cost(f.lam_me, f.rbits) + f.ref_pen)[
        :, None, None, None, None]
    flat = cost.reshape(f.NR, f.n_my, f.n_mx, -1)
    per_ref, per_ref_i = flat.min(-1)
    ref = per_ref.argmin(0)
    idx = per_ref_i.gather(0, ref[None])[0].to(I32)
    cxs = f.cen_x.gather(0, ref[None])[0]
    cys = f.cen_y.gather(0, ref[None])[0]
    D, R = f.D, f.R
    return ref.to(I32), idx % D - R + cxs, idx // D - R + cys


def p_search(f: PFrame) -> None:
    """Stages 0-1: the coarse centres (zero without ``use_cme``,
    rd.py:416-418) and the dense per-8x8 SSD grids."""
    if f.use_cme:
        f.cen_x, f.cen_y = f.k.coarse_search(f.banks, f.cur_y, f.wp, f.lam_me)
    else:
        f.cen_x = torch.zeros((f.NR, f.n_my, f.n_mx), dtype=I32, device=f.dev)
        f.cen_y = torch.zeros_like(f.cen_x)
    f.ssd8 = f.k.ssd_grid8(f.banks, f.cur_y, f.cen_x, f.cen_y, f.wp, f.R)


def p_partitions(f: PFrame) -> None:
    """Stages 2-3: partition grids, the two-pass PMV field and the
    integer (ref, mv) of every 16x16, 16x8, 8x16 and 8x8 partition."""
    NR, n_my, n_mx, D, R = f.NR, f.n_my, f.n_mx, f.D, f.R
    ssd8 = f.ssd8.reshape(NR, n_my, 2, n_mx, 2, D, D)
    ssd16 = ssd8.sum((2, 4), dtype=I32)
    s16x8 = ssd8.sum(4, dtype=I32).permute(0, 1, 3, 2, 4, 5)
    s8x16 = ssd8.sum(2, dtype=I32)
    dgrid = torch.arange(-R, R + 1, dtype=I32, device=f.dev) * 4
    zb = (_mv_bits(f.cen_x[0][..., None] * 4 + dgrid)[:, :, None, :]
          + _mv_bits(f.cen_y[0][..., None] * 4 + dgrid)[:, :, :, None])
    c0 = ssd16[0] + _lam_cost(f.lam_me, zb)
    bi0 = c0.reshape(n_my, n_mx, -1).argmin(-1).to(I32)
    pm_x = (bi0 % D - R + f.cen_x[0]) * 4
    pm_y = (bi0 // D - R + f.cen_y[0]) * 4
    pmvx, pmvy = _med_neighbors(pm_x), _med_neighbors(pm_y)
    mvbits = _mvbits_grid(f, pmvx, pmvy)
    rbits = f.ints([1 if r == 0 else 2 * (r + 1).bit_length() - 1
                    for r in range(NR)])
    # a single active ref transmits no ref_idx; padded refs never win
    f.rbits = rbits if f.nref > 1 else torch.zeros_like(rbits)
    f.ref_pen = f.ints([1 << 29 if r >= f.nref else 0 for r in range(NR)])
    f.r16 = _part_argmin(f, ssd16, mvbits)
    # second pass: the PMV field of the chosen 16x16 integer mvs
    f.pmvx = _med_neighbors(f.r16[1] * 4)
    f.pmvy = _med_neighbors(f.r16[2] * 4)
    mvbits = _mvbits_grid(f, f.pmvx, f.pmvy)
    f.r168 = [_part_argmin(f, s16x8[:, :, :, h], mvbits) for h in range(2)]
    f.r816 = [_part_argmin(f, s8x16[:, :, :, h], mvbits) for h in range(2)]
    f.r88 = [_part_argmin(f, ssd8[:, :, b >> 1, :, b & 1], mvbits)
             for b in range(4)]


def _refine(f: PFrame, parts, offs, h: int, w: int):
    """Refine the units of several partitions of every MB in one launch:
    parts [(ref, imvx, imvy) (n_my, n_mx)], offs [(oy, ox)] their origins
    in the MB.  Returns per part (ref, mvx, mvy, pred, cost), (n_mb, ...)."""
    n = len(parts)
    ref = torch.cat([p[0].reshape(-1) for p in parts])
    ix = torch.cat([p[1].reshape(-1) for p in parts])
    iy = torch.cat([p[2].reshape(-1) for p in parts])
    y0 = torch.cat([f.mb_ys + oy for oy, _ in offs]).to(I32)
    x0 = torch.cat([f.mb_xs + ox for _, ox in offs]).to(I32)
    px = f.pmvx.reshape(-1).repeat(n)
    py = f.pmvy.reshape(-1).repeat(n)
    mvx, mvy, pred, cost = f.k.qpel_refine(
        f.banks, f.cur_y, ref, ix, iy, y0, x0, px, py, f.wp, f.lam_satd, h, w)
    return [tuple(t.chunk(n)[i] for t in (ref, mvx, mvy, pred, cost))
            for i in range(n)]


def p_refine(f: PFrame) -> None:
    """Stage 4: quarter-pel refinement of every partition."""
    f.q16, = _refine(f, [f.r16], [(0, 0)], 16, 16)
    f.q168 = _refine(f, f.r168, [(0, 0), (8, 0)], 8, 16)
    f.q816 = _refine(f, f.r816, [(0, 0), (0, 8)], 16, 8)
    f.q88 = _refine(f, f.r88, [(0, 0), (0, 8), (8, 0), (8, 8)], 8, 8)


def _chain_bits(f: PFrame, mvxs, mvys):
    """Chained mv rate of sub-blocks in scan order (first vs the PMV)."""
    tot = _mv_bits(mvxs[0] - f.u_px) + _mv_bits(mvys[0] - f.u_py)
    for a in range(1, len(mvxs)):
        tot = tot + _mv_bits(mvxs[a] - mvxs[a - 1]) + _mv_bits(
            mvys[a] - mvys[a - 1])
    return tot


def p_sub8(f: PFrame) -> None:
    """Sub-8x8 decision per 8x8 unit (rd.py:600-765): 4x4-level grids on
    the unit's reference around its 8x8 winner, 8x4/4x8/4x4 search and
    refinement, the split choice by SATD cost, and the MB composites."""
    n_mb, dev = f.n_mb, f.dev
    nsb = 4 * n_mb
    u = torch.arange(nsb, device=dev)
    u_mb, u_b8 = u // 4, u % 4
    u_y0 = (f.mb_ys[u_mb] + f.ints(_B8OY)[u_b8]).to(I32)
    u_x0 = (f.mb_xs[u_mb] + f.ints(_B8OX)[u_b8]).to(I32)
    f.u_ref = torch.stack([f.q88[b][0] for b in range(4)], 1).reshape(-1)
    f.u_qx = torch.stack([f.q88[b][1] for b in range(4)], 1).reshape(-1)
    f.u_qy = torch.stack([f.q88[b][2] for b in range(4)], 1).reshape(-1)
    u_pred8 = torch.stack([f.q88[b][3] for b in range(4)], 1)
    f.u_px = f.pmvx.reshape(-1)[u_mb]
    f.u_py = f.pmvy.reshape(-1)[u_mb]
    RS = min(f.R, 10)
    # sub-block centres stay RS + 5 inside the (widened) padding
    CMAX = (PADW if f.use_cme else PAD) - RS - 5
    u_cy = (f.u_qy >> 2).clamp(-CMAX, CMAX)
    u_cx = (f.u_qx >> 2).clamp(-CMAX, CMAX)
    # each unit's eight integer winners, (2, 8, nsb): 8x4, 4x8, 4x4
    mv = f.k.sub8_search(f.banks, f.cur_y, f.u_ref, u_cy, u_cx, f.u_px,
                         f.u_py, f.wp, RS, f.lam_me)

    def refine_sub(p0, offs, h, w):
        """Every unit's sub-blocks of one shape (partitions p0 ...) in
        one launch."""
        n = len(offs)
        out = f.k.qpel_refine(
            f.banks, f.cur_y, f.u_ref.repeat(n), mv[0, p0:p0 + n].reshape(-1),
            mv[1, p0:p0 + n].reshape(-1),
            torch.cat([u_y0 + oy for oy, _ in offs]),
            torch.cat([u_x0 + ox for _, ox in offs]),
            f.u_px.repeat(n), f.u_py.repeat(n), f.wp, f.lam_satd, h, w)
        return [tuple(t.chunk(n)[i] for t in out) for i in range(n)]

    q84 = refine_sub(0, [(0, 0), (4, 0)], 4, 8)
    q48 = refine_sub(2, [(0, 0), (0, 4)], 8, 4)
    q44 = refine_sub(4, [((q >> 1) * 4, (q & 1) * 4) for q in range(4)], 4, 4)
    split_cost = torch.stack([
        q84[0][3] + q84[1][3] + _lam_cost(f.lam_satd, 3),
        q48[0][3] + q48[1][3] + _lam_cost(f.lam_satd, 3),
        q44[0][3] + q44[1][3] + q44[2][3] + q44[3][3]
        + _lam_cost(f.lam_satd, 5)])
    u_split = split_cost.argmin(0).to(I32) + 1  # 1..3
    sel = (u_split - 1).long()[None]

    def pick3(vals):
        return torch.stack(vals).gather(
            0, sel.reshape(1, -1, *([1] * (vals[0].dim() - 1))).expand(
                1, *vals[0].shape))[0]

    def qsel(q, c):  # the mv component c of sub-position q per split mode
        return [q84[q >> 1][c], q48[q & 1][c], q44[q][c]]

    spl_mvx = torch.stack([pick3(qsel(q, 0)) for q in range(4)], 1)
    spl_mvy = torch.stack([pick3(qsel(q, 1)) for q in range(4)], 1)
    p84 = torch.cat([q84[0][2], q84[1][2]], 1)
    p48 = torch.cat([q48[0][2], q48[1][2]], 2)
    p44 = torch.cat([torch.cat([q44[0][2], q44[1][2]], 2),
                     torch.cat([q44[2][2], q44[3][2]], 2)], 1)
    spl_pred = pick3([p84, p48, p44])
    stb = f.ints([0, 3, 3, 5])[u_split.long()]
    split_mot = torch.stack([
        _chain_bits(f, [q84[0][0], q84[1][0]], [q84[0][1], q84[1][1]]),
        _chain_bits(f, [q48[0][0], q48[1][0]], [q48[0][1], q48[1][1]]),
        _chain_bits(f, [q44[q][0] for q in range(4)],
                    [q44[q][1] for q in range(4)])])
    f.motb_split = (pick3(list(split_mot)) + stb).reshape(n_mb, 4)
    f.motb_plain = (_chain_bits(f, [f.u_qx], [f.u_qy]) + 1).reshape(n_mb, 4)
    f.spl_pred_mb = (spl_pred.reshape(n_mb, 2, 2, 8, 8).transpose(2, 3)
                     .reshape(n_mb, 16, 16))
    f.spl_mvx_mb = spl_mvx.reshape(n_mb, 4, 4)
    f.spl_mvy_mb = spl_mvy.reshape(n_mb, 4, 4)
    f.spl_mode_mb = u_split.reshape(n_mb, 4)
    f.plain_pred_mb = (u_pred8.reshape(n_mb, 2, 2, 8, 8).transpose(2, 3)
                       .reshape(n_mb, 16, 16))


def _shift(x, dy: int, dx: int, fill: int):
    """out[y, x] = x[y + dy, x + dx], `fill` outside."""
    Hh, Ww = x.shape
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, Hh), slice(0, Hh - dy)) if dy >= 0 else (
        slice(0, Hh + dy), slice(-dy, Hh))
    xs, xd = (slice(dx, Ww), slice(0, Ww - dx)) if dx >= 0 else (
        slice(0, Ww + dx), slice(-dx, Ww))
    out[yd, xd] = x[ys, xs]
    return out


def _skip_field(f: PFrame):
    """The P_Skip mv of every MB (spec §8.4.1.1) on the refined 16x16
    field (rd.py:767-818)."""
    n_my, n_mx, dev = f.n_my, f.n_mx, f.dev
    mvx16 = f.q16[1].reshape(n_my, n_mx)
    mvy16 = f.q16[2].reshape(n_my, n_mx)
    ref16 = f.q16[0].reshape(n_my, n_mx)

    def nb(dy, dx):
        return (_shift(mvx16, dy, dx, 0), _shift(mvy16, dy, dx, 0),
                _shift(ref16, dy, dx, -1))

    col = torch.arange(n_mx, device=dev)[None, :].expand(n_my, n_mx)
    row = torch.arange(n_my, device=dev)[:, None].expand(n_my, n_mx)
    avA, avB = col > 0, row > 0
    avC = (row > 0) & (col < n_mx - 1)
    avD = (row > 0) & (col > 0)
    ax_, ay_, ar_ = nb(0, -1)
    bx_, by_, br_ = nb(-1, 0)
    cx_, cy_, cr_ = nb(-1, 1)
    dx_, dy_, dr_ = nb(-1, -1)
    cx_ = torch.where(avC, cx_, dx_)
    cy_ = torch.where(avC, cy_, dy_)
    cr_ = torch.where(avC, cr_, torch.where(avD, dr_, -1))
    avC = avC | avD
    mA, mB, mC = avA & (ar_ == 0), avB & (br_ == 0), avC & (cr_ == 0)
    nm = mA.to(I32) + mB.to(I32) + mC.to(I32)
    medx = _med3(torch.where(avA, ax_, 0), torch.where(avB, bx_, 0),
                 torch.where(avC, cx_, 0))
    medy = _med3(torch.where(avA, ay_, 0), torch.where(avB, by_, 0),
                 torch.where(avC, cy_, 0))
    onlyx = torch.where(mA, ax_, torch.where(mB, bx_, cx_))
    onlyy = torch.where(mA, ay_, torch.where(mB, by_, cy_))
    onlyA = (~avB) & (~avC) & avA
    pskx = torch.where(nm == 1, onlyx, torch.where(onlyA, ax_, medx))
    psky = torch.where(nm == 1, onlyy, torch.where(onlyA, ay_, medy))
    zero = ((~avA) | (~avB) | (mA & (ax_ == 0) & (ay_ == 0))
            | (mB & (bx_ == 0) & (by_ == 0)))
    return (torch.where(zero, 0, pskx).reshape(-1),
            torch.where(zero, 0, psky).reshape(-1))


def _mb_tiles(plane, s: int):
    """(H, W) plane -> (n_mb, s, s) raster MB tiles."""
    H, W = plane.shape
    return (plane.reshape(H // s, s, W // s, s).permute(0, 2, 1, 3)
            .reshape(-1, s, s))


def p_decide(f: PFrame) -> None:
    """Stage 5 (rd.py:820-1011): the skip field and prediction, residual
    coding of the six candidate predictions, the full-RD plain-8x8 vs
    split choice per unit, rates and J, the I16 candidate, and the winner
    over [P16x16, P16x8, P8x16, P8x8, SKIP, P16PMV, I16]."""
    n_mb, dev, lam = f.n_mb, f.dev, f.lam
    f.pskx, f.psky = _skip_field(f)
    q16, q168, q816, q88 = f.q16, f.q168, f.q816, f.q88

    def stack4(units):
        return [torch.stack([u[c] for u in units], 1) for c in range(3)]

    zeros = torch.zeros((n_mb, 4), dtype=I32, device=dev)
    cands = [stack4([q16] * 4), stack4([q168[0], q168[0], q168[1], q168[1]]),
             stack4([q816[0], q816[1], q816[0], q816[1]]), stack4(q88),
             [zeros, f.pskx[:, None].expand(n_mb, 4),
              f.psky[:, None].expand(n_mb, 4)]]
    f.ref8 = torch.stack([c[0] for c in cands])
    f.mv8x = torch.stack([c[1] for c in cands])
    f.mv8y = torch.stack([c[2] for c in cands])
    pred_sk = f.k.mc_luma(f.banks, zeros[:, 0].contiguous(), f.pskx, f.psky,
                          f.mb_ys.to(I32), f.mb_xs.to(I32), f.wp, 16, 16)
    preds = torch.stack([
        q16[3], torch.cat([q168[0][3], q168[1][3]], 1),
        torch.cat([q816[0][3], q816[1][3]], 2), f.plain_pred_mb, pred_sk,
        f.spl_pred_mb]).contiguous()
    f.orig_mb = _mb_tiles(f.cur_y, 16).contiguous()
    lev_i, rec_i, D8, cb8 = f.k.inter_luma_tq(preds, f.orig_mb, f.qp, lam)
    D_i, cb_i = D8.sum(-1, dtype=I32), cb8.sum(-1, dtype=I32)
    # per-unit plain 8x8 vs split at full RD (mode_decision.c:531)
    use_split = (D8[5] + _lam_cost(lam, cb8[5] + f.motb_split)
                 < D8[3] + _lam_cost(lam, cb8[3] + f.motb_plain))
    m_blk = use_split.reshape(n_mb, 2, 2).repeat_interleave(
        2, 1).repeat_interleave(2, 2)
    m_pix = use_split.reshape(n_mb, 2, 2).repeat_interleave(
        8, 1).repeat_interleave(8, 2)
    lev_i = torch.cat([lev_i[:3], torch.where(m_blk[..., None, None],
                                              lev_i[5], lev_i[3])[None],
                       lev_i[4:5]])
    rec_i = torch.cat([rec_i[:3], torch.where(m_pix, rec_i[5], rec_i[3])[None],
                       rec_i[4:5]])
    D_i = torch.cat([D_i[:3], torch.where(use_split, D8[5], D8[3]).sum(
        -1, dtype=I32)[None], D_i[4:5]])
    cb_i = torch.cat([cb_i[:3], torch.where(use_split, cb8[5], cb8[3]).sum(
        -1, dtype=I32)[None], cb_i[4:5]])
    f.sub_mot_mb = torch.where(use_split, f.motb_split, f.motb_plain).sum(
        -1, dtype=I32)
    f.sub_mode_mb = torch.where(use_split, f.spl_mode_mb, 0)
    f.sub_mvx_mb = torch.where(use_split[:, :, None], f.spl_mvx_mb,
                               f.u_qx.reshape(n_mb, 4)[:, :, None])
    f.sub_mvy_mb = torch.where(use_split[:, :, None], f.spl_mvy_mb,
                               f.u_qy.reshape(n_mb, 4)[:, :, None])
    f.preds = torch.cat([preds[:3], torch.where(m_pix, preds[5],
                                                preds[3])[None], preds[4:5]])
    f.lev_i, f.rec_i = lev_i, rec_i
    # skip: zero residual, rate ~ 0
    f.skip_rec = f.preds[4].clamp(0, 255)
    dsk = f.orig_mb - f.skip_rec
    D_skip = (dsk * dsk).sum((-1, -2), dtype=I32)
    # header + motion rate per candidate; later units price their mvds
    # against the in-MB predictor chain (spec §8.4.1.3)
    pmvx_f, pmvy_f = f.pmvx.reshape(-1), f.pmvy.reshape(-1)
    mvb = (_mv_bits(f.mv8x - pmvx_f[None, :, None])
           + _mv_bits(f.mv8y - pmvy_f[None, :, None]))
    refb = f.rbits[f.ref8.long()]
    hdr = f.ints([1, 3, 3, 7, 0])
    sel = f.ints([[1, 0, 0, 0], [1, 0, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1],
                  [0, 0, 0, 0]])

    def chain(c, a, b):
        return (_mv_bits(f.mv8x[c, :, a] - f.mv8x[c, :, b])
                + _mv_bits(f.mv8y[c, :, a] - f.mv8y[c, :, b]))

    mot = torch.stack([mvb[0, :, 0], mvb[1, :, 0] + chain(1, 2, 0),
                       mvb[2, :, 0] + chain(2, 1, 0), f.sub_mot_mb,
                       torch.zeros_like(f.sub_mot_mb)])
    R_inter = (hdr[:, None] + mot + (refb * sel[:, None, :]).sum(-1, dtype=I32)
               + cb_i)
    J_inter = D_i + _lam_cost(lam, R_inter)
    J_inter[4] = D_skip
    # P16x16 at the PMV: the skip prediction with residual coding
    R_pmv = (1 + f.rbits[0] + _mv_bits(f.pskx - pmvx_f)
             + _mv_bits(f.psky - pmvy_f) + cb_i[4])
    J_pmv = D_i[4] + _lam_cost(lam, R_pmv)
    if f.drift_pen is not None:
        # loss-aware RDO (rd.py:978-982): the expected drift distortion of
        # inter prediction under the simulated losses, int32 wrapping
        pen = f.drift_pen.to(torch.int64)
        J_inter = RD.wrap_i32(J_inter.to(torch.int64) + pen[None, :])
        J_pmv = RD.wrap_i32(J_pmv.to(torch.int64) + pen)
    # I16 from original neighbours (the decision's approximation)
    f.rec16, D16, cb16 = f.k.i16_candidate(f.cur_y, f.qp)
    J_i16 = D16 + _lam_cost(lam, cb16 + 8)
    J_all = torch.cat([J_inter, J_pmv[None], J_i16[None]], 0)
    if f.force_intra is not None:
        # forced intra refresh (rd.py:1005-1010, lencod intrarefresh.c:97):
        # every candidate but I16 of a scheduled MB costs 1 << 29
        inter = torch.arange(J_all.shape[0], device=dev)[:, None] < C_I16
        J_all = torch.where(f.force_intra[None, :] & inter,
                            torch.tensor(1 << 29, dtype=I32, device=dev),
                            J_all)
    f.win = J_all.argmin(0).to(I32)


def p_winner(f: PFrame) -> None:
    """Winner gather and inter chroma (rd.py:1015-1067)."""
    n_mb, win = f.n_mb, f.win
    ar = torch.arange(n_mb, device=f.dev)
    f.is_intra = win == C_I16
    wi = win.clamp(max=C_SKIP).long()
    skip = win == C_SKIP
    f.w_lev = torch.where(skip[:, None, None, None, None], 0, f.lev_i[wi, ar])
    f.w_rec = torch.where(skip[:, None, None], f.skip_rec, f.rec_i[wi, ar])
    f.w_pred = f.preds[wi, ar]
    f.w_ref8 = f.ref8[wi, ar]
    w_mv8x, w_mv8y = f.mv8x[wi, ar], f.mv8y[wi, ar]
    is_p88 = win == C_P8x8
    f.w_sub = torch.where(is_p88[:, None], f.sub_mode_mb, 0)
    f.w_mv4x = torch.where(is_p88[:, None, None], f.sub_mvx_mb,
                           w_mv8x[:, :, None]).contiguous()
    f.w_mv4y = torch.where(is_p88[:, None, None], f.sub_mvy_mb,
                           w_mv8y[:, :, None]).contiguous()
    pred_c = f.k.mc_chroma(f.cpads, f.w_ref8.contiguous(), f.w_mv4x, f.w_mv4y)
    orig_c = torch.stack([_mb_tiles(f.cur_u, 8), _mb_tiles(f.cur_v, 8)],
                         1).contiguous()
    levc, dcc, recc = f.k.inter_chroma_tq(pred_c, orig_c, f.qp_c, f.lam)
    # skip winners carry no chroma residual either
    f.levc = torch.where(skip[:, None, None, None, None, None], 0, levc)
    f.dcc = torch.where(skip[:, None, None, None], 0, dcc)
    f.recc = torch.where(skip[:, None, None, None], pred_c.clamp(0, 255), recc)


def p_t8(f: PFrame) -> None:
    """The FRExt transform-size decision of every winner (rd.py:1071-1113,
    K9); without it every MB keeps the 4x4 transform."""
    if not f.use_t8:
        f.w_t8 = torch.zeros(f.n_mb, dtype=I32, device=f.dev)
        return
    f.w_t8, f.w_lev8, f.w_lev, f.w_rec = f.k.t8_decide(
        f.orig_mb, f.w_pred, f.w_rec, f.w_lev, f.win, f.w_sub, f.is_intra,
        f.qp, f.lam)


def p_commit(f: PFrame) -> None:
    """The wavefront intra commit with the inter results copied through
    (rd.py:1115-1120)."""
    (f.rec_y, f.rec_u, f.rec_v, f.w_lev, f.lum_dc, f.i16mode, f.cip, f.levc,
     f.dcc, i4flag, f.ipm) = RD._intra_commit_scan(
        f.cur_y, f.cur_u, f.cur_v, f.w_rec.contiguous(), f.recc.contiguous(),
        f.is_intra.contiguous(), f.w_lev.contiguous(), f.levc.contiguous(),
        f.dcc.contiguous(), f.H, f.W, f.qp, f.qp_c, lam=f.lam,
        impl=f.k.intra_scan)
    f.win = torch.where(i4flag == 1, C_I4, f.win).to(I32)


def p_deblock(f: PFrame) -> None:
    """Boundary strengths and the in-loop filter (rd.py:1124-1160): the
    strengths read the winners' fields as they are (the 8x8 levels and
    transform flags with the 8x8 transform, whose MBs filter only their
    8-pel-grid edges)."""
    t8 = f.w_lev8 is not None
    BSV, BSH = f.k.strengths(f.n_my, f.n_mx, f.w_lev, f.is_intra, f.w_ref8,
                             f.w_mv4x, f.w_mv4y,
                             f.w_lev8.contiguous() if t8 else None,
                             f.w_t8 if t8 else None)
    f.dy, f.du, f.dv = f.k.deblock(
        f.rec_y.contiguous(), f.rec_u.contiguous(), f.rec_v.contiguous(),
        BSV, BSH, f.qp, f.qp_c)


def p_colocated(f: PFrame):
    """The colocated snapshot of a P picture for later B pictures
    (rd.py:1178): its final list-0 motion per 4x4 block as (4 n_my,
    4 n_mx) planes (intra bool, ref, mvx, mvy int32)."""
    n_my, n_mx = f.n_my, f.n_mx

    def mv4_pic(a):  # (n_mb, unit, subpos) -> (4 n_my, 4 n_mx)
        return (a.reshape(n_my, n_mx, 2, 2, 2, 2).permute(0, 2, 4, 1, 3, 5)
                .reshape(4 * n_my, 4 * n_mx))

    ref4 = (f.w_ref8.reshape(n_my, n_mx, 2, 2).permute(0, 2, 1, 3)
            .reshape(2 * n_my, 2 * n_mx).repeat_interleave(2, 0)
            .repeat_interleave(2, 1))
    intra4 = (f.is_intra.reshape(n_my, n_mx).repeat_interleave(4, 0)
              .repeat_interleave(4, 1))
    return (intra4.contiguous(), ref4.contiguous(),
            mv4_pic(f.w_mv4x).contiguous(), mv4_pic(f.w_mv4y).contiguous())


def p_host_out(f: PFrame):
    """The flat host_out in the reference's layout."""
    lev8 = (f.w_lev8 if f.w_lev8 is not None
            else torch.zeros(256 * f.n_mb, dtype=I32, device=f.dev))
    return torch.cat([
        f.win.reshape(-1), f.w_ref8.reshape(-1), f.w_sub.reshape(-1),
        f.w_t8.reshape(-1), f.w_mv4x.reshape(-1), f.w_mv4y.reshape(-1),
        f.i16mode.reshape(-1), f.cip.reshape(-1), f.w_lev.reshape(-1),
        lev8.reshape(-1), f.lum_dc.reshape(-1), f.levc.reshape(-1), f.dcc.reshape(-1),
        f.ipm.reshape(-1)]).to(I32)


def p_outputs(f: PFrame):
    """The flat host_out, the recon, and the next reference entry: the
    bank (K2) and the colocated snapshot for B pictures."""
    bank, cpad = f.k.ref_bank(f.dy, f.du, f.dv)
    return p_host_out(f), (f.dy, f.du, f.dv), (bank, cpad, p_colocated(f))


P_STAGES = (p_search, p_partitions, p_refine, p_sub8, p_decide, p_winner,
            p_t8, p_commit, p_deblock)


def rd_p_pipeline(cur_y, cur_u, cur_v, banks, cpads, H: int, W: int, R: int,
                  qp: int, qp_c: int, lam: int, lam_me: int, nref=None,
                  wp_w=None, wp_o=None, device=None, k: PKernels | None = None,
                  use_t8: bool = False, use_cme: bool = True,
                  force_intra=None, drift_pen=None):
    """Whole-picture RD P coding.  cur_*: uint8 or int32 planes (host or
    device); banks (NR, 4, Hp, Wp), cpads (NR, 2, Hcp, Wcp) int32 on the
    device; lam / lam_me: lambda_mode / lambda_me << 16; nref: the active
    references (the rest of `banks` is padding that never wins); wp_w /
    wp_o: (NR,) explicit luma weights and offsets, or None; use_t8: the
    FRExt 8x8-transform decision (High profile); use_cme: the coarse
    stage (on by default, as the reference's encoder calls it for one
    slice; its own default is off, the tile-row path); force_intra:
    (n_mb,) bool MBs coded intra whatever their cost (intra refresh), or
    None; drift_pen: (n_mb,) int32 added to every inter candidate's J
    (loss-aware RDO), or None.  ``k`` picks the kernel entries (the CUDA
    wrappers by default).

    Returns (host_out flat int32, recon (Y, U, V), next reference entry
    (bank, cpad, col)), all on the device."""
    dev = RD.resolve_device(device)
    NR = banks.shape[0]
    wp = None
    if wp_w is not None:
        wp = (RD._to_i32(wp_w, dev), RD._to_i32(wp_o, dev))
    f = PFrame(RD._to_i32(cur_y, dev), RD._to_i32(cur_u, dev),
               RD._to_i32(cur_v, dev), banks, cpads, H, W, R, qp, qp_c, lam,
               lam_me, NR if nref is None else nref, wp, k, use_t8, use_cme,
               None if force_intra is None
               else RD._to_i32(force_intra, dev) != 0,
               None if drift_pen is None else RD._to_i32(drift_pen, dev))
    for stage in P_STAGES:
        stage(f)
    return p_outputs(f)


P_ENTRIES = ("coarse_search", "ssd_grid8", "sub8_search", "qpel_refine",
             "mc_luma", "mc_chroma", "inter_luma_tq", "inter_chroma_tq",
             "i16_candidate", "strengths", "deblock", "t8_decide")


def entries_of(use_t8: bool) -> tuple:
    """The P entries a picture calls: all of them with the T8 stage,
    every one but ``t8_decide`` without."""
    return P_ENTRIES if use_t8 else P_ENTRIES[:-1]


def recording(k: PKernels):
    """(PKernels that run `k` and record every call of the P entries as
    (name, args), the list they append to): the real inputs of each
    kernel entry, for holding a kernel against its plain version."""
    calls: list = []

    def wrap(name, fn):
        def rec(*args):
            calls.append((name, args))
            return fn(*args)
        return rec

    return PKernels(**{n: (wrap(n, getattr(k, n)) if n in P_ENTRIES
                           else getattr(k, n)) for n in k.names()}), calls
