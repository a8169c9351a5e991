"""Device RD coding of intra pictures, the reference-bank entry, and the
helpers the P pipeline shares.

The PyTorch counterpart of the reference package's encoder/rd.py for the
all-intra path: the wavefront intra commit scan (full-RD I16 vs I4x4 with
9-mode 4x4 decisions against final neighbour recon, lencod/src/rdopt.c:597
Mode_Decision_for_4x4IntraBlocks) and the next-reference entry (edge-padded
recon plus its 6-tap half-pel planes); and the rate, SATD, RDOQ-lite,
thresholding, WP and chroma-MC helpers of ``rd_p.py`` (the P pipeline)
and ``rd_b.py`` (the B pipeline), and the B winner codes.

Every function here is the plain PyTorch version: int32 tensors, the same
arithmetic in the same order as the reference, vectorised over the
macroblocks of one anti-diagonal where the reference ``vmap``s.  The hand-
written CUDA kernels that replace the two device programs on the card
live in ``kernels/`` and are checked against these functions:

- ``kernels.intra_commit``: the whole commit scan (``_intra_scan``);
- ``kernels.ref_bank``: the whole reference entry (``ref_entry_plain``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import quant as Q
from ..ops import transforms as TR

PAD = 32  # reference-plane edge padding (the reference's ops/interp.py PAD)
BIG = 1 << 29  # cost of an unavailable mode
I32 = torch.int32

# B-picture winner codes in host_out (the reference's rd.py:60-62, :1908)
B_DIRECT, B_L0, B_L1, B_BI, B_I16, B_L0_16x8, B_L0_8x16 = 0, 1, 2, 3, 4, 5, 6
B_DIRECT_ZERO = 7  # direct prediction with forced-zero residual (B skip)
B_I4 = 8
B_P8X8 = 9  # per-unit sub-modes (pdir8: 0 L0 / 1 L1 / 2 BI / 3 direct)


# ---------------------------------------------------------------------------
# rate / cost helpers
# ---------------------------------------------------------------------------

def _bitlen(a):
    """floor(log2(a)) + 1 for int32 a >= 1, in integer arithmetic.

    The reference computes floor(log2(float32(a))) + 1, which XLA:CPU
    rounds down at a = 8192 and 32768; no intra level reaches 8192
    (|level| <= 6528: the luma-DC bound at QP 0), and the tests check
    equality exhaustively below it."""
    bounds = torch.tensor([1 << k for k in range(31)], dtype=a.dtype,
                          device=a.device)
    return torch.bucketize(a.contiguous(), bounds, out_int32=True, right=True)


def _coef_bits(lev):
    """Approximate CAVLC bits for one (..., 4, 4) block of levels."""
    a = lev.abs()
    nz = a > 0
    lb = torch.where(nz, 2 * _bitlen(a.clamp(min=1)) + 1, 0).sum(
        (-1, -2), dtype=I32)
    n = nz.sum((-1, -2), dtype=I32)
    return torch.where(n > 0, lb + n + 2, 0)


def _lam_cost(lam, bits):
    """lambda * bits with lambda in <<16 fixed point, overflow-safe: the
    integer and fractional parts of lambda multiply separately, so both
    partial products stay far below 2^31 at every QP."""
    return (lam >> 16) * bits + (((lam & 0xFFFF) * bits) >> 16)


def _mv_bits(d):
    """se(v) code length of d.  On the P path |d| stays below about 1300
    (tests/test_torch_p_ops.py checks the bound), far inside the range
    where the integer `_bitlen` equals the reference's float32 one."""
    k = 2 * d.abs() - (d > 0).to(d.dtype)
    return 2 * _bitlen(k + 1) - 1


def _med3(a, b, c):
    return a + b + c - torch.minimum(a, torch.minimum(b, c)) - torch.maximum(
        a, torch.maximum(b, c))


def _satd(d):
    """Hadamard SATD of (..., h, w) residuals: per 4x4 block
    (sum |hadamard4x4| + 1) >> 1, summed (lencod/src/me_distortion.c:182
    HadamardSAD4x4)."""
    b = d.reshape(*d.shape[:-2], d.shape[-2] // 4, 4,
                  d.shape[-1] // 4, 4).transpose(-3, -2)
    h = TR.hadamard4x4(b)
    return ((h.abs().sum((-1, -2), dtype=I32) + 1) >> 1).sum((-1, -2),
                                                             dtype=I32)


def _wp_affine(x, w, o):
    """Explicit weighted-prediction luma sample transform, logWD = 5
    (spec §8.4.2.3.3)."""
    return (((x * w + 16) >> 5) + o).clamp(0, 255)


def lam_satd_of(lam_me: int) -> int:
    """The refinement's SATD lambda, int32(sqrt(float32(lam_me) * 65536)),
    in float32 and in that order as the reference computes it (rd.py:548):
    float64 would differ at some QPs."""
    return int(np.sqrt(np.float32(lam_me) * np.float32(65536.0)))


# quarter-pel sample = avg of two bank samples (G=0, b=1, h=2, j=3);
# _QTAB[frac] = (plane0, oy0, ox0, plane1, oy1, ox1), frac = (mvy&3)*4+(mvx&3)
# (spec §8.4.2.2.1; the precomputed-plane scheme of lencod/src/img_luma.c)
_QTAB = np.zeros((16, 6), np.int32)
for _dy in range(4):
    for _dx in range(4):
        if (_dx, _dy) == (0, 0):
            _e = (0, 0, 0, 0, 0, 0)
        elif _dy == 0:
            _e = {1: (0, 0, 0, 1, 0, 0), 2: (1, 0, 0, 1, 0, 0),
                  3: (1, 0, 0, 0, 0, 1)}[_dx]
        elif _dx == 0:
            _e = {1: (0, 0, 0, 2, 0, 0), 2: (2, 0, 0, 2, 0, 0),
                  3: (2, 0, 0, 0, 1, 0)}[_dy]
        elif (_dx, _dy) == (2, 2):
            _e = (3, 0, 0, 3, 0, 0)
        elif _dx == 2:
            _e = (1, 0, 0, 3, 0, 0) if _dy == 1 else (3, 0, 0, 1, 1, 0)
        elif _dy == 2:
            _e = (2, 0, 0, 3, 0, 0) if _dx == 1 else (3, 0, 0, 2, 0, 1)
        else:
            _e = (1, (0 if _dy == 1 else 1), 0, 2, 0, (0 if _dx == 1 else 1))
        _QTAB[_dy * 4 + _dx] = _e

# the 49 refinement offsets (dx, dy), dy outer: the tie order of the search
_REFINE = np.asarray(
    [(dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)], np.int32)

# RDOQ-lite constants: inverse 4x4 basis row norms^2 scaled by 4, and the
# diagonal scale tying forward4x4 to the inverse-basis correlation
_RDOQ_N2 = np.outer([16, 10, 16, 10], [16, 10, 16, 10]).astype(np.float32)
_RDOQ_SS = np.outer([2, 1, 2, 1], [2, 1, 2, 1]).astype(np.float32)


def _rdoq4(blk, lev, qp, lam):
    """Per-coefficient soft quantization of (..., 4, 4) level blocks:
    |level| drops by one where Delta-J = Delta-D + lambda * Delta-R < 0.

    float32 in the reference's order, one rounding per operation:
    dD = ((delta * delta) * n2) - (((8 * delta) * F64) * ss), then
    dJ = dD + float32(lam) * float32(bits_m - bits).  blk: pixel
    residuals."""
    deq = Q.dequant4x4(lev, qp)
    levm = torch.where(lev > 0, lev - 1, torch.where(lev < 0, lev + 1, 0))
    deqm = Q.dequant4x4(levm, qp)
    f32 = torch.float32
    delta = (deqm - deq).to(f32)
    err64 = (blk << 6) - TR.inverse4x4(deq)
    F64 = TR.forward4x4(err64).to(f32)
    n2 = torch.as_tensor(_RDOQ_N2, device=lev.device)
    ss = torch.as_tensor(_RDOQ_SS, device=lev.device)
    dD = delta * delta * n2 - 8.0 * delta * F64 * ss
    a = lev.abs()
    bits = torch.where(a > 0, 2 * _bitlen(a.clamp(min=1)) + 2, 0)
    am = levm.abs()
    bits_m = torch.where(am > 0, 2 * _bitlen(am.clamp(min=1)) + 2, 0)
    lam32 = torch.tensor(int(lam), dtype=torch.int32).to(f32).to(lev.device)
    dJ = dD + lam32 * (bits_m - bits).to(f32)
    return torch.where((a > 0) & (dJ < 0), levm, lev)


# JM single-coefficient cost by run length (lencod/inc/block.h:45
# COEFF_COST4x4[0]); |level| > 1 counts as 9
_COEFF_COST_RUN = [3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
_ZZ4_RASTER = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]


def _block4_coeff_cost(lev, first: int = 0):
    """JM coeff_cost of (..., 4, 4) level blocks (lencod/src/block.c:899);
    `first` is the first zig-zag position coded (1 for AC blocks)."""
    dev = lev.device
    flat = lev.reshape(*lev.shape[:-2], 16)
    L = flat[..., torch.as_tensor(_ZZ4_RASTER, device=dev)][..., first:]
    nz = L != 0
    n = 16 - first
    idx = torch.arange(n, dtype=I32, device=dev)
    marked = torch.where(nz, idx, -1)
    prev_incl = torch.cummax(marked, dim=-1).values
    prev_excl = torch.cat([torch.full((*L.shape[:-1], 1), -1, dtype=I32,
                                      device=dev), prev_incl[..., :-1]], -1)
    run = idx - prev_excl - 1
    costs = torch.as_tensor(_COEFF_COST_RUN, dtype=I32, device=dev)
    cost = torch.where(L.abs() > 1, 9, costs[run.long()])
    return torch.where(nz, cost, 0).sum(-1, dtype=I32)


def _threshold_inter_luma(lev, rec, pred, orig):
    """JM inter-luma coefficient thresholding (macroblock.c:1236/:1386):
    per 8x8, drop all four 4x4 blocks when their summed coeff_cost is <= 4;
    then drop the MB's luma when the surviving total is <= 5.  Dropped
    blocks reconstruct as the clipped prediction.

    lev: (..., 4, 4, 4, 4) [brow, bcol, y, x]; rec/pred/orig (..., 16, 16).
    Returns (lev, rec, D8 (..., 4), cb8 (..., 4)): SSD and coefficient bits
    per 8x8 (b8 = 2 * by + bx); the MB's are their sums."""
    cost4 = _block4_coeff_cost(lev)                        # (..., 4, 4)
    c8 = cost4.reshape(*cost4.shape[:-2], 2, 2, 2, 2).sum((-3, -1),
                                                           dtype=I32)
    drop8 = c8 <= 4
    kept8 = torch.where(drop8, 0, c8)
    drop_mb = kept8.sum((-1, -2), dtype=I32) <= 5
    drop4 = (drop8.repeat_interleave(2, -1).repeat_interleave(2, -2)
             | drop_mb[..., None, None])
    lev = torch.where(drop4[..., None, None], 0, lev)
    pb = pred.reshape(*pred.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    rb = rec.reshape(*rec.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    rb = torch.where(drop4[..., None, None], pb.clamp(0, 255), rb)
    rec = rb.transpose(-3, -2).reshape(pred.shape)
    d = orig - rec
    q = (d * d).reshape(*d.shape[:-2], 2, 8, 2, 8)
    D8 = q.sum((-3, -1), dtype=I32).reshape(*d.shape[:-2], 4)
    cb8 = (_coef_bits(lev).reshape(*lev.shape[:-4], 2, 2, 2, 2)
           .sum((-3, -1), dtype=I32).reshape(*lev.shape[:-4], 4))
    return lev, rec, D8, cb8


def _mc_chroma_unit(cpads, r, mvx, mvy, yc, xc, h: int, w: int,
                    pad: int = PAD):
    """1/8-pel bilinear chroma MC of n (h, w) units for both planes.
    cpads (NR, 2, Hcp, Wcp); r, mvx, mvy, yc, xc: (n,) int tensors, the
    unit origins in chroma picture coordinates.  Samples outside the
    padded planes repeat their edge (the reference's further edge-padded
    planes).  Returns (n, 2, h, w)."""
    dev = cpads.device
    Hcp, Wcp = cpads.shape[-2:]
    yi = yc + (mvy >> 3) + pad
    xi = xc + (mvx >> 3) + pad
    fx = (mvx & 7)[:, None, None, None]
    fy = (mvy & 7)[:, None, None, None]
    ay = (yi[:, None] + torch.arange(h + 1, device=dev)).clamp(0, Hcp - 1)
    ax = (xi[:, None] + torch.arange(w + 1, device=dev)).clamp(0, Wcp - 1)
    ch = torch.arange(2, device=dev)
    A = cpads[r.long()[:, None, None, None], ch[None, :, None, None],
              ay.long()[:, None, :, None], ax.long()[:, None, None, :]]
    return ((8 - fx) * (8 - fy) * A[..., :h, :w]
            + fx * (8 - fy) * A[..., :h, 1:]
            + (8 - fx) * fy * A[..., 1:, :w]
            + fx * fy * A[..., 1:, 1:] + 32) >> 6


# ---------------------------------------------------------------------------
# I16 helpers (batched over n macroblocks)
# ---------------------------------------------------------------------------

def _i16_pred_all(up, left, ul, au, al, orig):
    """All-mode I16 prediction + Hadamard mode pick.  up/left: (n, 16),
    ul: (n,), au/al: (n,) bool, orig: (n, 16, 16).
    Returns (pred (n, 16, 16), mode (n,))."""
    n = up.shape[0]
    dev = up.device
    vert = up[:, None, :].expand(n, 16, 16)
    hor = left[:, :, None].expand(n, 16, 16)
    s_up = up.sum(-1, dtype=I32)
    s_l = left.sum(-1, dtype=I32)
    dc = torch.where(
        au & al, (s_up + s_l + 16) >> 5,
        torch.where(au, (s_up + 8) >> 4,
                    torch.where(al, (s_l + 8) >> 4, 128)))
    dcp = dc[:, None, None].expand(n, 16, 16)
    # plane mode (spec §8.3.3.4): p[-1, 6-i] for i < 7, the corner for i = 7
    w = torch.arange(1, 9, dtype=I32, device=dev)
    upb = torch.cat([up[:, :7].flip(-1), ul[:, None]], 1)
    Hg = (w * (up[:, 8:] - upb)).sum(-1, dtype=I32)
    lfb = torch.cat([left[:, :7].flip(-1), ul[:, None]], 1)
    Vg = (w * (left[:, 8:] - lfb)).sum(-1, dtype=I32)
    a = 16 * (left[:, 15] + up[:, 15])
    b = (5 * Hg + 32) >> 6
    c = (5 * Vg + 32) >> 6
    xs = torch.arange(16, dtype=I32, device=dev) - 7
    pl = (a[:, None, None] + b[:, None, None] * xs[None, None, :]
          + c[:, None, None] * xs[None, :, None] + 16) >> 5
    plane = pl.clamp(0, 255)
    preds = torch.stack([vert, hor, dcp, plane], 1)  # (n, 4, 16, 16)
    # JM mode pick is Hadamard SATD with the block DCs re-transformed
    # separately (lencod/src/intra16x16.c find_sad_16x16)
    d = orig[:, None] - preds
    blk = d.reshape(n, 4, 4, 4, 4, 4).transpose(-3, -2)
    h = TR.hadamard4x4(blk)
    ac = h.abs().sum((-1, -2), dtype=I32) - h[..., 0, 0].abs()
    hdc = TR.hadamard4x4(h[..., 0, 0])
    sad = (ac.sum((-1, -2), dtype=I32)
           + hdc.abs().sum((-1, -2), dtype=I32)) >> 1
    valid = torch.stack([au, al, torch.ones_like(au), au & al], 1)
    sad = torch.where(valid, sad, BIG)
    mode = sad.argmin(1)
    pred = preds[torch.arange(n, device=dev), mode]
    return pred, mode.to(I32)


def _i16_tq(pred, orig, qp):
    """I16 transform path: DC Hadamard + AC quant (JM dct_16x16,
    lencod/src/block.c:564).  pred/orig: (..., 16, 16).
    Returns (lev (..., 4, 4, 4, 4), dc_lev (..., 4, 4), rec, D, coefbits)."""
    res = orig - pred
    blk = res.reshape(*res.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    co = TR.forward4x4(blk)
    dch = TR.hadamard4x4(co[..., 0, 0]) >> 1
    dc_lev = Q.quant_luma_dc(dch, qp, intra=True)
    lev = Q.quant4x4(co, qp, Q.default_offset4(qp, True))
    lev[..., 0, 0] = 0
    deq = Q.dequant4x4(lev, qp)
    deq[..., 0, 0] = Q.dequant_luma_dc(TR.hadamard4x4(dc_lev), qp)
    rr = TR.inverse4x4(deq)
    pb = pred.reshape(*pred.shape[:-2], 4, 4, 4, 4).transpose(-3, -2)
    rec_b = ((rr + (pb << 6) + 32) >> 6).clamp(0, 255)
    rec = rec_b.transpose(-3, -2).reshape(pred.shape)
    d = orig - rec
    D_ = (d * d).sum((-1, -2), dtype=I32)
    cb = (_coef_bits(lev).sum((-1, -2), dtype=I32)
          + _coef_bits(dc_lev[..., None, :, :])[..., 0])
    return lev, dc_lev, rec, D_, cb


def _chroma_tq(pred, orig, qp_c, intra: bool = True, lam=None):
    """Chroma residual path per MB: pred/orig (..., 2, 8, 8).
    Returns levels (..., 2, 2, 2, 4, 4), dc (..., 2, 2, 2), recon
    (..., 2, 8, 8).  Inter (``intra=False``) rounds with the inter offset
    and drops a component's AC when its JM coeff_cost is below 4
    (block.c:1384); ``lam`` adds RDOQ-lite on the AC."""
    res = orig - pred
    blk = res.reshape(*res.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    co = TR.forward4x4(blk)
    dc_lev = Q.quant_chroma_dc(TR.hadamard2x2(co[..., 0, 0]), qp_c, intra)
    lev = Q.quant4x4(co, qp_c, Q.default_offset4(qp_c, intra))
    lev[..., 0, 0] = 0
    if lam is not None:
        lev = _rdoq4(blk, lev, qp_c, lam)
        lev[..., 0, 0] = 0
    if not intra:
        ac_cost = _block4_coeff_cost(lev, first=1).sum((-1, -2), dtype=I32)
        lev = torch.where((ac_cost < 4)[..., None, None, None, None], 0, lev)
    deq = Q.dequant4x4(lev, qp_c)
    deq[..., 0, 0] = Q.dequant_chroma_dc(TR.hadamard2x2(dc_lev), qp_c)
    rr = TR.inverse4x4(deq)
    pb = pred.reshape(*pred.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    rec_b = ((rr + (pb << 6) + 32) >> 6).clamp(0, 255)
    rec = rec_b.transpose(-3, -2).reshape(pred.shape)
    return lev, dc_lev, rec


# 4x4 block decode order (z-order) -> (bx, by), and internal up-right
# availability: for by > 0 the up-right block must precede in decode
# order (spec §6.4.8 via mb_access semantics)
_BLK4_XY = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
            (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]
_XY_TO_BLK = {xy: k for k, xy in enumerate(_BLK4_XY)}
_I4_AUR_INT = [
    (by > 0 and bx < 3 and _XY_TO_BLK[(bx + 1, by - 1)] < blk)
    for blk, (bx, by) in enumerate(_BLK4_XY)
]


def _i4_pred9(up, ur, left, X, au, al, aul, aur):
    """All nine 4x4 intra predictions (spec §8.3.1.2) for n blocks.
    up/ur/left: (n, 4) int32; X: (n,); a*: (n,) bool.
    Returns (preds (n, 9, 4, 4), valid (n, 9))."""
    n = up.shape[0]
    upv = torch.where(au[:, None], up, 128)
    A, B, C, D = upv.unbind(-1)
    urv = torch.where(aur[:, None], ur, D[:, None])
    E, F, G_, H_ = urv.unbind(-1)
    lfv = torch.where(al[:, None], left, 128)
    I, J, K, L = lfv.unbind(-1)
    Xv = torch.where(aul, X, 128)

    def m(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    vert = upv[:, None, :].expand(n, 4, 4)
    hor = lfv[:, :, None].expand(n, 4, 4)
    dc = torch.where(
        au & al, (A + B + C + D + I + J + K + L + 4) >> 3,
        torch.where(al, (I + J + K + L + 2) >> 2,
                    torch.where(au, (A + B + C + D + 2) >> 2, 128)))
    dcp = dc[:, None, None].expand(n, 4, 4)
    d0 = (A + C + 2 * B + 2) >> 2
    d1 = (B + D + 2 * C + 2) >> 2
    d2 = (C + E + 2 * D + 2) >> 2
    d3 = (D + F + 2 * E + 2) >> 2
    d4 = (E + G_ + 2 * F + 2) >> 2
    d5 = (F + H_ + 2 * G_ + 2) >> 2
    d6 = (G_ + 3 * H_ + 2) >> 2
    ddl = m([[d0, d1, d2, d3], [d1, d2, d3, d4],
             [d2, d3, d4, d5], [d3, d4, d5, d6]])
    r0 = (L + 2 * K + J + 2) >> 2
    r1 = (K + 2 * J + I + 2) >> 2
    r2 = (J + 2 * I + Xv + 2) >> 2
    r3 = (I + 2 * Xv + A + 2) >> 2
    r4 = (Xv + 2 * A + B + 2) >> 2
    r5 = (A + 2 * B + C + 2) >> 2
    r6 = (B + 2 * C + D + 2) >> 2
    ddr = m([[r3, r4, r5, r6], [r2, r3, r4, r5],
             [r1, r2, r3, r4], [r0, r1, r2, r3]])
    v0 = (Xv + A + 1) >> 1
    v1 = (A + B + 1) >> 1
    v2 = (B + C + 1) >> 1
    v3 = (C + D + 1) >> 1
    v4 = (I + 2 * Xv + A + 2) >> 2
    v5 = (Xv + 2 * A + B + 2) >> 2
    v6 = (A + 2 * B + C + 2) >> 2
    v7 = (B + 2 * C + D + 2) >> 2
    v8 = (Xv + 2 * I + J + 2) >> 2
    v9 = (I + 2 * J + K + 2) >> 2
    vr = m([[v0, v1, v2, v3], [v4, v5, v6, v7],
            [v8, v0, v1, v2], [v9, v4, v5, v6]])
    l0 = (A + B + 1) >> 1
    l1 = (B + C + 1) >> 1
    l2 = (C + D + 1) >> 1
    l3 = (D + E + 1) >> 1
    l4 = (E + F + 1) >> 1
    l5 = (A + 2 * B + C + 2) >> 2
    l6 = (B + 2 * C + D + 2) >> 2
    l7 = (C + 2 * D + E + 2) >> 2
    l8 = (D + 2 * E + F + 2) >> 2
    l9 = (E + 2 * F + G_ + 2) >> 2
    vl = m([[l0, l1, l2, l3], [l5, l6, l7, l8],
            [l1, l2, l3, l4], [l6, l7, l8, l9]])
    u0 = (I + J + 1) >> 1
    u1 = (I + 2 * J + K + 2) >> 2
    u2 = (J + K + 1) >> 1
    u3 = (J + 2 * K + L + 2) >> 2
    u4 = (K + L + 1) >> 1
    u5 = (K + 3 * L + 2) >> 2
    hu = m([[u0, u1, u2, u3], [u2, u3, u4, u5],
            [u4, u5, L, L], [L, L, L, L]])
    h0 = (Xv + I + 1) >> 1
    h1 = (I + 2 * Xv + A + 2) >> 2
    h2 = (Xv + 2 * A + B + 2) >> 2
    h3 = (A + 2 * B + C + 2) >> 2
    h4 = (I + J + 1) >> 1
    h5 = (Xv + 2 * I + J + 2) >> 2
    h6 = (J + K + 1) >> 1
    h7 = (I + 2 * J + K + 2) >> 2
    h8 = (K + L + 1) >> 1
    h9 = (J + 2 * K + L + 2) >> 2
    hd = m([[h0, h1, h2, h3], [h4, h5, h0, h1],
            [h6, h7, h4, h5], [h8, h9, h6, h7]])
    preds = torch.stack([vert, hor, dcp, ddl, ddr, vr, hd, vl, hu], 1)
    T = torch.ones_like(au)
    a3 = au & al & aul
    valid = torch.stack([au, al, T, au, a3, a3, a3, au, al], 1)
    return preds, valid


def _chroma_pred4(up, left, ul, au, al):
    """The 4 chroma pred modes of n 8x8 4:2:0 MBs; up/left: (n, 2, 8),
    ul: (n, 2), au/al: (n,) bool.  Returns (n, 4, 2, 8, 8) in JM mode
    numbering [DC, HOR, VERT, PLANE]."""
    n = up.shape[0]
    dev = up.device
    u0, u1 = up[..., :4].sum(-1, dtype=I32), up[..., 4:].sum(-1, dtype=I32)
    l0, l1 = left[..., :4].sum(-1, dtype=I32), left[..., 4:].sum(-1, dtype=I32)
    au_, al_ = au[:, None], al[:, None]
    both = au_ & al_
    # corner classes: TL/BR avg both; TR prefers up; BL prefers left
    tl = torch.where(both, (u0 + l0 + 4) >> 3,
                     torch.where(au_, (u0 + 2) >> 2,
                                 torch.where(al_, (l0 + 2) >> 2, 128)))
    tr = torch.where(au_, (u1 + 2) >> 2,
                     torch.where(al_, (l0 + 2) >> 2, 128))
    bl = torch.where(al_, (l1 + 2) >> 2,
                     torch.where(au_, (u0 + 2) >> 2, 128))
    br = torch.where(both, (u1 + l1 + 4) >> 3,
                     torch.where(au_, (u1 + 2) >> 2,
                                 torch.where(al_, (l1 + 2) >> 2, 128)))
    dcq = torch.stack([torch.stack([tl, tr], -1),
                       torch.stack([bl, br], -1)], -2)  # (n, 2, 2, 2)
    dc = dcq.repeat_interleave(4, -1).repeat_interleave(4, -2)
    hor = left[..., :, None].expand(n, 2, 8, 8)
    vert = up[..., None, :].expand(n, 2, 8, 8)
    w = torch.arange(1, 5, dtype=I32, device=dev)
    ub = torch.cat([up[..., :3].flip(-1), ul[..., None]], -1)
    Hg = (w * (up[..., 4:] - ub)).sum(-1, dtype=I32)
    lb = torch.cat([left[..., :3].flip(-1), ul[..., None]], -1)
    Vg = (w * (left[..., 4:] - lb)).sum(-1, dtype=I32)
    a = 16 * (left[..., 7] + up[..., 7])
    b = (34 * Hg + 32) >> 6
    cc = (34 * Vg + 32) >> 6
    xs = torch.arange(8, dtype=I32, device=dev) - 3
    pl = ((a[..., None, None] + b[..., None, None] * xs[None, :]
           + cc[..., None, None] * xs[:, None] + 16) >> 5).clamp(0, 255)
    return torch.stack([dc, hor, vert, pl], 1)


# I4 rate-model calibration vs real CABAC costs (the reference's values):
# non-MPM mode signalling costs more than the nominal 1+3 bins; coefficient
# bits cost less than the CAVLC-shaped _coef_bits estimate (x3/4).
_I4_NONMPM = 4
_I4_NONMPM_RARE = 9
_I4_COEF_NUM = 3


# ---------------------------------------------------------------------------
# the wavefront intra commit scan
# ---------------------------------------------------------------------------

@dataclass
class IntraScan:
    """Inputs and carry of one picture's intra commit scan: int32 tensors
    on one device (``is_intra`` bool).  The scan updates the carry in
    place: the plain version one anti-diagonal at a time, the CUDA kernel
    one MB row per block, each MB once the row above is two MBs ahead.

    Carry layout as in the reference: ``Yp`` (H+1, W+5) has a 1-pel
    top/left border and a 4-pel right margin for up-right reads; ``Up``/
    ``Vp`` (H/2+1, W/2+1) a 1-pel border; ``ipm`` (4n_my+1, 4n_mx+1) the
    per-4x4 intra modes (-1 outside the picture, DC for non-I4 MBs)."""

    n_my: int
    n_mx: int
    qp: int
    qp_c: int
    lam: int
    cur_y: torch.Tensor
    cur_u: torch.Tensor
    cur_v: torch.Tensor
    w_rec: torch.Tensor
    recc: torch.Tensor
    is_intra: torch.Tensor
    Yp: torch.Tensor
    Up: torch.Tensor
    Vp: torch.Tensor
    ipm: torch.Tensor
    w_lev: torch.Tensor
    levc: torch.Tensor
    dcc: torch.Tensor
    lum_dc: torch.Tensor
    i16mode: torch.Tensor
    cip: torch.Tensor
    i4flag: torch.Tensor

    @property
    def steps(self) -> int:
        """Anti-diagonals t = 2r + c.  MB (r, c) depends on (r, c-1),
        (r-1, c) and (r-1, c+1), committed at t-1, t-2 and t-1, so each
        anti-diagonal commits in parallel: 2*n_my + n_mx - 1 steps
        instead of n_mb (the reference's count: the last MB sits at
        t = 2*n_my + n_mx - 3, so the last step is empty, and with
        n_mx == 1 so is every odd one)."""
        return 2 * self.n_my + self.n_mx - 1

    def lanes(self, t: int):
        """(first row, number of MBs) of anti-diagonal t; its MBs are
        rows r0, r0+1, ... at column t - 2r."""
        r0 = max(0, (t - self.n_mx + 2) // 2)
        return r0, min(self.n_my - 1, t // 2) - r0 + 1


def _scan_start(cur_y, cur_u, cur_v, w_rec, recc, is_intra, w_lev, levc,
                dcc, H: int, W: int, qp: int, qp_c: int, lam: int):
    n_my, n_mx = H // 16, W // 16
    n_mb = n_my * n_mx
    dev = cur_y.device

    def z(*shape, fill=0):
        return torch.full(shape, fill, dtype=I32, device=dev)

    return IntraScan(
        n_my=n_my, n_mx=n_mx, qp=int(qp), qp_c=int(qp_c), lam=int(lam),
        cur_y=cur_y, cur_u=cur_u, cur_v=cur_v, w_rec=w_rec, recc=recc,
        is_intra=is_intra,
        Yp=z(H + 1, W + 5), Up=z(H // 2 + 1, W // 2 + 1),
        Vp=z(H // 2 + 1, W // 2 + 1), ipm=z(4 * n_my + 1, 4 * n_mx + 1, fill=-1),
        w_lev=w_lev.clone(), levc=levc.clone(), dcc=dcc.clone(),
        lum_dc=z(n_mb, 4, 4), i16mode=z(n_mb), cip=z(n_mb), i4flag=z(n_mb))


def _gather2(plane, y0, x0, h: int, w: int):
    """(n, h, w) tiles of `plane` at per-lane origins (y0, x0) (n,)."""
    dev = plane.device
    ay = torch.arange(h, device=dev)
    ax = torch.arange(w, device=dev)
    return plane[y0[:, None, None] + ay[:, None], x0[:, None, None] + ax]


def _i4_decide(s: IntraScan, y0, x0, r, c, au, al, avc, orig):
    """Sequential 16-block I4 decision + recon for the lanes of one
    diagonal.  Returns (rec (n,16,16), lev (n,4,4,4,4), D, bits, modes
    (n,4,4))."""
    n = r.shape[0]
    dev = r.device
    ar = torch.arange(n, device=dev)
    true = torch.ones(n, dtype=torch.bool, device=dev)
    # workspace: rows y0..y0+16, cols x0..x0+20 of the padded plane (the
    # 1-pel top/left border included); mode window of the 4x4 grid
    work = _gather2(s.Yp, y0, x0, 17, 21)
    mwork = _gather2(s.ipm, 4 * r, 4 * c, 5, 5)
    lev_mb = torch.zeros((n, 4, 4, 4, 4), dtype=I32, device=dev)
    D_tot = torch.zeros(n, dtype=I32, device=dev)
    bits = torch.zeros(n, dtype=I32, device=dev)
    off = Q.default_offset4(s.qp, True)
    m9 = torch.arange(9, device=dev)
    for blk, (bx, by) in enumerate(_BLK4_XY):
        px, py = 1 + 4 * bx, 1 + 4 * by
        up = work[:, py - 1, px : px + 4]
        urr = work[:, py - 1, px + 4 : px + 8]
        lf = work[:, py : py + 4, px - 1]
        X = work[:, py - 1, px - 1]
        au_b = au if by == 0 else true
        al_b = al if bx == 0 else true
        if by == 0:
            aur_b = (au & avc) if bx == 3 else au
        else:
            aur_b = true if _I4_AUR_INT[blk] else ~true
        if bx > 0 and by > 0:
            aul_b = true
        elif bx == 0 and by == 0:
            aul_b = au & al
        elif bx == 0:
            aul_b = al
        else:
            aul_b = au
        preds, valid = _i4_pred9(up, urr, lf, X, au_b, al_b, aul_b, aur_b)
        # most probable mode (decoder rule)
        lm = mwork[:, 1 + by, bx]
        um = mwork[:, by, 1 + bx]
        mpm = torch.where((lm < 0) | (um < 0), 2, torch.minimum(lm, um))
        ob = orig[:, 4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4][:, None]
        # full RD over all nine modes: T/Q/IQ/IT every candidate, charge
        # true recon SSD + lambda * (mode + coefficient bits)
        lev9 = Q.quant4x4(TR.forward4x4(ob - preds), s.qp, off)
        rr9 = TR.inverse4x4(Q.dequant4x4(lev9, s.qp))
        rec9 = ((rr9 + (preds << 6) + 32) >> 6).clamp(0, 255)
        dd9 = ob - rec9
        ssd9 = (dd9 * dd9).sum((-1, -2), dtype=I32)
        mb_bits = torch.where(
            m9 == mpm[:, None], 1,
            torch.where(m9 < 3, _I4_NONMPM, _I4_NONMPM_RARE)).to(I32)
        rate9 = (_coef_bits(lev9) * _I4_COEF_NUM) // 4 + mb_bits
        costs = torch.where(valid, ssd9 + _lam_cost(s.lam, rate9), BIG)
        mode = costs.argmin(1)
        D_tot += ssd9[ar, mode]
        bits += rate9[ar, mode]
        lev_mb[:, by, bx] = lev9[ar, mode]
        work[:, py : py + 4, px : px + 4] = rec9[ar, mode]
        mwork[:, 1 + by, 1 + bx] = mode.to(I32)
    return work[:, 1:, 1:17], lev_mb, D_tot, bits, mwork[:, 1:, 1:]


def _intra_commit_mbs(s: IntraScan, r, c) -> None:
    """Decide + reconstruct the MBs (r, c) (int64 tensors) against final
    neighbour recon (decoder semantics; the batched analog of
    rdopt.c:597), then scatter their tiles into the carry.  Non-intra MBs
    copy their inter results through.  Every MB's left, up-left, up and
    up-right neighbours must be committed, and no two of the MBs may be
    neighbours (their footprints then do not overlap)."""
    n = r.shape[0]
    dev = s.Yp.device
    n_mx = s.n_mx
    ids = r * n_mx + c
    y0, x0 = 16 * r, 16 * c
    yc, xc = 8 * r, 8 * c
    au = r > 0
    al = c > 0
    avc = c < n_mx - 1
    ar = torch.arange(n, device=dev)
    orig = _gather2(s.cur_y, y0, x0, 16, 16)

    # I16: mode pick by Hadamard cost, then transform/quant/recon
    a16 = torch.arange(16, device=dev)
    up = s.Yp[y0[:, None], x0[:, None] + 1 + a16]
    left = s.Yp[y0[:, None] + 1 + a16, x0[:, None]]
    ul = s.Yp[y0, x0]
    pred, mode = _i16_pred_all(up, left, ul, au, al, orig)
    lev, dclev, rec, D16, cb16 = _i16_tq(pred, orig, s.qp)
    J16 = D16 + _lam_cost(s.lam, (cb16 * _I4_COEF_NUM) // 4 + 8)
    rec4, lev4, D4, cb4, modes4 = _i4_decide(s, y0, x0, r, c, au, al, avc,
                                             orig)
    J4 = D4 + _lam_cost(s.lam, cb4 + 9)
    use4 = J4 < J16
    rec = torch.where(use4[:, None, None], rec4, rec)
    lev = torch.where(use4[:, None, None, None, None], lev4, lev)
    dclev = torch.where(use4[:, None, None], 0, dclev)
    modes4 = torch.where(use4[:, None, None], modes4, 2)

    # chroma: full RD over the four modes vs recon neighbours; mode bits
    # follow the intra_chroma_pred_mode binarization (1/2/3/3 bins)
    a8 = torch.arange(8, device=dev)
    upc = torch.stack([P[yc[:, None], xc[:, None] + 1 + a8]
                       for P in (s.Up, s.Vp)], 1)
    lfc = torch.stack([P[yc[:, None] + 1 + a8, xc[:, None]]
                       for P in (s.Up, s.Vp)], 1)
    ulc = torch.stack([s.Up[yc, xc], s.Vp[yc, xc]], 1)
    cpreds = _chroma_pred4(upc, lfc, ulc, au, al)  # (n, 4, 2, 8, 8)
    oc = torch.stack([_gather2(P, yc, xc, 8, 8)
                      for P in (s.cur_u, s.cur_v)], 1)
    oc4 = oc[:, None].expand(n, 4, 2, 8, 8)
    clev4, cdc4, crec4 = _chroma_tq(cpreds, oc4, s.qp_c)
    dc_ = oc4 - crec4
    cD = (dc_ * dc_).sum((-1, -2, -3), dtype=I32)
    adc = cdc4.abs()
    dcb = torch.where(adc > 0, 2 * _bitlen(adc.clamp(min=1)) + 1, 0).sum(
        (-1, -2, -3), dtype=I32)
    ccb = _coef_bits(clev4).sum((-1, -2, -3), dtype=I32) + dcb
    cmb = torch.tensor([1, 2, 3, 3], dtype=I32, device=dev)
    cvalid = torch.stack([torch.ones_like(au), al, au, au & al], 1)
    cJ = torch.where(
        cvalid, cD + _lam_cost(s.lam, (ccb * _I4_COEF_NUM) // 4 + cmb), BIG)
    cmode = cJ.argmin(1)
    crec, clev, cdc = crec4[ar, cmode], clev4[ar, cmode], cdc4[ar, cmode]

    # inter MBs: copy the candidate results through
    intra = s.is_intra[ids]

    def sel(a, b):
        return torch.where(intra.view(-1, *([1] * (a.dim() - 1))), a, b)

    rec = sel(rec, s.w_rec[ids])
    crec = sel(crec, s.recc[ids])
    lev = sel(lev, s.w_lev[ids])
    clev = sel(clev, s.levc[ids])
    cdc = sel(cdc, s.dcc[ids])
    dclev = sel(dclev, torch.zeros_like(dclev))
    mode = sel(mode, torch.zeros_like(mode))
    cmode = sel(cmode.to(I32), torch.zeros_like(mode))
    use4 = (intra & use4).to(I32)
    modes4 = sel(modes4, torch.full_like(modes4, 2))

    # scatter (the footprints of one diagonal's MBs do not overlap)
    a4 = torch.arange(4, device=dev)
    s.Yp[(y0 + 1)[:, None, None] + a16[:, None],
         (x0 + 1)[:, None, None] + a16] = rec
    iyc = (yc + 1)[:, None, None] + a8[:, None]
    ixc = (xc + 1)[:, None, None] + a8
    s.Up[iyc, ixc] = crec[:, 0]
    s.Vp[iyc, ixc] = crec[:, 1]
    s.ipm[(4 * r + 1)[:, None, None] + a4[:, None],
          (4 * c + 1)[:, None, None] + a4] = modes4
    s.w_lev[ids] = lev
    s.levc[ids] = clev
    s.dcc[ids] = cdc
    s.lum_dc[ids] = dclev
    s.i16mode[ids] = mode
    s.cip[ids] = cmode
    s.i4flag[ids] = use4


def _intra_step(s: IntraScan, t: int) -> None:
    """One wavefront step, plain version: commit every MB of
    anti-diagonal t (the reference's `step`)."""
    r0, n = s.lanes(t)
    r = r0 + torch.arange(n, device=s.Yp.device)
    _intra_commit_mbs(s, r, t - 2 * r)


def _intra_mb(s: IntraScan, r: int, c: int) -> None:
    """Commit the one MB (r, c), plain version: the unit of an order
    other than the reference's anti-diagonals (the CUDA kernel commits
    MB rows, each as soon as the row above is two MBs ahead)."""
    one = torch.ones(1, dtype=torch.int64, device=s.Yp.device)
    _intra_commit_mbs(s, r * one, c * one)


def _intra_scan(s: IntraScan) -> None:
    """The whole scan, plain version: the reference's anti-diagonal
    steps in order."""
    for t in range(s.steps):
        _intra_step(s, t)


def _intra_commit_scan(cur_y, cur_u, cur_v, w_rec, recc, is_intra, w_lev,
                       levc, dcc, H: int, W: int, qp: int, qp_c: int,
                       lam=0, impl=None):
    """Wavefront commit: assemble the recon planes; intra MBs are
    re-decided (I16 vs I4x4, per-block 9-mode decision against final
    neighbour recon) and reconstructed in place.

    All tensors int32 on one device (``is_intra`` bool).  ``impl`` runs
    the whole scan on the state; by default the ``kernels.intra_commit``
    wrapper, which launches the CUDA kernel once on a CUDA device and
    runs ``_intra_scan`` on the CPU.  Returns (recon_y, recon_u, recon_v,
    lev, lum_dc, i16mode, cip, levc, dcc, i4flag, ipm)."""
    if impl is None:
        from ..kernels.intra_commit import intra_commit_scan as impl
    s = _scan_start(cur_y, cur_u, cur_v, w_rec, recc, is_intra, w_lev, levc,
                    dcc, H, W, qp, qp_c, lam)
    impl(s)
    return (s.Yp[1:, 1 : W + 1], s.Up[1:, 1:], s.Vp[1:, 1:], s.w_lev,
            s.lum_dc, s.i16mode, s.cip, s.levc, s.dcc, s.i4flag,
            s.ipm[1:, 1:])


def wrap_i32(x) -> torch.Tensor:
    """An int64 tensor as int32 with two's-complement wrap (XLA's int32
    arithmetic)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(I32)


def _to_i32(x, dev: torch.device) -> torch.Tensor:
    """A host array or tensor as a contiguous int32 tensor on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.ascontiguousarray(x))
    return x.to(dev).to(I32).contiguous()


def rd_i_pipeline(cur_y, cur_u, cur_v, qp, qp_c, lam, H: int, W: int,
                  device=None, impl=None):
    """Whole-picture intra (I/IDR) coding: the commit scan with every MB
    intra — full-RD I16-vs-I4 with 9-mode 4x4 decisions.  Inputs are
    uint8 (or int32) planes, host or device; qp/qp_c/lam ints or 0-d
    tensors.  Runs on `device` (CUDA unless told otherwise).

    Returns (recon_y, recon_u, recon_v, lev, lum_dc, i16mode, cip,
    levc, dcc, i4flag, ipm), int32 tensors on the device."""
    dev = resolve_device(device)
    n_mb = (H // 16) * (W // 16)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    return _intra_commit_scan(
        _to_i32(cur_y, dev), _to_i32(cur_u, dev), _to_i32(cur_v, dev),
        z(n_mb, 16, 16), z(n_mb, 2, 8, 8),
        torch.ones(n_mb, dtype=torch.bool, device=dev),
        z(n_mb, 4, 4, 4, 4), z(n_mb, 2, 2, 2, 4, 4), z(n_mb, 2, 2, 2),
        H=H, W=W, qp=int(qp), qp_c=int(qp_c), lam=int(lam), impl=impl)


# ---------------------------------------------------------------------------
# reference resources
# ---------------------------------------------------------------------------

def _edge_pad(x, pad: int = PAD):
    """Edge-replicating pad of a 2-D tensor by `pad` on every side."""
    H, W = x.shape
    iy = torch.arange(-pad, H + pad, device=x.device).clamp(0, H - 1)
    ix = torch.arange(-pad, W + pad, device=x.device).clamp(0, W - 1)
    return x.index_select(0, iy).index_select(1, ix)


def _bank_from_pad(Ypad):
    """(4, Hp, Wp) bank [G, b, h, j], all indexed in G coordinates: the
    half-pel planes are shifted so bank[k, y, x] is the half-pel sample
    whose nearest full pel is (y, x), and are zero on a 2/3-sample border.
    int32 throughout: the 6-tap intermediates stay below 2^20."""
    P = Ypad

    def c6_h(A):
        return (A[:, 0:-5] - 5 * A[:, 1:-4] + 20 * A[:, 2:-3]
                + 20 * A[:, 3:-2] - 5 * A[:, 4:-1] + A[:, 5:])

    def c6_v(A):
        return (A[0:-5] - 5 * A[1:-4] + 20 * A[2:-3]
                + 20 * A[3:-2] - 5 * A[4:-1] + A[5:])

    b1 = c6_h(P)
    h1 = c6_v(P)
    j1 = c6_v(b1)
    b = ((b1[2:-3, :] + 16) >> 5).clamp(0, 255)
    h = ((h1[:, 2:-3] + 16) >> 5).clamp(0, 255)
    j = ((j1 + 512) >> 10).clamp(0, 255)
    # b/h/j[y, x] correspond to full-pel (y+2, x+2): shift by +2 (pad 2/3)
    out = torch.zeros((4, *P.shape), dtype=I32, device=P.device)
    out[0] = P
    for k, x in ((1, b), (2, h), (3, j)):
        out[k, 2:-3, 2:-3] = x
    return out


def ref_entry_plain(Y, U, V):
    """Plain version of the reference entry: int32 recon planes Y (H, W),
    U/V (H/2, W/2) -> (bank (4, H+64, W+64), cpad (2, H/2+64, W/2+64))."""
    return _bank_from_pad(_edge_pad(Y)), torch.stack([_edge_pad(U),
                                                      _edge_pad(V)])


def _edge_pad_cols(x, pad: int = PAD):
    """Edge-replicating pad of the columns of a 2-D tensor by `pad`."""
    W = x.shape[1]
    return x.index_select(1, torch.arange(-pad, W + pad, device=x.device)
                          .clamp(0, W - 1))


def ref_bank_rows_plain(extY, extU, extV):
    """Plain version of the reference entry of one row slab (the sharded
    GOP encoder's ``bank_of``, rd.py:2662-2672): int32 slabs extY (Hs, W),
    extU/extV (Hcs, W/2) whose rows are given (neighbour, edge or zero
    rows above and below) -> (bank (4, Hs, W+64), cpad (2, Hcs, W/2+64)),
    the columns edge-padded."""
    return _bank_from_pad(_edge_pad_cols(extY)), torch.stack(
        [_edge_pad_cols(extU), _edge_pad_cols(extV)])


def ref_entry_from_planes(Y, U, V, device=None, impl=None):
    """Build one reference entry from (unpadded) recon planes, host arrays
    or tensors: the aligned 4-plane luma bank + padded chroma stack, on
    `device` (CUDA unless told otherwise).  ``impl`` defaults to the
    ``kernels.ref_bank`` wrapper."""
    if impl is None:
        from ..kernels.ref_bank import ref_bank as impl
    dev = resolve_device(device)
    return impl(_to_i32(Y, dev), _to_i32(U, dev), _to_i32(V, dev))
