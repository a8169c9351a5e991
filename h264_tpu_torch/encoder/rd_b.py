"""Device RD coding of B pictures: the port of the reference package's
``rd_b_pipeline`` (encoder/rd.py:1972-2534) on PyTorch tensors.

Per picture, on the device: dense per-8x8 SSD grids around zero against
the list-0 references and the one list-1 anchor, a two-pass PMV field,
per-list (ref, mv) argmins of the 16x16, 16x8, 8x16 and 8x8 partitions,
their 49-point quarter-pel SATD refinement, the per-half {L0, L1, BI}
choice, the temporal direct field and prediction per 8x8 (spec
§8.4.1.2.3, direct_8x8_inference), the per-unit {direct, L0, L1, BI}
choice of the P8x8 candidate, residual coding of eight candidate
predictions with RDOQ-lite and JM thresholding, the I16 and direct-zero
(B skip) candidates, the winner gather, two-list chroma, the wavefront
intra commit, boundary strengths with the two-list pairing rule, the
in-loop filter and, for a stored B picture (``make_ref``), its reference
entry with the colocated snapshot.  The host tail reads the flat
``host_out`` buffer, whose layout is the reference's.

The per-pixel and per-candidate work goes through hand-written CUDA
kernels (``BKernels``): the P picture's K3 ``ssd_grid8`` (zero centres, no
WP), K4 ``qpel_refine``, K5, K1, K6 (``strengths`` with two lists, and
``deblock``) and K2, and three entries of their own, whose plain versions
are below: K7 ``b_direct``, ``mc_luma_win`` and ``mc_chroma_b`` (in
``csrc/qpel.cu``).  Everything else is glue on small tensors.

Window starts.  The B pipeline reads the unwidened banks (PAD = 32)
through ``jax.lax.dynamic_slice``, which places a whole window by its
start: a negative start first counts from the end of the axis (``s + L``,
numpy style), then the start is clamped into [0, L - size].  A window
that would leave the bank is moved, never edge-extended, and one that
would start above or left of it moves to the far edge.  Direct mvs
(scaled colocated P mvs, up to about +-77 pel) get there, so the direct
and L0-at-PMV predictions (``_dynfrac_mc``, a (h+2, w+2) window) and the
chroma prediction (``_mc_chroma_unit`` on 4x4 units, a 5x5 window) place
their windows the same way here (``_slice_start``), per unit.  The search
and refinement windows stay inside the bank at R <= 28, so the P
picture's per-sample clamping kernels give the same samples there.

As in ``rd_p``, the reference's trace-time experiment switches are not
carried (the identity at their defaults).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from . import rd as RD
from .rd import (_QTAB, B_BI, B_DIRECT, B_DIRECT_ZERO, B_I4, B_I16, B_L0,
                 B_L0_8x16, B_L0_16x8, B_L1, B_P8X8, BIG, I32, PAD, _bitlen,
                 _lam_cost, _mv_bits, _satd, lam_satd_of)
from .rd_p import (_mb_tiles, _med_neighbors, deblock_plain,
                   i16_candidate_plain, inter_chroma_tq_plain,
                   inter_luma_tq_plain, qpel_refine_plain, ssd_grid8_plain)
from .strengths import strengths_plain



# ---------------------------------------------------------------------------
# plain versions of the B picture's own kernel entries
# ---------------------------------------------------------------------------

def _slice_start(s, L: int, size: int):
    """Where ``dynamic_slice`` starts a window of `size` on an axis of
    length L asked to start at s: s + L when s < 0, then clamped into
    [0, L - size].  With size 1 it is also the index a JAX gather reads."""
    return torch.where(s < 0, s + L, s).clamp(0, L - size)


def mc_luma_win_plain(banks, ref, mvx, mvy, y0, x0, h: int, w: int):
    """Quarter-pel MC of n (h, w) units (rd.py:1911 `_dynfrac_mc`): each
    unit reads the (h + 2, w + 2) window of its reference at its integer
    position, the window placed (and the reference index clamped) in the
    (NR, 4, Hp, Wp) banks as ``dynamic_slice`` places it, and takes
    the rounded mean of the two samples ``_QTAB`` picks for its fraction.
    ref/mvx/mvy/y0/x0 (n,) int32.  Returns (n, h, w) int32."""
    NR, _, Hp, Wp = banks.shape
    dev = banks.device
    r = _slice_start(ref, NR, 1).long()[:, None, None]
    iy = _slice_start(y0 + (mvy >> 2) + PAD, Hp, h + 2)
    ix = _slice_start(x0 + (mvx >> 2) + PAD, Wp, w + 2)
    t = torch.as_tensor(_QTAB, device=dev)[((mvy & 3) * 4 + (mvx & 3)).long()]
    ay = torch.arange(h, device=dev)
    ax = torch.arange(w, device=dev)

    def tap(p, oy, ox):
        ya = ((iy + t[:, oy])[:, None] + ay).long()
        xa = ((ix + t[:, ox])[:, None] + ax).long()
        return banks[r, t[:, p].long()[:, None, None], ya[:, :, None],
                     xa[:, None, :]]

    return (tap(0, 1, 2) + tap(3, 4, 5) + 1) >> 1


def _mc_chroma_win(cpads, ref, mvx, mvy, yc, xc, h: int, w: int):
    """1/8-pel bilinear chroma MC of n (h, w) units for both planes
    (rd.py:159 `_mc_chroma_unit` with pad = PAD): the (h + 1, w + 1)
    window placed in the (NR, 2, Hcp, Wcp) planes as ``dynamic_slice``
    places it.  Returns (n, 2, h, w)."""
    NR, _, Hcp, Wcp = cpads.shape
    dev = cpads.device
    r = _slice_start(ref, NR, 1).long()[:, None, None, None]
    yi = _slice_start(yc + (mvy >> 3) + PAD, Hcp, h + 1)
    xi = _slice_start(xc + (mvx >> 3) + PAD, Wcp, w + 1)
    fx = (mvx & 7)[:, None, None, None]
    fy = (mvy & 7)[:, None, None, None]
    ay = (yi[:, None] + torch.arange(h + 1, device=dev)).long()
    ax = (xi[:, None] + torch.arange(w + 1, device=dev)).long()
    ch = torch.arange(2, device=dev)[None, :, None, None]
    A = cpads[r, ch, ay[:, None, :, None], ax[:, None, None, :]]
    return ((8 - fx) * (8 - fy) * A[..., :h, :w]
            + fx * (8 - fy) * A[..., :h, 1:]
            + (8 - fx) * fy * A[..., 1:, :w]
            + fx * fy * A[..., 1:, 1:] + 32) >> 6


def _units(n_mb: int, n_mx: int, dev):
    """(mb (n_mb, 1), b8 (1, 4), y0, x0 (n_mb, 4)): the luma origins of
    every MB's four 8x8 units."""
    mb = torch.arange(n_mb, device=dev)[:, None]
    b8 = torch.arange(4, device=dev)[None, :]
    y0 = 16 * (mb // n_mx) + 8 * (b8 >> 1)
    x0 = 16 * (mb % n_mx) + 8 * (b8 & 1)
    return mb, b8, y0, x0


def _join8(blocks, n_mb: int):
    """(n_mb * 4, 8, 8) unit blocks in (mb, b8) order -> (n_mb, 16, 16)."""
    return (blocks.reshape(n_mb, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n_mb, 16, 16))


def direct_mvs(col_intra4, col_ref4, col_mvx4, col_mvy4, dsf_tab, eq_tab):
    """Temporal direct motion per 8x8 unit (rd.py:2226-2242 `direct_b8`):
    from the colocated corner 4x4 of each unit (direct_8x8_inference), the
    list-0 index and the two mvs, scaled by DistScaleFactor ((dsf * mv +
    128) >> 8, arithmetic shift) unless the colocated block is intra or its
    list-0 picture is the list-1 anchor.  Col fields (4 n_my, 4 n_mx):
    intra bool, the rest int32 (ref indices already in this picture's list
    0); dsf_tab (NR0,) int32, eq_tab (NR0,) bool.  Returns idx, l0x, l0y,
    l1x, l1y (n_mb, 4), int32."""
    NR0 = dsf_tab.shape[0]
    H4, W4 = col_ref4.shape
    n_mx = W4 // 4
    n_mb = (H4 // 4) * n_mx
    mb, b8, _, _ = _units(n_mb, n_mx, col_ref4.device)
    ry = 4 * (mb // n_mx) + 3 * (b8 >> 1)
    rx = 4 * (mb % n_mx) + 3 * (b8 & 1)
    col_i = col_intra4[ry, rx]
    mcx = torch.where(col_i, 0, col_mvx4[ry, rx])
    mcy = torch.where(col_i, 0, col_mvy4[ry, rx])
    idx = torch.where(col_i, 0, col_ref4[ry, rx])
    ic = _slice_start(idx, NR0, 1).long()  # as the reference's gathers
    dsf = dsf_tab[ic]
    eq = eq_tab[ic] | col_i
    l0x = torch.where(eq, mcx, (dsf * mcx + 128) >> 8)
    l0y = torch.where(eq, mcy, (dsf * mcy + 128) >> 8)
    l1x = torch.where(eq, 0, l0x - mcx)
    l1y = torch.where(eq, 0, l0y - mcy)
    return tuple(a.to(I32) for a in (idx, l0x, l0y, l1x, l1y))


def b_direct_plain(banks0, banks1, col_intra4, col_ref4, col_mvx4, col_mvy4,
                   dsf_tab, eq_tab):
    """Temporal direct per 8x8 unit (rd.py:2218-2263 `direct_b8` /
    `direct_mb`): the motion of ``direct_mvs``, then the unit's
    prediction, the rounded mean of the two `_dynfrac_mc` predictions.
    banks0 (NR0, 4, Hp, Wp), banks1 (1, 4, Hp, Wp); the rest as
    ``direct_mvs``.  Returns pred (n_mb, 16, 16) and idx, l0x, l0y, l1x,
    l1y (n_mb, 4), int32."""
    idx, l0x, l0y, l1x, l1y = direct_mvs(col_intra4, col_ref4, col_mvx4,
                                         col_mvy4, dsf_tab, eq_tab)
    n_mb, n_mx = idx.shape[0], col_ref4.shape[1] // 4
    _, _, y0, x0 = _units(n_mb, n_mx, banks0.device)
    y0, x0 = y0.reshape(-1).to(I32), x0.reshape(-1).to(I32)
    p0 = mc_luma_win_plain(banks0, idx.reshape(-1), l0x.reshape(-1),
                           l0y.reshape(-1), y0, x0, 8, 8)
    p1 = mc_luma_win_plain(banks1, torch.zeros_like(y0), l1x.reshape(-1),
                           l1y.reshape(-1), y0, x0, 8, 8)
    return (_join8((p0 + p1 + 1) >> 1, n_mb), idx, l0x, l0y, l1x, l1y)


def mc_chroma_b_plain(cpads0, cpads1, idx0, m0x, m0y, m1x, m1y, u0, u1):
    """Two-list chroma prediction per MB (rd.py:2453-2470
    `chroma_pred_mb`): per 8x8 luma unit one 4x4 chroma unit from list 0
    (reference idx0) and one from the list-1 anchor, windows placed as
    `_mc_chroma_unit` (pad = PAD) places them; the rounded mean where the
    unit uses both lists (u0 & u1), else list 0 where u0, else list 1.
    idx0/m* (n_mb, 4) int32, u0/u1 (n_mb, 4) bool.  Returns (n_mb, 2, 8,
    8)."""
    n_mb = idx0.shape[0]
    n_mx = (cpads0.shape[-1] - 2 * PAD) // 8
    _, _, y0, x0 = _units(n_mb, n_mx, cpads0.device)
    yc, xc = (y0 >> 1).reshape(-1), (x0 >> 1).reshape(-1)
    c0 = _mc_chroma_win(cpads0, idx0.reshape(-1), m0x.reshape(-1),
                        m0y.reshape(-1), yc, xc, 4, 4)
    c1 = _mc_chroma_win(cpads1, torch.zeros_like(yc), m1x.reshape(-1),
                        m1y.reshape(-1), yc, xc, 4, 4)
    a0 = u0.reshape(-1, 1, 1, 1)
    both = a0 & u1.reshape(-1, 1, 1, 1)
    c = torch.where(both, (c0 + c1 + 1) >> 1, torch.where(a0, c0, c1))
    # [mb, by, bx, ch, y, x] -> (mb, ch, 8, 8)
    g = c.reshape(n_mb, 2, 2, 2, 4, 4).permute(0, 3, 1, 4, 2, 5)
    return g.reshape(n_mb, 2, 8, 8).to(I32)


# ---------------------------------------------------------------------------
# the kernel entries a B picture goes through
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BKernels:
    """The device entries of one B picture: the CUDA kernel wrappers by
    default (``default_kernels``), or their plain versions (``PLAIN``)."""

    ssd_grid8: object
    qpel_refine: object
    b_direct: object
    mc_luma_win: object
    mc_chroma_b: object
    inter_luma_tq: object
    inter_chroma_tq: object
    i16_candidate: object
    strengths: object
    deblock: object
    intra_scan: object
    ref_bank: object

    def names(self):
        return [f.name for f in fields(self)]


PLAIN = BKernels(
    ssd_grid8_plain, qpel_refine_plain, b_direct_plain, mc_luma_win_plain,
    mc_chroma_b_plain, inter_luma_tq_plain, inter_chroma_tq_plain,
    i16_candidate_plain, strengths_plain, deblock_plain, RD._intra_scan,
    RD.ref_entry_plain)


def default_kernels() -> BKernels:
    """The CUDA kernel wrappers (each runs its plain version on a CPU
    tensor)."""
    from ..kernels import b_direct as K7
    from ..kernels import deblock as K6
    from ..kernels import inter_tq as K5
    from ..kernels import intra_commit as K1
    from ..kernels import qpel as K4
    from ..kernels import ref_bank as K2
    from ..kernels import search_grid as K3

    return BKernels(
        K3.ssd_grid8, K4.qpel_refine, K7.b_direct, K4.mc_luma_win,
        K4.mc_chroma_b, K5.inter_luma_tq, K5.inter_chroma_tq,
        K5.i16_candidate, K6.strengths, K6.deblock, K1.intra_commit_scan,
        K2.ref_bank)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

class BFrame:
    """Inputs and intermediates of one B picture; each ``b_*`` stage adds
    its results as attributes.  banks0/cpads0: the list-0 references
    (NR0, ...), padded to a fixed depth, of which the first ``nref0`` are
    active; banks1/cpads1: the list-1 anchor (1, ...); col_*: the anchor's
    colocated snapshot with its reference indices translated into this
    picture's list 0; pocs0/dsf_tab/eq_tab (NR0,): the list-0 POCs,
    DistScaleFactors and "is the list-1 anchor" flags; poc1: the anchor's
    POC."""

    def __init__(self, cur_y, cur_u, cur_v, banks0, cpads0, banks1, cpads1,
                 col_intra4, col_ref4, col_mvx4, col_mvy4, pocs0, dsf_tab,
                 eq_tab, poc1: int, H: int, W: int, R: int, qp: int,
                 qp_c: int, lam: int, lam_me: int, nref0: int,
                 make_ref: bool = False, k: BKernels | None = None):
        self.cur_y, self.cur_u, self.cur_v = cur_y, cur_u, cur_v
        self.banks0, self.cpads0 = banks0, cpads0
        self.banks1, self.cpads1 = banks1, cpads1
        self.col = (col_intra4, col_ref4, col_mvx4, col_mvy4)
        self.pocs0, self.dsf_tab, self.eq_tab = pocs0, dsf_tab, eq_tab
        self.poc1 = int(poc1)
        self.H, self.W, self.R = H, W, R
        self.qp, self.qp_c, self.lam, self.lam_me = (
            int(qp), int(qp_c), int(lam), int(lam_me))
        self.nref0 = int(nref0)
        self.make_ref = bool(make_ref)
        self.k = k if k is not None else default_kernels()
        self.dev = cur_y.device
        self.NR0 = banks0.shape[0]
        self.n_my, self.n_mx = H // 16, W // 16
        self.n_mb = self.n_my * self.n_mx
        self.D = 2 * R + 1
        # SATD lambda, float32 in the reference's order (rd.py:2097)
        self.lam_satd = lam_satd_of(self.lam_me)
        mb = torch.arange(self.n_mb, device=self.dev)
        self.mb_ys = (mb // self.n_mx) * 16
        self.mb_xs = (mb % self.n_mx) * 16
        rb = self.ints([1 if r == 0 else 2 * (r + 1).bit_length() - 1
                        for r in range(self.NR0)])
        # list-0 ref_idx bits; a single active ref transmits none
        self.rbits0 = rb if self.nref0 > 1 else torch.zeros_like(rb)

    def ints(self, v):
        return torch.as_tensor(v, dtype=I32, device=self.dev)

    def tiles(self, plane, oy: int, ox: int, h: int, w: int):
        """(n_mb, h, w) tiles of `plane` at every MB's origin + (oy, ox)."""
        ay = torch.arange(h, device=self.dev)
        ax = torch.arange(w, device=self.dev)
        return plane[(self.mb_ys + oy)[:, None, None] + ay[:, None],
                     (self.mb_xs + ox)[:, None, None] + ax]


def b_search(f: BFrame) -> None:
    """Dense per-8x8 SSD grids around zero (rd.py:2019-2035), both lists,
    and their sums into the 16x16, 16x8 and 8x16 grids."""
    D, R = f.D, f.R

    def grids(banks):
        nr = banks.shape[0]
        zero = torch.zeros((nr, f.n_my, f.n_mx), dtype=I32, device=f.dev)
        s8 = f.k.ssd_grid8(banks, f.cur_y, zero, zero, None, R)
        return s8.reshape(nr, f.n_my, 2, f.n_mx, 2, D, D)

    f.s8 = [grids(f.banks0), grids(f.banks1)]
    f.g16 = [s.sum((2, 4), dtype=I32) for s in f.s8]
    f.g168 = [s.sum(4, dtype=I32).permute(0, 1, 3, 2, 4, 5) for s in f.s8]
    f.g816 = [s.sum(2, dtype=I32) for s in f.s8]


def _argmin16(f: BFrame, grids, lst: int):
    """(ref, imvx, imvy) (n_my, n_mx) of one partition of every MB
    (rd.py:2060 `argmin16`): the least cost per ref, then the first ref
    with the least cost, then its first cell.  List 0 prices its ref_idx
    and never picks a padded ref; the single list-1 ref costs nothing."""
    nr, n_my, n_mx, D, R = grids.shape[0], f.n_my, f.n_mx, f.D, f.R
    if lst == 0:
        rb = f.rbits0
        pen = f.ints([BIG if r >= f.nref0 else 0 for r in range(nr)])
    else:  # the list-1 anchor alone
        rb = pen = torch.zeros(1, dtype=I32, device=f.dev)
    cost = grids + _lam_cost(f.lam_me, f.mvbits)[None]
    cost = cost + (_lam_cost(f.lam_me, rb) + pen)[:, None, None, None, None]
    per_ref, per_ref_i = cost.reshape(nr, n_my, n_mx, -1).min(-1)
    ref = per_ref.argmin(0)
    idx = per_ref_i.gather(0, ref[None])[0].to(I32)
    return ref.to(I32), idx % D - R, idx // D - R


def b_argmin(f: BFrame) -> None:
    """The PMV field from list 0's zero-biased 16x16 best, the 16x16
    argmins of both lists priced against it (rd.py:2037-2089; every later
    argmin uses the same mv rates), and the second-pass PMV field from
    list 0's chosen integer mvs, which prices refinement and rates."""
    n_my, n_mx, D, R = f.n_my, f.n_mx, f.D, f.R
    dgrid = torch.arange(-R, R + 1, dtype=I32, device=f.dev) * 4
    zb = _mv_bits(dgrid)[None, :] + _mv_bits(dgrid)[:, None]
    bi0 = (f.g16[0][0] + _lam_cost(f.lam_me, zb)).reshape(
        n_my, n_mx, -1).argmin(-1).to(I32)
    pmvx = _med_neighbors((bi0 % D - R) * 4)
    pmvy = _med_neighbors((bi0 // D - R) * 4)
    bits_x = _mv_bits(dgrid - pmvx[..., None])
    bits_y = _mv_bits(dgrid - pmvy[..., None])
    f.mvbits = bits_x[:, :, None, :] + bits_y[:, :, :, None]
    f.a16 = [_argmin16(f, f.g16[0], 0), _argmin16(f, f.g16[1], 1)]
    f.pmvx_f = _med_neighbors(f.a16[0][1] * 4).reshape(-1)
    f.pmvy_f = _med_neighbors(f.a16[0][2] * 4).reshape(-1)


def _refine(f: BFrame, banks, parts, offs, h: int, w: int):
    """Refine the units of several partitions of every MB against one
    list's banks in one launch (rd.py:2100 `refine_u`): parts [(ref, imvx,
    imvy) (n_my, n_mx)], offs [(oy, ox)] their origins in the MB.  Returns
    per part (ref, mvx, mvy, pred, cost), (n_mb, ...)."""
    n = len(parts)
    ref = torch.cat([p[0].reshape(-1) for p in parts])
    ix = torch.cat([p[1].reshape(-1) for p in parts])
    iy = torch.cat([p[2].reshape(-1) for p in parts])
    y0 = torch.cat([f.mb_ys + oy for oy, _ in offs]).to(I32)
    x0 = torch.cat([f.mb_xs + ox for _, ox in offs]).to(I32)
    out = f.k.qpel_refine(banks, f.cur_y, ref, ix, iy, y0, x0,
                          f.pmvx_f.repeat(n), f.pmvy_f.repeat(n), None,
                          f.lam_satd, h, w)
    return [tuple(t.chunk(n)[i] for t in (ref, *out)) for i in range(n)]


def b_refine16(f: BFrame) -> None:
    """Quarter-pel refinement of the 16x16 winners of both lists."""
    f.q16 = [_refine(f, f.banks0, [f.a16[0]], [(0, 0)], 16, 16)[0],
             _refine(f, f.banks1, [f.a16[1]], [(0, 0)], 16, 16)[0]]


def _mvb(f: BFrame, mvx, mvy):
    return _mv_bits(mvx - f.pmvx_f) + _mv_bits(mvy - f.pmvy_f)


def b_halves(f: BFrame) -> None:
    """16x8 and 8x16 candidates (rd.py:2139-2178): per half the argmin and
    refinement of both lists, then the least SATD cost of {L0, L1, BI}."""
    f.halves = {}
    for key, g0, g1, offs, h, w in (
            ("168", f.g168[0], f.g168[1], [(0, 0), (8, 0)], 8, 16),
            ("816", f.g816[0], f.g816[1], [(0, 0), (0, 8)], 16, 8)):
        q0 = _refine(f, f.banks0, [_argmin16(f, g0[:, :, :, hf], 0)
                                   for hf in range(2)], offs, h, w)
        q1 = _refine(f, f.banks1, [_argmin16(f, g1[:, :, :, hf], 1)
                                   for hf in range(2)], offs, h, w)
        sets = []
        for hf, (oy, ox) in enumerate(offs):
            r0, x0, y0, p0, c0 = q0[hf]
            _, x1, y1, p1, c1 = q1[hf]
            pbi = (p0 + p1 + 1) >> 1
            mvb0, mvb1 = _mvb(f, x0, y0), _mvb(f, x1, y1)
            rb0 = f.rbits0[r0.long()]
            cbi = _satd(f.tiles(f.cur_y, oy, ox, h, w) - pbi) + _lam_cost(
                f.lam_satd, mvb0 + mvb1 + rb0)
            costs = torch.stack([c0 + _lam_cost(f.lam_satd, rb0), c1, cbi])
            pd = costs.argmin(0).to(I32)  # 0 L0 / 1 L1 / 2 BI
            sel = pd[:, None, None]
            sets.append(dict(
                pd=pd, pred=torch.where(sel == 0, p0,
                                        torch.where(sel == 1, p1, pbi)),
                r0=r0, x0=x0, y0=y0, x1=x1, y1=y1,
                bits=torch.where(pd == 0, rb0 + mvb0,
                                 torch.where(pd == 1, mvb1,
                                             rb0 + mvb0 + mvb1))))
        f.halves[key] = sets
    h168, h816 = f.halves["168"], f.halves["816"]
    f.pred_168 = torch.cat([h168[0]["pred"], h168[1]["pred"]], 1)
    f.pred_816 = torch.cat([h816[0]["pred"], h816[1]["pred"]], 2)


def b_direct(f: BFrame) -> None:
    """Temporal direct motion and prediction of every 8x8 unit (K7)."""
    (f.pred_dir, f.dir_idx, f.dir_l0x, f.dir_l0y, f.dir_l1x,
     f.dir_l1y) = f.k.b_direct(f.banks0, f.banks1, *f.col, f.dsf_tab,
                               f.eq_tab)


def b_p8(f: BFrame) -> None:
    """The P8x8 candidate (rd.py:2180-2216, :2265-2270): per 8x8 unit the
    argmin and refinement of both lists, then the least SATD cost of
    {direct, L0, L1, BI} (no direct in a stored B picture)."""
    offs = [(8 * (b >> 1), 8 * (b & 1)) for b in range(4)]
    q0 = _refine(f, f.banks0, [_argmin16(f, f.s8[0][:, :, b >> 1, :, b & 1],
                                         0) for b in range(4)], offs, 8, 8)
    q1 = _refine(f, f.banks1, [_argmin16(f, f.s8[1][:, :, b >> 1, :, b & 1],
                                         1) for b in range(4)], offs, 8, 8)
    f.units = []
    for b, (oy, ox) in enumerate(offs):
        r0, x0, y0, p0, c0 = q0[b]
        _, x1, y1, p1, c1 = q1[b]
        pbi = (p0 + p1 + 1) >> 1
        pdir = f.pred_dir[:, oy:oy + 8, ox:ox + 8]
        ou = f.tiles(f.cur_y, oy, ox, 8, 8)
        mvb0, mvb1 = _mvb(f, x0, y0), _mvb(f, x1, y1)
        rb0 = f.rbits0[r0.long()]
        cdir = _satd(ou - pdir) + _lam_cost(f.lam_satd, 1)
        if f.make_ref:
            cdir = cdir + BIG  # stored Bs: no direct
        costs = torch.stack([
            cdir, c0 + _lam_cost(f.lam_satd, rb0 + 3),
            c1 + _lam_cost(f.lam_satd, 3),
            _satd(ou - pbi) + _lam_cost(f.lam_satd, mvb0 + mvb1 + rb0 + 3)])
        k = costs.argmin(0).to(I32)  # 0 direct / 1 L0 / 2 L1 / 3 BI
        sel = k[:, None, None]
        f.units.append(dict(
            k=k, pred=torch.where(sel == 0, pdir, torch.where(
                sel == 1, p0, torch.where(sel == 2, p1, pbi))),
            r0=r0, x0=x0, y0=y0, x1=x1, y1=y1,
            bits=torch.where(k == 0, 1, torch.where(
                k == 1, 3 + rb0 + mvb0, torch.where(
                    k == 2, 3 + mvb1, 3 + rb0 + mvb0 + mvb1)))))
    f.pred_p8 = _join8(torch.stack([u["pred"] for u in f.units], 1)
                       .reshape(-1, 8, 8), f.n_mb)
    f.p8_bits = sum(u["bits"] for u in f.units)


def b_decide(f: BFrame) -> None:
    """Candidates and their J (rd.py:2272-2353): residual coding of
    [DIRECT, L0, L1, BI, L0@PMV, 16x8, 8x16, P8x8], the I16 candidate and
    direct-zero, and the winner over the ten."""
    n_mb, dev, lam = f.n_mb, f.dev, f.lam
    ref0, mv0x, mv0y, pred0, _ = f.q16[0]
    _, mv1x, mv1y, pred1, _ = f.q16[1]
    f.orig_mb = _mb_tiles(f.cur_y, 16).contiguous()
    # the L0 16x16 prediction at the PMV, ref 0 (mvd ~ 0)
    pred_pm = f.k.mc_luma_win(
        f.banks0, torch.zeros(n_mb, dtype=I32, device=dev), f.pmvx_f,
        f.pmvy_f, f.mb_ys.to(I32), f.mb_xs.to(I32), 16, 16)
    preds = torch.stack([f.pred_dir, pred0, pred1, (pred0 + pred1 + 1) >> 1,
                         pred_pm, f.pred_168, f.pred_816,
                         f.pred_p8]).contiguous()
    f.lev_i, f.rec_i, D8, cb8 = f.k.inter_luma_tq(preds, f.orig_mb, f.qp, lam)
    D_i, cb_i = D8.sum(-1, dtype=I32), cb8.sum(-1, dtype=I32)
    mvb0, mvb1 = _mvb(f, mv0x, mv0y), _mvb(f, mv1x, mv1y)
    multi = f.NR0 > 1  # the padded stack's depth, as the reference
    refb0 = (torch.where(ref0 == 0, 1, 2 * _bitlen(ref0 + 1) - 1) if multi
             else torch.zeros_like(ref0))
    h168, h816 = f.halves["168"], f.halves["816"]
    ones = torch.ones(n_mb, dtype=I32, device=dev)
    R_c = torch.stack([
        ones, 3 + mvb0 + refb0, 3 + mvb1, 5 + mvb0 + refb0 + mvb1,
        (5 + int(multi)) * ones, 7 + h168[0]["bits"] + h168[1]["bits"],
        7 + h816[0]["bits"] + h816[1]["bits"], 9 + f.p8_bits])
    J_inter = D_i + _lam_cost(lam, R_c + cb_i)
    # direct-zero (B skip): the direct prediction, no residual
    f.rec_dz = f.pred_dir.clamp(0, 255)
    ddz = f.orig_mb - f.rec_dz
    J_dz = (ddz * ddz).sum((-1, -2), dtype=I32)
    _, D16, cb16 = f.k.i16_candidate(f.cur_y, f.qp)
    J_i16 = D16 + _lam_cost(lam, cb16 + 11)
    J_all = torch.cat([J_inter, J_i16[None], J_dz[None]], 0)
    if f.make_ref:
        # stored Bs never use direct modes: their motion must stay
        # mappable into the leaf Bs' lists for temporal direct
        J_all[0] = BIG
        J_all[9] = BIG
    f.win6 = J_all.argmin(0).to(I32)


def b_winner(f: BFrame) -> None:
    """Winner gather, per-unit fields and two-list chroma (rd.py:2353-2478).
    Units of half winners take their half's fields (16x8 top = units 0, 1;
    8x16 left = units 0, 2); P8x8 units their sub-mode's or their direct
    motion; 16x16 direct and direct-zero ride BI."""
    n_mb, win6 = f.n_mb, f.win6
    ar = torch.arange(n_mb, device=f.dev)
    is_pm = win6 == 4
    win = torch.where(win6 == 9, B_DIRECT_ZERO, torch.where(
        win6 == 8, B_I16, torch.where(win6 == 7, B_P8X8, torch.where(
            is_pm, B_L0, win6)))).to(I32)
    ref0, mv0x, mv0y = f.q16[0][:3]
    _, mv1x, mv1y = f.q16[1][:3]
    # the PMV winner is a plain L0 16x16 with mv = PMV, ref 0
    ref0 = torch.where(is_pm, 0, ref0)
    mv0x = torch.where(is_pm, f.pmvx_f, mv0x)
    mv0y = torch.where(is_pm, f.pmvy_f, mv0y)
    f.is_intra = win == B_I16
    is_dz = win == B_DIRECT_ZERO
    win_i = torch.where(is_dz, 0, win6.clamp(max=7)).long()
    f.w_lev = torch.where(is_dz[:, None, None, None, None], 0,
                          f.lev_i[win_i, ar])
    f.w_rec = torch.where(is_dz[:, None, None], f.rec_dz, f.rec_i[win_i, ar])

    is_h168, is_h816, is_p8 = win == B_L0_16x8, win == B_L0_8x16, win == B_P8X8
    h168, h816 = f.halves["168"], f.halves["816"]
    s168 = torch.tensor([0, 0, 1, 1], device=f.dev)
    s816 = torch.tensor([0, 1, 0, 1], device=f.dev)

    def half_field(key):
        a168 = torch.stack([h168[0][key], h168[1][key]], 1)[:, s168]
        a816 = torch.stack([h816[0][key], h816[1][key]], 1)[:, s816]
        return torch.where(is_h168[:, None], a168, a816)

    ku = torch.stack([u["k"] for u in f.units], 1)  # 0 dir/1 L0/2 L1/3 BI
    pd16 = torch.where(win == B_L0, 0, torch.where(win == B_L1, 1, 2))
    pd_p8 = torch.where(ku == 0, 3, ku - 1)
    pd_half = torch.stack([h168[0]["pd"], h168[1]["pd"]], 1)[:, s168]
    pd_half = torch.where(is_h816[:, None], torch.stack(
        [h816[0]["pd"], h816[1]["pd"]], 1)[:, s816], pd_half)
    pdir8 = torch.where(
        (is_h168 | is_h816)[:, None], pd_half,
        torch.where(is_p8[:, None], pd_p8, pd16[:, None])).to(I32)

    use0 = (win == B_DIRECT) | (win == B_L0) | (win == B_BI) | is_dz
    use1 = (win == B_DIRECT) | (win == B_L1) | (win == B_BI) | is_dz
    isdir = ((win == B_DIRECT) | is_dz)[:, None]
    unit_dir = ku == 0

    def unit_field(key, dir_val):
        own = torch.stack([u[key] for u in f.units], 1)
        return torch.where(is_p8[:, None], torch.where(unit_dir, dir_val, own),
                           half_field(key))

    ishalf8 = (is_h168 | is_h816 | is_p8)[:, None]
    hu0 = ishalf8 & ((pdir8 == 0) | (pdir8 >= 2))
    hu1 = ishalf8 & (pdir8 >= 1)

    def pick(dir_val, key, hu, use, v16):
        return torch.where(isdir, dir_val, torch.where(
            hu, unit_field(key, dir_val),
            torch.where(use[:, None], v16[:, None], 0))).to(I32).contiguous()

    f.w_idx0 = pick(f.dir_idx, "r0", hu0, use0, ref0)
    f.w_m0x = pick(f.dir_l0x, "x0", hu0, use0, mv0x)
    f.w_m0y = pick(f.dir_l0y, "y0", hu0, use0, mv0y)
    f.w_m1x = pick(f.dir_l1x, "x1", hu1, use1, mv1x)
    f.w_m1y = pick(f.dir_l1y, "y1", hu1, use1, mv1y)
    f.u0_8 = ((use0[:, None] | hu0) & ~f.is_intra[:, None]).contiguous()
    f.u1_8 = ((use1[:, None] | hu1) & ~f.is_intra[:, None]).contiguous()
    f.win, f.pdir8 = win, pdir8

    pred_c = f.k.mc_chroma_b(f.cpads0, f.cpads1, f.w_idx0, f.w_m0x, f.w_m0y,
                             f.w_m1x, f.w_m1y, f.u0_8, f.u1_8)
    orig_c = torch.stack([_mb_tiles(f.cur_u, 8), _mb_tiles(f.cur_v, 8)],
                         1).contiguous()
    levc, dcc, recc = f.k.inter_chroma_tq(pred_c, orig_c, f.qp_c, f.lam)
    # direct-zero winners carry no chroma residual either
    f.levc = torch.where(is_dz[:, None, None, None, None, None], 0, levc)
    f.dcc = torch.where(is_dz[:, None, None, None], 0, dcc)
    f.recc = torch.where(is_dz[:, None, None, None], pred_c.clamp(0, 255),
                         recc)


def b_commit(f: BFrame) -> None:
    """The wavefront intra commit with the inter results copied through
    (rd.py:2480-2485)."""
    (f.rec_y, f.rec_u, f.rec_v, f.w_lev, f.lum_dc, f.i16mode, f.cip, f.levc,
     f.dcc, i4flag, f.ipm) = RD._intra_commit_scan(
        f.cur_y, f.cur_u, f.cur_v, f.w_rec.contiguous(), f.recc.contiguous(),
        f.is_intra.contiguous(), f.w_lev.contiguous(), f.levc.contiguous(),
        f.dcc.contiguous(), f.H, f.W, f.qp, f.qp_c, lam=f.lam,
        impl=f.k.intra_scan)
    f.win = torch.where(i4flag == 1, B_I4, f.win).to(I32)


def _to4(f: BFrame, a8):
    """(n_mb, 4) per-unit values -> (4 n_my, 4 n_mx) per 4x4 block."""
    p = (a8.reshape(f.n_my, f.n_mx, 2, 2).permute(0, 2, 1, 3)
         .reshape(2 * f.n_my, 2 * f.n_mx))
    return p.repeat_interleave(2, 0).repeat_interleave(2, 1).contiguous()


def b_deblock(f: BFrame) -> None:
    """Boundary strengths with the two-list pairing rule and the in-loop
    filter (rd.py:2487-2507): the strengths read the winners' per-unit
    fields as they are, list 0's reference id the POC at the clamped
    index, list 1's the anchor's POC."""
    BSV, BSH = f.k.strengths(f.n_my, f.n_mx, f.w_lev, f.is_intra, f.w_idx0,
                             f.w_m0x, f.w_m0y, None, None, f.pocs0, f.u0_8,
                             f.w_m1x, f.w_m1y, f.u1_8, f.poc1)
    f.dy, f.du, f.dv = f.k.deblock(
        f.rec_y.contiguous(), f.rec_u.contiguous(), f.rec_v.contiguous(),
        BSV, BSH, f.qp, f.qp_c)


def b_outputs(f: BFrame):
    """The flat host_out in the reference's layout (rd.py:2509-2517) and,
    for a stored B picture, its reference entry (K2) and colocated
    snapshot (:2518-2534): L0 motion where the block uses list 0, else its
    L1 motion, with the reference index NR0 (a sentinel the host maps to
    the list-1 anchor) for L1-only blocks."""
    host_out = torch.cat([
        f.win.reshape(-1), f.pdir8.reshape(-1), f.w_idx0.reshape(-1),
        f.w_m0x.reshape(-1), f.w_m0y.reshape(-1), f.w_m1x.reshape(-1),
        f.w_m1y.reshape(-1), f.i16mode.reshape(-1), f.cip.reshape(-1),
        f.w_lev.reshape(-1), f.lum_dc.reshape(-1), f.levc.reshape(-1),
        f.dcc.reshape(-1), f.ipm.reshape(-1)]).to(I32)
    recon = (f.dy, f.du, f.dv)
    if not f.make_ref:
        return host_out, recon
    bank, cpad = f.k.ref_bank(f.dy, f.du, f.dv)
    n_my, n_mx = f.n_my, f.n_mx
    intra4 = (f.is_intra.reshape(n_my, n_mx).repeat_interleave(4, 0)
              .repeat_interleave(4, 1))
    v0 = _to4(f, f.u0_8) & ~intra4
    v1 = _to4(f, f.u1_8) & ~intra4
    col = ((intra4 | ~(v0 | v1)).contiguous(),
           torch.where(v0, _to4(f, f.w_idx0), f.NR0).to(I32).contiguous(),
           torch.where(v0, _to4(f, f.w_m0x), _to4(f, f.w_m1x)).contiguous(),
           torch.where(v0, _to4(f, f.w_m0y), _to4(f, f.w_m1y)).contiguous())
    return host_out, recon, (bank, cpad, col)


B_STAGES = (b_search, b_argmin, b_refine16, b_halves, b_direct, b_p8,
            b_decide, b_winner, b_commit, b_deblock)


def rd_b_pipeline(cur_y, cur_u, cur_v, banks0, cpads0, banks1, cpads1,
                  col_intra4, col_ref4, col_mvx4, col_mvy4, pocs0, dsf_tab,
                  eq_tab, poc1: int, H: int, W: int, R: int, qp: int,
                  qp_c: int, lam: int, lam_me: int, nref0=None,
                  make_ref: bool = False, device=None,
                  k: BKernels | None = None):
    """Whole-picture RD B coding (temporal direct).  cur_*: uint8 or int32
    planes (host or device); banks0/cpads0 (NR0, ...) the list-0
    references, banks1/cpads1 (1, ...) the list-1 anchor, int32 on the
    device; col_*: the anchor's colocated snapshot (intra bool, ref/mvx/
    mvy int32, (4 n_my, 4 n_mx)) with its refs translated into this
    picture's list 0; pocs0/dsf_tab/eq_tab: (NR0,) list-0 POCs,
    DistScaleFactors and "equals the anchor" flags (host or device); lam /
    lam_me << 16; nref0: the active list-0 refs (the rest is padding that
    never wins); make_ref: a stored B picture (no direct modes, and a
    reference entry out).  ``k`` picks the kernel entries (the CUDA
    wrappers by default).

    Returns (host_out flat int32, recon (Y, U, V)) and, with make_ref, the
    reference entry (bank, cpad, col), all on the device."""
    dev = RD.resolve_device(device)
    NR0 = banks0.shape[0]

    def dev_col(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype).contiguous()

    f = BFrame(RD._to_i32(cur_y, dev), RD._to_i32(cur_u, dev),
               RD._to_i32(cur_v, dev), banks0, cpads0, banks1, cpads1,
               dev_col(col_intra4, torch.bool), dev_col(col_ref4, I32),
               dev_col(col_mvx4, I32), dev_col(col_mvy4, I32),
               dev_col(pocs0, I32), dev_col(dsf_tab, I32),
               dev_col(eq_tab, torch.bool), poc1, H, W, R, qp, qp_c, lam,
               lam_me, NR0 if nref0 is None else nref0, make_ref, k)
    for stage in B_STAGES:
        stage(f)
    return b_outputs(f)


B_ENTRIES = ("ssd_grid8", "qpel_refine", "b_direct", "mc_luma_win",
             "mc_chroma_b", "inter_luma_tq", "inter_chroma_tq",
             "i16_candidate", "strengths", "deblock")
# the entries only B pictures have
B_OWN = ("b_direct", "mc_luma_win", "mc_chroma_b")


def recording(k: BKernels):
    """(BKernels that run `k` and record every call of the B entries as
    (name, args), the list they append to): the real inputs of each
    kernel entry, for holding a kernel against its plain version."""
    calls: list = []

    def wrap(name, fn):
        def rec(*args):
            calls.append((name, args))
            return fn(*args)
        return rec

    return BKernels(**{n: (wrap(n, getattr(k, n)) if n in B_ENTRIES
                           else getattr(k, n)) for n in k.names()}), calls
