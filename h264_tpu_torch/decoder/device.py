"""Whole-picture inter reconstruction of the decoder on the card.

After the host entropy parse (PictureParseState) and MV derivation, the
picture's inter path — quarter-pel MC with weighted and bi-prediction,
residual dequant and inverse transform (4x4 and 8x8), recon — runs as
one kernel launch, K8 (``csrc/decode_inter.cu``, wrapper
``kernels/decode_inter.py``), in place of the reference package's jitted
``decoder/device.py:99 _decode_inter``.  ``decode_inter_plain`` below is
the same function in PyTorch, a transcription of ``_decode_inter``: the
CPU path and the yardstick the kernel is held against.

Intra MBs keep the sequential host raster path and overwrite their pixels
afterwards; inter MBs never read current-picture pixels, so device-inter
first and host-intra second is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder.rd import PAD, _QTAB
from ..kernels.decode_inter import MAXREF, decode_inter
from ..kernels.ref_bank import ref_bank
from ..ops import quant as Q
from ..ops import transforms as TR
from ..ops.exact import rshift_rnd_sf
from . import mbtables as M

# flat (scaling-list-free) inverse level scales, all 6 qp%6 classes;
# with SPS/PPS scaling matrices decode_inter_args passes DEQUANT * WeightScale
_ILS4 = (Q.DEQUANT4 * 16).astype(np.int32)  # (6, 4, 4)
_ILS8 = (Q.DEQUANT8 * 16).astype(np.int32)  # (6, 8, 8)

# raster position (by * 4 + bx) of a 4x4 block -> its JM index
_PERM4 = np.zeros(16, np.int64)
for _blk in range(16):
    _bx, _by = M.BLK4_TO_XY[_blk]
    _PERM4[int(_by) * 4 + int(_bx)] = _blk


# ---------------------------------------------------------------------------
# the plain version of K8
# ---------------------------------------------------------------------------

def decode_inter_plain(banks, cpads, refmap, mv, ref_idx, sid4,
                       wp_mode, wp_ly, wp_lc, wy, oy, wc, oc, wimp,
                       qp, qpc, t8, lev4, lev8, levc, dcc, inter_mask,
                       ils4y, ils8y, ils4c, H: int, W: int, NS: int):
    """The reference's ``_decode_inter`` in PyTorch: one flat int32
    (H*W + 2*(H/2)*(W/2),) Y|U|V buffer; non-inter MBs are zero.

    banks (NB,4,H+64,W+64) / cpads (NB,2,H/2+64,W/2+64): unified ref
    banks.  refmap (NS,2,MAXREF): slice x list x ref_idx -> bank index.
    mv (2,H4,W4,2), ref_idx (2,H4,W4), sid4 (H4,W4).  wp_*: per-slice
    weighted-prediction tables.  qp (nb,), qpc (nb,2), t8 (nb,),
    lev4 (nb,16,4,4) in JM block order, lev8 (nb,4,8,8),
    levc (nb,2,4,4,4), dcc (nb,2,2,2), inter_mask (nb,); ils4y (6,4,4),
    ils8y (6,8,8), ils4c (2,6,4,4).  All int32 tensors on one device."""
    dev = mv.device
    i32 = torch.int32
    H4, W4 = H // 4, W // 4
    n_my, n_mx = H // 16, W // 16
    nb = n_my * n_mx
    Hc, Wc = H // 2, W // 2
    L = lambda x: x.long()  # noqa: E731  (index form)
    qtab = torch.as_tensor(_QTAB, dtype=torch.long, device=dev)

    by = torch.arange(H4, device=dev).view(H4, 1).expand(H4, W4)
    bx = torch.arange(W4, device=dev).view(1, W4).expand(H4, W4)
    y0, x0 = by * 4, bx * 4
    sid = L(sid4).clamp(0, NS - 1)
    r0, r1 = L(ref_idx[0]), L(ref_idx[1])
    v0, v1 = r0 >= 0, r1 >= 0
    i0 = r0.clamp(0, MAXREF - 1)
    i1 = r1.clamp(0, MAXREF - 1)
    b0 = L(refmap[sid, 0, i0])
    b1 = L(refmap[sid, 1, i1])
    m0x, m0y = mv[0, ..., 0], mv[0, ..., 1]
    m1x, m1y = mv[1, ..., 0], mv[1, ..., 1]
    e4 = lambda t: t[..., None, None]  # noqa: E731
    a4 = torch.arange(4, device=dev)

    def mc_luma(bi, mvx, mvy):
        xi = (x0 + L(mvx >> 2)).clamp(-(PAD - 8), W + PAD - 12)
        yi = (y0 + L(mvy >> 2)).clamp(-(PAD - 8), H + PAD - 12)
        t = qtab[L((mvy & 3) * 4 + (mvx & 3))]  # (H4, W4, 6)

        def tap(k):
            rows = e4(yi + PAD + t[..., 3 * k + 1]) + a4.view(4, 1)
            cols = e4(xi + PAD + t[..., 3 * k + 2]) + a4.view(1, 4)
            return banks[e4(bi), e4(t[..., 3 * k]), rows, cols]

        return (tap(0) + tap(1) + 1) >> 1  # (H4, W4, 4, 4)

    e5 = lambda t: t[..., None, None, None]  # noqa: E731
    a2 = torch.arange(2, device=dev)
    pl = a2.view(2, 1, 1)

    def mc_chroma(bi, mvx, mvy):
        cxi = ((x0 >> 1) + L(mvx >> 3)).clamp(-(PAD - 4), Wc + PAD - 8)
        cyi = ((y0 >> 1) + L(mvy >> 3)).clamp(-(PAD - 4), Hc + PAD - 8)
        fx, fy = e5(mvx & 7), e5(mvy & 7)

        def tap(dy, dx):
            return cpads[e5(bi), pl, e5(cyi + PAD + dy) + a2.view(1, 2, 1),
                         e5(cxi + PAD + dx) + a2.view(1, 1, 2)]

        return ((8 - fx) * (8 - fy) * tap(0, 0) + fx * (8 - fy) * tap(0, 1)
                + (8 - fx) * fy * tap(1, 0) + fx * fy * tap(1, 1) + 32) >> 6

    p0y, p1y = mc_luma(b0, m0x, m0y), mc_luma(b1, m1x, m1y)
    p0c, p1c = mc_chroma(b0, m0x, m0y), mc_chroma(b1, m1x, m1y)
    mode, ly, lc = wp_mode[sid], wp_ly[sid], wp_lc[sid]

    # --- uni-pred (one list valid) ---
    lst_u = torch.where(v0, 0, 1)
    ri_u = torch.where(v0, i0, i1)
    puy = torch.where(e4(v0), p0y, p1y)
    puc = torch.where(e5(v0), p0c, p1c)

    def weigh(p, w, o, lg):
        return torch.where(lg >= 1,
                           ((p * w + (1 << (lg - 1).clamp(min=0))) >> lg) + o,
                           p * w + o).clamp(0, 255)

    uy_w = weigh(puy, e4(wy[sid, lst_u, ri_u]), e4(oy[sid, lst_u, ri_u]),
                 e4(ly))
    uc_w = weigh(puc, wc[sid, lst_u, ri_u][..., None, None],
                 oc[sid, lst_u, ri_u][..., None, None], e5(lc))
    uni_y = torch.where(e4(mode == 1), uy_w, puy)
    uni_c = torch.where(e5(mode == 1), uc_w, puc)

    # --- bi-pred: explicit weights (mode 1) or implicit pair (mode 2) ---
    iw = wimp[sid, i0, i1]  # (H4, W4, 2)
    imp = mode == 2
    by0 = torch.where(imp, iw[..., 0], wy[sid, 0, i0])
    by1 = torch.where(imp, iw[..., 1], wy[sid, 1, i1])
    bo0 = torch.where(imp, 0, oy[sid, 0, i0])
    bo1 = torch.where(imp, 0, oy[sid, 1, i1])
    lyb = torch.where(imp, 5, ly)
    lcb = torch.where(imp, 5, lc)
    wp_on = mode > 0
    bi_y_w = ((((p0y * e4(by0) + p1y * e4(by1) + e4(1 << lyb)) >> e4(lyb + 1))
               + e4((bo0 + bo1 + 1) >> 1)).clamp(0, 255))
    bi_y = torch.where(e4(wp_on), bi_y_w, (p0y + p1y + 1) >> 1)
    cw = lambda k, tab, i: torch.where(  # noqa: E731
        imp[..., None], iw[..., k, None], tab[sid, k, i])[..., None, None]
    co = lambda k, i: torch.where(  # noqa: E731
        imp[..., None], 0, oc[sid, k, i])[..., None, None]
    bi_c_w = ((((p0c * cw(0, wc, i0) + p1c * cw(1, wc, i1) + e5(1 << lcb))
                >> e5(lcb + 1)) + ((co(0, i0) + co(1, i1) + 1) >> 1))
              .clamp(0, 255))
    bi_c = torch.where(e5(wp_on), bi_c_w, (p0c + p1c + 1) >> 1)

    both, any_v = v0 & v1, v0 | v1
    pred4 = torch.where(e4(any_v), torch.where(e4(both), bi_y, uni_y), 0)
    predc = torch.where(e5(any_v), torch.where(e5(both), bi_c, uni_c), 0)
    pred_y = pred4.permute(0, 2, 1, 3).reshape(H, W).to(i32)
    pred_c = predc.permute(2, 0, 3, 1, 4).reshape(2, Hc, Wc).to(i32)

    # --- residuals (batched per MB) -----------------------------------------
    per = qp // 6
    ils = ils4y[L(qp % 6)]  # (nb, 4, 4)
    d4 = rshift_rnd_sf((lev4 * ils[:, None]) << per.view(nb, 1, 1, 1), 4)
    r4 = TR.inverse4x4(d4)[:, torch.as_tensor(_PERM4, device=dev)]
    res4 = r4.reshape(nb, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(nb, 16, 16)
    ils8 = ils8y[L(qp % 6)]
    d8 = rshift_rnd_sf((lev8 * ils8[:, None]) << per.view(nb, 1, 1, 1), 6)
    res8 = (TR.inverse8x8(d8).reshape(nb, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(nb, 16, 16))
    res = torch.where(t8.view(nb, 1, 1) != 0, res8, res4)
    pmb = pred_y.reshape(n_my, 16, n_mx, 16).permute(0, 2, 1, 3).reshape(
        nb, 16, 16)
    inter = inter_mask.view(nb, 1, 1) != 0
    rec_y = torch.where(inter, ((res + (pmb << 6) + 32) >> 6).clamp(0, 255), 0)
    Y = rec_y.reshape(n_my, n_mx, 16, 16).permute(0, 2, 1, 3).reshape(H, W)

    # chroma residual: DC Hadamard + AC; per-plane InvLevelScale
    cmb = pred_c.reshape(2, n_my, 8, n_mx, 8).permute(1, 3, 0, 2, 4).reshape(
        nb, 2, 8, 8)
    dch = TR.hadamard2x2(dcc)
    ilsc = ils4c[a2.view(1, 2), L(qpc % 6)]  # (nb, 2, 4, 4)
    perc = (qpc // 6).view(nb, 2, 1, 1)
    t = dch * ilsc[..., :1, :1]
    dcd = torch.where(perc < 5, t >> (5 - perc).clamp(min=0),
                      t << (perc - 5).clamp(min=0))
    deqc = rshift_rnd_sf((levc * ilsc[:, :, None]) << perc[..., None], 4)
    deqc[..., 0, 0] = dcd.reshape(nb, 2, 4)
    resc = (TR.inverse4x4(deqc).reshape(nb, 2, 2, 2, 4, 4)
            .permute(0, 1, 2, 4, 3, 5).reshape(nb, 2, 8, 8))
    rec_c = torch.where(inter[..., None],
                        ((resc + (cmb << 6) + 32) >> 6).clamp(0, 255), 0)
    C = rec_c.reshape(n_my, n_mx, 2, 8, 8).permute(2, 0, 3, 1, 4).reshape(
        2, Hc, Wc)
    return torch.cat([Y.reshape(-1), C[0].reshape(-1),
                      C[1].reshape(-1)]).to(i32)


# ---------------------------------------------------------------------------
# bank cache on decoded pictures
# ---------------------------------------------------------------------------

def picture_bank(pic, device):
    """(bank, cpad) of a DecodedPicture on `device`, built once with K2
    and cached on the picture."""
    ent = getattr(pic, "_device_bank", None)
    if ent is None or ent[0].device != device:
        pl = pic.planes
        ent = ref_bank(*(torch.as_tensor(np.ascontiguousarray(p, np.int32),
                                         device=device)
                         for p in (pl.Y, pl.U, pl.V)))
        pic._device_bank = ent
    return ent


# ---------------------------------------------------------------------------
# K8's arguments and launch for one picture
# ---------------------------------------------------------------------------

def decode_inter_args(state, sps, pps, slice_lists, slice_wp, device):
    """The arguments of K8 for one picture: (tensors, inter mask) or None
    when no MB is inter.

    slice_lists: per slice id [list0 pics, list1 pics]; slice_wp: per
    slice id build_wp_params() dict or None."""
    H, W = sps.height, sps.width
    NS = max(1, len(slice_lists))

    # unified bank table
    pics = []
    pic_ids = {}
    refmap = np.zeros((NS, 2, MAXREF), np.int32)
    for sid, lists in enumerate(slice_lists):
        for lst in (0, 1):
            for ri, p in enumerate(lists[lst][:MAXREF]):
                key = id(p)
                if key not in pic_ids:
                    pic_ids[key] = len(pics)
                    pics.append(p)
                refmap[sid, lst, ri] = pic_ids[key]
    if not pics:
        return None

    # WP tables
    wp_mode = np.zeros(NS, np.int32)
    wp_ly = np.zeros(NS, np.int32)
    wp_lc = np.zeros(NS, np.int32)
    wy = np.ones((NS, 2, MAXREF), np.int32)
    oy = np.zeros((NS, 2, MAXREF), np.int32)
    wc = np.ones((NS, 2, MAXREF, 2), np.int32)
    oc = np.zeros((NS, 2, MAXREF, 2), np.int32)
    wimp = np.full((NS, MAXREF, MAXREF, 2), 32, np.int32)
    for sid, wp in enumerate(slice_wp):
        if wp is None:
            continue
        wp_mode[sid] = wp["mode"]
        wp_ly[sid] = wp["ly"]
        wp_lc[sid] = wp["lc"]
        if wp["mode"] == 1:
            for lst in (0, 1):
                for ri, pw in enumerate(wp["w"][lst][:MAXREF]):
                    wy[sid, lst, ri] = pw.luma_weight
                    oy[sid, lst, ri] = pw.luma_offset
                    wc[sid, lst, ri] = pw.chroma_weight
                    oc[sid, lst, ri] = pw.chroma_offset
        else:
            for (i, j), (w0, w1) in wp["tab"].items():
                if i < MAXREF and j < MAXREF:
                    wimp[sid, i, j] = (w0, w1)

    # inverse level scales: DEQUANT * WeightScale (inter lists 3/7, 4/5)
    from ..syntax.parsets import effective_scaling

    ws = effective_scaling(sps, pps)
    if ws is None:
        ils4y, ils8y = _ILS4, _ILS8
        ils4c = np.stack([_ILS4, _ILS4])
    else:
        ws4, ws8 = ws
        ils4y = (Q.DEQUANT4 * ws4[3]).astype(np.int32)
        ils8y = (Q.DEQUANT8 * ws8[1]).astype(np.int32)
        ils4c = np.stack([(Q.DEQUANT4 * ws4[4]).astype(np.int32),
                          (Q.DEQUANT4 * ws4[5]).astype(np.int32)])

    sid_mb = np.asarray(state.slice_id)
    inter = (sid_mb >= 0) & (np.asarray(state.is_intra) == 0) \
        & (np.asarray(state.mb_type) >= 0)
    if not inter.any():
        return None
    sid4 = np.repeat(np.repeat(sid_mb.reshape(state.H, state.W), 4, 0), 4, 1)

    ents = [picture_bank(p, device) for p in pics]
    banks = torch.stack([e[0] for e in ents])
    cpads = torch.stack([e[1] for e in ents])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    args = (banks, cpads, *map(t, (
        refmap, state.mv, state.ref_idx, sid4, wp_mode, wp_ly, wp_lc, wy, oy,
        wc, oc, wimp, state.qp, state.qpc, state.transform8x8,
        state.luma_levels, state.luma8_levels, state.chroma_levels,
        state.chroma_dc, inter, ils4y, ils8y, ils4c)))
    return args, inter


def decode_inter_picture(state, sps, pps, planes, slice_infos, slice_lists,
                         slice_wp, device):
    """Launch K8 for the picture's inter MBs on `device`.

    Returns None when no MB is inter, else (inter_mask (nb,), finalize):
    finalize() makes the one device-to-host copy and writes the inter
    MBs' pixels into `planes`; call it after the host work so the copy
    waits under it."""
    built = decode_inter_args(state, sps, pps, slice_lists, slice_wp, device)
    if built is None:
        return None
    args, inter = built
    H, W = sps.height, sps.width
    packed = decode_inter(*args, H=H, W=W, NS=args[2].shape[0])

    def finalize():
        flat = packed.cpu().numpy()
        Hc, Wc = H // 2, W // 2
        Yh = flat[: H * W].reshape(H, W)
        Uh = flat[H * W: H * W + Hc * Wc].reshape(Hc, Wc)
        Vh = flat[H * W + Hc * Wc:].reshape(Hc, Wc)
        m16 = np.repeat(np.repeat(inter.reshape(state.H, state.W), 16, 0),
                        16, 1)
        m8 = np.repeat(np.repeat(inter.reshape(state.H, state.W), 8, 0),
                       8, 1)
        planes.Y[m16] = Yh[m16]
        planes.U[m8] = Uh[m8]
        planes.V[m8] = Vh[m8]

    return inter, finalize
