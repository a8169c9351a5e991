"""Picture reconstruction from parsed SE tensors — host (numpy) oracle.

This is the sequential bit-exact reference path; the batched JAX
wavefront reconstruction is validated against it.  Arithmetic matches
the reference decoder (ldecod/src/block.c itrans/itrans_2,
macroblock.c decode_one_macroblock, transform8x8.c itrans8x8).
"""

from __future__ import annotations

import numpy as np

from ..ops import interp as MC
from ..ops import intra as IP
from ..ops import quant as Q
from ..ops import transforms as TR
from ..ops.exact import rshift_rnd_sf
from ..syntax.parsets import PPS, SPS
from . import mbtables as M
from .state import PictureParseState


class Planes:
    """Decoded picture sample planes (int32 while reconstructing)."""

    def __init__(self, sps: SPS):
        self.Y = np.zeros((sps.height, sps.width), np.int32)
        cw, ch = sps.mb_chroma_size
        H = sps.frame_height_in_mbs
        W = sps.pic_width_in_mbs
        if sps.chroma_format_idc:
            self.U = np.zeros((H * ch, W * cw), np.int32)
            self.V = np.zeros((H * ch, W * cw), np.int32)
        else:
            self.U = self.V = None

    def to_yuv_bytes(self) -> bytes:
        out = self.Y.astype(np.uint8).tobytes()
        if self.U is not None:
            out += self.U.astype(np.uint8).tobytes()
            out += self.V.astype(np.uint8).tobytes()
        return out


def _add_residual(pred, res_scaled, max_val=255):
    """itrans tail: rshift_rnd_sf(res + (pred << 6), 6), clipped."""
    return rshift_rnd_sf(res_scaled + (pred.astype(np.int64) << 6), 6).clip(
        0, max_val
    ).astype(np.int32)


# ---------------------------------------------------------------------------
# Weighted prediction (spec §8.4.2.3; ldecod/src/mc_prediction.c:59-148
# mc_prediction/weighted_mc_prediction/weighted_bi_prediction)
# ---------------------------------------------------------------------------

def build_wp_params(sh, pps, lists, cur_poc):
    """Per-slice weighted-prediction parameters, or None when WP is off.

    Explicit (P weighted_pred_flag / B weighted_bipred_idc==1): weights
    straight from the slice header's pred_weight_table. Implicit (B
    weighted_bipred_idc==2): per-(i,j) weight pairs from POC distances
    (logWD=5, offsets 0), matching ldecod/src/image.c:1992 fill_wp_params.
    """
    from ..syntax.slice_header import SliceType
    from .mv import dist_scale_factor

    st = sh.slice_type
    if st in (SliceType.P, SliceType.SP) and pps.weighted_pred_flag:
        mode = 1
    elif st == SliceType.B and pps.weighted_bipred_idc:
        mode = pps.weighted_bipred_idc
    else:
        return None
    if mode == 1:
        return {
            "mode": 1,
            "ly": sh.luma_log2_weight_denom,
            "lc": sh.chroma_log2_weight_denom,
            "w": sh.pred_weights,
        }
    tab = {}
    for i, p0 in enumerate(lists[0]):
        for j, p1 in enumerate(lists[1]):
            if p0.poc == p1.poc or p0.long_term or p1.long_term:
                tab[(i, j)] = (32, 32)
                continue
            w1 = dist_scale_factor(cur_poc, p0.poc, p1.poc) >> 2
            if w1 < -64 or w1 > 128:
                tab[(i, j)] = (32, 32)
            else:
                tab[(i, j)] = (64 - w1, w1)
    return {"mode": 2, "ly": 5, "lc": 5, "tab": tab}


def _wp_uni(pred, w, o, logwd, max_val):
    p = pred.astype(np.int64)
    if logwd >= 1:
        out = ((p * w + (1 << (logwd - 1))) >> logwd) + o
    else:
        out = p * w + o
    return out.clip(0, max_val).astype(np.int32)


def _wp_bi(p0, p1, w0, o0, w1, o1, logwd, max_val):
    a = p0.astype(np.int64) * w0
    b = p1.astype(np.int64) * w1
    out = ((a + b + (1 << logwd)) >> (logwd + 1)) + ((o0 + o1 + 1) >> 1)
    return out.clip(0, max_val).astype(np.int32)


class IntraReconstructor:
    """Reconstructs intra MBs (I4/I8/I16/IPCM + chroma) in raster order."""

    def __init__(self, st: PictureParseState, sps: SPS, pps: PPS, planes: Planes):
        self.st = st
        self.sps = sps
        self.pps = pps
        self.pl = planes
        self.dc_y = 1 << (sps.bit_depth_luma - 1)
        self.dc_c = 1 << (sps.bit_depth_chroma - 1)
        self.max_y = (1 << sps.bit_depth_luma) - 1
        self.max_c = (1 << sps.bit_depth_chroma) - 1
        # effective scaling (WeightScale) matrices; None = flat 16
        from ..syntax.parsets import effective_scaling

        ws = effective_scaling(sps, pps)
        self.ws4, self.ws8 = ws if ws is not None else (None, None)

    def _w4(self, idx: int):
        """WeightScale4x4 list idx (0..5) or None (flat)."""
        return None if self.ws4 is None else self.ws4[idx]

    def _w8(self, idx: int):
        return None if self.ws8 is None else self.ws8[idx]

    # -- neighbor sample gathering ---------------------------------------
    def _avail_for_intra(self, avail: bool, nb_addr: int) -> bool:
        if not avail:
            return False
        if self.pps.constrained_intra_pred_flag:
            return bool(self.st.is_intra[nb_addr])
        return True

    def recon_mb(self, addr: int):
        st = self.st
        mbt = int(st.mb_type[addr])
        if mbt == M.IPCM:
            self._recon_ipcm(addr)
            return
        if mbt == M.I4MB:
            self._recon_i4(addr)
        elif mbt == M.I8MB:
            self._recon_i8(addr)
        elif mbt == M.I16MB:
            self._recon_i16(addr)
        else:
            raise NotImplementedError(f"inter mb_type {mbt} at {addr}")
        if self.sps.chroma_format_idc:
            self._recon_chroma_intra(addr)

    # -- IPCM --------------------------------------------------------------
    def _recon_ipcm(self, addr: int):
        st, pl = self.st, self.pl
        W = st.W
        mx, my = (addr % W) * 16, (addr // W) * 16
        luma, cb, cr = st.ipcm_samples[addr]
        pl.Y[my : my + 16, mx : mx + 16] = luma
        cw, ch = self.sps.mb_chroma_size
        cx, cy = (addr % W) * cw, (addr // W) * ch
        pl.U[cy : cy + ch, cx : cx + cw] = cb
        pl.V[cy : cy + ch, cx : cx + cw] = cr

    # -- intra 4x4 ---------------------------------------------------------
    def _recon_i4(self, addr: int):
        st, pl = self.st, self.pl
        W = st.W
        mx, my = (addr % W) * 16, (addr // W) * 16
        qp = int(st.qp[addr])
        x4o, y4o = st.mb_block_origin(addr)
        for blk in range(16):
            bx, by = M.BLK4_TO_XY[blk]
            ioff, joff = int(bx) * 4, int(by) * 4
            px, py = mx + ioff, my + joff
            mode = int(st.ipredmode[y4o + by, x4o + bx])
            pred = self._pred_block4(addr, ioff, joff, px, py, mode)
            levels = st.luma_levels[addr, blk]
            if levels.any():
                coef = Q.dequant4x4(levels, qp, self._w4(0))
                res = TR.inverse4x4(coef.astype(np.int64))
                rec = _add_residual(pred, res, self.max_y)
            else:
                rec = pred
            pl.Y[py : py + 4, px : px + 4] = rec

    def _pred_block4(self, addr, ioff, joff, px, py, mode):
        st, pl = self.st, self.pl
        la, lmb, *_ = st.luma4x4_neighbor(addr, ioff - 1, joff)
        ua, umb, *_ = st.luma4x4_neighbor(addr, ioff, joff - 1)
        ura, urmb, *_ = st.luma4x4_neighbor(addr, ioff + 4, joff - 1)
        ula, ulmb, *_ = st.luma4x4_neighbor(addr, ioff - 1, joff - 1)
        # JM: kill up-right for blocks 3 and 11 positions (not yet decoded)
        if ioff == 4 and (joff == 4 or joff == 12):
            ura = False
        avail_l = self._avail_for_intra(la, lmb)
        avail_u = self._avail_for_intra(ua, umb)
        avail_ur = self._avail_for_intra(ura, urmb)
        avail_ul = self._avail_for_intra(ula, ulmb)
        Y = pl.Y
        up = Y[py - 1, px : px + 4] if avail_u else None
        upright = Y[py - 1, px + 4 : px + 8] if avail_ur else None
        left = Y[py : py + 4, px - 1] if avail_l else None
        upleft = Y[py - 1, px - 1] if avail_ul else 0
        return IP.pred4x4(
            mode,
            up.tolist() if up is not None else None,
            upright.tolist() if upright is not None else None,
            left.tolist() if left is not None else None,
            int(upleft),
            avail_u,
            avail_l,
            avail_ul,
            avail_ur,
            self.dc_y,
        )

    # -- intra 8x8 ---------------------------------------------------------
    def _recon_i8(self, addr: int):
        st, pl = self.st, self.pl
        W = st.W
        mx, my = (addr % W) * 16, (addr // W) * 16
        qp = int(st.qp[addr])
        x4o, y4o = st.mb_block_origin(addr)
        for b8 in range(4):
            ioff, joff = (b8 & 1) * 8, (b8 >> 1) * 8
            px, py = mx + ioff, my + joff
            mode = int(st.ipredmode[y4o + (b8 >> 1) * 2, x4o + (b8 & 1) * 2])
            la, lmb, *_ = st.luma4x4_neighbor(addr, ioff - 1, joff)
            ua, umb, *_ = st.luma4x4_neighbor(addr, ioff, joff - 1)
            ura, urmb, *_ = st.luma4x4_neighbor(addr, ioff + 8, joff - 1)
            ula, ulmb, *_ = st.luma4x4_neighbor(addr, ioff - 1, joff - 1)
            if ioff == 8 and joff == 8:
                ura = False
            avail_l = self._avail_for_intra(la, lmb)
            avail_u = self._avail_for_intra(ua, umb)
            avail_ur = self._avail_for_intra(ura, urmb)
            avail_ul = self._avail_for_intra(ula, ulmb)
            Y = pl.Y
            up = Y[py - 1, px : px + 8] if avail_u else None
            upright = Y[py - 1, px + 8 : px + 16] if avail_ur else None
            if avail_ur and upright.shape[0] < 8:  # picture edge padding
                upright = np.pad(upright, (0, 8 - upright.shape[0]), mode="edge")
            left = Y[py : py + 8, px - 1] if avail_l else None
            upleft = int(Y[py - 1, px - 1]) if avail_ul else 0
            Pf, Lf = IP.filter_ref_8x8(
                up, upright, left, upleft, avail_u, avail_l, avail_ul, avail_ur,
                self.dc_y,
            )
            pred = IP.pred8x8(mode, Pf, Lf, avail_u, avail_l, avail_ul, self.dc_y)
            levels = st.luma8_levels[addr, b8]
            if levels.any():
                coef = Q.dequant8x8(levels, qp, self._w8(0))
                res = TR.inverse8x8(coef.astype(np.int64))
                rec = _add_residual(pred, res, self.max_y)
            else:
                rec = pred
            pl.Y[py : py + 8, px : px + 8] = rec

    # -- intra 16x16 -------------------------------------------------------
    def _recon_i16(self, addr: int):
        st, pl = self.st, self.pl
        W = st.W
        mx, my = (addr % W) * 16, (addr // W) * 16
        qp = int(st.qp[addr])
        up_mb = st.mb_up(addr)
        left_mb = st.mb_left(addr)
        ul_a, ul_mb, *_ = st.luma4x4_neighbor(addr, -1, -1)
        avail_u = self._avail_for_intra(up_mb >= 0, up_mb)
        avail_l = self._avail_for_intra(left_mb >= 0, left_mb)
        avail_ul = self._avail_for_intra(ul_a, ul_mb)
        Y = pl.Y
        up = Y[my - 1, mx : mx + 16] if avail_u else np.zeros(16, np.int32)
        left = Y[my : my + 16, mx - 1] if avail_l else np.zeros(16, np.int32)
        upleft = int(Y[my - 1, mx - 1]) if avail_ul else 0
        mode = int(st.i16mode[addr])
        pred = IP.pred16x16(
            mode, up, left, upleft, avail_u, avail_l, avail_ul, self.dc_y,
            self.sps.bit_depth_luma,
        )
        # DC path: inverse Hadamard of DC levels, then dequant
        dc_had = TR.hadamard4x4(st.luma_dc[addr].astype(np.int64))
        # NB: itrans_2 uses plain butterflies (no >>1), which hadamard4x4 is
        dc = Q.dequant_luma_dc(dc_had, qp, self._w4(0))
        rec = np.empty((16, 16), np.int32)
        for blk in range(16):
            bx, by = M.BLK4_TO_XY[blk]
            levels = st.luma_levels[addr, blk]
            coef = Q.dequant4x4(levels, qp, self._w4(0)).astype(np.int64)
            coef[0, 0] = dc[by, bx]
            res = TR.inverse4x4(coef)
            rec[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = _add_residual(
                pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4], res, self.max_y
            )
        pl.Y[my : my + 16, mx : mx + 16] = rec

    # -- chroma ------------------------------------------------------------
    def _recon_chroma_intra(self, addr: int):
        st, pl = self.st, self.pl
        cw, ch = self.sps.mb_chroma_size
        W = st.W
        cx, cy = (addr % W) * cw, (addr // W) * ch
        mode = int(st.c_ipred_mode[addr])
        up_mb = st.mb_up(addr)
        left_mb = st.mb_left(addr)
        ul_a, ul_mb = st.chroma4x4_neighbor(addr, -1, -1, cw, ch)[:2]
        avail_u = self._avail_for_intra(up_mb >= 0, up_mb)
        avail_l = self._avail_for_intra(left_mb >= 0, left_mb)
        for uv, plane in ((0, pl.U), (1, pl.V)):
            qp_c = int(st.qpc[addr, uv])
            up = plane[cy - 1, cx : cx + cw] if avail_u else np.zeros(cw, np.int32)
            left = plane[cy : cy + ch, cx - 1] if avail_l else np.zeros(ch, np.int32)
            upleft = int(plane[cy - 1, cx - 1]) if (avail_u and avail_l and ul_a) else 0
            pred = IP.pred_chroma(
                mode, up, left, upleft, avail_u, avail_l, cw, ch, self.dc_c,
                self.sps.bit_depth_chroma,
            )
            self._chroma_residual(addr, uv, plane, pred, cx, cy, qp_c)

    def _chroma_residual(self, addr, uv, plane, pred, cx, cy, qp_c):
        st = self.st
        cw, ch = self.sps.mb_chroma_size
        # DC: 2x2 hadamard of parsed DC levels, dequant (truncating shifts)
        dch = TR.hadamard2x2(st.chroma_dc[addr, uv].astype(np.int64))
        dc = Q.dequant_chroma_dc(dch, qp_c, self._w4(1 + uv))
        rec = np.empty((ch, cw), np.int32)
        for blk in range(4):
            bx, by = blk & 1, blk >> 1
            levels = st.chroma_levels[addr, uv, blk]
            coef = Q.dequant4x4(levels, qp_c, self._w4(1 + uv)).astype(np.int64)
            coef[0, 0] = dc[by, bx]
            res = TR.inverse4x4(coef)
            rec[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = _add_residual(
                pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4], res, self.max_c
            )
        plane[cy : cy + ch, cx : cx + cw] = rec


class PictureReconstructor(IntraReconstructor):
    """Full picture reconstruction: intra + inter MBs.

    `ref_planes[lst]` maps ref_idx -> padded reference planes
    (Ypad, Upad, Vpad) per slice; provided per slice id.
    """

    def __init__(self, st, sps, pps, planes, slice_refs, slice_wp=None,
                 slice_cadj=None):
        super().__init__(st, sps, pps, planes)
        # slice_refs: per slice id: [list0, list1] where each is a list of
        # (Ypad, Upad, Vpad) tuples (padded with MC.PAD)
        self.slice_refs = slice_refs
        # slice_wp: per slice id: None or build_wp_params() dict
        self.slice_wp = slice_wp or [None] * len(slice_refs)
        # slice_cadj: per slice id: [list0 adj, list1 adj] chroma vertical
        # MV adjustment per ref (0 / +2 / -2 quarter-luma units) for
        # opposite-parity field references (spec §8.4.1.4.1)
        self.slice_cadj = slice_cadj

    def recon_mb(self, addr: int):
        st = self.st
        mbt = int(st.mb_type[addr])
        if st.is_intra[addr]:
            super().recon_mb(addr)
            return
        self._recon_inter(addr)

    def _recon_inter(self, addr: int):
        st, pl = self.st, self.pl
        W = st.W
        mx, my = (addr % W) * 16, (addr // W) * 16
        x4, y4 = st.mb_block_origin(addr)
        sid = int(st.slice_id[addr])
        refs = self.slice_refs[sid]
        wp = self.slice_wp[sid]
        width, height = self.sps.width, self.sps.height
        cw, ch = self.sps.mb_chroma_size
        cwidth, cheight = width >> 1, height >> 1

        pred_y = np.empty((16, 16), np.int32)
        pred_u = np.empty((ch, cw), np.int32)
        pred_v = np.empty((ch, cw), np.int32)

        for by in range(4):
            for bx in range(4):
                px, py = mx + bx * 4, my + by * 4
                preds_y, preds_u, preds_v = [], [], []
                used = []  # (lst, ref_idx) parallel to preds_*
                for lst in (0, 1):
                    ref = int(st.ref_idx[lst, y4 + by, x4 + bx])
                    if ref < 0:
                        continue
                    used.append((lst, ref))
                    mvx = int(st.mv[lst, y4 + by, x4 + bx, 0])
                    mvy = int(st.mv[lst, y4 + by, x4 + bx, 1])
                    Ypad, Upad, Vpad = refs[lst][ref]
                    xi = px + (mvx >> 2)
                    yi = py + (mvy >> 2)
                    dx, dy = mvx & 3, mvy & 3
                    xi = max(-(MC.PAD - 8), min(width + MC.PAD - 12, xi))
                    yi = max(-(MC.PAD - 8), min(height + MC.PAD - 12, yi))
                    preds_y.append(
                        MC.luma_block(Ypad, MC.PAD, xi, yi, dx, dy, 4, 4, self.max_y)
                    )
                    # chroma: eighth-pel from the same MV (+- parity
                    # adjustment for opposite-parity field refs)
                    cvy = mvy
                    if self.slice_cadj is not None:
                        cvy = mvy + self.slice_cadj[sid][lst][ref]
                    cx_full = (px >> 1) + (mvx >> 3)
                    cy_full = (py >> 1) + (cvy >> 3)
                    fx, fy = mvx & 7, cvy & 7
                    cx_full = max(-(MC.PAD - 4), min(cwidth + MC.PAD - 8, cx_full))
                    cy_full = max(-(MC.PAD - 4), min(cheight + MC.PAD - 8, cy_full))
                    preds_u.append(
                        MC.chroma_block(Upad, MC.PAD, cx_full, cy_full, fx, fy, 2, 2)
                    )
                    preds_v.append(
                        MC.chroma_block(Vpad, MC.PAD, cx_full, cy_full, fx, fy, 2, 2)
                    )
                if not preds_y:
                    raise ValueError(f"no prediction for inter block at MB {addr}")
                if len(preds_y) == 2:
                    if wp is not None:
                        i0, i1 = used[0][1], used[1][1]
                        if wp["mode"] == 2:
                            wy0, wy1 = wp["tab"][(i0, i1)]
                            oy0 = oy1 = 0
                            wcpair = (((wy0, 0), (wy0, 0)), ((wy1, 0), (wy1, 0)))
                        else:
                            pw0, pw1 = wp["w"][0][i0], wp["w"][1][i1]
                            wy0, oy0 = pw0.luma_weight, pw0.luma_offset
                            wy1, oy1 = pw1.luma_weight, pw1.luma_offset
                            wcpair = (
                                tuple(zip(pw0.chroma_weight, pw0.chroma_offset)),
                                tuple(zip(pw1.chroma_weight, pw1.chroma_offset)),
                            )
                        yblk = _wp_bi(preds_y[0], preds_y[1], wy0, oy0,
                                      wy1, oy1, wp["ly"], self.max_y)
                        ublk = _wp_bi(preds_u[0], preds_u[1],
                                      wcpair[0][0][0], wcpair[0][0][1],
                                      wcpair[1][0][0], wcpair[1][0][1],
                                      wp["lc"], self.max_c)
                        vblk = _wp_bi(preds_v[0], preds_v[1],
                                      wcpair[0][1][0], wcpair[0][1][1],
                                      wcpair[1][1][0], wcpair[1][1][1],
                                      wp["lc"], self.max_c)
                    else:
                        yblk = (preds_y[0] + preds_y[1] + 1) >> 1
                        ublk = (preds_u[0] + preds_u[1] + 1) >> 1
                        vblk = (preds_v[0] + preds_v[1] + 1) >> 1
                elif wp is not None and wp["mode"] == 1:
                    lst0, i0 = used[0]
                    pw = wp["w"][lst0][i0]
                    yblk = _wp_uni(preds_y[0], pw.luma_weight, pw.luma_offset,
                                   wp["ly"], self.max_y)
                    ublk = _wp_uni(preds_u[0], pw.chroma_weight[0],
                                   pw.chroma_offset[0], wp["lc"], self.max_c)
                    vblk = _wp_uni(preds_v[0], pw.chroma_weight[1],
                                   pw.chroma_offset[1], wp["lc"], self.max_c)
                else:
                    yblk, ublk, vblk = preds_y[0], preds_u[0], preds_v[0]
                pred_y[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = yblk
                pred_u[by * 2 : by * 2 + 2, bx * 2 : bx * 2 + 2] = ublk
                pred_v[by * 2 : by * 2 + 2, bx * 2 : bx * 2 + 2] = vblk

        # --- luma residual ---
        qp = int(st.qp[addr])
        rec = pred_y
        if st.transform8x8[addr]:
            out = np.empty((16, 16), np.int32)
            for b8 in range(4):
                ioff, joff = (b8 & 1) * 8, (b8 >> 1) * 8
                levels = st.luma8_levels[addr, b8]
                if levels.any():
                    coef = Q.dequant8x8(levels, qp, self._w8(1))
                    res = TR.inverse8x8(coef.astype(np.int64))
                    out[joff : joff + 8, ioff : ioff + 8] = _add_residual(
                        pred_y[joff : joff + 8, ioff : ioff + 8], res, self.max_y
                    )
                else:
                    out[joff : joff + 8, ioff : ioff + 8] = pred_y[
                        joff : joff + 8, ioff : ioff + 8
                    ]
            rec = out
        else:
            out = np.empty((16, 16), np.int32)
            for blk in range(16):
                bx, by = M.BLK4_TO_XY[blk]
                ioff, joff = int(bx) * 4, int(by) * 4
                levels = st.luma_levels[addr, blk]
                if levels.any():
                    coef = Q.dequant4x4(levels, qp, self._w4(3))
                    res = TR.inverse4x4(coef.astype(np.int64))
                    out[joff : joff + 4, ioff : ioff + 4] = _add_residual(
                        pred_y[joff : joff + 4, ioff : ioff + 4], res, self.max_y
                    )
                else:
                    out[joff : joff + 4, ioff : ioff + 4] = pred_y[
                        joff : joff + 4, ioff : ioff + 4
                    ]
            rec = out
        pl.Y[my : my + 16, mx : mx + 16] = rec

        # --- chroma residual ---
        cx, cy = (addr % W) * cw, (addr // W) * ch
        for uv, (plane, pred) in enumerate(((pl.U, pred_u), (pl.V, pred_v))):
            qp_c = int(st.qpc[addr, uv])
            self._chroma_residual_inter(addr, uv, plane, pred, cx, cy, qp_c)

    def _chroma_residual_inter(self, addr, uv, plane, pred, cx, cy, qp_c):
        st = self.st
        cw, ch = self.sps.mb_chroma_size
        dch = TR.hadamard2x2(st.chroma_dc[addr, uv].astype(np.int64))
        dc = Q.dequant_chroma_dc(dch, qp_c, self._w4(4 + uv))
        rec = np.empty((ch, cw), np.int32)
        for blk in range(4):
            bx, by = blk & 1, blk >> 1
            levels = st.chroma_levels[addr, uv, blk]
            coef = Q.dequant4x4(levels, qp_c, self._w4(4 + uv)).astype(np.int64)
            coef[0, 0] = dc[by, bx]
            if coef.any():
                res = TR.inverse4x4(coef)
                rec[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = _add_residual(
                    pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4], res, self.max_c
                )
            else:
                rec[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = pred[
                    by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4
                ]
        plane[cy : cy + ch, cx : cx + cw] = rec
