"""CAVLC slice-data writer: PictureParseState -> slice bits.

The encoder's interchange format is the same per-picture SE tensor set
the decoder parses into; this module serializes it (spec §7.3.5 +
§9.1/9.2; reference: lencod/src/macroblock.c writeMBLayer:2582,
writeCoeff4x4_CAVLC:4099, vlc.c writers).  Host-serial by design — the
per-slice tail of the pipeline (SURVEY.md §7.1).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.writer import BitWriter
from ..decoder import mbtables as M
from ..decoder.state import PictureParseState
from ..entropy.cavlc import tables as T
from ..entropy.cavlc.enc import encode_block
from ..syntax.parsets import PPS, SPS
from ..syntax.slice_header import SliceHeader, SliceType

_ZZ4 = M.ZZ_SCAN_4x4
_ZZ8 = M.ZZ_SCAN_8x8
# encoder-side NCBP maps cbp -> codeNum directly (lencod/src/vlc.c
# linfo_cbp_intra: ue(NCBP[1][cbp][0]))
_CBP_CODE_INTRA = {cbp: T.NCBP[1][cbp][0] for cbp in range(48)}
_CBP_CODE_INTER = {cbp: T.NCBP[1][cbp][1] for cbp in range(48)}

# B-slice mb_type inverses (mbtables B_PDIR_* maps raw -> pdirs)
_B_16x8_CODE = {pd: raw for raw, pd in M.B_PDIR_16x8.items()}
_B_8x16_CODE = {pd: raw for raw, pd in M.B_PDIR_8x16.items()}
_SUB_MB_B_CODE = {mp: v for v, mp in enumerate(M.SUB_MB_B)}

DC_PRED = 2


class CavlcSliceWriter:
    def __init__(self, st: PictureParseState, sps: SPS, pps: PPS, sh: SliceHeader):
        self.st = st
        self.sps = sps
        self.pps = pps
        self.sh = sh
        # nC context state, written in coding order (JM nz_coeff semantics)
        self.nnz = np.zeros((3, 4 * st.H, 4 * st.W), np.int32)
        self.qp = sh.slice_qp(pps)
        self.trace: list | None = None

    def _t(self, *vals):
        if self.trace is not None:
            self.trace.append(vals)

    # ------------------------------------------------------------------
    def write_slice_data(self, w: BitWriter, mb_addrs: list[int],
                         wB: BitWriter | None = None,
                         wC: BitWriter | None = None):
        """Serialize the slice.  When wB/wC are given, slice data is split
        into partitions: headers/motion/CBP/dquant -> w (partition A),
        intra residual blocks -> wB, inter residual blocks -> wC
        (spec §7.3.2.8-.10; lencod/src/header.c:41 assignSE2partition_DP)."""
        st = self.st
        is_pb = self.sh.slice_type in (SliceType.P, SliceType.SP, SliceType.B)
        whole_frame = (
            mb_addrs
            and mb_addrs[0] == 0
            and len(mb_addrs) == st.n_mbs
            and mb_addrs[-1] == st.n_mbs - 1
        )
        if (
            self.trace is None
            and wB is None
            and whole_frame  # native writer assumes full-frame neighbors
            and self.sh.slice_type != SliceType.B
            and self._try_native(w, mb_addrs, is_pb)
        ):
            return
        skip_run = 0
        for addr in mb_addrs:
            if is_pb and st.skip_flag[addr]:
                skip_run += 1
                continue
            if is_pb:
                w.ue(skip_run)
                skip_run = 0
            self._write_mb(w, addr, wB=wB, wC=wC)
        if is_pb and skip_run:
            w.ue(skip_run)

    # ------------------------------------------------------------------
    def _write_mb(self, w: BitWriter, addr: int, wB=None, wC=None):
        st = self.st
        mbt = int(st.mb_type[addr])
        is_p = self.sh.slice_type in (SliceType.P, SliceType.SP)
        is_b = self.sh.slice_type == SliceType.B
        cbp = int(st.cbp[addr])

        # mb_type
        if mbt == M.I16MB:
            i16off = (
                int(st.i16mode[addr])
                + 4 * {0: 0, 16: 1, 32: 2, 15: 3, 31: 4, 47: 5}[cbp]
            )
            val = (24 if is_b else 6 if is_p else 1) + i16off
        elif mbt in (M.I4MB, M.I8MB):
            val = 23 if is_b else 5 if is_p else 0
        elif is_b:
            val = self._b_mb_type(addr, mbt)
        elif mbt in (M.P16x16, M.P16x8, M.P8x16):
            val = mbt - 1
        elif mbt == M.P8x8:
            val = 3
        else:
            raise NotImplementedError(f"mb_type {mbt} in CAVLC writer")
        w.ue(val)
        self._t("mb_type", val)

        x4, y4 = st.mb_block_origin(addr)

        if mbt == M.P8x8:
            for b8 in range(4):
                b8m = int(st.b8mode[addr][b8])
                if is_b:
                    sub_val = _SUB_MB_B_CODE[(b8m, int(st.b8pdir[addr][b8]))]
                else:
                    sub_val = {M.B8_8x8: 0, M.B8_8x4: 1, M.B8_4x8: 2,
                               M.B8_4x4: 3}[b8m]
                w.ue(sub_val)

        # transform_size_8x8_flag for I_NxN (before intra pred modes,
        # lencod/src/macroblock.c UVLC write order)
        if mbt in (M.I4MB, M.I8MB) and self.pps.transform_8x8_mode_flag:
            w.u(1 if mbt == M.I8MB else 0, 1)

        # intra prediction info
        if mbt in (M.I4MB, M.I8MB):
            step = 2 if mbt == M.I8MB else 1
            for b8 in range(4):
                for j in range(0, 2, step):
                    for i in range(0, 2, step):
                        bx = ((b8 & 1) << 1) + i
                        by = (b8 & 2) + j
                        mode = int(st.ipredmode[y4 + by, x4 + bx])
                        mpm = self._mpm(addr, bx, by)
                        if mode == mpm:
                            w.u(1, 1)
                            self._t("ipred", -1)
                        else:
                            rem = mode if mode < mpm else mode - 1
                            w.u(0, 1)
                            w.u(rem, 3)
                            self._t("ipred", rem)
        if mbt in (M.I4MB, M.I8MB, M.I16MB):
            w.ue(int(st.c_ipred_mode[addr]))
            self._t("cipred", int(st.c_ipred_mode[addr]))

        # motion info
        if mbt in (M.P16x16, M.P16x8, M.P8x16, M.P8x8):
            self._write_motion(w, addr, mbt)

        # cbp
        if mbt != M.I16MB:
            table = (_CBP_CODE_INTRA if mbt in (M.I4MB, M.I8MB)
                     else _CBP_CODE_INTER)
            w.ue(table[cbp])
            self._t("cbp", cbp)

        # inter transform_size_8x8_flag after CBP (need_transform_size,
        # lencod/src/macroblock.c:2915 UVLC write point)
        if (
            mbt not in (M.I4MB, M.I8MB, M.I16MB)
            and (cbp & 15)
            and self.pps.transform_8x8_mode_flag
            and self._no_part_less_than_8x8(addr)
        ):
            w.u(int(st.transform8x8[addr]), 1)

        if cbp != 0 or mbt == M.I16MB:
            dq = int(self._dquant(addr))
            w.se(dq)
            self._t("dquant", dq)

        rw = w
        if wB is not None and wC is not None:
            # DP: residual categories route to partition B (intra) or C
            # (inter) — lencod/src/header.c:41 assignSE2partition
            rw = wB if st.is_intra[addr] else wC
        self._write_residuals(rw, addr)

    def _try_native(self, w: BitWriter, mb_addrs, is_p: bool) -> bool:
        """Write the whole slice via the native C writer when the feature
        set allows (same bits as the Python path; fuzz-tested)."""
        st = self.st
        if self.sh.slice_type not in (SliceType.P, SliceType.I):
            return False
        if self.sps.chroma_format_idc not in (0, 1):
            return False
        supported = (M.PSKIP, M.P16x16, M.P16x8, M.P8x16, M.P8x8, M.I4MB,
                     M.I16MB)
        types = st.mb_type[np.asarray(mb_addrs, np.int64)]
        if not np.isin(types, supported).all():
            return False
        if self.pps.transform_8x8_mode_flag:
            return False  # transform-size syntax rides the Python writer
        if np.isin(types, (M.PSKIP,)).any() and not is_p:
            return False
        from .. import native

        res = native.cavlc_write_slice(
            st, is_p, self.sh.num_ref_idx_l0_active_minus1 + 1, self.qp,
            bool(self.pps.constrained_intra_pred_flag),
            self.sps.chroma_format_idc == 1, mb_addrs, self.nnz,
        )
        if res is None:
            return False
        payload, nbits = res
        w.append_bits(payload, nbits)
        for a in mb_addrs:  # mirror the per-MB dquant qp tracking
            if (is_p and st.skip_flag[a]) or (
                st.cbp[a] == 0 and st.mb_type[a] != M.I16MB
            ):
                continue
            self.qp = int(st.qp[a])
        return True

    def _no_part_less_than_8x8(self, addr: int) -> bool:
        st = self.st
        mbt = int(st.mb_type[addr])
        if mbt in (M.P16x16, M.P16x8, M.P8x16):
            return True
        if mbt == 0 and self.sh.slice_type == SliceType.B:
            return bool(self.sps.direct_8x8_inference_flag)
        if mbt == M.P8x8:
            inference = bool(self.sps.direct_8x8_inference_flag)
            for b in range(4):
                b8m = int(st.b8mode[addr][b])
                if not ((b8m == M.B8_DIRECT and inference) or b8m == M.B8_8x8):
                    return False
            return True
        return False

    def _dquant(self, addr: int) -> int:
        """mb_qp_delta derived from the per-MB qp sequence."""
        dq = int(self.st.qp[addr]) - self.qp
        self.qp = int(self.st.qp[addr])
        return dq

    # ------------------------------------------------------------------
    def _mpm(self, addr: int, bx: int, by: int) -> int:
        st = self.st
        la, lmb, _, _, lx, ly = st.luma4x4_neighbor(addr, (bx << 2) - 1, by << 2)
        ua, umb, _, _, ux, uy = st.luma4x4_neighbor(addr, bx << 2, (by << 2) - 1)
        if self.pps.constrained_intra_pred_flag:
            la = la and bool(st.is_intra[lmb])
            ua = ua and bool(st.is_intra[umb])
        left_m = int(st.ipredmode[ly, lx]) if la else -1
        up_m = int(st.ipredmode[uy, ux]) if ua else -1
        return DC_PRED if (left_m < 0 or up_m < 0) else min(left_m, up_m)

    def _b_mb_type(self, addr: int, mbt: int) -> int:
        """Inverse of _interpret_B for the inter B mb types."""
        st = self.st
        pd = st.b8pdir[addr]
        if mbt == M.BSKIP_DIRECT:
            return 0
        if mbt == M.P16x16:
            return {0: 1, 1: 2, 2: 3}[int(pd[0])]
        if mbt == M.P16x8:
            return _B_16x8_CODE[(int(pd[0]), int(pd[2]))]
        if mbt == M.P8x16:
            return _B_8x16_CODE[(int(pd[0]), int(pd[1]))]
        if mbt == M.P8x8:
            return 22
        raise NotImplementedError(f"B mb_type {mbt} in CAVLC writer")

    # ------------------------------------------------------------------
    def _write_motion(self, w: BitWriter, addr: int, mbt: int):
        st = self.st
        x4, y4 = st.mb_block_origin(addr)
        bframe = self.sh.slice_type == SliceType.B
        n_active = (
            self.sh.num_ref_idx_l0_active_minus1 + 1,
            self.sh.num_ref_idx_l1_active_minus1 + 1,
        )
        if mbt == M.P16x16:
            parts = [(0, 0, 4, 4, 0)]
        elif mbt == M.P16x8:
            parts = [(0, 0, 4, 2, 0), (0, 2, 4, 2, 2)]
        elif mbt == M.P8x16:
            parts = [(0, 0, 2, 4, 0), (2, 0, 2, 4, 1)]
        else:
            parts = [((b8 & 1) * 2, (b8 >> 1) * 2, 2, 2, b8) for b8 in range(4)]

        def active(lst, b8):
            b8m = int(st.b8mode[addr][b8])
            pdir = int(st.b8pdir[addr][b8])
            if b8m == M.IBLOCK or (mbt == M.P8x8 and b8m == M.B8_DIRECT):
                return False
            if bframe and pdir != lst and pdir != M.PD_BI:
                return False
            return True

        # ref idx: list0 then list1, per partition (spec §7.3.5.1 order)
        for lst in (0, 1):
            if lst == 1 and not bframe:
                break
            n_ref = n_active[lst]
            if n_ref <= 1:
                continue
            for (bx, by, _, _, b8) in parts:
                if not active(lst, b8):
                    continue
                w.te(int(st.ref_idx[lst, y4 + by, x4 + bx]), n_ref - 1)
        # mvd: list0 then list1, per sub-partition
        for lst in (0, 1):
            if lst == 1 and not bframe:
                break
            for (bx, by, w4, h4, b8) in parts:
                if not active(lst, b8):
                    continue
                if mbt == M.P8x8:
                    b8m = int(st.b8mode[addr][b8])
                    sw, sh_ = {M.B8_8x8: (2, 2), M.B8_8x4: (2, 1),
                               M.B8_4x8: (1, 2), M.B8_4x4: (1, 1)}[b8m]
                    subs = [
                        (bx + dx, by + dy)
                        for dy in range(0, 2, sh_)
                        for dx in range(0, 2, sw)
                    ]
                else:
                    subs = [(bx, by)]
                for (sx, sy) in subs:
                    w.se(int(st.mvd[lst, y4 + sy, x4 + sx, 0]))
                    w.se(int(st.mvd[lst, y4 + sy, x4 + sx, 1]))

    # ------------------------------------------------------------------
    def _predict_nnz(self, addr: int, bx: int, by: int, plane: int = 0) -> int:
        st = self.st
        if plane == 0:
            la, lmb, lbx, lby, lx, ly = st.luma4x4_neighbor(
                addr, (bx << 2) - 1, by << 2
            )
            ua, umb, ubx, uby, ux, uy = st.luma4x4_neighbor(
                addr, bx << 2, (by << 2) - 1
            )
        else:
            cw, ch = self.sps.mb_chroma_size
            la, lmb, lbx, lby = st.chroma4x4_neighbor(addr, (bx << 2) - 1, by << 2, cw, ch)
            ua, umb, ubx, uby = st.chroma4x4_neighbor(addr, bx << 2, (by << 2) - 1, cw, ch)
            if la:
                ox, oy = lmb % st.W * (cw // 4), lmb // st.W * (ch // 4)
                lx, ly = ox + lbx, oy + lby
            if ua:
                ox, oy = umb % st.W * (cw // 4), umb // st.W * (ch // 4)
                ux, uy = ox + ubx, oy + uby
        cnt = 0
        pred = 0
        if la:
            pred += int(self.nnz[plane, ly, lx])
            cnt += 1
        if ua:
            pred += int(self.nnz[plane, uy, ux])
            cnt += 1
        if cnt == 2:
            pred = (pred + 1) >> 1
        return pred

    # ------------------------------------------------------------------
    def _write_residuals(self, w: BitWriter, addr: int):
        st = self.st
        mbt = int(st.mb_type[addr])
        cbp = int(st.cbp[addr])
        x4, y4 = st.mb_block_origin(addr)

        if mbt == M.I16MB:
            # luma DC: 16 coefficients in full 4x4 zig-zag scan
            scan = [int(st.luma_dc[addr, y, x]) for (x, y) in _ZZ4]
            nc = self._predict_nnz(addr, 0, 0)
            n = encode_block(w, scan, 16, nc, trace=self.trace)
            self.nnz[0, y4, x4] = n

        if cbp & 15:
            maxc = 15 if mbt == M.I16MB else 16
            t8 = bool(st.transform8x8[addr])
            for b8 in range(4):
                for b4 in range(4):
                    blk = b8 * 4 + b4
                    bx, by = (int(v) for v in M.BLK4_TO_XY[blk])
                    if not (cbp & (1 << b8)):
                        self.nnz[0, y4 + by, x4 + bx] = 0
                        continue
                    if t8:
                        # 8x8 coeffs split over 4 interleaved 4x4 CAVLC
                        # blocks: sub-block b4 takes 8x8-scan 4k+b4
                        lv = st.luma8_levels[addr, b8]
                        scan = [
                            int(lv[_ZZ8[(k << 2) + b4][1],
                                   _ZZ8[(k << 2) + b4][0]])
                            for k in range(16)
                        ]
                    else:
                        levels = st.luma_levels[addr, blk]
                        if mbt == M.I16MB:
                            scan = [int(levels[y, x]) for (x, y) in _ZZ4[1:]]
                        else:
                            scan = [int(levels[y, x]) for (x, y) in _ZZ4]
                    nc = self._predict_nnz(addr, bx, by)
                    n = encode_block(w, scan, maxc, nc, trace=self.trace)
                    self.nnz[0, y4 + by, x4 + bx] = n
        if self.sps.chroma_format_idc != 1:
            return
        # chroma DC
        if cbp > 15:
            for uv in range(2):
                dcs = st.chroma_dc[addr, uv]
                scan = [int(dcs[0, 0]), int(dcs[0, 1]), int(dcs[1, 0]), int(dcs[1, 1])]
                encode_block(w, scan, 4, -1, chroma_dc=True, yuv=0, trace=self.trace)
        # chroma AC
        x2, y2 = 2 * (addr % st.W), 2 * (addr // st.W)
        if cbp > 31:
            for uv in range(2):
                for blk in range(4):
                    bx, by = blk & 1, blk >> 1
                    levels = st.chroma_levels[addr, uv, blk]
                    scan = [int(levels[y, x]) for (x, y) in _ZZ4[1:]]
                    nc = self._predict_nnz(addr, bx, by, plane=1 + uv)
                    n = encode_block(w, scan, 15, nc, trace=self.trace)
                    self.nnz[1 + uv, y2 + by, x2 + bx] = n
