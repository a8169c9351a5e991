"""CAVLC macroblock-layer slice parsing (spec §7.3.5 with §9.1/9.2
descriptors) — Baseline/Extended-profile counterpart of cabac_mb.py.

Fills the same PictureParseState; reconstruction is shared.
Reference: ldecod/src/macroblock.c read_one_macroblock (UVLC paths),
readCoeff4x4_CAVLC:2227, vlc.c readers.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.reader import BitReader
from ..entropy.cavlc.dec import decode_block
from ..entropy.cavlc import tables as T
from ..ops.exact import chroma_qp
from ..syntax.parsets import PPS, SPS
from ..syntax.slice_header import SliceHeader, SliceType
from . import mbtables as M
from .state import PictureParseState

_ZZ4 = M.ZZ_SCAN_4x4.tolist()
_ZZ8 = M.ZZ_SCAN_8x8.tolist()
DC_PRED = 2

# T.NCBP is the encoder-direction table (cbp -> codeNum); invert per
# chroma-mode and intra/inter for decoding
_CBP_FROM_CODE = [
    [{T.NCBP[m][cbp][t]: cbp for cbp in range(48)} for t in range(2)]
    for m in range(2)
]


class CavlcSliceParser:
    def __init__(self, rbsp: bytes, sh: SliceHeader, sps: SPS, pps: PPS,
                 state: PictureParseState, slice_id: int):
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.st = state
        self.slice_id = slice_id
        self.slice_type = sh.slice_type
        self.qp = sh.slice_qp(pps)
        self.r = BitReader(rbsp, sh.header_bit_len)
        self.num_ref_active = (
            sh.num_ref_idx_l0_active_minus1 + 1,
            sh.num_ref_idx_l1_active_minus1 + 1,
        )
        # data partitioning: residual readers (ldecod/src/nal_part.c);
        # None with dp=True means the partition was lost
        self.dp = False
        self.rB = None
        self.rC = None

    def parse(self) -> list[int]:
        st = self.st
        r = self.r
        addr = self.sh.first_mb_in_slice
        decoded = []
        is_pb = self.slice_type in (SliceType.P, SliceType.SP, SliceType.B)
        nxt = getattr(self, "next_addr", None) or (lambda a: a + 1)

        def bookkeep(a):
            st.slice_id[a] = self.slice_id
            st.qp[a] = self.qp
            st.lf_disable[a] = self.sh.disable_deblocking_filter_idc
            st.lf_alpha[a] = 2 * self.sh.slice_alpha_c0_offset_div2
            st.lf_beta[a] = 2 * self.sh.slice_beta_offset_div2

        while addr < st.n_mbs and r.more_rbsp_data():
            if is_pb:
                skip_run = r.ue()  # precedes every coded MB (spec §7.3.4)
                for _ in range(skip_run):
                    if addr >= st.n_mbs:
                        break
                    bookkeep(addr)
                    self._setup_skip(addr)
                    decoded.append(addr)
                    addr = nxt(addr)
                    if addr < 0:
                        addr = st.n_mbs
                if addr >= st.n_mbs or not r.more_rbsp_data():
                    break
            bookkeep(addr)
            self._read_mb(addr)
            decoded.append(addr)
            addr = nxt(addr)
            if addr < 0:
                addr = st.n_mbs
        return decoded

    # ------------------------------------------------------------------
    def _setup_skip(self, addr: int):
        st = self.st
        st.skip_flag[addr] = 1
        if self.slice_type == SliceType.B:
            st.mb_type[addr] = M.BSKIP_DIRECT
            st.b8mode[addr] = M.B8_DIRECT
            st.b8pdir[addr] = M.PD_BI
        else:
            st.mb_type[addr] = M.PSKIP
            st.b8mode[addr] = 0
            st.b8pdir[addr] = M.PD_L0
        self._set_chroma_qp(addr)
        x4, y4 = st.mb_block_origin(addr)
        st.ipredmode[y4 : y4 + 4, x4 : x4 + 4] = DC_PRED

    def _read_mb(self, addr: int):
        st = self.st
        r = self.r
        x4, y4 = st.mb_block_origin(addr)
        st.ipredmode[y4 : y4 + 4, x4 : x4 + 4] = DC_PRED
        raw = r.ue()
        is_p = self.slice_type in (SliceType.P, SliceType.SP)
        is_b = self.slice_type == SliceType.B
        if is_p:
            raw += 1  # CAVLC codes mb_type-1 for P (JM read_one_macroblock)
            # raw now matches the JM P numbering: 1..3 partitions, 4/5 P8x8,
            # 6 I4MB, 7.. I16, 31 IPCM
        # B slice: raw used directly (0 direct, 1..21 inter, 22 B8x8,
        # 23 I4MB, 24..47 I16, 48 IPCM).  I slice: 0 I4MB, 1..24 I16, 25 IPCM
        st.raw_mb_type[addr] = raw
        if is_p:
            self._interpret_P(addr, raw)
        elif is_b:
            self._interpret_B(addr, raw)
        else:
            self._interpret_I(addr, raw)
        mbt = int(st.mb_type[addr])
        st.is_intra[addr] = mbt in (M.I4MB, M.I16MB, M.I8MB, M.IPCM)

        if mbt == M.IPCM:
            self._read_ipcm(addr)
            return

        if mbt == M.P8x8:
            for b8 in range(4):
                v = r.ue()
                tab = M.SUB_MB_B if is_b else M.SUB_MB_P
                st.b8mode[addr][b8], st.b8pdir[addr][b8] = tab[v]

        # transform_size_8x8_flag for I_NxN (before intra pred modes,
        # ldecod/src/macroblock.c:781)
        if mbt == M.I4MB and self.pps.transform_8x8_mode_flag:
            if r.u(1):
                st.transform8x8[addr] = 1
                st.mb_type[addr] = M.I8MB
                mbt = M.I8MB

        if mbt in (M.I4MB, M.I8MB):
            step = 2 if mbt == M.I8MB else 1
            for b8 in range(4):
                for j in range(0, 2, step):
                    for i in range(0, 2, step):
                        bx = ((b8 & 1) << 1) + i
                        by = (b8 & 2) + j
                        mpm = self._mpm(addr, bx, by)
                        if r.u(1):
                            mode = mpm
                        else:
                            rem = r.u(3)
                            mode = rem if rem < mpm else rem + 1
                        st.ipredmode[
                            y4 + by : y4 + by + step, x4 + bx : x4 + bx + step
                        ] = mode
        if mbt in (M.I4MB, M.I8MB, M.I16MB):
            st.c_ipred_mode[addr] = r.ue()

        if mbt in (M.P16x16, M.P16x8, M.P8x16, M.P8x8):
            self._read_motion(addr, mbt)

        if mbt == M.I16MB:
            pass  # cbp from mb_type
        else:
            code = r.ue()
            tab_idx = 0 if mbt in (M.I4MB, M.I8MB) else 1
            mode = 1 if self.sps.chroma_format_idc in (1, 2) else 0
            st.cbp[addr] = _CBP_FROM_CODE[mode][tab_idx][code]
        cbp = int(st.cbp[addr])

        # transform_size_8x8_flag for inter MBs (after CBP,
        # ldecod/src/macroblock.c:2915 need_transform_size_flag)
        if (
            mbt not in (M.I4MB, M.I8MB, M.I16MB)
            and (cbp & 15)
            and self.pps.transform_8x8_mode_flag
            and self._no_part_less_than_8x8(addr)
        ):
            st.transform8x8[addr] = r.u(1)

        if cbp != 0 or mbt == M.I16MB:
            dq = r.se()
            self.qp = (self.qp + dq + 52) % 52
        st.qp[addr] = self.qp
        self._set_chroma_qp(addr)
        self._read_residuals(addr)

    def _interpret_I(self, addr, raw):
        st = self.st
        if raw == 0:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif raw == 25:
            st.mb_type[addr] = M.IPCM
        else:
            st.mb_type[addr] = M.I16MB
            st.cbp[addr] = M.I16_CBP_TAB[(raw - 1) >> 2]
            st.i16mode[addr] = (raw - 1) & 3
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1

    def _interpret_P(self, addr, raw):
        st = self.st
        if raw < 4:
            st.mb_type[addr] = raw
            st.b8mode[addr] = raw
            st.b8pdir[addr] = 0
        elif raw in (4, 5):
            st.mb_type[addr] = M.P8x8
        elif raw == 6:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif raw == 31:
            st.mb_type[addr] = M.IPCM
        else:
            st.mb_type[addr] = M.I16MB
            st.cbp[addr] = M.I16_CBP_TAB[(raw - 7) >> 2]
            st.i16mode[addr] = (raw - 7) & 3
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1

    def _interpret_B(self, addr, raw):
        st = self.st
        if raw == 0:
            st.mb_type[addr] = M.BSKIP_DIRECT
            st.b8mode[addr] = M.B8_DIRECT
            st.b8pdir[addr] = M.PD_BI
        elif raw == 23:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif raw == 48:
            st.mb_type[addr] = M.IPCM
        elif 23 < raw < 48:
            st.mb_type[addr] = M.I16MB
            st.cbp[addr] = M.I16_CBP_TAB[(raw - 24) >> 2]
            st.i16mode[addr] = (raw - 24) & 3
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1
        elif raw == 22:
            st.mb_type[addr] = M.P8x8
        elif raw < 4:
            st.mb_type[addr] = M.P16x16
            st.b8mode[addr] = 1
            st.b8pdir[addr] = M.B_PDIR_16x16[raw]
        elif (raw & 1) == 0:  # 16x8
            st.mb_type[addr] = M.P16x8
            st.b8mode[addr] = 2
            pd = M.B_PDIR_16x8[raw]
            st.b8pdir[addr][0] = st.b8pdir[addr][1] = pd[0]
            st.b8pdir[addr][2] = st.b8pdir[addr][3] = pd[1]
        else:  # 8x16
            st.mb_type[addr] = M.P8x16
            st.b8mode[addr] = 3
            pd = M.B_PDIR_8x16[raw]
            st.b8pdir[addr][0] = st.b8pdir[addr][2] = pd[0]
            st.b8pdir[addr][1] = st.b8pdir[addr][3] = pd[1]

    def _no_part_less_than_8x8(self, addr: int) -> bool:
        """JM need_transform_size_flag partition condition
        (macroblock.c:2901), same rule as the CABAC parser."""
        st = self.st
        mbt = int(st.mb_type[addr])
        if mbt in (M.P16x16, M.P16x8, M.P8x16):
            return True
        if mbt == 0 and self.slice_type == SliceType.B:
            return bool(self.sps.direct_8x8_inference_flag)
        if mbt == M.P8x8:
            inference = bool(self.sps.direct_8x8_inference_flag)
            for b in range(4):
                b8m = int(st.b8mode[addr][b])
                if not ((b8m == M.B8_DIRECT and inference) or b8m == M.B8_8x8):
                    return False
            return True
        return False

    def _read_ipcm(self, addr: int):
        """pcm_alignment_zero_bit* + raw samples (spec §7.3.5,
        ldecod/src/macroblock.c read_IPCM_coeffs_from_NAL)."""
        st = self.st
        r = self.r
        r.align()
        assert self.sps.bit_depth_luma == 8, "IPCM needs 8-bit depth"
        luma = np.array(
            [[r.u(8) for _ in range(16)] for _ in range(16)], np.int32
        )
        cw, ch = self.sps.mb_chroma_size
        chroma = []
        for _ in range(2 if self.sps.chroma_format_idc else 0):
            chroma.append(np.array(
                [[r.u(8) for _ in range(cw)] for _ in range(ch)], np.int32
            ))
        st.ipcm_samples[addr] = (luma, *chroma)
        st.qp[addr] = self.qp
        self._set_chroma_qp(addr)
        # nnz = 16 on every covered block for CAVLC neighbor prediction
        x4, y4 = st.mb_block_origin(addr)
        st.nnz[0, y4 : y4 + 4, x4 : x4 + 4] = 16
        x2, y2 = 2 * (addr % st.W), 2 * (addr // st.W)
        st.nnz[1:, y2 : y2 + 2, x2 : x2 + 2] = 16

    def _mpm(self, addr, bx, by):
        st = self.st
        la, lmb, _, _, lx, ly = st.luma4x4_neighbor(addr, (bx << 2) - 1, by << 2)
        ua, umb, _, _, ux, uy = st.luma4x4_neighbor(addr, bx << 2, (by << 2) - 1)
        if self.pps.constrained_intra_pred_flag:
            la = la and bool(st.is_intra[lmb])
            ua = ua and bool(st.is_intra[umb])
        left_m = int(st.ipredmode[ly, lx]) if la else -1
        up_m = int(st.ipredmode[uy, ux]) if ua else -1
        return DC_PRED if (left_m < 0 or up_m < 0) else min(left_m, up_m)

    def _read_motion(self, addr, mbt):
        st = self.st
        r = self.r
        x4, y4 = st.mb_block_origin(addr)
        bframe = self.slice_type == SliceType.B
        if mbt == M.P16x16:
            parts = [(0, 0, 4, 4, 0)]
        elif mbt == M.P16x8:
            parts = [(0, 0, 4, 2, 0), (0, 2, 4, 2, 2)]
        elif mbt == M.P8x16:
            parts = [(0, 0, 2, 4, 0), (2, 0, 2, 4, 1)]
        else:
            parts = [((b8 & 1) * 2, (b8 >> 1) * 2, 2, 2, b8) for b8 in range(4)]
        allrefzero = not bframe and int(st.raw_mb_type[addr]) == 5
        # ref_idx: list0 then list1, per partition (spec §7.3.5.1 order)
        for lst in (0, 1):
            if lst == 1 and not bframe:
                break
            n_ref = self.num_ref_active[lst]
            for (bx, by, w4, h4, b8) in parts:
                b8m = int(st.b8mode[addr][b8])
                pdir = int(st.b8pdir[addr][b8])
                if b8m == M.IBLOCK or (mbt == M.P8x8 and b8m == M.B8_DIRECT):
                    continue
                if bframe and pdir != lst and pdir != M.PD_BI:
                    continue
                ref = r.te(n_ref - 1) if (n_ref > 1 and not allrefzero) else 0
                st.ref_idx[lst, y4 + by : y4 + by + h4, x4 + bx : x4 + bx + w4] = ref
        # mvd: list0 then list1, per sub-partition
        for lst in (0, 1):
            if lst == 1 and not bframe:
                break
            for (bx, by, w4, h4, b8) in parts:
                b8m = int(st.b8mode[addr][b8])
                pdir = int(st.b8pdir[addr][b8])
                if b8m == M.IBLOCK or (mbt == M.P8x8 and b8m == M.B8_DIRECT):
                    continue
                if bframe and pdir != lst and pdir != M.PD_BI:
                    continue
                if mbt == M.P8x8:
                    sw, sh_ = {M.B8_8x8: (2, 2), M.B8_8x4: (2, 1),
                               M.B8_4x8: (1, 2), M.B8_4x4: (1, 1)}[b8m]
                    subs = [
                        (bx + dx, by + dy)
                        for dy in range(0, 2, sh_)
                        for dx in range(0, 2, sw)
                    ]
                    dims = (sw, sh_)
                else:
                    subs = [(bx, by)]
                    dims = (w4, h4)
                for (sx, sy) in subs:
                    mvdx = r.se()
                    mvdy = r.se()
                    st.mvd[
                        lst, y4 + sy : y4 + sy + dims[1], x4 + sx : x4 + sx + dims[0]
                    ] = (mvdx, mvdy)

    # ------------------------------------------------------------------
    def _predict_nnz(self, addr, bx, by, plane=0):
        st = self.st
        if plane == 0:
            la, lmb, lbx, lby, lx, ly = st.luma4x4_neighbor(addr, (bx << 2) - 1, by << 2)
            ua, umb, ubx, uby, ux, uy = st.luma4x4_neighbor(addr, bx << 2, (by << 2) - 1)
        else:
            cw, ch = self.sps.mb_chroma_size
            la, lmb, lbx, lby = st.chroma4x4_neighbor(addr, (bx << 2) - 1, by << 2, cw, ch)
            ua, umb, ubx, uby = st.chroma4x4_neighbor(addr, bx << 2, (by << 2) - 1, cw, ch)
            if la:
                lx, ly = (lmb % st.W) * 2 + lbx, (lmb // st.W) * 2 + lby
            if ua:
                ux, uy = (umb % st.W) * 2 + ubx, (umb // st.W) * 2 + uby
        cnt = 0
        pred = 0
        if la:
            pred += int(st.nnz[plane, ly, lx])
            cnt += 1
        if ua:
            pred += int(st.nnz[plane, uy, ux])
            cnt += 1
        if cnt == 2:
            pred = (pred + 1) >> 1
        return pred

    def _read_residuals(self, addr):
        st = self.st
        r = self.r
        mbt = int(st.mb_type[addr])
        cbp = int(st.cbp[addr])
        x4, y4 = st.mb_block_origin(addr)
        if self.dp:
            # category routing: intra coefficients ride partition B,
            # inter coefficients partition C (spec §7.4.1 categories)
            r = self.rB if st.is_intra[addr] else self.rC
            if r is None:
                # lost partition: coefficients absent; zero nnz so later
                # MBs' nC prediction stays consistent (JM ei_flag path)
                st.nnz[0, y4 : y4 + 4, x4 : x4 + 4] = 0
                x2, y2 = 2 * (addr % st.W), 2 * (addr // st.W)
                st.nnz[1:, y2 : y2 + 2, x2 : x2 + 2] = 0
                return
        if mbt == M.I16MB:
            nc = self._predict_nnz(addr, 0, 0)
            coeffs, n = decode_block(r, 16, nc)
            st.nnz[0, y4, x4] = n
            for k, lev in enumerate(coeffs):
                if lev:
                    x, y = _ZZ4[k]
                    st.luma_dc[addr, y, x] = lev
                    st.cbp_blk[addr] |= 1
        if cbp & 15:
            maxc = 15 if mbt == M.I16MB else 16
            t8 = bool(st.transform8x8[addr])
            for b8 in range(4):
                for b4 in range(4):
                    blk = b8 * 4 + b4
                    bx, by = (int(v) for v in M.BLK4_TO_XY[blk])
                    if not (cbp & (1 << b8)):
                        st.nnz[0, y4 + by, x4 + bx] = 0
                        continue
                    nc = self._predict_nnz(addr, bx, by)
                    coeffs, n = decode_block(r, maxc, nc)
                    st.nnz[0, y4 + by, x4 + bx] = n
                    if t8:
                        # 8x8 coeffs ride 4 interleaved 4x4 blocks: scan
                        # index k of sub-block b4 -> 8x8 scan 4k+b4
                        # (ldecod/src/macroblock.c CAVLC 8x8 branch)
                        nz = 0
                        for k, lev in enumerate(coeffs):
                            if lev:
                                x, y = _ZZ8[(k << 2) + b4]
                                st.luma8_levels[addr, b8, y, x] = lev
                                nz += 1
                        if nz:
                            st.cbp_blk[addr] |= 51 << (4 * b8 - 2 * (b8 & 1))
                        continue
                    off = 1 if mbt == M.I16MB else 0
                    nz = 0
                    for k, lev in enumerate(coeffs):
                        if lev:
                            x, y = _ZZ4[k + off]
                            st.luma_levels[addr, blk, y, x] = lev
                            nz += 1
                    if nz:
                        st.cbp_blk[addr] |= 1 << (4 * by + bx)
        if self.sps.chroma_format_idc != 1:
            return
        x2, y2 = 2 * (addr % st.W), 2 * (addr // st.W)
        if cbp > 15:
            for uv in range(2):
                coeffs, n = decode_block(r, 4, -1, chroma_dc=True, yuv=0)
                for k, lev in enumerate(coeffs):
                    if lev:
                        st.chroma_dc[addr, uv, k >> 1, k & 1] = lev
        if cbp > 31:
            for uv in range(2):
                for blk in range(4):
                    bx, by = blk & 1, blk >> 1
                    nc = self._predict_nnz(addr, bx, by, plane=1 + uv)
                    coeffs, n = decode_block(r, 15, nc)
                    st.nnz[1 + uv, y2 + by, x2 + bx] = n
                    for k, lev in enumerate(coeffs):
                        if lev:
                            x, y = _ZZ4[k + 1]
                            st.chroma_levels[addr, uv, blk, y, x] = lev

    def _set_chroma_qp(self, addr):
        st = self.st
        qp = int(st.qp[addr])
        cb_off, cr_off = self.pps.chroma_qp_offset
        st.qpc[addr, 0] = chroma_qp(qp, cb_off)
        st.qpc[addr, 1] = chroma_qp(qp, cr_off)
