"""CABAC macroblock-layer slice parsing (spec §7.3.5, §9.3.3.1).

Produces per-picture SE tensors in `PictureParseState`; no pixel work
happens here — reconstruction consumes the arrays as whole-frame batches
(the parse/reconstruct split of SURVEY.md §7.1: entropy parse is the
serial tail, reconstruction is the TPU-parallel body).

Context index derivations mirror the reference readers exactly
(ldecod/src/cabac.c readMB_typeInfo_CABAC:549, readMVD_CABAC:269,
readCBP_CABAC:977, read_and_store_CBP_block_bit:1178,
read_significance_map:1470, ...), expressed against the JM context
grouping generated into tables.py.
"""

from __future__ import annotations

import numpy as np

from ..syntax.parsets import PPS, SPS
from ..syntax.slice_header import SliceHeader, SliceType
from ..entropy.cabac.engine import CabacDecoder, ContextSet
from ..entropy.cabac import tables as T
from ..ops.exact import chroma_qp
from . import mbtables as M
from .state import PictureParseState

_POS2CTX_MAP = [a.tolist() for a in T.POS2CTX_MAP]
_POS2CTX_LAST = [a.tolist() for a in T.POS2CTX_LAST]
_TYPE2CTX_BCBP = T.TYPE2CTX_BCBP.tolist()
_TYPE2CTX_MAP = T.TYPE2CTX_MAP.tolist()
_TYPE2CTX_LAST = T.TYPE2CTX_LAST.tolist()
_TYPE2CTX_ONE = T.TYPE2CTX_ONE.tolist()
_TYPE2CTX_ABS = T.TYPE2CTX_ABS.tolist()
_MAXPOS = T.MAXPOS.tolist()
_C1ISDC = T.C1ISDC.tolist()
_MAX_C2 = T.MAX_C2.tolist()

_ZZ4 = M.ZZ_SCAN_4x4.tolist()
_ZZ8 = M.ZZ_SCAN_8x8.tolist()
_FLD4 = M.FIELD_SCAN_4x4.tolist()
_FLD8 = M.FIELD_SCAN_8x8.tolist()
# field significance-map position->context (ldecod/src/cabac.c
# pos2ctx_map8x8i; 4x4-class types share the frame table)
_POS2CTX_MAP8x8I = [
    0, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 7, 7, 8, 4, 5,
    6, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 11, 12, 11,
    9, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 13, 13, 9,
    9, 10, 10, 8, 13, 13, 9, 9, 10, 10, 14, 14, 14, 14, 14, 14]
_BLK4 = M.BLK4_TO_XY.tolist()

DC_PRED = 2  # intra 4x4 DC mode

# partition geometry per b8mode: (sub-part width, height) in 4x4-block units
_B8_PARTS = {
    M.B8_8x8: (2, 2),
    M.B8_8x4: (2, 1),
    M.B8_4x8: (1, 2),
    M.B8_4x4: (1, 1),
}


class CabacSliceParser:
    """Parses one CABAC slice's macroblocks into the picture state."""

    def __init__(
        self,
        rbsp: bytes,
        sh: SliceHeader,
        sps: SPS,
        pps: PPS,
        state: PictureParseState,
        slice_id: int,
    ):
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.st = state
        self.slice_id = slice_id
        self.slice_type = sh.slice_type
        self.qp = sh.slice_qp(pps)
        self.last_dquant = 0
        self.fld = bool(sh.field_pic_flag)  # field picture: field scans
        # + FLD significance contexts (ldecod/src/cabac.c:1481)
        start_bit = (sh.header_bit_len + 7) & ~7  # cabac_alignment_one_bit
        self.rbsp = rbsp
        self.dec = CabacDecoder(rbsp, start_bit)
        self.ctx = ContextSet(
            self.slice_type in (SliceType.I, SliceType.SI),
            sh.cabac_init_idc,
            self.qp,
        )
        self.num_ref_active = (
            sh.num_ref_idx_l0_active_minus1 + 1,
            sh.num_ref_idx_l1_active_minus1 + 1,
        )
        self.allrefzero = False
        self.trace: list | None = []  # (name, value...) tuples; None disables

    def _t(self, name, *vals):
        if self.trace is not None:
            self.trace.append((name, *vals))

    # ------------------------------------------------------------------
    # slice loop
    # ------------------------------------------------------------------
    def parse(self) -> list[int]:
        """Parse MBs until end_of_slice; returns decoded MB addresses."""
        st = self.st
        addr = self.sh.first_mb_in_slice
        decoded = []
        is_pb = self.slice_type in (SliceType.P, SliceType.B, SliceType.SP)
        nxt = getattr(self, "next_addr", None) or (lambda a: a + 1)
        while True:
            if addr < 0 or addr >= st.n_mbs:
                break
            st.slice_id[addr] = self.slice_id
            st.qp[addr] = self.qp
            st.lf_disable[addr] = self.sh.disable_deblocking_filter_idc
            st.lf_alpha[addr] = 2 * self.sh.slice_alpha_c0_offset_div2
            st.lf_beta[addr] = 2 * self.sh.slice_beta_offset_div2
            skipped = self._read_mb_skip(addr) if is_pb else False
            if skipped:
                self._setup_skip_mb(addr)
            else:
                self._read_mb(addr)
            decoded.append(addr)
            eos = self.dec.terminate()  # end_of_slice_flag
            self._t("end_of_slice_flag", eos)
            if eos:
                break
            addr = nxt(addr)
        return decoded

    # ------------------------------------------------------------------
    # macroblock orchestration
    # ------------------------------------------------------------------
    def _read_mb(self, addr: int):
        st = self.st
        x4, y4 = st.mb_block_origin(addr)
        st.ipredmode[y4 : y4 + 4, x4 : x4 + 4] = DC_PRED
        stype = self.slice_type
        if stype == SliceType.I:
            raw = self._read_mb_type_I(addr)
            self._interpret_I(addr, raw)
        elif stype == SliceType.B:
            raw = self._read_mb_type_B(addr)
            if raw > 23:  # intra-16x16 path suffix (raw == 24)
                raw = self._read_i16_suffix(raw)
            self._interpret_B(addr, raw)
        else:
            raw = self._read_mb_type_P(addr)
            if raw == 7:
                raw = self._read_i16_suffix(raw)
            self._interpret_P(addr, raw)
        self._t("mb_type", raw)
        st.raw_mb_type[addr] = raw
        mbt = int(st.mb_type[addr])
        st.is_intra[addr] = mbt in (M.I4MB, M.I16MB, M.I8MB, M.IPCM, M.SI4MB)

        if mbt == M.IPCM:
            self._read_ipcm(addr)
            return

        # P8x8: sub_mb_types
        if mbt == M.P8x8:
            for b8 in range(4):
                v = self._read_sub_mb_type()
                self._t("sub_mb_type", v)
                if self.slice_type == SliceType.B:
                    st.b8mode[addr][b8], st.b8pdir[addr][b8] = M.SUB_MB_B[v]
                else:
                    st.b8mode[addr][b8], st.b8pdir[addr][b8] = M.SUB_MB_P[v]

        # transform size flag for I4MB (before intra pred modes)
        if mbt == M.I4MB and self.pps.transform_8x8_mode_flag:
            ts = self._read_transform_size(addr)
            self._t("transform_size_8x8_flag", ts)
            if ts:
                st.transform8x8[addr] = 1
                st.mb_type[addr] = M.I8MB
                mbt = M.I8MB

        # intra prediction modes
        if mbt in (M.I4MB, M.I8MB):
            self._read_intra_pred_modes(addr)
        if st.is_intra[addr] and self.sps.chroma_format_idc in (1, 2):
            st.c_ipred_mode[addr] = self._read_cipred_mode(addr)
            self._t("intra_chroma_pred_mode", int(st.c_ipred_mode[addr]))

        # motion info
        if not st.is_intra[addr] and mbt != 0:
            self._read_motion_info(addr)
        elif mbt == 0 and stype == SliceType.B:
            # B_Direct_16x16: no motion syntax
            pass

        # CBP
        if mbt == M.I16MB:
            off = 1 if stype == SliceType.I else (24 if stype == SliceType.B else 7)
            st.cbp[addr] = M.I16_CBP_TAB[(raw - off) >> 2]
            st.i16mode[addr] = (raw - off) & 3
        else:
            st.cbp[addr] = self._read_cbp(addr)
            self._t("coded_block_pattern", int(st.cbp[addr]))
        cbp = int(st.cbp[addr])

        # transform_size_8x8_flag for inter MBs (after CBP; JM
        # readCBPandCoeffsFromNAL need_transform_size_flag, macroblock.c:2901)
        if (
            mbt not in (M.I4MB, M.I8MB, M.I16MB)
            and (cbp & 15)
            and self.pps.transform_8x8_mode_flag
            and self._no_part_less_than_8x8(addr)
        ):
            ts = self._read_transform_size(addr)
            self._t("transform_size_8x8_flag", ts)
            st.transform8x8[addr] = ts

        if cbp != 0 or mbt == M.I16MB:
            dq = self._read_dquant()
            self._t("mb_qp_delta", dq)
            self.qp = (self.qp + dq + 52) % 52
        st.qp[addr] = self.qp
        self._set_chroma_qp(addr)

        self._read_residuals(addr)

    def _no_part_less_than_8x8(self, addr: int) -> bool:
        """JM need_transform_size_flag partition condition (macroblock.c:2901):
        mb_type 1..3, or direct with 8x8 inference, or NoMbPartLessThan8x8."""
        st = self.st
        mbt = int(st.mb_type[addr])
        if mbt in (M.P16x16, M.P16x8, M.P8x16):
            return True
        if mbt == 0 and self.slice_type == SliceType.B:  # direct MB
            return bool(self.sps.direct_8x8_inference_flag)
        if mbt == M.P8x8:
            inference = bool(self.sps.direct_8x8_inference_flag)
            for b in range(4):
                b8m = int(st.b8mode[addr][b])
                if not ((b8m == M.B8_DIRECT and inference) or b8m == M.B8_8x8):
                    return False
            return True
        return False

    def _setup_skip_mb(self, addr: int):
        st = self.st
        st.skip_flag[addr] = 1
        st.raw_mb_type[addr] = -2
        st.qp[addr] = self.qp
        self._set_chroma_qp(addr)
        if self.slice_type == SliceType.B:
            st.mb_type[addr] = M.BSKIP_DIRECT
            st.b8mode[addr] = M.B8_DIRECT
            st.b8pdir[addr] = M.PD_BI
        else:
            st.mb_type[addr] = M.PSKIP
            st.b8mode[addr] = 0
            st.b8pdir[addr] = M.PD_L0
        x4, y4 = st.mb_block_origin(addr)
        st.ipredmode[y4 : y4 + 4, x4 : x4 + 4] = DC_PRED

    # ------------------------------------------------------------------
    # mb_type readers (per slice type)
    # ------------------------------------------------------------------
    def _read_mb_skip(self, addr: int) -> bool:
        st = self.st
        up, left = st.mb_up(addr), st.mb_left(addr)
        a = 1 if (left >= 0 and not st.skip_flag[left]) else 0
        b = 1 if (up >= 0 and not st.skip_flag[up]) else 0
        if self.slice_type == SliceType.B:
            s, m, base = self.ctx.group("MB_TYPE", 2)
            bit = self.dec.decision((s, m), base + 7 + a + b)
        else:
            s, m, base = self.ctx.group("MB_TYPE", 1)
            bit = self.dec.decision((s, m), base + a + b)
        if bit:
            self.last_dquant = 0
        self._t("mb_skip_flag", 0 if bit else 1)
        return bool(bit)

    def _read_mb_type_I(self, addr: int) -> int:
        st = self.st
        dec = self.dec
        up, left = st.mb_up(addr), st.mb_left(addr)
        s, m, base = self.ctx.group("MB_TYPE", 0)
        g = (s, m)
        a = 1 if (left >= 0 and st.mb_type[left] not in (M.I4MB, M.I8MB)) else 0
        b = 1 if (up >= 0 and st.mb_type[up] not in (M.I4MB, M.I8MB)) else 0
        if not dec.decision(g, base + a + b):
            return 0  # I_4x4 / I_8x8
        if dec.terminate():
            return 25  # IPCM
        act = 1
        act += 12 * dec.decision(g, base + 4)
        if dec.decision(g, base + 5):
            act += 8 if dec.decision(g, base + 6) else 4
        act += 2 * dec.decision(g, base + 7)
        act += dec.decision(g, base + 8)
        return act

    def _read_mb_type_P(self, addr: int) -> int:
        dec = self.dec
        s, m, base = self.ctx.group("MB_TYPE", 1)
        g = (s, m)
        if dec.decision(g, base + 4):
            return 7 if dec.decision(g, base + 7) else 6
        if dec.decision(g, base + 5):
            return 2 if dec.decision(g, base + 7) else 3
        return 4 if dec.decision(g, base + 6) else 1

    def _read_mb_type_B(self, addr: int) -> int:
        st = self.st
        dec = self.dec
        up, left = st.mb_up(addr), st.mb_left(addr)
        s, m, base = self.ctx.group("MB_TYPE", 2)
        g = (s, m)
        a = 1 if (left >= 0 and st.mb_type[left] != 0) else 0
        b = 1 if (up >= 0 and st.mb_type[up] != 0) else 0
        if not dec.decision(g, base + a + b):
            return 0
        if dec.decision(g, base + 4):
            if dec.decision(g, base + 5):
                act = 12
                act += 8 * dec.decision(g, base + 6)
                act += 4 * dec.decision(g, base + 6)
                act += 2 * dec.decision(g, base + 6)
                if act == 24:
                    act = 11
                elif act == 26:
                    act = 22
                else:
                    if act == 22:
                        act = 23
                    act += dec.decision(g, base + 6)
            else:
                act = 3
                act += 4 * dec.decision(g, base + 6)
                act += 2 * dec.decision(g, base + 6)
                act += dec.decision(g, base + 6)
        else:
            act = 2 if dec.decision(g, base + 6) else 1
        return act

    def _read_i16_suffix(self, act: int) -> int:
        """Intra-16x16 suffix for P/B (mb_type row 1, ctx 8-10); IPCM via
        terminate (readMB_typeInfo_CABAC P/B tail)."""
        dec = self.dec
        if dec.terminate():
            return 48 if self.slice_type == SliceType.B else 31
        s, m, base = self.ctx.group("MB_TYPE", 1)
        g = (s, m)
        act += 12 * dec.decision(g, base + 8)
        if dec.decision(g, base + 9):
            act += 4
            if dec.decision(g, base + 9):
                act += 4
        act += 2 * dec.decision(g, base + 10)
        act += dec.decision(g, base + 10)
        return act

    # ------------------------------------------------------------------
    # mb_type interpretation (JM interpret_mb_mode_*)
    # ------------------------------------------------------------------
    def _interpret_I(self, addr: int, raw: int):
        st = self.st
        if raw == 0:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif raw == 25:
            st.mb_type[addr] = M.IPCM
            st.cbp[addr] = 0
            st.i16mode[addr] = 0
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1
        else:
            st.mb_type[addr] = M.I16MB
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1

    def _interpret_P(self, addr: int, raw: int):
        st = self.st
        if raw < 4:
            st.mb_type[addr] = raw
            st.b8mode[addr] = raw
            st.b8pdir[addr] = 0
        elif raw in (4, 5):
            st.mb_type[addr] = M.P8x8
            self.allrefzero = raw == 5
        elif raw == 6:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif raw == 31:
            st.mb_type[addr] = M.IPCM
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1
        else:
            st.mb_type[addr] = M.I16MB
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1

    def _interpret_B(self, addr: int, raw: int):
        st = self.st
        if raw == 0:
            st.mb_type[addr] = 0
            st.b8mode[addr] = M.B8_DIRECT
            st.b8pdir[addr] = M.PD_BI
        elif raw == 23:
            st.mb_type[addr] = M.I4MB
            st.b8mode[addr] = M.IBLOCK
            st.b8pdir[addr] = -1
        elif 23 < raw < 48:
            st.mb_type[addr] = M.I16MB
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1
        elif raw == 22:
            st.mb_type[addr] = M.P8x8
        elif raw < 4:
            st.mb_type[addr] = M.P16x16
            st.b8mode[addr] = 1
            st.b8pdir[addr] = M.B_PDIR_16x16[raw]
        elif raw == 48:
            st.mb_type[addr] = M.IPCM
            st.b8mode[addr] = 0
            st.b8pdir[addr] = -1
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

    # ------------------------------------------------------------------
    # small SE readers
    # ------------------------------------------------------------------
    def _read_sub_mb_type(self) -> int:
        dec = self.dec
        if self.slice_type != SliceType.B:
            s, m, base = self.ctx.group("B8_TYPE", 0)
            g = (s, m)
            if dec.decision(g, base + 1):
                return 0
            if dec.decision(g, base + 3):
                return 2 if dec.decision(g, base + 4) else 3
            return 1
        s, m, base = self.ctx.group("B8_TYPE", 1)
        g = (s, m)
        if not dec.decision(g, base + 0):
            return 0  # direct
        if dec.decision(g, base + 1):
            if dec.decision(g, base + 2):
                if dec.decision(g, base + 3):
                    act = 10
                    if dec.decision(g, base + 3):
                        act += 1
                else:
                    act = 6
                    if dec.decision(g, base + 3):
                        act += 2
                    if dec.decision(g, base + 3):
                        act += 1
            else:
                act = 2
                if dec.decision(g, base + 3):
                    act += 2
                if dec.decision(g, base + 3):
                    act += 1
        else:
            act = 1 if dec.decision(g, base + 3) else 0
        return act + 1

    def _read_transform_size(self, addr: int) -> int:
        st = self.st
        up, left = st.mb_up(addr), st.mb_left(addr)
        a = int(st.transform8x8[left]) if left >= 0 else 0
        b = int(st.transform8x8[up]) if up >= 0 else 0
        s, m, base = self.ctx.group("TRANSFORM_SIZE", 0)
        return self.dec.decision((s, m), base + a + b)

    def _read_intra_pred_modes(self, addr: int):
        st = self.st
        dec = self.dec
        s, m, base = self.ctx.group("IPR", 0)
        g = (s, m)
        x4, y4 = st.mb_block_origin(addr)
        is8x8 = bool(st.transform8x8[addr])
        step = 2 if is8x8 else 1
        for b8 in range(4):
            if st.b8mode[addr][b8] != M.IBLOCK:
                continue
            for j in range(0, 2, step):
                for i in range(0, 2, step):
                    bx = ((b8 & 1) << 1) + i
                    by = (b8 & 2) + j
                    if dec.decision(g, base):
                        mode_in = -1  # use most probable
                    else:
                        mode_in = dec.decision(g, base + 1)
                        mode_in |= dec.decision(g, base + 1) << 1
                        mode_in |= dec.decision(g, base + 1) << 2
                    self._t("intra4x4_pred_mode", mode_in)
                    la, lmb, _, _, lx, ly = st.luma4x4_neighbor(
                        addr, (bx << 2) - 1, by << 2
                    )
                    ua, umb, _, _, ux, uy = st.luma4x4_neighbor(
                        addr, bx << 2, (by << 2) - 1
                    )
                    if self.pps.constrained_intra_pred_flag:
                        la = la and bool(st.is_intra[lmb])
                        ua = ua and bool(st.is_intra[umb])
                    left_m = int(st.ipredmode[ly, lx]) if la else -1
                    up_m = int(st.ipredmode[uy, ux]) if ua else -1
                    mpm = DC_PRED if (left_m < 0 or up_m < 0) else min(left_m, up_m)
                    if mode_in == -1:
                        mode = mpm
                    else:
                        mode = mode_in if mode_in < mpm else mode_in + 1
                    bs = step
                    st.ipredmode[
                        y4 + by : y4 + by + bs, x4 + bx : x4 + bx + bs
                    ] = mode

    def _read_cipred_mode(self, addr: int) -> int:
        st = self.st
        up, left = st.mb_up(addr), st.mb_left(addr)
        a = (
            1
            if (left >= 0 and st.c_ipred_mode[left] != 0 and st.mb_type[left] != M.IPCM)
            else 0
        )
        b = (
            1
            if (up >= 0 and st.c_ipred_mode[up] != 0 and st.mb_type[up] != M.IPCM)
            else 0
        )
        s, m, base = self.ctx.group("CIPR", 0)
        g = (s, m)
        if not self.dec.decision(g, base + a + b):
            return 0
        if not self.dec.decision(g, base + 3):
            return 1
        return 3 if self.dec.decision(g, base + 3) else 2

    def _read_cbp(self, addr: int) -> int:
        st = self.st
        dec = self.dec
        s, m, base = self.ctx.group("CBP", 0)
        g0 = (s, m)
        up, left = st.mb_up(addr), st.mb_left(addr)
        cbp = 0
        for mb_y in (0, 2):
            for mb_x in (0, 2):
                if mb_y == 0:
                    if up < 0 or st.mb_type[up] == M.IPCM:
                        b = 0
                    else:
                        b = 0 if (st.cbp[up] & (1 << (2 + mb_x // 2))) else 1
                else:
                    b = 0 if (cbp & (1 << (mb_x // 2))) else 1
                if mb_x == 0:
                    la, lmb, _, lby, _, _ = st.luma4x4_neighbor(addr, -1, mb_y << 2)
                    if la:
                        if st.mb_type[lmb] == M.IPCM:
                            a = 0
                        else:
                            a = 0 if (st.cbp[lmb] & (1 << (2 * (lby // 2) + 1))) else 1
                    else:
                        a = 0
                else:
                    a = 0 if (cbp & (1 << mb_y)) else 1
                if dec.decision(g0, base + a + 2 * b):
                    cbp += 1 << (mb_y + mb_x // 2)
        if self.sps.chroma_format_idc in (1, 2):
            s1, m1, base1 = self.ctx.group("CBP", 1)
            b = 1 if (up >= 0 and (st.mb_type[up] == M.IPCM or st.cbp[up] > 15)) else 0
            a = (
                1
                if (left >= 0 and (st.mb_type[left] == M.IPCM or st.cbp[left] > 15))
                else 0
            )
            if dec.decision((s1, m1), base1 + a + 2 * b):
                s2, m2, base2 = self.ctx.group("CBP", 2)
                b = (
                    1
                    if (
                        up >= 0
                        and (
                            st.mb_type[up] == M.IPCM
                            or (st.cbp[up] > 15 and (st.cbp[up] >> 4) == 2)
                        )
                    )
                    else 0
                )
                a = (
                    1
                    if (
                        left >= 0
                        and (
                            st.mb_type[left] == M.IPCM
                            or (st.cbp[left] > 15 and (st.cbp[left] >> 4) == 2)
                        )
                    )
                    else 0
                )
                cbp += 32 if dec.decision((s2, m2), base2 + a + 2 * b) else 16
        if cbp == 0:
            self.last_dquant = 0
        return cbp

    def _read_dquant(self) -> int:
        s, m, base = self.ctx.group("DELTA_QP", 0)
        g = (s, m)
        act_ctx = 1 if self.last_dquant != 0 else 0
        if not self.dec.decision(g, base + act_ctx):
            act_sym = 0
        else:
            # unary_bin_decode(delta_qp_contexts + 2, ctx_offset=1)
            if not self.dec.decision(g, base + 2):
                act_sym = 1
            else:
                act_sym = 1
                while self.dec.decision(g, base + 3):
                    act_sym += 1
                act_sym += 1
        dquant = (act_sym + 1) // 2
        if (act_sym & 1) == 0:
            dquant = -dquant
        self.last_dquant = dquant
        return dquant

    # ------------------------------------------------------------------
    # motion info
    # ------------------------------------------------------------------
    def _read_motion_info(self, addr: int):
        st = self.st
        mbt = int(st.mb_type[addr])
        x4, y4 = st.mb_block_origin(addr)
        bframe = self.slice_type == SliceType.B

        # partition list per 8x8 block: list of (bx, by, w, h) sub-partitions
        def partitions():
            if mbt == M.P16x16:
                return [(0, 0, 4, 4, 0)]
            if mbt == M.P16x8:
                return [(0, 0, 4, 2, 0), (0, 2, 4, 2, 2)]
            if mbt == M.P8x16:
                return [(0, 0, 2, 4, 0), (2, 0, 2, 4, 1)]
            # P8x8: one entry per 8x8 block (sub-partitions expanded later)
            out = []
            for b8 in range(4):
                bx8, by8 = (b8 & 1) * 2, (b8 >> 1) * 2
                out.append((bx8, by8, 2, 2, b8))
            return out

        parts = partitions()

        # --- reference indices: list0 then list1, per partition ---
        for lst in (0, 1):
            n_active = self.num_ref_active[lst]
            for (bx, by, w, h, b8) in parts:
                b8mode = int(st.b8mode[addr][b8])
                pdir = int(st.b8pdir[addr][b8])
                if mbt == M.P8x8 and b8mode == M.B8_DIRECT:
                    continue
                if b8mode == M.IBLOCK:
                    continue
                if pdir != lst and pdir != M.PD_BI:
                    continue
                if lst == 1 and not bframe:
                    continue
                read_flag = n_active > 1 and not (mbt == M.P8x8 and self.allrefzero)
                if read_flag:
                    ref = self._read_ref_idx(addr, lst, bx, by)
                    self._t(f"ref_idx_l{lst}", ref)
                else:
                    ref = 0
                st.ref_idx[lst, y4 + by : y4 + by + h, x4 + bx : x4 + bx + w] = ref

        # --- MVDs: list0 then list1, per sub-partition ---
        for lst in (0, 1):
            for (bx, by, w, h, b8) in parts:
                b8mode = int(st.b8mode[addr][b8])
                pdir = int(st.b8pdir[addr][b8])
                if b8mode == M.IBLOCK or (mbt == M.P8x8 and b8mode == M.B8_DIRECT):
                    continue
                if pdir != lst and pdir != M.PD_BI:
                    continue
                if lst == 1 and not bframe:
                    continue
                if mbt == M.P8x8:
                    sw, sh_ = _B8_PARTS[b8mode]
                    subs = [
                        (bx + dx, by + dy, sw, sh_)
                        for dy in range(0, 2, sh_)
                        for dx in range(0, 2, sw)
                    ]
                else:
                    subs = [(bx, by, w, h)]
                for (sx, sy, sw2, sh2) in subs:
                    mvd = [0, 0]
                    for comp in range(2):
                        mvd[comp] = self._read_mvd(addr, lst, sx, sy, comp)
                        self._t(f"mvd_l{lst}", mvd[comp])
                    st.mvd[
                        lst, y4 + sy : y4 + sy + sh2, x4 + sx : x4 + sx + sw2
                    ] = mvd

    def _read_ref_idx(self, addr: int, lst: int, bx: int, by: int) -> int:
        st = self.st
        la, lmb, lbx, lby, lx, ly = st.luma4x4_neighbor(addr, (bx << 2) - 1, by << 2)
        ua, umb, ubx, uby, ux, uy = st.luma4x4_neighbor(addr, bx << 2, (by << 2) - 1)

        def flag(avail, mb, nbx, nby, px, py):
            if not avail:
                return 0
            b8 = (nbx // 2) % 2 + 2 * ((nby // 2) % 2)
            if st.mb_type[mb] == M.IPCM:
                return 0
            if self.slice_type == SliceType.B and st.mb_type[mb] == 0 and not st.is_intra[mb]:
                return 0  # direct MB
            if st.b8mode[mb][b8] == 0 and st.b8pdir[mb][b8] == 2:
                return 0  # direct sub-block
            return 1 if st.ref_idx[lst, py, px] > 0 else 0

        a = flag(la, lmb, lbx, lby, lx, ly)
        b = flag(ua, umb, ubx, uby, ux, uy)
        s, m, base = self.ctx.group("REF_NO", 0)
        g = (s, m)
        if not self.dec.decision(g, base + a + 2 * b):
            return 0
        s1, m1, base1 = self.ctx.group("REF_NO", 1)
        g1 = (s1, m1)
        # unary_bin_decode(ref_no_contexts[addctx=0] + 4, offset 1): JM uses
        # the same row; rest bins at index 5
        if not self.dec.decision(g, base + 4):
            return 1
        k = 2
        while self.dec.decision(g, base + 5):
            k += 1
        return k

    def _read_mvd(self, addr: int, lst: int, bx: int, by: int, comp: int) -> int:
        st = self.st
        la, lmb, lbx, lby, _, _ = st.luma4x4_neighbor(addr, (bx << 2) - 1, by << 2)
        ua, umb, ubx, uby, _, _ = st.luma4x4_neighbor(addr, bx << 2, (by << 2) - 1)
        a_val = 0
        if la:
            ox, oy = st.mb_block_origin(lmb)
            a_val = abs(int(st.mvd[lst, oy + lby, ox + lbx, comp]))
        b_val = 0
        if ua:
            ox, oy = st.mb_block_origin(umb)
            b_val = abs(int(st.mvd[lst, oy + uby, ox + ubx, comp]))
        err = a_val + b_val
        if err < 3:
            act_ctx = 5 * comp
        elif err > 32:
            act_ctx = 5 * comp + 3
        else:
            act_ctx = 5 * comp + 2
        s0, m0, base0 = self.ctx.group("MV_RES", 0)
        if not self.dec.decision((s0, m0), base0 + act_ctx):
            return 0
        s1, m1, base1 = self.ctx.group("MV_RES", 1)
        val = self._unary_exp_golomb_mv((s1, m1), base1 + 5 * comp, 3)
        val += 1
        if self.dec.bypass():
            val = -val
        return val

    def _unary_exp_golomb_mv(self, g, base: int, max_bin: int) -> int:
        dec = self.dec
        if not dec.decision(g, base):
            return 0
        symbol = 0
        k = 1
        bin_ = 1
        offset = 1
        l = 0
        while True:
            l = dec.decision(g, base + offset)
            bin_ += 1
            if bin_ == 2:
                offset += 1
            if bin_ == max_bin:
                offset += 1
            symbol += 1
            k += 1
            if l == 0 or k == 8:  # exp_start = 8
                break
        if l != 0:
            symbol += self._exp_golomb_bypass(3) + 1
        return symbol

    def _exp_golomb_bypass(self, k: int) -> int:
        dec = self.dec
        symbol = 0
        while dec.bypass():
            symbol += 1 << k
            k += 1
        binary = 0
        while k:
            k -= 1
            if dec.bypass():
                binary |= 1 << k
        return symbol + binary

    def _unary_exp_golomb_level(self, g, idx: int) -> int:
        dec = self.dec
        if not dec.decision(g, idx):
            return 0
        symbol = 0
        k = 1
        l = 0
        while True:
            l = dec.decision(g, idx)
            symbol += 1
            k += 1
            if l == 0 or k == 13:  # exp_start = 13
                break
        if l != 0:
            symbol += self._exp_golomb_bypass(0) + 1
        return symbol

    # ------------------------------------------------------------------
    # residual blocks
    # ------------------------------------------------------------------
    def _read_residuals(self, addr: int):
        st = self.st
        cbp = int(st.cbp[addr])
        mbt = int(st.mb_type[addr])
        x4o, y4o = st.mb_block_origin(addr)
        if mbt == M.I16MB:
            levels = self._read_block(addr, M.LUMA_16DC, 0, 0, 0)
            if levels is not None:
                scan4 = _FLD4 if self.fld else _ZZ4
                for k, lev in enumerate(levels):
                    if lev:
                        x, y = scan4[k]
                        st.luma_dc[addr, y, x] = lev
                        st.cbp_blk[addr] |= 1
        # luma AC / 4x4 / 8x8
        if cbp & 15:
            t8 = bool(st.transform8x8[addr])
            for b8 in range(4):
                if not (cbp & (1 << b8)):
                    continue
                if t8:
                    self._read_luma8x8(addr, b8)
                else:
                    btype = M.LUMA_16AC if mbt == M.I16MB else M.LUMA_4x4
                    scan4 = _FLD4 if self.fld else _ZZ4
                    for b4 in range(4):
                        blk = b8 * 4 + b4
                        bx, by = _BLK4[blk]
                        levels = self._read_block(addr, btype, 0, bx, by)
                        if levels is None:
                            continue
                        nz = 0
                        off = 1 if btype == M.LUMA_16AC else 0
                        for k, lev in enumerate(levels):
                            if lev:
                                x, y = scan4[k + off]
                                st.luma_levels[addr, blk, y, x] = lev
                                nz += 1
                        if nz:
                            st.cbp_blk[addr] |= 1 << (4 * by + bx)
                            st.nnz[0, y4o + by, x4o + bx] = nz
        # chroma DC
        if self.sps.chroma_format_idc == 1:
            if cbp > 15:
                for uv in range(2):
                    levels = self._read_block(addr, M.CHROMA_DC, uv, 0, 0)
                    if levels is not None:
                        for k, lev in enumerate(levels):
                            if lev:
                                st.chroma_dc[addr, uv, k >> 1, k & 1] = lev
            # chroma AC
            if cbp > 31:
                for uv in range(2):
                    for blk in range(4):
                        bx, by = blk & 1, blk >> 1
                        levels = self._read_block(addr, M.CHROMA_AC, uv, bx, by)
                        if levels is None:
                            continue
                        for k, lev in enumerate(levels):
                            if lev:
                                x, y = (_FLD4 if self.fld else _ZZ4)[k + 1]
                                st.chroma_levels[addr, uv, blk, y, x] = lev

    def _read_luma8x8(self, addr: int, b8: int):
        st = self.st
        levels = self._read_block(addr, M.LUMA_8x8, 0, (b8 & 1) * 2, (b8 >> 1) * 2)
        if levels is None:
            return
        nz = 0
        scan8 = _FLD8 if self.fld else _ZZ8
        for k, lev in enumerate(levels):
            if lev:
                x, y = scan8[k]
                st.luma8_levels[addr, b8, y, x] = lev
                nz += 1
        if nz:
            # all four 4x4 positions marked (JM: 51 << (4*b8 - 2*(b8&1)))
            st.cbp_blk[addr] |= 51 << (4 * b8 - 2 * (b8 & 1))
            x4o, y4o = st.mb_block_origin(addr)
            bx8, by8 = (b8 & 1) * 2, (b8 >> 1) * 2
            st.nnz[0, y4o + by8 : y4o + by8 + 2, x4o + bx8 : x4o + bx8 + 2] = nz

    def _read_block(self, addr: int, btype: int, is_v: int, bx: int, by: int):
        """CABAC residual block: cbf + sig map + levels.

        (bx, by) are 4x4-block coords within the MB (luma) or within the
        chroma MB.  Returns levels in scan order (len maxpos) or None."""
        if not self._read_cbf(addr, btype, is_v, bx, by):
            self._t("coeff", 0, 0)
            return None
        dec = self.dec
        maxpos = _MAXPOS[btype]
        coeff = [0] * maxpos
        p2c_map = _POS2CTX_MAP[btype]
        p2c_last = _POS2CTX_LAST[btype]
        if self.fld:
            if btype == M.LUMA_8x8:
                p2c_map = _POS2CTX_MAP8x8I
            sm, mm, base_m = self.ctx.group(
                "FLD_MAP", _TYPE2CTX_MAP[btype])
            sl, ml, base_l = self.ctx.group(
                "FLD_LAST", _TYPE2CTX_LAST[btype])
        else:
            sm, mm, base_m = self.ctx.group("MAP", _TYPE2CTX_MAP[btype])
            sl, ml, base_l = self.ctx.group("LAST", _TYPE2CTX_LAST[btype])
        gm, gl = (sm, mm), (sl, ml)
        shift = 0 if _C1ISDC[btype] else -1
        i0 = 0 if _C1ISDC[btype] else 1
        i1 = maxpos - 1 if _C1ISDC[btype] else maxpos
        i = i0
        last_seen = False
        while i < i1:
            if dec.decision(gm, base_m + p2c_map[i]):
                coeff[i + shift] = 1
                if dec.decision(gl, base_l + p2c_last[i]):
                    last_seen = True
                    break
            i += 1
        if not last_seen:
            coeff[i1 + shift] = 1
        # levels (reverse scan)
        so, mo, base_o = self.ctx.group("ONE", _TYPE2CTX_ONE[btype])
        sa, ma, base_a = self.ctx.group("ABS", _TYPE2CTX_ABS[btype])
        go, ga = (so, mo), (sa, ma)
        c1, c2 = 1, 0
        mc2 = _MAX_C2[btype]
        for idx in range(maxpos - 1, -1, -1):
            if coeff[idx]:
                ctx = min(c1, 4)
                coeff[idx] += dec.decision(go, base_o + ctx)
                if coeff[idx] == 2:
                    ctx = min(c2, mc2)
                    coeff[idx] += self._unary_exp_golomb_level(ga, base_a + ctx)
                    c1 = 0
                    c2 += 1
                elif c1:
                    c1 += 1
                if dec.bypass():
                    coeff[idx] = -coeff[idx]
        if self.trace is not None:
            run = 0
            for v in coeff:
                if v == 0:
                    run += 1
                else:
                    self.trace.append(("coeff", v, run))
                    run = 0
            self.trace.append(("coeff", 0, 0))
        return coeff

    def _cbf_bit_for(self, btype: int, is_v: int, bx: int, by: int) -> int:
        if btype in (M.LUMA_16DC, M.CB_16DC, M.CR_16DC):
            return 0
        if btype in (M.CHROMA_DC, M.CHROMA_DC_2x4, M.CHROMA_DC_4x4):
            return 17 + is_v
        if btype == M.CHROMA_AC:
            return (19 if not is_v else 35) + 4 * by + bx
        return 1 + 4 * by + bx

    def _read_cbf(self, addr: int, btype: int, is_v: int, bx: int, by: int) -> int:
        st = self.st
        is_luma = btype in (
            M.LUMA_16DC, M.LUMA_16AC, M.LUMA_8x8, M.LUMA_8x4, M.LUMA_4x8, M.LUMA_4x4,
        )
        is_dc = btype in (M.LUMA_16DC, M.CHROMA_DC, M.CHROMA_DC_2x4, M.CHROMA_DC_4x4)
        default_bit = 1 if st.is_intra[addr] else 0
        i = 0 if is_dc else bx
        j = 0 if is_dc else by
        if is_luma:
            la, lmb, lbx, lby, _, _ = st.luma4x4_neighbor(addr, (i << 2) - 1, j << 2)
            ua, umb, ubx, uby, _, _ = st.luma4x4_neighbor(addr, i << 2, (j << 2) - 1)
        else:
            cw, ch = self.sps.mb_chroma_size
            la, lmb, lbx, lby = st.chroma4x4_neighbor(addr, (i << 2) - 1, j << 2, cw, ch)
            ua, umb, ubx, uby = st.chroma4x4_neighbor(addr, i << 2, (j << 2) - 1, cw, ch)
        if btype == M.LUMA_16DC:
            bit_a = bit_b = 0
        elif btype in (M.CHROMA_DC, M.CHROMA_DC_2x4, M.CHROMA_DC_4x4):
            bit_a = bit_b = 17 + is_v
        elif btype == M.CHROMA_AC:
            bit_a = (19 if not is_v else 35) + (4 * lby + lbx if la else 0)
            bit_b = (19 if not is_v else 35) + (4 * uby + ubx if ua else 0)
        else:
            bit_a = 1 + (4 * lby + lbx if la else 0)
            bit_b = 1 + (4 * uby + ubx if ua else 0)
        if btype == M.LUMA_8x8:
            cbf = 1  # coded_block_flag not sent for luma 8x8 (4:2:0 streams)
        else:
            upper = default_bit
            left = default_bit
            if ua:
                upper = (
                    1
                    if st.mb_type[umb] == M.IPCM
                    else (st.cbp_bits[umb] >> bit_b) & 1
                )
            if la:
                left = (
                    1
                    if st.mb_type[lmb] == M.IPCM
                    else (st.cbp_bits[lmb] >> bit_a) & 1
                )
            ctx2 = 2 * upper + left
            s, m, base = self.ctx.group("BCBP", _TYPE2CTX_BCBP[btype])
            cbf = self.dec.decision((s, m), base + ctx2)
        if cbf:
            bit = self._cbf_bit_for(btype, is_v, bx, by)
            mask = 1 << bit
            if btype == M.LUMA_8x8:
                mask |= (1 << (bit + 1)) | (1 << (bit + 4)) | (1 << (bit + 5))
            st.cbp_bits[addr] |= mask
        return cbf

    # ------------------------------------------------------------------
    # IPCM
    # ------------------------------------------------------------------
    def _read_ipcm(self, addr: int):
        st = self.st
        dec = self.dec
        # align to byte boundary, read raw samples, restart engine
        pos = (dec.pos + 7) & ~7
        data = self.rbsp
        bd = self.sps.bit_depth_luma
        assert bd == 8, "IPCM for high bit depth lands with 9/10-bit support"
        luma = np.frombuffer(
            data[pos // 8 : pos // 8 + 256], np.uint8
        ).reshape(16, 16).astype(np.int32)
        pos += 256 * 8
        cw, ch = self.sps.mb_chroma_size
        chroma = []
        for _ in range(2 if self.sps.chroma_format_idc else 0):
            n = cw * ch
            chroma.append(
                np.frombuffer(data[pos // 8 : pos // 8 + n], np.uint8)
                .reshape(ch, cw)
                .astype(np.int32)
            )
            pos += n * 8
        st.ipcm_samples[addr] = (luma, *chroma)
        st.qp[addr] = self.qp
        self._set_chroma_qp(addr)
        # per spec the cbf context bitmap is all-ones for IPCM (handled via
        # mb_type checks in neighbors); nnz=16 for CAVLC neighbors
        x4, y4 = st.mb_block_origin(addr)
        st.nnz[:, y4 : y4 + 4, x4 : x4 + 4] = 16
        self.last_dquant = 0
        # restart arithmetic engine at new position
        new_dec = CabacDecoder(data, pos)
        self.dec = new_dec

    def _set_chroma_qp(self, addr: int):
        st = self.st
        qp = int(st.qp[addr])
        cb_off, cr_off = self.pps.chroma_qp_offset
        st.qpc[addr, 0] = chroma_qp(qp, cb_off)
        st.qpc[addr, 1] = chroma_qp(qp, cr_off)
