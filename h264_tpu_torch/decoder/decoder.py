"""Top-level H.264 decoder: NAL stream -> decoded frames.

Host-side orchestration (the JM ldecod.c/image.c role): NAL iteration,
parameter-set activation, picture boundary detection, slice parse
dispatch, MV derivation, reconstruction, deblocking, DPB management.
A copy of the reference package's decoder/decoder.py whose device path
(``use_device=True``, the default here) runs the inter reconstruction as
K8 on a CUDA card (decoder/device.py), or its plain PyTorch version on
the CPU with ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import NalUnitType, iter_annexb_nalus
from ..device import resolve_device
from ..ops import interp as MCI
from ..ops.deblock import deblock_picture
from ..syntax.parsets import PPS, SPS, parse_pps, parse_sps
from ..syntax.slice_header import SliceHeader, SliceType, parse_slice_header
from .cabac_mb import CabacSliceParser
from .cavlc_mb import CavlcSliceParser
from .dpb import DPB
from .mv import compute_moving_mask, derive_mvs
from .recon import PictureReconstructor, Planes, build_wp_params
from .state import PictureParseState


@dataclass
class DecodedPicture:
    poc: int
    frame_num: int
    planes: Planes
    state: PictureParseState
    is_ref: bool
    is_idr: bool
    slice_type: SliceType
    pic_num: int = 0
    frame_num_wrap: int = 0
    long_term: bool = False
    long_term_idx: int = -1
    _padded: tuple | None = None
    sei: list = None  # SEI messages seen since the previous picture
    tone_mapping: object = None  # active ToneMapping (sei.py), if any

    field_parity: int = -1  # -1 frame picture; 0 top field, 1 bottom

    def to_yuv_bytes(self) -> bytes:
        return self.planes.to_yuv_bytes()

    def padded_planes(self):
        if self._padded is None:
            self._padded = (
                MCI.pad_plane(self.planes.Y),
                MCI.pad_plane(self.planes.U),
                MCI.pad_plane(self.planes.V),
            )
        return self._padded

    @property
    def unique_id(self) -> int:
        return self.poc


class _FieldView:
    """Field-picture view of an SPS: same parameters, half the frame
    height (spec §7.4.2.1 FrameHeightInMbs vs field decoding;
    ldecod/src/image.c field path).  Every consumer downstream — parsers,
    reconstruction, deblocking — then operates on field geometry."""

    def __init__(self, sps):
        self._sps = sps

    def __getattr__(self, name):
        return getattr(self._sps, name)

    is_field_picture = True

    @property
    def frame_height_in_mbs(self):
        return self._sps.pic_height_in_map_units_minus1 + 1

    @property
    def height(self):
        return 16 * self.frame_height_in_mbs


class H264Decoder:
    """Decodes an Annex-B stream; yields pictures in decode order."""

    def __init__(self, conceal_mode: int = 0, use_device: bool = True,
                 device=None):
        """conceal_mode: 0 = strict (parse errors propagate), 1 = frame
        copy, 2 = motion copy (ldecod decoder.cfg ConcealMode;
        erc_do_p.c:1260 conceal_lost_frames).  Modes 1/2 also enable
        slice-loss concealment (erc_do_i.c / erc_do_p.c).

        use_device: run the whole picture's inter reconstruction (MC +
        residual) as one K8 launch (decoder/device.py) on `device` (the
        CUDA card unless the caller names another, "cpu" for the plain
        PyTorch version); intra MBs keep the host raster path.
        use_device=False runs the native host path (native/recon.c).
        Bit-identical either way."""
        self.sps_map: dict[int, SPS] = {}
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self.pending_sei: list = []
        self.active_tone_mapping = None
        self._dp_wait = None  # buffered DPA awaiting its B/C partitions
        self.pps_map: dict[int, PPS] = {}
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.dpb: DPB | None = None
        self.conceal_mode = conceal_mode
        self.poc_gap = 2
        self._field_refs: list = []  # decoded reference FIELDS (PicAFF)

    # -- POC (spec §8.2.1, types 0 and 2) ---------------------------------
    def _compute_poc(self, sh: SliceHeader, sps: SPS) -> int:
        if sps.pic_order_cnt_type == 0:
            max_lsb = sps.max_pic_order_cnt_lsb
            if sh.is_idr:
                self.prev_poc_msb = 0
                self.prev_poc_lsb = 0
            lsb = sh.pic_order_cnt_lsb
            if lsb < self.prev_poc_lsb and (self.prev_poc_lsb - lsb) >= max_lsb // 2:
                msb = self.prev_poc_msb + max_lsb
            elif lsb > self.prev_poc_lsb and (lsb - self.prev_poc_lsb) > max_lsb // 2:
                msb = self.prev_poc_msb - max_lsb
            else:
                msb = self.prev_poc_msb
            poc = msb + lsb
            if sh.nal_ref_idc:
                self.prev_poc_msb = msb
                self.prev_poc_lsb = lsb
            return poc
        if sps.pic_order_cnt_type == 2:
            if sh.is_idr:
                self.prev_frame_num_offset = 0
                off = 0
            else:
                if sh.frame_num < self.prev_frame_num:
                    off = self.prev_frame_num_offset + sps.max_frame_num
                else:
                    off = self.prev_frame_num_offset
                self.prev_frame_num_offset = off
            tmp = off + sh.frame_num
            return 2 * tmp if sh.nal_ref_idc else 2 * tmp - 1
        # POC type 1 (spec §8.2.1.2; ldecod/src/header.c:596 decode_poc)
        if sh.is_idr:
            off = 0
        elif self.prev_frame_num > sh.frame_num:
            off = self.prev_frame_num_offset + sps.max_frame_num
        else:
            off = self.prev_frame_num_offset
        self.prev_frame_num_offset = off
        cycle = len(sps.offset_for_ref_frame)
        abs_frame_num = off + sh.frame_num if cycle else 0
        if sh.nal_ref_idc == 0 and abs_frame_num > 0:
            abs_frame_num -= 1
        expected = 0
        if abs_frame_num > 0:
            cycle_cnt = (abs_frame_num - 1) // cycle
            in_cycle = (abs_frame_num - 1) % cycle
            expected = cycle_cnt * sum(sps.offset_for_ref_frame)
            expected += sum(sps.offset_for_ref_frame[: in_cycle + 1])
        if sh.nal_ref_idc == 0:
            expected += sps.offset_for_non_ref_pic
        top = expected + sh.delta_pic_order_cnt[0]
        bottom = (
            top + sps.offset_for_top_to_bottom_field + sh.delta_pic_order_cnt[1]
        )
        return min(top, bottom)

    # -- main decode loop --------------------------------------------------
    def decode_stream(self, data: bytes):
        """Generator of DecodedPicture in decode order (Annex-B input)."""
        yield from self.decode_nalus(iter_annexb_nalus(data))

    def decode_nalus(self, nalus):
        """Generator of DecodedPicture in decode order from an iterable of
        NalUnit (Annex-B or RTP transport already removed)."""
        pending = None
        for nalu in nalus:
            t = nalu.nal_unit_type
            if t == NalUnitType.SEI:
                from ..syntax.sei import ToneMapping, parse_sei

                msgs = parse_sei(nalu.rbsp, self.sps_map)
                self.pending_sei.extend(msgs)
                for m in msgs:
                    if isinstance(m, ToneMapping) and m.tone_map_id == 0:
                        # applied to output only in RGB mode, like JM
                        # (ldecod/src/output.c:395); tracked regardless
                        self.active_tone_mapping = (
                            None if m.cancel_flag else m
                        )
            elif t == NalUnitType.SPS:
                s = parse_sps(nalu.rbsp)
                self.sps_map[s.seq_parameter_set_id] = s
            elif t == NalUnitType.PPS:
                p = parse_pps(nalu.rbsp)
                self.pps_map[p.pic_parameter_set_id] = p
            elif t in (NalUnitType.DPB, NalUnitType.DPC):
                # attach partition B/C to the waiting DPA, matched by
                # slice_id (ldecod/src/nal_part.c partition assembly):
                # if the slice's DPA was lost, its B/C partitions must
                # NOT attach to the previous slice's waiting DPA
                if self._dp_wait is not None:
                    from ..bitstream.reader import BitReader

                    r = BitReader(nalu.rbsp)
                    sid = r.ue()  # slice_id
                    if self._dp_wait["pps"].redundant_pic_cnt_present_flag:
                        r.ue()
                    key = "b" if t == NalUnitType.DPB else "c"
                    if sid == self._dp_wait["slice_id"]:
                        self._dp_wait[key] = (nalu.rbsp, r.pos)
            elif t in (NalUnitType.SLICE, NalUnitType.IDR, NalUnitType.DPA):
                self._flush_dp()
                sh, sps, pps = parse_slice_header(
                    nalu.rbsp, self.sps_map, self.pps_map, nalu.nal_ref_idc,
                    nalu.is_idr,
                )
                dpa_slice_id = None
                if t == NalUnitType.DPA:
                    from ..bitstream.reader import BitReader

                    r = BitReader(nalu.rbsp, sh.header_bit_len)
                    dpa_slice_id = r.ue()  # slice_id
                    sh.header_bit_len = r.pos
                    sh.is_dp = True
                if self.dpb is None:
                    self.dpb = DPB(sps)
                poc = self._compute_poc(sh, sps)
                is_new = pending is None or self._is_new_picture(pending, sh, poc)
                if (sh.redundant_pic_cnt > 0 and pending is not None
                        and sh.frame_num == pending["sh0"].frame_num
                        and poc == pending["poc"]):
                    is_new = False  # redundant slices extend their primary
                if is_new and pending is not None:
                    yield self._finish_picture(pending)
                    pending = None
                if (
                    is_new and self.conceal_mode and not sh.is_idr
                    and sh.nal_ref_idc
                    and self.dpb.short_term_refs()
                ):
                    yield from self._conceal_frame_gap(sh, sps)
                elif (
                    is_new and not self.conceal_mode and not sh.is_idr
                    and not sps.gaps_in_frame_num_value_allowed_flag
                    and self.dpb.short_term_refs()
                    and sh.frame_num not in (
                        self.prev_frame_num,
                        (self.prev_frame_num + 1) % sps.max_frame_num,
                    )
                ):
                    # JM strict behavior (ldecod/src/image.c:2394):
                    # "An unintentional loss of pictures occurs! Exit"
                    raise ValueError(
                        f"frame_num gap ({self.prev_frame_num} -> "
                        f"{sh.frame_num}) with concealment disabled"
                    )
                self.prev_frame_num = sh.frame_num
                if pending is None:
                    if sh.is_idr:
                        self.dpb.idr_flush()
                        self._field_refs.clear()
                    sps_pic = (_FieldView(sps) if sh.field_pic_flag
                               else sps)
                    state = PictureParseState(
                        sps_pic.pic_width_in_mbs,
                        sps_pic.frame_height_in_mbs
                    )
                    pending = {
                        "state": state,
                        "sps": sps_pic,
                        "pps": pps,
                        "poc": poc,
                        "sh0": sh,
                        "slices": [],
                    }
                if sh.redundant_pic_cnt > 0:
                    # redundant coded slice: used only when the primary
                    # is damaged or missing (ldecod/src/image.c:157
                    # Error_tracking; lencod.c:2718 redundant frames) —
                    # primaries precede redundants in the stream, so an
                    # empty picture here means the primary was lost
                    if not pending.get("lost", 0) and pending["slices"]:
                        continue
                    if pending.get("lost", 0):
                        pending["lost"] -= 1
                    self._parse_slice(pending, nalu.rbsp, sh, sps, pps)
                elif t == NalUnitType.DPA:
                    self._dp_wait = {
                        "pending": pending, "rbsp": nalu.rbsp, "sh": sh,
                        "sps": sps, "pps": pps, "b": None, "c": None,
                        "slice_id": dpa_slice_id,
                    }
                else:
                    self._parse_slice(pending, nalu.rbsp, sh, sps, pps)
        self._flush_dp()
        if pending is not None:
            yield self._finish_picture(pending)

    def _flush_dp(self) -> None:
        """Parse a buffered data-partitioned slice once its B/C
        partitions (if any) have arrived."""
        dp = self._dp_wait
        if dp is None:
            return
        self._dp_wait = None
        self._parse_slice(
            dp["pending"], dp["rbsp"], dp["sh"], dp["sps"], dp["pps"],
            part_b=dp["b"], part_c=dp["c"],
        )

    def _conceal_frame_gap(self, sh: SliceHeader, sps: SPS):
        """Insert concealed reference frames for frame_num gaps
        (erc_do_p.c:1260 conceal_lost_frames; mbuffer.c:3426 gap fill)."""
        from .erc import conceal_lost_frame

        max_fn = sps.max_frame_num
        expected = (self.prev_frame_num + 1) % max_fn
        if sh.frame_num in (self.prev_frame_num, expected):
            return
        fn = expected
        while fn != sh.frame_num:
            refs = sorted(
                self.dpb.short_term_refs(), key=lambda p: -p.poc
            )
            if not refs:
                break
            src = refs[0]
            planes = conceal_lost_frame(sps, src, self.conceal_mode)
            st = PictureParseState(sps.pic_width_in_mbs,
                                   sps.frame_height_in_mbs)
            st.slice_id[:] = 0
            st.mv[0] = np.asarray(src.state.mv[0])
            st.ref_idx[0] = np.asarray(src.state.ref_idx[0])
            pic = DecodedPicture(
                poc=src.poc + self.poc_gap,
                frame_num=fn,
                planes=planes,
                state=st,
                is_ref=True,
                is_idr=False,
                slice_type=SliceType.P,
            )
            pic.concealed = True
            self.dpb.update_pic_nums(fn, max_fn)
            self.dpb.store(pic, None)
            self.prev_poc_lsb = pic.poc % sps.max_pic_order_cnt_lsb \
                if sps.pic_order_cnt_type == 0 else self.prev_poc_lsb
            yield pic
            fn = (fn + 1) % max_fn

    def _is_new_picture(self, pending, sh: SliceHeader, poc: int) -> bool:
        sh0: SliceHeader = pending["sh0"]
        return (
            sh.frame_num != sh0.frame_num
            or poc != pending["poc"]
            or sh.pic_parameter_set_id != sh0.pic_parameter_set_id
            or (sh.is_idr != sh0.is_idr)
            or (sh.is_idr and sh.idr_pic_id != sh0.idr_pic_id)
            or sh.field_pic_flag != sh0.field_pic_flag
            or sh.bottom_field_flag != sh0.bottom_field_flag
            or sh.first_mb_in_slice == 0
        )

    def _parse_slice(self, pending, rbsp: bytes, sh: SliceHeader, sps, pps,
                     part_b=None, part_c=None):
        state = pending["state"]
        sid = len(pending["slices"])
        if pps.entropy_coding_mode_flag:
            # native fused parse first (the decode-throughput path); the
            # Python parser below stays as the portable oracle
            fmo_next = None
            if pps.num_slice_groups_minus1 > 0:
                from ..syntax.fmo import mb_to_slice_group, next_mb_array

                sg_map = mb_to_slice_group(
                    sps, pps, sh.slice_group_change_cycle)
                fmo_next = next_mb_array(sg_map)
            try:
                from ..native import cabac_parse_slice

                n = cabac_parse_slice(state, rbsp, sh, sps, pps, sid,
                                      fmo_next=fmo_next)
            except ValueError:
                n = -1  # corrupt slice: same handling as a parse raise
            if n is not None and n >= 0:
                pending["slices"].append(sh)
                return
            if n == -1:
                if not self.conceal_mode:
                    raise ValueError("corrupt CABAC slice data")
                bad = np.asarray(state.slice_id) == sid
                state.slice_id[bad] = -1
                state.mb_type[bad] = -1
                state.is_intra[bad] = 0
                state.skip_flag[bad] = 0
                state.cbp[bad] = 0
                bad4 = np.repeat(np.repeat(
                    bad.reshape(state.H, state.W), 4, 0), 4, 1)
                state.ref_idx[:, bad4] = -1
                state.mv[:, bad4] = 0
                pending["lost"] = pending.get("lost", 0) + 1
                return
            parser = CabacSliceParser(rbsp, sh, sps, pps, state, sid)
            parser.trace = None
        else:
            if part_b is None and part_c is None and not sh.is_dp:
                fmo_next = None
                if pps.num_slice_groups_minus1 > 0:
                    from ..syntax.fmo import mb_to_slice_group, \
                        next_mb_array

                    sg_map = mb_to_slice_group(
                        sps, pps, sh.slice_group_change_cycle)
                    fmo_next = next_mb_array(sg_map)
                try:
                    from ..native import cavlc_parse_slice

                    n = cavlc_parse_slice(state, rbsp, sh, sps, pps, sid,
                                          fmo_next=fmo_next)
                except ValueError:
                    n = -1
                if n is not None and n >= 0:
                    pending["slices"].append(sh)
                    return
                if n == -1:
                    if not self.conceal_mode:
                        raise ValueError("corrupt CAVLC slice data")
                    bad = np.asarray(state.slice_id) == sid
                    state.slice_id[bad] = -1
                    state.mb_type[bad] = -1
                    state.is_intra[bad] = 0
                    state.skip_flag[bad] = 0
                    state.cbp[bad] = 0
                    bad4 = np.repeat(np.repeat(
                        bad.reshape(state.H, state.W), 4, 0), 4, 1)
                    state.ref_idx[:, bad4] = -1
                    state.mv[:, bad4] = 0
                    pending["lost"] = pending.get("lost", 0) + 1
                    return
            parser = CavlcSliceParser(rbsp, sh, sps, pps, state, sid)
            if part_b is not None or part_c is not None or sh.is_dp:
                from ..bitstream.reader import BitReader

                parser.dp = True
                parser.rB = (None if part_b is None
                             else BitReader(part_b[0], part_b[1]))
                parser.rC = (None if part_c is None
                             else BitReader(part_c[0], part_c[1]))
        if pps.num_slice_groups_minus1 > 0:
            from ..syntax.fmo import mb_to_slice_group, next_mb_array

            sg_map = mb_to_slice_group(sps, pps, sh.slice_group_change_cycle)
            nxt = next_mb_array(sg_map)
            parser.next_addr = lambda a: int(nxt[a])
        try:
            parser.parse()
        except Exception:
            if not self.conceal_mode:
                raise
            # drop the damaged slice: every MB it touched is re-marked
            # missing and left to the concealment pass (the JM per-
            # partition/segment drop, ldecod/src/image.c + erc_api.c)
            bad = np.asarray(state.slice_id) == sid
            state.slice_id[bad] = -1
            state.mb_type[bad] = -1
            state.is_intra[bad] = 0
            state.skip_flag[bad] = 0
            state.cbp[bad] = 0
            bad4 = np.repeat(np.repeat(
                bad.reshape(state.H, state.W), 4, 0), 4, 1)
            state.ref_idx[:, bad4] = -1
            state.mv[:, bad4] = 0
            pending["lost"] = pending.get("lost", 0) + 1
            return
        pending["slices"].append(sh)

    def _field_lists(self, parity: int, cur_fn: int, max_fn: int):
        """P-field reference list (spec §8.2.4.2.2/§8.2.4.2.5): frames by
        FrameNumWrap descending, fields alternating parity starting with
        the current field's parity, missing fields skipped."""
        by_fn: dict[int, list] = {}
        for f in self._field_refs:
            by_fn.setdefault(f.frame_num, []).append(f)

        def wrap(fn):
            return fn - max_fn if fn > cur_fn else fn

        frames = sorted(by_fn, key=lambda fn: -wrap(fn))
        same = [f for fn in frames for f in by_fn[fn]
                if f.field_parity == parity]
        opp = [f for fn in frames for f in by_fn[fn]
               if f.field_parity != parity]
        out = []
        i = j = 0
        while i < len(same) or j < len(opp):
            if i < len(same):
                out.append(same[i])
                i += 1
            if j < len(opp):
                out.append(opp[j])
                j += 1
        return [out, []]

    def _finish_field_picture(self, pending) -> DecodedPicture:
        """Field-picture reconstruction (PicAFF decode side; I/P fields,
        no MBAFF).  Each field is a half-height picture over the
        _FieldView geometry; reference lists come from the decoded-field
        buffer (ldecod/src/mbuffer.c field list init)."""
        state: PictureParseState = pending["state"]
        sps = pending["sps"]
        pps: PPS = pending["pps"]
        sh0: SliceHeader = pending["sh0"]
        poc = pending["poc"]
        parity = 1 if sh0.bottom_field_flag else 0
        if sh0.slice_type not in (SliceType.I, SliceType.P):
            raise NotImplementedError("B field pictures")
        planes = Planes(sps)
        slice_info = []
        slice_refs = []
        slice_wp = []
        slice_cadj = []
        for sh in pending["slices"]:
            lists = self._field_lists(parity, sh0.frame_num,
                                      sps.max_frame_num)
            lists[0] = lists[0][: sh.num_ref_idx_l0_active_minus1 + 1]
            slice_info.append({
                "type": sh.slice_type,
                "cur_poc": poc,
                "ref_ids": [[p.unique_id for p in lists[0]], []],
                "ref_lt": [[p.long_term for p in lists[0]], []],
                "col": None,
                "direct_8x8_inference": sps.direct_8x8_inference_flag,
                "spatial_direct": True,
            })
            slice_refs.append(
                [[p.padded_planes() for p in lists[0]], []])
            slice_wp.append(build_wp_params(sh, pps, lists, poc))
            # opposite-parity chroma vertical adjustment (spec §8.4.1.4.1;
            # ldecod/src/macroblock.c:4296: top field -2, bottom +2)
            slice_cadj.append([
                [(0 if p.field_parity == parity
                  else (-2 if parity == 0 else 2)) for p in lists[0]],
                [],
            ])
        native_done = False
        if not self.use_device:
            from ..native import recon_picture as native_recon

            native_done = native_recon(
                state, sps, pps, planes, slice_info, slice_refs, slice_wp,
                slice_cadj=slice_cadj)
        if not native_done:
            if sh0.slice_type != SliceType.I:
                derive_mvs(state, state.slice_id, slice_info)
            recon = PictureReconstructor(
                state, sps, pps, planes, slice_refs, slice_wp,
                slice_cadj=slice_cadj)
            for addr in range(state.n_mbs):
                recon.recon_mb(addr)
        deblock_picture(state, sps, planes)
        pic = DecodedPicture(
            poc=poc,
            frame_num=sh0.frame_num,
            planes=planes,
            state=state,
            is_ref=sh0.nal_ref_idc != 0,
            is_idr=sh0.is_idr,
            slice_type=sh0.slice_type,
            sei=self.pending_sei,
            tone_mapping=self.active_tone_mapping,
            field_parity=parity,
        )
        self.pending_sei = []
        if pic.is_ref:
            # sliding window over complementary FRAME pairs: when the
            # frame count exceeds num_ref_frames, the oldest frame's
            # fields leave together (mbuffer.c sliding_window semantics)
            self._field_refs.append(pic)
            max_fn = sps.max_frame_num

            def wrap(fn):
                return fn - max_fn if fn > sh0.frame_num else fn

            while len({f.frame_num for f in self._field_refs}) > \
                    sps.num_ref_frames:
                oldest = min({f.frame_num for f in self._field_refs},
                             key=wrap)
                self._field_refs = [f for f in self._field_refs
                                    if f.frame_num != oldest]
        return pic

    def _finish_picture(self, pending) -> DecodedPicture:
        state: PictureParseState = pending["state"]
        sps: SPS = pending["sps"]
        pps: PPS = pending["pps"]
        sh0: SliceHeader = pending["sh0"]
        poc = pending["poc"]
        if sh0.field_pic_flag:
            return self._finish_field_picture(pending)
        planes = Planes(sps)

        # per-slice reference lists + colocated info
        self.dpb.update_pic_nums(sh0.frame_num, sps.max_frame_num)
        slice_info = []
        slice_refs = []
        slice_wp = []
        slice_lists = []
        for sh in pending["slices"]:
            lists = self.dpb.build_lists(sh, poc)
            slice_lists.append(lists)
            info = {
                "type": sh.slice_type,
                "cur_poc": poc,
                "ref_ids": [
                    [p.unique_id for p in lists[0]],
                    [p.unique_id for p in lists[1]],
                ],
                "ref_lt": [
                    [p.long_term for p in lists[0]],
                    [p.long_term for p in lists[1]],
                ],
                "col": None,
                "direct_8x8_inference": sps.direct_8x8_inference_flag,
                "spatial_direct": sh.direct_spatial_mv_pred_flag,
            }
            if sh.slice_type == SliceType.B and lists[1]:
                colpic = lists[1][0]
                cst = colpic.state
                info["col"] = {
                    "moving": compute_moving_mask(cst, colpic.long_term),
                    "pic": colpic,
                    "poc": colpic.poc,
                    "ref_idx0": cst.ref_idx[0],
                    "ref_idx1": cst.ref_idx[1],
                    "ref_id0": cst.ref_pic_id[0],
                    "ref_id1": cst.ref_pic_id[1],
                    "mv0": cst.mv[0],
                    "mv1": cst.mv[1],
                }
            slice_info.append(info)
            slice_refs.append(
                [
                    [p.padded_planes() for p in lists[0]],
                    [p.padded_planes() for p in lists[1]],
                ]
            )
            slice_wp.append(build_wp_params(sh, pps, lists, poc))

        native_done = False
        if not self.use_device:
            # native runtime tail: MV derivation + full reconstruction in
            # one C pass (native/recon.c); falls back to the oracle below
            from ..native import recon_picture as native_recon

            native_done = native_recon(
                state, sps, pps, planes, slice_info, slice_refs, slice_wp,
                deblock=True)
        if not native_done and sh0.slice_type != SliceType.I:
            derive_mvs(state, state.slice_id, slice_info)

        recon = PictureReconstructor(
            state, sps, pps, planes, slice_refs, slice_wp
        )
        missing = np.asarray(state.slice_id) < 0
        n_missing = int(missing.sum())
        if n_missing:
            state.lf_disable[missing] = 1  # JM order: filter, then conceal
        inter_done = None
        dev_finalize = None
        if (not native_done and self.use_device and sps.bit_depth_luma == 8
                and sps.chroma_format_idc == 1):
            from .device import decode_inter_picture

            out = decode_inter_picture(
                state, sps, pps, planes, slice_info, slice_lists, slice_wp,
                self.device)
            if out is not None:
                inter_done, dev_finalize = out
        if dev_finalize is not None:
            # one packed d2h fetch; intra MBs below predict from the
            # fetched inter neighbors (decoder raster semantics)
            dev_finalize()
        if not native_done:
            for addr in range(state.n_mbs):
                if missing[addr]:
                    continue
                if inter_done is not None and inter_done[addr]:
                    continue
                recon.recon_mb(addr)
        if native_done != 2:  # 2 = the fused native call already filtered
            deblock_picture(state, sps, planes)
        if n_missing:
            from .erc import conceal_missing

            refs = sorted(
                self.dpb.short_term_refs() + self.dpb.long_term_refs(),
                key=lambda p: abs(p.poc - poc),
            )
            conceal_missing(
                state, sps, planes, refs[0] if refs else None,
                sh0.slice_type == SliceType.I and not refs,
            )

        pic = DecodedPicture(
            poc=poc,
            frame_num=sh0.frame_num,
            planes=planes,
            state=state,
            is_ref=sh0.nal_ref_idc != 0,
            is_idr=sh0.is_idr,
            slice_type=sh0.slice_type,
            sei=self.pending_sei,
            tone_mapping=self.active_tone_mapping,
        )
        self.pending_sei = []
        if sh0.is_idr and sh0.long_term_reference_flag:
            pic.long_term = True
            pic.long_term_idx = 0
        mmco5 = self.dpb.store(pic, sh0)
        if mmco5:
            # spec §8.2.1: after MMCO5 the current picture acts as POC 0
            pic.poc = 0
            pic.frame_num = 0
            self.prev_poc_msb = self.prev_poc_lsb = 0
            self.prev_frame_num = 0
            self.prev_frame_num_offset = 0
        return pic


def weave_fields(pics: list) -> list:
    """Pair decoded top/bottom fields into frame pictures (output-stage
    field pairing, ldecod/src/output.c flush_pending_output): lines of
    the top field land on even frame rows, bottom on odd."""
    out = [p for p in pics if p.field_parity < 0]
    fields = sorted((p for p in pics if p.field_parity >= 0),
                    key=lambda p: p.poc)
    used = set()
    for i, top in enumerate(fields):
        if id(top) in used or top.field_parity != 0:
            continue
        bot = next(
            (f for f in fields[i + 1:]
             if id(f) not in used and f.field_parity == 1
             and f.frame_num == top.frame_num), None)
        if bot is None:
            continue
        used.add(id(top))
        used.add(id(bot))
        import copy as _copy

        frame = _copy.copy(top)
        pl = Planes.__new__(Planes)
        H2, W = top.planes.Y.shape
        pl.Y = np.empty((2 * H2, W), np.int32)
        pl.Y[0::2] = np.asarray(top.planes.Y)
        pl.Y[1::2] = np.asarray(bot.planes.Y)
        Hc, Wc = top.planes.U.shape
        pl.U = np.empty((2 * Hc, Wc), np.int32)
        pl.V = np.empty((2 * Hc, Wc), np.int32)
        pl.U[0::2] = np.asarray(top.planes.U)
        pl.U[1::2] = np.asarray(bot.planes.U)
        pl.V[0::2] = np.asarray(top.planes.V)
        pl.V[1::2] = np.asarray(bot.planes.V)
        frame.planes = pl
        frame.field_parity = -1
        out.append(frame)
    return sorted(out, key=lambda p: p.poc)


def decode_annexb(data: bytes, use_device: bool = True, device=None) -> list:
    """Decode a stream; returns pictures in output (POC) order; field
    pictures come back woven into frames."""
    dec = H264Decoder(use_device=use_device, device=device)
    pics = list(dec.decode_stream(data))
    if any(p.field_parity >= 0 for p in pics):
        return weave_fields(pics)
    return sorted(pics, key=lambda p: p.poc)
