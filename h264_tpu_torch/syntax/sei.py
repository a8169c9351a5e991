"""SEI messages: parse, write, and tone-mapping LUT behavior.

Capability parity with the reference SEI subsystem (ldecod/src/sei.c
InterpretSEIMessage:75 and the per-payload interpreters;
lencod/src/sei.c writers), re-designed as typed dataclasses with
symmetric parse/write and the payload registry dispatch replaced by a
dict.  Typed payloads: buffering period (0), picture timing (1), user
data unregistered (5), recovery point (6), tone mapping (23); every
other payload round-trips as raw bytes.

Tone-mapping LUT construction mirrors ldecod/src/sei.c:1871
interpret_tone_mapping (models 0-3); per JM, the LUT is applied to
output pictures only in RGB output mode (output.c:395).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.reader import BitReader
from ..bitstream.writer import BitWriter

BUFFERING_PERIOD = 0
PIC_TIMING = 1
PAN_SCAN_RECT = 2
FILLER_PAYLOAD = 3
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6
DEC_REF_PIC_MARKING_REPETITION = 7
SCENE_INFO = 9
FULL_FRAME_FREEZE = 13
FULL_FRAME_FREEZE_RELEASE = 14
TONE_MAPPING = 23


@dataclass
class BufferingPeriod:
    payload_type = BUFFERING_PERIOD
    seq_parameter_set_id: int = 0
    # per HRD (nal then vcl): list of (initial_cpb_removal_delay,
    # initial_cpb_removal_delay_offset) per cpb_cnt
    nal_cpb: list[tuple[int, int]] = field(default_factory=list)
    vcl_cpb: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class PicTiming:
    payload_type = PIC_TIMING
    cpb_removal_delay: int = 0
    dpb_output_delay: int = 0
    pic_struct: int | None = None  # present iff pic_struct_present_flag


@dataclass
class UserDataUnregistered:
    payload_type = USER_DATA_UNREGISTERED
    uuid: bytes = b"\x00" * 16
    data: bytes = b""


@dataclass
class RecoveryPoint:
    payload_type = RECOVERY_POINT
    recovery_frame_cnt: int = 0
    exact_match_flag: bool = True
    broken_link_flag: bool = False
    changing_slice_group_idc: int = 0


@dataclass
class ToneMapping:
    payload_type = TONE_MAPPING
    tone_map_id: int = 0
    cancel_flag: bool = False
    repetition_period: int = 1
    coded_data_bit_depth: int = 8
    sei_bit_depth: int = 8
    model_id: int = 0
    # model 0
    min_value: int = 0
    max_value: int = 255
    # model 1
    sigmoid_midpoint: int = 128
    sigmoid_width: int = 64
    # model 2
    start_of_coded_interval: list[int] = field(default_factory=list)
    # model 3
    coded_pivot_value: list[int] = field(default_factory=list)
    sei_pivot_value: list[int] = field(default_factory=list)

    def lut(self) -> np.ndarray:
        """Tone-map LUT (ldecod/src/sei.c:1871 interpret_tone_mapping)."""
        max_in = 1 << self.coded_data_bit_depth
        max_out = 1 << self.sei_bit_depth
        lut = np.zeros(max_in, np.int64)
        if self.model_id == 0:  # linear with clipping
            lo, hi = self.min_value, self.max_value
            i = np.arange(max_in)
            lut = np.where(
                i <= lo, 0,
                np.where(i >= hi, max_out - 1,
                         (i - lo) * (max_out - 1) // max(1, hi - lo)))
        elif self.model_id == 1:  # sigmoid
            i = np.arange(max_in, dtype=np.float64)
            t = 1.0 + np.exp(-6.0 * (i - self.sigmoid_midpoint)
                             / self.sigmoid_width)
            lut = np.floor((max_out - 1) / t + 0.5).astype(np.int64)
        elif self.model_id == 2:  # user table
            s = self.start_of_coded_interval
            for j in range(max_out - 1):
                lut[s[j]: s[j + 1]] = j
            lut[s[max_out - 1]:] = max_out - 1
        elif self.model_id == 3:  # piecewise linear
            cp = [0, *self.coded_pivot_value, max_in - 1]
            sp = [0, *self.sei_pivot_value, max_out - 1]
            for j in range(len(cp) - 1):
                if cp[j + 1] == cp[j]:
                    continue
                slope = (sp[j + 1] - sp[j]) / (cp[j + 1] - cp[j])
                i = np.arange(cp[j], cp[j + 1] + 1)
                lut[i] = sp[j] + ((i - cp[j]) * slope).astype(np.int64)
        return lut

    def apply(self, plane: np.ndarray) -> np.ndarray:
        lut = self.lut()
        return lut[np.clip(np.asarray(plane, np.int64), 0, len(lut) - 1)]


@dataclass
class PanScanRect:
    """pan_scan_rect SEI (spec D.2.4; lencod/src/sei.c pan-scan
    writer / ldecod interpreter)."""
    payload_type = PAN_SCAN_RECT
    pan_scan_rect_id: int = 0
    cancel_flag: bool = False
    # (left, right, top, bottom) offsets in 1/16 sample units
    rects: tuple = ()
    repetition_period: int = 0


@dataclass
class SceneInfo:
    """scene_info SEI (spec D.2.10)."""
    payload_type = SCENE_INFO
    scene_info_present_flag: bool = True
    scene_id: int = 0
    scene_transition_type: int = 0
    second_scene_id: int = 0


@dataclass
class FillerPayload:
    """filler_payload SEI (spec D.2.3): n 0xFF bytes."""
    payload_type = FILLER_PAYLOAD
    size: int = 1


@dataclass
class FullFrameFreeze:
    """full_frame_freeze / release SEI (spec D.2.14/15)."""
    release: bool = False
    repetition_period: int = 0

    @property
    def payload_type(self):
        return (FULL_FRAME_FREEZE_RELEASE if self.release
                else FULL_FRAME_FREEZE)


@dataclass
class RawSEI:
    payload_type: int = 0
    data: bytes = b""


# ---------------------------------------------------------------------------
# payload parse/write
# ---------------------------------------------------------------------------

def _hrd_lengths(sps):
    """(init_delay_len, removal_delay_len, output_delay_len) from the
    active SPS HRD, spec E.2.2 defaults (24) when absent."""
    v = getattr(sps, "vui", None) if sps is not None else None
    hrd = (v.nal_hrd or v.vcl_hrd) if v is not None else None
    if hrd is None:
        return 24, 24, 24
    return (hrd.initial_cpb_removal_delay_length_minus1 + 1,
            hrd.cpb_removal_delay_length_minus1 + 1,
            hrd.dpb_output_delay_length_minus1 + 1)


def _parse_buffering_period(b: bytes, sps_map) -> BufferingPeriod:
    r = BitReader(b)
    m = BufferingPeriod()
    m.seq_parameter_set_id = r.ue()
    sps = sps_map.get(m.seq_parameter_set_id) if sps_map else None
    ilen = _hrd_lengths(sps)[0]
    v = getattr(sps, "vui", None) if sps is not None else None
    if v is not None and v.nal_hrd is not None:
        for _ in range(v.nal_hrd.cpb_cnt_minus1 + 1):
            m.nal_cpb.append((r.u(ilen), r.u(ilen)))
    if v is not None and v.vcl_hrd is not None:
        for _ in range(v.vcl_hrd.cpb_cnt_minus1 + 1):
            m.vcl_cpb.append((r.u(ilen), r.u(ilen)))
    return m


def _write_buffering_period(w: BitWriter, m: BufferingPeriod, sps_map):
    w.ue(m.seq_parameter_set_id)
    sps = sps_map.get(m.seq_parameter_set_id) if sps_map else None
    ilen = _hrd_lengths(sps)[0]
    for d, o in m.nal_cpb:
        w.u(d, ilen)
        w.u(o, ilen)
    for d, o in m.vcl_cpb:
        w.u(d, ilen)
        w.u(o, ilen)


def _parse_pic_timing(b: bytes, sps) -> PicTiming:
    r = BitReader(b)
    m = PicTiming()
    v = getattr(sps, "vui", None) if sps is not None else None
    has_hrd = v is not None and (v.nal_hrd or v.vcl_hrd)
    if has_hrd:
        _, rlen, olen = _hrd_lengths(sps)
        m.cpb_removal_delay = r.u(rlen)
        m.dpb_output_delay = r.u(olen)
    if v is not None and v.pic_struct_present_flag:
        m.pic_struct = r.u(4)
        # clock timestamps not carried (JM prints them only)
    return m


def _write_pic_timing(w: BitWriter, m: PicTiming, sps):
    v = getattr(sps, "vui", None) if sps is not None else None
    has_hrd = v is not None and (v.nal_hrd or v.vcl_hrd)
    if has_hrd:
        _, rlen, olen = _hrd_lengths(sps)
        w.u(m.cpb_removal_delay, rlen)
        w.u(m.dpb_output_delay, olen)
    if v is not None and v.pic_struct_present_flag:
        w.u(m.pic_struct or 0, 4)


def _parse_recovery_point(b: bytes) -> RecoveryPoint:
    r = BitReader(b)
    m = RecoveryPoint()
    m.recovery_frame_cnt = r.ue()
    m.exact_match_flag = r.flag()
    m.broken_link_flag = r.flag()
    m.changing_slice_group_idc = r.u(2)
    return m


def _write_recovery_point(w: BitWriter, m: RecoveryPoint):
    w.ue(m.recovery_frame_cnt)
    w.flag(m.exact_match_flag)
    w.flag(m.broken_link_flag)
    w.u(m.changing_slice_group_idc, 2)


def _parse_tone_mapping(b: bytes) -> ToneMapping:
    """Correct model-3 interleaved pivot parse (spec D.1.24 order:
    (coded_pivot_value[i], sei_pivot_value[i]) per pivot)."""
    r = BitReader(b)
    m = ToneMapping()
    m.tone_map_id = r.ue()
    m.cancel_flag = r.flag()
    if m.cancel_flag:
        return m
    m.repetition_period = r.ue()
    m.coded_data_bit_depth = r.u(8)
    m.sei_bit_depth = r.u(8)
    m.model_id = r.ue()
    cbits = ((m.coded_data_bit_depth + 7) >> 3) << 3
    sbits = ((m.sei_bit_depth + 7) >> 3) << 3
    if m.model_id == 0:
        m.min_value = r.u(32)
        m.max_value = r.u(32)
    elif m.model_id == 1:
        m.sigmoid_midpoint = r.u(32)
        m.sigmoid_width = r.u(32)
    elif m.model_id == 2:
        m.start_of_coded_interval = [
            r.u(cbits) for _ in range(1 << m.sei_bit_depth)
        ]
    elif m.model_id == 3:
        n = r.u(16)
        for _ in range(n):
            m.coded_pivot_value.append(r.u(cbits))
            m.sei_pivot_value.append(r.u(sbits))
    return m


def _write_tone_mapping(w: BitWriter, m: ToneMapping):
    w.ue(m.tone_map_id)
    w.flag(m.cancel_flag)
    if m.cancel_flag:
        return
    w.ue(m.repetition_period)
    w.u(m.coded_data_bit_depth, 8)
    w.u(m.sei_bit_depth, 8)
    w.ue(m.model_id)
    cbits = ((m.coded_data_bit_depth + 7) >> 3) << 3
    sbits = ((m.sei_bit_depth + 7) >> 3) << 3
    if m.model_id == 0:
        w.u(m.min_value, 32)
        w.u(m.max_value, 32)
    elif m.model_id == 1:
        w.u(m.sigmoid_midpoint, 32)
        w.u(m.sigmoid_width, 32)
    elif m.model_id == 2:
        for v in m.start_of_coded_interval:
            w.u(v, cbits)
    elif m.model_id == 3:
        w.u(len(m.coded_pivot_value), 16)
        for c, s in zip(m.coded_pivot_value, m.sei_pivot_value):
            w.u(c, cbits)
            w.u(s, sbits)


def _parse_user_data(b: bytes) -> UserDataUnregistered:
    return UserDataUnregistered(uuid=b[:16], data=b[16:])


# ---------------------------------------------------------------------------
# sei_rbsp() level
# ---------------------------------------------------------------------------

def _parse_pan_scan(b: bytes) -> PanScanRect:
    r = BitReader(b)
    m = PanScanRect(pan_scan_rect_id=r.ue(), cancel_flag=r.flag())
    if not m.cancel_flag:
        cnt = r.ue() + 1
        rects = []
        for _ in range(cnt):
            rects.append((r.se(), r.se(), r.se(), r.se()))
        m.rects = tuple(rects)
        m.repetition_period = r.ue()
    return m


def _write_pan_scan(w: BitWriter, m: PanScanRect):
    w.ue(m.pan_scan_rect_id)
    w.flag(m.cancel_flag)
    if not m.cancel_flag:
        w.ue(len(m.rects) - 1)
        for (l, rr, t, bo) in m.rects:
            w.se(l)
            w.se(rr)
            w.se(t)
            w.se(bo)
        w.ue(m.repetition_period)


def _parse_scene_info(b: bytes) -> SceneInfo:
    r = BitReader(b)
    m = SceneInfo(scene_info_present_flag=r.flag())
    if m.scene_info_present_flag:
        m.scene_id = r.ue()
        m.scene_transition_type = r.ue()
        if m.scene_transition_type > 3:
            m.second_scene_id = r.ue()
    return m


def _write_scene_info(w: BitWriter, m: SceneInfo):
    w.flag(m.scene_info_present_flag)
    if m.scene_info_present_flag:
        w.ue(m.scene_id)
        w.ue(m.scene_transition_type)
        if m.scene_transition_type > 3:
            w.ue(m.second_scene_id)


def _parse_freeze(b: bytes, release: bool) -> FullFrameFreeze:
    m = FullFrameFreeze(release=release)
    if not release:
        m.repetition_period = BitReader(b).ue()
    return m


def parse_sei(rbsp: bytes, sps_map=None, active_sps=None) -> list:
    """Parse an SEI NAL's RBSP into typed messages (unknown types kept
    raw).  (ldecod/src/sei.c:75 InterpretSEIMessage.)"""
    out = []
    i = 0
    n = len(rbsp)
    while i < n:
        if rbsp[i] == 0x80 and i == n - 1:  # rbsp trailing bits
            break
        pt = 0
        while i < n and rbsp[i] == 0xFF:
            pt += 255
            i += 1
        if i >= n:  # truncated/corrupt SEI: drop the damaged tail
            break
        pt += rbsp[i]
        i += 1
        ps = 0
        while i < n and rbsp[i] == 0xFF:
            ps += 255
            i += 1
        if i >= n:
            break
        ps += rbsp[i]
        i += 1
        if i + ps > n:  # payload extends past the NAL: damaged
            break
        body = rbsp[i : i + ps]
        i += ps
        try:
            if pt == BUFFERING_PERIOD:
                out.append(_parse_buffering_period(body, sps_map))
            elif pt == PIC_TIMING:
                out.append(_parse_pic_timing(body, active_sps))
            elif pt == PAN_SCAN_RECT:
                out.append(_parse_pan_scan(body))
            elif pt == SCENE_INFO:
                out.append(_parse_scene_info(body))
            elif pt == FILLER_PAYLOAD:
                out.append(FillerPayload(size=len(body)))
            elif pt in (FULL_FRAME_FREEZE, FULL_FRAME_FREEZE_RELEASE):
                out.append(_parse_freeze(body, pt == FULL_FRAME_FREEZE_RELEASE))
            elif pt == USER_DATA_UNREGISTERED:
                out.append(_parse_user_data(body))
            elif pt == RECOVERY_POINT:
                out.append(_parse_recovery_point(body))
            elif pt == TONE_MAPPING:
                out.append(_parse_tone_mapping(body))
            else:
                out.append(RawSEI(payload_type=pt, data=body))
        except (IndexError, ValueError):
            # damaged payload (loss/corruption paths): keep it raw like
            # other damaged NALs instead of aborting the decode
            out.append(RawSEI(payload_type=pt, data=body))
    return out


def _payload_bytes(msg, sps_map=None, active_sps=None) -> bytes:
    if isinstance(msg, RawSEI):
        return msg.data
    if isinstance(msg, FillerPayload):
        return b"\xff" * msg.size
    w = BitWriter()
    if isinstance(msg, BufferingPeriod):
        _write_buffering_period(w, msg, sps_map)
    elif isinstance(msg, PanScanRect):
        _write_pan_scan(w, msg)
    elif isinstance(msg, SceneInfo):
        _write_scene_info(w, msg)
    elif isinstance(msg, FullFrameFreeze):
        if not msg.release:
            w.ue(msg.repetition_period)
        else:
            w.flag(True)  # payload must be non-empty; spec allows any
        
    elif isinstance(msg, PicTiming):
        _write_pic_timing(w, msg, active_sps)
    elif isinstance(msg, UserDataUnregistered):
        return msg.uuid + msg.data
    elif isinstance(msg, RecoveryPoint):
        _write_recovery_point(w, msg)
    elif isinstance(msg, ToneMapping):
        _write_tone_mapping(w, msg)
    else:
        raise TypeError(f"unknown SEI message {msg!r}")
    # byte_alignment(): stop bit + zero pad only when unaligned
    # (spec D.1 sei_payload tail)
    if not w.byte_aligned():
        w.u(1, 1)
        while not w.byte_aligned():
            w.u(0, 1)
    return w.get_bytes()


def write_sei(messages: list, sps_map=None, active_sps=None) -> bytes:
    """Serialize messages into one sei_rbsp() (lencod/src/sei.c writers +
    nal.c rbsp packing)."""
    out = bytearray()
    for msg in messages:
        body = _payload_bytes(msg, sps_map, active_sps)
        pt = msg.payload_type
        while pt >= 255:
            out.append(0xFF)
            pt -= 255
        out.append(pt)
        ps = len(body)
        while ps >= 255:
            out.append(0xFF)
            ps -= 255
        out.append(ps)
        out += body
    out.append(0x80)  # rbsp_trailing_bits
    return bytes(out)
