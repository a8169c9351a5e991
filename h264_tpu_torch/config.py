"""JM-compatible configuration: ``.cfg`` parsing with lencod's command
line semantics, the decoder's run configuration, and profile / level
validation.

Copies of the reference package's config.py: ``parse_cfg_text`` /
``parse_cfg_file`` (``Param = Value`` lines, ``#`` comments, quoted
strings; lencod/src/configfile.c:357 ParseContent), the encoder's
``EncoderRunConfig``, ``encoder_config_from_params`` (JM parameter names
onto the port's ``EncoderConfig``, with the q_matrix.cfg and
ToneMapping.cfg parsers) and ``configure_encoder`` (configfile.c:170
Configure: -d / -f files and -p Param=Value overrides, in order),
``DecoderRunConfig`` and ``parse_decoder_cfg`` (ldecod's fixed positional
decoder.cfg, ldecod/src/ldecod.c:508 init_conf), and ``level_for`` /
``profile_check`` (configfile.c:1289 ProfileCheck, :1481 LevelCheck; level
indices lencod.c:2647 SetLevelIndices)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


def parse_cfg_text(text: str) -> dict[str, str]:
    """Parse JM `Param = Value # comment` lines into a string dict."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            val = val[1:-1]
        if key:
            out[key] = val
    return out


def parse_cfg_file(path: str | Path) -> dict[str, str]:
    return parse_cfg_text(Path(path).read_text(errors="replace"))


def _default_enc():
    from .encoder.encoder import EncoderConfig

    return EncoderConfig(width=176, height=144)


@dataclass
class EncoderRunConfig:
    """A whole encoder run: I/O and codec parameters.  `params` keeps every
    raw JM parameter; the typed fields are the ones the encoder acts on."""

    input_file: str = ""
    output_file: str = "test.264"
    recon_file: str = ""
    frames_to_encode: int = 1
    start_frame: int = 0
    frame_rate: float = 30.0
    frame_skip: int = 0
    out_file_mode: int = 0  # 0 Annex B, 1 RTP packet file
    enc: object = field(default_factory=_default_enc)  # EncoderConfig
    params: dict[str, str] = field(default_factory=dict)


_TRUE = ("1", "2", "3")


def _qmatrix_from_cfg(path: str):
    """q_matrix.cfg parser (lencod/src/q_matrix.c ParseMatrix): named
    matrices in raster order; a leading 0 selects the default matrix;
    later duplicates override.  (ws4 (6, 4, 4), ws8 (2, 8, 8)) int32, or
    None when the file cannot be read."""
    from .syntax.parsets import (_SL_DEFAULTS_4x4, _SL_DEFAULTS_8x8, FLAT_16,
                                 FLAT_64)

    names4 = ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
              "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"]
    names8 = ["INTRA8X8_LUMA", "INTER8X8_LUMA"]
    sl4 = [list(FLAT_16) for _ in range(6)]
    sl8 = [list(FLAT_64) for _ in range(2)]
    try:
        text = open(path).read()
    except OSError:
        return None
    for m in re.finditer(r"(\w+)\s*=\s*((?:[\s,]*\d+)+)", text):
        name = m.group(1)
        vals = [int(x) for x in re.findall(r"\d+", m.group(2))]
        if name in names4 and len(vals) >= 16:
            i = names4.index(name)
            sl4[i] = (list(_SL_DEFAULTS_4x4[i]) if vals[0] == 0
                      else vals[:16])
        elif name in names8 and len(vals) >= 64:
            i = names8.index(name)
            sl8[i] = (list(_SL_DEFAULTS_8x8[i]) if vals[0] == 0
                      else vals[:64])
    return (np.array(sl4, np.int32).reshape(6, 4, 4),
            np.array(sl8, np.int32).reshape(2, 8, 8))


def _tone_mapping_from_cfg(path: str):
    """ToneMapping.cfg parser (lencod/src/sei.c ParseToneMappingConfigFile):
    keyword = value lines, interval and pivot arrays space-separated.  A
    ``syntax.sei.ToneMapping``, or None when the file cannot be read."""
    from .syntax.sei import ToneMapping

    vals: dict[str, str] = {}
    try:
        for line in open(path):
            line = line.split("#")[0].split("##")[0]
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            vals[k.strip()] = v.strip()
    except OSError:
        return None

    def ints(key):
        return [int(x) for x in vals.get(key, "").split()]

    return ToneMapping(
        tone_map_id=int(vals.get("tone_map_id", 0)),
        cancel_flag=vals.get("tone_map_cancel_flag", "0") in _TRUE,
        repetition_period=int(vals.get("tone_map_repetition_period", 1)),
        coded_data_bit_depth=int(vals.get("coded_data_bit_depth", 8)),
        sei_bit_depth=int(vals.get("sei_bit_depth", 8)),
        model_id=int(vals.get("model_id", 0)),
        min_value=int(vals.get("min_value", 0)),
        max_value=int(vals.get("max_value", 255)),
        sigmoid_midpoint=int(vals.get("sigmoid_midpoint", 128)),
        sigmoid_width=int(vals.get("sigmoid_width", 64)),
        start_of_coded_interval=ints("start_of_coded_interval"),
        coded_pivot_value=ints("coded_pivot_value"),
        sei_pivot_value=ints("sei_pivot_value"),
    )


def encoder_config_from_params(params: dict[str, str]) -> EncoderRunConfig:
    """Map JM parameter names onto the port's typed encoder config (the
    reference's config.py:135-190; its defaults: the host path,
    ``fast=False``)."""
    from .encoder.encoder import EncoderConfig

    g = params.get
    width = int(g("SourceWidth", 176))
    height = int(g("SourceHeight", 144))
    qp = int(g("QPISlice", g("QPFirstFrame", 28)))
    qp_p = int(g("QPPSlice", g("QPRemainingFrame", qp)))
    qp_b = int(g("QPBSlice", qp_p + 2))
    nb = int(g("NumberBFrames", 0))
    intra_period = int(g("IntraPeriod", 0))
    # JM IntraPeriod counts P anchors; idr_period counts display frames
    idr_period = intra_period * (nb + 1) if intra_period else 0
    enc = EncoderConfig(
        width=width,
        height=height,
        qp=qp_p,
        search_range=int(g("SearchRange", 16)),
        idr_period=idr_period,
        num_ref_frames=max(1, int(g("NumberReferenceFrames", 1))),
        entropy="cabac" if g("SymbolMode", "0") in _TRUE else "cavlc",
        b_frames=nb,
        qp_b_offset=qp_b - qp_p,
        enable_deblock=g("LoopFilterDisable", "0") == "0",
        rc_bitrate=(float(g("Bitrate", 0))
                    if g("RateControlEnable", "0") in _TRUE else 0.0),
        rc_fps=float(g("FrameRate", 30.0)),
        sei_text=(g("SEIMessageText", "")
                  if g("GenerateSEIMessage", "0") in _TRUE else ""),
        transform8x8=g("Transform8x8Mode", "0") not in ("0",),
        partition_mode=int(g("PartitionMode", 0)),
        scaling_lists=(
            _qmatrix_from_cfg(g("QmatrixFile", "q_matrix.cfg"))
            if g("ScalingMatrixPresentFlag", "0") in _TRUE else None),
        sei_tone_mapping=(
            _tone_mapping_from_cfg(g("ToneMappingFile", "ToneMapping.cfg"))
            if g("ToneMappingSEIPresentFlag", "0") in _TRUE else None),
    )
    return EncoderRunConfig(
        input_file=g("InputFile", ""),
        output_file=g("OutputFile", "test.264"),
        recon_file=g("ReconFile", ""),
        frames_to_encode=int(g("FramesToBeEncoded", 1)),
        start_frame=int(g("StartFrame", 0)),
        frame_rate=float(g("FrameRate", 30.0)),
        frame_skip=int(g("FrameSkip", 0)),
        out_file_mode=int(g("OutFileMode", 0)),
        enc=enc,
        params=dict(params),
    )


def configure_encoder(argv: list[str]) -> EncoderRunConfig:
    """JM Configure() semantics (configfile.c:170): -d default file, -f
    additional files, -p Param=Value overrides (the value may be split
    over several arguments), a bare ``*.cfg`` argument, applied in order."""
    params: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-d", "-f"):
            params.update(parse_cfg_file(argv[i + 1]))
            i += 2
        elif a == "-p":
            frag = argv[i + 1]
            j = i + 2
            while "=" not in frag or frag.endswith("="):
                frag += argv[j]
                j += 1
            params.update(parse_cfg_text(frag))
            i = j
        elif a.endswith(".cfg") and "=" not in a:
            params.update(parse_cfg_file(a))
            i += 1
        else:
            raise SystemExit(f"unknown encoder argument: {a}")
    return encoder_config_from_params(params)


@dataclass
class DecoderRunConfig:
    """ldecod positional config (bin/decoder.cfg, ldecod.c:508)."""

    input_file: str = "test.264"
    output_file: str = "test_dec.yuv"
    ref_file: str = ""
    write_uv: bool = True
    nal_mode: int = 0  # 0 Annex B, 1 RTP
    ref_offset: int = 0
    poc_scale: int = 2
    concealment_mode: int = 0
    ref_poc_gap: int = 2
    poc_gap: int = 2
    silent: bool = False


def parse_decoder_cfg(path: str | Path) -> DecoderRunConfig:
    tokens = []
    for raw in Path(path).read_text(errors="replace").splitlines():
        t = raw.split()[0] if raw.split() else ""
        if t:
            tokens.append(t)
    d = DecoderRunConfig()
    fields_pos = [
        ("input_file", str), ("output_file", str), ("ref_file", str),
        ("write_uv", lambda v: bool(int(v))), ("nal_mode", int),
        ("ref_offset", int), ("poc_scale", int), ("_rate", int),
        ("_b", int), ("_f", int), ("_lb", str),
        ("concealment_mode", int), ("ref_poc_gap", int), ("poc_gap", int),
        ("silent", lambda v: bool(int(v))),
    ]
    for (name, conv), tok in zip(fields_pos, tokens):
        if name.startswith("_"):
            continue
        try:
            setattr(d, name, conv(tok))
        except ValueError:
            break  # free-text trailer reached
    return d


# level_idc -> (MaxMBPS, MaxFS, MaxDpbMbs)  (spec Table A-1, normative)
LEVEL_LIMITS = {
    10: (1485, 99, 396), 11: (3000, 396, 900), 12: (6000, 396, 2376),
    13: (11880, 396, 2376), 20: (11880, 396, 2376),
    21: (19800, 792, 4752), 22: (20250, 1620, 8100),
    30: (40500, 1620, 8100), 31: (108000, 3600, 18000),
    32: (216000, 5120, 20480), 40: (245760, 8192, 32768),
    41: (245760, 8192, 32768), 42: (522240, 8704, 34816),
    50: (589824, 22080, 110400), 51: (983040, 36864, 184320),
}


def level_for(width: int, height: int, fps: float,
              num_ref_frames: int) -> int:
    """Smallest level_idc whose Table A-1 limits admit the stream
    (frame size, MB rate, DPB size) — the SetLevelIndices analog."""
    fs = (width // 16) * (height // 16)
    mbps = fs * fps
    for lvl in sorted(LEVEL_LIMITS):
        max_mbps, max_fs, max_dpb = LEVEL_LIMITS[lvl]
        if (fs <= max_fs and mbps <= max_mbps
                and fs * max(1, num_ref_frames) <= max_dpb):
            return lvl
    raise ValueError(
        f"stream exceeds level 5.1 limits: {width}x{height}@{fps} "
        f"with {num_ref_frames} reference frames")


def profile_check(enc) -> None:
    """Feature/profile consistency (ProfileCheck analog): raises on
    combinations no profile admits."""
    if enc.entropy == "cabac" and enc.partition_mode == 1:
        raise ValueError("data partitioning (Extended) excludes CABAC")
    if enc.num_slice_groups > 1 and (enc.transform8x8
                                     or enc.scaling_lists is not None):
        raise ValueError("FMO (Baseline/Extended) excludes FRExt tools")
    if enc.partition_mode == 1 and (enc.transform8x8
                                    or enc.scaling_lists is not None):
        raise ValueError("data partitioning excludes FRExt tools")
