"""The JM ``.cfg`` parser and the decoder's run configuration, and
profile / level validation.

Copies of the reference package's config.py: ``parse_cfg_text`` /
``parse_cfg_file`` (``Param = Value`` lines, ``#`` comments, quoted
strings), ``DecoderRunConfig`` and ``parse_decoder_cfg`` (ldecod's fixed
positional decoder.cfg, ldecod/src/ldecod.c:508 init_conf), and
``level_for`` / ``profile_check`` (lencod/src/configfile.c:1289
ProfileCheck, :1481 LevelCheck; level indices lencod.c:2647
SetLevelIndices).  The encoder half of the parser (``configure_encoder``)
is not ported yet (ROADMAP Queue 1, "Config and CLIs")."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


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
