"""CAVLC residual block encoder (spec §9.2).

Encodes one transform block's coefficients (zig-zag scan order) into a
BitWriter.  Semantics mirror the reference encoder exactly
(lencod/src/macroblock.c writeCoeff4x4_CAVLC:4099, lencod/src/vlc.c
writeSyntaxElement_Level_VLC1/VLCN, TotalZeros, Run) using the normative
code tables in tables.py.
"""

from __future__ import annotations

from ...bitstream.writer import BitWriter
from . import tables as T

_INC_VLC = (0, 3, 6, 12, 24, 48, 32768)


def nc_to_vlcnum(nc: int) -> int:
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


def encode_block(
    w: BitWriter,
    scan_coeffs,
    max_coeff: int,
    nc: int,
    chroma_dc: bool = False,
    yuv: int = 0,
    high_profile: bool = True,
    trace: list | None = None,
) -> int:
    """Encode one block; scan_coeffs: ints in scan order (len = max_coeff).

    `nc` is the predicted total_coeff context (ignored for chroma DC).
    Returns total_coeff of this block (for the caller's nnz bookkeeping)."""
    # build (level, run) pairs in scan order
    levels, runs = [], []
    run = 0
    totzeros = 0
    for c in scan_coeffs:
        if c == 0:
            run += 1
        else:
            levels.append(int(c))
            runs.append(run)
            totzeros += run
            run = 0
    numcoeff = len(levels)
    numtrailingones = 0
    for lv in reversed(levels):
        if abs(lv) == 1 and numtrailingones < 3:
            numtrailingones += 1
        else:
            break

    if trace is not None:
        trace.append(("ct", numcoeff, numtrailingones))
    # --- coeff_token ---
    if chroma_dc:
        lt = T.COEFF_TOKEN_CDC_LEN[yuv]
        ct = T.COEFF_TOKEN_CDC_CODE[yuv]
        w.u(ct[numtrailingones][numcoeff], lt[numtrailingones][numcoeff])
    else:
        vlcnum = nc_to_vlcnum(nc)
        if vlcnum == 3:  # 6-bit FLC
            code = ((numcoeff - 1) << 2) | numtrailingones if numcoeff else 3
            w.u(code, 6)
        else:
            w.u(
                T.COEFF_TOKEN_CODE[vlcnum][numtrailingones][numcoeff],
                T.COEFF_TOKEN_LEN[vlcnum][numtrailingones][numcoeff],
            )
    if numcoeff == 0:
        return 0

    # --- trailing one signs (reverse scan order) ---
    if numtrailingones:
        code = 0
        for lv in levels[-1 : -1 - numtrailingones : -1]:
            code = (code << 1) | (1 if lv < 0 else 0)
        w.u(code, numtrailingones)
        if trace is not None:
            trace.append(("t1sign", code))

    # --- remaining levels (reverse scan order) ---
    level_two_or_higher = 0 if (numcoeff > 3 and numtrailingones == 3) else 1
    vlc = 1 if (numcoeff > 10 and numtrailingones < 3) else 0
    first = True
    for k in range(numcoeff - 1 - numtrailingones, -1, -1):
        lv = levels[k]
        enc_lv = lv
        if level_two_or_higher:
            level_two_or_higher = 0
            enc_lv = lv - 1 if lv > 0 else lv + 1
        if trace is not None:
            trace.append(("lev", enc_lv))
        if vlc == 0:
            _level_vlc1(w, enc_lv, high_profile)
        else:
            _level_vlcn(w, enc_lv, vlc, high_profile)
        if abs(lv) > _INC_VLC[vlc]:
            vlc += 1
        if first and abs(lv) > 3:
            vlc = 2
        first = False

    # --- total zeros ---
    if numcoeff < max_coeff:
        if chroma_dc:
            lt = T.TOTAL_ZEROS_CDC_LEN[yuv]
            ct = T.TOTAL_ZEROS_CDC_CODE[yuv]
        else:
            lt = T.TOTAL_ZEROS_LEN
            ct = T.TOTAL_ZEROS_CODE
        w.u(ct[numcoeff - 1][totzeros], lt[numcoeff - 1][totzeros])
        if trace is not None:
            trace.append(("totzeros", totzeros))

    # --- run_before (reverse scan order) ---
    zerosleft = totzeros
    numcoef = numcoeff
    for k in range(numcoeff - 1, -1, -1):
        if not zerosleft or numcoeff <= 1:
            break
        if numcoef > 1:
            vlcr = min(zerosleft - 1, 6)
            r = runs[k]
            w.u(T.RUN_BEFORE_CODE[vlcr][r], T.RUN_BEFORE_LEN[vlcr][r])
            if trace is not None:
                trace.append(("run", r))
            zerosleft -= r
            numcoef -= 1
    return numcoeff


def _level_vlc1(w: BitWriter, level: int, high_profile: bool):
    levabs = abs(level)
    sign = 1 if level < 0 else 0
    if levabs < 8:
        length = levabs * 2 + sign - 1
        w.u(1, length)  # unary: zeros then stop 1 (inf=1)
    elif levabs < 16:
        w.u((1 << 4) | ((levabs - 8) << 1) | sign, 19)
    else:
        _level_escape2(w, levabs - 16, sign, high_profile, sub_offset=False)


def _level_vlcn(w: BitWriter, level: int, vlc: int, high_profile: bool):
    sign = 1 if level < 0 else 0
    levabs = abs(level) - 1
    shift = vlc - 1
    escape = 15 << shift
    if levabs < escape:
        suffix = levabs & ~(~0 << shift)
        num_prefix = levabs >> shift
        length = num_prefix + vlc + 1
        w.u((1 << (shift + 1)) | (suffix << 1) | sign, length)
    else:
        _level_escape2(w, levabs - escape, sign, high_profile)


def _level_escape2(w: BitWriter, levabsesc: int, sign: int, high_profile: bool,
                   sub_offset: bool = True):
    num_prefix = 15
    length = 28
    if levabsesc > 2048:
        num_prefix += 1
        while levabsesc > (1 << (num_prefix - 3)) - 4096:
            num_prefix += 1
    if num_prefix > 15 and not high_profile:
        raise ValueError("level_prefix > 15 outside High profile")
    addbit = num_prefix - 15
    length += addbit << 1
    # JM quirk: Level_VLC1's escape omits the offset subtraction
    # (lencod/src/vlc.c writeSyntaxElement_Level_VLC1 vs _VLCN)
    val = levabsesc - ((2048 << addbit) - 2048) if sub_offset else levabsesc
    if val < 0:
        # JM's extended-prefix region is inconsistent here; levels this large
        # (>2064) cannot arise from 8-bit residual quantization
        raise ValueError(f"level magnitude out of CAVLC range ({levabsesc})")
    w.u((1 << (12 + addbit)) | (val << 1) | sign, length)
