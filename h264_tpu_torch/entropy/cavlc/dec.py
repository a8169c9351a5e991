"""CAVLC residual block decoder (spec §9.2) — inverse of enc.py.

Mirrors the reference reader (ldecod/src/vlc.c readSyntaxElement_
NumCoeffTrailingOnes:..., readCoeff4x4_CAVLC ldecod/src/macroblock.c:2227).
Prefix decoding is table-driven from the same normative tables.
"""

from __future__ import annotations

from ...bitstream.reader import BitReader
from . import tables as T

_INC_VLC = (0, 3, 6, 12, 24, 48, 32768)


def _build_prefix_map(len_tab, code_tab, values):
    """dict: (length, code) -> value for one VLC table row."""
    m = {}
    for v in values:
        ln = len_tab[v]
        if ln:
            m[(ln, code_tab[v])] = v
    return m


class _VlcTable:
    def __init__(self, len_tab, code_tab):
        self.map = {}
        self.max_len = 0
        for v in range(len(len_tab)):
            ln = int(len_tab[v])
            if ln:
                self.map[(ln, int(code_tab[v]))] = v
                self.max_len = max(self.max_len, ln)

    def read(self, r: BitReader) -> int:
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | r.u(1)
            hit = self.map.get((ln, code))
            if hit is not None:
                return hit
        raise ValueError("invalid VLC code")


class _PairTable:
    """coeff_token: value = (total_coeff, t1s)."""

    def __init__(self, len_tab, code_tab):
        self.map = {}
        self.max_len = 0
        for t1 in range(len(len_tab)):
            for nc in range(len(len_tab[t1])):
                ln = int(len_tab[t1][nc])
                if ln:
                    key = (ln, int(code_tab[t1][nc]))
                    if key not in self.map:
                        self.map[key] = (nc, t1)
                    self.max_len = max(self.max_len, ln)

    def read(self, r: BitReader):
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | r.u(1)
            hit = self.map.get((ln, code))
            if hit is not None:
                return hit
        raise ValueError("invalid coeff_token")


_COEFF_TOKEN = [_PairTable(T.COEFF_TOKEN_LEN[v], T.COEFF_TOKEN_CODE[v]) for v in range(3)]
_COEFF_TOKEN_CDC = [
    _PairTable(T.COEFF_TOKEN_CDC_LEN[y], T.COEFF_TOKEN_CDC_CODE[y]) for y in range(3)
]
_TOTAL_ZEROS = [
    _VlcTable(T.TOTAL_ZEROS_LEN[v], T.TOTAL_ZEROS_CODE[v]) for v in range(15)
]
_TOTAL_ZEROS_CDC = [
    [_VlcTable(T.TOTAL_ZEROS_CDC_LEN[y][v], T.TOTAL_ZEROS_CDC_CODE[y][v])
     for v in range(len(T.TOTAL_ZEROS_CDC_LEN[y]))]
    for y in range(3)
]
_RUN_BEFORE = [_VlcTable(T.RUN_BEFORE_LEN[v], T.RUN_BEFORE_CODE[v]) for v in range(7)]



def nc_to_vlcnum(nc: int) -> int:
    """coeff_token table index for a predicted nC (the reference
    package's entropy/cavlc/enc.py:18; the CAVLC writer is not ported)."""
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


def decode_block(
    r: BitReader, max_coeff: int, nc: int, chroma_dc: bool = False, yuv: int = 0
):
    """Decode one block; returns (scan_coeffs list, total_coeff)."""
    if chroma_dc:
        numcoeff, t1s = _COEFF_TOKEN_CDC[yuv].read(r)
    else:
        vlcnum = nc_to_vlcnum(nc)
        if vlcnum == 3:
            code = r.u(6)
            if code == 3:
                numcoeff, t1s = 0, 0
            else:
                numcoeff = (code >> 2) + 1
                t1s = code & 3
        else:
            numcoeff, t1s = _COEFF_TOKEN[vlcnum].read(r)
    coeffs = [0] * max_coeff
    if numcoeff == 0:
        return coeffs, 0
    levels = [0] * numcoeff
    # trailing one signs
    for i in range(t1s):
        sign = r.u(1)
        levels[numcoeff - 1 - i] = -1 if sign else 1
    # levels
    level_two_or_higher = 0 if (numcoeff > 3 and t1s == 3) else 1
    vlc = 1 if (numcoeff > 10 and t1s < 3) else 0
    first = True
    for k in range(numcoeff - 1 - t1s, -1, -1):
        lv = _read_level(r, vlc)
        if level_two_or_higher:
            level_two_or_higher = 0
            lv = lv + 1 if lv > 0 else lv - 1
        levels[k] = lv
        if abs(lv) > _INC_VLC[vlc]:
            vlc += 1
        if first and abs(lv) > 3:
            vlc = 2
        first = False
    # total zeros
    totzeros = 0
    if numcoeff < max_coeff:
        if chroma_dc:
            totzeros = _TOTAL_ZEROS_CDC[yuv][numcoeff - 1].read(r)
        else:
            totzeros = _TOTAL_ZEROS[numcoeff - 1].read(r)
    # runs
    runs = [0] * numcoeff
    zerosleft = totzeros
    numcoef = numcoeff
    for k in range(numcoeff - 1, -1, -1):
        if not zerosleft or numcoeff <= 1:
            break
        if numcoef > 1:
            vlcr = min(zerosleft - 1, 6)
            run = _RUN_BEFORE[vlcr].read(r)
            runs[k] = run
            zerosleft -= run
            numcoef -= 1
    runs[0] += zerosleft  # remaining zeros precede the first coefficient
    # place into scan positions
    pos = -1
    for k in range(numcoeff):
        pos += runs[k] + 1
        coeffs[pos] = levels[k]
    return coeffs, numcoeff


def _read_level(r: BitReader, vlc: int) -> int:
    """Inverse of Level_VLC1 / Level_VLCN."""
    zeros = 0
    while r.u(1) == 0:
        zeros += 1
        if zeros > 64:
            raise ValueError("bad level prefix")
    num_prefix = zeros
    if vlc == 0:
        if num_prefix < 14:
            levabs = (num_prefix >> 1) + 1
            sign = num_prefix & 1
            return -levabs if sign else levabs
        if num_prefix == 14:
            # 19-bit: prefix 14 zeros + '1' + 4 bits
            rest = r.u(4)
            levabs = 8 + (rest >> 1)
            sign = rest & 1
            return -levabs if sign else levabs
        # escape: prefix >= 15 (VLC1 escape omits the offset, JM quirk)
        return _read_escape2(r, num_prefix, base=16, add_offset=False)
    shift = vlc - 1
    if num_prefix < 15:
        suffix = r.u(shift) if shift else 0
        levabs = (num_prefix << shift) + suffix + 1
        sign = r.u(1)
        return -levabs if sign else levabs
    return _read_escape2(r, num_prefix, base=(15 << shift) + 1)


def _read_escape2(r: BitReader, num_prefix: int, base: int, add_offset=True) -> int:
    addbit = num_prefix - 15
    offset = ((2048 << addbit) - 2048) if add_offset else 0
    rest = r.u(12 + addbit)
    levabsesc = (rest >> 1) + offset
    sign = rest & 1
    levabs = levabsesc + base
    return -levabs if sign else levabs
