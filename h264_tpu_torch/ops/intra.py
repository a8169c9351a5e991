"""Intra prediction kernels (spec §8.3): 4x4 (9 modes), 8x8 (9 modes with
reference filtering), 16x16 (4 modes), chroma (4 modes).

Each function takes the prediction reference samples explicitly and
returns the predicted block — pure functions usable by the sequential
decoder oracle and by the batched encoder mode-search (where they are
vmapped over blocks).  Integer arithmetic matches the reference decoder
(ldecod/src/block.c intrapred:137 / intrapred_luma_16x16:450,
ldecod/src/transform8x8.c intrapred8x8:224).

Reference-sample convention (4x4):  up A..D, up-right E..H, left I..L,
up-left X, each already substituted per availability (unavailable up/left
-> dc_pred_value; unavailable up-right -> replicate D).
"""

from __future__ import annotations

import numpy as np

# 4x4 / 8x8 luma mode numbers (spec Table 8-2 / 8-3)
VERT_PRED = 0
HOR_PRED = 1
DC_PRED = 2
DIAG_DOWN_LEFT_PRED = 3
DIAG_DOWN_RIGHT_PRED = 4
VERT_RIGHT_PRED = 5
HOR_DOWN_PRED = 6
VERT_LEFT_PRED = 7
HOR_UP_PRED = 8

# 16x16 modes
VERT_PRED_16 = 0
HOR_PRED_16 = 1
DC_PRED_16 = 2
PLANE_16 = 3

# chroma modes
DC_PRED_8 = 0
HOR_PRED_8 = 1
VERT_PRED_8 = 2
PLANE_8 = 3


def pred4x4(mode, up, upright, left, upleft, avail_up, avail_left, avail_upleft,
            avail_upright, dc_value=128):
    """Predict one 4x4 block. `up`,`upright`,`left`: length-4 int arrays
    (raw neighbor pixels; substitution handled here), `upleft` scalar."""
    A, B, C, D = (up if avail_up else [dc_value] * 4)
    if avail_upright:
        E, F, G, H = upright
    else:
        E = F = G = H = D
    I, J, K, L = (left if avail_left else [dc_value] * 4)
    X = upleft if avail_upleft else dc_value
    p = np.empty((4, 4), np.int32)
    if mode == DC_PRED:
        if avail_up and avail_left:
            s = (A + B + C + D + I + J + K + L + 4) >> 3
        elif avail_left:
            s = (I + J + K + L + 2) >> 2
        elif avail_up:
            s = (A + B + C + D + 2) >> 2
        else:
            s = dc_value
        p[:] = s
    elif mode == VERT_PRED:
        if not avail_up:
            raise ValueError("vertical pred without up neighbor")
        p[:] = [A, B, C, D]
    elif mode == HOR_PRED:
        if not avail_left:
            raise ValueError("horizontal pred without left neighbor")
        p[0], p[1], p[2], p[3] = I, J, K, L
    elif mode == DIAG_DOWN_LEFT_PRED:
        p[0, 0] = (A + C + 2 * B + 2) >> 2
        p[0, 1] = p[1, 0] = (B + D + 2 * C + 2) >> 2
        p[0, 2] = p[1, 1] = p[2, 0] = (C + E + 2 * D + 2) >> 2
        p[0, 3] = p[1, 2] = p[2, 1] = p[3, 0] = (D + F + 2 * E + 2) >> 2
        p[1, 3] = p[2, 2] = p[3, 1] = (E + G + 2 * F + 2) >> 2
        p[2, 3] = p[3, 2] = (F + H + 2 * G + 2) >> 2
        p[3, 3] = (G + 3 * H + 2) >> 2
    elif mode == DIAG_DOWN_RIGHT_PRED:
        p[3, 0] = (L + 2 * K + J + 2) >> 2
        p[2, 0] = p[3, 1] = (K + 2 * J + I + 2) >> 2
        p[1, 0] = p[2, 1] = p[3, 2] = (J + 2 * I + X + 2) >> 2
        p[0, 0] = p[1, 1] = p[2, 2] = p[3, 3] = (I + 2 * X + A + 2) >> 2
        p[0, 1] = p[1, 2] = p[2, 3] = (X + 2 * A + B + 2) >> 2
        p[0, 2] = p[1, 3] = (A + 2 * B + C + 2) >> 2
        p[0, 3] = (B + 2 * C + D + 2) >> 2
    elif mode == VERT_RIGHT_PRED:
        p[0, 0] = p[2, 1] = (X + A + 1) >> 1
        p[0, 1] = p[2, 2] = (A + B + 1) >> 1
        p[0, 2] = p[2, 3] = (B + C + 1) >> 1
        p[0, 3] = (C + D + 1) >> 1
        p[1, 0] = p[3, 1] = (I + 2 * X + A + 2) >> 2
        p[1, 1] = p[3, 2] = (X + 2 * A + B + 2) >> 2
        p[1, 2] = p[3, 3] = (A + 2 * B + C + 2) >> 2
        p[1, 3] = (B + 2 * C + D + 2) >> 2
        p[2, 0] = (X + 2 * I + J + 2) >> 2
        p[3, 0] = (I + 2 * J + K + 2) >> 2
    elif mode == VERT_LEFT_PRED:
        p[0, 0] = (A + B + 1) >> 1
        p[0, 1] = p[2, 0] = (B + C + 1) >> 1
        p[0, 2] = p[2, 1] = (C + D + 1) >> 1
        p[0, 3] = p[2, 2] = (D + E + 1) >> 1
        p[2, 3] = (E + F + 1) >> 1
        p[1, 0] = (A + 2 * B + C + 2) >> 2
        p[1, 1] = p[3, 0] = (B + 2 * C + D + 2) >> 2
        p[1, 2] = p[3, 1] = (C + 2 * D + E + 2) >> 2
        p[1, 3] = p[3, 2] = (D + 2 * E + F + 2) >> 2
        p[3, 3] = (E + 2 * F + G + 2) >> 2
    elif mode == HOR_UP_PRED:
        p[0, 0] = (I + J + 1) >> 1
        p[0, 1] = (I + 2 * J + K + 2) >> 2
        p[0, 2] = p[1, 0] = (J + K + 1) >> 1
        p[0, 3] = p[1, 1] = (J + 2 * K + L + 2) >> 2
        p[1, 2] = p[2, 0] = (K + L + 1) >> 1
        p[1, 3] = p[2, 1] = (K + 3 * L + 2) >> 2
        p[2, 2] = p[2, 3] = p[3, 0] = p[3, 1] = p[3, 2] = p[3, 3] = L
    elif mode == HOR_DOWN_PRED:
        p[0, 0] = p[1, 2] = (X + I + 1) >> 1
        p[0, 1] = p[1, 3] = (I + 2 * X + A + 2) >> 2
        p[0, 2] = (X + 2 * A + B + 2) >> 2
        p[0, 3] = (A + 2 * B + C + 2) >> 2
        p[1, 0] = p[2, 2] = (I + J + 1) >> 1
        p[1, 1] = p[2, 3] = (X + 2 * I + J + 2) >> 2
        p[2, 0] = p[3, 2] = (J + K + 1) >> 1
        p[2, 1] = p[3, 3] = (I + 2 * J + K + 2) >> 2
        p[3, 0] = (K + L + 1) >> 1
        p[3, 1] = (J + 2 * K + L + 2) >> 2
    else:
        raise ValueError(f"bad intra 4x4 mode {mode}")
    return p


def filter_ref_8x8(up, upright, left, upleft, avail_up, avail_left,
                   avail_upleft, avail_upright, dc_value=128):
    """Intra 8x8 reference-sample low-pass filtering (spec §8.3.2.2.1;
    JM LowPassForIntra8x8Pred, ldecod/src/transform8x8.c).

    Inputs: up[8], upright[8], left[8], upleft scalar (raw pixels).
    Returns (up16, left8, upleft) filtered arrays with substitutions.
    up16 = filtered p[0..15,-1]."""
    P = np.empty(17, np.int64)  # P[0]=upleft, P[1..16]=up row
    L = np.empty(9, np.int64)  # L[0]=upleft, L[1..8]=left col
    if avail_up:
        P[1:9] = up
    else:
        P[1:9] = dc_value
    if avail_upright:
        P[9:17] = upright
    else:
        P[9:17] = P[8]
    if avail_upleft:
        P[0] = upleft
    else:
        P[0] = dc_value
    if avail_left:
        L[1:9] = left
    else:
        L[1:9] = dc_value
    L[0] = P[0]

    Pf = P.copy()
    Lf = L.copy()
    if avail_up:
        if avail_upleft:
            Pf[1] = (P[0] + 2 * P[1] + P[2] + 2) >> 2
        else:
            Pf[1] = (3 * P[1] + P[2] + 2) >> 2
        for i in range(2, 16):
            Pf[i] = (P[i - 1] + 2 * P[i] + P[i + 1] + 2) >> 2
        Pf[16] = (P[15] + 3 * P[16] + 2) >> 2
    if avail_upleft:
        if avail_up and avail_left:
            Pf[0] = (P[1] + 2 * P[0] + L[1] + 2) >> 2
        elif avail_up:
            Pf[0] = (3 * P[0] + P[1] + 2) >> 2
        elif avail_left:
            Pf[0] = (3 * P[0] + L[1] + 2) >> 2
        Lf[0] = Pf[0]
    if avail_left:
        if avail_upleft:
            Lf[1] = (L[0] + 2 * L[1] + L[2] + 2) >> 2
        else:
            Lf[1] = (3 * L[1] + L[2] + 2) >> 2
        for i in range(2, 8):
            Lf[i] = (L[i - 1] + 2 * L[i] + L[i + 1] + 2) >> 2
        Lf[8] = (L[7] + 3 * L[8] + 2) >> 2
    return Pf, Lf


def pred8x8(mode, Pf, Lf, avail_up, avail_left, avail_upleft, dc_value=128):
    """Predict an 8x8 block from filtered samples (Pf[0..16], Lf[0..8])."""
    up = Pf[1:17]  # p[x,-1], x=0..15
    left = Lf[1:9]
    X = Pf[0]
    p = np.empty((8, 8), np.int64)
    if mode == DC_PRED:
        if avail_up and avail_left:
            s = (up[:8].sum() + left.sum() + 8) >> 4
        elif avail_left:
            s = (left.sum() + 4) >> 3
        elif avail_up:
            s = (up[:8].sum() + 4) >> 3
        else:
            s = dc_value
        p[:] = s
    elif mode == VERT_PRED:
        p[:] = up[:8]
    elif mode == HOR_PRED:
        for y in range(8):
            p[y] = left[y]
    elif mode == DIAG_DOWN_LEFT_PRED:
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (up[14] + 3 * up[15] + 2) >> 2
                else:
                    k = x + y
                    p[y, x] = (up[k] + 2 * up[k + 1] + up[k + 2] + 2) >> 2
    elif mode == DIAG_DOWN_RIGHT_PRED:
        for y in range(8):
            for x in range(8):
                if x > y:
                    k = x - y
                    a = up[k - 2] if k >= 2 else X
                    b = up[k - 1] if k >= 1 else X
                    p[y, x] = (a + 2 * b + up[k] + 2) >> 2
                elif x < y:
                    k = y - x
                    a = left[k - 2] if k >= 2 else X
                    b = left[k - 1] if k >= 1 else X
                    p[y, x] = (a + 2 * b + left[k] + 2) >> 2
                else:
                    p[y, x] = (up[0] + 2 * X + left[0] + 2) >> 2
    elif mode == VERT_RIGHT_PRED:
        uq = np.concatenate([[X], up])  # uq[i] = p[i-1,-1]
        lq = np.concatenate([[X], left])
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    k = x - (y >> 1)
                    p[y, x] = (uq[k] + uq[k + 1] + 1) >> 1
                elif z >= 0:
                    k = x - (y >> 1)
                    p[y, x] = (uq[k - 1] + 2 * uq[k] + uq[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (left[0] + 2 * X + up[0] + 2) >> 2
                else:
                    n = y - 2 * x  # zVR < -1: index along the left column
                    p[y, x] = (lq[n] + 2 * lq[n - 1] + lq[n - 2] + 2) >> 2
    elif mode == HOR_DOWN_PRED:
        uq = np.concatenate([[X], up])
        lq = np.concatenate([[X], left])
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    k = y - (x >> 1)
                    p[y, x] = (lq[k] + lq[k + 1] + 1) >> 1
                elif z >= 0:
                    k = y - (x >> 1)
                    p[y, x] = (lq[k - 1] + 2 * lq[k] + lq[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (up[0] + 2 * X + left[0] + 2) >> 2
                else:
                    n = x - 2 * y  # zHD < -1: index along the top row
                    p[y, x] = (uq[n] + 2 * uq[n - 1] + uq[n - 2] + 2) >> 2
    elif mode == VERT_LEFT_PRED:
        for y in range(8):
            for x in range(8):
                k = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (up[k] + up[k + 1] + 1) >> 1
                else:
                    p[y, x] = (up[k] + 2 * up[k + 1] + up[k + 2] + 2) >> 2
    elif mode == HOR_UP_PRED:
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z > 13:
                    p[y, x] = left[7]
                elif z == 13:
                    p[y, x] = (left[6] + 3 * left[7] + 2) >> 2
                elif z % 2 == 0:
                    k = y + (x >> 1)
                    p[y, x] = (left[k] + left[k + 1] + 1) >> 1
                else:
                    k = y + (x >> 1)
                    p[y, x] = (left[k] + 2 * left[k + 1] + left[k + 2] + 2) >> 2
    else:
        raise ValueError(f"bad intra 8x8 mode {mode}")
    return p.astype(np.int32)


def pred16x16(mode, up, left, upleft, avail_up, avail_left, avail_upleft,
              dc_value=128, bitdepth=8):
    """Predict the 16x16 luma block (spec §8.3.3)."""
    p = np.empty((16, 16), np.int64)
    up = np.asarray(up, np.int64)
    left = np.asarray(left, np.int64)
    if mode == VERT_PRED_16:
        p[:] = up
    elif mode == HOR_PRED_16:
        p[:] = left[:, None]
    elif mode == DC_PRED_16:
        if avail_up and avail_left:
            s = (up.sum() + left.sum() + 16) >> 5
        elif avail_left:
            s = (left.sum() + 8) >> 4
        elif avail_up:
            s = (up.sum() + 8) >> 4
        else:
            s = dc_value
        p[:] = s
    elif mode == PLANE_16:
        H = sum(
            (i + 1) * (int(up[8 + i]) - (int(up[6 - i]) if 6 - i >= 0 else int(upleft)))
            for i in range(8)
        )
        V = sum(
            (j + 1)
            * (int(left[8 + j]) - (int(left[6 - j]) if 6 - j >= 0 else int(upleft)))
            for j in range(8)
        )
        a = 16 * (int(left[15]) + int(up[15]))
        b = (5 * H + 32) >> 6
        c = (5 * V + 32) >> 6
        maxv = (1 << bitdepth) - 1
        for y in range(16):
            for x in range(16):
                v = (a + b * (x - 7) + c * (y - 7) + 16) >> 5
                p[y, x] = min(maxv, max(0, v))
    else:
        raise ValueError(f"bad intra 16x16 mode {mode}")
    return p.astype(np.int32)


def pred_chroma(mode, up, left, upleft, avail_up, avail_left, cw, ch,
                dc_value=128, bitdepth=8):
    """Predict one chroma block (cw x ch; 8x8 for 4:2:0), spec §8.3.4.

    DC mode operates per 4x4 sub-block with position-dependent neighbor
    selection (JM intrapred_chroma / spec §8.3.4.1)."""
    p = np.empty((ch, cw), np.int64)
    up = np.asarray(up, np.int64)
    left = np.asarray(left, np.int64)
    if mode == DC_PRED_8:
        # per-4x4 position classes (JM block_pos, ldecod/src/block.c):
        # top-left/bottom-right average both edges; top-right prefers up;
        # bottom-left prefers left
        for by in range(0, ch, 4):
            for bx in range(0, cw, 4):
                u = up[bx : bx + 4]
                l = left[by : by + 4]
                corner = (bx == 0, by == 0)
                s = dc_value
                if corner == (True, True) or corner == (False, False):
                    if avail_up and avail_left:
                        s = (u.sum() + l.sum() + 4) >> 3
                    elif avail_up:
                        s = (u.sum() + 2) >> 2
                    elif avail_left:
                        s = (l.sum() + 2) >> 2
                elif corner == (False, True):  # top right
                    if avail_up:
                        s = (u.sum() + 2) >> 2
                    elif avail_left:
                        s = (l.sum() + 2) >> 2
                else:  # bottom left
                    if avail_left:
                        s = (l.sum() + 2) >> 2
                    elif avail_up:
                        s = (u.sum() + 2) >> 2
                p[by : by + 4, bx : bx + 4] = s
    elif mode == HOR_PRED_8:
        p[:] = left[:ch, None]
    elif mode == VERT_PRED_8:
        p[:] = up[:cw]
    elif mode == PLANE_8:
        xCF = 4 * (cw == 16)  # 0 for 4:2:0/4:2:2 widths of 8
        yCF = 4 * (ch == 16)
        # H = sum_{x=0}^{3+xCF} (x+1)*(p[4+xCF+x,-1] - p[2+xCF-x,-1])
        H = 0
        for x in range(4 + xCF):
            a = int(up[4 + xCF + x])
            bidx = 2 + xCF - x
            b = int(up[bidx]) if bidx >= 0 else int(upleft)
            H += (x + 1) * (a - b)
        V = 0
        for y in range(4 + yCF):
            a = int(left[4 + yCF + y])
            bidx = 2 + yCF - y
            b = int(left[bidx]) if bidx >= 0 else int(upleft)
            V += (y + 1) * (a - b)
        a0 = 16 * (int(left[ch - 1]) + int(up[cw - 1]))
        b0 = (34 * (1 if cw == 8 else 0) + 29 * (1 if cw == 16 else 0)) * H
        b0 = (b0 + 32) >> 6
        c0 = (34 * (1 if ch == 8 else 0) + 29 * (1 if ch == 16 else 0)) * V
        c0 = (c0 + 32) >> 6
        maxv = (1 << bitdepth) - 1
        for y in range(ch):
            for x in range(cw):
                v = (a0 + b0 * (x - 3 - xCF) + c0 * (y - 3 - yCF) + 16) >> 5
                p[y, x] = min(maxv, max(0, v))
    else:
        raise ValueError(f"bad chroma mode {mode}")
    return p.astype(np.int32)
