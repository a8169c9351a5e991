"""Vectorized decode-state fills for the device RD pipelines.

The RD pipelines return whole-frame tensors (winner modes, per-8x8
motion, levels); the host must derive the exact parse-level state the
entropy writers consume: PMV/MVD (spec §8.4.1.3), P_Skip detection
(§8.4.1.1) and temporal-direct motion (§8.4.1.2.3).  The reference does
all of this MB-serially inside its coding loop
(lencod/src/mv-search.c:87 SetMotionVectorPredictor,
macroblock.c:1189 FindSkipModeMotionVector, mv-search.c:1462
Get_Direct_Motion_Vectors); here every derivation is a whole-frame
numpy pass — legal because the predictor reads only *final* neighbor
motion, which the device pipeline has already committed for every MB.

All routines operate on PictureParseState arrays without per-MB Python
loops.  A copy of the reference package's encoder/fills.py.
"""

from __future__ import annotations

import numpy as np

from ..decoder import mbtables as M

_NONE_ID = -(10 ** 9)


# ---------------------------------------------------------------------------
# neighbor gathers (static geometry -> whole-frame source arrays)
# ---------------------------------------------------------------------------

def _gather_nb(st, lst, dmy: int, dmx: int, by: int, bx: int):
    """For every MB: (avail, ref, mvx, mvy) of block (by,bx) inside the MB
    at (mb_y+dmy, mb_x+dmx).  Availability = in picture + same slice
    (JM mb_is_available, ldecod/src/mb_access.c)."""
    H, W = st.H, st.W
    my, mx = np.mgrid[0:H, 0:W]
    ny, nx = my + dmy, mx + dmx
    inb = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
    nyc, nxc = np.clip(ny, 0, H - 1), np.clip(nx, 0, W - 1)
    sid = st.slice_id.reshape(H, W)
    avail = inb & (sid[nyc, nxc] == sid)
    y4 = nyc * 4 + by
    x4 = nxc * 4 + bx
    ref = np.where(avail, st.ref_idx[lst, y4, x4].astype(np.int32), -1)
    mvx = np.where(avail, st.mv[lst, y4, x4, 0], 0)
    mvy = np.where(avail, st.mv[lst, y4, x4, 1], 0)
    return avail.ravel(), ref.ravel(), mvx.ravel(), mvy.ravel()


def _nb_a(st, lst, bx: int, by: int):
    if bx > 0:
        return _gather_nb(st, lst, 0, 0, by, bx - 1)
    return _gather_nb(st, lst, 0, -1, by, 3)


def _nb_b(st, lst, bx: int, by: int):
    if by > 0:
        return _gather_nb(st, lst, 0, 0, by - 1, bx)
    return _gather_nb(st, lst, -1, 0, 3, bx)


def _nb_c(st, lst, bx: int, by: int, w4: int):
    """C neighbor incl. the decode-order mask; returns None if statically
    unavailable (caller substitutes D)."""
    xc = bx + w4
    if by > 0:
        # decode-order masking (JM SetMotionVectorPredictor):
        xp, yp, wpix = 4 * bx, 4 * by, 4 * w4
        if xp < 8:
            if (yp == 8 and wpix == 16) or (yp != 8 and xp + wpix == 8):
                return None
        elif xp + wpix == 16:
            return None
        if xc >= 4:
            return None
        return _gather_nb(st, lst, 0, 0, by - 1, xc)
    if xc < 4:
        return _gather_nb(st, lst, -1, 0, 3, xc)
    return _gather_nb(st, lst, -1, 1, 3, 0)


def _nb_d(st, lst, bx: int, by: int):
    if bx > 0 and by > 0:
        return _gather_nb(st, lst, 0, 0, by - 1, bx - 1)
    if bx == 0 and by > 0:
        return _gather_nb(st, lst, 0, -1, by - 1, 3)
    if bx > 0:
        return _gather_nb(st, lst, -1, 0, 3, bx - 1)
    return _gather_nb(st, lst, -1, -1, 3, 3)


def _med3(a, b, c):
    return a + b + c - np.minimum(a, np.minimum(b, c)) \
        - np.maximum(a, np.maximum(b, c))


def pmv_grid(st, lst: int, ref_q, bx: int, by: int, w4: int, h4: int):
    """Median MV predictor for the fixed partition geometry
    (bx,by,w4,h4), for every MB at once.  ref_q: (n_mbs,) queried
    ref_idx.  Exact whole-frame dual of decoder/mv.py:pmv."""
    av_a, ref_a, ax, ay = _nb_a(st, lst, bx, by)
    av_b, ref_b, bx_, by_ = _nb_b(st, lst, bx, by)
    c = _nb_c(st, lst, bx, by, w4)
    if c is None:
        av_c, ref_c, cx, cy = _nb_d(st, lst, bx, by)
    else:
        av_c, ref_c, cx, cy = c
        d = _nb_d(st, lst, bx, by)
        av_c = np.where(av_c, av_c, d[0])
        ref_c = np.where(c[0], ref_c, d[1])
        cx = np.where(c[0], cx, d[2])
        cy = np.where(c[0], cy, d[3])

    m_a = av_a & (ref_a == ref_q)
    m_b = av_b & (ref_b == ref_q)
    m_c = av_c & (ref_c == ref_q)
    n_match = m_a.astype(np.int32) + m_b + m_c

    medx = _med3(np.where(av_a, ax, 0), np.where(av_b, bx_, 0),
                 np.where(av_c, cx, 0))
    medy = _med3(np.where(av_a, ay, 0), np.where(av_b, by_, 0),
                 np.where(av_c, cy, 0))
    only = n_match == 1
    ox = np.where(m_a, ax, np.where(m_b, bx_, cx))
    oy = np.where(m_a, ay, np.where(m_b, by_, cy))
    a_only = (~av_b) & (~av_c) & av_a
    px = np.where(only, ox, np.where(a_only, ax, medx))
    py = np.where(only, oy, np.where(a_only, ay, medy))

    # directional overrides for 16x8 / 8x16
    if w4 == 4 and h4 == 2:
        if by == 0:
            px, py = np.where(m_b, bx_, px), np.where(m_b, by_, py)
        else:
            px, py = np.where(m_a, ax, px), np.where(m_a, ay, py)
    elif w4 == 2 and h4 == 4:
        if bx == 0:
            px, py = np.where(m_a, ax, px), np.where(m_a, ay, py)
        else:
            px, py = np.where(m_c, cx, px), np.where(m_c, cy, py)
    return px, py


def pskip_grid(st):
    """P_Skip candidate MV for every MB (spec §8.4.1.1): zero if A/B
    unavailable or zero-motion-ref0, else PMV(ref0, 16x16)."""
    av_a, ref_a, ax, ay = _nb_a(st, 0, 0, 0)
    av_b, ref_b, bx_, by_ = _nb_b(st, 0, 0, 0)
    zero_a = av_a & (ref_a == 0) & (ax == 0) & (ay == 0)
    zero_b = av_b & (ref_b == 0) & (bx_ == 0) & (by_ == 0)
    force0 = (~av_a) | (~av_b) | zero_a | zero_b
    px, py = pmv_grid(st, 0, np.zeros(st.n_mbs, np.int32), 0, 0, 4, 4)
    return np.where(force0, 0, px), np.where(force0, 0, py)


# ---------------------------------------------------------------------------
# P-frame fill tail: MVD + skip for the RD winner layout
# ---------------------------------------------------------------------------

_PART_GEOM = {
    1: [(0, 0, 4, 4)],                      # 16x16 (1 part)
    2: [(0, 0, 4, 2), (0, 2, 4, 2)],        # 16x8
    3: [(0, 0, 2, 4), (2, 0, 2, 4)],        # 8x16
    4: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)],  # 8x8
}


def fill_p_mvd_skip(st, win, C):
    """Vectorized MVD + P_Skip detection for the P RD winner array.

    win: per-MB winner code (C.C_P16x16 etc.); the motion/ref state in
    `st` is final.  Mirrors the per-MB scalar derivation formerly in
    encoder._fill_p_state_rd."""
    n_mb = st.n_mbs
    H, W = st.H, st.W
    y0 = (np.arange(n_mb) // W) * 4
    x0 = (np.arange(n_mb) % W) * 4

    # skip detection (16x16 / SKIP winners with cbp 0 and ref 0)
    is16 = (win == C.C_P16x16) | (win == C.C_SKIP) | (win == C.C_P16PMV)
    cand = is16 & (st.cbp == 0) & (st.ref_idx[0, y0, x0] == 0)
    if cand.any():
        sx, sy = pskip_grid(st)
        hit = cand & (st.mv[0, y0, x0, 0] == sx) & (st.mv[0, y0, x0, 1] == sy)
        st.skip_flag[hit] = 1
        st.mb_type[np.where(hit)[0]] = M.PSKIP
        st.b8mode[np.where(hit)[0]] = 0
    else:
        hit = np.zeros(n_mb, bool)

    geom_of = {
        C.C_P16x16: 1, C.C_SKIP: 1, C.C_P16PMV: 1, C.C_P16x8: 2,
        C.C_P8x16: 3,
    }
    for code, gk in geom_of.items():
        mask = (win == code) & ~hit & ~st.is_intra.astype(bool)
        if not mask.any():
            continue
        idx = np.where(mask)[0]
        for (bx, by, w4, h4) in _PART_GEOM[gk]:
            ref_q = st.ref_idx[0, y0 + by, x0 + bx].astype(np.int32)
            px, py = pmv_grid(st, 0, ref_q, bx, by, w4, h4)
            dx = st.mv[0, y0 + by, x0 + bx, 0] - px
            dy = st.mv[0, y0 + by, x0 + bx, 1] - py
            for j in range(h4):
                for i in range(w4):
                    st.mvd[0, y0[idx] + by + j, x0[idx] + bx + i, 0] = dx[idx]
                    st.mvd[0, y0[idx] + by + j, x0[idx] + bx + i, 1] = dy[idx]
    # P8x8: per-unit sub-partition geometry from b8mode
    p88 = (win == C.C_P8x8) & ~hit & ~st.is_intra.astype(bool)
    if p88.any():
        _SUB_GEOM = {
            M.B8_8x8: [(0, 0, 2, 2)],
            M.B8_8x4: [(0, 0, 2, 1), (0, 1, 2, 1)],
            M.B8_4x8: [(0, 0, 1, 2), (1, 0, 1, 2)],
            M.B8_4x4: [(0, 0, 1, 1), (1, 0, 1, 1),
                       (0, 1, 1, 1), (1, 1, 1, 1)],
        }
        for b8 in range(4):
            bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
            for sm, subs in _SUB_GEOM.items():
                mask = p88 & (st.b8mode[:, b8] == sm)
                if not mask.any():
                    continue
                idx = np.where(mask)[0]
                for (sx, sy, w4, h4) in subs:
                    bx, by = bx0 + sx, by0 + sy
                    ref_q = st.ref_idx[0, y0 + by, x0 + bx].astype(np.int32)
                    px, py = pmv_grid(st, 0, ref_q, bx, by, w4, h4)
                    dx = st.mv[0, y0 + by, x0 + bx, 0] - px
                    dy = st.mv[0, y0 + by, x0 + bx, 1] - py
                    for j in range(h4):
                        for i in range(w4):
                            st.mvd[0, y0[idx] + by + j,
                                   x0[idx] + bx + i, 0] = dx[idx]
                            st.mvd[0, y0[idx] + by + j,
                                   x0[idx] + bx + i, 1] = dy[idx]


def fill_b_half_mvd(st, h168, h816, pdir8):
    """MVD for B 16x8 / 8x16 winners: per half, per list where the
    half's pdir uses that list (spec §8.4.1.3 geometry overrides are in
    pmv_grid)."""
    n_mb = st.n_mbs
    W = st.W
    y0 = (np.arange(n_mb) // W) * 4
    x0 = (np.arange(n_mb) % W) * 4
    for mask_mb, geoms, hunit in (
        (h168, [(0, 0, 4, 2), (0, 2, 4, 2)], (0, 2)),
        (h816, [(0, 0, 2, 4), (2, 0, 2, 4)], (0, 1)),
    ):
        if not mask_mb.any():
            continue
        for h, (bx, by, w4, h4) in enumerate(geoms):
            pd = pdir8[:, hunit[h]]
            for lst in (0, 1):
                use = mask_mb & ((pd == lst) | (pd == 2))
                if not use.any():
                    continue
                ref_q = st.ref_idx[lst, y0 + by, x0 + bx].astype(np.int32)
                px, py = pmv_grid(st, lst, ref_q, bx, by, w4, h4)
                dx = st.mv[lst, y0 + by, x0 + bx, 0] - px
                dy = st.mv[lst, y0 + by, x0 + bx, 1] - py
                idx = np.where(use)[0]
                for j in range(h4):
                    for i in range(w4):
                        st.mvd[lst, y0[idx] + by + j,
                               x0[idx] + bx + i, 0] = dx[idx]
                        st.mvd[lst, y0[idx] + by + j,
                               x0[idx] + bx + i, 1] = dy[idx]


def fill_b_p8_mvd(st, p8, pdir8):
    """MVD for explicit 8x8 units of B P8x8 MBs (per-unit pdir; direct
    units carry no mvd)."""
    n_mb = st.n_mbs
    W = st.W
    y0 = (np.arange(n_mb) // W) * 4
    x0 = (np.arange(n_mb) % W) * 4
    if not p8.any():
        return
    for b8 in range(4):
        bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
        pd = pdir8[:, b8]
        for lst in (0, 1):
            use = p8 & (pd != 3) & ((pd == lst) | (pd == 2))
            if not use.any():
                continue
            ref_q = st.ref_idx[lst, y0 + by, x0 + bx].astype(np.int32)
            px, py = pmv_grid(st, lst, ref_q, bx, by, 2, 2)
            dx = st.mv[lst, y0 + by, x0 + bx, 0] - px
            dy = st.mv[lst, y0 + by, x0 + bx, 1] - py
            idx = np.where(use)[0]
            for j in range(2):
                for i in range(2):
                    st.mvd[lst, y0[idx] + by + j, x0[idx] + bx + i, 0] = \
                        dx[idx]
                    st.mvd[lst, y0[idx] + by + j, x0[idx] + bx + i, 1] = \
                        dy[idx]


def fill_b_explicit_mvd(st, use0, use1):
    """Vectorized 16x16 MVD for explicit B MBs (L0/L1/BI)."""
    n_mb = st.n_mbs
    W = st.W
    y0 = (np.arange(n_mb) // W) * 4
    x0 = (np.arange(n_mb) % W) * 4
    for lst, use in ((0, use0), (1, use1)):
        if not use.any():
            continue
        ref_q = st.ref_idx[lst, y0, x0].astype(np.int32)
        px, py = pmv_grid(st, lst, ref_q, 0, 0, 4, 4)
        dx = st.mv[lst, y0, x0, 0] - px
        dy = st.mv[lst, y0, x0, 1] - py
        idx = np.where(use)[0]
        for j in range(4):
            for i in range(4):
                st.mvd[lst, y0[idx] + j, x0[idx] + i, 0] = dx[idx]
                st.mvd[lst, y0[idx] + j, x0[idx] + i, 1] = dy[idx]


# ---------------------------------------------------------------------------
# temporal direct (whole-frame)
# ---------------------------------------------------------------------------

def _cdiv_arr(a, b):
    """C-style truncating division, elementwise."""
    q = np.abs(a) // np.abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def dist_scale_factors(cur_poc: int, pocs0, poc1: int):
    """DistScaleFactor per list0 entry (spec 8-202..8-203)."""
    pocs0 = np.asarray(pocs0, np.int64)
    tb = np.clip(cur_poc - pocs0, -128, 127)
    td = np.clip(poc1 - pocs0, -128, 127)
    td = np.where(td == 0, 1, td)  # guarded by caller (poc0 == poc1 case)
    tx = _cdiv_arr(16384 + np.abs(_cdiv_arr(td, 2)), td)
    return np.clip((tb * tx + 32) >> 6, -1024, 1023)


def fill_temporal_direct(st, direct_mask, col, cur_poc: int, pocs0,
                         poc1: int, ref_lt0=None, inference: bool = True,
                         unit_mask=None):
    """Whole-frame temporal-direct derivation for all `direct_mask` MBs
    (spec §8.4.1.2.3; dual of decoder/mv.py:_temporal_direct).

    col: dict with ref_idx0/ref_idx1/ref_id0/ref_id1/mv0/mv1 arrays of
    the colocated picture (RefPicList1[0]); pocs0: current list0 POCs.
    unit_mask (n_mb, 4): restrict the write-back to these 8x8 units
    (per-unit direct inside B P8x8 MBs)."""
    if not direct_mask.any():
        return
    n_mb = st.n_mbs
    W = st.W
    idx = np.where(direct_mask)[0]
    y0 = (idx // W) * 4
    x0 = (idx % W) * 4
    # 4x4 offsets + 8x8-inference colocated source offsets
    bxy = np.arange(4)
    bx = np.tile(bxy, 4)          # (16,) x offsets
    by = np.repeat(bxy, 4)
    if inference:
        cx = (bx & 2) + ((bx & 2) >> 1)
        cy = (by & 2) + ((by & 2) >> 1)
    else:
        cx, cy = bx, by
    ry = y0[:, None] + cy[None, :]   # (n_d, 16)
    rx = x0[:, None] + cx[None, :]

    c_r0 = col["ref_idx0"][ry, rx].astype(np.int32)
    c_r1 = col["ref_idx1"][ry, rx].astype(np.int32)
    use0 = c_r0 >= 0
    use1 = (~use0) & (c_r1 >= 0)
    col_intra = ~(use0 | use1)
    ref_id = np.where(use0, col["ref_id0"][ry, rx],
                      np.where(use1, col["ref_id1"][ry, rx], _NONE_ID))
    mcx = np.where(use0, col["mv0"][ry, rx, 0],
                   np.where(use1, col["mv1"][ry, rx, 0], 0))
    mcy = np.where(use0, col["mv0"][ry, rx, 1],
                   np.where(use1, col["mv1"][ry, rx, 1], 0))

    pocs0 = list(pocs0)
    nr = len(pocs0)
    mapped = np.full(ref_id.shape, -1, np.int32)
    for k, p0 in enumerate(pocs0):
        mapped = np.where((ref_id == p0) & (mapped < 0), k, mapped)
    bad = (~col_intra) & (mapped < 0)
    if bad.any():
        raise ValueError("temporal direct: colocated ref id not in list0")
    mapped = np.where(col_intra, 0, mapped)

    dsf_tab = dist_scale_factors(cur_poc, pocs0, poc1)
    lt = np.asarray(
        [bool(ref_lt0[k]) if ref_lt0 is not None else False
         for k in range(nr)]
    )
    same = np.asarray([p0 == poc1 for p0 in pocs0])
    passthru = (lt | same)[mapped]
    dsf = dsf_tab[mapped]
    sx = (dsf * mcx + 128) >> 8
    sy = (dsf * mcy + 128) >> 8
    m0x = np.where(col_intra, 0, np.where(passthru, mcx, sx))
    m0y = np.where(col_intra, 0, np.where(passthru, mcy, sy))
    m1x = np.where(col_intra, 0, np.where(passthru, 0, m0x - mcx))
    m1y = np.where(col_intra, 0, np.where(passthru, 0, m0y - mcy))
    ref_l0 = np.where(col_intra, 0, mapped)
    poc_arr = np.asarray(pocs0, np.int64)

    ty = y0[:, None] + by[None, :]
    tx = x0[:, None] + bx[None, :]
    if unit_mask is not None:
        # block (bx, by) belongs to unit (by>>1)*2 + (bx>>1)
        bu = ((by >> 1) * 2 + (bx >> 1))[None, :]  # (1, 16)
        keep = np.take_along_axis(
            unit_mask[idx], np.broadcast_to(bu, (len(idx), 16)), axis=1)
        ty = ty[keep]
        tx = tx[keep]
        m0x, m0y = m0x[keep], m0y[keep]
        m1x, m1y = m1x[keep], m1y[keep]
        ref_l0 = ref_l0[keep]
    st.mv[0, ty, tx, 0] = m0x
    st.mv[0, ty, tx, 1] = m0y
    st.mv[1, ty, tx, 0] = m1x
    st.mv[1, ty, tx, 1] = m1y
    st.ref_idx[0, ty, tx] = ref_l0.astype(np.int8)
    st.ref_idx[1, ty, tx] = 0
    st.ref_pic_id[0, ty, tx] = poc_arr[ref_l0]
    st.ref_pic_id[1, ty, tx] = poc1
