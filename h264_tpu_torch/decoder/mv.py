"""Motion-vector derivation: PMV, P_Skip, B spatial/temporal direct.

Pure function of the parse state + reference lists — runs as a raster
pass after entropy parse, before (and independent of) pixel work.
Mirrors the reference semantics: SetMotionVectorPredictor
(ldecod/src/macroblock.c), skip MV (macroblock.c read_one_macroblock
P_Skip path), spatial direct (macroblock.c decode_one_macroblock direct
branches + mbuffer.c compute_colocated moving_block).
"""

from __future__ import annotations

import numpy as np

from ..syntax.slice_header import SliceType
from . import mbtables as M
from .state import PictureParseState

_B8_PARTS = {
    M.B8_8x8: (2, 2),
    M.B8_8x4: (2, 1),
    M.B8_4x8: (1, 2),
    M.B8_4x4: (1, 1),
}


def _neighbor_info(st: PictureParseState, addr: int, lst: int, xp: int, yp: int):
    """(avail, ref, mv) of the 4x4 block containing relative pixel (xp,yp)."""
    avail, nb, bx, by, px, py = st.luma4x4_neighbor(addr, xp, yp)
    if not avail:
        return False, -1, (0, 0)
    ref = int(st.ref_idx[lst, py, px])
    mv = (int(st.mv[lst, py, px, 0]), int(st.mv[lst, py, px, 1]))
    return True, ref, mv


def pmv(st: PictureParseState, addr: int, lst: int, ref: int,
        bx: int, by: int, w4: int, h4: int):
    """Median MV predictor (spec §8.4.1.3); (bx,by,w4,h4) in 4x4 units."""
    xp = bx << 2
    yp = by << 2
    wpix = w4 << 2
    avail_a, ref_a, mv_a = _neighbor_info(st, addr, lst, xp - 1, yp)
    avail_b, ref_b, mv_b = _neighbor_info(st, addr, lst, xp, yp - 1)
    avail_c, ref_c, mv_c = _neighbor_info(st, addr, lst, xp + wpix, yp - 1)
    # decode-order masking of C inside the MB (JM SetMotionVectorPredictor)
    if yp > 0:
        if xp < 8:
            if (yp == 8 and wpix == 16) or (yp != 8 and xp + wpix == 8):
                avail_c = False
        elif xp + wpix == 16:
            avail_c = False
    if not avail_c:
        avail_c, ref_c, mv_c = _neighbor_info(st, addr, lst, xp - 1, yp - 1)

    # directional overrides for 16x8 / 8x16 partitions
    if w4 == 4 and h4 == 2:  # 16x8
        if by == 0 and avail_b and ref_b == ref:
            return mv_b
        if by == 2 and avail_a and ref_a == ref:
            return mv_a
    elif w4 == 2 and h4 == 4:  # 8x16
        if bx == 0 and avail_a and ref_a == ref:
            return mv_a
        if bx == 2 and avail_c and ref_c == ref:
            return mv_c

    match_a = avail_a and ref_a == ref
    match_b = avail_b and ref_b == ref
    match_c = avail_c and ref_c == ref
    n_match = match_a + match_b + match_c
    if n_match == 1:
        return mv_a if match_a else (mv_b if match_b else mv_c)
    if not avail_b and not avail_c and avail_a:
        return mv_a
    ax, ay = mv_a if avail_a else (0, 0)
    bx_, by_ = mv_b if avail_b else (0, 0)
    cx, cy = mv_c if avail_c else (0, 0)
    med = lambda a, b, c: a + b + c - min(a, b, c) - max(a, b, c)
    return (med(ax, bx_, cx), med(ay, by_, cy))


def _set_block(st, lst, x4, y4, bx, by, w4, h4, ref, mv, ref_pic_id):
    st.ref_idx[lst, y4 + by : y4 + by + h4, x4 + bx : x4 + bx + w4] = ref
    st.mv[lst, y4 + by : y4 + by + h4, x4 + bx : x4 + bx + w4] = mv
    st.ref_pic_id[lst, y4 + by : y4 + by + h4, x4 + bx : x4 + bx + w4] = ref_pic_id


def derive_mvs(st: PictureParseState, slice_of_mb, slice_info):
    """Fill st.mv / st.ref_pic_id for every MB.

    slice_of_mb: st.slice_id array; slice_info: list per slice id with
    keys: 'type' (SliceType), 'ref_ids' ([list0_ids, list1_ids] — unique
    picture ids, POC-based, indexed by ref_idx), 'col' (colocated info for
    B: dict with 'moving', 'ref0_mv', ... or None), 'spatial_direct': bool.
    """
    for addr in range(st.n_mbs):
        sid = int(st.slice_id[addr])
        if sid < 0:
            continue
        info = slice_info[sid]
        stype = info["type"]
        mbt = int(st.mb_type[addr])
        if st.is_intra[addr]:
            continue
        x4, y4 = st.mb_block_origin(addr)
        ref_ids = info["ref_ids"]
        if stype == SliceType.B:
            direct = (
                _spatial_direct if info.get("spatial_direct", True)
                else _temporal_direct
            )
            if mbt == 0:  # B skip / direct 16x16
                direct(st, addr, info)
                continue
            _derive_inter_mb(st, addr, info, bframe=True)
        else:
            if mbt == M.PSKIP and st.skip_flag[addr]:
                mv = _pskip_mv(st, addr)
                _set_block(st, 0, x4, y4, 0, 0, 4, 4, 0, mv, ref_ids[0][0])
                continue
            _derive_inter_mb(st, addr, info, bframe=False)


def _derive_inter_mb(st, addr, info, bframe):
    mbt = int(st.mb_type[addr])
    x4, y4 = st.mb_block_origin(addr)
    ref_ids = info["ref_ids"]
    if mbt == M.P16x16:
        parts = [(0, 0, 4, 4, 0)]
    elif mbt == M.P16x8:
        parts = [(0, 0, 4, 2, 0), (0, 2, 4, 2, 2)]
    elif mbt == M.P8x16:
        parts = [(0, 0, 2, 4, 0), (2, 0, 2, 4, 1)]
    else:  # P8x8
        parts = [((b8 & 1) * 2, (b8 >> 1) * 2, 2, 2, b8) for b8 in range(4)]

    for lst in (0, 1):
        if lst == 1 and not bframe:
            break
        for (bx, by, w4, h4, b8) in parts:
            b8mode = int(st.b8mode[addr][b8])
            pdir = int(st.b8pdir[addr][b8])
            if b8mode == M.IBLOCK:
                continue
            if mbt == M.P8x8 and b8mode == M.B8_DIRECT:
                if lst == 0:  # derive once
                    if info.get("spatial_direct", True):
                        _spatial_direct_b8(st, addr, info, b8)
                    else:
                        _temporal_direct(st, addr, info, b8=b8)
                continue
            if pdir != lst and pdir != M.PD_BI:
                continue
            ref = int(st.ref_idx[lst, y4 + by, x4 + bx])
            rid = ref_ids[lst][ref]
            if mbt == M.P8x8:
                sw, sh = _B8_PARTS[b8mode]
                subs = [
                    (bx + dx, by + dy)
                    for dy in range(0, 2, sh)
                    for dx in range(0, 2, sw)
                ]
                for (sx, sy) in subs:
                    p = pmv(st, addr, lst, ref, sx, sy, sw, sh)
                    mvd = st.mvd[lst, y4 + sy, x4 + sx]
                    mv = (p[0] + int(mvd[0]), p[1] + int(mvd[1]))
                    _set_block(st, lst, x4, y4, sx, sy, sw, sh, ref, mv, rid)
            else:
                p = pmv(st, addr, lst, ref, bx, by, w4, h4)
                mvd = st.mvd[lst, y4 + by, x4 + bx]
                mv = (p[0] + int(mvd[0]), p[1] + int(mvd[1]))
                _set_block(st, lst, x4, y4, bx, by, w4, h4, ref, mv, rid)


def _pskip_mv(st, addr):
    """P_Skip MV (spec §8.4.1.1)."""
    a_avail, ref_a, mv_a = _neighbor_info(st, addr, 0, -1, 0)
    b_avail, ref_b, mv_b = _neighbor_info(st, addr, 0, 0, -1)
    if (
        not a_avail
        or not b_avail
        or (ref_a == 0 and mv_a == (0, 0))
        or (ref_b == 0 and mv_b == (0, 0))
    ):
        return (0, 0)
    return pmv(st, addr, 0, 0, 0, 0, 4, 4)


def _spatial_ref_sel(st, addr, lst):
    """min-positive reference over A/B/C neighbors (spec §8.4.1.2.2)."""
    a_avail, ref_a, _ = _neighbor_info(st, addr, lst, -1, 0)
    b_avail, ref_b, _ = _neighbor_info(st, addr, lst, 0, -1)
    c_avail, ref_c, _ = _neighbor_info(st, addr, lst, 16, -1)
    if not c_avail:
        c_avail, ref_c, _ = _neighbor_info(st, addr, lst, -1, -1)
    refs = [r for r, av in ((ref_a, a_avail), (ref_b, b_avail), (ref_c, c_avail)) if av and r >= 0]
    return min(refs) if refs else -1


def _direct_mv_pred(st, addr, info):
    """(ref_l0, mv_l0, ref_l1, mv_l1) 16x16 spatial-direct predictors."""
    l0 = _spatial_ref_sel(st, addr, 0)
    l1 = _spatial_ref_sel(st, addr, 1)
    if l0 < 0 and l1 < 0:
        return 0, (0, 0), 0, (0, 0), True
    mv0 = pmv(st, addr, 0, l0, 0, 0, 4, 4) if l0 >= 0 else (0, 0)
    mv1 = pmv(st, addr, 1, l1, 0, 0, 4, 4) if l1 >= 0 else (0, 0)
    return l0, mv0, l1, mv1, False


def _spatial_direct(st, addr, info):
    l0, mv0, l1, mv1, both_zero = _direct_mv_pred(st, addr, info)
    x4, y4 = st.mb_block_origin(addr)
    ref_ids = info["ref_ids"]
    col = info["col"]
    inference = info.get("direct_8x8_inference", True)
    for by in range(4):
        for bx in range(4):
            if inference:
                cx = (bx & 2) + ((bx & 2) >> 1)  # 0,0,3,3
                cy = (by & 2) + ((by & 2) >> 1)
            else:
                cx, cy = bx, by
            moving = (
                bool(col["moving"][y4 + cy, x4 + cx]) if col is not None else True
            )
            if both_zero:
                r0, m0 = 0, (0, 0)
                r1, m1 = 0, (0, 0)
            else:
                if l0 >= 0:
                    m0 = (0, 0) if (l0 == 0 and not moving) else mv0
                    r0 = l0
                else:
                    r0, m0 = -1, (0, 0)
                if l1 >= 0:
                    m1 = (0, 0) if (l1 == 0 and not moving) else mv1
                    r1 = l1
                else:
                    r1, m1 = -1, (0, 0)
            _set_block(
                st, 0, x4, y4, bx, by, 1, 1, r0, m0,
                ref_ids[0][r0] if r0 >= 0 else -(10 ** 9),
            )
            _set_block(
                st, 1, x4, y4, bx, by, 1, 1, r1, m1,
                ref_ids[1][r1] if r1 >= 0 else -(10 ** 9),
            )


def _spatial_direct_b8(st, addr, info, b8):
    """Spatial direct for one 8x8 of a B_8x8 MB (same predictors)."""
    l0, mv0, l1, mv1, both_zero = _direct_mv_pred(st, addr, info)
    x4, y4 = st.mb_block_origin(addr)
    ref_ids = info["ref_ids"]
    col = info["col"]
    inference = info.get("direct_8x8_inference", True)
    bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
    for by in range(by0, by0 + 2):
        for bx in range(bx0, bx0 + 2):
            if inference:
                cx = (bx & 2) + ((bx & 2) >> 1)
                cy = (by & 2) + ((by & 2) >> 1)
            else:
                cx, cy = bx, by
            moving = (
                bool(col["moving"][y4 + cy, x4 + cx]) if col is not None else True
            )
            if both_zero:
                r0, m0, r1, m1 = 0, (0, 0), 0, (0, 0)
            else:
                if l0 >= 0:
                    m0 = (0, 0) if (l0 == 0 and not moving) else mv0
                    r0 = l0
                else:
                    r0, m0 = -1, (0, 0)
                if l1 >= 0:
                    m1 = (0, 0) if (l1 == 0 and not moving) else mv1
                    r1 = l1
                else:
                    r1, m1 = -1, (0, 0)
            _set_block(
                st, 0, x4, y4, bx, by, 1, 1, r0, m0,
                ref_ids[0][r0] if r0 >= 0 else -(10 ** 9),
            )
            _set_block(
                st, 1, x4, y4, bx, by, 1, 1, r1, m1,
                ref_ids[1][r1] if r1 >= 0 else -(10 ** 9),
            )


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def dist_scale_factor(cur_poc: int, poc0: int, poc1: int) -> int:
    """DistScaleFactor per spec §8.4.1.2.3 (8-202..8-203); used by both
    temporal direct and implicit weighted prediction."""
    tb = _clip3(-128, 127, cur_poc - poc0)
    td = _clip3(-128, 127, poc1 - poc0)
    tx = _cdiv(16384 + abs(_cdiv(td, 2)), td)
    return _clip3(-1024, 1023, (tb * tx + 32) >> 6)


def _temporal_direct(st, addr, info, b8=None):
    """Temporal direct MV derivation (spec §8.4.1.2.3; reference
    lencod/src/mv-search.c:1462 Get_Direct_Motion_Vectors temporal branch,
    ldecod/src/macroblock.c decode_one_macroblock direct path).

    The colocated block lives in RefPicList1[0]; its L0 motion (falling
    back to L1) is scaled by the POC-distance ratio. refIdxL0 maps the
    colocated reference into the *current* list0 by unique picture id."""
    col = info["col"]
    x4, y4 = st.mb_block_origin(addr)
    ref_ids = info["ref_ids"]
    cur_poc = info["cur_poc"]
    poc1 = col["poc"]  # POC of RefPicList1[0] (the colocated picture)
    inference = info.get("direct_8x8_inference", True)
    if b8 is None:
        rng = [(bx, by) for by in range(4) for bx in range(4)]
    else:
        bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
        rng = [(bx0 + dx, by0 + dy) for dy in range(2) for dx in range(2)]
    for bx, by in rng:
        if inference:
            cx = (bx & 2) + ((bx & 2) >> 1)
            cy = (by & 2) + ((by & 2) >> 1)
        else:
            cx, cy = bx, by
        ry, rx = y4 + cy, x4 + cx
        # colocated motion: L0, fall back to L1
        if int(col["ref_idx0"][ry, rx]) >= 0:
            ref_id = int(col["ref_id0"][ry, rx])
            mv_col = (int(col["mv0"][ry, rx, 0]), int(col["mv0"][ry, rx, 1]))
            col_intra = False
        elif int(col["ref_idx1"][ry, rx]) >= 0:
            ref_id = int(col["ref_id1"][ry, rx])
            mv_col = (int(col["mv1"][ry, rx, 0]), int(col["mv1"][ry, rx, 1]))
            col_intra = False
        else:
            col_intra = True
        if col_intra:
            ref_l0, mv_l0, mv_l1 = 0, (0, 0), (0, 0)
        else:
            try:
                mapped = ref_ids[0].index(ref_id)
            except ValueError:
                raise ValueError(
                    f"temporal direct: colocated ref id {ref_id} not in "
                    f"current list0 {ref_ids[0]}"
                )
            ref_l0 = mapped
            poc0 = ref_id  # unique_id IS the POC
            lt = bool(info.get("ref_lt", [[False] * 64] * 2)[0][mapped])
            if lt or poc1 == poc0:
                mv_l0, mv_l1 = mv_col, (0, 0)
            else:
                dsf = dist_scale_factor(cur_poc, poc0, poc1)
                mv_l0 = (
                    (dsf * mv_col[0] + 128) >> 8,
                    (dsf * mv_col[1] + 128) >> 8,
                )
                mv_l1 = (mv_l0[0] - mv_col[0], mv_l0[1] - mv_col[1])
        _set_block(st, 0, x4, y4, bx, by, 1, 1, ref_l0, mv_l0,
                   ref_ids[0][ref_l0])
        _set_block(st, 1, x4, y4, bx, by, 1, 1, 0, mv_l1, ref_ids[1][0])


def compute_moving_mask(col_state: PictureParseState, col_is_long_term=False):
    """moving_block array of the colocated picture (JM compute_colocated,
    ldecod/src/mbuffer.c): NOT moving iff (refL0==0 and |mv|<=1 both
    comps) or (refL0<0 and refL1==0 and |mvL1|<=1)."""
    ref0 = col_state.ref_idx[0]
    ref1 = col_state.ref_idx[1]
    mv0 = col_state.mv[0]
    mv1 = col_state.mv[1]
    still0 = (
        (ref0 == 0)
        & (np.abs(mv0[..., 0]) >> 1 == 0)
        & (np.abs(mv0[..., 1]) >> 1 == 0)
    )
    if col_is_long_term:
        still0 = np.zeros_like(still0)
    still1 = (
        (ref0 < 0)
        & (ref1 == 0)
        & (np.abs(mv1[..., 0]) >> 1 == 0)
        & (np.abs(mv1[..., 1]) >> 1 == 0)
    )
    return ~(still0 | still1)
