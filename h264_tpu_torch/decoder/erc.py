"""Error concealment (non-normative), JM behavior class.

Reference: ldecod/src/erc_do_i.c:43 ercConcealIntraFrame (spatial
weighted-pixel interpolation), erc_do_p.c:84 ercConcealInterFrame /
concealByTrial:336 (candidate-MV trial with boundary matching),
erc_do_p.c:1260 conceal_lost_frames (whole-frame copy / motion copy).

Concealment runs after deblocking in picture finish (the JM exit_picture
order) on macroblocks whose slices were never received (slice_id < 0),
and at the sequence level when frame_num gaps reveal whole lost frames.
"""

from __future__ import annotations

import numpy as np

from ..ops import interp as MC


def missing_mbs(state) -> np.ndarray:
    """Addresses of MBs no received slice covered."""
    return np.nonzero(np.asarray(state.slice_id) < 0)[0]


# ---------------------------------------------------------------------------
# intra concealment: weighted pixel interpolation (erc_do_i.c:91)
# ---------------------------------------------------------------------------

def _conceal_mb_intra(planes, mx, my, avail, cw, ch):
    """Fill one 16x16 MB (+chroma) from the boundary pixels of available
    4-neighbors; per-pixel weights are inverse boundary distances."""
    Y = planes.Y
    dist = {}
    srcs = {}
    xs = np.arange(16)
    ys = np.arange(16)
    if avail[0]:  # left
        srcs["l"] = Y[my : my + 16, mx - 1][:, None]
        dist["l"] = (xs + 1)[None, :]
    if avail[1]:  # right
        srcs["r"] = Y[my : my + 16, mx + 16][:, None]
        dist["r"] = (16 - xs)[None, :]
    if avail[2]:  # up
        srcs["u"] = Y[my - 1, mx : mx + 16][None, :]
        dist["u"] = (ys + 1)[:, None]
    if avail[3]:  # down
        srcs["d"] = Y[my + 16, mx : mx + 16][None, :]
        dist["d"] = (16 - ys)[:, None]
    num = np.zeros((16, 16), np.float64)
    den = np.zeros((16, 16), np.float64)
    for k in srcs:
        w = 1.0 / dist[k].astype(np.float64)
        num += srcs[k].astype(np.float64) * w
        den += w + 0 * num  # broadcast
    Y[my : my + 16, mx : mx + 16] = np.clip(
        np.rint(num / np.maximum(den, 1e-9)), 0, 255
    ).astype(Y.dtype)
    # chroma: same scheme at half resolution
    for P in (planes.U, planes.V):
        cx, cy = (mx // 16) * cw, (my // 16) * ch
        numc = np.zeros((ch, cw), np.float64)
        denc = np.zeros((ch, cw), np.float64)
        xc = np.arange(cw)
        yc = np.arange(ch)
        if avail[0]:
            numc += P[cy : cy + ch, cx - 1][:, None] / (xc + 1)[None, :]
            denc += 1.0 / (xc + 1)[None, :]
        if avail[1]:
            numc += P[cy : cy + ch, cx + cw][:, None] / (cw - xc)[None, :]
            denc += 1.0 / (cw - xc)[None, :]
        if avail[2]:
            numc += P[cy - 1, cx : cx + cw][None, :] / (yc + 1)[:, None]
            denc += 1.0 / (yc + 1)[:, None]
        if avail[3]:
            numc += P[cy + ch, cx : cx + cw][None, :] / (ch - yc)[:, None]
            denc += 1.0 / (ch - yc)[:, None]
        if denc.any():
            P[cy : cy + ch, cx : cx + cw] = np.clip(
                np.rint(numc / np.maximum(denc, 1e-9)), 0, 255
            ).astype(P.dtype)


# ---------------------------------------------------------------------------
# inter concealment: candidate-MV trial with boundary matching
# (erc_do_p.c concealByTrial)
# ---------------------------------------------------------------------------

def _mc_block(ref_padded, px, py, mv, w, h, width, height):
    xi = px + (mv[0] >> 2)
    yi = py + (mv[1] >> 2)
    dx, dy = mv[0] & 3, mv[1] & 3
    xi = max(-(MC.PAD - 8), min(width + MC.PAD - w - 8, xi))
    yi = max(-(MC.PAD - 8), min(height + MC.PAD - h - 8, yi))
    return MC.luma_block(ref_padded, MC.PAD, xi, yi, dx, dy, w, h)


def _conceal_mb_inter(state, planes, ref_pic, addr, avail, sps):
    """Trial over candidate MVs (zero + available neighbor MVs); pick the
    one minimizing the boundary mismatch against received neighbors."""
    W = state.W
    mx, my = (addr % W) * 16, (addr // W) * 16
    x4, y4 = state.mb_block_origin(addr)
    Ypad, Upad, Vpad = ref_pic.padded_planes()
    width, height = sps.width, sps.height
    cands = [(0, 0)]
    mvf = np.asarray(state.mv[0])
    for av, (nx4, ny4) in zip(
        avail, ((x4 - 1, y4), (x4 + 4, y4), (x4, y4 - 1), (x4, y4 + 4))
    ):
        if av and 0 <= nx4 < 4 * W and 0 <= ny4 < mvf.shape[0]:
            cands.append((int(mvf[ny4, nx4, 0]), int(mvf[ny4, nx4, 1])))
    best = None
    Y = planes.Y
    for mv in cands:
        blk = _mc_block(Ypad, mx, my, mv, 16, 16, width, height)
        cost = 0
        if avail[0]:
            cost += int(np.abs(blk[:, 0] - Y[my : my + 16, mx - 1]).sum())
        if avail[1]:
            cost += int(np.abs(blk[:, 15] - Y[my : my + 16, mx + 16]).sum())
        if avail[2]:
            cost += int(np.abs(blk[0] - Y[my - 1, mx : mx + 16]).sum())
        if avail[3]:
            cost += int(np.abs(blk[15] - Y[my + 16, mx : mx + 16]).sum())
        if best is None or cost < best[0]:
            best = (cost, mv, blk)
    _, mv, blk = best
    Y[my : my + 16, mx : mx + 16] = blk
    cw, ch = sps.mb_chroma_size
    cx, cy = (addr % W) * cw, (addr // W) * ch
    cwidth, cheight = width >> 1, height >> 1
    for plane, pad in ((planes.U, Upad), (planes.V, Vpad)):
        xi = cx + (mv[0] >> 3)
        yi = cy + (mv[1] >> 3)
        fx, fy = mv[0] & 7, mv[1] & 7
        xi = max(-(MC.PAD - 4), min(cwidth + MC.PAD - cw - 4, xi))
        yi = max(-(MC.PAD - 4), min(cheight + MC.PAD - ch - 4, yi))
        plane[cy : cy + ch, cx : cx + cw] = MC.chroma_block(
            pad, MC.PAD, xi, yi, fx, fy, cw, ch
        )
    # record the motion so later direct/colocated reads see something sane
    state.mv[0, y4 : y4 + 4, x4 : x4 + 4] = mv
    state.ref_idx[0, y4 : y4 + 4, x4 : x4 + 4] = 0
    if ref_pic is not None:
        state.ref_pic_id[0, y4 : y4 + 4, x4 : x4 + 4] = ref_pic.unique_id


def conceal_missing(state, sps, planes, ref_pic, intra_pic: bool) -> int:
    """Conceal every MB without a received slice.  Works inward from MBs
    adjacent to received/concealed data (the JM concentric order).
    Returns the number of concealed MBs."""
    miss = set(int(a) for a in missing_mbs(state))
    if not miss:
        return 0
    n = len(miss)
    W, H = state.W, state.H
    cw, ch = sps.mb_chroma_size
    done = set()
    while miss:
        progressed = []
        for addr in sorted(miss):
            x, y = addr % W, addr // W
            nb = [
                addr - 1 if x > 0 else -1,
                addr + 1 if x < W - 1 else -1,
                addr - W if y > 0 else -1,
                addr + W if y < H - 1 else -1,
            ]
            avail = [a >= 0 and (a not in miss) for a in nb]
            if not any(avail):
                continue
            if intra_pic or ref_pic is None:
                _conceal_mb_intra(
                    planes, x * 16, y * 16, avail, cw, ch)
            else:
                _conceal_mb_inter(state, planes, ref_pic, addr, avail, sps)
            progressed.append(addr)
        if not progressed:  # fully lost picture: flat fill / zero-mv copy
            for addr in sorted(miss):
                x, y = addr % W, addr // W
                if intra_pic or ref_pic is None:
                    planes.Y[y * 16 : y * 16 + 16, x * 16 : x * 16 + 16] = 128
                    planes.U[y * ch : (y + 1) * ch, x * cw : (x + 1) * cw] = 128
                    planes.V[y * ch : (y + 1) * ch, x * cw : (x + 1) * cw] = 128
                else:
                    _conceal_mb_inter(
                        state, planes, ref_pic, addr,
                        [False] * 4, sps)
            break
        for a in progressed:
            miss.discard(a)
    return n


# ---------------------------------------------------------------------------
# whole-frame concealment (conceal_lost_frames, erc_do_p.c:1260)
# ---------------------------------------------------------------------------

def conceal_lost_frame(sps, ref_pic, mode: int):
    """Build concealed planes for a missing frame from its nearest
    reference: mode 1 = frame copy; mode 2 = motion copy (re-apply the
    reference's own motion field against the reference, the
    constant-motion assumption)."""
    from .recon import Planes

    planes = Planes(sps)
    src = ref_pic.planes
    if mode != 2:
        planes.Y[:] = src.Y
        planes.U[:] = src.U
        planes.V[:] = src.V
        return planes
    st = ref_pic.state
    Ypad, Upad, Vpad = ref_pic.padded_planes()
    width, height = sps.width, sps.height
    mvf = np.asarray(st.mv[0])
    reff = np.asarray(st.ref_idx[0])
    for y4 in range(4 * st.H):
        for x4 in range(4 * st.W):
            px, py = 4 * x4, 4 * y4
            mv = (
                (int(mvf[y4, x4, 0]), int(mvf[y4, x4, 1]))
                if reff[y4, x4] >= 0 else (0, 0)
            )
            planes.Y[py : py + 4, px : px + 4] = _mc_block(
                Ypad, px, py, mv, 4, 4, width, height)
            if (x4 & 1) == 0 and (y4 & 1) == 0:
                cxx, cyy = px >> 1, py >> 1
                fx, fy = mv[0] & 7, mv[1] & 7
                xi = cxx + (mv[0] >> 3)
                yi = cyy + (mv[1] >> 3)
                xi = max(-(MC.PAD - 4),
                         min((width >> 1) + MC.PAD - 6, xi))
                yi = max(-(MC.PAD - 4),
                         min((height >> 1) + MC.PAD - 6, yi))
                for plane, pad in ((planes.U, Upad), (planes.V, Vpad)):
                    plane[cyy : cyy + 2, cxx : cxx + 2] = MC.chroma_block(
                        pad, MC.PAD, xi, yi, fx, fy, 2, 2)
    return planes
