"""FMO slice-group maps, spec §8.2.2 (map types 0-6).

Capability parity with the reference FMO layer (lencod/src/fmo.c
FmoGenerateType0..6MapUnitMap :70-75 and ldecod/src/fmo.c), re-designed
as pure functions producing a whole-picture MB->group tensor (the map is
a constant per picture, ideal as a device-side gather index).
"""

from __future__ import annotations

import numpy as np


def mb_to_slice_group(sps, pps, slice_group_change_cycle: int = 0
                      ) -> np.ndarray:
    """MB address -> slice group id (frame coding, MapUnit == MB)."""
    W = sps.pic_width_in_mbs
    H = sps.frame_height_in_mbs
    n = W * H
    ng = pps.num_slice_groups_minus1 + 1
    if ng == 1:
        return np.zeros(n, np.int32)
    t = pps.slice_group_map_type
    if t == 0:  # interleave (run lengths)
        runs = [r + 1 for r in pps.run_length_minus1]
        out = np.empty(n, np.int32)
        i = 0
        while i < n:
            for g in range(ng):
                for _ in range(runs[g] if g < len(runs) else 1):
                    if i >= n:
                        break
                    out[i] = g
                    i += 1
        return out
    if t == 1:  # dispersed (checkerboard-like)
        i = np.arange(n)
        return (((i % W) + (((i // W) * ng) // 2)) % ng).astype(np.int32)
    if t == 2:  # foreground rectangles + background
        out = np.full(n, ng - 1, np.int32)
        for g in range(ng - 2, -1, -1):
            tl = pps.top_left[g]
            br = pps.bottom_right[g]
            x0, y0 = tl % W, tl // W
            x1, y1 = br % W, br // W
            for y in range(y0, min(y1, H - 1) + 1):
                for x in range(x0, min(x1, W - 1) + 1):
                    out[y * W + x] = g
        return out
    cr = pps.slice_group_change_rate_minus1 + 1
    k = min(slice_group_change_cycle * cr, n)
    cd = 1 if pps.slice_group_change_direction_flag else 0
    if t == 3:  # box-out
        out = np.ones(n, np.int32)
        x = (W - cd) // 2
        y = (H - cd) // 2
        left = right = x
        top = bottom = y
        xdir = cd - 1
        ydir = cd
        remaining = k
        while remaining > 0:
            if out[y * W + x] == 1:
                out[y * W + x] = 0
                remaining -= 1
            if xdir == -1 and x == left:
                left = max(left - 1, 0)
                x = left
                xdir, ydir = 0, 2 * cd - 1
            elif xdir == 1 and x == right:
                right = min(right + 1, W - 1)
                x = right
                xdir, ydir = 0, 1 - 2 * cd
            elif ydir == -1 and y == top:
                top = max(top - 1, 0)
                y = top
                xdir, ydir = 1 - 2 * cd, 0
            elif ydir == 1 and y == bottom:
                bottom = min(bottom + 1, H - 1)
                y = bottom
                xdir, ydir = 2 * cd - 1, 0
            else:
                x += xdir
                y += ydir
        return out
    if t == 4:  # raster scan
        out = np.ones(n, np.int32)
        size_ul = n - k if cd else k
        out[:size_ul] = 0 if not cd else 1
        out[size_ul:] = 1 if not cd else 0
        return out
    if t == 5:  # wipe (column-major)
        order = np.arange(n).reshape(H, W).T.ravel()  # col-major scan
        out = np.ones(n, np.int32)
        size_ul = n - k if cd else k
        out[order[:size_ul]] = 0 if not cd else 1
        out[order[size_ul:]] = 1 if not cd else 0
        return out
    if t == 6:  # explicit
        ids = list(pps.slice_group_id) + [0] * max(0, n - len(pps.slice_group_id))
        return np.asarray(ids[:n], np.int32)
    raise ValueError(f"slice_group_map_type {t}")


def next_mb_in_group(sg_map: np.ndarray, addr: int) -> int:
    """FmoGetNextMBNr: next MB (raster) in the same slice group, or -1."""
    g = sg_map[addr]
    for a in range(addr + 1, len(sg_map)):
        if sg_map[a] == g:
            return int(a)
    return -1


def next_mb_array(sg_map: np.ndarray) -> np.ndarray:
    """Precomputed FmoGetNextMBNr table: nxt[a] = next MB of a's group."""
    n = len(sg_map)
    nxt = np.full(n, -1, np.int64)
    last: dict[int, int] = {}
    for a in range(n - 1, -1, -1):
        g = int(sg_map[a])
        nxt[a] = last.get(g, -1)
        last[g] = a
    return nxt
