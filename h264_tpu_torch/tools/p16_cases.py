"""Built inputs of the legacy P picture (``encoder/fast.py``: kernels K12
``p16_search`` and K13 ``p16_refine``), beside its recorded ones:

- ``0_255`` / ``255_0``: a current picture of 255 against a reference of 0
  and the reverse, every SSD term at its largest (256 * 255^2 per MB);
- ``flat``: equal flat planes, so every SSD is 0 and the costs tie up to
  the rate prior (at QP 0 the prior is 0 for most vectors: the first
  offset in (dy, dx) order must win);
- ``edges``: a reference state of random samples (the padded plane, its
  half-pel planes and the chroma pads, no sample replicated), and a
  current picture whose MBs are its windows at integer vectors of +-R
  toward every picture edge (left column -R, right column +R, top row
  -R, bottom row +R: each such MB has one vector of SSD 0) and at random
  quarter-pel vectors inside, so the refinement's windows reach as deep
  into the pads as R allows.

``built_case(name, H, W, R, seed)`` returns the current planes (Y, U, V)
and the reference state (Ypad, b, h, j, Upad, Vpad) as int32 numpy
arrays; ``reached_sides`` counts the MBs whose search vector lies at +-R
on each side; ``moved_vectors`` gives integer vectors for K13 whose
windows move (wrap or clamp) as the reference's ``dynamic_slice`` places
them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder import fast

CASES = ("0_255", "255_0", "flat", "edges")
P = fast.PAD


def _state_of(Y, U, V):
    """(Ypad, b, h, j, Upad, Vpad) of planes, edge-padded by 32."""
    return tuple(x.numpy() for x in fast.ref_resources(Y, U, V,
                                                       device="cpu"))


def edge_vectors(H: int, W: int, R: int, seed: int):
    """Per-MB quarter-pel vectors (n_my, n_mx) x 2: +-4R toward the edge
    on the border MBs, random within +-(4R - 3) inside."""
    rs = np.random.RandomState(seed)
    n_my, n_mx = H // 16, W // 16
    lim = max(4 * R - 3, 0)
    vx = rs.randint(-lim, lim + 1, (n_my, n_mx))
    vy = rs.randint(-lim, lim + 1, (n_my, n_mx))
    vx[:, 0], vx[:, -1] = -4 * R, 4 * R
    vy[0, :], vy[-1, :] = -4 * R, 4 * R
    return vx.astype(np.int32), vy.astype(np.int32)


def built_case(name: str, H: int, W: int, R: int, seed: int):
    """(cur (Y, U, V), ref state (Ypad, b, h, j, Upad, Vpad)), int32."""
    Hc, Wc = H // 2, W // 2
    rs = np.random.RandomState(seed)
    if name in ("0_255", "255_0", "flat"):
        c, r = {"0_255": (255, 0), "255_0": (0, 255), "flat": (128, 128)}[name]
        cur = (np.full((H, W), c), np.full((Hc, Wc), c), np.full((Hc, Wc), c))
        ref = (np.full((H, W), r), np.full((Hc, Wc), r), np.full((Hc, Wc), r))
        return (tuple(x.astype(np.int32) for x in cur),
                _state_of(*(x.astype(np.int32) for x in ref)))
    if name != "edges":
        raise KeyError(name)
    Ypad = rs.randint(0, 256, (H + 2 * P, W + 2 * P)).astype(np.int32)
    b, h, j = (x.numpy() for x in fast.half_planes(torch.as_tensor(Ypad)))
    Upad, Vpad = rs.randint(0, 256, (2, Hc + 2 * P, Wc + 2 * P)).astype(
        np.int32)
    vx, vy = edge_vectors(H, W, R, seed)
    planes = tuple(torch.as_tensor(x) for x in (Ypad, b, h, j))
    ys, xs = (o.reshape(H // 16, W // 16) for o in fast._mb_origins(
        H, W, "cpu"))
    Y = np.empty((H, W), np.int32)
    for i in range(H // 16):
        for k in range(W // 16):
            mx, my = int(vx[i, k]), int(vy[i, k])
            iy = torch.tensor([int(ys[i, k]) + (my >> 2) + P])
            ix = torch.tensor([int(xs[i, k]) + (mx >> 2) + P])
            Y[16 * i: 16 * i + 16, 16 * k: 16 * k + 16] = fast.qpel_window(
                planes, iy, ix, mx & 3, my & 3)[0].numpy()
    U, V = rs.randint(0, 256, (2, Hc, Wc)).astype(np.int32)
    return (Y, U, V), (Ypad, b, h, j, Upad, Vpad)


def reached_sides(int_mvx, int_mvy, R: int) -> dict:
    """MBs of the border rows / columns whose integer search vector is
    +-R toward that side."""
    mx, my = np.asarray(int_mvx), np.asarray(int_mvy)
    return {"left": int((mx[:, 0] == -R).sum()),
            "right": int((mx[:, -1] == R).sum()),
            "top": int((my[0, :] == -R).sum()),
            "bottom": int((my[-1, :] == R).sum())}


# integer vectors past the search range: one beyond R 32, beyond the pad
# of 32, and at the int32 extremes (the products and sums wrap)
FAR = (33, -33, 40, -40, 200, -200, 2 ** 30, -2 ** 31)


def moved_vectors(H: int, W: int, R: int, seed: int):
    """Integer vectors (n_my, n_mx) x 2, int32, whose refinement windows
    move: the top-left MB at -(R + 1) and the bottom-right one at R + 1 on
    both axes (its b window a row past the bottom, G wrapping at the top
    at R 32), the others drawn from ``FAR``."""
    rs = np.random.RandomState(seed)
    n_my, n_mx = H // 16, W // 16
    mx, my = (rs.choice(np.array(FAR, np.int64), (n_my, n_mx))
              for _ in range(2))
    mx[0, 0] = my[0, 0] = -(R + 1)
    mx[-1, -1] = my[-1, -1] = R + 1
    return mx.astype(np.int32), my.astype(np.int32)
