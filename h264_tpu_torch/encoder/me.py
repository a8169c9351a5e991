"""Motion estimation of the host-path encoder: dense full-search SAD grids.

The PyTorch counterpart of the reference package's encoder/me.py (the
re-design of lencod's FastFullSearch, me_fullfast.c:833
SetupFastFullPelSearch): the SAD of every integer search position for
every macroblock in one device computation, after which the serial mode
decision reads grid values and adds MV-rate costs (no per-position round
trips).  On the card the grid is kernel K10 (``csrc/sad_grid.cu``,
wrapper ``kernels.sad_grid``); ``sad_grid_16x16_plain`` is its plain
version, which CPU tensors run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_I32 = torch.int32


def sad_grid_16x16_plain(cur: torch.Tensor, ref_padded: torch.Tensor,
                         search_range: int) -> torch.Tensor:
    """SAD of every 16x16 MB against every integer displacement.

    cur: (H, W) int32; ref_padded: (H + 2R, W + 2R) int32, edge-padded by
    R.  Returns (2R+1, 2R+1, H//16, W//16) int32, indexed [dy+R, dx+R]
    (the reference's ``sad_grid_16x16``: one dy at a time, its 2R+1 dx
    windows stacked).  Every sum is exact in int32 (256 terms of at most
    255)."""
    H, W = cur.shape
    R = int(search_range)
    D = 2 * R + 1
    n_my, n_mx = H // 16, W // 16
    out = torch.empty((D, D, n_my, n_mx), dtype=_I32, device=cur.device)
    for dy in range(D):
        strip = ref_padded[dy:dy + H]
        wins = torch.stack([strip[:, dx:dx + W] for dx in range(D)])
        ad = (cur[None] - wins).abs()
        out[dy] = ad.reshape(D, n_my, 16, n_mx, 16).sum(dim=(2, 4))
    return out


def compute_sad_grids(cur_y: np.ndarray, ref_y: np.ndarray,
                      search_range: int = 16, device=None,
                      impl=None) -> np.ndarray:
    """Host wrapper: numpy (2R+1, 2R+1, nMBy, nMBx) int32 grids of the
    (H, W) planes `cur_y` against `ref_y`, the reference edge-padded by R
    on the host, both uploaded as int32 to `device` and the grid fetched
    in one copy (`device`: CUDA unless told otherwise).  ``impl`` defaults
    to the K10 wrapper (which runs the plain version on CPU tensors and
    the kernel on CUDA ones)."""
    if impl is None:
        from ..kernels.sad_grid import sad_grid_16x16 as impl
    R = int(search_range)
    dev = resolve_device(device)
    ref_p = np.pad(np.asarray(ref_y, np.int32), R, mode="edge")
    cur = torch.as_tensor(np.ascontiguousarray(cur_y, np.int32)).to(dev)
    ref = torch.as_tensor(ref_p).to(dev)
    return impl(cur, ref, R).cpu().numpy()


# MV rate cost: JM's lambda-weighted exp-golomb length of the MV difference
# (lencod/src/mv-search.c mvbits table)
def mv_bits(d: int) -> int:
    """Length of the se(v) code of d (an mvd component in quarter-pel
    units)."""
    k = 2 * abs(d) - (1 if d > 0 else 0)  # ue code number
    return 2 * (k + 1).bit_length() - 1


def mv_cost(lambda_factor: int, dx: int, dy: int, px: int, py: int) -> int:
    """Weighted MV rate: (lambda * bits) >> 16 (JM MV_COST semantics)."""
    b = mv_bits(dx - px) + mv_bits(dy - py)
    return (lambda_factor >> 16) * b + (((lambda_factor & 0xFFFF) * b) >> 16)
