"""K10 wrapper: the dense 16x16 SAD grids of the host-path encoder.

Kernel: ``csrc/sad_grid.cu`` (replaces the reference's
``encoder/me.py:25`` ``sad_grid_16x16``).  Plain version:
``encoder.me.sad_grid_16x16_plain``.  CPU tensors run the plain version;
CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import me

sad_grid_16x16_plain = me.sad_grid_16x16_plain

_I32 = torch.int32


def sad_grid_16x16(cur, ref_padded, search_range: int):
    """cur (H, W) and ref_padded (H + 2R, W + 2R) int32 -> (2R+1, 2R+1,
    H//16, W//16) int32 SADs, indexed [dy+R, dx+R]."""
    if cur.device.type == "cpu":
        return sad_grid_16x16_plain(cur, ref_padded, search_range)
    dev = cur.device
    R = int(search_range)
    if R < 0:
        raise ValueError(f"sad_grid_16x16: search range {R} is negative")
    if cur.dim() != 2 or cur.shape[0] % 16 or cur.shape[1] % 16:
        raise ValueError("sad_grid_16x16: cur must be (H, W) whole MBs, got "
                         f"{tuple(cur.shape)}")
    H, W = cur.shape
    check_tensor("sad_grid_16x16", "cur", cur, (H, W), _I32, dev)
    check_tensor("sad_grid_16x16", "ref_padded", ref_padded,
                 (H + 2 * R, W + 2 * R), _I32, dev)
    if cur.data_ptr() % 16:
        raise ValueError("sad_grid_16x16: cur must start on a 16-byte "
                         "boundary (the kernel reads its rows as int4)")
    D = 2 * R + 1
    out = torch.empty((D, D, H // 16, W // 16), dtype=_I32, device=dev)
    rc = kernel_fn("sad_grid", "sad_grid_16x16", "ppiiipp")(
        cur.data_ptr(), ref_padded.data_ptr(), H, W, R, out.data_ptr(),
        stream_of(cur))
    check_launch(rc, "sad_grid_16x16")
    sad_grid_16x16.launches += 1
    return out


sad_grid_16x16.launches = 0
