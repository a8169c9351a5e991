"""K1 wrapper: the whole intra commit scan of one picture in one launch.

Kernel: ``csrc/intra_commit.cu`` (replaces the reference's
``encoder/rd.py:1415 _intra_commit_scan``).  Plain version:
``encoder.rd._intra_scan`` (the reference's anti-diagonal steps).  A
state on the CPU runs the plain version; a state on a CUDA device
launches the kernel, or raises.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd
from ..encoder.rd import IntraScan

intra_commit_scan_plain = rd._intra_scan

_I32 = torch.int32


def _check(s: IntraScan) -> None:
    """Device, dtype, shape and contiguity of every tensor the kernel
    reads or writes."""
    n_my, n_mx = s.n_my, s.n_mx
    H, W = 16 * n_my, 16 * n_mx
    n_mb = n_my * n_mx
    dev = s.Yp.device
    shapes = {
        "cur_y": (H, W), "cur_u": (H // 2, W // 2), "cur_v": (H // 2, W // 2),
        "w_rec": (n_mb, 16, 16), "recc": (n_mb, 2, 8, 8), "is_intra": (n_mb,),
        "Yp": (H + 1, W + 5), "Up": (H // 2 + 1, W // 2 + 1),
        "Vp": (H // 2 + 1, W // 2 + 1), "ipm": (4 * n_my + 1, 4 * n_mx + 1),
        "w_lev": (n_mb, 4, 4, 4, 4), "levc": (n_mb, 2, 2, 2, 4, 4),
        "dcc": (n_mb, 2, 2, 2), "lum_dc": (n_mb, 4, 4), "i16mode": (n_mb,),
        "cip": (n_mb,), "i4flag": (n_mb,),
    }
    for name, shape in shapes.items():
        check_tensor("intra_commit_scan", name, getattr(s, name), shape,
                     torch.bool if name == "is_intra" else _I32, dev)
    if not 0 <= s.qp <= 51 or not 0 <= s.qp_c <= 51:
        raise ValueError(f"intra_commit_scan: qp {s.qp}/{s.qp_c} outside 0..51")


def intra_commit_scan(s: IntraScan) -> None:
    """Commit every MB of the scan `s` in place."""
    if s.Yp.device.type == "cpu":
        intra_commit_scan_plain(s)
        return
    _check(s)
    # the blocks' row ticket, then each MB row's committed columns
    sync = torch.zeros(s.n_my + 1, dtype=_I32, device=s.Yp.device)
    fn = kernel_fn("intra_commit", "intra_commit_scan",
                   "p" * 18 + "i" * 5 + "p")
    rc = fn(*(x.data_ptr() for x in (
        s.cur_y, s.cur_u, s.cur_v, s.w_rec, s.recc, s.is_intra, s.Yp, s.Up,
        s.Vp, s.ipm, s.w_lev, s.levc, s.dcc, s.lum_dc, s.i16mode, s.cip,
        s.i4flag, sync)),
        s.n_my, s.n_mx, s.qp, s.qp_c, s.lam, stream_of(s.Yp))
    check_launch(rc, "intra_commit_scan")
    intra_commit_scan.launches += 1


intra_commit_scan.launches = 0
