"""K7 wrapper: temporal direct motion and prediction of a B picture.

Kernel: ``csrc/b_direct.cu`` (replaces the reference's ``encoder/rd.py:
2218-2263 direct_b8`` / ``direct_mb`` with ``:1911 _dynfrac_mc``).  Plain
version: ``encoder.rd_b.b_direct_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_b

b_direct_plain = rd_b.b_direct_plain

_I32 = torch.int32


def b_direct(banks0, banks1, col_intra4, col_ref4, col_mvx4, col_mvy4,
             dsf_tab, eq_tab):
    """banks0 (NR0, 4, Hp, Wp), banks1 (1, 4, Hp, Wp), the colocated
    snapshot (4 n_my, 4 n_mx) (intra bool, ref/mvx/mvy int32), dsf_tab
    (NR0,) int32, eq_tab (NR0,) bool -> pred (n_mb, 16, 16) and idx, l0x,
    l0y, l1x, l1y (n_mb, 4), int32."""
    if banks0.device.type == "cpu":
        return b_direct_plain(banks0, banks1, col_intra4, col_ref4, col_mvx4,
                              col_mvy4, dsf_tab, eq_tab)
    dev = banks0.device
    if banks0.dim() != 4 or banks0.shape[1] != 4:
        raise ValueError(f"b_direct: banks0 must be (NR0, 4, Hp, Wp), got "
                         f"{tuple(banks0.shape)}")
    NR0, _, Hp, Wp = banks0.shape
    H, W = Hp - 64, Wp - 64
    if H % 16 or W % 16 or H <= 0 or W <= 0:
        raise ValueError(f"b_direct: picture {W}x{H} is not whole MBs")
    H4, W4 = H // 4, W // 4
    check_tensor("b_direct", "banks0", banks0, (NR0, 4, Hp, Wp), _I32, dev)
    check_tensor("b_direct", "banks1", banks1, (1, 4, Hp, Wp), _I32, dev)
    for name, x, dt in (("col_intra4", col_intra4, torch.bool),
                        ("col_ref4", col_ref4, _I32),
                        ("col_mvx4", col_mvx4, _I32),
                        ("col_mvy4", col_mvy4, _I32)):
        check_tensor("b_direct", name, x, (H4, W4), dt, dev)
    check_tensor("b_direct", "dsf_tab", dsf_tab, (NR0,), _I32, dev)
    check_tensor("b_direct", "eq_tab", eq_tab, (NR0,), torch.bool, dev)
    n_mx = W // 16
    n_mb = (H // 16) * n_mx
    pred = torch.empty((n_mb, 16, 16), dtype=_I32, device=dev)
    fields = [torch.empty((n_mb, 4), dtype=_I32, device=dev) for _ in range(5)]
    rc = kernel_fn("b_direct", "b_direct", "p" * 8 + "i" * 5 + "p" * 7)(
        banks0.data_ptr(), banks1.data_ptr(), col_intra4.data_ptr(),
        col_ref4.data_ptr(), col_mvx4.data_ptr(), col_mvy4.data_ptr(),
        dsf_tab.data_ptr(), eq_tab.data_ptr(), NR0, Hp, Wp, n_mb, n_mx,
        pred.data_ptr(), *(t.data_ptr() for t in fields), stream_of(banks0))
    check_launch(rc, "b_direct")
    b_direct.launches += 1
    return (pred, *fields)


b_direct.launches = 0
