"""K12 and K13 wrappers: the legacy P picture's integer-pel search and its
quarter-pel refinement with the residual coding.

Kernels: ``csrc/p16_search.cu`` (K12) and ``csrc/p16_refine.cu`` (K13),
which replace the reference's ``encoder/fast.py:117-158`` and ``:160-296``
(inside ``_p_frame_core``).  Plain versions: ``encoder.fast``
``search_plain`` and ``refine_tq_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import fast

search_plain = fast.search_plain
refine_tq_plain = fast.refine_tq_plain

_I32 = torch.int32
_P = fast.PAD


def _whole_mbs(fn: str, cur_y) -> tuple[int, int]:
    if cur_y.dim() != 2 or cur_y.shape[0] % 16 or cur_y.shape[1] % 16:
        raise ValueError(f"{fn}: cur_y must be (H, W) whole MBs, got "
                         f"{tuple(cur_y.shape)}")
    return tuple(cur_y.shape)


def p16_search(cur_y, ref_pad, R: int, lambda_me: int):
    """cur_y (H, W), ref_pad (H+64, W+64) int32 -> (int_mvx, int_mvy,
    grid0) (H/16, W/16) int32."""
    if cur_y.device.type == "cpu":
        return search_plain(cur_y, ref_pad, R, lambda_me)
    dev = cur_y.device
    H, W = _whole_mbs("p16_search", cur_y)
    R = int(R)
    if not 0 <= R <= _P:
        raise ValueError(f"p16_search: search range {R} outside 0..{_P}")
    check_tensor("p16_search", "cur_y", cur_y, (H, W), _I32, dev)
    check_tensor("p16_search", "ref_pad", ref_pad, (H + 2 * _P, W + 2 * _P),
                 _I32, dev)
    if cur_y.data_ptr() % 16:
        raise ValueError("p16_search: cur_y must start on a 16-byte "
                         "boundary (the kernel reads its rows as int4)")
    out = torch.empty((3, H // 16, W // 16), dtype=_I32, device=dev)
    rc = kernel_fn("p16_search", "p16_search", "ppiiiipppp")(
        cur_y.data_ptr(), ref_pad.data_ptr(), H, W, R, int(lambda_me),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        stream_of(cur_y))
    check_launch(rc, "p16_search")
    p16_search.launches += 1
    return out[0], out[1], out[2]


def _plane(name: str, x, shape, dev):
    """(pointer, rows, cols, row stride) of a 2-D int32 plane with unit
    column stride (a view into a K2 bank is fine)."""
    if (not isinstance(x, torch.Tensor) or x.device != dev
            or x.dtype != _I32 or tuple(x.shape) != tuple(shape)
            or x.stride(1) != 1):
        got = (f"{x.dtype} {tuple(x.shape)} stride {x.stride()} on "
               f"{x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"p16_refine: {name} must be an int32 plane of "
                         f"shape {tuple(shape)} with unit column stride on "
                         f"{dev}, got {got}")
    return x.data_ptr(), (*shape, x.stride(0))


def p16_refine(cur_y, cur_u, cur_v, ref_pad, bpl, hpl, jpl, ref_u_pad,
               ref_v_pad, int_mvx, int_mvy, qp: int, qp_c: int,
               lambda_me: int):
    """int32 current planes (H, W), (H/2, W/2) x 2; ref_pad (H+64, W+64),
    b/h/j (H+59, W+59), U/V pads (H/2+64, W/2+64); int_mvx/int_mvy
    (H/16, W/16) -> (mvx, mvy (n_mb), lev (H/4, W/4, 4, 4), rec_y, lev_u
    (H/8, W/8, 4, 4), dc_u (H/16, W/16, 2, 2), rec_u, lev_v, dc_v,
    rec_v)."""
    if cur_y.device.type == "cpu":
        return refine_tq_plain(cur_y, cur_u, cur_v, ref_pad, bpl, hpl, jpl,
                               ref_u_pad, ref_v_pad, int_mvx, int_mvy, qp,
                               qp_c, lambda_me)
    dev = cur_y.device
    H, W = _whole_mbs("p16_refine", cur_y)
    for q in (qp, qp_c):
        if not 0 <= int(q) <= 51:
            raise ValueError(f"p16_refine: qp {q} outside 0..51")
    Hc, Wc = H // 2, W // 2
    n_my, n_mx = H // 16, W // 16
    for name, x, shape in (("cur_y", cur_y, (H, W)), ("cur_u", cur_u, (Hc, Wc)),
                           ("cur_v", cur_v, (Hc, Wc)),
                           ("int_mvx", int_mvx, (n_my, n_mx)),
                           ("int_mvy", int_mvy, (n_my, n_mx))):
        check_tensor("p16_refine", name, x, shape, _I32, dev)
    for name, x in (("cur_y", cur_y), ("cur_u", cur_u), ("cur_v", cur_v)):
        if x.data_ptr() % 16:
            raise ValueError(f"p16_refine: {name} must start on a 16-byte "
                             "boundary (the kernel reads its rows as int4)")
    lp, hp = (H + 2 * _P, W + 2 * _P), (H + 2 * _P - 5, W + 2 * _P - 5)
    cp = (Hc + 2 * _P, Wc + 2 * _P)
    ptrs, dims = [], []
    for name, x, shape in (("ref_pad", ref_pad, lp), ("b", bpl, hp),
                           ("h", hpl, hp), ("j", jpl, hp),
                           ("ref_u_pad", ref_u_pad, cp),
                           ("ref_v_pad", ref_v_pad, cp)):
        p, d = _plane(name, x, shape, dev)
        ptrs.append(p)
        dims.extend(d)
    planes = (ctypes.c_void_p * 6)(*ptrs)
    dimv = (ctypes.c_int * 18)(*dims)

    def new(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    mv = new(2, n_my * n_mx)
    lev, rec_y = new(H // 4, W // 4, 4, 4), new(H, W)
    lev_u, lev_v = new(Hc // 4, Wc // 4, 4, 4), new(Hc // 4, Wc // 4, 4, 4)
    dc_u, dc_v = new(n_my, n_mx, 2, 2), new(n_my, n_mx, 2, 2)
    rec_u, rec_v = new(Hc, Wc), new(Hc, Wc)
    rc = kernel_fn("p16_refine", "p16_refine", "pppiippppiii" + "p" * 11)(
        cur_y.data_ptr(), cur_u.data_ptr(), cur_v.data_ptr(), H, W,
        ctypes.addressof(planes), ctypes.addressof(dimv), int_mvx.data_ptr(),
        int_mvy.data_ptr(), int(qp), int(qp_c), int(lambda_me),
        mv[0].data_ptr(), mv[1].data_ptr(), lev.data_ptr(), rec_y.data_ptr(),
        lev_u.data_ptr(), dc_u.data_ptr(), rec_u.data_ptr(), lev_v.data_ptr(),
        dc_v.data_ptr(), rec_v.data_ptr(), stream_of(cur_y))
    check_launch(rc, "p16_refine")
    p16_refine.launches += 1
    return (mv[0], mv[1], lev, rec_y, lev_u, dc_u, rec_u, lev_v, dc_v, rec_v)


p16_search.launches = 0
p16_refine.launches = 0
