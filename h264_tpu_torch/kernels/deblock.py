"""K6 wrappers: boundary strengths and the in-loop deblocking filter.

Kernel: ``csrc/deblock.cu`` (replaces the reference's ``encoder/rd.py:1713
strengths_full``, ``:1928 strengths_full_b`` and ``:1800
deblock_device_full``).  Plain versions: ``encoder.rd_p``
``strengths_plain``, ``deblock_plain``; ``encoder.rd_b``
``strengths_b_plain``.  CPU tensors run the plain version; CUDA tensors
launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_b, rd_p

strengths_plain = rd_p.strengths_plain
strengths_b_plain = rd_b.strengths_b_plain
deblock_plain = rd_p.deblock_plain

_I32 = torch.int32


def strengths(nz4, mvx4, mvy4, ref4, intra4):
    """(4 n_my, 4 n_mx) per-4x4 fields (nz4/intra4 bool) -> (BSV, BSH)
    int32 bS of every block's left and top edge."""
    if nz4.device.type == "cpu":
        return strengths_plain(nz4, mvx4, mvy4, ref4, intra4)
    dev = nz4.device
    H4, W4 = nz4.shape
    for name, x, dt in (("nz4", nz4, torch.bool), ("mvx4", mvx4, _I32),
                        ("mvy4", mvy4, _I32), ("ref4", ref4, _I32),
                        ("intra4", intra4, torch.bool)):
        check_tensor("strengths", name, x, (H4, W4), dt, dev)
    bsv = torch.empty((H4, W4), dtype=_I32, device=dev)
    bsh = torch.empty_like(bsv)
    rc = kernel_fn("deblock", "strengths", "pppppiippp")(
        nz4.data_ptr(), mvx4.data_ptr(), mvy4.data_ptr(), ref4.data_ptr(),
        intra4.data_ptr(), H4, W4, bsv.data_ptr(), bsh.data_ptr(),
        stream_of(nz4))
    check_launch(rc, "strengths")
    strengths.launches += 1
    return bsv, bsh


def strengths_b(nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x, m1y):
    """(4 n_my, 4 n_mx) per-4x4 fields of a B picture (nz4/intra4/v0/v1
    bool, reference POCs r0/r1 and mvs int32) -> (BSV, BSH) int32."""
    if nz4.device.type == "cpu":
        return strengths_b_plain(nz4, intra4, v0, r0, m0x, m0y, v1, r1, m1x,
                                 m1y)
    dev = nz4.device
    H4, W4 = nz4.shape
    args = (("nz4", nz4, torch.bool), ("intra4", intra4, torch.bool),
            ("v0", v0, torch.bool), ("r0", r0, _I32), ("m0x", m0x, _I32),
            ("m0y", m0y, _I32), ("v1", v1, torch.bool), ("r1", r1, _I32),
            ("m1x", m1x, _I32), ("m1y", m1y, _I32))
    for name, x, dt in args:
        check_tensor("strengths_b", name, x, (H4, W4), dt, dev)
    bsv = torch.empty((H4, W4), dtype=_I32, device=dev)
    bsh = torch.empty_like(bsv)
    rc = kernel_fn("deblock", "strengths_b", "p" * 10 + "ii" + "ppp")(
        *(x.data_ptr() for _, x, _ in args), H4, W4, bsv.data_ptr(),
        bsh.data_ptr(), stream_of(nz4))
    check_launch(rc, "strengths_b")
    strengths_b.launches += 1
    return bsv, bsh


def _thresholds(qp: int):
    alpha, beta, clip_row = rd_p._thresholds(qp, "cpu")
    return [alpha, beta, *(int(v) for v in clip_row)]


def deblock(rec_y, rec_u, rec_v, BSV, BSH, qp: int, qp_c: int):
    """Filtered copies (Y, U, V) of the int32 recon planes, in one launch
    of a persistent kernel; the inputs stay as they are."""
    if rec_y.device.type == "cpu":
        return deblock_plain(rec_y, rec_u, rec_v, BSV, BSH, qp, qp_c)
    dev = rec_y.device
    H, W = rec_y.shape
    if H % 16 or W % 16:
        raise ValueError(f"deblock: picture {W}x{H} is not whole MBs")
    for name, x, shape in (("rec_y", rec_y, (H, W)),
                           ("rec_u", rec_u, (H // 2, W // 2)),
                           ("rec_v", rec_v, (H // 2, W // 2)),
                           ("BSV", BSV, (H // 4, W // 4)),
                           ("BSH", BSH, (H // 4, W // 4))):
        check_tensor("deblock", name, x, shape, _I32, dev)
    thr = (ctypes.c_int * 12)(*_thresholds(qp), *_thresholds(qp_c))
    Y, U, V = (torch.empty_like(x) for x in (rec_y, rec_u, rec_v))
    # the blocks' row ticket, then each MB row's filtered columns (the C
    # entry zeroes them)
    sync = torch.empty(H // 16 + 1, dtype=_I32, device=dev)
    rc = kernel_fn("deblock", "deblock", "pppppii" + "ppppp" + "p")(
        rec_y.data_ptr(), rec_u.data_ptr(), rec_v.data_ptr(), BSV.data_ptr(),
        BSH.data_ptr(), H, W, ctypes.addressof(thr), Y.data_ptr(),
        U.data_ptr(), V.data_ptr(), sync.data_ptr(), stream_of(rec_y))
    check_launch(rc, "deblock")
    deblock.launches += 1
    return Y, U, V


strengths.launches = 0
strengths_b.launches = 0
deblock.launches = 0
