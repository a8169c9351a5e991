"""K5 wrappers: residual coding of a P picture's candidates.

Kernel: ``csrc/inter_tq.cu`` (replaces the reference's ``encoder/rd.py:879
tq_recon`` with ``:228 _rdoq4`` and ``:287 _threshold_inter_luma``, the
inter branch of ``:1267 _chroma_tq``, and the I16 candidate of
``:984-998``).  Plain versions: ``encoder.rd_p`` ``inter_luma_tq_plain``,
``inter_chroma_tq_plain``, ``i16_candidate_plain``.  CPU tensors run the
plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_p

inter_luma_tq_plain = rd_p.inter_luma_tq_plain
inter_chroma_tq_plain = rd_p.inter_chroma_tq_plain
i16_candidate_plain = rd_p.i16_candidate_plain

_I32 = torch.int32


def _qp(fn, qp):
    if not 0 <= int(qp) <= 51:
        raise ValueError(f"{fn}: qp {qp} outside 0..51")
    return int(qp)


def inter_luma_tq(pred, orig, qp: int, lam: int):
    """pred (NC, n_mb, 16, 16), orig (n_mb, 16, 16) -> (lev (NC, n_mb, 4,
    4, 4, 4), rec (NC, n_mb, 16, 16), D8 (NC, n_mb, 4), cb8 (NC, n_mb, 4))."""
    if pred.device.type == "cpu":
        return inter_luma_tq_plain(pred, orig, qp, lam)
    dev = pred.device
    if pred.dim() != 4:
        raise ValueError(f"inter_luma_tq: pred must be (NC, n_mb, 16, 16), "
                         f"got {tuple(pred.shape)}")
    NC, n_mb = pred.shape[:2]
    check_tensor("inter_luma_tq", "pred", pred, (NC, n_mb, 16, 16), _I32, dev)
    check_tensor("inter_luma_tq", "orig", orig, (n_mb, 16, 16), _I32, dev)
    qp = _qp("inter_luma_tq", qp)
    lev = torch.empty((NC, n_mb, 4, 4, 4, 4), dtype=_I32, device=dev)
    rec = torch.empty((NC, n_mb, 16, 16), dtype=_I32, device=dev)
    d8 = torch.empty((NC, n_mb, 4), dtype=_I32, device=dev)
    cb8 = torch.empty_like(d8)
    rc = kernel_fn("inter_tq", "inter_luma_tq", "ppiiiipppp" + "p")(
        pred.data_ptr(), orig.data_ptr(), NC * n_mb, n_mb, qp, int(lam),
        lev.data_ptr(), rec.data_ptr(), d8.data_ptr(), cb8.data_ptr(),
        stream_of(pred))
    check_launch(rc, "inter_luma_tq")
    inter_luma_tq.launches += 1
    return lev, rec, d8, cb8


def inter_chroma_tq(pred, orig, qp_c: int, lam: int):
    """pred/orig (n_mb, 2, 8, 8) -> (levc (n_mb, 2, 2, 2, 4, 4), dcc
    (n_mb, 2, 2, 2), recc (n_mb, 2, 8, 8))."""
    if pred.device.type == "cpu":
        return inter_chroma_tq_plain(pred, orig, qp_c, lam)
    dev = pred.device
    n_mb = pred.shape[0]
    check_tensor("inter_chroma_tq", "pred", pred, (n_mb, 2, 8, 8), _I32, dev)
    check_tensor("inter_chroma_tq", "orig", orig, (n_mb, 2, 8, 8), _I32, dev)
    qp_c = _qp("inter_chroma_tq", qp_c)
    lev = torch.empty((n_mb, 2, 2, 2, 4, 4), dtype=_I32, device=dev)
    dc = torch.empty((n_mb, 2, 2, 2), dtype=_I32, device=dev)
    rec = torch.empty((n_mb, 2, 8, 8), dtype=_I32, device=dev)
    rc = kernel_fn("inter_tq", "inter_chroma_tq", "ppiiipppp")(
        pred.data_ptr(), orig.data_ptr(), n_mb, qp_c, int(lam), lev.data_ptr(),
        dc.data_ptr(), rec.data_ptr(), stream_of(pred))
    check_launch(rc, "inter_chroma_tq")
    inter_chroma_tq.launches += 1
    return lev, dc, rec


def i16_candidate(cur_y, qp: int):
    """The I16 candidate of every MB from original neighbours:
    (rec16 (n_mb, 16, 16), D16 (n_mb,), cb16 (n_mb,))."""
    if cur_y.device.type == "cpu":
        return i16_candidate_plain(cur_y, qp)
    dev = cur_y.device
    H, W = cur_y.shape
    check_tensor("i16_candidate", "cur_y", cur_y, (H, W), _I32, dev)
    if H % 16 or W % 16:
        raise ValueError(f"i16_candidate: picture {W}x{H} is not whole MBs")
    if cur_y.data_ptr() % 16:
        raise ValueError("i16_candidate: cur_y must start on a 16-byte "
                         "boundary (the kernel reads its rows as int4)")
    qp = _qp("i16_candidate", qp)
    n_mb = (H // 16) * (W // 16)
    rec = torch.empty((n_mb, 16, 16), dtype=_I32, device=dev)
    d = torch.empty(n_mb, dtype=_I32, device=dev)
    cb = torch.empty_like(d)
    rc = kernel_fn("inter_tq", "i16_candidate", "piiipppp")(
        cur_y.data_ptr(), H, W, qp, rec.data_ptr(), d.data_ptr(),
        cb.data_ptr(), stream_of(cur_y))
    check_launch(rc, "i16_candidate")
    i16_candidate.launches += 1
    return rec, d, cb


inter_luma_tq.launches = 0
inter_chroma_tq.launches = 0
i16_candidate.launches = 0
