"""K4 wrappers: quarter-pel refinement and MC from the reference banks.

Kernel: ``csrc/qpel.cu`` (replaces the reference's ``encoder/rd.py:551``
``refine_unit`` / ``:583 refine_parts`` and the sub-8x8 refinement,
``:145 _mc_luma_unit`` and the skip prediction, ``:159 _mc_chroma_unit``
as ``chroma_pred_mb`` uses it).  Plain versions: ``encoder.rd_p``
``qpel_refine_plain``, ``mc_luma_plain``, ``mc_chroma_plain``.  CPU
tensors run the plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_p
from .search_grid import _check_common

qpel_refine_plain = rd_p.qpel_refine_plain
mc_luma_plain = rd_p.mc_luma_plain
mc_chroma_plain = rd_p.mc_chroma_plain

_I32 = torch.int32


def qpel_refine(banks, cur_y, ref, imvx, imvy, y0, x0, px, py, wp,
                lam_satd: int, h: int, w: int):
    """49-point quarter-pel refinement of n (h, w) units.  Returns
    (mvx, mvy) (n,), pred (n, h, w), cost (n,), int32."""
    if banks.device.type == "cpu":
        return qpel_refine_plain(banks, cur_y, ref, imvx, imvy, y0, x0, px,
                                 py, wp, lam_satd, h, w)
    _, Hp, Wp, _, W, (pw, po, use_wp) = _check_common(
        "qpel_refine", banks, cur_y, wp)
    n = ref.shape[0]
    for name, x in (("ref", ref), ("imvx", imvx), ("imvy", imvy), ("y0", y0),
                    ("x0", x0), ("px", px), ("py", py)):
        check_tensor("qpel_refine", name, x, (n,), _I32, banks.device)
    if h not in (4, 8, 16) or w not in (4, 8, 16):
        raise ValueError(f"qpel_refine: unit {h}x{w} is not a partition")
    dev = banks.device
    mvx = torch.empty(n, dtype=_I32, device=dev)
    mvy = torch.empty_like(mvx)
    cost = torch.empty_like(mvx)
    pred = torch.empty((n, h, w), dtype=_I32, device=dev)
    rc = kernel_fn("qpel", "qpel_refine", "p" * 11 + "i" * 8 + "ppppp")(
        banks.data_ptr(), cur_y.data_ptr(), ref.data_ptr(), imvx.data_ptr(),
        imvy.data_ptr(), y0.data_ptr(), x0.data_ptr(), px.data_ptr(),
        py.data_ptr(), pw, po, use_wp, n, Hp, Wp, W, int(lam_satd), h, w,
        mvx.data_ptr(), mvy.data_ptr(), pred.data_ptr(), cost.data_ptr(),
        stream_of(banks))
    check_launch(rc, "qpel_refine")
    qpel_refine.launches += 1
    return mvx, mvy, pred, cost


def mc_luma(banks, ref, mvx, mvy, y0, x0, wp, h: int, w: int):
    """Quarter-pel MC of n (h, w) units, weighted by each unit's
    reference when wp is given.  Returns (n, h, w) int32."""
    if banks.device.type == "cpu":
        return mc_luma_plain(banks, ref, mvx, mvy, y0, x0, wp, h, w)
    NR, _, Hp, Wp = banks.shape
    dev = banks.device
    check_tensor("mc_luma", "banks", banks, (NR, 4, Hp, Wp), _I32, dev)
    n = ref.shape[0]
    for name, x in (("ref", ref), ("mvx", mvx), ("mvy", mvy), ("y0", y0),
                    ("x0", x0)):
        check_tensor("mc_luma", name, x, (n,), _I32, dev)
    pw = po = None
    if wp is not None:
        for name, x in zip(("wp_w", "wp_o"), wp):
            check_tensor("mc_luma", name, x, (NR,), _I32, dev)
        pw, po = wp[0].data_ptr(), wp[1].data_ptr()
    out = torch.empty((n, h, w), dtype=_I32, device=dev)
    rc = kernel_fn("qpel", "mc_luma", "p" * 8 + "i" * 6 + "pp")(
        banks.data_ptr(), ref.data_ptr(), mvx.data_ptr(), mvy.data_ptr(),
        y0.data_ptr(), x0.data_ptr(), pw, po, int(wp is not None), n, Hp, Wp,
        h, w, out.data_ptr(), stream_of(banks))
    check_launch(rc, "mc_luma")
    mc_luma.launches += 1
    return out


def mc_chroma(cpads, ref8, mv4x, mv4y):
    """Inter chroma prediction of every MB, (n_mb, 2, 8, 8) int32, from
    its per-unit references ref8 (n_mb, 4) and per-4x4 mvs (n_mb, 4, 4)."""
    if cpads.device.type == "cpu":
        return mc_chroma_plain(cpads, ref8, mv4x, mv4y)
    dev = cpads.device
    if cpads.dim() != 4 or cpads.shape[1] != 2:
        raise ValueError(f"mc_chroma: cpads must be (NR, 2, Hcp, Wcp), got "
                         f"{tuple(cpads.shape)}")
    NR, _, Hcp, Wcp = cpads.shape
    check_tensor("mc_chroma", "cpads", cpads, (NR, 2, Hcp, Wcp), _I32, dev)
    n_mx = (Wcp - 64) // 8
    n_mb = ref8.shape[0]
    check_tensor("mc_chroma", "ref8", ref8, (n_mb, 4), _I32, dev)
    for name, x in (("mv4x", mv4x), ("mv4y", mv4y)):
        check_tensor("mc_chroma", name, x, (n_mb, 4, 4), _I32, dev)
    if n_mb != n_mx * ((Hcp - 64) // 8):
        raise ValueError(f"mc_chroma: {n_mb} MBs for chroma planes "
                         f"{Hcp - 64}x{Wcp - 64}")
    out = torch.empty((n_mb, 2, 8, 8), dtype=_I32, device=dev)
    rc = kernel_fn("qpel", "mc_chroma", "ppppiiiipp")(
        cpads.data_ptr(), ref8.data_ptr(), mv4x.data_ptr(), mv4y.data_ptr(),
        n_mb, n_mx, Hcp, Wcp, out.data_ptr(), stream_of(cpads))
    check_launch(rc, "mc_chroma")
    mc_chroma.launches += 1
    return out


qpel_refine.launches = 0
mc_luma.launches = 0
mc_chroma.launches = 0
