"""K4 wrappers: quarter-pel refinement and MC from the reference banks.

Kernel: ``csrc/qpel.cu`` (replaces the reference's ``encoder/rd.py:551``
``refine_unit`` / ``:583 refine_parts``, the sub-8x8 refinement and the B
picture's ``:2100 refine_u``, ``:145 _mc_luma_unit`` and the skip
prediction, ``:159 _mc_chroma_unit`` as the P picture's ``chroma_pred_mb``
uses it, ``:1911 _dynfrac_mc`` and the B picture's ``:2453
chroma_pred_mb``).  Plain versions: ``encoder.rd_p`` ``qpel_refine_plain``,
``mc_luma_plain``, ``mc_chroma_plain``; ``encoder.rd_b``
``mc_luma_win_plain``, ``mc_chroma_b_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_b, rd_p
from .search_grid import _check_common

qpel_refine_plain = rd_p.qpel_refine_plain
mc_luma_plain = rd_p.mc_luma_plain
mc_chroma_plain = rd_p.mc_chroma_plain
mc_luma_win_plain = rd_b.mc_luma_win_plain
mc_chroma_b_plain = rd_b.mc_chroma_b_plain

_I32 = torch.int32
# the (h, w) units qpel_refine takes: the partitions and sub-partitions
_SHAPES = ((16, 16), (8, 16), (16, 8), (8, 8), (4, 8), (8, 4), (4, 4))


def qpel_refine(banks, cur_y, ref, imvx, imvy, y0, x0, px, py, wp,
                lam_satd: int, h: int, w: int):
    """49-point quarter-pel refinement of n (h, w) units (bank samples in
    0..255, as the reference banks hold).  Returns (mvx, mvy) (n,), pred
    (n, h, w), cost (n,), int32."""
    if banks.device.type == "cpu":
        return qpel_refine_plain(banks, cur_y, ref, imvx, imvy, y0, x0, px,
                                 py, wp, lam_satd, h, w)
    _, Hp, Wp, _, W, (pw, po, use_wp) = _check_common(
        "qpel_refine", banks, cur_y, wp)
    n = ref.shape[0]
    for name, x in (("ref", ref), ("imvx", imvx), ("imvy", imvy), ("y0", y0),
                    ("x0", x0), ("px", px), ("py", py)):
        check_tensor("qpel_refine", name, x, (n,), _I32, banks.device)
    if (h, w) not in _SHAPES:
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


def mc_luma_win(banks, ref, mvx, mvy, y0, x0, h: int, w: int):
    """`_dynfrac_mc` of n (h, w) units: window starts clamped into the
    banks.  Returns (n, h, w) int32."""
    if banks.device.type == "cpu":
        return mc_luma_win_plain(banks, ref, mvx, mvy, y0, x0, h, w)
    dev = banks.device
    if banks.dim() != 4 or banks.shape[1] != 4:
        raise ValueError(f"mc_luma_win: banks must be (NR, 4, Hp, Wp), got "
                         f"{tuple(banks.shape)}")
    NR, _, Hp, Wp = banks.shape
    check_tensor("mc_luma_win", "banks", banks, (NR, 4, Hp, Wp), _I32, dev)
    n = ref.shape[0]
    for name, x in (("ref", ref), ("mvx", mvx), ("mvy", mvy), ("y0", y0),
                    ("x0", x0)):
        check_tensor("mc_luma_win", name, x, (n,), _I32, dev)
    if not (0 < h <= Hp - 2 and 0 < w <= Wp - 2):
        raise ValueError(f"mc_luma_win: unit {h}x{w} larger than the bank")
    out = torch.empty((n, h, w), dtype=_I32, device=dev)
    rc = kernel_fn("qpel", "mc_luma_win", "p" * 6 + "i" * 6 + "pp")(
        banks.data_ptr(), ref.data_ptr(), mvx.data_ptr(), mvy.data_ptr(),
        y0.data_ptr(), x0.data_ptr(), NR, Hp, Wp, n, h, w, out.data_ptr(),
        stream_of(banks))
    check_launch(rc, "mc_luma_win")
    mc_luma_win.launches += 1
    return out


def mc_chroma_b(cpads0, cpads1, idx0, m0x, m0y, m1x, m1y, u0, u1):
    """Two-list chroma prediction of every MB, (n_mb, 2, 8, 8) int32, from
    list-0 reference indices idx0, mvs m0x/m0y/m1x/m1y (n_mb, 4) int32 and
    list use u0/u1 (n_mb, 4) bool per 8x8 unit."""
    if cpads0.device.type == "cpu":
        return mc_chroma_b_plain(cpads0, cpads1, idx0, m0x, m0y, m1x, m1y, u0,
                                 u1)
    dev = cpads0.device
    if cpads0.dim() != 4 or cpads0.shape[1] != 2:
        raise ValueError(f"mc_chroma_b: cpads0 must be (NR0, 2, Hcp, Wcp), "
                         f"got {tuple(cpads0.shape)}")
    NR0, _, Hcp, Wcp = cpads0.shape
    check_tensor("mc_chroma_b", "cpads0", cpads0, (NR0, 2, Hcp, Wcp), _I32,
                 dev)
    check_tensor("mc_chroma_b", "cpads1", cpads1, (1, 2, Hcp, Wcp), _I32, dev)
    n_mx = (Wcp - 64) // 8
    n_mb = idx0.shape[0]
    if n_mb != n_mx * ((Hcp - 64) // 8) or n_mb == 0:
        raise ValueError(f"mc_chroma_b: {n_mb} MBs for chroma planes "
                         f"{Hcp - 64}x{Wcp - 64}")
    for name, x, dt in (("idx0", idx0, _I32), ("m0x", m0x, _I32),
                        ("m0y", m0y, _I32), ("m1x", m1x, _I32),
                        ("m1y", m1y, _I32), ("u0", u0, torch.bool),
                        ("u1", u1, torch.bool)):
        check_tensor("mc_chroma_b", name, x, (n_mb, 4), dt, dev)
    out = torch.empty((n_mb, 2, 8, 8), dtype=_I32, device=dev)
    rc = kernel_fn("qpel", "mc_chroma_b", "p" * 9 + "i" * 5 + "pp")(
        cpads0.data_ptr(), cpads1.data_ptr(), idx0.data_ptr(),
        m0x.data_ptr(), m0y.data_ptr(), m1x.data_ptr(), m1y.data_ptr(),
        u0.data_ptr(), u1.data_ptr(), NR0, n_mb, n_mx, Hcp, Wcp,
        out.data_ptr(), stream_of(cpads0))
    check_launch(rc, "mc_chroma_b")
    mc_chroma_b.launches += 1
    return out


qpel_refine.launches = 0
mc_luma.launches = 0
mc_chroma.launches = 0
mc_luma_win.launches = 0
mc_chroma_b.launches = 0
