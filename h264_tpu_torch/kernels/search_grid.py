"""K3 wrappers: the dense block-matching grids of a P picture.

Kernel: ``csrc/search_grid.cu`` (replaces the reference's
``encoder/rd.py:361-459`` coarse search and ``block_ssd``, and
``:640-665`` ``block_ssd4``).  Plain versions: ``encoder.rd_p``
``coarse_search_plain``, ``ssd_grid8_plain``, ``ssd_grid4_plain``.  CPU
tensors run the plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_p

coarse_search_plain = rd_p.coarse_search_plain
ssd_grid8_plain = rd_p.ssd_grid8_plain
ssd_grid4_plain = rd_p.ssd_grid4_plain

_I32 = torch.int32


def _check_common(fn, banks, cur_y, wp):
    """The bank stack, the source plane and the WP tables; returns
    (NR, Hp, Wp, H, W, wp pointers and flag)."""
    dev = banks.device
    if banks.dim() != 4 or banks.shape[1] != 4:
        raise ValueError(f"{fn}: banks must be (NR, 4, Hp, Wp), got "
                         f"{tuple(banks.shape)}")
    NR, _, Hp, Wp = banks.shape
    H, W = Hp - 64, Wp - 64
    check_tensor(fn, "banks", banks, (NR, 4, Hp, Wp), _I32, dev)
    check_tensor(fn, "cur_y", cur_y, (H, W), _I32, dev)
    if H % 16 or W % 16:
        raise ValueError(f"{fn}: picture {W}x{H} is not whole MBs")
    if wp is None:
        return NR, Hp, Wp, H, W, (None, None, 0)
    for name, x in zip(("wp_w", "wp_o"), wp):
        check_tensor(fn, name, x, (NR,), _I32, dev)
    return NR, Hp, Wp, H, W, (wp[0].data_ptr(), wp[1].data_ptr(), 1)


def coarse_search(banks, cur_y, wp, lam_me: int):
    """Per (ref, MB) full-pel search centre (cen_x, cen_y), each
    (NR, n_my, n_mx) int32."""
    if banks.device.type == "cpu":
        return coarse_search_plain(banks, cur_y, wp, lam_me)
    NR, Hp, Wp, H, W, (pw, po, use_wp) = _check_common(
        "coarse_search", banks, cur_y, wp)
    cen_x = torch.empty((NR, H // 16, W // 16), dtype=_I32, device=banks.device)
    cen_y = torch.empty_like(cen_x)
    # the kernel's scratch: every reference's decimated plane, u16 cells
    plane = torch.empty((NR, (Hp + 2 * rd_p.E) // 4, (Wp + 2 * rd_p.E) // 4),
                        dtype=torch.int16, device=banks.device)
    rc = kernel_fn("search_grid", "coarse_search", "ppppiiiiiiipppp")(
        banks.data_ptr(), cur_y.data_ptr(), pw, po, use_wp, NR, Hp, Wp, H, W,
        int(lam_me), plane.data_ptr(), cen_x.data_ptr(), cen_y.data_ptr(),
        stream_of(banks))
    check_launch(rc, "coarse_search")
    coarse_search.launches += 1
    return cen_x, cen_y


def ssd_grid8(banks, cur_y, cen_x, cen_y, wp, R: int):
    """(NR, n_b8, 2R+1, 2R+1) int32 SSD grids of every 8x8 block."""
    if banks.device.type == "cpu":
        return ssd_grid8_plain(banks, cur_y, cen_x, cen_y, wp, R)
    NR, Hp, Wp, H, W, (pw, po, use_wp) = _check_common(
        "ssd_grid8", banks, cur_y, wp)
    for name, x in (("cen_x", cen_x), ("cen_y", cen_y)):
        check_tensor("ssd_grid8", name, x, (NR, H // 16, W // 16), _I32,
                     banks.device)
    if not 0 <= R <= 28:
        raise ValueError(f"ssd_grid8: R {R} outside 0..28")
    D = 2 * R + 1
    out = torch.empty((NR, (H // 8) * (W // 8), D, D), dtype=_I32,
                      device=banks.device)
    rc = kernel_fn("search_grid", "ssd_grid8", "pppppp" + "i" * 7 + "pp")(
        banks.data_ptr(), cur_y.data_ptr(), cen_x.data_ptr(), cen_y.data_ptr(),
        pw, po, use_wp, NR, Hp, Wp, H, W, R, out.data_ptr(), stream_of(banks))
    check_launch(rc, "ssd_grid8")
    ssd_grid8.launches += 1
    return out


def ssd_grid4(banks, cur_y, u_ref, u_cy, u_cx, wp, RS: int):
    """(n_units, 4, 2RS+1, 2RS+1) int32 grids of every unit's 4x4
    quadrants on the unit's reference."""
    if banks.device.type == "cpu":
        return ssd_grid4_plain(banks, cur_y, u_ref, u_cy, u_cx, wp, RS)
    NR, Hp, Wp, H, W, (pw, po, use_wp) = _check_common(
        "ssd_grid4", banks, cur_y, wp)
    n = 4 * (H // 16) * (W // 16)
    for name, x in (("u_ref", u_ref), ("u_cy", u_cy), ("u_cx", u_cx)):
        check_tensor("ssd_grid4", name, x, (n,), _I32, banks.device)
    if not 0 <= RS <= 10:
        raise ValueError(f"ssd_grid4: RS {RS} outside 0..10")
    DS = 2 * RS + 1
    out = torch.empty((n, 4, DS, DS), dtype=_I32, device=banks.device)
    rc = kernel_fn("search_grid", "ssd_grid4", "ppppppp" + "i" * 6 + "pp")(
        banks.data_ptr(), cur_y.data_ptr(), u_ref.data_ptr(), u_cy.data_ptr(),
        u_cx.data_ptr(), pw, po, use_wp, n, Hp, Wp, W, RS, out.data_ptr(),
        stream_of(banks))
    check_launch(rc, "ssd_grid4")
    ssd_grid4.launches += 1
    return out


coarse_search.launches = 0
ssd_grid8.launches = 0
ssd_grid4.launches = 0
