"""K3 wrappers: the dense block-matching searches of a P picture.

Kernel: ``csrc/search_grid.cu`` (replaces the reference's
``encoder/rd.py:361-459`` coarse search and ``block_ssd``, and
``:640-677`` ``block_ssd4`` with the sub-8x8 pricing and argmins).  Plain
versions: ``encoder.rd_p`` ``coarse_search_plain``, ``ssd_grid8_plain``,
``sub8_search_plain``.  CPU tensors run the plain version; CUDA tensors
launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_p

coarse_search_plain = rd_p.coarse_search_plain
ssd_grid8_plain = rd_p.ssd_grid8_plain
sub8_search_plain = rd_p.sub8_search_plain

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


def sub8_search(banks, cur_y, u_ref, u_cy, u_cx, u_px, u_py, wp, RS: int,
                lam_me: int):
    """(2, 8, n_units) int32: each unit's integer winners (mvx, then mvy)
    of its 8x4, 4x8 and 4x4 partitions, searched +-RS around (u_cx, u_cy)
    on reference u_ref and priced against the PMV (u_px, u_py)."""
    if banks.device.type == "cpu":
        return sub8_search_plain(banks, cur_y, u_ref, u_cy, u_cx, u_px, u_py,
                                 wp, RS, lam_me)
    NR, Hp, Wp, H, W, (pw, po, use_wp) = _check_common(
        "sub8_search", banks, cur_y, wp)
    n = 4 * (H // 16) * (W // 16)
    units = (u_ref, u_cy, u_cx, u_px, u_py)
    for name, x in zip(("u_ref", "u_cy", "u_cx", "u_px", "u_py"), units):
        check_tensor("sub8_search", name, x, (n,), _I32, banks.device)
    if not 0 <= RS <= 10:
        raise ValueError(f"sub8_search: RS {RS} outside 0..10")
    if not 0 <= lam_me < 2 ** 31:
        raise ValueError(f"sub8_search: lam_me {lam_me} outside 0..2^31-1")
    out = torch.empty((2, 8, n), dtype=_I32, device=banks.device)
    rc = kernel_fn("search_grid", "sub8_search", "p" * 9 + "i" * 7 + "pp")(
        banks.data_ptr(), cur_y.data_ptr(), *(x.data_ptr() for x in units),
        pw, po, use_wp, Hp, Wp, W, n, RS, int(lam_me), out.data_ptr(),
        stream_of(banks))
    check_launch(rc, "sub8_search")
    sub8_search.launches += 1
    return out


coarse_search.launches = 0
ssd_grid8.launches = 0
sub8_search.launches = 0
