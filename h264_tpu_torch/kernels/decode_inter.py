"""K8 wrapper: the decoder's whole-picture inter reconstruction.

Kernel: ``csrc/decode_inter.cu`` (replaces the reference's
``decoder/device.py:99 _decode_inter``).  Plain version:
``decoder.device.decode_inter_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of

_I32 = torch.int32
MAXREF = 8  # per-list ref table depth (csrc/decode_inter.cu kMaxRef)

# argument names in order, after banks and cpads
_NAMES = ("refmap", "mv", "ref_idx", "sid4", "wp_mode", "wp_ly", "wp_lc",
          "wy", "oy", "wc", "oc", "wimp", "qp", "qpc", "t8", "lev4", "lev8",
          "levc", "dcc", "inter_mask", "ils4y", "ils8y", "ils4c")


def decode_inter_plain(*args, **kw):
    """The plain PyTorch version (``decoder.device.decode_inter_plain``)."""
    from ..decoder.device import decode_inter_plain as plain

    return plain(*args, **kw)


def _shapes(NB, NS, H, W):
    H4, W4 = H // 4, W // 4
    nb = (H // 16) * (W // 16)
    return {
        "banks": (NB, 4, H + 64, W + 64),
        "cpads": (NB, 2, H // 2 + 64, W // 2 + 64),
        "refmap": (NS, 2, MAXREF), "mv": (2, H4, W4, 2),
        "ref_idx": (2, H4, W4), "sid4": (H4, W4),
        "wp_mode": (NS,), "wp_ly": (NS,), "wp_lc": (NS,),
        "wy": (NS, 2, MAXREF), "oy": (NS, 2, MAXREF),
        "wc": (NS, 2, MAXREF, 2), "oc": (NS, 2, MAXREF, 2),
        "wimp": (NS, MAXREF, MAXREF, 2),
        "qp": (nb,), "qpc": (nb, 2), "t8": (nb,),
        "lev4": (nb, 16, 4, 4), "lev8": (nb, 4, 8, 8),
        "levc": (nb, 2, 4, 4, 4), "dcc": (nb, 2, 2, 2), "inter_mask": (nb,),
        "ils4y": (6, 4, 4), "ils8y": (6, 8, 8), "ils4c": (2, 6, 4, 4),
    }


def decode_inter(banks, cpads, *rest, H: int, W: int, NS: int):
    """(banks, cpads, refmap, mv, ref_idx, sid4, wp_mode, wp_ly, wp_lc, wy,
    oy, wc, oc, wimp, qp, qpc, t8, lev4, lev8, levc, dcc, inter_mask,
    ils4y, ils8y, ils4c), int32 tensors on one device (shapes in
    ``decoder.device.decode_inter_plain``) -> the flat int32
    (H*W + 2*(H/2)*(W/2),) Y|U|V recon of the inter MBs, zero elsewhere."""
    if banks.device.type == "cpu":
        return decode_inter_plain(banks, cpads, *rest, H=H, W=W, NS=NS)
    dev = banks.device
    if len(rest) != len(_NAMES):
        raise ValueError(f"decode_inter: {2 + len(rest)} tensors, expected "
                         f"{2 + len(_NAMES)}")
    if H % 16 or W % 16 or H <= 0 or W <= 0 or NS < 1:
        raise ValueError(f"decode_inter: picture {W}x{H} is not whole MBs "
                         f"or NS {NS} < 1")
    if banks.dim() != 4 or banks.shape[0] < 1:
        raise ValueError(f"decode_inter: banks must be (NB, 4, H+64, W+64), "
                         f"got {tuple(banks.shape)}")
    shapes = _shapes(banks.shape[0], NS, H, W)
    for name, x in zip(("banks", "cpads", *_NAMES), (banks, cpads, *rest)):
        check_tensor("decode_inter", name, x, shapes[name], _I32, dev)
    out = torch.empty(H * W + 2 * (H // 2) * (W // 2), dtype=_I32,
                      device=dev)
    rc = kernel_fn("decode_inter", "decode_inter", "p" * 25 + "iii" + "pp")(
        banks.data_ptr(), cpads.data_ptr(), *(x.data_ptr() for x in rest),
        H, W, NS, out.data_ptr(), stream_of(banks))
    check_launch(rc, "decode_inter")
    decode_inter.launches += 1
    return out


decode_inter.launches = 0
