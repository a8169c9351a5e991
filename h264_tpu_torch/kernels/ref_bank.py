"""K2 wrapper: the reference-bank entry of one reconstructed picture.

Kernel: ``csrc/ref_bank.cu`` (replaces the reference's
``encoder/rd.py:101 ref_entry_from_planes`` / ``:113 _bank_from_pad``).
Plain version: ``encoder.rd.ref_entry_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd

ref_bank_plain = rd.ref_entry_plain


def ref_bank(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor):
    """int32 recon planes Y (H, W), U/V (H/2, W/2) on one device ->
    (bank (4, H+64, W+64), cpad (2, H/2+64, W/2+64)) int32."""
    if Y.device.type == "cpu":
        return ref_bank_plain(Y, U, V)
    H, W = Y.shape
    for name, x, shape in (("Y", Y, (H, W)), ("U", U, (H // 2, W // 2)),
                           ("V", V, (H // 2, W // 2))):
        check_tensor("ref_bank", name, x, shape, torch.int32, Y.device)
    if H % 2 or W % 2:
        raise ValueError(f"ref_bank: odd picture size {H}x{W}")
    P = rd.PAD
    bank = torch.empty((4, H + 2 * P, W + 2 * P), dtype=torch.int32,
                       device=Y.device)
    cpad = torch.empty((2, H // 2 + 2 * P, W // 2 + 2 * P), dtype=torch.int32,
                       device=Y.device)
    rc = kernel_fn("ref_bank", "ref_bank", "pppppiip")(
        Y.data_ptr(), U.data_ptr(), V.data_ptr(), bank.data_ptr(),
        cpad.data_ptr(), H, W, stream_of(Y))
    check_launch(rc, "ref_bank")
    ref_bank.launches += 1
    return bank, cpad


ref_bank.launches = 0
