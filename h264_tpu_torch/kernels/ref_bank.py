"""K2 wrappers: the reference-bank entry of one reconstructed picture
(``ref_bank``) and of one row slab (``ref_bank_rows``).

Kernel: ``csrc/ref_bank.cu`` (replaces the reference's
``encoder/rd.py:101 ref_entry_from_planes`` / ``:113 _bank_from_pad``,
and the sharded GOP encoder's ``bank_of``, ``:2662-2672``).  Plain
versions: ``encoder.rd.ref_entry_plain`` and ``ref_bank_rows_plain``.
CPU tensors run the plain version; CUDA tensors launch the kernel (one
launch over output tiles staged in shared memory), or raise.
"""

from __future__ import annotations

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd

ref_bank_plain = rd.ref_entry_plain
ref_bank_rows_plain = rd.ref_bank_rows_plain


def _check_size(fn: str, Hp: int, Wp: int) -> None:
    """The kernel's offsets are int: refuse a bank of 2^31 samples."""
    if 4 * Hp * Wp >= 2 ** 31:
        raise ValueError(f"{fn}: a ({Hp}, {Wp}) bank has 2^31 or more "
                         "samples")


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
    _check_size("ref_bank", H + 2 * P, W + 2 * P)
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


def ref_bank_rows(extY: torch.Tensor, extU: torch.Tensor,
                  extV: torch.Tensor):
    """int32 row slabs extY (Hs, W), extU/extV (Hcs, W/2) on one device,
    their rows given (Hs = Hg + 64, Hcs = Hg/2 + 64) -> (bank (4, Hs,
    W+64), cpad (2, Hcs, W/2+64)) int32, the columns edge-padded."""
    if extY.device.type == "cpu":
        return ref_bank_rows_plain(extY, extU, extV)
    Hs, W = extY.shape
    Hcs = extU.shape[0]
    for name, x, shape in (("extY", extY, (Hs, W)),
                           ("extU", extU, (Hcs, W // 2)),
                           ("extV", extV, (Hcs, W // 2))):
        check_tensor("ref_bank_rows", name, x, shape, torch.int32,
                     extY.device)
    if W % 2 or Hs < 6 or Hcs < 1:
        raise ValueError(f"ref_bank_rows: slab sizes {Hs}x{W}, {Hcs} chroma "
                         "rows")
    P = rd.PAD
    _check_size("ref_bank_rows", Hs, W + 2 * P)
    bank = torch.empty((4, Hs, W + 2 * P), dtype=torch.int32,
                       device=extY.device)
    cpad = torch.empty((2, Hcs, W // 2 + 2 * P), dtype=torch.int32,
                       device=extY.device)
    rc = kernel_fn("ref_bank", "ref_bank_rows", "pppppiiip")(
        extY.data_ptr(), extU.data_ptr(), extV.data_ptr(), bank.data_ptr(),
        cpad.data_ptr(), Hs, Hcs, W, stream_of(extY))
    check_launch(rc, "ref_bank_rows")
    ref_bank_rows.launches += 1
    return bank, cpad


ref_bank_rows.launches = 0
