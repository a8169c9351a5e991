"""K7 wrapper: temporal direct motion and prediction of a B picture.

Kernel: ``csrc/b_direct.cu`` (replaces the reference's ``encoder/rd.py:
2218-2263 direct_b8`` / ``direct_mb`` with ``:1911 _dynfrac_mc``).  Plain
version: ``encoder.rd_b.b_direct_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.

A call costs its host time more than its kernel's, so the wrapper makes
one combined test of every input's device, dtype, shape and contiguity
(walking the per-tensor checks only to name what failed) and one
allocation: the prediction and the five per-unit fields are views of one
int32 buffer.
"""

from __future__ import annotations

import functools

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_b

b_direct_plain = rd_b.b_direct_plain

_I32 = torch.int32
_NAMES = ("banks0", "banks1", "col_intra4", "col_ref4", "col_mvx4",
          "col_mvy4", "dsf_tab", "eq_tab")


@functools.lru_cache(maxsize=64)
def _spec(shape0, dev):
    """What every input must be, given banks0's shape: a list of (device,
    dtype, shape, contiguous); None when banks0 is no bank of whole MBs."""
    if len(shape0) != 4 or shape0[1] != 4:
        return None
    NR0, _, Hp, Wp = shape0
    H, W = Hp - 64, Wp - 64
    if H % 16 or W % 16 or H <= 0 or W <= 0:
        return None
    if NR0 * 4 * Hp * Wp >= 2 ** 31:  # the kernel's int offsets
        raise ValueError(f"b_direct: banks0 {tuple(shape0)} has 2^31 or "
                         "more samples")
    c4 = torch.Size((H // 4, W // 4))
    shapes = (shape0, (1, 4, Hp, Wp), c4, c4, c4, c4, (NR0,), (NR0,))
    dtypes = (_I32, _I32, torch.bool, _I32, _I32, _I32, _I32, torch.bool)
    return [(dev, dt, torch.Size(s), True) for dt, s in zip(dtypes, shapes)]


def _accepts(ins) -> bool:
    """The combined test: every input is what the kernel takes."""
    spec = _spec(ins[0].shape, ins[0].device)
    try:
        got = [(x.device, x.dtype, x.shape, x.is_contiguous()) for x in ins]
    except AttributeError:  # not a tensor
        return False
    return spec is not None and got == spec


def _reject(ins) -> None:
    """Raise the ValueError that names the first input the kernel does
    not take."""
    banks0 = ins[0]
    if banks0.dim() != 4 or banks0.shape[1] != 4:
        raise ValueError(f"b_direct: banks0 must be (NR0, 4, Hp, Wp), got "
                         f"{tuple(banks0.shape)}")
    NR0, _, Hp, Wp = banks0.shape
    H, W = Hp - 64, Wp - 64
    if H % 16 or W % 16 or H <= 0 or W <= 0:
        raise ValueError(f"b_direct: picture {W}x{H} is not whole MBs")
    for name, x, (dev, dt, shape, _) in zip(_NAMES, ins,
                                            _spec(banks0.shape,
                                                  banks0.device)):
        check_tensor("b_direct", name, x, shape, dt, dev)
    raise ValueError("b_direct: inputs rejected")


def b_direct(banks0, banks1, col_intra4, col_ref4, col_mvx4, col_mvy4,
             dsf_tab, eq_tab):
    """banks0 (NR0, 4, Hp, Wp), banks1 (1, 4, Hp, Wp), the colocated
    snapshot (4 n_my, 4 n_mx) (intra bool, ref/mvx/mvy int32), dsf_tab
    (NR0,) int32, eq_tab (NR0,) bool -> pred (n_mb, 16, 16) and idx, l0x,
    l0y, l1x, l1y (n_mb, 4), int32."""
    if banks0.device.type == "cpu":
        return b_direct_plain(banks0, banks1, col_intra4, col_ref4, col_mvx4,
                              col_mvy4, dsf_tab, eq_tab)
    ins = (banks0, banks1, col_intra4, col_ref4, col_mvx4, col_mvy4,
           dsf_tab, eq_tab)
    if not _accepts(ins):
        _reject(ins)
    NR0, _, Hp, Wp = banks0.shape
    n_mb = (Hp - 64) // 16 * ((Wp - 64) // 16)
    out = torch.empty((69, n_mb, 4), dtype=_I32, device=banks0.device)
    rc = kernel_fn("b_direct", "b_direct", "p" * 8 + "iii" + "pp")(
        *(x.data_ptr() for x in ins), NR0, Hp, Wp, out.data_ptr(),
        stream_of(banks0))
    check_launch(rc, "b_direct")
    b_direct.launches += 1
    return (out[:64].view(n_mb, 16, 16), *out[64:].unbind())


b_direct.launches = 0
