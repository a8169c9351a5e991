"""K11 wrapper: one picture's step of the loss-aware RDO's simulated
decoders.

Kernel: ``csrc/propagate_drift.cu`` (replaces the reference's
``encoder/lossaware.py:35`` ``propagate_drift``).  Plain version:
``encoder.lossaware.propagate_drift_plain``.  CPU tensors run the plain
version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import (check_aligned, check_launch, check_tensor, kernel_fn,
                      stream_of)
from ..encoder.lossaware import propagate_drift_plain

_I32 = torch.int32


def propagate_drift(drift, frame_delta, mv4, intra4, lost):
    """drift (K, H, W) int32, frame_delta (H, W) int32, mv4 (H/4, W/4, 2)
    int32 quarter-pel (x, y), intra4 (H/4, W/4) bool, lost (K,) bool ->
    (new drift (K, H, W) int32, penalty (n_mb,) int32)."""
    if drift.device.type == "cpu":
        return propagate_drift_plain(drift, frame_delta, mv4, intra4, lost)
    dev = drift.device
    if (drift.dim() != 3 or drift.shape[0] < 1 or drift.shape[1] % 16
            or drift.shape[2] % 16):
        raise ValueError("propagate_drift: drift must be (K, H, W) whole "
                         f"MBs with K >= 1, got {tuple(drift.shape)}")
    K, H, W = drift.shape
    fn = "propagate_drift"
    check_tensor(fn, "drift", drift, (K, H, W), _I32, dev)
    check_tensor(fn, "frame_delta", frame_delta, (H, W), _I32, dev)
    check_tensor(fn, "mv4", mv4, (H // 4, W // 4, 2), _I32, dev)
    check_tensor(fn, "intra4", intra4, (H // 4, W // 4), torch.bool, dev)
    check_tensor(fn, "lost", lost, (K,), torch.bool, dev)
    for name, x in (("drift", drift), ("frame_delta", frame_delta),
                    ("mv4", mv4)):  # read in 16- and 8-byte loads
        check_aligned(fn, name, x)
    new = torch.empty_like(drift)
    pen = torch.empty((H // 16) * (W // 16), dtype=_I32, device=dev)
    rc = kernel_fn("propagate_drift", "propagate_drift", "pppppiiippp")(
        drift.data_ptr(), frame_delta.data_ptr(), mv4.data_ptr(),
        intra4.data_ptr(), lost.data_ptr(), K, H, W, new.data_ptr(),
        pen.data_ptr(), stream_of(drift))
    check_launch(rc, fn)
    propagate_drift.launches += 1
    return new, pen


propagate_drift.launches = 0
