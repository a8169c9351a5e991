"""K9 wrapper: the FRExt transform-size decision of a P picture.

Kernel: ``csrc/t8.cu`` (replaces the reference's ``encoder/rd.py:1071-1113``,
the T8 stage of ``rd_p_pipeline``).  Plain version:
``encoder.rd_p.t8_decide_plain``.  CPU tensors run the plain version; CUDA
tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from ..device import (check_aligned, check_launch, check_tensor, kernel_fn,
                      stream_of)
from ..encoder import rd_p

t8_decide_plain = rd_p.t8_decide_plain

_I32 = torch.int32


def t8_decide(orig_mb, w_pred, w_rec, w_lev, win, w_sub, is_intra, qp: int,
              lam: int):
    """orig_mb/w_pred/w_rec (n_mb, 16, 16), w_lev (n_mb, 4, 4, 4, 4), win
    (n_mb,), w_sub (n_mb, 4), int32; is_intra (n_mb,) bool -> (w_t8
    (n_mb,), w_lev8 (n_mb, 2, 2, 8, 8), w_lev, w_rec), int32."""
    if orig_mb.device.type == "cpu":
        return t8_decide_plain(orig_mb, w_pred, w_rec, w_lev, win, w_sub,
                               is_intra, qp, lam)
    dev = orig_mb.device
    n_mb = orig_mb.shape[0]
    for name, x, shape, dt in (
            ("orig_mb", orig_mb, (n_mb, 16, 16), _I32),
            ("w_pred", w_pred, (n_mb, 16, 16), _I32),
            ("w_rec", w_rec, (n_mb, 16, 16), _I32),
            ("w_lev", w_lev, (n_mb, 4, 4, 4, 4), _I32),
            ("win", win, (n_mb,), _I32), ("w_sub", w_sub, (n_mb, 4), _I32),
            ("is_intra", is_intra, (n_mb,), torch.bool)):
        check_tensor("t8_decide", name, x, shape, dt, dev)
        if dt == _I32 and name != "win":  # read in 16-byte loads
            check_aligned("t8_decide", name, x)
    if not 0 <= int(qp) <= 51:
        raise ValueError(f"t8_decide: qp {qp} outside 0..51")
    t8 = torch.empty(n_mb, dtype=_I32, device=dev)
    lev8 = torch.empty((n_mb, 2, 2, 8, 8), dtype=_I32, device=dev)
    lev = torch.empty_like(w_lev)
    rec = torch.empty_like(w_rec)
    rc = kernel_fn("t8", "t8_decide", "ppppppp" + "iii" + "ppppp")(
        orig_mb.data_ptr(), w_pred.data_ptr(), w_rec.data_ptr(),
        w_lev.data_ptr(), win.data_ptr(), w_sub.data_ptr(),
        is_intra.data_ptr(), n_mb, int(qp), int(lam), t8.data_ptr(),
        lev8.data_ptr(), lev.data_ptr(), rec.data_ptr(), stream_of(orig_mb))
    check_launch(rc, "t8_decide")
    t8_decide.launches += 1
    return t8, lev8, lev, rec


t8_decide.launches = 0
