"""Loss-aware RDO: K simulated lossy decoders carried as drift on the card.

The PyTorch counterpart of the reference package's encoder/lossaware.py,
its reshaping of lencod's error-resilient mode decision
(lencod/src/md_highloss.c:39 encode_one_macroblock_highloss with the
NumberOfDecoders simulated decoders of lencod/src/decoder.c, UpdateDecoders
:353, Build_Status_Map :444): each simulated decoder keeps its DRIFT (its
reference minus the true reference), carried from picture to picture by
one device step:

    drift_k' = lost_k ? drift_k + (true_prev - true_cur)   (frame-copy
                                                            concealment)
             : intra 4x4 block ? 0
             : drift_k moved by the picture's integer MVs

The per-MB mean drift energy over the K decoders is the expected extra
distortion of inter prediction under loss; the P pipeline adds it to every
inter candidate's J (``rd_p.p_decide``, ``drift_pen``).  K and the loss
rate are NumberOfDecoders and LossRateA (bin/encoder.cfg:260).

The step runs as kernel K11 (``kernels/propagate_drift.py``,
``csrc/propagate_drift.cu``); ``propagate_drift_plain`` below is its plain
version, and the CPU path.
"""

from __future__ import annotations

import numpy as np
import torch

from .rd import I32, wrap_i32

_PEN_MAX = float(2 ** 30)


def drift_energy(new):
    """Per-MB penalty of drift `new` (K, H, W) int32 -> (n_mb,) int32: the
    mean over the K decoders of each MB's sum of float32(new * new) (the
    square wraps as int32), min 2^30, truncated to int32.

    The float32 sum follows the order of the reference's program as XLA
    compiles it for the CPU (one fused reduction over the decoder and the
    MB's rows and columns, vectorized over 8 rows; found by reading the
    compiled program and held against it in tests/test_torch_lossaware.py):
    per MB one total runs through the decoders in order; for decoder k,
    lane l of 8 adds, column by column, the samples of row l and then of row
    l + 8, lane 0 starting from the total and the others from -0.0; the
    lanes then fold in halves ((l, l+4), then (l, l+2), then (0, 1)) into
    the new total.  The mean is the total times float32(1 / K)."""
    K, H, W = new.shape
    n_my, n_mx = H // 16, W // 16
    n_mb = n_my * n_mx
    x = new.to(torch.int64)
    e = wrap_i32(x * x).to(torch.float32)
    e = e.reshape(K, n_my, 16, n_mx, 16).permute(1, 3, 0, 2, 4).reshape(
        n_mb, K, 16, 16)
    # the 32 terms of each lane: row l's 16 columns, then row l + 8's
    terms = torch.cat([e[:, :, :8], e[:, :, 8:]], 3)  # (n_mb, K, 8, 32)
    lanes = torch.full((n_mb, K, 8), -0.0, dtype=torch.float32,
                       device=new.device)
    for t in range(32):  # lanes 1..7 of every decoder at once
        lanes = lanes + terms[..., t]
    total = torch.zeros(n_mb, dtype=torch.float32, device=new.device)
    for k in range(K):  # lane 0 carries the total through the decoders
        v0 = total
        for t in range(32):
            v0 = v0 + terms[:, k, 0, t]
        v = torch.cat([v0[:, None], lanes[:, k, 1:]], 1)
        v = v[:, :4] + v[:, 4:]
        v = v[:, :2] + v[:, 2:]
        total = v[:, 0] + v[:, 1]
    inv_k = torch.tensor(np.float32(1.0) / np.float32(K),
                         device=new.device)
    pen = torch.clamp(total * inv_k, max=_PEN_MAX)
    return pen.clamp(min=-float(2 ** 31)).to(I32)


def propagate_drift_plain(drift, frame_delta, mv4, intra4, lost):
    """One picture's step for all K simulated decoders (the reference's
    lossaware.py:35-66).

    drift (K, H, W) int32: each decoder's reference minus the true one;
    frame_delta (H, W) int32: true previous minus true current recon;
    mv4 (H/4, W/4, 2) int32 quarter-pel list-0 MVs (x, y); intra4
    (H/4, W/4) bool; lost (K,) bool: this picture's slice lost in decoder
    k.  Returns (new drift (K, H, W) int32, the next picture's penalty
    (n_mb,) int32: ``drift_energy`` of the new drift)."""
    K, H, W = drift.shape
    dev = drift.device
    mv4 = mv4.to(I32)
    mvx = mv4[..., 0].repeat_interleave(4, 0).repeat_interleave(4, 1)
    mvy = mv4[..., 1].repeat_interleave(4, 0).repeat_interleave(4, 1)
    ys = torch.arange(H, dtype=I32, device=dev)[:, None]
    xs = torch.arange(W, dtype=I32, device=dev)[None, :]
    # nearest-pel gather (arithmetic shift), clamped into the picture
    gy = (ys + ((mvy + 2) >> 2)).clamp(0, H - 1).long()
    gx = (xs + ((mvx + 2) >> 2)).clamp(0, W - 1).long()
    intra = intra4.to(torch.bool).repeat_interleave(4, 0).repeat_interleave(
        4, 1)
    received = torch.where(intra, 0, drift[:, gy, gx])
    copied = wrap_i32(drift.to(torch.int64) + frame_delta.to(torch.int64))
    new = torch.where(lost.to(torch.bool)[:, None, None], copied, received)
    return new.to(I32).contiguous(), drift_energy(new)


class LossSimulator:
    """The host driver of the simulated decoder bank (one per encoder;
    the reference's lossaware.py:69-99).  The loss draws come from its own
    ``np.random.RandomState(seed)``, K uniforms per picture, not re-seeded
    by ``reset``; the drift bank lives on `device`.  ``step`` is the
    propagation (the K11 wrapper by default; its plain version runs CPU
    tensors)."""

    def __init__(self, k: int, loss_rate: float, H: int, W: int,
                 seed: int = 17, device=None, step=None):
        if step is None:
            from ..kernels.propagate_drift import propagate_drift as step
        self.k = k
        self.loss_rate = loss_rate
        self.H, self.W = H, W
        self.device = torch.device("cpu" if device is None else device)
        self.step = step
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.drift = torch.zeros((self.k, self.H, self.W), dtype=I32,
                                 device=self.device)
        self.pen = None  # (n_mb,) int32: the next P picture's penalty
        self._prev_recon = None

    def after_frame(self, recon_y, mv4, intra4):
        """Advance the bank past a coded P picture: recon_y (H, W) int32,
        its true reconstruction; mv4 (H/4, W/4, 2) and intra4 (H/4, W/4),
        its final motion and intra blocks, all on the device."""
        lost = torch.as_tensor(self.rng.rand(self.k) < self.loss_rate,
                               device=self.device)
        if self._prev_recon is None:
            delta = torch.zeros((self.H, self.W), dtype=I32,
                                device=self.device)
        else:
            delta = self._prev_recon - recon_y
        self.drift, self.pen = self.step(self.drift, delta.contiguous(),
                                         mv4.contiguous(),
                                         intra4.contiguous(), lost)
        self._prev_recon = recon_y
