"""Loss-aware RDO in the port (h264_tpu_torch.encoder.lossaware) vs the JAX
package, on the CPU, live against the reference's jitted
``propagate_drift``:

- ``propagate_drift_plain`` (K11's plain version) on the built inputs of
  tools/drift_cases.py at 48x32 and 176x144 with K 1, 3 and 8: |drift| to
  4095 (MB sums past 2^24, where the float32 order shows) and to 60000
  (wrapping squares), gathers clipped on every side, all and none lost,
  all intra; new drift and penalty equal;
- ``LossSimulator`` driven for 6 pictures, with a reset after the third,
  by the same recon / motion / intra inputs on both sides: drift, penalty
  and the loss draws (the generator's state) equal after every picture;
- the encoder refusing loss-aware RDO off the RD path, as the reference.

The error-resilient encodes are in test_torch_er.py; K11 itself on the
card in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import lossaware as JLA
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder import lossaware as TLA
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.drift_cases import CASES, built_case, clipped_sides

torch.set_num_threads(1)


def _jax(args, H, W):
    new, pen = JLA.propagate_drift(*(jnp.asarray(a) for a in args), H=H,
                                   W=W)
    return np.asarray(new), np.asarray(pen)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("H,W", [(32, 48), (144, 176)], ids=lambda v: str(v))
def test_propagate_drift_plain_equals_reference(H, W, K, case):
    args = built_case(case, H, W, K, seed=3)
    want_new, want_pen = _jax(args, H, W)
    new, pen = TLA.propagate_drift_plain(*(torch.as_tensor(a) for a in args))
    assert new.dtype == pen.dtype == torch.int32
    np.testing.assert_array_equal(new.numpy(), want_new)
    np.testing.assert_array_equal(pen.numpy(), want_pen)
    if case == "edges":
        assert min(clipped_sides(args[2], H, W).values()) > 0
    if case == "large":
        # the MB sums pass 2^24: the penalty is not the exact mean, so the
        # order of the float32 additions decides it
        e = want_new.astype(np.float64) ** 2
        exact = e.reshape(K, H // 16, 16, W // 16, 16).sum((0, 2, 4)) / K
        assert (np.abs(exact.reshape(-1) - want_pen) > 1).any()
        assert want_pen.max() < 2 ** 30
    if case == "wrap":
        assert (np.abs(want_new) > 46340).any()


def test_loss_simulator_equals_reference():
    H, W, K = 48, 64, 3
    rng = np.random.default_rng(7)
    jsim = JLA.LossSimulator(K, 0.5, H, W)
    tsim = TLA.LossSimulator(K, 0.5, H, W, device="cpu")
    assert tsim.pen is None and tsim.drift.shape == (K, H, W)
    for i in range(6):
        if i == 3:  # an IDR: the bank resets, the draws go on
            jsim.reset()
            tsim.reset()
        recon = rng.integers(0, 256, (H, W)).astype(np.int32)
        mv4 = rng.integers(-64, 65, (H // 4, W // 4, 2)).astype(np.int32)
        intra4 = rng.random((H // 4, W // 4)) < 0.1
        jsim.after_frame(jnp.asarray(recon), jnp.asarray(mv4),
                         jnp.asarray(intra4))
        tsim.after_frame(torch.as_tensor(recon), torch.as_tensor(mv4),
                         torch.as_tensor(intra4))
        np.testing.assert_array_equal(tsim.drift.numpy(),
                                      np.asarray(jsim.drift))
        np.testing.assert_array_equal(tsim.pen.numpy(), np.asarray(jsim.pen))
        js, ts = jsim.rng.get_state(), tsim.rng.get_state()
        assert js[2:] == ts[2:] and np.array_equal(js[1], ts[1])
    assert int(np.abs(np.asarray(jsim.drift)).max()) > 0


def test_loss_aware_rdo_needs_the_rd_path():
    base = dict(width=64, height=48, loss_aware_k=2)
    with pytest.raises(AssertionError, match="RD path"):
        JaxEncoder(JaxConfig(**base))
    with pytest.raises(ValueError, match="RD path"):
        H264Encoder(EncoderConfig(**base), device="cpu")
    enc = H264Encoder(EncoderConfig(fast=True, **base), device="cpu")
    assert enc._lsim.k == 2 and enc._lsim.loss_rate == 0.1
