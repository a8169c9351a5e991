"""The port's motion-estimation module (h264_tpu_torch.encoder.me) vs the
JAX package's, on the CPU: K10's plain version ``sad_grid_16x16_plain``
against ``me.sad_grid_16x16`` at 176x144 and 32x48 for search ranges 0,
1, 8, 16 and 32 on seeded random, all-0 and all-255 planes (exact
equality); ``compute_sad_grids`` against the reference's; ``mv_bits`` and
``mv_cost`` over every mvd in [-2048, 2048].  K10 itself runs on the card
(test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import me as JME
from h264_tpu_torch.encoder import me as TME
from h264_tpu_torch.kernels import sad_grid as K10

SIZES = [(176, 144), (32, 48)]
RANGES = [0, 1, 8, 16, 32]


def _planes(content, W, H, seed):
    rs = np.random.RandomState(seed)
    if content == "random":
        return rs.randint(0, 256, (H, W)), rs.randint(0, 256, (H, W))
    if content == "zeros":
        return np.zeros((H, W), np.int64), np.zeros((H, W), np.int64)
    # all-255 source against an all-0 reference: every term at its largest
    return np.full((H, W), 255), np.zeros((H, W), np.int64)


@pytest.mark.parametrize("content", ["random", "zeros", "max"])
@pytest.mark.parametrize("R", RANGES)
@pytest.mark.parametrize("W,H", SIZES, ids=lambda v: str(v))
def test_sad_grid_plain_matches_reference(W, H, R, content):
    cur, ref = _planes(content, W, H, seed=W + R)
    ref_p = np.pad(ref.astype(np.int32), R, mode="edge")
    want = np.asarray(JME.sad_grid_16x16(
        jnp.asarray(cur, jnp.int32), jnp.asarray(ref_p, jnp.int32), R))
    got = TME.sad_grid_16x16_plain(torch.as_tensor(cur, dtype=torch.int32),
                                   torch.as_tensor(ref_p), R)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (2 * R + 1, 2 * R + 1,
                                              H // 16, W // 16)
    np.testing.assert_array_equal(got.numpy(), want)
    if content == "max":
        assert int(got.max()) == 255 * 256


@pytest.mark.parametrize("R", [0, 8, 16])
def test_compute_sad_grids_matches_reference(R):
    """The host wrapper (edge padding by R, uploads, one fetch) on uint8
    planes, as the encoder passes them."""
    rs = np.random.RandomState(R)
    cur = rs.randint(0, 256, (144, 176)).astype(np.uint8)
    ref = rs.randint(0, 256, (144, 176)).astype(np.uint8)
    want = JME.compute_sad_grids(cur, ref, R)
    got = TME.compute_sad_grids(cur, ref, R, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    """On CPU tensors the K10 wrapper is the plain version and launches
    nothing."""
    cur = torch.randint(0, 256, (32, 48), dtype=torch.int32)
    ref = torch.randint(0, 256, (32 + 8, 48 + 8), dtype=torch.int32)
    before = K10.sad_grid_16x16.launches
    got = K10.sad_grid_16x16(cur, ref, 4)
    assert K10.sad_grid_16x16.launches == before
    assert torch.equal(got, TME.sad_grid_16x16_plain(cur, ref, 4))


def test_compute_sad_grids_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TME.compute_sad_grids(z, z, 2)


def test_mv_bits_matches_reference():
    d = range(-2048, 2049)
    assert [TME.mv_bits(x) for x in d] == [JME.mv_bits(x) for x in d]


@pytest.mark.parametrize("lam", [0, 1, 65535, 65536, 3 * 65536 + 12345,
                                 1 << 24])
def test_mv_cost_matches_reference(lam):
    rs = np.random.RandomState(lam & 0xFFFF)
    for dx, dy, px, py in rs.randint(-2048, 2049, (500, 4)):
        args = (lam, int(dx), int(dy), int(px), int(py))
        assert TME.mv_cost(*args) == JME.mv_cost(*args)
