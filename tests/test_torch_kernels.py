"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest -q --noconftest -o "markers=gpu: needs a CUDA card" \
        -m gpu tests/test_torch_kernels.py

(the CPU side of each kernel is held against the JAX package by
test_torch_intra.py, test_torch_bank.py, test_torch_encode.py and the
test_torch_p_*.py files)."""

import numpy as np
import pytest
import torch

from h264_tpu_torch.encoder import rd, rd_p
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.kernels import deblock as K6
from h264_tpu_torch.kernels import inter_tq as K5
from h264_tpu_torch.kernels import intra_commit as K1
from h264_tpu_torch.kernels import qpel as K4
from h264_tpu_torch.kernels import ref_bank as K2
from h264_tpu_torch.kernels import search_grid as K3
from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames

pytestmark = pytest.mark.gpu

OUTS = "ry ru rv lev lum_dc i16mode cip levc dcc i4flag ipm".split()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lam(qp):
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


# (width, height): one MB column / row, small, QCIF, CIF
SIZES = [(16, 64), (64, 16), (64, 48), (176, 144), (352, 288)]


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("W,H", SIZES, ids=lambda v: str(v))
def test_intra_commit_matches_plain(cuda, W, H, qp):
    Y, U, V = (torch.as_tensor(p, device=cuda)
               for p in synthetic_frames(1, W, H, seed=W + H)[0])
    args = (Y, U, V, qp, chroma_qp(qp, 0), _lam(qp), H, W)
    before = K1.intra_commit_step.launches
    got = rd.rd_i_pipeline(*args, device=cuda)
    assert K1.intra_commit_step.launches > before
    want = rd.rd_i_pipeline(*args, device=cuda,
                            impl=K1.intra_commit_step_plain)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


def test_intra_commit_inter_copy_through(cuda):
    """The P/B form of the scan, with half the MBs inter."""
    W, H, qp = 176, 144, 30
    n_mb = (H // 16) * (W // 16)
    rng = np.random.RandomState(4)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a, device=cuda).to(dtype)

    Y, U, V = (t(p) for p in synthetic_frames(1, W, H, seed=3)[0])
    args = (Y, U, V, t(rng.randint(0, 256, (n_mb, 16, 16))),
            t(rng.randint(0, 256, (n_mb, 2, 8, 8))),
            t(rng.rand(n_mb) < 0.5, torch.bool),
            t(rng.randint(-3, 4, (n_mb, 4, 4, 4, 4))),
            t(rng.randint(-2, 3, (n_mb, 2, 2, 2, 4, 4))),
            t(rng.randint(-5, 6, (n_mb, 2, 2, 2))))
    kw = dict(H=H, W=W, qp=qp, qp_c=chroma_qp(qp, 0), lam=_lam(qp))
    got = rd._intra_commit_scan(*args, **kw)
    want = rd._intra_commit_scan(*args, **kw, impl=K1.intra_commit_step_plain)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("W,H", [(16, 16), (64, 48), (352, 288),
                                 (1280, 720)], ids=lambda v: str(v))
def test_ref_bank_matches_plain(cuda, W, H):
    rng = np.random.RandomState(W)
    Y, U, V = (torch.as_tensor(rng.randint(0, 256, s), dtype=torch.int32,
                               device=cuda)
               for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    before = K2.ref_bank.launches
    got = K2.ref_bank(Y, U, V)
    assert K2.ref_bank.launches == before + 1
    for g, w in zip(got, K2.ref_bank_plain(Y, U, V)):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_input(cuda):
    Y = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    U = torch.zeros((16, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K2.ref_bank(Y.float(), U, U)
    with pytest.raises(ValueError):
        K2.ref_bank(Y, U.t()[:, :8], U)
    s = rd._scan_start(Y, U, U, *(torch.zeros(4, 16, 16, dtype=torch.int32,
                                              device=cuda),
                                  torch.zeros(4, 2, 8, 8, dtype=torch.int32,
                                              device=cuda),
                                  torch.ones(4, dtype=torch.int32,
                                             device=cuda)),
                       torch.zeros(4, 4, 4, 4, 4, dtype=torch.int32, device=cuda),
                       torch.zeros(4, 2, 2, 2, 4, 4, dtype=torch.int32,
                                   device=cuda),
                       torch.zeros(4, 2, 2, 2, dtype=torch.int32, device=cuda),
                       32, 32, 28, 28, 0)
    with pytest.raises(ValueError, match="is_intra"):
        K1.intra_commit_step(s, 0)


def test_encoder_on_card_matches_cpu(cuda):
    frames = synthetic_frames(2, 176, 144, seed=8)
    cfg = EncoderConfig(width=176, height=144, qp=30, fast=True,
                        entropy="cabac", idr_period=1)
    on_card = H264Encoder(cfg).encode_sequence(frames)
    on_cpu = H264Encoder(cfg, device="cpu").encode_sequence(frames)
    assert on_card == on_cpu


# ---------------------------------------------------------------------------
# P picture kernels (K3-K6) on the real intermediate tensors of P pictures
# ---------------------------------------------------------------------------

def _ippp_cfg(W, H, qp, wp, nref=2, sr=8):
    return EncoderConfig(width=W, height=H, qp=qp, fast=True, rd=True,
                         entropy="cabac", num_ref_frames=nref,
                         search_range=sr, weighted_pred=wp)


_CALLS: dict = {}


def _p_calls(dev, W, H, qp, wp):
    """Every P-entry call of a 1 I + 2 P encode through the plain path on
    the card, as (name, args)."""
    key = (W, H, qp, wp)
    if key not in _CALLS:
        enc = H264Encoder(_ippp_cfg(W, H, qp, wp), device=dev)
        enc._p_kernels, calls = rd_p.recording(rd_p.PLAIN)
        list(enc.encode_stream(moving_frames(3, W, H, seed=W + qp)))
        _CALLS[key] = calls
    return _CALLS[key]


@pytest.mark.parametrize("wp", [True, False], ids=["wp", "nowp"])
@pytest.mark.parametrize("qp", [28, 51])
@pytest.mark.parametrize("W,H", [(176, 144), (352, 288)], ids=lambda v: str(v))
def test_p_kernels_match_plain(cuda, W, H, qp, wp):
    kern = rd_p.default_kernels()
    calls = _p_calls(cuda, W, H, qp, wp)
    seen = set()
    for name, args in calls:
        before = getattr(kern, name).launches
        got = getattr(kern, name)(*args)
        assert getattr(kern, name).launches == before + 1, name
        want = getattr(rd_p.PLAIN, name)(*args)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and torch.equal(g, w), f"{name} out {i}"
        seen.add(name)
    assert seen == set(rd_p.P_ENTRIES)


def test_p_wrappers_reject_bad_input(cuda):
    calls = dict(_p_calls(cuda, 176, 144, 28, True))
    banks, cur_y, wp, lam_me = calls["coarse_search"]
    with pytest.raises(ValueError):
        K3.coarse_search(banks.float(), cur_y, wp, lam_me)
    with pytest.raises(ValueError):
        K3.coarse_search(banks, cur_y[:, :160], wp, lam_me)
    with pytest.raises(ValueError):
        K3.ssd_grid8(banks, cur_y, *calls["ssd_grid8"][2:5], 40)
    a = calls["qpel_refine"]
    with pytest.raises(ValueError):
        K4.qpel_refine(*a[:2], a[2][::2], *a[3:])
    with pytest.raises(ValueError):
        K4.mc_chroma(*calls["mc_chroma"][:1], calls["mc_chroma"][1].t(),
                     *calls["mc_chroma"][2:])
    pred, orig, qp, lam = calls["inter_luma_tq"]
    with pytest.raises(ValueError):
        K5.inter_luma_tq(pred, orig[:-1], qp, lam)
    with pytest.raises(ValueError):
        K5.inter_chroma_tq(*calls["inter_chroma_tq"][:2], 60, lam)
    nz4, *rest = calls["strengths"]
    with pytest.raises(ValueError):
        K6.strengths(nz4.to(torch.int32), *rest)
    y, u, v, bsv, bsh, qp, qpc = calls["deblock"]
    with pytest.raises(ValueError):
        K6.deblock(y, u, v.cpu(), bsv, bsh, qp, qpc)


@pytest.mark.parametrize("wp", [True, False], ids=["wp", "nowp"])
def test_ippp_encoder_on_card_matches_cpu(cuda, wp):
    frames = moving_frames(5, 176, 144, seed=8)
    cfg = _ippp_cfg(176, 144, 30, wp)
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)
    for ea, eb in zip(card._rd_refs, cpu._rd_refs):
        assert ea[0] == eb[0]
        for x, y in zip((*ea[1:3], *ea[3]), (*eb[1:3], *eb[3])):
            assert torch.equal(x.cpu(), y)
