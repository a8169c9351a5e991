"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest -q --noconftest -o "markers=gpu: needs a CUDA card" \
        -m gpu tests/test_torch_kernels.py

(the CPU side of each kernel is held against the JAX package by
test_torch_intra.py, test_torch_bank.py, test_torch_encode.py, the
test_torch_p_*.py and test_torch_b_*.py files, and for K8
test_torch_decode_ops.py and test_torch_decode.py)."""

import pathlib

import numpy as np
import pytest
import torch

from h264_tpu_torch.decoder import device as DEV
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder import rd, rd_b, rd_p
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.kernels import b_direct as K7
from h264_tpu_torch.kernels import deblock as K6
from h264_tpu_torch.kernels import decode_inter as K8
from h264_tpu_torch.kernels import inter_tq as K5
from h264_tpu_torch.kernels import intra_commit as K1
from h264_tpu_torch.kernels import qpel as K4
from h264_tpu_torch.kernels import ref_bank as K2
from h264_tpu_torch.kernels import search_grid as K3
from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.tools.decode_cases import NS as DEC_NS
from h264_tpu_torch.tools.decode_cases import built_cases
from h264_tpu_torch.tools.strengths_cases import (strengths_b_branches,
                                                  strengths_b_inputs)
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


# ---------------------------------------------------------------------------
# B picture kernels (K7, mc_luma_win, mc_chroma_b, strengths_b, and the
# K3-K6 entries B pictures share) on the real tensors of B pictures
# ---------------------------------------------------------------------------

def _ipb_cfg(W, H, qp, hier=False):
    return EncoderConfig(width=W, height=H, qp=qp, fast=True, rd=True,
                         entropy="cabac", b_frames=3 if hier else 1,
                         b_hierarchy=hier, num_ref_frames=2, search_range=8,
                         weighted_pred=True)


_B_CALLS: dict = {}


def _b_calls(dev, W, H, qp, hier=False):
    """Every B-entry call of a short IPB encode through the plain path on
    the card, as (name, args)."""
    key = (W, H, qp, hier)
    if key not in _B_CALLS:
        enc = H264Encoder(_ipb_cfg(W, H, qp, hier), device=dev)
        enc._b_kernels, calls = rd_b.recording(rd_b.PLAIN)
        list(enc.encode_stream(moving_frames(5, W, H, seed=W + qp)))
        _B_CALLS[key] = calls
    return _B_CALLS[key]


def _hold(kern, name, args):
    before = getattr(kern, name).launches if name in rd_b.B_OWN else None
    got = getattr(kern, name)(*args)
    if before is not None:
        assert getattr(kern, name).launches == before + 1, name
    want = getattr(rd_b.PLAIN, name)(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{name} out {i}"


@pytest.mark.parametrize("hier", [False, True], ids=["ipb", "hier"])
@pytest.mark.parametrize("qp", [28, 49])  # B pictures at QP 30 and 51
@pytest.mark.parametrize("W,H", [(176, 144), (352, 288)], ids=lambda v: str(v))
def test_b_kernels_match_plain(cuda, W, H, qp, hier):
    kern = rd_b.default_kernels()
    calls = _b_calls(cuda, W, H, qp, hier)
    for name, args in calls:
        _hold(kern, name, args)
    assert {n for n, _ in calls} == set(rd_b.B_ENTRIES)


def test_b_kernels_with_far_motion_match_plain(cuda):
    """Direct, windowed luma and chroma MC with mvs of up to +-90 pel:
    windows that start outside the banks are placed as the reference's
    dynamic_slice places them, in the kernel as in the plain version."""
    kern = rd_b.default_kernels()
    first = {}
    for name, a in _b_calls(cuda, 176, 144, 28):
        first.setdefault(name, a)
    rng = np.random.RandomState(9)

    def far(t):
        return torch.as_tensor(rng.randint(-360, 361, tuple(t.shape)),
                               dtype=torch.int32, device=cuda)

    b0, b1, ci, cr, cmx, cmy, dsf, eq = first["b_direct"]
    _hold(kern, "b_direct", (b0, b1, torch.zeros_like(ci), cr, far(cmx),
                             far(cmy), dsf, eq))
    banks, ref, mvx, mvy, y0, x0, h, w = first["mc_luma_win"]
    _hold(kern, "mc_luma_win", (banks, ref, far(mvx), far(mvy), y0, x0, h, w))
    for hh, ww in ((8, 8), (16, 16), (4, 8)):
        n = 300
        yy = torch.as_tensor(rng.randint(0, (144 - hh) // 4 + 1, n) * 4,
                             dtype=torch.int32, device=cuda)
        xx = torch.as_tensor(rng.randint(0, (176 - ww) // 4 + 1, n) * 4,
                             dtype=torch.int32, device=cuda)
        rr = torch.as_tensor(rng.randint(0, banks.shape[0], n),
                             dtype=torch.int32, device=cuda)
        _hold(kern, "mc_luma_win", (banks, rr, far(rr), far(rr), yy, xx, hh,
                                    ww))
    c0, c1, idx0, m0x, m0y, m1x, m1y, u0, u1 = first["mc_chroma_b"]
    _hold(kern, "mc_chroma_b", (c0, c1, idx0, far(m0x), far(m0y), far(m1x),
                                far(m1y), u0, u1))


@pytest.mark.parametrize("H4,W4", [(72, 88), (180, 320)])
def test_strengths_b_every_branch_matches_plain(cuda, H4, W4):
    """strengths_b on built inputs that take every branch of the pairing
    rule (crossed and same-ref pairs, which a real IPB stream never
    has), at CIF and 1280x720."""
    args = strengths_b_inputs(H4, W4, seed=H4 + W4, device=cuda)
    assert min(strengths_b_branches(args).values()) > 0
    _hold(rd_b.default_kernels(), "strengths_b", args)


def test_b_wrappers_reject_bad_input(cuda):
    first = {}
    for name, a in _b_calls(cuda, 176, 144, 28):
        first.setdefault(name, a)
    b0, b1, ci, cr, cmx, cmy, dsf, eq = first["b_direct"]
    with pytest.raises(ValueError):
        K7.b_direct(b0, b0, ci, cr, cmx, cmy, dsf, eq)  # list 1 is one bank
    with pytest.raises(ValueError):
        K7.b_direct(b0, b1, ci.to(torch.int32), cr, cmx, cmy, dsf, eq)
    banks, ref, mvx, mvy, y0, x0, h, w = first["mc_luma_win"]
    with pytest.raises(ValueError):
        K4.mc_luma_win(banks, ref[:-1], mvx, mvy, y0, x0, h, w)
    c0, c1, idx0, *rest = first["mc_chroma_b"]
    with pytest.raises(ValueError):
        K4.mc_chroma_b(c0, c1, idx0[:-1], *(r[:-1] for r in rest))
    args = first["strengths_b"]
    with pytest.raises(ValueError):
        K6.strengths_b(args[0].to(torch.int32), *args[1:])


@pytest.mark.parametrize("hier", [False, True], ids=["ipb", "hier"])
def test_ipb_encoder_on_card_matches_cpu(cuda, hier):
    frames = moving_frames(9 if hier else 5, 176, 144, seed=8)
    cfg = _ipb_cfg(176, 144, 30, hier)
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


STREAMS = sorted((pathlib.Path(__file__).parent / "streams").glob("*.264"),
                 key=lambda p: p.name)


def _decode_calls(cuda, paths):
    """(args, H, W, NS) of every K8 call of decoding `paths` on the card."""
    calls = []
    kernel = DEV.decode_inter

    def rec(*a, H, W, NS):
        calls.append((a, H, W, NS))
        return kernel(*a, H=H, W=W, NS=NS)

    DEV.decode_inter = rec
    try:
        for path in paths:
            decode_annexb(path.read_bytes(), device=cuda)
    finally:
        DEV.decode_inter = kernel
    return calls


def test_decode_inter_matches_plain_recorded(cuda):
    """K8 on the inputs of every inter picture of the in-repo streams."""
    calls = _decode_calls(cuda, STREAMS)
    assert len(calls) > 50
    for args, H, W, ns in calls:
        got = K8.decode_inter(*args, H=H, W=W, NS=ns)
        want = K8.decode_inter_plain(*args, H=H, W=W, NS=ns)
        assert torch.equal(got, want)


@pytest.mark.parametrize("W,H", [(176, 144), (352, 288), (1280, 720)],
                         ids=lambda v: str(v))
def test_decode_inter_matches_plain_built(cuda, W, H):
    """Far mvs, ref_idx up to 9, explicit/implicit WP, T8, QP 0/51 and
    wrapping dequant (tools/decode_cases.py)."""
    for name, arrs in built_cases(H, W, seed=W + H):
        args = tuple(torch.as_tensor(a, device=cuda) for a in arrs)
        before = K8.decode_inter.launches
        got = K8.decode_inter(*args, H=H, W=W, NS=DEC_NS)
        assert K8.decode_inter.launches == before + 1
        want = K8.decode_inter_plain(*args, H=H, W=W, NS=DEC_NS)
        assert torch.equal(got, want), name


def test_decode_inter_rejects_bad_input(cuda):
    H, W = 48, 64
    args = [torch.as_tensor(a, device=cuda)
            for a in built_cases(H, W, seed=3)[0][1]]
    ok = K8.decode_inter(*args, H=H, W=W, NS=DEC_NS)
    assert ok.shape == (H * W * 3 // 2,)
    for i, bad in ((0, args[0].to(torch.int64)),  # dtype
                   (3, args[3][:, :-1]),  # shape
                   (17, args[17].cpu()),  # device
                   (5, args[5].t().contiguous().t())):  # layout
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            K8.decode_inter(*wrong, H=H, W=W, NS=DEC_NS)
    with pytest.raises(ValueError):
        K8.decode_inter(*args[:-1], H=H, W=W, NS=DEC_NS)
    with pytest.raises(ValueError):
        K8.decode_inter(*args, H=H + 8, W=W, NS=DEC_NS)


@pytest.mark.parametrize("path", STREAMS, ids=lambda p: p.stem)
def test_decoder_on_card_matches_cpu(cuda, path):
    data = path.read_bytes()
    before = K8.decode_inter.launches
    card = b"".join(p.to_yuv_bytes() for p in decode_annexb(data))
    cpu = b"".join(p.to_yuv_bytes()
                   for p in decode_annexb(data, device="cpu"))
    host = b"".join(p.to_yuv_bytes()
                    for p in decode_annexb(data, use_device=False))
    assert card == cpu == host
    if path.stem not in ("cabac_ipcm", "cavlc_ipcm", "field"):
        assert K8.decode_inter.launches > before
