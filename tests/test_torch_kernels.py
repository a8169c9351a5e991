"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest -q --noconftest -o "markers=gpu: needs a CUDA card" \
        -m gpu tests/test_torch_kernels.py

(the CPU side of each kernel is held against the JAX package by
test_torch_intra.py, test_torch_bank.py, test_torch_encode.py, the
test_torch_p_*.py, test_torch_t8_*.py and test_torch_b_*.py files, for
K9 also test_torch_ops.py, for K8 test_torch_decode_ops.py and
test_torch_decode.py, for K10 test_torch_me.py and the
test_torch_host_*.py files, on the tile-row path test_torch_rows*.py
and test_torch_ratectl.py, for K11 test_torch_lossaware.py and
test_torch_er.py, for K12 and K13 test_torch_legacy.py, and for K2's
row-slab entry and the sharded pipelines test_torch_sharded.py)."""

import pathlib

import numpy as np
import pytest
import torch

from h264_tpu_torch.decoder import device as DEV
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder import fast, rd, rd_b, rd_p, rd_rows
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.kernels import b_direct as K7
from h264_tpu_torch.kernels import deblock as K6
from h264_tpu_torch.kernels import decode_inter as K8
from h264_tpu_torch.encoder.lossaware import propagate_drift_plain
from h264_tpu_torch.kernels import inter_tq as K5
from h264_tpu_torch.kernels import propagate_drift as K11
from h264_tpu_torch.kernels import intra_commit as K1
from h264_tpu_torch.kernels import p16 as P16
from h264_tpu_torch.kernels import qpel as K4
from h264_tpu_torch.kernels import ref_bank as K2
from h264_tpu_torch.kernels import sad_grid as K10
from h264_tpu_torch.kernels import search_grid as K3
from h264_tpu_torch.kernels import t8 as K9
from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.parallel import dryrun as DRY
from h264_tpu_torch.parallel import sharded as SHD
from h264_tpu_torch.parallel.mesh import Mesh
from h264_tpu_torch.tools.decode_cases import NS as DEC_NS
from h264_tpu_torch.tools.decode_cases import built_cases
from h264_tpu_torch.tools.drift_cases import CASES as DRIFT_CASES
from h264_tpu_torch.tools.drift_cases import built_case as drift_case
from h264_tpu_torch.tools.drift_cases import ordered_route as drift_ordered_route
from h264_tpu_torch.tools.p16_cases import CASES as P16_CASES
from h264_tpu_torch.tools.p16_cases import built_case as p16_built_case
from h264_tpu_torch.tools.p16_cases import moved_vectors as p16_moved_vectors
from h264_tpu_torch.tools.p16_cases import reached_sides as p16_reached
from h264_tpu_torch.tools.rows_cases import edge_motion
from h264_tpu_torch.tools.search_tq_cases import (COARSE_CONTENTS,
                                                  CORNER_CENTRES,
                                                  I16_CONTENTS,
                                                  LUMA_CONTENTS,
                                                  SUB8_CONTENTS, chroma_case,
                                                  coarse_case, corner_mbs,
                                                  direct_case, direct_kinds,
                                                  i16_case, luma_case,
                                                  sub8_case)
from h264_tpu_torch.tools.slab_cases import CONTENTS as SLAB_CONTENTS
from h264_tpu_torch.tools.slab_cases import built_slab
from h264_tpu_torch.tools.strengths_cases import branches, strengths_inputs
from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames
from h264_tpu_torch.tools.t8_cases import MB_COUNTS as T8_MB_COUNTS
from h264_tpu_torch.tools.t8_cases import built_cases as t8_cases
from h264_tpu_torch.tools.t8_cases import sized_case as t8_sized_case

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
    before = K1.intra_commit_scan.launches
    got = rd.rd_i_pipeline(*args, device=cuda)
    assert K1.intra_commit_scan.launches == before + 1
    want = rd.rd_i_pipeline(*args, device=cuda,
                            impl=K1.intra_commit_scan_plain)
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
    want = rd._intra_commit_scan(*args, **kw, impl=K1.intra_commit_scan_plain)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


def _is_intra_pattern(name, n_my, n_mx):
    """(n_my * n_mx,) bool: which MBs of the P/B form of the scan are
    intra."""
    r, c = np.meshgrid(np.arange(n_my), np.arange(n_mx), indexing="ij")
    if name == "all_intra":
        m = np.ones((n_my, n_mx), bool)
    elif name == "all_inter":
        m = np.zeros((n_my, n_mx), bool)
    elif name == "one_mb":
        m = (r == n_my // 2) & (c == n_mx // 2)
    elif name == "one_column":
        m = c == n_mx // 2
    elif name == "checkerboard":
        m = (r + c) % 2 == 0
    else:  # "random5"
        m = np.random.RandomState(n_my * 1000 + n_mx).rand(n_my, n_mx) < 0.05
    return m.reshape(-1)


PATTERNS = ["all_intra", "all_inter", "one_mb", "one_column", "checkerboard",
            "random5"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("W,H", [(16, 16), (16, 64), (48, 32), (352, 288),
                                 (1280, 720), (1920, 1088)],
                         ids=lambda v: str(v))
def test_intra_commit_patterns_repeated(cuda, W, H, pattern):
    """K1 on one is_intra pattern, bit-equal to its plain scan 20 times
    over (the blocks hand MBs over through row counters, and no race
    checker runs on the card), one launch per scan."""
    n_my, n_mx = H // 16, W // 16
    n_mb = n_my * n_mx
    rng = np.random.RandomState(W + H)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a, device=cuda).to(dtype)

    Y, U, V = (t(p) for p in synthetic_frames(1, W, H, seed=W)[0])
    args = (Y, U, V, t(rng.randint(0, 256, (n_mb, 16, 16))),
            t(rng.randint(0, 256, (n_mb, 2, 8, 8))),
            t(_is_intra_pattern(pattern, n_my, n_mx), torch.bool),
            t(rng.randint(-3, 4, (n_mb, 4, 4, 4, 4))),
            t(rng.randint(-2, 3, (n_mb, 2, 2, 2, 4, 4))),
            t(rng.randint(-5, 6, (n_mb, 2, 2, 2))))
    kw = dict(H=H, W=W, qp=28, qp_c=chroma_qp(28, 0), lam=_lam(28))
    want = rd._intra_commit_scan(*args, **kw, impl=K1.intra_commit_scan_plain)
    for _ in range(20):
        before = K1.intra_commit_scan.launches
        got = rd._intra_commit_scan(*args, **kw)
        assert K1.intra_commit_scan.launches == before + 1
        for name, g, w in zip(OUTS, got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("content", ["random", "0_255"])
@pytest.mark.parametrize("W,H", [(16, 16), (64, 48), (176, 144), (352, 288),
                                 (1280, 720), (208, 96), (22, 18)],
                         ids=lambda v: str(v))
def test_ref_bank_matches_plain(cuda, W, H, content):
    """K2's tiles (32 x 64 outputs) at sizes that are and are not whole
    tiles (208 + 64 columns: 4.25 tiles; 22 + 64: rows that take no
    16-byte stores), on random and 0/255 checkerboard planes (the 6-tap
    sums' extremes)."""
    rng = np.random.RandomState(W)

    def plane(h, w):
        if content == "random":
            return rng.randint(0, 256, (h, w))
        return (np.indices((h, w)).sum(0) % 2) * 255

    Y, U, V = (torch.as_tensor(plane(*s), dtype=torch.int32, device=cuda)
               for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    before = K2.ref_bank.launches
    got = K2.ref_bank(Y, U, V)
    assert K2.ref_bank.launches == before + 1
    for g, w in zip(got, K2.ref_bank_plain(Y, U, V)):
        assert torch.equal(g, w)
    # a plane at an offset that is not 16-byte aligned takes the
    # sample-a-thread staging
    Y2 = torch.empty(H * W + 1, dtype=torch.int32, device=cuda)[1:].view(H, W)
    Y2.copy_(Y)
    for g, w in zip(K2.ref_bank(Y2, U, V), K2.ref_bank_plain(Y, U, V)):
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
        K1.intra_commit_scan(s)


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

def _ippp_cfg(W, H, qp, wp, nref=2, sr=8, **kw):
    return EncoderConfig(width=W, height=H, qp=qp, fast=True, rd=True,
                         entropy=kw.pop("entropy", "cabac"),
                         num_ref_frames=nref, search_range=sr,
                         weighted_pred=wp, **kw)


_CALLS: dict = {}


def _p_calls(dev, W, H, qp, wp, t8=False):
    """Every P-entry call of a 1 I + 2 P encode through the plain path on
    the card, as (name, args)."""
    key = (W, H, qp, wp, t8)
    if key not in _CALLS:
        enc = H264Encoder(_ippp_cfg(W, H, qp, wp, transform8x8=t8),
                          device=dev)
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
    assert seen == set(rd_p.entries_of(False))


def test_p_wrappers_reject_bad_input(cuda):
    calls = dict(_p_calls(cuda, 176, 144, 28, True))
    banks, cur_y, wp, lam_me = calls["coarse_search"]
    with pytest.raises(ValueError):
        K3.coarse_search(banks.float(), cur_y, wp, lam_me)
    with pytest.raises(ValueError):
        K3.coarse_search(banks, cur_y[:, :160], wp, lam_me)
    with pytest.raises(ValueError):
        K3.ssd_grid8(banks, cur_y, *calls["ssd_grid8"][2:5], 40)
    a = calls["sub8_search"]
    with pytest.raises(ValueError):  # centres as int64
        K3.sub8_search(*a[:3], a[3].long(), *a[4:])
    with pytest.raises(ValueError):  # PMVs a unit short
        K3.sub8_search(*a[:5], a[5][:-1], *a[6:])
    with pytest.raises(ValueError):
        K3.sub8_search(*a[:8], 11, a[9])
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
    a = calls["strengths"]
    with pytest.raises(ValueError):  # levels as bool
        K6.strengths(*a[:2], a[2] != 0, *a[3:])
    with pytest.raises(ValueError):  # mvs of another picture
        K6.strengths(*a[:5], a[5][:-1], *a[6:])
    with pytest.raises(ValueError):  # one field on the host
        K6.strengths(*a[:3], a[3].cpu(), *a[4:])
    y, u, v, bsv, bsh, qp, qpc = calls["deblock"]
    with pytest.raises(ValueError):
        K6.deblock(y, u, v.cpu(), bsv, bsh, qp, qpc)


def _ssd8_inputs(dev, W, H, R, content, kind):
    """Built inputs of ssd_grid8.  P: 5 references, the WP weights and
    offsets at their extremes, and centres at +-48 on the picture's edge
    MBs (windows past every edge, their reads clamped to the bank) and
    random steps of 4 inside; B: 2 references, zero centres, no WP.  The
    banks' planes are all 0, all 255 or random, the source the opposite
    extreme (the largest SSD) or random."""
    rng = np.random.RandomState(W + H + R)
    NR = 5 if kind == "P" else 2
    n_my, n_mx = H // 16, W // 16

    def plane(h, w, fill):
        a = (rng.randint(0, 256, (h, w)) if fill is None
             else np.full((h, w), fill))
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    fill = {"zero": 0, "full": 255, "random": None}[content]
    banks = torch.stack([K2.ref_bank_plain(
        plane(H, W, fill), plane(H // 2, W // 2, fill),
        plane(H // 2, W // 2, fill))[0] for _ in range(NR)])
    cur_y = plane(H, W, None if fill is None else 255 - fill)
    if kind == "B":
        cen = torch.zeros((NR, n_my, n_mx), dtype=torch.int32, device=dev)
        return banks, cur_y, cen, cen.clone(), None
    cen_x = 4 * rng.randint(-12, 13, (NR, n_my, n_mx))
    cen_y = 4 * rng.randint(-12, 13, (NR, n_my, n_mx))
    cen_x[:, :, 0], cen_x[:, :, -1] = -48, 48
    cen_y[:, 0, :], cen_y[:, -1, :] = -48, 48
    cen_x[1:3] *= -1  # the opposite corners too
    cen_y[2:4] *= -1
    wp = (torch.tensor([-128, 127, 0, 1, 64], dtype=torch.int32, device=dev),
          torch.tensor([127, -128, 0, -128, 127], dtype=torch.int32,
                       device=dev))
    return (banks, cur_y,
            *(torch.as_tensor(c, dtype=torch.int32, device=dev)
              for c in (cen_x, cen_y)), wp)


@pytest.mark.parametrize("kind", ["P", "B"])
@pytest.mark.parametrize("content", ["zero", "full", "random"])
@pytest.mark.parametrize("R", [1, 8, 16, 28])
@pytest.mark.parametrize("W,H", [(64, 48), (352, 288)], ids=lambda v: str(v))
def test_ssd_grid8_matches_plain_built(cuda, W, H, R, content, kind):
    banks, cur_y, cen_x, cen_y, wp = _ssd8_inputs(cuda, W, H, R, content,
                                                  kind)
    before = K3.ssd_grid8.launches
    got = K3.ssd_grid8(banks, cur_y, cen_x, cen_y, wp, R)
    assert K3.ssd_grid8.launches == before + 1
    want = K3.ssd_grid8_plain(banks, cur_y, cen_x, cen_y, wp, R)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if content != "random" and wp is None:
        assert int(want.max()) == 64 * 255 ** 2


@pytest.mark.parametrize("content", COARSE_CONTENTS)
@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("NR", [1, 5])
@pytest.mark.parametrize("W,H", [(352, 288), (1280, 720)],
                         ids=lambda v: str(v))
def test_coarse_search_matches_plain_built(cuda, W, H, NR, wp, content):
    """coarse_search (the decimation, then the strip search) at CIF and
    720p, NR 1 and 5, WP off and at its extremes, on random content, on
    corner MBs whose best cell lies in the clamped corner of the widened
    bank, on flat content (at lam_me 0 every cell ties and the first
    wins) and on 0/255 checkerboards; the lambdas of QP 0 and 51 and 0;
    10 launches each on unchanged inputs."""
    banks, cur_y, wpt = coarse_case(content, W, H, NR, wp, seed=W + NR)
    banks, cur_y = banks.to(cuda), cur_y.to(cuda)
    if wpt is not None:
        wpt = tuple(x.to(cuda) for x in wpt)
    for lam_me in (0, 2 * _lam(0), 2 * _lam(51)):
        want = K3.coarse_search_plain(banks, cur_y, wpt, lam_me)
        before = K3.coarse_search.launches
        for _ in range(10):
            got = K3.coarse_search(banks, cur_y, wpt, lam_me)
            torch.cuda.synchronize()
            for g, x in zip(got, want):
                assert g.dtype == x.dtype and torch.equal(g, x), lam_me
        assert K3.coarse_search.launches == before + 10
        if content == "corners" and lam_me == 2 * _lam(0):
            for (my, mx), c in zip(corner_mbs(W, H), CORNER_CENTRES):
                assert (int(got[0][0, my, mx]), int(got[1][0, my, mx])) == c
        if content == "flat" and lam_me == 0:
            assert bool((got[0] == -48).all() and (got[1] == -48).all())


@pytest.mark.parametrize("content", SUB8_CONTENTS)
@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("RS", [0, 1, 8, 10])
@pytest.mark.parametrize("NR", [1, 5])
@pytest.mark.parametrize("W,H", [(16, 16), (176, 144), (352, 288),
                                 (1280, 720)], ids=lambda v: str(v))
def test_sub8_search_matches_plain_built(cuda, W, H, NR, RS, wp, content):
    """sub8_search at one MB, 176x144, CIF and 720p, NR 1 and 5, RS 0, 1,
    8 and 10, WP off and at its extremes, on random, flat (every SSD of a
    partition ties: the rate decides, and at lam_me 0 the first cell) and
    0/255 content, the first four units' centres at the corners +-CMAX;
    the lambdas of QP 28 (a fraction that makes lam_cost of a sum differ
    from the sum of lam_costs) and 51, and 0; 5 launches each on unchanged
    inputs."""
    *a, wpt, RS = sub8_case(content, W, H, NR, RS, wp, seed=W + 7 * NR + RS)
    a = [x.to(cuda) for x in a]
    if wpt is not None:
        wpt = tuple(x.to(cuda) for x in wpt)
    for lam_me in (2 * _lam(28), 2 * _lam(51), 0):
        want = K3.sub8_search_plain(*a, wpt, RS, lam_me)
        before = K3.sub8_search.launches
        for _ in range(5):
            got = K3.sub8_search(*a, wpt, RS, lam_me)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want), lam_me
        assert K3.sub8_search.launches == before + 5
        if content == "flat" and lam_me == 0:
            assert torch.equal(got, torch.stack([a[4] - RS, a[3] - RS])[
                :, None].expand_as(got))


@pytest.mark.parametrize("content", I16_CONTENTS)
@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("W,H", [(16, 16), (16, 1088), (1280, 16),
                                 (176, 144), (352, 288), (1280, 720)],
                         ids=lambda v: str(v))
def test_i16_candidate_matches_plain_built(cuda, W, H, qp, content):
    """i16_candidate (a warp an MB) at one MB, one MB column and row,
    QCIF, CIF and 720p, QP 0, 28 and 51, on random, 0/255 checkerboard,
    flat (every available mode ties: the first wins) and gradient (PLANE
    wins) content; three launches each on unchanged inputs."""
    cur = i16_case(content, W, H, seed=W + H + qp).to(cuda)
    want = K5.i16_candidate_plain(cur, qp)
    before = K5.i16_candidate.launches
    for _ in range(3):
        got = K5.i16_candidate(cur, qp)
        torch.cuda.synchronize()
        for name, g, x in zip(("rec16", "D16", "cb16"), got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
    assert K5.i16_candidate.launches == before + 3


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("content", LUMA_CONTENTS)
@pytest.mark.parametrize("n_mb", [1, 13, 99])
@pytest.mark.parametrize("NC", [1, 6, 8])
def test_inter_luma_tq_matches_plain_built(cuda, NC, n_mb, content, qp):
    """inter_luma_tq (a warp per candidate and MB, 8 a block) for 1, 6 and
    8 candidates of 1, 13 and 99 MBs (each count but 8 x 1, 8 x 13 and
    8 x 99 leaves a partial last block), QP 0, 28 and 51, on residuals
    up to +-40, of +-255 and sparse ones whose 8x8 units and MBs drop
    (tools/search_tq_cases.py); two launches each."""
    pred, orig = (x.to(cuda) for x in luma_case(content, NC, n_mb,
                                                seed=NC * n_mb + qp))
    lam = _lam(qp)
    want = K5.inter_luma_tq_plain(pred, orig, qp, lam)
    before = K5.inter_luma_tq.launches
    for _ in range(2):
        got = K5.inter_luma_tq(pred, orig, qp, lam)
        torch.cuda.synchronize()
        for name, g, x in zip(("lev", "rec", "D8", "cb8"), got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
    assert K5.inter_luma_tq.launches == before + 2


@pytest.mark.parametrize("qp_c", [0, 29, 39, 51])
@pytest.mark.parametrize("content", LUMA_CONTENTS)
@pytest.mark.parametrize("n_mb", [1, 41, 396, 3600])
def test_inter_chroma_tq_matches_plain_built(cuda, n_mb, content, qp_c):
    """inter_chroma_tq (16 lanes an MB, two MBs a warp and a block) for 1,
    41, 396 (CIF) and 3600 (1280x720) MBs (odd counts leave a half warp
    coding the last MB again, unstored), chroma QP 0, 29, 39 and 51, on
    residuals up to +-40, of 0 and +-255, and sparse ones whose planes'
    AC costs fall on both sides of JM's drop threshold
    (tools/search_tq_cases.py); two launches each."""
    pred, orig = (x.to(cuda) for x in chroma_case(content, n_mb,
                                                  seed=n_mb + qp_c, qp_c=qp_c))
    lam = _lam(qp_c)
    want = K5.inter_chroma_tq_plain(pred, orig, qp_c, lam)
    before = K5.inter_chroma_tq.launches
    for _ in range(2):
        got = K5.inter_chroma_tq(pred, orig, qp_c, lam)
        torch.cuda.synchronize()
        for name, g, x in zip(("levc", "dcc", "recc"), got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
    assert K5.inter_chroma_tq.launches == before + 2


DIRECT_OUTS = ("pred", "idx", "l0x", "l0y", "l1x", "l1y")


@pytest.mark.parametrize("NR", [1, 3])
@pytest.mark.parametrize("W,H", [(16, 16), (176, 144), (352, 288),
                                 (1280, 720)], ids=lambda v: str(v))
def test_b_direct_matches_plain_built(cuda, W, H, NR):
    """b_direct (a warp per MB, the motion derived once per unit) on built
    colocated fields: intra blocks, units whose reference is the anchor,
    indices past the list, negative scaled mvs, mvs up to +-90 pel whose
    windows start outside the padded banks (tools/search_tq_cases.py);
    one MB, QCIF (an odd MB count: a partial last block), CIF and
    1280x720; two launches each."""
    args = tuple(a.to(cuda) for a in direct_case(W, H, NR, seed=W + NR))
    if W > 16:
        kinds = direct_kinds(tuple(a.cpu() for a in args))
        assert all(v > 0 for k, v in kinds.items() if k != "anchor" or NR > 1)
    want = K7.b_direct_plain(*args)
    before = K7.b_direct.launches
    for _ in range(2):
        got = K7.b_direct(*args)
        torch.cuda.synchronize()
        for name, g, x in zip(DIRECT_OUTS, got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
    assert K7.b_direct.launches == before + 2


def test_b_direct_returns_views_of_one_buffer(cuda):
    """The prediction and the five fields are contiguous views of one
    int32 buffer, in that order, with the plain version's shapes; a later
    call allocates anew and leaves an earlier call's results as they
    were."""
    args = tuple(a.to(cuda) for a in direct_case(176, 144, 3, seed=5))
    first = K7.b_direct(*args)
    want = K7.b_direct_plain(*args)
    base = first[0].untyped_storage().data_ptr()
    at = first[0].data_ptr()
    for name, g, x in zip(DIRECT_OUTS, first, want):
        assert g.is_contiguous() and g.shape == x.shape, name
        assert g.dtype == torch.int32, name
        assert g.untyped_storage().data_ptr() == base, name
        assert g.data_ptr() == at, name  # each follows the one before
        at += g.numel() * 4
    kept = [g.clone() for g in first]
    args2 = tuple(a.to(cuda) for a in direct_case(176, 144, 3, seed=6))
    second = K7.b_direct(*args2)
    torch.cuda.synchronize()
    assert second[0].untyped_storage().data_ptr() != base
    for name, g, k, x in zip(DIRECT_OUTS, first, kept, want):
        assert torch.equal(g, k) and torch.equal(g, x), name
    for name, g, x in zip(DIRECT_OUTS, second, K7.b_direct_plain(*args2)):
        assert torch.equal(g, x), name


REFINE_SHAPES = [(16, 16), (8, 16), (16, 8), (8, 8), (4, 8), (8, 4), (4, 4)]


def _refine_inputs(dev, h, w, content, seed, m=37):
    """Built inputs of qpel_refine on a 176x144 picture with 2 references:
    units at the four corners whose integer mvs put the window against and
    past the bank's edges (every read clamped), then m random units; the
    content random, or flat in bank and source (every candidate's SATD
    the same)."""
    rng = np.random.RandomState(seed)
    Hs, Ws = 144, 176

    def plane(hh, ww):
        a = (np.full((hh, ww), 90) if content == "flat"
             else rng.randint(0, 256, (hh, ww)))
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    banks = torch.stack([K2.ref_bank_plain(
        plane(Hs, Ws), plane(Hs // 2, Ws // 2), plane(Hs // 2, Ws // 2))[0]
        for _ in range(2)])
    cur_y = plane(Hs, Ws)
    y0 = np.r_[0, 0, Hs - h, Hs - h, rng.randint(0, Hs // h, m) * h]
    x0 = np.r_[0, Ws - w, 0, Ws - w, rng.randint(0, Ws // w, m) * w]
    imvy = np.r_[-34, -40, 33, 40, rng.randint(-36, 37, m)]
    imvx = np.r_[-40, 34, -33, 40, rng.randint(-36, 37, m)]
    n = len(y0)
    unit = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (
        rng.randint(0, 2, n), imvx, imvy, y0, x0, rng.randint(-80, 81, n),
        rng.randint(-80, 81, n))]
    return banks, cur_y, unit


@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("h,w", REFINE_SHAPES)
def test_qpel_refine_matches_plain_built(cuda, h, w, wp, qp):
    """qpel_refine on every shape, WP on and off, at the lambdas of QP 0
    and 51, for n = 1, n = 7 and n = 41, windows at every corner of the
    bank.  At 8x8 and smaller a block takes 5 units, so 7 and 41 leave a
    partial last block; at 16x16, 16x8 and 8x16 these n give one unit a
    block (test_qpel_refine_packs_large_units packs several)."""
    banks, cur_y, unit = _refine_inputs(cuda, h, w, "random", h * w + qp)
    wpt = ((torch.tensor([-128, 127], dtype=torch.int32, device=cuda),
            torch.tensor([127, -128], dtype=torch.int32, device=cuda))
           if wp else None)
    lam = rd.lam_satd_of(_lam(qp))
    for n in (1, 7, unit[0].shape[0]):
        a = (banks, cur_y, *(x[:n].contiguous() for x in unit), wpt, lam, h,
             w)
        before = K4.qpel_refine.launches
        got = K4.qpel_refine(*a)
        assert K4.qpel_refine.launches == before + 1
        want = K4.qpel_refine_plain(*a)
        for name, g, x in zip(("mvx", "mvy", "pred", "cost"), got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), (n, name)


@pytest.mark.parametrize("units", [2, 3, 4, 5])
@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("h,w", [(16, 16), (16, 8), (8, 16)])
def test_qpel_refine_packs_large_units(cuda, h, w, wp, units):
    """At 16x16, 16x8 and 8x16 the C entry packs n / (4 SMs) units a block,
    at most 5: n = units x 4 SMs + 1 packs `units` a block and leaves one
    unit in the last block, which repeats it (random units tiled over the
    picture, the four corner windows among them)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = units * 4 * sms + 1
    banks, cur_y, unit = _refine_inputs(cuda, h, w, "random", n, m=n - 4)
    wpt = ((torch.tensor([-128, 127], dtype=torch.int32, device=cuda),
            torch.tensor([127, -128], dtype=torch.int32, device=cuda))
           if wp else None)
    a = (banks, cur_y, *unit, wpt, rd.lam_satd_of(_lam(28)), h, w)
    got = K4.qpel_refine(*a)
    want = K4.qpel_refine_plain(*a)
    for name, g, x in zip(("mvx", "mvy", "pred", "cost"), got, want):
        assert g.dtype == x.dtype and torch.equal(g, x), name


@pytest.mark.parametrize("h,w", REFINE_SHAPES)
def test_qpel_refine_flat_ties_keep_the_first(cuda, h, w):
    """Flat bank and source with no rate: all 49 costs tie and the first
    candidate (-3, -3) wins, as the plain version's argmin (the windows
    kept inside the bank's flat interior: its half-pel planes are not flat
    at its outer edge)."""
    banks, cur_y, unit = _refine_inputs(cuda, h, w, "flat", 5)
    unit[1], unit[2] = unit[1].clamp(-16, 16), unit[2].clamp(-16, 16)
    a = (banks, cur_y, *unit, None, 0, h, w)
    got = K4.qpel_refine(*a)
    want = K4.qpel_refine_plain(*a)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert torch.equal(got[0], 4 * unit[1] - 3)
    assert torch.equal(got[1], 4 * unit[2] - 3)


def _deblock_inputs(dev, W, H, bs, seed):
    """Blocky planes (flat 4x4 blocks a few levels apart, plus noise) and
    strengths all 4 (the picture's edges too), all 0, random 0-4, or the
    legacy path's 0-2."""
    rng = np.random.RandomState(seed)
    H4, W4 = H // 4, W // 4

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=dev)

    base = np.repeat(np.repeat(rng.randint(90, 130, (H4, W4)), 4, 0), 4, 1)
    y = base + rng.randint(-2, 3, (H, W))
    u, v = (np.repeat(np.repeat(rng.randint(110, 140, (H4, W4)), 2, 0), 2, 1)
            + rng.randint(-1, 2, (H // 2, W // 2)) for _ in range(2))
    hi = {"all4": 5, "all0": 1, "random": 5, "legacy": 3}[bs]
    lo = 4 if bs == "all4" else 0
    bsv, bsh = (rng.randint(lo, hi, (H4, W4)) for _ in range(2))
    return t(y), t(u), t(v), t(bsv), t(bsh)


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("bs", ["all4", "all0", "random", "legacy"])
@pytest.mark.parametrize("W,H", [(16, 16), (16, 1088), (1280, 16),
                                 (352, 288), (1280, 720)],
                         ids=lambda v: str(v))
def test_deblock_matches_plain_repeated(cuda, W, H, bs, qp):
    """K6 bit-equal to its plain version 20 times over on one stream (the
    blocks hand MBs over through row counters, and no race checker runs
    on the card), one launch per call, its inputs unchanged."""
    args = _deblock_inputs(cuda, W, H, bs, W + H + qp)
    keep = [x.clone() for x in args]
    qpc = chroma_qp(qp, 0)
    want = K6.deblock_plain(*args, qp, qpc)
    if bs == "all4" and qp == 51:
        assert not torch.equal(want[0], args[0])  # it filtered
    for _ in range(20):
        before = K6.deblock.launches
        got = K6.deblock(*args, qp, qpc)
        assert K6.deblock.launches == before + 1
        for g, x, name in zip(got, want, "YUV"):
            assert torch.equal(g, x), name
    for x, k in zip(args, keep):
        assert torch.equal(x, k)


@pytest.mark.parametrize("qp", [28, 51])
def test_t8_p_kernels_match_plain(cuda, qp):
    """Every P entry, K9 included, on the calls of a T8 IPPP encode."""
    kern = rd_p.default_kernels()
    seen = set()
    for name, args in _p_calls(cuda, 352, 288, qp, True, t8=True):
        before = getattr(kern, name).launches
        got = getattr(kern, name)(*args)
        assert getattr(kern, name).launches == before + 1, name
        want = getattr(rd_p.PLAIN, name)(*args)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and torch.equal(g, w), f"{name} out {i}"
        seen.add(name)
    assert seen == set(rd_p.entries_of(True))


@pytest.mark.parametrize("case", range(4), ids=["qp0_bound", "ties",
                                                 "classes_qp28",
                                                 "classes_qp51"])
def test_t8_decide_matches_plain_built(cuda, case):
    name, arrs, qp, lam = t8_cases(64, seed=9)[case]
    args = tuple(torch.as_tensor(a, device=cuda) for a in arrs)
    got = K9.t8_decide(*args, qp, lam)
    want = K9.t8_decide_plain(*args, qp, lam)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if name == "ties":
        assert not got[0].any()
    if name == "qp0_bound":
        assert int(got[1].abs().max()) == 3264


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("n_mb", T8_MB_COUNTS)
def test_t8_decide_matches_plain_sized(cuda, n_mb, qp):
    """A warp an MB at MB counts that do not fill the last block (1, 5,
    397) and at 1280x720's 3600, where both transforms win."""
    name, arrs, qp, lam = t8_sized_case(n_mb, seed=9, qp=qp)
    args = tuple(torch.as_tensor(a, device=cuda) for a in arrs)
    before = K9.t8_decide.launches
    got = K9.t8_decide(*args, qp, lam)
    assert K9.t8_decide.launches == before + 1
    want = K9.t8_decide_plain(*args, qp, lam)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if n_mb >= 397:
        assert got[0].any() and not got[0].all()


def test_t8_wrapper_rejects_bad_input(cuda):
    _, arrs, qp, lam = t8_cases(16, seed=1)[1]
    args = [torch.as_tensor(a, device=cuda) for a in arrs]
    with pytest.raises(ValueError, match="is_intra"):
        K9.t8_decide(*args[:6], args[6].to(torch.int32), qp, lam)
    with pytest.raises(ValueError, match="w_lev"):
        K9.t8_decide(*args[:3], args[3][:-1], *args[4:], qp, lam)
    with pytest.raises(ValueError, match="qp"):
        K9.t8_decide(*args, 52, lam)
    # a view one word in: contiguous, but off the 16-byte loads' boundary
    off = torch.empty(16 * 256 + 1, dtype=torch.int32, device=cuda)[1:]
    off = off.view(16, 16, 16).copy_(args[0])
    with pytest.raises(ValueError, match="orig_mb.*16-byte"):
        K9.t8_decide(off, *args[1:], qp, lam)


@pytest.mark.parametrize("kw", [
    {"entropy": "cavlc"}, {"transform8x8": True},
    {"transform8x8": True, "entropy": "cavlc", "b_frames": 1}],
    ids=["cavlc", "t8", "t8_cavlc_ipb"])
def test_cavlc_and_t8_encoders_on_card_match_cpu(cuda, kw):
    frames = moving_frames(5, 176, 144, seed=8)
    cfg = _ippp_cfg(176, 144, 30, True, **kw)
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)


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
# B picture kernels (K7, mc_luma_win, mc_chroma_b, and the K3-K6 entries
# B pictures share) on the real tensors of B pictures
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


def _legacy_strengths(n_my, n_mx, seed, dev):
    """Legacy-layout fields: 4x4 levels in raster (4 n_my, 4 n_mx, 4, 4),
    per-MB mvs within +-6 of each other."""
    rs = np.random.RandomState(seed)
    lev = np.where(rs.rand(4 * n_my, 4 * n_mx, 4, 4) < 0.03,
                   rs.randint(-2, 3, (4 * n_my, 4 * n_mx, 4, 4)), 0)
    mv = [torch.as_tensor(rs.randint(-6, 7, n_my * n_mx), dtype=torch.int32,
                          device=dev) for _ in range(2)]
    return (n_my, n_mx, torch.as_tensor(lev, dtype=torch.int32, device=dev),
            None, None, *mv)


@pytest.mark.parametrize("layout", ["b", "p", "p_t8", "legacy"])
@pytest.mark.parametrize("n_my,n_mx", [(18, 22), (45, 80)],
                         ids=["cif", "720p"])
def test_strengths_every_branch_matches_plain(cuda, n_my, n_mx, layout):
    """The one strengths kernel in the B, P (4x4 and 8x8 transform) and
    legacy layouts, on built inputs that take every branch of its rule
    (crossed and same-ref pairs, which a real IPB stream never has; the
    8x8 transform's odd edges), at CIF and 1280x720."""
    if layout == "legacy":
        args = _legacy_strengths(n_my, n_mx, n_my + n_mx, cuda)
    else:
        args = strengths_inputs(n_my, n_mx, n_my + n_mx, cuda,
                                lists=2 if layout == "b" else 1,
                                t8=layout == "p_t8")
        n = branches(args)
        assert min(v for k, v in n.items() if layout == "p_t8"
                   or k != "t8_odd") > 0, n
    before = K6.strengths.launches
    got = K6.strengths(*args)
    assert K6.strengths.launches == before + 1
    for g, w in zip(got, K6.strengths_plain(*args)):
        assert g.is_contiguous() and torch.equal(g, w)


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
    a = first["strengths"]
    with pytest.raises(ValueError):  # list 1 without its flags
        K6.strengths(*a[:13], None, a[14])
    with pytest.raises(ValueError):  # list flags as int32
        K6.strengths(*a[:10], a[10].to(torch.int32), *a[11:])


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


# ---------------------------------------------------------------------------
# K10: the host-path encoder's SAD grids, and the host path on the card
# ---------------------------------------------------------------------------

def _sad_inputs(content, W, H, R, seed, device):
    rs = np.random.RandomState(seed)
    if content == "random":
        cur, ref = rs.randint(0, 256, (2, H, W))
    elif content == "flat":
        cur, ref = np.full((2, H, W), 117)
    else:  # 0/255: every term at its largest
        cur, ref = np.full((H, W), 255), np.zeros((H, W), np.int64)
    ref_p = np.pad(ref, R, mode="edge")
    return (torch.as_tensor(cur, dtype=torch.int32, device=device),
            torch.as_tensor(ref_p, dtype=torch.int32, device=device))


@pytest.mark.parametrize("content", ["random", "flat", "0_255"])
@pytest.mark.parametrize("R", [0, 1, 8, 16, 28, 32, 64])
@pytest.mark.parametrize("W,H", [(176, 144), (352, 288), (1280, 720)],
                         ids=lambda v: str(v))
def test_sad_grid_matches_plain(cuda, W, H, R, content):
    cur, ref = _sad_inputs(content, W, H, R, seed=W + R, device=cuda)
    before = K10.sad_grid_16x16.launches
    got = K10.sad_grid_16x16(cur, ref, R)
    assert K10.sad_grid_16x16.launches == before + 1
    want = K10.sad_grid_16x16_plain(cur, ref, R)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if content == "0_255":
        assert int(got.min()) == int(got.max()) == 255 * 256


# (W, H, R): every size at R 0, 1, 16, 33 and 64; then ranges whose quads
# make several strips where a cut into strips of 16 would leave a narrow
# last one (R 120 and 121: 13 quads; R 1000: 5), whose blocks span the
# most tile rows
SAD_BUILT = [(W, H, R) for W, H in ((16, 16), (48, 32), (1280, 16),
                                    (176, 144), (352, 288), (1280, 720))
             for R in (0, 1, 16, 33, 64)] + [
    (16, 16, 120), (16, 16, 121), (16, 16, 1000), (48, 32, 120),
    (176, 144, 121)]


@pytest.mark.parametrize("content", ["random", "flat", "0_255", "padded"])
@pytest.mark.parametrize("W,H,R", SAD_BUILT, ids=lambda v: str(v))
def test_sad_grid_matches_plain_built(cuda, W, H, R, content):
    """sad_grid_16x16 (packed u8 windows, tiles of 4 x 3 cells, runs of 8
    MBs a block) at one MB, 48x32 (a run cut to 3 MBs), one MB row of
    1280x16 (ten runs), QCIF (runs of 8 and 3), CIF and 720p, R 0, 1,
    16, 33 and 64 (tiles that do not divide 2R + 1; R 33 and 64 split the
    grid over blocks), and at R 120, 121 and 1000 (four to 32 strips), on
    random, flat, 0/255 and edge-padded content (a seeded moving_frames
    pair padded as me.compute_sad_grids pads it); two launches on
    unchanged inputs."""
    if content == "padded":
        fr = moving_frames(2, max(W, 64), max(H, 64), seed=W + R)
        cur = torch.as_tensor(np.ascontiguousarray(
            np.asarray(fr[1][0], np.int32)[:H, :W]), device=cuda)
        ref = torch.as_tensor(np.pad(np.asarray(fr[0][0], np.int32)[:H, :W],
                                     R, mode="edge"), device=cuda)
    else:
        cur, ref = _sad_inputs(content, W, H, R, seed=W + R, device=cuda)
    want = K10.sad_grid_16x16_plain(cur, ref, R)
    before = K10.sad_grid_16x16.launches
    for _ in range(2):
        got = K10.sad_grid_16x16(cur, ref, R)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert K10.sad_grid_16x16.launches == before + 2
    if content == "0_255":
        assert int(got.min()) == int(got.max()) == 255 * 256


def test_sad_grid_rejects_bad_input(cuda):
    cur, ref = _sad_inputs("random", 48, 32, 4, seed=1, device=cuda)
    with pytest.raises(ValueError, match="ref_padded"):
        K10.sad_grid_16x16(cur, ref[:-1], 4)
    with pytest.raises(ValueError, match="cur"):
        K10.sad_grid_16x16(cur.to(torch.int64), ref, 4)
    with pytest.raises(ValueError, match="whole MBs"):
        K10.sad_grid_16x16(cur[:-1], ref, 4)
    with pytest.raises(ValueError, match="negative"):
        K10.sad_grid_16x16(cur, ref, -1)


@pytest.mark.parametrize("kw", [
    {}, {"entropy": "cabac", "b_frames": 1},
    {"slice_mode": 1, "slice_argument": 33},
    {"num_slice_groups": 2, "slice_group_map_type": 2,
     "slice_group_rects": ((12, 58),)},
    {"partition_mode": 1, "redundant_pics": True},
    {"entropy": "cabac", "transform8x8": True, "b_frames": 1,
     "fast": True, "slice_mode": 1, "slice_argument": 50}],
    ids=["cavlc", "cabac_ipb", "slices", "fmo2", "dp_redundant",
         "fast_slices_t8_ipb"])
def test_host_path_encoder_on_card_matches_cpu(cuda, kw):
    """The host-path encoder (K10 for the grids) on the card writes the
    stream and recons it writes on the CPU, and K10 ran."""
    frames = moving_frames(5, 176, 144, seed=8)
    cfg = EncoderConfig(width=176, height=144, search_range=8, **kw)
    before = K10.sad_grid_16x16.launches
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    assert K10.sad_grid_16x16.launches > before
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# tile rows (rd_rows) and rate control
# ---------------------------------------------------------------------------

ROWS_ENTRIES = set(rd_p.entries_of(False)) - {"coarse_search"}


def _hold_p(kern, name, args):
    before = getattr(kern, name).launches
    got = getattr(kern, name)(*args)
    assert getattr(kern, name).launches == before + 1, name
    want = getattr(rd_p.PLAIN, name)(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{name} out {i}"


@pytest.mark.parametrize("W,H,G", [(176, 144, 3), (352, 288, 3),
                                   (352, 288, 6)], ids=lambda v: str(v))
def test_rows_p_kernels_match_plain(cuda, W, H, G):
    """Every P entry of the tile-row path (no coarse search) on the slab
    inputs of a 1 I + 2 P encode with G rows, through the plain path on
    the card, against the kernel."""
    enc = H264Encoder(_ippp_cfg(W, H, 28, False, row_slices=G), device=cuda)
    enc._p_kernels, calls = rd_p.recording(rd_p.PLAIN)
    list(enc.encode_stream(moving_frames(3, W, H, seed=W + G)))
    kern = rd_p.default_kernels()
    for name, args in calls:
        _hold_p(kern, name, args)
    assert {n for n, _ in calls} == ROWS_ENTRIES


def test_rows_p_kernels_at_the_slab_edges_match_plain(cuda):
    """R 28 and content moved 28 pels along each diagonal
    (tools/rows_cases.py): the windows reach every slab edge."""
    H, W, G, R = 96, 176, 3, 28
    ref, curs = edge_motion(H, W, R)
    bank, cpad = K2.ref_bank(*(torch.as_tensor(p, dtype=torch.int32,
                                               device=cuda) for p in ref))
    kern = rd_p.default_kernels()
    for cur in curs:
        k, calls = rd_p.recording(rd_p.PLAIN)
        rd_rows.rd_p_rows_pipeline(*cur, bank[None], cpad[None], H=H, W=W,
                                   R=R, qp=28, qp_c=chroma_qp(28, 0),
                                   lam=_lam(28), lam_me=_lam(28), G=G,
                                   device=cuda, k=k)
        for name, args in calls:
            _hold_p(kern, name, args)
        assert {n for n, _ in calls} == ROWS_ENTRIES


@pytest.mark.parametrize("kw", [
    {"row_slices": 3},
    {"row_slices": 3, "entropy": "cavlc", "rc_bitrate": 350e3,
     "num_ref_frames": 1},
    {"rc_bitrate": 350e3},
    {"rc_bitrate": 700e3, "b_frames": 1},
    {"rc_bitrate": 350e3, "fast": False, "entropy": "cavlc"}],
    ids=["rows", "rows_rc_cavlc", "rc_ippp", "rc_ipb", "rc_host"])
def test_rows_and_rate_control_encoders_on_card_match_cpu(cuda, kw):
    """Tile rows and rate control on the card write the streams and recons
    they write on the CPU (the QP picks follow the same bits)."""
    frames = moving_frames(5, 176, 144, seed=8)
    cfg = EncoderConfig(**{**dict(width=176, height=144, qp=28, fast=True,
                                  rd=True, entropy="cabac", num_ref_frames=2,
                                  search_range=8), **kw})
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# K11 (propagate_drift, the loss-aware RDO's simulated decoders)
# ---------------------------------------------------------------------------

def _hold_k11(args):
    before = K11.propagate_drift.launches
    got = K11.propagate_drift(*args)
    assert K11.propagate_drift.launches == before + 1
    want = propagate_drift_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", DRIFT_CASES)
@pytest.mark.parametrize("K", [1, 3, 30, 33, 64])
@pytest.mark.parametrize("W,H", [(176, 144), (352, 288)], ids=lambda v: str(v))
def test_propagate_drift_matches_plain_built(cuda, W, H, K, case):
    args = drift_case(case, H, W, K, seed=11)
    _hold_k11(tuple(torch.as_tensor(a, device=cuda) for a in args))
    if case == "threshold":  # both of the kernel's routes ran
        ordered = drift_ordered_route(args[0])  # the new drift is the drift
        assert ordered.any() and not ordered.all()


def test_propagate_drift_matches_plain_recorded(cuda):
    """Every step of a loss-aware encode on the card (30 decoders)."""
    calls = []

    class Recording(H264Encoder):
        @staticmethod
        def _propagate_drift(*a):
            calls.append(a)
            return K11.propagate_drift(*a)

    cfg = EncoderConfig(width=176, height=144, qp=28, fast=True,
                        entropy="cabac", num_ref_frames=2, search_range=8,
                        loss_aware_k=30, loss_rate=0.1, intra_refresh=22)
    Recording(cfg, device=cuda).encode_sequence(moving_frames(5, 176, 144,
                                                              seed=8))
    assert len(calls) == 4
    for a in calls:
        _hold_k11(a)


def test_propagate_drift_rejects_bad_input(cuda):
    args = [torch.as_tensor(a, device=cuda)
            for a in drift_case("seeded", 32, 48, 2)]
    bad = [(0, args[0][:, :20]), (0, args[0].to(torch.int64)),
           (1, args[1][:16]), (2, args[2][..., :1]),
           (3, args[3].to(torch.int32)), (4, args[4][:1]),
           (2, args[2].transpose(0, 1))]
    # a view one word in: contiguous, but off the 16-byte loads' boundary
    off = torch.empty(args[0].numel() + 1, dtype=torch.int32,
                      device=cuda)[1:]
    bad.append((0, off.view(args[0].shape).copy_(args[0])))
    for i, x in bad:
        with pytest.raises(ValueError, match="propagate_drift"):
            K11.propagate_drift(*args[:i], x, *args[i + 1:])


@pytest.mark.parametrize("kw", [
    {"loss_aware_k": 30, "loss_rate": 0.1, "intra_refresh": 22},
    {"loss_aware_k": 3, "loss_rate": 0.5, "b_frames": 1, "idr_period": 4,
     "weighted_pred": True, "intra_refresh": 30},
    {"loss_aware_k": 3, "loss_rate": 0.5, "intra_refresh": 40,
     "row_slices": 3}],
    ids=["ippp_er", "ipb_er", "rows_er"])
def test_error_resilient_encoders_on_card_match_cpu(cuda, kw):
    """Loss-aware RDO and intra refresh on the card write the streams and
    recons they write on the CPU."""
    frames = moving_frames(6, 176, 144, seed=8)
    cfg = EncoderConfig(**{**dict(width=176, height=144, qp=28, fast=True,
                                  rd=True, entropy="cabac", num_ref_frames=2,
                                  search_range=8, sei_text="er"), **kw})
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    before = K11.propagate_drift.launches
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    assert K11.propagate_drift.launches > before
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)
    assert torch.equal(card._lsim.drift.cpu(), cpu._lsim.drift)


# ---------------------------------------------------------------------------
# the legacy P16x16 path (rd=False): K12 p16_search, K13 p16_refine
# ---------------------------------------------------------------------------

def _legacy_inputs(case, W, H, R, dev):
    """(cur (Y, U, V), reference state) int32 on `dev`: a seeded picture
    against the previous one's state, or a built case."""
    if case == "seeded":
        fr = moving_frames(2, W, H, seed=W)
        ref = fast.ref_resources(*(np.asarray(p, np.int32) for p in fr[0]),
                                 device=dev)
        cur = tuple(torch.as_tensor(np.asarray(p, np.int32), device=dev)
                    for p in fr[1])
        return cur, ref
    cur, ref = p16_built_case(case, H, W, R, seed=11)
    return (tuple(torch.as_tensor(x, device=dev) for x in cur),
            tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                  for x in ref))


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("case", ["seeded", *P16_CASES])
@pytest.mark.parametrize("W,H,R", [(176, 144, 8), (352, 288, 28)],
                         ids=["qcif-r8", "cif-r28"])
def test_p16_kernels_match_plain(cuda, W, H, R, case, qp):
    cur, ref = _legacy_inputs(case, W, H, R, cuda)
    lam = _lam(qp)
    before = (P16.p16_search.launches, P16.p16_refine.launches)
    got = P16.p16_search(cur[0], ref[0], R, lam)
    want = P16.search_plain(cur[0], ref[0], R, lam)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if case == "edges":
        assert min(p16_reached(got[0].cpu(), got[1].cpu(), R).values()) > 0
    # ref[1:4] are views of a K2 bank (seeded) or planes of their own
    got = P16.p16_refine(*cur, *ref, got[0], got[1], qp, qp, lam)
    want = P16.refine_tq_plain(*cur, *ref, want[0], want[1], qp, qp, lam)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (P16.p16_search.launches, P16.p16_refine.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", ["seeded", *P16_CASES])
@pytest.mark.parametrize("R", [0, 1, 8, 16, 28, 32])
@pytest.mark.parametrize("W,H", [(16, 16), (64, 48), (176, 144), (352, 288),
                                 (1280, 720)], ids=lambda v: str(v))
def test_p16_search_matches_plain_built(cuda, W, H, R, case):
    """p16_search (packed u8 windows, __dp4a) at one MB, 64x48, QCIF, CIF
    and 720p, R 0 (one cell), 1, 8, 16, 28 and 32 (tiles that do not
    divide 2R + 1), on a seeded picture and tools/p16_cases.py's 0/255,
    255/0, flat (every SSD ties: the rate or the first p decides) and
    edge-motion cases, at lambdas 0 and of QP 28 and 51; two launches
    each on unchanged inputs."""
    if case == "seeded":  # two moving frames, cut to W x H
        fr = [[np.asarray(p, np.int32)[:H >> k, :W >> k]
               for k, p in zip((0, 1, 1), f)]
              for f in moving_frames(2, max(W, 64), max(H, 64), seed=W + R)]
        ref = fast.ref_resources(*fr[0], device=cuda)[0]
        cur = torch.as_tensor(fr[1][0], device=cuda)
    else:
        cur, ref = p16_built_case(case, H, W, R, seed=R + 11)
        cur = torch.as_tensor(cur[0], device=cuda)
        ref = torch.as_tensor(np.ascontiguousarray(ref[0]), device=cuda)
    for lam in (0, _lam(28), _lam(51)):
        want = P16.search_plain(cur, ref, R, lam)
        before = P16.p16_search.launches
        for _ in range(2):
            got = P16.p16_search(cur, ref, R, lam)
            torch.cuda.synchronize()
            for name, g, x in zip(("mvx", "mvy", "grid0"), got, want):
                assert g.dtype == x.dtype and torch.equal(g, x), (name, lam)
        assert P16.p16_search.launches == before + 2
        if case == "flat" and lam == 0:
            assert bool((got[0] == -R).all() and (got[1] == -R).all())


@pytest.mark.parametrize("case", ["seeded", *P16_CASES])
@pytest.mark.parametrize("R", [0, 8, 28, 32])
@pytest.mark.parametrize("W,H", [(16, 16), (48, 32), (176, 144), (352, 288),
                                 (1280, 720)], ids=lambda v: str(v))
def test_p16_refine_matches_plain_built(cuda, W, H, R, case):
    """p16_refine (a warp an MB on packed u8 windows) at one MB, 48x32,
    QCIF, CIF and 720p, on a seeded picture against the previous one's K2
    bank and on tools/p16_cases.py's built ones, at QP 0, 28 and 51: from
    the plain search's vectors at R 0, 8, 28 and 32 (the edges case's
    windows wrap and clamp at R 32), and from vectors whose windows move
    (p16_cases.moved_vectors: the corner MBs at +-(R + 1), vectors beyond
    the pad and at the int32 extremes); two launches each on unchanged
    inputs."""
    if case == "seeded":  # two moving frames, cut to W x H
        fr = [[np.ascontiguousarray(np.asarray(p, np.int32)[:H >> k, :W >> k])
               for k, p in zip((0, 1, 1), f)]
              for f in moving_frames(2, max(W, 64), max(H, 64), seed=W + R)]
        ref = fast.ref_resources(*fr[0], device=cuda)
        cur = tuple(torch.as_tensor(p, device=cuda) for p in fr[1])
    else:
        cur, ref = _legacy_inputs(case, W, H, R, cuda)
    moved = tuple(torch.as_tensor(v, device=cuda)
                  for v in p16_moved_vectors(H, W, R, seed=W + R))
    for qp in (0, 28, 51):
        lam = _lam(qp)
        searched = P16.search_plain(cur[0], ref[0], R, lam)[:2]
        for what, (mx, my) in (("searched", searched), ("moved", moved)):
            want = P16.refine_tq_plain(*cur, *ref, mx, my, qp, qp, lam)
            before = P16.p16_refine.launches
            for _ in range(2):
                got = P16.p16_refine(*cur, *ref, mx, my, qp, qp, lam)
                torch.cuda.synchronize()
                for i, (g, x) in enumerate(zip(got, want)):
                    assert g.dtype == x.dtype and torch.equal(g, x), (
                        what, qp, i)
            assert P16.p16_refine.launches == before + 2


def test_p16_kernels_reject_bad_input(cuda):
    cur, ref = _legacy_inputs("seeded", 64, 48, 4, cuda)
    with pytest.raises(ValueError, match="search range"):
        P16.p16_search(cur[0], ref[0], 33, 0)
    with pytest.raises(ValueError, match="ref_pad"):
        P16.p16_search(cur[0], ref[0][1:], 4, 0)
    mx, my, _ = P16.p16_search(cur[0], ref[0], 4, 0)
    with pytest.raises(ValueError, match="b must"):
        P16.p16_refine(*cur, ref[0], ref[1][:, 1:], *ref[2:], mx, my, 28,
                       28, 0)
    with pytest.raises(ValueError, match="qp"):
        P16.p16_refine(*cur, *ref, mx, my, 52, 28, 0)


@pytest.mark.parametrize("kw", [
    {"entropy": "cavlc"}, {"entropy": "cabac", "pipeline_depth": 1},
    {"entropy": "cabac", "idr_period": 2}],
    ids=["cavlc-depth8", "cabac-depth1", "cabac-idr2"])
def test_legacy_encoder_on_card_matches_cpu(cuda, kw):
    frames = moving_frames(5, 176, 144, seed=8)
    cfg = EncoderConfig(width=176, height=144, qp=28, fast=True, rd=False,
                        search_range=28, **kw)
    card = H264Encoder(cfg)
    cpu = H264Encoder(cfg, device="cpu")
    before = P16.p16_refine.launches
    assert card.encode_sequence(frames) == cpu.encode_sequence(frames)
    assert P16.p16_refine.launches > before
    for (_, a), (_, b) in zip(card.all_recons, cpu.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(card._dev_ref, cpu._dev_ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("content", SLAB_CONTENTS)
@pytest.mark.parametrize("r", [0, 1, 2], ids=["top", "middle", "bottom"])
@pytest.mark.parametrize("Hg,W", [(16, 64), (32, 64), (144, 352),
                                  (240, 1280)], ids=lambda v: str(v))
def test_ref_bank_rows_matches_plain(cuda, Hg, W, r, content):
    ext = [torch.as_tensor(x, device=cuda)
           for x in built_slab(content, Hg, W, r, 3)]
    before = K2.ref_bank_rows.launches
    got = K2.ref_bank_rows(*ext)
    assert K2.ref_bank_rows.launches == before + 1
    for g, w in zip(got, K2.ref_bank_rows_plain(*ext)):
        assert torch.equal(g, w)


def test_ref_bank_rows_rejects_bad_input(cuda):
    Y = torch.zeros((96, 64), dtype=torch.int32, device=cuda)
    U = torch.zeros((80, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K2.ref_bank_rows(Y.float(), U, U)
    with pytest.raises(ValueError):
        K2.ref_bank_rows(Y, U[:, :16], U)


def test_sharded_gop_on_card_matches_chain(cuda):
    """A (frame 1, row 2) mesh of gloo ranks sharing the card: 3 P
    pictures of 64 lines in 2 tile rows equal the single-device chain on
    the card, and every rank launched ref_bank_rows once a picture."""
    S, G = 3, 2
    cy, cu, cv, y0, u0, v0 = DRY.gop_inputs(1, G, S)
    H, W = cy.shape[2:]
    lam = _lam(28)
    step = SHD.rd_gop_rows_sharded(Mesh(1, G, "gloo", "cuda"), S=S, H=H,
                                   W=W, R=8, qp=28, qp_c=28, lam=lam)

    def rows(a):
        return a.reshape(*a.shape[:-2], G, a.shape[-2] // G, a.shape[-1])

    host_outs, recons = step(*map(rows, (cy, cu, cv, y0, u0, v0)))
    for info in step.ranks:
        assert info["device"].startswith("cuda")
        assert info["launches"]["ref_bank_rows"] == S
        assert info["launches"]["intra_commit"] == S
    bank, cpad = rd.ref_entry_from_planes(y0[0], u0[0], v0[0], device=cuda)
    for s in range(S):
        ho, rec, (bank, cpad, _) = rd_rows.rd_p_rows_pipeline(
            cy[0, s], cu[0, s], cv[0, s], bank[None], cpad[None], H=H, W=W,
            R=8, qp=28, qp_c=28, lam=lam, lam_me=lam, G=G, device=cuda)
        np.testing.assert_array_equal(host_outs[0, s], ho.cpu().numpy())
        for got, x in zip(recons, rec):
            np.testing.assert_array_equal(got[0, s].reshape(x.shape),
                                          x.cpu().numpy())
