"""The decoder's inter reconstruction (decode_inter_plain, the plain
version of K8) and the 8x8 inverse transform and dequant of the port,
held against the reference package on the CPU, exactly.

K8's inputs are recorded from the reference's own device decode
(``h264_tpu.decoder.device._decode_inter``) of in-repo streams, and built
from a seed (h264_tpu_torch/tools/decode_cases.py: far mvs, ref_idx up to
9, explicit and implicit WP, T8 MBs, QP 0 and 51, wrapping dequant).
All inputs are QCIF, so the reference compiles few specializations.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.decoder import device as JDEV
from h264_tpu.decoder.decoder import decode_annexb as jax_decode
from h264_tpu.ops import quant as JQ
from h264_tpu.ops import transforms as JTR
from h264_tpu_torch.convert import decode_inter_args_from_numpy
from h264_tpu_torch.decoder import device as DEV
from h264_tpu_torch.decoder import mbtables as M
from h264_tpu_torch.kernels import decode_inter as K8
from h264_tpu_torch.ops import quant as Q
from h264_tpu_torch.ops import transforms as TR
from h264_tpu_torch.tools.decode_cases import NS, built_cases, clip_sides

STREAMS = pathlib.Path(__file__).parent / "streams"
RECORDED = ["wp_p", "wp_b_expl", "wp_b_impl", "cavlc_t8", "qmat_sps",
            "multiref", "tdirect", "wpfade_bimpl"]


@pytest.fixture(scope="module")
def recorded():
    """stream -> [(args (25 numpy arrays), H, W, NS, reference output)]
    of every ``_decode_inter`` call of the reference's device decode."""
    orig = JDEV._decode_inter
    out = {}
    calls = []

    def rec(*args, H, W, NS):
        res = orig(*args, H=H, W=W, NS=NS)
        calls.append(([np.asarray(a) for a in args], H, W, NS,
                      np.asarray(res)))
        return res

    JDEV._decode_inter = rec
    try:
        for name in RECORDED:
            calls = []
            jax_decode((STREAMS / f"{name}.264").read_bytes(),
                       use_device=True)
            out[name] = calls
    finally:
        JDEV._decode_inter = orig
    return out


@pytest.mark.parametrize("name", RECORDED)
def test_decode_inter_plain_matches_reference_recorded(recorded, name):
    calls = recorded[name]
    assert calls, f"{name}: no inter picture"
    for args, H, W, ns, want in calls:
        got = DEV.decode_inter_plain(
            *decode_inter_args_from_numpy(args, "cpu"), H=H, W=W, NS=ns)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the wrapper takes the plain version for CPU tensors
        got_w = K8.decode_inter(*decode_inter_args_from_numpy(args, "cpu"),
                                H=H, W=W, NS=ns)
        assert torch.equal(got_w, got)


def test_recorded_inputs_cover_the_cases(recorded):
    """The recorded calls carry T8 MBs, scaling lists, both WP modes and
    bi-prediction."""
    allc = [c for cs in recorded.values() for c in cs]
    assert any(a[16].any() for a, *_ in allc)  # t8
    assert any((a[22] != JDEV._ILS4).any() for a, *_ in allc)  # qmat
    modes = {int(m) for a, *_ in allc for m in a[6]}
    assert {1, 2} <= modes
    assert any(((a[4][0] >= 0) & (a[4][1] >= 0)).any() for a, *_ in allc)


@pytest.mark.parametrize("case", range(3), ids=["far-wp-t8", "far-wp-4x4",
                                                "wrap"])
def test_decode_inter_plain_matches_reference_built(case):
    H, W = 144, 176
    name, args = built_cases(H, W, seed=11)[case]
    sides = clip_sides(args[3], H, W)
    assert all(v > 0 for d in sides.values() for v in d.values()), sides
    want = np.asarray(JDEV._decode_inter(*map(jnp.asarray, args), H=H, W=W,
                                         NS=NS))
    got = DEV.decode_inter_plain(*decode_inter_args_from_numpy(args, "cpu"),
                                 H=H, W=W, NS=NS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_order_formula():
    """K8 maps raster 4x4 position (by, bx) to JM order by formula."""
    for blk, (bx, by) in enumerate(M.BLK4_TO_XY.tolist()):
        assert (by >> 1) * 8 + (bx >> 1) * 4 + (by & 1) * 2 + (bx & 1) == blk
        assert DEV._PERM4[by * 4 + bx] == blk


def test_inverse8x8_matches_reference():
    rs = np.random.RandomState(5)
    c = rs.randint(-4000, 4000, (50, 8, 8)).astype(np.int32)
    want = np.asarray(JTR.inverse8x8(c))
    np.testing.assert_array_equal(TR.inverse8x8(c), want)  # numpy path
    np.testing.assert_array_equal(TR.inverse8x8(torch.as_tensor(c)).numpy(),
                                  want)
    c64 = c.astype(np.int64)  # the host recon's int64 path
    np.testing.assert_array_equal(TR.inverse8x8(c64), JTR.inverse8x8(c64))


@pytest.mark.parametrize("fn", ["inverse4x4", "hadamard4x4", "forward4x4"])
def test_4x4_transforms_numpy_path(fn):
    rs = np.random.RandomState(6)
    c = rs.randint(-3000, 3000, (40, 4, 4)).astype(np.int64)
    got = getattr(TR, fn)(c)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, getattr(JTR, fn)(c))
    d = rs.randint(-300, 300, (40, 2, 2)).astype(np.int64)
    np.testing.assert_array_equal(TR.hadamard2x2(d), JTR.hadamard2x2(d))


@pytest.mark.parametrize("qp", [0, 17, 28, 51])
@pytest.mark.parametrize("scaled", [False, True], ids=["flat", "qmat"])
def test_dequant_matches_reference(qp, scaled):
    rs = np.random.RandomState(qp)
    ws4 = rs.randint(4, 80, (4, 4)).astype(np.int32) if scaled else None
    ws8 = rs.randint(4, 80, (8, 8)).astype(np.int32) if scaled else None
    lev4 = rs.randint(-60, 60, (9, 4, 4)).astype(np.int32)
    lev8 = rs.randint(-60, 60, (9, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(Q.inv_level_scale4(qp % 6, ws4),
                                  JQ.inv_level_scale4(qp % 6, ws4))
    np.testing.assert_array_equal(Q.inv_level_scale8(qp % 6, ws8),
                                  JQ.inv_level_scale8(qp % 6, ws8))
    np.testing.assert_array_equal(Q.dequant4x4(lev4, qp, ws4),
                                  JQ.dequant4x4(lev4, qp, ws4))
    np.testing.assert_array_equal(Q.dequant8x8(lev8, qp, ws8),
                                  JQ.dequant8x8(lev8, qp, ws8))
    np.testing.assert_array_equal(
        Q.dequant8x8(torch.as_tensor(lev8), qp, ws8).numpy(),
        JQ.dequant8x8(lev8, qp, ws8))
    dc = rs.randint(-500, 500, (4, 4)).astype(np.int64)
    np.testing.assert_array_equal(Q.dequant_luma_dc(dc, qp, ws4),
                                  JQ.dequant_luma_dc(dc, qp, ws4))
    np.testing.assert_array_equal(Q.dequant_chroma_dc(dc[:2, :2], qp, ws4),
                                  JQ.dequant_chroma_dc(dc[:2, :2], qp, ws4))
    np.testing.assert_array_equal(Q.DEQUANT8, JQ.DEQUANT8)
