"""The port's host-path encoder (the reference's default configuration,
``fast=False``) vs the JAX package's, on the CPU: identical Annex-B bytes
and recon planes for 3 seeded 176x144 frames at search range 8 (CAVLC
IPPP at QP 0, 28 and 51 with and without sub-pel refinement, CABAC,
``idr_period=2``, ``enable_i4=False``, the 8x8 transform, the scaling
matrices of the in-repo qmat stream), every stream decoding through the
port's decoder to the encoder's recons; the lone P picture of a B
configuration.  B pictures: test_torch_host_b.py; slices, FMO, data
partitioning and redundant slices: test_torch_host_slices.py."""

import numpy as np
import pytest

from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from torch_host_pairs import (BASE, assert_decodes_to_recons,
                              assert_recons_equal, assert_streams_equal,
                              encode_pair, frames, qmat_scaling_lists)

N = 3
CONFIGS = {
    **{f"default-qp{q}": dict(qp=q) for q in (0, 28, 51)},
    **{f"nosubpel-qp{q}": dict(qp=q, subpel=False) for q in (0, 28, 51)},
    "cabac": dict(entropy="cabac"),
    "idr2": dict(idr_period=2),
    "no-i4": dict(enable_i4=False),
    "t8": dict(transform8x8=True),
    "qmat": dict(scaling_lists="qmat"),
    "qmat-t8": dict(scaling_lists="qmat", transform8x8=True, entropy="cabac"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = dict(CONFIGS[request.param])
    if kw.get("scaling_lists") == "qmat":
        kw["scaling_lists"] = qmat_scaling_lists()
    return encode_pair(kw, N)


def test_stream_byte_identical(pair):
    assert_streams_equal(pair)


def test_recons_equal(pair):
    assert_recons_equal(pair, N)


def test_stream_decodes_to_recons(pair):
    assert_decodes_to_recons(pair, N)


def test_default_configuration_is_the_host_path():
    """EncoderConfig's defaults (fast=False, CAVLC) code every P picture
    on the host path: SAD grids (K10's plain version here), the MB loop,
    Baseline profile; the I picture goes to the device intra pipeline."""
    enc = H264Encoder(EncoderConfig(176, 144), device="cpu")
    assert not enc.cfg.fast and enc.cfg.entropy == "cavlc"
    assert enc.sps.profile_idc == 66 and not enc._multi_slice
    from h264_tpu_torch.kernels import sad_grid as K10

    calls = []
    enc._sad_grid = lambda *a: calls.append(a[2]) or K10.sad_grid_16x16(*a)
    enc.encode_sequence(frames(2))
    assert calls == [16]
    padded = enc.recon_pics[-1][3]
    assert padded is not None and not enc._rd_refs


def test_scaling_lists_signal_high_profile():
    ws = qmat_scaling_lists()
    enc = H264Encoder(EncoderConfig(176, 144, scaling_lists=ws), device="cpu")
    assert enc.sps.profile_idc == 100
    assert enc.sps.seq_scaling_matrix_present_flag
    assert not enc.pps.transform_8x8_mode_flag
    np.testing.assert_array_equal(enc._ws4, ws[0])
    np.testing.assert_array_equal(enc._ws8, ws[1])


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_lone_p_picture_of_a_host_b_configuration(entropy):
    """A P picture coded alone (encode_frame) in a B configuration: the
    reference codes it on its host path, and so does the port."""
    kw = dict(BASE, b_frames=1, entropy=entropy)
    fr = frames(N)
    jenc = JaxEncoder(JaxConfig(**kw))
    tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
    for i, is_idr in ((0, True), (1, False), (2, False)):
        a = jenc.encode_frame(fr[i], is_idr)
        b = tenc.encode_frame(fr[i], is_idr)
        assert [(x.nal_unit_type, x.rbsp) for x in a] == [
            (x.nal_unit_type, x.rbsp) for x in b]
    assert [p for p, _ in tenc.all_recons] == [0, 2, 4]
    assert_recons_equal((jenc, None, tenc, None), N)


def test_lone_p_picture_of_a_fast_b_configuration_fails_in_both():
    """With fast=True (one slice) the reference's RD pictures keep no
    padded planes, and its host-path P picture fails on them; the port
    refuses the picture, saying why."""
    kw = dict(BASE, b_frames=1, fast=True, rd=True, entropy="cabac")
    fr = frames(2)
    jenc = JaxEncoder(JaxConfig(**kw))
    jenc.encode_frame(fr[0], True)
    with pytest.raises(TypeError):
        jenc.encode_frame(fr[1], False)
    tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
    tenc.encode_frame(fr[0], True)
    with pytest.raises(NotImplementedError, match="reference package fails"):
        tenc.encode_frame(fr[1], False)
