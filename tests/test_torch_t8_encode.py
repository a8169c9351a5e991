"""Port encodes with the FRExt 8x8 transform (High profile,
``transform8x8``) vs the JAX package, on the CPU, with explicit weighted
prediction: IPPP CABAC at QP 0, 28 and 51, IPPP CAVLC at QP 28 and IPB
CABAC at QP 28 (the reduced bench configuration of
test_torch_b_encode.py).  Byte-identical Annex-B streams, equal recons and
reference entries, and every P (and B) picture's pipeline outputs --
``host_out`` with the transform_size_8x8 flags and 8x8 levels -- from the
reference encoder's own DPB state.  Every P picture here runs the
reference's ``rd_p_pipeline(use_t8=True, use_wp=True)``, so this file's
worker compiles that specialization once for all of them; without WP:
test_torch_t8_encode_nowp.py.  Helpers: test_torch_p_encode.py and
test_torch_b_encode.py."""

import functools

import numpy as np
import pytest

import test_torch_b_encode as bbase
import test_torch_p_encode as base
from h264_tpu.decoder.decoder import decode_annexb as jax_decode
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder

T8 = {"t8": True}
CAVLC_T8 = {"t8": True, "entropy": "cavlc"}


def _parts(host_out, n_mb):
    return base._host_parts(host_out, n_mb)


def t8_mix(snaps, n_mb):
    """(8x8-transform MBs, 4x4 inter MBs) over the P pictures' host_out."""
    n8 = n4 = 0
    for s in snaps:
        parts = _parts(s["pending"][0], n_mb)
        win, t8 = parts[0], parts[3]
        inter = (win < TP.C_I16) & (win != TP.C_SKIP)
        n8 += int((t8 > 0).sum())
        n4 += int((inter & (t8 == 0)).sum())
    return n8, n4


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_stream_byte_identical(qp):
    base.check_stream(qp, True, **T8)
    tenc = base.port_encode(qp, True, **T8)[0]
    assert tenc.sps.profile_idc == 100 and tenc.pps.transform_8x8_mode_flag


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_recon_and_refs_equal(qp):
    base.check_recon_and_refs(qp, True, **T8)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_stream_decodes_to_port_recon(qp):
    base.check_decodes(qp, True, **T8)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_pipeline_from_jax_state(qp):
    """Every P picture: host_out (w_t8 and w_lev8 included), recon and
    the next reference entry."""
    base.check_pipeline_from_jax_state(qp, True, every=True, **T8)


@pytest.mark.parametrize("qp", [0, 28])
def test_streams_mix_8x8_and_4x4(qp):
    """Both transform sizes occur among the inter MBs of the QP 0 and 28
    streams (at QP 51 this content quantises the 8x8 residuals to zero,
    and a tie keeps 4x4)."""
    n8, n4 = t8_mix(base.port_encode(qp, True, **T8)[2],
                    (base.W // 16) * (base.H // 16))
    assert n8 > 0 and n4 > 0


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_8x8_levels_within_the_bit_length_bound(qp):
    """Every 8x8 level of the streams is at most 3264 in magnitude (the
    QP 0 bound, tests/test_torch_ops.py), below 8192 where `_bitlen`
    would part from the reference's."""
    n_mb = (base.W // 16) * (base.H // 16)
    for s in base.port_encode(qp, True, **T8)[2]:
        assert np.abs(_parts(s["pending"][0], n_mb)[9]).max() <= 3264


def test_cavlc_stream_byte_identical():
    base.check_stream(28, True, **CAVLC_T8)
    tenc = base.port_encode(28, True, **CAVLC_T8)[0]
    assert tenc.sps.profile_idc == 100
    assert not tenc.pps.entropy_coding_mode_flag


def test_cavlc_recon_and_refs_equal():
    base.check_recon_and_refs(28, True, **CAVLC_T8)


def test_cavlc_stream_decodes_to_port_recon():
    base.check_decodes(28, True, **CAVLC_T8)


def test_cavlc_pipeline_from_jax_state():
    base.check_pipeline_from_jax_state(28, True, every=True, **CAVLC_T8)


def test_cavlc_stream_mixes_8x8_and_4x4():
    n_mb = (base.W // 16) * (base.H // 16)
    n8, n4 = t8_mix(base.port_encode(28, True, **CAVLC_T8)[2], n_mb)
    assert n8 > 0 and n4 > 0


# ---------------------------------------------------------------------------
# IPB with the 8x8 transform on its P pictures (B pictures code 4x4, as
# the reference's rd_b_pipeline has no T8 stage)
# ---------------------------------------------------------------------------

def _ipb_cfg(cls):
    return bbase.cfg(cls, transform8x8=True)


@functools.lru_cache(maxsize=None)
def ipb_encode():
    """(JAX encoder, stream, P snapshots, B snapshots) and the port's."""
    out = []
    for enc in (JaxEncoder(_ipb_cfg(JaxConfig)),
                H264Encoder(_ipb_cfg(EncoderConfig), device="cpu")):
        psnaps, bsnaps = [], []
        base._record_p(enc, psnaps)
        bbase.record_b(enc, bsnaps)
        out.append((enc, enc.encode_sequence(bbase.frames()), psnaps, bsnaps))
    return out


def test_ipb_stream_byte_identical_recon_and_refs_equal():
    (jenc, jstream, _, _), (tenc, tstream, _, _) = ipb_encode()
    bbase.check_stream(jenc, jstream, tenc, tstream, bbase.N)
    assert tenc.sps.profile_idc == 100


def test_ipb_p_pipeline_from_jax_state():
    (_, _, psnaps, _), _ = ipb_encode()
    assert len(psnaps) == 4
    base.check_p_from_jax_state(psnaps, _ipb_cfg(EncoderConfig))


def test_ipb_b_pipeline_from_jax_state():
    (_, _, _, bsnaps), _ = ipb_encode()
    assert len(bsnaps) == 3
    bbase.check_b_from_jax_state(bsnaps, _ipb_cfg(EncoderConfig))


def test_ipb_stream_mixes_8x8_and_4x4():
    _, (_, _, psnaps, _) = ipb_encode()
    n8, n4 = t8_mix(psnaps, (base.W // 16) * (base.H // 16))
    assert n8 > 0 and n4 > 0


def test_ipb_reference_decoder_on_reference_stream():
    """The reference package's own decoder on its own IPB T8 stream: the
    I and P pictures equal the reference encoder's recons, and so do the
    B pictures (ROADMAP Queue 3 records the comparison)."""
    (jenc, jstream, _, _), _ = ipb_encode()
    pics = sorted(jax_decode(jstream), key=lambda p: p.poc)
    recs = sorted(jenc.all_recons, key=lambda e: e[0])
    assert [p.poc for p in pics] == [p for p, _ in recs]
    for pic, (_, rec) in zip(pics, recs):
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
