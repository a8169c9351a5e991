"""Port IPPP CABAC encode (h264_tpu_torch) vs the JAX package, on the CPU,
with explicit weighted prediction: byte-identical Annex-B stream, equal
recon planes and reference entries (bank, cpad, colocated motion), for 5
moving, fading 176x144 frames (num_ref_frames 2, search range 8) at QP 0,
28 and 51.  Each P picture's ``rd_p_pipeline`` outputs are also held
against the reference's from the reference's own DPB state, carried over
with ``convert.encoder_refs_from_numpy``.  WP off and the CAVLC
(Baseline) stream: test_torch_p_encode_nowp.py; the 8x8 transform:
test_torch_t8_encode*.py.  The helpers take the entropy coder and the
8x8 transform as options (``entropy``, ``t8``)."""

import functools

import numpy as np
import pytest
import torch

from h264_tpu.decoder.decoder import decode_annexb
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.convert import encoder_refs_from_numpy
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, N = 176, 144, 5
# the plain pipeline's tensors are small: one thread per test worker is
# faster than several workers each spreading over every core
torch.set_num_threads(1)


def _cfg(cls, qp, wp, entropy="cabac", t8=False):
    return cls(width=W, height=H, qp=qp, fast=True, rd=True, entropy=entropy,
               num_ref_frames=2, search_range=8, weighted_pred=wp,
               transform8x8=t8)


@functools.lru_cache(maxsize=None)
def frames():
    return moving_frames(N, W, H, seed=11)


def _record_p(enc, snaps):
    """Wrap enc._start_p_rd: before each P picture keep the encoder's DPB
    and WP state, after it the picture's pending outputs."""
    start = enc._start_p_rd

    def rec(yuv, *a, **kw):
        snap = {"yuv": yuv, "refs": list(enc._rd_refs),
                "src": (dict(enc._src_dc), dict(enc._src_sd),
                        dict(enc._src_ds)),
                "frame_num": enc.frame_num, "prev_poc": enc._prev_poc,
                "kw": kw}
        pend = start(yuv, *a, **kw)
        snap.update(pending=pend, entry=enc._rd_refs[0])
        snaps.append(snap)
        return pend

    enc._start_p_rd = rec


@functools.lru_cache(maxsize=None)
def jax_encode(qp: int, wp: bool, **kw):
    """(JAX encoder, its stream, its P snapshots)."""
    jenc, jsnaps = JaxEncoder(_cfg(JaxConfig, qp, wp, **kw)), []
    _record_p(jenc, jsnaps)
    return jenc, jenc.encode_sequence(frames()), jsnaps


@functools.lru_cache(maxsize=None)
def port_encode(qp: int, wp: bool, **kw):
    """(port encoder, its stream, its P snapshots)."""
    tenc, tsnaps = H264Encoder(_cfg(EncoderConfig, qp, wp, **kw),
                               device="cpu"), []
    _record_p(tenc, tsnaps)
    return tenc, tenc.encode_sequence(frames()), tsnaps


def encode(qp: int, wp: bool, **kw):
    return jax_encode(qp, wp, **kw) + port_encode(qp, wp, **kw)


def _np(x):
    return np.asarray(x)


def check_stream(qp, wp, **kw):
    _, jstream, _, _, tstream, _ = encode(qp, wp, **kw)
    assert len(tstream) > 100
    assert tstream == jstream


def check_recon_and_refs(qp, wp, **kw):
    jenc, _, _, tenc, _, _ = encode(qp, wp, **kw)
    assert len(tenc.all_recons) == len(jenc.all_recons) == N
    for (pa, a), (pb, b) in zip(jenc.all_recons, tenc.all_recons):
        assert pa == pb
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(y, _np(x))
    assert len(tenc._rd_refs) == len(jenc._rd_refs) == 2
    for (jp, jb, jc, jcol), (tp, tb, tc, tcol) in zip(jenc._rd_refs,
                                                      tenc._rd_refs):
        assert jp == tp
        np.testing.assert_array_equal(tb.numpy(), _np(jb))
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        for x, y in zip(tcol, jcol):
            np.testing.assert_array_equal(x.numpy(), _np(y))


def check_decodes(qp, wp, **kw):
    """The reference package's decoder reconstructs the port's recon."""
    _, _, _, tenc, tstream, _ = encode(qp, wp, **kw)
    pics = decode_annexb(tstream)
    assert len(pics) == N
    for pic, (_, rec) in zip(pics, tenc.all_recons):
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(_np(x), y)


def check_p_from_jax_state(snaps, cfg_):
    """Each P snapshot restarted in a fresh port encoder from the JAX
    encoder's DPB (banks, cpads, colocated motion) and WP statistics:
    host_out, recon and next entry equal the reference's."""
    for snap in snaps:
        tenc = H264Encoder(cfg_, device="cpu")
        encoder_refs_from_numpy(
            tenc, [(p, _np(b), _np(c), tuple(_np(x) for x in col))
                   for p, b, c, col in snap["refs"]], src=snap["src"])
        tenc.frame_num, tenc._prev_poc = snap["frame_num"], snap["prev_poc"]
        (host_out, recon, frame_num, poc, ref_pocs, _, wpw,
         _) = tenc._start_p_rd(snap["yuv"], **snap["kw"])
        jp = snap["pending"]
        assert (frame_num, poc, ref_pocs, wpw) == (jp[3], jp[4], jp[5], jp[7])
        np.testing.assert_array_equal(host_out.numpy(), _np(jp[1]))
        for x, y in zip(recon, jp[2]):
            np.testing.assert_array_equal(x.numpy(), _np(y))
        (tp, tb, tc, tcol), (jpoc, jb, jc, jcol) = tenc._rd_refs[0], snap[
            "entry"]
        assert tp == jpoc
        for x, y in zip((tb, tc, *tcol), (jb, jc, *jcol)):
            np.testing.assert_array_equal(x.numpy(), _np(y))


def check_pipeline_from_jax_state(qp, wp, every=False, **kw):
    """The first P picture (one reference) and the last (a full DPB), or
    `every` P picture, from the JAX encoder's state (check_p_from_jax_state)."""
    jsnaps = jax_encode(qp, wp, **kw)[2]
    assert len(jsnaps) == N - 1
    check_p_from_jax_state(jsnaps if every else (jsnaps[0], jsnaps[-1]),
                           _cfg(EncoderConfig, qp, wp, **kw))


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_stream_byte_identical(qp):
    check_stream(qp, True)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_recon_and_refs_equal(qp):
    check_recon_and_refs(qp, True)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_stream_decodes_to_port_recon(qp):
    check_decodes(qp, True)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_pipeline_from_jax_state(qp):
    check_pipeline_from_jax_state(qp, True)


def _host_parts(host_out, n_mb):
    sizes = [n_mb, 4 * n_mb, 4 * n_mb, n_mb, 16 * n_mb, 16 * n_mb, n_mb,
             n_mb, 256 * n_mb, 256 * n_mb, 16 * n_mb, 128 * n_mb, 8 * n_mb,
             16 * n_mb]
    return np.split(host_out.numpy(), np.cumsum(sizes)[:-1])


def test_stream_exercises_the_p_path():
    """The QP 28 WP stream takes every kind of decision the path has."""
    tsnaps = port_encode(28, True)[2]
    n_mb = (W // 16) * (H // 16)
    win, ref8, sub = [], [], []
    for s in tsnaps:
        parts = _host_parts(s["pending"][0], n_mb)
        win.append(parts[0])
        ref8.append(parts[1].reshape(n_mb, 4))
        sub.append(parts[2].reshape(n_mb, 4))
    win, ref8, sub = map(np.concatenate, (win, ref8, sub))
    inter = win < TP.C_I16
    assert (win == TP.C_SKIP).any() or (win == TP.C_P16PMV).any()
    assert (win == TP.C_P16x16).any()
    assert ((win == TP.C_P8x8)[:, None] & (sub > 0)).any()
    assert ((win == TP.C_I16) | (win == TP.C_I4)).any()
    assert (inter[:, None] & (ref8 > 0)).any()
    assert any(w != (32, 0) for s in tsnaps for w in s["pending"][6])


def test_levels_and_mvs_within_the_bit_length_range():
    """The integer `_bitlen` equals the reference's below 8192: levels and
    mvd codes of every QP stay far below it (test_torch_p_ops.py has the
    analytic bounds)."""
    n_mb = (W // 16) * (H // 16)
    for qp in (0, 28, 51):
        for s in port_encode(qp, True)[2]:
            parts = _host_parts(s["pending"][0], n_mb)
            lev = np.abs(np.concatenate([parts[8], parts[10], parts[11],
                                         parts[12]]))
            mv = np.abs(np.concatenate([parts[4], parts[5]]))
            assert lev.max() < 8192 and 2 * (2 * mv.max()) + 1 < 8192


def test_idr_period_stream_byte_identical():
    """An IDR every 2 pictures (I P I P I): the DPB, frame_num and POC
    restart at each IDR as in the reference."""
    fr = frames()
    jcfg, tcfg = _cfg(JaxConfig, 28, True), _cfg(EncoderConfig, 28, True)
    jcfg.idr_period = tcfg.idr_period = 2
    jstream = JaxEncoder(jcfg).encode_sequence(fr)
    tenc = H264Encoder(tcfg, device="cpu")
    assert tenc.encode_sequence(fr) == jstream
    assert [p for p, _ in tenc.all_recons] == [0, 2, 0, 2, 0]
