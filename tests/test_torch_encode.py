"""Port all-intra CABAC encode (h264_tpu_torch.encoder.encoder) vs the JAX
package, on the CPU: byte-identical Annex-B stream, equal recon planes and
reference bank, for 3 seeded 176x144 frames at QP 0, 28 and 51; the
configurations still unported; the carried tables.  The IPPP streams are
in test_torch_p_encode.py, the IPB streams in test_torch_b_encode.py and
test_torch_b_pipeline.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.decoder.decoder import decode_annexb
from h264_tpu.encoder import rd as JRD
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.convert import carried_tables, encoder_refs_from_numpy
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import synthetic_frames

W, H = 176, 144
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, qp, **kw):
    return cls(width=W, height=H, qp=qp, fast=True, rd=True, entropy="cabac",
               idr_period=1, **kw)


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(3, W, H, seed=17)


@pytest.fixture(scope="module", params=[0, 28, 51], ids=lambda q: f"qp{q}")
def encoded(request, frames):
    qp = request.param
    jenc = JaxEncoder(_cfg(JaxConfig, qp))
    jstream = jenc.encode_sequence(frames)
    tenc = H264Encoder(_cfg(EncoderConfig, qp), device="cpu")
    tstream = tenc.encode_sequence(frames)
    return jenc, jstream, tenc, tstream


def test_stream_byte_identical(encoded):
    _, jstream, _, tstream = encoded
    assert len(tstream) > 100
    assert tstream == jstream


def test_recon_and_bank_equal(encoded):
    jenc, _, tenc, _ = encoded
    assert len(tenc.all_recons) == len(jenc.all_recons) == 3
    for (_, a), (_, b) in zip(jenc.all_recons, tenc.all_recons):
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(y, np.asarray(x))
    (jpoc, jbank, jcpad, jcol), = jenc._rd_refs
    (tpoc, tbank, tcpad, tcol), = tenc._rd_refs
    assert jpoc == tpoc
    np.testing.assert_array_equal(tbank.numpy(), np.asarray(jbank))
    np.testing.assert_array_equal(tcpad.numpy(), np.asarray(jcpad))
    for x, y in zip(tcol, jcol):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_stream_decodes_to_port_recon(encoded):
    """The reference package's decoder reconstructs the port's recon."""
    _, _, tenc, tstream = encoded
    pics = decode_annexb(tstream)
    assert len(pics) == 3
    for pic, (_, rec) in zip(pics, tenc.all_recons):
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(np.asarray(x), y)


def test_port_encode_imports_no_jax():
    code = (
        "import sys\n"
        "from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder\n"
        "from h264_tpu_torch.tools.synthseq import synthetic_frames\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cabac',"
        " idr_period=1)\n"
        "s = H264Encoder(cfg, device='cpu').encode_sequence("
        "synthetic_frames(2, 48, 32))\n"
        "assert len(s) > 50\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cabac',"
        " num_ref_frames=2, search_range=8, weighted_pred=True)\n"
        "s = H264Encoder(cfg, device='cpu').encode_sequence("
        "synthetic_frames(2, 48, 32))\n"
        "assert len(s) > 50\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cabac',"
        " b_frames=1, num_ref_frames=2, search_range=8, weighted_pred=True)\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert len(s) > 50 and [p for p, _ in enc.all_recons] == [0, 4, 2]\n"
        "from h264_tpu_torch.decoder.decoder import decode_annexb\n"
        "assert [p.poc for p in decode_annexb(s, device='cpu')] == [0, 2, 4]\n"
        "d = open('tests/streams/wp_b_expl.264', 'rb').read()\n"
        "a = decode_annexb(d, device='cpu')\n"
        "b = decode_annexb(d, use_device=False)\n"
        "assert len(a) == len(b) > 0 and all(\n"
        "    x.to_yuv_bytes() == y.to_yuv_bytes() for x, y in zip(a, b))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "(m.split('.')[0].startswith('h264_tpu') and "
        "m.split('.')[0] != 'h264_tpu_torch'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        H264Encoder(_cfg(EncoderConfig, 28))
    with pytest.raises(RuntimeError, match="CUDA"):
        H264Encoder(_cfg(EncoderConfig, 28), device="cuda")


@pytest.mark.parametrize("kw", [
    {"intra_refresh": 2}, {"b_frames": 1, "rc_bitrate": 1e5},
    {"entropy": "cavlc"},
    {"fast": False}, {"rd": False}, {"slice_mode": 1, "slice_argument": 11},
    {"transform8x8": True}, {"rc_bitrate": 1e5}, {"sei_text": "x"},
    {"row_slices": 2}, {"loss_aware_k": 2},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_configuration_raises(kw):
    base = dict(width=W, height=H, fast=True, rd=True, entropy="cabac",
                idr_period=1)
    base.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        H264Encoder(EncoderConfig(**base), device="cpu")


def test_p_picture_raises(frames):
    """P pictures are ported: the second picture of an IPPP stream now
    encodes on the CPU (this test's name dates from when it raised)."""
    enc = H264Encoder(EncoderConfig(width=W, height=H, fast=True,
                                    entropy="cabac", idr_period=0),
                      device="cpu")
    gen = enc.encode_stream(frames[:2])
    next(gen)
    nals = next(gen)
    assert len(nals) == 1 and nals[0].nal_unit_type == 1
    assert enc.all_recons[1][0] == 2  # the P picture's POC


@pytest.mark.parametrize("name", sorted(carried_tables()))
def test_carried_table_equal(name):
    import importlib

    mod, attr = name.rsplit(".", 1)
    ref = getattr(importlib.import_module(f"h264_tpu.{mod}"), attr)
    ours = carried_tables()[name]
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ours[k]),
                                          np.asarray(ref[k]))
    elif isinstance(ref, (list, tuple)) and ref and hasattr(ref[0], "shape"):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    elif isinstance(ref, (list, tuple)) and ref and isinstance(
            ref[0], (list, tuple)):
        assert ours == ref  # nested, possibly ragged, lists of ints
    else:
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_encoder_refs_from_jax_entries(frames):
    Y, U, V = (np.asarray(p, np.int32) for p in frames[0])
    bank, cpad = JRD.ref_entry_from_planes(*map(jnp.asarray, (Y, U, V)))
    col = (np.ones((H // 4, W // 4), bool),
           *(np.zeros((H // 4, W // 4), np.int32) for _ in range(3)))
    enc = H264Encoder(_cfg(EncoderConfig, 28), device="cpu")
    encoder_refs_from_numpy(enc, [(0, np.asarray(bank), np.asarray(cpad),
                                   col)])
    (poc, b, c, tcol), = enc._rd_refs
    assert poc == 0 and b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.asarray(bank))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cpad))
    assert tcol[0].dtype == torch.bool and tcol[0].all()
