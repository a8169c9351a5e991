"""Port all-intra encode (h264_tpu_torch.encoder.encoder) vs the JAX
package, on the CPU: byte-identical Annex-B stream, equal recon planes and
reference bank, for 3 seeded 176x144 frames at QP 0, 28 and 51, CABAC
and CAVLC (Baseline); the native CAVLC slice writer against the
reference's Python writer on I and P parse states; the configurations
still unported; the carried tables.  The IPPP streams are in
test_torch_p_encode*.py, the IPB streams in test_torch_b_encode.py and
test_torch_b_pipeline.py, the 8x8 transform in test_torch_t8_encode*.py."""

import copy
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
from h264_tpu.encoder.syntax_cavlc import CavlcSliceWriter as JaxCavlcWriter
from h264_tpu.syntax import parsets as JPS
from h264_tpu.syntax import slice_header as JSH
from h264_tpu_torch import native
from h264_tpu_torch.bitstream.writer import BitWriter
from h264_tpu_torch.convert import carried_tables, encoder_refs_from_numpy
from h264_tpu_torch.encoder import syntax_cavlc as TCV
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames

W, H = 176, 144
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, qp, **kw):
    kw.setdefault("entropy", "cabac")
    return cls(width=W, height=H, qp=qp, fast=True, rd=True, idr_period=1,
               **kw)


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


@pytest.fixture(scope="module", params=[0, 28, 51], ids=lambda q: f"qp{q}")
def encoded_cavlc(request, frames):
    qp = request.param
    jenc = JaxEncoder(_cfg(JaxConfig, qp, entropy="cavlc"))
    tenc = H264Encoder(_cfg(EncoderConfig, qp, entropy="cavlc"), device="cpu")
    return jenc, jenc.encode_sequence(frames), tenc, tenc.encode_sequence(
        frames)


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


def test_cavlc_stream_byte_identical(encoded_cavlc):
    _, jstream, tenc, tstream = encoded_cavlc
    assert len(tstream) > 100
    assert tstream == jstream
    assert tenc.sps.profile_idc == 66
    assert not tenc.pps.entropy_coding_mode_flag


def test_cavlc_recon_and_bank_equal(encoded_cavlc):
    test_recon_and_bank_equal(encoded_cavlc)


def test_cavlc_stream_decodes_to_port_recon(encoded_cavlc):
    test_stream_decodes_to_port_recon(encoded_cavlc)


def _as_reference(obj, cls):
    """A reference-package header object with the fields of the port's
    copy (the writers read plain fields and the slice type)."""
    out = cls.__new__(cls)
    out.__dict__.update(copy.deepcopy(obj.__dict__))
    return out


@pytest.fixture(scope="module")
def cavlc_slices():
    """(st, sps, pps, sh) of each slice of a port CAVLC IPPP encode (I
    then P pictures, 96x64, WP off), as its writer got them."""
    out = []
    write = TCV.CavlcSliceWriter.write_slice_data

    def rec(self, w, addrs, *a, **kw):
        out.append((copy.deepcopy(self.st), self.sps, self.pps, self.sh))
        write(self, w, addrs, *a, **kw)

    TCV.CavlcSliceWriter.write_slice_data = rec
    try:
        cfg = EncoderConfig(width=96, height=64, qp=26, fast=True,
                            entropy="cavlc", num_ref_frames=2,
                            search_range=8)
        H264Encoder(cfg, device="cpu").encode_sequence(
            moving_frames(3, 96, 64, seed=5))
    finally:
        TCV.CavlcSliceWriter.write_slice_data = write
    return out


def _slice_bits(writer, st):
    w = BitWriter()
    writer.write_slice_data(w, list(range(st.n_mbs)))
    return w.raw_bits()


def test_native_cavlc_writer_matches_reference_python_writer(
        cavlc_slices, monkeypatch):
    """The port's native CAVLC writer (native/cavlc_writer.c) writes the
    bits the reference's Python CavlcSliceWriter writes on the same I and
    P parse states, and it is the path the port takes for them."""
    taken = []
    fn = native.cavlc_write_slice

    def counted(*a, **kw):
        res = fn(*a, **kw)
        taken.append(res is not None)
        return res

    monkeypatch.setattr(native, "cavlc_write_slice", counted)
    kinds = []
    for st, sps, pps, sh in cavlc_slices:
        ours = _slice_bits(TCV.CavlcSliceWriter(st, sps, pps, sh), st)
        ref = JaxCavlcWriter(st, _as_reference(sps, JPS.SPS),
                             _as_reference(pps, JPS.PPS),
                             _as_reference(sh, JSH.SliceHeader))
        ref.trace = []  # the reference's Python path
        assert ours == _slice_bits(ref, st)
        kinds.append(sh.slice_type.name)
    assert kinds == ["I", "P", "P"]
    assert taken == [True] * 3


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
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cavlc',"
        " transform8x8=True, num_ref_frames=2, search_range=8,"
        " weighted_pred=True)\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert len(s) > 50 and enc.sps.profile_idc == 100\n"
        "assert len(decode_annexb(s, device='cpu')) == 3\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, rd=False,"
        " search_range=4)\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert len(s) > 50 and enc._dev_ref is not None\n"
        "assert [p.to_yuv_bytes() for p in decode_annexb(s, device='cpu')]"
        " == [p.to_yuv_bytes() for _, p in enc.all_recons]\n"
        "cfg = EncoderConfig(width=48, height=32, search_range=4)\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert len(s) > 50 and not cfg.fast\n"
        "assert [p.to_yuv_bytes() for p in decode_annexb(s, device='cpu')]"
        " == [p.to_yuv_bytes() for p in decode_annexb(s, use_device=False)]\n"
        "cfg = EncoderConfig(width=48, height=32, search_range=4, b_frames=1,"
        " slice_mode=1, slice_argument=2, partition_mode=1)\n"
        "s = H264Encoder(cfg, device='cpu').encode_sequence("
        "synthetic_frames(3, 48, 32))\n"
        "assert len(decode_annexb(s, device='cpu')) == 3\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cavlc',"
        " search_range=4, row_slices=2, rc_bitrate=2e5)\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert enc.rc.n_coded == 3\n"
        "assert [p.to_yuv_bytes() for p in decode_annexb(s, device='cpu')]"
        " == [p.to_yuv_bytes() for p in decode_annexb(s, use_device=False)]\n"
        "d = open('tests/streams/wp_b_expl.264', 'rb').read()\n"
        "a = decode_annexb(d, device='cpu')\n"
        "b = decode_annexb(d, use_device=False)\n"
        "assert len(a) == len(b) > 0 and all(\n"
        "    x.to_yuv_bytes() == y.to_yuv_bytes() for x, y in zip(a, b))\n"
        "cfg = EncoderConfig(width=48, height=32, fast=True, entropy='cabac',"
        " search_range=4, loss_aware_k=2, loss_rate=0.5, intra_refresh=2,"
        " sei_text='x')\n"
        "enc = H264Encoder(cfg, device='cpu')\n"
        "s = enc.encode_sequence(synthetic_frames(3, 48, 32))\n"
        "assert enc._lsim.pen is not None and len(enc.headers()) == 3\n"
        "assert len(decode_annexb(s, device='cpu')) == 3\n"
        "from h264_tpu_torch.parallel.dryrun import gop_inputs\n"
        "from h264_tpu_torch.parallel.mesh import Mesh\n"
        "from h264_tpu_torch.parallel.sharded import rd_gop_rows_sharded\n"
        "x = [a.reshape(*a.shape[:-2], 2, -1, a.shape[-1])"
        " for a in gop_inputs(1, 2, 1)]\n"
        "step = rd_gop_rows_sharded(Mesh(1, 2, 'gloo', 'cpu'), S=1, H=64,"
        " W=64, R=8, qp=28, qp_c=28, lam=1 << 16)\n"
        "assert step(*x)[0].shape[:3] == (1, 1, 2)\n"
        "assert [i['foreign_modules'] for i in step.ranks] == [[], []]\n"
        "import contextlib, io, os, tempfile\n"
        "from h264_tpu_torch import lencod\n"
        "os.chdir(tempfile.mkdtemp())\n"
        "open('in.yuv', 'wb').write(bytes(range(256)) * 18)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert lencod.main(['--device', 'cpu', '-p', 'InputFile=in.yuv',"
        " '-p', 'SourceWidth=48', '-p', 'SourceHeight=32', '-p',"
        " 'FramesToBeEncoded=2', '-p', 'SearchRange=4', '-p',"
        " 'ReconFile=rec.yuv']) == 0\n"
        "assert os.path.getsize('rec.yuv') == 2 * 48 * 32 * 3 // 2\n"
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


# configurations ported since this test listed them (the cases keep
# their names): what the encoder now signals for each (profile, CABAC,
# transform_8x8_mode_flag, several slices, host path, a rate controller,
# deblocking_filter_control_present_flag, simulated lossy decoders, the
# header NALs: SPS, PPS and an SEI when there are messages)
_PORTED_SINCE = {"entropy=cavlc": (66, False, False, False, False, False,
                                   False, 0, 2),
                 "transform8x8=True": (100, True, True, False, False, False,
                                       False, 0, 2),
                 "fast=False": (77, True, False, False, True, False, False,
                                0, 2),
                 "slice_mode=1-slice_argument=11": (77, True, False, True,
                                                    False, False, False, 0,
                                                    2),
                 "b_frames=1-rc_bitrate=100000.0": (77, True, False, False,
                                                    False, True, False, 0,
                                                    2),
                 "rc_bitrate=100000.0": (77, True, False, False, False, True,
                                         False, 0, 2),
                 "row_slices=2": (77, True, False, False, False, False,
                                  True, 0, 2),
                 "intra_refresh=2": (77, True, False, False, False, False,
                                     False, 0, 2),
                 "sei_text=x": (77, True, False, False, False, False, False,
                                0, 3),
                 "loss_aware_k=2": (77, True, False, False, False, False,
                                    False, 2, 2),
                 "rd=False": (77, True, False, False, False, False, False, 0,
                              2)}


@pytest.mark.parametrize("kw", [
    {"intra_refresh": 2}, {"b_frames": 1, "rc_bitrate": 1e5},
    {"entropy": "cavlc"},
    {"fast": False}, {"rd": False}, {"slice_mode": 1, "slice_argument": 11},
    {"transform8x8": True}, {"rc_bitrate": 1e5}, {"sei_text": "x"},
    {"row_slices": 2}, {"loss_aware_k": 2},
    {"scaling_lists": (np.full((6, 4, 4), 16), np.full((2, 8, 8), 16))},
], ids=lambda kw: "-".join(f"{k}={v}" if k != "scaling_lists" else k
                           for k, v in kw.items()))
def test_unported_configuration_raises(kw):
    """Every configuration is ported (the legacy P16x16 path, rd=False,
    last; its encodes are held in test_torch_legacy.py): CAVLC, the 8x8
    transform, the host path (fast=False), multi-slice, rate control (with
    and without B pictures), tile-row slices, intra refresh, SEI,
    loss-aware RDO and the legacy path construct and set the
    profile (Baseline, High), the PPS entropy flag and
    transform_8x8_mode_flag, the multi-slice flag, the path, the rate
    controller, the PPS filter-control flag (tile rows are deblocked on
    their own), the simulated decoders and the SEI NAL instead; scaling
    matrices with fast=True raise where the reference asserts (they run on
    the host path)."""
    base = dict(width=W, height=H, fast=True, rd=True, entropy="cabac",
                idr_period=1)
    base.update(kw)
    key = "-".join(f"{k}={v}" for k, v in kw.items())
    if key in _PORTED_SINCE:
        enc = H264Encoder(EncoderConfig(**base), device="cpu")
        assert (enc.sps.profile_idc, enc.pps.entropy_coding_mode_flag,
                enc.pps.transform_8x8_mode_flag, enc._multi_slice,
                not enc.cfg.fast, enc.rc is not None,
                enc.pps.deblocking_filter_control_present_flag,
                0 if enc._lsim is None else enc._lsim.k, len(enc.headers())
                ) == _PORTED_SINCE[key]
        return
    if "scaling_lists" in kw:
        with pytest.raises(AssertionError, match="host path"):
            JaxEncoder(JaxConfig(**base))
        with pytest.raises(ValueError, match="host path"):
            H264Encoder(EncoderConfig(**base), device="cpu")
        return
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
