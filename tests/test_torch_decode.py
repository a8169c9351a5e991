"""The port's decoder (h264_tpu_torch.decoder) against the reference
package's, on the CPU.

Every in-repo stream decodes byte-identical through the port's device
path (K8's plain version, ``device="cpu"``), the reference's device path
(``use_device=True``) and the port's native host path
(``use_device=False``); the port decodes a port-encoded IPPP stream to the
encoder's recons; ``python -m h264_tpu_torch.ldecod`` writes what
``python -m h264_tpu.ldecod`` writes.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from h264_tpu.decoder.decoder import decode_annexb as jax_decode
from h264_tpu_torch.decoder import device as DEV
from h264_tpu_torch.decoder.decoder import H264Decoder, decode_annexb
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames

ROOT = pathlib.Path(__file__).resolve().parent.parent
STREAMS = sorted((ROOT / "tests" / "streams").glob("*.264"),
                 key=lambda p: p.name)


def _yuv(pics) -> bytes:
    return b"".join(p.to_yuv_bytes() for p in pics)


@pytest.mark.parametrize("path", STREAMS, ids=lambda p: p.stem)
def test_stream_decode_matches_reference(path, monkeypatch):
    data = path.read_bytes()
    calls = []
    kernel = DEV.decode_inter

    def count(*a, **kw):
        calls.append(kw["H"])
        return kernel(*a, **kw)

    monkeypatch.setattr(DEV, "decode_inter", count)
    got = decode_annexb(data, device="cpu")
    want = _yuv(jax_decode(data, use_device=True))
    assert _yuv(got) == want, f"{path.stem}: device-path decode differs"
    assert _yuv(decode_annexb(data, use_device=False)) == want, \
        f"{path.stem}: host-path decode differs"
    raw = list(H264Decoder(device="cpu").decode_stream(data))
    inter = [p for p in raw
             if p.slice_type.name in ("P", "B") and p.field_parity < 0]
    # frame P/B pictures with inter MBs go through K8 (in both decodes
    # above); field pictures stay on the host
    assert 0 < len(calls) <= 2 * len(inter) if inter else not calls


def test_decode_port_encoded_ippp_matches_recons():
    W, H = 176, 144
    frames = moving_frames(4, W, H, seed=8)
    cfg = EncoderConfig(width=W, height=H, qp=28, fast=True, rd=True,
                        entropy="cabac", b_frames=0, num_ref_frames=2,
                        search_range=8, weighted_pred=True)
    enc = H264Encoder(cfg, device="cpu")
    stream = enc.encode_sequence(frames)
    dec = H264Decoder(device="cpu")
    pics = list(dec.decode_stream(stream))
    assert [p.slice_type.name for p in pics] == ["I", "P", "P", "P"]
    for pic, (poc, rec) in zip(pics, enc.all_recons):
        assert pic.poc == poc
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert _yuv(decode_annexb(stream, use_device=False)) == _yuv(pics)


def test_ldecod_cli_matches_reference(tmp_path):
    stream = ROOT / "tests" / "streams" / "wp_b_impl.264"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for mod, extra in (("h264_tpu_torch.ldecod", ["--device", "cpu"]),
                       ("h264_tpu.ldecod", [])):
        out = tmp_path / f"{mod}.yuv"
        r = subprocess.run(
            [sys.executable, "-m", mod, *extra, str(stream), str(out)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        outs[mod] = (out.read_bytes(), r.stdout.replace(str(out), "OUT"))
    (a, log_a), (b, log_b) = outs.values()
    assert a == b and len(a) > 0
    assert log_a == log_b  # per-picture POC / type lines


def test_decoder_default_device_raises_without_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        H264Decoder()
    H264Decoder(use_device=False)  # the host path needs no card


def test_decoder_config_parsers_match_reference(tmp_path):
    from h264_tpu import config as JC
    from h264_tpu_torch import config as C

    text = ('InputFile = "in.yuv"  # comment\nFramesToBeEncoded=3\n'
            '# only a comment\nnot a pair\nQPISlice = 28\nEmpty =\n')
    assert C.parse_cfg_text(text) == JC.parse_cfg_text(text)
    cfg = tmp_path / "decoder.cfg"
    cfg.write_text("test.264   # input\nout.yuv\nref.yuv\n1\n0\n0\n2\n500000"
                   "\n104000\n73000\nleakybucket.cfg\n2\n2\n2\n1\nfree text\n")
    assert C.parse_cfg_file(cfg) == JC.parse_cfg_file(cfg)
    assert vars(C.parse_decoder_cfg(cfg)) == vars(JC.parse_decoder_cfg(cfg))
