"""The encoder's configuration, SEI and command-line tools in the port vs
the JAX package, on the CPU, live:

- ``encoder_config_from_params`` field by field (every field of the run
  configuration and of the encoder configuration, the scaling matrices of
  a q_matrix.cfg and the tone mapping of a ToneMapping.cfg) on parameter
  texts, and ``configure_encoder``'s -d / -f / -p / bare-file order;
- ``H264Encoder.headers()`` with each SEI kind (text, tone mapping of each
  model, recovery point, all three) byte for byte;
- ``lencod`` on a 3-frame 176x144 host-path run (the parser's defaults,
  ``fast=False``), Annex-B and RTP, with a text SEI set by ``-p``: the
  stream, the recon file, data.txt and stats.dat byte-equal to the
  reference's lencod;
- ``tools.rtp_loss`` (``apply_loss`` and its command), ``tools.rtpdump``'s
  output and ``tools.benchseq`` (``make_sequence`` with the foreman path
  of both packages pointed at a seeded temporary file, its helpers, and
  the error when the file is absent)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from h264_tpu import config as JC
from h264_tpu import lencod as JL
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu.syntax import sei as JSEI
from h264_tpu.tools import benchseq as JB
from h264_tpu.tools import rtp_loss as JRL
from h264_tpu.tools import rtpdump as JRD
from h264_tpu_torch import config as TC
from h264_tpu_torch import lencod as TL
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.syntax import sei as TSEI
from h264_tpu_torch.tools import benchseq as TB
from h264_tpu_torch.tools import rtp_loss as TRL
from h264_tpu_torch.tools import rtpdump as TRD
from h264_tpu_torch.tools.synthseq import moving_frames

torch.set_num_threads(1)
W, H = 176, 144

QMATRIX = """# q_matrix.cfg
INTRA4X4_LUMA = 6,13,20,28,13,20,28,32,20,28,32,37,28,32,37,42
INTER4X4_LUMA = 0
INTER8X8_LUMA = """ + ",".join(str(8 + (i * 7) % 40) for i in range(64)) + "\n"
TONEMAP = """tone_map_id = 3
tone_map_repetition_period = 2
coded_data_bit_depth = 8
sei_bit_depth = 8
model_id = 3  # piecewise linear
coded_pivot_value = 40 120 200
sei_pivot_value = 20 100 240
"""
FULL = """SourceWidth = 352   # CIF
SourceHeight = 288
QPISlice = 26
QPPSlice = 30
QPBSlice = 33
NumberBFrames = 2
IntraPeriod = 3
SearchRange = 24
NumberReferenceFrames = 4
SymbolMode = 1
LoopFilterDisable = 1
RateControlEnable = 1
Bitrate = 450000
FrameRate = 25.0
GenerateSEIMessage = 1
SEIMessageText = "loss-aware test text"
Transform8x8Mode = 1
PartitionMode = 0
ScalingMatrixPresentFlag = 1
QmatrixFile = {qm}
ToneMappingSEIPresentFlag = 1
ToneMappingFile = {tm}
InputFile = "in.yuv"
OutputFile = out.264
ReconFile = rec.yuv
FramesToBeEncoded = 12
StartFrame = 2
FrameSkip = 1
OutFileMode = 1
"""


def _same(a, b) -> bool:
    """Field-by-field equality of the two packages' config objects."""
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__ and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)))
    if isinstance(a, (tuple, list)) and not isinstance(a, str):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", ["empty", "full", "defaults-on"])
def test_encoder_config_from_params_field_by_field(tmp_path, text):
    (tmp_path / "q.cfg").write_text(QMATRIX)
    (tmp_path / "t.cfg").write_text(TONEMAP)
    body = {"empty": "",
            "full": FULL.format(qm=tmp_path / "q.cfg", tm=tmp_path / "t.cfg"),
            # the flags on, their files absent: the parsers give None
            "defaults-on": FULL.format(qm=tmp_path / "none.cfg",
                                       tm=tmp_path / "none.cfg")}[text]
    params = JC.parse_cfg_text(body)
    assert TC.parse_cfg_text(body) == params
    want = JC.encoder_config_from_params(params)
    got = TC.encoder_config_from_params(params)
    assert _same(want, got)
    if text == "full":
        assert got.enc.scaling_lists is not None
        assert got.enc.sei_tone_mapping.model_id == 3
        assert got.enc.idr_period == 9 and got.enc.rc_bitrate == 450000


def test_configure_encoder_argv_order(tmp_path):
    (tmp_path / "a.cfg").write_text("SourceWidth = 64\nSourceHeight = 48\n"
                                    "QPISlice = 20\nSearchRange = 8\n")
    (tmp_path / "b.cfg").write_text("QPISlice = 22\nSymbolMode = 1\n")
    (tmp_path / "c.cfg").write_text("NumberBFrames = 1\nQPPSlice = 40\n")
    argv = ["-d", str(tmp_path / "a.cfg"), "-f", str(tmp_path / "b.cfg"),
            "-p", "QPPSlice=24", "-p", "GenerateSEIMessage", "=", "1",
            "-p", "SEIMessageText=", "split", str(tmp_path / "c.cfg")]
    want, got = JC.configure_encoder(argv), TC.configure_encoder(argv)
    assert _same(want, got)
    assert got.enc.sei_text == "split" and got.enc.qp == 40
    for mod in (JC, TC):
        with pytest.raises(SystemExit, match="unknown encoder argument"):
            mod.configure_encoder(["--bogus"])


def _tone(sei, model):
    kw = {0: dict(min_value=16, max_value=235),
          1: dict(sigmoid_midpoint=100, sigmoid_width=40),
          2: dict(start_of_coded_interval=list(range(0, 256))),
          3: dict(coded_pivot_value=[40, 120], sei_pivot_value=[30, 160])}
    return sei.ToneMapping(tone_map_id=model, model_id=model,
                           repetition_period=model, **kw[model])


SEI_KINDS = {"none": {}, "text": {"sei_text": "port SEI"},
             "recovery": {"sei_recovery_point": True},
             **{f"tone{m}": {"sei_tone_mapping": m} for m in range(4)},
             "all": {"sei_text": "x" * 300, "sei_recovery_point": True,
                     "sei_tone_mapping": 3}}


@pytest.mark.parametrize("kind", sorted(SEI_KINDS))
def test_headers_with_sei_equal(kind):
    kw = dict(SEI_KINDS[kind])
    base = dict(width=W, height=H, entropy="cabac")
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    if "sei_tone_mapping" in kw:
        jkw["sei_tone_mapping"] = _tone(JSEI, kw["sei_tone_mapping"])
        tkw["sei_tone_mapping"] = _tone(TSEI, kw["sei_tone_mapping"])
    want = JaxEncoder(JaxConfig(**jkw)).headers()
    got = H264Encoder(EncoderConfig(**tkw), device="cpu").headers()
    assert len(got) == len(want) == (2 if kind == "none" else 3)
    assert [(n.nal_unit_type, n.nal_ref_idc, n.rbsp) for n in got] == [
        (n.nal_unit_type, n.nal_ref_idc, n.rbsp) for n in want]


@pytest.fixture(scope="module")
def lencod_runs(tmp_path_factory):
    """Each package's lencod on the same 3 seeded 176x144 frames, Annex-B
    (OutFileMode 0) and RTP (1): {(package, mode): {file name: bytes}}."""
    root = tmp_path_factory.mktemp("lencod")
    yuv = root / "in.yuv"
    with open(yuv, "wb") as f:
        for fr in moving_frames(3, W, H, seed=5):
            for p in fr:
                f.write(np.ascontiguousarray(p, np.uint8).tobytes())
    (root / "enc.cfg").write_text(
        f"InputFile = {yuv}\nSourceWidth = {W}\nSourceHeight = {H}\n"
        "FramesToBeEncoded = 3\nQPISlice = 28\nQPPSlice = 28\n"
        "SearchRange = 4\nOutputFile = out.bin\nReconFile = rec.yuv\n")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg, main, extra in (("jax", JL.main, []),
                                 ("port", TL.main, ["--device", "cpu"])):
            for mode in (0, 1):
                d = root / f"{pkg}{mode}"
                d.mkdir()
                mp.chdir(d)
                argv = ["-d", str(root / "enc.cfg"), "-p",
                        "GenerateSEIMessage=1", "-p",
                        "SEIMessageText=lencod run", "-p",
                        f"OutFileMode={mode}", *extra]
                with contextlib.redirect_stdout(io.StringIO()) as log:
                    assert main(argv) == 0
                out[pkg, mode] = {p.name: p.read_bytes()
                                  for p in d.iterdir()}
                out[pkg, mode]["stdout"] = log.getvalue()
    return out


@pytest.mark.parametrize("mode", [0, 1], ids=["annexb", "rtp"])
def test_lencod_output_and_recon_equal(lencod_runs, mode):
    want, got = lencod_runs["jax", mode], lencod_runs["port", mode]
    for name in ("out.bin", "rec.yuv", "data.txt", "stats.dat"):
        assert got[name] == want[name], name
    assert len(got["rec.yuv"]) == 3 * W * H * 3 // 2
    assert b"lencod run" in got["out.bin"]
    # the per-frame table but its time column
    strip = [line.rsplit(None, 1)[0] for line in want["stdout"].splitlines()
             if line[:6].strip().isdigit()]
    assert [line.rsplit(None, 1)[0] for line in got["stdout"].splitlines()
            if line[:6].strip().isdigit()] == strip and len(strip) == 3


@pytest.fixture(scope="module")
def rtp_file(lencod_runs):
    return lencod_runs["port", 1]["out.bin"]


@pytest.mark.parametrize("loss,seed", [(0, 0), (20, 0), (50, 3), (100, 7)])
def test_apply_loss_equal(rtp_file, loss, seed):
    want = JRL.apply_loss(rtp_file, loss, seed)
    got = TRL.apply_loss(rtp_file, loss, seed)
    assert got == want
    # SPS, PPS, SEI (always kept) and 3 pictures
    assert got[1] == 6 and got[2] == {0: 0, 100: 3}.get(loss, got[2])


def test_rtp_loss_and_rtpdump_commands_equal(tmp_path, rtp_file):
    src = tmp_path / "in.rtp"
    src.write_bytes(rtp_file)
    outs = {}
    for pkg, loss_main, dump_main in (("h264_tpu", JRL.main, JRD.main),
                                      ("h264_tpu_torch", TRL.main, TRD.main)):
        dst = tmp_path / f"{pkg}.rtp"
        with contextlib.redirect_stdout(io.StringIO()) as log:
            assert loss_main([str(src), str(dst), "30", "4"]) == 0
            assert dump_main([str(dst)]) == 0
        outs[pkg] = (dst.read_bytes(), log.getvalue())
        with contextlib.redirect_stdout(io.StringIO()) as usage:
            assert loss_main([]) == dump_main([]) == 1
        assert f"python -m {pkg}.tools.rtpdump" in usage.getvalue()
    assert outs["h264_tpu_torch"] == outs["h264_tpu"]
    assert "packets" in outs["h264_tpu_torch"][1]


def test_benchseq_equal(tmp_path, monkeypatch):
    fore = tmp_path / "foreman.yuv"
    with open(fore, "wb") as f:
        for fr in moving_frames(3, 176, 144, seed=9):
            for p in fr:
                f.write(np.ascontiguousarray(p, np.uint8).tobytes())
    monkeypatch.setattr(JB, "FOREMAN", str(fore))
    monkeypatch.setattr(TB, "FOREMAN", str(fore))
    want = JB.make_sequence(n=8, w=64, h=48, seed=7)
    got = TB.make_sequence(n=8, w=64, h=48, seed=7)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    JB.write_yuv(want, tmp_path / "j.yuv")
    TB.write_yuv(got, tmp_path / "t.yuv")
    assert (tmp_path / "t.yuv").read_bytes() == (tmp_path / "j.yuv"
                                                 ).read_bytes()
    assert TB.psnr(got[0][0], got[1][0]) == JB.psnr(want[0][0], want[1][0])
    r1, p1 = [100, 200, 400, 800], [30.0, 33.1, 36.0, 38.7]
    r2, p2 = [90, 185, 380, 760], [30.2, 33.0, 36.1, 38.8]
    assert TB.bd_rate(r1, p1, r2, p2) == JB.bd_rate(r1, p1, r2, p2)
    # without the clip both fail alike (no fallback)
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "FOREMAN", str(tmp_path / "absent.yuv"))
        with pytest.raises(FileNotFoundError):
            mod.make_sequence(n=2, w=64, h=48)
