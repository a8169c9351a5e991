"""Tile-row slices at a fixed QP in the port vs the JAX package, on the
CPU, against outputs recorded from the JAX package by
tests/torch_records.py (digests of every array and stream, equal digest
for digest; the live reference would compile its scalar-QP tile-row
program, one program more than the tier-1 run has time for):
``rd_p_rows_pipeline`` with one QP and lambda for every row (host
buffers, recon planes and next entry; 176x144, 3 rows, R 8, one
reference), and the encoder with 3 tile rows of 176x144 (CABAC, 5 frames,
one reference, search range 8), and the same with the 8x8 transform
signalled (the High profile; the tile rows code without it, as the
reference's do, while the I picture keeps it): the stream byte for byte
and the recons; both of the port's decoder paths give back the recons.
(2 rows would not divide the 9 MB rows of 176x144: test_torch_rows.py
holds that both packages refuse it.)  Tile rows with a QP per row, live
against the reference: test_torch_rows.py."""

import functools

import numpy as np
import pytest
import torch

import torch_records as REC
from h264_tpu_torch.bitstream import iter_annexb_nalus
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_rows as TR
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.syntax.parsets import parse_pps, parse_sps
from h264_tpu_torch.syntax.slice_header import parse_slice_header

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def records() -> dict:
    return REC.load()


@functools.lru_cache(maxsize=None)
def port_encode(name: str):
    enc = H264Encoder(EncoderConfig(**REC.ROWS_QP[name]), device="cpu")
    return enc, enc.encode_sequence(REC.frames())


def test_rows_pipeline_equal_scalar_qp():
    cur, ref = REC.pipe_inputs()
    bank, cpad = TRD.ref_entry_plain(*(torch.as_tensor(p) for p in ref))
    out = TR.rd_p_rows_pipeline(
        *cur, bank[None], cpad[None], lam=REC.lam(28), lam_me=REC.lam(28),
        nref=1, device="cpu", **REC.PIPE)
    assert out[0].shape[0] == REC.PIPE["G"]
    assert REC.pipe_record(out) == records()["pipeline"]


@pytest.mark.parametrize("name", sorted(REC.ROWS_QP))
def test_stream_and_recons_equal(name):
    enc, stream = port_encode(name)
    want = records()[name]
    assert len(stream) == want["bytes"]
    assert REC.encode_record(enc, stream) == want
    assert enc.pps.deblocking_filter_control_present_flag
    assert enc.pps.transform_8x8_mode_flag == (name == "t8")


@pytest.mark.parametrize("name", sorted(REC.ROWS_QP))
def test_stream_decodes_to_recons(name):
    enc, stream = port_encode(name)
    for use_device in (True, False):
        pics = decode_annexb(stream, use_device=use_device, device="cpu")
        assert len(pics) == len(enc.all_recons) == REC.N
        for pic, (poc, rec) in zip(pics, enc.all_recons):
            assert pic.poc == poc
            for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                         (pic.planes.V, rec.V)):
                np.testing.assert_array_equal(np.asarray(x), y)


def test_each_p_picture_is_one_slice_per_row():
    """3 slices per P picture, deblocked on their own (idc 2), starting at
    MBs 0, 33 and 66."""
    sps = pps = None
    firsts = []
    for n in iter_annexb_nalus(port_encode("cabac")[1]):
        if n.nal_unit_type == 7:
            sps = parse_sps(n.rbsp)
        elif n.nal_unit_type == 8:
            pps = parse_pps(n.rbsp)
        elif n.nal_unit_type == 1:
            sh = parse_slice_header(n.rbsp, {sps.seq_parameter_set_id: sps},
                                    {pps.pic_parameter_set_id: pps},
                                    n.nal_ref_idc, False)[0]
            firsts.append((sh.first_mb_in_slice,
                           sh.disable_deblocking_filter_idc))
    assert firsts == [(0, 2), (33, 2), (66, 2)] * (REC.N - 1)
