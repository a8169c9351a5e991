"""Error-resilient encoding in the port vs the JAX package, on the CPU,
against outputs recorded from the JAX package by tests/torch_records.py
(digests of every array and stream, equal digest for digest; the live
reference would compile the intra-refresh and loss-aware specializations
of its P pipeline, more programs than the tier-1 run has time for):

- ``rd_p_pipeline`` with a refresh mask (a third of the MBs) and with a
  drift penalty (up to the 2^30 clip), 176x144, R 8, one reference: host
  buffers, recon planes and next entry (on noise, whose MBs all code
  intra: the encodes below show the refreshed MBs coding intra);
- the loss-aware IPPP encode (3 decoders, loss 0.5, 6 frames), the IPB
  encode with loss-aware RDO, intra refresh, explicit WP and an IDR at
  frame 4, and the intra-refresh IPPP encode (40 of 99 MBs over 5 frames:
  the permutation runs out and is re-seeded from the number of source
  POCs): the stream byte for byte and the recons; every P pipeline call's
  refresh mask and drift penalty (none on the first P picture after an
  IDR); every step of the simulated decoders (the losses drawn, the new
  drift and penalty); the number of source POCs the re-seed counts; the
  masked MBs code intra (I16 or I4); both of the port's decoder paths give back the
  recons.

The drift step and the simulator live against the reference:
test_torch_lossaware.py."""

import functools

import numpy as np
import pytest
import torch

import torch_records as REC
from h264_tpu_torch.decoder.decoder import H264Decoder
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TRP
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder

torch.set_num_threads(1)
N_MB = (REC.W // 16) * (REC.H // 16)


@functools.lru_cache(maxsize=None)
def records() -> dict:
    return REC.load()


@functools.lru_cache(maxsize=None)
def port_encode(name: str):
    """The port's encode of ER_ENC[name] with its P pipeline calls and its
    decoder steps recorded as the generator records the reference's."""
    kw, n = REC.ER_ENC[name]
    calls, steps = [], []
    pipe = TRP.rd_p_pipeline

    def rec_pipe(*a, **k):
        calls.append(REC.call_record(k.get("force_intra"),
                                     k.get("drift_pen")))
        return pipe(*a, **k)

    class Recording(H264Encoder):
        @staticmethod
        def _propagate_drift(drift, delta, mv4, intra4, lost):
            new, pen = H264Encoder._propagate_drift(drift, delta, mv4,
                                                    intra4, lost)
            steps.append(REC.step_record(lost, new, pen))
            return new, pen

    enc = Recording(EncoderConfig(**kw), device="cpu")
    enc.picture_log = []
    TRP.rd_p_pipeline = rec_pipe
    try:
        stream = enc.encode_sequence(REC.frames(n))
    finally:
        TRP.rd_p_pipeline = pipe
    return enc, stream, calls, steps


def _win(host_out) -> np.ndarray:
    return np.asarray(host_out).reshape(-1)[:N_MB]


@pytest.mark.parametrize("name", ["pipeline_refresh", "pipeline_drift"])
def test_pipeline_branch_equal(name):
    cur, ref = REC.pipe_inputs()
    mask, pen = REC.er_inputs()
    bank, cpad = TRD.ref_entry_plain(*(torch.as_tensor(p) for p in ref))
    kw = ({"force_intra": mask} if name == "pipeline_refresh"
          else {"drift_pen": pen})
    out = TRP.rd_p_pipeline(
        *cur, bank[None], cpad[None], lam=REC.lam(28),
        lam_me=2 * REC.lam(28), nref=1, device="cpu", use_cme=True,
        **REC.PIPE_P, **kw)
    assert REC.pipe_record(out) == records()[name]


@pytest.mark.parametrize("name", sorted(REC.ER_ENC))
def test_stream_and_recons_equal(name):
    enc, stream, _, _ = port_encode(name)
    want = records()[name]
    assert len(stream) == want["bytes"]
    assert REC.encode_record(enc, stream) == {
        k: want[k] for k in ("stream", "bytes", "recons")}


@pytest.mark.parametrize("name", sorted(REC.ER_ENC))
def test_pipeline_calls_equal(name):
    """Each P pipeline call's refresh mask and drift penalty; the source
    POC count the refresh re-seed reads."""
    enc, _, calls, _ = port_encode(name)
    want = records()[name]
    assert calls == want["calls"]
    assert len(enc._src_dc) == want["src_pocs"]
    kw = REC.ER_ENC[name][0]
    if kw.get("intra_refresh"):
        # as many MBs as asked, fewer where a new permutation repeats one
        assert all(0 < len(c["refresh"]) <= kw["intra_refresh"]
                   for c in calls)
        assert len(calls[0]["refresh"]) == kw["intra_refresh"]
    if kw.get("loss_aware_k"):
        # no penalty on the first P picture after each IDR, one after
        assert calls[0]["pen"] is None and calls[1]["pen"] is not None


def test_refresh_permutation_is_reseeded():
    """40 of 99 MBs per P picture: the first permutation covers every MB
    in the first 2 pictures and 19 of the third, which then draws 21 MBs
    of the permutation seeded 13 + the source POCs seen (3)."""
    _, _, calls, _ = port_encode("er_refresh")
    first = np.random.RandomState(13).permutation(N_MB)
    again = np.random.RandomState(13 + 3).permutation(N_MB)
    assert calls[0]["refresh"] == sorted(first[:40].tolist())
    assert calls[2]["refresh"] == sorted(set(first[80:].tolist()
                                             + again[:21].tolist()))
    assert calls[3]["refresh"] == sorted(again[21:61].tolist())


@pytest.mark.parametrize("name", ["er_ipb", "er_loss"])
def test_decoder_steps_equal(name):
    """Every step of the simulated decoders: one per RD P picture."""
    enc, _, calls, steps = port_encode(name)
    assert steps == records()[name]["steps"]
    assert len(steps) == len(calls)


@pytest.mark.parametrize("name", sorted(REC.ER_ENC))
def test_refreshed_mbs_code_intra(name):
    enc, _, calls, _ = port_encode(name)
    p_rows = [row for kind, _, row in enc.picture_log if kind == "P"]
    assert len(p_rows) == len(calls)
    for call, row in zip(calls, p_rows):
        if call["refresh"] is not None:
            assert (_win(row)[call["refresh"]] >= TRP.C_I16).all()


@pytest.mark.parametrize("name", sorted(REC.ER_ENC))
def test_stream_decodes_to_recons(name):
    """In decode order, I and P pictures equal to the recons."""
    enc, stream, _, _ = port_encode(name)
    for use_device in (True, False):
        pics = list(H264Decoder(use_device=use_device, device="cpu")
                    .decode_stream(stream))
        assert len(pics) == len(enc.all_recons) == REC.ER_ENC[name][1]
        for pic, (poc, rec) in zip(pics, enc.all_recons):
            assert pic.poc == poc
            if pic.slice_type.name == "B":
                continue  # B windows (ROADMAP Queue 3)
            for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                         (pic.planes.V, rec.V)):
                np.testing.assert_array_equal(np.asarray(x), y)
