"""Port IPB CABAC encode (h264_tpu_torch) vs the JAX package, on the CPU:
the bench configuration reduced (one B picture between anchors, explicit
WP on the P pictures, num_ref_frames 2, search range 8, QP 28) on 8
moving, fading 176x144 frames (the last closes the stream as a P
picture), and with an IDR every 4 pictures.  Byte-identical Annex-B stream, equal
recons (decode order) and reference entries; every B picture's
``rd_b_pipeline`` outputs from the reference encoder's own DPB state
(``convert.encoder_refs_from_numpy``); and the four B fills held on the
parse states the reference encoder gave them.  The same IPB stream with
CAVLC (Main profile; its B slices go through the Python CAVLC writer, as
in the reference): byte-identical, equal recons and reference entries,
every P picture's outputs from the reference's DPB state, and the
reference's own decoder on the reference's stream.  The hierarchical
stream (``b_hierarchy``) is in test_torch_b_pipeline.py."""

import copy
import functools

import numpy as np
import pytest
import torch

import test_torch_p_encode as pbase
from h264_tpu.decoder.decoder import decode_annexb
from h264_tpu.encoder import fills as JFL
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.convert import encoder_refs_from_numpy
from h264_tpu_torch.decoder.state import PictureParseState
from h264_tpu_torch.encoder import fills as TFL
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, N = 176, 144, 8
torch.set_num_threads(1)
FILLS = ("fill_b_half_mvd", "fill_b_p8_mvd", "fill_b_explicit_mvd",
         "fill_temporal_direct")


def cfg(cls, **kw):
    base = dict(width=W, height=H, qp=28, fast=True, rd=True,
                entropy="cabac", b_frames=1, num_ref_frames=2,
                search_range=8, weighted_pred=True)
    base.update(kw)
    return cls(**base)


@functools.lru_cache(maxsize=None)
def frames():
    return moving_frames(N, W, H, seed=13)


def record_b(enc, snaps):
    """Wrap enc._start_b_rd: keep the encoder's DPB before each B picture
    and its pending outputs (and new entry) after."""
    start = enc._start_b_rd

    def rec(yuv, poc, is_ref=False):
        snap = {"yuv": yuv, "poc": poc, "is_ref": is_ref,
                "refs": list(enc._rd_refs),
                "anchors": copy.deepcopy(enc._anchor_ref_pocs),
                "frame_num": enc.frame_num}
        pend = start(yuv, poc, is_ref=is_ref)
        snap.update(pending=pend, entry=enc._rd_refs[0])
        snaps.append(snap)
        return pend

    enc._start_b_rd = rec


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def jax_encode():
    """(JAX encoder, stream, B snapshots, fill calls).  Every call of the
    reference's B fills is recorded as (name, args with the parse state
    before, the parse state after)."""
    enc, snaps, fills = JaxEncoder(cfg(JaxConfig)), [], []
    record_b(enc, snaps)
    saved = {n: getattr(JFL, n) for n in FILLS}

    def wrap(name):
        fn = saved[name]

        def rec(st, *args, **kw):
            before = (copy.deepcopy(st), copy.deepcopy(args),
                      copy.deepcopy(kw))
            fn(st, *args, **kw)
            fills.append((name, before, copy.deepcopy(st)))
        return rec

    try:
        for n in FILLS:
            setattr(JFL, n, wrap(n))
        stream = enc.encode_sequence(frames())
    finally:
        for n, fn in saved.items():
            setattr(JFL, n, fn)
    return enc, stream, snaps, fills


@functools.lru_cache(maxsize=None)
def port_encode():
    enc, snaps = H264Encoder(cfg(EncoderConfig), device="cpu"), []
    record_b(enc, snaps)
    enc.picture_log = []
    return enc, enc.encode_sequence(frames()), snaps


def check_stream(jenc, jstream, tenc, tstream, n):
    assert len(tstream) > 100
    assert tstream == jstream
    assert len(tenc.all_recons) == len(jenc.all_recons) == n
    for (pa, a), (pb, b) in zip(jenc.all_recons, tenc.all_recons):
        assert pa == pb
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(y, _np(x))
    assert len(tenc._rd_refs) == len(jenc._rd_refs)
    for (jp, jb, jc, jcol), (tp, tb, tc, tcol) in zip(jenc._rd_refs,
                                                      tenc._rd_refs):
        assert jp == tp
        np.testing.assert_array_equal(tb.numpy(), _np(jb))
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        for x, y in zip(tcol, jcol):
            assert x.dtype == (torch.bool if y.dtype == bool else torch.int32)
            np.testing.assert_array_equal(x.numpy(), _np(y))
    assert tenc._anchor_ref_pocs == jenc._anchor_ref_pocs


def check_b_from_jax_state(snaps, cfg_):
    """Each B picture restarted in a fresh port encoder from the JAX
    encoder's DPB and anchor POCs: host_out, recon and (stored B) the new
    reference entry equal the reference's."""
    for snap in snaps:
        tenc = H264Encoder(cfg_, device="cpu")
        encoder_refs_from_numpy(
            tenc, [(p, _np(b), _np(c), tuple(_np(x) for x in col))
                   for p, b, c, col in snap["refs"]],
            anchor_ref_pocs=snap["anchors"])
        tenc.frame_num = snap["frame_num"]
        host_out, recon, *meta = tenc._start_b_rd(
            snap["yuv"], snap["poc"], is_ref=snap["is_ref"])
        jp = snap["pending"]
        assert tuple(meta) == tuple(jp[3:])
        np.testing.assert_array_equal(host_out.numpy(), _np(jp[1]))
        for x, y in zip(recon, jp[2]):
            np.testing.assert_array_equal(x.numpy(), _np(y))
        if snap["is_ref"]:
            (tp, tb, tc, tcol), (jpoc, jb, jc, jcol) = (tenc._rd_refs[0],
                                                       snap["entry"])
            assert tp == jpoc == snap["poc"]
            for x, y in zip((tb, tc, *tcol), (jb, jc, *jcol)):
                np.testing.assert_array_equal(x.numpy(), _np(y))


def b_winners(snaps, n_mb):
    """The winner codes of the port's B pictures (host_out's first part)."""
    return np.concatenate([s["pending"][0][:n_mb].numpy() for s in snaps])


def test_stream_byte_identical_recon_and_refs_equal():
    jenc, jstream, _, _ = jax_encode()
    tenc, tstream, _ = port_encode()
    check_stream(jenc, jstream, tenc, tstream, N)
    assert [p for p, _ in tenc.all_recons] == [0, 4, 2, 8, 6, 12, 10, 14]


def test_stream_decodes_to_port_recon():
    """The reference package's decoder reconstructs the port's recon."""
    tenc, tstream, _ = port_encode()
    pics = sorted(decode_annexb(tstream), key=lambda p: p.poc)
    recs = sorted(tenc.all_recons, key=lambda e: e[0])
    assert len(pics) == N
    for pic, (_, rec) in zip(pics, recs):
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(_np(x), y)


def test_idr_period_stream_byte_identical():
    """An IDR every 4 pictures: the pending B picture closes its GOP as a
    P picture, and the DPB, frame_num and POC restart at the IDR."""
    fr = frames()[:7]
    jenc = JaxEncoder(cfg(JaxConfig, idr_period=4))
    tenc = H264Encoder(cfg(EncoderConfig, idr_period=4), device="cpu")
    assert tenc.encode_sequence(fr) == jenc.encode_sequence(fr)
    assert [p for p, _ in tenc.all_recons] == [0, 4, 2, 6, 0, 4, 2]


def test_b_pipeline_from_jax_state():
    _, _, snaps, _ = jax_encode()
    assert len(snaps) == 3
    check_b_from_jax_state(snaps, cfg(EncoderConfig))


def test_stream_exercises_the_b_path():
    """The B pictures take direct, direct-zero, one-list and bi-predicted
    decisions; the P pictures are weighted."""
    _, _, snaps = port_encode()
    win = b_winners(snaps, (W // 16) * (H // 16))
    assert np.isin(win, [TRD.B_DIRECT, TRD.B_DIRECT_ZERO]).any()
    assert np.isin(win, [TRD.B_L0, TRD.B_L1]).any()
    assert np.isin(win, [TRD.B_BI, TRD.B_L0_16x8, TRD.B_L0_8x16,
                         TRD.B_P8X8]).any()


def test_picture_log_names_each_picture():
    """The encoder's picture log: type and POC of every picture in decode
    order, and each B picture's fetched host_out (its winners first)."""
    tenc, _, snaps = port_encode()
    log = tenc.picture_log
    assert [(k, poc) for k, poc, _ in log] == list(zip(
        "IPBPBPBP", [p for p, _ in tenc.all_recons]))
    assert log[0][2] is None
    n_mb = (W // 16) * (H // 16)
    rows = [row[:n_mb] for k, _, row in log if k == "B"]
    np.testing.assert_array_equal(np.concatenate(rows),
                                  b_winners(snaps, n_mb))


def _port_state(st):
    out = PictureParseState.__new__(PictureParseState)
    out.__dict__ = copy.deepcopy(st.__dict__)
    return out


@pytest.mark.parametrize("name", FILLS)
def test_b_fill_on_reference_states(name):
    """Each B fill of the port, on the parse states the reference encoder
    called its own with, leaves the same state."""
    calls = [c for c in jax_encode()[3] if c[0] == name]
    assert calls
    for _, (st, args, kw), after in calls:
        mine = _port_state(st)
        getattr(TFL, name)(mine, *copy.deepcopy(args), **copy.deepcopy(kw))
        assert mine.__dict__.keys() == after.__dict__.keys()
        for key, want in after.__dict__.items():
            np.testing.assert_array_equal(np.asarray(mine.__dict__[key]),
                                          np.asarray(want), err_msg=key)


def test_b_frames_configurations():
    """b_hierarchy needs b_frames == 3; a B configuration with rd=False
    (ported: the host path codes it, as in the reference) keeps no device
    reference state; intra refresh and loss-aware RDO are ported."""
    with pytest.raises(ValueError, match="b_frames == 3"):
        H264Encoder(cfg(EncoderConfig, b_hierarchy=True), device="cpu")
    legacy = H264Encoder(cfg(EncoderConfig, rd=False, weighted_pred=False),
                         device="cpu")
    assert legacy._dev_ref is None and legacy.sps.pic_order_cnt_type == 0
    er = H264Encoder(cfg(EncoderConfig, intra_refresh=2, loss_aware_k=2),
                     device="cpu")
    assert er._lsim.k == 2 and er.cfg.intra_refresh == 2
    enc = H264Encoder(cfg(EncoderConfig), device="cpu")
    assert enc.sps.num_ref_frames == 3 and enc.sps.pic_order_cnt_type == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc.encode_frame(frames()[0], False)


@functools.lru_cache(maxsize=None)
def cavlc_encode():
    """[(encoder, stream, P snapshots)] of the JAX encoder and the port's,
    the IPB configuration with CAVLC."""
    out = []
    for enc in (JaxEncoder(cfg(JaxConfig, entropy="cavlc")),
                H264Encoder(cfg(EncoderConfig, entropy="cavlc"),
                            device="cpu")):
        snaps = []
        pbase._record_p(enc, snaps)
        out.append((enc, enc.encode_sequence(frames()), snaps))
    return out


def test_cavlc_stream_byte_identical_recon_and_refs_equal():
    (jenc, jstream, _), (tenc, tstream, _) = cavlc_encode()
    check_stream(jenc, jstream, tenc, tstream, N)
    assert tenc.sps.profile_idc == 77
    assert not tenc.pps.entropy_coding_mode_flag


def test_cavlc_p_pipeline_from_jax_state():
    (_, _, snaps), _ = cavlc_encode()
    assert len(snaps) == 4
    pbase.check_p_from_jax_state(snaps, cfg(EncoderConfig, entropy="cavlc"))


def test_cavlc_reference_decoder_on_reference_stream():
    """The reference package's decoder on the reference's CAVLC IPB
    stream reconstructs the reference encoder's pictures, B included
    (ROADMAP Queue 3 records the comparison)."""
    (jenc, jstream, _), _ = cavlc_encode()
    pics = sorted(decode_annexb(jstream), key=lambda p: p.poc)
    recs = sorted(jenc.all_recons, key=lambda e: e[0])
    assert [p.poc for p in pics] == [p for p, _ in recs]
    for pic, (_, rec) in zip(pics, recs):
        for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                     (pic.planes.V, rec.V)):
            np.testing.assert_array_equal(_np(x), _np(y))
