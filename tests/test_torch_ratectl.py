"""Rate control in the port (h264_tpu_torch.control, and the encoder's
use of it) vs the JAX package, on the CPU.

The controller: QP <-> Qstep over 0..51, seeded pick_qp / post_frame
sequences over I, P and B pictures (gop_size 0 and 8, n_b 0 and 1) that
give every QP and the final model and buffer state of the reference, and
the leaky-bucket parameters of tests/test_ratectl.py's cases.

The encoder, at 176x144 on seeded synthetic frames: the RD path's IPPP
(CABAC at depth 1, and CAVLC) and IPB (CABAC, one B picture, anchor
groups of 2), the host path's IPPP and IPB (CAVLC), and a bitrate that
drives the P QPs to 0.  Each gives the reference's QP
picks in the reference's order, its stream byte for byte and its recons,
and decodes through the port's decoder (both paths) to its recons.  The
RD configurations are those of test_torch_p_encode_nowp.py and
test_torch_b_encode.py without weighted prediction (which the reference
refuses under rate control), so the reference's device programs keep
their compiled specializations: QP and lambda are traced there.  Tile
rows under rate control: test_torch_rows.py."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

from h264_tpu.control import leaky_bucket as JLB
from h264_tpu.control import ratectl as JR
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.control import leaky_bucket as TLB
from h264_tpu_torch.control import ratectl as TR
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames

W, H = 176, 144
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def test_qp_qstep_conversions_equal():
    for qp in range(52):
        assert TR.qp_to_qstep(qp) == JR.qp_to_qstep(qp)
        assert TR.qstep_to_qp(TR.qp_to_qstep(qp)) == qp
    for qstep in np.geomspace(0.3, 300.0, 997):
        assert TR.qstep_to_qp(float(qstep)) == JR.qstep_to_qp(float(qstep))


def _kinds(n: int, gop: int, n_b: int):
    """Picture types in coding order: I, then P B^n_b groups, a new I
    every `gop` pictures (none with gop 0)."""
    out = []
    for i in range(n):
        if i == 0 or (gop and i % gop == 0):
            out.append("I")
        else:
            out.append("B" if n_b and (i % gop if gop else i) % 2 == 0
                       else "P")
    return out


@pytest.mark.parametrize("n_b", [0, 1])
@pytest.mark.parametrize("gop", [0, 8])
def test_controller_sequence_equal(gop, n_b):
    """Forty pictures of seeded bits and MADs wide enough to move the QP
    across its range and to set off the model's outlier rejection: every
    pick and the final state equal the reference's."""
    rng = np.random.RandomState(7 + gop + n_b)
    mine = TR.RateControl(300_000, 30, W, H, gop_size=gop, n_b=n_b)
    ref = JR.RateControl(300_000, 30, W, H, gop_size=gop, n_b=n_b)
    qps = []
    for kind in _kinds(40, gop, n_b):
        q = mine.pick_qp(kind)
        assert q == ref.pick_qp(kind), (kind, len(qps))
        qps.append(q)
        bits = float(rng.choice([800.0, 5000.0, 40000.0, 150000.0])
                     * rng.uniform(0.5, 1.5))
        mad = float(rng.uniform(0.2, 20.0))
        mine.post_frame(kind, bits, mad)
        ref.post_frame(kind, bits, mad)
    assert len(set(qps)) > 5
    for name in ("x1", "x2", "mad_a1", "mad_a2", "buffer_fullness",
                 "prev_p_qp", "p_qp_sum", "p_count", "n_coded"):
        assert getattr(mine, name) == getattr(ref, name), name


def test_b_pick_follows_the_last_p():
    """A B picture takes the last P picture's QP + 2 (tests/test_ratectl.py
    test_rc_b_frames_pick)."""
    for rc in (TR.RateControl(300_000, 30, W, H, n_b=1),
               JR.RateControl(300_000, 30, W, H, n_b=1)):
        rc.pick_qp("I")
        rc.post_frame("I", 40000, 4.0)
        qp = rc.pick_qp("P")
        rc.post_frame("P", 15000, 4.0)
        assert rc.pick_qp("B") == qp + 2


def test_leaky_bucket_equal():
    """The bucket parameters of tests/test_ratectl.py's case: equal to the
    reference's, never underflowing, and underflowing with F tightened."""
    bits = [40000, 9000, 12000, 7000, 20000, 8000, 6000, 15000]
    rates = [200_000, 350_000, 600_000]
    mine = TLB.calc_buffer(bits, rates, 30.0)
    ref = JLB.calc_buffer(bits, rates, 30.0)
    assert [(p.rate, p.buffer_size, p.initial_fullness) for p in mine] == [
        (p.rate, p.buffer_size, p.initial_fullness) for p in ref]
    for p in mine:
        assert TLB.verify_bucket(bits, p, 30.0)
    assert mine[0].buffer_size >= mine[1].buffer_size >= mine[2].buffer_size
    bad = replace(mine[0], initial_fullness=mine[0].initial_fullness - 5000)
    assert not TLB.verify_bucket(bits, bad, 30.0)
    assert not JLB.verify_bucket(bits, JLB.BucketParams(
        bad.rate, bad.buffer_size, bad.initial_fullness), 30.0)


# ---------------------------------------------------------------------------
# the encoder under rate control
# ---------------------------------------------------------------------------

RD_IPPP = dict(fast=True, rd=True, num_ref_frames=2, search_range=8)
CONFIGS = {
    "rd-ippp-cabac": (dict(RD_IPPP, entropy="cabac", rc_bitrate=350e3), 5),
    "rd-ippp-cavlc": (dict(RD_IPPP, entropy="cavlc", rc_bitrate=350e3), 5),
    "rd-ipb-cabac": (dict(RD_IPPP, entropy="cabac", b_frames=1,
                          rc_bitrate=700e3), 7),
    "host-ippp-cavlc": (dict(search_range=8, rc_bitrate=350e3), 5),
    "host-ipb-cavlc": (dict(search_range=8, b_frames=1, rc_bitrate=700e3),
                       5),
    # bpp > 0.9 starts the I picture at QP 10; the P QPs (from 12, at
    # most 2 down per picture) reach 0 by the eleventh P picture
    "rd-ippp-qp0": (dict(RD_IPPP, entropy="cabac", rc_bitrate=60e6), 12),
}


@functools.lru_cache(maxsize=None)
def frames(n: int):
    return moving_frames(n, W, H, seed=11)


def _record_picks(enc):
    """Wrap the encoder's rate control (if any): every (type, QP) it picks,
    and the per-row QPs of tile-row pictures, in order."""
    picks = []
    if enc.rc is None:
        return picks
    pick = enc.rc.pick_qp

    def rec(kind):
        q = pick(kind)
        picks.append((kind, q))
        return q

    enc.rc.pick_qp = rec
    rows = enc._rc_row_qps

    def rec_rows(*a):
        q = rows(*a)
        picks.append(("rows", [int(x) for x in q]))
        return q

    enc._rc_row_qps = rec_rows
    return picks


@functools.lru_cache(maxsize=None)
def encode_pair(items: tuple, n: int):
    """(JAX encoder, its stream, its picks, port encoder, its stream, its
    picks, the port's intra level maxima) of `n` frames under
    EncoderConfig(width=176, height=144, **dict(items))."""
    kw = dict(items, width=W, height=H)
    fr = frames(n)
    jenc = JaxEncoder(JaxConfig(**kw))
    jpicks = _record_picks(jenc)
    jstream = jenc.encode_sequence(fr)
    tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
    tenc.picture_log = []
    tpicks = _record_picks(tenc)
    intra_max = []
    intra = tenc._device_intra_picture

    def rec_intra(st, *a):
        intra(st, *a)
        intra_max.append(max(int(np.abs(x).max()) for x in (
            st.luma_levels, st.luma_dc, st.chroma_levels, st.chroma_dc)))

    tenc._device_intra_picture = rec_intra
    tstream = tenc.encode_sequence(fr)
    return jenc, jstream, jpicks, tenc, tstream, tpicks, intra_max


def rc_pair(name: str):
    kw, n = CONFIGS[name]
    return encode_pair(tuple(sorted(kw.items())), n)


def check_pair(pair):
    """The QP picks first (the order of picks and posts shows there), then
    the stream bytes and every recon."""
    jenc, jstream, jpicks, tenc, tstream, tpicks, _ = pair
    assert tpicks == jpicks
    assert len(tstream) > 100
    assert tstream == jstream
    assert len(tenc.all_recons) == len(jenc.all_recons)
    for (jp, a), (tp, b) in zip(jenc.all_recons, tenc.all_recons):
        assert jp == tp
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(y, np.asarray(x))


def check_decodes(pair):
    """Both of the port's decoder paths give back the encoder's recons (in
    display order: POC order with B pictures, else coding order)."""
    _, _, _, tenc, tstream, _, _ = pair
    recs = tenc.all_recons
    if tenc.cfg.b_frames:
        recs = sorted(recs, key=lambda e: e[0])
    for use_device in (True, False):
        pics = decode_annexb(tstream, use_device=use_device, device="cpu")
        assert len(pics) == len(recs)
        for pic, (poc, rec) in zip(pics, recs):
            assert pic.poc == poc
            for x, y in ((pic.planes.Y, rec.Y), (pic.planes.U, rec.U),
                         (pic.planes.V, rec.V)):
                np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_qps_and_recons_equal(name):
    check_pair(rc_pair(name))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_decodes_to_recons(name):
    check_decodes(rc_pair(name))


def test_qps_vary_and_every_picture_is_posted():
    """The controller moves the QP, and every coded picture reports its
    bits: one pick and one post per picture."""
    for name in ("rd-ippp-cabac", "rd-ipb-cabac", "host-ipb-cavlc"):
        _, _, _, tenc, _, tpicks, _ = rc_pair(name)
        assert tenc.rc.n_coded == len(tenc.all_recons) == len(tpicks)
        assert len({q for _, q in tpicks}) > 1, name
    kinds = [k for k, _ in rc_pair("rd-ipb-cabac")[5]]
    assert kinds == ["I", "P", "B", "P", "B", "P", "B"]


def test_bitrate_drives_the_qps_to_zero_within_the_bitlen_bound():
    """At 60 Mb/s the P QPs reach 0; the levels stay where the port's
    integer bit length equals the reference's float32 one (below 8192):
    P 4x4 levels < 1700 and intra (the I picture at QP 10, the P
    pictures' intra MBs at QP 0) <= 6528, the luma-DC bound at QP 0
    (ROADMAP Queue 3, "Settled").  The I picture cannot reach QP 0 in a
    short stream: a later I picture takes the running mean of every P QP
    so far, minus 1, and the first P pictures start at 10-12 and step by
    at most 2; the fixed-QP pairs hold I pictures at QP 0."""
    from h264_tpu_torch.encoder import rd_p as TP
    from h264_tpu_torch.encoder.rd_rows import P_PARTS

    _, _, _, tenc, _, tpicks, intra_max = rc_pair("rd-ippp-qp0")
    p_qps = [q for k, q in tpicks if k == "P"]
    assert [q for k, q in tpicks if k == "I"] == [10]
    assert p_qps[0] == 12 and p_qps[-1] == 0
    n_mb = (W // 16) * (H // 16)
    cuts = np.cumsum([0] + [n_mb * k for k in P_PARTS])
    p_lev, p_intra = 0, list(intra_max)
    for kind, _, row in tenc.picture_log:
        if kind == "P":
            intra = row[:n_mb] >= TP.C_I16
            lev = np.abs(row[cuts[8]:cuts[9]].reshape(n_mb, 256))
            p_lev = max(p_lev, int(lev[~intra].max()))
            p_intra += [int(lev[intra].max(initial=0)),
                        int(np.abs(row[cuts[10]:cuts[11]]).max())]
    assert 0 < p_lev < 1700
    assert max(p_intra) <= 6528


def test_lone_p_picture_of_a_fast_b_configuration_under_rate_control():
    """Under rate control the reference keeps the I picture's padded
    planes, so the lone P picture after it codes on the host path (no
    rate control: test_torch_host_encode.py, where both fail)."""
    kw = dict(width=W, height=H, search_range=8, b_frames=1, fast=True,
              rd=True, entropy="cabac", rc_bitrate=350e3)
    fr = frames(2)
    jenc = JaxEncoder(JaxConfig(**kw))
    tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
    for is_idr, yuv in ((True, fr[0]), (False, fr[1])):
        assert ([(n.nal_unit_type, n.rbsp) for n in tenc.encode_frame(
            yuv, is_idr)] == [(n.nal_unit_type, n.rbsp)
                              for n in jenc.encode_frame(yuv, is_idr)])
    for (jp, a), (tp, b) in zip(jenc.all_recons, tenc.all_recons):
        assert jp == tp
        np.testing.assert_array_equal(b.Y, np.asarray(a.Y))
