"""Tile-row slices (``row_slices``) in the port vs the JAX package, on the
CPU.

``rd_rows.row_slabs`` against the reference's ``_row_slabs``;
``rd_rows.rd_p_rows_pipeline`` against ``rd_p_rows_pipeline``: host
buffers, recon planes and the next entry (bank, cpad, colocated motion)
equal, with a (G,) vector of QPs and lambdas (176x144, 3 groups, one
reference, R 8: the encoder's call under rate control, so the pair and
the encoder pair below share the reference's compiled program); every
window of the rows path at R 28, on motion that
reaches every slab edge, inside its slab; the encoder under rate control
with 3 tile rows (the reference's test_rc_basic_unit_rows_roundtrip
configuration): the QP picks and row QPs, the stream byte for byte, the
recons, and both of the port's decoder paths; the host path with tile
rows (only the PPS and slice headers change); and the two ways both
packages refuse tile rows: a G that does not divide the MB rows, and a
B configuration (the group fetch of a tile-row anchor with its B
picture).  Tile rows at a fixed QP (the pipeline pair with a scalar QP,
and the encoder with CABAC and with the 8x8 transform signalled):
test_torch_rows_qp.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from h264_tpu.encoder import rd as JRD
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.encoder import rd_rows as TR
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.encoder.encoder import fetch_group
from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.tools.rows_cases import edge_motion
from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames
from test_torch_ratectl import check_decodes, check_pair, encode_pair
from torch_host_pairs import (assert_decodes_to_recons, assert_recons_equal,
                              assert_streams_equal)
from torch_host_pairs import encode_pair as host_pair

torch.set_num_threads(1)
PAD = TRD.PAD


def _lam(qp: int) -> int:
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


def _inputs(H: int, W: int, seed: int):
    """Random current planes (uint8) and one reference entry (the
    reference's own bank), as jnp arrays."""
    rng = np.random.default_rng(seed)
    cur = [jnp.asarray(rng.integers(0, 256, s), jnp.uint8)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    bank, cpad = JRD.ref_entry_from_planes(
        jnp.asarray(rng.integers(0, 256, (H, W)), jnp.int32),
        jnp.asarray(rng.integers(0, 256, (H // 2, W // 2)), jnp.int32),
        jnp.asarray(rng.integers(0, 256, (H // 2, W // 2)), jnp.int32))
    return cur, jnp.stack([bank]), jnp.stack([cpad])


def test_row_slabs_equal():
    H, W, G = 96, 64, 3
    _, banks, cpads = _inputs(H, W, 3)
    slabs, cslabs = JRD._row_slabs(banks, cpads, H, G)
    mine = TR.row_slabs(torch.as_tensor(np.array(banks)),
                        torch.as_tensor(np.array(cpads)), H, G)
    assert mine[0].shape == (G, 1, 4, H // G + 2 * PAD, W + 2 * PAD)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(slabs))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(cslabs))


def _check_rows_pipeline(ref_out, cur, banks, cpads, **kw):
    ho, rec, (bank, cpad, col) = ref_out
    mho, mrec, (mbank, mcpad, mcol) = TR.rd_p_rows_pipeline(
        *(np.asarray(c) for c in cur), torch.as_tensor(np.array(banks)),
        torch.as_tensor(np.array(cpads)), device="cpu", **kw)
    assert mho.shape == np.asarray(ho).shape
    np.testing.assert_array_equal(mho.numpy(), np.asarray(ho))
    for x, y in zip(mrec, rec):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(mbank.numpy(), np.asarray(bank))
    np.testing.assert_array_equal(mcpad.numpy(), np.asarray(cpad))
    assert len(mcol) == len(col) == 4
    for x, y in zip(mcol, col):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    return mho


def test_rows_pipeline_equal_qp_per_row():
    """A QP, chroma QP and lambda per row (the basic unit of the rate
    control), in the form the encoder passes them: 176x144, G 3."""
    H, W, G = 144, 176, 3
    cur, banks, cpads = _inputs(H, W, 8)
    qp = np.asarray([22, 28, 33], np.int32)
    qp_c = np.asarray([chroma_qp(int(q), 0) for q in qp], np.int32)
    lam = np.asarray([_lam(int(q)) for q in qp], np.int32)
    ref = JRD.rd_p_rows_pipeline(*cur, banks, cpads, H=H, W=W, R=8, qp=qp,
                                 qp_c=qp_c, lam=lam, lam_me=lam, G=G,
                                 nref=jnp.int32(1))
    _check_rows_pipeline(ref, cur, banks, cpads, H=H, W=W, R=8, qp=qp,
                         qp_c=qp_c, lam=lam, lam_me=lam, G=G, nref=1)


def _windows(name, args):
    """(rows, cols) of the bank windows one recorded P entry call reads, as
    (starts, size) per axis, the reference's dynamic_slice windows
    (rd.py:435, :551, :640, :848, :159)."""
    if name == "ssd_grid8":
        banks, cur_y, cen_x, cen_y, _, R = args
        H, W = cur_y.shape
        by, bx, mb = TP._b8_geometry(H, W, cur_y.device)
        cy, cx = cen_y.reshape(-1)[mb], cen_x.reshape(-1)[mb]
        return (by + cy - R + PAD, 2 * R + 8), (bx + cx - R + PAD, 2 * R + 8)
    if name == "sub8_search":
        banks, cur_y, u_ref, u_cy, u_cx, _, _, _, RS, _ = args
        n_mx = cur_y.shape[1] // 16
        u = torch.arange(u_ref.shape[0])
        mb, b8 = u // 4, u % 4
        q = torch.arange(4)
        y0 = (16 * (mb // n_mx) + 8 * (b8 >> 1))[:, None] + 4 * (q >> 1)
        x0 = (16 * (mb % n_mx) + 8 * (b8 & 1))[:, None] + 4 * (q & 1)
        return ((y0 + u_cy[:, None] - RS + PAD, 2 * RS + 4),
                (x0 + u_cx[:, None] - RS + PAD, 2 * RS + 4))
    if name == "qpel_refine":
        imvx, imvy, y0, x0 = args[3:7]
        h, w = args[11], args[12]
        return (y0 + imvy + PAD - 1, h + 3), (x0 + imvx + PAD - 1, w + 3)
    if name == "mc_luma":
        mvx, mvy, y0, x0 = args[2:6]
        h, w = args[7], args[8]
        return (y0 + (mvy >> 2) + PAD, h + 2), (x0 + (mvx >> 2) + PAD, w + 2)
    if name == "mc_chroma":
        cpads, _, mv4x, mv4y = args
        n_mx = (cpads.shape[-1] - 2 * PAD) // 8
        mb = torch.arange(mv4x.shape[0])[:, None, None]
        b8 = torch.arange(4)[None, :, None]
        q = torch.arange(4)[None, None, :]
        yc = (16 * (mb // n_mx) + 8 * (b8 >> 1) + 4 * (q >> 1)) >> 1
        xc = (16 * (mb % n_mx) + 8 * (b8 & 1) + 4 * (q & 1)) >> 1
        return (yc + (mv4y >> 3) + PAD, 3), (xc + (mv4x >> 3) + PAD, 3)
    return None


def test_no_window_starts_outside_the_slab():
    """The reference reads the unwidened slabs through dynamic_slice,
    which moves a window that would leave them; the port clamps each
    sample instead.  At R 28, on pictures whose content moves 28 pels in
    each diagonal direction (so that mvs reach +-R at every edge of every
    slab), every window of the search grids, the refinement, the sub-8x8
    grids, the skip MC and the chroma MC starts inside its slab: the two
    read the same samples."""
    H, W, G, R = 64, 96, 2, 28
    ref, curs = edge_motion(H, W, R)
    bank, cpad = TRD.ref_entry_plain(*(torch.as_tensor(p, dtype=torch.int32)
                                       for p in ref))
    seen = {"imv": set(), "u_c": set()}
    calls = 0
    for cur in curs:
        k, log = TP.recording(TP.PLAIN)
        TR.rd_p_rows_pipeline(*cur, bank[None], cpad[None], H=H, W=W, R=R,
                              qp=28, qp_c=chroma_qp(28, 0), lam=_lam(28),
                              lam_me=_lam(28), G=G, device="cpu", k=k)
        for name, args in log:
            win = _windows(name, args)
            if win is None:
                continue
            calls += 1
            src = args[0]
            for (start, size), extent in zip(win, src.shape[-2:]):
                assert int(start.min()) >= 0, name
                assert int(start.max()) + size <= extent, name
            if name == "qpel_refine":
                seen["imv"] |= {int(args[4].min()), int(args[4].max()),
                                int(args[3].min()), int(args[3].max())}
            if name == "sub8_search":
                seen["u_c"] |= {int(args[3].min()), int(args[3].max())}
        assert {n for n, _ in log} == set(TP.entries_of(False)) - {
            "coarse_search"}
    assert calls > 0
    # the searches reached +-R, and the sub-8x8 centres their clamp
    cmax = PAD - min(R, 10) - 5
    assert {-R, R} <= seen["imv"] and {-cmax, cmax} <= seen["u_c"]


RC_ROWS = (("entropy", "cavlc"), ("fast", True), ("num_ref_frames", 1),
           ("rc_bitrate", 350e3), ("row_slices", 3), ("search_range", 8))


def test_rate_controlled_rows_stream_qps_and_recons_equal():
    """The reference's test_rc_basic_unit_rows_roundtrip configuration
    (CAVLC, 3 tile rows, 350 kb/s) on 6 frames: its QP picks and row QPs,
    stream and recons; each P picture is 3 slices with its own QP."""
    pair = encode_pair(RC_ROWS, 6)
    check_pair(pair)
    rows = [q for k, q in pair[5] if k == "rows"]
    assert len(rows) == 5 and all(len(r) == 3 for r in rows)
    tenc = pair[3]
    assert tenc.pps.deblocking_filter_control_present_flag


def test_rate_controlled_rows_stream_decodes_to_recons():
    check_decodes(encode_pair(RC_ROWS, 6))


def test_rows_on_the_host_path():
    """With fast=False tile rows only set the PPS filter-control flag, so
    the slice headers carry disable_deblocking_filter_idc (0)."""
    pair = host_pair(dict(row_slices=2), 3)
    assert_streams_equal(pair)
    assert_recons_equal(pair, 3)
    assert_decodes_to_recons(pair, 3)
    assert pair[2].pps.deblocking_filter_control_present_flag


def test_rows_that_do_not_divide_the_mb_rows_fail_in_both():
    """2 groups of the 9 MB rows of 176x144: the reference fails at the
    first P picture (a TypeError reshaping its recon), the port refuses
    it there (ValueError); an all-intra stream codes in both."""
    kw = dict(width=176, height=144, fast=True, entropy="cabac",
              search_range=8, row_slices=2)
    fr = moving_frames(2, 176, 144, seed=11)
    with pytest.raises(TypeError):
        JaxEncoder(JaxConfig(**kw)).encode_sequence(fr)
    with pytest.raises(ValueError, match="whole MB rows"):
        H264Encoder(EncoderConfig(**kw), device="cpu").encode_sequence(fr)
    assert (H264Encoder(EncoderConfig(**kw, idr_period=1),
                        device="cpu").encode_sequence(fr)
            == JaxEncoder(JaxConfig(**kw, idr_period=1)).encode_sequence(fr))


def test_rows_with_b_pictures_fail_in_both():
    """A B configuration's anchors take the tile rows and its B pictures
    one slice; the reference fetches a group's flat outputs in one stack,
    which fails on a tile-row anchor's (G, L_g) buffer beside a B
    picture's flat one (ValueError), so no B stream with tile rows codes
    there; the port's group fetch refuses the same group, and so the
    port's encode."""
    with pytest.raises(ValueError, match="same shape"):
        JRD.fetch_group([jnp.zeros((3, 40), jnp.int32),
                         jnp.zeros((100,), jnp.int32)])
    with pytest.raises(ValueError, match="same shape"):
        fetch_group([torch.zeros((3, 40), dtype=torch.int32),
                     torch.zeros(100, dtype=torch.int32)])
    assert fetch_group([torch.ones((3, 40), dtype=torch.int32)] * 2).shape \
        == (2, 3, 40)
    kw = dict(width=48, height=32, fast=True, entropy="cabac",
              search_range=4, row_slices=2, b_frames=1)
    fr = synthetic_frames(3, 48, 32)
    with pytest.raises(ValueError, match="same shape"):
        H264Encoder(EncoderConfig(**kw), device="cpu").encode_sequence(fr)
