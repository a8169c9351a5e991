"""One B picture through the JAX package's ``rd_b_pipeline`` and the
port's (h264_tpu_torch.encoder.rd_b), on the CPU, with ``make_ref`` False
and True: equal ``host_out``, recon, and (stored B) reference entry with
its colocated snapshot; and the hierarchical IPB stream (``b_hierarchy``,
b_frames 3, num_ref_frames 2, search range 8, QP 30, 9 frames) against
the JAX package's: byte-identical, with equal recons and reference
entries, and every B picture's outputs from the reference's DPB.

The one picture is 176x144 at R = 8 with a list 0 of 4 banks of which 3
are active: the shapes of the hierarchical stream's B pictures, so this
file's worker compiles the reference pipeline once for both.  Its banks
are JAX-made reference entries of moving frames whose outer 16 pixels
are flat; the colocated field carries the pan's motion inside, scaled by
DistScaleFactor, and mvs of +-90 pel on that border ring that refer to
the anchor itself (unscaled list 0, zero list 1), so direct predictions
and chroma windows start outside the padded banks, where
``dynamic_slice`` moves them, and still predict the flat ring: the ring
MBs take direct modes (the test asserts both)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_b_encode as base
from h264_tpu.decoder.mv import dist_scale_factor
from h264_tpu.encoder import rd as JRD
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder import rd_b as TB
from h264_tpu_torch.encoder.encoder import (EncoderConfig, H264Encoder,
                                            b_lambda_fx)
from h264_tpu_torch.encoder.rd import PAD
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, R, NR0, NREF0, QP = 176, 144, 8, 4, 3, 30
POC, POCS0, POC1 = 6, [4, 2, 8, 8], 8  # list 0 holds the anchor too
torch.set_num_threads(1)


def _flat_border(frame):
    y, u, v = (np.array(p) for p in frame)
    for p, m in ((y, 16), (u, 8), (v, 8)):
        p[:m], p[-m:], p[:, :m], p[:, -m:] = 128, 128, 128, 128
    return y, u, v


@functools.lru_cache(maxsize=None)
def inputs():
    """cur (POC 6), list 0 (POCs 4, 2, the anchor 8 and a padding copy),
    the list-1 anchor (POC 8) and its colocated field, DistScaleFactors,
    eq flags."""
    fr = [_flat_border(f) for f in moving_frames(5, W, H, seed=21)]
    ents = [JRD.ref_entry_from_planes(*(jnp.asarray(p, jnp.int32)
                                        for p in fr[i])) for i in (2, 1, 4)]
    b0 = np.stack([np.asarray(ents[i][0]) for i in (0, 1, 2, 2)])
    c0 = np.stack([np.asarray(ents[i][1]) for i in (0, 1, 2, 2)])
    b1, c1 = np.asarray(ents[2][0])[None], np.asarray(ents[2][1])[None]
    rng = np.random.RandomState(5)
    H4, W4 = H // 4, W // 4
    intra = rng.rand(H4, W4) < 0.1
    ref = np.where(rng.rand(H4, W4) < 0.8, 0,
                   rng.randint(0, 2, (H4, W4))).astype(np.int32)
    # the pan's motion from the anchor to list-0 picture k (2 + k frames
    # back; moving_frames pans (0.75, 1.25) pel a frame), some noise
    mvy = ((2 + ref) * 3 + rng.randint(-1, 2, (H4, W4))).astype(np.int32)
    mvx = ((2 + ref) * 5 + rng.randint(-1, 2, (H4, W4))).astype(np.int32)
    # the flat border ring points +-90 pel out of the picture (full-pel)
    # at the anchor itself
    yy, xx = np.mgrid[0:H4, 0:W4]
    ring = (yy < 4) | (yy >= H4 - 4) | (xx < 4) | (xx >= W4 - 4)
    ref = np.where(ring, 2, ref).astype(np.int32)
    mvx = np.where(ring, np.where(xx < W4 // 2, -360, 360), mvx)
    mvy = np.where(ring, np.where(yy < H4 // 2, -352, 352), mvy)
    intra &= ~ring
    col = (intra, ref, mvx.astype(np.int32), mvy.astype(np.int32))
    dsf = np.asarray([dist_scale_factor(POC, p, POC1) if p != POC1 else 0
                      for p in POCS0], np.int32)
    eq = np.asarray([p == POC1 for p in POCS0])
    return fr[3], b0, c0, b1, c1, col, dsf, eq


@functools.lru_cache(maxsize=None)
def jax_out(make_ref: bool):
    cur, b0, c0, b1, c1, col, dsf, eq = inputs()
    lam = b_lambda_fx(QP, make_ref)
    out = JRD.rd_b_pipeline(
        *map(jnp.asarray, cur), jnp.asarray(b0), jnp.asarray(c0),
        jnp.asarray(b1), jnp.asarray(c1), *map(jnp.asarray, col),
        jnp.asarray(np.asarray(POCS0, np.int32)), jnp.asarray(dsf),
        jnp.asarray(eq), jnp.int32(POC1), H=H, W=W, R=R, qp=QP, qp_c=QP - 1,
        lam=lam, lam_me=lam, nref0=jnp.int32(NREF0), make_ref=make_ref)
    return [np.asarray(out[0]), [np.asarray(x) for x in out[1]]] + (
        [[np.asarray(x) for x in (*out[2][:2], *out[2][2])]]
        if make_ref else [])


@functools.lru_cache(maxsize=None)
def port_frame(make_ref: bool):
    cur, b0, c0, b1, c1, col, dsf, eq = inputs()
    lam = b_lambda_fx(QP, make_ref)
    def t(a):
        return torch.tensor(np.asarray(a))

    f = TB.BFrame(*(t(np.asarray(p, np.int32)) for p in cur), t(b0), t(c0),
                  t(b1), t(c1), t(col[0]), t(col[1]), t(col[2]), t(col[3]),
                  torch.tensor(POCS0, dtype=torch.int32), t(dsf), t(eq), POC1,
                  H, W, R, QP, QP - 1, lam, lam, NREF0, make_ref, TB.PLAIN)
    for stage in TB.B_STAGES:
        stage(f)
    return f, TB.b_outputs(f)


@pytest.mark.parametrize("make_ref", [False, True], ids=["leaf", "stored"])
def test_host_out_and_recon_equal(make_ref):
    want = jax_out(make_ref)
    _, got = port_frame(make_ref)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for x, y in zip(got[1], want[1]):
        np.testing.assert_array_equal(x.numpy(), y)


def test_stored_entry_and_col_equal():
    want = jax_out(True)[2]
    _, got = port_frame(True)
    bank, cpad, col = got[2]
    assert col[0].dtype == torch.bool and col[1].dtype == torch.int32
    for x, y in zip((bank, cpad, *col), want):
        np.testing.assert_array_equal(x.numpy(), y)
    # L1-only blocks carry the sentinel NR0
    assert int(col[1].max()) <= NR0


def test_the_picture_takes_every_kind_of_decision():
    f, _ = port_frame(False)
    win = f.win.numpy()
    assert np.isin(win, [TB.B_DIRECT, TB.B_DIRECT_ZERO]).any()
    assert np.isin(win, [TB.B_L0, TB.B_L1, TB.B_BI]).any()
    assert (~np.isin(win, [TB.B_DIRECT, TB.B_DIRECT_ZERO])).any()
    fs, _ = port_frame(True)
    assert not np.isin(fs.win.numpy(), [TB.B_DIRECT, TB.B_DIRECT_ZERO]).any()


def test_direct_and_chroma_windows_are_start_clamped():
    """Some direct-prediction windows, and chroma windows of the winners,
    start outside the padded banks, where dynamic_slice moves them."""
    f, _ = port_frame(False)
    Hp, Wp = H + 2 * PAD, W + 2 * PAD
    _, _, y0, x0 = TB._units(f.n_mb, f.n_mx, f.dev)
    out = 0
    for mx, my in ((f.dir_l0x, f.dir_l0y), (f.dir_l1x, f.dir_l1y)):
        iy = y0 + (my >> 2) + PAD
        ix = x0 + (mx >> 2) + PAD
        out += int(((iy < 0) | (iy > Hp - 10) | (ix < 0)
                    | (ix > Wp - 10)).sum())
    assert out > 10
    yc = (y0 >> 1) + (f.w_m0y >> 3) + PAD
    xc = (x0 >> 1) + (f.w_m0x >> 3) + PAD
    cout = f.u0_8 & ((yc < 0) | (yc > H // 2 + 2 * PAD - 5) | (xc < 0)
                     | (xc > W // 2 + 2 * PAD - 5))
    assert int(cout.sum()) > 0


# ---------------------------------------------------------------------------
# the hierarchical stream
# ---------------------------------------------------------------------------

N_HIER = 9


def hier_cfg(cls):
    return cls(width=W, height=H, qp=QP, fast=True, rd=True, entropy="cabac",
               b_frames=3, b_hierarchy=True, num_ref_frames=2,
               search_range=R)


@functools.lru_cache(maxsize=None)
def hier_frames():
    return moving_frames(N_HIER, W, H, seed=31)


@functools.lru_cache(maxsize=None)
def jax_hier():
    enc, snaps = JaxEncoder(hier_cfg(JaxConfig)), []
    base.record_b(enc, snaps)
    return enc, enc.encode_sequence(hier_frames()), snaps


@functools.lru_cache(maxsize=None)
def port_hier():
    enc, snaps = H264Encoder(hier_cfg(EncoderConfig), device="cpu"), []
    base.record_b(enc, snaps)
    return enc, enc.encode_sequence(hier_frames()), snaps


def test_hier_stream_byte_identical_recon_and_refs_equal():
    jenc, jstream, _ = jax_hier()
    tenc, tstream, tsnaps = port_hier()
    base.check_stream(jenc, jstream, tenc, tstream, N_HIER)
    # decode order: I, P 8, stored B 4, B 2, B 6, P 16, stored B 12, ...
    assert [p for p, _ in tenc.all_recons] == [0, 8, 4, 2, 6, 16, 12, 10,
                                               14]
    assert [s["is_ref"] for s in tsnaps] == [True, False, False] * 2


def test_hier_b_pipeline_from_jax_state():
    snaps = jax_hier()[2]
    assert len(snaps) == 6
    base.check_b_from_jax_state(snaps, hier_cfg(EncoderConfig))
