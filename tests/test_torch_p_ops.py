"""Port P-picture helpers (h264_tpu_torch.encoder.rd / rd_p) vs the JAX
package's encoder/rd.py, elementwise, on the CPU; exact equality.

Inputs are made with numpy from a seed and go through the jitted JAX
function and the port's plain PyTorch version.  Also the exactness traps
of the P path: the float32 SATD lambda at every QP, the float32 RDOQ at QP
0/28/51, the integer bit length's argument bounds, and the windows that
the reference's dynamic_slice would clamp."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu.ops import quant as JQ
from h264_tpu.ops import transforms as JTR
from h264_tpu.ops.exact import chroma_qp
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.encoder import strengths as TS
from h264_tpu_torch.tools.strengths_cases import levels_of, per_block

QPS = [0, 28, 51]


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _eq(ours, theirs, what=""):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), what)


def _lam(qp):
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


@pytest.fixture
def rng():
    return np.random.RandomState(11)


def test_mv_bits_and_wp_affine(rng):
    d = np.arange(-3000, 3001, dtype=np.int32)
    _eq(TRD._mv_bits(_t(d)), jax.jit(JRD._mv_bits)(jnp.asarray(d)))
    x = rng.randint(0, 256, 5000).astype(np.int32)
    w = rng.randint(-128, 128, 5000).astype(np.int32)
    o = rng.randint(-128, 128, 5000).astype(np.int32)
    _eq(TRD._wp_affine(_t(x), _t(w), _t(o)),
        jax.jit(JRD._wp_affine)(*map(jnp.asarray, (x, w, o))))


@pytest.mark.parametrize("shape", [(40, 16, 16), (40, 8, 16), (40, 16, 8),
                                   (40, 8, 8), (40, 4, 8), (40, 8, 4),
                                   (40, 4, 4)])
def test_satd(rng, shape):
    d = rng.randint(-255, 256, shape).astype(np.int32)
    _eq(TRD._satd(_t(d)), jax.jit(JRD._satd)(jnp.asarray(d)))


def test_lam_satd_every_qp():
    """int32(sqrt(float32(lam_me) * 65536)) in float32, as the pipeline
    computes it with lam_me traced (rd.py:548), at every QP."""
    f = jax.jit(lambda lm: jnp.sqrt(
        jnp.asarray(lm, jnp.float32) * 65536.0).astype(jnp.int32))
    for qp in range(52):
        lam_me = 2 * _lam(qp)
        assert TRD.lam_satd_of(lam_me) == int(f(jnp.int32(lam_me))), qp


@pytest.mark.parametrize("qp", QPS)
def test_rdoq4(rng, qp):
    """float32 Delta-J decisions over many residual blocks: the torch
    version rounds once per operation, as XLA:CPU does.  The inter
    deadzone leaves RDOQ little to drop, so the levels are the quantized
    ones pushed up by 0, 1 or 2 at random: Delta-J then takes every sign,
    and many decisions fall close to 0."""
    n = 6000
    blk = np.round(rng.normal(0, 6, (n, 4, 4)) * rng.choice(
        [1, 4, 20], (n, 1, 1))).clip(-255, 255).astype(np.int32)
    lev = np.asarray(jax.jit(JQ.quant4x4)(
        JTR.forward4x4(jnp.asarray(blk)), jnp.int32(qp),
        jnp.int32(JQ.default_offset4(qp, False))))
    bump = rng.randint(0, 3, lev.shape) * np.where(
        rng.rand(*lev.shape) < 0.5, -1, 1)
    lev = np.where(lev != 0, lev + np.sign(lev) * np.abs(bump), bump)
    lev = lev.astype(np.int32)
    lam = _lam(qp)
    want = jax.jit(JRD._rdoq4)(jnp.asarray(blk), jnp.asarray(lev),
                               jnp.int32(qp), jnp.int32(lam))
    got = TRD._rdoq4(_t(blk), _t(lev), qp, lam)
    _eq(got, want)
    assert (np.asarray(want) != lev).any()  # decisions were taken


@pytest.mark.parametrize("first", [0, 1])
def test_block4_coeff_cost(rng, first):
    lev = rng.randint(-2, 3, (3000, 4, 4)).astype(np.int32)
    lev[rng.rand(3000, 4, 4) < 0.6] = 0
    _eq(TRD._block4_coeff_cost(_t(lev), first),
        jax.jit(functools.partial(JRD._block4_coeff_cost, first=first))(
            jnp.asarray(lev)))


def test_threshold_inter_luma(rng):
    n = 300
    lev = rng.randint(-2, 3, (n, 4, 4, 4, 4)).astype(np.int32)
    lev[rng.rand(*lev.shape) < 0.85] = 0
    pred = rng.randint(-20, 276, (n, 16, 16)).astype(np.int32)
    rec = rng.randint(0, 256, (n, 16, 16)).astype(np.int32)
    orig = rng.randint(0, 256, (n, 16, 16)).astype(np.int32)
    wl, wr, wd, wc = jax.jit(JRD._threshold_inter_luma)(
        *map(jnp.asarray, (lev, rec, pred, orig)))
    gl, gr, gd8, gc8 = TRD._threshold_inter_luma(_t(lev), _t(rec), _t(pred),
                                                 _t(orig))
    _eq(gl, wl, "lev")
    _eq(gr, wr, "rec")
    _eq(gd8.sum(-1, dtype=torch.int32), wd, "D")
    _eq(gc8.sum(-1, dtype=torch.int32), wc, "cb")


@pytest.mark.parametrize("qp", QPS)
def test_inter_luma_tq_and_chroma_tq(rng, qp):
    """The candidate residual path (rd.py:879 tq_recon) and the inter
    branch of `_chroma_tq` with RDOQ-lite and the JM AC drop."""
    pred = rng.randint(0, 256, (3, 8, 16, 16)).astype(np.int32)
    orig = (pred[0] + rng.randint(-40, 41, (8, 16, 16))).clip(0, 255)
    lam = _lam(qp)
    off = jnp.int32(JQ.default_offset4(qp, False))

    def tq_recon(p, o, qp, lam):  # rd.py:879-893, verbatim
        res = o - p
        blk = res.reshape(*res.shape[:-2], 4, 4, 4, 4).swapaxes(-3, -2)
        lev = JQ.quant4x4(JTR.forward4x4(blk), qp, off)
        lev = JRD._rdoq4(blk, lev, qp, lam)
        rr = JTR.inverse4x4(JQ.dequant4x4(lev, qp).astype(jnp.int32))
        pb = p.reshape(*p.shape[:-2], 4, 4, 4, 4).swapaxes(-3, -2)
        rec_b = ((rr + (pb << 6) + 32) >> 6).clip(0, 255)
        rec = rec_b.swapaxes(-3, -2).reshape(*p.shape)
        return JRD._threshold_inter_luma(lev, rec, p, o)

    want = jax.jit(tq_recon)(jnp.asarray(pred), jnp.asarray(orig)[None],
                             jnp.int32(qp), jnp.int32(lam))
    lev, rec, d8, cb8 = TP.inter_luma_tq_plain(_t(pred), _t(orig), qp, lam)
    _eq(lev, want[0], "lev")
    _eq(rec, want[1], "rec")
    _eq(d8.sum(-1, dtype=torch.int32), want[2], "D")
    _eq(cb8.sum(-1, dtype=torch.int32), want[3], "cb")
    cpred = rng.randint(0, 256, (24, 2, 8, 8)).astype(np.int32)
    corig = (cpred + rng.randint(-30, 31, cpred.shape)).clip(0, 255)
    qpc = chroma_qp(qp, 0)
    want = jax.jit(functools.partial(JRD._chroma_tq, intra=False))(
        jnp.asarray(cpred), jnp.asarray(corig), jnp.int32(qpc),
        lam=jnp.int32(lam))
    got = TP.inter_chroma_tq_plain(_t(cpred), _t(corig), qpc, lam)
    for g, w, name in zip(got, want, ("lev", "dc", "rec")):
        _eq(g, w, name)


def test_mc_chroma_unit(rng):
    Hc, Wc, NR, n = 24, 32, 2, 200
    cp = rng.randint(0, 256, (NR, 2, Hc + 64, Wc + 64)).astype(np.int32)
    r = rng.randint(0, NR, n).astype(np.int32)
    mvx = rng.randint(-200, 200, n).astype(np.int32)
    mvy = rng.randint(-200, 200, n).astype(np.int32)
    yc = rng.randint(0, Hc - 1, n).astype(np.int32)
    xc = rng.randint(0, Wc - 1, n).astype(np.int32)
    f = jax.jit(jax.vmap(
        lambda *a: JRD._mc_chroma_unit(jnp.asarray(cp), *a, 2, 2),
        in_axes=(0, 0, 0, 0, 0)))
    want = f(*map(jnp.asarray, (r, mvx, mvy, yc, xc)))
    got = TRD._mc_chroma_unit(_t(cp), *map(_t, (r, mvx, mvy, yc, xc)), 2, 2)
    _eq(got, want)


@pytest.mark.parametrize("qp", QPS)
def test_strengths_and_deblock(rng, qp):
    """strengths_full and deblock_device_full at 64x48; the port's one
    strengths function takes the reference's planes in rd_p's layouts
    (4x4 levels and per-block fields per MB, intra per MB); the port
    filters anti-diagonal by anti-diagonal, the reference in raster
    order."""
    H, W = 48, 64
    H4, W4 = H // 4, W // 4
    nz4 = rng.rand(H4, W4) < 0.3
    mvx = rng.randint(-6, 7, (H4, W4)).astype(np.int32)
    mvy = rng.randint(-6, 7, (H4, W4)).astype(np.int32)
    ref = rng.randint(0, 2, (H4, W4)).astype(np.int32)
    intra_mb = rng.rand(H // 16, W // 16) < 0.3
    intra = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    wv, wh = jax.jit(JRD.strengths_full)(*map(jnp.asarray,
                                              (nz4, mvx, mvy, ref, intra)))
    n_my, n_mx = H // 16, W // 16
    bv, bh = TS.strengths_plain(
        n_my, n_mx, _t(levels_of(nz4, n_my, n_mx)),
        _t(intra_mb.reshape(-1), torch.bool),
        *(_t(per_block(a, n_my, n_mx)) for a in (ref, mvx, mvy)))
    _eq(bv, wv, "BSV")
    _eq(bh, wh, "BSH")
    # blocky content: flat 4x4 blocks a few levels apart, plus noise
    base = np.repeat(np.repeat(rng.randint(100, 120, (H4, W4)), 4, 0), 4, 1)
    y = (base + rng.randint(-2, 3, (H, W))).astype(np.int32)
    u, v = (np.repeat(np.repeat(rng.randint(120, 130, (H4, W4)), 2, 0), 2,
                      1).astype(np.int32) for _ in range(2))
    qpc = chroma_qp(qp, 0)
    want = jax.jit(JRD.deblock_device_full)(
        *map(jnp.asarray, (y, u, v)), wv, wh, jnp.int32(qp), jnp.int32(qpc))
    got = TP.deblock_plain(_t(y), _t(u), _t(v), bv, bh, qp, qpc)
    for g, w, name in zip(got, want, "YUV"):
        _eq(g, w, name)
    if qp >= 28:
        assert not np.array_equal(np.asarray(want[0]), y)  # it filtered


def test_bitlen_arguments_stay_below_8192():
    """The port's integer bit length equals the reference's float32 one
    below 8192 (tests/test_torch_ops.py).  On the P path it sees mv
    differences and levels; both stay far below it."""
    R = 28
    RS = min(R, 10)
    cmax = TP.PADW - RS - 5
    # integer mvs: coarse centre +-4 RC, grid +-R; sub-8x8 centre +-CMAX,
    # grid +-RS; quarter-pel refinement +-3
    mv = 4 * max(4 * TP.RC + R, cmax + RS) + 3
    # an mvd is a difference of two such mvs (the PMV is a median of them)
    k = 2 * (2 * mv)
    assert k + 1 < 8192 and 2 * 4 * 4 * TP.RC + 1 < 8192
    # levels at QP 0: a 4x4 forward coefficient is at most 255 times the
    # L1 norm of its basis row pair; quant multiplies by MF (<= 13107)
    basis = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1],
                      [1, -2, 2, -1]])
    l1 = np.abs(basis).sum(1)
    cmax4 = 255 * np.outer(l1, l1)
    mf = np.asarray(TRD.Q.QUANT4[0])
    lev4 = (cmax4 * mf + (682 << 4)) >> 15
    # the I16 candidate's DC (hadamard of 16 DCs, halved) and chroma DC
    dc16 = ((16 * 16 * 255 // 2) * 13107 + 2 * (682 << 4)) >> 16
    dcc = ((4 * 16 * 255) * 13107 + 2 * (682 << 4)) >> 16
    assert max(lev4.max(), dc16, dcc) < 8192


@pytest.mark.parametrize("W,H", [(352, 288), (1280, 720)])
def test_no_window_starts_outside_the_widened_bank(W, H):
    """jax.lax.dynamic_slice clamps a start that would run out of range;
    the port clamps each coordinate instead.  The two agree because no
    window of this path starts out of range (R = 28, the widest), checked
    from the extreme mvs each stage can reach."""
    R, P, E = 28, TP.PAD, TP.E
    PW = P + E
    Hf, Wf = H + 2 * PW, W + 2 * PW  # widened bank
    cen = 4 * TP.RC  # |coarse centre|, full-pel
    # coarse: decimated window rows 4 my + 12 .. + 28 of (H + 2 PW) / 4
    assert 0 <= 12 and 4 * (H // 16 - 1) + 12 + 28 <= Hf // 4
    # block_ssd: y0 - R + PW .. + 2R + 8
    for y0, c in ((0, -cen), (H - 8, cen)):
        s = y0 + c - R + PW
        assert 0 <= s and s + 2 * R + 8 <= Hf
    # refine_unit (16x16 and 4x4 units): y0 + imv + PW - 1 .. + h + 3
    RS = min(R, 10)
    cmax = PW - RS - 5
    for h, imv in ((16, cen + R), (4, cmax + RS)):
        for y0, m in ((0, -imv), (H - h, imv)):
            s = y0 + m + PW - 1
            assert 0 <= s and s + h + 3 <= Hf
    # block_ssd4: y0 + cy - RS + PW .. + 2 RS + 4, |cy| <= CMAX
    for y0, c in ((0, -cmax), (H - 4, cmax)):
        s = y0 + c - RS + PW
        assert 0 <= s and s + 2 * RS + 4 <= Hf
    # skip MC (18 rows) and chroma MC (3 rows) at the largest mvs
    q = 4 * (cen + R) + 3
    for y0, m in ((0, -q), (H - 16, q)):
        s = y0 + (m >> 2) + PW
        assert 0 <= s and s + 18 <= Hf
    qs = 4 * (cmax + RS) + 3
    for yc, m in ((0, -qs), (H // 2 - 2, qs)):
        s = yc + (m >> 3) + PW
        assert 0 <= s and s + 3 <= H // 2 + 2 * PW
    assert Wf - W == Hf - H  # the same margins hold across
