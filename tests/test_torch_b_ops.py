"""The B picture's own operations in the port (h264_tpu_torch.encoder.rd_b,
decoder/mv.py) against the JAX package, on the CPU, exact equality, with
inputs from a numpy seed: boundary strengths with the two-list rule, the
windowed luma and chroma MC at the picture border (window starts clamped
as ``dynamic_slice`` clamps them), the temporal direct derivation and
prediction, DistScaleFactor, the B lambda's SATD form at every QP, and the
ranges that keep the search and refinement windows inside the padded
banks.  The B fills are held on the reference encoder's own parse states
in test_torch_b_encode.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.decoder import mv as JMV
from h264_tpu.encoder import fills as JFL
from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.decoder import mv as TMV
from h264_tpu_torch.encoder import encoder as TE
from h264_tpu_torch.encoder import fills as TFL
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_b as TB
from h264_tpu_torch.encoder import strengths as TS
from h264_tpu_torch.tools.strengths_cases import branches, strengths_inputs

W, H, NR = 64, 48, 3
Hp, Wp = H + 2 * TRD.PAD, W + 2 * TRD.PAD


@pytest.fixture
def rng():
    return np.random.RandomState(7)


@functools.lru_cache(maxsize=None)
def banks():
    """(banks (NR, 4, Hp, Wp), cpads (NR, 2, ...)) from JAX-made entries of
    random planes."""
    r = np.random.RandomState(3)
    ents = [JRD.ref_entry_from_planes(
        *(jnp.asarray(r.randint(0, 256, s), jnp.int32)
          for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
        for _ in range(NR)]
    return (np.stack([np.asarray(e[0]) for e in ents]),
            np.stack([np.asarray(e[1]) for e in ents]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _border_units(rng, n, h, w):
    """n (h, w) units, half of them at the picture's edges, with mvs up to
    +-90 pel (+-360 quarter-pel) pointing out of the picture there."""
    y0 = rng.randint(0, (H - h) // 4 + 1, n) * 4
    x0 = rng.randint(0, (W - w) // 4 + 1, n) * 4
    edge = rng.rand(n) < 0.5
    y0 = np.where(edge & (rng.rand(n) < 0.5), 0, y0)
    x0 = np.where(edge & (rng.rand(n) < 0.5), W - w, x0)
    mvx = rng.randint(-360, 361, n)
    mvy = rng.randint(-360, 361, n)
    return [a.astype(np.int32) for a in (y0, x0, mvx, mvy)]


@pytest.mark.parametrize("h,w", [(8, 8), (16, 16)])
def test_mc_luma_win_matches_dynfrac_mc(rng, h, w):
    b, _ = banks()
    n = 400
    y0, x0, mvx, mvy = _border_units(rng, n, h, w)
    ref = rng.randint(0, NR + 1, n).astype(np.int32)  # NR: clamped
    f = jax.jit(jax.vmap(lambda r, mx, my, yy, xx: JRD._dynfrac_mc(
        jnp.asarray(b), r, mx, my, yy, xx, h, w)))
    want = np.asarray(f(ref, mvx, mvy, y0, x0))
    got = TB.mc_luma_win_plain(_t(b), *map(_t, (ref, mvx, mvy, y0, x0)), h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    iy = y0 + (mvy >> 2) + TRD.PAD
    clamped = (iy < 0) | (iy > Hp - h - 2)
    assert clamped.sum() > 20 and (~clamped).sum() > 20


def _jax_chroma_pred(c0, c1, idx0, m0x, m0y, m1x, m1y, u0, u1):
    """The reference's chroma_pred_mb (rd.py:2453-2470) over every MB."""
    n_mx = W // 16

    def unit(i, b8):
        yc = (i // n_mx) * 8 + (b8 >> 1) * 4
        xc = (i % n_mx) * 8 + (b8 & 1) * 4
        a = JRD._mc_chroma_unit(c0, idx0[i, b8], m0x[i, b8], m0y[i, b8],
                                yc, xc, 4, 4)
        b = JRD._mc_chroma_unit(c1, jnp.int32(0), m1x[i, b8], m1y[i, b8],
                                yc, xc, 4, 4)
        both = u0[i, b8] & u1[i, b8]
        return jnp.where(both, (a + b + 1) >> 1, jnp.where(u0[i, b8], a, b))

    def mb(i):
        blocks = [unit(i, b8) for b8 in range(4)]
        return jnp.concatenate([jnp.concatenate(blocks[:2], axis=2),
                                jnp.concatenate(blocks[2:], axis=2)], axis=1)

    n_mb = idx0.shape[0]
    return np.asarray(jax.jit(jax.vmap(mb))(jnp.arange(n_mb)))


def test_mc_chroma_b_matches_chroma_pred_mb(rng):
    _, c = banks()
    n_mb = (H // 16) * (W // 16)
    idx0 = rng.randint(0, NR, (n_mb, 4)).astype(np.int32)
    m = [rng.randint(-360, 361, (n_mb, 4)).astype(np.int32) for _ in range(4)]
    u0 = rng.rand(n_mb, 4) < 0.7
    u1 = rng.rand(n_mb, 4) < 0.7
    want = _jax_chroma_pred(jnp.asarray(c), jnp.asarray(c[1:2]),
                            jnp.asarray(idx0), *map(jnp.asarray, m),
                            jnp.asarray(u0), jnp.asarray(u1))
    got = TB.mc_chroma_b_plain(_t(c), _t(c[1:2]), _t(idx0), *map(_t, m),
                               _t(u0), _t(u1))
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, y0, _ = TB._units(n_mb, W // 16, "cpu")
    yi = (y0.numpy() >> 1) + (m[1] >> 3) + TRD.PAD
    assert ((yi < 0) | (yi > H // 2 + 2 * TRD.PAD - 5)).sum() > 5


def _jax_direct(b0, b1, ci, cr, cmx, cmy, dsf_tab, eq_tab):
    """The reference's direct_b8 / direct_mb (rd.py:2218-2263)."""
    n_my, n_mx = H // 16, W // 16
    b8oy, b8ox = (0, 0, 8, 8), (0, 8, 0, 8)

    def direct_b8(i, b8):
        ry = (i // n_mx) * 4 + (0 if b8oy[b8] == 0 else 3)
        rx = (i % n_mx) * 4 + (0 if b8ox[b8] == 0 else 3)
        col_i = ci[ry, rx]
        mcx = jnp.where(col_i, 0, cmx[ry, rx])
        mcy = jnp.where(col_i, 0, cmy[ry, rx])
        idx = jnp.where(col_i, 0, cr[ry, rx]).astype(jnp.int32)
        dsf = dsf_tab[idx]
        eq = eq_tab[idx] | col_i
        l0x = jnp.where(eq, mcx, (dsf * mcx + 128) >> 8)
        l0y = jnp.where(eq, mcy, (dsf * mcy + 128) >> 8)
        return (idx, l0x, l0y, jnp.where(eq, 0, l0x - mcx),
                jnp.where(eq, 0, l0y - mcy))

    def direct_mb(i):
        parts = [direct_b8(i, b8) for b8 in range(4)]
        blocks = []
        for b8, (idx, l0x, l0y, l1x, l1y) in enumerate(parts):
            y0 = (i // n_mx) * 16 + b8oy[b8]
            x0 = (i % n_mx) * 16 + b8ox[b8]
            p0 = JRD._dynfrac_mc(b0, idx, l0x, l0y, y0, x0, 8, 8)
            p1 = JRD._dynfrac_mc(b1, jnp.int32(0), l1x, l1y, y0, x0, 8, 8)
            blocks.append((p0 + p1 + 1) >> 1)
        pred = jnp.concatenate([jnp.concatenate(blocks[:2], axis=1),
                                jnp.concatenate(blocks[2:], axis=1)], axis=0)
        return (pred,) + tuple(jnp.stack([p[k] for p in parts])
                               for k in range(5))

    out = jax.jit(jax.vmap(direct_mb))(jnp.arange(n_my * n_mx))
    return [np.asarray(x) for x in out]


def test_temporal_direct_matches_reference(rng):
    b, _ = banks()
    H4, W4 = H // 4, W // 4
    ci = rng.rand(H4, W4) < 0.2
    cr = rng.randint(0, NR, (H4, W4)).astype(np.int32)
    cmx = rng.randint(-400, 401, (H4, W4)).astype(np.int32)
    cmy = rng.randint(-400, 401, (H4, W4)).astype(np.int32)
    poc, pocs0, poc1 = 6, [4, 2, 8], 8  # the last list-0 ref is the anchor
    dsf = np.asarray([TMV.dist_scale_factor(poc, p, poc1) if p != poc1 else 0
                      for p in pocs0], np.int32)
    eq = np.asarray([p == poc1 for p in pocs0])
    want = _jax_direct(jnp.asarray(b), jnp.asarray(b[2:3]),
                       *map(jnp.asarray, (ci, cr, cmx, cmy, dsf, eq)))
    got = TB.b_direct_plain(_t(b), _t(b[2:3]), *map(_t, (ci, cr, cmx, cmy,
                                                         dsf, eq)))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w_)
    # negative scaled mvs (arithmetic shift), and units whose colocated
    # reference is the anchor itself (unscaled)
    idx, l0x = got[1].numpy(), got[2].numpy()
    assert (l0x < 0).any() and (idx == 2).any() and (idx < 2).any()


def strengths_b_reference(args):
    """The reference's strengths_full_b on the per-4x4 planes its
    rd_b_pipeline builds (rd.py:2487-2505) from the B fields `args` of
    the port's one strengths function."""
    (n_my, n_mx, coef, intra, idx0, m0x, m0y, _, _, pocs0, u0, m1x, m1y,
     u1, poc1) = args

    def R(x):
        return TS.raster(x, n_my, n_mx, "field")[..., 0].numpy()

    lev = coef.numpy()
    nz4 = (lev != 0).any((-1, -2))
    nz4 = nz4.reshape(n_my, n_mx, 4, 4).transpose(0, 2, 1, 3).reshape(
        4 * n_my, 4 * n_mx)
    intra4 = R(intra)
    r0 = pocs0.numpy()[np.clip(R(idx0), 0, pocs0.numel() - 1)]
    return JRD.strengths_full_b(*map(jnp.asarray, (
        nz4, intra4, R(u0) & ~intra4, r0, R(m0x), R(m0y), R(u1) & ~intra4,
        np.full_like(r0, poc1), R(m1x), R(m1y))))


def test_strengths_b_matches_reference(rng):
    """Seeded B fields in rd_b's layout (per-MB intra, per-unit list-0
    indices, mvs and list flags, the MBs' 4x4 levels), list 0 holding the
    anchor's POC: the port's one strengths function equals the
    reference's strengths_full_b on the planes its pipeline builds."""
    n_my, n_mx = 6, 8
    n_mb = n_my * n_mx
    pocs = np.asarray([0, 2, 4, 8], np.int32)
    intra = rng.rand(n_mb) < 0.08
    use = rng.randint(0, 3, (n_mb, 4))
    u0 = (use != 1) & ~intra[:, None]
    u1 = (use != 0) & ~intra[:, None]
    idx = rng.randint(0, 5, (n_mb, 4)).astype(np.int32)  # 4: clamped
    m = [rng.randint(-7, 8, (n_mb, 4)).astype(np.int32) for _ in range(4)]
    lev = np.where(rng.rand(n_mb, 4, 4, 4, 4) < 0.01,
                   rng.randint(-2, 3, (n_mb, 4, 4, 4, 4)), 0).astype(np.int32)
    args = (n_my, n_mx, _t(lev), _t(intra), _t(idx), _t(m[0]), _t(m[1]),
            None, None, _t(pocs), _t(u0), _t(m[2]), _t(m[3]), _t(u1), 8)
    want = strengths_b_reference(args)
    got = TS.strengths_plain(*args)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert set(np.unique(np.asarray(want[0]))) == {0, 1, 2, 3, 4}
    n = branches(args)
    assert n["crossed_mv_small"] + n["crossed_mv_large"] > 0, n
    assert n["same_ref_mv_small"] + n["same_ref_mv_large"] > 0, n


@pytest.mark.parametrize("H4,W4", [(36, 44), (72, 88)])
def test_strengths_b_built_inputs_reach_every_branch(H4, W4):
    """The built B inputs the card's check of strengths uses: the plain
    version equals the reference on them, and every branch of the pairing
    rule decides some edges (counted apart, then matched to the bS)."""
    args = strengths_inputs(H4 // 4, W4 // 4, seed=H4 + W4, device="cpu")
    want = strengths_b_reference(args)
    got = TS.strengths_plain(*args)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    n = branches(args)
    assert min(n.values()) > 0, n
    bs = np.concatenate([got[0][:, 1:].reshape(-1).numpy(),
                         got[1][1:, :].reshape(-1).numpy()])
    small = sum(v for k, v in n.items() if k.endswith("_mv_small"))
    large = sum(v for k, v in n.items() if k.endswith("_mv_large"))
    assert [int((bs == b).sum()) for b in range(5)] == [
        small, n["unmatched"] + large, n["coefficients"], n["intra_inside"],
        n["intra_mb_edge"]]


def test_dist_scale_factor_poc_grid():
    for cur in range(-6, 40, 3):
        for p0 in range(-70, 70, 7):
            for p1 in range(-70, 200, 11):
                if p1 == p0:
                    continue
                assert TMV.dist_scale_factor(cur, p0, p1) == \
                    JMV.dist_scale_factor(cur, p0, p1)
    pocs0 = [4, 2, 0, -8, 300]
    np.testing.assert_array_equal(TFL.dist_scale_factors(6, pocs0, 8),
                                  JFL.dist_scale_factors(6, pocs0, 8))
    a = np.arange(-50, 51)
    np.testing.assert_array_equal(TFL._cdiv_arr(a[:, None], a[None, a != 0]),
                                  JFL._cdiv_arr(a[:, None], a[None, a != 0]))
    assert TMV._cdiv(-7, 2) == -3 and TMV._cdiv(7, -2) == -3


@pytest.mark.parametrize("is_ref", [False, True], ids=["leaf", "stored"])
def test_b_lambda_every_qp(is_ref):
    """The B lambda (float64 host, rd.py:2097's SATD form in float32)."""
    sq = jax.jit(lambda lam: jnp.sqrt(
        jnp.asarray(lam, jnp.float32) * 65536.0).astype(jnp.int32))
    for qp in range(52):
        t = qp - 12
        lam_f = (0.68 * 0.95 * 2.0 ** (t / 3.0) * min(4.0, max(2.0, t / 6.0))
                 * (0.5 if is_ref else 1.0))
        lam = TE.b_lambda_fx(qp, is_ref)
        assert lam == int(lam_f * 65536 + 0.5)
        assert TRD.lam_satd_of(lam) == int(sq(jnp.int32(lam)))


@pytest.mark.parametrize("W_,H_", [(352, 288), (1280, 720)])
def test_no_b_search_or_refine_window_leaves_the_bank(W_, H_):
    """The B search and refinement read the unwidened banks (PAD = 32) at
    zero centres; dynamic_slice would shift a window that leaves them,
    the port's K3/K4 clamp per sample.  At R <= 28 no such window starts
    out of range, checked from the extreme mvs each stage can reach."""
    P = TRD.PAD
    for R in (8, 16, 28):
        for L, n in ((H_, H_ + 2 * P), (W_, W_ + 2 * P)):
            # block_ssd: y0 - R + PAD .. + 2R + 8
            for y0 in (0, L - 8):
                s = y0 - R + P
                assert 0 <= s and s + 2 * R + 8 <= n
            # refine_u: y0 + imv + PAD - 1 .. + h + 3, |imv| <= R
            for h in (8, 16):
                for y0, imv in ((0, -R), (L - h, R)):
                    s = y0 + imv + P - 1
                    assert 0 <= s and s + h + 3 <= n
            # L0 at the PMV: a median of integer mvs, |pmv| <= 4R
            for y0, m in ((0, -4 * R), (L - 16, 4 * R)):
                s = y0 + (m >> 2) + P
                assert 0 <= s and s + 18 <= n
            # explicit chroma: refined mvs, |mv| <= 4R + 3
            for yc, m in ((0, -4 * R - 3), (L // 2 - 4, 4 * R + 3)):
                s = yc + (m >> 3) + P
                assert 0 <= s and s + 5 <= L // 2 + 2 * P
