"""Port leaf ops (h264_tpu_torch.ops, rd rate helpers) vs the JAX package.

Same seeded numpy inputs through the jitted JAX function (CPU) and the
port's PyTorch version on the CPU; the tolerance is exact equality (a
codec port is bit-exact or wrong)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu.ops import quant as JQ
from h264_tpu.ops import transforms as JTR
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TRP
from h264_tpu_torch.ops import quant as TQ
from h264_tpu_torch.ops import transforms as TTR
from h264_tpu_torch.tools.t8_cases import basis_signs

QPS = list(range(52))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _eq(ours, theirs):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.RandomState(11)
    return {
        "res": rng.randint(-255, 256, (64, 4, 4)).astype(np.int32),
        "coef": rng.randint(-4080, 4081, (64, 4, 4)).astype(np.int32),
        "lev": rng.randint(-40, 41, (64, 4, 4)).astype(np.int32),
        "dc22": rng.randint(-16320, 16321, (64, 2, 2)).astype(np.int32),
        "dc44": rng.randint(-32640, 32641, (64, 4, 4)).astype(np.int32),
        "res8": rng.randint(-255, 256, (64, 8, 8)).astype(np.int32),
        "coef8": rng.randint(-16320, 16321, (64, 8, 8)).astype(np.int32),
        "lev8": rng.randint(-40, 41, (64, 8, 8)).astype(np.int32),
    }


@pytest.mark.parametrize("name,src", [
    ("forward4x4", "res"), ("inverse4x4", "coef"), ("hadamard4x4", "coef"),
    ("hadamard2x2", "dc22"), ("forward8x8", "res8"), ("inverse8x8", "coef8"),
])
def test_transforms(blocks, name, src):
    x = blocks[src]
    want = jax.jit(getattr(JTR, name))(jnp.asarray(x))
    _eq(getattr(TTR, name)(_t(x)), want)


@jax.jit
def _jax_quant(coef, lev, dc44, dc22, qp):
    off = JQ.default_offset4(qp, True)
    return (JQ.quant4x4(coef, qp, off), JQ.dequant4x4(lev, qp),
            JQ.quant_luma_dc(dc44, qp, intra=True),
            JQ.dequant_luma_dc(lev, qp),
            JQ.quant_chroma_dc(dc22, qp, True),
            JQ.quant_chroma_dc(dc22, qp, False),
            JQ.dequant_chroma_dc(lev[:, :2, :2], qp),
            off, JQ.default_offset4(qp, False))


@pytest.mark.parametrize("qp", QPS)
def test_quant_every_qp(blocks, qp):
    """Traced qp on the JAX side (its table-gather and dynamic-shift
    path); int and 0-d tensor qp on the port side."""
    b = blocks
    want = _jax_quant(*(jnp.asarray(b[k]) for k in
                        ("coef", "lev", "dc44", "dc22")), jnp.int32(qp))
    for q in (qp, torch.tensor(qp, dtype=torch.int32)):
        off = TQ.default_offset4(q, True)
        got = (TQ.quant4x4(_t(b["coef"]), q, off),
               TQ.dequant4x4(_t(b["lev"]), q),
               TQ.quant_luma_dc(_t(b["dc44"]), q, intra=True),
               TQ.dequant_luma_dc(_t(b["lev"]), q),
               TQ.quant_chroma_dc(_t(b["dc22"]), q, True),
               TQ.quant_chroma_dc(_t(b["dc22"]), q, False),
               TQ.dequant_chroma_dc(_t(b["lev"][:, :2, :2]), q))
        for g, w in zip(got, want):
            _eq(g, w)
        assert off == int(want[7])
        assert TQ.default_offset4(q, False) == int(want[8])


def test_bitlen_exhaustive():
    """Integer bit length vs the reference's float32 floor(log2) + 1 over
    [1, 2^20).  They agree on every value below 8192, which covers every
    level the intra path can produce (|level| <= 6528, the luma-DC bound
    at QP 0); XLA:CPU's float32 log2 rounds down at 8192 and 32768, where
    the port keeps the exact bit length."""
    a = np.arange(1, 1 << 20, dtype=np.int32)
    ours = TRD._bitlen(torch.from_numpy(a)).numpy()
    exact = np.frexp(a.astype(np.float64))[1]
    np.testing.assert_array_equal(ours, exact)
    theirs = np.asarray(jax.jit(JRD._bitlen)(jnp.asarray(a)))
    below = a < 8192
    np.testing.assert_array_equal(ours[below], theirs[below])
    assert (a[ours != theirs] >= 8192).all()


def test_coef_bits_and_lam_cost(blocks):
    lev = np.concatenate([blocks["lev"], blocks["coef"] // 2,
                          np.zeros((4, 4, 4), np.int32)])
    _eq(TRD._coef_bits(_t(lev)), jax.jit(JRD._coef_bits)(jnp.asarray(lev)))
    bits = np.arange(0, 30000, 7, dtype=np.int32)
    for qp in (0, 12, 28, 40, 51):
        lam = int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)
        want = jax.jit(JRD._lam_cost)(jnp.int32(lam), jnp.asarray(bits))
        _eq(TRD._lam_cost(lam, _t(bits)), want)


@jax.jit
def _jax_quant8(coef8, lev8, qp):
    off = JQ.default_offset8(qp, False)
    return (JQ.quant8x8(coef8, qp, off), JQ.dequant8x8(lev8, qp), off,
            JQ.default_offset8(qp, True))


@pytest.mark.parametrize("qp", QPS)
def test_quant8_every_qp(blocks, qp):
    """8x8 quant (inter and intra offsets), dequant and the QUANT8 table
    row against the reference's traced-qp path, on +-255 residual blocks
    through forward8x8."""
    coef8 = np.asarray(jax.jit(JTR.forward8x8)(jnp.asarray(blocks["res8"])))
    want = _jax_quant8(jnp.asarray(coef8), jnp.asarray(blocks["lev8"]),
                       jnp.int32(qp))
    for q in (qp, torch.tensor(qp, dtype=torch.int32)):
        off = TQ.default_offset8(q, False)
        _eq(TQ.quant8x8(_t(coef8), q, off), want[0])
        _eq(TQ.dequant8x8(_t(blocks["lev8"]), q), want[1])
        assert off == int(want[2])
        assert TQ.default_offset8(q, True) == int(want[3])
    np.testing.assert_array_equal(TQ.QUANT8[qp % 6], JQ.QUANT8[qp % 6])


def _t8_reference(orig_mb, w_pred, w_rec, w_lev, win, w_sub, is_intra, qp,
                  lam):
    """The reference's T8 stage (h264_tpu/encoder/rd.py:1071-1113) on its
    own, written with the reference package's functions."""
    n_mb = orig_mb.shape[0]
    res = (orig_mb - w_pred).reshape(n_mb, 2, 8, 2, 8).swapaxes(2, 3)
    co8 = JTR.forward8x8(res)
    per8, rem8 = qp // 6, qp % 6
    mf8 = jnp.asarray(JQ.QUANT8)[rem8]
    v8 = jnp.asarray(JQ.DEQUANT8)[rem8] * 16
    off8 = JQ.default_offset8(qp, False)
    a8c = jnp.abs(co8)
    q = (a8c * mf8 + off8) >> (JQ.Q_BITS_8 + per8)
    lev8 = jnp.where(co8 < 0, -q, q)
    rr8 = JTR.inverse8x8(((lev8 * v8) << per8) + 32 >> 6)
    pb8 = w_pred.reshape(n_mb, 2, 8, 2, 8).swapaxes(2, 3)
    rec8 = ((rr8 + (pb8 << 6) + 32) >> 6).clip(0, 255)
    rec8 = rec8.swapaxes(2, 3).reshape(n_mb, 16, 16)
    D_8 = ((orig_mb - rec8) ** 2).sum((-1, -2))
    a8l = jnp.abs(lev8)
    nz8 = a8l > 0
    cb8 = (jnp.where(nz8, 2 * JRD._bitlen(jnp.maximum(a8l, 1)) + 2, 0)
           .sum((-1, -2)) + jnp.where(nz8.any((-1, -2)), 4, 0)).sum((-1, -2))
    D_4 = ((orig_mb - w_rec) ** 2).sum((-1, -2))
    cb4 = JRD._coef_bits(w_lev).sum((-1, -2))
    ok = (~is_intra) & (win != TRP.C_SKIP) & (
        (win != TRP.C_P8x8) | (w_sub == 0).all(-1))
    use8 = ok & (D_8 + JRD._lam_cost(lam, cb8 + 1)
                 < D_4 + JRD._lam_cost(lam, cb4 + 1))
    u5 = use8[:, None, None, None, None]
    return (use8.astype(jnp.int32), jnp.where(u5, lev8, 0),
            jnp.where(u5, 0, w_lev), jnp.where(use8[:, None, None], rec8, w_rec))


def _t8_inputs(rng, n_mb):
    """Seeded T8 stage inputs: predictions within 2, 12 or 40 of the
    source, a 4x4 recon near the source or equal to the prediction (no
    4x4 residual), sparse 4x4 levels, every winner class."""
    orig = rng.randint(0, 256, (n_mb, 16, 16))
    spread = rng.choice([2, 12, 40], (n_mb, 1, 1))
    pred = np.clip(orig + (rng.randint(-40, 41, orig.shape) * spread) // 40,
                   0, 255)
    rec = np.where(rng.rand(n_mb, 1, 1) < 0.5, pred,
                   np.clip(orig + rng.randint(-3, 4, orig.shape), 0, 255))
    lev = rng.randint(-3, 4, (n_mb, 4, 4, 4, 4)) * (
        rng.rand(n_mb, 4, 4, 4, 4) < 0.1)
    win = rng.randint(0, 7, n_mb)
    sub = rng.randint(0, 4, (n_mb, 4)) * (rng.rand(n_mb, 4) < 0.3)
    return (orig, pred, rec, lev, win, sub, win == TRP.C_I16)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_t8_decide_plain_matches_reference_stage(qp):
    rng = np.random.RandomState(qp)
    lam = int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)
    args = _t8_inputs(rng, 300)
    want = jax.jit(_t8_reference, static_argnums=(7,))(
        *(jnp.asarray(a) for a in args), qp, jnp.int32(lam))
    got = TRP.t8_decide_plain(*(_t(a) for a in args[:6]),
                              torch.from_numpy(args[6]), qp, lam)
    for g, w in zip(got, want):
        _eq(g, w)
    assert 0 < int(got[0].sum()) < 300


def test_t8_level_bound():
    """The largest 8x8 level at QP 0 is 3264 (the DC of a +-255
    residual), far below 8192 where `_bitlen` leaves the reference's
    float32 form: per coefficient (u, v) the residual whose signs follow
    the basis products reaches it, and a seeded sweep of +-255 blocks
    stays inside it."""
    worst = 255 * basis_signs()
    rng = np.random.RandomState(5)
    sweep = rng.choice([-255, 255], (4096, 8, 8))
    for res in (worst, -worst, sweep):
        coef = TTR.forward8x8(_t(res))
        lev = TQ.quant8x8(coef, 0, TQ.default_offset8(0, False)).abs()
        assert int(lev.max()) <= 3264
    lev = TQ.quant8x8(TTR.forward8x8(_t(worst)), 0, TQ.default_offset8(0, False))
    assert int(lev.abs().max()) == 3264


def test_t8_tie_keeps_4x4():
    """A zero residual codes no level either way: D_8 = D_4 = 0 and equal
    bits, and the strict < keeps every MB on the 4x4 transform."""
    rng = np.random.RandomState(2)
    orig = _t(rng.randint(0, 256, (20, 16, 16)))
    z = torch.zeros((20, 4, 4, 4, 4), dtype=torch.int32)
    win = torch.zeros(20, dtype=torch.int32)
    t8, lev8, lev, rec = TRP.t8_decide_plain(
        orig, orig.clone(), orig.clone(), z, win,
        torch.zeros((20, 4), dtype=torch.int32),
        torch.zeros(20, dtype=torch.bool), 28, 1 << 16)
    assert not t8.any() and not lev8.any()
    assert torch.equal(rec, orig) and torch.equal(lev, z)


def test_t8_eligibility():
    """With a 4x4 recon far off (so 8x8 always pays), only inter,
    non-skip winners whose units are all 8x8 switch: P16x16, P16x8,
    P8x16, P16PMV and P8x8 without sub-8x8 units, not skip, intra or a
    P8x8 with a split unit."""
    rng = np.random.RandomState(3)
    n = 9
    orig = _t(rng.randint(0, 256, (n, 16, 16)))
    pred = (orig + _t(rng.randint(-4, 5, (n, 16, 16)))).clamp(0, 255)
    win = _t([TRP.C_P16x16, TRP.C_P16x8, TRP.C_P8x16, TRP.C_P8x8,
              TRP.C_P8x8, TRP.C_SKIP, TRP.C_P16PMV, TRP.C_I16, TRP.C_P8x8])
    sub = torch.zeros((n, 4), dtype=torch.int32)
    sub[4, 2] = 3
    sub[8, 0] = 1
    t8, *_ = TRP.t8_decide_plain(
        orig, pred, torch.zeros_like(orig),
        torch.zeros((n, 4, 4, 4, 4), dtype=torch.int32), win, sub,
        win == TRP.C_I16, 28, 1 << 16)
    assert t8.tolist() == [1, 1, 1, 1, 0, 0, 1, 0, 0]
