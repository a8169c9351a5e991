"""The premises of the CUDA designs of K3 ``coarse_search`` and K5
``inter_luma_tq``, on the CPU, exactly.

K3 decimates every reference's weighted widened G plane once per call
into u16 cells, then searches each MB's 28 x 28 window of that plane: one
block per strip of 4 MBs along a row (the strip's window staged with
zeros past the plane's right edge), a lane per grid column taking its
first minimum down the rows, then a (cost, index) butterfly across the
warp.  Written that way in PyTorch it must equal ``coarse_search_plain``.

K5 codes a (candidate, MB) problem on a warp, two lanes a 4x4 block, each
holding two rows: row passes in the lane, column passes from two partial
sums a column exchanged with the partner lane, constants by row parity,
JM's coeff_cost from zig-zag bit masks, and the 8x8 and MB thresholds,
SSD and bits by xor-butterfly sums.  Written lane by lane in PyTorch it
must equal ``inter_luma_tq_plain``, which equals the reference's
``tq_recon``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu.ops import quant as JQ
from h264_tpu.ops import transforms as JTR
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.ops import quant as Q
from h264_tpu_torch.ops import transforms as TR
from h264_tpu_torch.tools.search_tq_cases import (CORNER_CENTRES,
                                                  LUMA_CONTENTS, coarse_case,
                                                  corner_mbs, drop_kinds,
                                                  luma_case)

I32 = torch.int32
RC, DCO, STRIP, WIN_COLS = 12, 25, 4, 44
BIG = 2 ** 31 - 1


def _lam_me(qp):
    """The P pipeline's lambda_me << 16 (twice lambda_mode)."""
    return 2 * int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


def _lam(qp):
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


# ---------------------------------------------------------------------------
# K3: decimate once, then search the small plane
# ---------------------------------------------------------------------------

def _decimate(banks, wp):
    """Phase A: (NR, (Hp+128)/4, (Wp+128)/4) cells, each the sum of the
    16 weighted bank samples (4Y + a - 64, 4X + b - 64), clamped."""
    NR, _, Hp, Wp = banks.shape
    Hl, Wl = (Hp + 128) // 4, (Wp + 128) // 4
    a4 = torch.arange(4)
    rows = (4 * torch.arange(Hl)[:, None] + a4 - 64).clamp(0, Hp - 1)
    cols = (4 * torch.arange(Wl)[:, None] + a4 - 64).clamp(0, Wp - 1)
    g = banks[:, 0][:, rows[:, :, None, None], cols[None, None, :, :]]
    if wp is not None:
        g = TRD._wp_affine(g, wp[0][:, None, None, None, None],
                           wp[1][:, None, None, None, None])
    return g.sum((2, 4), dtype=I32)


def _strip_search(plane, cur_y, lam_me):
    """Phase B lane by lane: (cen_x, cen_y), each (NR, n_my, n_mx)."""
    NR, Hl, Wl = plane.shape
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    cb = cur_y.reshape(H // 4, 4, W // 4, 4).sum((1, 3), dtype=I32)
    lane = torch.arange(32)
    kx = lane.clamp(max=DCO - 1)
    off = torch.arange(-RC, RC + 1, dtype=I32) * 16
    rate = TRD._lam_cost(lam_me, TRD._mv_bits(off)[:, None]
                         + TRD._mv_bits(off[kx])[None, :])  # (ky, lane)
    cen = torch.zeros((2, NR, n_my, n_mx), dtype=I32)
    for my in range(n_my):
        for mx0 in range(0, n_mx, STRIP):
            c0 = 4 * mx0 + 12
            win = torch.zeros((NR, DCO + 3, WIN_COLS), dtype=I32)
            n = min(WIN_COLS, Wl - c0)
            win[:, :, :n] = plane[:, 4 * my + 12:4 * my + 40, c0:c0 + n]
            for m in range(min(STRIP, n_mx - mx0)):
                mx = mx0 + m
                base = 4 * m + kx
                sad = torch.zeros((NR, DCO, 32), dtype=I32)
                for a in range(4):
                    for b in range(4):
                        w = win[:, a:a + DCO, base + b]
                        sad += (w - cb[4 * my + a, 4 * mx + b]).abs()
                cost = sad + rate
                # each lane's first minimum down its column (strict <)
                best = torch.full((NR, 32), BIG, dtype=torch.int64)
                bidx = torch.zeros((NR, 32), dtype=torch.int64)
                for ky in range(DCO):
                    c = cost[:, ky].long()
                    lt = c < best
                    best = torch.where(lt, c, best)
                    bidx = torch.where(lt, ky * DCO + kx, bidx)
                best[:, DCO:] = BIG
                for s in (16, 8, 4, 2, 1):  # the (cost, index) butterfly
                    oc, oi = best[:, lane ^ s], bidx[:, lane ^ s]
                    take = (oc < best) | ((oc == best) & (oi < bidx))
                    best = torch.where(take, oc, best)
                    bidx = torch.where(take, oi, bidx)
                k = bidx[:, 0]
                cen[0, :, my, mx] = ((k % DCO - RC) * 4).to(I32)
                cen[1, :, my, mx] = ((k // DCO - RC) * 4).to(I32)
    return cen[0], cen[1]


@pytest.mark.parametrize("content", ("random", "corners", "flat"))
@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("NR", [1, 3])
@pytest.mark.parametrize("W,H", [(64, 48), (176, 144)], ids=lambda v: str(v))
def test_decimate_then_search_matches_plain(W, H, NR, wp, content):
    banks, cur, wpt = coarse_case(content, W, H, NR, wp, seed=W + NR + wp)
    plane = _decimate(banks, wpt)
    for lam_me in (0, _lam_me(0), _lam_me(51)):
        want = TP.coarse_search_plain(banks, cur, wpt, lam_me)
        got = _strip_search(plane, cur, lam_me)
        for g, w, name in zip(got, want, ("cen_x", "cen_y")):
            assert torch.equal(g, w), (name, lam_me)
        if content == "corners" and lam_me == _lam_me(0):
            # the corner MBs' windows reach the clamped corners of the
            # widened bank, and the extreme cell wins there
            for (my, mx), c in zip(corner_mbs(W, H), CORNER_CENTRES):
                assert (int(want[0][0, my, mx]), int(want[1][0, my, mx])) == c
        if content == "flat" and lam_me == 0:
            # every cell ties: the first one, (-48, -48)
            assert int(want[0].max()) == int(want[0].min()) == -48
            assert int(want[1].max()) == int(want[1].min()) == -48


@pytest.mark.parametrize("wp", [(127, 127), (-128, 127), (127, -128),
                                (-128, -128), (32, 0)], ids=str)
def test_decimated_cells_fit_u16(wp):
    """The kernel stores the cells as u16: under any weight and offset,
    on a 0/255 checkerboard and on flat 255, every cell is 0..4080."""
    for content in ("checker", "flat"):
        banks, _, _ = coarse_case(content, 64, 48, 2, False, seed=5)
        if content == "flat":
            banks = torch.full_like(banks, 255)
        plane = _decimate(banks, (torch.tensor([wp[0], 32], dtype=I32),
                                  torch.tensor([wp[1], 0], dtype=I32)))
        assert 0 <= int(plane.min()) and int(plane.max()) <= 16 * 255
    assert int(plane[1].min()) == int(plane[1].max()) == 16 * 255


# ---------------------------------------------------------------------------
# K5: inter_luma_tq lane by lane
# ---------------------------------------------------------------------------

LANE = torch.arange(32)
HALF = (LANE & 1)[None, :, None]  # h of each lane, broadcast over x
# zig-zag index of raster position 4 y + x (the kernel's kZzOf)
ZZ_OF = [0, 1, 5, 6, 2, 4, 7, 12, 3, 8, 11, 13, 9, 10, 14, 15]


def _xor(v, k):
    """__shfl_xor_sync(v, k) over the lane axis (1)."""
    return v[:, LANE ^ k]


def _cls(j, x):
    return 0 if (j | x) & 1 == 0 else 1 if (j & x) & 1 else 2


def _fwd_row(v):
    t0, t1 = v[..., 0] + v[..., 3], v[..., 1] + v[..., 2]
    t2, t3 = v[..., 1] - v[..., 2], v[..., 0] - v[..., 3]
    return torch.stack([t0 + t1, t3 * 2 + t2, t0 - t1, t3 - t2 * 2], -1)


def _inv_row(v):
    e0, e1 = v[..., 0] + v[..., 2], v[..., 0] - v[..., 2]
    e2, e3 = (v[..., 1] >> 1) - v[..., 3], v[..., 1] + (v[..., 3] >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)


def _fwd_cols(v):
    a, b = v[:, :, 0], v[:, :, 1]
    h = HALF.bool()
    k0 = torch.where(h, b - a, a + b)
    k1 = torch.where(h, a * 2 - b, a * 2 + b)
    s0 = torch.where(h, a + b, a - b)
    s1 = torch.where(h, -a - b * 2, a - b * 2)
    return torch.stack([k0 + _xor(s0, 1), k1 + _xor(s1, 1)], 2)


def _inv_cols(v):
    a, b = v[:, :, 0], v[:, :, 1]
    hb = b >> 1
    h = HALF.bool()
    k0 = torch.where(h, b - a, a + b)
    k1 = torch.where(h, a - hb, a + hb)
    s0 = torch.where(h, a + hb, a - hb)
    s1 = torch.where(h, -a - b, a - b)
    return torch.stack([k0 + _xor(s0, 1), k1 + _xor(s1, 1)], 2)


def _coeff_cost_mask(M, B, first=0):
    """JM coeff_cost from the zig-zag nonzero mask M and |level| > 1 mask
    B, scanned from position `first` (the kernel's coeff_cost_mask at
    first 0): a nonzero after r zeros costs [r < 1] + [r < 3] + [r < 6],
    9 when |level| > 1."""
    keep = 0xFFFF & ~((1 << first) - 1)
    M, B = M & keep, B & keep
    E = (M << 1) | (1 << first)
    S = (M & ~B) << 1
    n1 = E << 1
    n3 = n1 | (n1 << 1) | (n1 << 2)
    n6 = n3 | (n3 << 3)

    def popc(x):
        return ((x[..., None] >> torch.arange(32)) & 1).sum(-1)

    return 9 * popc(B) + popc(S & n1) + popc(S & n3) + popc(S & n6)


def _luma_lanes(pred, orig, qp, lam):
    """inter_luma_tq as the kernel computes it, (NC, n_mb, ...) outputs."""
    NC, n_mb = pred.shape[:2]
    n = NC * n_mb
    per, rem = divmod(qp, 6)
    off, qbits = 342 << (4 + per), 15 + per
    mf = [int(Q._M4[rem][c]) for c in range(3)]
    vs = [int(Q._V4[rem][c]) * 16 for c in range(3)]

    def lanes(x):  # (n, 16, 16) -> (n, 32, 2, 4), lane 2 blk + h
        return x.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 32, 2, 4)

    def per_pos(f, dtype=I32):  # f(j, x) -> a (2, 4) table
        return torch.tensor([[f(j, x) for x in range(4)] for j in range(2)],
                            dtype=dtype)

    MF, VS = per_pos(lambda j, x: mf[_cls(j, x)]), per_pos(
        lambda j, x: vs[_cls(j, x)])
    zz = torch.where(HALF[..., None].bool(),
                     torch.tensor([ZZ_OF[8:12], ZZ_OF[12:16]]),
                     torch.tensor([ZZ_OF[0:4], ZZ_OF[4:8]]))  # (1, 32, 2, 4)

    def deq(lv):
        return ((lv * VS) << per) + 8 >> 4

    P = lanes(pred.reshape(n, 16, 16))
    O = lanes(orig.expand(NC, n_mb, 16, 16).reshape(n, 16, 16))
    res = O - P
    c = _fwd_cols(_fwd_row(res))
    lev = torch.sign(c) * ((c.abs() * MF + off) >> qbits)
    F = _fwd_cols(_fwd_row((res << 6) - _inv_cols(_inv_row(deq(lev)))))
    lm = torch.where(lev > 0, lev - 1, torch.where(lev < 0, lev + 1, 0))
    f32 = torch.float32
    delta = (deq(lm) - deq(lev)).to(f32)
    n2 = per_pos(lambda j, x: (10. if j else 16.) * (10. if x & 1 else 16.),
                 f32)
    ss = per_pos(lambda j, x: (1. if j else 2.) * (1. if x & 1 else 2.), f32)
    dD = delta * delta * n2 - 8.0 * delta * F.to(f32) * ss

    def bits(a):
        return torch.where(a > 0, 2 * TRD._bitlen(a.clamp(min=1)) + 2, 0)

    a = lev.abs()
    dJ = dD + torch.tensor(lam, dtype=I32).to(f32) * (bits(lm.abs())
                                                       - bits(a)).to(f32)
    lev = torch.where((a > 0) & (dJ < 0), lm, lev)
    nzm = ((lev != 0).long() << zz).sum((-1, -2))
    bigm = ((lev.abs() > 1).long() << zz).sum((-1, -2))
    nzm, bigm = nzm | _xor(nzm, 1), bigm | _xor(bigm, 1)
    cost = _coeff_cost_mask(nzm, bigm)
    c8 = cost + _xor(cost, 2)
    c8 = c8 + _xor(c8, 8)
    tot = torch.where(c8 <= 4, 0, c8)
    tot = tot + _xor(tot, 4)
    tot = tot + _xor(tot, 16)
    drop = ((c8 <= 4) | (tot <= 5))[..., None, None]
    lev = torch.where(drop, 0, lev)
    rr = _inv_cols(_inv_row(deq(lev)))
    rec = torch.where(drop, P.clamp(0, 255),
                      ((rr + (P << 6) + 32) >> 6).clamp(0, 255))
    ssd = ((P + res - rec) ** 2).sum((-1, -2))
    al = lev.abs()
    lb = torch.where(al > 0, 2 * TRD._bitlen(al.clamp(min=1)) + 1, 0).sum(
        (-1, -2))
    nn = (al > 0).sum((-1, -2))
    lb, nn = lb + _xor(lb, 1), nn + _xor(nn, 1)
    cb = torch.where(nn > 0, lb + nn + 2, 0)
    ssd = ssd + _xor(ssd, 1)
    for k in (2, 8):
        ssd, cb = ssd + _xor(ssd, k), cb + _xor(cb, k)
    heads = [l for l in range(32) if l & 0b01011 == 0]  # b8 0, 1, 2, 3
    assert [2 * (l >> 4) + ((l >> 2) & 1) for l in heads] == [0, 1, 2, 3]

    def pic(x):  # (n, 32, 2, 4) -> (NC, n_mb, 16, 16)
        return x.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(
            NC, n_mb, 16, 16)

    return (lev.reshape(NC, n_mb, 4, 4, 4, 4), pic(rec),
            ssd[:, heads].reshape(NC, n_mb, 4).to(I32),
            cb[:, heads].reshape(NC, n_mb, 4).to(I32))


@pytest.mark.parametrize("first", [0, 1])
def test_coeff_cost_mask_exhaustive(first):
    """Every 16-bit nonzero pattern, with levels of +-1 and of +-1 / +-2
    alternating, against the port's ``_block4_coeff_cost``."""
    pat = torch.arange(1 << 16)
    bit = (pat[:, None] >> torch.arange(16)) & 1  # zig-zag position z
    raster = torch.tensor([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                           14, 15])
    sign = torch.where(torch.arange(16) % 3 == 0, -1, 1)
    for mag in (torch.ones(16, dtype=torch.long),
                1 + (torch.arange(16) % 2), 1 + (torch.arange(16) // 8)):
        zlev = bit * mag * sign
        lev = torch.zeros((1 << 16, 16), dtype=torch.long)
        lev[:, raster] = zlev
        want = TRD._block4_coeff_cost(lev.reshape(-1, 4, 4).to(I32), first)
        M = (bit << torch.arange(16)).sum(-1)
        B = ((zlev.abs() > 1).long() << torch.arange(16)).sum(-1)
        got = _coeff_cost_mask(M, B, first)
        assert torch.equal(got.to(I32), want)


@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("content", LUMA_CONTENTS)
def test_luma_lanes_match_plain(content, qp):
    pred, orig = luma_case(content, 6, 40, seed=qp + 7)
    lam = _lam(qp)
    want = TP.inter_luma_tq_plain(pred, orig, qp, lam)
    got = _luma_lanes(pred, orig, qp, lam)
    for g, w, name in zip(got, want, ("lev", "rec", "D8", "cb8")):
        assert torch.equal(g, w), name


def test_sparse_case_takes_every_threshold_branch():
    pred, orig = luma_case("sparse", 8, 60, seed=3)
    kinds = drop_kinds(pred, orig, 28, _lam(28))
    assert all(v > 0 for v in kinds.values()), kinds


def test_column_passes_wrap_as_the_plain_transforms():
    """The split column passes equal forward4x4 / inverse4x4 on blocks
    whose sums wrap int32."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, (64, 16, 16),
                                     dtype=np.int64).astype(np.int32))
    blk = x.reshape(64, 4, 4, 4, 4).transpose(2, 3)
    lanes = blk.reshape(64, 32, 2, 4)
    for mine, plain in ((lambda v: _fwd_cols(_fwd_row(v)), TR.forward4x4),
                        (lambda v: _inv_cols(_inv_row(v)), TR.inverse4x4)):
        assert torch.equal(mine(lanes).reshape(blk.shape), plain(blk))


@pytest.mark.parametrize("qp", [0, 51])
def test_luma_plain_matches_reference_at_extreme_residuals(qp):
    """``inter_luma_tq_plain`` against the reference's ``tq_recon``
    (rd.py:879-893) on residuals of +-255."""
    pred, orig = luma_case("extreme", 3, 12, seed=qp)
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

    want = jax.jit(tq_recon)(jnp.asarray(pred.numpy()),
                             jnp.asarray(orig.numpy())[None], jnp.int32(qp),
                             jnp.int32(lam))
    lev, rec, d8, cb8 = TP.inter_luma_tq_plain(pred, orig, qp, lam)
    assert int((orig[None] - pred).abs().max()) == 255
    np.testing.assert_array_equal(lev.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(d8.sum(-1, dtype=I32).numpy(),
                                  np.asarray(want[2]))
    np.testing.assert_array_equal(cb8.sum(-1, dtype=I32).numpy(),
                                  np.asarray(want[3]))
