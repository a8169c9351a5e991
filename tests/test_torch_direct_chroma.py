"""The premises of the CUDA designs of K7 ``b_direct`` and K5
``inter_chroma_tq``, on the CPU, exactly.

K7 derives each 8x8 unit's motion once, on one lane a unit: the colocated
corner read, the clamped index, DistScaleFactor and the anchor flag, the
scaled mvs, and each list's window origin and the two bank planes its
fraction picks, as one offset per tap (the fraction table packed into two
64-bit words, a nibble a fraction).  Lane 8 b8 + x then reads column x
of unit b8 from those four offsets.  Written that way in PyTorch it must
equal ``b_direct_plain`` and the reference's ``direct_b8`` /
``direct_mb`` with ``_dynfrac_mc``.  The wrapper's one combined input
test must accept exactly what its per-tensor checks accept.

K5's chroma coding runs in the lane form of ``inter_luma_tq``
(test_torch_search_tq.py): two lanes a 4x4 block, 16 lanes an MB; the
2x2 DC Hadamard, its quant, inverse and truncating dequant by xor
shuffles among a plane's four blocks; RDOQ-lite on the AC with the DC
slot zero, skipped by a warp whose levels are all zero; the AC cost from
zig-zag position 1 from bit masks; JM's plane drop by shuffled sums.  Written lane by lane in PyTorch it must equal
``inter_chroma_tq_plain`` and the reference's ``_chroma_tq(intra=False,
lam)``."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_b as TB
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.kernels import b_direct as K7
from h264_tpu_torch.ops import quant as Q
from h264_tpu_torch.tools.search_tq_cases import (LUMA_CONTENTS,
                                                  chroma_ac_costs,
                                                  chroma_case, direct_case,
                                                  direct_kinds)
from test_torch_search_tq import (HALF, LANE, ZZ_OF, _cls, _coeff_cost_mask,
                                  _fwd_cols, _fwd_row, _inv_cols, _inv_row,
                                  _lam, _xor)

I32 = torch.int32
CSRC = pathlib.Path(TB.__file__).resolve().parent.parent / "csrc"


def _taps():
    """kTapA and kTapB as csrc/b_direct.cu writes them."""
    src = (CSRC / "b_direct.cu").read_text()
    return tuple(int(re.search(rf"{n} = 0x([0-9A-Fa-f]+)ULL", src).group(1),
                     16) for n in ("kTapA", "kTapB"))


# ---------------------------------------------------------------------------
# K7: the derivation once per unit, then a row a lane
# ---------------------------------------------------------------------------

def test_packed_fraction_table_is_qtab():
    """Nibble f of kTapA / kTapB is (plane, row offset, column offset) of
    the first / second tap of fraction f in the reference's ``_QTAB``."""
    for tap, cols in zip(_taps(), ((0, 1, 2), (3, 4, 5))):
        for f in range(16):
            t = (tap >> (4 * f)) & 15
            want = tuple(int(JRD._QTAB[f, k]) for k in cols)
            assert (t & 3, (t >> 2) & 1, t >> 3) == want, f
    np.testing.assert_array_equal(TRD._QTAB, JRD._QTAB)


def _direct_units(b0, b1, ci, cr, cmx, cmy, dsf_tab, eq_tab):
    """b_direct as the kernel computes it: the (n_mb, 4) units' motion and
    four tap offsets, then the samples of each unit from them."""
    NR0, _, Hp, Wp = b0.shape
    n_my, n_mx = (Hp - 64) // 16, (Wp - 64) // 16
    n_mb = n_my * n_mx
    tap_a, tap_b = _taps()
    mb, u = torch.arange(n_mb)[:, None], torch.arange(4)[None]
    mby, mbx, by, bx = mb // n_mx, mb % n_mx, u >> 1, u & 1
    c = (4 * mby + 3 * by) * (4 * n_mx) + 4 * mbx + 3 * bx  # flat, once
    intra = ci.reshape(-1)[c]
    mcx = torch.where(intra, 0, cmx.reshape(-1)[c])
    mcy = torch.where(intra, 0, cmy.reshape(-1)[c])
    idx = torch.where(intra, 0, cr.reshape(-1)[c])
    ic = TB._slice_start(idx, NR0, 1)
    dsf = dsf_tab[ic.long()]
    eq = eq_tab[ic.long()] | intra
    l0x = torch.where(eq, mcx, (dsf * mcx + 128) >> 8)
    l0y = torch.where(eq, mcy, (dsf * mcy + 128) >> 8)
    l1x = torch.where(eq, 0, l0x - mcx)
    l1y = torch.where(eq, 0, l0y - mcy)
    uy, ux = 16 * mby + 8 * by + TRD.PAD, 16 * mbx + 8 * bx + TRD.PAD

    def offset(tap, mx, my):
        iy = TB._slice_start(uy + (my >> 2), Hp, 10)
        ix = TB._slice_start(ux + (mx >> 2), Wp, 10)
        nib = torch.tensor([(tap >> (4 * f)) & 15 for f in range(16)])
        t = nib[((my & 3) * 4 + (mx & 3)).long()]
        return ((t & 3) * Hp + iy + ((t >> 2) & 1)) * Wp + ix + (t >> 3)

    bank0 = ic * 4 * Hp * Wp
    o0a, o0b = bank0 + offset(tap_a, l0x, l0y), bank0 + offset(tap_b, l0x, l0y)
    o1a, o1b = offset(tap_a, l1x, l1y), offset(tap_b, l1x, l1y)
    # lane 8 b8 + x of MB mb: column x of unit b8, eight rows
    row = (torch.arange(8)[:, None] * Wp + torch.arange(8))[None, None]
    f0, f1 = b0.reshape(-1), b1.reshape(-1)

    def mean(flat, oa, ob):
        return (flat[(oa[..., None, None] + row).long()]
                + flat[(ob[..., None, None] + row).long()] + 1) >> 1

    blocks = (mean(f0, o0a, o0b) + mean(f1, o1a, o1b) + 1) >> 1
    pred = blocks.reshape(n_mb, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
    return (pred.reshape(n_mb, 16, 16),
            *(a.to(I32) for a in (idx, l0x, l0y, l1x, l1y)))


def _jax_direct(b0, b1, ci, cr, cmx, cmy, dsf_tab, eq_tab):
    """The reference's direct_b8 / direct_mb (rd.py:2218-2263)."""
    H, W = ci.shape[0] * 4, ci.shape[1] * 4
    n_mx = W // 16
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

    out = jax.jit(jax.vmap(direct_mb))(jnp.arange((H // 16) * n_mx))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("W,H,NR", [(176, 144, 3), (176, 144, 1),
                                    (96, 64, 3), (64, 48, 2)],
                         ids=lambda v: str(v))
def test_direct_units_match_plain_and_reference(W, H, NR):
    args = direct_case(W, H, NR, seed=W + NR)
    kinds = direct_kinds(args)
    need = [k for k in kinds if k != "anchor" or NR > 1]
    assert all(kinds[k] > 0 for k in need), kinds
    want = TB.b_direct_plain(*args)
    got = _direct_units(*args)
    ref = _jax_direct(*(jnp.asarray(a.numpy()) for a in args))
    for g, w, r, name in zip(got, want, ref,
                             ("pred", "idx", "l0x", "l0y", "l1x", "l1y")):
        assert g.dtype == w.dtype == I32
        assert torch.equal(g, w), name
        np.testing.assert_array_equal(w.numpy(), r, err_msg=name)


def test_direct_combined_check_matches_per_tensor_checks():
    """The wrapper's one combined test accepts the built inputs and
    rejects each bad one, and its per-tensor walk names that one with a
    ValueError, as the checks it replaced did."""
    args = direct_case(64, 48, 3, seed=1)
    assert K7._accepts(args)
    meta = torch.empty(args[6].shape, dtype=I32, device="meta")
    bad = {0: args[0].float(), 1: args[1][:, :3].clone(),
           2: args[2].to(I32), 3: args[3][:, :-1].clone(),
           4: args[4].t().contiguous().t(), 5: args[5][:, ::2],
           6: meta, 7: args[7].to(I32), 8: "not a tensor"}
    for k, x in bad.items():
        ins = list(args)
        if k == 8:
            ins[3] = x
        else:
            ins[k] = x
        assert not K7._accepts(ins), k
        with pytest.raises(ValueError):
            K7._reject(ins)
    with pytest.raises(ValueError):  # not whole MBs
        K7._reject([args[0][:, :, :-8].clone(), *args[1:]])


# ---------------------------------------------------------------------------
# K5: inter_chroma_tq lane by lane
# ---------------------------------------------------------------------------

CB = ((LANE >> 1) & 3)[None, :]


def _hadamard_blocks(v):
    """The kernel's hadamard_blocks: a 2x2 Hadamard over lane bits 1, 2."""
    p = _xor(v, 2)
    v = torch.where((CB & 1).bool(), p - v, v + p)
    p = _xor(v, 4)
    return torch.where((CB & 2).bool(), p - v, v + p)


def _chroma_lanes(pred, orig, qp_c, lam):
    """inter_chroma_tq as the kernel computes it: two MBs a warp, the half
    warp past an odd count coding the last MB again."""
    n = pred.shape[0]
    pad = torch.arange(n + n % 2).clamp(max=n - 1)
    nw = (n + 1) // 2
    per, rem = divmod(qp_c, 6)
    off, qbits = 342 << (4 + per), 15 + per
    mf = [int(Q._M4[rem][c]) for c in range(3)]
    vs = [int(Q._V4[rem][c]) * 16 for c in range(3)]

    def lanes(x):  # (n, 2, 8, 8) -> (nw, 32, 2, 4), lane 8 pl + 2 cb + h
        x = x[pad].reshape(-1, 2, 2, 2, 2, 2, 4)  # mb pl cby h j cbx x
        return x.permute(0, 1, 2, 5, 3, 4, 6).reshape(nw, 32, 2, 4)

    def per_pos(f, dtype=I32):
        return torch.tensor([[f(j, x) for x in range(4)] for j in range(2)],
                            dtype=dtype)

    MF = per_pos(lambda j, x: mf[_cls(j, x)])
    VS = per_pos(lambda j, x: vs[_cls(j, x)])
    dc_slot = (HALF[..., None] == 0) & (torch.arange(2)[:, None] == 0) & (
        torch.arange(4) == 0)  # (1, 32, 2, 4): h 0, j 0, x 0
    zz = torch.where(HALF[..., None].bool(),
                     torch.tensor([ZZ_OF[8:12], ZZ_OF[12:16]]),
                     torch.tensor([ZZ_OF[0:4], ZZ_OF[4:8]]))

    def deq(lv):
        return ((lv * VS) << per) + 8 >> 4

    P, O = lanes(pred), lanes(orig)
    res = O - P
    c = _fwd_cols(_fwd_row(res))
    hd = _hadamard_blocks(c[..., 0, 0])
    dl = torch.sign(hd) * ((hd.abs() * mf[0] + 2 * off) >> (16 + per))
    dg = _hadamard_blocks(dl) * vs[0]
    dc_deq = dg >> (5 - per) if per < 5 else dg << (per - 5)
    lev = torch.where(dc_slot, 0, torch.sign(c) * ((c.abs() * MF + off)
                                                   >> qbits))
    # RDOQ runs in the warps that hold a nonzero level
    warp_nz = (lev != 0).any(-1).any(-1).any(-1)[:, None, None, None]
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
    lev = torch.where(warp_nz & (a > 0) & (dJ < 0), lm, lev)
    nzm = ((lev != 0).long() << zz).sum((-1, -2))
    bigm = ((lev.abs() > 1).long() << zz).sum((-1, -2))
    nzm, bigm = nzm | _xor(nzm, 1), bigm | _xor(bigm, 1)
    tot = _coeff_cost_mask(nzm, bigm, first=1)
    tot = tot + _xor(tot, 2)
    tot = tot + _xor(tot, 4)
    lev = torch.where((tot < 4)[..., None, None], 0, lev)
    rr = _inv_cols(_inv_row(torch.where(dc_slot, dc_deq[..., None, None],
                                        deq(lev))))
    rec = ((rr + (P << 6) + 32) >> 6).clamp(0, 255)

    def planes(x):  # (nw, 32, 2, 4) -> (n, pl, cby, cbx, h, j, x)
        return x.reshape(-1, 2, 2, 2, 2, 2, 4)[:n]

    levc = planes(lev).reshape(n, 2, 2, 2, 4, 4)
    recc = planes(rec).permute(0, 1, 2, 4, 5, 3, 6).reshape(n, 2, 8, 8)
    dcc = dl.reshape(-1, 2, 2, 2, 2)[:n, ..., 0].reshape(n, 2, 2, 2)
    return levc.to(I32), dcc.to(I32), recc.to(I32)


@pytest.mark.parametrize("qp_c", [0, 29, 39])
@pytest.mark.parametrize("content", LUMA_CONTENTS)
def test_chroma_lanes_match_plain_and_reference(content, qp_c):
    pred, orig = chroma_case(content, 41, seed=qp_c + 11, qp_c=qp_c)
    lam = _lam(qp_c)
    if content == "sparse":  # the drop decides both ways
        cost = chroma_ac_costs(pred, orig, qp_c, lam)
        assert int((cost < 4).sum()) > 0 and int((cost >= 4).sum()) > 0
    if content == "extreme":
        assert int((orig - pred).abs().max()) == 255
    want = TP.inter_chroma_tq_plain(pred, orig, qp_c, lam)
    got = _chroma_lanes(pred, orig, qp_c, lam)
    ref = jax.jit(lambda p, o: JRD._chroma_tq(p, o, qp_c, intra=False,
                                              lam=jnp.int32(lam)))(
        jnp.asarray(pred.numpy()), jnp.asarray(orig.numpy()))
    for g, w, r, name in zip(got, want, ref, ("levc", "dcc", "recc")):
        assert torch.equal(g, w), name
        np.testing.assert_array_equal(w.numpy(), np.asarray(r), err_msg=name)


def test_hadamard_blocks_is_the_2x2_hadamard():
    """Lane cb of each plane's four DC lanes gets entry cb (= 2 ky + kx)
    of the 2x2 Hadamard of the four blocks' values [by][bx]."""
    from h264_tpu_torch.ops import transforms as TR

    rng = np.random.RandomState(4)
    v = torch.from_numpy(rng.randint(-5000, 5000, (3, 32)).astype(np.int32))
    got = _hadamard_blocks(v).reshape(3, 2, 2, 4, 2)[..., 0]  # m pl cb h
    want = TR.hadamard2x2(v.reshape(3, 2, 2, 2, 2, 2)[..., 0]).reshape(
        3, 2, 2, 4)
    assert torch.equal(got, want)
