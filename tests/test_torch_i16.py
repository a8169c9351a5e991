"""The premises of the CUDA design of K5 ``i16_candidate``, on the CPU,
exactly.

The kernel codes an MB's I16 candidate on one warp, two lanes a 4x4 block
as ``inter_luma_tq`` does (test_torch_search_tq.py): the neighbours read
by the lanes that hold them, the DC value and PLANE parameters from warp
sums, each mode's Hadamard cost as the lane pair's block sums plus the
16 DC terms' Hadamard by xor-shuffle butterflies in natural (Walsh) order,
summed over the warp; then the chosen mode's transform, the DC Hadamard,
its quant and bit count and the Hadamard of its levels on the DC lanes by
the same butterflies, the AC and the recon in the lanes.  Written lane by
lane in PyTorch it must equal ``i16_candidate_plain``, which equals the
reference's I16 candidate (rd.py:984-997: its neighbours, ``_i16_pred_all``
and ``_i16_tq``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.ops import quant as Q
from h264_tpu_torch.tools.search_tq_cases import I16_CONTENTS, i16_case
from h264_tpu_torch.tools.synthseq import synthetic_frames
from test_torch_search_tq import (HALF, LANE, _cls, _fwd_cols, _fwd_row,
                                  _inv_cols, _inv_row, _xor)

I32 = torch.int32
BIG = 1 << 29  # an unavailable mode's cost (common.cuh kBig)
QPS = [0, 28, 51]


def _source(content, W=176, H=144):
    """A seeded QCIF picture, or a built one of tools/search_tq_cases.py."""
    if content == "seeded":
        return torch.as_tensor(synthetic_frames(1, W, H, seed=5)[0][0],
                               dtype=I32)
    return i16_case(content, W, H, seed=W + H)


def _ref_i16(cur_y, qp):
    """The reference's I16 candidate of every MB, as rd.py:984-997 forms
    it (original neighbours, zero outside the picture): (rec, D, cb,
    mode)."""
    y = jnp.asarray(cur_y.numpy())
    H, W = y.shape
    n_my, n_mx = H // 16, W // 16
    n = n_my * n_mx
    up = jnp.pad(y, ((1, 0), (0, 0)))[:-1][::16][:n_my].reshape(n, 16)
    left = (jnp.pad(y, ((0, 0), (1, 0)))[:, :-1][:, ::16][:, :n_mx]
            .reshape(n_my, 16, n_mx).transpose(0, 2, 1).reshape(n, 16))
    ul = jnp.pad(y, ((1, 0), (1, 0)))[:-1, :-1][::16, ::16].reshape(n)
    row, col = jnp.meshgrid(jnp.arange(n_my), jnp.arange(n_mx),
                            indexing="ij")
    orig = y.reshape(n_my, 16, n_mx, 16).transpose(0, 2, 1, 3).reshape(
        n, 16, 16)
    pred, mode, _ = JRD._i16_pred_all(up, left, ul, (row > 0).reshape(-1),
                                      (col > 0).reshape(-1), orig)
    _, _, rec, D, cb = JRD._i16_tq(pred, orig, qp)
    return tuple(torch.as_tensor(np.array(a)) for a in (rec, D, cb, mode))


# ---------------------------------------------------------------------------
# the kernel's lanes
# ---------------------------------------------------------------------------

BR, BC, H_ = LANE >> 3, (LANE >> 1) & 3, LANE & 1
Y0, X0 = 4 * BR + 2 * H_, 4 * BC  # the lane's first row, first column
JJ, XX = torch.arange(2)[:, None], torch.arange(4)[None, :]


def _had_row(v):
    e0, e1 = v[..., 0] + v[..., 2], v[..., 0] - v[..., 2]
    e2, e3 = v[..., 1] - v[..., 3], v[..., 1] + v[..., 3]
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)


def _had_cols(v):
    """The kernel's had_cols: one exchange a column, h = 0 keeping (w0 +
    w1) +- (w2 + w3), h = 1 (w0 - w1) -+ (w2 - w3)."""
    s, t = v[:, :, 0] + v[:, :, 1], v[:, :, 0] - v[:, :, 1]
    h = HALF.bool()
    p = _xor(torch.where(h, s, t), 1)
    return torch.stack([torch.where(h, p - t, s + p),
                        torch.where(h, p + t, s - p)], 2)


def _hadamard_dc(v):
    """The kernel's hadamard_dc: natural-order butterflies over lane bits
    1-4, v (n, 32)."""
    for b in (2, 4, 8, 16):
        p = _xor(v, b)
        v = torch.where((LANE & b).bool(), p - v, v + p)
    return v


def _warp_sum(v):
    return v.sum(1, keepdim=True)


def _quant(c, mf, off, qbits):
    return torch.sign(c) * ((c.abs() * mf + off) >> qbits)


def _i16_lanes(cur_y, qp):
    """i16_candidate as the kernel computes it: (rec (n, 16, 16), D (n,),
    cb (n,), mode (n,), cost (n, 4), the largest |DC Hadamard| of the
    mode pick)."""
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    n = n_my * n_mx
    r = torch.arange(n)[:, None] // n_mx
    c = torch.arange(n)[:, None] % n_mx
    au, al = r > 0, c > 0  # (n, 1)
    O = TP._mb_tiles(cur_y, 16).reshape(n, 4, 4, 4, 4).transpose(2, 3)
    O = O.reshape(n, 32, 2, 4)  # lane 2 blk + h: rows 2h, 2h + 1 of blk
    pad = torch.nn.functional.pad(cur_y, (1, 0, 1, 0))  # zero outside
    up = pad[(16 * r)[..., None], (16 * c + 1 + X0[None, :])[..., None]
             + XX[0]] * au[..., None]  # (n, 32, 4)
    lf = pad[(16 * r + 1 + Y0[None, :])[..., None] + JJ[:, 0],
             (16 * c)[..., None]] * al[..., None]  # (n, 32, 2)
    ul = pad[16 * r, 16 * c] * (au & al)  # (n, 1), lane 0's
    hold_up = ((LANE & 0b11001) == 0)[None, :]
    hold_left = ((LANE & 0b00110) == 0)[None, :]
    su = _warp_sum(up.sum(-1) * hold_up)
    hg = _warp_sum(((X0[:, None] + XX[0] - 7) * up).sum(-1) * hold_up) - 8 * ul
    sl = _warp_sum(lf.sum(-1) * hold_left)
    vg = _warp_sum(((Y0[:, None] + JJ[:, 0] - 7) * lf).sum(-1) * hold_left
                   ) - 8 * ul
    pa = 16 * (up[:, 6:7, 3] + lf[:, 25:26, 1])
    pb, pc = (5 * hg + 32) >> 6, (5 * vg + 32) >> 6
    dc = torch.where(au & al, (su + sl + 16) >> 5,
                     torch.where(au, (su + 8) >> 4,
                                 torch.where(al, (sl + 8) >> 4, 128)))
    X = (X0[:, None, None] + XX)[None]  # (1, 32, 1, 4)
    Yr = (Y0[:, None, None] + JJ)[None]  # (1, 32, 2, 1)
    preds = torch.stack([
        up[:, :, None, :].expand(n, 32, 2, 4),
        lf[..., None].expand(n, 32, 2, 4),
        dc[..., None, None].expand(n, 32, 2, 4),
        ((pa[..., None, None] + pb[..., None, None] * (X - 7)
          + pc[..., None, None] * (Yr - 7) + 16) >> 5).clamp(0, 255)], 1)
    valid = torch.cat([au, al, torch.ones_like(au), au & al], 1)
    costs, hd_max = [], 0
    for m in range(4):
        d = _had_cols(_had_row(O - preds[:, m]))
        hd = _hadamard_dc(d[:, :, 0, 0])
        hd_max = max(hd_max, int((hd.abs() * valid[:, m:m + 1]).max()))
        s = d.abs().sum((-1, -2)) + torch.where(
            H_.bool(), 0, hd.abs() - d[:, :, 0, 0].abs())
        costs.append(s.sum(1) >> 1)
    cost = torch.where(valid, torch.stack(costs, 1), BIG)
    mode = cost.argmin(1)  # the first minimum
    pr = preds[torch.arange(n), mode]

    per, rem = divmod(qp, 6)
    off, qbits = 682 << (4 + per), 15 + per
    MF = torch.tensor([[int(Q._M4[rem][_cls(j, x)]) for x in range(4)]
                       for j in range(2)])
    VS = torch.tensor([[int(Q._V4[rem][_cls(j, x)]) * 16 for x in range(4)]
                       for j in range(2)])
    co = _fwd_cols(_fwd_row(O - pr))
    dl = _quant(_hadamard_dc(co[:, :, 0, 0]) >> 1, int(Q._M4[rem][0]),
                2 * off, 16 + per)
    dla = torch.where(H_.bool(), 0, dl.abs())
    dbits = _warp_sum(torch.where(
        dla > 0, 2 * TRD._bitlen(dla.clamp(min=1)) + 1 + (1 << 16), 0))
    cbdc = torch.where(dbits > 0, (dbits & 0xFFFF) + (dbits >> 16) + 2, 0)
    dc_deq = ((_hadamard_dc(dl) * (int(Q._V4[rem][0]) * 16)) << per) + 32 >> 6
    is_dc = ((H_ == 0)[:, None, None] & (JJ == 0) & (XX == 0))[None]
    lev = torch.where(is_dc, 0, _quant(co, MF, off, qbits))
    al_ = lev.abs()
    lb = torch.where(al_ > 0, 2 * TRD._bitlen(al_.clamp(min=1)) + 1, 0).sum(
        (-1, -2))
    nn = (al_ > 0).sum((-1, -2))
    lb, nn = lb + _xor(lb, 1), nn + _xor(nn, 1)
    deq = torch.where(is_dc, dc_deq[..., None, None], ((lev * VS) << per) + 8
                      >> 4)
    rr = _inv_cols(_inv_row(deq))
    rec = ((rr + (pr << 6) + 32) >> 6).clamp(0, 255)
    D = ((O - rec) ** 2).sum((1, 2, 3))
    cb = torch.where((H_ == 0) & (nn > 0), lb + nn + 2, 0).sum(1) + cbdc[:, 0]
    rec = rec.reshape(n, 4, 4, 4, 4).transpose(2, 3).reshape(n, 16, 16)
    return rec, D.to(I32), cb.to(I32), mode.to(I32), cost, hd_max


def _plain_mode(cur_y):
    """The port's ``_i16_pred_all`` mode of every MB."""
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    pad = torch.nn.functional.pad(cur_y, (1, 0, 1, 0))
    r, c, a16 = torch.arange(n_my), torch.arange(n_mx), torch.arange(16)
    up = pad[(16 * r)[:, None, None], (16 * c)[None, :, None] + 1 + a16]
    left = pad[(16 * r)[:, None, None] + 1 + a16, (16 * c)[None, :, None]]
    ul = pad[(16 * r)[:, None], (16 * c)[None, :]]
    au = (r > 0)[:, None].expand(n_my, n_mx).reshape(-1)
    al = (c > 0)[None, :].expand(n_my, n_mx).reshape(-1)
    return TRD._i16_pred_all(up.reshape(-1, 16), left.reshape(-1, 16),
                             ul.reshape(-1), au, al,
                             TP._mb_tiles(cur_y, 16))[1]


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("content", ["seeded", "checker", "flat"])
def test_i16_plain_matches_reference(content, qp):
    """``i16_candidate_plain`` against the reference's I16 candidate on a
    seeded QCIF picture, a 0/255 checkerboard and a flat picture."""
    cur = _source(content)
    rec, D, cb = TP.i16_candidate_plain(cur, qp)
    want = _ref_i16(cur, qp)
    for name, g, w in zip(("rec", "D16", "cb16"), (rec, D, cb), want):
        assert torch.equal(g, w.to(g.dtype)), name
    assert torch.equal(_plain_mode(cur), want[3].to(I32))


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("content", ["seeded", *I16_CONTENTS])
def test_i16_lanes_match_plain(content, qp):
    cur = _source(content)
    rec, D, cb, mode, _, _ = _i16_lanes(cur, qp)
    want = TP.i16_candidate_plain(cur, qp)
    for name, g, w in zip(("rec", "D16", "cb16"), (rec, D, cb), want):
        assert torch.equal(g, w), name
    assert torch.equal(mode, _plain_mode(cur))


def test_i16_lanes_one_mb():
    """A picture of one MB: no neighbour, DC 128 the only mode."""
    cur = _source("random", 16, 16)
    rec, D, cb, mode, cost, _ = _i16_lanes(cur, 28)
    for g, w in zip((rec, D, cb), TP.i16_candidate_plain(cur, 28)):
        assert torch.equal(g, w)
    assert mode.tolist() == [2] and cost[0, [0, 1, 3]].tolist() == [BIG] * 3


def test_i16_flat_takes_the_first_available_mode():
    """On flat content every available mode predicts the source: all cost
    0, so the first available wins: DC at the top-left MB, HOR along the
    top row, VERT everywhere else."""
    cur = _source("flat", 64, 48)
    _, D, _, mode, cost, _ = _i16_lanes(cur, 28)
    n_mx = 4
    want = [2 if i == 0 else 1 if i < n_mx else 0 for i in range(12)]
    assert mode.tolist() == want
    assert _plain_mode(cur).tolist() == want
    assert int(torch.where(cost < BIG, cost, 0).max()) == 0
    assert int(D.max()) == 0


def test_i16_plane_wins_on_a_gradient():
    """On a ramp PLANE predicts every MB whose neighbours lie on it."""
    cur = _source("gradient", 64, 64)
    rec, D, cb, mode, _, _ = _i16_lanes(cur, 28)
    inner = [4 * r + c for r in range(1, 4) for c in range(1, 4)]
    assert mode[inner].tolist() == [3] * len(inner)
    assert torch.equal(_plain_mode(cur), mode)
    for g, w in zip((rec, D, cb), TP.i16_candidate_plain(cur, 28)):
        assert torch.equal(g, w)


def test_i16_sums_fit_the_kernel_widths():
    """The kernel sums in int32.  A block's Hadamard absolute sum is at
    most 4 x its L2 norm, 16 x the residual's: 16 x 1020 at +-255, which
    a residual in the pattern of a bent function reaches (every
    coefficient of magnitude 1020).  A DC Hadamard term reaches 16 x 16 x
    255 = 65280, past int16 (an MB of 255 whose left neighbour is 0, in
    its HOR mode).  So an MB's mode cost is at
    most (16 x 16320 + 4 x 16 x 4080) / 2 = 261120, far below kBig (an
    unavailable mode never wins), and the DC quant's product stays below
    2^31."""
    from h264_tpu_torch.ops import transforms as TR

    k = torch.arange(16)
    x = [(k >> i) & 1 for i in range(4)]
    bent = (255 * (1 - 2 * ((x[0] & x[1]) ^ (x[2] & x[3])))).reshape(4, 4)
    hb = TR.hadamard4x4(bent.to(I32))
    assert int(hb.abs().sum()) == 16 * 1020
    assert int(hb.abs().min()) == int(hb.abs().max()) == 1020
    cur = torch.zeros((16, 32), dtype=I32)
    cur[:, 16:] = 255
    hd_max = _i16_lanes(cur, 0)[5]
    assert hd_max == 16 * 16 * 255 > (1 << 15) - 1
    bound = (16 * 16 * 1020 + 4 * 16 * 16 * 255) >> 1
    worst = 0
    for content in ("checker", "flat", "random", "gradient"):
        for q in (0, 51):
            c = _i16_lanes(_source(content, 64, 48), q)[4]
            worst = max(worst, int(torch.where(c < BIG, c, 0).max()))
    assert 0 < worst <= bound < BIG
    # the DC level's product at QP 0: |65280 >> 1| x 13107 + 2 (682 << 4)
    assert (65280 >> 1) * 13107 + 2 * (682 << 4) < 2 ** 31
