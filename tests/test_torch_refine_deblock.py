"""The premises of the CUDA designs of K4 ``qpel_refine`` and K6
``deblock``, on the CPU, exactly.

K6 filters a picture in one launch: blocks take MB rows in order and
filter MB (r, c) once (r, c-1) and (r-1, c+1) (or the end of row r-1) are
done, and each MB reads its own samples from the input planes.  So any
such order must give the raster order's result (the reference's
``deblock_device_full`` and the port's anti-diagonal ``deblock_plain``),
and no MB's own samples may be written before its turn.

K4 stages one (4, h+2, w+2) window of the bank per unit (coordinates
clamped) and computes each distinct quarter-pel sample of the unit once,
as 16 fraction planes, before the 49 candidates read them.  A plain
refinement built that way must equal ``qpel_refine_plain``, also on units
whose windows leave the bank, and the samples fit in bytes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu.ops.exact import chroma_qp
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.encoder import strengths as TS
from h264_tpu_torch.tools.strengths_cases import levels_of, per_block

H, W = 48, 64
N_MY, N_MX = H // 16, W // 16


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@functools.lru_cache(maxsize=None)
def _deblock_case(qp: int):
    """Blocky 64x48 planes, strengths of random motion, coefficients and
    intra MBs, and the reference's filtered planes at `qp`."""
    rng = np.random.RandomState(12)
    H4, W4 = H // 4, W // 4
    nz4 = rng.rand(H4, W4) < 0.3
    mvx = rng.randint(-6, 7, (H4, W4)).astype(np.int32)
    mvy = rng.randint(-6, 7, (H4, W4)).astype(np.int32)
    ref = rng.randint(0, 2, (H4, W4)).astype(np.int32)
    intra = rng.rand(N_MY, N_MX) < 0.3
    bv, bh = TS.strengths_plain(
        N_MY, N_MX, _t(levels_of(nz4, N_MY, N_MX)),
        _t(intra.reshape(-1), torch.bool),
        *(_t(per_block(a, N_MY, N_MX)) for a in (ref, mvx, mvy)))
    base = np.repeat(np.repeat(rng.randint(100, 120, (H4, W4)), 4, 0), 4, 1)
    y = (base + rng.randint(-2, 3, (H, W))).astype(np.int32)
    u, v = (np.repeat(np.repeat(rng.randint(120, 130, (H4, W4)), 2, 0), 2,
                      1).astype(np.int32) for _ in range(2))
    qpc = chroma_qp(qp, 0)
    want = jax.jit(JRD.deblock_device_full)(
        *map(jnp.asarray, (y, u, v)), jnp.asarray(bv.numpy()),
        jnp.asarray(bh.numpy()), jnp.int32(qp), jnp.int32(qpc))
    return (_t(y), _t(u), _t(v), bv, bh, qpc,
            [np.asarray(w) for w in want])


def _ready(done, r, c):
    """MB (r, c) may be filtered: its left neighbour and the row above up
    to column c + 1 (or the row's end) are done."""
    return (c == 0 or done[r][c - 1]) and (
        r == 0 or done[r - 1][min(c + 1, N_MX - 1)])


def _order(kind):
    """The MBs in raster order, in the kernel's row-lag order (each row in
    turn advances one MB when it may: row r at column c once row r-1 has
    finished c + 1), or in a random order that respects left and
    up-right."""
    if kind == "raster":
        return [(r, c) for r in range(N_MY) for c in range(N_MX)]
    done = [[False] * N_MX for _ in range(N_MY)]
    nxt = [0] * N_MY
    out = []
    rng = np.random.RandomState(kind) if isinstance(kind, int) else None
    while len(out) < N_MY * N_MX:
        ready = [r for r in range(N_MY)
                 if nxt[r] < N_MX and _ready(done, r, nxt[r])]
        pick = ready if rng is None else [ready[rng.randint(len(ready))]]
        for r in pick:
            out.append((r, nxt[r]))
            done[r][nxt[r]] = True
            nxt[r] += 1
    return out


@pytest.mark.parametrize("kind", ["raster", "row_lag", 0, 1, 2])
@pytest.mark.parametrize("qp", [28, 51])
def test_deblock_order_does_not_matter(qp, kind):
    y, u, v, bv, bh, qpc, want = _deblock_case(qp)
    order = _order(kind)
    assert sorted(order) == _order("raster")
    if kind != "raster":
        assert order != _order("raster")
    thr = (TP._thresholds(qp, "cpu"), TP._thresholds(qpc, "cpu"))
    Yp, Cp = TP.deblock_pad(y, u, v)
    for r, c in order:
        # the copy-folding premise: the MB's own samples are untouched
        assert torch.equal(Yp[4 + 16 * r:20 + 16 * r, 4 + 16 * c:20 + 16 * c],
                           y[16 * r:16 * r + 16, 16 * c:16 * c + 16]), (r, c)
        for P, src in zip(Cp, (u, v)):
            assert torch.equal(
                P[2 + 8 * r:10 + 8 * r, 2 + 8 * c:10 + 8 * c],
                src[8 * r:8 * r + 8, 8 * c:8 * c + 8]), (r, c)
        TP.deblock_mbs(Yp, Cp, bv, bh, torch.tensor([r]), torch.tensor([c]),
                       thr)
    got = (Yp[4:, 4:], Cp[0][2:, 2:], Cp[1][2:, 2:])
    plain = TP.deblock_plain(y, u, v, bv, bh, qp, qpc)
    for g, p, w, name in zip(got, plain, want, "YUV"):
        assert torch.equal(g, p), name
        np.testing.assert_array_equal(g.numpy(), w, name)
    assert not torch.equal(plain[0], y)  # it filtered


def _staged_refine(banks, cur_y, ref, imvx, imvy, y0, x0, px, py, wp,
                   lam_satd, h, w):
    """The refinement as the kernel computes it: one clamped (4, h+2,
    w+2) window per unit, its 16 fraction planes (the mean, then WP), the
    49 candidates' costs from them, the first minimum by strict <."""
    _, _, Hp, Wp = banks.shape
    ay, ax = torch.arange(h + 2), torch.arange(w + 2)
    rows = ((y0 + imvy - 1 + TRD.PAD)[:, None] + ay).clamp(0, Hp - 1)
    cols = ((x0 + imvx - 1 + TRD.PAD)[:, None] + ax).clamp(0, Wp - 1)
    win = banks[ref.long()[:, None, None, None],
                torch.arange(4)[None, :, None, None],
                rows.long()[:, None, :, None], cols.long()[:, None, None, :]]
    assert 0 <= int(win.min()) and int(win.max()) <= 255
    q = []
    for t in TRD._QTAB:
        a = win[:, t[0], t[1]:t[1] + h + 1, t[2]:t[2] + w + 1]
        b = win[:, t[3], t[4]:t[4] + h + 1, t[5]:t[5] + w + 1]
        q.append(TP._wp((a + b + 1) >> 1, wp, ref[:, None, None]))
    orig = cur_y[(y0[:, None] + torch.arange(h))[:, :, None],
                 (x0[:, None] + torch.arange(w))[:, None, :]]
    n = ref.shape[0]
    best = torch.full((n,), 1 << 30, dtype=torch.int32)
    out = [torch.zeros(n, dtype=torch.int32) for _ in range(2)] + [
        torch.zeros((n, h, w), dtype=torch.int32)]
    for dx, dy in TRD._REFINE.tolist():
        oy, ox = (dy >> 2) + 1, (dx >> 2) + 1
        pred = q[(dy & 3) * 4 + (dx & 3)][:, oy:oy + h, ox:ox + w]
        mvx, mvy = 4 * imvx + dx, 4 * imvy + dy
        cost = TRD._satd(orig - pred) + TRD._lam_cost(
            lam_satd, TRD._mv_bits(mvx - px) + TRD._mv_bits(mvy - py))
        lt = cost < best
        best = torch.where(lt, cost, best)
        for o, x in zip(out, (mvx, mvy, pred)):
            o[lt] = x[lt]
    return (*out, best)


@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("h,w", [(16, 16), (8, 16), (16, 8), (8, 8), (4, 8),
                                 (8, 4), (4, 4)])
def test_refine_from_staged_window(h, w, wp):
    rng = np.random.RandomState(h * 17 + w + wp)
    Hs, Ws = 48, 64
    planes = [_t(rng.randint(0, 256, s)) for s in
              ((Hs, Ws), (Hs // 2, Ws // 2), (Hs // 2, Ws // 2))]
    bank, _ = TRD.ref_entry_plain(*planes)
    banks = torch.stack([bank, TRD.ref_entry_plain(
        *(p.flip(0) for p in planes))[0]])
    cur = _t(rng.randint(0, 256, (Hs, Ws)))
    cur[:, :Ws // 4] = 77  # flat source over flat reference: ties
    banks[:, :, :, :TRD.PAD + Ws // 4 + 4] = 77
    # units at the four corners with integer mvs that put the window
    # against and past the bank's edges, a flat unit, and random ones
    y0 = [0, 0, Hs - h, Hs - h, 0] + list(rng.randint(0, Hs // h, 27) * h)
    x0 = [0, Ws - w, 0, Ws - w, 0] + list(rng.randint(0, Ws // w, 27) * w)
    imvy = [-32, -40, 28, 40, 1] + list(rng.randint(-36, 37, 27))
    imvx = [-33, 40, -40, 29, 0] + list(rng.randint(-36, 37, 27))
    n = len(y0)
    args = [_t(np.asarray(a, np.int32)) for a in (
        rng.randint(0, 2, n), imvx, imvy, y0, x0,
        rng.randint(-64, 65, n), rng.randint(-64, 65, n))]
    args[0][4] = 0
    wpt = (_t(np.asarray([40, 23])), _t(np.asarray([-7, 12]))) if wp else None
    lam_me = int(0.85 * 0.95 * 2.0 ** ((28 - 12) / 3.0) * 65536 + 0.5)
    for lam in (TRD.lam_satd_of(lam_me), 0):
        want = TP.qpel_refine_plain(banks, cur, *args, wpt, lam, h, w)
        got = _staged_refine(banks, cur, *args, wpt, lam, h, w)
        for g, x, name in zip(got, want, ("mvx", "mvy", "pred", "cost")):
            assert torch.equal(g, x), name
    # the flat unit without a rate: 49 equal costs, the first candidate
    assert (int(want[0][4]), int(want[1][4])) == (-3, 1)


@pytest.mark.parametrize("content", ["checkerboard", "random_0_255"])
def test_ref_bank_stays_in_byte_range(content):
    """K4 stages the bank as bytes: the 6-tap planes clip to 0..255 even
    on the most extreme content."""
    Hs, Ws = 48, 64
    yy, xx = np.mgrid[:Hs, :Ws]
    if content == "checkerboard":
        y = ((yy + xx) % 2) * 255
    else:
        y = np.random.RandomState(3).randint(0, 2, (Hs, Ws)) * 255
    planes = [_t(y), _t(y[::2, ::2]), _t(255 - y[::2, ::2])]
    bank, cpad = TRD.ref_entry_plain(*planes)
    for x in (bank, cpad):
        assert 0 <= int(x.min()) and int(x.max()) <= 255
    assert int(bank[1:].max()) == 255 and int(bank[1:].min()) == 0
