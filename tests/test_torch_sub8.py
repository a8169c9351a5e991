"""K3 ``sub8_search`` on the CPU, exactly: its plain version against the
quadrant grids of ``ssd_grid4_plain`` priced and reduced here in numpy,
and the CUDA design's arithmetic written lane by lane in numpy.

The kernel gives each 8x8 unit 64 threads: thread (s, j) takes grid
column j and the strip of SH rows from s SH on, reads each window row it
needs once as two packed half rows, and forms every cell's four quadrant
SSDs as sum cur^2 + a running 4-row box of half-row squares - 2 x the
8x8 cross term split by quadrant.  It prices a cell once (lam_cost of the
summed row and column bits) and keeps each partition's first minimum as
the key cost * 512 + raster index; a pair's key is its two quadrants'
keys less the cell's rate-and-index part.  Written that way here it must
give ``ssd_grid4_plain``'s grids and ``sub8_search_plain``'s winners."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.tools.search_tq_cases import (SUB8_CONTENTS, sub8_case,
                                                  sub8_cmax)

PAD = 32
M32 = 0xFFFFFFFF
RS_CASES = (0, 1, 8, 10)
# lambda_me of QP 28 (its fraction makes lam_cost(a + b) differ from
# lam_cost(a) + lam_cost(b)), of QP 51, and 0 (ties go to the first cell)
LAMS = (2 * int(0.85 * 0.95 * 2.0 ** (16 / 3.0) * 65536 + 0.5),
        2 * int(0.85 * 0.95 * 2.0 ** 13 * 65536 + 0.5), 0)


def _np_mv_bits(d):
    d = np.asarray(d, np.int64)
    k = 2 * np.abs(d) - (d > 0)
    return 2 * np.floor(np.log2(k + 1)).astype(np.int64) + 1


def _np_lam_cost(lam, bits):
    return (lam >> 16) * bits + (((lam & 0xFFFF) * bits) >> 16)


def _np(t):
    return None if t is None else np.asarray(t, np.int64)


def _case(content, RS, wp, NR=2, W=32, H=48):
    return sub8_case(content, W, H, NR, RS, wp,
                     seed=1000 * RS + 10 * SUB8_CONTENTS.index(content) + wp)


def _rates(u_cy, u_cx, u_px, u_py, RS, lam):
    """(n, DS, DS) rate of each cell, and the same as the sum of the row's
    and the column's rates."""
    off = 4 * np.arange(-RS, RS + 1)
    by = _np_mv_bits(4 * u_cy[:, None] + off - u_py[:, None])
    bx = _np_mv_bits(4 * u_cx[:, None] + off - u_px[:, None])
    return (_np_lam_cost(lam, by[:, :, None] + bx[:, None, :]),
            _np_lam_cost(lam, by)[:, :, None] + _np_lam_cost(lam, bx)[:, None])


def _first_minima(s44, rate, u_cy, u_cx, RS):
    """The eight partitions' first minima over the raster index, numpy:
    (2, 8, n)."""
    DS = 2 * RS + 1
    out = np.zeros((2, 8, s44.shape[0]), np.int64)
    for p, qs in enumerate(((0, 1), (2, 3), (0, 2), (1, 3),
                            (0,), (1,), (2,), (3,))):
        cost = sum(s44[:, q] for q in qs) + rate
        for u in range(s44.shape[0]):
            flat = cost[u].reshape(-1)
            k = int(np.flatnonzero(flat == flat.min())[0])
            out[0, p, u] = k % DS - RS + u_cx[u]
            out[1, p, u] = k // DS - RS + u_cy[u]
    return out


@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("RS", RS_CASES)
@pytest.mark.parametrize("content", SUB8_CONTENTS)
def test_sub8_plain_matches_numpy_pricing(content, RS, wp):
    """sub8_search_plain against ssd_grid4_plain's grids summed, priced
    and reduced here, at the three lambdas; centres at +-CMAX among
    them."""
    banks, cur, u_ref, u_cy, u_cx, u_px, u_py, wpt, RS = _case(content, RS,
                                                                 wp)
    s44 = TP.ssd_grid4_plain(banks, cur, u_ref, u_cy, u_cx, wpt, RS).numpy()
    cy, cx, px, py = map(_np, (u_cy, u_cx, u_px, u_py))
    cmax = sub8_cmax(RS)
    assert {(-cmax, -cmax), (cmax, cmax)} <= set(zip(cx, cy))
    if content == "extreme":
        assert s44.max() == 16 * 255 ** 2
    for lam in LAMS:
        rate, split = _rates(cy, cx, px, py, RS, lam)
        if lam == LAMS[0]:
            assert (rate != split).any()  # lam_cost is not additive
        want = _first_minima(s44.astype(np.int64), rate, cy, cx, RS)
        got = TP.sub8_search_plain(banks, cur, u_ref, u_cy, u_cx, u_px,
                                   u_py, wpt, RS, lam)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), lam
        if content == "flat" and lam == 0:
            assert np.array_equal(want[0], np.broadcast_to(cx - RS, (8, cx.size)))
            assert np.array_equal(want[1], np.broadcast_to(cy - RS, (8, cy.size)))


def test_numpy_rate_matches_reference():
    """The test's mv bits and lam_cost are the reference's on every mv
    difference the search can price (|d| below 2^12)."""
    d = np.arange(-4095, 4096)
    ref = np.asarray(JRD._mv_bits(jnp.asarray(d, jnp.int32)))
    assert np.array_equal(_np_mv_bits(d), ref)
    bits = np.arange(0, 60)
    for lam in LAMS:
        assert np.array_equal(_np_lam_cost(lam, bits), np.asarray(
            JRD._lam_cost(lam, jnp.asarray(bits, jnp.int32))))


def _geometry(RS):
    """The kernel's split of a unit's 64 threads: (DS, SH, NS)."""
    DS = 2 * RS + 1
    n_str = 64 // DS
    SH = -(-DS // n_str)
    return DS, SH, -(-DS // SH)


@pytest.mark.parametrize("RS", range(11))
def test_sub8_thread_geometry(RS):
    """Every RS of 0..10: the strips cover the grid and fit a unit's 64
    threads, a thread holds at most 7 cells, and the strips read no more
    than the NS SH + 7 staged rows of 8 words (at most 28)."""
    DS, SH, NS = _geometry(RS)
    assert NS * SH >= DS > (NS - 1) * SH
    assert NS * DS <= 64
    assert SH <= 7
    assert NS * SH + 7 <= 28 and 2 * RS + 8 <= 28
    assert (DS - 1) // 4 + 2 < 8  # the third aligned word of column DS-1


def test_sub8_keys_fit_int32():
    """cost * 512 + raster index stays below 2^31 for a pair's largest SSD,
    lam_me up to 2^31 - 1 and mv differences below 2^13 quarter-pels."""
    bits = 2 * int(_np_mv_bits(-(2 ** 13 - 1)))
    cost = 32 * 255 ** 2 + _np_lam_cost(2 ** 31 - 1, bits)
    assert cost * 512 + 21 * 21 - 1 < 2 ** 31


def _windows(banks, cur, u_ref, u_cy, u_cx, wp, RS, size):
    """Each unit's weighted window of `size` (rows, columns) from its
    (2RS+8)^2 window's corner on, its reads clamped to the bank, and its
    8x8 source block, numpy."""
    NR, _, Hp, Wp = banks.shape
    W = cur.shape[1]
    u = np.arange(u_ref.size)
    mb, b8 = u // 4, u % 4
    y0 = 16 * (mb // (W // 16)) + 8 * (b8 >> 1)
    x0 = 16 * (mb % (W // 16)) + 8 * (b8 & 1)
    rows = np.clip((y0 + u_cy - RS + PAD)[:, None] + np.arange(size[0]), 0,
                   Hp - 1)
    cols = np.clip((x0 + u_cx - RS + PAD)[:, None] + np.arange(size[1]), 0,
                   Wp - 1)
    win = banks[u_ref[:, None, None], 0, rows[:, :, None], cols[:, None, :]]
    if wp is not None:
        w, o = wp[0][u_ref][:, None, None], wp[1][u_ref][:, None, None]
        win = np.clip(((win * w + 16) >> 5) + o, 0, 255)
    a8 = np.arange(8)
    src = cur[(y0[:, None] + a8)[:, :, None], (x0[:, None] + a8)[:, None, :]]
    return win, src


def _sub8_lanes(banks, cur, u_ref, u_cy, u_cx, u_px, u_py, wp, RS, lam):
    """sub8_kernel thread by thread (vectorized over units): the quadrant
    SSDs it forms, (n, 4, DS, DS), and its winners, (2, 8, n)."""
    DS, SH, NS = _geometry(RS)
    n = u_ref.size
    # the staged rows and words: the bank's clamped samples past the
    # (2RS+8)^2 window too, which no cell of the grid may read
    stage, src = _windows(banks, cur, u_ref, u_cy, u_cx, wp, RS,
                          (NS * SH + 7, 32))
    csq = np.stack([(src[:, 4 * (q >> 1):4 * (q >> 1) + 4,
                         4 * (q & 1):4 * (q & 1) + 4] ** 2).sum((1, 2))
                    for q in range(4)], 1)
    by = _np_mv_bits(4 * (u_cy[:, None] + np.arange(DS) - RS) - u_py[:, None])
    ssd = np.zeros((n, 4, DS, DS), np.int64)
    best = np.full((8, n), 2 ** 31 - 1, np.int64)
    for s in range(NS):
        i0 = s * SH
        for j in range(DS):
            bx = _np_mv_bits(4 * (u_cx + j - RS) - u_px)
            rows = stage[:, i0:i0 + SH + 7, j:j + 8]  # the thread's reads
            half = (rows[..., :4], rows[..., 4:])
            sq = [(h * h).sum(-1) for h in half]  # __dp4a(w, w)
            box = [np.zeros_like(sq[0]) for _ in range(2)]
            for h in range(2):
                box[h][:, 3] = sq[h][:, :4].sum(1)
                for t in range(4, SH + 7):
                    box[h][:, t] = box[h][:, t - 1] + sq[h][:, t] - sq[h][:, t - 4]
            for a in range(SH):
                i = i0 + a
                if i >= DS:
                    continue
                kq = []
                base = (_np_lam_cost(lam, by[:, i] + bx) * 512
                        + i * DS + j) & M32
                for q in range(4):
                    qy, qx = q >> 1, q & 1
                    cross = sum((half[qx][:, a + y] * src[:, y, 4 * qx:4 * qx + 4]
                                 ).sum(-1) for y in range(4 * qy, 4 * qy + 4))
                    e = csq[:, q] + box[qx][:, a + 3 + 4 * qy] - 2 * cross
                    ssd[:, q, i, j] = e
                    kq.append((e * 512 + base) & M32)
                keys = [(kq[0] + kq[1] - base) & M32, (kq[2] + kq[3] - base) & M32,
                        (kq[0] + kq[2] - base) & M32, (kq[1] + kq[3] - base) & M32,
                        *kq]
                for p, key in enumerate(keys):
                    assert (key < 2 ** 31).all()
                    best[p] = np.minimum(best[p], key)
    k = best & 511
    return ssd, np.stack([k % DS - RS + u_cx, k // DS - RS + u_cy])


@pytest.mark.parametrize("wp", [False, True], ids=["nowp", "wp"])
@pytest.mark.parametrize("RS", RS_CASES)
@pytest.mark.parametrize("content", SUB8_CONTENTS)
def test_sub8_lanes_match_plain(content, RS, wp):
    """The kernel's algebra (each quadrant's SSD from the packed half rows'
    running boxes and the split cross term) equals ssd_grid4_plain, and
    its packed-key minima over the strips equal sub8_search_plain."""
    args = _case(content, RS, wp, NR=2, W=32, H=32)
    banks, cur, u_ref, u_cy, u_cx, u_px, u_py, wpt, RS = args
    npa = [_np(x) for x in (banks, cur, u_ref, u_cy, u_cx, u_px, u_py)]
    wpn = None if wpt is None else tuple(map(_np, wpt))
    want = TP.ssd_grid4_plain(banks, cur, u_ref, u_cy, u_cx, wpt, RS).numpy()
    for lam in LAMS:
        ssd, mv = _sub8_lanes(*npa, wpn, RS, lam)
        assert np.array_equal(ssd, want)
        got = TP.sub8_search_plain(*args, lam).numpy()
        assert np.array_equal(mv, got), lam
