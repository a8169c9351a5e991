"""The premises of the CUDA design of K9 ``t8_decide``, on the CPU,
exactly.

``csrc/t8.cu`` runs a warp an MB, up to 4 MBs a block; lane 8 b + r holds
row r of 8x8 block b (``kernels/t8_geometry.py``).  Each lane runs whole
8-point butterflies in its registers, and the warp transposes every 8x8
block through a padded tile between the passes; a coefficient takes its
class's quant and dequant factors from lane ``class`` by a shuffle; the
sums are lane partials and warp sums, the nonzero 8x8 blocks a ballot, and
each 4x4 block's count and bits the join of its two halves (lanes l and
l ^ 1); every lane decides.  Here the geometry reads every input word once
and writes every output word once, the tile has no bank conflicts, and a
model of the lane form written as the kernel computes (the butterflies in
its in-place form, every lane's values) equals ``t8_decide_plain`` on the
built cases of ``tools/t8_cases.py`` and on its sized ones."""

import pathlib
import re

import numpy as np
import pytest
import torch

from h264_tpu_torch.encoder import rd_p
from h264_tpu_torch.kernels import t8_geometry as G
from h264_tpu_torch.ops.quant import _CLASS8, _M8, _V8
from h264_tpu_torch.tools import t8_cases

LANES = np.arange(32)


@pytest.mark.parametrize("n_mb", [1, 5, 397])
def test_every_word_read_and_written_once(n_mb):
    """Over the launch's grid, the raster words (orig, pred, the 4x4
    recon; the recon written), the level words (the 4x4 levels read; the
    8x8 and 4x4 levels written) and each MB's t8 flag (lane 0) are each
    touched exactly once; the warps past the last MB touch nothing."""
    blocks, threads = G.grid(n_mb)
    per = threads // 32
    assert per == G.mbs_per_block(n_mb) and blocks * per >= n_mb > (
        blocks - 1) * per
    raster = np.zeros(256 * n_mb, int)
    level = np.zeros(256 * n_mb, int)
    flag = np.zeros(n_mb, int)
    for blk in range(blocks):
        for warp in range(per):
            mb = G.mb_of(blk, warp, per)
            if mb >= n_mb:
                continue
            for lane in LANES:
                raster[256 * mb + G.raster_start(lane) + np.arange(8)] += 1
                level[256 * mb + G.level_start(lane) + np.arange(8)] += 1
            flag[mb] += 1
    assert (raster == 1).all() and (level == 1).all() and (flag == 1).all()


def test_lane_words():
    """A lane's raster words are row r of 8x8 block b of the MB, its level
    words row r of that block in (2, 2, 8, 8) and half of 4x4 block
    lane >> 1 in (4, 4, 4, 4); both runs of 8 start on 16 bytes."""
    ras = np.arange(256).reshape(16, 16)
    lev8 = np.arange(256).reshape(2, 2, 8, 8)
    lev4 = np.arange(256).reshape(4, 4, 4, 4)
    for lane in LANES:
        b, r = G.lane_row(lane)
        s, t = G.raster_start(lane), G.level_start(lane)
        assert s % 4 == 0 and t % 4 == 0
        assert (ras[8 * (b >> 1) + r, 8 * (b & 1):8 * (b & 1) + 8]
                == s + np.arange(8)).all()
        assert (lev8[b >> 1, b & 1, r] == t + np.arange(8)).all()
        half = lev4.reshape(16, 16)[lane >> 1, 8 * (lane & 1):][:8]
        assert (half == t + np.arange(8)).all()


def test_transpose_tile():
    """The tile's writes (a row a lane) and reads (a column a lane) each
    hit 32 distinct banks, stay inside a warp's TILE_WORDS, and turn every
    block's rows into its columns."""
    for c in range(8):
        w = [G.tile_row_word(l, c) for l in LANES]
        rd = [G.tile_col_word(l, c) for l in LANES]
        assert len({x % 32 for x in w}) == 32 and len({x % 32 for x in rd}) == 32
        assert max(w + rd) < G.TILE_WORDS
    m = np.arange(32 * 8).reshape(32, 8)  # lane l's row: block l >> 3
    tile = np.zeros(G.TILE_WORDS, int)
    for l in LANES:
        tile[[G.tile_row_word(l, c) for c in range(8)]] = m[l]
    got = np.array([[tile[G.tile_col_word(l, q)] for q in range(8)]
                    for l in LANES])
    blocks = m.reshape(4, 8, 8)
    assert (got.reshape(4, 8, 8) == blocks.transpose(0, 2, 1)).all()


def test_constants_match_the_kernel():
    """The geometry's block size, SM count and tile rows are the
    kernel's."""
    src = (pathlib.Path(rd_p.__file__).parent.parent / "csrc"
           / "t8.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)[;,]", src)}
    assert (got["kMaxMbs"], got["kSms"], got["kTileRow"]) == (
        G.MAX_MBS, G.SMS, G.TILE_ROW)
    assert (got["kCSkip"], got["kCP8x8"]) == (rd_p.C_SKIP, rd_p.C_P8x8)


# ---------------------------------------------------------------------------
# the lane form, as the kernel computes it: values (n_mb, 32 lanes, 8)
# ---------------------------------------------------------------------------

def _fwd8(p):
    p = list(p.unbind(-1))
    s0, s1, s2, s3 = p[0] + p[7], p[1] + p[6], p[2] + p[5], p[3] + p[4]
    b0, b1, b2, b3 = s0 + s3, s1 + s2, s0 - s3, s1 - s2
    d0, d1, d2, d3 = p[0] - p[7], p[1] - p[6], p[2] - p[5], p[3] - p[4]
    b4 = d1 + d2 + ((d0 >> 1) + d0)
    b5 = d0 - d3 - ((d2 >> 1) + d2)
    b6 = d0 + d3 - ((d1 >> 1) + d1)
    b7 = d1 - d2 + ((d3 >> 1) + d3)
    return torch.stack([b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1),
                        b5 + (b6 >> 2), b0 - b1, b6 - (b5 >> 2),
                        (b2 >> 1) - b3, (b4 >> 2) - b7], -1)


def _inv8(p):
    p = list(p.unbind(-1))
    a0, a4 = p[0] + p[4], p[0] - p[4]
    a2, a6 = (p[2] >> 1) - p[6], p[2] + (p[6] >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -p[3] + p[5] - p[7] - (p[7] >> 1)
    a3 = p[1] + p[7] - p[3] - (p[3] >> 1)
    a5 = -p[1] + p[7] + p[5] + (p[5] >> 1)
    a7 = p[3] + p[5] + p[1] + (p[1] >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3,
                        b2 - b5, b0 - b7], -1)


_W_ROW = torch.tensor([[G.tile_row_word(l, c) for c in range(8)]
                       for l in LANES])
_W_COL = torch.tensor([[G.tile_col_word(l, q) for q in range(8)]
                       for l in LANES])
_RASTER = torch.tensor(np.array([G.raster_start(l) + np.arange(8) for l in LANES]))
_LEVEL = torch.tensor(np.array([G.level_start(l) + np.arange(8) for l in LANES]))
_R = torch.tensor(LANES & 7)
# the class of element q of the lane's column (q, r) and of element c of
# its row (r, c)
_CLS_COL = torch.tensor(_CLASS8).T[_R]
_CLS_ROW = torch.tensor(_CLASS8)[_R]


def _transpose(v):
    """transpose8: every lane writes its row into the warp's tile, then
    reads its column."""
    tile = torch.zeros(v.shape[0], G.TILE_WORDS, dtype=v.dtype)
    tile[:, _W_ROW.reshape(-1)] = v.reshape(v.shape[0], -1)
    return tile[:, _W_COL]


def _shfl(per_lane, src):
    """__shfl_sync: every lane reads `per_lane` of lane src."""
    return per_lane[src]


def _bitlen(a):
    """floor(log2 a) + 1 of a >= 1 (32 - __clz(a))."""
    return torch.tensor(np.frexp(a.numpy().astype(np.float64))[1])


def _warp_sum(x):
    return x.sum(1, keepdim=True).expand_as(x)


def t8_lanes(orig_mb, w_pred, w_rec, w_lev, win, w_sub, is_intra, qp, lam):
    """t8_decide as csrc/t8.cu computes it, lane by lane (int64, which the
    kernel's int32 equals where nothing overflows: the level bound)."""
    n = orig_mb.shape[0]
    flat = lambda x: x.reshape(n, 256).to(torch.int64)  # noqa: E731
    o, p = flat(orig_mb)[:, _RASTER], flat(w_pred)[:, _RASTER]
    q4, l4 = flat(w_rec)[:, _RASTER], flat(w_lev)[:, _LEVEL]
    per, rem = qp // 6, qp % 6
    off = 342 << (5 + per)
    lanes6 = torch.tensor([l if l < 6 else 0 for l in LANES])
    mf = torch.tensor(_M8[rem], dtype=torch.int64)[lanes6]
    ils = torch.tensor(_V8[rem], dtype=torch.int64)[lanes6] * 16

    v = _fwd8(_transpose(_fwd8(o - p)))
    a = (v.abs() * _shfl(mf, _CLS_COL) + off) >> (16 + per)
    lev = _transpose(torch.where(v < 0, -a, a))
    v = ((lev * _shfl(ils, _CLS_ROW)) << per) + 32 >> 6
    v = _transpose(_inv8(_transpose(_inv8(v))))
    r8 = ((v + (p << 6) + 32) >> 6).clamp(0, 255)

    al, a4 = lev.abs(), l4.abs()
    bl8, bl4 = _bitlen(al), _bitlen(a4)
    d8 = ((o - r8) ** 2).sum(-1)
    d4 = ((o - q4) ** 2).sum(-1)
    cb8 = torch.where(al > 0, 2 * bl8 + 2, 0).sum(-1)
    nz = (al > 0).any(-1)
    lb = torch.where(a4 > 0, 2 * bl4 + 1, 0).sum(-1)
    n4 = (a4 > 0).sum(-1)
    partner = torch.tensor(LANES ^ 1)
    lb, n4 = lb + lb[:, partner], n4 + n4[:, partner]
    cb4 = _warp_sum(torch.where((_R[None] & 1) == 0,
                                torch.where(n4 > 0, lb + n4 + 2, 0), 0))
    nzb = nz.reshape(n, 4, 8).any(-1).sum(-1, keepdim=True).expand(n, 32)
    d8, d4 = _warp_sum(d8), _warp_sum(d4)
    cb8 = _warp_sum(cb8) + 4 * nzb

    def lam_cost(bits):
        return (lam >> 16) * bits + (((lam & 0xFFFF) * bits) >> 16)

    w = win.to(torch.int64)[:, None]
    ok = ((~is_intra)[:, None] & (w != rd_p.C_SKIP)
          & ((w != rd_p.C_P8x8) | (w_sub == 0).all(-1)[:, None]))
    use = ok & (d8 + lam_cost(cb8 + 1) < d4 + lam_cost(cb4 + 1))
    assert (use == use[:, :1]).all()  # every lane decides alike
    u = use[..., None]
    out = [torch.zeros(n, 256, dtype=torch.int64) for _ in range(3)]
    out[0][:, _LEVEL] = torch.where(u, lev, 0)
    out[1][:, _LEVEL] = torch.where(u, 0, l4)
    out[2][:, _RASTER] = torch.where(u, r8, q4)
    return (use[:, 0].to(torch.int32),
            out[0].reshape(n, 2, 2, 8, 8).to(torch.int32),
            out[1].reshape(n, 4, 4, 4, 4).to(torch.int32),
            out[2].reshape(n, 16, 16).to(torch.int32))


def _cases():
    cases = [(name, arrs, qp, lam)
             for name, arrs, qp, lam in t8_cases.built_cases(40, seed=5)]
    for n_mb in t8_cases.MB_COUNTS:
        cases.append(t8_cases.sized_case(n_mb, seed=5))
    cases.append(t8_cases.sized_case(397, seed=6, qp=0))
    cases.append(t8_cases.sized_case(397, seed=7, qp=51))
    return cases


@pytest.mark.parametrize("case", range(len(_cases())),
                         ids=[c[0] + f"_qp{c[2]}" for c in _cases()])
def test_lane_form_equals_plain(case):
    name, arrs, qp, lam = _cases()[case]
    args = tuple(torch.as_tensor(a) for a in arrs)
    got = t8_lanes(*args, qp, lam)
    want = rd_p.t8_decide_plain(*args, qp, lam)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if name.startswith("sized") and len(arrs[0]) >= 397:
        use = got[0].bool()
        assert use.any() and (~use & ~args[6]).any()  # both transforms win
    if name == "qp0_bound":
        assert int(got[1].abs().max()) == 3264
