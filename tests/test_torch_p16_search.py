"""The premises of the CUDA design of K12 ``p16_search``, on the CPU,
exactly, in numpy.

The kernel stages each MB's (16 + 2R)^2 window as packed u8 words (zero
past it), takes the squares' row sums of 16 samples once per window
(16 ``__dp4a`` a quad of four dx, from three ``__byte_perm`` shifts), the
cross terms of a tile of 4 dx by 8 dy cells by ``__dp4a`` of the shifted
window words with the MB's rows, the vertical 16-row box of the row sums
down the tile's columns, SSD = sum cur^2 + box - 2 cross, the rate once a
cell, and the first minimum as (cost, p) pairs: strict < in rising p in a
thread, then the least cost and the least p holding it over a warp, then
over the block.  Written word by word here it must equal ``search_plain``
(which ``tests/test_torch_legacy.py::test_search`` holds against the
reference's ``fast.py``)."""

import numpy as np
import pytest
import torch

from h264_tpu_torch.encoder import fast
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.p16_cases import CASES, built_case
from h264_tpu_torch.tools.synthseq import moving_frames

P = fast.PAD
TX, TY = 4, 8
INT_MAX = 2 ** 31 - 1
RS = [0, 1, 8, 32]


def _geometry(R):
    """csrc/p16_search.cu Geometry: D, S, nq, nty, Sr, Ws, tiles."""
    D, S = 2 * R + 1, 16 + 2 * R
    nq, nty = -(-D // TX), -(-D // TY)
    return D, S, nq, nty, nty * TY + 15, (nq + 5) // 4 * 4 + 2, nq * nty


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 arrays (selectors 0-7)."""
    both = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        k = np.uint64((sel >> (4 * i)) & 7)
        out |= ((both >> (np.uint64(8) * k)) & np.uint64(0xFF)) << np.uint64(
            8 * i)
    return out.astype(np.uint32)


def _dp4a(a, b, c=0):
    """__dp4a(a, b, c) of unsigned words: c + the four byte products."""
    s = np.asarray(c, np.int64)
    for i in range(4):
        s = s + ((a.astype(np.int64) >> (8 * i)) & 255) * (
            (b.astype(np.int64) >> (8 * i)) & 255)
    return s


def _pack(samples):
    """(..., 4 m) u8 samples -> (..., m) words, sample 4 i + b in byte b."""
    s = samples.astype(np.uint32).reshape(*samples.shape[:-1], -1, 4)
    return s[..., 0] | s[..., 1] << 8 | s[..., 2] << 16 | s[..., 3] << 24


def _search_lanes(cur, ref_pad, R, lam):
    """p16_search as the kernel computes it: (mvx, mvy, grid0) (n_my,
    n_mx)."""
    H, W = cur.shape
    n_my, n_mx = H // 16, W // 16
    D, S, nq, nty, Sr, Ws, tiles = _geometry(R)
    out = np.zeros((3, n_my, n_mx), np.int64)
    bits = fast.mv_bits(torch.arange(-R, R + 1, dtype=torch.int32) * 4
                        ).numpy().astype(np.int64)
    for my in range(n_my):
        for mx in range(n_mx):
            # A. the window's words, zero past S x S; the MB's rows
            win = np.zeros((Sr, 4 * Ws), np.int64)
            y0, x0 = P + 16 * my - R, P + 16 * mx - R
            win[:S, :S] = ref_pad[y0:y0 + S, x0:x0 + S]
            wd = _pack(win)  # (Sr, Ws)
            blk = cur[16 * my:16 * my + 16, 16 * mx:16 * mx + 16]
            cw = _pack(blk)  # (16, 4)
            csq = int(_dp4a(cw, cw).sum())
            # B. row sums of 16 squares, a quad of four dx from five words
            q5 = np.stack([wd[:, q:q + 5] for q in range(nq)], 1)
            sh = np.stack([q5[..., :4] if k == 0 else _byte_perm(
                q5[..., :4], q5[..., 1:], 0x3210 + 0x1111 * k)
                for k in range(TX)], 2)  # (Sr, nq, k, i)
            rs = _dp4a(sh, sh).sum(-1)  # (Sr, nq, k)
            rs[S:] = 0
            rs = rs.reshape(Sr, nq * TX)
            # C. the cross terms: MB row y against window row dy + y
            cross = np.zeros((nty * TY, nq, TX), np.int64)
            for y in range(16):
                cross += _dp4a(sh[y:y + nty * TY], cw[y]).sum(-1)
            cross = cross.reshape(nty * TY, nq * TX)
            # D. the vertical box, SSD, rate; each thread's first minimum
            # over its 8 x 4 tile in rising p
            box = np.stack([rs[dy:dy + 16].sum(0) for dy in range(nty * TY)])
            ssd = csq + box - 2 * cross
            b = bits[:, None] + bits[None, :]
            cost = np.full(ssd.shape, INT_MAX, np.int64)
            cost[:D, :D] = ssd[:D, :D] + (lam >> 16) * b + (
                ((lam & 0xFFFF) * b) >> 16)
            assert 0 <= cost.min() and cost[:D, :D].max() < 2 ** 25
            out[2, my, mx] = ssd[R, R]
            best = []
            for t in range(32 * -(-tiles // 32)):
                bc = bp = INT_MAX
                if t < tiles:
                    ty, tq = divmod(t, nq)
                    tile = cost[TY * ty:TY * ty + TY, TX * tq:TX * tq + TX]
                    a, k = divmod(int(np.argmin(tile)), TX)
                    if tile[a, k] < INT_MAX:
                        bc = int(tile[a, k])
                        bp = (TY * ty + a) * D + TX * tq + k
                best.append((bc, bp))
            # the warps' least cost, then least p holding it; the block's
            warps = []
            for w in range(0, len(best), 32):
                c = min(x[0] for x in best[w:w + 32])
                warps.append((c, min(x[1] for x in best[w:w + 32]
                                     if x[0] == c)))
            c, p = warps[0]
            for wc, wp in warps[1:]:
                if wc < c or (wc == c and wp < p):
                    c, p = wc, wp
            out[0, my, mx], out[1, my, mx] = p % D - R, p // D - R
    return out


def _inputs(case, W, H, R):
    if case == "seeded":  # two moving frames, cut to W x H
        fr = [[np.asarray(p, np.int32)[:H >> k, :W >> k]
               for k, p in zip((0, 1, 1), f)]
              for f in moving_frames(2, max(W, 64), max(H, 64), seed=W + R)]
        ref = fast.ref_resources(*fr[0], device="cpu")
        return fr[1][0].astype(np.int64), ref[0].numpy().astype(np.int64)
    cur, ref = built_case(case, H, W, R, seed=R + 3)
    return cur[0].astype(np.int64), ref[0].astype(np.int64)


def _lam(qp):
    return int(0.85 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("case", ["seeded", *CASES])
def test_search_lanes_match_plain(case, R):
    """The kernel's algebra at R 0, 1, 8 and 32 on a seeded picture and on
    tools/p16_cases.py's built ones (0/255 and 255/0, flat, motion to +-R
    at every edge), at the lambdas of QP 28 and 51."""
    W, H = (32, 16) if R == 32 else (48, 32)
    cur, ref = _inputs(case, W, H, R)
    for qp in (28, 51):
        got = _search_lanes(cur, ref, R, _lam(qp))
        want = fast.search_plain(torch.as_tensor(cur, dtype=torch.int32),
                                 torch.as_tensor(ref, dtype=torch.int32), R,
                                 _lam(qp))
        for g, w, name in zip(got, want, ("mvx", "mvy", "grid0")):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("R", [1, 8])
def test_search_first_minimum_on_flat_content(R):
    """On flat content every SSD ties: at lambda 0 every cost ties and the
    first p wins (-R, -R); with a rate the zero vector wins; the (cost, p)
    reduction equals numpy's argmin over the whole grid."""
    cur = np.full((32, 48), 77, np.int64)
    ref = np.full((32 + 2 * P, 48 + 2 * P), 77, np.int64)
    bits = fast.mv_bits(torch.arange(-R, R + 1, dtype=torch.int32) * 4
                        ).numpy().astype(np.int64)
    for lam, want in ((0, -R), (_lam(28), 0)):
        got = _search_lanes(cur, ref, R, lam)
        assert (got[0] == want).all() and (got[1] == want).all()
        b = bits[:, None] + bits[None, :]
        cost = (lam >> 16) * b + (((lam & 0xFFFF) * b) >> 16)
        p = int(np.argmin(cost.reshape(-1)))
        assert (p % (2 * R + 1) - R, p // (2 * R + 1) - R) == (want, want)
        assert (got[2] == 0).all()


def test_search_key_needs_38_bits():
    """The largest cost at R 32 and the encoder's largest lambda (QP 51's,
    the legacy path's lambda_mode) stays below 2^25, and p below 65^2 <
    2^13: 38 bits, too many for one 32-bit key, so the kernel compares
    (cost, p) pairs; every partial sum fits int32."""
    lam = H264Encoder(EncoderConfig(width=16, height=16, qp=51, fast=True,
                                    rd=False), device="cpu").lambda_mode_fx
    R = 32
    bits = fast.mv_bits(torch.arange(-R, R + 1, dtype=torch.int32) * 4)
    b = int((bits[:, None] + bits[None, :]).max())
    worst = 256 * 255 ** 2 + (lam >> 16) * b + (((lam & 0xFFFF) * b) >> 16)
    assert worst < 2 ** 25 and (2 * R + 1) ** 2 <= 2 ** 13
    assert 2 ** 25 * 2 ** 13 > 2 ** 32
    # the cross term and the box of squares of one cell, at 0/255
    assert 256 * 255 * 255 < 2 ** 31
