"""The premises of the CUDA design of K10 ``sad_grid_16x16``, on the CPU,
exactly, in numpy.

A block of the kernel takes a run of up to 8 neighbouring MBs of one MB
row and 16 tiles of its grid (``Geometry``: tiles of 4 dx by 3 dy; the
grid's quads cut into strips of at most 16 whose widths differ by at most
one, the tiles row-major in a strip); it stages the run's MBs and the window its tiles read as packed
u8 words, zero past the reference and the run; lane l takes MB l % 8 and
tile l / 8
of its warp's four, and down the 18 window rows of its tile shifts each
row's five words into the quad's dx by ``__byte_perm`` and adds the four
absolute differences of each word (``vabsdiff4`` with accumulate) to every
cell whose 16 x 16 block holds the row; it writes only the cells inside
the grid of MBs inside the row.  Written word by word here, on pictures
whose width does not divide the run and at R 0, 1, 16 and 33 (tiles that
do not divide 2R + 1; R 33 and 120 cut the quads into strips), it must
equal ``sad_grid_16x16_plain`` and, at the shapes
``tests/test_torch_me.py`` compiles, the reference's
``me.sad_grid_16x16``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import me as JME
from h264_tpu_torch.encoder import me as TME
from h264_tpu_torch.kernels import sad_geometry as K10
from h264_tpu_torch.kernels.sad_geometry import (MAXQ, MB_WORDS, RUN, TILES,
                                                 TX, TY, WARPS)


def _pack(samples):
    """(..., 4 m) u8 samples -> (..., m) words, sample 4 i + b in byte b."""
    s = samples.astype(np.uint32).reshape(*samples.shape[:-1], -1, 4)
    return s[..., 0] | s[..., 1] << 8 | s[..., 2] << 16 | s[..., 3] << 24


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 arrays (selectors 0-7)."""
    both = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        k = np.uint64((sel >> (4 * i)) & 7)
        out |= ((both >> (np.uint64(8) * k)) & np.uint64(0xFF)) << np.uint64(
            8 * i)
    return out.astype(np.uint32)


def _bytes(w):
    """(...) words -> (..., 4) bytes."""
    w = np.asarray(w, np.int64)
    return np.stack([(w >> (8 * b)) & 255 for b in range(4)], -1)


def _sad_lanes(cur, ref, R):
    """sad_grid_16x16 as the kernel computes it: every block ((MB row, run
    of 8 MBs) x strip x group of 16 tiles) at once, lane by lane."""
    H, W = cur.shape
    n_my, n_mx = H // 16, W // 16
    g = K10.geometry(R)
    D, nty, rows_max, Ws = g.D, g.nty, g.rows, g.Ws
    Hp, Wp = H + 2 * R, W + 2 * R
    runs = -(-n_mx // RUN)
    mby, run, strip, grp = (v.reshape(-1) for v in np.meshgrid(
        np.arange(n_my), np.arange(runs), np.arange(g.ns),
        np.arange(g.groups), indexing="ij"))
    assert (n_my * runs, g.ns, g.groups) == g.blocks(H, W)
    mx0, q0 = run * RUN, g.strip_q0(strip)
    sw = g.strip_q0(strip + 1) - q0
    n_tiles, u0 = sw * nty, grp * TILES
    keep = u0 < n_tiles  # the other blocks return at once
    mby, mx0, q0, sw, n_tiles, u0 = (v[keep] for v in (mby, mx0, q0, sw,
                                                        n_tiles, u0))
    nb = mby.size
    ty0 = u0 // sw
    rows = ((np.minimum(u0 + TILES, n_tiles) - 1) // sw - ty0 + 1) * TY + 15
    assert rows.max() <= rows_max
    # A. the runs' MB rows as words, zero past the row's end; each block's
    # window as words, zero past the reference
    curp = np.zeros((H, 16 * runs * RUN), np.int64)
    curp[:, :W] = cur
    cw = _pack(curp.reshape(n_my, 16, runs * RUN, 16).transpose(0, 2, 1, 3))
    ys = (16 * mby + TY * ty0)[:, None] + np.arange(rows_max)
    xs = (16 * mx0 + 4 * q0)[:, None] + np.arange(4 * Ws)
    inside = (ys[:, :, None] < Hp) & (xs[:, None, :] < Wp)
    win = np.where(inside, ref[np.minimum(ys, Hp - 1)[:, :, None],
                               np.minimum(xs, Wp - 1)[:, None, :]], 0)
    wd = _pack(win)  # (nb, rows_max, Ws)
    # B. lane l: MB m = l % 8, tile u = u0 + l // 8 of the strip
    lane = np.arange(32 * WARPS)
    m = lane % RUN
    u = u0[:, None] + lane // 8
    live = u < n_tiles[:, None]
    ty, tq = u // sw[:, None], u % sw[:, None]
    cb = _bytes(cw[mby[:, None], mx0[:, None] + m])  # (nb, 128, 16, 4, 4)
    bi = np.arange(nb)[:, None]
    acc = np.zeros((nb, lane.size, TY, TX), np.int64)
    for r in range(TY + 15):
        row = np.minimum(TY * (ty - ty0[:, None]) + r, rows_max - 1)
        w = np.stack([wd[bi, row, np.minimum(4 * m + tq + i, Ws - 1)]
                      for i in range(5)], -1)  # (nb, 128, 5)
        sh = [_bytes(w[..., :4] if k == 0 else _byte_perm(
            w[..., :4], w[..., 1:], 0x3210 + 0x1111 * k)) for k in range(TX)]
        for a in range(TY):
            y = r - a
            if 0 <= y <= 15:
                for k in range(TX):
                    # four vabsdiff4 with accumulate, one a word
                    acc[:, :, a, k] += np.abs(sh[k] - cb[:, :, y]).sum((-1, -2))
    # C. the cells inside the grid of the MBs inside the row
    out = np.full((D, D, n_my, n_mx), -1, np.int64)
    mx = mx0[:, None] + m
    for a in range(TY):
        for k in range(TX):
            dy, dx = TY * ty + a, 4 * (q0[:, None] + tq) + k
            ok = live & (dy < D) & (dx < D) & (mx < n_mx)
            out[dy[ok], dx[ok], np.broadcast_to(mby[:, None], ok.shape)[ok],
                mx[ok]] = acc[:, :, a, k][ok]
    return out


def _planes(content, W, H, R, seed):
    rs = np.random.RandomState(seed)
    if content == "random":
        cur, ref = rs.randint(0, 256, (2, H, W))
    elif content == "flat":
        cur, ref = np.full((2, H, W), 131)
    else:  # 0/255: every term at its largest
        cur, ref = np.full((H, W), 255), np.zeros((H, W), np.int64)
    return cur, np.pad(ref, R, mode="edge")


# (W, H, R): one MB, a row of 2 MBs (the run cut short), 9 MBs a row (a
# run of 8 and one of 1) at R 0, 1, 16 and 33 (QCIF, runs of 8 and 3, is
# held against the reference below); one MB at R 120, four strips of 15,
# 15, 15 and 16 quads
CELLS = [(W, H, R) for W, H in ((16, 16), (32, 48), (144, 32))
         for R in (0, 1, 16, 33)] + [(16, 16, 120)]


@pytest.mark.parametrize("content", ["random", "flat", "0_255"])
@pytest.mark.parametrize("W,H,R", CELLS, ids=lambda v: str(v))
def test_sad_lanes_match_plain(W, H, R, content):
    cur, ref = _planes(content, W, H, R, seed=W + R)
    got = _sad_lanes(cur, ref, R)
    want = TME.sad_grid_16x16_plain(torch.as_tensor(cur, dtype=torch.int32),
                                    torch.as_tensor(ref, dtype=torch.int32),
                                    R)
    np.testing.assert_array_equal(got, want.numpy())
    if content == "0_255":
        assert int(got.min()) == int(got.max()) == 255 * 256


@pytest.mark.parametrize("R", [0, 1, 16])
@pytest.mark.parametrize("W,H", [(32, 48), (176, 144)], ids=lambda v: str(v))
def test_sad_lanes_match_reference(W, H, R):
    """Against the reference's jitted me.sad_grid_16x16 at the shapes and
    ranges tests/test_torch_me.py compiles."""
    cur, ref = _planes("random", W, H, R, seed=W * 3 + R)
    want = np.asarray(JME.sad_grid_16x16(jnp.asarray(cur, jnp.int32),
                                         jnp.asarray(ref, jnp.int32), R))
    np.testing.assert_array_equal(_sad_lanes(cur, ref, R), want)


@pytest.mark.parametrize("R", [0, 1, 13, 14, 16, 31, 32, 33, 64, 120, 121,
                               200, 1000])
def test_geometry_bounds_shared_memory(R):
    """Every R cuts the grid into strips of 1 to 16 quads that follow one
    another over all nq, whose tiles the blocks cover, 16 a block; in
    every strip, the narrowest included, a block's window stays inside the
    rows x Ws words staged, and the window and MBs under 12 KB of shared
    memory (the 48 KB a block may take without asking is never needed)."""
    g = K10.geometry(R)
    assert TX * g.nq >= g.D and TY * g.nty >= g.D
    assert (RUN * MB_WORDS + g.rows * g.Ws) * 4 < 12 * 1024
    assert g.strip_q0(0) == 0 and g.strip_q0(g.ns) == g.nq
    for s in range(g.ns):
        q0 = g.strip_q0(s)
        sw = g.strip_q0(s + 1) - q0
        assert 1 <= sw <= g.sw <= MAXQ
        assert g.groups * TILES >= sw * g.nty
        # the feed's five words of the last quad of the last MB stay in a
        # row
        assert 4 * (RUN - 1) + sw - 1 + 4 < g.Ws
        # 16 consecutive tiles of the strip span at most the rows staged
        for u0 in range(0, sw * g.nty, TILES):
            u1 = min(u0 + TILES, sw * g.nty) - 1
            assert (u1 // sw - u0 // sw + 1) * TY + 15 <= g.rows


def test_constants_match_the_kernel():
    """The emulation's tile, run, block and strip sizes
    (kernels/sad_geometry.py) are the kernel's."""
    import pathlib
    import re

    src = (pathlib.Path(TME.__file__).parent.parent / "csrc"
           / "sad_grid.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                            src)}
    assert (got["kRun"], got["kTX"], got["kTY"], got["kWarps"], got["kMaxQ"],
            got["kMbWords"]) == (RUN, TX, TY, WARPS, MAXQ, MB_WORDS)
