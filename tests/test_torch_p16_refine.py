"""The premises of the CUDA design of K13 ``p16_refine``, on the CPU,
exactly, in numpy.

The kernel prices each MB's 49 quarter-pel candidates on packed u8 words:
a regular MB (no window moves: its middle starts in 1 .. L - 17 on both
axes of every plane) stages each plane's 18 x 18 window from one sample up
and left of its middle start, five words a row, and takes every window
word by a funnel shift of two staged words; any other MB reads each window
word at its own placed start (a negative start plus the axis length,
clamped to L - 16, as ``dynamic_slice`` places it).  A candidate averaging
two windows takes ``__vavgu4`` of their words; the squared error is
``__vabsdiffu4`` then ``__dp4a`` of the difference with itself, summed
over the warp; lane l keeps the keys cost * 64 + k of k = l and l + 32
and the warp's least key is the first minimum (the cost's bound makes the
key fit int32).  Written word
by word here it must equal ``refine_plain`` (which
``tests/test_torch_legacy.py::test_refine`` holds against the reference's
``fast.py``), on tools/p16_cases.py's cases and seeded content at R 8 and
28, at R 32 on ``edges`` (windows that wrap and clamp at the picture's
edges), and on vectors that move windows: the corner MBs at +-(R + 1) and
vectors beyond the pad (+-40, +-200, +-2^30, -2^31).  The plain version's
window placement is held against ``jax.lax.dynamic_slice`` itself."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu_torch.encoder import fast
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.encoder.rd import _lam_cost
from h264_tpu_torch.tools.p16_cases import CASES, built_case, moved_vectors
from h264_tpu_torch.tools.synthseq import moving_frames

P = fast.PAD
KCAND = 49
I32 = torch.int32


def _wrap(x):
    """int64 values -> their int32 wrap, as int64."""
    return (np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _slice_start(s, L, size):
    s = np.where(s < 0, s + L, s)
    return np.clip(s, 0, L - size)


def _cand_of(k):
    """csrc/p16_refine.cu cand_of: windows a and b of candidate k, each
    (plane 0 G / 1 b / 2 h / 3 j, row offset, column offset)."""
    ox, oy = k % 7 - 3, k // 7 - 3
    dx, dy = (ox + 4) & 3, (oy + 4) & 3
    r, c = int(oy >= 0), int(ox >= 0)
    G00, G01, G10 = (0, r, c), (0, r, c + 1), (0, r + 1, c)
    B00, B10, H00, H01, J00 = (1, r, c), (1, r + 1, c), (2, r, c), (
        2, r, c + 1), (3, r, c)
    if (dx, dy) == (0, 0):
        return G00, G00
    if dy == 0:
        return {1: (G00, B00), 2: (B00, B00), 3: (B00, G01)}[dx]
    if dx == 0:
        return {1: (G00, H00), 2: (H00, H00), 3: (H00, G10)}[dy]
    if (dx, dy) == (2, 2):
        return J00, J00
    if dx == 2:
        return (B00, J00) if dy == 1 else (J00, B10)
    if dy == 2:
        return (H00, J00) if dx == 1 else (J00, H01)
    return (B00 if dy == 1 else B10), (H00 if dx == 1 else H01)


def _pack(samples):
    """(..., 4 m) u8 samples -> (..., m) words, sample 4 i + b in byte b."""
    s = samples.astype(np.uint32).reshape(*samples.shape[:-1], -1, 4)
    return s[..., 0] | s[..., 1] << 8 | s[..., 2] << 16 | s[..., 3] << 24


def _bytes(w):
    """(...) words -> (..., 4) bytes."""
    w = np.asarray(w, np.uint32)
    return np.stack([(w >> (8 * b)) & 255 for b in range(4)], -1).astype(
        np.int64)


def _funnelshift_r(lo, hi, s):
    both = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return (both >> np.uint64(s)).astype(np.uint32)


def _vavgu4(a, b):
    return _pack((_bytes(a) + _bytes(b) + 1) >> 1)[..., 0]


def _vabsdiffu4(a, b):
    return _pack(np.abs(_bytes(a) - _bytes(b)))[..., 0]


def _dp4a(a, b, c=0):
    return c + (_bytes(a) * _bytes(b)).sum(-1)


def _window_words(planes, r0, c0):
    """Every (plane, row offset, column offset) window's words, (n_mb, 16
    rows, 4 words) each, and the MBs' regular mask.  r0 / c0 (n_mb, 4):
    the starts asked for offset 0 of each plane (one up and left of the
    middle start)."""
    n = len(r0)
    regular = np.ones(n, bool)
    for p, pl in enumerate(planes):
        L0, L1 = pl.shape
        my, mx = _wrap(r0[:, p] + 1), _wrap(c0[:, p] + 1)
        regular &= (my >= 1) & (my <= L0 - 17) & (mx >= 1) & (mx <= L1 - 17)
    Y = np.arange(16)
    out = {}
    for p, pl in enumerate(planes):
        L0, L1 = pl.shape
        # a regular MB: the 18 x 18 window from (r0, c0) as five words a
        # row, bytes 18 and 19 zero; a window word is a funnel shift
        st = np.zeros((n, 18, 20), np.int64)
        ok = np.flatnonzero(regular)
        rr = r0[ok, p][:, None] + np.arange(18)
        cc = c0[ok, p][:, None] + np.arange(18)
        st[ok, :, :18] = pl[rr[:, :, None], cc[:, None, :]]
        sw = _pack(st)  # (n, 18, 5)
        for ro in range(3):
            for co in range(3):
                lo = sw[:, ro + Y][:, :, :4]
                hi = sw[:, ro + Y][:, :, 1:5]
                staged = _funnelshift_r(lo, hi, 8 * co)
                # any MB: the window at its placed start
                ys = _slice_start(_wrap(r0[:, p] + ro), L0, 16)
                xs = _slice_start(_wrap(c0[:, p] + co), L1, 16)
                placed = _pack(pl[(ys[:, None] + Y)[:, :, None],
                                  (xs[:, None] + Y)[:, None, :]])
                out[p, ro, co] = np.where(regular[:, None, None], staged,
                                          placed)
    return out, regular


def _refine_lanes(cur_y, planes, int_mvx, int_mvy, lam):
    """The kernel's refinement: (mvx, mvy (n_mb,), pred_y (H, W), the
    regular mask, the costs (n_mb, 49))."""
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    mbs = np.arange(n_my * n_mx)
    y0, x0 = 16 * (mbs // n_mx), 16 * (mbs % n_mx)
    bvx = np.asarray(int_mvx, np.int64).reshape(-1)
    bvy = np.asarray(int_mvy, np.int64).reshape(-1)
    iy0, ix0 = _wrap(y0 + P + bvy), _wrap(x0 + P + bvx)
    qy0, qx0 = _wrap(iy0 - 2), _wrap(ix0 - 2)
    r0 = np.stack([_wrap(iy0 - 1)] + [_wrap(qy0 - 1)] * 3, 1)
    c0 = np.stack([_wrap(ix0 - 1)] + [_wrap(qx0 - 1)] * 3, 1)
    wins, regular = _window_words(planes, r0, c0)
    src = _pack(cur_y.reshape(n_my, 16, n_mx, 16).transpose(0, 2, 1, 3)
                .reshape(-1, 16, 16))
    words, costs = [], []
    for k in range(KCAND):
        a, b = _cand_of(k)
        w = wins[a] if a == b else _vavgu4(wins[a], wins[b])
        d = _vabsdiffu4(w, src)
        ssd = _dp4a(d, d).sum((1, 2))  # the lanes' __dp4a, then the warp
        mvx = torch.as_tensor(_wrap(bvx * 4 + k % 7 - 3), dtype=I32)
        mvy = torch.as_tensor(_wrap(bvy * 4 + k // 7 - 3), dtype=I32)
        rate = _lam_cost(int(lam), fast.mv_bits(mvx) + fast.mv_bits(mvy))
        costs.append(_wrap(ssd + rate.numpy().astype(np.int64)))
        words.append(w)
    costs = np.stack(costs, 1)
    k = _first_minimum(costs)
    pred = _bytes(np.stack(words, 1)[mbs, k]).reshape(n_my, n_mx, 16, 16)
    pred_y = pred.transpose(0, 2, 1, 3).reshape(H, W)
    return (_wrap(bvx * 4 + k % 7 - 3), _wrap(bvy * 4 + k // 7 - 3), pred_y,
            regular, costs)


def _first_minimum(costs):
    """The kernel's first minimum of (n, 49) costs: lane l holds the keys
    cost * 64 + k of k = l and l + 32, then the warp's least key; the key
    must fit int32."""
    key = costs * 64 + np.arange(KCAND)
    assert key.min() >= -2 ** 31 and key.max() < 2 ** 31 - 1
    n = costs.shape[0]
    hi = np.full((n, 32), 2 ** 31 - 1, np.int64)
    hi[:, :KCAND - 32] = key[:, 32:]
    return np.minimum(key[:, :32], hi).min(1) & 63


@functools.lru_cache(maxsize=None)
def _lam(qp):
    """The legacy encoder's lambda_me at `qp`."""
    return H264Encoder(EncoderConfig(width=16, height=16, qp=qp, fast=True,
                                     rd=False), device="cpu").lambda_mode_fx


def _inputs(case, W, H, R):
    """(cur (Y, U, V), (G, b, h, j, U pad, V pad)) as torch int32: a seeded
    second picture against the first one's state (b, h and j views of a
    K2 bank), or a built case."""
    if case == "seeded":
        fr = [[np.ascontiguousarray(np.asarray(p, np.int32)[:H >> k, :W >> k])
               for k, p in zip((0, 1, 1), f)]
              for f in moving_frames(2, max(W, 64), max(H, 64), seed=W + R)]
        ref = fast.ref_resources(*fr[0], device="cpu")
        return tuple(torch.as_tensor(p) for p in fr[1]), ref
    cur, ref = built_case(case, H, W, R, seed=R + 5)
    return (tuple(torch.as_tensor(x) for x in cur),
            tuple(torch.as_tensor(np.ascontiguousarray(x)) for x in ref))


def _check(cur, ref, mx, my, lam):
    got = _refine_lanes(cur[0].numpy(), [x.numpy() for x in ref[:4]], mx, my,
                        lam)
    want = fast.refine_plain(cur[0], *ref[:4], mx, my, lam)
    for g, w, name in zip(got, want, ("mvx", "mvy", "pred_y")):
        np.testing.assert_array_equal(g.reshape(w.shape), w.numpy(),
                                      err_msg=name)
    return got[3]


# (size, R): QCIF at R 8, 48x32 at R 28, and the edges case at R 32
RUNS = [((176, 144), 8), ((48, 32), 28)]


@pytest.mark.parametrize("case", ["seeded", *CASES])
@pytest.mark.parametrize("size,R", RUNS, ids=["qcif-r8", "48x32-r28"])
def test_refine_lanes_match_plain(case, size, R):
    """The packed-word refinement from the plain integer search's vectors,
    at the lambdas of QP 0, 28 and 51: every MB regular at R <= 28."""
    W, H = size
    cur, ref = _inputs(case, W, H, R)
    for qp in (0, 28, 51):
        mx, my, _ = fast.search_plain(cur[0], ref[0], R, _lam(qp))
        assert _check(cur, ref, mx, my, _lam(qp)).all()


def test_refine_lanes_at_r32_edges():
    """R 32 on the edges case: the border MBs' search vectors reach +-32,
    so windows at the top and left edges wrap to the far side and those at
    the bottom and right clamp; those MBs take the placed words."""
    W, H, R = 48, 32, 32
    cur, ref = _inputs("edges", W, H, R)
    for qp in (28, 51):
        mx, my, _ = fast.search_plain(cur[0], ref[0], R, _lam(qp))
        regular = _check(cur, ref, mx, my, _lam(qp))
        assert not regular.all()


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_refine_lanes_on_moving_windows(case):
    """Vectors that move windows: the top-left MB at -(R + 1) and the
    bottom-right one at R + 1 with R 32 (the b window a row past the
    bottom, the G window wrapping at the top), and vectors beyond the pad
    (+-40, +-200) and at the int32 extremes on the other MBs."""
    W, H, R = 48, 32, 32
    cur, ref = _inputs(case, W, H, R)
    for seed in range(3):
        mx, my = (torch.as_tensor(v) for v in moved_vectors(H, W, R, seed))
        regular = _check(cur, ref, mx, my, _lam(28))
        assert not regular[0] and not regular[-1]
    # vectors of exactly +-R reach one sample past the pad at the edges
    mx = torch.full((H // 16, W // 16), R, dtype=I32)
    assert not _check(cur, ref, mx, -mx, _lam(28)).all()


def test_first_minimum_key_orders_as_argmin():
    """The key cost * 64 + k gives numpy's first argmin on costs anywhere
    in (-2^25, 2^25): ties, negative costs and both ends."""
    rs = np.random.RandomState(3)
    lo, hi = -2 ** 25 + 1, 2 ** 25 - 1
    costs = np.concatenate([
        rs.randint(lo, hi, (2000, KCAND), dtype=np.int64),
        rs.randint(0, 4, (2000, KCAND)),  # many ties
        np.full((1, KCAND), hi), np.full((1, KCAND), lo),
        rs.choice([lo, hi, 0, -1], (500, KCAND))])
    np.testing.assert_array_equal(_first_minimum(costs),
                                  np.argmin(costs, 1))


def test_key_bound_for_every_input_the_wrapper_takes():
    """The bound behind the key: mv_bits is 2 bitlen - 1 with bitlen in
    0..32, so one vector component costs -1..63 bits on every int32 (the
    plain version's mv_bits at every bit length and both extremes), and
    for every int32 lambda (QP 51's, the encoder's largest, among them)
    lam_cost of -2..126 bits stays in -2^22 - 2 .. 2^22 + 126: a cost,
    the SSD (at most 256 x 255^2) plus that rate, lies in (-2^25, 2^25),
    so cost * 64 + k fits int32 for k < 64, at R 32 and for every vector
    beyond it."""
    d = torch.tensor(sorted({s * (2 ** i + e) for i in range(31)
                             for e in (-1, 0, 1) for s in (1, -1)}
                            | {2 ** 31 - 1, -2 ** 31}), dtype=I32)
    bits = fast.mv_bits(d)
    assert -1 <= int(bits.min()) and int(bits.max()) <= 63
    b = torch.arange(-2, 127, dtype=torch.int64)
    for lam in (-2 ** 31, -1, 0, _lam(51), 2 ** 31 - 1):
        rate = (lam >> 16) * b + (((lam & 0xFFFF) * b) >> 16)
        assert -2 ** 22 - 2 <= int(rate.min()) and int(rate.max()) <= (
            2 ** 22 + 126)
        for cost in (int(rate.min()), int(rate.max()) + 256 * 255 ** 2):
            assert -2 ** 25 < cost < 2 ** 25
            assert -2 ** 31 <= cost * 64 + KCAND - 1 < 2 ** 31


def test_plain_window_placement_is_dynamic_slice():
    """fast._window places a window where jax.lax.dynamic_slice does, for
    starts across both wraps and clamps of an axis of 40."""
    plane = np.arange(40 * 40, dtype=np.int32).reshape(40, 40)
    starts = np.arange(-90, 90, 7, dtype=np.int32)
    got = fast._window(torch.as_tensor(plane), torch.as_tensor(starts),
                       torch.as_tensor(starts[::-1].copy()), 16).numpy()
    ds = jax.jit(lambda p, y, x: jax.lax.dynamic_slice(p, (y, x), (16, 16)))
    for i, (y, x) in enumerate(zip(starts, starts[::-1])):
        want = np.asarray(ds(jnp.asarray(plane), jnp.int32(y), jnp.int32(x)))
        np.testing.assert_array_equal(got[i], want, err_msg=f"{y}, {x}")


def test_constants_match_the_kernel():
    """The emulation's candidate count and staged window are the
    kernel's: 49 candidates, 18 x 18 samples a plane."""
    import pathlib
    import re

    src = (pathlib.Path(fast.__file__).parent.parent / "csrc"
           / "p16_refine.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                            src)}
    assert (got["kCand"], got["kSr"]) == (KCAND, 18)
