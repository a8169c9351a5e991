"""Deterministic benchmark sequence synthesis.

The reference tree ships only 3 QCIF frames (bin/foreman_part_qcif.yuv),
which is not credible benchmark content: with num_ref_frames >= 3 a
looped 3-frame source lets every inter frame find a reference with
identical source content, deflating residual energy and bitrate.

This module synthesizes a NON-REPEATING sequence with realistic video
statistics from that texture, fully deterministically (no RNG state
leaks; everything derives from a fixed seed):

- a 2x2 "world" mosaic built from the 3 foreman frames (the 4th tile is
  a mirrored copy), giving a 704x576 luma world at CIF output size;
- a smooth camera path (pan + slow zoom) sampled with sub-pixel
  bilinear interpolation -> global motion with fractional MVs;
- a foreground patch moving against the camera -> occlusion + local
  motion;
- light deterministic film grain -> nonzero residuals everywhere
  (honest entropy-coding load);
- a linear fade over the last quarter -> weighted-prediction material.

Both lencod (the baseline) and our encoder consume the *same* YUV file
written by `write_yuv`, so the comparison is content-identical.
"""

from __future__ import annotations

import os

import numpy as np

# the 3-frame clip of the JM reference tree, where the reference package's
# benchseq reads it (its FOREMAN); no fallback when it is absent, as there
FOREMAN = os.path.join(os.sep, "root", "reference", "bin",
                       "foreman_part_qcif.yuv")


def _load_foreman():
    raw = open(FOREMAN, "rb").read()
    W, H = 176, 144
    fs = W * H * 3 // 2
    out = []
    for i in range(3):
        o = i * fs
        Y = np.frombuffer(raw[o : o + W * H], np.uint8).reshape(H, W)
        U = np.frombuffer(raw[o + W * H : o + W * H * 5 // 4], np.uint8)
        V = np.frombuffer(raw[o + W * H * 5 // 4 : o + fs], np.uint8)
        out.append(
            (Y, U.reshape(H // 2, W // 2), V.reshape(H // 2, W // 2))
        )
    return out


def _up2(p):
    return np.repeat(np.repeat(p, 2, 0), 2, 1)


def _world(w, h):
    """Mosaic world planes at (2h, 2w) luma / (h, w) chroma."""
    f = _load_foreman()
    t0, t1, t2 = (_up2(x[0]) for x in f)
    t3 = t1[:, ::-1]

    def fit(t, hh, ww):
        ry = np.clip((np.arange(hh) * t.shape[0]) // hh, 0, t.shape[0] - 1)
        rx = np.clip((np.arange(ww) * t.shape[1]) // ww, 0, t.shape[1] - 1)
        return t[np.ix_(ry, rx)]

    Y = np.block(
        [[fit(t0, h, w), fit(t1, h, w)], [fit(t2, h, w), fit(t3, h, w)]]
    ).astype(np.float32)
    u0, u1, u2 = (x[1] for x in f)
    v0, v1, v2 = (x[2] for x in f)
    U = np.block(
        [
            [fit(u0, h // 2, w // 2), fit(u1, h // 2, w // 2)],
            [fit(u2, h // 2, w // 2), fit(u1[:, ::-1], h // 2, w // 2)],
        ]
    ).astype(np.float32)
    V = np.block(
        [
            [fit(v0, h // 2, w // 2), fit(v1, h // 2, w // 2)],
            [fit(v2, h // 2, w // 2), fit(v1[:, ::-1], h // 2, w // 2)],
        ]
    ).astype(np.float32)
    return Y, U, V


def _bilinear(img, ys, xs):
    h, w = img.shape
    ys = np.clip(ys, 0.0, h - 1.001)
    xs = np.clip(xs, 0.0, w - 1.001)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, np.minimum(x0 + 1, w - 1))]
    c = img[np.ix_(np.minimum(y0 + 1, h - 1), x0)]
    d = img[np.ix_(np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1))]
    return (
        a * (1 - fy) * (1 - fx)
        + b * (1 - fy) * fx
        + c * fy * (1 - fx)
        + d * fy * fx
    )


def make_sequence(n=100, w=352, h=288, seed=7, fade=True):
    """Return a list of n (Y, U, V) uint8 planes, CIF 4:2:0 by default."""
    WY, WU, WV = _world(w, h)
    rng = np.random.default_rng(seed)
    grain = [rng.normal(0.0, 1.2, (h, w)).astype(np.float32) for _ in range(8)]
    # foreground patch texture (from tile 2) + its own grain-free copy
    ph, pw = h // 4, w // 4
    patch = WY[h : h + ph, :pw].copy()
    frames = []
    t = np.arange(n, dtype=np.float64)
    # camera: smooth pan covering ~half of the world + gentle zoom
    cx = (w / 2) + (w / 2 - 8) * (0.5 - 0.5 * np.cos(2 * np.pi * t / n))
    cy = (h / 2) + (h / 2 - 8) * (0.5 - 0.5 * np.cos(2 * np.pi * t / (n * 1.7)))
    zoom = 1.0 + 0.12 * np.sin(2 * np.pi * t / n)
    for i in range(n):
        sy = zoom[i]
        ys = cy[i] + (np.arange(h) - h / 2) * sy
        xs = cx[i] + (np.arange(w) - w / 2) * sy
        Y = _bilinear(WY, ys, xs)
        U = _bilinear(WU, ys[::2] / 2.0, xs[::2] / 2.0)
        V = _bilinear(WV, ys[::2] / 2.0, xs[::2] / 2.0)
        # foreground object on an independent diagonal track
        ox = int((w - pw - 16) * (0.5 + 0.5 * np.sin(2 * np.pi * (i / n) * 2.3)))
        oy = int((h - ph - 16) * (i / max(n - 1, 1)))
        Y[oy : oy + ph, ox : ox + pw] = patch
        Y += grain[i % len(grain)]
        if fade and i >= (3 * n) // 4:
            g = 1.0 - 0.4 * (i - 3 * n // 4) / max(n - 3 * n // 4 - 1, 1)
            Y *= g
            U = (U - 128.0) * g + 128.0
            V = (V - 128.0) * g + 128.0
        frames.append(
            (
                np.clip(Y + 0.5, 0, 255).astype(np.uint8),
                np.clip(U + 0.5, 0, 255).astype(np.uint8),
                np.clip(V + 0.5, 0, 255).astype(np.uint8),
            )
        )
    return frames


def write_yuv(frames, path):
    with open(path, "wb") as f:
        for Y, U, V in frames:
            f.write(Y.tobytes())
            f.write(U.tobytes())
            f.write(V.tobytes())


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = (d * d).mean()
    return 99.0 if mse == 0 else 10 * np.log10(255.0**2 / mse)


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta-rate (%%) of curve 2 vs curve 1 (negative =
    curve 2 needs fewer bits at equal PSNR). r: kbps, p: PSNR dB."""
    lr1, lr2 = np.log(np.asarray(r1, np.float64)), np.log(
        np.asarray(r2, np.float64)
    )
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo, hi = max(p1.min(), p2.min()), min(p1.max(), p2.max())
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    a1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    a2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return float((np.exp(a2 - a1) - 1.0) * 100.0)
