"""Built inputs of the loss-aware RDO's drift step (kernel K11,
``propagate_drift``): seeded numpy arrays that reach what an encode seldom
does, for holding the kernel against its plain version on the card
(``chip_smoke.py``, ``tests/test_torch_kernels.py``) and the plain version
against the reference package on the CPU (``tests/test_torch_lossaware.py``).

Each case is (drift (K, H, W) int32, frame_delta (H, W) int32, mv4
(H/4, W/4, 2) int32, intra4 (H/4, W/4) bool, lost (K,) bool):
- ``seeded``: |drift| to 255 everywhere, random motion, intra blocks and
  losses (every per-decoder MB sum exact in float32, the decoder sum not);
- ``large``: |drift| to 4095 on one sample in 20, so that the MB sums pass
  2^24 and round while the penalty stays under its 2^30 clip;
- ``wrap``: |drift| to 60000 on one sample in 100, whose squares wrap as
  int32, every picture lost (the large values kept);
- ``edges``: motion of up to 3 pictures' size, every 4x4 block's gather
  clipped, on every side of the picture;
- ``all_lost``, ``none_lost``, ``all_intra``: the three branches alone;
- ``threshold``: each MB's total over the K decoders of the new drift's
  squares set exactly (``THRESHOLD_TOTALS``, in turn): 2^24 - 1, 2^24 and
  2^24 + 1, and beside them, so that the kernel's order-free route (exact
  totals up to 2^24) and its ordered one both run in one call; no motion,
  no intra, a zero delta, so the new drift is the drift.
"""

from __future__ import annotations

import numpy as np

CASES = ("seeded", "large", "wrap", "edges", "all_lost", "none_lost",
         "all_intra", "threshold")
# the ``threshold`` case's MB totals, MB m taking entry m % 9
THRESHOLD_TOTALS = tuple(2 ** 24 + d for d in (-1, 0, 1, -2, 2, -100, 100)) + (
    2 ** 23, 2 ** 25)


def _threshold_drift(rng, H: int, W: int, K: int):
    """Drift (K, H, W) whose MB m has sum of squares THRESHOLD_TOTALS[m % 9]:
    `cap` (at most 4095, at least what fits the MB's K x 256 samples) as
    often as it fits, then greedy squares, at random samples with random
    signs."""
    n_my, n_mx = H // 16, W // 16
    mbs = np.zeros((n_my * n_mx, K * 256), np.int64)
    for m in range(n_my * n_mx):
        rem = THRESHOLD_TOTALS[m % len(THRESHOLD_TOTALS)]
        cap = int(rng.integers(int(np.sqrt(rem // (K * 256 - 16))) + 1, 4096))
        vals = [cap] * (rem // (cap * cap))
        rem -= len(vals) * cap * cap
        while rem:
            v = int(np.sqrt(rem))
            v -= v * v > rem
            vals.append(v)
            rem -= v * v
        at = rng.choice(K * 256, len(vals), replace=False)
        mbs[m, at] = np.array(vals) * rng.choice([-1, 1], len(vals))
    return mbs.reshape(n_my, n_mx, K, 16, 16).transpose(2, 0, 3, 1, 4).reshape(
        K, H, W).astype(np.int32)


def built_case(name: str, H: int, W: int, K: int, seed: int = 0):
    """The case `name` at H x W with K decoders (module docstring)."""
    rng = np.random.default_rng([seed, H, W, K, CASES.index(name)])
    amp, dens = {"large": (4095, 0.05), "wrap": (60000, 0.01)}.get(
        name, (255, 1.0))
    drift = (rng.integers(-amp, amp + 1, (K, H, W))
             * (rng.random((K, H, W)) < dens)).astype(np.int32)
    delta = rng.integers(-255, 256, (H, W)).astype(np.int32)
    if name == "threshold":
        lost = rng.random(K) < 0.4
        return (_threshold_drift(rng, H, W, K), np.zeros((H, W), np.int32),
                np.zeros((H // 4, W // 4, 2), np.int32),
                np.zeros((H // 4, W // 4), bool), lost)
    if name == "edges":  # quarter-pel, far past every side
        mv4 = rng.integers(-12 * max(H, W), 12 * max(H, W) + 1,
                           (H // 4, W // 4, 2)).astype(np.int32)
    else:
        mv4 = rng.integers(-256, 257, (H // 4, W // 4, 2)).astype(np.int32)
    intra4 = rng.random((H // 4, W // 4)) < (
        1.0 if name == "all_intra" else 0.2)
    lost = rng.random(K) < 0.4
    if name in ("all_lost", "wrap"):
        lost[:] = True
    elif name in ("none_lost", "all_intra", "edges"):
        lost[:] = False
    return drift, delta, mv4, intra4, lost


def ordered_route(new):
    """(n_mb,) bool: the MBs of new drift `new` (K, H, W; numpy or a torch
    tensor on any device) that K11 sends on its ordered route: a square
    that wraps negative as int32, or an exact total of the squares over
    the K decoders above 2^24.  Numpy in, numpy out."""
    import torch

    K, H, W = new.shape
    x = torch.as_tensor(new).to(torch.int64)
    e = (x * x + 2 ** 31) % 2 ** 32 - 2 ** 31  # the int32 square
    e = e.reshape(K, H // 16, 16, W // 16, 16).permute(1, 3, 0, 2, 4)
    e = e.reshape((H // 16) * (W // 16), -1)
    out = (e < 0).any(1) | (e.clamp(min=0).sum(1) > 2 ** 24)
    return out.numpy() if isinstance(new, np.ndarray) else out


def clipped_sides(mv4, H: int, W: int) -> dict:
    """How many samples' gathers the clip moves, per side of the picture
    (top, bottom, left, right)."""
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    mvx = np.repeat(np.repeat(mv4[..., 0], 4, 0), 4, 1)
    mvy = np.repeat(np.repeat(mv4[..., 1], 4, 0), 4, 1)
    gy = ys + ((mvy + 2) >> 2)
    gx = xs + ((mvx + 2) >> 2)
    return {"top": int((gy < 0).sum()), "bottom": int((gy > H - 1).sum()),
            "left": int((gx < 0).sum()), "right": int((gx > W - 1).sum())}
