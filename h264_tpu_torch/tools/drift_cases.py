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
- ``all_lost``, ``none_lost``, ``all_intra``: the three branches alone.
"""

from __future__ import annotations

import numpy as np

CASES = ("seeded", "large", "wrap", "edges", "all_lost", "none_lost",
         "all_intra")


def built_case(name: str, H: int, W: int, K: int, seed: int = 0):
    """The case `name` at H x W with K decoders (module docstring)."""
    rng = np.random.default_rng([seed, H, W, K, CASES.index(name)])
    amp, dens = {"large": (4095, 0.05), "wrap": (60000, 0.01)}.get(
        name, (255, 1.0))
    drift = (rng.integers(-amp, amp + 1, (K, H, W))
             * (rng.random((K, H, W)) < dens)).astype(np.int32)
    delta = rng.integers(-255, 256, (H, W)).astype(np.int32)
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
