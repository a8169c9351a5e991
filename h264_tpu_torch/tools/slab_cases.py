"""Built row slabs of the sharded GOP encoder's reference bank
(``parallel.sharded``, K2 ``ref_bank_rows``).

``built_slab(content, Hg, W, r, n_row)`` cuts row shard r of an n_row x
Hg-line picture (random or 0/255 samples) and extends it as
``halo.exchange`` does, in numpy: min(PAD, h) rows of each neighbour
around it, the outer shards' edge row repeated on their open side, zero
rows beyond.  With Hg < 2 PAD the chroma slab (Hg / 2 lines) has zero
rows, and with Hg < PAD the luma slab too.  The tests hold the bank's
plain version against the reference's ``_bank_from_pad`` on them, and
``chip_smoke.py`` and the ``gpu`` tests the kernel against its plain
version.
"""

from __future__ import annotations

import numpy as np

PAD = 32
CONTENTS = ("random", "0_255")


def extend(plane: np.ndarray, r: int, h: int, pad: int = PAD) -> np.ndarray:
    """Rows [r h, r h + h) of `plane` extended as ``halo.exchange``
    extends a shard's slab: (h + 2 pad, w)."""
    n = min(pad, h)
    top, bot = r * h, r * h + h
    above = plane[top - n: top] if top else np.repeat(plane[:1], n, 0)
    below = (plane[bot: bot + n] if bot < len(plane)
             else np.repeat(plane[-1:], n, 0))
    zeros = np.zeros((pad - n, plane.shape[1]), plane.dtype)
    return np.concatenate([zeros, above, plane[top: bot], below, zeros])


def built_slab(content: str, Hg: int, W: int, r: int, n_row: int,
               seed: int = 3):
    """(extY (Hg + 2 PAD, W), extU, extV (Hg/2 + 2 PAD, W/2)) int32 of row
    shard r of n_row."""
    rng = np.random.default_rng(seed + 17 * r + Hg)
    H = Hg * n_row
    planes = [rng.integers(0, 256, s) for s in
              ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    if content == "0_255":
        planes = [255 * (p & 1) for p in planes]
    return tuple(extend(p.astype(np.int32), r, h)
                 for p, h in zip(planes, (Hg, Hg // 2, Hg // 2)))
