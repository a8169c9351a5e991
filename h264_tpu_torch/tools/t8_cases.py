"""Built inputs of the T8 decision (K9, ``rd_p.t8_decide_plain``): the
cases a recorded picture may not reach.

- ``qp0_bound``: at QP 0, +-255 residuals whose signs follow the basis
  product of each 8x8 coefficient position (one position per 8x8 block,
  all 64 of them), so every position reaches its largest level (3264 at
  the DC) and the butterflies' shifts act on negative intermediates;
- ``ties``: zero residuals with a 4x4 recon equal to the source and no
  levels, where D_8 = D_4 = 0 and the bits tie, so 4x4 must stay;
- ``classes``: every winner class (each inter partition, skip, P16PMV,
  I16, I4's code and P8x8 with and without sub-8x8 units) with a 4x4
  recon far from the source, so the 8x8 transform pays wherever it is
  allowed.

``built_cases(n_mb, seed)`` returns [(name, (orig_mb, w_pred, w_rec,
w_lev, win, w_sub, is_intra), qp, lam)] as numpy arrays (int32, is_intra
bool); ``n_mb`` (at least 16) sets the size of the last two cases.
``sized_case(n_mb, seed, qp)`` is one seeded case of any number of MBs
(``MB_COUNTS``: counts that are not a multiple of the kernel's MBs a
block, and 1280x720's 3600), where both transforms win.
"""

from __future__ import annotations

import numpy as np

from ..encoder import rd_p
from ..ops import transforms as TR


def _lam(qp: int) -> int:
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def basis_signs() -> np.ndarray:
    """(64, 8, 8): per coefficient position k the sign pattern (+-1) of the
    forward 8x8 transform's basis, which maximises |coefficient k|."""
    import torch

    eye = torch.eye(64, dtype=torch.int32).reshape(64, 8, 8) * 64
    basis = TR.forward8x8(eye).numpy().reshape(64, 64)  # [input, output]
    return np.where(basis.T > 0, 1, -1).reshape(64, 8, 8)


# MB counts of ``sized_case``: one MB, a block's MBs and more, CIF's 396
# and one, 1280x720's
MB_COUNTS = (1, 5, 397, 3600)


def sized_case(n_mb: int, seed: int, qp: int = 28):
    """(name, arrays, qp, lam) of n_mb seeded MBs: every winner class,
    sub-8x8 units on some P8x8 ones, residuals of +-2 to +-40, and a 4x4
    recon and levels of their own error and density per MB, so that the
    8x8 transform wins on some eligible MBs and loses on others."""
    rng = np.random.RandomState([seed, n_mb, qp])
    orig = rng.randint(0, 256, (n_mb, 16, 16))
    amp = rng.randint(2, 41, (n_mb, 1, 1))
    pred = np.clip(orig + rng.randint(-40, 41, orig.shape) * amp // 40,
                   0, 255)
    err = rng.randint(0, 13, (n_mb, 1, 1))
    rec = np.clip(orig + rng.randint(-12, 13, orig.shape) * err // 12, 0, 255)
    dens = rng.random_sample((n_mb, 1, 1, 1, 1))
    lev = rng.randint(-3, 4, (n_mb, 4, 4, 4, 4)) * (
        rng.random_sample((n_mb, 4, 4, 4, 4)) < dens)
    win = rng.randint(0, 8, n_mb)  # C_P16x16 .. C_I4
    sub = rng.randint(0, 4, (n_mb, 4)) * (rng.random_sample((n_mb, 4)) < 0.3)
    intra = (win == rd_p.C_I16) | (win == rd_p.C_I4)
    return (f"sized_{n_mb}", (_i32(orig), _i32(pred), _i32(rec), _i32(lev),
                              _i32(win), _i32(sub), intra), qp, _lam(qp))


def built_cases(n_mb: int, seed: int):
    rng = np.random.RandomState(seed)
    cases = []
    # QP 0, +-255: 16 MBs, their 64 8x8 blocks one basis pattern each
    s = basis_signs().reshape(16, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4)
    s = s.reshape(16, 16, 16)
    orig = np.where(s > 0, 255, 0)
    pred = 255 - orig
    lev = rng.randint(-2, 3, (16, 4, 4, 4, 4))
    cases.append(("qp0_bound", (
        orig, pred, pred, lev, np.full(16, rd_p.C_P16x16),
        np.zeros((16, 4)), np.zeros(16, bool)), 0, _lam(0)))
    # zero residuals: every MB ties
    orig = rng.randint(0, 256, (n_mb, 16, 16))
    win = rng.choice([rd_p.C_P16x16, rd_p.C_P16x8, rd_p.C_P8x16,
                      rd_p.C_P8x8, rd_p.C_P16PMV], n_mb)
    cases.append(("ties", (orig, orig, orig, np.zeros((n_mb, 4, 4, 4, 4)),
                           win, np.zeros((n_mb, 4)), np.zeros(n_mb, bool)),
                  28, _lam(28)))
    # every winner class; the 4x4 recon far off, no 4x4 levels
    orig = rng.randint(0, 256, (n_mb, 16, 16))
    pred = np.clip(orig + rng.randint(-20, 21, orig.shape), 0, 255)
    win = np.arange(n_mb) % 8  # C_P16x16 .. C_I4
    sub = np.zeros((n_mb, 4))
    sub[(win == rd_p.C_P8x8) & (np.arange(n_mb) % 16 < 8), 1] = 2
    for qp in (28, 51):
        cases.append((f"classes_qp{qp}", (
            orig, pred, np.zeros_like(orig), np.zeros((n_mb, 4, 4, 4, 4)),
            win, sub, win == rd_p.C_I16), qp, _lam(qp)))
    return [(name, tuple(a if a.dtype == bool else _i32(a) for a in arrs),
             qp, lam) for name, arrs, qp, lam in cases]
