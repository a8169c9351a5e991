"""The premise of K11's order-free route (``csrc/propagate_drift.cu``),
on the CPU, exactly.

The penalty of an MB is a float32 sum of the K x 256 terms float32(new *
new) (the square wraps as int32), taken in the reference's order
(``lossaware.drift_energy``), times float32(1 / K).  Where every term is a
non-negative integer and the exact total is at most 2^24, every partial
sum of any order is an integer that float32 holds exactly, so the ordered
sum is the total.  The kernel adds each thread's terms (a 4-sample row
segment of the MB, decoders t / 64, t / 64 + 4, ...) in unsigned 32 bits
saturating at 2^25, sums its warps, and takes the route where no term is
negative and the total is at most 2^24; there the penalty is
trunc(float32(total) * float32(1 / K)).  Held here: that rule, with the
kernel's partition and saturation, picks the MBs
``tools/drift_cases.ordered_route`` leaves, and equals ``drift_energy`` on
each MB it takes: totals of 2^24 - 1 and 2^24 (taken) and 2^24 + 1 (not),
wrapped negative terms (not taken), squares that wrap to 0 (taken), and
the ``seeded``, ``large``, ``wrap`` and ``threshold`` cases; and, at 48x32
with 8 decoders (the specialization test_torch_lossaware.py compiles),
the reference's ``propagate_drift``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import lossaware as JLA
from h264_tpu_torch.encoder import lossaware as TLA
from h264_tpu_torch.tools.drift_cases import (THRESHOLD_TOTALS, built_case,
                                              ordered_route)

torch.set_num_threads(1)

EXACT, CAP = 2 ** 24, 2 ** 25


def kernel_rule(new):
    """(taken (n_mb,) bool, penalty where taken (n_mb,) int64) as the
    kernel's threads, warps and block compute them."""
    K, H, W = new.shape
    n_mb = (H // 16) * (W // 16)
    x = np.asarray(new, np.int64)
    e = (x * x + 2 ** 31) % 2 ** 32 - 2 ** 31
    # (n_mb, K, 16 rows, 4 segments, 4 samples)
    e = e.reshape(K, H // 16, 16, W // 16, 4, 4).transpose(1, 3, 0, 2, 4, 5)
    e = e.reshape(n_mb, K, 64, 4)
    neg = (e < 0).any((1, 2, 3))
    acc = np.zeros((n_mb, 256), np.int64)  # thread t = 64 g + segment
    for k in range(K):  # saturating adds of the non-negative terms
        for i in range(4):
            t = 64 * (k % 4) + np.arange(64)
            acc[:, t] = np.minimum(acc[:, t] + np.maximum(e[:, k, :, i], 0),
                                   CAP)
    assert acc.max() < 2 ** 32
    warps = np.minimum(acc.reshape(n_mb, 8, 32).sum(-1), CAP)
    assert warps.max() <= 32 * CAP < 2 ** 32
    total = warps.sum(-1)
    taken = ~neg & (total <= EXACT)
    inv_k = np.float32(1.0) / np.float32(K)
    pen = (total.astype(np.float32) * inv_k).astype(np.int64)
    return taken, pen


def _check(new):
    taken, pen = kernel_rule(new)
    assert (taken == ~ordered_route(new)).all()
    want = TLA.drift_energy(torch.as_tensor(np.asarray(new, np.int32)))
    assert (pen[taken] == want.numpy()[taken]).all()
    return taken


@pytest.mark.parametrize("K", [1, 3, 8, 30])
def test_threshold_totals(K):
    """MB totals 2^24 - 1 and 2^24 take the rule, 2^24 + 1 does not; the
    rule equals the ordered sum wherever it is taken."""
    new = built_case("threshold", 48, 64, K, seed=1)[0]
    taken = _check(new)
    totals = np.array([THRESHOLD_TOTALS[m % 9] for m in range(12)])
    assert (taken == (totals <= EXACT)).all()
    assert {2 ** 24 - 1, 2 ** 24} <= set(totals[taken])
    assert 2 ** 24 + 1 in set(totals[~taken])


def test_wrapped_squares():
    """A square past 2^31 wraps negative and sends its MB on the ordered
    route; one of 65536 wraps to 0 and does not."""
    new = np.zeros((3, 32, 32), np.int32)
    new[0, 3, 5] = 46341  # 46341^2 > 2^31 - 1
    new[1, 20, 7] = -50000
    new[2, 9, 30] = 65536  # 2^32: the int32 square is 0
    new[2, 9, 29] = 7
    new[1, 25, 25] = 4000
    taken = _check(new)
    assert taken.tolist() == [False, True, False, True]


@pytest.mark.parametrize("case", ["seeded", "large", "wrap", "threshold"])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("H,W", [(32, 48), (144, 176)], ids=lambda v: str(v))
def test_rule_equals_ordered_sum(H, W, K, case):
    args = built_case(case, H, W, K, seed=3)
    new, _ = TLA.propagate_drift_plain(*(torch.as_tensor(a) for a in args))
    taken = _check(new.numpy())
    if case == "wrap":
        assert not taken.all()


@pytest.mark.parametrize("case,K", [("threshold", 8), ("seeded", 1)])
def test_rule_equals_reference(case, K):
    """The rule's penalty equals the reference's wherever it is taken (48x32
    with 8 decoders and with 1, shapes test_torch_lossaware.py compiles)."""
    args = built_case(case, 32, 48, K, seed=3)
    new, pen = JLA.propagate_drift(*(jnp.asarray(a) for a in args), H=32,
                                   W=48)
    taken, rule = kernel_rule(np.asarray(new))
    assert taken.any()
    assert (rule[taken] == np.asarray(pen)[taken]).all()
