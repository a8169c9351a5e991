"""The port's one boundary-strength function (K6 ``strengths``'s plain
version, h264_tpu_torch/encoder/strengths.py) against the JAX package, on
the CPU, exact equality: against ``strengths_full`` on P fields in rd_p's
layout (with the 8x8 transform's fields and odd-edge zeroing), against
``strengths_full_b`` on B fields (test_torch_b_ops.py holds those), and
against the legacy ``fast.strengths_device_p`` on the legacy glue's
fields; on seeded fields and on the built inputs of
tools/strengths_cases.py, which take every branch of the rule.  Also: the
P rule is the two-list rule with list 1 absent and the index as the
reference id; every layout reads the same blocks; the kernel wrapper's
combined test takes the P, B and legacy glue's fields as they are and
rejects what the kernel does not take."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import fast as JF
from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import fast as TF
from h264_tpu_torch.encoder import rd_b as TB
from h264_tpu_torch.encoder import strengths as TS
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.kernels import deblock as K6
from h264_tpu_torch.tools.strengths_cases import (BRANCHES_1, branches,
                                                  strengths_inputs)
from h264_tpu_torch.tools.synthseq import moving_frames

SIZES = [(3, 4), (9, 11), (18, 22)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _R(x, n_my, n_mx):
    return TS.raster(x, n_my, n_mx, "field")[..., 0].numpy()


def strengths_p_reference(args):
    """The reference's strengths_full on the per-4x4 planes rd_p_pipeline
    builds (rd.py:1124-1156) from the P fields `args` of the port's
    function, with its T8 odd-edge zeroing."""
    n_my, n_mx, coef, intra, ref0, mvx, mvy, coef8, t8 = args[:9]
    lev = coef.numpy()
    nz4 = (lev != 0).any((-1, -2))
    if coef8 is not None:
        nz8 = (coef8.numpy() != 0).any((-1, -2))
        nz4 = nz4 | np.repeat(np.repeat(nz8, 2, -1), 2, -2)
    nz4 = nz4.reshape(n_my, n_mx, 4, 4).transpose(0, 2, 1, 3).reshape(
        4 * n_my, 4 * n_mx)
    bsv, bsh = (np.asarray(x) for x in JRD.strengths_full(*map(
        jnp.asarray, (nz4, _R(mvx, n_my, n_mx), _R(mvy, n_my, n_mx),
                      _R(ref0, n_my, n_mx), _R(intra, n_my, n_mx)))))
    if t8 is not None:
        t8p = _R(t8, n_my, n_mx) > 0
        bsv = np.where(t8p & (np.arange(4 * n_mx) % 2 == 1)[None], 0, bsv)
        bsh = np.where(t8p & (np.arange(4 * n_my) % 2 == 1)[:, None], 0, bsh)
    return bsv, bsh


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _p_fields(n_my, n_mx, seed, t8):
    """Seeded P fields in rd_p's layout: per-MB intra, per-unit reference
    indices, per-block mvs, the MBs' 4x4 levels (zero in 8x8-transform
    MBs) and, with `t8`, the 8x8 levels and flags."""
    rs = np.random.RandomState(seed)
    n_mb = n_my * n_mx
    intra = rs.rand(n_mb) < 0.15
    lev = np.where(rs.rand(n_mb, 4, 4, 4, 4) < 0.02,
                   rs.randint(-2, 3, (n_mb, 4, 4, 4, 4)), 0).astype(np.int32)
    ref = rs.randint(0, 3, (n_mb, 4)).astype(np.int32)
    mvx, mvy = (rs.randint(-6, 7, (n_mb, 4, 4)).astype(np.int32)
                for _ in range(2))
    coef8 = t8f = None
    if t8:
        t8m = (rs.rand(n_mb) < 0.4) & ~intra
        lev[t8m] = 0
        lev8 = np.where(rs.rand(n_mb, 2, 2, 8, 8) < 0.01,
                        rs.randint(-2, 3, (n_mb, 2, 2, 8, 8)), 0)
        lev8[~t8m] = 0
        coef8, t8f = _t(lev8.astype(np.int32)), _t(t8m.astype(np.int32))
    return (n_my, n_mx, _t(lev), _t(intra), _t(ref), _t(mvx), _t(mvy), coef8,
            t8f)


@pytest.mark.parametrize("t8", [False, True], ids=["4x4", "t8"])
@pytest.mark.parametrize("n_my,n_mx", SIZES, ids=str)
def test_p_fields_match_reference(n_my, n_mx, t8):
    args = _p_fields(n_my, n_mx, n_my * 7 + n_mx, t8)
    _eq(TS.strengths_plain(*args), strengths_p_reference(args))


@pytest.mark.parametrize("t8", [False, True], ids=["4x4", "t8"])
@pytest.mark.parametrize("n_my,n_mx", SIZES[1:], ids=str)
def test_p_built_inputs_reach_every_branch(n_my, n_mx, t8):
    """The built one-list inputs the card's check uses: equal to the
    reference, every branch taken (the odd-edge zeroing with the 8x8
    transform), each branch's count matched to the bS."""
    args = strengths_inputs(n_my, n_mx, n_my + n_mx, "cpu", lists=1, t8=t8)
    got = TS.strengths_plain(*args)
    _eq(got, strengths_p_reference(args))
    n = branches(args)
    assert set(n) == set(BRANCHES_1)
    assert min(v for k, v in n.items() if t8 or k != "t8_odd") > 0, n
    assert (n["t8_odd"] > 0) == t8
    bs = np.concatenate([got[0][:, 1:].reshape(-1).numpy(),
                         got[1][1:, :].reshape(-1).numpy()])
    assert [int((bs == b).sum()) for b in range(5)] == [
        n["straight_mv_small"] + n["t8_odd"],
        n["unmatched"] + n["straight_mv_large"], n["coefficients"],
        n["intra_inside"], n["intra_mb_edge"]]


def _legacy_fields(n_my, n_mx, seed):
    """The legacy picture's fields: 4x4 levels in raster (4 n_my, 4 n_mx,
    4, 4) and per-MB mvs within +-6 of each other."""
    rs = np.random.RandomState(seed)
    lev = np.where(rs.rand(4 * n_my, 4 * n_mx, 4, 4) < 0.03,
                   rs.randint(-2, 3, (4 * n_my, 4 * n_mx, 4, 4)), 0)
    mvx, mvy = (rs.randint(-6, 7, (n_my, n_mx)).astype(np.int32) + 40
                for _ in range(2))
    return lev.astype(np.int32), mvx, mvy


@pytest.mark.parametrize("n_my,n_mx", SIZES, ids=str)
def test_legacy_fields_match_reference(n_my, n_mx):
    lev, mvx, mvy = _legacy_fields(n_my, n_mx, n_my + 3 * n_mx)
    nz4 = (lev != 0).any((-1, -2))
    want = JF.strengths_device_p(*map(jnp.asarray, (nz4, mvx, mvy)))
    got = TF.strengths_device_p(_t(lev), _t(mvx), _t(mvy))
    _eq(got, want)
    assert {0, 1, 2} <= set(np.unique(np.asarray(want[0])))


@pytest.mark.parametrize("t8", [False, True], ids=["4x4", "t8"])
@pytest.mark.parametrize("n_my,n_mx", SIZES[1:], ids=str)
def test_p_rule_is_the_two_list_rule_with_list_1_absent(n_my, n_mx, t8):
    """Over every branch of the one-list rule: the P fields with one list
    give the two-list rule's strengths with list 1 unused (mvs 0) and
    list 0's id the index itself (POC table 0, 1, 2, ...); and the
    reference's strengths_full equals its strengths_full_b so."""
    args = strengths_inputs(n_my, n_mx, 3 * n_my + n_mx, "cpu", lists=1,
                            t8=t8)
    n_mx_, intra, ref0 = args[1], args[3], args[4]
    n_mb = n_my * n_mx_
    nr = int(ref0.max()) + 1
    zeros = torch.zeros(n_mb, dtype=torch.int32)
    two = (*args[:9], torch.arange(nr, dtype=torch.int32),
           (~intra)[:, None].expand(n_mb, 4).contiguous(), zeros, zeros,
           torch.zeros(n_mb, dtype=torch.bool), -5)
    _eq(TS.strengths_plain(*args), TS.strengths_plain(*two))
    R = functools.partial(_R, n_my=n_my, n_mx=n_mx)
    nz4 = TS.coded(args[2], args[7], n_my, n_mx).numpy()
    intra4 = R(intra)
    z = np.zeros_like(R(ref0))
    p_rule = JRD.strengths_full(*map(jnp.asarray, (
        nz4, R(args[5]), R(args[6]), R(ref0), intra4)))
    b_rule = JRD.strengths_full_b(*map(jnp.asarray, (
        nz4, intra4, ~intra4, R(ref0), R(args[5]), R(args[6]),
        np.zeros_like(intra4), z, z, z)))
    for a, b in zip(p_rule, b_rule):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_layouts_read_the_same_blocks():
    """A per-block raster field given per MB, per unit or per block of a
    unit reads the same blocks; levels likewise in their two layouts (per
    MB and the legacy raster); a field or levels as a picture raster of
    one value a block fit no layout."""
    n_my, n_mx = 3, 5
    n_mb = n_my * n_mx
    rs = np.random.RandomState(1)
    mb = rs.randint(-9, 9, n_mb).astype(np.int32)
    unit = rs.randint(-9, 9, (n_mb, 4)).astype(np.int32)
    blk = rs.randint(-9, 9, (n_mb, 4, 4)).astype(np.int32)
    want_mb = np.repeat(np.repeat(mb.reshape(n_my, n_mx), 4, 0), 4, 1)
    want_unit = np.repeat(np.repeat(unit.reshape(n_my, n_mx, 2, 2).transpose(
        0, 2, 1, 3).reshape(2 * n_my, 2 * n_mx), 2, 0), 2, 1)
    want_blk = blk.reshape(n_my, n_mx, 2, 2, 2, 2).transpose(
        0, 2, 4, 1, 3, 5).reshape(4 * n_my, 4 * n_mx)
    for a, w in ((mb, want_mb), (unit, want_unit), (blk, want_blk)):
        np.testing.assert_array_equal(_R(_t(a), n_my, n_mx), w)
    for name in ("mv0x", "coef"):
        with pytest.raises(ValueError):
            TS.layout(want_blk.shape, n_my, n_mx, name)
    lev = rs.randint(-9, 9, (n_mb, 4, 4, 4, 4)).astype(np.int32)
    ras = lev.reshape(n_my, n_mx, 4, 4, 16).transpose(0, 2, 1, 3, 4).reshape(
        4 * n_my, 4 * n_mx, 4, 4)
    for a in (lev, ras):
        np.testing.assert_array_equal(
            TS.raster(_t(a), n_my, n_mx, "coef").numpy(),
            ras.reshape(4 * n_my, 4 * n_mx, 16))


@functools.lru_cache(maxsize=None)
def _b_call():
    """The strengths call of a B picture of the port's CPU encode (64x48,
    IPB, plain versions)."""
    cfg = EncoderConfig(width=64, height=48, qp=28, fast=True, rd=True,
                        entropy="cabac", b_frames=1, num_ref_frames=2,
                        search_range=8)
    enc = H264Encoder(cfg, device="cpu")
    enc._b_kernels, calls = TB.recording(TB.PLAIN)
    list(enc.encode_stream(moving_frames(3, 64, 48, seed=5)))
    return [a for n, a in calls if n == "strengths"][0]


def test_wrapper_takes_the_b_and_legacy_fields():
    """The fields b_deblock and the legacy picture give the strengths pass
    the kernel wrapper's combined test as they are."""
    a = _b_call()
    assert a[9] is not None and a[11] is not None  # two lists
    lay = list(K6.layout_of(*a))
    assert lay[-1] == a[9].numel() and not any(lay[6:12])  # no 8x8 levels
    lev, mvx, mvy = _legacy_fields(3, 4, 0)
    lay = list(K6.layout_of(3, 4, _t(lev), None, None, _t(mvx).reshape(-1),
                            _t(mvy).reshape(-1)))
    assert lay[:6] == list(TS.layout(lev.shape, 3, 4, "coef")[0])
    assert lay[-1] == 0  # one list


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = list(_b_call())
    cases = {
        "coef as bool": {2: a[2] != 0},
        "coef of another picture": {2: a[2][:-1]},
        "intra as int32": {3: a[3].to(torch.int32)},
        "mvs not contiguous": {5: a[5].t().contiguous().t()},
        "pocs0 not a vector": {9: a[9][:, None]},
        "list 1 without its flags": {13: None},
        "not a tensor": {6: a[6].numpy()},
        "no mvs": {5: None},
    }
    for what, change in cases.items():
        b = list(a)
        for i, v in change.items():
            b[i] = v
        with pytest.raises(ValueError):
            K6.layout_of(*b)
        if what == "list 1 without its flags":
            with pytest.raises(ValueError):
                TS.strengths_plain(*b)
