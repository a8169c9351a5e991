"""Stages 6 (the wavefront intra commit with inter copy-through,
rd.py:1115-1123) and 7 (strengths and deblocking, :1124-1160) of the
port's P pipeline against the JAX package's ``rd_p_pipeline(stage=k)``
checksums (setup and the other stages in test_torch_p_stages.py); and
the 8x8 transform's parts of the deblock (rd.py:1128-1131, :1146-1156)
and of ``host_out`` (:1167-1176) on the same inputs."""

import pytest
import torch

import test_torch_p_stages as base
from h264_tpu_torch.encoder import strengths as TS
from h264_tpu_torch.kernels import deblock as K6


def _one(calls, name):
    (args,) = [a for n, a in calls if n == name]
    return args


def _t8_pic(f):
    """(4 n_my, 4 n_mx) bool: the 4x4 blocks of 8x8-transform MBs."""
    return (f.w_t8.bool().reshape(f.n_my, f.n_mx).repeat_interleave(4, 0)
            .repeat_interleave(4, 1))


@pytest.mark.parametrize("stage", [6, 7])
def test_stage_checksum(stage):
    assert base._port()[stage] == base.jax_checksum(stage)


def test_t8_deblock_marks_nonzero_8x8_blocks():
    """A nonzero 8x8 block of an 8x8-transform MB marks its four 4x4 cells
    as coded in the strengths, which read the 8x8 levels beside the 4x4
    ones; every other cell as the 4x4 rule."""
    f, calls, _, _ = base.port_t8_run(True)
    a = _one(calls, "strengths")
    assert torch.equal(a[7], f.w_lev8) and a[2] is f.w_lev
    nz4 = TS.coded(a[2], a[7], f.n_my, f.n_mx)
    nz8 = (f.w_lev8 != 0).any(-1).any(-1)  # (n_mb, 2, 2)
    cells = nz8.repeat_interleave(2, 1).repeat_interleave(2, 2)
    pic = (cells.reshape(f.n_my, f.n_mx, 4, 4).permute(0, 2, 1, 3)
           .reshape(4 * f.n_my, 4 * f.n_mx))
    assert pic.any() and not (pic & ~nz4).any()
    own = ((f.w_lev != 0).any(-1).any(-1).reshape(f.n_my, f.n_mx, 4, 4)
           .permute(0, 2, 1, 3).reshape(4 * f.n_my, 4 * f.n_mx))
    assert torch.equal(nz4 & ~pic, own & ~pic)


def test_t8_deblock_filters_only_8_pel_edges():
    """The strengths go to the filter with bS 0 on the odd (4-pel) edges
    inside 8x8-transform MBs (the flags the strengths take), and
    unchanged everywhere else."""
    f, calls, _, _ = base.port_t8_run(True)
    a = _one(calls, "strengths")
    assert a[8] is f.w_t8
    bsv, bsh = TS.strengths_plain(*a[:8])
    dbsv, dbsh = _one(calls, "deblock")[3:5]
    t8 = _t8_pic(f)
    odd_v = (torch.arange(4 * f.n_mx) % 2 == 1)[None, :] & t8
    odd_h = (torch.arange(4 * f.n_my) % 2 == 1)[:, None] & t8
    assert t8.any() and (bsv[odd_v] > 0).any()
    assert not dbsv[odd_v].any() and not dbsh[odd_h].any()
    assert torch.equal(dbsv[~odd_v], bsv[~odd_v])
    assert torch.equal(dbsh[~odd_h], bsh[~odd_h])


def test_t8_host_out_carries_flags_and_8x8_levels():
    f, _, host_out, _ = base.port_t8_run(True)
    parts = base.host_parts(host_out, f.n_mb)
    assert torch.equal(parts[3], f.w_t8)
    assert torch.equal(parts[9], f.w_lev8.reshape(-1))
    assert torch.equal(parts[8], f.w_lev.reshape(-1))


def test_no_t8_deblock_and_host_out_unchanged():
    """Without the 8x8 transform the strengths take no 8x8 fields, the
    filter gets them as they are, and host_out's flag and 8x8-level parts
    are zero."""
    f, calls, host_out, _ = base.port_t8_run(False)
    a = _one(calls, "strengths")
    assert a[7] is None and a[8] is None
    bsv, bsh = TS.strengths_plain(*a)
    dbsv, dbsh = _one(calls, "deblock")[3:5]
    assert torch.equal(dbsv, bsv) and torch.equal(dbsh, bsh)
    parts = base.host_parts(host_out, f.n_mb)
    assert not parts[3].any() and not parts[9].any()


@pytest.mark.parametrize("use_t8", [False, True], ids=["4x4", "t8"])
def test_strengths_wrapper_takes_the_p_fields(use_t8):
    """The fields p_deblock gives the strengths pass the kernel wrapper's
    combined test as they are (device, dtype, layout, contiguity)."""
    _, calls, _, _ = base.port_t8_run(use_t8)
    a = _one(calls, "strengths")
    lay = list(K6.layout_of(*a))
    assert len(lay) == 6 * len(TS.FIELDS) + 1 and lay[-1] == 0  # one list
    assert any(lay[6:12]) == use_t8  # the 8x8 levels' strides
