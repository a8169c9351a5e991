"""Stages 4 (candidate decision, rd.py:820-1013) and 5 (winner gather and
inter chroma, :1015-1069) of the port's P pipeline against the JAX
package's ``rd_p_pipeline(stage=k)`` checksums (setup and the other
stages in test_torch_p_stages.py); and the T8 stage that follows the
winner gather (rd.py:1071-1113, ``rd_p.p_t8``) on the same inputs."""

import pytest
import torch

import test_torch_p_stages as base
from h264_tpu_torch.encoder import rd_p as TP


@pytest.mark.parametrize("stage", [4, 5])
def test_stage_checksum(stage):
    assert base._port()[stage] == base.jax_checksum(stage)


def test_t8_stage_decides_on_the_winner():
    """One t8_decide call, on the winner's source, prediction (the
    candidate predictions gathered by the winner), recon, levels and
    eligibility fields, whose result the frame keeps."""
    f, calls, _, (w_lev, w_rec) = base.port_t8_run(True)
    (args,) = [a for n, a in calls if n == "t8_decide"]
    orig, pred, rec, lev, win, sub, intra, qp, lam = args
    ar = torch.arange(f.n_mb)
    assert torch.equal(pred, f.preds[f.win.clamp(max=TP.C_SKIP).long(), ar])
    assert torch.equal(orig, f.orig_mb) and torch.equal(rec, w_rec)
    assert torch.equal(lev, w_lev) and torch.equal(sub, f.w_sub)
    assert torch.equal(intra, win == TP.C_I16)
    assert (qp, lam) == (f.qp, f.lam)
    t8, lev8, _, _ = TP.t8_decide_plain(*args)
    assert torch.equal(t8, f.w_t8) and torch.equal(lev8, f.w_lev8)


def test_t8_stage_switches_some_inter_mbs():
    """Both transform sizes occur; an 8x8 MB carries no 4x4 levels, a 4x4
    inter MB no 8x8 levels and its own levels and recon (the intra
    commit later recodes intra MBs)."""
    f, _, _, (w_lev, w_rec) = base.port_t8_run(True)
    t8 = f.w_t8.bool()
    inter = (f.win < TP.C_I16) & (f.win != TP.C_SKIP)
    keep = inter & ~t8
    assert t8.any() and keep.any()
    assert not f.w_lev[t8].any() and f.w_lev8[t8].any()
    assert not f.w_lev8[~t8].any()
    assert torch.equal(f.w_lev[keep], w_lev[keep])
    assert torch.equal(f.w_rec[keep], w_rec[keep])


def test_no_t8_stage_without_the_8x8_transform():
    """Without use_t8 the stage calls no kernel and every MB keeps the 4x4
    transform."""
    f, calls, _, (w_lev, w_rec) = base.port_t8_run(False)
    assert "t8_decide" not in {n for n, _ in calls}
    assert f.w_lev8 is None and not f.w_t8.any()
    assert {n for n, _ in calls} == set(TP.entries_of(False))
