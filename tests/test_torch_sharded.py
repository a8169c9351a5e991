"""The sharded tile-row pipelines of the port (h264_tpu_torch/parallel/)
on the CPU, over gloo ranks (one process each), vs the JAX package.

The reference's shard_map'd programs are held through the digests that
tests/torch_records.py records from h264_tpu on 8 virtual CPU devices
(``record_sharded``; compiled live, each would cost the tier-1 run a
program of several minutes): ``rd_p_rows_sharded`` at mesh (2, 2) on
tests/test_rd_pipeline.py:148's inputs, ``rd_gop_rows_sharded`` at (2, 2)
through ``dryrun_multichip(4)`` (S 8, host buffers, recon, the CAVLC
stream and the printed line) and at (1, 4) with H 128 (middle shards,
S 4).  Each also equals the port's single-device ``rd_p_rows_pipeline``
chain on the same inputs.  The bank of a row slab (K2
``ref_bank_rows``'s plain version) runs live against the reference's
``_bank_from_pad`` (eager jnp) on built slabs.  Also: the refusals (nccl
on the CPU or with more ranks than cards, the reference's asserts), a
rank that raises, and no rank holding JAX or the JAX package."""

import functools
import hashlib
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_records as REC
from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_rows as TR
from h264_tpu_torch.kernels import ref_bank as K2
from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.parallel import dryrun as DR
from h264_tpu_torch.parallel import sharded as SH
from h264_tpu_torch.parallel import mesh as MESH
from h264_tpu_torch.parallel.mesh import Mesh
from h264_tpu_torch.tools.slab_cases import CONTENTS, built_slab

torch.set_num_threads(1)

PAD = TRD.PAD


@functools.lru_cache(maxsize=None)
def records() -> dict:
    return REC.load()["sharded"]


def cpu_mesh(n_frame, n_row):
    return Mesh(n_frame, n_row, "gloo", "cpu")


def check_ranks(step, n):
    assert len(step.ranks) == n
    for info in step.ranks:
        assert info["foreign_modules"] == [], info["foreign_modules"]
        # the plain versions on the CPU: no kernel launched
        assert not any(info["launches"].values())


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("r", [0, 1, 2], ids=["top", "middle", "bottom"])
@pytest.mark.parametrize("Hg", [32, 16])
def test_ref_bank_rows_plain_equals_reference(Hg, r, content):
    ext = built_slab(content, Hg, 64, r, 3)
    n_zero = PAD - min(PAD, Hg // 2)
    assert not ext[1][:n_zero].any() and n_zero > 0  # chroma zero rows
    bank, cpad = K2.ref_bank_rows(*(torch.as_tensor(x) for x in ext))
    assert bank.shape == (4, Hg + 2 * PAD, 64 + 2 * PAD)
    assert cpad.shape == (2, Hg // 2 + 2 * PAD, 32 + 2 * PAD)
    cols = ((0, 0), (PAD, PAD))
    want = JRD._bank_from_pad(jnp.pad(jnp.asarray(ext[0]), cols,
                                      mode="edge"))
    want_c = jnp.stack([jnp.pad(jnp.asarray(x), cols, mode="edge")
                        for x in ext[1:]])
    np.testing.assert_array_equal(bank.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cpad.numpy(), np.asarray(want_c))


def test_p_rows_sharded_equals_reference_and_chain():
    (cy, cu, cv), refs = REC.p_rows_inputs()
    ents = [TRD.ref_entry_plain(*(torch.as_tensor(p) for p in r))
            for r in refs]
    banks = torch.stack([e[0][None] for e in ents]).numpy()
    cpads = torch.stack([e[1][None] for e in ents]).numpy()
    step = SH.rd_p_rows_sharded(cpu_mesh(2, 2), lam=REC.SH_LAM, **REC.SH_P)
    host_outs, recons = step(cy, cu, cv, banks, cpads)
    check_ranks(step, 4)
    want = records()["p_rows_2x2"]
    assert REC.digest(host_outs) == want["host_outs"]
    assert [REC.digest(x) for x in recons] == want["recons"]
    G, Hg = REC.SH_P["G"], REC.SH_P["H"] // REC.SH_P["G"]
    for f in range(REC.SH_F):
        ho, rec, _ = TR.rd_p_rows_pipeline(
            cy[f], cu[f], cv[f], torch.as_tensor(banks[f]),
            torch.as_tensor(cpads[f]), lam=REC.SH_LAM, lam_me=REC.SH_LAM,
            device="cpu", **REC.SH_P)
        np.testing.assert_array_equal(host_outs[f], ho.numpy())
        for i, x in enumerate(rec):
            np.testing.assert_array_equal(
                recons[i][f], x.numpy().reshape(G, -1, x.shape[1]))
        assert recons[0].shape[2] == Hg


def test_dryrun_multichip_4_equals_reference(capsys):
    out = DR.dryrun_multichip(4, backend="gloo", device="cpu")
    want = records()["dryrun_4"]
    assert capsys.readouterr().out.strip() == want["line"] == out["line"]
    assert REC.digest(out["host_outs"]) == want["host_outs"]
    assert REC.digest(out["recon_y"]) == want["recon_y"]
    assert len(out["stream"]) == want["stream_bytes"]
    assert hashlib.sha256(out["stream"]).hexdigest() == want["stream"]
    assert len(out["ranks"]) == 4
    for info in out["ranks"]:
        assert len(info["step_ms"]) == len(info["exchange_ms"]) == DR.S_DRY
        assert info["foreign_modules"] == []


def test_gop_1x4_middle_shards_equal_reference_and_chain():
    F, G, S = REC.SH_GOP14["F"], REC.SH_GOP14["G"], REC.SH_GOP14["S"]
    cy, cu, cv, y0, u0, v0 = DR.gop_inputs(F, G, S)
    H, W = cy.shape[2:]
    qpc = chroma_qp(28, 0)
    step = SH.rd_gop_rows_sharded(cpu_mesh(F, G), S=S, H=H, W=W, R=8, qp=28,
                                  qp_c=qpc, lam=REC.SH_LAM)

    def rows(a):
        return a.reshape(*a.shape[:-2], G, a.shape[-2] // G, a.shape[-1])

    host_outs, (recon_y, recon_u, recon_v) = step(
        *map(rows, (cy, cu, cv, y0, u0, v0)))
    check_ranks(step, G)
    want = records()["gop_1x4"]
    assert REC.digest(host_outs) == want["host_outs"]
    assert REC.digest(recon_y) == want["recon_y"]
    stream = b"".join(n.rbsp for s in range(S) for n in DR._entropy_nals(
        host_outs[0, s], W, H, G, 28, s))
    assert len(stream) == want["stream_bytes"]
    assert REC.digest(stream) == want["stream"]
    # the single-device chain on the same GOP, all three planes
    bank, cpad = TRD.ref_entry_plain(*(torch.as_tensor(p[0])
                                       for p in (y0, u0, v0)))
    for s in range(S):
        ho, rec, (bank, cpad, _) = TR.rd_p_rows_pipeline(
            cy[0, s], cu[0, s], cv[0, s], bank[None], cpad[None], H=H, W=W,
            R=8, qp=28, qp_c=qpc, lam=REC.SH_LAM, lam_me=REC.SH_LAM, G=G,
            device="cpu")
        np.testing.assert_array_equal(host_outs[0, s], ho.numpy())
        for got, x in zip((recon_y, recon_u, recon_v), rec):
            np.testing.assert_array_equal(got[0, s].reshape(x.shape),
                                          x.numpy())


def test_nccl_refuses_the_cpu_and_more_ranks_than_cards(monkeypatch):
    with pytest.raises(ValueError, match="CUDA cards"):
        Mesh(1, 2, "nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        Mesh(1, 2, "nccl", "cuda")
    with pytest.raises(ValueError, match="one card per rank"):
        DR.dryrun_multichip(2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="backend"):
        Mesh(1, 2, "mpi", "cpu")
    assert not torch.distributed.is_initialized()


def test_reference_asserts_are_refusals():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                              ("frame", "row"))
    kw = dict(qp=28, qp_c=28, lam=REC.SH_LAM)
    # the halo must cover the search: R + 7 <= Hg (64 / 2 = 32 < 28 + 7)
    with pytest.raises(AssertionError, match="halo"):
        JRD.rd_gop_rows_sharded(jmesh, S=2, H=64, W=64, R=28, **kw)
    with pytest.raises(ValueError, match="halo"):
        SH.rd_gop_rows_sharded(cpu_mesh(1, 2), S=2, H=64, W=64, R=28, **kw)
    # and R / 2 + 6 <= Hg / 2 (Hg 32: R 24 passes the first, not this)
    with pytest.raises(AssertionError):
        JRD.rd_gop_rows_sharded(jmesh, S=2, H=64, W=64, R=24, **kw)
    with pytest.raises(ValueError, match="halo"):
        SH.rd_gop_rows_sharded(cpu_mesh(1, 2), S=2, H=64, W=64, R=24, **kw)
    # the row groups must spread evenly over the row shards
    with pytest.raises(AssertionError):
        JRD.rd_p_rows_sharded(jmesh, H=96, W=64, R=8, G=3, **kw)
    with pytest.raises(ValueError, match="row groups"):
        SH.rd_p_rows_sharded(cpu_mesh(1, 2), H=96, W=64, R=8, G=3, **kw)
    # and tile rows are whole MB rows (rd_rows.check_rows: the reference
    # fails later, reshaping its recon)
    with pytest.raises(ValueError, match="whole MB rows"):
        SH.rd_gop_rows_sharded(cpu_mesh(1, 2), S=2, H=144, W=64, R=8, **kw)
    with pytest.raises(ValueError, match="whole MB rows"):
        SH.rd_p_rows_sharded(cpu_mesh(1, 2), H=144, W=64, R=8, G=2, **kw)


def test_a_rank_that_raises_fails_the_run():
    cy, cu, cv, y0, u0, v0 = DR.gop_inputs(1, 2, 1)
    step = SH.rd_gop_rows_sharded(cpu_mesh(1, 2), S=1, H=64, W=64, R=8,
                                  qp=28, qp_c=28, lam="not a lambda")

    def rows(a):
        return a.reshape(*a.shape[:-2], 2, a.shape[-2] // 2, a.shape[-1])

    with pytest.raises(mp.ProcessRaisedException, match="not a lambda"):
        step(*map(rows, (cy, cu, cv, y0, u0, v0)))


def _sleeping_rank(rank, seconds):
    time.sleep(seconds)


def test_a_rank_that_hangs_is_stopped(monkeypatch):
    """A launch whose ranks outlive its limit stops and reaps them all and
    raises, instead of waiting for ever."""
    monkeypatch.setattr(MESH, "LAUNCH_LIMIT", 10.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 10 s"):
        MESH.launch(cpu_mesh(1, 2), _sleeping_rank, 3600)
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()
