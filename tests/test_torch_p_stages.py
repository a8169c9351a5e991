"""The port's P stages (h264_tpu_torch.encoder.rd_p ``p_*``) against the
JAX package's ``rd_p_pipeline(stage=k)`` checksums, on the CPU.

At 64x48, R = 8, NR = 2 with explicit WP, on JAX-made references of
moving, fading frames: after each port stage the same int32 sums the
reference returns for ``stage=k`` (compared modulo 2^32: they wrap in
int32).  Stages 1, 2, 3 and 35 here; 4 and 5 in
test_torch_p_stages_decide.py, 6 and 7 in test_torch_p_stages_loop.py,
so the compiles spread over the test workers.  Those two files also hold
the port's 8x8-transform glue on the same inputs (``port_t8_run``): the
T8 stage after the winner gather, and its deblock and ``host_out`` parts
(the reference's whole T8 pipeline: test_torch_t8_encode*.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_p as TP
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, R, NR, QP = 64, 48, 8, 2, 28
WP_W = np.array([30, 36], np.int32)
WP_O = np.array([3, -4], np.int32)


def _lam(qp):
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


@functools.lru_cache(maxsize=None)
def _inputs():
    frames = moving_frames(3, W, H, seed=3)
    ents = [JRD.ref_entry_from_planes(*(jnp.asarray(p, jnp.int32)
                                        for p in frames[i])) for i in (1, 0)]
    banks = jnp.stack([e[0] for e in ents])
    cpads = jnp.stack([e[1] for e in ents])
    return frames[2], banks, cpads


def jax_checksum(stage: int) -> int:
    cur, banks, cpads = _inputs()
    lam = _lam(QP)
    out = JRD.rd_p_pipeline(
        *map(jnp.asarray, cur), banks, cpads, H=H, W=W, R=R, qp=QP, qp_c=QP,
        lam=lam, lam_me=2 * lam, stage=stage, nref=jnp.int32(NR),
        wp_w=jnp.asarray(WP_W), wp_o=jnp.asarray(WP_O), use_wp=True,
        use_cme=True)[0]
    return int(np.asarray(out).astype(np.int64)) % (1 << 32)


def _s32(*ts) -> int:
    return sum(int(t.to(torch.int64).sum()) for t in ts) % (1 << 32)


# stage k -> the port's stages that complete it, and its checksum (the
# reference's `return` of stage k, rd.py:459/538/597/764/1013/1069/1123/1160)
STAGES = {
    1: (TP.p_search, lambda f: _s32(f.ssd8)),
    2: (TP.p_partitions, lambda f: _s32(*f.r16)),
    3: (TP.p_refine, lambda f: _s32(*[u for q in [f.q16, *f.q168, *f.q816,
                                                  *f.q88] for u in q])),
    35: (TP.p_sub8, lambda f: _s32(f.spl_pred_mb, f.spl_mvx_mb,
                                   f.motb_split)),
    4: (TP.p_decide, lambda f: _s32(f.win, f.rec16)),
    5: (TP.p_winner, lambda f: _s32(f.recc, f.w_rec)),
    6: (TP.p_commit, lambda f: _s32(f.rec_y, f.rec_u, f.rec_v)),
    7: (TP.p_deblock, lambda f: _s32(f.dy, f.du, f.dv)),
}


def port_checksums() -> dict:
    """Run every port stage once on the CPU; checksum after each."""
    cur, banks, cpads = _inputs()
    lam = _lam(QP)
    f = TP.PFrame(*(torch.from_numpy(np.asarray(p, np.int32)) for p in cur),
                  torch.tensor(np.asarray(banks)), torch.tensor(np.asarray(cpads)),
                  H, W, R, QP, QP, lam, 2 * lam, NR,
                  (torch.from_numpy(WP_W), torch.from_numpy(WP_O)), TP.PLAIN)
    out = {}
    for k, (stage, checksum) in STAGES.items():
        stage(f)
        out[k] = checksum(f)
    return out


_port = functools.lru_cache(maxsize=None)(port_checksums)

@functools.lru_cache(maxsize=None)
def port_t8_run(use_t8: bool):
    """The port's whole P pipeline (plain versions) with or without the T8
    stage, at 176x144, QP 28, WP, on the port's own reference entries of
    moving frames (the stage inputs above code no MB that may take the
    8x8 transform): (frame, the recorded kernel calls, host_out, the
    winner's (w_lev, w_rec) before the T8 stage)."""
    Wt, Ht = 176, 144
    frames = moving_frames(3, Wt, Ht, seed=11)
    ents = [TRD.ref_entry_from_planes(*(np.asarray(p, np.int32)
                                        for p in frames[i]), device="cpu")
            for i in (1, 0)]
    lam = _lam(QP)
    k, calls = TP.recording(TP.PLAIN)
    f = TP.PFrame(*(torch.from_numpy(np.asarray(p, np.int32))
                    for p in frames[2]),
                  torch.stack([e[0] for e in ents]),
                  torch.stack([e[1] for e in ents]), Ht, Wt, R, QP, QP, lam,
                  2 * lam, NR, (torch.from_numpy(WP_W), torch.from_numpy(WP_O)),
                  k, use_t8)
    before = None
    for stage in TP.P_STAGES:
        if stage is TP.p_t8:
            before = (f.w_lev.clone(), f.w_rec.clone())
        stage(f)
    return f, calls, TP.p_outputs(f)[0], before


def host_parts(host_out, n_mb):
    """host_out split into its 14 parts (the reference's layout)."""
    sizes = [n_mb, 4 * n_mb, 4 * n_mb, n_mb, 16 * n_mb, 16 * n_mb, n_mb,
             n_mb, 256 * n_mb, 256 * n_mb, 16 * n_mb, 128 * n_mb, 8 * n_mb,
             16 * n_mb]
    return torch.split(host_out, sizes)


@pytest.mark.parametrize("stage", [1, 2, 3, 35])
def test_stage_checksum(stage):
    assert _port()[stage] == jax_checksum(stage)
