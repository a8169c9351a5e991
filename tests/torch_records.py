"""Outputs of the reference package (h264_tpu) recorded for the port's
tests whose live run would cost the tier-1 run more compiled programs of
the reference: the tile-row pipeline with one QP for every row (its
scalar-QP program; the per-row-QP one runs live in test_torch_rows.py),
and the P pipeline's intra-refresh and loss-aware branches (each a static
specialization of rd_p_pipeline) with the encodes that take them, and
the sharded tile-row pipelines (rd_p_rows_sharded, rd_gop_rows_sharded
and the dry run of __graft_entry__.py, each a shard_map'd program over a
mesh of the CPU's virtual devices).  ROADMAP's "Tier-1 budget" allows one
new program per slice.

test_torch_rows_qp.py and test_torch_er.py hold the port's outputs equal
to these records, digest for digest: the sha256 of each integer array
(with its shape) and of each stream, on the same seeded inputs, which this
module makes for both sides.  The encodes also record, for every P
pipeline call, the refresh mask and the drift penalty it was given, and
for every step of the simulated decoders the losses drawn, the new drift
and penalty and the largest |drift|.  Regenerate the records after a
change to h264_tpu or to the inputs (about half an hour on a CPU, most of
it the reference's compiles):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_records.py

or only the sharded records (``record_sharded``; they need 8 virtual
devices, which the command gives JAX before it loads):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_records.py sharded
"""

import contextlib
import hashlib
import io
import json
import os
import pathlib
import sys

import numpy as np

from h264_tpu_torch.ops.exact import chroma_qp
from h264_tpu_torch.tools.synthseq import moving_frames

PATH = pathlib.Path(__file__).with_name("torch_records.json")
W, H, N = 176, 144, 5
ROWS = dict(width=W, height=H, entropy="cabac", fast=True, num_ref_frames=1,
            row_slices=3, search_range=8)
# fixed-QP tile rows: CABAC, and with the 8x8 transform signalled
ROWS_QP = {"cabac": ROWS, "t8": dict(ROWS, transform8x8=True)}
# the pipeline with one QP for every row, called as the encoder calls it
PIPE = dict(H=H, W=W, R=8, qp=28, qp_c=chroma_qp(28, 0), G=3)
# error resilience (fast RD path, CABAC, R 8): loss-aware RDO (3 simulated
# decoders losing half the pictures, one reference, 6 frames); the same with
# intra refresh in an IPB stream with explicit WP and an IDR at frame 4 (its
# decoders reset there); intra refresh alone, 40 of the 99 MBs per P
# picture over 5 frames, so that its permutation runs out and is re-seeded
ER = dict(width=W, height=H, entropy="cabac", fast=True, search_range=8)
ER_ENC = {
    "er_loss": (dict(ER, num_ref_frames=1, loss_aware_k=3, loss_rate=0.5), 6),
    "er_ipb": (dict(ER, num_ref_frames=2, b_frames=1, weighted_pred=True,
                    idr_period=4, loss_aware_k=3, loss_rate=0.5,
                    intra_refresh=30), 7),
    "er_refresh": (dict(ER, num_ref_frames=1, intra_refresh=40), 5),
}
# the one-slice P pipeline as the encoder calls it (R 8, one reference, the
# coarse stage on), with a refresh mask and with a drift penalty
PIPE_P = dict(H=H, W=W, R=8, qp=28, qp_c=chroma_qp(28, 0))
# the sharded tile-row step at tests/test_rd_pipeline.py:148's inputs: 2
# frames of 64x64 over a (frame 2, row 2) mesh, 2 groups, one reference
SH_P = dict(H=64, W=64, R=8, qp=28, qp_c=26, G=2)
SH_F = 2
# the lambda of __graft_entry__.py and test_rd_pipeline.py:154
SH_LAM = int(0.85 * 2.0 ** ((28 - 12) / 3.0) * 65536)
# the GOP encoder over (frame 1, row 4): the dry run's content and shapes
# at H 128 (middle row shards), 4 P pictures
SH_GOP14 = dict(F=1, G=4, S=4)


def er_inputs(seed: int = 19):
    """(refresh mask (99,) bool, drift penalty (99,) int32) of the
    pipeline pair: a third of the MBs forced intra, penalties up to the
    2^30 clip."""
    rng = np.random.default_rng(seed)
    n_mb = (H // 16) * (W // 16)
    mask = rng.random(n_mb) < 1 / 3
    pen = rng.integers(0, 1 << 16, n_mb).astype(np.int32)
    pen[rng.random(n_mb) < 0.1] = 1 << 30
    return mask, pen


def lam(qp: int) -> int:
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


def digest(x) -> str:
    if isinstance(x, bytes):
        return hashlib.sha256(x).hexdigest()
    a = np.asarray(x)
    return hashlib.sha256(str(a.shape).encode()
                          + a.astype(np.int64).tobytes()).hexdigest()


def frames(n: int = N):
    return moving_frames(n, W, H, seed=11)


def pipe_inputs(seed: int = 9):
    """(current planes uint8, reference planes int32) of the pipeline
    pair; each side makes its reference entry from the planes."""
    rng = np.random.default_rng(seed)
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    cur = [rng.integers(0, 256, s).astype(np.uint8) for s in shapes]
    ref = [rng.integers(0, 256, s).astype(np.int32) for s in shapes]
    return cur, ref


def pipe_record(out) -> dict:
    host_out, recon, (bank, cpad, col) = out
    return {"host_out": digest(host_out),
            "recon": [digest(x) for x in recon],
            "bank": digest(bank), "cpad": digest(cpad),
            "col": [digest(x) for x in col]}


def encode_record(enc, stream: bytes) -> dict:
    return {"stream": digest(stream), "bytes": len(stream),
            "recons": [[poc, digest(p.Y), digest(p.U), digest(p.V)]
                       for poc, p in enc.all_recons]}


def call_record(force_intra, drift_pen) -> dict:
    """What one P pipeline call of an encode was given."""
    return {"refresh": (None if force_intra is None else
                        [int(i) for i in np.nonzero(np.asarray(force_intra))[0]]),
            "pen": None if drift_pen is None else digest(drift_pen)}


def step_record(lost, new, pen) -> dict:
    """One step of the simulated decoders."""
    new = np.asarray(new)
    return {"lost": [bool(x) for x in np.asarray(lost)], "drift": digest(new),
            "pen": digest(pen), "max_abs_drift": int(np.abs(new).max())}


def p_rows_inputs(seed: int = 7):
    """tests/test_rd_pipeline.py:148's inputs, drawn in its order: current
    planes (F, H, W), (F, H/2, W/2) uint8, and each frame's reference
    planes (y, u, v) int32."""
    rng = np.random.default_rng(seed)
    Hh, Ww = SH_P["H"], SH_P["W"]
    cur = [rng.integers(0, 256, (SH_F, h, w)).astype(np.uint8)
           for h, w in ((Hh, Ww), (Hh // 2, Ww // 2), (Hh // 2, Ww // 2))]
    refs = [[rng.integers(0, 256, s).astype(np.int32)
             for s in ((Hh, Ww), (Hh // 2, Ww // 2), (Hh // 2, Ww // 2))]
            for _ in range(SH_F)]
    return cur, refs


def gop_record(host_outs, recon_y, stream: bytes) -> dict:
    return {"host_outs": digest(host_outs), "recon_y": digest(recon_y),
            "stream": digest(stream), "stream_bytes": len(stream)}


def load() -> dict:
    return json.loads(PATH.read_text())


def record() -> dict:
    """Run the reference package on every input above."""
    import jax.numpy as jnp

    from h264_tpu.encoder import rd as JRD
    from h264_tpu.encoder.encoder import EncoderConfig, H264Encoder

    cur, ref = pipe_inputs()
    bank, cpad = JRD.ref_entry_from_planes(*(jnp.asarray(p) for p in ref))
    out = JRD.rd_p_rows_pipeline(
        *(jnp.asarray(c) for c in cur), jnp.stack([bank]), jnp.stack([cpad]),
        lam=lam(28), lam_me=lam(28), nref=jnp.int32(1), **PIPE)
    recs = {"pipeline": pipe_record(out)}
    for name, kw in ROWS_QP.items():
        enc = H264Encoder(EncoderConfig(**kw))
        recs[name] = encode_record(enc, enc.encode_sequence(frames()))
    mask, pen = er_inputs()
    for name, kw in (("pipeline_refresh", dict(force_intra=jnp.asarray(mask),
                                               use_refresh=True)),
                     ("pipeline_drift", dict(drift_pen=jnp.asarray(pen),
                                             use_drift=True))):
        out = JRD.rd_p_pipeline(
            *(jnp.asarray(c) for c in cur), jnp.stack([bank]),
            jnp.stack([cpad]), lam=lam(28), lam_me=2 * lam(28),
            nref=jnp.int32(1), use_cme=True, **PIPE_P, **kw)
        recs[name] = pipe_record(out)
    recs.update(record_er())
    return recs


def record_er() -> dict:
    """The error-resilient encodes of ER_ENC, with their pipeline calls and
    decoder steps."""
    from h264_tpu.encoder import lossaware as JLA
    from h264_tpu.encoder import rd as JRD
    from h264_tpu.encoder.encoder import EncoderConfig, H264Encoder

    pipe, step = JRD.rd_p_pipeline, JLA.propagate_drift
    recs = {}
    for name, (kw, n) in ER_ENC.items():
        calls, steps = [], []

        def rec_pipe(*a, **k):
            calls.append(call_record(k.get("force_intra"),
                                     k.get("drift_pen")))
            return pipe(*a, **k)

        def rec_step(drift, delta, mv4, intra4, lost, H, W):
            new, pen = step(drift, delta, mv4, intra4, lost, H=H, W=W)
            steps.append(step_record(lost, new, pen))
            return new, pen

        JRD.rd_p_pipeline, JLA.propagate_drift = rec_pipe, rec_step
        try:
            enc = H264Encoder(EncoderConfig(**kw))
            stream = enc.encode_sequence(frames(n))
        finally:
            JRD.rd_p_pipeline, JLA.propagate_drift = pipe, step
        recs[name] = {**encode_record(enc, stream), "calls": calls,
                      "steps": steps, "src_pocs": len(enc._src_dc)}
    return recs


def record_sharded() -> dict:
    """The reference's sharded pipelines on meshes of 8 virtual CPU
    devices: rd_p_rows_sharded at (2, 2); rd_gop_rows_sharded at (2, 2)
    and (2, 4) as the dry run drives it (``dryrun_multichip(4)`` and
    ``(8)``: its host buffers, recon and CAVLC stream, caught around the
    calls, and the line it prints), and at (1, 4), H 128."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import __graft_entry__ as GE
    from h264_tpu.encoder import rd as JRD
    from h264_tpu_torch.parallel.dryrun import gop_inputs

    devs = jax.devices()
    assert len(devs) >= 8, "needs --xla_force_host_platform_device_count=8"

    def mesh(nf, nr):
        return Mesh(np.array(devs[: nf * nr], dtype=object).reshape(nf, nr),
                    ("frame", "row"))

    recs = {}
    m = mesh(2, 2)
    (cy, cu, cv), refs = p_rows_inputs()
    ents = [JRD.ref_entry_from_planes(*(jnp.asarray(p) for p in r))
            for r in refs]
    G = SH_P["G"]
    fs, rs = NamedSharding(m, P("frame", "row")), NamedSharding(m, P("frame"))
    args = [jax.device_put(jnp.asarray(c.reshape(SH_F, G, c.shape[1] // G,
                                                 c.shape[2])), fs)
            for c in (cy, cu, cv)]
    args += [jax.device_put(jnp.stack([e[i][None] for e in ents]), rs)
             for i in (0, 1)]
    host_outs, recons = JRD.rd_p_rows_sharded(m, lam=SH_LAM, **SH_P)(*args)
    recs["p_rows_2x2"] = {"host_outs": digest(host_outs),
                          "recons": [digest(x) for x in recons]}

    gop, ent = JRD.rd_gop_rows_sharded, GE._entropy_nals
    for n in (4, 8):
        got, nals = {}, []

        def catch_gop(*a, **k):
            step = gop(*a, **k)

            def run(*args):
                got["out"] = step(*args)
                return got["out"]
            return run

        def catch_nals(*a):
            nals.append(ent(*a))
            return nals[-1]

        JRD.rd_gop_rows_sharded, GE._entropy_nals = catch_gop, catch_nals
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                GE.dryrun_multichip(n)
        finally:
            JRD.rd_gop_rows_sharded, GE._entropy_nals = gop, ent
        # the dry run codes each picture's single-device buffers, then its
        # sharded ones: the sharded stream is every second call's
        sh = b"".join(x.rbsp for ns in nals[1::2] for x in ns)
        line = buf.getvalue().strip()
        assert f"stream_bytes={len(sh)}" in line, line
        recs[f"dryrun_{n}"] = {**gop_record(*got["out"], sh), "line": line}
    assert "stream_bytes=25923" in recs["dryrun_8"]["line"]  # MULTICHIP_r05

    F, G, S = SH_GOP14["F"], SH_GOP14["G"], SH_GOP14["S"]
    cy, cu, cv, y0, u0, v0 = gop_inputs(F, G, S)
    H, W = cy.shape[2:]
    m = mesh(F, G)
    fs, rs = (NamedSharding(m, P("frame", None, "row")),
              NamedSharding(m, P("frame", "row")))
    args = [jax.device_put(jnp.asarray(c.reshape(F, S, G, -1, c.shape[3])),
                           fs) for c in (cy, cu, cv)]
    args += [jax.device_put(jnp.asarray(c.reshape(F, G, -1, c.shape[2])), rs)
             for c in (y0, u0, v0)]
    step = JRD.rd_gop_rows_sharded(m, S=S, H=H, W=W, R=8, qp=28,
                                   qp_c=chroma_qp(28, 0), lam=SH_LAM)
    host_outs, recon_y = (np.asarray(x) for x in step(*args))
    sh = b"".join(x.rbsp for s in range(S)
                  for x in ent(host_outs[0, s], W, H, G, 28, s))
    recs["gop_1x4"] = gop_record(host_outs, recon_y, sh)
    return recs


if __name__ == "__main__":
    if sys.argv[1:] == ["sharded"]:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                                   "force_host_platform_device_count=8")
        recs = {**load(), "sharded": record_sharded()}
    else:
        recs = record()
    PATH.write_text(json.dumps(recs, indent=1) + "\n")
    print(f"wrote {PATH}")
