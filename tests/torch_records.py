"""Outputs of the reference package (h264_tpu) recorded for the port's
tests whose live run would cost the tier-1 run one more compiled program
of the reference: the tile-row pipeline with one QP for every row (its
scalar-QP program; the per-row-QP one runs live in test_torch_rows.py).
ROADMAP's "Tier-1 budget" allows one new program per slice.

test_torch_rows_qp.py holds the port's outputs equal to these records,
digest for digest: the sha256 of each integer array (with its shape) and
of each stream, on the same seeded inputs, which this module makes for
both sides.  Regenerate the records after a change to h264_tpu or to the
inputs (a few minutes on a CPU, most of it the reference's compile):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_records.py
"""

import hashlib
import json
import pathlib

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
    return recs


if __name__ == "__main__":
    PATH.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {PATH}")
