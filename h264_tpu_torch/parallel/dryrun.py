"""The multi-process dry run of the sharded GOP encoder: the port of the
reference package's ``__graft_entry__.py dryrun_multichip`` and
``_entropy_nals`` (:54-178).

    python -m h264_tpu_torch.parallel.dryrun --devices N
        [--backend gloo|nccl] [--device cpu|cuda]

N ranks form the reference's mesh (2 frame shards when N is even, else
1; N / n_frame row shards).  Each frame shard codes one closed GOP of S 8
P pictures of Hg 32 lines per row shard, 64 wide, R 8, QP 28, in tile
rows whose reference banks each rank rebuilds from exchanged halos
(``sharded.rd_gop_rows_sharded``).  The run then requires the host
buffers, the recon and the CAVLC slices of every picture to equal those
of the single-device tile-row chain (``rd_rows.rd_p_rows_pipeline``
picture after picture), and prints the reference's summary line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

HG, W_DRY, S_DRY, R_DRY, QP_DRY = 32, 64, 8, 8, 28


def gop_inputs(F: int, G: int, S: int, Hg: int = HG, W: int = W_DRY,
               seed: int = 0):
    """The dry run's content (``__graft_entry__.py:87-99``), made with
    numpy in the same order: F GOPs of S moving uint8 pictures (H = G Hg
    lines) and each GOP's initial int32 reference planes.  Returns (cy
    (F, S, H, W), cu, cv (F, S, H/2, W/2), y0 (F, H, W), u0, v0 (F, H/2,
    W/2))."""
    H = Hg * G
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (F, H + 4 * S, W + 4 * S)).astype(np.uint8)
    cy = np.stack([np.stack([base[f, 2 * s: 2 * s + H, 2 * s: 2 * s + W]
                             for s in range(S)]) for f in range(F)])
    cu = (cy[:, :, ::2, ::2] // 2 + 64)[:, :, : H // 2, : W // 2]
    cv = 255 - cu
    y0 = rng.integers(0, 256, (F, H, W)).astype(np.int32)
    u0 = rng.integers(0, 256, (F, H // 2, W // 2)).astype(np.int32)
    v0 = rng.integers(0, 256, (F, H // 2, W // 2)).astype(np.int32)
    return cy, cu, cv, y0, u0, v0


def _entropy_nals(host_out_rows, W: int, H: int, G: int, qp: int,
                  frame_idx: int):
    """The host entropy tail (state fill and CAVLC slice writers) of one
    P picture's (G, L) tile-row outputs (``__graft_entry__.py:164``); its
    slice NAL units.  The encoder is the port's, on the host; its
    ``_finish_p_rd`` takes 8 fields where the reference's takes 9 (no
    host_out among them), with the reference's frame_num s + 1, POC
    2 (s + 1) and reference POC 2 s.  The recon planes are not read."""
    import torch

    from ..encoder.encoder import EncoderConfig, H264Encoder

    enc = H264Encoder(EncoderConfig(
        width=W, height=H, qp=qp, fast=True, rd=True, row_slices=G,
        num_ref_frames=1, entropy="cavlc"), device="cpu")
    dummy = torch.zeros((2, 2), dtype=torch.int32)
    pending = ("rd", (dummy, dummy, dummy), frame_idx + 1,
               2 * (frame_idx + 1), [2 * frame_idx], qp, None, 1.0)
    return enc._finish_p_rd(pending, fetched=np.asarray(host_out_rows))


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None):
    """The chained-GOP tile-row encode over a (frame, row) mesh of
    n_devices ranks on `backend` (``parallel.mesh``), held byte for byte
    against the single-device tile-row chain on `device` (CUDA unless
    told otherwise), through the entropy tail.  Prints the reference's
    summary line and returns {"line", "stream" (the sharded pictures'
    slice bytes), "host_outs" (F, S, G, L), "recon_y" (F, S, G, Hg, W),
    "ranks"}.  Raises AssertionError where the two differ."""
    import torch

    from ..device import resolve_device
    from ..encoder import rd as RD
    from ..encoder import rd_rows as RDR
    from ..ops.exact import chroma_qp
    from .mesh import Mesh
    from .sharded import rd_gop_rows_sharded

    n_frame = 2 if n_devices % 2 == 0 else 1  # __graft_entry__.py:75-76
    n_row = n_devices // n_frame
    mesh = Mesh(n_frame, n_row, backend,
                "cuda" if device is None else str(device))
    dev = resolve_device(device)
    G = n_row  # one tile-row slice per row shard
    H, W = HG * G, W_DRY
    F, S, R, QP = n_frame, S_DRY, R_DRY, QP_DRY
    QPC = chroma_qp(QP, 0)
    lam = int(0.85 * 2.0 ** ((QP - 12) / 3.0) * 65536)
    cy, cu, cv, y0, u0, v0 = gop_inputs(F, G, S)

    def rows(a):  # (F, [S,] H, W) -> (F, [S,] G, h, W)
        return a.reshape(*a.shape[:-2], G, a.shape[-2] // G, a.shape[-1])

    step = rd_gop_rows_sharded(mesh, S=S, H=H, W=W, R=R, qp=QP, qp_c=QPC,
                               lam=lam)
    host_outs, (recon_y, _, _) = step(*map(rows, (cy, cu, cv, y0, u0, v0)))

    # the single-device chain: the same GOPs picture after picture
    ok_pix = True
    streams_sh, streams_1d = [], []
    for f in range(F):
        bank, cpad = RD.ref_entry_from_planes(y0[f], u0[f], v0[f],
                                              device=dev)
        banks, cpads = bank[None], cpad[None]
        for s in range(S):
            ho, rec, entry = RDR.rd_p_rows_pipeline(
                cy[f, s], cu[f, s], cv[f, s], banks, cpads, H=H, W=W, R=R,
                qp=QP, qp_c=QPC, lam=lam, lam_me=lam, G=G, device=dev)
            banks, cpads = entry[0][None], entry[1][None]
            ho = ho.cpu().numpy()
            if not np.array_equal(ho, host_outs[f, s]):
                raise AssertionError(
                    f"sharded host_out differs (gop {f}, frame {s})")
            if not np.array_equal(rec[0].cpu().numpy().reshape(G, HG, W),
                                  recon_y[f, s]):
                ok_pix = False
            streams_1d.append(_entropy_nals(ho, W, H, G, QP, s))
            streams_sh.append(_entropy_nals(host_outs[f, s], W, H, G, QP, s))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    assert ok_pix, "sharded recon differs from single-device recon"
    b1 = b"".join(n.rbsp for nals in streams_1d for n in nals)
    b2 = b"".join(n.rbsp for nals in streams_sh for n in nals)
    assert b1 == b2 and len(b1) > 0, "sharded stream != single-device stream"
    line = (f"dryrun_multichip ok: mesh={mesh.shape} gops={F} frames={S} "
            f"rows={G} host_outs={host_outs.shape} stream_bytes={len(b1)} "
            "(chained GOP scan + ppermute halos + entropy, byte-exact)")
    print(line)
    return {"line": line, "stream": b2, "host_outs": host_outs,
            "recon_y": recon_y, "ranks": step.ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the sharded GOP encoder's dry run over N ranks")
    ap.add_argument("--devices", type=int, required=True,
                    help="ranks: 2 frame shards when even, N/2 row shards")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl",
                    help="nccl: one card per rank; gloo: the CPU, or ranks "
                         "that share the cards")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
