"""Does the reference encoder's B recon agree with what a decoder
reconstructs when a direct window leaves the padded reference banks?

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/b_window_probe.py

``rd_b_pipeline`` reads its direct predictions through
``jax.lax.dynamic_slice``, which moves a window that would leave the bank
(a negative start wraps to the far edge, then the start is clamped), while
a decoder clamps each sample to the picture.  This script encodes five
176x144 frames of a 36-pixel-a-frame horizontal pan (IPB, one B picture
between anchors, 2 reference frames, search range 28, QP 28) with the JAX
package and with the port, counts in the port (bit-exact with the
reference) the direct units of each B picture whose window was moved,
decodes the reference's stream with ``h264_tpu.decoder`` and compares
every decoded picture with the encoder's recon.  Not part of the tests:
it compiles the reference's pipelines at R = 28 (minutes on a CPU).
"""

import numpy as np
import torch

from h264_tpu.decoder.decoder import decode_annexb
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.encoder import rd_b as TB
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, N = 176, 144, 5
KW = dict(width=W, height=H, qp=28, fast=True, rd=True, entropy="cabac",
          b_frames=1, num_ref_frames=2, search_range=28)


def moved_direct_units(f: TB.BFrame) -> int:
    """Direct units (16x16 direct, direct-zero, P8x8 direct units) of the
    picture whose list-0 or list-1 window starts outside the bank."""
    _, _, y0, x0 = TB._units(f.n_mb, f.n_mx, f.dev)
    Hp, Wp = f.H + 2 * TRD.PAD, f.W + 2 * TRD.PAD
    moved = torch.zeros_like(f.u0_8)
    for mx, my in ((f.w_m0x, f.w_m0y), (f.w_m1x, f.w_m1y)):
        iy = y0 + (my >> 2) + TRD.PAD
        ix = x0 + (mx >> 2) + TRD.PAD
        moved |= (iy < 0) | (iy > Hp - 10) | (ix < 0) | (ix > Wp - 10)
    direct = (((f.win == TRD.B_DIRECT) | (f.win == TRD.B_DIRECT_ZERO))[:, None]
              | ((f.win == TRD.B_P8X8)[:, None] & (f.pdir8 == 3)))
    return int((moved & direct).sum())


def main():
    frames = moving_frames(N, W, H, seed=3, pan=(0.0, 36.0), fade=0.0)
    counts = []
    winner = TB.b_winner

    def counting(f):
        winner(f)
        counts.append(moved_direct_units(f))

    TB.B_STAGES = tuple(counting if s is winner else s for s in TB.B_STAGES)
    port = H264Encoder(EncoderConfig(**KW), device="cpu").encode_sequence(
        frames)
    print("direct units with moved windows, per B picture:", counts)
    jenc = JaxEncoder(JaxConfig(**KW))
    stream = jenc.encode_sequence(frames)
    print("reference stream equal to the port's:", stream == port)
    recs = sorted(jenc.all_recons, key=lambda e: e[0])
    for pic, (poc, rec) in zip(decode_annexb(stream), recs):
        a = np.asarray(pic.planes.Y, np.int64)
        b = np.asarray(rec.Y, np.int64)
        print(f"POC {poc}: decoder vs encoder recon: {int((a != b).sum())} "
              f"luma samples differ, max |diff| {int(np.abs(a - b).max())}")


if __name__ == "__main__":
    main()
