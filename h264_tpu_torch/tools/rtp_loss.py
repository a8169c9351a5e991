"""rtp_loss equivalent: drop a percentage of packets from a JM RTP file
(capability parity: rtp_loss/rtp_loss.cpp — deterministic unseeded PRNG,
first `keep_first` packets always kept so parameter sets survive).

Usage: python -m h264_tpu_torch.tools.rtp_loss in.rtp out.rtp loss_percent [seed]
"""

from __future__ import annotations

import random
import struct
import sys

from ..bitstream.rtp import iter_rtp_packets


def apply_loss(data: bytes, loss_percent: float, seed: int = 0,
               keep_first: int = 3) -> tuple[bytes, int, int]:
    rng = random.Random(seed)  # deterministic, like rand() unseeded
    out = bytearray()
    n = dropped = 0
    for pkt, intime in iter_rtp_packets(data):
        keep = n < keep_first or rng.random() * 100.0 >= loss_percent
        if keep:
            out += struct.pack("<II", len(pkt), intime)
            out += pkt
        else:
            dropped += 1
        n += 1
    return bytes(out), n, dropped


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (3, 4):
        print(__doc__)
        return 1
    data = open(args[0], "rb").read()
    seed = int(args[3]) if len(args) == 4 else 0
    out, n, dropped = apply_loss(data, float(args[2]), seed)
    open(args[1], "wb").write(out)
    print(f"{n} packets in, {dropped} dropped ({dropped / max(1, n) * 100:.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
