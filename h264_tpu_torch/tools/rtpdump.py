"""rtpdump equivalent: inspect a JM RTP packet file
(capability parity: rtpdump/rtpdump.cpp).

Usage: python -m h264_tpu_torch.tools.rtpdump file.rtp
"""

from __future__ import annotations

import sys

from ..bitstream.rtp import iter_rtp_packets, parse_rtp_packet

_NAL_NAMES = {
    1: "SLICE", 2: "DPA", 3: "DPB", 4: "DPC", 5: "IDR", 6: "SEI",
    7: "SPS", 8: "PPS", 9: "AUD", 10: "EOSEQ", 11: "EOSTREAM", 12: "FILL",
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__)
        return 1
    data = open(args[0], "rb").read()
    n = 0
    for pkt, intime in iter_rtp_packets(data):
        payload, seq, ts, marker = parse_rtp_packet(pkt)
        hdr = payload[0] if payload else 0
        nt = hdr & 0x1F
        print(
            f"packet {n:5d}  seq {seq:5d}  ts {ts:10d}  m {marker}"
            f"  len {len(pkt):5d}  nal {_NAL_NAMES.get(nt, nt)}"
            f"  nri {(hdr >> 5) & 3}"
        )
        n += 1
    print(f"{n} packets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
