"""RTP packet-file output/input (JM RTP mode, RFC 3984 single-NAL).

Capability parity with the reference RTP layer: one RTP packet per NALU,
stored in the JM packet-file format — per packet a native-endian uint32
packet length, a uint32 arrival/send time, then the packet bytes
(12-byte RTP header + NAL payload).  Mirrors lencod/src/rtp.c
ComposeRTPPacket/WriteRTPPacket/WriteRTPNALU (:150-:230) and
ldecod/src/rtp.c GetRTPNALU (:159).
"""

from __future__ import annotations

import struct

from .nal import NalUnit, rbsp_to_ebsp, ebsp_to_rbsp

H264PAYLOADTYPE = 105  # lencod/inc/rtp.h:25
H264SSRC = 0x12345678  # lencod/inc/rtp.h:26
RTP_TR_TIMESTAMP_MULT = 3000  # 90 kHz clock at 30 fps


def compose_rtp_packet(payload: bytes, seq: int, timestamp: int,
                       marker: int = 1) -> bytes:
    """12-byte RTP header (v=2, pt=105, seq/ts/ssrc big-endian) + payload."""
    b0 = (2 << 6) | 0  # v=2, p=0, x=0, cc=0
    b1 = ((marker & 1) << 7) | H264PAYLOADTYPE
    return struct.pack(">BBHII", b0, b1, seq & 0xFFFF,
                       timestamp & 0xFFFFFFFF, H264SSRC) + payload


def parse_rtp_packet(packet: bytes):
    """-> (payload, seq, timestamp, marker); raises on malformed header."""
    if len(packet) < 12:
        raise ValueError("RTP packet shorter than header")
    b0, b1, seq, ts, ssrc = struct.unpack(">BBHII", packet[:12])
    if (b0 >> 6) != 2:
        raise ValueError("not an RTP v2 packet")
    cc = b0 & 0x0F
    x = (b0 >> 4) & 1
    off = 12 + 4 * cc
    if x:  # header extension
        if len(packet) < off + 4:
            raise ValueError("truncated RTP extension")
        ext_len = struct.unpack(">H", packet[off + 2 : off + 4])[0]
        off += 4 + 4 * ext_len
    return packet[off:], seq, ts, (b1 >> 7) & 1


def write_rtp(nalus: list[NalUnit], timestamps: list[int] | None = None
              ) -> bytes:
    """Serialize NALUs into a JM RTP packet file (one NALU per packet)."""
    out = bytearray()
    ts = 0
    for i, n in enumerate(nalus):
        payload = bytes([n.header_byte()]) + rbsp_to_ebsp(n.rbsp)
        if timestamps is not None:
            ts = timestamps[i]
        pkt = compose_rtp_packet(payload, seq=i, timestamp=ts, marker=1)
        out += struct.pack("<II", len(pkt), ts)
        out += pkt
    return bytes(out)


def iter_rtp_packets(data: bytes):
    """Yield (packet_bytes, intime) from a JM RTP packet file."""
    off = 0
    n = len(data)
    while off + 8 <= n:
        plen, intime = struct.unpack_from("<II", data, off)
        off += 8
        if off + plen > n:
            raise ValueError("truncated RTP packet file")
        yield data[off : off + plen], intime
        off += plen


def read_rtp(data: bytes) -> list[NalUnit]:
    """Parse a JM RTP packet file into NAL units (GetRTPNALU dual)."""
    nalus = []
    for pkt, _t in iter_rtp_packets(data):
        payload, seq, ts, marker = parse_rtp_packet(pkt)
        if not payload:
            continue
        hdr = payload[0]
        nalus.append(
            NalUnit(
                nal_unit_type=hdr & 0x1F,
                nal_ref_idc=(hdr >> 5) & 3,
                rbsp=ebsp_to_rbsp(payload[1:]),
                forbidden_zero_bit=(hdr >> 7) & 1,
            )
        )
    return nalus
