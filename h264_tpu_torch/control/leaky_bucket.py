"""Leaky-bucket (HRD) parameter computation.

Algorithm port of the reference encoder's bucket analysis
(lencod/src/leaky_bucket.c:202 calc_buffer / PacketizedPicture sizes):
given the per-picture bit counts of a coded sequence and a set of
candidate transmission rates, compute for each rate R the minimum
decoder buffer size B and initial fullness F such that the buffer never
underflows — the (R, B, F) triples the reference writes to
leakybucketparam.cfg and signals via VUI HRD (parset.c:1101).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BucketParams:
    rate: float          # bits per second
    buffer_size: float   # bits (B)
    initial_fullness: float  # bits (F)


def calc_buffer(frame_bits, rates, frame_rate: float) -> list[BucketParams]:
    """Minimum (B, F) per rate for constant-rate drain at `frame_rate`.

    The decoder model: before decoding picture n the buffer has received
    n * R / frame_rate bits plus the initial fullness F; decoding
    instantaneously removes bits_n.  Underflow-free means
    F >= max_n (sum_{k<=n} bits_k - n * R / frame_rate); the buffer must
    hold B >= F (reference calc_buffer computes the same prefix maxima).
    """
    out = []
    for rate in rates:
        per_frame = float(rate) / float(frame_rate)
        cum = 0.0
        worst = 0.0  # max prefix shortfall -> required initial fullness
        level_peak = 0.0
        for n, bits in enumerate(frame_bits):
            cum += float(bits)
            shortfall = cum - n * per_frame
            if shortfall > worst:
                worst = shortfall
            if cum - (n + 1) * per_frame + per_frame > level_peak:
                level_peak = cum - n * per_frame
        F = max(worst, 0.0)
        B = max(F, level_peak)
        out.append(BucketParams(rate=float(rate), buffer_size=B,
                                initial_fullness=F))
    return out


def verify_bucket(frame_bits, params: BucketParams,
                  frame_rate: float) -> bool:
    """HRD check: no underflow with (R, B, F) over the sequence
    (the decoder-side dual, ldecod/src/leaky_bucket.c)."""
    per_frame = params.rate / frame_rate
    level = params.initial_fullness
    for bits in frame_bits:
        if level < bits - 1e-6:
            return False
        level = min(params.buffer_size, level - bits + per_frame)
    return True
