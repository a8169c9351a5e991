"""Where a host-path picture's time goes on the CUDA card.

    python -m h264_tpu_torch.tools.profile_host [--frames N] [--entropy
        cavlc|cabac] [--out DIR]

Encodes N frames (default 7: I P B P B P B) of moving, fading content
(``synthseq.moving_frames``) at CIF on the host path, the reference's
default configuration (``fast=False``, QP 28, search range 16) with one B
picture between anchors, through ``H264Encoder(..., device="cuda")
.encode_stream``, and reports per picture type (the I picture and the
first P, which carries the kernel build, left out):

- host-clock phases: the SAD grids (``me.compute_sad_grids``: padding,
  uploads, kernel K10, the one fetch; bracketed by
  ``torch.cuda.synchronize``), the MB loop (``_FrameEncoder.encode_mb``,
  numpy), the deblocking filter, the entropy writer and the rest;
- from ``torch.profiler`` over one further P and one further B picture:
  the device-busy time, the kernels with the most device time, and the
  device's idle share of the picture's wall time.

Prints the card's name and power limit and one JSON line; with ``--out
DIR`` also writes ``DIR/profile_host.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import torch

from ..encoder import encoder as E
from ..encoder import me as ME
from ..encoder.syntax_cabac import CabacSliceWriter
from ..encoder.syntax_cavlc import CavlcSliceWriter
from .devprof import device_profile
from .synthseq import moving_frames

SIZE = (352, 288)


def _cfg(entropy: str):
    return E.EncoderConfig(width=SIZE[0], height=SIZE[1], qp=28,
                           entropy=entropy, b_frames=1)


def _timed(acc, name, fn, sync: bool):
    def wrapper(*a, **k):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        acc[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def _phases(n: int, entropy: str) -> dict:
    """Mean phase ms per P and B picture after the I and the first P."""
    acc = collections.defaultdict(float)
    per = {"P": collections.defaultdict(float),
           "B": collections.defaultdict(float)}
    count = collections.Counter()
    saved = (ME.compute_sad_grids, E._FrameEncoder.encode_mb,
             E.deblock_picture, CabacSliceWriter.write_slice_data,
             CavlcSliceWriter.write_slice_data)
    enc = E.H264Encoder(_cfg(entropy), device="cuda")
    enc.picture_log = log = []
    gen = enc.encode_stream(moving_frames(n, *SIZE, seed=5), depth=1)
    next(gen)  # the I picture
    next(gen)  # the first P picture: the kernel build, first launches
    try:
        ME.compute_sad_grids = _timed(acc, "sad_grids", saved[0], True)
        E._FrameEncoder.encode_mb = _timed(acc, "mb_loop", saved[1], False)
        E.deblock_picture = _timed(acc, "deblock", saved[2], False)
        CabacSliceWriter.write_slice_data = _timed(acc, "entropy", saved[3],
                                                   False)
        CavlcSliceWriter.write_slice_data = _timed(acc, "entropy", saved[4],
                                                   False)
        for _ in range(n - 2):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            next(gen)
            torch.cuda.synchronize()
            acc["total"] = (time.perf_counter() - t0) * 1e3
            kind = log[-1][0]
            count[kind] += 1
            for k, v in acc.items():
                per[kind][k] += v
    finally:
        (ME.compute_sad_grids, E._FrameEncoder.encode_mb, E.deblock_picture,
         CabacSliceWriter.write_slice_data,
         CavlcSliceWriter.write_slice_data) = saved
    out = {}
    for kind, ph in per.items():
        if not count[kind]:
            continue
        m = {k: v / count[kind] for k, v in ph.items()}
        m["other"] = m["total"] - sum(v for k, v in m.items()
                                      if k != "total")
        out[kind] = {"pictures": count[kind],
                     **{k: round(v, 3) for k, v in m.items()}}
    return out


def _device_profile(entropy: str) -> dict:
    """torch.profiler over the third P and the second B picture."""
    enc = E.H264Encoder(_cfg(entropy), device="cuda")
    enc.picture_log = log = []
    gen = enc.encode_stream(moving_frames(7, *SIZE, seed=6), depth=1)
    for _ in range(4):  # I P B P
        next(gen)
    out = {}
    for _ in range(2):  # P B
        _, report = device_profile(lambda: next(gen), 8)
        out[log[-1][0]] = report
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=7)
    ap.add_argument("--entropy", choices=("cavlc", "cabac"), default="cavlc")
    ap.add_argument("--out", help="directory for profile_host.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_host: needs a CUDA card")
    report = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    print(report["device"])
    report["config"] = {"size": f"{SIZE[0]}x{SIZE[1]}",
                        "entropy": args.entropy, "frames": args.frames}
    report["phases_ms_per_picture"] = _phases(args.frames, args.entropy)
    report["one_picture"] = _device_profile(args.entropy)
    print(json.dumps(report))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_host.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
