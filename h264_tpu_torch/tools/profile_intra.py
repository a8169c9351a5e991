"""Where an all-intra picture's time goes on the CUDA card.

    python -m h264_tpu_torch.tools.profile_intra [--frames N] [--out DIR]

Encodes N seeded CIF and 1280x720 pictures (QP 28) through
``H264Encoder(..., device="cuda")`` and reports, per picture size:

- host-clock phases (each bracketed by ``torch.cuda.synchronize``): the
  device intra decision (``_device_intra_picture``: the commit scan, the
  copy of its outputs to the host and the parse-state fill), of which the
  commit scan alone; the host deblock; the CABAC writer; the reference
  entry; the rest of ``encode_frame``;
- from ``torch.profiler`` over one further picture: the device-busy time
  (sum of kernel and copy time on the card), each kernel's total time and
  count, and the device's idle share of the picture's wall time.

Prints the card's name and power limit and one JSON line per size; with
``--out DIR`` also writes ``DIR/profile_intra.json``.  Needs a CUDA card.
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
from ..encoder import rd
from ..encoder.syntax_cabac import CabacSliceWriter
from .devprof import device_profile
from .synthseq import synthetic_frames

SIZES = ((352, 288), (1280, 720))


def _phases(size, n: int) -> dict:
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = (rd.rd_i_pipeline, rd.ref_entry_from_planes, E.deblock_picture,
             CabacSliceWriter.write_slice_data,
             E.H264Encoder._device_intra_picture)
    try:
        rd.rd_i_pipeline = timed("scan", saved[0])
        rd.ref_entry_from_planes = timed("ref_entry", saved[1])
        E.deblock_picture = timed("deblock", saved[2])
        CabacSliceWriter.write_slice_data = timed("cabac", saved[3])
        E.H264Encoder._device_intra_picture = timed("intra", saved[4])
        W, H = size
        enc = E.H264Encoder(E.EncoderConfig(
            width=W, height=H, qp=28, fast=True, entropy="cabac",
            idr_period=1), device="cuda")
        frames = synthetic_frames(n + 1, W, H, seed=5)
        enc.encode_frame(frames[0], True)  # warm: build, first launches
        acc.clear()
        t0 = time.perf_counter()
        for f in frames[1:]:
            enc.encode_frame(f, True)
        torch.cuda.synchronize()
        acc["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        (rd.rd_i_pipeline, rd.ref_entry_from_planes, E.deblock_picture,
         CabacSliceWriter.write_slice_data,
         E.H264Encoder._device_intra_picture) = saved
    per = {k: v / n for k, v in acc.items()}
    per["other"] = per["total"] - sum(
        per[k] for k in ("intra", "deblock", "cabac", "ref_entry"))
    return {k: round(v, 3) for k, v in per.items()}


def _device_profile(size) -> dict:
    W, H = size
    enc = E.H264Encoder(E.EncoderConfig(
        width=W, height=H, qp=28, fast=True, entropy="cabac", idr_period=1),
        device="cuda")
    frames = synthetic_frames(2, W, H, seed=6)
    enc.encode_frame(frames[0], True)
    return device_profile(lambda: enc.encode_frame(frames[1], True),
                          6)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", help="directory for profile_intra.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_intra: needs a CUDA card")
    report = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    print(report["device"])
    for size in SIZES:
        key = f"{size[0]}x{size[1]}"
        report[key] = {"phases_ms_per_picture": _phases(size, args.frames),
                       "one_picture": _device_profile(size)}
        print(json.dumps({key: report[key]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_intra.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
