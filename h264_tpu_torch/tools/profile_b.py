"""Where a B picture's time goes on the CUDA card.

    python -m h264_tpu_torch.tools.profile_b [--frames N] [--out DIR]

Encodes an IPB stream of moving, fading content (``synthseq.
moving_frames``) at CIF and 1280x720 in the bench configuration (CABAC,
QP 28, one B picture between anchors, 5 reference frames, search range
28, explicit WP on the P pictures) through ``H264Encoder(...,
device="cuda").encode_stream`` with pipeline depth 1, so every step
dispatches and finishes one picture, and reports per B picture (N B
pictures after a warm one):

- host-clock phases, each bracketed by ``torch.cuda.synchronize``: the
  stages of ``rd_b.rd_b_pipeline`` (search, argmin, refine16, halves,
  direct, p8, decide, winner, commit, deblock, outputs), the fetch of
  ``host_out``, the parse-state fill (with temporal direct), the CABAC
  writer and the rest of the picture;
- from ``torch.profiler`` over one further B picture (no synchronize
  inside): the device-busy time, the kernels with the most device time,
  and the device's idle share of the picture's wall time.

Prints the card's name and power limit and one JSON line per size; with
``--out DIR`` also writes ``DIR/profile_b.json``.  Needs a CUDA card.
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
from ..encoder import rd_b as RDB
from ..encoder.syntax_cabac import CabacSliceWriter
from .devprof import device_profile
from .synthseq import moving_frames

SIZES = ((352, 288), (1280, 720))


def _cfg(W: int, H: int):
    return E.EncoderConfig(width=W, height=H, qp=28, fast=True, rd=True,
                           entropy="cabac", b_frames=1, num_ref_frames=5,
                           search_range=28, weighted_pred=True)


class _Steps:
    """Drive an IPB encode one picture per step."""

    def __init__(self, size, n_frames: int, seed: int):
        W, H = size
        self.enc = E.H264Encoder(_cfg(W, H), device="cuda")
        self.enc.picture_log = []
        self.gen = self.enc.encode_stream(
            moving_frames(n_frames, W, H, seed=seed), depth=1)

    def step(self) -> str:
        """Encode the next picture; returns its type ("I", "P" or "B")."""
        log = self.enc.picture_log
        n = len(log)
        next(self.gen)
        if len(log) != n + 1:
            raise RuntimeError("profile_b: a step finished "
                               f"{len(log) - n} pictures")
        return log[-1][0]

    def until_before_b(self):
        """Step until the next step is a B picture's (a P just finished:
        its B follows it in decode order)."""
        while self.step() != "P":
            pass


def _phases(size, n: int) -> dict:
    acc = collections.defaultdict(float)
    in_b = [False]

    def timed(name, fn, only_b=False):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if in_b[0] or not only_b:
                acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = (RDB.B_STAGES, RDB.b_outputs, E.fetch_group,
             E.H264Encoder._fill_b_state_rd, CabacSliceWriter.write_slice_data,
             E.H264Encoder._start_b_rd, E.H264Encoder._start_p_rd)
    steps = _Steps(size, 2 * n + 4, seed=5)
    steps.until_before_b()
    steps.step()  # a warm B picture: build, first launches
    try:
        RDB.B_STAGES = tuple(timed(s.__name__[2:], s) for s in saved[0])
        RDB.b_outputs = timed("outputs", saved[1])
        E.fetch_group = timed("fetch", saved[2], only_b=True)
        E.H264Encoder._fill_b_state_rd = timed("fill", saved[3])
        CabacSliceWriter.write_slice_data = timed("cabac", saved[4],
                                                  only_b=True)

        def mark(fn, flag):
            def wrapper(*a, **k):
                in_b[0] = flag
                return fn(*a, **k)
            return wrapper

        E.H264Encoder._start_b_rd = mark(saved[5], True)
        E.H264Encoder._start_p_rd = mark(saved[6], False)
        done = 0
        while done < n:
            steps.until_before_b()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if steps.step() != "B":
                raise RuntimeError("profile_b: expected a B picture")
            torch.cuda.synchronize()
            acc["total"] += (time.perf_counter() - t0) * 1e3
            done += 1
    finally:
        (RDB.B_STAGES, RDB.b_outputs, E.fetch_group,
         E.H264Encoder._fill_b_state_rd, CabacSliceWriter.write_slice_data,
         E.H264Encoder._start_b_rd, E.H264Encoder._start_p_rd) = saved
    per = {k: v / n for k, v in acc.items()}
    per["other"] = per["total"] - sum(v for k, v in per.items()
                                      if k != "total")
    return {k: round(v, 3) for k, v in per.items()}


def _device_profile(size) -> dict:
    steps = _Steps(size, 7, seed=6)
    steps.until_before_b()
    steps.step()  # warm B
    steps.until_before_b()
    kind, report = device_profile(steps.step, 14)
    if kind != "B":
        raise RuntimeError("profile_b: expected a B picture")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3,
                    help="B pictures timed per size")
    ap.add_argument("--out", help="directory for profile_b.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_b: needs a CUDA card")
    report = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    print(report["device"])
    for size in SIZES:
        key = f"{size[0]}x{size[1]}"
        report[key] = {"phases_ms_per_b_picture": _phases(size, args.frames),
                       "one_b_picture": _device_profile(size)}
        print(json.dumps({key: report[key]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_b.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
