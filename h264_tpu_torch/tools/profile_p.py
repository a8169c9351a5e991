"""Where a P picture's time goes on the CUDA card.

    python -m h264_tpu_torch.tools.profile_p [--frames N] [--entropy
        cabac|cavlc] [--t8] [--rows G] [--rc BITRATE] [--legacy]
        [--out DIR]

Encodes 1 I + N P pictures of moving, fading content (``synthseq.
moving_frames``) at CIF and 1280x720 in the P half of the bench
configuration (CABAC by default, QP 28, 5 reference frames, search range
28, explicit WP; ``--t8`` adds the 8x8 transform of the High profile;
``--rows G`` codes each P picture as G tile-row slices and ``--rc
BITRATE`` runs the rate control at BITRATE bits/s, both without WP, which
the encoder refuses with them) through ``H264Encoder(..., device="cuda")
.encode_stream`` with pipeline depth 1, and reports per P picture:

- host-clock phases, each bracketed by ``torch.cuda.synchronize``: the
  stages of ``rd_p.rd_p_pipeline`` (search, partitions, refine, sub8,
  decide, winner, t8, commit, deblock, outputs; with tile rows each
  stage summed over the groups, and the slab copy ``slabs`` and the
  whole-picture reference entry ``bank`` beside them), the fetch of
  ``host_out``, the parse-state fill, the entropy writer (``cabac`` or
  ``cavlc``; CAVLC slices with the 8x8 transform take the Python writer)
  and the rest of the picture (the rate control's picks among it);
- from ``torch.profiler`` over one further P picture (no synchronize
  inside): the device-busy time, the kernels with the most device time,
  and the device's idle share of the picture's wall time.

``--legacy`` profiles the legacy P16x16 picture instead (``rd=False``:
one reference, search range 28, no WP) with the phases of
``fast.p_frame_pipeline`` and its host tail: the upload of the current
planes, K12 (``search``), K13 (``refine``), K6 (``deblock``: strengths
and filter), K2 (``next_ref``: the padded and half-pel planes), the
pipeline's glue, the fetch, ``_fill_p_state`` (``fill``) and the writer.

Prints the card's name and power limit and one JSON line per size; with
``--out DIR`` also writes ``DIR/profile_p.json`` (``profile_p_cavlc.json``,
``profile_p_t8.json``, ``profile_p_cavlc_t8.json``, ``..._rows3``,
``..._rc``, ``..._legacy`` with the switches).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import time

import torch

from ..encoder import encoder as E
from ..encoder import fast as FAST
from ..encoder import rd_p as RDP
from ..encoder import rd_rows as RDR
from ..encoder.syntax_cabac import CabacSliceWriter
from ..encoder.syntax_cavlc import CavlcSliceWriter
from .devprof import device_profile
from .synthseq import moving_frames

SIZES = ((352, 288), (1280, 720))


def _cfg(W: int, H: int, entropy: str = "cabac", t8: bool = False,
         rows: int = 1, rc: float = 0.0, legacy: bool = False):
    if legacy:
        return E.EncoderConfig(width=W, height=H, qp=28, fast=True,
                               rd=False, entropy=entropy, search_range=28)
    return E.EncoderConfig(width=W, height=H, qp=28, fast=True, rd=True,
                           entropy=entropy, b_frames=0, num_ref_frames=5,
                           search_range=28,
                           weighted_pred=rows == 1 and not rc,
                           transform8x8=t8, row_slices=rows, rc_bitrate=rc)


def _timer(acc):
    """timed(name, fn): fn, its host-clock ms added to acc[name], each
    call bracketed by torch.cuda.synchronize."""
    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper
    return timed


def _legacy_phases(size, n: int, entropy: str) -> dict:
    """Per legacy P picture: the dispatch split into the upload, the
    kernels and the pipeline's glue, then the fetch, the fill, the writer
    and the rest."""
    acc = collections.defaultdict(float)
    timed = _timer(acc)
    W, H = size
    frames = moving_frames(n + 2, W, H, seed=5)
    enc = E.H264Encoder(_cfg(W, H, entropy, legacy=True), device="cuda")
    gen = enc.encode_stream(frames, depth=1)
    next(gen)  # the I picture
    next(gen)  # a warm P picture: build, first launches
    saved = (E.H264Encoder._start_p_legacy, FAST.p_frame_pipeline,
             E.fetch_group, E.H264Encoder._fill_p_state,
             CabacSliceWriter.write_slice_data,
             CavlcSliceWriter.write_slice_data)
    k = FAST.default_kernels()
    try:
        E.H264Encoder._start_p_legacy = timed("dispatch", saved[0])
        FAST.p_frame_pipeline = timed("pipeline", saved[1])
        enc._legacy_kernels = FAST.LKernels(
            timed("search", k.p16_search), timed("refine", k.p16_refine),
            timed("deblock", k.strengths), timed("deblock", k.deblock),
            timed("next_ref", k.ref_bank))
        E.fetch_group = timed("fetch", saved[2])
        E.H264Encoder._fill_p_state = timed("fill", saved[3])
        CabacSliceWriter.write_slice_data = timed("cabac", saved[4])
        CavlcSliceWriter.write_slice_data = timed("cavlc", saved[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            next(gen)
        torch.cuda.synchronize()
        acc["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        (E.H264Encoder._start_p_legacy, FAST.p_frame_pipeline,
         E.fetch_group, E.H264Encoder._fill_p_state,
         CabacSliceWriter.write_slice_data,
         CavlcSliceWriter.write_slice_data) = saved
    per = {key: v / n for key, v in acc.items()}
    kern = sum(per[key] for key in ("search", "refine", "deblock",
                                    "next_ref"))
    per["upload"] = per.pop("dispatch") - per["pipeline"]
    per["glue"] = per.pop("pipeline") - kern
    per["other"] = per["total"] - sum(v for key, v in per.items()
                                      if key != "total")
    return {key: round(v, 3) for key, v in per.items()}


def _phases(size, n: int, entropy: str, t8: bool, rows: int,
            rc: float) -> dict:
    acc = collections.defaultdict(float)
    timed = _timer(acc)

    saved = (RDP.P_STAGES, RDP.p_outputs, E.fetch_group,
             E.H264Encoder._fill_p_state_rd, CabacSliceWriter.write_slice_data,
             CavlcSliceWriter.write_slice_data, RDP.p_host_out,
             RDR.row_slabs)
    W, H = size
    frames = moving_frames(n + 2, W, H, seed=5)
    enc = E.H264Encoder(_cfg(W, H, entropy, t8, rows, rc), device="cuda")
    gen = enc.encode_stream(frames, depth=1)
    next(gen)  # the I picture
    next(gen)  # a warm P picture: build, first launches
    try:
        RDP.P_STAGES = tuple(timed(s.__name__[2:], s) for s in saved[0])
        if rows > 1:  # the groups' host buffers; the slabs and the bank
            RDP.p_host_out = timed("outputs", saved[6])
            RDR.row_slabs = timed("slabs", saved[7])
            k = RDP.default_kernels()
            enc._p_kernels = dataclasses.replace(
                k, ref_bank=timed("bank", k.ref_bank))
        else:
            RDP.p_outputs = timed("outputs", saved[1])
        E.fetch_group = timed("fetch", saved[2])
        E.H264Encoder._fill_p_state_rd = timed("fill", saved[3])
        CabacSliceWriter.write_slice_data = timed("cabac", saved[4])
        CavlcSliceWriter.write_slice_data = timed("cavlc", saved[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            next(gen)
        torch.cuda.synchronize()
        acc["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        (RDP.P_STAGES, RDP.p_outputs, E.fetch_group,
         E.H264Encoder._fill_p_state_rd, CabacSliceWriter.write_slice_data,
         CavlcSliceWriter.write_slice_data, RDP.p_host_out,
         RDR.row_slabs) = saved
    per = {k: v / n for k, v in acc.items()}
    per["other"] = per["total"] - sum(v for k, v in per.items()
                                      if k != "total")
    return {k: round(v, 3) for k, v in per.items()}


def _device_profile(size, entropy: str, t8: bool, rows: int,
                    rc: float, legacy: bool = False) -> dict:
    W, H = size
    enc = E.H264Encoder(_cfg(W, H, entropy, t8, rows, rc, legacy),
                        device="cuda")
    gen = enc.encode_stream(moving_frames(4, W, H, seed=6), depth=1)
    for _ in range(3):
        next(gen)
    return device_profile(lambda: next(gen), 12)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--entropy", choices=("cabac", "cavlc"), default="cabac")
    ap.add_argument("--t8", action="store_true",
                    help="the 8x8 transform (High profile)")
    ap.add_argument("--rows", type=int, default=1,
                    help="tile-row slices per P picture (no WP)")
    ap.add_argument("--rc", type=float, default=0.0,
                    help="rate control at this many bits/s (no WP)")
    ap.add_argument("--legacy", action="store_true",
                    help="the legacy P16x16 picture (rd=False)")
    ap.add_argument("--out", help="directory for profile_p.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_p: needs a CUDA card")
    report = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    print(report["device"])
    report["config"] = {"entropy": args.entropy, "t8": args.t8,
                        "rows": args.rows, "rc_bitrate": args.rc,
                        "legacy": args.legacy}
    opts = (args.entropy, args.t8, args.rows, args.rc)
    for size in SIZES:
        key = f"{size[0]}x{size[1]}"
        report[key] = {
            "phases_ms_per_p_picture": (
                _legacy_phases(size, args.frames, args.entropy)
                if args.legacy else _phases(size, args.frames, *opts)),
            "one_p_picture": _device_profile(size, *opts, args.legacy)}
        print(json.dumps({key: report[key]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "profile_p" + ("_cavlc" if args.entropy == "cavlc" else "") + (
            "_t8" if args.t8 else "") + (
            f"_rows{args.rows}" if args.rows > 1 else "") + (
            "_rc" if args.rc else "") + ("_legacy" if args.legacy else "")
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
