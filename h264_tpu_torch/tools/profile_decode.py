"""Where a decoded picture's time goes on the CUDA card.

    python -m h264_tpu_torch.tools.profile_decode [--out DIR]

Encodes an IPB stream of moving, fading content (``synthseq.
moving_frames``) at CIF (9 frames) and 1280x720 (5 frames) in the bench
configuration (CABAC, QP 28, one B picture between anchors, 5 reference
frames, search range 28, explicit WP) with the port's encoder on the
card, then decodes it with ``H264Decoder(device="cuda")`` and reports,
per picture type (the first decode warms up and is not counted):

- host-clock phases, each bracketed by ``torch.cuda.synchronize``: the
  slice parse (native CABAC reader), ``derive_mvs`` (MV derivation), the
  reference banks (K2, ``picture_bank``), K8's argument tables and their
  copies to the card, K8 itself, the fetch of K8's output and the commit
  of the inter MBs, the intra MBs' ``recon_mb``, the deblocking filter,
  and the rest;
- the same stream's time per picture through the native host path
  (``use_device=False``);
- from ``torch.profiler`` over the whole device-path decode (no
  synchronize inside): device-busy time, the kernels with the most
  device time, and the device's idle share of the wall time.

Prints the card's name and power limit and one JSON line per size; with
``--out DIR`` also writes ``DIR/profile_decode.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import torch

from ..bitstream import write_annexb
from ..decoder import decoder as DD
from ..decoder import device as DEV
from ..decoder.recon import PictureReconstructor
from ..encoder.encoder import EncoderConfig, H264Encoder
from .devprof import device_profile
from .synthseq import moving_frames

SIZES = {(352, 288): 9, (1280, 720): 5}


def ipb_stream(W: int, H: int, n: int, seed: int = 5):
    """An IPB stream of the bench configuration, encoded by the port on
    the card."""
    cfg = EncoderConfig(width=W, height=H, qp=28, fast=True, rd=True,
                        entropy="cabac", b_frames=1, num_ref_frames=5,
                        search_range=28, weighted_pred=True)
    enc = H264Encoder(cfg)
    nalus = enc.headers()
    for out in enc.encode_stream(moving_frames(n, W, H, seed=seed)):
        nalus.extend(out)
    return write_annexb(nalus)


def timed_decode(data: bytes, **dec_kw):
    """Decode `data` with ``H264Decoder(**dec_kw)``; returns (pictures in
    decode order, [(type, ms)]): each picture's host-clock time is its
    slices' parse plus its ``_finish_picture``, which ends in a copy from
    the card (so the card's work is inside)."""
    dec = DD.H264Decoder(**dec_kw)
    cur = [0.0]
    times = []

    def timed(fn, finish):
        def wrapper(*a, **k):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            cur[0] += (time.perf_counter() - t0) * 1e3
            if finish:
                times.append((out.slice_type.name, cur[0]))
                cur[0] = 0.0
            return out
        return wrapper

    dec._parse_slice = timed(dec._parse_slice, False)
    dec._finish_picture = timed(dec._finish_picture, True)
    pics = list(dec.decode_stream(data))
    return pics, times


def mean_by_type(times) -> dict:
    by = collections.defaultdict(list)
    for kind, ms in times:
        by[kind].append(ms)
    return {k: {"ms": round(sum(v) / len(v), 3), "n": len(v)}
            for k, v in sorted(by.items())}


def _phases(data: bytes) -> dict:
    """Mean host-clock phases per picture type of a device-path decode."""
    acc = collections.defaultdict(float)
    per_pic = []

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def dip(*a, **k):
        res = saved["dip"](*a, **k)
        if res is None:
            return res
        inter, fin = res
        return inter, timed("fetch+commit", fin)

    saved = {"mvs": DD.derive_mvs, "deblock": DD.deblock_picture,
             "dip": DEV.decode_inter_picture, "bank": DEV.picture_bank,
             "k8": DEV.decode_inter, "intra": PictureReconstructor.recon_mb}
    try:
        DD.derive_mvs = timed("derive_mvs", saved["mvs"])
        DD.deblock_picture = timed("deblock", saved["deblock"])
        DEV.picture_bank = timed("bank (K2)", saved["bank"])
        DEV.decode_inter = timed("K8", saved["k8"])
        PictureReconstructor.recon_mb = timed("intra recon_mb",
                                              saved["intra"])
        # decode_inter_picture = tables and their copies, banks, K8 (the
        # last two timed above too); the decoder imports it at call time
        DEV.decode_inter_picture = timed("K8 args+banks+K8", dip)
        dec = DD.H264Decoder(device="cuda")
        t_pic = [0.0]

        def wrap(fn, finish):
            def wrapper(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                if not finish:
                    acc["parse"] += dt
                t_pic[0] += dt
                if finish:
                    per_pic.append((out.slice_type.name, dict(acc),
                                    t_pic[0]))
                    acc.clear()
                    t_pic[0] = 0.0
                return out
            return wrapper

        dec._parse_slice = wrap(dec._parse_slice, False)
        dec._finish_picture = wrap(dec._finish_picture, True)
        list(dec.decode_stream(data))
    finally:
        DD.derive_mvs, DD.deblock_picture = saved["mvs"], saved["deblock"]
        DEV.decode_inter_picture = saved["dip"]
        DEV.picture_bank, DEV.decode_inter = saved["bank"], saved["k8"]
        PictureReconstructor.recon_mb = saved["intra"]
    out = {}
    for kind in ("I", "P", "B"):
        sel = [(ph, tot) for k, ph, tot in per_pic if k == kind]
        if not sel:
            continue
        n = len(sel)
        names = sorted({k for ph, _ in sel for k in ph})
        mean = {k: sum(ph.get(k, 0.0) for ph, _ in sel) / n for k in names}
        tot = sum(t for _, t in sel) / n
        inner = mean.pop("K8 args+banks+K8", 0.0)
        mean["K8 args (tables, copies)"] = (
            inner - mean.get("bank (K2)", 0.0) - mean.get("K8", 0.0))
        mean["other"] = tot - sum(mean.values())
        mean["total"] = tot
        out[kind] = {"n": n, **{k: round(v, 3) for k, v in mean.items()}}
    return out


def _device_profile(data: bytes) -> dict:
    pics, report = device_profile(
        lambda: DD.decode_annexb(data, device="cuda"), 10)
    return {"pictures": len(pics), **report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for profile_decode.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA card")
    report = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    print(report["device"])
    for (W, H), n in SIZES.items():
        data = ipb_stream(W, H, n)
        timed_decode(data, device="cuda")  # warm: builds, first launches
        _, dev_t = timed_decode(data, device="cuda")
        _, host_t = timed_decode(data, use_device=False)
        key = f"{W}x{H}"
        report[key] = {
            "stream_bytes": len(data),
            "device_path_ms": mean_by_type(dev_t),
            "host_path_ms": mean_by_type(host_t),
            "phases_ms_per_picture": _phases(data),
            "whole_stream": _device_profile(data)}
        print(json.dumps({key: report[key]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_decode.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
