"""lencod of the port: JM-compatible encoder CLI.

Usage (lencod.exe-compatible, lencod/src/configfile.c:170 Configure):
    python -m h264_tpu_torch.lencod [--device DEV] -d encoder.cfg
        [-f more.cfg] [-p Param=Value]

Reads JM .cfg files, encodes the input YUV, writes Annex-B or JM RTP
output, an optional reconstruction file, and per-frame report lines
(image.c:2400 ReportP-style) plus a summary, and the machine-readable
data.txt, stats.dat and log.dat in the working directory.  The encoder's
device work runs on the CUDA card unless ``--device`` names another
(``--device cpu``: the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .bitstream import write_annexb
from .bitstream.rtp import write_rtp, RTP_TR_TIMESTAMP_MULT
from .config import configure_encoder
from .encoder.encoder import H264Encoder
from .io import psnr, read_yuv_frames


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else None
        del args[i: i + 2]
    run = configure_encoder(args)
    cfg = run.enc
    frames = read_yuv_frames(
        run.input_file, cfg.width, cfg.height,
        n_frames=run.frames_to_encode, start=run.start_frame,
        skip=run.frame_skip,
    )
    enc = H264Encoder(cfg, device=device)
    nalus = enc.headers()
    t0 = time.time()
    total_bits = 0
    print(f" Frame   Bit/pic   QP   SnrY    SnrU    SnrV    Time(ms)")
    n_out = 0
    for out in enc.encode_stream(frames):
        bits = sum(8 * (len(n.rbsp) + 5) for n in out)
        total_bits += bits
        nalus.extend(out)
        if enc.all_recons:
            poc, planes = enc.all_recons[-1]
            disp = poc // 2
            src = frames[min(disp, len(frames) - 1)]
            sy = psnr(planes.Y, src[0])
            su = psnr(planes.U, src[1])
            sv = psnr(planes.V, src[2])
            dt = (time.time() - t0) * 1000
            t0 = time.time()
            print(
                f"{n_out:6d}  {bits:8d}  {int(planes_qp(enc)):3d} "
                f"{sy:7.3f} {su:7.3f} {sv:7.3f}  {dt:9.0f}"
            )
        n_out += 1
    if run.out_file_mode == 1:
        ts = [0, 0]  # SPS/PPS share timestamp 0
        t = 0
        for n in nalus[2:]:
            ts.append(t)
            t += RTP_TR_TIMESTAMP_MULT
        data = write_rtp(nalus, ts)
    else:
        data = write_annexb(nalus)
    with open(run.output_file, "wb") as f:
        f.write(data)
    if run.recon_file:
        with open(run.recon_file, "wb") as f:
            groups: list[list] = [[]]
            for poc, planes in enc.all_recons:
                if poc == 0 and groups[-1]:
                    groups.append([])
                groups[-1].append((poc, planes))
            for g in groups:
                for _poc, planes in sorted(g, key=lambda t: t[0]):
                    f.write(planes.to_yuv_bytes())
    n_pics = max(1, len(enc.all_recons) or len(frames))
    kbps = total_bits / n_pics * run.frame_rate / 1000
    print(f" Total bits: {total_bits}  ({kbps:.2f} kbit/s @ {run.frame_rate:g} fps)")
    print(f" Output written to {run.output_file}"
          f" ({'RTP' if run.out_file_mode == 1 else 'Annex B'})")
    _write_machine_stats(run, enc, frames, total_bits, kbps)
    return 0


def _slice_type_of(nal) -> str:
    """First-slice type of a picture's NAL (header ue fields only)."""
    from .bitstream.reader import BitReader

    if nal.nal_unit_type == 5:
        return "I"
    try:
        r = BitReader(nal.rbsp)
        r.ue()  # first_mb_in_slice
        t = r.ue() % 5
        return {0: "P", 1: "B", 2: "I", 3: "SP", 4: "SI"}[t]
    except Exception:
        return "?"


def _write_machine_stats(run, enc, frames, total_bits, kbps):
    """JM-style machine outputs (lencod.c:1181 report / :989
    report_frame_statistic formats, re-shaped): per-frame `data.txt`
    rows, cumulative `stats.dat`, and an append-only one-row-per-run
    `log.dat`."""
    import datetime

    recs = {}
    for poc, pl in enc.all_recons:
        recs.setdefault(poc, pl)
    rows = []
    bits_by_type = {}
    count_by_type = {}
    for i, (poc, pl) in enumerate(sorted(recs.items())):
        disp = poc // 2
        src = frames[min(disp, len(frames) - 1)]
        rows.append((disp, psnr(pl.Y, src[0]), psnr(pl.U, src[1]),
                     psnr(pl.V, src[2])))
    # per-picture bits and types from the written stream
    from .bitstream import iter_annexb_nalus

    seen = []
    try:
        for nal in iter_annexb_nalus(open(run.output_file, "rb").read()):
            if nal.nal_unit_type in (1, 2, 5):
                st = _slice_type_of(nal)
                seen.append((st, 8 * (len(nal.rbsp) + 5)))
    except OSError:
        pass
    for st, b in seen:
        bits_by_type[st] = bits_by_type.get(st, 0) + b
        count_by_type[st] = count_by_type.get(st, 0) + 1
    with open("data.txt", "w") as f:
        f.write("# frame  snr_y  snr_u  snr_v\n")
        for disp, sy, su, sv in rows:
            f.write(f"{disp:5d} {sy:8.3f} {su:8.3f} {sv:8.3f}\n")
    avg = [sum(r[k] for r in rows) / max(1, len(rows)) for k in (1, 2, 3)]
    with open("stats.dat", "w") as f:
        f.write(f" Frames: {len(rows)}\n")
        f.write(f" Bit rate (kbit/s): {kbps:.2f}\n")
        for st in ("I", "P", "B", "SP", "SI"):
            if st in bits_by_type:
                f.write(f" Bits {st}: {bits_by_type[st]} "
                        f"({count_by_type[st]} pics)\n")
        f.write(f" SNR Y/U/V: {avg[0]:.3f} {avg[1]:.3f} {avg[2]:.3f}\n")
    hdr = ("date       | input | frames | qp | kbps | snr_y | snr_u | "
           "snr_v\n")
    import os

    need_hdr = not os.path.exists("log.dat")
    with open("log.dat", "a") as f:
        if need_hdr:
            f.write(hdr)
        f.write(
            f"{datetime.date.today()} | {run.input_file} | {len(rows)} | "
            f"{run.enc.qp} | {kbps:.2f} | {avg[0]:.3f} | {avg[1]:.3f} | "
            f"{avg[2]:.3f}\n")


def planes_qp(enc) -> int:
    return enc.rc.last_qp if enc.rc is not None else enc.cfg.qp


if __name__ == "__main__":
    raise SystemExit(main())
