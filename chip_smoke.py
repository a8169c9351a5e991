#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h264_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

1. builds the CUDA kernels K1-K6 (nvcc, sm_90a, one process per source,
   all at once) and the host C runtime (gcc);
2. holds K1 (intra commit) and K2 (reference bank) against their plain
   PyTorch versions on the card, bit for bit, at CIF and 1280x720, QP 28
   and 51, and times both;
3. holds every entry of K3-K6 (search grids, quarter-pel refinement and
   MC, inter residual coding, deblocking) against its plain version on
   the card, bit for bit, on the real inputs of P pictures (1 I + 2 P) at
   CIF and 1280x720, QP 28 and 51, weighted prediction on and off, with 5
   reference frames and search range 28; times kernel and plain version
   per P picture at both sizes (QP 28, WP on);
4. drives the all-intra main path (4 CIF + 2 1280x720 pictures) and the
   IPPP main path (CABAC, 5 reference frames, search range 28, explicit
   WP: 8 CIF and 4 1280x720 frames, the DPB warming from 1 to 5) through
   ``H264Encoder(..., device="cuda").encode_stream``, each with the
   kernels' launch counters set to 0 just before and read just after;
5. encodes the same frames through the kernels' plain versions on the
   card and requires the identical streams, recons and reference entries;
6. prints per-picture times for I and P pictures (CUDA events and host
   clock), PSNR-Y, bytes and each P picture's mode mix, a ``kernels`` JSON
   line, the card's name and power limit, and as its last line the
   result object.

Inputs are seeded synthetic frames (h264_tpu_torch/tools/synthseq.py).
Exits non-zero, printing no result, when no CUDA card is present or the
package is not beside the script.  With ``--out DIR`` the details also go
to ``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CIF = (352, 288)
HD = (1280, 720)
N_INTRA = {CIF: 4, HD: 2}  # all-intra main path
N_IPPP = {CIF: 8, HD: 4}  # IPPP main path: 1 I + 7 / 3 P
SEED = 2026
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and the
# non-tensor float32 rate, used as the int32 rate (the card has half as
# many INT32 lanes, so the operation bound below is optimistic)
HBM_BPS = 3.35e12
INT32_OPS = 67e12
# int32 operations per sample, counted from csrc/intra_commit.cu:
# Hadamard cost (residual, 2 passes, abs-sum); transform/quant/recon
# (residual, forward, quant, bits, dequant, inverse, recon, SSD); I4 adds
# its prediction
OPS_SATD, OPS_TQ, OPS_I4 = 8, 34, 36
# per coefficient of csrc/inter_tq.cu: OPS_TQ plus RDOQ-lite (a dequant,
# an inverse and a forward transform, 8 float operations, the bits) and
# the coeff_cost scan
OPS_INTER_TQ = OPS_TQ + 40
# per sample of a candidate in csrc/qpel.cu: 2 clamped reads and their
# rounded mean, WP (5), residual, Hadamard share and abs-sum (8)
OPS_QPEL, OPS_WP = 8, 5
# per filtered line of csrc/deblock.cu (8 loads, the tests, the filter)
OPS_LINE = 40
SOURCES = {
    "intra_commit": ("h264_tpu_torch/csrc/intra_commit.cu",
                     "h264_tpu/encoder/rd.py:1415"),
    "ref_bank": ("h264_tpu_torch/csrc/ref_bank.cu",
                 "h264_tpu/encoder/rd.py:101"),
    "coarse_search": ("h264_tpu_torch/csrc/search_grid.cu",
                      "h264_tpu/encoder/rd.py:398"),
    "ssd_grid8": ("h264_tpu_torch/csrc/search_grid.cu",
                  "h264_tpu/encoder/rd.py:435"),
    "ssd_grid4": ("h264_tpu_torch/csrc/search_grid.cu",
                  "h264_tpu/encoder/rd.py:640"),
    "qpel_refine": ("h264_tpu_torch/csrc/qpel.cu",
                    "h264_tpu/encoder/rd.py:551"),
    "mc_luma": ("h264_tpu_torch/csrc/qpel.cu", "h264_tpu/encoder/rd.py:145"),
    "mc_chroma": ("h264_tpu_torch/csrc/qpel.cu",
                  "h264_tpu/encoder/rd.py:159"),
    "inter_luma_tq": ("h264_tpu_torch/csrc/inter_tq.cu",
                      "h264_tpu/encoder/rd.py:879"),
    "inter_chroma_tq": ("h264_tpu_torch/csrc/inter_tq.cu",
                        "h264_tpu/encoder/rd.py:1267"),
    "i16_candidate": ("h264_tpu_torch/csrc/inter_tq.cu",
                      "h264_tpu/encoder/rd.py:984"),
    "strengths": ("h264_tpu_torch/csrc/deblock.cu",
                  "h264_tpu/encoder/rd.py:1713"),
    "deblock": ("h264_tpu_torch/csrc/deblock.cu",
                "h264_tpu/encoder/rd.py:1800"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def lam_fx(qp: int) -> int:
    """The encoder's fixed-point lambda (IPPP/all-intra base 0.85*0.95)."""
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


def k1_work(H: int, W: int):
    """(bytes, int32 ops) one picture's intra commit needs: source planes
    read once, every output written once; operations from the modes that
    are available at each MB's position."""
    from h264_tpu_torch.encoder.rd import _BLK4_XY

    n_my, n_mx = H // 16, W // 16
    n_mb = n_my * n_mx
    au = np.repeat((np.arange(n_my) > 0)[:, None], n_mx, 1).astype(int)
    al = np.repeat((np.arange(n_mx) > 0)[None, :], n_my, 0).astype(int)
    v16 = au + al + 1 + (au & al)
    vc = 1 + al + au + (au & al)
    v4 = 0
    for bx, by in _BLK4_XY:
        aub = au if by == 0 else 1
        alb = al if bx == 0 else 1
        aul = 1 if bx and by else (au & al if not (bx or by)
                                    else (al if bx == 0 else au))
        a3 = aub & alb & aul
        v4 = v4 + (3 * aub + 2 * alb + 1 + 3 * a3)
    ops = int((256 * (v16 * OPS_SATD + OPS_TQ) + 16 * v4 * OPS_I4
               + 128 * vc * OPS_TQ).sum())
    src = H * W * 3 // 2 * 4 + n_mb  # planes + is_intra
    out = (H * W * 3 // 2 + n_mb * (256 + 128 + 16 + 8 + 3)
           + 16 * n_mb) * 4
    return src + out, ops


def k2_work(H: int, W: int):
    """(bytes, int32 ops) of one reference entry: planes read once, bank
    and cpad written once; b/h 6 taps, j 6x6 separable taps."""
    Hp, Wp = H + 64, W + 64
    Hcp, Wcp = H // 2 + 64, W // 2 + 64
    nbytes = (H * W * 3 // 2 + 4 * Hp * Wp + 2 * Hcp * Wcp) * 4
    ops = Hp * Wp * (2 * 15 + 7 * 15)
    return nbytes, ops


def p_work(name: str, args):
    """(bytes, int32 ops) of one call of a P kernel entry, from the shapes
    (and, for the filter, the strengths) of its inputs: each input the
    function needs read once, each output written once."""
    import torch

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    if name in ("coarse_search", "ssd_grid8", "ssd_grid4", "qpel_refine"):
        banks, cur_y = args[0], args[1]
        NR, _, Hp, Wp = banks.shape
        wp = args[{"coarse_search": 2, "ssd_grid8": 4, "ssd_grid4": 5,
                   "qpel_refine": 9}[name]]
        g_plane = NR * Hp * Wp * 4  # the G plane of every reference
        wpo = OPS_WP if wp is not None else 0
    if name == "coarse_search":
        n_mb = cur_y.numel() // 256
        cells = NR * n_mb * 25 * 25
        return (g_plane + nb(cur_y) + 2 * NR * n_mb * 4,
                NR * n_mb * 28 * 28 * 16 * (1 + wpo) + cells * (16 * 3 + 20))
    if name == "ssd_grid8":
        R = args[5]
        D = 2 * R + 1
        n_b8 = cur_y.numel() // 64
        return (g_plane + nb(cur_y, args[2], args[3]) + NR * n_b8 * D * D * 4,
                NR * n_b8 * (D * D * 64 * 3 + (D + 7) ** 2 * wpo))
    if name == "ssd_grid4":
        RS = args[6]
        DS = 2 * RS + 1
        n = args[2].numel()
        return (g_plane + nb(cur_y, *args[2:5]) + n * 4 * DS * DS * 4,
                n * (4 * DS * DS * 16 * 3 + (DS + 7) ** 2 * wpo))
    if name == "qpel_refine":
        h, w = args[11], args[12]
        n = args[2].numel()
        windows = n * 4 * (h + 3) * (w + 3) * 4
        return (windows + n * h * w * 4 + nb(*args[2:9]) + n * (h * w + 3) * 4,
                n * 49 * (h * w * (OPS_QPEL + wpo) + 20))
    if name == "mc_luma":
        n, h, w = args[1].numel(), args[7], args[8]
        return (n * 4 * (h + 1) * (w + 1) * 4 + nb(*args[1:6]) + n * h * w * 4,
                n * h * w * (3 + (OPS_WP if args[6] is not None else 0)))
    if name == "mc_chroma":
        n_mb = args[1].shape[0]
        return (n_mb * 16 * 2 * 9 * 4 + nb(*args[1:]) + n_mb * 128 * 4,
                n_mb * 128 * 12)
    if name == "inter_luma_tq":
        pred, orig = args[0], args[1]
        NC, n_mb = pred.shape[:2]
        out = NC * n_mb * (256 + 256 + 8) * 4
        return nb(pred, orig) + out, pred.numel() * OPS_INTER_TQ
    if name == "inter_chroma_tq":
        n_mb = args[0].shape[0]
        return nb(args[0], args[1]) + n_mb * (128 + 8 + 128) * 4, (
            n_mb * 128 * OPS_INTER_TQ)
    if name == "i16_candidate":
        cur_y = args[0]
        n_mb = cur_y.numel() // 256
        return nb(cur_y) + n_mb * 258 * 4, n_mb * 256 * (4 * OPS_SATD + OPS_TQ)
    if name == "strengths":
        n = args[0].numel()
        return nb(*args) + 2 * n * 4, 2 * n * 12
    if name == "deblock":
        y, u, v, bsv, bsh = args[:5]
        # filtered lines: 4 luma and 2 chroma lines per plane per 4-sample
        # edge segment with bS > 0
        seg = int((bsv > 0).sum()) + int((bsh > 0).sum())
        return 2 * nb(y, u, v) + nb(bsv, bsh), seg * (4 + 2 * 2) * OPS_LINE
    raise KeyError(name)


def bound_ms(nbytes: int, ops: int):
    tb, to = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from h264_tpu_torch import device as D
    from h264_tpu_torch import native
    from h264_tpu_torch.bitstream import write_annexb
    from h264_tpu_torch.encoder import rd, rd_p
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.kernels import intra_commit as K1
    from h264_tpu_torch.kernels import ref_bank as K2
    from h264_tpu_torch.ops.exact import chroma_qp
    from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames

    dev = torch.device("cuda")
    report: dict = {"device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    D.build_cuda(["intra_commit", "ref_bank", "search_grid", "qpel",
                  "inter_tq", "deblock"])
    t_nvcc = time.perf_counter() - t0
    for stem in ("cabac_engine", "cabac_writer", "deblock"):
        if native._load(stem) is None:
            fail(f"host C library {stem} did not build")
    print(f"build: nvcc {t_nvcc:.1f}s, total {time.perf_counter() - t0:.1f}s")
    for stem, log in D.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    frames = {s: synthetic_frames(N_INTRA[s], *s, seed=SEED) for s in N_INTRA}
    pframes = {s: moving_frames(N_IPPP[s], *s, seed=SEED) for s in N_IPPP}

    def cuda_ms(fn, reps: int) -> float:
        fn()  # warm
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    # ---- 2. K1/K2 vs plain versions ------------------------------------------
    err = {n: 0 for n in SOURCES}  # max |kernel - plain|
    mismatches = {n: 0 for n in SOURCES}  # differing elements
    timing = {}
    names = "ry ru rv lev lum_dc i16mode cip levc dcc i4flag ipm".split()
    for (W, H) in (CIF, HD):
        Y, U, V = (torch.as_tensor(p, device=dev) for p in frames[(W, H)][0])
        for qp in (28, 51):
            qpc, lam = chroma_qp(qp, 0), lam_fx(qp)

            def scan(impl=None):
                return rd.rd_i_pipeline(Y, U, V, qp, qpc, lam, H, W,
                                        device=dev, impl=impl)

            ok = scan()
            ref = scan(K1.intra_commit_step_plain)
            torch.cuda.synchronize()
            for name, a, b in zip(names, ok, ref):
                d = (a.long() - b.long()).abs()
                e = int(d.max())
                err["intra_commit"] = max(err["intra_commit"], e)
                mismatches["intra_commit"] += int((d > 0).sum())
                if e:
                    idx = np.unravel_index(int(d.argmax()), tuple(d.shape))
                    fail(f"intra_commit {W}x{H} QP {qp}: {name} differs "
                         f"({int((d > 0).sum())} elements, first max at "
                         f"{idx}: kernel {int(a[idx])} plain {int(b[idx])})")
            planes = [x.contiguous() for x in ok[:3]]
            bk = K2.ref_bank(*planes)
            bp = K2.ref_bank_plain(*planes)
            torch.cuda.synchronize()
            for name, a, b in zip(("bank", "cpad"), bk, bp):
                e = int((a - b).abs().max())
                err["ref_bank"] = max(err["ref_bank"], e)
                mismatches["ref_bank"] += int((a != b).sum())
                if e:
                    fail(f"ref_bank {W}x{H} QP {qp}: {name} differs by {e}")
            print(f"check {W}x{H} QP {qp}: intra_commit and ref_bank "
                  "equal to their plain versions (tolerance 0: bit-exact)")
            if qp == 28:
                T = 2 * (H // 16) + W // 16 - 2  # launches: non-empty steps
                tm = timing.setdefault((W, H), {})
                tm["intra_commit"] = {
                    "ms": cuda_ms(scan, 5),
                    "plain_ms": cuda_ms(
                        lambda: scan(K1.intra_commit_step_plain), 1),
                    "launches_per_picture": T,
                    "work": k1_work(H, W)}
                tm["ref_bank"] = {
                    "ms": cuda_ms(lambda: K2.ref_bank(*planes), 50),
                    "plain_ms": cuda_ms(lambda: K2.ref_bank_plain(*planes), 20),
                    "launches_per_picture": 1, "work": k2_work(H, W)}
                print(f"time {W}x{H}: intra_commit "
                      f"{tm['intra_commit']['ms']:.3f} ms/picture ({T} "
                      f"launches), plain {tm['intra_commit']['plain_ms']:.1f}"
                      f" ms; ref_bank {tm['ref_bank']['ms']:.4f} ms, plain "
                      f"{tm['ref_bank']['plain_ms']:.4f} ms")

    # ---- 3. K3-K6 vs plain versions on the inputs of real P pictures ---------
    def p_cfg(size, qp=28, wp=True):
        return EncoderConfig(width=size[0], height=size[1], qp=qp, fast=True,
                             rd=True, entropy="cabac", b_frames=0,
                             num_ref_frames=5, search_range=28,
                             weighted_pred=wp)

    kern = rd_p.default_kernels()
    for size in (CIF, HD):
        for qp in (28, 51):
            for wp in (True, False):
                enc = H264Encoder(p_cfg(size, qp, wp), device="cuda")
                enc._p_kernels, calls = rd_p.recording(kern)
                list(enc.encode_stream(pframes[size][:3]))
                torch.cuda.synchronize()
                for name, cargs in calls:
                    got = getattr(kern, name)(*cargs)
                    want = getattr(rd_p.PLAIN, name)(*cargs)
                    if isinstance(want, torch.Tensor):
                        got, want = (got,), (want,)
                    for i, (g, w) in enumerate(zip(got, want)):
                        d = (g.long() - w.long()).abs()
                        e = int(d.max()) if d.numel() else 0
                        err[name] = max(err[name], e)
                        mismatches[name] += int((d > 0).sum())
                        if e or g.dtype != w.dtype:
                            fail(f"{name} {size[0]}x{size[1]} QP {qp} WP "
                                 f"{wp}: output {i} differs "
                                 f"({int((d > 0).sum())} elements)")
                if {n for n, _ in calls} != set(rd_p.P_ENTRIES):
                    fail("a P entry was not called")
                print(f"check {size[0]}x{size[1]} QP {qp} WP {wp}: "
                      f"{len(calls)} calls of the {len(rd_p.P_ENTRIES)} P "
                      "entries equal to their plain versions (tolerance 0: "
                      "bit-exact)")
                if qp == 28 and wp:
                    # per P picture: the second P picture's calls
                    last = [c for c in calls[len(calls) // 2:]]
                    tm = timing.setdefault(size, {})
                    for name in rd_p.P_ENTRIES:
                        mine = [a for n, a in last if n == name]
                        fk, fp = getattr(kern, name), getattr(rd_p.PLAIN, name)
                        work = [p_work(name, a) for a in mine]
                        tm[name] = {
                            "ms": sum(cuda_ms(lambda a=a: fk(*a), 5)
                                      for a in mine),
                            "plain_ms": sum(cuda_ms(lambda a=a: fp(*a), 1)
                                            for a in mine),
                            "launches_per_picture": len(mine),
                            "work": (sum(w[0] for w in work),
                                     sum(w[1] for w in work))}
                    print(f"time {size[0]}x{size[1]} per P picture (ms, "
                          "kernel / plain): " + ", ".join(
                              f"{n} {tm[n]['ms']:.3f}/{tm[n]['plain_ms']:.1f}"
                              for n in rd_p.P_ENTRIES))

    # ---- 4. the main paths through the kernels -------------------------------
    counters = {"intra_commit": K1.intra_commit_step, "ref_bank": K2.ref_bank,
                **{n: getattr(kern, n) for n in rd_p.P_ENTRIES}}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {n: fn.launches for n, fn in counters.items()}

    def encode(cls, size, cfg, fr):
        """Encode `fr` picture by picture (pipeline depth 1, so each P
        picture is timed alone); also keep each P picture's host_out."""
        enc = cls(cfg, device="cuda")
        rows = []
        finish = enc._finish_p_rd

        def keep(p, fetched):
            rows.append(fetched)
            return finish(p, fetched)

        enc._finish_p_rd = keep
        nalus = enc.headers()
        pics = []
        gen = enc.encode_stream(fr, depth=1)
        for i in range(len(fr)):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            a.record()
            out = next(gen)
            b.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - h0) * 1e3
            nalus.extend(out)
            src = fr[i][0].astype(np.float64)
            mse = ((enc.all_recons[-1][1].Y - src) ** 2).mean()
            pics.append({"type": "I" if out[0].nal_unit_type == 5 else "P",
                         "event_ms": a.elapsed_time(b), "host_ms": host_ms,
                         "psnr_y": 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)),
                         "bytes": sum(len(n.rbsp) for n in out)})
        return enc, write_annexb(nalus), pics, rows

    def intra_cfg(size):
        return EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                             rd=True, entropy="cabac", idr_period=1)

    reset()
    runs_i = {s: encode(H264Encoder, s, intra_cfg(s), frames[s])
              for s in N_INTRA}
    launches_i = read()
    print(f"all-intra main path launches: "
          f"{ {n: launches_i[n] for n in ('intra_commit', 'ref_bank')} }")
    for name in ("intra_commit", "ref_bank"):
        if launches_i[name] == 0:
            fail(f"kernel {name} was not launched on the all-intra path")
    reset()
    runs_p = {s: encode(H264Encoder, s, p_cfg(s), pframes[s]) for s in N_IPPP}
    launches = read()
    print(f"IPPP main path launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the IPPP main path")

    def mode_mix(row, n_mb):
        sizes = [n_mb, 4 * n_mb, 4 * n_mb]
        win, ref8, sub = np.split(row[: sum(sizes)], np.cumsum(sizes)[:-1])
        ref8, sub = ref8.reshape(n_mb, 4), sub.reshape(n_mb, 4)
        inter = win < rd_p.C_I16
        p88 = win == rd_p.C_P8x8

        def share(m):
            return round(float(np.mean(m)), 4)

        return {"skip": share(win == rd_p.C_SKIP),
                "p16x16": share((win == rd_p.C_P16x16)
                                | (win == rd_p.C_P16PMV)),
                "p16x8": share(win == rd_p.C_P16x8),
                "p8x16": share(win == rd_p.C_P8x16), "p8x8": share(p88),
                "split_units": share(p88[:, None] & (sub > 0)),
                "intra": share(~inter),
                "ref_gt0": share(inter & (ref8 > 0).any(1))}

    for tag, runs in (("all-intra", runs_i), ("IPPP", runs_p)):
        for size, (enc, stream, pics, rows) in runs.items():
            n_mb = (size[0] // 16) * (size[1] // 16)
            p_rows = iter(rows)
            for i, p in enumerate(pics):
                if p["type"] == "P":
                    p["mode_mix"] = mode_mix(next(p_rows), n_mb)
                print(f"{tag} {size[0]}x{size[1]} #{i} {p['type']}: "
                      f"{p['event_ms']:.1f} ms (events) {p['host_ms']:.1f} ms "
                      f"(host), PSNR-Y {p['psnr_y']:.2f} dB, {p['bytes']} "
                      f"bytes" + (f", modes {p['mode_mix']}" if "mode_mix"
                                  in p else ""))
            for kind in ("I", "P"):
                sel = [p for p in pics if p["type"] == kind]
                if kind == "I" and tag == "all-intra":
                    sel = sel[1:]  # the first picture carries the warm-up
                if not sel:
                    continue
                print(f"mean {tag} {size[0]}x{size[1]} {kind} ({len(sel)}): "
                      f"{np.mean([p['event_ms'] for p in sel]):.1f} ms "
                      f"(events), {np.mean([p['host_ms'] for p in sel]):.1f}"
                      f" ms (host), PSNR-Y "
                      f"{np.mean([p['psnr_y'] for p in sel]):.2f} dB, "
                      f"{np.mean([p['bytes'] for p in sel]):.0f} bytes")
            for p in pics:
                if not 25.0 < p["psnr_y"] < 99.0:
                    fail(f"{size}: PSNR-Y {p['psnr_y']:.2f} dB out of range")
            report[f"{tag} {size[0]}x{size[1]}"] = {
                "pictures": pics, "stream_bytes": len(stream)}

    # ---- 5. the same frames through the plain versions on the card -----------
    class PlainEncoder(H264Encoder):
        _intra_step = staticmethod(K1.intra_commit_step_plain)
        _ref_bank = staticmethod(K2.ref_bank_plain)
        _p_kernels = rd_p.PLAIN

    for tag, runs, cfg_of, fr_of in (
            ("all-intra", runs_i, intra_cfg, frames),
            ("IPPP", runs_p, p_cfg, pframes)):
        for size, (enc, stream, _, _) in runs.items():
            penc, pstream, _, _ = encode(PlainEncoder, size, cfg_of(size),
                                         fr_of[size])
            if pstream != stream:
                fail(f"{tag} {size}: stream differs from the plain path's")
            for (_, a), (_, b) in zip(enc.all_recons, penc.all_recons):
                for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
                    if not np.array_equal(x, y):
                        fail(f"{tag} {size}: recon differs from the plain "
                             "path's")
            for ea, eb in zip(enc._rd_refs, penc._rd_refs):
                for x, y in zip((*ea[1:3], *ea[3]), (*eb[1:3], *eb[3])):
                    if not torch.equal(x, y):
                        fail(f"{tag} {size}: reference entry differs from "
                             "the plain path's")
            print(f"plain path {tag} {size[0]}x{size[1]}: stream, recon and "
                  "reference entries identical")

    # ---- 6. report -----------------------------------------------------------
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        tm = timing[CIF][name]
        b_ms, b_by = bound_ms(*tm["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "mismatches": mismatches[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    for size, tm in timing.items():
        report[f"timing_{size[0]}x{size[1]}"] = {
            n: {**v, "bound_ms": bound_ms(*v["work"])[0]}
            for n, v in tm.items()}
    report["launches_all_intra"] = launches_i
    report["launches_ippp"] = launches
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    report["nvidia_smi"] = card
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(f"chip_smoke: {report['seconds']:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
