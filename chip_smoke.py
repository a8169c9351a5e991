#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h264_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

1. builds the CUDA kernels K1-K8 (nvcc, sm_90a, one process per source,
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
4. holds every entry of the B pipeline (its own K7 ``b_direct``,
   ``mc_luma_win``, ``mc_chroma_b``, ``strengths_b``, and the K3-K6
   entries it shares) against its plain version on the card, bit for bit,
   on the real inputs of B pictures (an IPB stream of 5 frames) at CIF
   and 1280x720, B pictures at QP 30 and 51, and b_direct, mc_luma_win
   and mc_chroma_b also on inputs built so that their windows start
   outside the padded banks (the reference's ``dynamic_slice``
   placement), and strengths_b also on inputs built so that every branch
   of its pairing rule decides some edges (tools/strengths_cases.py);
   times kernel and plain version per B picture at both sizes (QP 28);
5. drives the all-intra path (4 CIF + 2 1280x720 pictures), the IPPP
   path (CABAC, 5 reference frames, search range 28, explicit WP: 6 CIF
   and 3 1280x720 frames), the main path, the bench configuration (IPB:
   one B picture between anchors, 5 reference frames, search range 28,
   explicit WP, QP 28; 9 CIF and 5 1280x720 frames) and the hierarchical
   IPB path (``b_hierarchy``, 9 CIF frames) through ``H264Encoder(...,
   device="cuda").encode_stream``, each with the kernels' launch counters
   set to 0 just before and read just after;
6. encodes the same frames through the kernels' plain versions on the
   card and requires the identical streams, recons and reference entries;
7. the decoder: decodes the 17 in-repo streams (QCIF) and every stream
   of step 5 with ``H264Decoder(device="cuda")``, recording K8's
   (``decode_inter``) inputs, and requires each decode to be
   byte-identical to the native host decode (``use_device=False``) and
   the I and P pictures of the all-intra, IPPP and IPB streams to equal
   the encoder's recons (B pictures and the hierarchical stream: the
   count of samples that differ is printed, not checked); K8's launch
   counter is set to 0 just before the decode of the CIF and 720p IPB
   streams and read just after; holds K8 against its plain version bit
   for bit on every recorded input and on built inputs (far mvs, WP, T8,
   QP 0/51, wrapping dequant; tools/decode_cases.py) at QCIF, CIF and
   1280x720; times K8 and its plain version per CIF and 720p picture and
   the decode per picture type, device and host path;
8. prints per-picture times for I, P and B pictures (CUDA events and host
   clock around each ``encode_stream`` step, pipeline depth 1), their
   means per type with sample counts, PSNR-Y, bytes and the mode mixes, a
   ``kernels`` JSON line (launches from the main path; K8's from the
   decode of step 7), the card's name and power limit, and as its last
   line the result object.

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
N_INTRA = {CIF: 4, HD: 2}  # all-intra path
N_IPPP = {CIF: 6, HD: 3}  # IPPP path: 1 I + 5 / 2 P
N_IPB = {CIF: 9, HD: 5}  # the main path: I P B P B ... (4 / 2 B)
N_HIER = 9  # hierarchical IPB at CIF: I, 2 x (P, stored B, 2 B)
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
# per sample of csrc/b_direct.cu (the unit's derivation shared by its 64
# samples, two window samples per list, their means) and of the chroma
# samplers (four taps and weights per list, the select)
OPS_DIRECT, OPS_CHROMA_B = 12, 30
# per 4x4 block edge of strengths_b (the pairing rule, four mv pairs)
OPS_BS_B = 40
# per sample of csrc/decode_inter.cu: a luma prediction per list (two
# reads, their rounded mean), a chroma one per list (four taps, weights,
# rounding), and per inter sample the weighting and select, dequant,
# two transform passes and the recon
OPS_DEC_MC_L, OPS_DEC_MC_C, OPS_DEC_RES = 4, 12, 20
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
    "b_direct": ("h264_tpu_torch/csrc/b_direct.cu",
                 "h264_tpu/encoder/rd.py:2226"),
    "mc_luma_win": ("h264_tpu_torch/csrc/qpel.cu",
                    "h264_tpu/encoder/rd.py:1911"),
    "mc_chroma_b": ("h264_tpu_torch/csrc/qpel.cu",
                    "h264_tpu/encoder/rd.py:2453"),
    "strengths_b": ("h264_tpu_torch/csrc/deblock.cu",
                    "h264_tpu/encoder/rd.py:1928"),
    "decode_inter": ("h264_tpu_torch/csrc/decode_inter.cu",
                     "h264_tpu/decoder/device.py:99"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def luma_planes(mvx, mvy) -> int:
    """Bank planes the quarter-pel predictions of units with these mvs
    read, summed over the units: one at full- and half-pel positions
    (where both taps are one sample), else two."""
    import torch
    from h264_tpu_torch.encoder.rd import _QTAB

    q = torch.as_tensor(_QTAB)
    one = (q[:, :3] == q[:, 3:]).all(1).to(mvx.device)
    frac = ((mvy & 3) * 4 + (mvx & 3)).long()
    return int((2 - one[frac].long()).sum())


def b_work(name: str, args):
    """(bytes, int32 ops) of one call of a B picture's own kernel entry:
    the samples its windows need read once (per unit and list, its 8x8 or
    h x w samples from each bank plane its mv's fraction reads; for
    chroma the 5x5 window per 4x4 unit, plane and list the unit's output
    depends on), the colocated and per-unit fields, each output written
    once."""
    if name == "b_direct":
        from h264_tpu_torch.encoder.rd_b import direct_mvs

        n_mb = args[3].numel() // 16
        _, l0x, l0y, l1x, l1y = direct_mvs(*args[2:])
        need = (luma_planes(l0x, l0y) + luma_planes(l1x, l1y)) * 64 * 4
        fields = n_mb * 4 * (1 + 3 * 4)  # corner intra (1 B) + 3 int32
        out = n_mb * (256 + 20) * 4
        return need + fields + out, n_mb * 256 * OPS_DIRECT
    if name == "mc_luma_win":
        n, h, w = args[1].numel(), args[6], args[7]
        return ((luma_planes(args[2], args[3]) * h * w + n * (5 + h * w)) * 4,
                n * h * w * 3)
    if name == "mc_chroma_b":
        n_mb = args[2].shape[0]
        u0, u1 = args[7], args[8]
        lists = int(u0.sum()) + int((u1 | ~u0).sum())  # list 1 if not u0
        return (lists * 2 * 25 * 4 + n_mb * 4 * (5 * 4 + 2)
                + n_mb * 128 * 4, n_mb * 128 * OPS_CHROMA_B)
    if name == "strengths_b":
        n = args[0].numel()
        return n * (4 * 1 + 6 * 4) + 2 * n * 4, 2 * n * OPS_BS_B
    raise KeyError(name)


def entry_work(name: str, args):
    """(bytes, int32 ops) of one call of any P or B kernel entry."""
    from h264_tpu_torch.encoder.rd_b import B_OWN

    return b_work(name, args) if name in B_OWN else p_work(name, args)


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


def decode_work(args, H: int, W: int):
    """(bytes, int32 ops) of one K8 call: the bank samples the valid
    lists' predictions of the inter MBs need (16 luma samples from each
    bank plane the mv's fraction reads; per chroma plane the 2x2 block's
    window, 2 or 3 samples a side by the fraction), the per-block and
    per-MB fields and levels of the inter MBs, the tables, and the recon
    written once."""
    mv, ref_idx, inter = args[3], args[4], args[21] != 0
    n_my, n_mx = H // 16, W // 16
    blk = inter.view(n_my, 1, n_mx, 1).expand(n_my, 4, n_mx, 4).reshape(
        H // 4, W // 4)
    need = lists = 0
    for lst in (0, 1):
        v = (ref_idx[lst] >= 0) & blk
        mvx, mvy = mv[lst, ..., 0][v], mv[lst, ..., 1][v]
        need += luma_planes(mvx, mvy) * 16 * 4
        taps = (2 + ((mvy & 7) != 0).long()) * (2 + ((mvx & 7) != 0).long())
        need += int(taps.sum()) * 2 * 4
        lists += int(v.sum())
    n_inter = int(inter.sum())
    fields = int(blk.sum()) * (4 + 2 + 1) * 4  # mv, ref_idx, slice id
    levels = n_inter * (5 + 256 + 128 + 8) * 4  # qp, qpc, t8 + levels
    tables = sum(args[i].numel() * 4 for i in (2, *range(6, 14), 22, 23, 24))
    out = H * W * 3 // 2 * 4
    ops = lists * (16 * OPS_DEC_MC_L + 8 * OPS_DEC_MC_C) + (
        n_inter * 384 * OPS_DEC_RES)
    return need + fields + levels + tables + inter.numel() * 4 + out, ops


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
    from h264_tpu_torch.decoder import device as DEV
    from h264_tpu_torch.decoder.decoder import H264Decoder
    from h264_tpu_torch.encoder import rd, rd_b, rd_p
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.kernels import decode_inter as K8
    from h264_tpu_torch.kernels import intra_commit as K1
    from h264_tpu_torch.kernels import ref_bank as K2
    from h264_tpu_torch.ops.exact import chroma_qp
    from h264_tpu_torch.tools.decode_cases import NS as DEC_NS
    from h264_tpu_torch.tools.decode_cases import built_cases as dec_cases
    from h264_tpu_torch.tools.decode_cases import clip_sides
    from h264_tpu_torch.tools.profile_decode import mean_by_type, timed_decode
    from h264_tpu_torch.tools.strengths_cases import (strengths_b_branches,
                                                      strengths_b_inputs)
    from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames

    dev = torch.device("cuda")
    report: dict = {"device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    D.build_cuda(["intra_commit", "ref_bank", "search_grid", "qpel",
                  "inter_tq", "deblock", "b_direct", "decode_inter"])
    t_nvcc = time.perf_counter() - t0
    for stem in ("cabac_engine", "cabac_writer", "deblock", "cabac_reader",
                 "cavlc_reader", "recon"):
        if native._load(stem) is None:
            fail(f"host C library {stem} did not build")
    print(f"build: nvcc {t_nvcc:.1f}s, total {time.perf_counter() - t0:.1f}s")
    for stem, log in D.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    frames = {s: synthetic_frames(N_INTRA[s], *s, seed=SEED) for s in N_INTRA}
    pframes = {s: moving_frames(N_IPPP[s], *s, seed=SEED) for s in N_IPPP}
    bframes = {s: moving_frames(N_IPB[s], *s, seed=SEED + 1) for s in N_IPB}
    hframes = moving_frames(N_HIER, *CIF, seed=SEED + 2)

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

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

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

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 4. the B entries vs plain versions on the inputs of B pictures ------
    def b_cfg(size, qp=28, hier=False):
        return EncoderConfig(width=size[0], height=size[1], qp=qp, fast=True,
                             rd=True, entropy="cabac",
                             b_frames=3 if hier else 1, b_hierarchy=hier,
                             num_ref_frames=5, search_range=28,
                             weighted_pred=True)

    bkern = rd_b.default_kernels()

    def hold(name, cargs, what):
        """Run entry `name` through its kernel and its plain version on
        the same inputs; fail on any difference."""
        got = getattr(bkern, name)(*cargs)
        want = getattr(rd_b.PLAIN, name)(*cargs)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            d = (g.long() - w.long()).abs()
            e = int(d.max()) if d.numel() else 0
            err[name] = max(err[name], e)
            mismatches[name] += int((d > 0).sum())
            if e or g.dtype != w.dtype:
                fail(f"{name} {what}: output {i} differs "
                     f"({int((d > 0).sum())} elements)")

    rs = np.random.RandomState(SEED)

    def far(t):
        """mvs of up to +-90 pel, so windows start outside the banks."""
        return torch.as_tensor(rs.randint(-360, 361, tuple(t.shape)),
                               dtype=torch.int32, device=t.device)

    def out_of_bank(y0, mvy, shift, L, size):
        s = y0 + (mvy >> shift) + rd.PAD
        return int(((s < 0) | (s > L - size)).sum())

    def built_cases(calls, seed):
        """The first call of each B entry with windows, its mvs replaced
        by far ones (and the colocated field made all inter); and
        strengths_b on built inputs of the same shape that take every
        branch of its pairing rule."""
        first = {}
        for name, a in calls:
            first.setdefault(name, a)
        b0, b1, ci, cr, cmx, cmy, dsf, eq = first["b_direct"]
        banks, ref, mvx, mvy, y0, x0, h, w = first["mc_luma_win"]
        c0, c1, idx0, m0x, m0y, m1x, m1y, u0, u1 = first["mc_chroma_b"]
        Hp, Hcp, Wcp = banks.shape[2], c0.shape[2], c0.shape[3]
        far_y, far_c = far(mvy), far(m0y)
        _, _, uy, _ = rd_b._units(idx0.shape[0], (Wcp - 2 * rd.PAD) // 8,
                                  idx0.device)
        n_out = (out_of_bank(y0, far_y, 2, Hp, h + 2),
                 out_of_bank(uy >> 1, far_c, 3, Hcp, 5))
        if min(n_out) == 0:
            fail("clamp cases: no window starts outside the banks")
        bs_args = strengths_b_inputs(*first["strengths_b"][0].shape, seed,
                                     dev)
        branches = strengths_b_branches(bs_args)
        if min(branches.values()) == 0:
            fail(f"strengths_b cases: a branch is not taken ({branches})")
        return [("b_direct", (b0, b1, torch.zeros_like(ci), cr, far(cmx),
                              far(cmy), dsf, eq)),
                ("mc_luma_win", (banks, ref, far(mvx), far_y, y0, x0, h, w)),
                ("mc_chroma_b", (c0, c1, idx0, far(m0x), far_c, far(m1x),
                                 far(m1y), u0, u1)),
                ("strengths_b", bs_args)], n_out, branches

    timing_b = {}
    for size in (CIF, HD):
        for qp in (28, 49):  # the B pictures at QP 30 and 51
            enc = H264Encoder(b_cfg(size, qp), device="cuda")
            enc._b_kernels, calls = rd_b.recording(bkern)
            list(enc.encode_stream(bframes[size][:5]))
            torch.cuda.synchronize()
            for name, cargs in calls:
                hold(name, cargs, f"{size[0]}x{size[1]} B QP {qp + 2}")
            if {n for n, _ in calls} != set(rd_b.B_ENTRIES):
                fail("a B entry was not called")
            cases, n_out, branches = built_cases(calls, SEED + qp)
            for name, cargs in cases:
                hold(name, cargs, f"{size[0]}x{size[1]} B QP {qp + 2} built "
                     "inputs")
            print(f"check {size[0]}x{size[1]} B QP {qp + 2}: {len(calls)} "
                  "calls "
                  f"of the {len(rd_b.B_ENTRIES)} B entries, b_direct, "
                  f"mc_luma_win, mc_chroma_b with far mvs ({n_out[0]} luma "
                  f"and {n_out[1]} chroma windows moved) and strengths_b on "
                  f"built inputs (edges per branch {branches}), equal to "
                  "their plain versions (tolerance 0: bit-exact)")
            if qp == 28:
                last = calls[len(calls) // 2:]  # the second B picture
                tm = timing_b.setdefault(size, {})
                for name in rd_b.B_ENTRIES:
                    mine = [a for n, a in last if n == name]
                    fk, fp = getattr(bkern, name), getattr(rd_b.PLAIN, name)
                    wk = [entry_work(name, a) for a in mine]
                    tm[name] = {
                        "ms": sum(cuda_ms(lambda a=a: fk(*a), 5)
                                  for a in mine),
                        "plain_ms": sum(cuda_ms(lambda a=a: fp(*a), 1)
                                        for a in mine),
                        "launches_per_picture": len(mine),
                        "work": (sum(x[0] for x in wk), sum(x[1] for x in wk))}
                print(f"time {size[0]}x{size[1]} per B picture (ms, kernel / "
                      "plain): " + ", ".join(
                          f"{n} {tm[n]['ms']:.3f}/{tm[n]['plain_ms']:.1f}"
                          for n in rd_b.B_ENTRIES))

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 5. the paths through the kernels ------------------------------------
    counters = {"intra_commit": K1.intra_commit_step, "ref_bank": K2.ref_bank,
                **{n: getattr(kern, n) for n in rd_p.P_ENTRIES},
                **{n: getattr(bkern, n) for n in rd_b.B_OWN}}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {n: fn.launches for n, fn in counters.items()}

    def encode(cls, cfg, fr):
        """Encode `fr` picture by picture (pipeline depth 1, so each step
        dispatches and finishes one picture, timed alone); the encoder's
        picture log gives each picture's type and host_out."""
        enc = cls(cfg, device="cuda")
        enc.picture_log = log = []
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
            if len(log) != i + 1:
                fail(f"step {i} finished {len(log) - i} pictures, not one")
            kind, poc, row = log[-1]
            rec = enc.all_recons[-1][1]
            src = fr[poc // 2 if cfg.idr_period == 0 else i][0]
            mse = ((rec.Y - src.astype(np.float64)) ** 2).mean()
            pics.append({"type": kind, "poc": poc,
                         "event_ms": a.elapsed_time(b), "host_ms": host_ms,
                         "psnr_y": 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)),
                         "bytes": sum(len(n.rbsp) for n in out),
                         "row": row})
        return enc, write_annexb(nalus), pics

    def intra_cfg(size):
        return EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                             rd=True, entropy="cabac", idr_period=1)

    paths = {
        "all-intra": ({s: (intra_cfg(s), frames[s]) for s in N_INTRA},
                      ("intra_commit", "ref_bank")),
        "IPPP": ({s: (p_cfg(s), pframes[s]) for s in N_IPPP},
                 ("intra_commit", "ref_bank", *rd_p.P_ENTRIES)),
        "IPB": ({s: (b_cfg(s), bframes[s]) for s in N_IPB}, tuple(counters)),
        "IPB-hierarchy": ({CIF: (b_cfg(CIF, hier=True), hframes)},
                          tuple(counters)),
    }
    runs, launches_of = {}, {}
    for tag, (sizes, needed) in paths.items():
        reset()
        runs[tag] = {s: encode(H264Encoder, c, f)
                     for s, (c, f) in sizes.items()}
        launches_of[tag] = read()
        print(f"{tag} path launches: "
              f"{ {n: launches_of[tag][n] for n in needed} }")
        for name in needed:
            if launches_of[tag][name] == 0:
                fail(f"kernel {name} was not launched on the {tag} path")
    launches = launches_of["IPB"]  # the main path: the bench configuration

    def share(m):
        return round(float(np.mean(m)), 4)

    def mode_mix(kind, row, n_mb):
        if kind == "P":
            sizes = [n_mb, 4 * n_mb, 4 * n_mb]
            win, ref8, sub = np.split(row[: sum(sizes)], np.cumsum(sizes)[:-1])
            ref8, sub = ref8.reshape(n_mb, 4), sub.reshape(n_mb, 4)
            inter = win < rd_p.C_I16
            p88 = win == rd_p.C_P8x8
            return {"skip": share(win == rd_p.C_SKIP),
                    "p16x16": share((win == rd_p.C_P16x16)
                                    | (win == rd_p.C_P16PMV)),
                    "p16x8": share(win == rd_p.C_P16x8),
                    "p8x16": share(win == rd_p.C_P8x16), "p8x8": share(p88),
                    "split_units": share(p88[:, None] & (sub > 0)),
                    "intra": share(~inter),
                    "ref_gt0": share(inter & (ref8 > 0).any(1))}
        win = row[:n_mb]
        return {"direct": share(win == rd.B_DIRECT),
                "direct_zero": share(win == rd.B_DIRECT_ZERO),
                "l0": share(win == rd.B_L0), "l1": share(win == rd.B_L1),
                "bi": share(win == rd.B_BI),
                "halves": share((win == rd.B_L0_16x8)
                                | (win == rd.B_L0_8x16)),
                "p8x8": share(win == rd.B_P8X8),
                "intra": share((win == rd.B_I16) | (win == rd.B_I4))}

    for tag, by_size in runs.items():
        for size, (enc, stream, pics) in by_size.items():
            n_mb = (size[0] // 16) * (size[1] // 16)
            for i, p in enumerate(pics):
                row = p.pop("row")
                if row is not None:
                    p["mode_mix"] = mode_mix(p["type"], row, n_mb)
                print(f"{tag} {size[0]}x{size[1]} #{i} {p['type']} POC "
                      f"{p['poc']}: {p['event_ms']:.1f} ms (events) "
                      f"{p['host_ms']:.1f} ms (host), PSNR-Y "
                      f"{p['psnr_y']:.2f} dB, {p['bytes']} bytes"
                      + (f", modes {p['mode_mix']}" if "mode_mix" in p
                         else ""))
            for kind in ("I", "P", "B"):
                sel = [p for p in pics if p["type"] == kind]
                if kind == "I" and tag == "all-intra":
                    sel = sel[1:]  # the first picture carries the warm-up
                if not sel:
                    continue
                print(f"mean {tag} {size[0]}x{size[1]} {kind} ({len(sel)} "
                      f"pictures): "
                      f"{np.mean([p['event_ms'] for p in sel]):.1f} ms "
                      f"(events), {np.mean([p['host_ms'] for p in sel]):.1f}"
                      f" ms (host), PSNR-Y "
                      f"{np.mean([p['psnr_y'] for p in sel]):.2f} dB, "
                      f"{np.mean([p['bytes'] for p in sel]):.0f} bytes")
            for p in pics:
                if not 25.0 < p["psnr_y"] < 99.0:
                    fail(f"{tag} {size}: PSNR-Y {p['psnr_y']:.2f} dB out of "
                         "range")
            report[f"{tag} {size[0]}x{size[1]}"] = {
                "pictures": pics, "stream_bytes": len(stream)}

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 6. the same frames through the plain versions on the card -----------
    class PlainEncoder(H264Encoder):
        _intra_step = staticmethod(K1.intra_commit_step_plain)
        _ref_bank = staticmethod(K2.ref_bank_plain)
        _p_kernels = rd_p.PLAIN
        _b_kernels = rd_b.PLAIN

    for tag, (sizes, _) in paths.items():
        for size, (enc, stream, _) in runs[tag].items():
            cfg, fr = sizes[size]
            penc, pstream, _ = encode(PlainEncoder, cfg, fr)
            if pstream != stream:
                fail(f"{tag} {size}: stream differs from the plain path's")
            for (_, a), (_, b) in zip(enc.all_recons, penc.all_recons):
                for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
                    if not np.array_equal(x, y):
                        fail(f"{tag} {size}: recon differs from the plain "
                             "path's")
            if len(enc._rd_refs) != len(penc._rd_refs):
                fail(f"{tag} {size}: reference lists differ in length")
            for ea, eb in zip(enc._rd_refs, penc._rd_refs):
                if ea[0] != eb[0]:
                    fail(f"{tag} {size}: reference POCs differ")
                for x, y in zip((*ea[1:3], *ea[3]), (*eb[1:3], *eb[3])):
                    if not torch.equal(x, y):
                        fail(f"{tag} {size}: reference entry differs from "
                             "the plain path's")
            print(f"plain path {tag} {size[0]}x{size[1]}: stream, recon and "
                  "reference entries identical")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 7. the decoder on the card ------------------------------------------
    k8_calls = []  # (what, args, H, W, NS) of every K8 call of the decodes
    k8 = DEV.decode_inter

    def decode(data: bytes, what: str, **kw):
        """Decode order pictures of a device-path decode, K8's inputs
        recorded, checked byte-identical to the native host decode."""
        def rec(*a, H, W, NS):
            k8_calls.append((what, a, H, W, NS))
            return k8(*a, H=H, W=W, NS=NS)

        DEV.decode_inter = rec
        try:
            pics = list(H264Decoder(device="cuda").decode_stream(data))
        finally:
            DEV.decode_inter = k8
        host = list(H264Decoder(use_device=False).decode_stream(data))
        if [p.to_yuv_bytes() for p in pics] != [p.to_yuv_bytes()
                                                for p in host]:
            fail(f"decode of {what}: differs from the native host decode")
        return pics

    here = os.path.dirname(os.path.abspath(__file__))
    streams = sorted(f for f in os.listdir(os.path.join(here, "tests",
                                                        "streams"))
                     if f.endswith(".264"))
    for f in streams:
        with open(os.path.join(here, "tests", "streams", f), "rb") as fh:
            pics = decode(fh.read(), f)
    print(f"decode: the {len(streams)} in-repo streams on the card equal "
          f"the native host decode ({len(k8_calls)} K8 calls)")
    if len(streams) != 17:
        fail(f"{len(streams)} in-repo streams, expected 17")

    dec_counters = {"decode_inter": K8.decode_inter, "ref_bank": K2.ref_bank}
    for fn in dec_counters.values():
        fn.launches = 0
    dec_pics = {s: decode(runs["IPB"][s][1], f"IPB {s[0]}x{s[1]}")
                for s in N_IPB}  # the decode main path
    launches_dec = {n: fn.launches for n, fn in dec_counters.items()}
    print(f"decode path launches (IPB CIF + 720p): {launches_dec}")
    if launches_dec["decode_inter"] == 0:
        fail("kernel decode_inter was not launched on the decode path")

    b_diff = {}
    for tag, by_size in runs.items():
        for size, (enc, stream, _) in by_size.items():
            what = f"{tag} {size[0]}x{size[1]}"
            pics = (dec_pics[size] if tag == "IPB" else decode(stream, what))
            if len(pics) != len(enc.all_recons):
                fail(f"decode of {what}: {len(pics)} pictures, encoded "
                     f"{len(enc.all_recons)}")
            for pic, (poc, rec) in zip(pics, enc.all_recons):
                kind = pic.slice_type.name
                if pic.poc != poc:
                    fail(f"decode of {what}: POC {pic.poc}, encoded {poc}")
                dy = int((np.asarray(pic.planes.Y) != rec.Y).sum())
                dc = int((np.asarray(pic.planes.U) != rec.U).sum()
                         + (np.asarray(pic.planes.V) != rec.V).sum())
                if kind in ("I", "P") and tag != "IPB-hierarchy" and (dy or dc):
                    fail(f"decode of {what}: {kind} picture POC {poc} differs "
                         f"from the encoder's recon ({dy} luma, {dc} chroma "
                         "samples)")
                if kind == "B" or tag == "IPB-hierarchy":
                    b_diff.setdefault(what, []).append((kind, poc, dy, dc))
            print(f"decode of {what}: byte-identical to the host decode; I/P "
                  "pictures equal to the encoder's recons"
                  if tag != "IPB-hierarchy" else
                  f"decode of {what}: byte-identical to the host decode")
    for what, rows in b_diff.items():
        print(f"decode vs encoder recon, {what} (report; the reference's B "
              "windows, ROADMAP Queue 3): " + ", ".join(
                  f"{k} POC {poc}: {dy} luma / {dc} chroma samples differ"
                  for k, poc, dy, dc in rows))
    report["decode_vs_recon"] = b_diff

    # K8 against its plain version on every recorded and built input
    def hold_k8(args, H, W, ns, what):
        got = K8.decode_inter(*args, H=H, W=W, NS=ns)
        want = K8.decode_inter_plain(*args, H=H, W=W, NS=ns)
        d = (got.long() - want.long()).abs()
        err["decode_inter"] = max(err["decode_inter"], int(d.max()))
        mismatches["decode_inter"] += int((d > 0).sum())
        if int(d.max()) or got.dtype != want.dtype:
            fail(f"decode_inter {what}: differs from its plain version "
                 f"({int((d > 0).sum())} samples)")

    for what, a, H, W, ns in k8_calls:
        hold_k8(a, H, W, ns, what)
    n_built = 0
    for (W, H) in ((176, 144), CIF, HD):
        for name, arrs in dec_cases(H, W, seed=SEED + W):
            args_t = tuple(torch.as_tensor(x, device=dev) for x in arrs)
            hold_k8(args_t, H, W, DEC_NS, f"{W}x{H} built {name}")
            n_built += 1
        sides = clip_sides(arrs[3], H, W)
        if min(v for d in sides.values() for v in d.values()) == 0:
            fail(f"decode_inter built inputs {W}x{H}: a side is not clipped")
    print(f"check decode_inter: {len(k8_calls)} recorded calls (QCIF, CIF, "
          f"720p) and {n_built} built inputs (far mvs clipped on every side, "
          "WP, T8, QP 0/51, wrapping dequant) equal to the plain version "
          "(tolerance 0: bit-exact)")

    timing_d = {}
    for size in N_IPB:
        mine = [c for c in k8_calls if c[0] == f"IPB {size[0]}x{size[1]}"]
        wk = [decode_work(a, H, W) for _, a, H, W, _ in mine]
        timing_d[size] = {"decode_inter": {
            "ms": float(np.mean([cuda_ms(
                lambda c=c: K8.decode_inter(*c[1], H=c[2], W=c[3], NS=c[4]),
                10) for c in mine])),
            "plain_ms": float(np.mean([cuda_ms(
                lambda c=c: K8.decode_inter_plain(*c[1], H=c[2], W=c[3],
                                                  NS=c[4]), 1)
                for c in mine[:3]])),
            "launches_per_picture": 1,
            "work": (int(np.mean([w[0] for w in wk])),
                     int(np.mean([w[1] for w in wk])))}}
        tm = timing_d[size]["decode_inter"]
        print(f"time {size[0]}x{size[1]} decode_inter per inter picture "
              f"(mean of {len(mine)}): {tm['ms']:.4f} ms, plain "
              f"{tm['plain_ms']:.3f} ms, bound "
              f"{bound_ms(*tm['work'])[0]:.5f} ms ({tm['work'][0]} B)")
        data = runs["IPB"][size][1]
        _, dev_t = timed_decode(data, device="cuda")
        _, host_t = timed_decode(data, use_device=False)
        report[f"decode_ms_{size[0]}x{size[1]}"] = {
            "device_path": mean_by_type(dev_t),
            "host_path": mean_by_type(host_t)}
        print(f"decode {size[0]}x{size[1]} IPB ms per picture (host clock, "
              f"synchronized): device path {mean_by_type(dev_t)}, host path "
              f"{mean_by_type(host_t)}")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 8. report -----------------------------------------------------------
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        tm = (timing_d if name == "decode_inter" else timing_b
              if name in rd_b.B_OWN else timing)[CIF][name]
        b_ms, b_by = bound_ms(*tm["work"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches_dec if name == "decode_inter"
                         else launches)[name],
            "max_abs_err": err[name], "mismatches": mismatches[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    for kind, tms in (("", timing), ("b_", timing_b), ("decode_", timing_d)):
        for size, tm in tms.items():
            report[f"timing_{kind}{size[0]}x{size[1]}"] = {
                n: {**v, "bound_ms": bound_ms(*v["work"])[0]}
                for n, v in tm.items()}
    report["launches"] = {**launches_of, "decode": launches_dec}
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
