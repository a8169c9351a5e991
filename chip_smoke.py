#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h264_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

1. builds the CUDA kernels K1-K13 and K2's row-slab entry (nvcc, sm_90a,
   one process per source, all at once) and the host C runtime (gcc);
2. holds K1 (intra commit) and K2 (reference bank) against their plain
   PyTorch versions on the card, bit for bit, at CIF and 1280x720, QP 28
   and 51, and times both;
3. holds every entry of K3-K6 (search grids, quarter-pel refinement and
   MC, inter residual coding, deblocking) against its plain version on
   the card, bit for bit, on the real inputs of P pictures (1 I + 2 P) at
   CIF and 1280x720, QP 28 and 51, weighted prediction on and off, with 5
   reference frames and search range 28; times kernel and plain version
   per P picture at both sizes (QP 28, WP on), the K3 entries also beside
   their library route (``coarse_search`` by ``torch.cdist(p=1)`` on the
   unfolded decimated windows, ``ssd_grid8`` by a grouped ``conv2d`` in
   float32 with TF32 off and box-sum energies, ``sub8_search`` by the same
   grids of its quadrants, then torch's pricing and argmins, each held
   equal to the kernel); holds every entry of the
   tile-row path (``rd_rows``: the P entries but the coarse search, per
   row slab) against its plain version on the real inputs of P pictures
   in 3 rows (1 I + 2 P, CIF and 1280x720, QP 28, WP off, 5 reference
   frames, search range 28) and on built CIF inputs whose motion reaches
   +-28 up to every slab edge (tools/rows_cases.py), and times both per
   rows P picture; holds K9 (``t8_decide``,
   the 8x8-transform decision) against its plain version on the real
   inputs of P pictures with the 8x8 transform (1 I + 2 P, CIF and
   1280x720, QP 28 and 51, WP on) and on built inputs (QP 0 with +-255
   residuals, zero residuals that tie, every winner class; 1, 5, 397 and
   3600 MBs, which leave the last block of MBs short, at QP 0, 28 and 51;
   tools/t8_cases.py), and times both per CIF and 720p P picture (events,
   and on the device queued behind a spin); times
   K4's ``qpel_refine`` per shape and per picture, K6's ``deblock`` and K1
   on the P and B pictures on the device (each call queued behind a spin
   of the card) beside every kernel's time back to back, and K6's chain on
   built inputs (a 16x16 picture, an MB's step along a 1280x16 row and
   down a 16x1088 column, CIF and 720p pictures beside their chain), and
   requires, by ``torch.profiler``, one kernel and no copy per ``deblock``
   call and one ``deblock`` kernel in an I + P encode
   (h264_tpu_torch/tools/time_kernels.py, which also gives every entry of
   its ``ONE_CALL`` its device time on those pictures, one call, beside an
   empty launch of its grid);
4. holds every entry of the B pipeline (its own K7 ``b_direct``,
   ``mc_luma_win``, ``mc_chroma_b``, and the K3-K6 entries it shares,
   ``strengths`` with two lists among them) against its plain version on
   the card, bit for bit, on the real inputs of B pictures (an IPB stream
   of 5 frames) at CIF and 1280x720, B pictures at QP 30 and 51, and
   b_direct, mc_luma_win and mc_chroma_b also on inputs built so that
   their windows start outside the padded banks (the reference's
   ``dynamic_slice`` placement), and strengths also on B and P inputs
   built so that every branch of its rule decides some edges
   (tools/strengths_cases.py);
   times kernel and plain version per B picture at both sizes (QP 28),
   ``ssd_grid8`` also beside its library route;
5. drives the all-intra path (4 CIF + 2 1280x720 pictures), the IPPP
   path (CABAC, 5 reference frames, search range 28, explicit WP: 6 CIF
   and 3 1280x720 frames), the main path, the bench configuration (IPB:
   one B picture between anchors, 5 reference frames, search range 28,
   explicit WP, QP 28; 9 CIF and 5 1280x720 frames) and the hierarchical
   IPB path (``b_hierarchy``, 9 CIF frames), and this slice's paths: the
   bench configuration with the 8x8 transform (High profile, ``IPB-T8``:
   9 CIF and 5 1280x720 frames), CAVLC all-intra (4 CIF), CAVLC IPPP
   (Baseline, WP off, 6 CIF), CAVLC IPB (Main, 9 CIF) and IPPP with the
   8x8 transform and CAVLC (6 CIF), and the host-path encoder (the
   reference's default configuration, ``fast=False``, search range 16):
   CAVLC IPPP (3 CIF), CABAC IPB (5 CIF), and at 176x144 multi-slice
   (``slice_mode=1``), FMO map type 2, CAVLC data partitioning with
   redundant slices and the scaling matrices of the in-repo qmat stream
   (3 frames each), and the tile rows and the rate control: the IPPP
   configuration in 3 tile rows (WP off; 6 CIF and 3 1280x720 frames),
   CAVLC IPPP in 3 rows under rate control at 1.4 Mb/s (one reference,
   search range 8, 6 CIF frames), the bench configuration without WP under
   rate control at 1.0 Mb/s (9 CIF frames) and the host path's CAVLC IPPP
   under rate control at 350 kb/s (3 176x144 frames), and the
   error-resilient paths: the bench configuration with loss-aware RDO
   (JM's defaults NumberOfDecoders 30 and LossRateA 10 %) and intra refresh
   (22 MBs per P picture), ``IPB-ER`` (9 CIF and 5 1280x720 frames), and
   the same without B pictures, ``IPPP-ER`` (6 CIF frames: drift penalties
   on 4 consecutive P pictures), and the legacy P16x16 path (``rd=False``:
   ``IPPP-legacy``, CAVLC at the default pipeline depth 8, so the P
   pictures' outputs come back in one stacked fetch, 6 CIF and 3 1280x720
   frames; ``IPPP-legacy-cabac``, 6 CIF frames at depth 1; QP 28, search
   range 28), through
   ``H264Encoder(..., device="cuda").encode_stream``, each with the
   kernels' launch counters set to 0 just before and read just after (and
   read around each picture: a tile-row P picture's launches); then holds
   K10 (``sad_grid_16x16``, the
   host path's SAD grids) against its plain version on every input the
   host-path encodes gave it and on built ones (176x144, CIF, 1280x720;
   search ranges 0, 16 and 64; random and 0/255 planes), and times it per
   call at CIF and 1280x720, R 16 (events, mean of 20) beside its plain
   version and ``torch.cdist`` (p=1, float32, exact below 2^24) on the
   ``unfold``ed windows; holds K11 (``propagate_drift``, the simulated
   decoders' drift step) against its plain version on every step of the
   error-resilient encodes (CIF, 1280x720) and on the built inputs of
   tools/drift_cases.py (|drift| to 4095 and 60000, all / none lost, all
   intra, gathers clipped on every side, MB totals at 2^24 - 1, 2^24 and
   2^24 + 1; K 1, 3 and 30 at CIF and 1280x720, 33 and 64 at CIF),
   prints the share of MBs on its ordered route (from the plain version's
   terms) for each recorded path and built case, and times both per P
   picture at CIF and 1280x720 with K 30 (events, mean of 20; the kernel
   also on the device, queued behind a spin); holds K12 (``p16_search``) and K13 (``p16_refine``) against
   their plain versions on every call of the legacy encodes (QP 28, and 1
   I + 2 P at QP 0 and 51, CIF and 1280x720) and on the built inputs of
   tools/p16_cases.py (0/255 and flat planes, motion to +-28 at every
   picture edge; QP 0, 28, 51; CIF and 1280x720), and K2 and K6 on every
   call the legacy encodes made of them; times K12 and K13 per P picture at
   CIF and 1280x720 beside their plain versions, K12 also beside the
   reference's own route through library calls (``conv2d`` for the cross
   term, in float32 with TF32 off, exact, and in bfloat16, whose output is
   rounded; box sums for the energies), and K2 and K6 on the legacy
   inputs;
6. encodes the same frames at CIF (the host path's 176x144 ones at
   176x144) through the kernels' plain versions on the card (the IPB-T8
   path: its first 5 frames, encoded again through the kernels; not the
   fixed-QP tile rows, whose entries step 3 holds on their inputs), each
   path in a worker process of its own (6 at a time: the plain versions
   are host-bound), and requires the identical streams, recons and
   reference entries (the 1280x720 encodes are not repeated: steps 2-4
   hold every entry on recorded 720p inputs, and K1's plain version alone
   takes several seconds per CIF picture);
7. the decoder: decodes the 17 in-repo streams (QCIF) and every stream
   of step 5 with ``H264Decoder(device="cuda")``, recording K8's
   (``decode_inter``) inputs, and requires each decode to be
   byte-identical to the native host decode (``use_device=False``) and
   the I and P pictures of the all-intra, IPPP and IPB streams and every
   picture of the host-path and legacy streams to equal the encoder's
   recons (B
   pictures of the RD path and the hierarchical stream: the count of
   samples that differ is printed, not checked; the FMO stream: the
   reference's decoder, and so the port's, decodes each of its pictures
   as two, ROADMAP Queue 3, so its count is checked instead); K8's launch
   counter is set to 0 just before the decode of the CIF and 720p IPB
   streams and read just after; holds K8 against its plain version bit
   for bit on every recorded input and on built inputs (far mvs, WP, T8,
   QP 0/51, wrapping dequant; tools/decode_cases.py) at QCIF, CIF and
   1280x720; times K8 and its plain version per CIF and 720p picture and
   the decode per picture type, device and host path; drops the slice of
   the second P picture of the IPPP-ER stream and decodes what is left
   with concealment (frame copy and motion copy) on both decoder paths,
   byte-identical;
8. runs the command-line chain in a temporary directory: ``python -m
   h264_tpu_torch.lencod`` on 3 seeded 176x144 frames with ``-p``
   overrides (a text SEI, RTP output), ``tools.rtp_loss`` and
   ``tools.rtpdump`` on its output and ``h264_tpu_torch.ldecod`` on it,
   each exit code 0 and the decode equal to the recon file;
9. the sharded tile-row pipelines (``h264_tpu_torch/parallel/``; the
   ranks are processes that share this one card over gloo, their halos
   staged through host memory, and nccl at world size 1, so their times
   are no scaling result): holds K2's row-slab entry ``ref_bank_rows``
   against its plain version on built slabs (0/255 and random; top,
   middle and bottom shards; Hg 16, where zero rows appear, 144 and 240)
   and on every slab the runs below built, and times it at the CIF slab
   beside its plain version and ``ref_bank`` on a plane of the same
   height; codes GOPs of P pictures with ``rd_gop_rows_sharded`` (R 28,
   QP 28, CAVLC, ``moving_frames``; each GOP's I picture by the RD encoder
   in tile rows, one reference): CIF over mesh (frame 2, row 2), 8 P
   pictures per GOP, 1280x720 over (1, 3), 3 P pictures (a middle shard),
   and the CIF GOP over (1, 1) on nccl; requires each run's host
   buffers, recons and CAVLC slices to equal the single-device tile-row
   chain (``rd_p_rows_pipeline``) on the card, each GOP's stream (SPS,
   PPS, IDR and the sharded P pictures) to decode with
   ``H264Decoder(device="cuda")`` to the sharded recons, and every kernel
   of the path to have launched in the ranks; runs
   ``dryrun_multichip(8)`` on 8 gloo ranks and requires the
   ``stream_bytes=25923`` of ``MULTICHIP_r05.json`` and the host buffers,
   recon and stream digests that tests/torch_records.py recorded from
   h264_tpu; prints per-rank step, exchange and ``ref_bank_rows`` times
   beside the chain's time per picture;
10. prints per-picture times for I, P and B pictures (CUDA events and host
   clock around each ``encode_stream`` step, pipeline depth 1), their
   means per type with sample counts, PSNR-Y, bytes, each slice's QP and
   the mode mixes (with the 8x8 transform, the share of 8x8-transform MBs
   among the P MBs), the achieved bitrate of each rate-controlled stream
   against its target, a tile-row P picture's launches, the intra-MB share
   of the P pictures of the error-resilient paths beside their paths
   without it and the largest |drift| of their simulated decoders, a
   ``kernels`` JSON line (launches from the main path, the bench
   configuration; K9's from the IPB-T8 path; K10's from the CIF host-path
   IPPP and IPB encodes; K8's from the decode of step 7; K11's from the
   IPB-ER path; K12's and K13's from the IPPP-legacy path;
   ``ref_bank_rows``'s from the ranks of the CIF (2, 2) sharded run; and
   each entry's launches per CIF tile-row P picture), the P_Skip share of the
   legacy P pictures, the seconds the run took, the card's name and power
   limit, and as its last line the result object.

Inputs are seeded synthetic frames (h264_tpu_torch/tools/synthseq.py).
Exits non-zero, printing no result, when no CUDA card is present or the
package is not beside the script.  With ``--out DIR`` the details also go
to ``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CIF = (352, 288)
HD = (1280, 720)
N_INTRA = {CIF: 4, HD: 2}  # all-intra path
K1_REPS = 5  # K1 launches on each adversarial is_intra pattern (step 2)
N_IPPP = {CIF: 6, HD: 3}  # IPPP path: 1 I + 5 / 2 P
N_IPB = {CIF: 9, HD: 5}  # the main path: I P B P B ... (4 / 2 B)
N_HIER = 9  # hierarchical IPB at CIF: I, 2 x (P, stored B, 2 B)
N_IPB_T8_PLAIN = 5  # the IPB-T8 path's frames held against the plain path
QCIF = (176, 144)
N_HOST = {"P": 3, "B": 5}  # host-path frames: I P P, I P B P B
ROWS = 3  # tile-row slices per P picture (96 lines at CIF, 240 at 720p)
# rate control targets (bits/s): the reference's QCIF test rate (350 kb/s)
# scaled by pixels to CIF; the bench configuration; the QCIF host path
RC_ROWS, RC_IPB, RC_HOST = 1.4e6, 1.0e6, 350e3
# error-resilient paths: JM's NumberOfDecoders and LossRateA defaults
# (lencod's encoder.cfg), forced intra MBs per P picture
ER = dict(loss_aware_k=30, loss_rate=0.1, intra_refresh=22)
SEED = 2026
# the sharded GOP encoder (step 9): P pictures per GOP at CIF and 720p,
# search range, QP
S_SH, S_SH_HD, R_SH, QP_SH = 8, 3, 28, 28
PLAIN_WORKERS = 6  # processes of step 6 (the card's host has 8 cores)
# H100 SXM HBM3 bytes/s (NVIDIA data sheet, 700 W).  The operation rates
# are the card's own, set by main() from lane_rates().  Counting rule: an
# operation is one instruction on one lane, counted as the function needs
# it: a multiply-add is one; a __dp4a is one for 4 u8 multiply-adds, so an
# SSD over u8 samples costs a quarter per term (sum cur^2 - 2 sum cur ref
# + sum ref^2, the squares shared by the cells); a SAD over u8 samples a
# quarter per term (VABSDIFF4, 4 samples with their sum); values that fit
# 16 bits two an instruction (16-bit lanes); a value computed once per
# plane is counted once.  Integer instructions issue on the INT32
# pipe, 64 lanes per SM a clock; float32 ones on the FP32 pipe, 128 lanes,
# which is also the SM's issue rate (4 schedulers, one warp-instruction a
# clock each), so both kinds together take at least (int + float) / FP32
HBM_BPS = 3.35e12
INT32_OPS = FP32_OPS = None
# MACs of one __dp4a; u8 samples of one VABSDIFF4
DP4A_MACS = 4
# integer operations per sample, counted from csrc/common.cuh: Hadamard
# cost (residual 1, two butterfly passes 4, absolute value and sum 2);
# transform/quant/recon (residual 1, forward 4, quant 5: abs, the
# multiply-add with its offset, shift, sign; bits 6; dequant 2: a
# multiply-add by the scale shifted by per, shift; inverse 5; rounding and
# recon 4; SSD 2: difference, multiply-add); I4 adds its 3-tap prediction
OPS_SATD, OPS_TQ = 7, 29
OPS_I4 = OPS_TQ + 3
# i16_candidate's Hadamard costs in 16-bit pairs: the residual (|d| <=
# 255), the butterflies' sums (<= 16 x 255) and the absolute sum of a
# block (<= 16 x 4080 < 2^16) all fit 16 bits, a half each
OPS_SATD_16 = OPS_SATD / 2
# per coefficient of csrc/inter_tq.cu: OPS_TQ plus RDOQ-lite's integer part
# (two dequants, the decremented level, an inverse and a forward transform,
# the residual's shift, two absolute values, two bit counts, the
# decision: 29) and the coeff_cost scan (3); its float32 part (three
# conversions, six products, a difference and a sum: 12, FP32 pipe)
OPS_INTER_TQ, FOPS_INTER_TQ = OPS_TQ + 32, 12
# inter_luma_tq and inter_chroma_tq: the same, with the residual (|d| <=
# 255) and its forward transform (|c| <= 36 x 255) in 16-bit pairs, a half
# each (1 + 4 -> 2.5); chroma's 2x2 DC transforms, a few operations per
# plane, are not counted
OPS_INTER_LUMA = OPS_INTER_CHROMA = OPS_INTER_TQ - 2.5
# qpel_refine (csrc/qpel.cu): per distinct quarter-pel sample of a unit
# the two bank samples' rounded mean, a quarter (__vavgu4, 4 u8 samples);
# per sample of a candidate its residual (1), Hadamard share (4), absolute
# value and sum (1 with the next residual's), all within 16 bits (|d| <=
# 255, each Hadamard sum <= 16 * 255, the absolute sum of the 16 <= 16320),
# so two an instruction: 3; WP (5: multiply-add with the rounding, shift,
# offset, clamp 2) on each distinct sample
OPS_QMEAN_PER_4, OPS_QPEL_PAIRS, OPS_WP = 1, 3, 5
# per filtered line of csrc/deblock.cu (8 loads, the tests, the filter)
OPS_LINE = 40
# per sample of a bilinear chroma prediction: four taps, a multiply-add
# each (the rounding in the first), and the shift; the weights are the
# 4x4 block's
OPS_BILIN = 5
# per sample of csrc/b_direct.cu (the unit's derivation shared by its 64
# samples, two window samples per list, their means) and of the chroma
# samplers (a bilinear prediction per list, their rounded mean, the
# select)
OPS_DIRECT, OPS_CHROMA_B = 12, 2 * OPS_BILIN + 3
# per 4x4 block edge of strengths: the two-list pairing rule (four mv
# pairs) and the one-list rule; per 4x4 block reading the 16 levels of
# its 4x4 block, or 64 of its 8x8 one, a quarter each (one 16-byte OR)
OPS_BS_B, OPS_BS_P = 40, 12
# per sample of the 8x8 transform path (csrc/t8.cu): forward and inverse
# 8-point butterflies, two passes each (16), quant 5, bits 6, dequant 2,
# rounding and recon 4, the SSD of the 8x8 and of the 4x4 recon (4)
OPS_T8 = 37
# per sample of the 6-tap half-pel planes (csrc/ref_bank.cu): b and h 8
# each (three pair sums, the rounding in one, two multiply-adds for the
# 20 and -5 taps, shift, clamp 2); j 13 (its unrounded vertical sums, 5,
# shared along the row, the 6-tap over them, shift, clamp)
OPS_BANK = 29
# per sample and decoder of csrc/propagate_drift.cu: the select, the
# lost-picture add, the square and its exact sum (integer); on the MBs
# whose float32 sum can round, the conversion and the float32 addition
# (FP32 pipe)
OPS_DRIFT, FOPS_DRIFT = 4, 2
# per MB of p16_refine beside the coding: the 49 candidates' 256 squared
# errors of u8 samples and the 40 averaging candidates' 256 rounded byte
# means, a quarter each (__dp4a, __vavgu4: 4 u8 samples), and per
# candidate its rate and first-minimum step (OPS_CELL + 3, as a cell of
# p16_search)
P16_CANDS, P16_MEANS = 49, 40
# per grid cell of the dense searches (p16_search, ssd_grid8): the SSD's
# three terms combined (2); p16_search adds the rate and the first minimum
# (3)
OPS_CELL = 2
# per grid cell of sub8_search beside its 16 __dp4a: the four SSDs'
# three terms combined (4 x OPS_CELL; the energies shared by the cells,
# as for ssd_grid8), the four pair sums (4), the rate (the row's and
# column's bits summed, lam_cost's two products, shift and sum: 5) and
# eight first-minimum updates (8)
OPS_SUB8_CELL = 4 * OPS_CELL + 4 + 5 + 8
# per sample of csrc/decode_inter.cu: a luma prediction per list (two
# reads' rounded mean), a chroma one per list (bilinear), and per inter
# sample the weighting and select (5), dequant 2, two transform passes 5
# and the recon 4
OPS_DEC_MC_L, OPS_DEC_MC_C, OPS_DEC_RES = 2, OPS_BILIN, 16
SOURCES = {
    "intra_commit": ("h264_tpu_torch/csrc/intra_commit.cu",
                     "h264_tpu/encoder/rd.py:1415"),
    "ref_bank": ("h264_tpu_torch/csrc/ref_bank.cu",
                 "h264_tpu/encoder/rd.py:101"),
    "coarse_search": ("h264_tpu_torch/csrc/search_grid.cu",
                      "h264_tpu/encoder/rd.py:398"),
    "ssd_grid8": ("h264_tpu_torch/csrc/search_grid.cu",
                  "h264_tpu/encoder/rd.py:435"),
    "sub8_search": ("h264_tpu_torch/csrc/search_grid.cu",
                    "h264_tpu/encoder/rd.py:640, :666"),
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
                  "h264_tpu/encoder/rd.py:1713, :1928"),
    "deblock": ("h264_tpu_torch/csrc/deblock.cu",
                "h264_tpu/encoder/rd.py:1800"),
    "b_direct": ("h264_tpu_torch/csrc/b_direct.cu",
                 "h264_tpu/encoder/rd.py:2226"),
    "mc_luma_win": ("h264_tpu_torch/csrc/qpel.cu",
                    "h264_tpu/encoder/rd.py:1911"),
    "mc_chroma_b": ("h264_tpu_torch/csrc/qpel.cu",
                    "h264_tpu/encoder/rd.py:2453"),
    "decode_inter": ("h264_tpu_torch/csrc/decode_inter.cu",
                     "h264_tpu/decoder/device.py:99"),
    "t8_decide": ("h264_tpu_torch/csrc/t8.cu", "h264_tpu/encoder/rd.py:1071"),
    "sad_grid_16x16": ("h264_tpu_torch/csrc/sad_grid.cu",
                       "h264_tpu/encoder/me.py:25"),
    "propagate_drift": ("h264_tpu_torch/csrc/propagate_drift.cu",
                        "h264_tpu/encoder/lossaware.py:35"),
    "p16_search": ("h264_tpu_torch/csrc/p16_search.cu",
                   "h264_tpu/encoder/fast.py:117"),
    "p16_refine": ("h264_tpu_torch/csrc/p16_refine.cu",
                   "h264_tpu/encoder/fast.py:160"),
    "ref_bank_rows": ("h264_tpu_torch/csrc/ref_bank.cu",
                      "h264_tpu/encoder/rd.py:2662"),
}
# the legacy path's entries (fast.LKernels) and its encodes' pipeline depth
LEGACY = ("p16_search", "p16_refine", "strengths", "deblock", "ref_bank")
DEPTH = {"IPPP-legacy": 8}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def ref_state(enc):
    """The reference state an encoder keeps on the card, as numpy: each RD
    reference entry (POC, bank, cpad and colocated fields) and the legacy
    path's (Ypad, b, h, j, Upad, Vpad)."""
    out = [(e[0], [x.cpu().numpy() for x in (*e[1:3], *e[3])])
           for e in enc._rd_refs]
    if enc._dev_ref is not None:
        out.append(("legacy", [x.cpu().numpy() for x in enc._dev_ref]))
    return out


def plain_encode(job):
    """Step 6's worker: encode `fr` under `cfg` through the kernels' plain
    versions on the card (pipeline depth 1).  Returns the stream, the
    recon planes, the reference entries and the simulated decoders' drift
    (None without loss-aware RDO) as numpy arrays and the seconds
    taken."""
    import torch

    from h264_tpu_torch.bitstream import write_annexb
    from h264_tpu_torch.encoder import fast, rd_b, rd_p
    from h264_tpu_torch.encoder.encoder import H264Encoder
    from h264_tpu_torch.encoder.lossaware import propagate_drift_plain
    from h264_tpu_torch.kernels import intra_commit as K1
    from h264_tpu_torch.kernels import ref_bank as K2
    from h264_tpu_torch.kernels import sad_grid as K10

    class PlainEncoder(H264Encoder):
        _intra_scan = staticmethod(K1.intra_commit_scan_plain)
        _ref_bank = staticmethod(K2.ref_bank_plain)
        _sad_grid = staticmethod(K10.sad_grid_16x16_plain)
        _propagate_drift = staticmethod(propagate_drift_plain)
        _p_kernels = rd_p.PLAIN
        _b_kernels = rd_b.PLAIN
        _legacy_kernels = fast.PLAIN

    _, _, cfg, fr = job
    t0 = time.perf_counter()
    enc = PlainEncoder(cfg, device="cuda")
    nalus = enc.headers()
    for out in enc.encode_stream(fr, depth=1):
        nalus.extend(out)
    recons = [(p.Y, p.U, p.V) for _, p in enc.all_recons]
    refs = ref_state(enc)
    drift = None if enc._lsim is None else enc._lsim.drift.cpu().numpy()
    torch.cuda.synchronize()
    return write_annexb(nalus), recons, refs, drift, time.perf_counter() - t0


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
                n * h * w * 2)  # a rounded mean per sample
    if name == "mc_chroma_b":
        n_mb = args[2].shape[0]
        u0, u1 = args[7], args[8]
        lists = int(u0.sum()) + int((u1 | ~u0).sum())  # list 1 if not u0
        return (lists * 2 * 25 * 4 + n_mb * 4 * (5 * 4 + 2)
                + n_mb * 128 * 4, n_mb * 128 * OPS_CHROMA_B)
    raise KeyError(name)


def entry_work(name: str, args):
    """(bytes, int32 ops[, float32 ops]) of one call of any P or B kernel
    entry."""
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
    return nbytes, Hp * Wp * OPS_BANK


def p_work(name: str, args):
    """(bytes, int32 ops) of one call of a P kernel entry, from the shapes
    (and, for the filter, the strengths) of its inputs: each input the
    function needs read once, each output written once."""
    import torch

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    if name in ("coarse_search", "ssd_grid8", "sub8_search", "qpel_refine"):
        banks, cur_y = args[0], args[1]
        NR, _, Hp, Wp = banks.shape
        wp = args[{"coarse_search": 2, "ssd_grid8": 4, "sub8_search": 7,
                   "qpel_refine": 9}[name]]
        g_plane = NR * Hp * Wp * 4  # the G plane of every reference
        wpo = OPS_WP if wp is not None else 0
    if name == "coarse_search":
        n_mb = cur_y.numel() // 256
        cells = NR * n_mb * 25 * 25
        # WP and the 4 x 4 decimation once per plane (a sum of 16 samples,
        # IADD3 taking two an instruction); per cell 16 SAD terms of 12-bit
        # sums (two 16-bit lanes an instruction), the rate (its x and y
        # parts a row and a column each), the first minimum: 4
        return (g_plane + nb(cur_y) + 2 * NR * n_mb * 4,
                NR * Hp * Wp * (wpo * 2 + 1) // 2 + cells * (16 // 2 + 4))
    if name == "ssd_grid8":
        # the MACs in __dp4a, the cells' three terms combined, WP once on
        # each sample the windows read (no more than the plane)
        R = args[5]
        D = 2 * R + 1
        n_b8 = cur_y.numel() // 64
        return (g_plane + nb(cur_y, args[2], args[3]) + NR * n_b8 * D * D * 4,
                NR * n_b8 * D * D * (64 // DP4A_MACS + OPS_CELL)
                + min(NR * (n_b8 // 4) * (D + 15) ** 2, NR * Hp * Wp) * wpo)
    if name == "sub8_search":
        # per cell the 64 MACs in __dp4a and OPS_SUB8_CELL; WP once on
        # each sample the units' windows read (no more than the planes);
        # out: 8 mvs a unit
        RS = args[8]
        DS = 2 * RS + 1
        n = args[2].numel()
        return (g_plane + nb(cur_y, *args[2:7]) + n * 16 * 4,
                n * DS * DS * (64 // DP4A_MACS + OPS_SUB8_CELL)
                + min(n * (DS + 7) ** 2, NR * Hp * Wp) * wpo)
    if name == "qpel_refine":
        h, w = args[11], args[12]
        n = args[2].numel()
        # the (4, h+2, w+2) window every candidate's samples lie in
        windows = n * 4 * (h + 2) * (w + 2) * 4
        # the mean and WP once on each of the (4h+3) x (4w+3) distinct
        # quarter-pel samples the 49 candidates reach; per candidate its
        # samples' SATD share, and its cost and first minimum (20)
        return (windows + n * h * w * 4 + nb(*args[2:9]) + n * (h * w + 3) * 4,
                n * ((4 * h + 3) * (4 * w + 3) * (OPS_QMEAN_PER_4 + 4 * wpo)
                     // 4 + 49 * (h * w * OPS_QPEL_PAIRS + 20)))
    if name == "mc_luma":
        n, h, w = args[1].numel(), args[7], args[8]
        return (n * 4 * (h + 1) * (w + 1) * 4 + nb(*args[1:6]) + n * h * w * 4,
                n * h * w * (2 + (OPS_WP if args[6] is not None else 0)))
    if name == "mc_chroma":
        n_mb = args[1].shape[0]
        return (n_mb * 16 * 2 * 9 * 4 + nb(*args[1:]) + n_mb * 128 * 4,
                n_mb * 128 * OPS_BILIN)
    if name == "inter_luma_tq":
        pred, orig = args[0], args[1]
        NC, n_mb = pred.shape[:2]
        out = NC * n_mb * (256 + 256 + 8) * 4
        return (nb(pred, orig) + out, int(pred.numel() * OPS_INTER_LUMA),
                pred.numel() * FOPS_INTER_TQ)
    if name == "inter_chroma_tq":
        n_mb = args[0].shape[0]
        return (nb(args[0], args[1]) + n_mb * (128 + 8 + 128) * 4,
                int(n_mb * 128 * OPS_INTER_CHROMA),
                n_mb * 128 * FOPS_INTER_TQ)
    if name == "i16_candidate":
        cur_y = args[0]
        n_mb = cur_y.numel() // 256
        return (nb(cur_y) + n_mb * 258 * 4,
                int(n_mb * 256 * (4 * OPS_SATD_16 + OPS_TQ)))
    if name == "strengths":
        # the fields and levels read once, both bS planes written once
        a = (*args, *(None,) * (15 - len(args)))
        n = 16 * a[0] * a[1]
        coef = sum(t.numel() // n for t in (a[2], a[7])
                   if isinstance(t, torch.Tensor))
        ops = OPS_BS_B if a[11] is not None else OPS_BS_P
        return nb(*a[2:]) + 2 * n * 4, n * (2 * ops + coef // 4)
    if name == "deblock":
        y, u, v, bsv, bsh = args[:5]
        # filtered lines: 4 luma and 2 chroma lines per plane per 4-sample
        # edge segment with bS > 0
        seg = int((bsv > 0).sum()) + int((bsh > 0).sum())
        return 2 * nb(y, u, v) + nb(bsv, bsh), seg * (4 + 2 * 2) * OPS_LINE
    if name == "t8_decide":
        n_mb = args[0].shape[0]
        # orig, pred, 4x4 recon and levels, win, sub, intra in; the flags,
        # 8x8 levels, 4x4 levels and recon out
        return nb(*args[:7]) + n_mb * (1 + 3 * 256) * 4, n_mb * 256 * OPS_T8
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


def sad_work(H: int, W: int, R: int):
    """(bytes, int32 ops) of one K10 call: the picture and the padded
    reference read once, the grid written once; per position and MB 256
    SAD terms of u8 samples, 4 an instruction (csrc/sad_grid.cu)."""
    D = 2 * R + 1
    n_mb = (H // 16) * (W // 16)
    return (H * W + (H + 2 * R) * (W + 2 * R) + D * D * n_mb) * 4, (
        D * D * H * W // DP4A_MACS)


def sad_cdist(cur, ref_p, R: int):
    """The SAD grids by one library computation (a yardstick, not a
    path): every MB's 256 samples against the unfolded 16x16 windows of
    its (16+2R)^2 search area, ``torch.cdist`` with p=1 in float32 (exact:
    every partial sum is an integer below 2^24)."""
    import torch

    H, W = cur.shape
    n_my, n_mx, D, S = H // 16, W // 16, 2 * R + 1, 16 + 2 * R
    x1 = (cur.float().reshape(n_my, 16, n_mx, 16).permute(0, 2, 1, 3)
          .reshape(n_my * n_mx, 1, 256))
    x2 = (ref_p.float().unfold(0, S, 16).unfold(1, S, 16)
          .unfold(2, 16, 1).unfold(3, 16, 1)
          .reshape(n_my * n_mx, D * D, 256))
    d = torch.cdist(x1, x2, p=1)
    return d.reshape(n_my, n_mx, D, D).permute(2, 3, 0, 1)


def drift_work(K: int, H: int, W: int, ordered: float = 1.0):
    """(bytes, int32 operations, float32 operations) of one K11 call: the
    drift read and the new drift written, the delta, mv4, intra and lost
    read once, the penalty written; the float32 sum only on the share
    `ordered` of the MBs that need the reference's order (the others'
    exact integer total gives it)."""
    n4 = (H // 4) * (W // 4)
    nbytes = (2 * K + 1) * H * W * 4 + n4 * (8 + 1) + K + (H // 16) * (
        W // 16) * 4
    return (nbytes, OPS_DRIFT * K * H * W,
            round(FOPS_DRIFT * K * H * W * ordered))


def p16_search_work(H: int, W: int, R: int):
    """(bytes, int32 ops) of one K12 call: the picture and the search area
    of the padded reference read once, three int32 per MB written; per
    offset and MB 256 SSD terms of u8 samples in __dp4a, the terms
    combined, the rate and the first minimum."""
    D = 2 * R + 1
    n_mb = (H // 16) * (W // 16)
    return (H * W + (H + 2 * R) * (W + 2 * R) + 3 * n_mb) * 4, (
        D * D * (H * W // DP4A_MACS + n_mb * (OPS_CELL + 3)))


def p16_refine_work(H: int, W: int):
    """(bytes, int32 ops) of one K13 call: the current planes, the integer
    vectors, and the windows the candidates read (per MB at most 18 x 18
    samples of each of G, b, h and j and 9 x 9 of each chroma pad; no more
    than the planes), the outputs written once; per MB the candidates'
    squared errors and byte means of u8 samples, a quarter each, each
    candidate's rate and first minimum, the luma and chroma coding per
    sample."""
    n_mb = (H // 16) * (W // 16)
    Hp, Wp = H + 64, W + 64
    luma = min(n_mb * 4 * 18 * 18, Hp * Wp + 3 * (Hp - 5) * (Wp - 5))
    chroma = min(n_mb * 2 * 81, 2 * (H // 2 + 64) * (W // 2 + 64))
    inputs = H * W * 3 // 2 + 2 * n_mb + luma + chroma
    outputs = 2 * n_mb + 2 * H * W + 2 * (H * W // 2) + 8 * n_mb
    ops = n_mb * ((P16_CANDS + P16_MEANS) * 256 // DP4A_MACS
                  + P16_CANDS * (OPS_CELL + 3) + 256 * OPS_TQ
                  + 128 * (OPS_BILIN + OPS_TQ))
    return (inputs + outputs) * 4, ops


def ssd_conv(cur, ref_pad, R: int, lam: int, dtype):
    """The integer search by the reference's own route through library
    calls (fast.py:117-158; a yardstick, not a path): the cross term of
    every MB against the whole search area by one ``conv2d`` (`dtype`
    float32 with TF32 off is exact: every partial sum is an integer below
    2^24; PyTorch's bfloat16 ``conv2d`` rounds its output to bfloat16),
    the window energies by box sums, each MB's (2R+1)^2 window gathered,
    the rate added and the first minimum taken.  Returns (int_mvx, int_mvy,
    grid0) as K12 does."""
    import torch
    import torch.nn.functional as F

    from h264_tpu_torch.encoder.fast import mv_bits
    from h264_tpu_torch.encoder.rd import _lam_cost

    H, W = cur.shape
    n_my, n_mx, D, P = H // 16, W // 16, 2 * R + 1, 32
    refw = ref_pad[P - R: P + H + R, P - R: P + W + R]
    curb = cur.reshape(n_my, 16, n_mx, 16).permute(0, 2, 1, 3).reshape(
        -1, 1, 16, 16)
    cross = F.conv2d(refw[None, None].to(dtype), curb.to(dtype))[0].float()
    r2 = (refw * refw).long()
    vc = F.pad(r2, (0, 0, 1, 0)).cumsum(0)
    vbox = vc[16:] - vc[:-16]
    hc = F.pad(vbox, (1, 0)).cumsum(1)
    ref2 = (hc[:, 16:] - hc[:, :-16]).float()
    cur2 = (curb.float() ** 2).sum((1, 2, 3))
    i = torch.arange(n_my * n_mx, device=cur.device)
    a = torch.arange(D, device=cur.device)
    iy = ((i // n_mx) * 16)[:, None] + a
    ix = ((i % n_mx) * 16)[:, None] + a
    cw = cross[i[:, None, None], iy[:, :, None], ix[:, None, :]]
    rw = ref2[iy[:, :, None], ix[:, None, :]]
    ssd = (rw - 2.0 * cw + cur2[:, None, None]).round().int()
    bits = mv_bits(torch.arange(-R, R + 1, device=cur.device,
                                dtype=torch.int32) * 4)
    cost = ssd + _lam_cost(lam, bits[:, None] + bits[None, :])
    best = cost.reshape(-1, D * D).argmin(1).int()
    return ((best % D - R).reshape(n_my, n_mx),
            (best // D - R).reshape(n_my, n_mx),
            ssd[:, R, R].reshape(n_my, n_mx))


def grid_conv(win, blk):
    """SSD grids of B blocks (B, n, n) against their windows (B, n + D -
    1, n + D - 1) by library calls (a yardstick, not a path): the cross
    term by one grouped ``conv2d`` in float32 with TF32 off (exact: every
    partial sum is an integer below 2^24), the window energies by box sums
    of an integral image; (B, D, D) int32."""
    import torch
    import torch.nn.functional as F

    n = blk.shape[-1]
    cross = F.conv2d(win.float()[None], blk.float()[:, None],
                     groups=win.shape[0])[0]
    sq = F.pad(win.long() ** 2, (1, 0, 1, 0)).cumsum(1).cumsum(2)
    e = sq[:, n:, n:] - sq[:, :-n, n:] - sq[:, n:, :-n] + sq[:, :-n, :-n]
    cur2 = (blk.long() ** 2).sum((1, 2))
    return (e - 2 * cross.round().long() + cur2[:, None, None]).int()


def ssd_grid8_lib(banks, cur_y, cen_x, cen_y, wp, R: int):
    """K3 ``ssd_grid8``'s function by the library route: each (ref, 8x8
    block)'s window gathered (clamped, weighted) as the plain version
    gathers it, then ``grid_conv``; (NR, n_b8, D, D)."""
    import torch

    from h264_tpu_torch.encoder import rd_p

    NR, _, Hp, Wp = banks.shape
    H, W = cur_y.shape
    D, Wn = 2 * R + 1, 2 * R + 8
    by, bx, mb = rd_p._b8_geometry(H, W, banks.device)
    a = torch.arange(Wn, device=banks.device)
    rows = rd_p._clampi((by + cen_y.reshape(NR, -1)[:, mb] - R + rd_p.PAD)
                        [..., None] + a, Hp - 1)
    cols = rd_p._clampi((bx + cen_x.reshape(NR, -1)[:, mb] - R + rd_p.PAD)
                        [..., None] + a, Wp - 1)
    r = torch.arange(NR, device=banks.device)[:, None, None, None]
    win = rd_p._wp(banks[r, 0, rows[..., :, None], cols[..., None, :]], wp, r)
    a8 = torch.arange(8, device=banks.device)
    cur8 = cur_y[(by[:, None] + a8)[:, :, None], (bx[:, None] + a8)[:, None, :]]
    return grid_conv(win.reshape(-1, Wn, Wn),
                     cur8.repeat(NR, 1, 1)).reshape(NR, -1, D, D)


def sub8_search_lib(banks, cur_y, u_ref, u_cy, u_cx, u_px, u_py, wp,
                    RS: int, lam_me: int):
    """K3 ``sub8_search``'s function by the library route: the quadrant
    grids by ``grid_conv`` on the windows the plain version gathers, then
    the partition sums, the pricing and the first minima in torch;
    (2, 8, nsb)."""
    import torch

    from h264_tpu_torch.encoder import rd_p
    from h264_tpu_torch.encoder.rd import _lam_cost, _mv_bits

    _, _, Hp, Wp = banks.shape
    n_mx = cur_y.shape[1] // 16
    dev = banks.device
    DS, Wn = 2 * RS + 1, 2 * RS + 4
    u = torch.arange(u_ref.shape[0], device=dev)
    mb, b8, q = u // 4, u % 4, torch.arange(4, device=dev)
    y0 = (16 * (mb // n_mx) + 8 * (b8 >> 1))[:, None] + 4 * (q >> 1)
    x0 = (16 * (mb % n_mx) + 8 * (b8 & 1))[:, None] + 4 * (q & 1)
    a = torch.arange(Wn, device=dev)
    rows = rd_p._clampi((y0 + u_cy[:, None] - RS + rd_p.PAD)[..., None] + a,
                        Hp - 1)
    cols = rd_p._clampi((x0 + u_cx[:, None] - RS + rd_p.PAD)[..., None] + a,
                        Wp - 1)
    r = u_ref.long()[:, None, None, None]
    win = rd_p._wp(banks[r, 0, rows[..., :, None], cols[..., None, :]], wp, r)
    a4 = torch.arange(4, device=dev)
    cb = cur_y[(y0[..., None] + a4)[..., :, None],
               (x0[..., None] + a4)[..., None, :]]
    s44 = grid_conv(win.reshape(-1, Wn, Wn),
                    cb.reshape(-1, 4, 4)).reshape(-1, 4, DS, DS)
    off = torch.arange(-RS, RS + 1, dtype=torch.int32, device=dev) * 4
    by = _mv_bits(u_cy[:, None] * 4 + off - u_py[:, None])
    bx = _mv_bits(u_cx[:, None] * 4 + off - u_px[:, None])
    parts = torch.stack([s44[:, list(p)].sum(1, dtype=torch.int32)
                         for p in rd_p.SUB8_PARTS])
    k = (parts + _lam_cost(lam_me, by[:, :, None] + bx[:, None, :])).reshape(
        8, u.shape[0], -1).argmin(-1).to(torch.int32)
    return torch.stack([k % DS - RS + u_cx, k // DS - RS + u_cy])


def coarse_search_lib(banks, cur_y, wp, lam_me: int):
    """K3 ``coarse_search``'s function by the library route: the
    decimated planes as the plain version makes them, every (ref, MB)'s
    DCO x DCO candidate 16-vectors unfolded, their SADs by one
    ``torch.cdist(p=1)`` (float32, exact: integers below 2^24), the rate
    added and the first minimum taken; (cen_x, cen_y)."""
    import torch

    from h264_tpu_torch.encoder import rd_p
    from h264_tpu_torch.encoder.rd import _lam_cost, _mv_bits

    NR, _, Hp, Wp = banks.shape
    H, W = cur_y.shape
    n_my, n_mx = H // 16, W // 16
    dev, E, RC, DCO = banks.device, rd_p.E, rd_p.RC, rd_p.DCO
    iy = rd_p._clampi(torch.arange(Hp + 2 * E, device=dev) - E, Hp - 1)
    ix = rd_p._clampi(torch.arange(Wp + 2 * E, device=dev) - E, Wp - 1)
    G = banks[:, 0].index_select(1, iy).index_select(2, ix)
    if wp is not None:
        G = rd_p._wp_affine(G, wp[0][:, None, None], wp[1][:, None, None])
    ref_l = G.reshape(NR, G.shape[1] // 4, 4, G.shape[2] // 4, 4).sum(
        (2, 4), dtype=torch.int32)
    cur_l = cur_y.reshape(H // 4, 4, W // 4, 4).sum((1, 3), dtype=torch.int32)
    curmb = cur_l.reshape(n_my, 4, n_mx, 4).permute(0, 2, 1, 3)
    a = torch.arange(DCO + 3, device=dev)
    rows = (4 * torch.arange(n_my, device=dev) - RC + rd_p.PADW // 4)[:, None] + a
    cols = (4 * torch.arange(n_mx, device=dev) - RC + rd_p.PADW // 4)[:, None] + a
    win = ref_l[:, rows[:, None, :, None], cols[None, :, None, :]]
    cand = win.unfold(3, 4, 1).unfold(4, 4, 1)  # (NR, my, mx, DCO, DCO, 4, 4)
    sad = torch.cdist(
        curmb.reshape(1, -1, 1, 16).expand(NR, -1, -1, -1).reshape(
            -1, 1, 16).float(),
        cand.reshape(-1, DCO * DCO, 16).float(), p=1)[:, 0]
    coff = torch.arange(-RC, RC + 1, dtype=torch.int32, device=dev) * 16
    cbits = (_mv_bits(coff)[None, :] + _mv_bits(coff)[:, None]).reshape(-1)
    k = (sad.round().int() + _lam_cost(lam_me, cbits)).argmin(-1).to(
        torch.int32).reshape(NR, n_my, n_mx)
    return ((k % DCO) - RC) * 4, ((k // DCO) - RC) * 4


# the library route of each K3 entry (library_ms), held equal to the kernel
K3_LIB = {"coarse_search": coarse_search_lib, "ssd_grid8": ssd_grid8_lib,
          "sub8_search": sub8_search_lib}


def digest(x) -> str:
    """sha256 of an integer array with its shape (or of bytes), as
    tests/torch_records.py records the reference's outputs."""
    import hashlib

    if isinstance(x, bytes):
        return hashlib.sha256(x).hexdigest()
    a = np.asarray(x)
    return hashlib.sha256(str(a.shape).encode()
                          + a.astype(np.int64).tobytes()).hexdigest()


def rows_bank_work(Hs: int, Hcs: int, W: int):
    """(bytes, int32 ops) of one row-slab reference entry (K2
    ``ref_bank_rows``): slabs read once, bank and cpad written once; b/h
    6 taps, j 6x6 separable taps, per bank sample."""
    Wp, Wcp = W + 64, W // 2 + 64
    nbytes = (Hs * W + Hcs * W + 4 * Hs * Wp + 2 * Hcs * Wcp) * 4
    return nbytes, Hs * Wp * OPS_BANK


def gop_run(tag, size, mesh, S, seed, names, hold_bank):
    """GOPs of S P pictures (after each GOP's I picture, coded by the
    port's RD encoder in tile rows, one reference, CAVLC) through the
    sharded encoder on `mesh`, held against the single-device tile-row
    chain on the card (host buffers, recons, slice bytes), each GOP's
    stream decoded on the card to the sharded recons, and K2's
    row-slab entry against its plain version on every slab built
    (``hold_bank``); fails unless every kernel of `names` launched in the
    ranks.  On a CPU mesh (a rehearsal) all of it runs on the CPU."""
    import torch

    from h264_tpu_torch.bitstream import write_annexb
    from h264_tpu_torch.decoder.decoder import H264Decoder
    from h264_tpu_torch.encoder import rd, rd_rows
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.ops.exact import chroma_qp
    from h264_tpu_torch.parallel import dryrun as DRY
    from h264_tpu_torch.parallel.sharded import rd_gop_rows_sharded
    from h264_tpu_torch.tools.synthseq import moving_frames

    dev = torch.device("cpu" if mesh.device == "cpu" else "cuda")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    lam_sh, qpc_sh = lam_fx(QP_SH), chroma_qp(QP_SH, 0)
    W, H = size
    F, G = mesh.n_frame, mesh.n_row
    fr = moving_frames(F * (S + 1), W, H, seed=seed)
    cfg = EncoderConfig(width=W, height=H, qp=QP_SH, fast=True, rd=True,
                        row_slices=G, num_ref_frames=1, entropy="cavlc")
    heads, idrs, irec = None, [], []
    for f in range(F):
        enc = H264Encoder(cfg, device=dev)
        heads = enc.headers()
        idrs.append(next(enc.encode_stream([fr[f * (S + 1)]], depth=1)))
        irec.append(enc.all_recons[0][1])
    pf = [[fr[f * (S + 1) + 1 + s] for s in range(S)] for f in range(F)]
    cur = [np.stack([np.stack([p[i] for p in g]) for g in pf])
           for i in range(3)]  # (F, S, h, w)
    init = [np.stack([np.asarray(getattr(x, c), np.int32) for x in irec])
            for c in "YUV"]

    def rows(a):
        return a.reshape(*a.shape[:-2], G, a.shape[-2] // G, a.shape[-1])

    step = rd_gop_rows_sharded(mesh, S=S, H=H, W=W, R=R_SH, qp=QP_SH,
                               qp_c=qpc_sh, lam=lam_sh, keep_slabs=True)
    sync()
    t_call = time.time()
    host_outs, recons = step(*map(rows, (*cur, *init)))
    wall = time.time() - t_call
    launches_sh = {n: sum(i["launches"][n] for i in step.ranks)
                   for n in names}
    for info in step.ranks:
        # one slab entry and one intra commit scan per picture of its row
        for n in ("ref_bank_rows", "intra_commit"):
            if n in names and info["launches"][n] != S * F // mesh.n_frame:
                fail(f"{tag}: rank {info['rank']} launched {n} "
                     f"{info['launches'][n]} times")
        if info["foreign_modules"]:
            fail(f"{tag}: rank {info['rank']} holds "
                 f"{info['foreign_modules']}")
    for n in names:
        if launches_sh[n] == 0:
            fail(f"kernel {n} was not launched on the {tag} path")
    chain_ms = []
    for f in range(F):
        bank, cpad = rd.ref_entry_from_planes(*(x[f] for x in init),
                                              device=dev)
        dec = list(H264Decoder(device=dev).decode_stream(
            write_annexb(heads + idrs[f] + [
                n for s in range(S) for n in DRY._entropy_nals(
                    host_outs[f, s], W, H, G, QP_SH, s)])))
        if len(dec) != S + 1:
            fail(f"{tag} GOP {f}: {len(dec)} pictures decoded")
        for s in range(S):
            sync()
            h0 = time.perf_counter()
            ho, rec, (bank, cpad, _) = rd_rows.rd_p_rows_pipeline(
                *(x[f, s] for x in cur), bank[None], cpad[None], H=H,
                W=W, R=R_SH, qp=QP_SH, qp_c=qpc_sh, lam=lam_sh,
                lam_me=lam_sh, G=G, device=dev)
            ho = ho.cpu().numpy()
            chain_ms.append((time.perf_counter() - h0) * 1e3)
            if not np.array_equal(ho, host_outs[f, s]):
                fail(f"{tag} GOP {f} picture {s}: host_out differs from "
                     "the single-device chain")
            for i, x in enumerate(rec):
                if not np.array_equal(recons[i][f, s].reshape(x.shape),
                                      x.cpu().numpy()):
                    fail(f"{tag} GOP {f} picture {s}: recon {'YUV'[i]} "
                         "differs from the single-device chain")
            if [n.rbsp for n in DRY._entropy_nals(ho, W, H, G, QP_SH, s)
                ] != [n.rbsp for n in DRY._entropy_nals(
                    host_outs[f, s], W, H, G, QP_SH, s)]:
                fail(f"{tag} GOP {f} picture {s}: slices differ")
            for i, c in enumerate("YUV"):
                if not np.array_equal(getattr(dec[s + 1].planes, c),
                                      recons[i][f, s].reshape(
                                          getattr(dec[s + 1].planes,
                                                  c).shape)):
                    fail(f"{tag} GOP {f} picture {s}: the decode "
                         f"differs from the sharded recon ({c})")
        if not all(np.array_equal(getattr(dec[0].planes, c),
                                  getattr(irec[f], c)) for c in "YUV"):
            fail(f"{tag} GOP {f}: the I picture's decode differs")
    for key, ext in step.slabs.items():
        hold_bank(ext, f"{tag} slab {key}")
    per_rank = [rank_times(info) for info in step.ranks]
    out = {"mesh": mesh.shape, "backend": mesh.backend, "size": size,
           "S": S, "ranks": per_rank, "launches": launches_sh,
           "chain_ms_per_picture": float(np.median(chain_ms)),
           "wall_s": wall, "slabs_held": len(step.slabs),
           **start_exit(step.ranks, t_call, t_call + wall)}
    print(f"sharded {tag} {W}x{H} mesh {mesh.shape} {mesh.backend} "
          f"({F} GOP(s) x {S} P; wall {wall:.1f} s, of it the ranks' start "
          f"{out['start_s']:.1f} s and their exit and gather "
          f"{out['exit_s']:.1f} s): host_outs, recons and slices equal to "
          "the single-device "
          f"chain, the decode equal to the recons, {len(step.slabs)} slabs "
          f"held; launches {launches_sh}")
    for r in per_rank:
        print_rank(r)
    print(f"  single-device chain on {dev.type}: "
          f"{out['chain_ms_per_picture']:.2f} ms per picture ({G} rows; "
          f"median of {len(chain_ms)})")
    return out


def start_exit(ranks, t_call: float, t_done: float) -> dict:
    """The ranks' start (from the call to the last rank beginning its
    work: processes, imports, rendezvous) and exit (from the last rank
    ending its work to the call's return: exit and gather), in s."""
    return {"start_s": max(i["t_enter"] for i in ranks) - t_call,
            "exit_s": t_done - max(i["t_exit"] for i in ranks)}


def rank_times(info) -> dict:
    """A rank's times: its first step, and the median of its later ones,
    of the halo exchange within them (which waits for the neighbours'
    pictures too) and of its ref_bank_rows launch (host clock,
    synchronized), in ms."""
    later = slice(1, None) if len(info["step_ms"]) > 1 else slice(None)
    return {**{k: info[k] for k in ("rank", "frame", "row", "device")},
            "first_step_ms": info["step_ms"][0],
            **{k: float(np.median(info[k][later]))
               for k in ("step_ms", "exchange_ms", "bank_ms")},
            "n": len(info["step_ms"])}


def print_rank(r) -> None:
    print(f"  rank {r['rank']} (frame {r['frame']}, row {r['row']}, "
          f"{r['device']}): first step {r['first_step_ms']:.2f} ms; median "
          f"of the next {r['n'] - 1}: step {r['step_ms']:.2f} ms, exchange "
          f"{r['exchange_ms']:.3f} ms, ref_bank_rows {r['bank_ms']:.3f} ms "
          "(host clock, synchronized)")


def lane_rates(torch):
    """The card's INT32 and FP32 rates, lane-instructions/s: 64 INT32 and
    128 FP32 lanes per SM (Hopper) x SMs x the maximum SM clock
    nvidia-smi reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_lane = sms * float(mhz) * 1e6
    return 64 * per_lane, 128 * per_lane


def work_sum(works):
    """(bytes, int32 ops, float32 ops) of several calls."""
    tot = [0, 0, 0]
    for w in works:
        for i, x in enumerate(w):
            tot[i] += x
    return tuple(tot)


def bound_ms(nbytes: int, ops: int, fops: int = 0):
    """The least time of a function that moves `nbytes` and does `ops`
    integer and `fops` float32 operations (the counting rule at
    HBM_BPS)."""
    tb = nbytes / HBM_BPS * 1e3
    to = max(ops / INT32_OPS, (ops + fops) / FP32_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global INT32_OPS, FP32_OPS
    INT32_OPS, FP32_OPS = lane_rates(torch)
    print(f"operation rates: INT32 {INT32_OPS / 1e12:.2f} T/s, FP32 "
          f"{FP32_OPS / 1e12:.2f} T/s (64 / 128 lanes x SMs x clocks.max.sm)")
    from h264_tpu_torch import device as D
    from h264_tpu_torch import native
    from h264_tpu_torch.bitstream import iter_annexb_nalus, write_annexb
    from h264_tpu_torch.decoder import device as DEV
    from h264_tpu_torch.decoder.decoder import H264Decoder
    from h264_tpu_torch.encoder import fast, rd, rd_b, rd_p, rd_rows
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.encoder.lossaware import propagate_drift_plain
    from h264_tpu_torch.kernels import decode_inter as K8
    from h264_tpu_torch.kernels import intra_commit as K1
    from h264_tpu_torch.kernels import p16 as P16
    from h264_tpu_torch.kernels import propagate_drift as K11
    from h264_tpu_torch.kernels import ref_bank as K2
    from h264_tpu_torch.kernels import sad_grid as K10
    from h264_tpu_torch.kernels import t8 as K9
    from h264_tpu_torch.ops.exact import chroma_qp
    from h264_tpu_torch.syntax.parsets import parse_sps
    from h264_tpu_torch.tools.decode_cases import NS as DEC_NS
    from h264_tpu_torch.tools.decode_cases import built_cases as dec_cases
    from h264_tpu_torch.tools.decode_cases import clip_sides
    from h264_tpu_torch.tools.drift_cases import CASES as DRIFT_CASES
    from h264_tpu_torch.tools.drift_cases import built_case as drift_case
    from h264_tpu_torch.tools.drift_cases import clipped_sides
    from h264_tpu_torch.tools.drift_cases import ordered_route
    from h264_tpu_torch.syntax.slice_header import parse_slice_header
    from h264_tpu_torch.tools.profile_decode import mean_by_type, timed_decode
    from h264_tpu_torch.tools.p16_cases import CASES as P16_CASES
    from h264_tpu_torch.tools.p16_cases import built_case as p16_case
    from h264_tpu_torch.tools.p16_cases import moved_vectors, reached_sides
    from h264_tpu_torch.parallel import dryrun as DRY
    from h264_tpu_torch.parallel.mesh import Mesh
    from h264_tpu_torch.parallel.sharded import rd_gop_rows_sharded
    from h264_tpu_torch.tools.slab_cases import CONTENTS as SLAB_CONTENTS
    from h264_tpu_torch.tools.slab_cases import built_slab
    from h264_tpu_torch.tools.rows_cases import edge_motion
    from h264_tpu_torch.tools.strengths_cases import branches as \
        strengths_branches
    from h264_tpu_torch.tools.strengths_cases import strengths_inputs
    from h264_tpu_torch.tools.synthseq import moving_frames, synthetic_frames
    from h264_tpu_torch.tools.t8_cases import MB_COUNTS as T8_MB_COUNTS
    from h264_tpu_torch.tools.t8_cases import built_cases as t8_cases
    from h264_tpu_torch.tools.t8_cases import sized_case as t8_sized_case
    from h264_tpu_torch.tools import time_kernels as TK

    dev = torch.device("cuda")
    report: dict = {"device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    D.build_cuda(["intra_commit", "ref_bank", "search_grid", "qpel",
                  "inter_tq", "deblock", "b_direct", "decode_inter", "t8",
                  "sad_grid", "propagate_drift", "p16_search", "p16_refine"])
    t_nvcc = time.perf_counter() - t0
    for stem in ("cabac_engine", "cabac_writer", "cavlc_writer", "deblock",
                 "cabac_reader", "cavlc_reader", "recon"):
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

    # back to back (CUDA events) and on the device (each call queued behind
    # a spin of the card)
    cuda_ms, device_ms = TK.events_ms, TK.spin_ms

    def k1_state(W, H, is_intra, seed=SEED):
        """The intra commit scan's state of a synthetic W x H picture at QP
        28 in its P/B form: seeded inter results and the MBs `is_intra`
        ((n_mb,) bool) intra."""
        n_mb = (H // 16) * (W // 16)
        rng = np.random.RandomState(seed)

        def t(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)

        Y, U, V = (t(p) for p in synthetic_frames(1, W, H, seed=seed)[0])
        return rd._scan_start(
            Y, U, V, t(rng.randint(0, 256, (n_mb, 16, 16))),
            t(rng.randint(0, 256, (n_mb, 2, 8, 8))),
            torch.as_tensor(is_intra, device=dev),
            t(rng.randint(-3, 4, (n_mb, 4, 4, 4, 4))),
            t(rng.randint(-2, 3, (n_mb, 2, 2, 2, 4, 4))),
            t(rng.randint(-5, 6, (n_mb, 2, 2, 2))), H, W, 28,
            chroma_qp(28, 0), lam_fx(28))

    def k1_launch(W, H):
        """One K1 launch on an all-intra W x H state (each launch writes the
        same carry again)."""
        st = k1_state(W, H, np.ones((H // 16) * (W // 16), bool))
        return lambda: K1.intra_commit_scan(st)

    # ---- 2. K1/K2 vs plain versions ------------------------------------------
    err = {n: 0 for n in SOURCES}  # max |kernel - plain|
    mismatches = {n: 0 for n in SOURCES}  # differing elements
    timing = {}
    names = "ry ru rv lev lum_dc i16mode cip levc dcc i4flag ipm".split()
    # one MB's latency: K1 on a 16 x 16 picture (with the launch's own
    # cost), and the slope over a column of 68 MBs, each of which waits
    # for the one above
    k1_mb_ms = device_ms(k1_launch(16, 16), 20)
    k1_slope_ms = (device_ms(k1_launch(16, 1088), 10) - k1_mb_ms) / 67

    def hold_k1(st, what, reps: int = 1):
        """K1 on the scan state `st` `reps` times, each bit-equal to the
        plain scan on a copy of it; the launches each run made."""
        fields = ("Yp", "Up", "Vp", "ipm", "w_lev", "levc", "dcc", "lum_dc",
                  "i16mode", "cip", "i4flag")
        start = {f: getattr(st, f).clone() for f in fields}
        rd._intra_scan(st)
        want = {f: getattr(st, f).clone() for f in fields}
        for _ in range(reps):
            for f in fields:
                getattr(st, f).copy_(start[f])
            before = K1.intra_commit_scan.launches
            K1.intra_commit_scan(st)
            torch.cuda.synchronize()
            if K1.intra_commit_scan.launches != before + 1:
                fail(f"intra_commit {what}: not one launch")
            for f in fields:
                d = (getattr(st, f).long() - want[f].long()).abs()
                e = int(d.max())
                err["intra_commit"] = max(err["intra_commit"], e)
                mismatches["intra_commit"] += int((d > 0).sum())
                if e:
                    fail(f"intra_commit {what}: {f} differs "
                         f"({int((d > 0).sum())} elements)")

    # K1 on adversarial is_intra patterns at CIF: the blocks hand MBs over
    # through row counters, and no race checker runs on the card, so each
    # pattern is launched K1_REPS times
    n_my, n_mx = CIF[1] // 16, CIF[0] // 16
    rr, cc = np.meshgrid(np.arange(n_my), np.arange(n_mx), indexing="ij")
    patterns = {
        "all intra": np.ones((n_my, n_mx), bool),
        "all inter": np.zeros((n_my, n_mx), bool),
        "one MB": (rr == n_my // 2) & (cc == n_mx // 2),
        "one column": cc == n_mx // 2,
        "checkerboard": (rr + cc) % 2 == 0,
        "random 5 %": np.random.RandomState(SEED).rand(n_my, n_mx) < 0.05}
    for pname, pat in patterns.items():
        hold_k1(k1_state(*CIF, pat.reshape(-1)), f"CIF {pname}", K1_REPS)
    print(f"check intra_commit CIF on is_intra patterns ({', '.join(patterns)}"
          f"), {K1_REPS} launches each: equal to the plain scan (tolerance "
          f"0: bit-exact); one MB {k1_mb_ms:.4f} ms (16 x 16 picture), "
          f"{k1_slope_ms:.4f} ms a MB down a 16 x 1088 column")
    for (W, H) in (CIF, HD):
        Y, U, V = (torch.as_tensor(p, device=dev) for p in frames[(W, H)][0])
        for qp in (28, 51):
            qpc, lam = chroma_qp(qp, 0), lam_fx(qp)

            def scan(impl=None):
                return rd.rd_i_pipeline(Y, U, V, qp, qpc, lam, H, W,
                                        device=dev, impl=impl)

            ok = scan()
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            ref = scan(K1.intra_commit_scan_plain)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - h0) * 1e3  # host clock
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
                # the chain: T - 1 MBs one after the other, T the
                # reference's steps: the 16 x 16 picture (one MB with the
                # launch) and T - 2 more at the column's pace
                T = 2 * (H // 16) + W // 16 - 1
                tm = timing.setdefault((W, H), {})
                tm["intra_commit"] = {
                    "ms": cuda_ms(scan, 5),
                    "plain_ms": plain_ms,
                    "alone_ms": device_ms(k1_launch(W, H), 10),
                    "chain_ms": k1_mb_ms + (T - 2) * k1_slope_ms,
                    "launches_per_picture": 1,
                    "work": k1_work(H, W)}
                tm["ref_bank"] = {
                    "ms": cuda_ms(lambda: K2.ref_bank(*planes), 50),
                    "plain_ms": cuda_ms(lambda: K2.ref_bank_plain(*planes), 20),
                    "launches_per_picture": 1, "work": k2_work(H, W)}
                t1 = tm["intra_commit"]
                print(f"time {W}x{H}: intra_commit {t1['ms']:.4f} ms/picture "
                      f"(rd_i_pipeline, 1 launch; the launch alone "
                      f"{t1['alone_ms']:.4f} ms; chain {k1_mb_ms:.4f} + "
                      f"{T - 2} x {k1_slope_ms:.4f} = {t1['chain_ms']:.4f} "
                      "ms, the 16 x 16 picture and the column's slope), "
                      f"plain {plain_ms:.1f} ms (host clock); ref_bank "
                      f"{tm['ref_bank']['ms']:.4f} ms, plain "
                      f"{tm['ref_bank']['plain_ms']:.4f} ms")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 3. K3-K6 vs plain versions on the inputs of real P pictures ---------
    def p_cfg(size, qp=28, wp=True, **kw):
        return EncoderConfig(width=size[0], height=size[1], qp=qp, fast=True,
                             rd=True, entropy=kw.pop("entropy", "cabac"),
                             b_frames=0, num_ref_frames=5, search_range=28,
                             weighted_pred=wp, **kw)

    kern = rd_p.default_kernels()

    def hold_p(calls, what):
        """Each recorded P entry call through its kernel and its plain
        version; fail on any difference."""
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
                    fail(f"{name} {what}: output {i} differs "
                         f"({int((d > 0).sum())} elements)")

    def lib_ms(name, fk, mine):
        """The library route's time of K3 entry `name` over the calls
        `mine` (float32, TF32 off), each output held equal to the
        kernel's."""
        torch.backends.cudnn.allow_tf32 = False
        try:
            for a in mine:
                got, want = K3_LIB[name](*a), fk(*a)
                if isinstance(want, torch.Tensor):
                    got, want = (got,), (want,)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"{name}: the library route differs from the "
                         "kernel")
            return sum(cuda_ms(lambda a=a: K3_LIB[name](*a), 3)
                       for a in mine)
        finally:
            torch.backends.cudnn.allow_tf32 = True
            torch.cuda.empty_cache()

    def time_p(calls, names):
        """Kernel and plain time of each entry over `calls` (one
        picture's), its launches and its work (and the K3 entries' library
        route)."""
        tm = {}
        for name in names:
            mine = [a for n, a in calls if n == name]
            fk, fp = getattr(kern, name), getattr(rd_p.PLAIN, name)
            work = [p_work(name, a) for a in mine]
            tm[name] = {
                "ms": sum(cuda_ms(lambda a=a: fk(*a), 5) for a in mine),
                "plain_ms": sum(cuda_ms(lambda a=a: fp(*a), 1)
                                for a in mine),
                "launches_per_picture": len(mine),
                "work": work_sum(work)}
            if name in K3_LIB:
                tm[name]["library_ms"] = lib_ms(name, fk, mine)
        return tm

    # on the device, the second P and B picture of each size: K4 per shape
    # and per picture, K6, K1 on its scan state
    on_device = {}

    def picture_device(size, kind, calls, scan):
        """K4's, K6's and K1's device times on one recorded picture, and
        the bound of each K4 call."""
        t = TK.picture_times(calls, scan, reps=10)
        refine = [a for n, a in calls if n == "qpel_refine"]
        for x, a in zip(t["qpel_refine"]["shapes"], refine):
            x.append(bound_ms(*p_work("qpel_refine", a))[0])
        for name in TK.ONE_CALL:
            if name == "ref_bank" and name in t:
                t[name]["bound_ms"] = bound_ms(*k2_work(*size[::-1]))[0]
            for a in [a for n, a in calls if n == name]:
                t[name]["bound_ms"] = bound_ms(*entry_work(name, a))[0]
        on_device.setdefault(f"{size[0]}x{size[1]}", {})[kind] = t

    for size in (CIF, HD):
        for qp in (28, 51):
            for wp in (True, False):
                enc = H264Encoder(p_cfg(size, qp, wp), device="cuda")
                k_rec, calls = rd_p.recording(kern)
                scans = []
                enc._p_kernels = TK.scan_recording(k_rec, scans)
                list(enc.encode_stream(pframes[size][:3]))
                hold_p(calls, f"{size[0]}x{size[1]} QP {qp} WP {wp}")
                p_names = rd_p.entries_of(False)
                if {n for n, _ in calls} != set(p_names):
                    fail("a P entry was not called")
                print(f"check {size[0]}x{size[1]} QP {qp} WP {wp}: "
                      f"{len(calls)} calls of the {len(p_names)} P "
                      "entries equal to their plain versions (tolerance 0: "
                      "bit-exact)")
                if qp == 28 and wp:
                    # per P picture: the second P picture's calls
                    tm = timing.setdefault(size, {})
                    tm.update(time_p(calls[len(calls) // 2:], p_names))
                    picture_device(size, "P", calls[len(calls) // 2:],
                                   scans[-1])
                    print(f"time {size[0]}x{size[1]} per P picture (ms, "
                          "kernel / plain): " + ", ".join(
                              f"{n} {tm[n]['ms']:.3f}/{tm[n]['plain_ms']:.1f}"
                              for n in p_names))
                    print(f"time {size[0]}x{size[1]} per P picture, K3 "
                          "library route (conv2d float32 / cdist p=1, equal "
                          "to the kernel; ms): " + ", ".join(
                              f"{n} {tm[n]['library_ms']:.4f}"
                              for n in K3_LIB))

    def print_device(size, kind):
        """One picture's K3, K5 and K7, K4 (per shape, with each call's
        bound), K6 and K1 device times."""
        t = on_device[f"{size[0]}x{size[1]}"][kind]
        q, d = t["qpel_refine"], t["deblock"]
        print(f"time {size[0]}x{size[1]} per {kind} picture on the device "
              "(ms; back to back, median of 5 rounds; bound; an empty launch "
              "of each design's grid): " + ", ".join(
                  f"{n} {t[n]['device_ms']:.4f} ({t[n]['events_ms']:.4f}; "
                  f"{t[n]['bound_ms']:.5f}"
                  + "".join(f"; {g} {ms:.4f}" for g, ms in
                            t[n].get("empty_launch_ms", {}).items()) + ")"
                  for n in TK.ONE_CALL if n in t))
        print(f"time {size[0]}x{size[1]} per {kind} picture on the device "
              f"(ms; back to back, median of {len(q['events_rounds_ms'])} "
              f"rounds): qpel_refine {q['picture_device_ms']:.4f} "
              f"({q['events_ms']:.4f}; host clock {q['host_ms']:.4f}), "
              "per shape (h x w, units: device ms, "
              "bound ms) " + ", ".join(
                  f"{h}x{w} ({n}): {ms:.4f}, {bd:.5f}"
                  for h, w, n, ms, bd in q["shapes"])
              + f"; deblock {d['device_ms']:.4f} ({d['events_ms']:.4f}); "
              f"intra_commit {t['intra_commit']['device_ms']:.4f} "
              f"({t['intra_commit']['events_ms']:.4f}; "
              f"{t['intra_commit']['intra_mbs']} intra MBs)")

    # K6's chain on built inputs (a 16 x 16 picture, the step along a row
    # and down a column; CIF and 720p pictures beside their chain) and its
    # device operations: one kernel per call and no copy, one kernel in an
    # I + P encode
    for size in (CIF, HD):
        print_device(size, "P")
    k6_chain = TK.deblock_chain()
    k6_prof = TK.deblock_profile()
    k6_call, k6_enc = k6_prof["call"], k6_prof["ip_encode"]
    if (list(k6_call["kernels"].values()) != [1] or k6_call["memcpy"]
            or k6_enc["deblock_calls"] != 1
            or k6_enc["deblock_kernels"] != 1):
        fail(f"deblock: not one kernel launch per call ({k6_prof})")
    print(f"time deblock chain on built inputs (device ms): 16 x 16 picture "
          f"{k6_chain['mb_ms']:.4f}, an MB along a row "
          f"{k6_chain['row_step_ms']:.5f}, down a column "
          f"{k6_chain['column_step_ms']:.5f}; " + ", ".join(
              f"{k} {v['built_ms']:.4f} against its chain {v['chain_ms']:.4f}"
              for k, v in k6_chain["pictures"].items()))
    print(f"check deblock launches (torch.profiler): one CIF call "
          f"{k6_call['kernels']}, {k6_call['memset']} memset, "
          f"{k6_call['memcpy']} copies; an I + P encode "
          f"{k6_enc['deblock_kernels']} deblock kernel for "
          f"{k6_enc['deblock_calls']} call")
    report["deblock_profile"] = k6_prof
    report["deblock_chain"] = k6_chain
    report["on_device"] = on_device

    # the tile-row path (rd_rows): its P entries (no coarse search) on the
    # slab inputs of 1 I + 2 P pictures in ROWS rows, and on built inputs
    # whose motion reaches every slab edge at R 28 (tools/rows_cases.py)
    rows_names = tuple(n for n in rd_p.entries_of(False)
                       if n != "coarse_search")
    timing_rows = {}
    for size in (CIF, HD):
        enc = H264Encoder(p_cfg(size, wp=False, row_slices=ROWS),
                          device="cuda")
        enc._p_kernels, calls = rd_p.recording(kern)
        list(enc.encode_stream(pframes[size][:3]))
        hold_p(calls, f"rows {size[0]}x{size[1]}")
        if {n for n, _ in calls} != set(rows_names):
            fail("a P entry of the tile-row path was not called")
        timing_rows[size] = time_p(calls[len(calls) // 2:], rows_names)
        tm = timing_rows[size]
        print(f"check rows {size[0]}x{size[1]} ({ROWS} rows): {len(calls)} "
              f"calls of the {len(rows_names)} P entries of the tile-row "
              "path equal to their plain versions (tolerance 0: bit-exact)")
        print(f"time rows {size[0]}x{size[1]} per P picture (ms, kernel / "
              "plain, launches): " + ", ".join(
                  f"{n} {tm[n]['ms']:.3f}/{tm[n]['plain_ms']:.1f}/"
                  f"{tm[n]['launches_per_picture']}" for n in rows_names))
    ref_e, curs_e = edge_motion(CIF[1], CIF[0], 28)
    bank_e, cpad_e = K2.ref_bank(*(torch.as_tensor(p, dtype=torch.int32,
                                                   device=dev) for p in ref_e))
    n_edge = 0
    for cur in curs_e:
        k_rec, calls = rd_p.recording(kern)
        rd_rows.rd_p_rows_pipeline(
            *cur, bank_e[None], cpad_e[None], H=CIF[1], W=CIF[0], R=28,
            qp=28, qp_c=chroma_qp(28, 0), lam=lam_fx(28), lam_me=lam_fx(28),
            G=ROWS, device=dev, k=k_rec)
        hold_p(calls, "rows built R 28 slab-edge motion")
        mvs = [int(a[4].abs().max()) for n, a in calls if n == "qpel_refine"]
        if max(mvs) != 28:
            fail(f"rows built inputs: the search reached {max(mvs)}, not 28")
        n_edge += len(calls)
    print(f"check rows built: {n_edge} calls on CIF content moved 28 pels "
          "along each diagonal (mvs at +-28 up to the slab edges) equal to "
          "their plain versions (tolerance 0: bit-exact)")

    # K9 on the real inputs of P pictures with the 8x8 transform (the other
    # entries of those pictures are the shapes held above) and on built ones
    def hold_k9(cargs, what):
        got = K9.t8_decide(*cargs)
        want = K9.t8_decide_plain(*cargs)
        for i, (g, w) in enumerate(zip(got, want)):
            d = (g.long() - w.long()).abs()
            e = int(d.max()) if d.numel() else 0
            err["t8_decide"] = max(err["t8_decide"], e)
            mismatches["t8_decide"] += int((d > 0).sum())
            if e or g.dtype != w.dtype:
                fail(f"t8_decide {what}: output {i} differs "
                     f"({int((d > 0).sum())} elements)")
        return got

    for size in (CIF, HD):
        for qp in (28, 51):
            enc = H264Encoder(p_cfg(size, qp, True, transform8x8=True),
                              device="cuda")
            enc._p_kernels, calls = rd_p.recording(kern)
            list(enc.encode_stream(pframes[size][:3]))
            torch.cuda.synchronize()
            k9 = [a for n, a in calls if n == "t8_decide"]
            if len(k9) != 2 or {n for n, _ in calls} != set(
                    rd_p.entries_of(True)):
                fail("a P entry of the T8 pictures was not called")
            n8 = sum(int(hold_k9(a, f"{size[0]}x{size[1]} QP {qp}")[0].sum())
                     for a in k9)
            print(f"check {size[0]}x{size[1]} QP {qp} T8: t8_decide on the "
                  f"{len(k9)} recorded P pictures equal to its plain version "
                  f"(tolerance 0: bit-exact); {n8} 8x8-transform MBs")
            if qp == 28:
                tm = timing.setdefault(size, {})
                tm["t8_decide"] = {
                    "ms": cuda_ms(lambda a=k9[1]: K9.t8_decide(*a), 20),
                    "device_ms": device_ms(
                        lambda a=k9[1]: K9.t8_decide(*a), 10),
                    "plain_ms": cuda_ms(
                        lambda a=k9[1]: K9.t8_decide_plain(*a), 5),
                    "launches_per_picture": 1,
                    "work": p_work("t8_decide", k9[1])}
                print(f"time {size[0]}x{size[1]} t8_decide per P picture: "
                      f"{tm['t8_decide']['ms']:.4f} ms (events, mean of "
                      f"20), device {tm['t8_decide']['device_ms']:.4f} ms "
                      "(queued behind a spin, mean of 10), plain "
                      f"{tm['t8_decide']['plain_ms']:.3f} ms, bound "
                      f"{bound_ms(*tm['t8_decide']['work'])[0]:.5f} ms")
    n_mb_cif = (CIF[0] // 16) * (CIF[1] // 16)
    for name, arrs, qp, lam in t8_cases(n_mb_cif, SEED):
        got = hold_k9(tuple(torch.as_tensor(a, device=dev) for a in arrs)
                      + (qp, lam), f"built {name}")
        if name == "ties" and got[0].any():
            fail("t8_decide: a tie chose the 8x8 transform")
        if name == "qp0_bound" and int(got[1].abs().max()) != 3264:
            fail("t8_decide: the QP 0 bound case misses level 3264")
    for n_mb in T8_MB_COUNTS:  # blocks of 1 to 4 MBs, the last one short
        for qp in (0, 28, 51):
            name, arrs, qp, lam = t8_sized_case(n_mb, SEED, qp)
            got = hold_k9(tuple(torch.as_tensor(a, device=dev)
                                for a in arrs) + (qp, lam), f"built {name}")
            if n_mb >= 397 and (got[0].all() or not got[0].any()):
                fail(f"t8_decide built {name}: one transform won everywhere")
    print("check t8_decide built inputs (QP 0 +-255 residuals at the level "
          "bound 3264, ties, every winner class at QP 28 and 51; "
          f"{', '.join(map(str, T8_MB_COUNTS))} MBs at QP 0, 28 and 51): "
          "equal to the plain version (tolerance 0: bit-exact)")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 4. the B entries vs plain versions on the inputs of B pictures ------
    def b_cfg(size, qp=28, hier=False, wp=True, **kw):
        return EncoderConfig(width=size[0], height=size[1], qp=qp, fast=True,
                             rd=True, entropy=kw.pop("entropy", "cabac"),
                             b_frames=3 if hier else 1, b_hierarchy=hier,
                             num_ref_frames=5, search_range=28,
                             weighted_pred=wp, **kw)

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
        strengths on built B inputs of the same shape that take every
        branch of its pairing rule, and on built P inputs (with the 8x8
        transform's fields) that take every branch of its one-list
        rule."""
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
        n_my, n_mx = first["strengths"][:2]
        bs_args = strengths_inputs(n_my, n_mx, seed, dev)
        bs_p = strengths_inputs(n_my, n_mx, seed + 1, dev, lists=1, t8=True)
        branches = strengths_branches(bs_args)
        if min([*branches.values(),
                *strengths_branches(bs_p).values()]) == 0:
            fail(f"strengths cases: a branch is not taken ({branches})")
        return [("b_direct", (b0, b1, torch.zeros_like(ci), cr, far(cmx),
                              far(cmy), dsf, eq)),
                ("mc_luma_win", (banks, ref, far(mvx), far_y, y0, x0, h, w)),
                ("mc_chroma_b", (c0, c1, idx0, far(m0x), far_c, far(m1x),
                                 far(m1y), u0, u1)),
                ("strengths", bs_args), ("strengths", bs_p)], n_out, branches

    timing_b = {}
    for size in (CIF, HD):
        for qp in (28, 49):  # the B pictures at QP 30 and 51
            enc = H264Encoder(b_cfg(size, qp), device="cuda")
            k_rec, calls = rd_b.recording(bkern)
            scans = []
            enc._b_kernels = TK.scan_recording(k_rec, scans)
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
                  f"and {n_out[1]} chroma windows moved) and strengths on "
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
                        "work": work_sum(wk)}
                    if name == "ssd_grid8":
                        tm[name]["library_ms"] = lib_ms(name, fk, mine)
                picture_device(size, "B", last, scans[-1])
                print_device(size, "B")
                print(f"time {size[0]}x{size[1]} per B picture (ms, kernel / "
                      "plain): " + ", ".join(
                          f"{n} {tm[n]['ms']:.3f}/{tm[n]['plain_ms']:.1f}"
                          for n in rd_b.B_ENTRIES)
                      + f"; ssd_grid8 library route "
                      f"{tm['ssd_grid8']['library_ms']:.4f}")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 5. the paths through the kernels ------------------------------------
    counters = {"intra_commit": K1.intra_commit_scan, "ref_bank": K2.ref_bank,
                **{n: getattr(kern, n) for n in rd_p.P_ENTRIES},
                **{n: getattr(bkern, n) for n in rd_b.B_OWN},
                "sad_grid_16x16": K10.sad_grid_16x16,
                "propagate_drift": K11.propagate_drift,
                "p16_search": P16.p16_search, "p16_refine": P16.p16_refine}
    k10_calls = []  # (path, (cur, ref_padded, R)) of every host-path K10 call
    k11_calls = []  # (path, size, args) of every step of the ER paths
    # (path, size, entry, args) of every call of the legacy entries
    legacy_calls = []

    class HostEncoder(H264Encoder):
        """The encoder, with every K10 call's inputs recorded."""

        @staticmethod
        def _sad_grid(cur, ref_p, R):
            k10_calls.append((host_tag, (cur, ref_p, R)))
            return K10.sad_grid_16x16(cur, ref_p, R)

    class DriftEncoder(H264Encoder):
        """The encoder, with every K11 call's inputs recorded."""

        @staticmethod
        def _propagate_drift(*a):
            k11_calls.append((host_tag, tuple(a[0].shape[1:]), a))
            return K11.propagate_drift(*a)

    class LegacyEncoder(H264Encoder):
        """The encoder, with every call of the legacy P entries recorded
        (``calls``) and each legacy P picture's P_Skip share kept
        (``skips``)."""

        def __init__(self, cfg, device=None):
            super().__init__(cfg, device)
            self._legacy_kernels, self.calls = fast.recording(
                fast.default_kernels())
            self.skips = []

        def _fill_p_state(self, st, *a):
            super()._fill_p_state(st, *a)
            self.skips.append(float(st.skip_flag.mean()))

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {n: fn.launches for n, fn in counters.items()}

    def slice_qps(enc, out):
        """The QP of each slice NAL of a picture (tile rows: one per
        row)."""
        return [26 + enc.pps.pic_init_qp_minus26 + parse_slice_header(
            n.rbsp, {0: enc.sps}, {0: enc.pps}, n.nal_ref_idc,
            n.nal_unit_type == 5)[0].slice_qp_delta
            for n in out if n.nal_unit_type in (1, 5)]

    def encode(cls, cfg, fr, depth=1):
        """Encode `fr` picture by picture (pipeline depth 1, so each step
        dispatches and finishes one picture, timed alone; under rate
        control an anchor and its B picture are dispatched together, so
        the anchor's step carries the B picture's dispatch; at a larger
        depth the step that finishes a group carries its dispatches and
        its one fetch); the encoder's picture log gives each picture's
        type and host_out, the launch counters each step's launches."""
        enc = cls(cfg, device="cuda")
        enc.picture_log = log = []
        nalus = enc.headers()
        pics = []
        gen = enc.encode_stream(fr, depth=depth)
        for i in range(len(fr)):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            before = read()
            h0 = time.perf_counter()
            a.record()
            out = next(gen)
            b.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - h0) * 1e3
            step = {n: v - before[n] for n, v in read().items() if v != before[n]}
            nalus.extend(out)
            if len(log) < i + 1 or (depth == 1 and len(log) != i + 1):
                fail(f"step {i} finished {len(log) - i} pictures")
            kind, poc, row = log[i]
            rec = enc.all_recons[i][1]
            src = fr[poc // 2 if cfg.idr_period == 0 else i][0]
            mse = ((rec.Y - src.astype(np.float64)) ** 2).mean()
            pics.append({"type": kind, "poc": poc,
                         "event_ms": a.elapsed_time(b), "host_ms": host_ms,
                         "psnr_y": 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)),
                         "bytes": sum(len(n.rbsp) for n in out),
                         "qps": slice_qps(enc, out), "launches": step,
                         "row": row if cfg.rd else None})
        return enc, write_annexb(nalus), pics

    def intra_cfg(size, entropy="cabac"):
        return EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                             rd=True, entropy=entropy, idr_period=1)

    def host_cfg(size, **kw):
        return EncoderConfig(width=size[0], height=size[1], qp=28, **kw)

    def legacy_cfg(size, entropy="cavlc", qp=28):
        return EncoderConfig(width=size[0], height=size[1], qp=qp, fast=True,
                             rd=False, entropy=entropy, search_range=28)

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "streams", "qmat_sps.264"),
              "rb") as fh:  # the in-repo lencod stream's scaling lists
        qsps = next(parse_sps(n.rbsp) for n in iter_annexb_nalus(fh.read())
                    if n.nal_unit_type == 7)
    qmat = (np.array(qsps.scaling_lists_4x4, np.int32).reshape(6, 4, 4),
            np.array(qsps.scaling_lists_8x8, np.int32).reshape(2, 8, 8))
    qframes = moving_frames(3, *QCIF, seed=SEED + 3)

    i_names = ("intra_commit", "ref_bank")
    p_names = (*i_names, *rd_p.entries_of(False))
    t8_names = (*i_names, *rd_p.entries_of(True))
    rd_names = tuple(n for n in counters
                     if n not in ("sad_grid_16x16", "propagate_drift",
                                  "p16_search", "p16_refine"))
    b_names = tuple(n for n in rd_names if n != "t8_decide")
    er_names = (*b_names, "propagate_drift")
    h_names = ("intra_commit", "sad_grid_16x16")  # the device I picture
    r_names = (*i_names, *rows_names)
    paths = {
        "all-intra": ({s: (intra_cfg(s), frames[s]) for s in N_INTRA},
                      i_names),
        "IPPP": ({s: (p_cfg(s), pframes[s]) for s in N_IPPP}, p_names),
        "IPB": ({s: (b_cfg(s), bframes[s]) for s in N_IPB}, b_names),
        "IPB-hierarchy": ({CIF: (b_cfg(CIF, hier=True), hframes)}, b_names),
        # this slice: the bench configuration in the High profile, and
        # CAVLC (Baseline IPPP, Main IPB)
        "IPB-T8": ({s: (b_cfg(s, transform8x8=True), bframes[s])
                    for s in N_IPB}, rd_names),
        "all-intra-CAVLC": ({CIF: (intra_cfg(CIF, "cavlc"), frames[CIF])},
                            i_names),
        "IPPP-CAVLC": ({CIF: (p_cfg(CIF, wp=False, entropy="cavlc"),
                              pframes[CIF])}, p_names),
        "IPB-CAVLC": ({CIF: (b_cfg(CIF, entropy="cavlc"), bframes[CIF])},
                      b_names),
        "IPPP-T8-CAVLC": ({CIF: (p_cfg(CIF, entropy="cavlc",
                                       transform8x8=True), pframes[CIF])},
                          t8_names),
        # the host path (the reference's default configuration,
        # fast=False); multi-slice, FMO, data partitioning with redundant
        # slices, scaling matrices (I pictures on the host MB loop but for
        # the one-slice flat-scaling ones)
        "host-IPPP-CAVLC": ({CIF: (host_cfg(CIF), pframes[CIF][:N_HOST["P"]])},
                            h_names),
        "host-IPB-CABAC": ({CIF: (host_cfg(CIF, entropy="cabac", b_frames=1),
                                  bframes[CIF][:N_HOST["B"]])}, h_names),
        "host-slices": ({QCIF: (host_cfg(QCIF, slice_mode=1,
                                         slice_argument=33), qframes)},
                        ("sad_grid_16x16",)),
        "host-FMO2": ({QCIF: (host_cfg(QCIF, num_slice_groups=2,
                                       slice_group_map_type=2,
                                       slice_group_rects=((12, 58),)),
                              qframes)}, ("sad_grid_16x16",)),
        "host-DP-redundant": ({QCIF: (host_cfg(QCIF, partition_mode=1,
                                               redundant_pics=True),
                                      qframes)}, h_names),
        "host-qmat": ({QCIF: (host_cfg(QCIF, scaling_lists=qmat), qframes)},
                      ("sad_grid_16x16",)),
        # this slice: tile rows (rd_rows) and the rate control: the IPPP
        # configuration in ROWS rows (no WP); the reference's rate-control
        # test of tile rows at CIF (CAVLC, one reference, search range 8);
        # the bench configuration under rate control (no WP); the host path
        # under rate control
        "rows": ({s: (p_cfg(s, wp=False, row_slices=ROWS), pframes[s])
                  for s in N_IPPP}, r_names),
        "rows-RC-CAVLC": ({CIF: (EncoderConfig(
            width=CIF[0], height=CIF[1], fast=True, rd=True,
            entropy="cavlc", num_ref_frames=1, search_range=8,
            row_slices=ROWS, rc_bitrate=RC_ROWS), pframes[CIF])}, r_names),
        "IPB-RC": ({CIF: (b_cfg(CIF, wp=False, rc_bitrate=RC_IPB),
                          bframes[CIF])}, b_names),
        "host-RC": ({QCIF: (host_cfg(QCIF, rc_bitrate=RC_HOST), qframes)},
                    h_names),
        # this slice: error resilience, the bench configuration with
        # loss-aware RDO and intra refresh, and the same without B pictures
        "IPB-ER": ({s: (b_cfg(s, **ER), bframes[s]) for s in N_IPB},
                   er_names),
        "IPPP-ER": ({CIF: (p_cfg(CIF, **ER), pframes[CIF])},
                    (*p_names, "propagate_drift")),
        # this slice: the legacy P16x16 path (rd=False), CAVLC at the
        # default pipeline depth 8 (DEPTH), and CABAC at depth 1
        "IPPP-legacy": ({s: (legacy_cfg(s), pframes[s]) for s in N_IPPP},
                        ("intra_commit", *LEGACY)),
        "IPPP-legacy-cabac": ({CIF: (legacy_cfg(CIF, "cabac"),
                                     pframes[CIF])},
                              ("intra_commit", *LEGACY)),
    }
    def k1_expected(tag, cfg, kind):
        """K1 launches one picture of a path must make: one scan per
        picture coded on the device, one per row (G) of a tile-row P
        picture; the legacy path scans its I pictures only, the host path
        its I pictures that are one slice with flat scaling (the condition
        of the encoder's device intra picture)."""
        if tag.startswith("host"):
            one = (cfg.slice_mode == 0 and cfg.num_slice_groups == 1
                   and cfg.scaling_lists is None)
            return int(kind == "I" and one)
        if "legacy" in tag:
            return int(kind == "I")
        return cfg.row_slices if kind == "P" else 1

    runs, launches_of = {}, {}
    for tag, (sizes, needed) in paths.items():
        reset()
        host_tag = tag
        cls = (HostEncoder if tag.startswith("host") else DriftEncoder
               if tag.endswith("-ER") else LegacyEncoder if "legacy" in tag
               else H264Encoder)
        runs[tag] = {s: encode(cls, c, f, DEPTH.get(tag, 1))
                     for s, (c, f) in sizes.items()}
        launches_of[tag] = read()
        n_pics = sum(len(r[2]) for r in runs[tag].values())
        k1_want = sum(k1_expected(tag, c, p["type"])
                      for s, (c, _) in sizes.items()
                      for p in runs[tag][s][2])
        print(f"{tag} path launches: "
              f"{ {n: launches_of[tag][n] for n in needed} }; "
              f"intra_commit {launches_of[tag]['intra_commit']} launches "
              f"for {n_pics} pictures ({k1_want} expected)")
        if launches_of[tag]["intra_commit"] != k1_want:
            fail(f"{tag}: intra_commit launched "
                 f"{launches_of[tag]['intra_commit']} times for {n_pics} "
                 f"pictures, {k1_want} expected")
        for name in needed:
            if launches_of[tag][name] == 0:
                fail(f"kernel {name} was not launched on the {tag} path")
    # the main path: the bench configuration; K9 runs on its High-profile
    # form, K10 on the host path (the CIF IPPP and IPB encodes)
    launches = {**launches_of["IPB"],
                "t8_decide": launches_of["IPB-T8"]["t8_decide"],
                "sad_grid_16x16": sum(
                    launches_of[t]["sad_grid_16x16"]
                    for t in ("host-IPPP-CAVLC", "host-IPB-CABAC")),
                "propagate_drift": launches_of["IPB-ER"]["propagate_drift"],
                **{n: launches_of["IPPP-legacy"][n]
                   for n in ("p16_search", "p16_refine")}}
    for tag, by_size in runs.items():
        for size, (enc, _, pics) in by_size.items():
            if "legacy" not in tag:
                continue
            legacy_calls.extend((tag, size, n, a) for n, a in enc.calls)
            for p, share in zip([p for p in pics if p["type"] == "P"],
                                enc.skips):
                p["p_skip"] = share
    n_k10 = {t: sum(1 for c in k10_calls if c[0] == t) for t in runs}
    if any(n_k10[t] != launches_of[t]["sad_grid_16x16"] for t in runs):
        fail(f"K10 calls {n_k10} differ from its launch counts")

    def share(m):
        return round(float(np.mean(m)), 4)

    def mode_mix(kind, row, n_mb):
        if kind == "P":
            sizes = [n_mb, 4 * n_mb, 4 * n_mb]
            win, ref8, sub = np.split(row[: sum(sizes)], np.cumsum(sizes)[:-1])
            ref8, sub = ref8.reshape(n_mb, 4), sub.reshape(n_mb, 4)
            inter = win < rd_p.C_I16
            p88 = win == rd_p.C_P8x8
            t8 = row[9 * n_mb: 10 * n_mb] > 0
            return {"t8": share(t8), "skip": share(win == rd_p.C_SKIP),
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
                      f"{p['psnr_y']:.2f} dB, {p['bytes']} bytes, QP "
                      f"{p['qps']}"
                      + (f", modes {p['mode_mix']}" if "mode_mix" in p
                         else "")
                      + (f", P_Skip share {p['p_skip']:.4f}" if "p_skip" in p
                         else ""))
            if enc.rc is not None:
                got = 8 * len(stream) / len(pics) * enc.cfg.rc_fps
                report[f"bitrate {tag} {size[0]}x{size[1]}"] = {
                    "target": enc.cfg.rc_bitrate, "achieved": got}
                print(f"bitrate {tag} {size[0]}x{size[1]}: {got:.0f} b/s "
                      f"achieved, {enc.cfg.rc_bitrate:.0f} b/s target "
                      f"({got / enc.cfg.rc_bitrate:.4f}; {len(pics)} pictures"
                      f" at {enc.cfg.rc_fps:g} fps)")
            if enc.cfg.row_slices > 1:
                rp = [p for p in pics if p["type"] == "P"]
                if any(len(p["qps"]) != ROWS for p in rp):
                    fail(f"{tag}: a P picture is not {ROWS} slices")
                per = {n: float(np.mean([p["launches"].get(n, 0)
                                         for p in rp])) for n in r_names}
                report[f"rows_launches {tag} {size[0]}x{size[1]}"] = per
                print(f"launches per rows P picture, {tag} {size[0]}x"
                      f"{size[1]} (mean of {len(rp)}): {per}")
            t8s = [p["mode_mix"]["t8"] for p in pics
                   if p["type"] == "P" and "mode_mix" in p]
            if "T8" in tag and not max(t8s) > 0:
                fail(f"{tag} {size}: no P MB took the 8x8 transform")
            if "T8" in tag:
                print(f"8x8-transform share of the P MBs, {tag} "
                      f"{size[0]}x{size[1]}: {np.mean(t8s):.4f} (mean of "
                      f"{len(t8s)} P pictures)")
                report[f"t8_share {tag} {size[0]}x{size[1]}"] = float(
                    np.mean(t8s))
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

    # K10 against its plain version on every recorded and built input
    def hold_k10(cargs, what):
        got = K10.sad_grid_16x16(*cargs)
        want = K10.sad_grid_16x16_plain(*cargs)
        d = (got.long() - want.long()).abs()
        e = int(d.max())
        err["sad_grid_16x16"] = max(err["sad_grid_16x16"], e)
        mismatches["sad_grid_16x16"] += int((d > 0).sum())
        if e or got.dtype != want.dtype or got.shape != want.shape:
            fail(f"sad_grid_16x16 {what}: differs from its plain version "
                 f"({int((d > 0).sum())} elements)")
        return got

    for tag, cargs in k10_calls:
        hold_k10(cargs, f"recorded {tag}")
    rs_k10 = np.random.RandomState(SEED + 10)
    n_built = 0
    for (W, H) in (QCIF, CIF, HD):
        for R in (0, 16, 64):
            for content in ("random", "0_255"):
                if content == "random":
                    cur, ref = rs_k10.randint(0, 256, (2, H, W))
                else:  # every term at its largest
                    cur, ref = np.full((H, W), 255), np.zeros((H, W), int)
                cargs = (torch.as_tensor(cur, dtype=torch.int32, device=dev),
                         torch.as_tensor(np.pad(ref, R, mode="edge"),
                                         dtype=torch.int32, device=dev), R)
                got = hold_k10(cargs, f"built {W}x{H} R {R} {content}")
                if content == "0_255" and int(got.min()) != 255 * 256:
                    fail("sad_grid_16x16: the 0/255 case misses 65280")
                n_built += 1
    print(f"check sad_grid_16x16: {len(k10_calls)} recorded calls of the "
          f"host-path encodes and {n_built} built inputs (176x144, CIF, "
          "1280x720; R 0/16/64; random and 0/255) equal to the plain "
          "version (tolerance 0: bit-exact)")
    for size in (CIF, HD):
        W, H = size
        if size == CIF:  # a recorded input of the CIF host-path IPPP encode
            cargs = next(a for t, a in k10_calls if t == "host-IPPP-CAVLC")
        else:
            fr = pframes[HD]
            cargs = (torch.as_tensor(fr[1][0], dtype=torch.int32, device=dev),
                     torch.as_tensor(np.pad(fr[0][0].astype(np.int32), 16,
                                            mode="edge"), device=dev), 16)
        lib = sad_cdist(*cargs)
        if not torch.equal(lib.round().to(torch.int32),
                           K10.sad_grid_16x16(*cargs)):
            fail(f"torch.cdist {W}x{H}: differs from the SAD grids")
        del lib
        tm = timing.setdefault(size, {})
        tm["sad_grid_16x16"] = {
            "ms": cuda_ms(lambda: K10.sad_grid_16x16(*cargs), 20),
            "device_ms": device_ms(lambda: K10.sad_grid_16x16(*cargs), 10),
            "plain_ms": cuda_ms(lambda: K10.sad_grid_16x16_plain(*cargs), 3),
            "library_ms": cuda_ms(lambda: sad_cdist(*cargs), 3),
            "launches_per_picture": "1 (P), 2 (B)",
            "work": sad_work(H, W, cargs[2])}
        print(f"time {W}x{H} R 16 sad_grid_16x16 per call: "
              f"{tm['sad_grid_16x16']['ms']:.4f} ms (events, mean of 20), "
              f"device {tm['sad_grid_16x16']['device_ms']:.4f} ms (queued "
              "behind a spin, mean of 10), "
              f"plain {tm['sad_grid_16x16']['plain_ms']:.3f} ms, torch.cdist "
              f"{tm['sad_grid_16x16']['library_ms']:.3f} ms, bound "
              f"{bound_ms(*tm['sad_grid_16x16']['work'])[0]:.5f} ms "
              f"({bound_ms(*tm['sad_grid_16x16']['work'])[1]})")
    torch.cuda.empty_cache()

    # K11 against its plain version on every recorded and built input
    max_drift = {}  # path -> the largest |drift| its decoders reached

    # the share of MBs on K11's ordered route, from the plain version's
    # terms: (MBs ordered, MBs) per recorded path and size, per built case
    ordered_mbs = {}

    def hold_k11(cargs, what, key):
        got = K11.propagate_drift(*cargs)
        want = propagate_drift_plain(*cargs)
        for g, w, part in zip(got, want, ("drift", "pen")):
            d = (g.long() - w.long()).abs()
            e = int(d.max())
            err["propagate_drift"] = max(err["propagate_drift"], e)
            mismatches["propagate_drift"] += int((d > 0).sum())
            if e or g.dtype != w.dtype or g.shape != w.shape:
                idx = np.unravel_index(int(d.argmax()), tuple(d.shape))
                fail(f"propagate_drift {what}: {part} differs from its plain "
                     f"version ({int((d > 0).sum())} elements, first max at "
                     f"{idx}: kernel {int(g[idx])} plain {int(w[idx])})")
        route = ordered_route(want[0])
        n = ordered_mbs.setdefault(key, [0, 0])
        n[0] += int(route.sum())
        n[1] += route.numel()
        return got

    for tag, size, cargs in k11_calls:
        new, _ = hold_k11(cargs, f"recorded {tag} {size}",
                          f"recorded {tag} {size[1]}x{size[0]}")
        max_drift[tag] = max(max_drift.get(tag, 0), int(new.abs().max()))
    n_built = 0
    for (W, H) in (CIF, HD):
        for K in (1, 3, 30, 33, 64) if (W, H) == CIF else (1, 3, 30):
            for case in DRIFT_CASES:
                arrs = drift_case(case, H, W, K, seed=SEED)
                if case == "edges" and min(clipped_sides(
                        arrs[2], H, W).values()) == 0:
                    fail(f"propagate_drift built {W}x{H}: a side is not "
                         "clipped")
                hold_k11(tuple(torch.as_tensor(a, device=dev) for a in arrs),
                         f"built {W}x{H} K {K} {case}", f"built {case}")
                n_built += 1
    if not 0 < ordered_mbs["built threshold"][0] < ordered_mbs[
            "built threshold"][1]:
        fail("propagate_drift built threshold: one route took every MB")
    print(f"check propagate_drift: {len(k11_calls)} recorded steps of the "
          f"error-resilient encodes (CIF, 1280x720) and {n_built} built "
          "inputs (|drift| to 4095 and 60000, all / none lost, all intra, "
          "gathers clipped on every side, MB totals about 2^24; K 1/3/30, "
          "at CIF also 33/64) equal to the plain version (tolerance 0: "
          f"bit-exact); largest |drift| reached: {max_drift}")
    print("propagate_drift MBs on the ordered route (a square wrapped "
          "negative or an exact total above 2^24; from the plain terms): "
          + ", ".join(f"{k} {a}/{b} ({a / b:.4f})"
                      for k, (a, b) in ordered_mbs.items()))
    report["max_abs_drift"] = max_drift
    report["drift_ordered_mbs"] = ordered_mbs
    for size in (CIF, HD):
        W, H = size
        cargs = next(a for t, s, a in k11_calls
                     if t == "IPB-ER" and s == (H, W))
        K = cargs[0].shape[0]
        tm = timing.setdefault(size, {})
        new = propagate_drift_plain(*cargs)[0]
        tm["propagate_drift"] = {
            "ms": cuda_ms(lambda: K11.propagate_drift(*cargs), 20),
            "device_ms": device_ms(lambda: K11.propagate_drift(*cargs), 10),
            "plain_ms": cuda_ms(lambda: propagate_drift_plain(*cargs), 20),
            "launches_per_picture": "1 (RD P)",
            "work": drift_work(K, H, W, float(
                ordered_route(new).float().mean()))}
        b_ms, b_by = bound_ms(*tm["propagate_drift"]["work"])
        print(f"time {W}x{H} K {K} propagate_drift per P picture: "
              f"{tm['propagate_drift']['ms']:.4f} ms (events, mean of 20), "
              f"device {tm['propagate_drift']['device_ms']:.4f} ms (queued "
              "behind a spin, mean of 10), "
              f"plain {tm['propagate_drift']['plain_ms']:.3f} ms (mean of "
              f"20), bound {b_ms:.5f} ms ({b_by}, "
              f"{tm['propagate_drift']['work'][0]} B); no single PyTorch "
              "call computes it")
    for tag, base in (("IPB-ER", "IPB"), ("IPPP-ER", "IPPP")):
        for size in runs[tag]:
            shares = [
                float(np.mean([p["mode_mix"]["intra"]
                               for p in runs[t][size][2]
                               if p["type"] == "P" and "mode_mix" in p]))
                for t in (tag, base)]
            report[f"intra_share {tag} {size[0]}x{size[1]}"] = shares
            print(f"intra-MB share of the P pictures, {tag} {size[0]}x"
                  f"{size[1]}: {shares[0]:.4f} ({base}: {shares[1]:.4f})")

    # K12 and K13, and K2 and K6 where the legacy path runs them, against
    # their plain versions: every call of the legacy encodes (QP 28 above;
    # 1 I + 2 P at QP 0 and 51 here), and the built inputs at R 28
    lk = fast.default_kernels()

    def hold_l(name, cargs, what):
        got = getattr(lk, name)(*cargs)
        want = getattr(fast.PLAIN, name)(*cargs)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            d = (g.long() - w.long()).abs()
            e = int(d.max()) if d.numel() else 0
            err[name] = max(err[name], e)
            mismatches[name] += int((d > 0).sum())
            if e or g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} {what}: output {i} differs from its plain "
                     f"version ({int((d > 0).sum())} elements)")
        return got

    for size in (CIF, HD):
        for qp in (0, 51):
            enc = LegacyEncoder(legacy_cfg(size, qp=qp), device="cuda")
            list(enc.encode_stream(pframes[size][:3]))
            legacy_calls.extend((f"legacy QP {qp}", size, n, a)
                                for n, a in enc.calls)
    for tag, size, name, cargs in legacy_calls:
        hold_l(name, cargs, f"recorded {tag} {size[0]}x{size[1]}")
    if {n for _, _, n, _ in legacy_calls} != set(LEGACY):
        fail("a legacy entry was not called")
    n_built = 0
    for (W, H) in (CIF, HD):
        for case in P16_CASES:
            cur, ref = p16_case(case, H, W, 28, seed=SEED + W)
            cur = tuple(torch.as_tensor(x, device=dev) for x in cur)
            ref = tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                        for x in ref)
            for qp in (0, 28, 51):
                what = f"built {W}x{H} {case} QP {qp}"
                mx, my, g0 = hold_l("p16_search",
                                    (cur[0], ref[0], 28, lam_fx(qp)), what)
                if case == "edges" and min(reached_sides(
                        mx.cpu(), my.cpu(), 28).values()) == 0:
                    fail(f"p16_search {what}: a picture edge's motion does "
                         "not reach 28")
                if case == "0_255" and int(g0.min()) != 256 * 255 ** 2:
                    fail(f"p16_search {what}: the SSD misses 256 * 255^2")
                hold_l("p16_refine", (*cur, *ref, mx, my, qp, qp,
                                      lam_fx(qp)), what)
                n_built += 1
            # vectors whose windows move: the corners at +-29, the others
            # beyond the pad and at the int32 extremes
            mx, my = (torch.as_tensor(v, device=dev)
                      for v in moved_vectors(H, W, 28, seed=SEED + W))
            hold_l("p16_refine", (*cur, *ref, mx, my, 28, 28, lam_fx(28)),
                   f"built {W}x{H} {case} moved windows")
            n_built += 1
    print(f"check legacy path: {len(legacy_calls)} recorded calls of "
          f"{', '.join(LEGACY)} (legacy IPPP, CIF and 1280x720, QP 0/28/51) "
          f"and {n_built} built inputs of p16_search and p16_refine (0/255, "
          "flat, motion to +-28 at every edge; QP 0/28/51; p16_refine also "
          "on vectors whose windows wrap and clamp) equal to the "
          "plain versions (tolerance 0: bit-exact)")
    timing_l = {}  # K2 and K6 on the legacy path's inputs
    for size in (CIF, HD):
        W, H = size
        # the last legacy P picture of step 5's IPPP-legacy encode
        mine = {n: a for t, s, n, a in legacy_calls
                if t == "IPPP-legacy" and s == size}
        tm = timing.setdefault(size, {})
        for name in ("p16_search", "p16_refine"):
            fk, fp, a = getattr(lk, name), getattr(fast.PLAIN, name), mine[name]
            tm[name] = {"ms": cuda_ms(lambda: fk(*a), 20),
                        "device_ms": device_ms(lambda: fk(*a), 10),
                        "plain_ms": cuda_ms(lambda: fp(*a), 3),
                        "launches_per_picture": 1,
                        "work": (p16_search_work(H, W, 28)
                                 if name == "p16_search"
                                 else p16_refine_work(H, W))}
        a = mine["p16_search"]
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib = ssd_conv(*a, torch.float32)
            if not all(torch.equal(x, y) for x, y in zip(
                    lib, P16.p16_search(*a))):
                fail(f"conv2d search {W}x{H}: differs from p16_search")
            del lib
            tm["p16_search"]["library_ms"] = cuda_ms(
                lambda: ssd_conv(*a, torch.float32), 3)
            tm["p16_search"]["library_bf16_ms"] = cuda_ms(
                lambda: ssd_conv(*a, torch.bfloat16), 3)
        except torch.cuda.OutOfMemoryError:
            tm["p16_search"]["library_ms"] = None
            tm["p16_search"]["library_bf16_ms"] = "not measured (memory)"
        finally:
            torch.backends.cudnn.allow_tf32 = True
            torch.cuda.empty_cache()
        tl = timing_l.setdefault(size, {})
        for name in ("strengths", "deblock", "ref_bank"):
            fk, fp, a = getattr(lk, name), getattr(fast.PLAIN, name), mine[name]
            tl[name] = {"ms": cuda_ms(lambda: fk(*a), 20),
                        "plain_ms": cuda_ms(lambda: fp(*a), 1),
                        "launches_per_picture": 1,
                        "work": (k2_work(H, W) if name == "ref_bank"
                                 else p_work(name, a))}
        for name, v in (*((n, tm[n]) for n in ("p16_search", "p16_refine")),
                        *tl.items()):
            b_ms, b_by = bound_ms(*v["work"])
            lib = (f", conv2d route {v['library_ms']:.3f} ms (float32, "
                   f"exact), {v['library_bf16_ms']} ms (bfloat16)"
                   if v.get("library_ms") is not None else "")
            dev_t = (f", device {v['device_ms']:.4f} ms (queued behind a "
                     "spin, mean of 10)" if "device_ms" in v else "")
            print(f"time {W}x{H} legacy {name} per P picture: "
                  f"{v['ms']:.4f} ms (events, mean of 20){dev_t}, plain "
                  f"{v['plain_ms']:.3f} ms, bound {b_ms:.5f} ms ({b_by}, "
                  f"{v['work'][0]} B, {v['work'][1]} ops){lib}")
    report["timing_legacy"] = {
        f"{s[0]}x{s[1]}": {n: {**v, "bound_ms": bound_ms(*v["work"])[0]}
                           for n, v in t.items()}
        for s, t in timing_l.items()}
    for size, (enc, _, pics) in runs["IPPP-legacy"].items():
        sk = [p["p_skip"] for p in pics if "p_skip" in p]
        report[f"p_skip IPPP-legacy {size[0]}x{size[1]}"] = sk
        print(f"P_Skip share of the legacy P pictures, {size[0]}x{size[1]}: "
              f"{np.mean(sk):.4f} (mean of {len(sk)})")
    del legacy_calls[:]
    torch.cuda.empty_cache()

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 6. the same frames through the plain versions on the card -----------
    # the plain versions are host-bound (the card idles), so each path's
    # plain encode runs in a worker process of its own, PLAIN_WORKERS at a
    # time, the longest first; nothing else runs meanwhile
    jobs = []
    for tag, (sizes, _) in paths.items():
        if tag == "rows":  # its entries are held on its inputs in step 3
            continue
        for size in [s for s in (CIF, QCIF) if s in sizes]:
            cfg, fr = sizes[size]
            if tag == "IPB-T8":  # a shorter stream, through both
                fr = fr[:N_IPB_T8_PLAIN]
            jobs.append((tag, size, cfg, fr))
    jobs.sort(key=lambda j: -j[1][0] * j[1][1] * len(j[3]))
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    # (a worker that dies fails the map instead of hanging it)
    with ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        plain = list(pool.map(plain_encode, jobs))
    for (tag, size, cfg, fr), (pstream, precons, prefs, pdrift,
                               secs) in zip(jobs, plain):
        enc, stream, _ = runs[tag][size]
        if tag == "IPB-T8":
            enc, stream, _ = encode(H264Encoder, cfg, fr)
        if pstream != stream:
            fail(f"{tag} {size}: stream differs from the plain path's")
        if len(enc.all_recons) != len(precons):
            fail(f"{tag} {size}: recon counts differ")
        for (_, a), b in zip(enc.all_recons, precons):
            for x, y in zip((a.Y, a.U, a.V), b):
                if not np.array_equal(x, y):
                    fail(f"{tag} {size}: recon differs from the plain "
                         "path's")
        mine = ref_state(enc)
        if len(mine) != len(prefs):
            fail(f"{tag} {size}: reference lists differ in length")
        for (pa, ea), (pb, eb) in zip(mine, prefs):
            if pa != pb:
                fail(f"{tag} {size}: reference POCs differ")
            for x, y in zip(ea, eb):
                if not np.array_equal(x, y):
                    fail(f"{tag} {size}: reference entry differs from "
                         "the plain path's")
        if (enc._lsim is None) != (pdrift is None) or (
                pdrift is not None and not np.array_equal(
                    enc._lsim.drift.cpu().numpy(), pdrift)):
            fail(f"{tag} {size}: simulated decoders' drift differs from the "
                 "plain path's")
        print(f"plain path {tag} {size[0]}x{size[1]} ({len(fr)} frames, "
              f"{secs:.0f} s in its worker): stream, recon and reference "
              "entries identical")
    print(f"plain paths: {len(jobs)} encodes in "
          f"{time.perf_counter() - t6:.0f} s on {PLAIN_WORKERS} workers")

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
            host = tag.startswith("host")
            if tag == "host-FMO2":
                # slice group 0 holds no MB 0: the reference's decoder (and
                # the port's) starts a new picture at the later slice with
                # first_mb_in_slice 0 (ROADMAP Queue 3)
                if len(pics) != 2 * len(enc.all_recons):
                    fail(f"decode of {what}: {len(pics)} pictures, expected "
                         f"the reference decoder's {2 * len(enc.all_recons)}")
                print(f"decode of {what}: byte-identical to the host decode; "
                      f"{len(pics)} pictures for {len(enc.all_recons)} coded "
                      "(the reference decoder's picture split)")
                continue
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
                if (kind in ("I", "P") or host) and tag != "IPB-hierarchy" \
                        and (dy or dc):
                    fail(f"decode of {what}: {kind} picture POC {poc} differs "
                         f"from the encoder's recon ({dy} luma, {dc} chroma "
                         "samples)")
                if (kind == "B" and not host) or tag == "IPB-hierarchy":
                    b_diff.setdefault(what, []).append((kind, poc, dy, dc))
            print(f"decode of {what}: byte-identical to the host decode; "
                  f"{'all' if host else 'I/P'} pictures equal to the "
                  "encoder's recons"
                  if tag != "IPB-hierarchy" else
                  f"decode of {what}: byte-identical to the host decode")
    for what, rows in b_diff.items():
        print(f"decode vs encoder recon, {what} (report; the reference's B "
              "windows, ROADMAP Queue 3): " + ", ".join(
                  f"{k} POC {poc}: {dy} luma / {dc} chroma samples differ"
                  for k, poc, dy, dc in rows))
    report["decode_vs_recon"] = b_diff

    # a lost slice: the IPPP-ER stream without its second P picture's slice
    # (its frame_num gap concealed), on both decoder paths
    er_stream = runs["IPPP-ER"][CIF][1]
    nals = list(iter_annexb_nalus(er_stream))
    slices = [i for i, n in enumerate(nals) if n.nal_unit_type == 1]
    lossy = write_annexb([n for i, n in enumerate(nals) if i != slices[1]])
    for mode in (1, 2):
        dpics = list(H264Decoder(conceal_mode=mode, device="cuda")
                     .decode_stream(lossy))
        hpics = list(H264Decoder(conceal_mode=mode, use_device=False)
                     .decode_stream(lossy))
        if [p.to_yuv_bytes() for p in dpics] != [p.to_yuv_bytes()
                                                 for p in hpics]:
            fail(f"IPPP-ER with a lost slice, conceal mode {mode}: the card's "
                 "decode differs from the host decode")
        if len(dpics) != N_IPPP[CIF] or not any(
                getattr(p, "concealed", False) for p in dpics):
            fail(f"IPPP-ER with a lost slice, conceal mode {mode}: "
                 f"{len(dpics)} pictures, none concealed")
    print("decode of IPPP-ER CIF without its second P slice, conceal modes "
          "1 and 2: the card's decode byte-identical to the host decode")

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

    # ---- 8. the command-line chain --------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with open(os.path.join(work, "in.yuv"), "wb") as f:
            for fr in moving_frames(3, *QCIF, seed=SEED + 4):
                for pl in fr:
                    f.write(np.ascontiguousarray(pl, np.uint8).tobytes())
        with open(os.path.join(work, "enc.cfg"), "w") as f:
            f.write(f"InputFile = in.yuv\nSourceWidth = {QCIF[0]}\n"
                    f"SourceHeight = {QCIF[1]}\nFramesToBeEncoded = 3\n"
                    "QPISlice = 28\nQPPSlice = 28\nSearchRange = 16\n"
                    "OutputFile = out.rtp\nReconFile = rec.yuv\n")
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        chain = [
            ["h264_tpu_torch.lencod", "-d", "enc.cfg", "-p",
             "GenerateSEIMessage=1", "-p", "SEIMessageText=chip smoke", "-p",
             "OutFileMode=1"],
            ["h264_tpu_torch.tools.rtp_loss", "out.rtp", "lossy.rtp", "20",
             "2"],  # (seed 2 drops the last picture's packet)
            ["h264_tpu_torch.tools.rtpdump", "lossy.rtp"],
            ["h264_tpu_torch.ldecod", "out.rtp", "dec.yuv"],
        ]
        t8c = time.perf_counter()
        for cmd in chain:
            r = subprocess.run([sys.executable, "-m", *cmd], cwd=work, env=env,
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                fail(f"{' '.join(cmd)}: exit {r.returncode}\n{r.stdout}"
                     f"{r.stderr}")
            print(f"cli {cmd[0]}: exit 0, last line: "
                  f"{r.stdout.strip().splitlines()[-1]}")
        with open(os.path.join(work, "dec.yuv"), "rb") as f:
            dec = f.read()
        with open(os.path.join(work, "rec.yuv"), "rb") as f:
            rec = f.read()
        if dec != rec or len(rec) != 3 * QCIF[0] * QCIF[1] * 3 // 2:
            fail("cli: the ldecod output differs from lencod's recon file")
        print(f"cli chain lencod (RTP, text SEI) -> rtp_loss -> rtpdump -> "
              f"ldecod: exit codes 0, decode equal to the recon file "
              f"({time.perf_counter() - t8c:.0f} s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 9. the sharded tile-row pipelines (parallel/) -----------------------
    # Ranks are processes of their own that load the kernels built in step
    # 1. On this card they share it (gloo, halos staged through host
    # memory), and nccl runs at world size 1: their times are not a
    # scaling result.
    t9 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' contexts share the card
    with open(os.path.join(here, "tests", "torch_records.json")) as fh:
        sh_rec = json.load(fh)["sharded"]

    def hold_rows_bank(ext, what):
        ext = [torch.as_tensor(x, device=dev) for x in ext]
        got = K2.ref_bank_rows(*ext)
        want = K2.ref_bank_rows_plain(*ext)
        for name, g, w in zip(("bank", "cpad"), got, want):
            e = int((g - w).abs().max())
            err["ref_bank_rows"] = max(err["ref_bank_rows"], e)
            mismatches["ref_bank_rows"] += int((g != w).sum())
            if e:
                fail(f"ref_bank_rows {what}: {name} differs by {e}")

    # (a) K2's row-slab entry on built slabs (0/255 and random; top,
    # middle and bottom shards; Hg 16 < PAD: zero rows in luma and
    # chroma), then timed at the CIF slab of 2 row shards (Hg 144)
    n_built = 0
    for content in SLAB_CONTENTS:
        for Hg in (16, 144, 240):
            for r in range(3):
                hold_rows_bank(built_slab(content, Hg, CIF[0] if Hg < 240
                                          else HD[0], r, 3),
                               f"built {content} Hg {Hg} shard {r}")
                n_built += 1
    print(f"check ref_bank_rows: {n_built} built slabs (0/255 and random; "
          "top, middle, bottom shards; Hg 16, 144, 240) equal to its plain "
          "version (tolerance 0: bit-exact)")
    ext = [torch.as_tensor(x, device=dev)
           for x in built_slab("random", 144, CIF[0], 1, 2)]
    pic = [x[rd.PAD:-rd.PAD].contiguous() for x in ext]  # a 144-line plane
    timing[CIF]["ref_bank_rows"] = {
        "ms": cuda_ms(lambda: K2.ref_bank_rows(*ext), 50),
        "plain_ms": cuda_ms(lambda: K2.ref_bank_rows_plain(*ext), 20),
        "ref_bank_same_height_ms": cuda_ms(
            lambda: K2.ref_bank(*pic), 50),
        "launches_per_picture": 1,
        "work": rows_bank_work(*(x.shape[0] for x in ext[:2]), CIF[0])}
    tb = timing[CIF]["ref_bank_rows"]
    print(f"time ref_bank_rows CIF slab (208 x 352 luma, 136 x 176 chroma):"
          f" {tb['ms']:.4f} ms, plain {tb['plain_ms']:.4f} ms, bound "
          f"{bound_ms(*tb['work'])[0]:.5f} ms; ref_bank on a 144 x 352 "
          f"plane {tb['ref_bank_same_height_ms']:.4f} ms")

    sh_names = ("ref_bank_rows", "intra_commit", *rows_names)
    sharded = {
        # (b) CIF over (frame 2, row 2); (c) 720p over (frame 1, row 3):
        # a middle shard; (e) the CIF GOP on nccl at world size 1
        "CIF-2x2": gop_run("CIF-2x2", CIF, Mesh(2, 2, "gloo"), S_SH,
                           SEED + 4, sh_names, hold_rows_bank),
        "720p-1x3": gop_run("720p-1x3", HD, Mesh(1, 3, "gloo"), S_SH_HD,
                            SEED + 5, sh_names, hold_rows_bank),
        "CIF-1x1-nccl": gop_run("CIF-1x1-nccl", CIF, Mesh(1, 1, "nccl"),
                                S_SH, SEED + 4, sh_names, hold_rows_bank),
    }
    # (d) the dry run, 8 gloo ranks: its stream as h264_tpu's
    t_call = time.time()
    dry = DRY.dryrun_multichip(8, backend="gloo", device="cuda")
    t_done = time.time()
    want = sh_rec["dryrun_8"]
    got = {"host_outs": digest(dry["host_outs"]),
           "recon_y": digest(dry["recon_y"]), "stream": digest(dry["stream"]),
           "stream_bytes": len(dry["stream"])}
    if "stream_bytes=25923" not in dry["line"] or any(
            got[k] != want[k] for k in got):
        fail(f"dryrun_multichip(8): {got} differs from the record of "
             f"h264_tpu {want}")
    sharded["dryrun-8"] = {"line": dry["line"], **got,
                           "wall_s": t_done - t_call,
                           "start_s": start_exit(dry["ranks"], t_call,
                                                 t_done)["start_s"],
                           "ranks": [rank_times(i) for i in dry["ranks"]]}
    print(f"dryrun_multichip(8) on 8 gloo ranks sharing the card: "
          f"stream_bytes={got['stream_bytes']} sha256 {got['stream']}, "
          "host_outs and recon equal to the record of h264_tpu "
          f"({sharded['dryrun-8']['wall_s']:.1f} s with the single-device "
          f"chain; the ranks' start {sharded['dryrun-8']['start_s']:.1f} s)")
    for r in sharded["dryrun-8"]["ranks"]:
        print_rank(r)
    launches["ref_bank_rows"] = sharded["CIF-2x2"]["launches"][
        "ref_bank_rows"]
    report["sharded"] = sharded
    print(f"sharded phase: {time.perf_counter() - t9:.0f} s")
    print(f"elapsed {time.perf_counter() - t_start:.0f} s")

    # ---- 10. report ----------------------------------------------------------
    kernels = []
    rows_per = report[f"rows_launches rows {CIF[0]}x{CIF[1]}"]
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
            "bound_by": b_by, "library_ms": tm.get("library_ms"),
            # launches per CIF P picture of the tile-row path (step 5)
            "rows_launches_per_picture": rows_per.get(name),
        })
        if name == "deblock":  # its chain on built inputs, device ms
            kernels[-1].update({
                "chain_16x16_ms": k6_chain["mb_ms"],
                "chain_row_step_ms": k6_chain["row_step_ms"],
                "chain_column_step_ms": k6_chain["column_step_ms"]})
    for kind, tms in (("", timing), ("b_", timing_b), ("decode_", timing_d),
                      ("rows_", timing_rows)):
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
