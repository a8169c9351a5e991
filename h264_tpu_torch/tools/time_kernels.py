"""The main path's kernel entries on its inputs, on one CUDA card: one
call a picture of each entry beside an empty launch of its grid, K4 per
shape and per picture, K6's chain and launch profile, and K1 on P and B
pictures.  ``chip_smoke.py`` times with the same functions.

    python -m h264_tpu_torch.tools.time_kernels [--out DIR]
    python h264_tpu_torch/tools/time_kernels.py --root DIR [--out DIR]
    python -m h264_tpu_torch.tools.time_kernels --trial [--out DIR]
    python -m h264_tpu_torch.tools.time_kernels --ab DIR [--out DIR]

Encodes the bench configuration (IPB, one B picture between anchors, QP
28, 5 references, search range 28, explicit WP; ``moving_frames``, 5
frames) at CIF and 1280x720 with every P and B kernel entry recorded, and
times on the second P and the second B picture's inputs:
- every ``ONE_CALL`` entry the picture calls (K3 ``coarse_search`` and
  ``ssd_grid4``, K5 ``inter_luma_tq``, ``inter_chroma_tq`` and
  ``i16_candidate``, K7 ``b_direct``, K2 ``ref_bank`` on the picture's
  filtered planes, K6 ``strengths``, K4 ``mc_luma``, ``mc_chroma``,
  ``mc_luma_win`` and ``mc_chroma_b``), one call: its device time queued
  behind a spin of the card (the host's launch time excluded), back to
  back (CUDA events and the host's clock; the median of 5 rounds), and an
  empty kernel launched on the grid of each of its designs
  (``empty_launch_ms``: the floor of a launch of that grid);
- each ``qpel_refine`` call (one shape each) on the device, and the
  picture's calls on the device and back to back;
- the ``deblock`` call, the same two ways;
- K1 ``intra_commit_scan`` on the picture's scan state (its intra MBs);
- for ``b_direct``, the distinct 32-byte sectors its gathers touch
  (``sector_bytes``, with the fields and outputs, and their time at
  3.35 TB/s, ``sector_bound_ms``): the least traffic of its reads at the
  memory's granularity, where the byte bound counts only the samples.
Then K6's chain on built inputs: a 16x16 picture, an MB's step along a
row (1280x16) and down a column (16x1088), CIF and 1280x720 pictures
beside their chain (``deblock_chain``); and ``torch.profiler`` over one
``deblock`` call and over an I + P encode: the device kernels, copies and
memsets each makes.  With ``--trial``, also K6 built without the fence
before each release, beside K6 as it is (``trial_no_fence``), and K3
with strips of 8, 4 and 2 MBs, its decimation alone, an empty launch of
the decimation's grid and its search alone (``trial_coarse``).

With ``--root`` the package is imported from the checkout DIR, so that
an earlier version of the kernels is timed by the same script in the
same call on the same card. With ``--ab DIR`` the package of the
checkout DIR is imported beside this one (as ``h264_tpu_torch_ab``), and
on the same recorded pictures both packages' strength step (the deblock
stage's glue for the strengths and their kernel, the filter left out; on
P pictures also with the colocated snapshot's planes, which
``p_outputs`` builds in ``p_colocated`` and earlier versions built in
``p_deblock``) and, as a control, both ``inter_chroma_tq`` wrappers
run back to back in turns, 15 rounds a b b a ... (``ab``), with each
strength step's count of torch operations: the host's speed wanders
between processes and over seconds, so only calls taken in turns in one
process compare their host time. Prints the card's name and power limit
and one JSON object (also written to DIR/time_kernels[-TAG].json with
``--out``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

CIF, HD = (352, 288), (1280, 720)
SEED = 20260717
# the kernel sources the bench configuration's pictures run
STEMS = ("intra_commit", "ref_bank", "search_grid", "qpel", "inter_tq",
         "deblock", "b_direct")


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


# the spin each timed call is queued behind: 4e6 clocks, about 2 ms on an
# H100, longer than the host takes to launch a picture's calls (up to
# 0.75 ms seen), so that they start back to back on the card
SPIN_CLOCKS = 4_000_000


def spin_ms(fn, reps: int) -> float:
    """Device time of one call of fn: each timed call is queued behind a
    spin of the card, so the host's launch time does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CLOCKS)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def events_ms(fn, reps: int) -> float:
    """Mean time of fn over reps calls back to back (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def events_rounds(fn, reps: int, rounds: int = 5) -> tuple:
    """fn back to back, `rounds` times: each round's mean time a call by
    CUDA events, and on the host's clock up to the last launch (before the
    synchronize: the launches' own cost).  Where the host's time is the
    longer, a call's time is the host's, and that wanders from round to
    round."""
    import torch

    ev, host = [], []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        ev.append(a.elapsed_time(b) / reps)
        host.append((t1 - t0) * 1e3 / reps)
    return ev, host


def back_to_back(fn, reps: int) -> dict:
    """``events_rounds`` of fn: the medians and each round's figures."""
    import statistics

    ev, host = events_rounds(fn, reps)
    return {"events_ms": statistics.median(ev), "events_rounds_ms": ev,
            "host_ms": statistics.median(host), "host_rounds_ms": host}


def copy_scan(s):
    """A copy of an intra commit scan state (K1 updates its carry in
    place)."""
    return dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone()
        for f in dataclasses.fields(s)
        if hasattr(getattr(s, f.name), "clone")})


def scan_recording(k, scans: list):
    """The kernel entries `k` (PKernels or BKernels) with a copy of each
    picture's K1 scan state appended to `scans` before its scan runs."""
    def scan(s):
        scans.append(copy_scan(s))
        return k.intra_scan(s)
    return dataclasses.replace(k, intra_scan=scan)


def by_picture(calls):
    """Recorded entry calls cut into pictures: a picture's calls end with
    its one ``deblock`` call."""
    pics = [[]]
    for name, a in calls:
        pics[-1].append((name, a))
        if name == "deblock":
            pics.append([])
    return pics[:-1]


def record_bench(size):
    """The bench configuration's recorded P and B pictures, in coding
    order: {"P": [(calls, scan)], "B": [...], "frames": {"P": [frame],
    "B": [...]}}, each picture's entry calls, a copy of its K1 scan state
    taken before the scan, and its ``PFrame`` / ``BFrame`` as the deblock
    stage found it."""
    import torch
    from h264_tpu_torch.encoder import rd_b, rd_p
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.tools.synthseq import moving_frames

    cfg = EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                        rd=True, entropy="cabac", b_frames=1,
                        num_ref_frames=5, search_range=28,
                        weighted_pred=True)
    enc = H264Encoder(cfg, device="cuda")
    scans = {"P": [], "B": []}
    frames = {"P": [], "B": []}
    pk, pcalls = rd_p.recording(rd_p.default_kernels())
    bk, bcalls = rd_b.recording(rd_b.default_kernels())
    enc._p_kernels = scan_recording(pk, scans["P"])
    enc._b_kernels = scan_recording(bk, scans["B"])
    stages = {"P": (rd_p, "P_STAGES"), "B": (rd_b, "B_STAGES")}
    kept = {kind: getattr(m, n) for kind, (m, n) in stages.items()}
    for kind, (mod, name) in stages.items():
        *rest, deblock = kept[kind]

        def hook(f, deblock=deblock, kind=kind):
            frames[kind].append(f)
            return deblock(f)

        setattr(mod, name, (*rest, hook))
    try:
        list(enc.encode_stream(moving_frames(5, *size, seed=SEED)))
    finally:
        for kind, (mod, name) in stages.items():
            setattr(mod, name, kept[kind])
    torch.cuda.synchronize()
    out = {kind: list(zip(by_picture(calls), scans[kind]))
           for kind, calls in (("P", pcalls), ("B", bcalls))}
    out["frames"] = frames
    return out


def _grid(warps: int):
    """(blocks, threads) of `warps` warps, as many a block (up to 4) as
    leave a block for each of an H100's 132 SMs."""
    per = max(1, min(4, warps // 132))
    return (warps + per - 1) // per, 32 * per


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _bank_blocks(H: int, W: int) -> int:
    """Blocks of ref_bank's grid for an H x W picture: output tiles of
    16 x 64, the chroma tiles in further rows of blocks."""
    ntx = _cdiv(W + 64, 64)
    tc = 2 * _cdiv(W // 2 + 64, 64) * _cdiv(H // 2 + 64, 16)
    return ntx * (_cdiv(H + 64, 16) + _cdiv(tc, ntx))


def _bank_grids(a):
    """ref_bank's grid, then the first design's (a thread an output)."""
    H, W = a[0].shape
    n = 4 * (H + 64) * (W + 64) + 2 * (H // 2 + 64) * (W // 2 + 64)
    return [(_bank_blocks(H, W), 256), (_cdiv(n, 256), 256)]


def _strength_grids(a):
    """strengths' grid (tiles of 4 rows of 32 blocks), then the first
    design's (a thread a block, 256 a thread block); a call of the first
    design (per-block planes first) has only the second."""
    if not isinstance(a[0], int):
        return [(_cdiv(a[0].numel(), 256), 256)]
    H4, W4 = 4 * a[0], 4 * a[1]
    return [(_cdiv(W4, 32) * _cdiv(H4, 4), 128), (_cdiv(H4 * W4, 256), 256)]


# (blocks, threads) of the launches of each entry timed one call a
# picture, from the call's arguments: this design's grid, then, where it
# was redesigned, the first design's
GRIDS = {
    "inter_chroma_tq": lambda a: [_grid((a[0].shape[0] + 1) // 2),
                                  ((a[0].shape[0] + 7) // 8, 64)],
    "b_direct": lambda a: [_grid(a[2].numel() // 16),
                           (a[2].numel() // 16, 256)],
    "ref_bank": _bank_grids,
    "strengths": _strength_grids,
    "i16_candidate": lambda a: [(a[0].numel() // 256, 64)],
    "ssd_grid4": lambda a: [(a[2].numel(), 256)],
    "mc_luma": lambda a: [(_cdiv(a[1].numel() * a[7] * a[8], 256), 256)],
    "mc_chroma": lambda a: [(_cdiv(a[1].shape[0] * 128, 256), 256)],
    "mc_luma_win": lambda a: [(_cdiv(a[1].numel() * a[6] * a[7], 256), 256)],
    "mc_chroma_b": lambda a: [(_cdiv(a[2].shape[0] * 128, 256), 256)],
}
# the entries timed one call a picture on the device, and their modules
# under kernels/: the redesigned ones, then the ones that wait for a
# redesign
ONE_CALL = {"coarse_search": "search_grid", "inter_luma_tq": "inter_tq",
            "inter_chroma_tq": "inter_tq", "b_direct": "b_direct",
            "ref_bank": "ref_bank", "strengths": "deblock",
            "i16_candidate": "inter_tq",
            "ssd_grid4": "search_grid", "mc_luma_win": "qpel",
            "mc_chroma_b": "qpel", "mc_luma": "qpel", "mc_chroma": "qpel"}


def empty_launch_ms(blocks: int, threads: int, reps: int = 20) -> float:
    """Device time of an empty kernel launched on a (blocks, threads)
    grid, queued behind a spin as ``spin_ms`` times a call."""
    import torch

    fn = _empty_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(blocks, threads, stream):
            raise RuntimeError("empty launch: CUDA error")

    return spin_ms(launch, reps)


@functools.lru_cache(maxsize=None)
def _empty_lib():
    return _trial_lib("empty", {"empty.cu": EMPTY_CU}, "empty_launch", "iip")


EMPTY_CU = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


HBM_BPS = 3.35e12  # an H100's memory rate


def direct_sector_bytes(args) -> int:
    """Bytes of the distinct 32-byte sectors that one ``b_direct`` call's
    gathers touch (each tap plane's 8 rows of 8 samples per unit and list,
    a row in one sector or two), plus the colocated fields and tables read
    and the outputs written once."""
    import torch
    from h264_tpu_torch.encoder import rd, rd_b

    b0, b1 = args[:2]
    NR0, _, Hp, Wp = b0.shape
    idx, l0x, l0y, l1x, l1y = (a.long() for a in rd_b.direct_mvs(*args[2:]))
    n_mb = idx.shape[0]
    dev = idx.device
    _, _, y0, x0 = rd_b._units(n_mb, (Wp - 64) // 16, dev)
    q = torch.as_tensor(rd._QTAB, device=dev).long()
    rows = torch.arange(8, device=dev)
    ends = []
    # list 1's bank after list 0's: a separate allocation, never shared
    for base, r, mx, my in ((0, rd_b._slice_start(idx, NR0, 1), l0x, l0y),
                            (NR0 * 4 * Hp * Wp, 0, l1x, l1y)):
        iy = rd_b._slice_start(y0 + (my >> 2) + rd.PAD, Hp, 10)
        ix = rd_b._slice_start(x0 + (mx >> 2) + rd.PAD, Wp, 10)
        t = q[(my & 3) * 4 + (mx & 3)]
        for k in (0, 3):
            row0 = (r * 4 + t[..., k]) * Hp + iy + t[..., k + 1]
            start = (base + (row0[..., None] + rows) * Wp
                     + (ix + t[..., k + 2])[..., None])
            ends += [start // 8, (start + 7) // 8]  # 8 int32 a sector
    sectors = int(torch.unique(torch.cat([e.reshape(-1) for e in ends])
                               ).numel())
    fields = sum(a.numel() * a.element_size() for a in args[2:])
    return sectors * 32 + fields + n_mb * 276 * 4


def load_ab(root):
    """The h264_tpu_torch package of the checkout `root`, imported as
    h264_tpu_torch_ab beside this one (the package imports itself only
    relatively)."""
    import importlib.util

    pkg = pathlib.Path(root).resolve() / "h264_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "h264_tpu_torch_ab", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["h264_tpu_torch_ab"] = mod
    spec.loader.exec_module(mod)
    return mod


def ab_times(fa, fb, reps: int = 20, rounds: int = 15) -> dict:
    """fa ("this") and fb ("ab") back to back in turns, a b b a ...: each
    round's mean ms a call by CUDA events and on the host's clock, their
    medians, and the ratio of this one's to the other's."""
    import statistics

    out = {"this": {"events": [], "host": []}, "ab": {"events": [], "host": []}}
    for i in range(rounds):
        order = (("this", fa), ("ab", fb))
        for key, fn in order if i % 2 == 0 else order[::-1]:
            ev, host = events_rounds(fn, reps, rounds=1)
            out[key]["events"] += ev
            out[key]["host"] += host
    for key in ("this", "ab"):
        for m in ("events", "host"):
            out[key][f"{m}_ms"] = statistics.median(out[key][m])
    out["events_ratio"] = out["this"]["events_ms"] / out["ab"]["events_ms"]
    out["host_ratio"] = out["this"]["host_ms"] / out["ab"]["host_ms"]
    return out


def count_ops(fn) -> int:
    """The torch operations (aten calls, views and allocations included)
    one call of fn dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def strength_step(pkg: str, kind: str, frame, colocated: bool = False):
    """The strength step of one recorded picture through the package
    `pkg`'s deblock stage (``p_deblock`` / ``b_deblock``) with the filter
    left out: every glue operation for the strengths and their kernel,
    on a copy of the picture's frame; with `colocated`, also the P
    picture's colocated planes where the package builds them apart from
    that stage (``p_colocated``)."""
    import copy
    import importlib

    mod = importlib.import_module(
        f"{pkg}.encoder.{'rd_p' if kind == 'P' else 'rd_b'}")
    g = copy.copy(frame)
    g.k = dataclasses.replace(mod.default_kernels(),
                              deblock=lambda *a: (None, None, None))
    stage = mod.p_deblock if kind == "P" else mod.b_deblock
    col = getattr(mod, "p_colocated", None) if colocated else None
    if col is None:
        return lambda: stage(g)
    return lambda: (stage(g), col(g))


def picture_ab(calls, kind: str, frame, other) -> dict:
    """In turns in one process (``ab_times``) on one recorded picture: the
    strength step of this package against `other`'s, with each one's count
    of torch operations (on P pictures also with the colocated planes,
    ``strength_step_colocated``); and, as a control of the host's speed,
    the ``inter_chroma_tq`` wrapper, the same in both."""
    import importlib

    from h264_tpu_torch.kernels import inter_tq as K5

    res = {}
    steps = [("strength_step", False)]
    if kind == "P":
        steps.append(("strength_step_colocated", True))
    for key, col in steps:
        fa = strength_step("h264_tpu_torch", kind, frame, col)
        fb = strength_step(other.__name__, kind, frame, col)
        res[key] = {**ab_times(fa, fb), "ops_this": count_ops(fa),
                    "ops_ab": count_ops(fb)}
    theirs = importlib.import_module(
        f"{other.__name__}.kernels.inter_tq").inter_chroma_tq
    for a in [a for n, a in calls if n == "inter_chroma_tq"]:
        res["inter_chroma_tq"] = ab_times(lambda: K5.inter_chroma_tq(*a),
                                          lambda: theirs(*a))
    return res


def one_call_times(calls, reps: int = 20) -> dict:
    """Each ``ONE_CALL`` entry the picture's recorded `calls` make (K2 on
    the picture's filtered planes), one call: its device time queued
    behind a spin of the card, back to back (the median of 5 rounds, on
    the host's clock too), and an empty launch of each of its designs'
    grids."""
    import importlib

    from h264_tpu_torch.kernels import deblock as K6

    dbk = [a for n, a in calls if n == "deblock"][0]
    K6.deblock(*dbk)  # built and warm before its output is kept
    inputs = [*calls, ("ref_bank", K6.deblock(*dbk))]
    res = {}
    for name, mod in ONE_CALL.items():
        fn = getattr(importlib.import_module(
            f"h264_tpu_torch.kernels.{mod}"), name, None)
        for a in [a for n, a in inputs if n == name]:
            res[name] = {"device_ms": spin_ms(lambda: fn(*a), reps),
                         **back_to_back(lambda: fn(*a), reps),
                         "launches": 1}
            if name == "b_direct":
                nb = direct_sector_bytes(a)
                res[name]["sector_bytes"] = nb
                res[name]["sector_bound_ms"] = nb / HBM_BPS * 1e3
            res[name]["empty_launch_ms"] = {
                f"{b}x{t}": empty_launch_ms(b, t, reps)
                for b, t in GRIDS.get(name, lambda a: [])(a)}
    return res


def picture_times(calls, scan, reps: int = 20) -> dict:
    """The ``ONE_CALL`` entries one call each, K4 per shape and per
    picture, K6 and K1 of one recorded picture: on the device, and back to
    back (the median of 5 rounds, each round's beside it, on the host's
    clock too)."""
    from h264_tpu_torch.kernels import deblock as K6
    from h264_tpu_torch.kernels import intra_commit as K1
    from h264_tpu_torch.kernels import qpel as K4

    refine = [a for n, a in calls if n == "qpel_refine"]
    dbk = [a for n, a in calls if n == "deblock"][0]

    def all_refine():
        for a in refine:
            K4.qpel_refine(*a)

    shapes = [[a[11], a[12], int(a[2].numel()),
               spin_ms(lambda a=a: K4.qpel_refine(*a), reps)] for a in refine]
    k1 = copy_scan(scan)
    return {
        **one_call_times(calls, reps),
        "qpel_refine": {
            "shapes": shapes,  # [h, w, units, device ms] of each call
            "device_ms": sum(x[3] for x in shapes),
            "picture_device_ms": spin_ms(all_refine, reps),
            **back_to_back(all_refine, reps),
            "launches": len(refine)},
        "deblock": {"device_ms": spin_ms(lambda: K6.deblock(*dbk), reps),
                    **back_to_back(lambda: K6.deblock(*dbk), reps)},
        "intra_commit": {
            "device_ms": spin_ms(lambda: K1.intra_commit_scan(k1), reps),
            **back_to_back(lambda: K1.intra_commit_scan(k1), reps),
            "intra_mbs": int(scan.is_intra.sum()),
            "mbs": int(scan.is_intra.numel())}}


def deblock_case(W: int, H: int, seed: int = SEED):
    """Blocky W x H planes (flat 4x4 blocks a few levels apart, plus noise)
    and random strengths 0-4 (0 on the picture's edges), on the card."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    H4, W4 = H // 4, W // 4
    base = np.repeat(np.repeat(rng.randint(90, 130, (H4, W4)), 4, 0), 4, 1)
    y = base + rng.randint(-2, 3, (H, W))
    u, v = (np.repeat(np.repeat(rng.randint(110, 140, (H4, W4)), 2, 0), 2, 1)
            for _ in range(2))
    bsv, bsh = (rng.randint(0, 5, (H4, W4)) for _ in range(2))
    bsv[:, 0] = 0
    bsh[0, :] = 0
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                                 device="cuda")
                 for x in (y, u, v, bsv, bsh)) + (28, 28)


def deblock_chain(reps: int = 20) -> dict:
    """K6's chain on built inputs (``deblock_case``): a 16x16 picture (one
    MB with the launch and the memset); the step of an MB along a row of
    80 MBs in one block (1280x16, no waits) and down a column of 68 MBs,
    each waiting for the one above in another block (16x1088, a hand-over
    each); and CIF and 1280x720 pictures beside their chain.  Every path
    to a picture's last MB holds n_mx + n_my - 2 steps along a row and
    n_my - 1 hand-overs (MB (r, c) waits for (r, c-1) and (r-1, c+1)), so
    the chain is the 16x16 picture plus those steps."""
    from h264_tpu_torch.kernels import deblock as K6

    def ms(W, H):
        case = deblock_case(W, H)
        return spin_ms(lambda: K6.deblock(*case), reps)

    mb = ms(16, 16)
    row = (ms(1280, 16) - mb) / 79
    col = (ms(16, 1088) - mb) / 67
    pictures = {}
    for W, H in (CIF, HD):
        n_mx, n_my = W // 16, H // 16
        pictures[f"{W}x{H}"] = {
            "built_ms": ms(W, H),
            "chain_ms": mb + (n_mx + n_my - 2) * row + (n_my - 1) * col}
    return {"mb_ms": mb, "row_step_ms": row, "column_step_ms": col,
            "pictures": pictures}


def _trial_lib(name: str, sources: dict, entry: str, sig: str):
    """The C entry `entry` of a trial library built from `sources` (file
    name -> text) in build/.../trial."""
    import ctypes

    from h264_tpu_torch import device as D

    trial = D.BUILD_DIR / "trial"
    trial.mkdir(parents=True, exist_ok=True)
    for fname, text in sources.items():
        (trial / fname).write_text(text)
    so = trial / f"lib{name}_sm90a.so"
    main = next(f for f in sources if f.endswith(".cu"))
    subprocess.run([D._nvcc(), *D.NVCC_FLAGS, "-o", str(so),
                    str(trial / main)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = [D._CTYPES[c] for c in sig]
    fn.restype = ctypes.c_int
    return fn


def trial_no_fence(reps: int = 20) -> dict:
    """A trial: K6 built from copies of csrc/deblock.cu and common.cuh
    whose ``publish`` has no fence before the release, beside the kernel
    as it is, on the same built inputs (16x16, the 16x1088 column, the
    1280x16 row, CIF, 1280x720), each trial call held equal to the plain
    version.  Device ms per call, with and without the fence."""
    import ctypes

    import torch
    from h264_tpu_torch import device as D
    from h264_tpu_torch.kernels import deblock as K6

    fence = "    __threadfence();\n    st_release(p, v);"
    common = (D.CSRC / "common.cuh").read_text()
    if common.count(fence) != 1:
        raise RuntimeError("trial: publish's fence in common.cuh moved")
    fn = _trial_lib("deblock_nofence", {
        "deblock.cu": (D.CSRC / "deblock.cu").read_text(),
        "common.cuh": common.replace(fence, "    st_release(p, v);")},
        "deblock", "pppppiipppppp")

    def no_fence(y, u, v, bsv, bsh, qp, qp_c):
        H, W = y.shape
        thr = (ctypes.c_int * 12)(*K6._thresholds(qp), *K6._thresholds(qp_c))
        out = [torch.empty_like(x) for x in (y, u, v)]
        sync = torch.empty(H // 16 + 1, dtype=torch.int32, device=y.device)
        rc = fn(*(x.data_ptr() for x in (y, u, v, bsv, bsh)), H, W,
                ctypes.addressof(thr), *(x.data_ptr() for x in out),
                sync.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"trial deblock: CUDA error {rc}")
        return out

    res = {}
    for W, H in ((16, 16), (16, 1088), (1280, 16), CIF, HD):
        case = deblock_case(W, H)
        want = K6.deblock_plain(*case)
        if not all(torch.equal(g, w) for g, w in zip(no_fence(*case), want)):
            raise RuntimeError(f"trial deblock {W}x{H}: differs from plain")
        res[f"{W}x{H}"] = {
            "fence_ms": spin_ms(lambda: K6.deblock(*case), reps),
            "no_fence_ms": spin_ms(lambda: no_fence(*case), reps)}
    return res


def trial_coarse(reps: int = 20) -> dict:
    """A trial: K3 ``coarse_search`` built with strips of 8, 4 and 2 MBs a
    search block, with the decimation alone (the entry returning after
    its first launch), with that launch's grid doing no work (the floor
    of a launch), and with the search alone, beside the kernel as it is,
    on the bench configuration's second P picture at CIF and 1280x720;
    each strip variant held equal to the kernel.  Device ms per call."""
    import torch
    from h264_tpu_torch import device as D
    from h264_tpu_torch.kernels import search_grid as K3

    src = (D.CSRC / "search_grid.cu").read_text()
    common = (D.CSRC / "common.cuh").read_text()
    strip = "constexpr int kStrip = 4;"
    entry = "  const int n_mx = W / 16, n_strips"
    body = "  const int cell = blockIdx.x * kDecThreads + threadIdx.x"
    dec = "  decimate_kernel<<<"
    if any(src.count(x) != 1 for x in (strip, entry, body, dec)):
        raise RuntimeError("trial: coarse_search's source moved")
    texts = {f"strip{k}": src.replace(strip, f"constexpr int kStrip = {k};")
             for k in (8, 4, 2)}
    texts["decimate_only"] = src.replace(entry, "  if (NR > 0) return 0;\n"
                                         + entry)
    # the decimation's grid with no work in it, and the search alone (on
    # a plane left as it was)
    texts["launch_floor"] = texts["decimate_only"].replace(
        body, "  if (Hl > 0) return;\n" + body)
    texts["search_only"] = src.replace(dec, "  if (NR < 0)\n" + dec)
    fns = {n: _trial_lib(f"coarse_{n}", {f"coarse_{n}.cu": t,
                                         "common.cuh": common},
                         "coarse_search", "ppppiiiiiiipppp")
           for n, t in texts.items()}

    def call(fn, banks, cur_y, wp, lam):
        NR, _, Hp, Wp = banks.shape
        H, W = cur_y.shape
        cen = [torch.empty((NR, H // 16, W // 16), dtype=torch.int32,
                           device=banks.device) for _ in range(2)]
        plane = torch.empty((NR, (Hp + 128) // 4, (Wp + 128) // 4),
                            dtype=torch.int16, device=banks.device)
        w = (wp[0].data_ptr(), wp[1].data_ptr(), 1) if wp else (None, None, 0)
        rc = fn(banks.data_ptr(), cur_y.data_ptr(), *w, NR, Hp, Wp, H, W,
                int(lam), plane.data_ptr(), cen[0].data_ptr(),
                cen[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"trial coarse_search: CUDA error {rc}")
        return cen

    res = {}
    for size in (CIF, HD):
        calls, _ = record_bench(size)["P"][1]
        a = [x for n, x in calls if n == "coarse_search"][0]
        want = K3.coarse_search(*a)
        out = {"kernel_ms": spin_ms(lambda: K3.coarse_search(*a), reps)}
        for name, fn in fns.items():
            if name.startswith("strip"):
                got = call(fn, *a)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"trial {name} {size}: differs")
            out[f"{name}_ms"] = spin_ms(lambda fn=fn: call(fn, *a), reps)
        res[f"{size[0]}x{size[1]}"] = out
    return res


def device_ops(step) -> dict:
    """torch.profiler over one step: its device kernels by name, and its
    copies and memsets."""
    from h264_tpu_torch.tools.devprof import device_profile

    _, rep = device_profile(step, 10 ** 6)
    out = {"kernels": {}, "memcpy": 0, "memset": 0,
           "device_busy_ms": rep["device_busy_ms"]}
    for name, v in rep["kernels"].items():
        if name.startswith("Memcpy"):
            out["memcpy"] += v["count"]
        elif name.startswith("Memset"):
            out["memset"] += v["count"]
        else:
            out["kernels"][name] = v["count"]
    return out


def deblock_profile() -> dict:
    """The device operations of one CIF deblock call, and the deblock
    kernels of an I + P encode at CIF (the I picture filters on the
    host)."""
    import torch
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.kernels import deblock as K6
    from h264_tpu_torch.tools.synthseq import moving_frames

    case = deblock_case(*CIF)
    K6.deblock(*case)
    torch.cuda.synchronize()
    call = device_ops(lambda: K6.deblock(*case))
    cfg = EncoderConfig(width=CIF[0], height=CIF[1], qp=28, fast=True,
                        rd=True, entropy="cabac", b_frames=0,
                        num_ref_frames=5, search_range=28,
                        weighted_pred=True)
    frames = moving_frames(2, *CIF, seed=SEED)
    list(H264Encoder(cfg, device="cuda").encode_stream(frames))  # warm
    before = K6.deblock.launches
    enc = device_ops(lambda: list(H264Encoder(cfg, device="cuda")
                                  .encode_stream(frames)))
    return {"call": call,
            "ip_encode": {"deblock_calls": K6.deblock.launches - before,
                          "deblock_kernels": sum(
                              c for n, c in enc["kernels"].items()
                              if "deblock_kernel" in n),
                          "memcpy": enc["memcpy"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import h264_tpu_torch from this checkout")
    ap.add_argument("--out", help="directory for the JSON report")
    ap.add_argument("--tag", default="", help="suffix of the report's name")
    ap.add_argument("--ab", help="also time the strength step of this "
                    "checkout in turns with this one's")
    ap.add_argument("--trial", action="store_true",
                    help="also time K6 without the fence before each "
                    "release, and K3 with other strips and its decimation "
                    "alone")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import h264_tpu_torch
    from h264_tpu_torch import device as D

    t0 = time.perf_counter()
    card = power_line()
    print(card)
    D.build_cuda(STEMS)
    for stem in ("ref_bank", "search_grid", "qpel", "inter_tq", "deblock",
                 "b_direct"):
        for ln in D.build_log.get(stem, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"  ptxas {stem}: {ln.strip()}")
    report = {"package": str(pathlib.Path(h264_tpu_torch.__file__).parent),
              "device": torch.cuda.get_device_name(0), "card": card}
    other = load_ab(args.ab) if args.ab else None
    for size in (CIF, HD):
        pics = record_bench(size)
        report[f"{size[0]}x{size[1]}"] = {
            kind: picture_times(*pics[kind][1]) for kind in ("P", "B")}
        if other is not None:
            report.setdefault("ab", {"package": str(pathlib.Path(
                other.__file__).parent)})[f"{size[0]}x{size[1]}"] = {
                kind: picture_ab(pics[kind][1][0], kind,
                                 pics["frames"][kind][1], other)
                for kind in ("P", "B")}
    report["deblock_chain"] = deblock_chain()
    report["deblock_profile"] = deblock_profile()
    if args.trial:
        report["trial_no_fence"] = trial_no_fence()
        report["trial_coarse"] = trial_coarse()
    report["seconds"] = time.perf_counter() - t0
    line = json.dumps(report)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        name = "time_kernels" + (f"-{args.tag}" if args.tag else "")
        (out / f"{name}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
