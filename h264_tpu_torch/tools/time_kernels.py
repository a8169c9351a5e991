"""The main path's kernel entries on its inputs, on one CUDA card: one
call a picture of each entry beside an empty launch of its grid, K4 per
shape and per picture, K6's chain and launch profile, and K1 on P and B
pictures.  ``chip_smoke.py`` times with the same functions.

    python -m h264_tpu_torch.tools.time_kernels [--out DIR] [--only t8,drift]
    python h264_tpu_torch/tools/time_kernels.py --root DIR [--out DIR]
    python -m h264_tpu_torch.tools.time_kernels --ab DIR [--out DIR]

Encodes the bench configuration (IPB, one B picture between anchors, QP
28, 5 references, search range 28, explicit WP; ``moving_frames``, 5
frames) at CIF and 1280x720 with every P and B kernel entry recorded, and
times on the second P and the second B picture's inputs:
- every ``ONE_CALL`` entry the picture calls (K3 ``coarse_search`` and
  ``sub8_search``, K5 ``inter_luma_tq``, ``inter_chroma_tq`` and
  ``i16_candidate``, K7 ``b_direct``, K2 ``ref_bank`` on the picture's
  filtered planes, K6 ``strengths``, K4 ``mc_luma``, ``mc_chroma``,
  ``mc_luma_win`` and ``mc_chroma_b``), one call: its device time
  queued behind a spin of the card (the host's launch time excluded),
  back to back (CUDA events and the host's clock; the median of 5
  rounds), and an empty kernel launched on the grid of each of its
  designs (``empty_launch_ms``: the floor of a launch of that grid);
- each ``qpel_refine`` call (one shape each) on the device, and the
  picture's calls on the device and back to back;
- the ``deblock`` call, the same two ways;
- K1 ``intra_commit_scan`` on the picture's scan state (its intra MBs);
- the SASS of K5's, K9's, K10's, K11's, K12's and K13's kernels
  (``sass_report``):
  each kernel's instructions, its ``__dp4a`` and each loop body's;
- on the legacy path's second P picture (``rd=False``, IPPP, CAVLC, QP
  28, search range 28), K12 ``p16_search`` and K13 ``p16_refine`` one
  call each the same ways, beside an empty launch of each of their
  designs' grids (``legacy_P``);
- K10 ``sad_grid_16x16`` one call the same ways at search range 16 on a
  seeded ``moving_frames`` pair, the reference edge-padded as
  ``me.compute_sad_grids`` pads it (``sad_grid``; the host path's own
  calls come one an MB loop of a picture, too slow to record at 720p);
- K9 ``t8_decide`` on the second P picture of the bench configuration
  with the 8x8 transform (IPB-T8, ``t8_P``) and K11 ``propagate_drift`` on
  the second P picture of the error-resilient one (IPB-ER: 30 decoders,
  10 % loss, 22 refreshed MBs; ``er_P``), one call each the same ways,
  beside an empty launch of each of their designs' grids; at 1280x720
  also K11 on the built ``large`` and ``wrap`` inputs of
  ``tools/drift_cases.py`` at K 30 (``drift_large``, ``drift_wrap``: every
  MB on its ordered route);
- each kernel's registers, stack frame, shared and local (spill) bytes
  (``cuobjdump -res-usage``, ``res_usage``) beside its SASS;
- for ``b_direct``, the distinct 32-byte sectors its gathers touch
  (``sector_bytes``, with the fields and outputs, and their time at
  3.35 TB/s, ``sector_bound_ms``): the least traffic of its reads at the
  memory's granularity, where the byte bound counts only the samples.
Then K6's chain on built inputs: a 16x16 picture, an MB's step along a
row (1280x16) and down a column (16x1088), CIF and 1280x720 pictures
beside their chain (``deblock_chain``); and ``torch.profiler`` over one
``deblock`` call and over an I + P encode: the device kernels, copies and
memsets each makes.

With ``--root`` the package is imported from the checkout DIR, so that
an earlier version of the kernels is timed by the same script in the
same call on the same card. ``--only`` picks parts of the report
(``bench``, ``legacy``, ``sad``, ``t8``, ``drift``, ``deblock``). With
``--ab DIR`` the package of the
checkout DIR is imported beside this one (as ``h264_tpu_torch_ab``), and
on the same recorded P pictures both packages' sub-8x8 search step
(``sub8_step``: from the units' centres to the winners each refinement
launch takes; both checkouts need the ``sub8_search`` entry) and, as a control, both ``inter_chroma_tq`` wrappers run
back to back in turns, 15 rounds a b b a ... (``ab``), with each step's
count of torch operations and its device kernels by ``torch.profiler``:
the host's speed wanders between processes and over seconds, so only
calls taken in turns in one process compare their host time. Prints the
card's name and power limit and one JSON object (also written to
DIR/time_kernels[-TAG].json with ``--out``). Needs a CUDA card.
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
         "deblock", "b_direct", "p16_search", "p16_refine", "sad_grid", "t8",
         "propagate_drift")
# the parts of the report ``--only`` may pick
SECTIONS = ("bench", "legacy", "sad", "t8", "drift", "deblock")


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


def bench_cfg(size, **kw):
    """The bench configuration (IPB, QP 28, 5 references, search range 28,
    explicit WP) at `size`, with the options `kw`."""
    from h264_tpu_torch.encoder.encoder import EncoderConfig

    return EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                         rd=True, entropy="cabac", b_frames=1,
                         num_ref_frames=5, search_range=28,
                         weighted_pred=True, **kw)


def record_bench(size):
    """The bench configuration's recorded P and B pictures, in coding
    order: {"P": [(calls, scan)], "B": [...]}, each picture's entry calls
    and a copy of its K1 scan state taken before the scan."""
    import torch
    from h264_tpu_torch.encoder import rd_b, rd_p
    from h264_tpu_torch.encoder.encoder import H264Encoder
    from h264_tpu_torch.tools.synthseq import moving_frames

    enc = H264Encoder(bench_cfg(size), device="cuda")
    scans = {"P": [], "B": []}
    pk, pcalls = rd_p.recording(rd_p.default_kernels())
    bk, bcalls = rd_b.recording(rd_b.default_kernels())
    enc._p_kernels = scan_recording(pk, scans["P"])
    enc._b_kernels = scan_recording(bk, scans["B"])
    list(enc.encode_stream(moving_frames(5, *size, seed=SEED)))
    torch.cuda.synchronize()
    return {kind: list(zip(by_picture(calls), scans[kind]))
            for kind, calls in (("P", pcalls), ("B", bcalls))}


def _i16_grid(n_mb: int):
    """(blocks, threads) of i16_candidate: a warp an MB, as many a block
    (2 to 4) as leave a block for each of an H100's 132 SMs."""
    per = max(2, min(4, n_mb // 132))
    return (n_mb + per - 1) // per, 32 * per


def _p16_threads(R: int) -> int:
    """p16_search's threads a block: a tile of 4 x 8 cells each, whole
    warps."""
    D = 2 * R + 1
    return 32 * _cdiv(_cdiv(D, 4) * _cdiv(D, 8), 32)


def record_legacy(size):
    """The legacy path's (``rd=False``: IPPP, CAVLC, QP 28, search range
    28; ``moving_frames``, 4 frames) ``p16_search`` and ``p16_refine``
    calls, one each a P picture, in coding order: {name: [args, ...]}."""
    import torch
    from h264_tpu_torch.encoder import fast
    from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
    from h264_tpu_torch.tools.synthseq import moving_frames

    cfg = EncoderConfig(width=size[0], height=size[1], qp=28, fast=True,
                        rd=False, entropy="cavlc", search_range=28)
    enc = H264Encoder(cfg, device="cuda")
    enc._legacy_kernels, calls = fast.recording(fast.default_kernels())
    list(enc.encode_stream(moving_frames(4, *size, seed=SEED)))
    torch.cuda.synchronize()
    return {name: [a for n, a in calls if n == name]
            for name in ("p16_search", "p16_refine")}


def record_t8(size):
    """K9 ``t8_decide``'s calls on the bench configuration with the 8x8
    transform (IPB-T8; ``moving_frames``, 5 frames), one a P picture, in
    coding order."""
    import torch
    from h264_tpu_torch.encoder import rd_p
    from h264_tpu_torch.encoder.encoder import H264Encoder
    from h264_tpu_torch.tools.synthseq import moving_frames

    enc = H264Encoder(bench_cfg(size, transform8x8=True), device="cuda")
    enc._p_kernels, calls = rd_p.recording(rd_p.default_kernels())
    list(enc.encode_stream(moving_frames(5, *size, seed=SEED)))
    torch.cuda.synchronize()
    return [a for n, a in calls if n == "t8_decide"]


# the error-resilient bench configuration (chip_smoke.ER): 30 simulated
# decoders, 10 % loss, 22 refreshed MBs a picture
ER = dict(loss_aware_k=30, loss_rate=0.1, intra_refresh=22)


def record_drift(size):
    """K11 ``propagate_drift``'s calls on the error-resilient bench
    configuration (IPB-ER; ``moving_frames``, 5 frames), one a P picture,
    in coding order."""
    import torch
    from h264_tpu_torch.encoder.encoder import H264Encoder
    from h264_tpu_torch.kernels import propagate_drift as K11
    from h264_tpu_torch.tools.synthseq import moving_frames

    calls = []

    class Recording(H264Encoder):
        @staticmethod
        def _propagate_drift(*a):
            calls.append(a)
            return K11.propagate_drift(*a)

    list(Recording(bench_cfg(size, **ER), device="cuda").encode_stream(
        moving_frames(5, *size, seed=SEED)))
    torch.cuda.synchronize()
    return calls


def drift_built(name: str, size, K: int = 30):
    """K11's arguments on the built case `name` of tools/drift_cases.py."""
    import torch
    from h264_tpu_torch.tools.drift_cases import built_case

    return tuple(torch.as_tensor(a, device="cuda")
                 for a in built_case(name, size[1], size[0], K, seed=SEED))


def sad_case(size, R: int = 16):
    """K10's arguments on a seeded ``moving_frames`` pair: the second
    picture's luma against the first's, edge-padded by R on the host as
    ``me.compute_sad_grids`` pads it."""
    import numpy as np
    import torch
    from h264_tpu_torch.tools.synthseq import moving_frames

    fr = moving_frames(2, *size, seed=SEED)
    ref = np.pad(np.asarray(fr[0][0], np.int32), R, mode="edge")
    return (torch.as_tensor(np.asarray(fr[1][0], np.int32), device="cuda"),
            torch.as_tensor(ref, device="cuda"), R)


def one_entry_times(name: str, fn, args, reps: int = 20) -> dict:
    """One call of the entry `fn` (``GRIDS[name]`` its grids): its device
    time queued behind a spin, back to back, and an empty launch of each
    of its designs' grids."""

    def call():
        return fn(*args)

    return {"device_ms": spin_ms(call, reps), **back_to_back(call, reps),
            "launches": 1, "empty_launch_ms": {
                f"{b}x{t}": empty_launch_ms(b, t, reps)
                for b, t in GRIDS[name](args)}}


def _grid(warps: int):
    """(blocks, threads) of `warps` warps, as many a block (up to 4) as
    leave a block for each of an H100's 132 SMs."""
    per = max(1, min(4, warps // 132))
    return (warps + per - 1) // per, 32 * per


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _p16_refine_grids(a):
    """p16_refine's grid (a warp an MB, 2 to 4 MBs a block as leave a
    block for each SM), then the first design's (256 threads an MB)."""
    n_mb = a[0].numel() // 256
    return [_i16_grid(n_mb), (n_mb, 256)]


def _local_module(name: str):
    """This checkout's ``kernels/<name>.py`` loaded by path (under
    ``--root`` the package imported is another checkout's)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "kernels"
    spec = importlib.util.spec_from_file_location(name, path / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t8_grids(a):
    """t8_decide's grid (a warp an MB, 1 to 4 MBs a block as leave a block
    for each SM), then the first design's (256 threads an MB)."""
    n_mb = a[0].shape[0]
    return [_local_module("t8_geometry").grid(n_mb), (n_mb, 256)]


def _sad_grids(a):
    """sad_grid_16x16's grid (blocks of 128 threads: runs of 8 MBs of a row
    by strips of at most 16 quads by groups of 16 tiles of 4 dx x 3 dy),
    then the first design's (an MB by tiles of up to 256 positions, a
    thread a position)."""
    geo = _local_module("sad_geometry")
    H, W = a[0].shape
    D = 2 * a[2] + 1
    x, y, z = geo.geometry(a[2]).blocks(H, W)
    dxt = min(D, 256)
    dyt = min(256 // dxt, D)
    return [(x * y * z, 32 * geo.WARPS),
            (H // 16 * (W // 16) * _cdiv(D, dyt) * _cdiv(D, dxt), 256)]


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
    "i16_candidate": lambda a: [_i16_grid(a[0].numel() // 256),
                                (a[0].numel() // 256, 64)],
    "p16_search": lambda a: [(a[0].numel() // 256, _p16_threads(a[2])),
                             (a[0].numel() // 256, 256)],
    "p16_refine": _p16_refine_grids,
    "sad_grid_16x16": _sad_grids,
    "sub8_search": lambda a: [(a[2].numel() // 2, 128)],
    "t8_decide": _t8_grids,
    "propagate_drift": lambda a: [
        (a[0].shape[1] // 16 * (a[0].shape[2] // 16), 256)],
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
            "sub8_search": "search_grid", "i16_candidate": "inter_tq",
            "mc_luma_win": "qpel",
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
    return _empty_lib_build()


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


# the partitions' winners as the three refinement launches take them:
# (first partition, count) of the 8x4, 4x8 and 4x4 shapes
_SUB8_SHAPES = ((0, 2), (2, 2), (4, 4))


def sub8_step(pkg: str, args):
    """The sub-8x8 search step of package `pkg` on one recorded
    ``sub8_search`` call's inputs, from the centres to the winners'
    (mvx, mvy) vectors of each shape that its refinement launches take:
    the one call and six views of its output."""
    import importlib

    K3 = importlib.import_module(f"{pkg}.kernels.search_grid")

    def step():
        mv = K3.sub8_search(*args)
        return [mv[c, p0:p0 + n].reshape(-1)
                for p0, n in _SUB8_SHAPES for c in (0, 1)]
    return step


def picture_ab(calls, other) -> dict:
    """In turns in one process (``ab_times``) on one recorded P picture:
    the sub-8x8 search step of this package against `other`'s, held
    equal, with each one's count of torch operations and its device
    kernels by ``torch.profiler``; and, as a control of the host's speed,
    the ``inter_chroma_tq`` wrapper, the same in both."""
    import importlib

    import torch
    from h264_tpu_torch.kernels import inter_tq as K5
    from h264_tpu_torch.tools.devprof import device_profile

    res = {}
    for a in [a for n, a in calls if n == "sub8_search"]:
        fa = sub8_step("h264_tpu_torch", a)
        fb = sub8_step(other.__name__, a)
        if not all(torch.equal(x, y) for x, y in zip(fa(), fb())):
            raise RuntimeError("sub8 step: the two packages differ")
        res["sub8_step"] = {
            **ab_times(fa, fb), "ops_this": count_ops(fa),
            "ops_ab": count_ops(fb), "profile_this": device_profile(fa, 20)[1],
            "profile_ab": device_profile(fb, 20)[1]}
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


def _empty_lib_build():
    """The C entry ``empty_launch`` of EMPTY_CU, built with the package's
    nvcc flags into build/.../empty."""
    import ctypes

    from h264_tpu_torch import device as D

    out = D.BUILD_DIR / "empty"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_CU)
    so = out / "libempty_sm90a.so"
    subprocess.run([D._nvcc(), *D.NVCC_FLAGS, "-o", str(so),
                    str(out / "empty.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).empty_launch
    fn.argtypes = [D._CTYPES[c] for c in "iip"]
    fn.restype = ctypes.c_int
    return fn


def sass_report(stems) -> dict:
    """Per kernel of the built libraries of `stems` (``cuobjdump -sass``):
    its SASS instructions, how many of them are ``IDP`` (``__dp4a``), and
    each loop's body (a backward branch's span): {stem: {kernel: {"n",
    "idp", "loops": [[instructions, idp], ...]}}}."""
    import re

    from h264_tpu_torch import device as D

    tool = pathlib.Path(D._nvcc()).with_name("cuobjdump")
    out = {}
    for stem in stems:
        text = subprocess.run([str(tool), "-sass", str(D._cuda_so(stem))],
                              capture_output=True, text=True).stdout
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            name = part.split("\n", 1)[0].strip()
            ins = [(int(a, 16), op) for a, op in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
            loops = []
            for a, op in ins:
                t = re.search(r"BRA\b.*?0x([0-9a-f]+)", op)
                if t and int(t.group(1), 16) < a:
                    body = [o for b, o in ins if int(t.group(1), 16) <= b <= a]
                    loops.append([len(body), sum("IDP" in o for o in body)])
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)  # mangled length
            short = (name[m.end():m.end() + int(m.group(1))] if m
                     else name)
            out.setdefault(stem, {})[short] = {
                "n": len(ins), "idp": sum("IDP" in o for _, o in ins),
                "loops": loops}
    return out


def res_usage(stems) -> dict:
    """Per kernel of the built libraries of `stems` (``cuobjdump
    -res-usage``): its registers, stack frame, shared and local bytes
    (local memory is where spills go): {stem: {kernel: {"REG", "STACK",
    "SHARED", "LOCAL"}}}."""
    import re

    from h264_tpu_torch import device as D

    tool = pathlib.Path(D._nvcc()).with_name("cuobjdump")
    out = {}
    for stem in stems:
        text = subprocess.run([str(tool), "-res-usage",
                               str(D._cuda_so(stem))],
                              capture_output=True, text=True).stdout
        for name, use in re.findall(r"Function ([^:\s]+):\s*\n\s*(.*)",
                                    text):
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)  # mangled length
            short = (name[m.end():m.end() + int(m.group(1))] if m
                     else name)
            out.setdefault(stem, {})[short] = {
                k: int(v) for k, v in re.findall(r"(\w+):(\d+)", use)
                if k in ("REG", "STACK", "SHARED", "LOCAL")}
    return out


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
    ap.add_argument("--ab", help="also time the sub-8x8 search step of "
                    "this checkout in turns with this one's")
    ap.add_argument("--only", help="comma-separated parts of the report "
                    f"(of {', '.join(SECTIONS)}; default all)")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(SECTIONS)
    if only - set(SECTIONS):
        ap.error(f"--only: unknown parts {sorted(only - set(SECTIONS))}")
    if args.root:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import h264_tpu_torch
    from h264_tpu_torch import device as D
    from h264_tpu_torch.kernels import p16 as P16
    from h264_tpu_torch.kernels import propagate_drift as K11
    from h264_tpu_torch.kernels import sad_grid as K10
    from h264_tpu_torch.kernels import t8 as K9

    t0 = time.perf_counter()
    card = power_line()
    print(card)
    D.build_cuda(STEMS)
    for stem in STEMS[1:]:
        for ln in D.build_log.get(stem, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"  ptxas {stem}: {ln.strip()}")
    sass_stems = ("inter_tq", "p16_search", "p16_refine", "sad_grid", "t8",
                  "propagate_drift")
    report = {"package": str(pathlib.Path(h264_tpu_torch.__file__).parent),
              "device": torch.cuda.get_device_name(0), "card": card,
              "sections": sorted(only), "sass": sass_report(sass_stems),
              "res_usage": res_usage(sass_stems)}
    for stem, kernels in report["sass"].items():
        for name, v in kernels.items():
            print(f"  sass {stem} {name}: {v['n']} instructions, {v['idp']} "
                  f"IDP, loops (instructions, IDP) {v['loops']}; "
                  f"{report['res_usage'].get(stem, {}).get(name)}")
    other = load_ab(args.ab) if args.ab else None
    for size in (CIF, HD):
        at = report.setdefault(f"{size[0]}x{size[1]}", {})
        if "bench" in only:
            pics = record_bench(size)
            at.update({kind: picture_times(*pics[kind][1])
                       for kind in ("P", "B")})
            if other is not None:
                report.setdefault("ab", {"package": str(pathlib.Path(
                    other.__file__).parent)})[f"{size[0]}x{size[1]}"] = {
                    "P": picture_ab(pics["P"][1][0], other)}
        if "legacy" in only:  # the legacy path's second P picture
            legacy = record_legacy(size)
            at["legacy_P"] = {
                name: one_entry_times(name, getattr(P16, name),
                                      legacy[name][1])
                for name in ("p16_search", "p16_refine")}
        if "sad" in only:
            at["sad_grid"] = {"sad_grid_16x16": one_entry_times(
                "sad_grid_16x16", K10.sad_grid_16x16, sad_case(size))}
        if "t8" in only:  # IPB-T8's second P picture
            at["t8_P"] = {"t8_decide": one_entry_times(
                "t8_decide", K9.t8_decide, record_t8(size)[1])}
        if "drift" in only:  # IPB-ER's second P picture; built inputs
            at["er_P"] = {"propagate_drift": one_entry_times(
                "propagate_drift", K11.propagate_drift,
                record_drift(size)[1])}
            if size == HD:
                for case in ("large", "wrap"):
                    at[f"drift_{case}"] = {"propagate_drift": one_entry_times(
                        "propagate_drift", K11.propagate_drift,
                        drift_built(case, size))}
        torch.cuda.empty_cache()
    if "deblock" in only:
        report["deblock_chain"] = deblock_chain()
        report["deblock_profile"] = deblock_profile()
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
