"""The sharded tile-row P pipelines over a (frame, row) mesh of ranks: the
port of the reference's ``rd_gop_rows_sharded`` and ``rd_p_rows_sharded``
(``encoder/rd.py:2603``, ``:2705``; a ``shard_map`` each).

Each rank runs the reference's ``local_step`` for its shard (SPMD): its
frames are those of its frame shard, its tile rows those of its row
shard.  A tile row is a slice of its own (``rd_rows``), so a group needs
nothing of the others but the reference rows of its slab.

``rd_gop_rows_sharded``: each frame shard codes closed GOPs of S P
pictures, one tile row per row shard.  Before each picture every shard
exchanges its recon's border rows with its row neighbours
(``halo.exchange``, for Y, U and V) and builds its slab's reference bank
from them (K2 ``ref_bank_rows``); the picture's group then runs the P
stages on that bank.  ``rd_p_rows_sharded``: one P picture per frame, the
row groups spread over the row shards, each taking its slab of the whole
(replicated) banks.

As the reference calls ``rd_p_pipeline`` with its defaults there, each
group runs without the coarse stage (``use_cme=False``; the port's own
pipeline defaults to it on), with ``lam_me = lam``, one reference, no WP
and no 8x8 transform, and makes no next-reference entry of its own
(``p_outputs`` is not called: the reference's XLA drops that unused K2).

Both return a function of the inputs, as the reference does, which starts
the ranks (``mesh.launch``), gathers their outputs by frame and row and
keeps each rank's launch counts and step, exchange and bank times in its
``ranks`` attribute.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..device import build_cuda
from ..encoder import rd as RD
from ..encoder import rd_p as RDP
from ..encoder import rd_rows as RDR
from ..encoder.rd import PAD
from ..kernels import ref_bank as K2
from . import halo
from .mesh import Mesh, Rank, launch


# the kernel sources of a sharded group's entries (csrc/<stem>.cu)
STEMS = ("intra_commit", "ref_bank", "search_grid", "qpel", "inter_tq",
         "deblock")


def _launch(mesh: Mesh, fn, *args) -> list:
    """mesh.launch, after building the group's kernels here when the
    ranks run on cards, so that each rank only loads them."""
    if mesh.device != "cpu":
        build_cuda(STEMS)
    return launch(mesh, fn, *args)


def _counters(k: RDP.PKernels) -> dict:
    """The launch-counted wrappers of a sharded group, by name."""
    return {**{n: getattr(k, n) for n in RDP.P_ENTRIES},
            "intra_commit": k.intra_scan, "ref_bank_rows": K2.ref_bank_rows}


def _group(cy, cu, cv, bank, cpad, Hg, W, R, qp, qp_c, lam, k, dev):
    """One tile row (host planes) on its bank slab (NR, 4, ., .), with
    lam_me = lam: (host_out, (Y, U, V) recon)."""
    f = RDR.code_row(*(RD._to_i32(p, dev) for p in (cy, cu, cv)), bank, cpad,
                     Hg, W, R, qp, qp_c, lam, lam, bank.shape[0], k)
    return RDP.p_host_out(f), (f.dy, f.du, f.dv)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _rank_info(ctx: Rank, counters: dict, times: dict,
               t_enter: float) -> dict:
    """What a rank reports beside its outputs: its coordinates, its
    launches, its times (ms; and the wall clock, s since the epoch, when
    it began and ended its work, against which the caller times the
    ranks' start and exit) and the modules of JAX or of the JAX package
    it holds (none)."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib") or (
                         m.startswith("h264_tpu")
                         and m.split(".")[0] != "h264_tpu_torch"))
    return {"rank": ctx.rank, "frame": ctx.f, "row": ctx.r,
            "device": str(ctx.device),
            "launches": {n: fn.launches for n, fn in counters.items()},
            "foreign_modules": foreign, "t_enter": t_enter,
            "t_exit": time.time(), **times}


def _p_rows_rank(ctx: Rank, cy, cu, cv, banks, cpads, Hg, W, R, qp, qp_c,
                 lam):
    """local_step of rd_p_rows_sharded (rd.py:2721-2742) on one rank."""
    t_enter = time.time()
    k = RDP.default_kernels()
    counters = _counters(k)
    for fn in counters.values():
        fn.launches = 0
    F, G = cy.shape[:2]
    Fl, Gl = F // ctx.mesh.n_frame, G // ctx.mesh.n_row
    out, step_ms = {}, []
    for f in range(ctx.f * Fl, (ctx.f + 1) * Fl):
        slabs, cslabs = RDR.row_slabs(
            *(torch.as_tensor(x[f]).to(ctx.device) for x in (banks, cpads)),
            G * Hg, G)
        for g in range(ctx.r * Gl, (ctx.r + 1) * Gl):
            t0 = time.perf_counter()
            ho, rec = _group(cy[f, g], cu[f, g], cv[f, g], slabs[g],
                             cslabs[g], Hg, W, R, qp, qp_c, lam, k,
                             ctx.device)
            ctx.sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out[f, g] = (_host(ho), tuple(_host(x) for x in rec))
    return out, _rank_info(ctx, counters, {"step_ms": step_ms}, t_enter)


def rd_p_rows_sharded(mesh: Mesh, H: int, W: int, R: int, qp: int,
                      qp_c: int, lam: int, G: int):
    """The tile-row step over a (frame, row) mesh (rd.py:2705).

    Returns fn(cur_y (F, G, Hg, W) or (F, H, W) uint8, cur_u, cur_v,
    banks (F, NR, 4, H+64, W+64), cpads (F, NR, 2, H/2+64, W/2+64) int32)
    -> (host_outs (F, G, L), recons (Y (F, G, Hg, W), U, V (F, G, Hg/2,
    W/2))), numpy.  Frames shard over `frame`, the G row groups over
    `row`; every rank of a frame shard holds its frames' whole banks."""
    RDR.check_rows(H, G)
    if G % mesh.n_row:
        raise ValueError(f"{G} row groups do not spread over {mesh.n_row} "
                         "row shards")
    Hg = H // G

    def run(cur_y, cur_u, cur_v, banks, cpads):
        F = len(cur_y)
        if F % mesh.n_frame:
            raise ValueError(f"{F} frames over {mesh.n_frame} frame shards")
        cur = [np.asarray(c).reshape(F, G, -1, np.shape(c)[-1])
               for c in (cur_y, cur_u, cur_v)]
        res = _launch(mesh, _p_rows_rank, *cur, np.asarray(banks),
                     np.asarray(cpads), Hg, W, R, qp, qp_c, lam)
        parts = {key: v for out, _ in res for key, v in out.items()}
        host_outs = np.stack([np.stack([parts[f, g][0] for g in range(G)])
                              for f in range(F)])
        recons = tuple(np.stack([np.stack([parts[f, g][1][i]
                                           for g in range(G)])
                                 for f in range(F)]) for i in range(3))
        run.ranks = [info for _, info in res]
        return host_outs, recons

    run.ranks = []
    return run


def _gop_rank(ctx: Rank, cy, cu, cv, y0, u0, v0, S, Hg, W, R, qp, qp_c,
              lam, keep_slabs):
    """local_step of rd_gop_rows_sharded (rd.py:2655-2690) on one rank:
    its GOPs, picture after picture, one tile row."""
    t_enter = time.time()
    k = RDP.default_kernels()
    counters = _counters(k)
    for fn in counters.values():
        fn.launches = 0
    F = len(cy)
    Fl = F // ctx.mesh.n_frame
    out = {}
    times = {"step_ms": [], "exchange_ms": [], "bank_ms": []}
    for f in range(ctx.f * Fl, (ctx.f + 1) * Fl):
        Y, U, V = (RD._to_i32(p[f, ctx.r], ctx.device) for p in (y0, u0, v0))
        for s in range(S):
            t0 = time.perf_counter()
            ext = [halo.exchange(ctx, p, PAD, h)
                   for p, h in ((Y, Hg), (U, Hg // 2), (V, Hg // 2))]
            ctx.sync()
            t1 = time.perf_counter()
            bank, cpad = K2.ref_bank_rows(*ext)
            ctx.sync()
            t2 = time.perf_counter()
            ho, (Y, U, V) = _group(cy[f, s, ctx.r], cu[f, s, ctx.r],
                                   cv[f, s, ctx.r], bank[None], cpad[None],
                                   Hg, W, R, qp, qp_c, lam, k, ctx.device)
            ctx.sync()
            t3 = time.perf_counter()
            times["step_ms"].append((t3 - t0) * 1e3)
            times["exchange_ms"].append((t1 - t0) * 1e3)
            times["bank_ms"].append((t2 - t1) * 1e3)
            out[f, s, ctx.r] = (_host(ho), _host(Y), _host(U), _host(V),
                                tuple(map(_host, ext)) if keep_slabs
                                else None)
    return out, _rank_info(ctx, counters, times, t_enter)


def rd_gop_rows_sharded(mesh: Mesh, S: int, H: int, W: int, R: int, qp: int,
                        qp_c: int, lam: int, keep_slabs: bool = False):
    """The chained-GOP tile-row encoder over a (frame, row) mesh
    (rd.py:2603): GOPs over `frame`, one tile row per `row` shard (G =
    n_row), S P pictures per GOP, each shard's reference rebuilt from
    exchanged halos.

    Returns fn(cy (F, S, G, Hg, W) uint8, cu, cv (F, S, G, Hg/2, W/2), y0
    (F, G, Hg, W) int32, u0, v0 (F, G, Hg/2, W/2)) -> (host_outs (F, S, G,
    L), (recon_y (F, S, G, Hg, W), recon_u, recon_v (F, S, G, Hg/2,
    W/2))), numpy; y0 / u0 / v0 are each GOP's initial reference (the I
    picture's recon), row-sharded like the pictures.  (The reference
    returns recon_y alone.)  Byte-exact against the single-device
    ``rd_p_rows_pipeline`` chain while the halo covers the search: R + 7
    <= Hg and R / 2 + 6 <= Hg / 2, which it requires (ValueError).
    With `keep_slabs` the function's ``slabs`` attribute maps (f, s, r)
    to the (extY, extU, extV) that rank's bank was built from (for holding
    K2 against its plain version)."""
    G = mesh.n_row
    RDR.check_rows(H, G)
    Hg = H // G
    if not (R + 7 <= Hg and R // 2 + 6 <= Hg // 2):
        raise ValueError(f"the halo of {Hg}-line tile rows does not cover "
                         f"search range {R} (R + 7 <= Hg and R // 2 + 6 <= "
                         "Hg // 2)")

    def run(cy, cu, cv, y0, u0, v0):
        F = len(cy)
        if F % mesh.n_frame:
            raise ValueError(f"{F} GOPs over {mesh.n_frame} frame shards")
        res = _launch(mesh, _gop_rank, *(np.asarray(x) for x in
                                        (cy, cu, cv, y0, u0, v0)),
                     S, Hg, W, R, qp, qp_c, lam, keep_slabs)
        parts = {key: v for out, _ in res for key, v in out.items()}

        def gather(i):
            return np.stack([np.stack([np.stack([parts[f, s, r][i]
                                                 for r in range(G)])
                                       for s in range(S)])
                             for f in range(F)])

        host_outs = gather(0)
        run.ranks = [info for _, info in res]
        run.slabs = {key: v[4] for key, v in parts.items() if keep_slabs}
        return host_outs, (gather(1), gather(2), gather(3))

    run.ranks, run.slabs = [], {}
    return run
