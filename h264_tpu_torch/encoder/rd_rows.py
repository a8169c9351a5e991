"""Tile-row slices of a P picture: the port of the reference package's
``_row_slabs`` and ``rd_p_rows_pipeline`` (encoder/rd.py:2550-2600).

Each group of MB rows is coded as a slice of its own with
disable_deblocking_filter_idc = 2, which makes the groups independent
given the reference banks: intra prediction, PMV and skip, and the
in-loop filter all stop at the group's edges when the group is coded as
a sub-picture of height Hg = H / G.  A group reads only its slab of each
bank, rows [g Hg, g Hg + Hg + 2 PAD): the search range and the
interpolation taps stay inside the PAD margin.

The reference ``vmap``s ``rd_p_pipeline`` over the groups, without the
coarse stage (``use_cme`` off: zero search centres, unwidened banks), the
weighted prediction and the 8x8-transform decision.  Here the groups run
one after another through the same kernel entries (``rd_p.PKernels``),
each on a contiguous copy of its slab; then the recon is reassembled and
the next reference entry is made over the whole picture (K2), because
its half-pel planes cross the group edges.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rd as RD
from . import rd_p as RDP
from .rd import PAD


# int32 per MB of each of the 14 parts of a P picture's host_out (win, ref8,
# sub, t8, mv4x, mv4y, i16mode, cip, lev, lev8, lum_dc, levc, dcc, ipm)
P_PARTS = (1, 4, 4, 1, 16, 16, 1, 1, 256, 256, 16, 128, 8, 16)


def merge_host_out(rows: np.ndarray) -> np.ndarray:
    """The (G, L_g) host buffers of G tile rows -> the picture's flat
    buffer in the one-slice layout: each part the groups' parts in group
    order (a group's ipm is its (4 Hg, 4 W) rows of the picture's plane).
    What the reference's ``_finish_p_rd`` does to its row buffers
    (encoder.py:830-845)."""
    n_g = rows.shape[1] // sum(P_PARTS)
    cuts = np.cumsum([n_g * k for k in P_PARTS])[:-1]
    per_g = [np.split(r[: n_g * sum(P_PARTS)], cuts) for r in rows]
    return np.concatenate([np.concatenate([pg[i] for pg in per_g])
                           for i in range(len(P_PARTS))])


def check_rows(H: int, G: int) -> None:
    """The groups must be whole MB rows: H / G a multiple of 16.  The
    reference fails otherwise (a TypeError reshaping its recon, at the
    first P picture), and so this refuses them: ValueError."""
    if G < 1 or H % (16 * G):
        raise ValueError(f"row_slices={G} does not divide the {H // 16} MB "
                         f"rows of a {H}-line picture into whole MB rows")


def row_slabs(banks, cpads, H: int, G: int):
    """Per-group bank slabs (rd.py:2550): rows [g Hg, g Hg + Hg + 2 PAD)
    of each luma bank and [g Hg/2, g Hg/2 + Hg/2 + 2 PAD) of each chroma
    pad.  Returns (G, NR, 4, Hg + 2 PAD, Wp) and (G, NR, 2, Hg/2 + 2 PAD,
    Wcp)."""
    Hg = H // G
    slabs = torch.stack([banks[:, :, g * Hg: g * Hg + Hg + 2 * PAD]
                         for g in range(G)])
    cslabs = torch.stack([
        cpads[:, :, g * (Hg // 2): g * (Hg // 2) + Hg // 2 + 2 * PAD]
        for g in range(G)])
    return slabs, cslabs


def code_row(cur_y, cur_u, cur_v, slab, cslab, Hg: int, W: int, R: int,
             qp, qp_c, lam, lam_me, nref: int, k: RDP.PKernels):
    """One tile row (int32 planes of Hg lines on the device) through the P
    stages on its bank slab, as the reference's ``rd_p_pipeline`` runs
    with its defaults: no coarse stage, no WP, no 8x8 transform.  Returns
    the ``PFrame`` with every stage's results."""
    f = RDP.PFrame(cur_y, cur_u, cur_v, slab, cslab, Hg, W, R, qp, qp_c,
                   lam, lam_me, nref, k=k, use_cme=False)
    for stage in RDP.P_STAGES:
        stage(f)
    return f


def _per_group(v, G: int) -> list[int]:
    """A scalar or a (G,) vector -> G Python ints."""
    return [int(x) for x in np.broadcast_to(np.asarray(v, np.int64), (G,))]


def rd_p_rows_pipeline(cur_y, cur_u, cur_v, banks, cpads, H: int, W: int,
                       R: int, qp, qp_c, lam, lam_me, G: int, nref=None,
                       device=None, k: RDP.PKernels | None = None):
    """G tile-row slices of one P picture.  qp / qp_c / lam / lam_me are
    scalars or (G,) vectors (a QP per row: the basic unit of the rate
    control).  Each group runs the P stages at height H / G on its slab
    of `banks` / `cpads` (no coarse stage, no WP, no 8x8 transform).

    Returns (host_out (G, L_g) int32, recon (Y, U, V) over the whole
    picture, next reference entry (bank, cpad, col) over the whole
    picture: col holds the groups' colocated planes in group order)."""
    check_rows(H, G)
    dev = RD.resolve_device(device)
    k = k if k is not None else RDP.default_kernels()
    Hg = H // G
    cur = [RD._to_i32(p, dev) for p in (cur_y, cur_u, cur_v)]
    slabs, cslabs = row_slabs(banks, cpads, H, G)
    nref = banks.shape[0] if nref is None else int(nref)
    qs, qcs, lams, lmes = (_per_group(v, G) for v in (qp, qp_c, lam, lam_me))
    host_outs, recons, cols = [], [], []
    for g in range(G):
        f = code_row(cur[0][g * Hg:(g + 1) * Hg],
                     cur[1][g * Hg // 2:(g + 1) * Hg // 2],
                     cur[2][g * Hg // 2:(g + 1) * Hg // 2],
                     slabs[g], cslabs[g], Hg, W, R, qs[g], qcs[g], lams[g],
                     lmes[g], nref, k)
        host_outs.append(RDP.p_host_out(f))
        recons.append((f.dy, f.du, f.dv))
        cols.append(RDP.p_colocated(f))
    Yf, Uf, Vf = (torch.cat([r[i] for r in recons]) for i in range(3))
    bank, cpad = k.ref_bank(Yf, Uf, Vf)
    col = tuple(torch.cat([c[i] for c in cols]) for i in range(4))
    return torch.stack(host_outs), (Yf, Uf, Vf), (bank, cpad, col)
