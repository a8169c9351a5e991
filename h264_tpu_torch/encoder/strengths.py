"""Boundary strengths of every P and B picture (K6 ``strengths``): the
layouts of the fields it reads and its plain PyTorch version.

One rule serves the RD P picture (rd.py:1713 ``strengths_full``), the B
picture (:1928 ``strengths_full_b``) and the legacy P16x16 picture
(fast.py:327 ``strengths_device_p``).  Per 4x4 block, the bS 0..4 of its
left (BSV) and top (BSH) edge, 0 on the picture's edges: 4 at an MB edge
and 3 inside where either side is intra; else 2 where either side has
coefficients; else the pairing rule.  With one list (P pictures) a
block's reference id is its reference index, and bS is 1 where the ids
differ or a component of the mvs differs by 4 or more.  With two lists
(B pictures) a list's id is the POC of its picture (``pocs0`` at the
clamped index for list 0, ``poc1`` for list 1) where the block uses the
list, else -10^9; the ids pair straight (p0 = q0, p1 = q1) or crossed
(p0 = q1, p1 = q0), else bS 1, and paired blocks compare the mvs of the
pairing lists (both pairings where q's two ids are one picture).  The P
rule is the two-list rule with list 1 absent: then p1 = q1 = -10^9, so
straight is p0 = q0, crossed cannot hold, and the mv test is list 0's.

Fields are read at the glue's own granularity, never spread into a
picture raster first.  A block (y4, x4) sits in MB (y4 / 4, x4 / 4),
8x8 unit ((y4 / 2) % 2, (x4 / 2) % 2) and block (y4 % 2, x4 % 2) of its
unit; a field's element offset is the dot product of those six indices
with its six strides (``layout``), so a zero stride broadcasts a
per-MB or per-unit value over its blocks.  The shapes taken:
  fields (``intra``, ``t8``, ``ref0``, ``mv0x`` ...): (n_mb,) per MB,
    (n_mb, 4) per unit, or (n_mb, 4, 4) per block of a unit [MB, unit,
    block];
  ``coef``: the 4x4 levels (n_mb, 4, 4, 4, 4) [MB, block row, block
    column] (RD P and B pictures) or (4 n_my, 4 n_mx, 4, 4) in raster
    (the legacy picture); a block has coefficients where any is nonzero;
  ``coef8``: the 8x8 levels (n_mb, 2, 2, 8, 8): a nonzero 8x8 block marks
    its four 4x4 blocks.
The luma DC levels of I16 MBs are not read: they mark only intra MBs,
whose edges are 3 or 4 before coefficients count.  ``t8`` (per MB, > 0
for 8x8-transform MBs) zeroes the odd (4-sample) edges inside them
(ldecod/src/loopFilter.c: !(t8 && (edge & 1))).
"""

from __future__ import annotations

import functools

import torch

I32 = torch.int32
NONE = -(10 ** 9)  # reference id of an unused list (strengths_full_b)
# the positional fields of ``strengths`` that are per-block tensors, in
# the C entry's order (pocs0 follows them)
FIELDS = ("coef", "coef8", "intra", "t8", "ref0", "mv0x", "mv0y", "use0",
          "mv1x", "mv1y", "use1")
# the fields the two-list rule takes, and only it
TWO_LISTS = ("pocs0", "use0", "mv1x", "mv1y", "use1")


@functools.lru_cache(maxsize=256)
def layout(shape: tuple, n_my: int, n_mx: int, name: str):
    """(strides, n) of a field of `shape` named `name`: the element
    offset's six strides over (MB row, MB column, unit row, unit column,
    block row, block column), and the values a block reads from there
    (16 for 4x4 levels, 64 for 8x8 ones, else 1).  Raises ValueError for
    a shape the field does not take."""
    n_mb, H4, W4 = n_my * n_mx, 4 * n_my, 4 * n_mx
    shape = tuple(shape)
    if name == "coef":
        table = {(n_mb, 4, 4, 4, 4): ((256 * n_mx, 256, 128, 32, 64, 16), 16),
                 (H4, W4, 4, 4): ((64 * W4, 64, 32 * W4, 32, 16 * W4, 16), 16)}
    elif name == "coef8":
        table = {(n_mb, 2, 2, 8, 8): ((256 * n_mx, 256, 128, 64, 0, 0), 64)}
    else:
        table = {(n_mb,): ((n_mx, 1, 0, 0, 0, 0), 1),
                 (n_mb, 4): ((4 * n_mx, 4, 2, 1, 0, 0), 1),
                 (n_mb, 4, 4): ((16 * n_mx, 16, 8, 4, 2, 1), 1)}
    if shape not in table:
        raise ValueError(f"strengths: {name} of shape {shape} fits no layout "
                         f"of a {n_my}x{n_mx}-MB picture (takes "
                         f"{sorted(table)})")
    return table[shape]


def raster(x, n_my: int, n_mx: int, name: str):
    """The field x as a (4 n_my, 4 n_mx) picture raster, or (4 n_my,
    4 n_mx, n) for levels, read through its layout."""
    st, n = layout(tuple(x.shape), n_my, n_mx, name)
    x = x.contiguous()
    v = torch.as_strided(x, (n_my, n_mx, 2, 2, 2, 2, n), (*st, 1))
    return v.permute(0, 2, 4, 1, 3, 5, 6).reshape(4 * n_my, 4 * n_mx, n)


def check_lists(args: dict) -> bool:
    """True with two lists; raise unless the two-list fields are all given
    or all absent."""
    given = [args[k] is not None for k in TWO_LISTS]
    if any(given) and not all(given):
        raise ValueError("strengths: pocs0, use0, mv1x, mv1y and use1 go "
                         "together (two lists) or not at all (one list)")
    return all(given)


def coded(coef, coef8, n_my: int, n_mx: int):
    """(4 n_my, 4 n_mx) bool: the blocks with coefficients."""
    nz = raster(coef, n_my, n_mx, "coef").ne(0).any(-1)
    if coef8 is not None:
        nz = nz | raster(coef8, n_my, n_mx, "coef8").ne(0).any(-1)
    return nz


def strengths_plain(n_my, n_mx, coef, intra, ref0, mv0x, mv0y, coef8=None,
                    t8=None, pocs0=None, use0=None, mv1x=None, mv1y=None,
                    use1=None, poc1=0):
    """(BSV, BSH), each (4 n_my, 4 n_mx) int32, of a picture of n_my x n_mx
    MBs from its fields (module docstring): coef int32 4x4 levels;
    intra bool or None (no intra MB); ref0 int32 reference indices, or
    None (all 0); mv0x/mv0y int32 quarter-pel mvs of list 0; coef8 int32
    8x8 levels or None; t8 int32 per MB or None; with two lists, pocs0
    (NR0,) int32, use0/use1 bool, mv1x/mv1y int32 and poc1."""
    two = check_lists(dict(pocs0=pocs0, use0=use0, mv1x=mv1x, mv1y=mv1y,
                           use1=use1))
    H4, W4 = 4 * n_my, 4 * n_mx

    def R(x, name="field"):
        return raster(x, n_my, n_mx, name)[..., 0]

    nz = coded(coef, coef8, n_my, n_mx)
    dev = nz.device
    intra4 = (R(intra).bool() if intra is not None
              else torch.zeros((H4, W4), dtype=torch.bool, device=dev))
    rid0 = (R(ref0) if ref0 is not None
            else torch.zeros((H4, W4), dtype=I32, device=dev))
    m0x, m0y = R(mv0x), R(mv0y)
    if two:
        rid0 = torch.where(R(use0).bool(),
                           pocs0[rid0.clamp(0, pocs0.numel() - 1).long()],
                           NONE)
        rid1 = torch.where(R(use1).bool(), int(poc1), NONE)
        m1x, m1y = R(mv1x), R(mv1y)

    def bs(q, p, mb_edge):
        ei = intra4[q] | intra4[p]
        coef_ = nz[q] | nz[p]

        def diff(ax, ay, bx, by):
            return ((ax[q] - bx[p]).abs() >= 4) | ((ay[q] - by[p]).abs() >= 4)

        d00 = diff(m0x, m0y, m0x, m0y)
        if not two:
            pair = (rid0[q] != rid0[p]) | d00
        else:
            rq0, rq1, rp0, rp1 = rid0[q], rid1[q], rid0[p], rid1[p]
            straight = (rq0 == rp0) & (rq1 == rp1)
            crossed = (rq0 == rp1) & (rq1 == rp0)
            d11 = diff(m1x, m1y, m1x, m1y)
            d01 = diff(m0x, m0y, m1x, m1y)
            d10 = diff(m1x, m1y, m0x, m0y)
            mv_two = torch.where(rq0 == rp0, d00 | d11, d01 | d10)
            mv_same = (d00 | d11) & (d01 | d10)
            mv_d = torch.where(rq0 != rq1, mv_two, mv_same)
            pair = ~(straight | crossed) | mv_d
        inter = torch.where(coef_, 2, pair.to(I32))
        return torch.where(ei, torch.where(mb_edge, 4, 3), inter).to(I32)

    colv = (torch.arange(1, W4, device=dev) % 4 == 0)[None, :]
    BSV = torch.zeros((H4, W4), dtype=I32, device=dev)
    BSV[:, 1:] = bs((slice(None), slice(1, None)),
                    (slice(None), slice(0, W4 - 1)), colv)
    rowh = (torch.arange(1, H4, device=dev) % 4 == 0)[:, None]
    BSH = torch.zeros((H4, W4), dtype=I32, device=dev)
    BSH[1:, :] = bs((slice(1, None), slice(None)),
                    (slice(0, H4 - 1), slice(None)), rowh)
    if t8 is not None:
        t8r = R(t8) > 0
        odd = torch.arange(max(H4, W4), device=dev) % 2 == 1
        BSV = torch.where(t8r & odd[None, :W4], 0, BSV)
        BSH = torch.where(t8r & odd[:H4, None], 0, BSH)
    return BSV, BSH
