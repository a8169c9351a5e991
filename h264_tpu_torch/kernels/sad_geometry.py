"""The block geometry of K10's kernel (``csrc/sad_grid.cu``
``Geometry``), for the tests that hold its premises and for the timing
tool's empty launches of its grid.  Imports nothing, so that a tool can
load it from its own checkout by path."""

from __future__ import annotations

from typing import NamedTuple

# csrc/sad_grid.cu's constants: MBs of a row a block, dx and dy a tile,
# warps a block, quads a strip at most, words an MB's staged rows take
RUN, TX, TY, WARPS, MAXQ, MB_WORDS = 8, 4, 3, 4, 16, 68
TILES = 4 * WARPS  # tiles a block


class Geometry(NamedTuple):
    """csrc/sad_grid.cu ``Geometry``: the grid's nq quads of dx by nty
    rows of TY dy, cut into ns strips of nq // ns or sw quads, the tiles
    row-major in a strip, TILES a block over `groups` blocks; a block's
    window is at most rows x Ws words."""

    D: int
    nq: int
    nty: int
    ns: int
    sw: int
    groups: int
    rows: int
    Ws: int

    def strip_q0(self, s):
        """The first quad of strip s (s = ns: one past the last)."""
        return s * self.nq // self.ns

    def blocks(self, H: int, W: int):
        """The launch's grid (x, y, z) for an (H, W) picture."""
        return (H // 16 * -(-(W // 16) // RUN), self.ns, self.groups)


def geometry(R: int) -> Geometry:
    D = 2 * R + 1
    nq, nty = -(-D // TX), -(-D // TY)
    ns = -(-nq // MAXQ)
    sw = -(-nq // ns)
    return Geometry(D, nq, nty, ns, sw, -(-(sw * nty) // TILES),
                    ((TILES - 1) // (nq // ns) + 2) * TY + 15,
                    4 * RUN + sw + 4)
