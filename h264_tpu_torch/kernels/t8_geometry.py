"""The lane geometry of K9's kernel (``csrc/t8.cu``), for the tests that
hold its premises and for the timing tool's empty launches of its grid.
Imports nothing, so that a tool can load it from its own checkout by path.

A warp takes one MB, ``mbs_per_block(n_mb)`` warps a block.  Lane
``8 b + r`` holds row ``r`` of 8x8 block ``b`` (``b = 2 b8y + b8x``): 8
samples of the raster ``(n_mb, 16, 16)`` planes, the same row of the 8x8
levels ``(n_mb, 2, 2, 8, 8)``, and 8 contiguous words of the 4x4 levels
``(n_mb, 4, 4, 4, 4)``, which are half of 4x4 block ``lane >> 1``.  The
8x8 transposes between the butterfly passes go through a tile of
``TILE_WORDS`` words a warp: 8x8 block ``b`` at ``TILE_BLOCK * b``, its
rows ``TILE_ROW`` words apart (one word of padding)."""

from __future__ import annotations

MAX_MBS = 4  # csrc/t8.cu kMaxMbs: warps (MBs) a block at most
SMS = 132  # an H100's SMs: the grid keeps a block for each
TILE_ROW = 9  # words a row of the transpose tile (csrc/t8.cu kTileRow)
TILE_BLOCK = 8 * TILE_ROW  # words an 8x8 block's tile
TILE_WORDS = 4 * TILE_BLOCK  # words a warp's tile


def mbs_per_block(n_mb: int) -> int:
    """Warps (MBs) a block: as many (1 to MAX_MBS) as leave a block for
    each SM."""
    return max(1, min(MAX_MBS, n_mb // SMS))


def grid(n_mb: int):
    """(blocks, threads) of the launch for n_mb MBs."""
    per = mbs_per_block(n_mb)
    return -(-n_mb // per), 32 * per


def mb_of(block: int, warp: int, per: int) -> int:
    """The MB of warp `warp` of block `block` (per warps a block); the
    warps past the last MB return at once."""
    return block * per + warp


def lane_row(lane: int):
    """(8x8 block b, row r) that lane holds."""
    return lane >> 3, lane & 7


def raster_start(lane: int) -> int:
    """First of the 8 contiguous words of the lane's row in an MB's
    (16, 16) raster (orig, pred, the 4x4 recon, the recon written)."""
    b, r = lane_row(lane)
    return 16 * (8 * (b >> 1) + r) + 8 * (b & 1)


def level_start(lane: int) -> int:
    """First of the lane's 8 contiguous words in an MB's 256 levels: row r
    of 8x8 block b of (2, 2, 8, 8), and half (lane & 1) of 4x4 block
    lane >> 1 of (4, 4, 4, 4)."""
    return 8 * lane


def tile_row_word(lane: int, c: int) -> int:
    """Tile word of element c of the row the lane writes."""
    b, r = lane_row(lane)
    return TILE_BLOCK * b + TILE_ROW * r + c


def tile_col_word(lane: int, q: int) -> int:
    """Tile word of element q of the column the lane reads back."""
    b, r = lane_row(lane)
    return TILE_BLOCK * b + TILE_ROW * q + r
