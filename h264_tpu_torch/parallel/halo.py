"""The recon halo exchange between the row shards of one frame shard: the
port of ``_exchange`` of the reference's sharded GOP encoder
(``encoder/rd.py:2636-2653``, two ``lax.ppermute``s along ``row``)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Rank


def exchange(ctx: Rank, plane: torch.Tensor, pad: int,
             hloc: int) -> torch.Tensor:
    """plane: this shard's (h, w) recon slab -> (h + 2 pad, w): n = min(pad,
    hloc) rows from each row neighbour around it (the shard above sends
    its bottom n rows, the shard below its top n), the outer shards' own
    edge row repeated n times on their open side, and pad - n zero rows
    beyond (never read for a legal search range: at R <= Hg - 7 the
    search and its taps stay inside the halo).

    Each shard sends and receives with one ``batch_isend_irecv``; on gloo
    a CUDA plane's halos go through host memory, since its point-to-point
    operations take CPU tensors only.  With one row shard there is no
    communication."""
    n = min(pad, hloc)
    n_row = ctx.mesh.n_row
    from_above = plane[:1].expand(n, -1)
    from_below = plane[-1:].expand(n, -1)
    if n_row > 1:
        staged = ctx.mesh.backend == "gloo" and plane.device.type != "cpu"

        def wire(x):
            return x.cpu() if staged else x.contiguous()

        ops, got = [], {}
        for dr, mine in ((-1, plane[:n]), (1, plane[-n:])):
            if 0 <= ctx.r + dr < n_row:
                send = wire(mine)
                got[dr] = torch.empty_like(send)
                # row shard r + dr of this frame shard is rank + dr
                ops += [dist.P2POp(dist.isend, send, ctx.rank + dr),
                        dist.P2POp(dist.irecv, got[dr], ctx.rank + dr)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if -1 in got:
            from_above = got[-1].to(plane.device)
        if 1 in got:
            from_below = got[1].to(plane.device)
    zeros = plane.new_zeros((pad - n, plane.shape[1]))
    return torch.cat([zeros, from_above, plane, from_below, zeros])
