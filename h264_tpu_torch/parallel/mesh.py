"""The (frame, row) mesh of the sharded pipelines, over the ranks of
``torch.distributed``: the counterpart of the reference's
``jax.sharding.Mesh(devices, ("frame", "row"))``.

Rank ``f * n_row + r`` holds frame shard f and row shard r.  Each rank is
a process of its own, started by ``launch`` (``torch.multiprocessing``
with the spawn start method, since the caller may hold a live CUDA
context) and joined through a ``file://`` rendezvous in a temporary
directory, so that no port is taken.

Backends.  ``"nccl"`` (the default) needs one card per rank: rank i runs
on ``cuda:i``, and the mesh refuses (``ValueError``, before any process
starts) a CPU device or more ranks than visible cards.  ``"gloo"`` is
asked for by name: the CPU dry run (``device="cpu"``), and ranks that
share the cards (rank i on ``cuda:(i mod cards)``).  Its point-to-point
operations take CPU tensors only, so ``halo.exchange`` stages a CUDA
rank's halos through host memory.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

BACKENDS = ("nccl", "gloo")
# a rank that waits longer than this for the rendezvous or a neighbour's
# halo raises, and so fails the run instead of hanging it
TIMEOUT = timedelta(seconds=300)
# a launch whose ranks have not all ended after this many seconds stops
# them and raises, so that no caller waits on a rank for ever
LAUNCH_LIMIT = 1200.0


@dataclass(frozen=True)
class Mesh:
    """n_frame x n_row ranks on `backend`; `device` is "cuda" or "cpu"."""

    n_frame: int
    n_row: int
    backend: str = "nccl"
    device: str = "cuda"

    def __post_init__(self):
        if self.n_frame < 1 or self.n_row < 1:
            raise ValueError(f"mesh ({self.n_frame}, {self.n_row}) is empty")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} is not one of "
                             f"{BACKENDS}")
        kind = torch.device(self.device).type
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"device {self.device!r} is neither cpu nor "
                             "cuda")
        if self.backend == "nccl":
            if kind == "cpu":
                raise ValueError("nccl runs on CUDA cards; use "
                                 "backend='gloo' with device='cpu'")
            n_cards = torch.cuda.device_count()
            if self.size > n_cards:
                raise ValueError(
                    f"nccl needs one card per rank: {self.size} ranks, "
                    f"{n_cards} cards visible; use backend='gloo' to share "
                    "them")
        else:
            resolve_device(self.device)  # a CUDA mesh needs a card

    @property
    def size(self) -> int:
        return self.n_frame * self.n_row

    @property
    def shape(self) -> dict:
        return {"frame": self.n_frame, "row": self.n_row}

    def coords(self, rank: int) -> tuple[int, int]:
        """(frame shard, row shard) of `rank`."""
        return divmod(rank, self.n_row)

    def device_of(self, rank: int) -> torch.device:
        if torch.device(self.device).type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True)
class Rank:
    """What a rank's function knows of itself."""

    mesh: Mesh
    rank: int
    f: int  # frame shard
    r: int  # row shard
    device: torch.device

    def sync(self) -> None:
        """Wait for this rank's device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _rank_main(i: int, mesh: Mesh, tmp: str, fn) -> None:
    """The process of rank i: join the group, run fn(Rank, *args) on the
    arguments ``launch`` saved and save what it returns for the caller.
    A failure propagates: the process exits non-zero and ``launch``
    raises."""
    dev = mesh.device_of(i)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh.backend,
                            init_method=f"file://{tmp}/rendezvous",
                            world_size=mesh.size, rank=i, timeout=TIMEOUT)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    out = fn(Rank(mesh, i, *mesh.coords(i), dev), *args)
    torch.save(out, os.path.join(tmp, f"rank{i}.pt"))
    dist.destroy_process_group()


def _join(ctx, limit: float) -> None:
    """Wait for every rank of the spawn context `ctx`, at most `limit`
    seconds; then, ended or not, stop and reap each process still there.
    Raises TimeoutError past the limit, and what ``ctx.join`` raises when
    a rank fails."""
    deadline = time.monotonic() + limit
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"mesh launch: ranks still running after "
                                   f"{limit:.0f} s")
            if ctx.join(timeout=min(left, 5.0)):
                return
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def launch(mesh: Mesh, fn, *args) -> list:
    """Run fn(Rank, *args) on every rank of `mesh` and return what each
    returned, by rank.  `fn` is a function of this package and `args`
    are picklable (numpy arrays, numbers).  The spawned ranks import the
    caller's main script, so a script that calls this keeps its work under
    ``if __name__ == "__main__"``.  Raises when a rank raises, and (after
    stopping every rank) when they have not all ended within
    ``LAUNCH_LIMIT`` seconds."""
    with tempfile.TemporaryDirectory(prefix="h264_mesh_") as tmp:
        # through a file, not the spawn pipe: a process's arguments larger
        # than the pipe's buffer hold its start until the one before has
        # imported its modules, so the ranks would start one by one
        torch.save(args, os.path.join(tmp, "args.pt"))
        _join(mp.start_processes(_rank_main, args=(mesh, tmp, fn),
                                 nprocs=mesh.size, join=False,
                                 start_method="spawn"), LAUNCH_LIMIT)
        return [torch.load(os.path.join(tmp, f"rank{i}.pt"),
                           weights_only=False) for i in range(mesh.size)]
