"""Multi-process runtime — counterpart of `griduniverse_tpu/parallel/distributed.py`.

The reference bootstraps `jax.distributed`; the port bootstraps a
`torch.distributed` process group, one rank a shard (`parallel.mesh`):

  * `initialize(backend, ...)` — `init_process_group` with the caller's
    backend ("nccl": one rank a card; "gloo": the CPU, or ranks sharing a
    card), address, world size, rank and timeout. The code never picks or
    switches a backend on its own. Nothing on a machine tells a process of
    a cluster: give `init_method` (e.g. "tcp://127.0.0.1:29500"),
    `world_size` and `rank`.
  * `make_global_array` — per-rank data feed: this rank builds only its
    rows of a global array, from a callback.
  * `fetch_global`, `fetch_replicated`, `local_shards` — result I/O across
    the process boundary.

Failure semantics: a lost rank makes the survivors' next collective raise
(a Gloo connection error, or the process group's timeout) instead of
hanging; recovery is checkpoint and restart (`utils/checkpoint.py`).
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.platform import rank_device
from .mesh import EnvMesh, all_gather_rows, shard_rows, tree_map

BACKENDS = ("nccl", "gloo")


def initialize(
    backend: str,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device=None,
    timeout_s: float = 300.0,
) -> dict:
    """Join this process to a process group. `device` is this rank's
    (default: card `rank` mod the cards it sees); NCCL makes it the current
    card. A collective that waits longer than `timeout_s` raises. Returns
    {rank, world_size, backend, device}. Call once a process; `shutdown`
    ends it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    own = rank if rank is not None else int(os.environ.get("RANK", "0"))
    dev = rank_device(own, device)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return {
        "rank": dist.get_rank(), "world_size": dist.get_world_size(),
        "backend": backend, "device": rank_device(dist.get_rank(), device),
    }


def shutdown() -> None:
    """Leave and destroy the default process group (end-of-job cleanup)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_global_array(
    mesh: EnvMesh,
    global_shape: Sequence[int],
    fill: Callable[[tuple], np.ndarray],
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """This rank's rows of a global array sharded on its leading axis:
    `fill(index)` builds them from their global numpy-style index (a tuple
    of slices), on this rank only, so no rank holds another's rows. Returns
    them on the mesh's device."""
    index = (shard_rows(mesh, int(global_shape[0])),) + tuple(slice(None) for _ in global_shape[1:])
    rows = torch.as_tensor(np.asarray(fill(index)), device=mesh.device)
    return rows if dtype is None else rows.to(dtype)


def fetch_global(mesh: EnvMesh, tree):
    """Every tensor of `tree` (this rank's rows of an env-sharded array;
    0-d tensors are replicated values) gathered in rank order to host numpy
    on every rank: each rank then holds the whole, to checkpoint or to
    hand back to `parallel.mesh.shard_env_state` after a restart."""
    def whole(x):
        return (x if x.dim() == 0 else all_gather_rows(mesh, x)).detach().cpu().numpy()

    return tree_map(whole, tree)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated result (the same on every rank: Q, V, the statistics)
    as host numpy."""
    return x.detach().cpu().numpy()


def local_shards(mesh: EnvMesh, x: torch.Tensor) -> list[tuple[tuple, np.ndarray]]:
    """This rank's shard of an env-sharded array as [(global index, data)]:
    the rows it owns."""
    n = int(x.shape[0]) * mesh.size
    index = (shard_rows(mesh, n),) + tuple(slice(None) for _ in x.shape[1:])
    return [(index, x.detach().cpu().numpy())]
