"""Sharded rollouts on the generic step — counterpart of
`griduniverse_tpu/parallel/rollout.py`.

The env step couples no two envs, so a rollout is embarrassingly parallel:
each rank steps its rows of the batch, and the only collectives combine
the episode statistics at the end (integer counts and lengths by an exact
all-reduce, the float return sum added in rank order; `parallel.mesh`).
The step is the port's generic one (`ops.rollout`, plain torch).

Random actions. The reference folds the shard index into each step's key.
Here each rank draws from a `torch.Generator` seeded from (seed, shard
index): streams independent across ranks and fixed for a given seed and
mesh, not the reference's draws (a chosen divergence). `actions=` injects
the global (T, B) draws, of which each rank steps its columns, so a sharded
run can be held against an unsharded one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.semantics import Semantics
from ..core.types import EnvState, Level
from ..ops.rollout import _draw_actions, episode_sums, reset_batch
from .mesh import EnvMesh, all_reduce_sum, local_batch, shard_index, shard_rows


def shard_seed(seed, shard: int) -> int:
    """A 64-bit generator seed mixed from (seed, shard index)."""
    entropy = (int(seed) & 0xFFFFFFFFFFFFFFFF, int(shard))
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def local_level(mesh: EnvMesh, level: Level, batch_size: int) -> Level:
    """The level a rank steps, on its device: a shared level whole, a
    per-env level its rows."""
    if level.batched:
        if int(level.grid.shape[0]) != batch_size:
            raise ValueError(
                f"per-env level has {int(level.grid.shape[0])} levels; expected batch_size={batch_size}"
            )
        rows = shard_rows(mesh, batch_size)
        level = Level(grid=level.grid[rows], start_idx=level.start_idx[rows])
    return level.to(mesh.device)


def reset_batch_sharded(mesh: EnvMesh, level: Level, batch_size: int) -> EnvState:
    """This rank's B / n envs at the level start."""
    return reset_batch(local_level(mesh, level, batch_size), local_batch(mesh, batch_size))


def episode_stats_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    level: Level,
    seed,
    batch_size: int,
    num_steps: int,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
    *,
    actions: torch.Tensor | None = None,
):
    """Random-action rollout with episode statistics, envs sharded over the
    mesh. Returns (this rank's final state, stats of 0-d tensors, the same
    on every rank: episodes, mean_return, mean_length, steps)."""
    lvl = local_level(mesh, level, batch_size)
    state = reset_batch(lvl, local_batch(mesh, batch_size))
    if actions is None:
        gen = torch.Generator(device=mesh.device).manual_seed(shard_seed(seed, shard_index(mesh)))
        actions = _draw_actions(sem, state, num_steps, gen, None)
    else:
        if tuple(actions.shape) != (num_steps, batch_size):
            raise ValueError(
                f"actions shape {tuple(actions.shape)} != (num_steps, B) = {(num_steps, batch_size)}"
            )
        actions = actions[:, shard_rows(mesh, batch_size)].to(mesh.device)
    state, n_eps, ret_sum, len_sum = episode_sums(
        sem, lvl, state, actions, auto_reset, max_episode_steps
    )
    n_eps = all_reduce_sum(mesh, n_eps)
    denom = n_eps.clamp(min=1)
    return state, {
        "episodes": n_eps,
        "mean_return": all_reduce_sum(mesh, ret_sum) / denom,
        "mean_length": all_reduce_sum(mesh, len_sum) / denom,
        "steps": torch.tensor(num_steps * batch_size, dtype=torch.int64, device=mesh.device),
    }
