"""Distributed tabular learners — counterpart of
`griduniverse_tpu/parallel/learner.py` (this module holds `DistTDResult`,
`q_learning_sharded` and `q_learning_batched_sharded`; the sharded TD(λ)
and Monte-Carlo learners are still to be ported).

`q_learning_sharded`: envs sharded over the mesh, the Q-table replicated on
every rank, each step's updates combined over the ranks so that every rank
applies the same update. The step is `algos.td.td_run`'s (the generic
step, ε-greedy, the TD errors), and each rank draws from its lanes of the
GLOBAL xorshift stream (`td_init`'s `xorshift_init` with the rank's lane
offset), so in both modes each env acts on the draws of the unsharded run:

  * `parity=True` — the (s, a, δ) of every env are all-gathered in rank
    (= env) order and K10 (`csrc/segment_mean.cu`) runs once over all B of
    them on every rank: Q equals the unsharded `td_run`'s bit for bit.
  * `parity=False` (the scalable mode) — each rank takes the env-order
    float sums and counts of its own envs (K10's sums form), the counts are
    all-reduced exactly and the sums added in rank order, and every rank
    applies the mean. In a world of one this is K10 bit for bit; above, the
    sums are associated by rank, within float rounding of the unsharded run.
  * `psum_every=k` (scalable mode) — k steps against the Q frozen at the
    window's start, the sums and counts accumulated locally, then one
    reduction and one pooled mean update a window: 1/k the collectives, with
    the reference's staleness semantics (`parallel/learner.py:80-113`).

`q_learning_batched_sharded`: one table per maze, mazes sharded; each rank
runs K6 (`algos.td_batched.q_learning_batched`) on its mazes with its lane
offset, tables and experience never cross ranks, and only the statistics
are reduced. The (N, S, A) tables are gathered in rank order.

Draws: `draws=` injects the reference's global (T, B) per-step draws (and
the initial action's), of which each rank takes its columns.
"""

from __future__ import annotations

import dataclasses

import torch

from ..algos.td import (
    ALGOS,
    _fold_stats,
    _next_draw,
    apply_segment_sums,
    apply_td_updates,
    epsilon_greedy,
    segment_sums,
    td_error_expected_sarsa,
    td_error_qlearning,
    td_error_sarsa,
)
from ..algos.td_batched import BatchedTDResult, q_learning_batched
from ..core.semantics import Semantics
from ..core.step import step_autoreset
from ..core.types import Level
from ..ops.bitplane import xorshift_init
from .mesh import EnvMesh, all_gather_rows, all_reduce_sum, local_batch, shard_index, shard_rows
from .rollout import local_level, reset_batch_sharded


@dataclasses.dataclass
class DistTDResult:
    q: torch.Tensor            # (S, A) the replicated table
    episodes: torch.Tensor     # () completed episodes over every rank
    mean_return: torch.Tensor  # () float32 mean episode return


def _check_q_learning_sharded(algo, parity, psum_every, num_steps):
    """The reference's validation (`parallel/learner.py:100-121`)."""
    if algo not in ALGOS:
        raise ValueError(algo)
    if psum_every < 1:
        raise ValueError(f"psum_every must be >= 1, got {psum_every}")
    if psum_every > 1 and parity:
        raise ValueError(
            "parity mode is defined as the bit-exact per-step rule; "
            "psum_every > 1 changes update semantics (see docstring) — "
            "use parity=False"
        )
    if num_steps % psum_every:
        raise ValueError(
            f"num_steps ({num_steps}) must be divisible by psum_every ({psum_every})"
        )


def _local_draws(draws, num_steps, batch_size, rows):
    """This rank's columns of injected (explore (T, B), rand_a (T, B),
    explore0 (B,), rand_a0 (B,)), or None."""
    if draws is None:
        return None
    shapes = ((num_steps, batch_size),) * 2 + ((batch_size,),) * 2
    for name, x, shape in zip(("explore", "rand_a", "explore0", "rand_a0"), draws, shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"draws: {name} has shape {tuple(x.shape)}, expected {shape}")
    explore, rand_a, explore0, rand_a0 = draws
    return explore[:, rows], rand_a[:, rows], explore0[rows], rand_a0[rows]


def q_learning_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    level: Level,
    key,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    parity: bool = False,
    psum_every: int = 1,
    draws=None,
) -> DistTDResult:
    """Distributed synchronous batched TD control (module docstring). `key`
    is the integer seed of the global xorshift lanes; `draws` injects the
    global (explore, rand_a, explore0, rand_a0). Returns the replicated Q
    and the statistics, the same on every rank."""
    _check_q_learning_sharded(algo, parity, psum_every, num_steps)
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = local_level(mesh, level, batch_size)
    draws = _local_draws(draws, num_steps, batch_size, rows)
    dev = mesh.device
    num_states, num_actions = lvl.num_states, sem.num_actions

    q = torch.zeros((num_states, num_actions), dtype=torch.float32, device=dev)
    state = reset_batch_sharded(mesh, level, batch_size)
    rs = xorshift_init(key, (local,), shard_index(mesh) * local, device=dev)
    draw, rs = _next_draw(rs, None if draws is None else (draws[2], draws[3]))
    a = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
    run_ret = torch.zeros(local, dtype=torch.float32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
    acc_sums = acc_counts = None

    for i in range(num_steps):
        s = state.agent_idx
        state, out = step_autoreset(sem, lvl, state, a)
        s2, r, d = out.obs, out.reward, out.done
        draw, rs = _next_draw(rs, None if draws is None else (draws[0][i], draws[1][i]))
        a_next = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
        if algo == "q_learning":
            delta = td_error_qlearning(q, s, a, r, s2, d, gamma)
        elif algo == "sarsa":
            delta = td_error_sarsa(q, s, a, r, s2, a_next, d, gamma)
        else:
            delta = td_error_expected_sarsa(q, s, a, r, s2, d, gamma, epsilon)
        if parity:
            # one gather a step: (s, a, the bits of δ) of every env, in env order
            pairs = all_gather_rows(mesh, torch.stack([s, a, delta.view(torch.int32)], dim=1))
            q = apply_td_updates(
                q, pairs[:, 0].contiguous(), pairs[:, 1].contiguous(),
                pairs[:, 2].contiguous().view(torch.float32), alpha,
            )
        else:
            sums, counts = segment_sums(s, a, delta, alpha, num_states, num_actions)
            counts = counts.to(torch.int64)
            if acc_sums is None:
                acc_sums, acc_counts = sums, counts
            else:
                acc_sums, acc_counts = acc_sums + sums, acc_counts + counts
            if (i + 1) % psum_every == 0:
                q = apply_segment_sums(
                    q, all_reduce_sum(mesh, acc_sums), all_reduce_sum(mesh, acc_counts)
                )
                acc_sums = acc_counts = None
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)
        a = a_next

    n_eps = all_reduce_sum(mesh, n_eps)
    return DistTDResult(
        q=q, episodes=n_eps, mean_return=all_reduce_sum(mesh, ret_sum) / n_eps.clamp(min=1)
    )


def q_learning_batched_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    levels: Level,
    key,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    parity: bool = False,
    dtype: str = "float32",
    draws=None,
) -> BatchedTDResult:
    """Per-maze TD control with the mazes sharded over the mesh: K6 on each
    rank's mazes, their lanes numbered from the rank's first maze, so each
    maze draws its stream of the unsharded run whether or not `parity` is
    set (kept for the reference's signature). `draws` injects the global
    (explore (T, N), rand_a (T, N), explore0 (N,), rand_a0 (N,)). Returns
    the (N, S, A) tables gathered in rank order and the pooled statistics,
    the same on every rank; `.state` is this rank's resume carry."""
    del parity
    if levels.grid.dim() != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got {tuple(levels.grid.shape)}"
        )
    if algo not in ALGOS:
        raise ValueError(algo)
    n = int(levels.grid.shape[0])
    if n % mesh.size:
        raise ValueError(f"maze count {n} not divisible by mesh size {mesh.size}")
    rows = shard_rows(mesh, n)
    res = q_learning_batched(
        sem, local_level(mesh, levels, n), key, num_steps, alpha, gamma, epsilon, algo,
        max_episode_steps, dtype=dtype, draws=_local_draws(draws, num_steps, n, rows),
        lane_offset=rows.start,
    )
    episodes = all_reduce_sum(mesh, res.state.n_eps_env.sum())
    ret_sum = all_reduce_sum(mesh, res.state.ret_sum_env.sum())
    return BatchedTDResult(
        q=all_gather_rows(mesh, res.q), episodes=episodes,
        mean_return=ret_sum / episodes.clamp(min=1), state=res.state,
    )
