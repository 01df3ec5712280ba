"""Batched rollouts over the generic (gather-based) step.

PyTorch counterpart of `griduniverse_tpu/ops/rollout.py`. A rollout is a
Python loop over T of the batched step; this path has no kernel (the
throughput path is ops.bitplane). Trajectories are time-major, (T, B).

Functions that draw random actions take a `torch.Generator`, or the draws
themselves as an `actions` tensor, so a test can feed them JAX's draws.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.semantics import Semantics
from ..core.step import reset, step, step_autoreset, step_autoreset_truncated
from ..core.types import EnvState, Level, StepResult

# The reference vmaps its single-env step over the batch, (sem, level,
# state_B, action_B) -> ...; the port's step is batched by construction (and
# takes a shared or a per-env level), so these are the same functions.
step_batch = step
step_autoreset_batch = step_autoreset


def _pick_step(auto_reset: bool, max_episode_steps: int | None = None):
    """The step variant for (auto-reset, optional time-limit truncation)."""
    if max_episode_steps is not None:
        if not auto_reset:
            raise ValueError("max_episode_steps requires auto_reset=True")
        return lambda sem, lvl, st, a: step_autoreset_truncated(  # noqa: E731
            sem, lvl, st, a, max_episode_steps
        )
    return step_autoreset if auto_reset else step


def reset_batch(level: Level, batch_size: int, *, device=None) -> EnvState:
    """B envs at the level start, on `device` (default: the level's).
    Accepts a shared level or a per-env level with B levels."""
    if device is not None:
        level = level.to(device)
    return reset(level, batch_size)


def _stack(outs: list[StepResult], b: int, device) -> StepResult:
    if not outs:
        return StepResult(
            obs=torch.empty((0, b), dtype=torch.int32, device=device),
            reward=torch.empty((0, b), dtype=torch.float32, device=device),
            done=torch.empty((0, b), dtype=torch.bool, device=device),
        )
    return StepResult(
        obs=torch.stack([o.obs for o in outs]),
        reward=torch.stack([o.reward for o in outs]),
        done=torch.stack([o.done for o in outs]),
    )


def _draw_actions(sem, state, num_steps, generator, actions):
    b = state.agent_idx.shape[0]
    if actions is not None:
        if tuple(actions.shape) != (num_steps, b):
            raise ValueError(
                f"actions shape {tuple(actions.shape)} != (num_steps, B) = {(num_steps, b)}"
            )
        return actions
    return torch.randint(
        0, sem.num_actions, (num_steps, b), generator=generator,
        dtype=torch.int32, device=state.agent_idx.device,
    )


def rollout_actions(
    sem: Semantics,
    level: Level,
    state: EnvState,
    actions: torch.Tensor,
    auto_reset: bool = False,
    max_episode_steps: int | None = None,
):
    """Step through pre-drawn (T, B) actions. Returns (final state,
    StepResult of (T, B) trajectories)."""
    if actions.dim() != 2:
        raise ValueError(f"actions must be (T, B), got shape {tuple(actions.shape)}")
    step_fn = _pick_step(auto_reset, max_episode_steps)
    outs = []
    for a in actions:
        state, out = step_fn(sem, level, state, a)
        outs.append(out)
    return state, _stack(outs, state.agent_idx.shape[0], state.agent_idx.device)


def rollout_random(
    sem: Semantics,
    level: Level,
    state: EnvState,
    num_steps: int,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
    *,
    generator: torch.Generator | None = None,
    actions: torch.Tensor | None = None,
):
    """Uniform-random-action rollout: actions from `generator`, or the
    given (T, B) draws."""
    actions = _draw_actions(sem, state, num_steps, generator, actions)
    return rollout_actions(sem, level, state, actions, auto_reset, max_episode_steps)


def rollout_policy(
    sem: Semantics,
    level: Level,
    state: EnvState,
    policy_fn: Callable[[torch.Tensor, torch.Generator | None], torch.Tensor],
    num_steps: int,
    auto_reset: bool = True,
    *,
    generator: torch.Generator | None = None,
):
    """Rollout under `policy_fn(obs_batch, generator) -> action_batch`."""
    step_fn = _pick_step(auto_reset)
    outs = []
    for _ in range(num_steps):
        state, out = step_fn(sem, level, state, policy_fn(state.agent_idx, generator))
        outs.append(out)
    return state, _stack(outs, state.agent_idx.shape[0], state.agent_idx.device)


def episode_stats(
    sem: Semantics,
    level: Level,
    state: EnvState,
    num_steps: int,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
    *,
    generator: torch.Generator | None = None,
    actions: torch.Tensor | None = None,
):
    """Random rollout + episode-return statistics: accumulates per-env
    running return/length and folds them into (count, return sum, length
    sum) on each done. Returns (final state, stats dict of 0-d tensors)."""
    actions = _draw_actions(sem, state, num_steps, generator, actions)
    state, n_eps, ret_sum, len_sum = episode_sums(
        sem, level, state, actions, auto_reset, max_episode_steps
    )
    denom = n_eps.clamp(min=1)
    return state, {
        "episodes": n_eps,
        "mean_return": ret_sum / denom,
        "mean_length": len_sum / denom,
    }


def episode_sums(
    sem: Semantics,
    level: Level,
    state: EnvState,
    actions: torch.Tensor,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
):
    """The rollout of `episode_stats` on (T, B) `actions`, its statistics as
    sums: (final state, episodes int64, return sum float32, length sum
    int64), each 0-d."""
    step_fn = _pick_step(auto_reset, max_episode_steps)
    dev = state.agent_idx.device
    run_ret = torch.zeros(state.agent_idx.shape, dtype=torch.float32, device=dev)
    run_len = torch.zeros(state.agent_idx.shape, dtype=torch.int32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
    len_sum = torch.zeros((), dtype=torch.int64, device=dev)
    for a in actions:
        state, out = step_fn(sem, level, state, a)
        run_ret = run_ret + out.reward
        run_len = run_len + 1
        d = out.done
        n_eps = n_eps + d.sum()
        ret_sum = ret_sum + torch.where(d, run_ret, 0.0).sum()
        len_sum = len_sum + torch.where(d, run_len, 0).sum()
        run_ret = torch.where(d, 0.0, run_ret)
        run_len = torch.where(d, 0, run_len)
    return state, n_eps, ret_sum, len_sum
