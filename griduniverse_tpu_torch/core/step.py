"""Batched reset/step — the generic (gather-based) transition.

PyTorch counterpart of `griduniverse_tpu/core/step.py`. The JAX version
steps one env and is vmapped; here every function takes a batch of envs
with a leading (B,) axis and either a shared (H, W) level or a per-env
(B, H, W) level.

Post-terminal convention (the same as the reference and the NumPy oracle):
  * `step`: once `done`, further steps are frozen — the state does not move,
    reward is 0.0, done stays True, t stops counting.
  * `step_autoreset`: the returned (obs, reward, done) are the terminal
    transition's, while the returned state is already reset to the start.

Out-of-range actions are clamped as XLA's gather clamps them: a negative
action counts from the end, then the index is clipped to [0, A-1]. Torch
indexing would raise instead.
"""

from __future__ import annotations

import torch

from .semantics import Semantics
from .types import EnvState, Level, StepResult


def clamp_actions(action: torch.Tensor, num_actions: int) -> torch.Tensor:
    """Map any int action onto [0, num_actions) the way XLA's gather does."""
    action = action.long()
    action = torch.where(action < 0, action + num_actions, action)
    return action.clamp(0, num_actions - 1)


def _batch_size(level: Level, batch_size: int | None) -> int:
    if level.batched:
        b = int(level.grid.shape[0])
        if batch_size is not None and batch_size != b:
            raise ValueError(f"batch_size {batch_size} != per-env level's {b} levels")
        return b
    return 1 if batch_size is None else int(batch_size)


def reset(level: Level, batch_size: int | None = None) -> EnvState:
    """B envs at the level start (B=1 by default for a shared level; a
    per-env level implies its own B)."""
    b = _batch_size(level, batch_size)
    dev = level.device
    return EnvState(
        agent_idx=level.start_idx.to(torch.int32).expand(b).clone(),
        t=torch.zeros(b, dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
    )


def observe(state: EnvState) -> torch.Tensor:
    """Observation = agent state index (Discrete(H*W))."""
    return state.agent_idx


def tile_at(level: Level, idx: torch.Tensor) -> torch.Tensor:
    """Tile code at state `idx`: any shape for a shared level, (B,) for a
    per-env level."""
    if level.batched:
        flat = level.grid.reshape(level.grid.shape[0], -1)
        return flat.gather(1, idx.long().unsqueeze(1)).squeeze(1)
    return level.grid.reshape(-1)[idx.long()]


def _move(sem: Semantics, level: Level, agent_idx: torch.Tensor, action: torch.Tensor):
    """Core transition: (agent_idx, action) -> (new_idx, reward, done),
    done-agnostic. Reused by the model-table builder (core.model)."""
    h, w = level.height, level.width
    a = clamp_actions(action, sem.num_actions)
    row = agent_idx // w
    col = agent_idx % w
    nrow = row + sem.deltas[a, 0]
    ncol = col + sem.deltas[a, 1]

    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    cand_idx = (nrow.clamp(0, h - 1) * w + ncol.clamp(0, w - 1)).to(torch.int32)
    cand_code = tile_at(level, cand_idx)
    blocked = ~in_bounds | ~sem.passable[cand_code.long()]
    new_idx = torch.where(blocked, agent_idx.to(torch.int32), cand_idx)

    new_code = tile_at(level, new_idx).long()
    return new_idx, sem.reward[new_code], sem.terminal[new_code]


def step(
    sem: Semantics, level: Level, state: EnvState, action: torch.Tensor
) -> tuple[EnvState, StepResult]:
    """One batched step, frozen after termination."""
    new_idx, reward, done_now = _move(sem, level, state.agent_idx, action)
    was_done = state.done
    agent_idx = torch.where(was_done, state.agent_idx, new_idx)
    reward = torch.where(was_done, torch.zeros_like(reward), reward)
    done = was_done | done_now
    t = torch.where(was_done, state.t, state.t + 1)
    return (
        EnvState(agent_idx=agent_idx, t=t, done=done),
        StepResult(obs=agent_idx, reward=reward, done=done),
    )


def _autoreset(level: Level, state: EnvState, new_idx, reward, done):
    start = level.start_idx.to(torch.int32).expand_as(new_idx)
    next_state = EnvState(
        agent_idx=torch.where(done, start, new_idx),
        t=torch.where(done, torch.zeros_like(state.t), state.t + 1),
        done=torch.zeros_like(done),
    )
    return next_state, StepResult(obs=new_idx, reward=reward, done=done)


def step_autoreset(
    sem: Semantics, level: Level, state: EnvState, action: torch.Tensor
) -> tuple[EnvState, StepResult]:
    """One batched step with branchless auto-reset: returns the terminal
    transition's (obs, reward, done) and a state already reset."""
    new_idx, reward, done = _move(sem, level, state.agent_idx, action)
    return _autoreset(level, state, new_idx, reward, done)


def step_autoreset_truncated(
    sem: Semantics,
    level: Level,
    state: EnvState,
    action: torch.Tensor,
    max_episode_steps: int,
) -> tuple[EnvState, StepResult]:
    """`step_autoreset` with a time limit: an episode also ends when it
    reaches `max_episode_steps` steps; `done` covers both endings."""
    new_idx, reward, done_env = _move(sem, level, state.agent_idx, action)
    done = done_env | ((state.t + 1) >= max_episode_steps)
    return _autoreset(level, state, new_idx, reward, done)
