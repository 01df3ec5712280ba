"""Vectorized NumPy-facing env — batch stepping without writing torch.

Counterpart of `griduniverse_tpu/compat/vector_env.py`. For users of the
reference who want the batched engine behind a familiar imperative API
(gymnasium-VectorEnv-flavored): actions in as a NumPy array,
observations, rewards and flags out as NumPy arrays, auto-reset handled
inside. Every step is one launch of K2 (`ops.bitplane.rollout_actions_bits`
over a (1, B) action, auto-reset with the time limit), the kernel of the
throughput path, on `device` (default: the card).

Conventions (identical to the functional engine):
  * auto-reset is NEXT-step style: when an env terminates or truncates, the
    returned observation is the FINAL state of the finished episode and the
    env already sits at the start state for the next `step` call;
  * `terminated` (goal/lava) and `truncated` (time limit) are reported
    separately; both imply the auto-reset above. K2 folds the time limit
    into `done`, so `terminated` is the terminal flag of the tile the env
    moved to (or stayed on) and `truncated` is `done & ~terminated`, the
    reference's `(t + 1 >= max_episode_steps) & ~terminated`.

Each step copies its four (B,) arrays to the host; for throughput, use the
functional rollouts (`ops.bitplane`) instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.semantics import SemanticsConfig, make_semantics
from ..core.types import Level
from ..ops.bitplane import pack_level, reset_bits, rollout_actions_bits, tile_code
from ..utils.platform import resolve_device
from .spaces import Discrete


class VectorGridEnv:
    """B envs stepped in lockstep — B copies of one shared level, or one
    env per level of a BATCHED (N, H, W) level (e.g. N distinct mazes;
    `num_envs` then defaults to N).

    >>> venv = VectorGridEnv(level, num_envs=1024, max_episode_steps=200)
    >>> obs = venv.reset()
    >>> obs, reward, terminated, truncated = venv.step(actions)  # all (B,)
    """

    def __init__(
        self,
        level: Level,
        num_envs: int | None = None,
        max_episode_steps: int | None = None,
        config: SemanticsConfig | None = None,
        *,
        device=None,
    ):
        self.config = config or SemanticsConfig()
        if level.grid.dim() == 3:
            n_levels = int(level.grid.shape[0])
            if num_envs is None:
                num_envs = n_levels
            elif int(num_envs) != n_levels:
                raise ValueError(
                    f"batched level has {n_levels} levels; num_envs must "
                    f"match (got {num_envs}) — one env per level"
                )
        elif num_envs is None:
            raise ValueError("num_envs is required for a shared level")
        self.num_envs = int(num_envs)
        self.max_episode_steps = max_episode_steps
        self.device = resolve_device(device)
        self._sem = make_semantics(self.config, device=self.device)
        self._bl = pack_level(level, device=self.device)
        self._state = reset_bits(self._bl, self.num_envs)

        self.single_action_space = Discrete(self.config.num_actions)
        self.single_observation_space = Discrete(self._bl.num_states)

    def reset(self) -> np.ndarray:
        self._state = reset_bits(self._bl, self.num_envs)
        return self._state.agent_idx.cpu().numpy()

    def step(self, actions) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        actions = np.ascontiguousarray(actions, np.int32)
        if actions.shape != (self.num_envs,):
            raise ValueError(
                f"actions must have shape ({self.num_envs},); got {actions.shape}"
            )
        if actions.min() < 0 or actions.max() >= self.config.num_actions:
            raise ValueError("action out of range")
        a = torch.from_numpy(actions).to(self.device).reshape(1, self.num_envs)
        self._state, (obs, reward, done) = rollout_actions_bits(
            self._sem, self._bl, self._state, a, True, self.max_episode_steps
        )
        obs, reward, done = obs[0], reward[0], done[0]
        term = self._sem.terminal[tile_code(self._bl, obs).long()]
        return (
            obs.cpu().numpy(),
            reward.cpu().numpy(),
            term.cpu().numpy(),
            (done & ~term).cpu().numpy(),
        )
