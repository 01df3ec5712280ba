"""Pure-NumPy oracle environment — the parity fixture, and the host step
of the compat env's `backend="numpy"`.

Counterpart of `griduniverse_tpu/utils/oracle.py`, copied: a deliberately
naive NumPy implementation of the reference's step semantics, reading its
constants from the port's `SemanticsConfig.numpy_tables()`, so the oracle
and the torch engine move together when the config changes. The port keeps
its own copy because it imports nothing of the JAX package.

The oracle mirrors the reference's mutable-object style: a stateful class
with `reset()` and `step(action) -> (obs, reward, done, info)`.
"""

from __future__ import annotations

import numpy as np

from ..core.semantics import SemanticsConfig


class OracleGridEnv:
    """Stateful NumPy gridworld with the reference's step semantics.

    Post-terminal convention matches core.step: `step` after done freezes
    (reward 0.0, state unchanged) unless `auto_reset=True`, in which case the
    terminal transition is returned and the internal state resets to start.
    """

    def __init__(
        self,
        grid: np.ndarray,
        start_idx: int,
        config: SemanticsConfig | None = None,
        auto_reset: bool = False,
        max_episode_steps: int | None = None,
    ):
        self.config = config or SemanticsConfig()
        passable, terminal, reward, deltas = self.config.numpy_tables()
        self._passable = passable
        self._terminal = terminal
        self._reward = reward
        self._deltas = deltas

        self.grid = np.asarray(grid, dtype=np.int32)
        if self.grid.ndim != 2:
            raise ValueError("grid must be 2-D")
        self.h, self.w = self.grid.shape
        self.start_idx = int(start_idx)
        self.auto_reset = bool(auto_reset)
        if max_episode_steps is not None and not auto_reset:
            raise ValueError("max_episode_steps requires auto_reset=True")
        self.max_episode_steps = max_episode_steps

        self.agent_idx = self.start_idx
        self.t = 0
        self.done = False

    # -- Gym-style API (reference: SURVEY.md §3.1/§3.2) ---------------------
    def reset(self) -> int:
        self.agent_idx = self.start_idx
        self.t = 0
        self.done = False
        return self.agent_idx

    def look_step_ahead(self, state: int, action: int):
        """Pure model lookahead, no env mutation — the reference DP helper."""
        row, col = divmod(int(state), self.w)
        drow, dcol = self._deltas[int(action)]
        nrow, ncol = row + int(drow), col + int(dcol)
        if not (0 <= nrow < self.h and 0 <= ncol < self.w):
            new_idx = int(state)  # off-grid: stay
        else:
            cand = nrow * self.w + ncol
            code = int(self.grid.flat[cand])
            new_idx = int(state) if not self._passable[code] else cand
        new_code = int(self.grid.flat[new_idx])
        reward = np.float32(self._reward[new_code])
        done = bool(self._terminal[new_code])
        return new_idx, reward, done

    def is_terminal(self, state: int) -> bool:
        return bool(self._terminal[int(self.grid.flat[int(state)])])

    def step(self, action: int):
        if self.done and not self.auto_reset:
            # frozen post-terminal (matches core.step.step)
            return self.agent_idx, np.float32(0.0), True, {}

        new_idx, reward, done = self.look_step_ahead(self.agent_idx, action)
        self.t += 1
        truncated = (
            self.max_episode_steps is not None
            and self.t >= self.max_episode_steps
        )
        if (done or truncated) and self.auto_reset:
            obs = new_idx  # terminal transition's obs
            self.reset()
            return obs, reward, True, {}
        self.agent_idx = new_idx
        self.done = done
        return self.agent_idx, reward, done, {}

    # -- batch runner for parity tests --------------------------------------
    def run_actions(self, actions: np.ndarray):
        """Step through a pre-drawn action array; returns (obs, reward, done)
        trajectories as arrays for bit-comparison against a batched rollout."""
        n = len(actions)
        obs = np.zeros(n, dtype=np.int32)
        rew = np.zeros(n, dtype=np.float32)
        don = np.zeros(n, dtype=bool)
        for i, a in enumerate(actions):
            o, r, d, _ = self.step(int(a))
            obs[i], rew[i], don[i] = o, r, d
        return obs, rew, don
