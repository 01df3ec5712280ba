"""Gymnasium adapter — the modern 5-tuple API over the same core.

Counterpart of `griduniverse_tpu/compat/gymnasium_env.py`. The reference
predates gymnasium (the classic 4-tuple gym API); this adapter plugs the
port into any gymnasium-compatible stack:

  * `reset(seed=..., options=...) → (obs, info)`
  * `step(a) → (obs, reward, terminated, truncated, info)` — time-limit
    truncation is reported SEPARATELY from environment termination
    (goal/lava), unlike the classic wrapper's folded `done`.
  * `register_envs()` adds `GridUniverseTorch-v0` to the gymnasium
    registry, so `gymnasium.make("GridUniverseTorch-v0", grid_shape=(8, 8))`
    works. The ID is the port's own: the JAX package registers
    `GridUniverseTpu-v0`, and since `register_envs` keeps the first entry
    of an ID, a shared ID would let `gymnasium.make` hand back whichever
    package registered first.

The constructor takes `GridUniverseEnv`'s keyword arguments, `backend` and
`device` among them (default: K2 on the card). Gated on the `gymnasium`
import: everything raises a helpful error if gymnasium is absent (it is
not a dependency of the core).
"""

from __future__ import annotations

from typing import Any

import numpy as np

try:
    import gymnasium

    _HAS_GYMNASIUM = True
except ImportError:  # pragma: no cover - gymnasium is available in CI
    _HAS_GYMNASIUM = False

from .gym_env import GridUniverseEnv

ENV_ID = "GridUniverseTorch-v0"


def _require_gymnasium():
    if not _HAS_GYMNASIUM:
        raise RuntimeError(
            "gymnasium is required for the gymnasium adapter; "
            "use compat.gym_env.GridUniverseEnv (no dependency) instead"
        )


if _HAS_GYMNASIUM:

    class GridUniverseGymnasiumEnv(gymnasium.Env):
        """gymnasium.Env over the classic wrapper (same constructor kwargs
        as `GridUniverseEnv`, plus gymnasium's `render_mode`)."""

        metadata = {"render_modes": ["human", "ansi", "rgb_array"], "render_fps": 8}

        def __init__(
            self,
            render_mode: str | None = None,
            max_episode_steps: int | None = None,
            **kwargs: Any,
        ):
            if render_mode is not None and render_mode not in self.metadata[
                "render_modes"
            ]:
                raise ValueError(f"unsupported render_mode {render_mode!r}")
            self.render_mode = render_mode
            self._max_episode_steps = max_episode_steps
            # truncation is handled HERE (split flag), not by the inner env
            kwargs.pop("max_steps", None)
            self._env = GridUniverseEnv(**kwargs)
            self._t = 0
            self.action_space = gymnasium.spaces.Discrete(self._env.action_space.n)
            self.observation_space = gymnasium.spaces.Discrete(
                self._env.observation_space.n
            )

        def reset(self, *, seed: int | None = None, options: dict | None = None):
            super().reset(seed=seed)
            if seed is not None:
                self._env.seed(seed)
            obs = self._env.reset()
            self._t = 0
            return np.int64(obs), {}

        def step(self, action):
            obs, reward, done, info = self._env.step(int(action))
            self._t += 1
            terminated = done
            truncated = (
                self._max_episode_steps is not None
                and self._t >= self._max_episode_steps
                and not terminated
            )
            return np.int64(obs), float(reward), terminated, truncated, info

        def render(self):
            if self.render_mode is None:
                return None
            return self._env.render(mode=self.render_mode)

        def close(self):
            self._env.close()

else:  # pragma: no cover - gymnasium is available in CI

    class GridUniverseGymnasiumEnv:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            _require_gymnasium()


def register_envs() -> None:
    """Idempotently register `GridUniverseTorch-v0` with gymnasium."""
    _require_gymnasium()
    if ENV_ID not in gymnasium.registry:
        gymnasium.register(
            id=ENV_ID,
            entry_point=(
                "griduniverse_tpu_torch.compat.gymnasium_env:GridUniverseGymnasiumEnv"
            ),
        )
