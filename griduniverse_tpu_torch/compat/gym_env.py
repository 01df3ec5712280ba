"""Gym-style single-env class — the reference's user-facing API.

Counterpart of `griduniverse_tpu/compat/gym_env.py`: `GridUniverseEnv` with
`reset() → obs`, `step(action) → (obs, reward, done, info)` (the classic
4-tuple gym API), `render(mode)`, `look_step_ahead(state, action)`,
`is_terminal(state)`, `action_space`, `observation_space`, and the
constructor forms `grid_shape` / `walls` / `lava` / `goal_states` /
`start_state` / `custom_world_fp` / `random_maze`.

Two interchangeable backends, bit for bit alike:

  * `backend="torch"` (default) — steps on `device` (default: the card)
    with `core.step`'s semantics, as the reference's `backend="jax"` does.
    At most `MAX_PACKED_STATES` states the level is packed once
    (`ops.bitplane.pack_level`), the env holds a B = 1 `FastState` and each
    `step` is one launch of K2 (`rollout_actions_bits` over a (1, 1) action,
    freeze after done). Above it the env holds a B = 1 `EnvState` and steps
    the generic gather-based `core.step.step`. The size picks the path once,
    in the constructor.
  * `backend="numpy"` — the port's NumPy oracle (`utils.oracle`) steps on
    the host, as the reference's default does; nothing touches a device.

`backend="jax"` names the reference's engine, which the port replaces by
`"torch"`. The `max_steps` truncation sits in this wrapper for both
backends, and `look_step_ahead` / `is_terminal` read the oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import semantics as S
from ..core.semantics import SemanticsConfig, make_semantics
from ..core.types import Level, make_level
from ..levels.builders import build_grid
from ..levels.maze import generate_maze_numpy
from ..levels.text import load_level_file, render_text
from ..core import step as core_step
from ..ops.bitplane import MAX_PACKED_STATES, pack_level, reset_bits, rollout_actions_bits
from ..utils.oracle import OracleGridEnv
from ..utils.platform import resolve_device
from .spaces import Discrete

BACKENDS = ("torch", "numpy")


class GridUniverseEnv:
    """Drop-in replacement for the reference's `GridUniverseEnv`.

    Constructor forms:
      * `GridUniverseEnv(grid_shape=(8, 8))` — empty grid
      * `GridUniverseEnv(grid_shape, walls=[…], lava=[…], goal_states=[…])`
      * `GridUniverseEnv(custom_world_fp="level.txt")`
      * `GridUniverseEnv(random_maze=True, grid_shape=(9, 9), seed=0)`
        (grid_shape must be odd-sized for a (2n+1) maze lattice)

    `backend` — "torch" (default: on `device`, the card unless given; K2
    up to `MAX_PACKED_STATES` states, `core.step` above) or "numpy" (the
    host oracle; `device` is not used).
    """

    metadata = {"render_modes": ["human", "ansi", "rgb_array"]}

    def __init__(
        self,
        grid_shape: tuple[int, int] = (8, 8),
        walls: Sequence[int] | None = None,
        lava: Sequence[int] | None = None,
        goal_states: Sequence[int] | None = None,
        start_state: int = 0,
        custom_world_fp: str | None = None,
        random_maze: bool = False,
        seed: int | None = None,
        config: SemanticsConfig | None = None,
        max_steps: int | None = None,
        backend: str = "torch",
        device=None,
    ):
        if backend == "jax":
            raise ValueError(
                'backend="jax" is the JAX package\'s engine; the port steps '
                'with backend="torch" (or the host oracle, backend="numpy")'
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend: {backend!r}; expected one of {BACKENDS}")
        self.backend = backend
        self.config = config or SemanticsConfig()
        self.device = resolve_device(device) if backend == "torch" else torch.device("cpu")

        if custom_world_fp is not None:
            self.level: Level = load_level_file(custom_world_fp, device=self.device)
        elif random_maze:
            h, w = grid_shape
            if h % 2 == 0 or w % 2 == 0:
                raise ValueError(
                    "random_maze grids must be odd-sized (2n+1 lattice); "
                    f"got {grid_shape}"
                )
            cells = ((h - 1) // 2, (w - 1) // 2)
            grid = generate_maze_numpy(cells, np.random.default_rng(seed))
            grid[grid.shape[0] - 2, grid.shape[1] - 2] = S.GOAL
            self.level = make_level(grid, grid.shape[1] + 1, device=self.device)
        else:
            grid = build_grid(grid_shape, walls or (), lava or (), goal_states or ())
            if grid.reshape(-1)[start_state] != S.EMPTY:
                raise ValueError("start_state must be an empty tile")
            self.level = make_level(grid, start_state, device=self.device)
        self.max_steps = max_steps

        self.action_space = Discrete(self.config.num_actions, seed=seed)
        self.observation_space = Discrete(self.level.num_states, seed=seed)

        # host copies for render; the oracle serves lookahead/is_terminal and
        # (backend="numpy") the step loop itself
        self._grid_np = self.level.grid.cpu().numpy()
        self._start_idx = int(self.level.start_idx)
        self._oracle = OracleGridEnv(self._grid_np, self._start_idx, self.config)
        # the bit-packed engine (K2) up to its limit, the gather-based step above
        self._packed = backend == "torch" and self.level.num_states <= MAX_PACKED_STATES
        if backend == "torch":
            self._sem = make_semantics(self.config, device=self.device)
            # each action's (1, 1) tensor for K2, or (1,) for core.step, made
            # once, so a step uploads nothing
            a = self.config.num_actions
            shape = (a, 1, 1) if self._packed else (a, 1)
            self._actions = torch.arange(a, dtype=torch.int32, device=self.device).reshape(shape)
            self._bl = pack_level(self.level) if self._packed else None
            self.reset()

    # ------------------------------------------------------------------ API
    def reset(self) -> int:
        if self.backend == "numpy":
            return self._oracle.reset()
        if self._packed:
            self._state = reset_bits(self._bl, 1)
        else:
            self._state = core_step.reset(self.level, 1)
        return self._start_idx

    def step(self, action) -> tuple[int, float, bool, dict]:
        if not self.action_space.contains(action):
            raise ValueError(
                f"invalid action {action!r}; expected 0..{self.action_space.n - 1}"
            )
        if self.backend == "numpy":
            obs, reward, done, info = self._oracle.step(int(action))
        else:
            if self._packed:
                self._state, (obs, reward, done) = rollout_actions_bits(
                    self._sem, self._bl, self._state, self._actions[int(action)]
                )
            else:
                self._state, out = core_step.step(
                    self._sem, self.level, self._state, self._actions[int(action)]
                )
                obs, reward, done = out.obs, out.reward, out.done
            obs, reward, done, info = obs.item(), reward.item(), done.item(), {}
        if self.max_steps is not None and not done and self._episode_steps() >= self.max_steps:
            done, info = True, {"TimeLimit.truncated": True}
        return int(obs), float(reward), bool(done), dict(info)

    def _episode_steps(self) -> int:
        if self.backend == "numpy":
            return self._oracle.t
        return int(self._state.t.item())

    def render(self, mode: str = "human"):
        if mode == "rgb_array":
            from .rendering import rgb_render

            return rgb_render(
                self._grid_np,
                agent_idx=self.current_state,
                start_idx=self._start_idx,
            )
        if mode == "graphic":
            # The reference's 'graphic' mode opened a pyglet window with tile
            # sprites. pyglet needs a display; headless environments get the
            # same pixels via mode='rgb_array' or compat.rendering.episode_gif.
            try:
                import pyglet  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "render(mode='graphic') needs pyglet + a display; this "
                    "environment has neither. Use mode='rgb_array' for the "
                    "same pixels, or compat.rendering.episode_gif for an "
                    "episode animation."
                ) from e
            return self._render_pyglet()
        text = render_text(
            self._grid_np,
            agent_idx=self.current_state,
            start_idx=self._start_idx,
        )
        if mode == "ansi":
            return text
        print(text)
        return None

    def _render_pyglet(self):  # pragma: no cover - needs a display
        """Blit the rgb_array frame into a pyglet window (the reference's
        'graphic' mode). Only reachable when pyglet imports (see render)."""
        import pyglet

        frame = self.render(mode="rgb_array")
        h, w, _ = frame.shape
        if not hasattr(self, "_window") or self._window is None:
            self._window = pyglet.window.Window(width=w, height=h)
        img = pyglet.image.ImageData(
            w, h, "RGB", np.ascontiguousarray(frame[::-1]).tobytes()
        )
        self._window.switch_to()
        self._window.dispatch_events()
        self._window.clear()
        img.blit(0, 0)
        self._window.flip()
        return self._window

    def close(self):
        win = getattr(self, "_window", None)
        if win is not None:  # pragma: no cover - needs a display
            win.close()
            self._window = None

    def seed(self, seed: int | None = None):
        """Reseed the action space's sampler (the dynamics draw nothing)."""
        self.action_space.seed(seed)
        return [seed]

    # -------------------------------------------------- model helpers
    def look_step_ahead(self, state: int, action: int):
        """Pure model lookahead (the reference's DP helper) on the host
        oracle, with no device round trip."""
        new_idx, reward, done = self._oracle.look_step_ahead(state, action)
        return new_idx, float(reward), bool(done)

    def is_terminal(self, state: int) -> bool:
        return self._oracle.is_terminal(state)

    @property
    def num_states(self) -> int:
        return self.level.num_states

    @property
    def current_state(self) -> int:
        if self.backend == "numpy":
            return int(self._oracle.agent_idx)
        return int(self._state.agent_idx.item())

    @property
    def done(self) -> bool:
        if self.backend == "numpy":
            return bool(self._oracle.done)
        return bool(self._state.done.item())
