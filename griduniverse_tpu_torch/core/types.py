"""Core containers: Level, EnvState, StepResult.

PyTorch counterpart of `griduniverse_tpu/core/types.py`. The containers are
plain dataclasses of tensors. Batching is written out: every `EnvState`
field has a leading env axis (B=1 for a single env), and a `Level` is either
shared, with an (H, W) grid, or per env, with a (B, H, W) grid.

`EnvState` has no PRNG key: the dynamics never read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.platform import resolve_device


@dataclasses.dataclass
class Level:
    """A gridworld level: static tile codes + start position.

    grid      — (H, W) int32 tile codes, or (B, H, W) for one level per env.
    start_idx — () int32 row-major start state, or (B,) for per-env levels.
    """

    grid: torch.Tensor
    start_idx: torch.Tensor

    @property
    def height(self) -> int:
        return int(self.grid.shape[-2])

    @property
    def width(self) -> int:
        return int(self.grid.shape[-1])

    @property
    def num_states(self) -> int:
        return self.height * self.width

    @property
    def batched(self) -> bool:
        return self.grid.dim() == 3

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def to(self, device) -> "Level":
        return Level(grid=self.grid.to(device), start_idx=self.start_idx.to(device))


def make_level(grid, start_idx, *, device=None) -> Level:
    """Validate a host grid (H, W) or a batch of grids (B, H, W) and upload
    it to `device` (default: the card). `start_idx` is an int, or one int
    per grid."""
    device = resolve_device(device)
    grid = np.asarray(grid, dtype=np.int32)
    if grid.ndim not in (2, 3):
        raise ValueError(
            f"level grid must be (H, W) or (B, H, W); got shape {grid.shape}"
        )
    n = grid.shape[-2] * grid.shape[-1]
    start = np.asarray(start_idx, dtype=np.int32)
    if grid.ndim == 3 and start.ndim == 0:
        start = np.full((grid.shape[0],), int(start), np.int32)
    if start.shape != grid.shape[:-2]:
        raise ValueError(
            f"start_idx shape {start.shape} does not match grid batch {grid.shape[:-2]}"
        )
    if not ((start >= 0) & (start < n)).all():
        raise ValueError(f"start_idx {start_idx} out of range for {grid.shape} grid")
    return Level(
        grid=torch.as_tensor(grid, device=device),
        start_idx=torch.as_tensor(start, device=device),
    )


@dataclasses.dataclass
class EnvState:
    """Per-env dynamic state, each field (B,).

    agent_idx — int32 row-major state index of the agent.
    t         — int32 steps taken this episode.
    done      — bool  episode finished (frozen until reset / auto-reset).
    """

    agent_idx: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class StepResult:
    """What `step` returns beside the new state: the Gym 4-tuple minus info.

    obs    — int32 observation = agent state index (Discrete(H*W)).
    reward — float32.
    done   — bool.

    Fields are (B,) for one step and (T, B) for a rollout.
    """

    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
