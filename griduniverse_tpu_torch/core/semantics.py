"""Environment semantics table — the single source of truth for parity.

PyTorch counterpart of `griduniverse_tpu/core/semantics.py`. The constants
and `SemanticsConfig` are copied unchanged; `Semantics` is a dataclass of
four small tensors. Each step looks a tile's attributes up with one index
into these tables, and the reward table already folds the per-step cost
into the non-terminal entries, so a step's reward is exactly one lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from ..utils.platform import resolve_device

# Tile codes (int32 on device). START is a parser-level marker only: the
# parser records the start position and stores EMPTY in the grid.
EMPTY: int = 0
WALL: int = 1
LAVA: int = 2
GOAL: int = 3
NUM_TILE_TYPES: int = 4

# Action indices. Default: 0=UP 1=RIGHT 2=DOWN 3=LEFT.
UP: int = 0
RIGHT: int = 1
DOWN: int = 2
LEFT: int = 3
NUM_ACTIONS: int = 4

# Default text-level alphabet: wall '#', empty 'o' (alias '.'), lava 'l',
# goal 'g', start 's'/'x'.
DEFAULT_CHAR_TO_TILE: Mapping[str, int] = {
    "o": EMPTY,
    ".": EMPTY,
    " ": EMPTY,
    "#": WALL,
    "l": LAVA,
    "g": GOAL,
}
DEFAULT_START_CHARS: Tuple[str, ...] = ("s", "x")
DEFAULT_TILE_TO_CHAR: Mapping[int, str] = {
    EMPTY: "o",
    WALL: "#",
    LAVA: "l",
    GOAL: "g",
}


@dataclasses.dataclass(frozen=True)
class SemanticsConfig:
    """Host-side, hashable description of the environment semantics."""

    step_reward: float = -1.0
    goal_reward: float = 10.0
    lava_reward: float = -10.0
    # (drow, dcol) per action, in action-index order.
    action_deltas: Tuple[Tuple[int, int], ...] = (
        (-1, 0),  # UP
        (0, 1),   # RIGHT
        (1, 0),   # DOWN
        (0, -1),  # LEFT
    )

    @property
    def num_actions(self) -> int:
        return len(self.action_deltas)

    def numpy_tables(self):
        """The per-tile-code tables as NumPy arrays."""
        passable = np.array([True, False, True, True], dtype=bool)
        terminal = np.array([False, False, True, True], dtype=bool)
        reward = np.array(
            [self.step_reward, 0.0, self.lava_reward, self.goal_reward],
            dtype=np.float32,
        )
        deltas = np.array(self.action_deltas, dtype=np.int32)
        return passable, terminal, reward, deltas


@dataclasses.dataclass
class Semantics:
    """Device-resident semantics tables.

    passable[t] — (4,) bool: can the agent enter a tile with code t?
    terminal[t] — (4,) bool: does entering code t end the episode?
    reward[t]   — (4,) float32 reward on a step that ENDS on code t.
    deltas[a]   — (A, 2) int32 (drow, dcol) for action a.
    """

    passable: torch.Tensor
    terminal: torch.Tensor
    reward: torch.Tensor
    deltas: torch.Tensor

    @property
    def num_actions(self) -> int:
        return int(self.deltas.shape[0])

    @property
    def device(self) -> torch.device:
        return self.deltas.device

    def to(self, device) -> "Semantics":
        return Semantics(
            passable=self.passable.to(device),
            terminal=self.terminal.to(device),
            reward=self.reward.to(device),
            deltas=self.deltas.to(device),
        )


def make_semantics(
    config: SemanticsConfig | None = None, *, device=None
) -> Semantics:
    """Build the semantics tables from a host config on `device` (default:
    the card)."""
    config = config or SemanticsConfig()
    device = resolve_device(device)
    passable, terminal, reward, deltas = config.numpy_tables()
    return Semantics(
        passable=torch.as_tensor(passable, device=device),
        terminal=torch.as_tensor(terminal, device=device),
        reward=torch.as_tensor(reward, device=device),
        deltas=torch.as_tensor(deltas, device=device),
    )


DEFAULT_CONFIG = SemanticsConfig()
