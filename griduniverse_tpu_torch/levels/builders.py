"""Programmatic level builders — counterpart of
`griduniverse_tpu/levels/builders.py`. Host-side NumPy, then one upload.
They also give the canonical levels of the BASELINE configs: config 1
(8×8 empty), config 2 (16×16 walls+goal), config 3 (lava text level).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import semantics as S
from ..core.types import Level, make_level


def build_grid(
    shape: tuple[int, int],
    walls: Sequence[int] = (),
    lava: Sequence[int] = (),
    goals: Sequence[int] = (),
) -> np.ndarray:
    """Build an (H, W) int32 tile-code grid from row-major index lists."""
    h, w = shape
    grid = np.full((h, w), S.EMPTY, dtype=np.int32)
    flat = grid.reshape(-1)
    for idx in walls:
        flat[idx] = S.WALL
    for idx in lava:
        flat[idx] = S.LAVA
    for idx in goals:
        flat[idx] = S.GOAL
    return grid


def make_level_from_indices(
    shape: tuple[int, int],
    start_idx: int = 0,
    walls: Sequence[int] = (),
    lava: Sequence[int] = (),
    goals: Sequence[int] = (),
    *,
    device=None,
) -> Level:
    """`GridUniverseEnv(grid_shape, walls, lava, goal)`-equivalent ctor."""
    grid = build_grid(shape, walls, lava, goals)
    if grid.reshape(-1)[start_idx] != S.EMPTY:
        raise ValueError("start_idx must be an empty tile")
    return make_level(grid, start_idx, device=device)


def empty_level(
    h: int = 8, w: int | None = None, goal: bool = False, *, device=None
) -> Level:
    """BASELINE config 1: empty H×W grid, start at 0; optional goal at the
    far corner."""
    w = h if w is None else w
    goals = [h * w - 1] if goal else []
    return make_level_from_indices((h, w), start_idx=0, goals=goals, device=device)


def walls_and_goal_16x16(*, device=None) -> Level:
    """BASELINE config 2: 16×16 grid with two partial walls making a winding
    route from the top-left start to the bottom-right goal."""
    h = w = 16
    walls = []
    # vertical wall at col 5, rows 0..11 (gap at bottom)
    walls += [r * w + 5 for r in range(0, 12)]
    # vertical wall at col 10, rows 4..15 (gap at top)
    walls += [r * w + 10 for r in range(4, 16)]
    return make_level_from_indices(
        (h, w), start_idx=0, walls=walls, goals=[h * w - 1], device=device
    )


# BASELINE config 3: lava/pit terminal-state text level. Goal at the center
# with a single safe entrance from the east; lava gates north/south/west
# punish shortcuts. Every open tile is reachable without crossing lava.
LAVA_CROSSING_9x9 = """\
soooooooo
o###l###o
o#ooooo#o
o#o###o#o
loo#goooo
o#o###o#o
o#ooooo#o
o###l###o
ooooooooo
"""


def lava_level(*, device=None) -> Level:
    from .text import level_from_text

    return level_from_text(LAVA_CROSSING_9x9, device=device)
