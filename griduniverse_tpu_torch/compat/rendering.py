"""Graphical rendering, headless — counterpart of
`griduniverse_tpu/compat/rendering.py`, copied onto the port's tile codes.

The reference GridUniverse rendered ASCII to stdout and tile sprites in a
pyglet window. pyglet needs a display, so the same information is rendered
headlessly: an RGB array (`render(mode="rgb_array")` on the compat env)
built with NumPy alone, saved to PNG through matplotlib and to an animated
GIF through Pillow. Each of those libraries is imported inside the call
that needs it, never when this module is imported.

The palette is per tile code and configurable like everything else.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..core import semantics as S

# tile code → RGB (uint8)
DEFAULT_PALETTE: Mapping[int, tuple[int, int, int]] = {
    S.EMPTY: (224, 224, 224),   # light grey floor
    S.WALL: (64, 64, 64),       # dark grey wall
    S.LAVA: (214, 72, 40),      # red-orange lava
    S.GOAL: (66, 165, 80),      # green goal
}
AGENT_COLOR: tuple[int, int, int] = (42, 98, 222)   # blue agent
START_COLOR: tuple[int, int, int] = (180, 200, 235)  # pale blue start tile


def rgb_render(
    grid: np.ndarray,
    agent_idx: int | None = None,
    start_idx: int | None = None,
    scale: int = 16,
    palette: Mapping[int, tuple[int, int, int]] = DEFAULT_PALETTE,
    grid_lines: bool = True,
) -> np.ndarray:
    """Render a tile-code grid to an (H·scale, W·scale, 3) uint8 image."""
    grid = np.asarray(grid)
    h, w = grid.shape
    img = np.zeros((h, w, 3), dtype=np.uint8)
    for code, color in palette.items():
        img[grid == code] = color
    if start_idx is not None:
        img[start_idx // w, start_idx % w] = START_COLOR
    if agent_idx is not None:
        img[agent_idx // w, agent_idx % w] = AGENT_COLOR
    big = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    if grid_lines and scale >= 4:
        big[::scale, :] = big[::scale, :] // 2
        big[:, ::scale] = big[:, ::scale] // 2
    return big


def save_png(image: np.ndarray, path: str) -> None:
    """Write an RGB uint8 array to PNG (matplotlib backend, gated import)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("matplotlib is required for save_png") from e
    plt.imsave(path, image)


def save_gif(
    frames: "list[np.ndarray]", path: str, fps: int = 8, loop: int = 0
) -> None:
    """Write RGB uint8 frames to an animated GIF (Pillow, imported
    here) — the headless stand-in for the reference's pyglet window
    animation."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is baked into the image
        raise RuntimeError("Pillow is required for save_gif") from e
    if not frames:
        raise ValueError("save_gif: no frames")
    images = [Image.fromarray(np.asarray(f, dtype=np.uint8)) for f in frames]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=max(1, round(1000 / fps)),
        loop=loop,
    )


def episode_frames(
    grid: np.ndarray,
    obs_traj: np.ndarray,
    start_idx: int | None = None,
    scale: int = 16,
    palette: Mapping[int, tuple[int, int, int]] = DEFAULT_PALETTE,
) -> "list[np.ndarray]":
    """Render an episode's (T,) observation trajectory (state indices, as
    returned by the rollout/compat APIs) into RGB frames, one per step."""
    obs_traj = np.asarray(obs_traj).reshape(-1)
    return [
        rgb_render(grid, agent_idx=int(o), start_idx=start_idx,
                   scale=scale, palette=palette)
        for o in obs_traj
    ]


def episode_gif(
    grid: np.ndarray,
    obs_traj: np.ndarray,
    path: str,
    start_idx: int | None = None,
    fps: int = 8,
    scale: int = 16,
) -> None:
    """One-call episode animation: trajectory → animated GIF on disk."""
    save_gif(episode_frames(grid, obs_traj, start_idx, scale), path, fps=fps)
