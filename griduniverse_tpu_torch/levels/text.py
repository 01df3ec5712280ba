"""Text-level I/O — parse character maps into `Level`s.

Counterpart of `griduniverse_tpu/levels/text.py`. Parsing is host-side
NumPy, done once; the result is uploaded through `make_level`.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence, Tuple

import numpy as np

from ..core import semantics as S
from ..core.types import Level, make_level


class LevelParseError(ValueError):
    """Malformed level text."""


def parse_text_grid(
    text: str,
    char_to_tile: Mapping[str, int] = S.DEFAULT_CHAR_TO_TILE,
    start_chars: Sequence[str] = S.DEFAULT_START_CHARS,
) -> Tuple[np.ndarray, int]:
    """Parse a multi-line character map into (grid int32 (H,W), start_idx).

    Rules: one char per tile; rows must be equal length; exactly one start
    char (the tile under the start is EMPTY); unknown chars raise.
    """
    lines = [ln for ln in text.splitlines() if ln.strip() != ""]
    if not lines:
        raise LevelParseError("empty level text")
    width = len(lines[0])
    starts = []
    rows = []
    for r, ln in enumerate(lines):
        if len(ln) != width:
            raise LevelParseError(
                f"ragged level: row {r} has length {len(ln)}, expected {width}"
            )
        row = np.zeros(width, dtype=np.int32)
        for c, ch in enumerate(ln):
            if ch in start_chars:
                starts.append((r, c))
                row[c] = S.EMPTY
            elif ch in char_to_tile:
                row[c] = char_to_tile[ch]
            else:
                raise LevelParseError(f"unknown tile char {ch!r} at row {r} col {c}")
        rows.append(row)
    grid = np.stack(rows)
    if len(starts) != 1:
        raise LevelParseError(f"level must have exactly 1 start, found {len(starts)}")
    sr, sc = starts[0]
    return grid, sr * width + sc


def load_level_file(
    path: str | os.PathLike,
    char_to_tile: Mapping[str, int] = S.DEFAULT_CHAR_TO_TILE,
    start_chars: Sequence[str] = S.DEFAULT_START_CHARS,
    *,
    device=None,
) -> Level:
    """Read a text maze file → Level on `device`."""
    with open(path, "r", encoding="utf-8") as f:
        grid, start_idx = parse_text_grid(f.read(), char_to_tile, start_chars)
    return make_level(grid, start_idx, device=device)


def level_from_text(text: str, *, device=None, **kw) -> Level:
    grid, start_idx = parse_text_grid(text, **kw)
    return make_level(grid, start_idx, device=device)


def render_text(
    grid,
    agent_idx: int | None = None,
    start_idx: int | None = None,
    tile_to_char: Mapping[int, str] = S.DEFAULT_TILE_TO_CHAR,
) -> str:
    """Inverse of parse: grid → ASCII."""
    grid = np.asarray(grid.cpu() if hasattr(grid, "cpu") else grid)
    h, w = grid.shape
    chars = [[tile_to_char[int(grid[r, c])] for c in range(w)] for r in range(h)]
    if start_idx is not None:
        chars[start_idx // w][start_idx % w] = "s"
    if agent_idx is not None:
        chars[agent_idx // w][agent_idx % w] = "A"
    return "\n".join("".join(row) for row in chars)
