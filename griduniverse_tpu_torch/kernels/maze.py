"""Wrappers of K3 (`csrc/maze.cu`) and K11 (`csrc/backtracker.cu`): check,
allocate, launch.

The plain PyTorch versions are `levels.maze.aldous_broder_mazes_reference`
and `levels.maze.backtracker_mazes_reference`.
"""

from __future__ import annotations

import torch

from ..ops.bitplane import MAX_PACKED_STATES
from . import LAUNCHES
from .build import check_int, check_tensor, launch

# Mazes up to this many cells keep their per-maze arrays in local memory;
# larger ones take a scratch buffer (`csrc/maze.cu`, `csrc/backtracker.cu`).
MAX_LOCAL_CELLS = 256


def _check_cells(cells) -> tuple[int, int]:
    """The largest maze is one whose grid (2ch+1)(2cw+1) the port can pack."""
    ch, cw = (int(c) for c in cells)
    if ch < 1 or cw < 1 or (2 * ch + 1) * (2 * cw + 1) > MAX_PACKED_STATES:
        raise ValueError(
            f"cells {cells}: the grid (2ch+1)(2cw+1) must hold 1..{MAX_PACKED_STATES} states"
        )
    return ch, cw


def aldous_broder_mazes_cuda(
    cells: tuple[int, int],
    batch_size: int,
    max_iters: int,
    *,
    directions: torch.Tensor | None = None,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """Launch K3 on `device` (or on the device of `directions`). Injected
    mode walks maze b by `directions[t, b]` (int8, at least `max_iters`
    rows); seeded mode draws from per-maze xorshift32 streams keyed by
    `seed`. Returns (B, 2ch+1, 2cw+1) int32 grids."""
    ch, cw = _check_cells(cells)
    batch_size = check_int("batch_size", batch_size, low=1)
    max_iters = check_int("max_iters", max_iters)
    device = torch.device(device) if directions is None else directions.device
    if device.type != "cuda":
        raise ValueError(f"aldous_broder_mazes_cuda takes a CUDA device, got {device}")
    dirs_ptr = None
    if directions is not None:
        rows = int(directions.shape[0]) if directions.dim() == 2 else 0
        if rows < max_iters:
            raise ValueError(f"directions has {rows} rows, fewer than max_iters={max_iters}")
        dirs_ptr = check_tensor(
            "directions", directions, torch.int8, (rows, batch_size), device
        )
    seed = int(seed) & 0xFFFFFFFF
    seed = seed - (1 << 32) if seed >= (1 << 31) else seed  # C int, same bits
    grids = torch.empty(
        (batch_size, 2 * ch + 1, 2 * cw + 1), dtype=torch.int32, device=device
    )
    scratch = None
    if ch * cw > MAX_LOCAL_CELLS:  # one byte a cell and maze
        scratch = torch.empty(ch * cw * batch_size, dtype=torch.uint8, device=device)
    launch(
        "gu_aldous_broder_mazes", device,
        ch, cw, batch_size, max_iters, dirs_ptr, seed, grids.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
    )
    LAUNCHES["aldous_broder_mazes"] += 1
    return grids


def backtracker_mazes_cuda(
    cells: tuple[int, int], batch_size: int, *, seed: int = 0, device=None
) -> torch.Tensor:
    """Launch K11 on `device`: one recursive-backtracker maze a thread from
    the per-maze xorshift32 streams keyed by `seed`. Returns (B, 2ch+1,
    2cw+1) int32 grids."""
    ch, cw = _check_cells(cells)
    batch_size = check_int("batch_size", batch_size, low=1)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"backtracker_mazes_cuda takes a CUDA device, got {device}")
    seed = int(seed) & 0xFFFFFFFF
    seed = seed - (1 << 32) if seed >= (1 << 31) else seed  # C int, same bits
    grids = torch.empty(
        (batch_size, 2 * ch + 1, 2 * cw + 1), dtype=torch.int32, device=device
    )
    scratch = None
    if ch * cw > MAX_LOCAL_CELLS:  # ⌈S/32⌉ visited words and S two-byte ids a maze
        n_words = (ch * cw + 31) // 32
        scratch = torch.empty(
            (n_words * 4 + ch * cw * 2) * batch_size, dtype=torch.uint8, device=device
        )
    launch(
        "gu_backtracker_mazes", device, ch, cw, batch_size, seed, grids.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
    )
    LAUNCHES["backtracker_mazes"] += 1
    return grids
