"""Wrappers of K3 (`csrc/maze.cu`) and K11 (`csrc/backtracker.cu`): plan,
check, allocate, launch.

Both kernels keep each maze's spanning tree in shared memory, four bits a
cell, word-major over a block's mazes (`csrc/maze_tree.cuh`), and each
block writes its grids once, coalesced. `plan` cuts a call into blocks. The
plain PyTorch versions are `levels.maze.aldous_broder_mazes_reference` and
`levels.maze.backtracker_mazes_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.bitplane import MAX_PACKED_STATES
from . import LAUNCHES
from .build import check_int, check_tensor, launch

WARP = 32
THREADS = 128                # a block: its walking warps, then all four write its grids
MAX_WARPS = THREADS // WARP  # walking warps a block at most
TARGET_BLOCKS = 132          # a block for each of the H100's SMs before a block walks more warps
SHARED_LIMIT = 227 * 1024    # the H100's opt-in shared memory a block


class Plan(NamedTuple):
    """A call's cut: `warps` walking warps a block (a maze a thread, 32·warps
    mazes a block) in `blocks` blocks of THREADS threads, `shared` bytes of
    trees a block."""
    warps: int
    blocks: int
    shared: int


def tree_words(cells) -> int:
    """32-bit words of one maze's tree: four bits a cell, ⌈cw/8⌉ words a row."""
    ch, cw = cells
    return ch * -(-cw // 8)


def plan(cells, batch: int) -> Plan:
    """The most walking warps a block, up to MAX_WARPS and halving, that
    still give TARGET_BLOCKS blocks and whose trees fit SHARED_LIMIT; one
    where none does. One warp's trees are 32 · ch · ⌈cw/8⌉ words (63 KB at
    63×63 cells), so every maze the port packs fits. A function of the
    shapes alone; any plan gives the same bits."""
    batch = check_int("batch_size", batch, low=1)
    per_warp = WARP * 4 * tree_words(cells)
    warps_needed = -(-batch // WARP)
    warps = MAX_WARPS
    while warps > 1 and (warps * per_warp > SHARED_LIMIT or -(-warps_needed // warps) < TARGET_BLOCKS):
        warps //= 2
    return Plan(warps, -(-warps_needed // warps), warps * per_warp)


def _check_cells(cells) -> tuple[int, int]:
    """The largest maze is one whose grid (2ch+1)(2cw+1) the port can pack."""
    ch, cw = (int(c) for c in cells)
    if ch < 1 or cw < 1 or (2 * ch + 1) * (2 * cw + 1) > MAX_PACKED_STATES:
        raise ValueError(
            f"cells {cells}: the grid (2ch+1)(2cw+1) must hold 1..{MAX_PACKED_STATES} states"
        )
    return ch, cw


def _c_seed(seed: int) -> int:
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= (1 << 31) else seed  # C int, same bits


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
    p = plan((ch, cw), batch_size)
    grids = torch.empty(
        (batch_size, 2 * ch + 1, 2 * cw + 1), dtype=torch.int32, device=device
    )
    launch(
        "gu_aldous_broder_mazes", device,
        ch, cw, batch_size, max_iters, dirs_ptr, _c_seed(seed), grids.data_ptr(),
        WARP * p.warps, p.shared,
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
    p = plan((ch, cw), batch_size)
    grids = torch.empty(
        (batch_size, 2 * ch + 1, 2 * cw + 1), dtype=torch.int32, device=device
    )
    launch(
        "gu_backtracker_mazes", device, ch, cw, batch_size, _c_seed(seed), grids.data_ptr(),
        WARP * p.warps, p.shared,
    )
    LAUNCHES["backtracker_mazes"] += 1
    return grids
