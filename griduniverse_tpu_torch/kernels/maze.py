"""Wrappers of K3 (`csrc/maze.cu`) and K11 (`csrc/backtracker.cu`): plan,
check, allocate, launch.

Both kernels keep each maze's spanning tree in shared memory, four bits a
cell, word-major over a block's mazes (`csrc/maze_tree.cuh`), and each
block writes its grids once, coalesced. `plan` cuts a call into blocks:
up to 128 mazes a block, fewer where their trees do not fit, and where not
even one does, one a block with its tree in a device-memory scratch. The
plain PyTorch versions are `levels.maze.aldous_broder_mazes_reference` and
`levels.maze.backtracker_mazes_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

WARP = 32
THREADS = 128                # a block: its walking lanes, then all 128 threads write its grids
MAX_WARPS = THREADS // WARP  # walking warps a block at most
TARGET_BLOCKS = 132          # a block for each of the H100's SMs before a block walks more warps
SHARED_LIMIT = 227 * 1024    # the H100's opt-in shared memory a block
STATIC_SHARED = 256          # of it, kept for the kernels' own static shared memory (K11's pick table)


class Plan(NamedTuple):
    """A call's cut: `mazes` walking lanes a block (a maze a lane: 128, 64,
    ..., 1) in `blocks` blocks of THREADS threads, `shared` bytes of trees a
    block; or, where one maze's tree does not fit a block (`shared` 0), one
    maze a block with its tree among the `scratch` words of device memory."""
    mazes: int
    blocks: int
    shared: int
    scratch: int

    @property
    def warps(self) -> int:
        """Warps a block with a walking lane."""
        return -(-self.mazes // WARP)


def tree_words(cells) -> int:
    """32-bit words of one maze's tree: four bits a cell, ⌈cw/8⌉ words a row."""
    ch, cw = cells
    return ch * -(-cw // 8)


def plan(cells, batch: int) -> Plan:
    """The most mazes a block, from MAX_WARPS warps' worth down to one and
    halving, whose trees fit SHARED_LIMIT less STATIC_SHARED; above one
    warp's worth, only while the blocks still number TARGET_BLOCKS. One
    warp's trees are 32 · ch · ⌈cw/8⌉ words (63 KB at 63×63 cells, 227 KB
    at about 120×120); one maze's tree fits up to 58,048 words (680×680
    cells). Above that the trees live in device memory, one maze a block.
    A function of the shapes alone; any plan gives the same bits."""
    batch = check_int("batch_size", batch, low=1)
    per_maze = 4 * tree_words(cells)
    room = SHARED_LIMIT - STATIC_SHARED
    if per_maze > room:
        return Plan(1, batch, 0, batch * tree_words(cells))
    mazes = MAX_WARPS * WARP
    while mazes > WARP and (mazes * per_maze > room or -(-batch // mazes) < TARGET_BLOCKS):
        mazes //= 2
    while mazes > 1 and mazes * per_maze > room:
        mazes //= 2
    return Plan(mazes, -(-batch // mazes), mazes * per_maze, 0)


def _check_cells(cells) -> tuple[int, int]:
    """Any lattice of at least one cell; the grid and, where used, the
    scratch are allocated before the launch, so a maze too large for the
    card raises torch's out-of-memory error there."""
    ch, cw = (int(c) for c in cells)
    if ch < 1 or cw < 1:
        raise ValueError(f"cells {cells}: a maze needs at least one cell each way")
    return check_int("cell rows", ch, low=1), check_int("cell columns", cw, low=1)


def _scratch(p: Plan, device) -> torch.Tensor | None:
    """The device tier's trees: p.scratch words, written before they are read."""
    return None if p.scratch == 0 else torch.empty(p.scratch, dtype=torch.int32, device=device)


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
    max_iters = int(max_iters)
    if not 0 <= max_iters < 1 << 63:
        raise ValueError(f"max_iters must be in [0, 2^63), got {max_iters}")
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
    scratch = _scratch(p, device)
    launch(
        "gu_aldous_broder_mazes", device,
        ch, cw, batch_size, max_iters, dirs_ptr, _c_seed(seed), grids.data_ptr(),
        p.mazes, p.shared, None if scratch is None else scratch.data_ptr(),
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
    scratch = _scratch(p, device)
    launch(
        "gu_backtracker_mazes", device, ch, cw, batch_size, _c_seed(seed), grids.data_ptr(),
        p.mazes, p.shared, None if scratch is None else scratch.data_ptr(),
    )
    LAUNCHES["backtracker_mazes"] += 1
    return grids
