"""Random maze generation — host generators and the batched device paths.

Counterpart of `griduniverse_tpu/levels/maze.py`.

  * `generate_maze_numpy` (iterative backtracker) and `generate_maze_wilson`
    (uniform spanning trees) are host NumPy, copied unchanged, so the same
    NumPy seed gives the same maze as the reference.
  * `_binary_tree_mazes` and `_sidewinder_mazes` are elementwise torch over
    (B, ch, cw); they take their coins and keys injected, or draw them from
    a `torch.Generator`.
  * `_aldous_broder_mazes` is kernel K3 (`csrc/maze.cu`) on CUDA and
    `aldous_broder_mazes_reference` on the CPU. It walks either by injected
    directions (the reference's draws) or by per-maze xorshift32 streams.
  * `_backtracker_mazes`, the reference's default, is kernel K11
    (`csrc/backtracker.cu`) on CUDA and `backtracker_mazes_reference` on the
    CPU: the iterative backtracker, one xorshift32 round an iteration (the
    plain version keeps an explicit stack; K11 a tree of each cell's way to
    its parent, which the stack always follows).

Maze layout (all paths): `cells = (ch, cw)` maps to a (2ch+1, 2cw+1) grid;
odd (row, col) are cells, even rows/cols are wall lines with passages
carved between neighbours. Start is the top-left cell, goal bottom-right.
"""

from __future__ import annotations

import itertools
import math
from collections import deque

import numpy as np
import torch

from .. import kernels
from ..core import semantics as S
from ..core.types import Level, make_level
from ..kernels.maze import aldous_broder_mazes_cuda, backtracker_mazes_cuda
from ..ops.bitplane import _U32, _mul32, _xorshift_step
from ..utils.platform import resolve_device


def _maze_shape(cells: tuple[int, int]) -> tuple[int, int]:
    ch, cw = cells
    return 2 * ch + 1, 2 * cw + 1


def generate_maze_numpy(
    cells: tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """Iterative-backtracker perfect maze; returns (H, W) int32 tile codes
    (WALL / EMPTY). Host-side parity path."""
    ch, cw = cells
    h, w = _maze_shape(cells)
    grid = np.full((h, w), S.WALL, dtype=np.int32)
    visited = np.zeros((ch, cw), dtype=bool)

    stack = [(0, 0)]
    visited[0, 0] = True
    grid[1, 1] = S.EMPTY
    # fixed neighbor order (up, right, down, left) shuffled per expansion
    deltas = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)])
    while stack:
        r, c = stack[-1]
        order = rng.permutation(4)
        for k in order:
            dr, dc = deltas[k]
            nr, nc = r + dr, c + dc
            if 0 <= nr < ch and 0 <= nc < cw and not visited[nr, nc]:
                visited[nr, nc] = True
                grid[2 * r + 1 + dr, 2 * c + 1 + dc] = S.EMPTY
                grid[2 * nr + 1, 2 * nc + 1] = S.EMPTY
                stack.append((nr, nc))
                break
        else:
            stack.pop()
    return grid


def generate_maze_wilson(
    cells: tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """Wilson's algorithm: loop-erased random walks from each untreed cell
    to the growing tree — a uniform sample over all spanning trees of the
    cell lattice. Loop erasure keeps the latest exit direction of each
    visited cell. Returns (H, W) int32 tile codes (WALL / EMPTY)."""
    ch, cw = cells
    h, w = _maze_shape(cells)
    grid = np.full((h, w), S.WALL, dtype=np.int32)
    in_tree = np.zeros((ch, cw), dtype=bool)
    in_tree[0, 0] = True
    grid[1, 1] = S.EMPTY
    deltas = ((-1, 0), (0, 1), (1, 0), (0, -1))

    for start in ((r, c) for r in range(ch) for c in range(cw)):
        if in_tree[start]:
            continue
        exit_dir = {}
        cur = start
        while not in_tree[cur]:
            k = int(rng.integers(4))
            dr, dc = deltas[k]
            nr, nc = cur[0] + dr, cur[1] + dc
            if not (0 <= nr < ch and 0 <= nc < cw):
                continue
            exit_dir[cur] = k
            cur = (nr, nc)
        cur = start
        while not in_tree[cur]:
            in_tree[cur] = True
            dr, dc = deltas[exit_dir[cur]]
            grid[2 * cur[0] + 1, 2 * cur[1] + 1] = S.EMPTY
            grid[2 * cur[0] + 1 + dr, 2 * cur[1] + 1 + dc] = S.EMPTY
            cur = (cur[0] + dr, cur[1] + dc)
    return grid


def random_maze_level(
    cells: tuple[int, int], seed: int, goal_bottom_right: bool = True, *, device=None
) -> Level:
    """Host path: the `random_maze=True` constructor equivalent."""
    rng = np.random.default_rng(seed)
    grid = generate_maze_numpy(cells, rng)
    h, w = grid.shape
    if goal_bottom_right:
        grid[h - 2, w - 2] = S.GOAL
    return make_level(grid, start_idx=1 * w + 1, device=device)


# ---------------------------------------------------------------------------
# Batched device generators
# ---------------------------------------------------------------------------


def _carve(north_open: torch.Tensor, west_open: torch.Tensor, cells) -> torch.Tensor:
    """(B, H, W) grid from the open north walls of rows 1.. (B, ch-1, cw)
    and the open west walls of columns 1.. (B, ch, cw-1)."""
    h, w = _maze_shape(cells)
    b = north_open.shape[0]
    grid = torch.full((b, h, w), S.WALL, dtype=torch.int32, device=north_open.device)
    grid[:, 1::2, 1::2] = S.EMPTY
    # north wall of cell (r, c) sits at grid (2r, 2c+1), r >= 1
    grid[:, 2 : h - 1 : 2, 1::2] = torch.where(north_open, S.EMPTY, S.WALL).int()
    # west wall of cell (r, c) sits at grid (2r+1, 2c), c >= 1
    grid[:, 1::2, 2 : w - 1 : 2] = torch.where(west_open, S.EMPTY, S.WALL).int()
    grid[:, h - 2, w - 2] = S.GOAL
    return grid


def _binary_tree_mazes(
    cells: tuple[int, int],
    batch_size: int,
    *,
    coin: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> torch.Tensor:
    """B perfect mazes via the binary-tree algorithm: each cell carves north
    or west by its coin (top row forced west, left column forced north), so
    every cell but the origin adds one edge toward the origin. `coin` is
    (B, ch, cw) bool, or drawn from `generator`."""
    ch, cw = cells
    if coin is None:
        coin = torch.rand((batch_size, ch, cw), generator=generator, device=resolve_device(device)) < 0.5
    dev = coin.device
    can_north = (torch.arange(ch, device=dev) > 0)[:, None]
    can_west = (torch.arange(cw, device=dev) > 0)[None, :]
    north = (coin & can_north & can_west) | (can_north & ~can_west)
    west = (~coin & can_north & can_west) | (can_west & ~can_north)
    return _carve(north[:, 1:, :], west[:, :, 1:], cells)


def _sidewinder_mazes(
    cells: tuple[int, int],
    batch_size: int,
    *,
    close: torch.Tensor | None = None,
    rand: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> torch.Tensor:
    """B perfect mazes via sidewinder. Row 0 is one east corridor; in the
    other rows each run of cells closes by its coin (forced at the last
    column) and carves north from the member with the largest key, where
    key = (rand26 << 6) | column. `close` is (B, ch, cw) bool and `rand`
    (B, ch, cw) uint32 values held in int64, or both are drawn from
    `generator`."""
    ch, cw = cells
    if cw > 64:
        raise ValueError(f"sidewinder: cw={cw} > 64 (column tie-break bits)")
    shape = (batch_size, ch, cw)
    if close is None:
        close = torch.rand(shape, generator=generator, device=resolve_device(device)) < 0.5
    if rand is None:
        rand = torch.randint(
            0, 1 << 32, shape, generator=generator, dtype=torch.int64, device=close.device
        )
    dev = close.device
    close = close.clone()
    close[:, :, cw - 1] = True
    keys = ((rand.to(torch.int64) >> 6) << 6) | torch.arange(cw, device=dev)

    # forward: prefix max of keys within each run (reset after a close)
    fwd = [keys[:, :, 0]]
    for c in range(1, cw):
        fwd.append(
            torch.where(close[:, :, c - 1], keys[:, :, c], torch.maximum(fwd[-1], keys[:, :, c]))
        )
    # backward: broadcast each run's closing prefix max over the run
    tot = [None] * cw
    tot[cw - 1] = fwd[cw - 1]
    for c in range(cw - 2, -1, -1):
        tot[c] = torch.where(close[:, :, c], fwd[c], tot[c + 1])
    run_max = torch.stack(tot, dim=-1)

    north = keys == run_max
    north[:, 0, :] = False
    east = ~close
    east[:, 0, :] = True
    # the east wall of (r, c) is the west wall of (r, c+1)
    return _carve(north[:, 1:, :], east[:, :, : cw - 1], cells)


def _ab_default_max_iters(s: int) -> int:
    log2s = max(1, math.ceil(math.log2(s)))
    return 64 * s * log2s * log2s


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def maze_stream_init(seed: int, batch_size: int, *, device=None) -> torch.Tensor:
    """Seeded-mode walk streams: fmix32(b·0x9E3779B9 + seed) | 1 per maze,
    as int64 values in [0, 2^32) (what K3 computes in-kernel)."""
    lanes = torch.arange(batch_size, dtype=torch.int64, device=resolve_device(device))
    return _fmix32((_mul32(lanes, 0x9E3779B9) + (int(seed) & _U32)) & _U32) | 1


def aldous_broder_mazes_reference(
    cells: tuple[int, int],
    batch_size: int,
    max_iters: int | None = None,
    *,
    directions: torch.Tensor | None = None,
    seed: int = 0,
    device=None,
    count_steps: bool = False,
):
    """Plain PyTorch version of K3: all walks in lockstep until every maze
    is covered or `max_iters` steps. Directions 0=N 1=E 2=S 3=W come from
    `directions[t, b]`, or from per-maze xorshift32 streams (top two bits)
    seeded by `maze_stream_init(seed)`. With `count_steps` it returns
    (grids, (B,) steps each walk took until its maze was covered), the
    work K3 does on these inputs."""
    ch, cw = cells
    s = ch * cw
    if max_iters is None:
        max_iters = _ab_default_max_iters(s)
    b = int(batch_size)
    if directions is not None:
        device = directions.device
        if directions.dim() != 2 or directions.shape[1] != b or directions.shape[0] < max_iters:
            raise ValueError(
                f"directions must be (>= max_iters={max_iters}, B={b}); "
                f"got {tuple(directions.shape)}"
            )
        x = None
    else:
        device = resolve_device(device)
        x = maze_stream_init(seed, b, device=device)
    rows = torch.arange(b, device=device)
    # first-entry edge per cell (from the entered cell): -1 unvisited, 4 root
    par = torch.full((b, s), -1, dtype=torch.int64, device=device)
    par[:, 0] = 4
    n_visited = torch.ones(b, dtype=torch.int64, device=device)
    p = torch.zeros(b, dtype=torch.int64, device=device)
    steps = torch.zeros(b, dtype=torch.int64, device=device)
    for t in range(max_iters):
        if t % 32 == 0 and bool((n_visited >= s).all()):
            break  # after cover no walk enters a new cell
        if count_steps:
            steps = steps + (n_visited < s)
        if directions is not None:
            d = directions[t].to(torch.int64)
        else:
            x = _xorshift_step(x)
            d = x >> 30
        r = p // cw
        c = p - r * cw
        nr = r + torch.where(d == 0, -1, torch.where(d == 2, 1, 0))
        nc = c + torch.where(d == 1, 1, torch.where(d == 3, -1, 0))
        ok = (nr >= 0) & (nr < ch) & (nc >= 0) & (nc < cw)
        q = torch.where(ok, nr.clamp(0, ch - 1) * cw + nc.clamp(0, cw - 1), p)
        cur = par[rows, q]
        newly = ok & (cur == -1)
        par[rows, q] = torch.where(newly, (d + 2) % 4, cur)
        n_visited = n_visited + newly
        p = q
    # safety net: an unreached cell carves north (west on row 0)
    cell_row = torch.arange(s, device=device) // cw
    par = torch.where(par == -1, torch.where(cell_row > 0, 0, 3), par)
    par = par.reshape(b, ch, cw)
    north_open = (par[:, 1:, :] == 0) | (par[:, :-1, :] == 2)
    west_open = (par[:, :, 1:] == 3) | (par[:, :, :-1] == 1)
    grids = _carve(north_open, west_open, cells)
    return (grids, steps) if count_steps else grids


def _aldous_broder_mazes(
    cells: tuple[int, int],
    batch_size: int,
    max_iters: int | None = None,
    *,
    directions: torch.Tensor | None = None,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """B perfect mazes via Aldous–Broder first-entry trees, exactly uniform
    over spanning trees (K3 on CUDA). Injected `directions` (T, B) replay
    the reference's draws; otherwise the walks are seeded by `seed`.
    `max_iters` defaults to the reference's 64·S·⌈log2 S⌉²."""
    ch, cw = cells
    if max_iters is None:
        max_iters = _ab_default_max_iters(ch * cw)
    dev = resolve_device(device) if directions is None else directions.device
    if not kernels.on_cuda(dev):
        return aldous_broder_mazes_reference(
            cells, batch_size, max_iters, directions=directions, seed=seed, device=dev
        )
    return aldous_broder_mazes_cuda(
        cells, batch_size, max_iters, directions=directions, seed=seed, device=dev
    )


# The 24 orders of the four directions (0=N 1=E 2=S 3=W), lexicographic: a
# backtracker iteration looks at its neighbours in order number
# ((x >> 16)·24) >> 16 of its stream's word x (K11 holds the same table).
NEIGHBOUR_ORDERS = tuple(itertools.permutations(range(4)))
_DELTA_ROW = (-1, 0, 1, 0)
_DELTA_COL = (0, 1, 0, -1)


def backtracker_mazes_reference(
    cells: tuple[int, int], batch_size: int, *, seed: int = 0, device=None
) -> torch.Tensor:
    """Plain PyTorch version of K11: B iterative backtrackers in lockstep,
    2·cells − 1 iterations each (cells − 1 pushes, cells pops). An iteration
    takes one round of the maze's xorshift32 stream (`maze_stream_init`),
    reads the neighbour order off it, carves to the first neighbour in that
    order that is inside the lattice and not yet visited and pushes it, or
    pops if there is none."""
    ch, cw = cells
    s = ch * cw
    h, w = _maze_shape(cells)
    b = int(batch_size)
    dev = resolve_device(device)
    orders = torch.tensor(NEIGHBOUR_ORDERS, dtype=torch.int64, device=dev)
    d_row = torch.tensor(_DELTA_ROW, dtype=torch.int64, device=dev)
    d_col = torch.tensor(_DELTA_COL, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    x = maze_stream_init(seed, b, device=dev)
    grid = torch.full((b, h * w), S.WALL, dtype=torch.int32, device=dev)
    grid[:, w + 1] = S.EMPTY
    visited = torch.zeros((b, s), dtype=torch.bool, device=dev)
    visited[:, 0] = True
    stack = torch.zeros((b, s), dtype=torch.int64, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    empty = torch.tensor(S.EMPTY, dtype=torch.int32, device=dev)
    for _ in range(2 * s - 1):
        x = _xorshift_step(x)
        order = orders[((x >> 16) * 24) >> 16]              # (B, 4)
        cur = stack[rows, sp - 1]
        r, c = cur // cw, cur % cw
        nr, nc = r[:, None] + d_row[order], c[:, None] + d_col[order]
        inside = (nr >= 0) & (nr < ch) & (nc >= 0) & (nc < cw)
        cell = nr.clamp(0, ch - 1) * cw + nc.clamp(0, cw - 1)
        free = inside & ~visited.gather(1, cell)
        push = free.any(dim=1)
        first = free.to(torch.int8).argmax(dim=1, keepdim=True)  # the first free one
        d = order.gather(1, first)[:, 0]
        target = cell.gather(1, first)[:, 0]
        at = (2 * r + 1) * w + 2 * c + 1
        step = d_row[d] * w + d_col[d]
        # a pop writes what is already there (the current cell is carved,
        # visited and on top of the stack), so no step waits on a mask's count
        grid[rows, torch.where(push, at + step, at)] = empty
        grid[rows, torch.where(push, at + 2 * step, at)] = empty
        visited[rows, torch.where(push, target, cur)] = True
        stack[rows, torch.where(push, sp, sp - 1)] = torch.where(push, target, cur)
        sp = torch.where(push, sp + 1, sp - 1)
    grid[:, (h - 2) * w + (w - 2)] = S.GOAL
    return grid.reshape(b, h, w)


def _backtracker_mazes(
    cells: tuple[int, int], batch_size: int, *, seed: int = 0, device=None
) -> torch.Tensor:
    """B perfect mazes by the recursive backtracker (K11 on CUDA): long
    winding corridors with few dead ends, the reference's default texture."""
    dev = resolve_device(device)
    if not kernels.on_cuda(dev):
        return backtracker_mazes_reference(cells, batch_size, seed=seed, device=dev)
    return backtracker_mazes_cuda(cells, batch_size, seed=seed, device=dev)


def generate_mazes_device(
    seed: int,
    cells: tuple[int, int],
    batch_size: int,
    algorithm: str = "backtracker",
    *,
    device=None,
):
    """B independent perfect mazes on `device` (default: the card), from an
    integer seed.

    algorithm — "binary_tree" (fully parallel, classic texture bias),
                "sidewinder" (nearly bias-free), "aldous_broder" (exactly
                uniform; K3 on CUDA) or "backtracker" (the reference's
                default: long corridors; K11 on CUDA).

    Returns (grids (B, H, W) int32, start_idx () int32 — all mazes start
    at the top-left cell (1, 1)).
    """
    h, w = _maze_shape(cells)
    dev = resolve_device(device)
    if algorithm in ("binary_tree", "sidewinder"):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        fn = _binary_tree_mazes if algorithm == "binary_tree" else _sidewinder_mazes
        grids = fn(cells, batch_size, generator=gen, device=dev)
    elif algorithm == "aldous_broder":
        grids = _aldous_broder_mazes(cells, batch_size, seed=seed, device=dev)
    elif algorithm == "backtracker":
        grids = _backtracker_mazes(cells, batch_size, seed=seed, device=dev)
    else:
        raise ValueError(f"unknown maze algorithm: {algorithm!r}")
    return grids, torch.tensor(1 * w + 1, dtype=torch.int32, device=dev)


def check_perfect_maze(grid, cells: tuple[int, int]) -> bool:
    """Host-side validator: all cells reachable AND exactly 2·cells−1 open
    tiles (cells + carved passages) ⇒ spanning tree ⇒ perfect maze."""
    ch, cw = cells
    if isinstance(grid, torch.Tensor):
        grid = grid.cpu().numpy()
    grid = np.asarray(grid)
    open_mask = grid != S.WALL
    n_open = int(open_mask.sum())
    if n_open != ch * cw + (ch * cw - 1):
        return False
    h, w = grid.shape
    seen = np.zeros_like(open_mask)
    dq = deque([(1, 1)])
    seen[1, 1] = True
    while dq:
        r, c = dq.popleft()
        for dr, dc in ((-1, 0), (0, 1), (1, 0), (0, -1)):
            nr, nc = r + dr, c + dc
            if 0 <= nr < h and 0 <= nc < w and open_mask[nr, nc] and not seen[nr, nc]:
                seen[nr, nc] = True
                dq.append((nr, nc))
    return bool((seen == open_mask).all())
