"""Wrappers of K4 (`csrc/dp_grid.cu`): check, allocate, launch.

The plain PyTorch versions are
`algos.dp_batched.value_iteration_batched_grid_reference` and
`algos.dp_batched.policy_iteration_batched_grid_reference`; the loops that
decide when to stop live in `algos.dp_batched` too.

Three tiers, picked by the maze's shape (`grid_tier`). Up to `MAX_STATES`
cells a maze, the shared-memory tier keeps a group of mazes in a block's
shared memory and runs up to `SWEEPS_A_LAUNCH` sweeps in one launch;
`packing` says how many mazes a block takes and how many cells a thread.
Above it, the cluster tier keeps one maze in a thread-block cluster, a band
of rows a block, and runs up to `SWEEPS_A_LAUNCH` sweeps a launch too;
`cluster_plan` says how many blocks and rows. A maze too large for
`MAX_CLUSTER_BLOCKS` blocks takes the global-memory tier: one thread per
cell from global memory, each sweep a launch of its own, the packed words
and the second V buffer in a scratch allocated here. The only limit left is
N·S < 2^31 cells in all.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import semantics_args

# the shared-memory tier's limit: 13 bytes a cell, within the 227 KB a
# block can use
MAX_STATES = 16_384
SWEEPS_A_LAUNCH = 16    # sweeps one launch of the shared tier takes (`kMaxSweeps`)
BLOCK_THREADS = 256     # a block of the shared tier at most (`kBlockMax`)
PARTIAL_ROWS = 4_096    # the blocks' rows of maxima the scratch holds (the grid's cap)
# the most dynamic shared memory a block of decoded actions (`Packing.table`)
# may take: three such blocks fit an SM's 228 KB. Above it the word a cell
# (13 bytes) keeps more blocks on an SM, and was the faster on the card
# (`PERF.md` §6: 65×65 mazes with a table of 139 KB, one block an SM)
TABLE_BYTES = 72 * 1024
# the cluster tier: a block of CLUSTER_THREADS threads holds a band of rows
# at CLUSTER_CELL_BYTES a cell (two V buffers and a word) in the opt-in
# shared memory a block can have, BLOCK_SHARED_BYTES, less CLUSTER_STATIC
# bytes kept for the kernel's static shared memory; a cluster is at most
# MAX_CLUSTER_BLOCKS blocks (the H100's largest, non-portable above 8)
CLUSTER_THREADS = 1_024
CLUSTER_CELL_BYTES = 12
BLOCK_SHARED_BYTES = 232_448
CLUSTER_STATIC = 4_096
MAX_CLUSTER_BLOCKS = 16


class Packing(NamedTuple):
    """The shared tier's cut: `mazes` a block, `threads` a block, `cells`
    a thread. With one cell a thread its actions are decoded into
    registers; with several, into a table in shared memory where `table`
    (6 bytes an action and cell), else into a word a cell."""
    mazes: int
    threads: int
    cells: int
    table: bool


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def table_bytes(num_states: int, num_actions: int) -> int:
    """Shared memory of a block that keeps a maze's decoded actions: two V
    buffers with their 0.0 slot, a float and a uint16 an action and cell,
    and the tile codes."""
    return 8 * (num_states + 1) + 6 * num_actions * num_states + num_states


@lru_cache(maxsize=64)
def packing(num_states: int, num_actions: int = 4) -> Packing:
    """How the shared tier cuts mazes of `num_states` cells: up to 256
    cells, ⌊256 / S⌋ mazes a block of whole warps, one thread a cell; above,
    a maze a block of at most 256 threads with ⌈S / 256⌉ cells each, with
    a table of decoded actions where `table_bytes` ≤ TABLE_BYTES."""
    s = check_int("states a maze", num_states, low=1)
    if s > MAX_STATES:
        raise ValueError(f"{s} states: the shared tier takes at most {MAX_STATES}")
    if s <= BLOCK_THREADS:
        mazes = BLOCK_THREADS // s
        return Packing(mazes, _warps(mazes * s), 1, False)
    cells = -(-s // BLOCK_THREADS)
    return Packing(1, _warps(-(-s // cells)), cells, table_bytes(s, num_actions) <= TABLE_BYTES)


class ClusterPlan(NamedTuple):
    """The cluster tier's cut of an H×W maze: a cluster of `blocks` blocks
    of CLUSTER_THREADS threads, block b holding rows [b·rows, (b+1)·rows)
    (the last band may hold fewer, none holds none), `cells` cells a thread,
    `bytes` of dynamic shared memory a block."""
    blocks: int
    rows: int
    cells: int
    bytes: int


@lru_cache(maxsize=64)
def cluster_plan(height: int, width: int) -> ClusterPlan | None:
    """The cluster tier's cut of a `height`×`width` maze: the least count of
    blocks whose bands of ⌈height / blocks⌉ rows fit a block at
    CLUSTER_CELL_BYTES a cell, or None where more than MAX_CLUSTER_BLOCKS
    would be needed (the global tier's mazes)."""
    h, w = check_int("height", height, low=1), check_int("width", width, low=1)
    budget = BLOCK_SHARED_BYTES - CLUSTER_STATIC
    for k in range(1, MAX_CLUSTER_BLOCKS + 1):
        rows = -(-h // k)
        band = rows * w
        if band * CLUSTER_CELL_BYTES <= budget:
            return ClusterPlan(-(-h // rows), rows, -(-band // CLUSTER_THREADS),
                               -(-band * CLUSTER_CELL_BYTES // 16) * 16)
    return None


def grid_tier(height: int, width: int) -> str:
    """The tier that sweeps a `height`×`width` maze: "shared" up to
    MAX_STATES cells, else "cluster" where `cluster_plan` finds a cut, else
    "global". A choice by shape, made before any launch."""
    if uses_shared_tier(height * width):
        return "shared"
    return "cluster" if cluster_plan(height, width) is not None else "global"


def uses_shared_tier(num_states: int) -> bool:
    """True if a maze of `num_states` cells runs in the shared-memory tier,
    False for the cluster or the global-memory tier (`grid_tier`)."""
    return num_states <= MAX_STATES


_scratch: dict[tuple[int, int], torch.Tensor] = {}


def _scratch_ptrs(device: torch.device) -> tuple[int, int]:
    """The shared tier's scratch for `device`'s current stream, made once:
    the blocks' rows of maxima or flags (PARTIAL_ROWS × SWEEPS_A_LAUNCH
    words, written before they are read in every launch) and the ticket, a
    word that is 0 between launches (the last block of a launch sets it
    back). Launches on one stream run in order, so they can share it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(PARTIAL_ROWS * SWEEPS_A_LAUNCH + 1, dtype=torch.int32, device=device)
    return buf.data_ptr(), buf.data_ptr() + 4 * PARTIAL_ROWS * SWEEPS_A_LAUNCH


def _grid_args(sem, grids, policy, device):
    if grids.dim() != 3:
        raise ValueError(f"grids must be (N, H, W), got shape {tuple(grids.shape)}")
    n, h, w = (int(d) for d in grids.shape)
    check_int("number of mazes", n, low=1)
    check_int("cells of all mazes (N*H*W)", n * h * w, low=1)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
    args += [check_tensor("grids", grids, torch.int32, (n, h, w), device), n, h, w]
    args.append(
        None if policy is None
        else check_tensor("policy", policy, torch.int32, (n, h * w), device)
    )
    return args, n, h * w


def grid_sweeps_cuda(sem, grids, v, policy, gamma: float, num_sweeps: int, table: bool | None = None,
                     tier: str | None = None):
    """Launch `num_sweeps` sweeps of K4 from V `v` (N, S) float32: VI sweeps,
    or evaluation sweeps of `policy` (N, S) int32 where one is given.
    Returns (V after the sweeps, (num_sweeps,) float32 global max |ΔV| of
    each sweep). One launch per SWEEPS_A_LAUNCH sweeps in the shared-memory
    and the cluster tiers, `num_sweeps` in the global-memory tier
    (`grid_tier`). `table`, where given, overrides `packing`'s choice of the
    table of decoded actions for mazes of several cells a thread, and
    `tier` the tier of a maze above MAX_STATES cells ("cluster", where
    `cluster_plan` has a cut, or "global"): the same bits either way; for
    measuring and for holding one tier against another."""
    device = grids.device
    if device.type != "cuda":
        raise ValueError(f"grid_sweeps_cuda takes CUDA tensors, got {device}")
    args, n, s = _grid_args(sem, grids, policy, device)
    h, w = args[7], args[8]
    num_sweeps = check_int("num_sweeps", num_sweeps, low=1)
    v_in = check_tensor("v", v, torch.float32, (n, s), device)
    v_out = torch.empty((n, s), dtype=torch.float32, device=device)
    maxima = torch.empty(num_sweeps, dtype=torch.float32, device=device)
    if tier is None:
        tier = grid_tier(h, w)
    elif tier not in ("cluster", "global") or grid_tier(h, w) == "shared" or (
            tier == "cluster" and cluster_plan(h, w) is None):
        raise ValueError(f"a {h}x{w} maze cannot take the {tier!r} tier")
    if tier == "global":
        v_tmp = torch.empty((n, s), dtype=torch.float32, device=device)
        info = torch.empty((n, s), dtype=torch.int32, device=device)
        launch("gu_grid_sweeps_global", device, *args, v_in, v_out.data_ptr(), v_tmp.data_ptr(),
               info.data_ptr(), float(gamma), num_sweeps, maxima.data_ptr())
        LAUNCHES["dp_grid"] += num_sweeps
        return v_out, maxima
    if tier == "shared":
        pk = packing(s, args[4])
        if table is not None and pk.cells > 1:
            pk = pk._replace(table=table)
        entry, cut = "gu_grid_sweeps", (pk.mazes, pk.threads, pk.cells, int(pk.table))
    else:
        cp = cluster_plan(h, w)
        entry, cut = "gu_grid_sweeps_cluster", (cp.blocks, cp.rows, cp.cells)
    partial, ticket = _scratch_ptrs(device)
    src = v_in
    for done in range(0, num_sweeps, SWEEPS_A_LAUNCH):  # the solvers ask for at most one launch
        k = min(SWEEPS_A_LAUNCH, num_sweeps - done)
        dst = v_out if done + k == num_sweeps else torch.empty((n, s), dtype=torch.float32, device=device)
        launch(entry, device, *args, src, dst.data_ptr(), float(gamma), k, *cut, partial, PARTIAL_ROWS,
               maxima.data_ptr() + 4 * done, ticket)
        LAUNCHES["dp_grid"] += 1
        src = dst.data_ptr()
    return v_out, maxima


def grid_greedy_cuda(sem, grids, v, gamma: float, policy):
    """Launch K4's improvement step: the greedy policy (N, S) int32 under
    `v`, and a one-int tensor that is 1 if it differs from `policy`
    anywhere (0 where `policy` is None)."""
    device = grids.device
    if device.type != "cuda":
        raise ValueError(f"grid_greedy_cuda takes CUDA tensors, got {device}")
    args, n, s = _grid_args(sem, grids, policy, device)
    policy_out = torch.empty((n, s), dtype=torch.int32, device=device)
    changed = torch.empty(1, dtype=torch.int32, device=device)
    v_ptr = check_tensor("v", v, torch.float32, (n, s), device)
    if uses_shared_tier(s):  # above, the greedy step is the global tier's in every case
        pk = packing(s, args[4])
        partial, ticket = _scratch_ptrs(device)
        launch("gu_grid_greedy", device, *args, v_ptr, float(gamma), policy_out.data_ptr(),
               changed.data_ptr(), pk.mazes, pk.threads, pk.cells, partial, PARTIAL_ROWS, ticket)
    else:
        launch("gu_grid_greedy_global", device, *args, v_ptr, float(gamma), policy_out.data_ptr(),
               changed.data_ptr())
    LAUNCHES["dp_grid"] += 1
    return policy_out, changed
