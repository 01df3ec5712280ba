"""Wrappers of K4 (`csrc/dp_grid.cu`): check, allocate, launch.

The plain PyTorch versions are
`algos.dp_batched.value_iteration_batched_grid_reference` and
`algos.dp_batched.policy_iteration_batched_grid_reference`; the loops that
decide when to stop live in `algos.dp_batched` too.

Two tiers. Up to `MAX_STATES` cells a maze, one block per maze keeps the
maze in shared memory and runs all of a call's sweeps in one launch. Above
it, one thread per cell works from global memory and each sweep is a launch
of its own; the packed words and the second V buffer live in a scratch
allocated here. The only limit left is N·S < 2^31 cells in all.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import semantics_args

# the shared-memory tier's limit: 13 bytes a cell, within the 227 KB a
# block can use
MAX_STATES = 16_384


def uses_shared_tier(num_states: int) -> bool:
    """True if a maze of `num_states` cells runs in the shared-memory tier
    (one launch a call), False for the global-memory tier (one a sweep)."""
    return num_states <= MAX_STATES


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


def grid_sweeps_cuda(sem, grids, v, policy, gamma: float, num_sweeps: int):
    """Launch `num_sweeps` sweeps of K4 from V `v` (N, S) float32: VI sweeps,
    or evaluation sweeps of `policy` (N, S) int32 where one is given.
    Returns (V after the sweeps, (num_sweeps,) float32 global max |ΔV| of
    each sweep). One launch in the shared-memory tier, `num_sweeps` in the
    global-memory tier."""
    device = grids.device
    if device.type != "cuda":
        raise ValueError(f"grid_sweeps_cuda takes CUDA tensors, got {device}")
    args, n, s = _grid_args(sem, grids, policy, device)
    num_sweeps = check_int("num_sweeps", num_sweeps, low=1)
    v_in = check_tensor("v", v, torch.float32, (n, s), device)
    v_out = torch.empty((n, s), dtype=torch.float32, device=device)
    maxima = torch.empty(num_sweeps, dtype=torch.float32, device=device)
    if uses_shared_tier(s):
        launch("gu_grid_sweeps", device, *args, v_in, v_out.data_ptr(), float(gamma), num_sweeps,
               maxima.data_ptr())
        LAUNCHES["dp_grid"] += 1
    else:
        v_tmp = torch.empty((n, s), dtype=torch.float32, device=device)
        info = torch.empty((n, s), dtype=torch.int32, device=device)
        launch("gu_grid_sweeps_global", device, *args, v_in, v_out.data_ptr(), v_tmp.data_ptr(),
               info.data_ptr(), float(gamma), num_sweeps, maxima.data_ptr())
        LAUNCHES["dp_grid"] += num_sweeps
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
    launch(
        "gu_grid_greedy" if uses_shared_tier(s) else "gu_grid_greedy_global", device, *args,
        check_tensor("v", v, torch.float32, (n, s), device), float(gamma),
        policy_out.data_ptr(), changed.data_ptr(),
    )
    LAUNCHES["dp_grid"] += 1
    return policy_out, changed
