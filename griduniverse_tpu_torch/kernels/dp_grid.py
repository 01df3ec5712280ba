"""Wrappers of K4 (`csrc/dp_grid.cu`): check, allocate, launch.

The plain PyTorch versions are
`algos.dp_batched.value_iteration_batched_grid_reference` and
`algos.dp_batched.policy_iteration_batched_grid_reference`; the loops that
decide when to stop live in `algos.dp_batched` too.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import semantics_args

# 13 bytes of shared memory a cell, within the 227 KB a block can use
MAX_STATES = 16_384


def _grid_args(sem, grids, policy, device):
    if grids.dim() != 3:
        raise ValueError(f"grids must be (N, H, W), got shape {tuple(grids.shape)}")
    n, h, w = (int(d) for d in grids.shape)
    check_int("number of mazes", n, low=1)
    if h * w > MAX_STATES:
        raise ValueError(f"{h}x{w} mazes exceed the kernel's {MAX_STATES} cells")
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
    each sweep)."""
    device = grids.device
    if device.type != "cuda":
        raise ValueError(f"grid_sweeps_cuda takes CUDA tensors, got {device}")
    args, n, s = _grid_args(sem, grids, policy, device)
    num_sweeps = check_int("num_sweeps", num_sweeps, low=1)
    v_out = torch.empty((n, s), dtype=torch.float32, device=device)
    maxima = torch.empty(num_sweeps, dtype=torch.float32, device=device)
    launch(
        "gu_grid_sweeps", device, *args,
        check_tensor("v", v, torch.float32, (n, s), device), v_out.data_ptr(),
        float(gamma), num_sweeps, maxima.data_ptr(),
    )
    LAUNCHES["dp_grid"] += 1
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
        "gu_grid_greedy", device, *args,
        check_tensor("v", v, torch.float32, (n, s), device), float(gamma),
        policy_out.data_ptr(), changed.data_ptr(),
    )
    LAUNCHES["dp_grid"] += 1
    return policy_out, changed
