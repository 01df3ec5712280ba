"""Wrappers of P1 and P2 (`csrc/gather_probe.cu`): check, allocate, launch.

The plain PyTorch versions are in `tools.gather_probe`:
`gather_1d_reference` and `take_along_axis1_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch


def gather_1d_cuda(table, idx):
    """Launch P1: `table[idx]` for a (S,) int32 table and int32 indices of
    any shape. An index outside the table is clamped to its ends."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"gather_1d_cuda takes CUDA tensors, got {device}")
    s = check_int("table length", int(table.shape[0]) if table.dim() == 1 else 0, low=1)
    n = check_int("indices", idx.numel(), low=1)
    out = torch.empty(idx.shape, dtype=torch.int32, device=device)
    launch(
        "gu_gather_1d", device,
        check_tensor("table", table, torch.int32, (s,), device), s,
        check_tensor("idx", idx, torch.int32, idx.shape, device), n, out.data_ptr(),
    )
    LAUNCHES["gather_1d"] += 1
    return out


def take_along_axis1_cuda(table, idx):
    """Launch P2: `out[r, k] = table[r, idx[r, k]]` for a (R, C) int32 table
    and (R, K) int32 indices. An index outside a row is clamped to its ends."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"take_along_axis1_cuda takes CUDA tensors, got {device}")
    if table.dim() != 2 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(
            f"table must be (R, C) and idx (R, K); got {tuple(table.shape)} and {tuple(idx.shape)}")
    rows, cols = (int(d) for d in table.shape)
    k = int(idx.shape[1])
    check_int("rows*cols", rows * cols, low=1)
    check_int("rows*k", rows * k, low=1)
    out = torch.empty((rows, k), dtype=torch.int32, device=device)
    launch(
        "gu_take_along_axis1", device,
        check_tensor("table", table, torch.int32, (rows, cols), device), cols,
        check_tensor("idx", idx, torch.int32, (rows, k), device), rows, k, out.data_ptr(),
    )
    LAUNCHES["take_along_axis1"] += 1
    return out
