"""Wrapper of K13 (`csrc/mc_returns.cu`): check, allocate, launch.

The plain PyTorch versions are `algos.mc.discounted_returns` and
`algos.mc.first_visit_mask`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch


def mc_returns_cuda(rewards, gamma: float, ids=None, valid=None):
    """Launch K13 over (T, B) float32 `rewards`: the discounted returns
    (T, B) float32 and, with `ids` (T, B) int32 and `valid` (T, B) bool,
    the first-visit mask (T, B) bool (else None)."""
    device = rewards.device
    if device.type != "cuda":
        raise ValueError(f"mc_returns_cuda takes CUDA tensors, got {device}")
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be (T, B), got shape {tuple(rewards.shape)}")
    t, b = (int(d) for d in rewards.shape)
    check_int("steps", t, low=1)
    check_int("episodes", b, low=1)
    check_int("samples (T*B)", t * b, low=1)
    if (ids is None) != (valid is None):
        raise ValueError("ids and valid come together")
    returns = torch.empty((t, b), dtype=torch.float32, device=device)
    mask = None if ids is None else torch.empty((t, b), dtype=torch.bool, device=device)
    launch(
        "gu_mc_returns", device,
        check_tensor("rewards", rewards, torch.float32, (t, b), device),
        None if ids is None else check_tensor("ids", ids, torch.int32, (t, b), device),
        None if valid is None else check_tensor("valid", valid, torch.bool, (t, b), device),
        t, b, float(gamma), returns.data_ptr(), None if mask is None else mask.data_ptr(),
    )
    LAUNCHES["mc_returns"] += 1
    return returns, mask
