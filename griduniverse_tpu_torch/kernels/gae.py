"""Wrapper of K7a (`csrc/gae.cu`): check, allocate, launch.

The plain PyTorch versions are `models.ppo.gae_advantages_reference` and
`models.a2c.nstep_returns_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch


def _shape(name: str, x) -> tuple[int, int]:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a (T, B) tensor")
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; the kernel takes CUDA tensors")
    return check_int("T", x.shape[0], low=1), check_int("B", x.shape[1], low=1)


def gae_cuda(value, reward, done, bootstrap, gamma: float, lam: float):
    """Launch K7a's GAE scan. Returns (advantages, value targets), (T, B)
    float32."""
    t, b = _shape("value", value)
    device = value.device
    adv = torch.empty_like(value)
    targets = torch.empty_like(value)
    launch(
        "gu_gae", device,
        check_tensor("value", value, torch.float32, (t, b), device),
        check_tensor("reward", reward, torch.float32, (t, b), device),
        check_tensor("done", done, torch.bool, (t, b), device),
        check_tensor("bootstrap", bootstrap, torch.float32, (b,), device),
        adv.data_ptr(), targets.data_ptr(), t, b, float(gamma), float(gamma * lam),
    )
    LAUNCHES["gae"] += 1
    return adv, targets


def nstep_returns_cuda(reward, done, bootstrap, gamma: float):
    """Launch K7a's n-step-return scan. Returns the (T, B) float32 returns."""
    t, b = _shape("reward", reward)
    device = reward.device
    returns = torch.empty_like(reward)
    launch(
        "gu_nstep_returns", device,
        check_tensor("reward", reward, torch.float32, (t, b), device),
        check_tensor("done", done, torch.bool, (t, b), device),
        check_tensor("bootstrap", bootstrap, torch.float32, (b,), device),
        returns.data_ptr(), t, b, float(gamma),
    )
    LAUNCHES["gae"] += 1
    return returns
