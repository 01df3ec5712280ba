"""Wrapper of K7a (`csrc/gae.cu`): check, plan, allocate, launch.

The plain PyTorch versions are `models.ppo.gae_advantages_reference` and
`models.a2c.nstep_returns_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

THREADS = 64      # threads a block (`kThreads`)
REGISTER_T = 16   # the register tier's largest T: every row loaded before the walk (`kRegRows`)
GROUP = 8         # rows a group above it, the next group loaded before this one is walked (`kGroup`)
WIDTHS = (4, 2, 1)


class Plan(NamedTuple):
    width: int    # adjacent envs a thread: 16-, 8- or 4-byte float accesses
    tier: str     # "registers" (T <= REGISTER_T) or "groups"
    threads: int  # a block
    blocks: int


def _width(b: int, floats: int, done: int) -> int:
    """The widest of WIDTHS that divides B with `floats` (the float
    pointers OR-ed together) aligned to 4·width bytes and `done` to width."""
    for w in WIDTHS:
        if b % w == 0 and not floats & (4 * w - 1) and not done & (w - 1):
            return w
    return 1


def plan(t: int, b: int, floats=(), done: int = 0) -> Plan:
    """How K7a scans a (T, B) rollout: the widest `width` in WIDTHS that
    divides B with every float pointer in `floats` aligned to 4·width bytes
    and the done pointer to width bytes (the default pointers are aligned;
    else the scalar path, width 1), and the tier from T."""
    f = 0
    for ptr in floats:
        f |= ptr
    width = _width(b, f, done)
    return Plan(width, "registers" if t <= REGISTER_T else "groups", THREADS, -(-(b // width) // THREADS))


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
    v = check_tensor("value", value, torch.float32, (t, b), device)
    r = check_tensor("reward", reward, torch.float32, (t, b), device)
    d = check_tensor("done", done, torch.bool, (t, b), device)
    bt = check_tensor("bootstrap", bootstrap, torch.float32, (b,), device)
    a, g = adv.data_ptr(), targets.data_ptr()
    launch("gu_gae", device, v, r, d, bt, a, g, t, b, float(gamma), float(gamma * lam),
           _width(b, v | r | bt | a | g, d))
    LAUNCHES["gae"] += 1
    return adv, targets


def nstep_returns_cuda(reward, done, bootstrap, gamma: float):
    """Launch K7a's n-step-return scan. Returns the (T, B) float32 returns."""
    t, b = _shape("reward", reward)
    device = reward.device
    returns = torch.empty_like(reward)
    r = check_tensor("reward", reward, torch.float32, (t, b), device)
    d = check_tensor("done", done, torch.bool, (t, b), device)
    bt = check_tensor("bootstrap", bootstrap, torch.float32, (b,), device)
    g = returns.data_ptr()
    launch("gu_nstep_returns", device, r, d, bt, g, t, b, float(gamma), _width(b, r | bt | g, d))
    LAUNCHES["gae"] += 1
    return returns
