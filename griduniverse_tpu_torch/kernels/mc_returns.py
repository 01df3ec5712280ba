"""Wrapper of K13 (`csrc/mc_returns.cu`): plan, check, allocate, launch.

The plain PyTorch versions are `algos.mc.discounted_returns` and
`algos.mc.first_visit_mask`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

MAX_GROUP = 32          # episodes a block at most: the returns run in warp 0, a lane an episode
SHARED_BYTES = 48 * 1024  # a block's staged tile (the most a block takes without an opt-in)
BYTES_PER_CELL = 9      # a reward (then its return), an id, a valid flag
# The plan's group of episodes a block: the largest power of two up to
# MAX_GROUP that still gives the card TARGET_BLOCKS blocks (about two an SM
# of the H100's 132), but not below MIN_GROUP. A block's time is its
# longest first-visit scans, so fewer episodes a block is faster until the
# blocks outnumber what the card runs at once. Measured at T = 100 in a CUDA
# graph on an H100 (`experiments/k13_groups.py`): at B = 256, 2 episodes a
# block 0.0052 ms, 4 0.0058, 8 0.0076, 1 0.0070; at B = 1,024, 4 0.0070, 2
# 0.0079, 8 0.0078, 1 0.0111.
TARGET_BLOCKS = 256
MIN_GROUP = 2


class Plan(NamedTuple):
    """A call's cut: `group` consecutive episodes a block (a power of two)
    in `blocks` blocks, their steps in tiles of `tile` rows (one tile of
    all T where it fits), `shared` bytes of a block's staged tile."""
    group: int
    tile: int
    blocks: int
    shared: int


def plan(t: int, b: int) -> Plan:
    """The cut of a call over T steps of B episodes, a function of the
    shapes alone: the group is the largest power of two up to MAX_GROUP with
    at least TARGET_BLOCKS blocks, not below MIN_GROUP, then halved while
    the group's T steps do not fit SHARED_BYTES in one tile; where not even
    one episode's do (T above 5,461), the group is 1 and its steps are cut
    into tiles. Any plan of (T, B) gives the same bits."""
    check_int("steps", t, low=1)
    check_int("episodes", b, low=1)
    group = MAX_GROUP
    while group > MIN_GROUP and -(-b // group) < TARGET_BLOCKS:
        group //= 2
    while group > 1 and group * t * BYTES_PER_CELL > SHARED_BYTES:
        group //= 2
    tile = min(t, SHARED_BYTES // (BYTES_PER_CELL * group))
    return Plan(group, tile, -(-b // group), BYTES_PER_CELL * tile * group)


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
    p = plan(t, b)
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
        p.group.bit_length() - 1, p.tile,
    )
    LAUNCHES["mc_returns"] += 1
    return returns, mask
