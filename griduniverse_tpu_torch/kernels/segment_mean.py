"""Wrapper of K10 (`csrc/segment_mean.cu`): check, allocate, launch.

The plain PyTorch version is `algos.td.apply_td_updates_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch


def segment_mean_cuda(q, s, a, delta, alpha: float, mask):
    """Launch K10: `q + sum / max(count, 1)` per (s, a) over the envs at
    that cell (only those with `mask` set, where one is given), the float
    sum of α·δ taken in increasing env index. Returns the new (S, A) table."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"segment_mean_cuda takes CUDA tensors, got {device}")
    if q.dim() != 2:
        raise ValueError(f"q must be (S, A), got shape {tuple(q.shape)}")
    num_states, num_actions = (int(d) for d in q.shape)
    b = check_int("batch", int(delta.shape[0]) if delta.dim() == 1 else 0, low=1)
    check_int("S*A", num_states * num_actions, low=1)
    q_out = torch.empty_like(q)
    launch(
        "gu_segment_mean", device,
        check_tensor("q", q, torch.float32, (num_states, num_actions), device),
        q_out.data_ptr(),
        check_tensor("s", s, torch.int32, (b,), device),
        check_tensor("a", a, torch.int32, (b,), device),
        check_tensor("delta", delta, torch.float32, (b,), device),
        None if mask is None else check_tensor("mask", mask, torch.bool, (b,), device),
        float(alpha), b, num_actions, num_states * num_actions,
    )
    LAUNCHES["segment_mean"] += 1
    return q_out
