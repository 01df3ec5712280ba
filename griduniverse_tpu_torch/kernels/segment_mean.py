"""Wrappers of K10 (`csrc/segment_mean.cu`): check, allocate, launch.

The plain PyTorch versions are `algos.td.apply_td_updates_reference` and,
for the sums form, `algos.td.segment_sums_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

THREADS = 256      # the block of every K10 kernel
SCAN_TILE = 4096   # counters a block of the scan takes


def chunk_envs(n_seg: int) -> int:
    """Envs one block counts and scatters: a multiple of the block, and at
    least as many as it has counters, so that the (segment, chunk) counters
    are no more than the batch plus one chunk's worth."""
    return -(-n_seg // THREADS) * THREADS


def segment_mean_cuda(q, s, a, delta, alpha: float, mask):
    """Launch K10: `q + sum / max(count, 1)` per (s, a) over the envs at
    that cell (only those with `mask` set, where one is given), the float
    sum of α·δ taken in increasing env index. Four kernels a call (count,
    scan, scatter, sum), all counted. Returns the new (S, A) table."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"segment_mean_cuda takes CUDA tensors, got {device}")
    if q.dim() != 2:
        raise ValueError(f"q must be (S, A), got shape {tuple(q.shape)}")
    num_states, num_actions = (int(d) for d in q.shape)
    q_out = torch.empty_like(q)
    launched = _launch(
        "gu_segment_mean",
        check_tensor("q", q, torch.float32, (num_states, num_actions), device), q_out.data_ptr(),
        s, a, delta, alpha, mask, num_states, num_actions, device,
    )
    LAUNCHES["segment_mean"] += launched
    return q_out


def segment_sums_cuda(s, a, delta, alpha: float, num_states: int, num_actions: int, mask=None):
    """Launch K10's sums form: per (s, a), the float sum of α·δ over the envs
    at that cell in increasing env index, and their count (only envs with
    `mask` set, where one is given). Four kernels a call, all counted under
    `segment_sums`. Returns (sums (S·A,) float32, counts (S·A,) int32)."""
    device = delta.device
    if device.type != "cuda":
        raise ValueError(f"segment_sums_cuda takes CUDA tensors, got {device}")
    n_seg = check_int("S*A", num_states * num_actions, low=1)
    sums = torch.empty((n_seg,), dtype=torch.float32, device=device)
    counts = torch.empty((n_seg,), dtype=torch.int32, device=device)
    launched = _launch(
        "gu_segment_sums", sums.data_ptr(), counts.data_ptr(),
        s, a, delta, alpha, mask, num_states, num_actions, device,
    )
    LAUNCHES["segment_sums"] += launched
    return sums, counts


def _launch(entry, out0, out1, s, a, delta, alpha, mask, num_states, num_actions, device) -> int:
    """Check the envs' inputs, allocate the scratch, launch `entry`'s four
    kernels; return how many were launched."""
    b = check_int("batch", int(delta.shape[0]) if delta.dim() == 1 else 0, low=1)
    n_seg = check_int("S*A", num_states * num_actions, low=1)
    chunk = chunk_envs(n_seg)
    n_counts = check_int("S*A*chunks", n_seg * -(-b // chunk) + 2)
    n_tiles = -(-(n_counts - 1) // SCAN_TILE)
    # the (segment, chunk) counters and the scan's ticket, α·δ in sorted
    # order, and the scan's 8-byte look-back words, in one allocation
    words = n_counts + b + (n_counts + b) % 2 + 2 * n_tiles
    scratch = torch.empty((words,), dtype=torch.int32, device=device)
    ptr = scratch.data_ptr()
    launched = ctypes.c_int(0)
    launch(
        entry, device, out0, out1,
        check_tensor("s", s, torch.int32, (b,), device),
        check_tensor("a", a, torch.int32, (b,), device),
        check_tensor("delta", delta, torch.float32, (b,), device),
        None if mask is None else check_tensor("mask", mask, torch.bool, (b,), device),
        float(alpha), b, num_actions, n_seg, chunk,
        ptr, ptr + 4 * n_counts, ptr + 4 * (words - 2 * n_tiles), ctypes.addressof(launched),
    )
    return launched.value
