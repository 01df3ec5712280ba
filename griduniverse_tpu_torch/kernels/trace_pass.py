"""Wrapper of K12 (`csrc/trace_pass.cu`): check, allocate, launch.

The plain PyTorch version is `algos.td_lambda.trace_pass_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

# Envs whose products a thread sums before the chunks are added in order: a
# constant of the algorithm (`kChunk` in the source), so changing it changes
# the bits of every table the pass updates.
CHUNK = 256
MAX_CHUNKS = 65_535  # chunks one launch of the first kernel takes (`kMaxChunks`)


def launches(batch: int) -> int:
    """Kernels one trace step launches at `batch` envs: a first-kernel
    launch for every MAX_CHUNKS chunks, and the table's update."""
    return -(-(-(-batch // CHUNK)) // MAX_CHUNKS) + 1


def trace_pass_cuda(table, e, s, a, delta, cut, gamma_lam: float, cutoff: float, alpha: float,
                    replacing: bool):
    """Launch K12 (two kernels, both counted, and one more launch of the
    first for every further 65,535 chunks of CHUNK envs): one step of the trace `e`
    (B, S, A) for control, with actions `a`, or (B, S) for prediction, with
    `a` None; `e` is updated IN PLACE. Returns the new `table` (S, A) or
    (S,). `s`, `a` int32, `delta` float32 and `cut` bool are (B,)."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"trace_pass_cuda takes CUDA tensors, got {device}")
    b = check_int("batch", int(e.shape[0]), low=1)
    n_cells = check_int("cells", table.numel(), low=1)
    num_actions = 1 if a is None else int(table.shape[-1])
    part = -(-b // CHUNK) * n_cells
    part_num = torch.empty((part,), dtype=torch.float32, device=device)
    part_cnt = torch.empty((part,), dtype=torch.int32, device=device)
    table_out = torch.empty_like(table)
    launched = ctypes.c_int(0)
    launch(
        "gu_trace_pass", device,
        check_tensor("e", e, torch.float32, (b, *table.shape), device),
        check_tensor("s", s, torch.int32, (b,), device),
        None if a is None else check_tensor("a", a, torch.int32, (b,), device),
        check_tensor("delta", delta, torch.float32, (b,), device),
        check_tensor("cut", cut, torch.bool, (b,), device),
        check_tensor("table", table, torch.float32, tuple(table.shape), device),
        table_out.data_ptr(), float(gamma_lam), float(cutoff), float(alpha), int(bool(replacing)),
        num_actions, b, n_cells, part_num.data_ptr(), part_cnt.data_ptr(),
        ctypes.addressof(launched),
    )
    LAUNCHES["trace_pass"] += launched.value
    return table_out
