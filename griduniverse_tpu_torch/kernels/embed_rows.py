"""Wrappers of K9a (`csrc/embed_rows.cu`): check, allocate, launch.

The plain PyTorch versions are `models.networks.embed_rows_reference`
(gradient by autograd) and `models.networks.embed_rows_backward_reference`
(the kernel's own order of adds).
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

# Samples per chunk of the backward's first level. The order of the float
# adds depends on it, so it is part of the function, not a tuning knob.
CHUNK = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise ValueError(f"the kernels compute in float32 or bfloat16, got {dtype}")
    return _DTYPES[dtype]


def embed_rows_cuda(table, obs, dtype: torch.dtype):
    """Launch K9a's forward: `table.to(dtype)[obs]`, table (S, E) float32,
    obs (N,) int32 → (N, E) `dtype`."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"embed_rows_cuda takes CUDA tensors, got {device}")
    if table.dim() != 2 or obs.dim() != 1:
        raise ValueError(f"table must be (S, E) and obs (N,), got {tuple(table.shape)}, {tuple(obs.shape)}")
    s, e = (check_int(n, v, low=1) for n, v in zip(("S", "E"), table.shape))
    check_int("S*E", s * e)
    n = check_int("N", obs.shape[0], low=1)
    out = torch.empty((n, e), dtype=dtype, device=device)
    launch(
        "gu_embed_rows", device,
        check_tensor("table", table, torch.float32, (s, e), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        out.data_ptr(), n, s, e, dtype_code(dtype),
    )
    LAUNCHES["embed_rows"] += 1
    return out


def embed_rows_backward_cuda(grad, obs, num_states: int):
    """Launch K9a's backward (two kernels): the (S, E) float32 sum of
    `grad`'s rows per index, in the fixed two-level order."""
    device = grad.device
    if device.type != "cuda":
        raise ValueError(f"embed_rows_backward_cuda takes CUDA tensors, got {device}")
    if grad.dim() != 2:
        raise ValueError(f"grad must be (N, E), got {tuple(grad.shape)}")
    n, e = check_int("N", grad.shape[0], low=1), check_int("E", grad.shape[1], low=1)
    s = check_int("S", num_states, low=1)
    check_int("S*E", s * e)
    num_chunks = -(-n // CHUNK)
    partial = torch.zeros((num_chunks, s, e), dtype=torch.float32, device=device)
    dtable = torch.empty((s, e), dtype=torch.float32, device=device)
    launch(
        "gu_embed_rows_backward", device,
        check_tensor("grad", grad, grad.dtype, (n, e), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        partial.data_ptr(), dtable.data_ptr(), n, CHUNK, num_chunks, s, e, dtype_code(grad.dtype),
    )
    LAUNCHES["embed_rows"] += 2
    return dtable
