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
# The backward's shared tier: a block's partial table, the chunk's indices
# and its gradient rows in shared memory. Up to this many bytes three blocks
# fit an SM's 228 KB (each block also reserves 1 KB), so one block's chain
# of adds runs while others stage their chunks. Above it (e.g. S=4,225,
# E=64: 1.1 MB) the global tier adds into zeroed partial tables in device
# memory.
SHARED_TIER_MAX_BYTES = 75 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise ValueError(f"the kernels compute in float32 or bfloat16, got {dtype}")
    return _DTYPES[dtype]


def shared_tier_bytes(num_states: int, embed_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block of the backward's shared tier: the
    partial table with a spare row (rounded up to 16 bytes), `CHUNK`
    indices and `CHUNK` gradient rows of `dtype`."""
    table_words = -(-(num_states + 1) * embed_dim // 4) * 4
    return 4 * table_words + 4 * CHUNK + CHUNK * embed_dim * dtype.itemsize


def uses_shared_tier(num_states: int, embed_dim: int, dtype: torch.dtype) -> bool:
    return shared_tier_bytes(num_states, embed_dim, dtype) <= SHARED_TIER_MAX_BYTES


def embed_rows_cuda(table, obs, dtype: torch.dtype):
    """Launch K9a's forward: `table.to(dtype)[obs]`, table (S, E) float32,
    obs (N,) int32 → (N, E) `dtype`. The C entry point picks the vector
    width from E and the pointers' alignment."""
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
    `grad`'s rows per index, in the fixed two-level order. The partial
    tables are built in shared memory where `uses_shared_tier`, else in a
    zeroed scratch in device memory."""
    device = grad.device
    if device.type != "cuda":
        raise ValueError(f"embed_rows_backward_cuda takes CUDA tensors, got {device}")
    if grad.dim() != 2:
        raise ValueError(f"grad must be (N, E), got {tuple(grad.shape)}")
    n, e = check_int("N", grad.shape[0], low=1), check_int("E", grad.shape[1], low=1)
    s = check_int("S", num_states, low=1)
    check_int("S*E", s * e)
    code = dtype_code(grad.dtype)
    num_chunks = -(-n // CHUNK)
    shared = shared_tier_bytes(s, e, grad.dtype) if uses_shared_tier(s, e, grad.dtype) else 0
    # the shared tier writes every partial table whole; the global tier adds into them
    partial = (torch.empty if shared else torch.zeros)((num_chunks, s, e), dtype=torch.float32, device=device)
    dtable = torch.empty((s, e), dtype=torch.float32, device=device)
    launch(
        "gu_embed_rows_backward", device,
        check_tensor("grad", grad, grad.dtype, (n, e), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        partial.data_ptr(), dtable.data_ptr(), n, CHUNK, num_chunks, s, e, code, shared,
    )
    LAUNCHES["embed_rows"] += 2
    return dtable
