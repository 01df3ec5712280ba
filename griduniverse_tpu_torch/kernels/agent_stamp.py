"""Wrappers of K9b (`csrc/agent_stamp.cu`): check, allocate, launch.

The plain PyTorch version is `models.networks.agent_stamp_reference`
(gradients by autograd).
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .embed_rows import dtype_code

# Samples per chunk of the first level of the dk and dbias sums; it fixes the
# order of the float adds.
CHUNK = 64


def _dims(y_tiles, obs):
    if y_tiles.dim() != 4 or obs.dim() != 1:
        raise ValueError(
            f"y_tiles must be (Nl, H, W, C) and obs (N,), got {tuple(y_tiles.shape)}, {tuple(obs.shape)}")
    nl, h, w, ch = (check_int(n, v, low=1) for n, v in zip(("Nl", "H", "W", "C"), y_tiles.shape))
    n = check_int("N", obs.shape[0], low=1)
    if n % nl:
        raise ValueError(f"{n} samples are not a whole number of passes over {nl} levels")
    return n, nl, h, w, ch


def agent_stamp_cuda(y_tiles, k_agent, bias, obs):
    """Launch K9b's forward: (N, H, W, C) in `y_tiles`' dtype."""
    device = y_tiles.device
    if device.type != "cuda":
        raise ValueError(f"agent_stamp_cuda takes CUDA tensors, got {device}")
    n, nl, h, w, ch = _dims(y_tiles, obs)
    out = torch.empty((n, h, w, ch), dtype=y_tiles.dtype, device=device)
    launch(
        "gu_agent_stamp", device,
        check_tensor("y_tiles", y_tiles, y_tiles.dtype, (nl, h, w, ch), device),
        check_tensor("k_agent", k_agent, torch.float32, (3, 3, ch), device),
        check_tensor("bias", bias, torch.float32, (ch,), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        out.data_ptr(), n, nl, h, w, ch, dtype_code(y_tiles.dtype),
    )
    LAUNCHES["agent_stamp"] += 1
    return out


def agent_stamp_backward_cuda(grad, out, obs, num_levels: int):
    """Launch K9b's backward (three kernels). Returns (dy_tiles in the
    compute dtype, dk_agent (3, 3, C) float32, dbias (C,) float32)."""
    device = grad.device
    if device.type != "cuda":
        raise ValueError(f"agent_stamp_backward_cuda takes CUDA tensors, got {device}")
    if grad.dim() != 4:
        raise ValueError(f"grad must be (N, H, W, C), got {tuple(grad.shape)}")
    n, h, w, ch = (int(d) for d in grad.shape)
    nl = check_int("Nl", num_levels, low=1)
    if n % nl:
        raise ValueError(f"{n} samples are not a whole number of passes over {nl} levels")
    num_chunks = -(-n // CHUNK)
    dy_tiles = torch.empty((nl, h, w, ch), dtype=grad.dtype, device=device)
    partial = torch.empty((num_chunks, 10, ch), dtype=torch.float32, device=device)
    dk = torch.empty((3, 3, ch), dtype=torch.float32, device=device)
    dbias = torch.empty((ch,), dtype=torch.float32, device=device)
    launch(
        "gu_agent_stamp_backward", device,
        check_tensor("grad", grad, grad.dtype, (n, h, w, ch), device),
        check_tensor("out", out, grad.dtype, (n, h, w, ch), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        dy_tiles.data_ptr(), partial.data_ptr(), dk.data_ptr(), dbias.data_ptr(),
        n, nl, CHUNK, num_chunks, h, w, ch, dtype_code(grad.dtype),
    )
    LAUNCHES["agent_stamp"] += 3
    return dy_tiles, dk, dbias
