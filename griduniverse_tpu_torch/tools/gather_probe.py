"""Probe: the two in-kernel gathers, on the card.

Counterpart of `tools/pallas_probe.py` of the JAX package, which asks its
TPU toolchain whether a kernel can gather (`table[idx]`, and
`take_along_axis` along axis 1) and finds that it cannot: the reason the
reference's env step is a select tree over packed words. On a GPU a gather
is one indexed load a thread, and the two probes are the hand-written
kernels P1 `gather_1d` and P2 `take_along_axis1` (`csrc/gather_probe.cu`).

`probe_gather_1d` and `probe_take_along_axis` run the reference's shapes,
with its all-zero indices and with indices drawn from a seed, and P1 also at
a shape that means something: a 65×65 level's 4,225 tile codes looked up at
65,536 agent positions, the env step's lookup. Each result is held against
the plain PyTorch version; a mismatch or a failed launch raises (the
reference turns an exception into text).

    python -m griduniverse_tpu_torch.tools.gather_probe
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.gather_probe import gather_1d_cuda, take_along_axis1_cuda
from ..utils.platform import resolve_device

STEP_LOOKUP = (4225, 65_536)  # a 65×65 level's states, one lookup an env


def gather_1d_reference(table, idx):
    """Plain PyTorch version of P1: `table[idx]`."""
    return table[idx.long()]


def take_along_axis1_reference(table, idx):
    """Plain PyTorch version of P2: `take_along_dim(table, idx, 1)`."""
    return torch.take_along_dim(table, idx.long(), 1)


def gather_1d(table, idx):
    """`table[idx]` for a (S,) int32 table and int32 indices of any shape (P1
    on CUDA)."""
    if not kernels.on_cuda(table, idx):
        return gather_1d_reference(table, idx)
    return gather_1d_cuda(table, idx.contiguous())


def take_along_axis1(table, idx):
    """`out[r, k] = table[r, idx[r, k]]` for a (R, C) int32 table and (R, K)
    int32 indices (P2 on CUDA)."""
    if not kernels.on_cuda(table, idx):
        return take_along_axis1_reference(table, idx)
    return take_along_axis1_cuda(table.contiguous(), idx.contiguous())


def _held(name: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or not bool((got == want).all()):
        raise AssertionError(f"{name}: the kernel and the plain version differ")


def _randint(high: int, shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, high, shape, generator=gen, device=device, dtype=torch.int32)


def probe_gather_1d(*, seed: int = 0, device=None) -> str:
    """P1 at the reference's shape (a (256,) table at (8, 128) indices, all
    zero and seeded) and at the env step's lookup."""
    dev = resolve_device(device)
    table = torch.arange(256, dtype=torch.int32, device=dev)
    for tag, idx in (("zero indices", torch.zeros((8, 128), dtype=torch.int32, device=dev)),
                     ("seeded indices", _randint(256, (8, 128), seed, dev))):
        _held(f"gather_1d {tag}", gather_1d(table, idx), gather_1d_reference(table, idx))
    states, envs = STEP_LOOKUP
    codes = _randint(4, (states,), seed + 1, dev)
    pos = _randint(states, (envs,), seed + 2, dev)
    _held("gather_1d step lookup", gather_1d(codes, pos), gather_1d_reference(codes, pos))
    return "OK"


def probe_take_along_axis(*, seed: int = 0, device=None) -> str:
    """P2 at the reference's shape: an (8, 256) table at (8, 256) indices,
    all zero and seeded."""
    dev = resolve_device(device)
    table = torch.arange(256, dtype=torch.int32, device=dev).expand(8, 256).contiguous()
    table = table + 1000 * torch.arange(8, dtype=torch.int32, device=dev)[:, None]  # rows differ
    for tag, idx in (("zero indices", torch.zeros((8, 256), dtype=torch.int32, device=dev)),
                     ("seeded indices", _randint(256, (8, 256), seed, dev))):
        _held(f"take_along_axis1 {tag}", take_along_axis1(table, idx),
              take_along_axis1_reference(table, idx))
    return "OK"


if __name__ == "__main__":
    print("1-D vector gather:", probe_gather_1d())
    print("2-D take_along_axis:", probe_take_along_axis())
