"""Wrappers of K9b (`csrc/agent_stamp.cu`): check, allocate, launch.

The plain PyTorch versions are `models.networks.agent_stamp_reference`
(gradients by autograd) and `models.networks.agent_stamp_backward_reference`
(the backward's own order of adds, which `plan` fixes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .embed_rows import dtype_code

# The order of the backward's float adds depends on these four, so they are
# part of the function, not tuning knobs: changing one changes the bits of
# every trained parameter.
T_RANGE = 64        # samples a level that one unit walks (dy_tiles' first level)
MAX_BLOCKS = 2048   # blocks of the first launch at most; units are dealt out in runs
SUM_LANES = 32      # the second launch adds the blocks' partials in 32 interleaved rows
MAX_THREADS = 256   # a block of the backward's first launch: `cells` rows of width / V threads
# The forward stages k a slice of at most this many channels a block (36 KB);
# its bits do not depend on it.
FORWARD_SLICE = 1024


class Plan(NamedTuple):
    """How the work of one call is cut: `vec` channels a thread, `cells`
    global cells a unit, `tiles` units a range, `ranges` of `T_RANGE`
    samples a level, `units` in all, `upb` units a block, `blocks` a
    slice; the channels in `slices` of `width` (the last one shorter), one
    slice of all C where C / vec ≤ MAX_THREADS."""
    vec: int
    cells: int
    tiles: int
    ranges: int
    units: int
    upb: int
    blocks: int
    slices: int
    width: int


def backward_launches() -> int:
    """Kernels one backward launches (and adds to `LAUNCHES`): the units with
    each block's tree, then the sum of the blocks' partials."""
    return 2


def vector_width(ch: int, dtype: torch.dtype) -> int:
    """Channels a thread takes: the most, up to 16 bytes, that divide C."""
    vec = 16 // dtype.itemsize
    while ch % vec:
        vec //= 2
    return vec


def plan(n: int, nl: int, h: int, w: int, ch: int, dtype: torch.dtype) -> Plan:
    """The cut of a call of N samples over Nl levels of H×W cells and C
    channels. Every quantity is a function of the shapes alone. Above
    MAX_THREADS threads a cell (C / vec), the channels are cut into the
    fewest slices of at most MAX_THREADS threads, as even as whole threads
    allow."""
    vec = vector_width(ch, dtype)
    groups = ch // vec
    per = -(-groups // -(-groups // MAX_THREADS))  # threads a cell of a slice
    slices = -(-groups // per)
    if h * w >= 1 << 22:
        raise ValueError(f"{h}x{w} cells: K9b takes fewer than 2^22 a level")
    cells = 1
    while cells < 32 and cells * 2 * per <= MAX_THREADS:
        cells *= 2
    tiles = -(-nl * h * w // cells)
    ranges = -(-(n // nl) // T_RANGE)
    units = check_int("units", ranges * tiles, low=1)
    upb = -(-units // MAX_BLOCKS)
    blocks = -(-units // upb)
    check_int("blocks of the backward's first launch", blocks * slices)
    return Plan(vec, cells, tiles, ranges, units, upb, blocks, slices, per * vec)


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
    p = plan(n, nl, h, w, ch, y_tiles.dtype)
    width = min(ch, FORWARD_SLICE)
    check_int("forward blocks", -(-nl * h * w * (width // p.vec) // 256) * p.ranges * -(-ch // FORWARD_SLICE))
    out = torch.empty((n, h, w, ch), dtype=y_tiles.dtype, device=device)
    launch(
        "gu_agent_stamp", device,
        check_tensor("y_tiles", y_tiles, y_tiles.dtype, (nl, h, w, ch), device),
        check_tensor("k_agent", k_agent, torch.float32, (3, 3, ch), device),
        check_tensor("bias", bias, torch.float32, (ch,), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        out.data_ptr(), nl, n // nl, T_RANGE, h, w, ch, p.vec, dtype_code(y_tiles.dtype),
    )
    LAUNCHES["agent_stamp"] += 1
    return out


def agent_stamp_backward_cuda(grad, out, obs, num_levels: int):
    """Launch K9b's backward (two kernels). Returns (dy_tiles in the
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
    p = plan(n, nl, h, w, ch, grad.dtype)
    dy_tiles = torch.empty((nl, h, w, ch), dtype=grad.dtype, device=device)
    # dy_tiles' float partials, one a range, where a level has several ranges
    dy_partial = torch.empty((p.ranges, nl, h, w, ch) if p.ranges > 1 else (0,), dtype=torch.float32, device=device)
    block_partial = torch.empty((p.blocks, 10, ch), dtype=torch.float32, device=device)
    dk = torch.empty((3, 3, ch), dtype=torch.float32, device=device)
    dbias = torch.empty((ch,), dtype=torch.float32, device=device)
    launch(
        "gu_agent_stamp_backward", device,
        check_tensor("grad", grad, grad.dtype, (n, h, w, ch), device),
        check_tensor("out", out, grad.dtype, (n, h, w, ch), device),
        check_tensor("obs", obs, torch.int32, (n,), device),
        dy_tiles.data_ptr(), dy_partial.data_ptr(), block_partial.data_ptr(), dk.data_ptr(), dbias.data_ptr(),
        nl, n // nl, h, w, ch, p.cells, p.tiles, p.ranges, T_RANGE, p.units, p.upb, p.blocks,
        p.slices, p.width, p.vec,
        dtype_code(grad.dtype),
    )
    LAUNCHES["agent_stamp"] += backward_launches()
    return dy_tiles, dk, dbias
