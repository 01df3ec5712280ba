"""Wrappers of K10 (`csrc/segment_mean.cu`): plan, check, allocate, launch.

The plain PyTorch versions are `algos.td.apply_td_updates_reference` and,
for the sums form, `algos.td.segment_sums_reference`.

`plan` picks the tier of a call by its shape: one launch of a thread-block
cluster (`"cluster"`) wherever the cluster holds the call, else the four
passes (`"passes"`). Both give the plain versions' bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch, load

THREADS = 256      # the block of every kernel of the passes
SCAN_TILE = 4096   # counters a block of the passes' scan takes

CLUSTER_THREADS = 512      # a block of the cluster tier
CLUSTER_WARPS = CLUSTER_THREADS // 32
CLUSTER_ROUNDS = 16        # envs a thread of the cluster tier holds at most
MAX_BLOCK_ENVS = CLUSTER_THREADS * CLUSTER_ROUNDS
MAX_CLUSTER_SEGMENTS = 2048  # where a block's shared memory still holds `cluster_shared_bytes`
ENVS_A_BLOCK = 4096        # the plan's share of a block, while 16 blocks are enough
MAX_CLUSTER_BLOCKS = 16    # clusters above eight blocks are Hopper's non-portable sizes
BLOCK_SHARED_BYTES = 232_448   # shared memory a block can take on Hopper (227 KB)
STATIC_SHARED_BYTES = 1024     # kept back for the kernel's own small arrays
STREAM_CHUNK = 8192        # floats of an owner's run in device memory, streamed a step


class Plan(NamedTuple):
    tier: str      # "cluster" or "passes"
    blocks: int    # the cluster's blocks (0 for the passes)
    launches: int  # kernels a call launches: 1 or 4


PASSES = Plan("passes", 0, 4)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _region(n_seg: int) -> int:
    """The region that holds the warps' histograms (a 16-bit count a warp and
    segment) and lane masks (32 bits a warp and segment), and then the stage
    of the owner's values (at least two chunks of STREAM_CHUNK floats)."""
    return max(_align16(6 * CLUSTER_WARPS * n_seg), 8 * STREAM_CHUNK)


def cluster_shared_bytes(n_seg: int) -> int:
    """Shared bytes of a cluster block at S·A = `n_seg`, as
    `cluster_shared_bytes` in the source counts them: the block's histogram
    (16 bits a segment), where each segment's values of the block go, the
    segments' starts in the sorted order, and the region."""
    return _align16(2 * n_seg) + _align16(4 * n_seg) + _align16(4 * (n_seg + 1)) + _region(n_seg)


def stage_values(n_seg: int) -> int:
    """Values an owner's run may hold to stay in its shared memory; a longer
    run goes through device memory."""
    return _region(n_seg) // 4


@functools.lru_cache(maxsize=1024)
def plan(batch: int, n_seg: int, sms: int, max_blocks: int = MAX_CLUSTER_BLOCKS) -> Plan:
    """The tier of a call of `batch` envs over `n_seg` segments on a card of
    `sms` SMs whose clusters hold at most `max_blocks` blocks (the wrapper
    asks the card, `cluster_blocks`). A cluster of k = ⌈batch / ENVS_A_BLOCK⌉
    blocks (one block up to 4,096 envs), at most the most the card holds,
    where a block then takes at most MAX_BLOCK_ENVS envs; else, and above
    MAX_CLUSTER_SEGMENTS segments, whose warps' histograms and lane masks a
    block's shared memory does not hold, the passes. A function of the
    shapes and the card, never of an error."""
    batch = check_int("batch", batch, low=1)
    n_seg = check_int("S*A", n_seg, low=1)
    k = min(-(-batch // ENVS_A_BLOCK), max_blocks, sms, MAX_CLUSTER_BLOCKS)
    if k < 1 or -(-batch // k) > MAX_BLOCK_ENVS or n_seg > MAX_CLUSTER_SEGMENTS:
        return PASSES
    return Plan("cluster", k, 1)


def chunk_envs(n_seg: int) -> int:
    """Envs one block of the passes counts and scatters: a multiple of the
    block, and at least as many as it has counters, so that the (segment,
    chunk) counters are no more than the batch plus one chunk's worth."""
    return -(-n_seg // THREADS) * THREADS


_cluster_blocks: dict[int, int] = {}


def cluster_blocks(device: torch.device) -> int:
    """The largest cluster (up to MAX_CLUSTER_BLOCKS blocks) of the cluster
    tier's kernel that `device` can run, at the most shared memory a block
    of the plan takes: `cudaOccupancyMaxActiveClusters` must find room for
    one. Asked once a device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cluster_blocks:
        lib = load()
        fits = ctypes.c_int(0)
        found = 0
        with torch.cuda.device(index):
            for k in range(MAX_CLUSTER_BLOCKS, 0, -1):
                code = lib.gu_segment_cluster_fits(k, cluster_shared_bytes(MAX_CLUSTER_SEGMENTS),
                                                   ctypes.addressof(fits))
                if code != 0:
                    msg = lib.gu_error_string(code).decode()
                    raise RuntimeError(f"gu_segment_cluster_fits: CUDA error {code} ({msg})")
                if fits.value >= 1:
                    found = k
                    break
        _cluster_blocks[index] = found
    return _cluster_blocks[index]


def call_plan(batch: int, n_seg: int, device: torch.device) -> Plan:
    """`plan` for a call on `device`, with the card's SM count and cluster limit."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(batch, n_seg, sms, cluster_blocks(device))


def segment_mean_cuda(q, s, a, delta, alpha: float, mask, *, tier: str | None = None):
    """Launch K10: `q + sum / max(count, 1)` per (s, a) over the envs at
    that cell (only those with `mask` set, where one is given), the float
    sum of α·δ taken in increasing env index. One launch in the cluster
    tier, four (count, scan, scatter, sum) in the passes, all counted.
    `tier="passes"` forces the passes (for timing both tiers). Returns the
    new (S, A) table."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"segment_mean_cuda takes CUDA tensors, got {device}")
    if q.dim() != 2:
        raise ValueError(f"q must be (S, A), got shape {tuple(q.shape)}")
    num_states, num_actions = (int(d) for d in q.shape)
    q_out = torch.empty_like(q)
    launched = _launch(
        False, check_tensor("q", q, torch.float32, (num_states, num_actions), device), q_out.data_ptr(), None,
        s, a, delta, alpha, mask, num_states, num_actions, device, tier,
    )
    LAUNCHES["segment_mean"] += launched
    return q_out


def segment_sums_cuda(s, a, delta, alpha: float, num_states: int, num_actions: int, mask=None, *,
                      tier: str | None = None):
    """Launch K10's sums form: per (s, a), the float sum of α·δ over the envs
    at that cell in increasing env index, and their count (only envs with
    `mask` set, where one is given). One launch in the cluster tier, four
    in the passes, all counted under `segment_sums`. Returns (sums (S·A,)
    float32, counts (S·A,) int32)."""
    device = delta.device
    if device.type != "cuda":
        raise ValueError(f"segment_sums_cuda takes CUDA tensors, got {device}")
    n_seg = check_int("S*A", num_states * num_actions, low=1)
    sums = torch.empty((n_seg,), dtype=torch.float32, device=device)
    counts = torch.empty((n_seg,), dtype=torch.int32, device=device)
    launched = _launch(
        True, None, sums.data_ptr(), counts.data_ptr(),
        s, a, delta, alpha, mask, num_states, num_actions, device, tier,
    )
    LAUNCHES["segment_sums"] += launched
    return sums, counts


def _launch(sums_form, q_in, out0, out1, s, a, delta, alpha, mask, num_states, num_actions, device, tier) -> int:
    """Check the envs' inputs, plan, allocate the scratch, launch; return
    how many kernels were launched."""
    if tier not in (None, "passes"):
        raise ValueError(f"tier must be None (the plan's) or 'passes', got {tier!r}")
    b = check_int("batch", int(delta.shape[0]) if delta.dim() == 1 else 0, low=1)
    n_seg = check_int("S*A", num_states * num_actions, low=1)
    envs = [
        check_tensor("s", s, torch.int32, (b,), device),
        check_tensor("a", a, torch.int32, (b,), device),
        check_tensor("delta", delta, torch.float32, (b,), device),
        None if mask is None else check_tensor("mask", mask, torch.bool, (b,), device),
        float(alpha), b, num_actions, n_seg,
    ]
    p = PASSES if tier == "passes" else call_plan(b, n_seg, device)
    if p.tier == "cluster":
        # the scratch, only where an owner's run can outgrow its stage
        vals = torch.empty((b,), dtype=torch.float32, device=device) if b > stage_values(n_seg) else None
        launch("gu_segment_cluster", device, q_in, out0, out1, *envs, p.blocks,
               None if vals is None else vals.data_ptr())
        return 1
    chunk = chunk_envs(n_seg)
    n_counts = check_int("S*A*chunks", n_seg * -(-b // chunk) + 2)
    n_tiles = -(-(n_counts - 1) // SCAN_TILE)
    # the (segment, chunk) counters and the scan's ticket, α·δ in sorted
    # order, and the scan's 8-byte look-back words, in one allocation
    words = n_counts + b + (n_counts + b) % 2 + 2 * n_tiles
    scratch = torch.empty((words,), dtype=torch.int32, device=device)
    ptr = scratch.data_ptr()
    launched = ctypes.c_int(0)
    name, outs = ("gu_segment_sums", (out0, out1)) if sums_form else ("gu_segment_mean", (q_in, out0))
    launch(name, device, *outs, *envs, chunk,
           ptr, ptr + 4 * n_counts, ptr + 4 * (words - 2 * n_tiles), ctypes.addressof(launched))
    return launched.value
