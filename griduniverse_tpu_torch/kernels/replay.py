"""Wrappers of K8a and K8b (`csrc/replay.cu`): check, allocate, launch.

The plain PyTorch versions are in `models.dqn`: `per_scores_reference` and
`per_select_reference` (K8a), `replay_write_reference`,
`replay_gather_reference` and `prio_refresh_reference` (K8b).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

# rows of a refresh in one launch: up to 1,024 one block that scans the
# later rows for each row's slot, above that a cluster of eight blocks of
# 1,024 threads, a row a thread, over a hash table of at least 2n entries
# spread over the blocks' shared memory (8 bytes an entry, 16 KB a block at
# this limit); a larger refresh is two launches over a per-slot scratch
MAX_HASH_REFRESH = 8192
# picks of a draw that one block sorts in shared memory; a larger draw is
# sorted by multi-block passes over the scratch
MAX_SHARED_PICKS = 16_384
SEL_SLICE = 1024    # slots a block of K8a's select passes takes
SORT_CHUNK = 4096   # picks a block of K8a's multi-block sort takes

# the ring's fields, in the order of `models.dqn.ReplayBuffer`
RING_FIELDS = (
    ("obs", torch.int32), ("action", torch.int32), ("reward", torch.float32),
    ("next_obs", torch.int32), ("done", torch.bool),
)


def _scalar(name: str, x, dtype: torch.dtype, device) -> int:
    return check_tensor(name, x, dtype, (), device)


def ring_pointers(buf, cap: int, device) -> list[int]:
    """The five fields' data pointers of the ring `buf`; raises unless each
    is a contiguous (cap,) tensor of its dtype on `device`."""
    return [check_tensor(f"buf.{f}", getattr(buf, f), dt, (cap,), device) for f, dt in RING_FIELDS]


def refresh_launches(n: int) -> int:
    """Kernels a refresh of n rows launches: one up to `MAX_HASH_REFRESH`,
    two above."""
    return 1 if n <= MAX_HASH_REFRESH else 2


def per_sample_scratch_words(cap: int, n: int) -> int:
    """32-bit words of K8a's scratch: the four select histograms and the
    state, the select blocks' counts, the picks' keys and slots, and above
    `MAX_SHARED_PICKS` the multi-block sort's permutations and counts."""
    words = 4 * 256 + 16 + 2 * -(-cap // SEL_SLICE) + 2 * n
    if n > MAX_SHARED_PICKS:
        words += 2 * n + 256 * -(-n // SORT_CHUNK)
    return words


def per_sample_cuda(prio, noise, size, beta, n: int, alpha: float):
    """Launch K8a: the n best of `alpha·log max(prio, 1e-30) + noise` over
    the first `size` slots (equal scores by lowest index, ordered by score
    descending), a slot with no mass replaced by the fallback hash, and the
    max-normalised importance weights. `size` (() int64) and `beta` (()
    float32) are device tensors. Eight kernels a draw up to
    `MAX_SHARED_PICKS` picks, twenty above, all counted. Returns
    (idx (n,) int32, w (n,) float32, score (cap,) float32)."""
    device = prio.device
    if device.type != "cuda":
        raise ValueError(f"per_sample_cuda takes CUDA tensors, got {device}")
    cap = check_int("capacity", int(prio.shape[0]) if prio.dim() == 1 else 0, low=1)
    n = check_int("n", n, low=1)
    if n > cap:
        raise ValueError(f"n={n}: a draw takes at most capacity={cap} slots")
    score = torch.empty_like(prio)
    partial = torch.empty(((cap + 255) // 256,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    scratch = torch.empty((check_int("scratch", per_sample_scratch_words(cap, n)),),
                          dtype=torch.int32, device=device)
    launched = ctypes.c_int(0)
    launch(
        "gu_per_sample", device,
        check_tensor("prio", prio, torch.float32, (cap,), device),
        check_tensor("noise", noise, torch.float32, (cap,), device),
        _scalar("size", size, torch.int64, device),
        _scalar("beta", beta, torch.float32, device),
        float(alpha), cap, n,
        score.data_ptr(), partial.data_ptr(), idx.data_ptr(), w.data_ptr(),
        scratch.data_ptr(), ctypes.addressof(launched),
    )
    LAUNCHES["per_sample"] += launched.value
    return idx, w, score


def replay_write_cuda(buf, prio, at, batch, p_max) -> None:
    """Launch K8b's write: the five fields of `batch` (B transitions) into
    the ring `buf` at slots `at`.. (`at` a () int64 device tensor), IN PLACE,
    and `p_max` into those slots of `prio` unless `prio` is None."""
    device = buf.obs.device
    if device.type != "cuda":
        raise ValueError(f"replay_write_cuda takes CUDA tensors, got {device}")
    cap = check_int("capacity", int(buf.obs.shape[0]), low=1)
    b = check_int("batch", int(batch.obs.shape[0]) if batch.obs.dim() == 1 else 0, low=1)
    if b > cap:
        raise ValueError(f"a write of {b} transitions does not fit a ring of {cap}")
    src = [check_tensor(f"batch.{f}", getattr(batch, f), dt, (b,), device) for f, dt in RING_FIELDS]
    launch(
        "gu_replay_write", device, *ring_pointers(buf, cap, device),
        None if prio is None else check_tensor("prio", prio, torch.float32, (cap,), device),
        *src, _scalar("at", at, torch.int64, device),
        None if prio is None else _scalar("p_max", p_max, torch.float32, device),
        b, cap,
    )
    LAUNCHES["replay"] += 1


def replay_gather_cuda(buf, idx):
    """Launch K8b's gather: the five fields of the ring at `idx` (n,) int32.
    Returns the five (n,) tensors, views of one buffer: the four 4-byte
    fields, then `done`."""
    device = buf.obs.device
    if device.type != "cuda":
        raise ValueError(f"replay_gather_cuda takes CUDA tensors, got {device}")
    cap = check_int("capacity", int(buf.obs.shape[0]), low=1)
    n = check_int("n", int(idx.shape[0]) if idx.dim() == 1 else 0, low=1)
    out = torch.empty((4 * n + -(-n // 4),), dtype=torch.int32, device=device)
    launch(
        "gu_replay_gather", device, *ring_pointers(buf, cap, device),
        check_tensor("idx", idx, torch.int32, (n,), device), n, cap, out.data_ptr(),
    )
    LAUNCHES["replay"] += 1
    obs, action, reward, next_obs, done = out.split((n, n, n, n, out.shape[0] - 4 * n))
    return obs, action, reward.view(torch.float32), next_obs, done.view(torch.bool)[:n]


def prio_refresh_cuda(prio, idx, abs_err, eps: float, p_max):
    """Launch K8b's refresh: `prio[idx[i]] = abs_err[i] + eps` IN PLACE, of
    equal indices the highest i wins. Returns the new () `p_max`, the larger
    of the old one and the largest refreshed priority. One kernel up to
    `MAX_HASH_REFRESH` rows, two above; `LAUNCHES` counts them."""
    device = prio.device
    if device.type != "cuda":
        raise ValueError(f"prio_refresh_cuda takes CUDA tensors, got {device}")
    cap = check_int("capacity", int(prio.shape[0]) if prio.dim() == 1 else 0, low=1)
    n = check_int("n", int(idx.shape[0]) if idx.dim() == 1 else 0, low=1)
    out = torch.empty((), dtype=torch.float32, device=device)
    owner = None
    if refresh_launches(n) == 2:  # each slot's winning row, -1 where untouched
        owner = torch.full((cap,), -1, dtype=torch.int32, device=device)
    launched = ctypes.c_int(0)
    launch(
        "gu_prio_refresh", device,
        check_tensor("prio", prio, torch.float32, (cap,), device),
        check_tensor("idx", idx, torch.int32, (n,), device),
        check_tensor("abs_err", abs_err, torch.float32, (n,), device),
        float(eps), n, cap, _scalar("p_max", p_max, torch.float32, device), out.data_ptr(),
        None if owner is None else owner.data_ptr(), ctypes.addressof(launched),
    )
    LAUNCHES["replay"] += launched.value
    return out
