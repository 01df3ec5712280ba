"""Wrappers of K1 and K2 (`csrc/rollout.cu`): plan, check, allocate, launch.

K1's `plan` cuts a scan into blocks and picks where each env's level is
read from; `draw_form` picks how a draw becomes an action. The plain
PyTorch versions are `ops.bitplane.random_scan_bits_reference` and
`ops.bitplane.rollout_actions_bits_reference`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch

NARROW_ACTIONS = 8  # up to this many the kernels keep rows in registers; above, their wide form
STREAM_XORSHIFT, STREAM_THREEFRY = 0, 1  # K1's action streams (`csrc/rollout.cu` `ActionStream`)
MAX_WORDS = 1024

# K1's plan (`csrc/rollout.cu` `LevelForm`, `DrawForm`, kK1MaxThreads, kStageBytes)
LEVEL_SHARED, LEVEL_STAGED, LEVEL_DEVICE = 0, 1, 2
DRAW_MASK, DRAW_MULHI, DRAW_MODULO = 0, 1, 2
WARP = 32
MAX_THREADS = 256         # K1's largest block
SCHEDULERS = 4            # warp schedulers an SM
STAGE_BYTES = 48 * 1024   # the most bytes of a block's per-env levels staged, as K2 stages them


class ScanPlan(NamedTuple):
    """K1's launch: `threads` a block in `blocks` blocks; each env's level
    read in form `level` (a shared level in shared memory, a byte a cell;
    the block's per-env levels' packed words staged there; or read through
    L1), `shared` bytes of it a block; the wide tables above NARROW_ACTIONS
    actions."""
    threads: int
    blocks: int
    level: int
    shared: int
    wide: bool


@functools.lru_cache(maxsize=256)
def plan(batch: int, n_words: int, per_env: bool, actions: int, sms: int) -> ScanPlan:
    """One warp a block while each of the card's `sms` · 4 schedulers gets
    one warp at most (B ≤ 16,896 on 132 SMs), so that a small batch spreads
    over the SMs; above, blocks of MAX_THREADS (eight warps), which spread
    evenly over an SM's four schedulers where one-warp blocks leave some a
    warp more. A shared level takes a byte a cell and one for the cell off
    the grid (16·n_words + 4 bytes). The block's per-env levels (4·n_words
    bytes an env) are staged where they fit STAGE_BYTES, else their packed
    words are read through L1. A function of the shapes and the card; every
    plan gives the same bits."""
    batch = check_int("batch", batch, low=1)
    threads = WARP if -(-batch // WARP) <= sms * SCHEDULERS else MAX_THREADS
    level, shared = LEVEL_SHARED, 16 * n_words + 4
    if per_env:
        staged = threads * n_words * 4
        level, shared = (LEVEL_STAGED, staged) if staged <= STAGE_BYTES else (LEVEL_DEVICE, 0)
    return ScanPlan(threads, -(-batch // threads), level, shared, actions > NARROW_ACTIONS)


@functools.lru_cache(maxsize=256)
def draw_form(actions: int) -> tuple[int, int]:
    """How K1 takes a draw's `(bits >> 9) % actions`, and the multiplier:
    a mask for a power of two (one action included); below 512 actions
    x − A·⌊x·m / 2³²⌋ with m = ⌈2³²/A⌉, exact for x < 2²³ since
    x·(m·A − 2³²) < 2²³·A ≤ 2³²; above, the remainder itself."""
    a = check_int("number of actions", actions, low=1)
    if a & (a - 1) == 0:
        return DRAW_MASK, 0
    if a < 512:
        return DRAW_MULHI, -(-(1 << 32) // a)
    return DRAW_MODULO, 0


def semantics_args(passable, terminal, reward, deltas, device):
    """The semantics' C arguments. Any number of actions: above
    NARROW_ACTIONS each kernel reads the deltas, 8 bytes an action, from
    device memory (so they must be 8-byte aligned, as a tensor's own
    storage is)."""
    a = check_int("number of actions", int(deltas.shape[0]), low=1)
    if a > NARROW_ACTIONS and deltas.data_ptr() % 8 != 0:
        raise ValueError("deltas must start on an 8-byte boundary (a tensor's own storage does)")
    return [
        check_tensor("passable", passable, torch.bool, (4,), device),
        check_tensor("terminal", terminal, torch.bool, (4,), device),
        check_tensor("reward", reward, torch.float32, (4,), device),
        check_tensor("deltas", deltas, torch.int32, (a, 2), device),
        a,
    ]


def level_args(code_words, start_idx, start_code, height, width, batch, device):
    """Check a packed level against `batch` envs; return its C arguments."""
    check_int("batch", batch, low=1)
    n_words = -(-(height * width) // 16)
    if n_words > MAX_WORDS:
        raise ValueError(f"{height}x{width} level exceeds {MAX_WORDS} packed words")
    per_env = code_words.dim() == 2
    lead = (batch,) if per_env else ()
    return [
        check_tensor("code_words", code_words, torch.int32, lead + (n_words,), device),
        n_words,
        int(per_env),
        check_tensor("start_idx", start_idx, torch.int32, lead, device),
        check_tensor("start_code", start_code, torch.int32, lead, device),
        height,
        width,
    ]


def max_steps_arg(max_episode_steps) -> int:
    """None (no time limit) is -1 for the kernel."""
    if max_episode_steps is None:
        return -1
    return check_int("max_episode_steps", max_episode_steps)


def _signed32(x: int) -> int:
    """A uint32 word as the C int with its bits."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def random_scan_bits_cuda(
    passable, terminal, reward, deltas,
    code_words, start_idx, start_code, height, width,
    agent_idx, agent_code, t, rs,
    num_steps: int, max_episode_steps: int | None, keys=None,
):
    """Launch K1 in `plan`'s blocks. Without `keys` it draws from the
    xorshift32 states `rs`; with `keys` (an `ops.bitplane.ThreefryKeys`)
    from the threefry stream, and `rs` is not read. Returns the final (agent_idx, agent_code, t,
    done) and the per-env (n_eps int32, ret_sum float32, len_sum int32)."""
    device = code_words.device
    if device.type != "cuda":
        raise ValueError(f"random_scan_bits_cuda takes CUDA tensors, got {device}")
    b = int(agent_idx.shape[0]) if agent_idx.dim() == 1 else 0
    sem = semantics_args(passable, terminal, reward, deltas, device)
    level = level_args(code_words, start_idx, start_code, height, width, b, device)
    p = plan(b, level[1], bool(level[2]), sem[4], torch.cuda.get_device_properties(device).multi_processor_count)
    level[2] = p.level  # the per-env flag's place takes the level's form
    args = sem + level + [b, check_int("num_steps", num_steps), max_steps_arg(max_episode_steps)]
    args += [
        check_tensor("agent_idx", agent_idx, torch.int32, (b,), device),
        check_tensor("agent_code", agent_code, torch.int32, (b,), device),
        check_tensor("t", t, torch.int32, (b,), device),
    ]
    if keys is None:
        args += [check_tensor("rs", rs, torch.int32, (b,), device), STREAM_XORSHIFT, 0, 0, 0, 0]
    else:
        # the step and the offset below 2^31 keep every global step and lane below 2^32
        args += [None, STREAM_THREEFRY, *map(_signed32, keys.key), check_int("threefry step", keys.step),
                 check_int("lane offset", keys.offset)]
    form, magic = draw_form(sem[4])
    args += [p.threads, p.shared, form, _signed32(magic)]
    outs = [torch.empty(b, dtype=torch.int32, device=device) for _ in range(3)]
    outs.append(torch.empty(b, dtype=torch.bool, device=device))
    n_eps = torch.empty(b, dtype=torch.int32, device=device)
    ret_sum = torch.empty(b, dtype=torch.float32, device=device)
    len_sum = torch.empty(b, dtype=torch.int32, device=device)
    outs += [n_eps, ret_sum, len_sum]
    launch("gu_random_scan_bits", device, *args, *[o.data_ptr() for o in outs])
    LAUNCHES["random_scan_bits"] += 1
    return tuple(outs)


def rollout_actions_bits_cuda(
    passable, terminal, reward, deltas,
    code_words, start_idx, start_code, height, width,
    agent_idx, agent_code, t, done,
    actions, auto_reset: bool, max_episode_steps: int | None,
):
    """Launch K2. Returns the final (agent_idx, agent_code, t, done) and the
    (T, B) trajectories (obs int32, reward float32, done bool)."""
    device = actions.device
    if device.type != "cuda":
        raise ValueError(f"rollout_actions_bits_cuda takes CUDA tensors, got {device}")
    if actions.dim() != 2:
        raise ValueError(f"actions must be (T, B), got shape {tuple(actions.shape)}")
    if max_episode_steps is not None and not auto_reset:
        raise ValueError("max_episode_steps requires auto_reset=True")
    n_steps, b = int(actions.shape[0]), int(actions.shape[1])
    args = semantics_args(passable, terminal, reward, deltas, device)
    args += level_args(code_words, start_idx, start_code, height, width, b, device)
    args += [b, check_int("num_steps", n_steps), int(bool(auto_reset)), max_steps_arg(max_episode_steps)]
    args += [
        check_tensor("actions", actions, torch.int32, (n_steps, b), device),
        check_tensor("agent_idx", agent_idx, torch.int32, (b,), device),
        check_tensor("agent_code", agent_code, torch.int32, (b,), device),
        check_tensor("t", t, torch.int32, (b,), device),
        check_tensor("done", done, torch.bool, (b,), device),
    ]
    outs = [torch.empty(b, dtype=torch.int32, device=device) for _ in range(3)]
    outs.append(torch.empty(b, dtype=torch.bool, device=device))
    outs.append(torch.empty((n_steps, b), dtype=torch.int32, device=device))
    outs.append(torch.empty((n_steps, b), dtype=torch.float32, device=device))
    outs.append(torch.empty((n_steps, b), dtype=torch.bool, device=device))
    launch("gu_rollout_actions_bits", device, *args, *[o.data_ptr() for o in outs])
    LAUNCHES["rollout_actions_bits"] += 1
    return tuple(outs)
