"""Wrapper of K6 (`csrc/td_batched.cu`): plan, check, allocate, launch.

The plain PyTorch version is `algos.td_batched.q_learning_batched_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args

# Dynamic shared memory a block may ask for on the H100 (232,448 bytes),
# less room for the block's static semantics tables.
SHARED_BYTES = 232_448 - 1_024
SM_SHARED_BYTES = 233_472  # shared memory of one SM, of which each block holds its own plus 1 KB
MAX_THREADS = 512          # mazes (threads) a block: 128 registers a thread
SM_THREADS = 1_024         # threads an SM is planned to hold at once (64 registers each)
GLOBAL_THREADS = 128       # mazes a block where no maze's table fits shared memory
SMS = 132                  # the H100's SMs


class Plan(NamedTuple):
    """How K6 lays N mazes out on the card: `blocks` blocks of `threads`
    mazes, a thread a maze (maze b·threads + i in thread i of block b). In
    the shared tier every maze of a block keeps its table and level in the
    block's `shared_bytes` of dynamic shared memory; in the global tier
    (`shared_bytes` 0) every maze reads its own from device memory."""

    tier: str          # "shared" or "global"
    threads: int
    blocks: int
    shared_bytes: int


def shared_bytes(mazes: int, num_states: int, num_actions: int, itemsize: int) -> int:
    """Bytes of shared memory `mazes` mazes take: their tables, entry-major
    and maze-minor, then (at a 16-byte boundary) their packed levels, word
    by word."""
    tables = mazes * num_states * num_actions * itemsize
    return (tables + 15) // 16 * 16 + mazes * 4 * -(-num_states // 16)


def _cost(n: int, threads: int, nbytes: int, sms: int) -> tuple[int, int, int]:
    """(waves × warps a scheduler, waves, threads) of blocks of `threads`
    mazes taking `nbytes` each: a maze's steps are a chain, so a wave lasts
    as long as its busiest scheduler (of an SM's four) issues the steps of
    its warps, and the waves follow one another."""
    blocks = -(-n // threads)
    per_sm = min(SM_SHARED_BYTES // (nbytes + 1_024), SM_THREADS // threads)
    waves = -(-blocks // (sms * per_sm))
    busiest = -(-min(blocks, sms * per_sm) // sms) * threads  # mazes on the fullest SM
    return waves * -(-busiest // 128), waves, threads


def global_plan(n: int) -> Plan:
    """The global tier for `n` mazes: blocks of `GLOBAL_THREADS`, every
    table in device memory."""
    return Plan("global", GLOBAL_THREADS, -(-check_int("n", n, low=1) // GLOBAL_THREADS), 0)


def plan(num_states: int, num_actions: int, dtype, n: int, *, sms: int = SMS) -> Plan:
    """K6's layout of `n` mazes of `num_states` states and `num_actions`
    actions, tables in `dtype` (torch.float32 or torch.bfloat16, or their
    names), on a card of `sms` SMs. The shared tier: blocks of a multiple
    of 32 mazes (a warp's lanes then sit in 32 distinct banks), every
    maze's table and level in shared memory; of the sizes that fit
    `SHARED_BYTES`, the one whose waves × warps on the busiest scheduler is
    least (`_cost`), then the fewest waves, then the smallest. Where not
    even 32 tables fit, the global tier (`global_plan`)."""
    if isinstance(dtype, str):
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    itemsize = {torch.float32: 4, torch.bfloat16: 2}[dtype]
    n = check_int("n", n, low=1)
    sizes = [t for t in range(32, MAX_THREADS + 1, 32)
             if shared_bytes(t, num_states, num_actions, itemsize) <= SHARED_BYTES]
    if not sizes:
        return global_plan(n)
    threads = min(sizes, key=lambda t: _cost(
        n, t, shared_bytes(t, num_states, num_actions, itemsize), sms))
    return Plan("shared", threads, -(-n // threads), shared_bytes(threads, num_states, num_actions, itemsize))


def td_batched_cuda(
    sem, bl, q, env_state, a, rs, run_ret, n_eps_env, ret_sum_env,
    draws, draw_first: bool, num_steps: int, alpha: float, gamma: float,
    epsilon: float, algo: int, max_episode_steps: int | None,
    target_scalars: tuple[float, float, float],
):
    """Launch K6 for `num_steps` steps on N mazes. `draws` is (explore
    (T, N) bool, rand_a (T, N) int32, explore0 (N,), rand_a0 (N,)) or four
    Nones for the native lanes; `draw_first` makes the kernel draw the
    first action itself; `target_scalars` is (γ, 1−ε, ε) as the target
    arithmetic takes them (`algos.td_batched.target_scalars`); the layout
    is `plan` of the shape. Returns the new (q, agent_idx,
    agent_code, t, a, rs, run_ret, n_eps_env, ret_sum_env); the inputs are
    left as they were."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"td_batched_cuda takes CUDA tensors, got {device}")
    if not bl.batched:
        raise ValueError("td_batched_cuda takes a per-env BitLevel")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    n = int(bl.code_words.shape[0])
    num_steps = check_int("num_steps", num_steps)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
    args += level_args(
        bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, n, device
    )
    check_tensor("q", q, q.dtype, (n, bl.num_states, sem.num_actions), device)
    layout = plan(bl.num_states, sem.num_actions, q.dtype, n,
                  sms=torch.cuda.get_device_properties(device).multi_processor_count)
    state_in = [
        ("agent_idx", env_state.agent_idx, torch.int32),
        ("agent_code", env_state.agent_code, torch.int32),
        ("t", env_state.t, torch.int32),
        ("a", a, torch.int32),
        ("rs", rs, torch.int32),
        ("run_ret", run_ret, torch.float32),
        ("n_eps_env", n_eps_env, torch.int32),
        ("ret_sum_env", ret_sum_env, torch.float32),
    ]
    for name, x, dtype in state_in:
        check_tensor(name, x, dtype, (n,), device)
    explore, rand_a, explore0, rand_a0 = draws
    draw_ptrs = [None, None, None, None]
    if explore is not None:
        draw_ptrs = [
            check_tensor("explore", explore, torch.bool, (num_steps, n), device),
            check_tensor("rand_a", rand_a, torch.int32, (num_steps, n), device),
            check_tensor("explore0", explore0, torch.bool, (n,), device),
            check_tensor("rand_a0", rand_a0, torch.int32, (n,), device),
        ]
    # the kernel updates the table and the state in place
    q_out = q.clone()
    state = [x.clone() for _, x, _ in state_in]
    if num_steps == 0 and not draw_first:
        return (q_out, *state)
    launch(
        "gu_td_batched", device, *args,
        n, num_steps, max_steps_arg(max_episode_steps), int(algo),
        int(q.dtype == torch.bfloat16),
        float(alpha), target_scalars[0], target_scalars[2], target_scalars[1],
        int(float(epsilon) * 65536.0), int(bool(draw_first)),
        layout.threads, layout.blocks, layout.shared_bytes, *draw_ptrs,
        q_out.data_ptr(), *[x.data_ptr() for x in state],
    )
    LAUNCHES["td_batched"] += 1
    return (q_out, *state)
