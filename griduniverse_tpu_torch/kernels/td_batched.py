"""Wrapper of K6 (`csrc/td_batched.cu`): check, allocate, launch.

The plain PyTorch version is `algos.td_batched.q_learning_batched_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args


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
    arithmetic takes them (`algos.td_batched.target_scalars`). Returns the new (q, agent_idx, agent_code, t, a,
    rs, run_ret, n_eps_env, ret_sum_env); the inputs are left as they were."""
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
        int(float(epsilon) * 65536.0), int(bool(draw_first)), *draw_ptrs,
        q_out.data_ptr(), *[x.data_ptr() for x in state],
    )
    LAUNCHES["td_batched"] += 1
    return (q_out, *state)
