"""Wrapper of K5 (`csrc/td_fast.cu`): check, allocate, launch.

The plain PyTorch version is `algos.td_fast.td_scan_fast_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args


def td_scan_fast_cuda(
    sem, bl, q, env_state, rs, run_ret, n_eps_env, ret_sum_env,
    num_steps: int, alpha: float, gamma: float, epsilon: float,
    expected_sarsa: int, max_episode_steps: int | None,
):
    """Launch K5 for `num_steps` steps (one step kernel each, and one that
    applies the last aggregate; `LAUNCHES` counts them all). Returns the new
    (q, agent_idx, agent_code, t, rs, run_ret, n_eps_env, ret_sum_env); the
    inputs are left as they were."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"td_scan_fast_cuda takes CUDA tensors, got {device}")
    b = int(rs.shape[0]) if rs.dim() == 1 else 0
    n_entries = bl.num_states * sem.num_actions
    num_steps = check_int("num_steps", num_steps)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
    args += level_args(
        bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, device
    )
    state_in = [
        ("agent_idx", env_state.agent_idx, torch.int32),
        ("agent_code", env_state.agent_code, torch.int32),
        ("t", env_state.t, torch.int32),
        ("rs", rs, torch.int32),
        ("run_ret", run_ret, torch.float32),
        ("n_eps_env", n_eps_env, torch.int32),
        ("ret_sum_env", ret_sum_env, torch.float32),
    ]
    q_ptr = check_tensor("q", q, torch.float32, (bl.num_states, sem.num_actions), device)
    for name, x, dtype in state_in:
        check_tensor(name, x, dtype, (b,), device)
    state = [x.clone() for _, x, _ in state_in]  # the kernel updates these in place
    if num_steps == 0:
        return (q.clone(), *state)
    q_out = torch.empty_like(q)
    q_buf = torch.empty((2, n_entries), dtype=torch.float32, device=device)
    acc = torch.empty((3, n_entries), dtype=torch.int64, device=device)
    cnt = torch.empty((3, n_entries), dtype=torch.int32, device=device)
    n_launched = ctypes.c_int(0)
    launch(
        "gu_td_scan_fast", device, *args,
        b, num_steps, max_steps_arg(max_episode_steps), int(expected_sarsa),
        float(alpha), float(gamma), float(epsilon), 1.0 - float(epsilon),
        int(float(epsilon) * 65536.0),
        q_ptr, q_out.data_ptr(), *[x.data_ptr() for x in state],
        q_buf.data_ptr(), acc.data_ptr(), cnt.data_ptr(), ctypes.addressof(n_launched),
    )
    LAUNCHES["td_scan_fast"] += n_launched.value
    return (q_out, *state)
