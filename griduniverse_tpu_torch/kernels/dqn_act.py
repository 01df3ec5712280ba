"""Wrapper of K7c (`csrc/dqn_act.cu`): check, allocate, launch.

The plain PyTorch version is `models.dqn.dqn_act_step_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args

CHUNK = 256  # envs a block: the first level of the fixed-order sum of ended returns


def dqn_act_step_cuda(
    passable, terminal, reward, deltas,
    code_words, start_idx, start_code, height, width,
    agent_idx, agent_code, t, q, explore, rand_a, run_ret, episodes, ret_sum,
    max_episode_steps: int | None,
):
    """Launch K7c (two kernels: the act-and-step pass, then the fold of the
    statistics). Returns the new (agent_idx, agent_code, t, done), the
    step's (action int32, next_obs int32, reward float32, done bool), each
    (B,), and the new (run_ret (B,), episodes () int64, ret_sum () float32)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"dqn_act_step_cuda takes CUDA tensors, got {device}")
    b = int(agent_idx.shape[0]) if agent_idx.dim() == 1 else 0
    args = semantics_args(passable, terminal, reward, deltas, device)
    a = args[-1]
    args += level_args(code_words, start_idx, start_code, height, width, b, device)
    args += [b, max_steps_arg(max_episode_steps)]
    args += [
        check_tensor("q", q, torch.float32, (b, a), device),
        check_tensor("explore", explore, torch.bool, (b,), device),
        check_tensor("rand_a", rand_a, torch.int32, (b,), device),
        check_tensor("agent_idx", agent_idx, torch.int32, (b,), device),
        check_tensor("agent_code", agent_code, torch.int32, (b,), device),
        check_tensor("t", t, torch.int32, (b,), device),
        check_tensor("run_ret", run_ret, torch.float32, (b,), device),
        check_tensor("episodes", episodes, torch.int64, (), device),
        check_tensor("ret_sum", ret_sum, torch.float32, (), device),
    ]
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    flag = dict(dtype=torch.bool, device=device)
    outs = [
        torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **flag),
        torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **f32), torch.empty(b, **flag),
        torch.empty(b, **f32), torch.empty((), dtype=torch.int64, device=device), torch.empty((), **f32),
    ]
    chunks = -(-b // CHUNK)
    scratch = (torch.empty(chunks, **f32), torch.empty(chunks, **i32))
    launch("gu_dqn_act_step", device, *args, *[o.data_ptr() for o in outs],
           *[x.data_ptr() for x in scratch])
    LAUNCHES["dqn_act"] += 2
    return tuple(outs)
