"""Wrappers of K7b (`csrc/act_step.cu`): check, allocate, launch.

The plain PyTorch versions are `models.a2c.act_step_reference` and
`models.a2c.greedy_step_reference`.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args


def _batch(agent_idx) -> int:
    return int(agent_idx.shape[0]) if agent_idx.dim() == 1 else 0


def act_step_cuda(
    passable, terminal, reward, deltas,
    code_words, start_idx, start_code, height, width,
    agent_idx, agent_code, t, logits, gumbel, max_episode_steps: int | None,
):
    """Launch K7b. Returns the new (agent_idx, agent_code, t, done) and the
    step's (action int32, logp float32, obs int32, reward float32, done
    bool), each (B,)."""
    device = logits.device
    if device.type != "cuda":
        raise ValueError(f"act_step_cuda takes CUDA tensors, got {device}")
    b = _batch(agent_idx)
    args = semantics_args(passable, terminal, reward, deltas, device)
    a = args[-1]
    args += level_args(code_words, start_idx, start_code, height, width, b, device)
    args += [b, max_steps_arg(max_episode_steps)]
    args += [
        check_tensor("logits", logits, torch.float32, (b, a), device),
        check_tensor("gumbel", gumbel, torch.float32, (b, a), device),
        check_tensor("agent_idx", agent_idx, torch.int32, (b,), device),
        check_tensor("agent_code", agent_code, torch.int32, (b,), device),
        check_tensor("t", t, torch.int32, (b,), device),
    ]
    i32 = dict(dtype=torch.int32, device=device)
    outs = [
        torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **i32),
        torch.empty(b, dtype=torch.bool, device=device),
        torch.empty(b, **i32), torch.empty(b, dtype=torch.float32, device=device),
        torch.empty(b, **i32), torch.empty(b, dtype=torch.float32, device=device),
        torch.empty(b, dtype=torch.bool, device=device),
    ]
    launch("gu_act_step", device, *args, *[o.data_ptr() for o in outs])
    LAUNCHES["act_step"] += 1
    return tuple(outs)


def greedy_step_cuda(
    passable, terminal, reward, deltas,
    code_words, start_idx, start_code, height, width,
    agent_idx, agent_code, t, done, reached, logits,
):
    """Launch K7b's greedy form. Returns the new (agent_idx, agent_code, t,
    done) and the updated `reached` flags, each (B,)."""
    device = logits.device
    if device.type != "cuda":
        raise ValueError(f"greedy_step_cuda takes CUDA tensors, got {device}")
    b = _batch(agent_idx)
    args = semantics_args(passable, terminal, reward, deltas, device)
    a = args[-1]
    # the greedy form never resets, so the kernel takes no start state
    words, n_words, per_env, _, _, h, w = level_args(
        code_words, start_idx, start_code, height, width, b, device)
    args += [words, n_words, per_env, h, w, b]
    args += [
        check_tensor("logits", logits, torch.float32, (b, a), device),
        check_tensor("agent_idx", agent_idx, torch.int32, (b,), device),
        check_tensor("agent_code", agent_code, torch.int32, (b,), device),
        check_tensor("t", t, torch.int32, (b,), device),
        check_tensor("done", done, torch.bool, (b,), device),
        check_tensor("reached", reached, torch.bool, (b,), device),
    ]
    i32 = dict(dtype=torch.int32, device=device)
    outs = [
        torch.empty(b, **i32), torch.empty(b, **i32), torch.empty(b, **i32),
        torch.empty(b, dtype=torch.bool, device=device),
        torch.empty(b, dtype=torch.bool, device=device),
    ]
    launch("gu_greedy_step", device, *args, *[o.data_ptr() for o in outs])
    LAUNCHES["act_step"] += 1
    return tuple(outs)
