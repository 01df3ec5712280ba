"""Dynamic-programming solvers over one dense model table.

PyTorch counterpart of `griduniverse_tpu/algos/dp.py`. The model is a
`core.model.ModelTable`; a sweep is one gather `v[next_state]`, a multiply,
an add and a reduction over the action axis, all plain torch on the
model's device. The loops are Python `while`s that read one scalar per
sweep; the batched solvers (`dp_batched`) are the throughput path.

Conventions (the reference's):
  * V is (S,) float32; terminal states are absorbing with V = 0.
  * Deterministic policies are (S,) int32; stochastic ones (S, A) float32.
  * Greedy ties break toward the lowest action index.
  * `gamma * cont` and `reward + ...` are two float32 roundings, never a
    fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.model import ModelTable


def below(delta: float, theta: float) -> bool:
    """The solvers' stopping test `delta < theta`, in float32 as the
    reference compares them."""
    return bool(np.float32(delta) < np.float32(theta))


def first_argmax(q: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, ties to the LOWEST index, int32. The
    maxima are weighted A, A-1, .., 1 by position, so the result does not
    rest on which of several equal maxima `torch.argmax` picks."""
    a = q.shape[-1]
    is_max = q == q.max(dim=-1, keepdim=True).values
    weight = torch.arange(a, 0, -1, dtype=torch.int32, device=q.device)
    return (is_max * weight).argmax(dim=-1).to(torch.int32)


def action_values(model: ModelTable, v: torch.Tensor, gamma: float) -> torch.Tensor:
    """Q(s, a) = r(s, a) + γ·V(s') with no bootstrap through terminals;
    the rows of terminal states are pinned to 0."""
    cont = torch.where(model.done, 0.0, v[model.next_state.long()])
    q = model.reward + gamma * cont
    return torch.where(model.terminal[:, None], 0.0, q)


def sweep_until(backup, v0: torch.Tensor, theta: float, max_iters: int):
    """v ← backup(v) until max|Δv| over the whole tensor < theta, or
    `max_iters` sweeps. Returns (v, sweeps)."""
    v, iters = v0, 0
    while iters < max_iters:
        v_new = backup(v)
        delta = float((v_new - v).abs().max())
        v, iters = v_new, iters + 1
        if below(delta, theta):
            break
    return v, iters


def value_iteration(
    model: ModelTable, gamma: float = 0.99, theta: float = 1e-6, max_iters: int = 10_000
):
    """Classic VI: sweep V ← max_a Q until the sup-norm delta < theta.
    Returns (V, greedy policy, number of sweeps)."""
    v0 = torch.zeros(model.num_states, dtype=torch.float32, device=model.reward.device)
    v, iters = sweep_until(
        lambda v: action_values(model, v, gamma).max(dim=1).values, v0, theta, max_iters
    )
    return v, greedy_policy_improvement(model, v, gamma), iters


def policy_evaluation(
    model: ModelTable,
    policy: torch.Tensor,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Iterative policy evaluation. `policy` is (S,) int32 deterministic or
    (S, A) float32 stochastic. Returns (V, number of sweeps)."""
    if policy.dim() == 1:
        pick = policy.long()[:, None]

        def backup(v):
            return action_values(model, v, gamma).gather(1, pick)[:, 0]
    else:

        def backup(v):
            return (policy * action_values(model, v, gamma)).sum(dim=1)

    v0 = torch.zeros(model.num_states, dtype=torch.float32, device=model.reward.device)
    return sweep_until(backup, v0, theta, max_iters)


def greedy_policy_improvement(model: ModelTable, v: torch.Tensor, gamma: float) -> torch.Tensor:
    """π(s) = argmax_a Q(s, a), ties to the lowest action."""
    return first_argmax(action_values(model, v, gamma))


def policy_iteration(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Howard policy iteration: evaluate (from V = 0), improve, until the
    policy is stable. Returns (V, policy, number of policy iterations)."""
    dev = model.reward.device
    policy = torch.zeros(model.num_states, dtype=torch.int32, device=dev)
    v = torch.zeros(model.num_states, dtype=torch.float32, device=dev)
    iters, stable = 0, False
    while not stable and iters < max_policy_iters:
        v, _ = policy_evaluation(model, policy, gamma, theta, max_eval_iters)
        new_policy = greedy_policy_improvement(model, v, gamma)
        stable = bool((new_policy == policy).all())
        policy, iters = new_policy, iters + 1
    return v, policy, iters
