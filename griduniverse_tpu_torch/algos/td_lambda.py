"""TD(λ): eligibility-trace control (SARSA(λ), Watkins Q(λ)) and TD(λ)
prediction.

PyTorch counterpart of `griduniverse_tpu/algos/td_lambda.py`.

  * Each env carries its OWN eligibility tensor e_i, shape (B, S, A) for
    control and (B, S) for prediction: the per-episode trace of the
    sequential algorithm, batched over envs.
  * Tiny traces are flushed to exact zero below `trace_cutoff`: it keeps the
    aggregation's visit counts honest.
  * The aggregation follows `apply_td_updates`' collision-MEAN convention
    (`algos.td`): per (s, a), the Q increment is the mean over the envs
    holding a live (nonzero) trace of their sequential update α·δ_i·e_i[s,a].
    With B = 1 this is the sequential rule `Q += α·δ·e`. A trace spreads an
    env over many cells, so this mean is DENSE, one sum over the env axis
    for every cell. The sum runs in a fixed order: the envs of each chunk of
    `kernels.trace_pass.CHUNK` in index order, then the chunks in order, so
    a run repeats its bits on the card.
  * Episode boundaries zero the finished env's whole trace (auto-reset);
    Watkins Q(λ) also zeroes it when the env's next action is exploratory.
  * The sharded learners (`parallel.learner`) stop the pass before its
    mean: K12's partial-sums form (`kernels.trace_pass.TracePartialsPlan`;
    plain versions `trace_partials_reference`, `apply_partials_reference`)
    gives each chunk's sums, which the ranks gather in rank order.
  * A step's decay, flush, bump, mean and cut are one pass over the trace,
    `trace_pass`: kernel K12 on CUDA, one launch a step through a
    `TracePassPlan` the loop builds once, which reads and writes each trace
    element once, and `trace_pass_reference` on the CPU. The trace is
    updated in place; it is the loop's own.

Random numbers, as in `algos.td`: one xorshift32 lane per env, one round per
ε-greedy draw, seeded by the integer `key`; or injected `draws` = (explore
(T, B) bool, rand_a (T, B) int32, explore0 (B,), rand_a0 (B,)). The
prediction samples its action from the policy row by inverse CDF on the
round's top 24 bits; its `draws` are the (T, B) int32 actions themselves,
or (T, B, A) Gumbel noise for `argmax(log π(·|s) + g)`, which is what the
reference's `jax.random.categorical` computes.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.step import step_autoreset
from ..kernels.trace_pass import CHUNK, TracePassPlan, trace_pass_cuda
from ..ops.bitplane import to_uint32_values, xorshift_init, xorshift_next
from ..ops.rollout import reset_batch
from .dp import first_argmax
from .td import TDResult, _fold_stats, _next_draw, epsilon_greedy

TRACES = ("accumulating", "replacing")


def check_trace(trace: str) -> None:
    """The reference's check of the trace kind."""
    if trace not in TRACES:
        raise ValueError(f"unknown trace kind: {trace!r}")


def decay_traces(e, gamma: float, lam: float, cutoff: float):
    """γλ decay with flush-to-zero below `cutoff`."""
    e = gamma * lam * e
    return torch.where(e < cutoff, 0.0, e)


def bump_traces(e, s, a, num_states: int, num_actions: int, kind: str):
    """Add this step's visit to each env's (B, S, A) trace. kind:
    "accumulating" (e += 1) or "replacing" (e = 1)."""
    hot = torch.zeros_like(e)
    hot[torch.arange(e.shape[0], device=e.device), s.long(), a.long()] = 1.0
    if kind == "accumulating":
        return e + hot
    return torch.maximum(e, hot)  # replacing: e[s, a] = 1


def chunk_partials_reference(delta, e):
    """Per chunk of `CHUNK` envs of `e` (B, ...) and cell: Σ_b δ_b·e_b over
    the chunk's envs in index order from 0.0, (⌈B / CHUNK⌉, cells) float32,
    and the count #{b: e_b ≠ 0} a cell, int32. The plain version of K12's
    partial-sums form's sums (`kernels.trace_pass.TracePartialsPlan`)."""
    b = e.shape[0]
    prod = delta.reshape(-1, 1) * e.reshape(b, -1)
    n_chunks = -(-b // CHUNK)
    pad = n_chunks * CHUNK - b  # padding rows add +0.0, which changes no bit
    if pad:
        prod = torch.cat([prod, prod.new_zeros((pad, prod.shape[1]))])
    prod = prod.reshape(n_chunks, CHUNK, -1)
    part = torch.zeros_like(prod[:, 0])
    for i in range(min(b, CHUNK)):
        part = part + prod[:, i]
    return part, (e != 0.0).reshape(b, -1).sum(dim=0).to(torch.int32)


def apply_partials_reference(table, partial, count, alpha: float):
    """`table + α · num / max(count, 1)` a cell, `num` the chunks' partial
    sums (C, cells) added in chunk order from 0.0: K12's apply, and that of
    its partial-sums form after the ranks' chunks are gathered in rank
    order."""
    num = torch.zeros_like(partial[0])
    for c in range(partial.shape[0]):
        num = num + partial[c]
    cnt = count.to(torch.float32)
    return table + alpha * num.reshape(table.shape) / cnt.reshape(table.shape).clamp(min=1.0)


def _live_sums(delta, e):
    """Per cell of `e` (B, ...): Σ_b δ_b·e_b in K12's order (the envs of each
    chunk of `CHUNK` in index order from 0.0, then the chunks' sums in
    order from 0.0) and the count #{b: e_b ≠ 0} as float32."""
    part, cnt = chunk_partials_reference(delta, e)
    num = torch.zeros_like(part[0])
    for c in range(part.shape[0]):
        num = num + part[c]
    return num.reshape(e.shape[1:]), cnt.to(torch.float32).reshape(e.shape[1:])


def _live_mean(table, delta, e, alpha: float):
    """`table + α · Σ_b δ_b·e_b / max(#{b: e_b ≠ 0}, 1)`, per cell."""
    num, cnt = _live_sums(delta, e)
    return table + alpha * num / cnt.clamp(min=1.0)


def apply_trace_updates(q, delta, e, alpha: float):
    """Q += α · mean-over-live-traces(δ_i·e_i), per (s, a).

    `delta` (B,), `e` (B, S, A). Envs with e_i[s,a] = 0 don't count toward
    the (s, a) denominator, so a state visited by one env updates at full
    α·δ·e (sequential parity), and a start state shared by thousands of envs
    moves by their mean update instead of the sum."""
    return _live_mean(q, delta, e, alpha)


def trace_pass_reference(table, e, s, a, delta, cut, gamma: float, lam: float, cutoff: float,
                         alpha: float, kind: str):
    """Plain PyTorch version of K12, in its order of float adds: one step
    of the traces `e` (B, S, A) for control (`a` the actions) or (B, S) for
    prediction (`a` None). Decay and flush (`decay_traces`), bump this
    step's (s, a) or s (`bump_traces`), the live-trace mean into `table`,
    then zero the traces of the envs with `cut` set. `e` is updated IN
    PLACE; returns the new table."""
    x = _advance_traces(e, s, a, gamma, lam, cutoff, kind)
    new_table = _live_mean(table, delta, x, alpha)
    _cut_traces(e, x, cut)
    return new_table


def _advance_traces(e, s, a, gamma: float, lam: float, cutoff: float, kind: str):
    """The traces `e` after this step's decay, flush and bump (a new tensor)."""
    x = e if a is not None else e.unsqueeze(-1)
    x = decay_traces(x, gamma, lam, cutoff)
    x = bump_traces(x, s, torch.zeros_like(s) if a is None else a, x.shape[1], x.shape[2], kind)
    return x.reshape(e.shape)


def _cut_traces(e, x, cut) -> None:
    """`e` ← `x` with the traces of the envs where `cut` is set zeroed."""
    e.copy_(torch.where(cut.reshape((-1,) + (1,) * (e.dim() - 1)), 0.0, x))


def trace_partials_reference(e, s, a, delta, cut, gamma: float, lam: float, cutoff: float, kind: str):
    """Plain PyTorch version of the pass of K12's partial-sums form: the
    step of `trace_pass_reference` up to the mean, which it leaves to the
    caller. Decay, flush and bump `e` (B, S, A) or (B, S); then each chunk
    of `CHUNK` envs' Σ δ·e a cell and the live counts
    (`chunk_partials_reference`); then the cut. `e` is updated IN PLACE;
    returns (partials (⌈B / CHUNK⌉, cells) float32, count (cells,) int32)."""
    x = _advance_traces(e, s, a, gamma, lam, cutoff, kind)
    partial, count = chunk_partials_reference(delta, x)
    _cut_traces(e, x, cut)
    return partial, count


def trace_pass(table, e, s, a, delta, cut, gamma: float, lam: float, cutoff: float,
               alpha: float, kind: str, plan: TracePassPlan | None = None):
    """One step of the eligibility traces, `trace_pass_reference`'s
    function: K12 on CUDA tensors, through `plan` (a `TracePassPlan` built
    once a run for this table's shape and batch; without one, a plan built
    for the call), the plain version on CPU tensors. `e` is updated IN
    PLACE; returns the new table."""
    if not kernels.on_cuda(table, e):
        return trace_pass_reference(table, e, s, a, delta, cut, gamma, lam, cutoff, alpha, kind)
    return trace_pass_cuda(
        table, e, s.to(torch.int32), None if a is None else a.to(torch.int32),
        delta.to(torch.float32), cut.to(torch.bool), gamma * lam, cutoff, alpha,
        kind == "replacing", plan,
    )


def td_lambda_transition(sem, level, q, state, a, rs, injected, algo: str, gamma: float,
                         epsilon: float):
    """One step of TD(λ) control against `q` before its trace pass, shared
    by `sarsa_lambda` / `watkins_q_lambda` and
    `parallel.learner.td_lambda_sharded`: the auto-reset env step, the next
    action drawn from `q` before the update (`injected` (explore, rand_a),
    or None for a xorshift round of `rs`), δ with the SARSA or Watkins
    target, and the trace cut (the episode's end; Watkins also an
    exploratory next action), known before the update. Returns (state,
    a_next, rs, s, r, d, delta, cut)."""
    s = state.agent_idx
    state, out = step_autoreset(sem, level, state, a)
    s2, r, d = out.obs, out.reward, out.done
    draw, rs = _next_draw(rs, injected)
    a_next = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
    q2 = q[s2.long()]
    greedy2 = first_argmax(q2)
    if algo == "sarsa":
        boot = q2[torch.arange(q2.shape[0], device=q2.device), a_next.long()]
    else:  # watkins: off-policy max target
        boot = q2.max(dim=-1).values
    delta = r + gamma * torch.where(d, 0.0, boot) - q[s.long(), a.long()]
    # cut traces: always at episode end; Watkins also on exploration
    cut = d | (a_next != greedy2) if algo == "watkins" else d
    return state, a_next, rs, s, r, d, delta, cut


def _td_lambda_control(sem, level, key, algo, num_steps, batch_size, alpha, gamma, epsilon, lam,
                       trace, trace_cutoff, q0, draws) -> TDResult:
    check_trace(trace)
    dev = level.device
    num_states, num_actions = level.num_states, sem.num_actions
    if q0 is None:
        q = torch.zeros((num_states, num_actions), dtype=torch.float32, device=dev)
    else:
        q = q0.clone()
    state = reset_batch(level, batch_size)
    b = state.agent_idx.shape[0]
    rs = xorshift_init(key, (b,), device=dev)
    draw, rs = _next_draw(rs, None if draws is None else (draws[2], draws[3]))
    a = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
    e = torch.zeros((b, num_states, num_actions), dtype=torch.float32, device=dev)
    plan = TracePassPlan(q, b, True) if kernels.on_cuda(q) else None
    run_ret = torch.zeros(b, dtype=torch.float32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(num_steps):
        state, a_next, rs, s, r, d, delta, cut = td_lambda_transition(
            sem, level, q, state, a, rs, None if draws is None else (draws[0][i], draws[1][i]), algo,
            gamma, epsilon)
        # the trace pass: decay, then bump this step's (s, a); the mean; the cut
        q = trace_pass(q, e, s, a, delta, cut, gamma, lam, trace_cutoff, alpha, trace, plan=plan)
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)
        a = a_next
    return TDResult(q=q, episodes=n_eps, mean_return=ret_sum / n_eps.clamp(min=1))


def sarsa_lambda(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    lam: float = 0.9, trace: str = "accumulating",
    trace_cutoff: float = 1e-4, q0=None, draws=None,
) -> TDResult:
    """On-policy SARSA(λ) with per-env eligibility traces."""
    return _td_lambda_control(sem, level, key, "sarsa", num_steps, batch_size, alpha, gamma,
                              epsilon, lam, trace, trace_cutoff, q0, draws)


def watkins_q_lambda(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    lam: float = 0.9, trace: str = "accumulating",
    trace_cutoff: float = 1e-4, q0=None, draws=None,
) -> TDResult:
    """Watkins Q(λ): off-policy max targets; traces cut at exploratory
    actions (and episode ends)."""
    return _td_lambda_control(sem, level, key, "watkins", num_steps, batch_size, alpha, gamma,
                              epsilon, lam, trace, trace_cutoff, q0, draws)


@dataclasses.dataclass
class TDLambdaPredictionResult:
    v: torch.Tensor          # (S,) state values under the policy
    episodes: torch.Tensor   # () completed episodes


def policy_tables(policy: torch.Tensor):
    """(normalised CDF, log π) of an (S, A) policy: what the prediction's
    action draws read."""
    cdf = policy.to(torch.float32).cumsum(dim=-1)
    cdf = cdf / cdf[:, -1:].clamp(min=1e-30)
    return cdf, torch.log(policy.to(torch.float32).clamp(min=1e-30))


def td_lambda_prediction_transition(sem, level, v, state, rs, injected, cdf, logp, gamma: float):
    """One step of TD(λ) prediction against `v` before its trace pass,
    shared by `td_lambda_prediction` and
    `parallel.learner.td_lambda_prediction_sharded`: the action drawn from
    the policy (`injected` the step's (B,) actions or (B, A) Gumbel noise,
    or None for inverse CDF on a xorshift round's top 24 bits), the
    auto-reset env step and δ. Returns (state, rs, s, r, d, delta)."""
    s = state.agent_idx
    if injected is None:
        rs, bits = xorshift_next(rs)
        u = (to_uint32_values(bits) >> 8).to(torch.float32) / float(1 << 24)
        a = (u[:, None] >= cdf[s.long()]).sum(dim=-1).clamp(max=cdf.shape[-1] - 1).to(torch.int32)
    elif injected.dim() == 2:
        a = torch.argmax(logp[s.long()] + injected, dim=-1).to(torch.int32)
    else:
        a = injected.to(torch.int32)
    state, out = step_autoreset(sem, level, state, a)
    s2, r, d = out.obs, out.reward, out.done
    delta = r + gamma * torch.where(d, 0.0, v[s2.long()]) - v[s.long()]
    return state, rs, s, r, d, delta


def td_lambda_prediction(
    sem, level, policy: torch.Tensor, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, lam: float = 0.9,
    trace: str = "accumulating", trace_cutoff: float = 1e-4, draws=None,
) -> TDLambdaPredictionResult:
    """TD(λ) policy evaluation: learn V^π for a fixed stochastic policy
    (S, A) from on-policy experience, per-env (B, S) traces."""
    check_trace(trace)
    dev = level.device
    num_states = level.num_states
    v = torch.zeros((num_states,), dtype=torch.float32, device=dev)
    state = reset_batch(level, batch_size)
    b = state.agent_idx.shape[0]
    rs = xorshift_init(key, (b,), device=dev)
    e = torch.zeros((b, num_states), dtype=torch.float32, device=dev)
    plan = TracePassPlan(v, b, False) if kernels.on_cuda(v) else None
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    cdf, logp = policy_tables(policy)
    for i in range(num_steps):
        state, rs, s, r, d, delta = td_lambda_prediction_transition(
            sem, level, v, state, rs, None if draws is None else draws[i], cdf, logp, gamma)
        v = trace_pass(v, e, s, None, delta, d, gamma, lam, trace_cutoff, alpha, trace, plan=plan)
        n_eps = n_eps + d.sum()
    return TDLambdaPredictionResult(v=v, episodes=n_eps)
