"""Monte-Carlo prediction and control, episode-batched.

PyTorch counterpart of `griduniverse_tpu/algos/mc.py`. B episodes of fixed
maximum length T are rolled in lockstep on the generic step (freeze-on-done
gives fixed shapes). The returns (a reverse pass over time) and the
FIRST-VISIT mask (each step's id against the earlier valid steps of its
episode) are kernel K13 (`csrc/mc_returns.cu`, one launch a round) on CUDA;
on the CPU the plain versions `discounted_returns` and `first_visit_mask`
(a (T, T) triangular self-comparison per episode). The per-state
aggregation is the deterministic segment mean of `algos.td`
(`apply_td_updates_masked`: kernel K10 on CUDA, its plain version on the
CPU), so a run repeats its bits on the card, at any number of samples (T·B)
a round.

Random numbers. The native stream is one xorshift32 lane per episode, one
round a step: the uniform-random policy takes its action from the top 16
bits, the ε-greedy one as `algos.td.epsilon_greedy` does. `key` is the
integer seed of the lanes. Instead, `draws` injects pre-drawn tensors, so
that a test can feed the reference's own draws: (T, B) int32 actions for
the random policy, or the pair (explore (T, B) bool, rand_a (T, B) int32).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.semantics import Semantics
from ..core.step import step
from ..core.types import Level
from ..kernels.mc_returns import mc_returns_cuda
from ..ops.bitplane import to_uint32_values, xorshift_init, xorshift_next
from ..ops.rollout import reset_batch
from .td import apply_td_updates_masked, epsilon_greedy


def _roll_episodes(sem, level, q_or_policy, key, batch_size, max_steps, epsilon, draws=None,
                   lane_offset: int = 0):
    """Roll B freeze-on-done episodes. Returns time-major (T, B) tensors:
    s (pre-step state), a, r, valid (the step happened before termination),
    and the (B,) `finished` flag: True iff episode b terminated within the
    T-step budget (its observed return is the COMPLETE return).

    q_or_policy: (S, A) Q-table for ε-greedy, or None for uniform random.
    `lane_offset`: the global index of the first episode's xorshift lane (a
    shard's first episode)."""
    state = reset_batch(level, batch_size)
    b = state.agent_idx.shape[0]
    rs = xorshift_init(key, (b,), lane_offset, device=level.device) if draws is None else None
    rows = []
    for t in range(max_steps):
        s = state.agent_idx
        valid = ~state.done
        if draws is None:
            rs, bits = xorshift_next(rs)
            if q_or_policy is None:
                a = (((to_uint32_values(bits) >> 16) * sem.num_actions) >> 16).to(torch.int32)
            else:
                a = epsilon_greedy(q_or_policy[s.long()], bits, epsilon)
        elif q_or_policy is None:
            a = draws[t].to(torch.int32)
        else:
            a = epsilon_greedy(q_or_policy[s.long()], (draws[0][t], draws[1][t]), epsilon)
        state, out = step(sem, level, state, a)
        rows.append((s, a, out.reward, valid))
    s, a, r, valid = (torch.stack(field) for field in zip(*rows))
    return s, a, r, valid, state.done


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """G_t = r_t + γ·G_{t+1}, by a reverse pass over the time axis.
    rewards: (T, ...) → returns (T, ...). Frozen post-done rewards are 0, so
    no masking is needed."""
    g = torch.zeros_like(rewards[0])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * g
        out.append(g)
    return torch.stack(out[::-1])


def first_visit_mask(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(T, B) ids → (T, B) bool: True where ids[t, b] is the FIRST valid
    occurrence in episode b. O(T²) broadcast compare; T is small."""
    t = ids.shape[0]
    same = ids[:, None, :] == ids[None, :, :]          # (T, T', B)
    steps = torch.arange(t, device=ids.device)
    earlier = (steps[None, :] < steps[:, None])[:, :, None]  # t' < t
    seen_before = (same & earlier & valid[None, :, :]).any(dim=1)
    return valid & ~seen_before


def mc_returns(rewards: torch.Tensor, gamma: float, ids=None, valid=None):
    """(returns, first-visit mask) of (T, B) samples: `discounted_returns`
    of the float32 `rewards`, and with `ids` (T, B) int32 and `valid` (T, B)
    bool the `first_visit_mask`, else None (K13 on CUDA, equal to the plain
    versions bit for bit)."""
    extra = () if ids is None else (ids, valid)
    if not kernels.on_cuda(rewards, *extra):
        g = discounted_returns(rewards, gamma)
        return g, None if ids is None else first_visit_mask(ids, valid)
    if ids is not None:
        extra = (ids.to(torch.int32).contiguous(), valid.contiguous())
    return mc_returns_cuda(rewards.contiguous(), gamma, *extra)


def _segment_mean(table, cell, action, increment, alpha, mask):
    """`table + Σ α·increment / max(count, 1)` per (cell, action) over the
    (T, B) samples where `mask` is set, summed in (t, b) order."""
    return apply_td_updates_masked(
        table, cell.reshape(-1).contiguous(), action.reshape(-1).contiguous(),
        increment.reshape(-1).contiguous(), alpha, mask.reshape(-1).contiguous())


def mc_round(sem: Semantics, level: Level, table, q_or_policy, key, batch_size: int, max_steps: int,
             epsilon: float, gamma: float, first_visit: bool, include_unfinished: bool, draws=None,
             lane_offset: int = 0):
    """One round of the MC family, shared by `mc_prediction` / `mc_control`
    and their sharded forms in `parallel.learner`: roll B episodes
    (`_roll_episodes`), take their returns and (first-visit) mask (K13),
    and give the (T, B) samples of the update: (cells, actions, increments,
    mask). For control (`table` the (S, A) Q) the cells are the states, the
    actions the actions taken and the increments `G − Q(s, a)`; for
    prediction (`table` None) the actions are 0 and the increments the
    returns. Returns and mask are per episode, so a shard's samples need
    nothing of another's."""
    s, a, r, valid, finished = _roll_episodes(
        sem, level, q_or_policy, key, batch_size, max_steps, epsilon, draws, lane_offset)
    if not include_unfinished:
        valid = valid & finished[None, :]
    ids = s if table is None else s * sem.num_actions + a
    g, first = mc_returns(r, gamma, ids, valid) if first_visit else mc_returns(r, gamma)
    mask = first if first_visit else valid
    if table is None:
        return s, torch.zeros_like(s), g, mask
    return s, a, g - table.reshape(-1)[ids.long()], mask


@dataclasses.dataclass
class MCResult:
    value: torch.Tensor   # (S,) or (S, A)
    counts: torch.Tensor  # visit counts, same shape, float32


def mc_prediction(
    sem: Semantics,
    level: Level,
    key,
    policy_q: torch.Tensor | None = None,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    batch_size: int = 256,
    max_steps: int = 100,
    first_visit: bool = True,
    include_unfinished: bool = False,
    draws=None,
) -> MCResult:
    """MC state-value prediction: V(s) = mean of (first-visit) returns
    observed from s, over B parallel episodes under the ε-greedy(policy_q),
    or uniform-random, policy.

    Episodes still running at `max_steps` carry PARTIAL returns; including
    them biases V toward zero wherever the step budget binds. They are
    therefore EXCLUDED by default. `include_unfinished=True` restores the
    biased everything-counts estimator."""
    num_states = level.num_states
    s, zero, g, mask = mc_round(sem, level, None, policy_q, key, batch_size, max_steps, epsilon, gamma,
                                first_visit, include_unfinished, draws)
    zeros = torch.zeros((num_states, 1), dtype=torch.float32, device=s.device)
    # with a zero table and α = 1 the segment mean IS the mean return
    v = _segment_mean(zeros, s, zero, g, 1.0, mask)[:, 0]
    n = torch.bincount(s[mask].long(), minlength=num_states).to(torch.float32)
    return MCResult(value=v, counts=n)


@dataclasses.dataclass
class MCControlResult:
    q: torch.Tensor         # (S, A)
    episodes: torch.Tensor  # () total episodes sampled


def mc_control(
    sem: Semantics,
    level: Level,
    key,
    num_rounds: int = 50,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    alpha: float = 0.05,
    batch_size: int = 256,
    max_steps: int = 100,
    first_visit: bool = True,
    include_unfinished: bool = False,
    draws=None,
) -> MCControlResult:
    """ε-greedy MC control (GLIE-style, constant-α incremental updates).

    Each round: roll B episodes under ε-greedy(Q), compute (first-visit)
    returns per (s, a), apply Q ← Q + α·(G − Q) as the mean over colliding
    (s, a) increments (synchronous batched semantics, as in `algos.td`).
    Round r's lanes are seeded by `key + r`; `draws` is one (explore,
    rand_a) pair per round. As in `mc_prediction`, unfinished episodes are
    excluded from the update by default."""
    dev = level.device
    q = torch.zeros((level.num_states, sem.num_actions), dtype=torch.float32, device=dev)
    b = batch_size
    for rnd in range(num_rounds):
        s, a, delta, mask = mc_round(
            sem, level, q, q, int(key) + rnd, batch_size, max_steps, epsilon, gamma, first_visit,
            include_unfinished, None if draws is None else draws[rnd])
        b = s.shape[1]
        q = _segment_mean(q, s, a, delta, alpha, mask)
    return MCControlResult(q=q, episodes=torch.tensor(num_rounds * b, dtype=torch.int64, device=dev))
