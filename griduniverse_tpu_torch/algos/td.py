"""Temporal-difference control — Q-learning / SARSA / expected SARSA /
double Q-learning over one shared table, on the generic step.

PyTorch counterpart of `griduniverse_tpu/algos/td.py`. B auto-reset envs
share one Q(S, A); every env's TD error is taken against the same
pre-update Q, and colliding (s, a) increments take the MEAN of α·δ,
summed in env order (`apply_td_updates`). With B=1 this is exactly the
sequential rule `Q[s,a] += α·δ`. On CUDA `apply_td_updates` and its masked
form are kernel K10 (`csrc/segment_mean.cu`); on the CPU they are the plain
version `apply_td_updates_reference`.

`td_run` is a Python loop over steps (generic `core.step`, `epsilon_greedy`,
the `td_error_*`, K10), so on the card it pays a few dozen small launches a
step; the fused learners are `algos.td_fast` and `algos.td_batched`.

Random numbers. The native stream is one xorshift32 lane per env, carried
in the train state: each ε-greedy draw takes one round (coin from the low
16 bits, explore action from the top 16 bits). `key` is the integer seed
of the lanes. Instead, `draws` injects pre-drawn tensors — `explore` bool
(T, B) and `rand_a` int32 (T, B), the (B,) pair for the initial action, and
for `double_q_learning` the table coin — so that a test can feed the
reference's own draws. All state is explicit, so run(2N) equals
run(N)∘run(N) bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.semantics import Semantics
from ..core.step import step_autoreset
from ..core.types import EnvState, Level
from ..kernels.segment_mean import segment_mean_cuda, segment_sums_cuda
from ..ops.bitplane import xorshift_init, xorshift_next
from ..ops.rollout import reset_batch
from .dp import first_argmax
from .td_fast import _epsilon_greedy_bits, row_mean

ALGOS = ("q_learning", "sarsa", "expected_sarsa")


def epsilon_greedy(q_rows: torch.Tensor, draw, epsilon: float) -> torch.Tensor:
    """ε-greedy over per-state Q rows (..., A) → actions (...,) int32.

    `draw` is one random word per env (int32 bit patterns of a xorshift32
    round: coin from the low 16 bits, explore action from the top 16), or an
    injected pair `(explore bool, rand_a int32)`. Greedy ties go to the
    lowest action."""
    if isinstance(draw, tuple):
        explore, rand_a = draw
        return torch.where(explore, rand_a.to(torch.int32), first_argmax(q_rows))
    return _epsilon_greedy_bits(q_rows, draw, epsilon)


def _q_at(q, s, a):
    return q[s.long(), a.long()]


def td_error_qlearning(q, s, a, r, s2, done, gamma):
    """δ = r + γ·(1−done)·max_a' Q(s', a') − Q(s, a). Off-policy target."""
    target = r + gamma * torch.where(done, 0.0, q[s2.long()].max(dim=-1).values)
    return target - _q_at(q, s, a)


def td_error_sarsa(q, s, a, r, s2, a2, done, gamma):
    """δ = r + γ·(1−done)·Q(s', a') − Q(s, a). On-policy target."""
    target = r + gamma * torch.where(done, 0.0, _q_at(q, s2, a2))
    return target - _q_at(q, s, a)


def td_error_expected_sarsa(q, s, a, r, s2, done, gamma, epsilon):
    """δ with the ε-greedy expectation over Q(s', ·)."""
    q2 = q[s2.long()]
    expected = (1.0 - epsilon) * q2.max(dim=-1).values + epsilon * row_mean(q2)
    target = r + gamma * torch.where(done, 0.0, expected)
    return target - _q_at(q, s, a)


def segment_sums_reference(s, a, delta, alpha, num_states: int, num_actions: int, mask=None):
    """Plain PyTorch version of K10's sums form: per (s, a), the float32 sum
    of α·δ over the envs at that cell IN INCREASING ENV INDEX, and the count
    (int32), each (S·A,). It adds the first member of every segment, then
    the second, and so on; each pass has unique indices, so the order of
    every segment's adds is env order."""
    flat = s.long() * num_actions + a.long()
    inc = alpha * delta
    if mask is not None:
        flat, inc = flat[mask], inc[mask]
    upd = torch.zeros(num_states * num_actions, dtype=torch.float32, device=delta.device)
    cnt = torch.zeros(num_states * num_actions, dtype=torch.int32, device=delta.device)
    if flat.numel():
        order = torch.argsort(flat, stable=True)
        keys, inc = flat[order], inc[order]
        pos = torch.arange(keys.numel(), device=delta.device)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        rank = pos - torch.where(first, pos, 0).cummax(dim=0).values
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            upd[keys[sel]] = upd[keys[sel]] + inc[sel]
            cnt[keys[sel]] = cnt[keys[sel]] + 1
    return upd, cnt


def segment_sums(s, a, delta, alpha, num_states: int, num_actions: int, mask=None):
    """K10's sums form on CUDA (`segment_sums_reference` on the CPU): the
    env-order float sums of α·δ and the counts of every (s, a), for a
    sharded learner to sum over its ranks before `apply_segment_sums`."""
    if not kernels.on_cuda(s, a, delta, *(() if mask is None else (mask,))):
        return segment_sums_reference(s, a, delta, alpha, num_states, num_actions, mask)
    return segment_sums_cuda(s, a, delta, alpha, num_states, num_actions, mask)


def apply_segment_sums(q, sums, counts):
    """`q + sums / max(counts, 1)`, the mean's apply after the sums (each
    (S·A,); counts of any integer type) are summed over the ranks."""
    mean = sums / counts.clamp(min=1).to(torch.float32)
    return q + mean.reshape(q.shape)


def apply_td_updates_reference(q, s, a, delta, alpha, mask=None):
    """Plain PyTorch version of K10: per (s, a), the float sum of α·δ over
    the envs at that cell in increasing env index (`segment_sums_reference`),
    the count, and `q + sum / max(count, 1)`."""
    num_states, num_actions = q.shape
    upd, cnt = segment_sums_reference(s, a, delta, alpha, num_states, num_actions, mask)
    return apply_segment_sums(q, upd, cnt)


def apply_td_updates(q, s, a, delta, alpha):
    """Aggregate per-env α·δ increments into the dense Q (K10 on CUDA):
    deterministic, in env order. Collisions take the MEAN of the
    increments for an (s, a), not the sum; with B=1 this is bit-exactly the
    sequential update."""
    if not kernels.on_cuda(q, s, a, delta):
        return apply_td_updates_reference(q, s, a, delta, alpha)
    return segment_mean_cuda(q, s, a, delta, alpha, None)


def apply_td_updates_masked(q, s, a, delta, alpha, mask):
    """`apply_td_updates` restricted to envs where `mask` is True — used by
    per-env-coin double Q-learning."""
    if not kernels.on_cuda(q, s, a, delta, mask):
        return apply_td_updates_reference(q, s, a, delta, alpha, mask)
    return segment_mean_cuda(q, s, a, delta, alpha, mask)


@dataclasses.dataclass
class TDResult:
    q: torch.Tensor            # (S, A) learned action values
    episodes: torch.Tensor     # () completed episodes
    mean_return: torch.Tensor  # () float32 mean episode return over the run


@dataclasses.dataclass
class TDTrainState:
    """Full resumable learner state. The per-env xorshift lanes take the
    place of the reference's PRNG key."""

    q: torch.Tensor          # (S, A)
    env_state: EnvState      # (B,) fields
    action: torch.Tensor     # (B,) int32 next action to execute (SARSA carry)
    rs: torch.Tensor         # (B,) int32 xorshift lanes
    step: int                # global step counter
    run_ret: torch.Tensor    # (B,) running per-env episode returns
    episodes: torch.Tensor   # () int64
    ret_sum: torch.Tensor    # () float32


def _next_draw(rs, injected):
    """(draw for `epsilon_greedy`, new lanes): the injected pair as it is,
    else one xorshift32 round."""
    if injected is not None:
        return injected, rs
    rs, bits = xorshift_next(rs)
    return bits, rs


def td_init(
    sem: Semantics,
    level: Level,
    key,
    batch_size: int,
    epsilon: float = 0.1,
    q0: torch.Tensor | None = None,
    draw0=None,
) -> TDTrainState:
    """The initial train state on the level's device. `draw0` injects the
    initial action's (explore, rand_a) pair."""
    dev = level.device
    if q0 is None:
        q = torch.zeros((level.num_states, sem.num_actions), dtype=torch.float32, device=dev)
    else:
        q = q0.clone()
    state0 = reset_batch(level, batch_size)
    b = state0.agent_idx.shape[0]
    draw, rs = _next_draw(xorshift_init(key, (b,), device=dev), draw0)
    return TDTrainState(
        q=q,
        env_state=state0,
        action=epsilon_greedy(q[state0.agent_idx.long()], draw, epsilon),
        rs=rs,
        step=0,
        run_ret=torch.zeros(b, dtype=torch.float32, device=dev),
        episodes=torch.zeros((), dtype=torch.int64, device=dev),
        ret_sum=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _fold_stats(run_ret, n_eps, ret_sum, r, d):
    run_ret = run_ret + r
    n_eps = n_eps + d.sum()
    ret_sum = ret_sum + torch.where(d, run_ret, 0.0).sum()
    return torch.where(d, 0.0, run_ret), n_eps, ret_sum


def td_run(
    sem: Semantics,
    level: Level,
    ts: TDTrainState,
    num_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    draws=None,
) -> TDTrainState:
    """Advance training by `num_steps`. Chunk-invariant. `draws` injects
    (explore (T, B) bool, rand_a (T, B) int32) for the action chosen at
    each step."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo: {algo!r}")
    q, state, a, rs = ts.q, ts.env_state, ts.action, ts.rs
    run_ret, n_eps, ret_sum = ts.run_ret, ts.episodes, ts.ret_sum
    for i in range(num_steps):
        s = state.agent_idx
        state, out = step_autoreset(sem, level, state, a)
        s2, r, d = out.obs, out.reward, out.done
        # next action from the CURRENT q at the post-reset state, chosen
        # before the update commits (classic SARSA ordering)
        draw, rs = _next_draw(rs, None if draws is None else (draws[0][i], draws[1][i]))
        a_next = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
        if algo == "q_learning":
            delta = td_error_qlearning(q, s, a, r, s2, d, gamma)
        elif algo == "sarsa":
            delta = td_error_sarsa(q, s, a, r, s2, a_next, d, gamma)
        else:
            delta = td_error_expected_sarsa(q, s, a, r, s2, d, gamma, epsilon)
        q = apply_td_updates(q, s, a, delta, alpha)
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)
        a = a_next
    return TDTrainState(
        q=q, env_state=state, action=a, rs=rs, step=ts.step + num_steps,
        run_ret=run_ret, episodes=n_eps, ret_sum=ret_sum,
    )


def _td_train(sem, level, key, algo, num_steps, batch_size, alpha, gamma, epsilon, q0, draws):
    step_draws, draw0 = (None, None) if draws is None else (draws[:2], tuple(draws[2:]))
    ts = td_init(sem, level, key, batch_size, epsilon, q0, draw0)
    ts = td_run(sem, level, ts, num_steps, alpha, gamma, epsilon, algo, step_draws)
    return TDResult(
        q=ts.q, episodes=ts.episodes, mean_return=ts.ret_sum / ts.episodes.clamp(min=1)
    )


def q_learning(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None, draws=None,
) -> TDResult:
    """Batched synchronous Q-learning. `draws` injects (explore, rand_a,
    explore0, rand_a0)."""
    return _td_train(
        sem, level, key, "q_learning", num_steps, batch_size, alpha, gamma, epsilon, q0, draws
    )


def sarsa(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None, draws=None,
) -> TDResult:
    """Batched on-policy SARSA."""
    return _td_train(
        sem, level, key, "sarsa", num_steps, batch_size, alpha, gamma, epsilon, q0, draws
    )


def expected_sarsa(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None, draws=None,
) -> TDResult:
    """Batched expected SARSA."""
    return _td_train(
        sem, level, key, "expected_sarsa", num_steps, batch_size, alpha, gamma, epsilon, q0,
        draws,
    )


@dataclasses.dataclass
class DoubleTDResult:
    q: torch.Tensor            # (S, A) combined table (q_a + q_b) / 2
    q_a: torch.Tensor          # (S, A) first table
    q_b: torch.Tensor          # (S, A) second table
    episodes: torch.Tensor     # () completed episodes
    mean_return: torch.Tensor  # () float32 mean episode return over the run


def double_q_learning(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    coin: str = "per_env", draws=None,
) -> DoubleTDResult:
    """Batched double Q-learning (van Hasselt 2010): two tables, each
    evaluated by the other. Behaviour policy: ε-greedy on (q_a + q_b).

    coin — which table each transition updates: "per_env" (an independent
    coin per env splits the batch between the tables every step) or
    "global" (one coin per step updates one table with the whole batch).
    Natively the coin is the top bit of a second xorshift32 round (env 0's
    lane for "global"). `draws` injects (explore (T, B), rand_a (T, B),
    pick_a), `pick_a` bool (T, B) for "per_env" and (T,) for "global"."""
    if coin not in ("per_env", "global"):
        raise ValueError(f"unknown coin mode: {coin!r}")
    dev = level.device
    q_a = torch.zeros((level.num_states, sem.num_actions), dtype=torch.float32, device=dev)
    q_b = q_a.clone()
    state = reset_batch(level, batch_size)
    b = state.agent_idx.shape[0]
    rs = xorshift_init(key, (b,), device=dev)
    run_ret = torch.zeros(b, dtype=torch.float32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)

    def cross_delta(q_upd, q_eval, s, a, r, s2, d):
        a_star = first_argmax(q_upd[s2.long()])
        target = r + gamma * torch.where(d, 0.0, _q_at(q_eval, s2, a_star))
        return target - _q_at(q_upd, s, a)

    for i in range(num_steps):
        s = state.agent_idx
        draw, rs = _next_draw(rs, None if draws is None else (draws[0][i], draws[1][i]))
        act = epsilon_greedy((q_a + q_b)[s.long()], draw, epsilon)
        state, out = step_autoreset(sem, level, state, act)
        s2, r, d = out.obs, out.reward, out.done
        delta_a = cross_delta(q_a, q_b, s, act, r, s2, d)
        delta_b = cross_delta(q_b, q_a, s, act, r, s2, d)
        if draws is None:
            rs, bits = xorshift_next(rs)
            pick_a = bits < 0 if coin == "per_env" else bits[0] < 0
        else:
            pick_a = draws[2][i]
        if coin == "per_env":
            q_a = apply_td_updates_masked(q_a, s, act, delta_a, alpha, pick_a)
            q_b = apply_td_updates_masked(q_b, s, act, delta_b, alpha, ~pick_a)
        else:  # one coin per step; the other table's update is discarded
            q_a = torch.where(pick_a, apply_td_updates(q_a, s, act, delta_a, alpha), q_a)
            q_b = torch.where(pick_a, q_b, apply_td_updates(q_b, s, act, delta_b, alpha))
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)

    return DoubleTDResult(
        q=(q_a + q_b) * 0.5, q_a=q_a, q_b=q_b, episodes=n_eps,
        mean_return=ret_sum / n_eps.clamp(min=1),
    )
