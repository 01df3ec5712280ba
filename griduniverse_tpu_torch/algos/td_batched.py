"""Per-maze sampled TD control — one Q-table PER MAZE, (N, S, A).

PyTorch counterpart of `griduniverse_tpu/algos/td_batched.py`. Env n lives
in maze n and learns its own table, so one call trains N independent
tabular agents: no experience mixes, and the update is the sequential rule
`Q[n, s, a] += α·δ` with no aggregation. On CUDA the whole run is kernel K6
(`csrc/td_batched.cu`): one thread per maze, T steps inside one launch, as
many tables a block as fit held in shared memory for the whole run
(`kernels.td_batched.plan`). On the CPU it is the plain version
`q_learning_batched_reference`. The
reference's select-tree row lookup is not carried over: a lookup is an
index.

Random numbers. The native stream is one xorshift32 lane per maze, carried
in the state: each ε-greedy draw takes one round (coin from the low 16
bits, explore action from the top 16 bits, as `algos.td_fast`). `key` is
the integer seed of the lanes. Instead, `draws=(explore, rand_a, explore0,
rand_a0)` injects pre-drawn tensors — `explore` bool (T, N) and `rand_a`
int32 (T, N) for the action chosen at each step, and the (N,) pair for the
initial action — so that a test can feed the reference's own draws.

Chunk invariance: pass the returned `state` back as `state0` and run(2N)
equals run(N)∘run(N) bit for bit. A bare `q0` warm start is NOT a resume:
it restarts the envs and the stream.

Episode statistics. The state keeps PER-MAZE accumulators (`n_eps_env`,
`ret_sum_env`); `episodes` and `ret_sum` are their sums, taken once at the
end of a call. The reference adds a cross-maze sum to a scalar every step,
so `ret_sum`'s float order differs from the reference's (close, not
bit-equal); `episodes` is an integer and equal.

`dtype="bfloat16"` stores the tables in bfloat16. Rows are read exactly
into float32. Where the reference's type rules put bfloat16 the port
rounds as the reference does on the CPU: the scalars γ, 1−ε and ε
themselves, and the expectation target (the mean, both products and their
sum). γ·target and δ stay float32; α·δ rounds once to bfloat16, and the
add rounds to bfloat16. With the reference's draws injected this gives the
reference's tables bit for bit (tests/test_torch_td_batched.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.td_batched import td_batched_cuda
from ..ops.bitplane import FastState, pack_level, reset_bits, step_bits, xorshift_init, xorshift_next
from .dp import first_argmax
from .td_fast import _epsilon_greedy_bits, row_mean

ALGOS = ("q_learning", "sarsa", "expected_sarsa")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BatchedTDState:
    """Full resumable carry of `q_learning_batched`. Feed back as `state0`
    to continue the exact stream."""

    q: torch.Tensor            # (N, S, A) per-maze action values
    env_state: FastState       # (N,) fields
    a: torch.Tensor            # (N,) int32 next action (SARSA carry)
    rs: torch.Tensor           # (N,) int32 xorshift lanes
    run_ret: torch.Tensor      # (N,) float32 running episode returns
    n_eps_env: torch.Tensor    # (N,) int32 completed episodes per maze
    ret_sum_env: torch.Tensor  # (N,) float32 folded return sums per maze
    episodes: torch.Tensor     # () sum of n_eps_env
    ret_sum: torch.Tensor      # () float32 sum of ret_sum_env
    t: int                     # steps taken so far


@dataclasses.dataclass
class BatchedTDResult:
    q: torch.Tensor            # (N, S, A) per-maze action values
    episodes: torch.Tensor     # () completed episodes (all mazes)
    mean_return: torch.Tensor  # () float32 mean episode return
    state: BatchedTDState | None = None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bfloat16 (ties to even), as float32."""
    return x.to(torch.bfloat16).float()


def target_scalars(gamma: float, epsilon: float, low: bool):
    """(γ, 1−ε, ε) as the target arithmetic uses them. With bfloat16 tables
    they meet bfloat16 values, and the reference's type rules then round
    the scalar itself to bfloat16 (1−ε is taken in float32 first)."""
    g, e = torch.tensor(gamma, dtype=torch.float32), torch.tensor(epsilon, dtype=torch.float32)
    scalars = (g, 1.0 - e, e)
    if low:
        scalars = tuple(_bf16(x) for x in scalars)
    return tuple(float(x) for x in scalars)


def _rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Q[n, s_n, :] → (N, A) float32."""
    n, _, a = q.shape
    return q.gather(1, s.long()[:, None, None].expand(n, 1, a))[:, 0, :].float()


def _draw(q, s, epsilon, rs, explore, rand_a):
    """ε-greedy on Q[n, s_n, :] from the native lanes (one round) or from
    injected (explore, rand_a). Returns (actions, new lanes)."""
    rows = _rows(q, s)
    if explore is None:
        rs, bits = xorshift_next(rs)
        return _epsilon_greedy_bits(rows, bits, epsilon), rs
    num_actions = rows.shape[-1]
    rand_a = rand_a.to(torch.int32).clamp(0, num_actions - 1)
    return torch.where(explore, rand_a, first_argmax(rows)), rs


def _td_step(sem, bl, algo, alpha, scalars, max_episode_steps, q, state, a, a_next_fn):
    """One per-maze TD transition and table update, the port of the
    reference's `_td_step`; `q` is updated IN PLACE, after every read.
    `scalars` is `target_scalars(...)`. Returns (new_state, a_next, r, d)."""
    low = q.dtype == torch.bfloat16
    gamma, one_minus_eps, eps = scalars
    s = state.agent_idx
    new_state, (s2, r, d) = step_bits(sem, bl, state, a, True, max_episode_steps)
    rows_s, rows_s2 = _rows(q, s), _rows(q, s2)
    q_sa = rows_s.gather(1, a.long()[:, None])[:, 0]
    a_next = a_next_fn(q, new_state.agent_idx)  # before the update commits
    if algo == "q_learning":
        boot = rows_s2.max(dim=-1).values
    elif algo == "sarsa":
        boot = rows_s2.gather(1, a_next.long()[:, None])[:, 0]
    else:  # expected_sarsa
        greedy, mean = rows_s2.max(dim=-1).values, row_mean(rows_s2)
        if low:
            boot = _bf16(_bf16(one_minus_eps * greedy) + _bf16(eps * _bf16(mean)))
        else:
            boot = one_minus_eps * greedy + eps * mean
    delta = r + gamma * torch.where(d, 0.0, boot) - q_sa
    inc = alpha * delta
    new = _bf16(q_sa + _bf16(inc)) if low else q_sa + inc
    n, _, num_actions = q.shape
    flat = (s.long() * num_actions + a.long())[:, None]
    q.view(n, -1).scatter_(1, flat, new.to(q.dtype)[:, None])
    return new_state, a_next, r, d


def _check(levels: Level, algo: str) -> None:
    if levels.grid.dim() != 3:
        raise ValueError(
            f"q_learning_batched expects a batched (N, H, W) level grid; got "
            f"{tuple(levels.grid.shape)} — use algos.td.q_learning"
        )
    if algo not in ALGOS:
        raise ValueError(f"unknown algo: {algo!r}")


def _init_state(sem, bl, key, q0, dtype, lane_offset=0) -> BatchedTDState:
    """Fresh tables, envs at their starts, seeded lanes (numbered from
    `lane_offset`); the first action `a` is still to be drawn."""
    dev = bl.device
    n = int(bl.code_words.shape[0])
    if q0 is None:
        q = torch.zeros((n, bl.num_states, sem.num_actions), dtype=_DTYPES[dtype], device=dev)
    else:
        q = q0.clone()
    env0 = reset_bits(bl, None)
    rs = xorshift_init(key, (n,), lane_offset, device=dev)
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    return BatchedTDState(
        q=q, env_state=env0, a=zi, rs=rs, run_ret=zf, n_eps_env=zi, ret_sum_env=zf,
        episodes=zi.sum(), ret_sum=zf.sum(), t=0,
    )


def _result(st: BatchedTDState) -> BatchedTDResult:
    st.episodes = st.n_eps_env.sum()
    st.ret_sum = st.ret_sum_env.sum()
    return BatchedTDResult(
        q=st.q, episodes=st.episodes,
        mean_return=st.ret_sum / st.episodes.clamp(min=1), state=st,
    )


def _check_draws(draws, num_steps, n):
    """Injected draws as (explore, rand_a, explore0, rand_a0), or four Nones."""
    if draws is None:
        return None, None, None, None
    explore, rand_a, explore0, rand_a0 = draws
    for name, x, shape in (
        ("explore", explore, (num_steps, n)), ("rand_a", rand_a, (num_steps, n)),
        ("explore0", explore0, (n,)), ("rand_a0", rand_a0, (n,)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"draws: {name} has shape {tuple(x.shape)}, expected {shape}")
    return explore, rand_a, explore0, rand_a0


def q_learning_batched_reference(
    sem: Semantics,
    levels: Level,
    key,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    q0: torch.Tensor | None = None,
    state0: BatchedTDState | None = None,
    dtype: str = "float32",
    draws=None,
    lane_offset: int = 0,
) -> BatchedTDResult:
    """Plain PyTorch version of K6: a Python loop over steps with
    `torch.gather` / `scatter` on the (N, S, A) tables."""
    _check(levels, algo)
    bl = pack_level(levels)
    st = state0 if state0 is not None else _init_state(sem, bl, key, q0, dtype, lane_offset)
    explore, rand_a, explore0, rand_a0 = _check_draws(draws, num_steps, st.a.shape[0])
    q, state, a, rs = st.q.clone(), st.env_state, st.a, st.rs
    if state0 is None:
        a, rs = _draw(q, state.agent_idx, epsilon, rs, explore0, rand_a0)
    run_ret, n_eps_env, ret_sum_env = st.run_ret, st.n_eps_env, st.ret_sum_env
    scalars = target_scalars(gamma, epsilon, q.dtype == torch.bfloat16)
    for i in range(num_steps):
        def a_next_fn(q_now, s_next):
            nonlocal rs
            ex, ra = (None, None) if explore is None else (explore[i], rand_a[i])
            a_next, rs = _draw(q_now, s_next, epsilon, rs, ex, ra)
            return a_next

        state, a, r, d = _td_step(
            sem, bl, algo, alpha, scalars, max_episode_steps, q, state, a, a_next_fn
        )
        run_ret = run_ret + r
        n_eps_env = n_eps_env + d.to(torch.int32)
        ret_sum_env = ret_sum_env + torch.where(d, run_ret, 0.0)
        run_ret = torch.where(d, 0.0, run_ret)
    return _result(BatchedTDState(
        q=q, env_state=state, a=a, rs=rs, run_ret=run_ret, n_eps_env=n_eps_env,
        ret_sum_env=ret_sum_env, episodes=st.episodes, ret_sum=st.ret_sum,
        t=st.t + num_steps,
    ))


def q_learning_batched(
    sem: Semantics,
    levels: Level,
    key,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    q0: torch.Tensor | None = None,
    state0: BatchedTDState | None = None,
    dtype: str = "float32",
    draws=None,
    lane_offset: int = 0,
) -> BatchedTDResult:
    """Train one ε-greedy TD agent PER MAZE for `num_steps` steps (K6 on
    CUDA).

    levels — batched (N, H, W); env n steps maze n with auto-reset.
    key — integer seed of the per-maze xorshift lanes (unused on a resume).
    algo — "q_learning" (max target), "sarsa" (carried next action) or
    "expected_sarsa" (ε-greedy expectation).
    state0 — a `result.state` of a previous call: resumes tables, envs,
    lanes and accumulators, so chunked runs equal unbroken ones bit for
    bit. `q0` alone warm-starts tables but restarts envs and the stream.
    dtype — storage type of the tables, "float32" or "bfloat16" (module
    docstring); ignored when `q0` or `state0` supply tables.
    draws — optional injected (explore, rand_a, explore0, rand_a0).
    lane_offset — the global number of maze 0's xorshift lane: a shard of
    a sharded run passes its first maze's index and draws that maze's
    stream of the unsharded run.
    Returns per-maze Q (N, S, A), pooled episode stats, and the resume
    carry in `.state`."""
    _check(levels, algo)
    if not kernels.on_cuda(levels.grid, sem.deltas):
        return q_learning_batched_reference(
            sem, levels, key, num_steps, alpha, gamma, epsilon, algo,
            max_episode_steps, q0, state0, dtype, draws, lane_offset,
        )
    bl = pack_level(levels)
    st = state0 if state0 is not None else _init_state(sem, bl, key, q0, dtype, lane_offset)
    q, idx, code, t, a, rs, run_ret, n_eps_env, ret_sum_env = td_batched_cuda(
        sem, bl, st.q, st.env_state, st.a, st.rs, st.run_ret, st.n_eps_env,
        st.ret_sum_env, _check_draws(draws, num_steps, st.a.shape[0]),
        state0 is None, num_steps, alpha, gamma, epsilon,
        ALGOS.index(algo), max_episode_steps,
        target_scalars(gamma, epsilon, st.q.dtype == torch.bfloat16),
    )
    return _result(BatchedTDState(
        q=q, env_state=FastState(idx, code, t, torch.zeros_like(st.env_state.done)),
        a=a, rs=rs, run_ret=run_ret, n_eps_env=n_eps_env, ret_sum_env=ret_sum_env,
        episodes=st.episodes, ret_sum=st.ret_sum, t=st.t + num_steps,
    ))
