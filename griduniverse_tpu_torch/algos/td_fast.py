"""Shared-Q tabular TD control on the bit-packed engine — the fast learner.

PyTorch counterpart of `griduniverse_tpu/algos/td_fast.py`. B envs step the
bit-packed engine (`ops.bitplane`) and learn ONE table Q(S, A): every step
all envs act ε-greedily on the same pre-update Q, every env's TD error is
taken against that Q, and each (s, a) cell moves by the MEAN of α·δ over
the envs that hit it (synchronous batched TD, the rule of
`algos.td.apply_td_updates`).

The reference writes every table access as a one-hot matrix product,
because the TPU gathers slowly and scatters through its matrix unit. Here
a row lookup is an index and the aggregate is an atomic add: on CUDA the
scan is kernel K5 (`csrc/td_fast.cu`), on the CPU the plain version
`td_scan_fast_reference` below. The reference's hi/lo one-hot
factorization is not carried over; its `psum_axes` (the sharded learner)
is `td_scan_fast_sharded`: K5's sharded form, one launch a step with each
step's aggregate summed over the ranks between launches.

Numerics. Q stays float32 throughout (the reference reads Q and writes α·δ
through bfloat16, and promises a learning outcome, not bits). The
aggregate is ORDER-FREE: each env's α·δ (float32) is turned into a 64-bit
fixed-point integer, round-to-nearest-even of α·δ·2^32, the integers are
summed exactly, and the mean `sum·2^-32 / max(count, 1)` is taken in
float64 and rounded once to float32 before it is added to Q. Integer
addition is associative, so the result does not depend on the order in
which envs are added: two runs give the same bits, a chunked run equals
the unbroken run, and K5 equals the plain version bit for bit.

RNG: one xorshift32 round per env per step supplies both the ε coin (low
16 bits) and the explore action (top 16 bits, multiply-shift) — the stream
of `ops.bitplane.xorshift_init`, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.semantics import Semantics
from ..kernels.td_fast import step_slots as td_step_slots
from ..kernels.td_fast import td_scan_fast_cuda, td_step_sharded_cuda
from ..ops.bitplane import (
    BitLevel,
    FastState,
    reset_bits,
    step_bits,
    to_uint32_values,
    xorshift_init,
    xorshift_next,
)
from .dp import first_argmax

ALGOS = ("q_learning", "expected_sarsa")
FIXED_ONE = float(1 << 32)  # the fixed-point unit of the aggregate


@dataclasses.dataclass
class FastTDResult:
    q: torch.Tensor            # (S, A) learned action values (float32)
    episodes: torch.Tensor     # () completed episodes
    mean_return: torch.Tensor  # () float32 mean episode return over the run


@dataclasses.dataclass
class FastTDTrainState:
    """Full resumable state of the fast engine: the Q-table, the per-env
    FastState, the xorshift lanes and the episode accumulators. Nothing
    else carries over between chunks, so chunked training equals one
    unbroken scan bit for bit."""

    q: torch.Tensor            # (S, A) float32
    env_state: FastState       # (B,) fields
    rs: torch.Tensor           # (B,) int32 xorshift lanes (uint32 bit patterns)
    step: int                  # global step counter
    run_ret: torch.Tensor      # (B,) float32 running episode returns
    n_eps_env: torch.Tensor    # (B,) int32 completed episodes per env
    ret_sum_env: torch.Tensor  # (B,) float32 folded return sums per env


def fast_td_init(
    sem: Semantics,
    bl: BitLevel,
    seed,
    batch_size: int | None = None,
    q0: torch.Tensor | None = None,
    lane_offset: int = 0,
) -> FastTDTrainState:
    """Initial train state on the level's device: all envs at the level
    start, xorshift lanes seeded per env id (numbered from `lane_offset`:
    a shard passes its first env's global index)."""
    dev = bl.device
    state = reset_bits(bl, None if bl.batched else batch_size)
    shape = state.agent_idx.shape
    if q0 is None:
        q = torch.zeros((bl.num_states, sem.num_actions), dtype=torch.float32, device=dev)
    else:
        q = torch.as_tensor(q0, dtype=torch.float32, device=dev).clone()
    return FastTDTrainState(
        q=q,
        env_state=state,
        rs=xorshift_init(seed, shape, lane_offset, device=dev),
        step=0,
        run_ret=torch.zeros(shape, dtype=torch.float32, device=dev),
        n_eps_env=torch.zeros(shape, dtype=torch.int32, device=dev),
        ret_sum_env=torch.zeros(shape, dtype=torch.float32, device=dev),
    )


def fast_td_result(ts: FastTDTrainState) -> FastTDResult:
    """Reduce a train state's per-env accumulators to the summary result."""
    n = ts.n_eps_env.sum()
    return FastTDResult(
        q=ts.q, episodes=n, mean_return=ts.ret_sum_env.sum() / n.clamp(min=1)
    )


def _epsilon_greedy_bits(q_rows: torch.Tensor, bits: torch.Tensor, epsilon: float):
    """ε-greedy from one random word per env (`bits`, int32 bit patterns):
    the low 16 bits are the explore coin, the top 16 bits pick the explore
    action by multiply-shift; greedy ties go to the lowest action."""
    num_actions = q_rows.shape[-1]
    u = to_uint32_values(bits)
    coin = (u & 0xFFFF) < int(epsilon * 65536.0)
    rand_a = (((u >> 16) * num_actions) >> 16).to(torch.int32)
    return torch.where(coin, rand_a, first_argmax(q_rows))


def row_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean over the last (action) axis, summed in index order and divided
    by A, so that the kernels can repeat it bit for bit. A is divided as a
    tensor: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which rounds differently where 1/A is inexact (A = 9, 25)."""
    total = rows[..., 0]
    for a in range(1, rows.shape[-1]):
        total = total + rows[..., a]
    return total / torch.full((), float(rows.shape[-1]), dtype=total.dtype, device=total.device)


def shared_q_aggregate(num_entries: int, num_actions: int, s, a, delta, alpha: float):
    """The step's fixed-point aggregate of the module docstring, (2, S·A)
    int64: row 0 the sums of round(α·δ·2^32) at each (s, a), row 1 the
    counts. Integer sums, so a sharded learner adds the ranks' aggregates
    exactly, in any order."""
    flat = s.long() * num_actions + a.long()
    inc = ((alpha * delta).double() * FIXED_ONE).round().to(torch.int64)
    agg = torch.zeros((2, num_entries), dtype=torch.int64, device=delta.device)
    agg[0].index_add_(0, flat, inc)
    agg[1].index_add_(0, flat, torch.ones_like(inc))
    return agg


def apply_aggregate(q, agg):
    """Q + sum·2^-32 / max(count, 1) for every entry, the mean in float64
    rounded once to float32."""
    mean = (agg[0].double() * (1.0 / FIXED_ONE) / agg[1].clamp(min=1).double()).float()
    return q + mean.reshape(q.shape)


def shared_q_update(q, s, a, delta, alpha: float):
    """q[s, a] += mean of α·δ over the envs at (s, a), by the order-free
    fixed-point aggregate of the module docstring."""
    num_states, num_actions = q.shape
    return apply_aggregate(q, shared_q_aggregate(num_states * num_actions, num_actions, s, a, delta, alpha))


def _check_algo(algo: str) -> None:
    if algo not in ALGOS:
        raise ValueError(f"unknown algo: {algo!r}")


def td_scan_fast_reference(
    sem: Semantics,
    bl: BitLevel,
    ts: FastTDTrainState,
    num_steps: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
) -> FastTDTrainState:
    """Plain PyTorch version of K5: a Python loop over steps with `q[s]`,
    `step_bits` and the fixed-point aggregate (the sharded form's plain
    version in a world of one: each step's aggregate applied as it is)."""
    return td_scan_fast_sharded_reference(
        sem, bl, ts, num_steps, alpha, gamma, epsilon, algo, max_episode_steps, lambda agg: agg
    )


def td_step_sharded_reference(
    sem: Semantics,
    bl: BitLevel,
    q_prev: torch.Tensor,
    agg_prev: torch.Tensor | None,
    ts: FastTDTrainState,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
):
    """Plain PyTorch version of K5's sharded form, one step: Q_t =
    `apply_aggregate(q_prev, agg_prev)` (q_prev itself at step 0, where
    `agg_prev` is None), this rank's envs acted and stepped against Q_t, and
    their aggregate. Returns (the state advanced by one step with `q` = Q_t,
    the step's (2, S·A) aggregate, not yet summed over the ranks)."""
    _check_algo(algo)
    q = q_prev if agg_prev is None else apply_aggregate(q_prev, agg_prev)
    state, rs = ts.env_state, ts.rs
    rs, bits = xorshift_next(rs)
    s = state.agent_idx
    q_rows = q[s.long()]
    a = _epsilon_greedy_bits(q_rows, bits, epsilon)
    state, (s2, r, d) = step_bits(sem, bl, state, a, True, max_episode_steps)
    v = q.max(dim=-1).values
    if algo == "expected_sarsa":
        v = (1.0 - epsilon) * v + epsilon * row_mean(q)
    q_sa = q_rows.gather(1, a.long()[:, None])[:, 0]
    delta = r + gamma * torch.where(d, 0.0, v[s2.long()]) - q_sa
    agg = shared_q_aggregate(q.numel(), q.shape[1], s, a, delta, alpha)
    run_ret = ts.run_ret + r
    ts = FastTDTrainState(
        q=q, env_state=state, rs=rs, step=ts.step + 1,
        run_ret=torch.where(d, 0.0, run_ret), n_eps_env=ts.n_eps_env + d.to(torch.int32),
        ret_sum_env=ts.ret_sum_env + torch.where(d, run_ret, 0.0),
    )
    return ts, agg


def td_scan_fast_sharded_reference(
    sem: Semantics,
    bl: BitLevel,
    ts: FastTDTrainState,
    num_steps: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
    all_reduce_sum,
) -> FastTDTrainState:
    """Plain PyTorch version of the sharded scan: `td_step_sharded_reference`
    a step, each step's aggregate through `all_reduce_sum`, and the last
    step's applied at the end."""
    _check_algo(algo)
    agg = None
    for _ in range(num_steps):
        ts, agg = td_step_sharded_reference(
            sem, bl, ts.q, agg, ts, alpha, gamma, epsilon, algo, max_episode_steps
        )
        agg = all_reduce_sum(agg)
    if agg is not None:
        ts = dataclasses.replace(ts, q=apply_aggregate(ts.q, agg))
    return ts


def td_scan_fast_sharded(
    sem: Semantics,
    bl: BitLevel,
    ts: FastTDTrainState,
    num_steps: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
    all_reduce_sum,
) -> FastTDTrainState:
    """Advance this rank's rows of a sharded shared-Q run by `num_steps`
    (the reference's `td_scan_fast(..., psum_axes=)`): each step's
    aggregate goes through `all_reduce_sum` (a function that sums a (2, S·A)
    int64 tensor over the ranks in place and returns it) before Q moves, so Q stays
    the same on every rank and equals the unsharded scan's bit for bit. On
    CUDA one launch of K5's sharded form a step and one to end the scan
    (`kernels.td_fast.td_step_sharded_cuda`); on the CPU its plain version."""
    _check_algo(algo)
    if num_steps == 0:
        return ts
    if not kernels.on_cuda(ts.q, ts.rs, ts.env_state.agent_idx, bl.code_words, sem.deltas):
        return td_scan_fast_sharded_reference(
            sem, bl, ts, num_steps, alpha, gamma, epsilon, algo, max_episode_steps, all_reduce_sum
        )
    st = ts.env_state
    state = [x.clone() for x in (st.agent_idx, st.agent_code, st.t, ts.rs, ts.run_ret,
                                 ts.n_eps_env, ts.ret_sum_env)]
    n_entries = ts.q.numel()
    qs = [ts.q, torch.empty_like(ts.q), torch.empty_like(ts.q)]
    aggs = torch.zeros((3, 2, n_entries), dtype=torch.int64, device=ts.q.device)
    kw = dict(alpha=alpha, gamma=gamma, epsilon=epsilon, expected_sarsa=ALGOS.index(algo),
              max_episode_steps=max_episode_steps)
    for t in range(num_steps):
        prev, cur, clear = td_step_slots(t)
        td_step_sharded_cuda(
            sem, bl, qs[0 if t == 0 else 1 + (t + 1) % 2], qs[1 + t % 2],
            None if prev is None else aggs[prev], aggs[cur], aggs[clear], state, **kw,
        )
        all_reduce_sum(aggs[cur])
    last = num_steps - 1
    q_out = torch.empty_like(ts.q)
    td_step_sharded_cuda(sem, bl, qs[1 + last % 2], q_out, aggs[last % 3], aggs[(last + 1) % 3],
                         None, state, act=False, **kw)
    idx, code, t_env, rs, run_ret, n_eps_env, ret_sum_env = state
    return FastTDTrainState(
        q=q_out, env_state=FastState(idx, code, t_env, torch.zeros_like(st.done)),
        rs=rs, step=ts.step + num_steps,
        run_ret=run_ret, n_eps_env=n_eps_env, ret_sum_env=ret_sum_env,
    )


def td_scan_fast(
    sem: Semantics,
    bl: BitLevel,
    ts: FastTDTrainState,
    num_steps: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
) -> FastTDTrainState:
    """Advance a FastTDTrainState by `num_steps` (K5 on CUDA). Chunk
    invariant: run(2N) equals run(N)∘run(N) bit for bit."""
    _check_algo(algo)
    if not kernels.on_cuda(ts.q, ts.rs, ts.env_state.agent_idx, bl.code_words, sem.deltas):
        return td_scan_fast_reference(
            sem, bl, ts, num_steps, alpha, gamma, epsilon, algo, max_episode_steps
        )
    q, idx, code, t, rs, run_ret, n_eps_env, ret_sum_env = td_scan_fast_cuda(
        sem, bl, ts.q, ts.env_state, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env,
        num_steps, alpha, gamma, epsilon, ALGOS.index(algo), max_episode_steps,
    )
    return FastTDTrainState(
        q=q, env_state=FastState(idx, code, t, torch.zeros_like(ts.env_state.done)),
        rs=rs, step=ts.step + num_steps,
        run_ret=run_ret, n_eps_env=n_eps_env, ret_sum_env=ret_sum_env,
    )


def compile_q_learning_fast(
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
):
    """Factory of `fn(seed, q0=None) -> FastTDResult`: the whole training
    run over fixed tables and level. algo — "q_learning" (max target) or
    "expected_sarsa" (ε-greedy expectation); both act ε-greedily."""
    _check_algo(algo)

    def fn(seed, q0=None):
        ts = fast_td_init(sem, bl, seed, batch_size, q0)
        ts = td_scan_fast(
            sem, bl, ts, num_steps, alpha, gamma, epsilon, algo, max_episode_steps
        )
        return fast_td_result(ts)

    return fn


def compile_fast_td_run(
    sem: Semantics,
    bl: BitLevel,
    chunk_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
):
    """Chunked-training factory: `run(ts) -> ts` advances training by
    `chunk_steps`. run∘run on N-step chunks is bit-equal to one 2N-step
    scan, so a checkpoint between chunks loses nothing."""
    _check_algo(algo)

    def run(ts: FastTDTrainState) -> FastTDTrainState:
        return td_scan_fast(
            sem, bl, ts, chunk_steps, alpha, gamma, epsilon, algo, max_episode_steps
        )

    return run
