"""Distributed tabular learners — counterpart of
`griduniverse_tpu/parallel/learner.py`: `DistTDResult`,
`q_learning_sharded`, `td_lambda_sharded`, `mc_control_sharded`,
`mc_prediction_sharded`, `td_lambda_prediction_sharded` and
`q_learning_batched_sharded`. Each family's step is the unsharded
learner's own transition function (`algos.td.td_transition`,
`algos.td_lambda.td_lambda_transition` and
`td_lambda_prediction_transition`, `algos.mc.mc_round`), as the
reference's sharded learners share `transition` (`:161`).

`q_learning_sharded`: envs sharded over the mesh, the Q-table replicated on
every rank, each step's updates combined over the ranks so that every rank
applies the same update. The step is `algos.td.td_run`'s (the generic
step, ε-greedy, the TD errors), and each rank draws from its lanes of the
GLOBAL xorshift stream (`td_init`'s `xorshift_init` with the rank's lane
offset), so in both modes each env acts on the draws of the unsharded run:

  * `parity=True` — the (s, a, δ) of every env are all-gathered in rank
    (= env) order and K10 (`csrc/segment_mean.cu`) runs once over all B of
    them on every rank: Q equals the unsharded `td_run`'s bit for bit.
  * `parity=False` (the scalable mode) — each rank takes the env-order
    float sums and counts of its own envs (K10's sums form), the counts are
    all-reduced exactly and the sums added in rank order, and every rank
    applies the mean. In a world of one this is K10 bit for bit; above, the
    sums are associated by rank, within float rounding of the unsharded run.
  * `psum_every=k` (scalable mode) — k steps against the Q frozen at the
    window's start, the sums and counts accumulated locally, then one
    reduction and one pooled mean update a window: 1/k the collectives, with
    the reference's staleness semantics (`parallel/learner.py:80-113`).

`q_learning_batched_sharded`: one table per maze, mazes sharded; each rank
runs K6 (`algos.td_batched.q_learning_batched`) on its mazes with its lane
offset, tables and experience never cross ranks, and only the statistics
are reduced. The (N, S, A) tables are gathered in rank order.

`td_lambda_sharded` and `td_lambda_prediction_sharded`: each env's trace
stays with its shard, the table is replicated. A step is K12's
partial-sums form (`kernels.trace_pass.TracePartialsPlan`; plain versions
`algos.td_lambda.trace_partials_reference` and `apply_partials_reference`
on the CPU): the rank's pass writes each chunk of 256 envs' Σ δ·e a cell
and the live counts, the chunks are all-gathered in rank order and the
counts all-reduced exactly, and every rank adds the chunks in order from
0.0 and applies `table + α·num / max(count, 1)`. Where B/n is a multiple of
256 the gathered chunks are the unsharded run's, and the table equals
`sarsa_lambda` / `watkins_q_lambda` / `td_lambda_prediction` bit for bit;
elsewhere the chunks fall differently (agreement to float rounding).
`td_lambda_prediction_sharded(parity=True)` where B/n is not a multiple of
256 gathers the traces, states, δ and cuts and runs the unsharded K12 step
over all B envs on every rank, keeping its own rows: bit for bit at any B.

`mc_control_sharded` and `mc_prediction_sharded`: each rank rolls its
episodes and runs K13 on them (returns and first-visit masks are per
episode). Scalable mode: K10's sums form over the rank's (t, b) samples,
the sums added in rank order and the counts all-reduced, then
`apply_segment_sums`. `parity=True`: the (T, B/n) samples all-gathered
along B and K10 run once over the (T, B) samples in (t, b) order on every
rank: the unsharded `mc_control` / `mc_prediction` bit for bit.

Draws: `draws=` injects the reference's global (T, B) per-step draws (and
the initial action's), of which each rank takes its columns. Natively each
rank draws from its lanes of the global xorshift stream (lane = global env
index), so in every mode each env draws the unsharded run's stream (the
reference's scalable mode folds the shard index into its keys instead: a
chosen divergence, ROADMAP "Chosen divergences").
"""

from __future__ import annotations

import dataclasses

import torch

from ..algos.td import (
    ALGOS,
    _fold_stats,
    _next_draw,
    apply_segment_sums,
    apply_td_updates,
    epsilon_greedy,
    segment_sums,
    td_transition,
)
from .. import kernels
from ..algos.mc import MCControlResult, MCResult, _segment_mean, mc_round
from ..algos.td_batched import BatchedTDResult, q_learning_batched
from ..algos.td_lambda import (
    TDLambdaPredictionResult,
    apply_partials_reference,
    check_trace,
    policy_tables,
    td_lambda_prediction_transition,
    td_lambda_transition,
    trace_partials_reference,
    trace_pass,
)
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.trace_pass import CHUNK, TracePartialsPlan, TracePassPlan
from ..ops.bitplane import xorshift_init
from .mesh import (
    EnvMesh,
    all_gather_columns,
    all_gather_rows,
    all_gather_rows_into,
    all_reduce_sum,
    local_batch,
    shard_index,
    shard_rows,
)
from .rollout import local_level, reset_batch_sharded


@dataclasses.dataclass
class DistTDResult:
    q: torch.Tensor            # (S, A) the replicated table
    episodes: torch.Tensor     # () completed episodes over every rank
    mean_return: torch.Tensor  # () float32 mean episode return


def _check_q_learning_sharded(algo, parity, psum_every, num_steps):
    """The reference's validation (`parallel/learner.py:100-121`)."""
    if algo not in ALGOS:
        raise ValueError(algo)
    if psum_every < 1:
        raise ValueError(f"psum_every must be >= 1, got {psum_every}")
    if psum_every > 1 and parity:
        raise ValueError(
            "parity mode is defined as the bit-exact per-step rule; "
            "psum_every > 1 changes update semantics (see docstring) — "
            "use parity=False"
        )
    if num_steps % psum_every:
        raise ValueError(
            f"num_steps ({num_steps}) must be divisible by psum_every ({psum_every})"
        )


def _local_draws(draws, num_steps, batch_size, rows):
    """This rank's columns of injected (explore (T, B), rand_a (T, B),
    explore0 (B,), rand_a0 (B,)), or None."""
    if draws is None:
        return None
    shapes = ((num_steps, batch_size),) * 2 + ((batch_size,),) * 2
    for name, x, shape in zip(("explore", "rand_a", "explore0", "rand_a0"), draws, shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"draws: {name} has shape {tuple(x.shape)}, expected {shape}")
    explore, rand_a, explore0, rand_a0 = draws
    return explore[:, rows], rand_a[:, rows], explore0[rows], rand_a0[rows]


def q_learning_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    level: Level,
    key,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    parity: bool = False,
    psum_every: int = 1,
    draws=None,
) -> DistTDResult:
    """Distributed synchronous batched TD control (module docstring). `key`
    is the integer seed of the global xorshift lanes; `draws` injects the
    global (explore, rand_a, explore0, rand_a0). Returns the replicated Q
    and the statistics, the same on every rank."""
    _check_q_learning_sharded(algo, parity, psum_every, num_steps)
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = local_level(mesh, level, batch_size)
    draws = _local_draws(draws, num_steps, batch_size, rows)
    dev = mesh.device
    num_states, num_actions = lvl.num_states, sem.num_actions

    q = torch.zeros((num_states, num_actions), dtype=torch.float32, device=dev)
    state = reset_batch_sharded(mesh, level, batch_size)
    rs = xorshift_init(key, (local,), shard_index(mesh) * local, device=dev)
    draw, rs = _next_draw(rs, None if draws is None else (draws[2], draws[3]))
    a = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
    run_ret = torch.zeros(local, dtype=torch.float32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
    acc_sums = acc_counts = None

    for i in range(num_steps):
        state, a_next, rs, s, r, d, delta = td_transition(
            sem, lvl, q, state, a, rs, None if draws is None else (draws[0][i], draws[1][i]), algo, gamma,
            epsilon)
        if parity:
            # one gather a step: (s, a, the bits of δ) of every env, in env order
            pairs = all_gather_rows(mesh, torch.stack([s, a, delta.view(torch.int32)], dim=1))
            q = apply_td_updates(
                q, pairs[:, 0].contiguous(), pairs[:, 1].contiguous(),
                pairs[:, 2].contiguous().view(torch.float32), alpha,
            )
        else:
            sums, counts = segment_sums(s, a, delta, alpha, num_states, num_actions)
            counts = counts.to(torch.int64)
            if acc_sums is None:
                acc_sums, acc_counts = sums, counts
            else:
                acc_sums, acc_counts = acc_sums + sums, acc_counts + counts
            if (i + 1) % psum_every == 0:
                q = apply_segment_sums(
                    q, all_reduce_sum(mesh, acc_sums), all_reduce_sum(mesh, acc_counts)
                )
                acc_sums = acc_counts = None
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)
        a = a_next

    n_eps = all_reduce_sum(mesh, n_eps)
    return DistTDResult(
        q=q, episodes=n_eps, mean_return=all_reduce_sum(mesh, ret_sum) / n_eps.clamp(min=1)
    )


class _ShardedTraceStep:
    """A step of a sharded TD(λ) learner's traces, built once a run: K12's
    partial-sums form on the card (`TracePartialsPlan`), its plain versions
    on the CPU, around the gather of the chunks' partial sums in rank order
    and the exact all-reduce of the live counts."""

    def __init__(self, mesh: EnvMesh, table, batch_local: int, with_actions: bool):
        self.mesh = mesh
        self.plan = None
        if kernels.on_cuda(table):
            self.plan = TracePartialsPlan(table, batch_local, with_actions, mesh.size,
                                          own_rows=mesh.group is None)

    def __call__(self, table, e, s, a, delta, cut, gamma, lam, cutoff, alpha, kind):
        mesh, plan = self.mesh, self.plan
        if plan is None:
            partial, count = trace_partials_reference(e, s, a, delta, cut, gamma, lam, cutoff, kind)
            return apply_partials_reference(
                table, all_gather_rows(mesh, partial), all_reduce_sum(mesh, count), alpha)
        local, count = plan.partials(
            e, s.to(torch.int32), None if a is None else a.to(torch.int32), delta.to(torch.float32),
            cut.to(torch.bool), gamma * lam, cutoff, kind == "replacing")
        if mesh.group is not None:
            all_gather_rows_into(mesh, local, plan.gathered[: plan.total_chunks])
            all_reduce_sum(mesh, count)  # in place: an integer sum
        return plan.apply(table, alpha)


def td_lambda_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    level: Level,
    key,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    lam: float = 0.9,
    algo: str = "sarsa",
    trace: str = "accumulating",
    trace_cutoff: float = 1e-4,
    draws=None,
) -> DistTDResult:
    """Distributed TD(λ) control (SARSA(λ) / Watkins Q(λ)): each env's (S, A)
    trace lives with its shard, Q is replicated, and a step's Σ δ·e and
    live counts are combined over the ranks by K12's partial-sums form
    (module docstring). `key` seeds the global xorshift lanes; `draws`
    injects the global (explore, rand_a, explore0, rand_a0). Returns Q and
    the statistics, the same on every rank."""
    if algo not in ("sarsa", "watkins"):
        raise ValueError(algo)
    check_trace(trace)
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = local_level(mesh, level, batch_size)
    draws = _local_draws(draws, num_steps, batch_size, rows)
    dev = mesh.device
    num_states, num_actions = lvl.num_states, sem.num_actions

    q = torch.zeros((num_states, num_actions), dtype=torch.float32, device=dev)
    state = reset_batch_sharded(mesh, level, batch_size)
    rs = xorshift_init(key, (local,), shard_index(mesh) * local, device=dev)
    draw, rs = _next_draw(rs, None if draws is None else (draws[2], draws[3]))
    a = epsilon_greedy(q[state.agent_idx.long()], draw, epsilon)
    e = torch.zeros((local, num_states, num_actions), dtype=torch.float32, device=dev)
    step = _ShardedTraceStep(mesh, q, local, True)
    run_ret = torch.zeros(local, dtype=torch.float32, device=dev)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(num_steps):
        state, a_next, rs, s, r, d, delta, cut = td_lambda_transition(
            sem, lvl, q, state, a, rs, None if draws is None else (draws[0][i], draws[1][i]), algo, gamma,
            epsilon)
        q = step(q, e, s, a, delta, cut, gamma, lam, trace_cutoff, alpha, trace)
        run_ret, n_eps, ret_sum = _fold_stats(run_ret, n_eps, ret_sum, r, d)
        a = a_next

    n_eps = all_reduce_sum(mesh, n_eps)
    return DistTDResult(
        q=q, episodes=n_eps, mean_return=all_reduce_sum(mesh, ret_sum) / n_eps.clamp(min=1)
    )


def td_lambda_prediction_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    level: Level,
    policy: torch.Tensor,
    key,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    lam: float = 0.9,
    trace: str = "accumulating",
    trace_cutoff: float = 1e-4,
    parity: bool = False,
    draws=None,
) -> TDLambdaPredictionResult:
    """Distributed TD(λ) policy evaluation: V^π for a fixed (S, A) policy
    with per-env (B/n, S) traces sharded with their envs and V replicated,
    each step's Σ δ·e and live counts combined by K12's partial-sums form.
    `parity=True`: equal to the unsharded `td_lambda_prediction` bit for bit
    at any B divisible by n (module docstring). `draws` injects the global
    (T, B) actions or (T, B, A) Gumbel noise. Returns V and the episodes,
    the same on every rank."""
    check_trace(trace)
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = local_level(mesh, level, batch_size)
    if draws is not None:
        if tuple(draws.shape[:2]) != (num_steps, batch_size):
            raise ValueError(f"draws has shape {tuple(draws.shape)}, expected ({num_steps}, {batch_size}, ...)")
        draws = draws[:, rows].to(mesh.device)
    dev = mesh.device
    num_states = lvl.num_states

    v = torch.zeros((num_states,), dtype=torch.float32, device=dev)
    state = reset_batch_sharded(mesh, level, batch_size)
    rs = xorshift_init(key, (local,), shard_index(mesh) * local, device=dev)
    e = torch.zeros((local, num_states), dtype=torch.float32, device=dev)
    whole = parity and local % CHUNK != 0 and mesh.group is not None
    if whole:  # the unsharded K12 step over every rank's envs
        plan = TracePassPlan(v, batch_size, False) if kernels.on_cuda(v) else None
    else:
        step = _ShardedTraceStep(mesh, v, local, False)
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    cdf, logp = policy_tables(policy.to(dev))
    for i in range(num_steps):
        state, rs, s, r, d, delta = td_lambda_prediction_transition(
            sem, lvl, v, state, rs, None if draws is None else draws[i], cdf, logp, gamma)
        if whole:
            e_all = all_gather_rows(mesh, e)
            v = trace_pass(v, e_all, all_gather_rows(mesh, s), None, all_gather_rows(mesh, delta),
                           all_gather_rows(mesh, d), gamma, lam, trace_cutoff, alpha, trace, plan=plan)
            e.copy_(e_all[rows])
        else:
            v = step(v, e, s, None, delta, d, gamma, lam, trace_cutoff, alpha, trace)
        n_eps = n_eps + d.sum()
    return TDLambdaPredictionResult(v=v, episodes=all_reduce_sum(mesh, n_eps))


def _check_shared_level(level: Level, name: str, detail: str) -> None:
    if level.grid.dim() != 2:
        raise ValueError(
            f"{name} requires a single shared (H, W) level; got grid shape {tuple(level.grid.shape)}{detail}"
        )


def _mc_local_draws(draws, rows):
    """This rank's columns of one round's injected draws: (T, B) actions, or
    the pair (explore (T, B), rand_a (T, B))."""
    if draws is None:
        return None
    if isinstance(draws, (tuple, list)):
        return tuple(x[:, rows] for x in draws)
    return draws[:, rows]


def _gathered_samples(mesh: EnvMesh, s, a, inc, mask):
    """The (T, B/n) samples of every rank gathered along B in rank order
    (one gather: the increment's bits and the mask beside the cells and
    actions)."""
    packed = torch.stack([s.to(torch.int32), a.to(torch.int32), inc.view(torch.int32), mask.to(torch.int32)],
                         dim=-1)
    whole = all_gather_columns(mesh, packed)
    return (whole[..., 0], whole[..., 1], whole[..., 2].contiguous().view(torch.float32),
            whole[..., 3].to(torch.bool))


def mc_control_sharded(
    mesh: EnvMesh,
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
    parity: bool = False,
    draws=None,
) -> MCControlResult:
    """Distributed ε-greedy MC control: episodes sharded over the ranks, Q
    replicated, each round's (first-visit) return increments combined over
    the ranks (module docstring). Round r's lanes are seeded by `key + r`,
    each rank's numbered from its first episode; `draws` injects one global
    (explore (T, B), rand_a (T, B)) pair a round. Returns Q (the same on
    every rank) and the episodes sampled."""
    _check_shared_level(
        level, "mc_control_sharded",
        ". Batched (N, H, W) per-env levels are not supported on this path (the episode roll and Q-table are "
        "defined over one shared geometry).")
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = level.to(mesh.device)
    num_states, num_actions = lvl.num_states, sem.num_actions
    q = torch.zeros((num_states, num_actions), dtype=torch.float32, device=mesh.device)
    for rnd in range(num_rounds):
        s, a, inc, mask = mc_round(
            sem, lvl, q, q, int(key) + rnd, local, max_steps, epsilon, gamma, first_visit, include_unfinished,
            None if draws is None else _mc_local_draws(draws[rnd], rows), rows.start)
        if parity:
            s, a, inc, mask = _gathered_samples(mesh, s, a, inc, mask)
            q = _segment_mean(q, s, a, inc, alpha, mask)
        else:
            sums, counts = segment_sums(s.reshape(-1), a.reshape(-1), inc.reshape(-1), alpha, num_states,
                                        num_actions, mask.reshape(-1))
            q = apply_segment_sums(q, all_reduce_sum(mesh, sums), all_reduce_sum(mesh, counts.to(torch.int64)))
    return MCControlResult(
        q=q, episodes=torch.tensor(num_rounds * batch_size, dtype=torch.int64, device=mesh.device))


def mc_prediction_sharded(
    mesh: EnvMesh,
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
    parity: bool = False,
    draws=None,
) -> MCResult:
    """Distributed first-visit MC state-value prediction, the prediction
    twin of `mc_control_sharded`: V computed identically on every rank from
    the global per-state return sums and counts (module docstring). `draws`
    injects the global (T, B) actions of the random policy, or the pair
    (explore, rand_a) of the ε-greedy one. Returns V and the counts, the
    same on every rank."""
    _check_shared_level(level, "mc_prediction_sharded", "")
    local = local_batch(mesh, batch_size)
    rows = shard_rows(mesh, batch_size)
    lvl = level.to(mesh.device)
    num_states = lvl.num_states
    s, zero, g, mask = mc_round(
        sem, lvl, None, None if policy_q is None else policy_q.to(mesh.device), key, local, max_steps, epsilon,
        gamma, first_visit, include_unfinished, _mc_local_draws(draws, rows), rows.start)
    zeros = torch.zeros((num_states, 1), dtype=torch.float32, device=mesh.device)
    if parity:
        s, zero, g, mask = _gathered_samples(mesh, s, zero, g, mask)
        # with a zero table and α = 1 the segment mean IS the mean return
        v = _segment_mean(zeros, s, zero, g, 1.0, mask)[:, 0]
        n = torch.bincount(s[mask].long(), minlength=num_states).to(torch.float32)
        return MCResult(value=v, counts=n)
    sums, counts = segment_sums(s.reshape(-1), zero.reshape(-1), g.reshape(-1), 1.0, num_states, 1,
                                mask.reshape(-1))
    counts = all_reduce_sum(mesh, counts.to(torch.int64))
    v = apply_segment_sums(zeros, all_reduce_sum(mesh, sums), counts)[:, 0]
    return MCResult(value=v, counts=counts.to(torch.float32))


def q_learning_batched_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    levels: Level,
    key,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    parity: bool = False,
    dtype: str = "float32",
    draws=None,
) -> BatchedTDResult:
    """Per-maze TD control with the mazes sharded over the mesh: K6 on each
    rank's mazes, their lanes numbered from the rank's first maze, so each
    maze draws its stream of the unsharded run whether or not `parity` is
    set (kept for the reference's signature). `draws` injects the global
    (explore (T, N), rand_a (T, N), explore0 (N,), rand_a0 (N,)). Returns
    the (N, S, A) tables gathered in rank order and the pooled statistics,
    the same on every rank; `.state` is this rank's resume carry."""
    del parity
    if levels.grid.dim() != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got {tuple(levels.grid.shape)}"
        )
    if algo not in ALGOS:
        raise ValueError(algo)
    n = int(levels.grid.shape[0])
    if n % mesh.size:
        raise ValueError(f"maze count {n} not divisible by mesh size {mesh.size}")
    rows = shard_rows(mesh, n)
    res = q_learning_batched(
        sem, local_level(mesh, levels, n), key, num_steps, alpha, gamma, epsilon, algo,
        max_episode_steps, dtype=dtype, draws=_local_draws(draws, num_steps, n, rows),
        lane_offset=rows.start,
    )
    episodes = all_reduce_sum(mesh, res.state.n_eps_env.sum())
    ret_sum = all_reduce_sum(mesh, res.state.ret_sum_env.sum())
    return BatchedTDResult(
        q=all_gather_rows(mesh, res.q), episodes=episodes,
        mean_return=ret_sum / episodes.clamp(min=1), state=res.state,
    )
