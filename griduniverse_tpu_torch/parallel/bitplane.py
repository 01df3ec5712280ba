"""Sharded bit-packed rollouts and shared-Q learning — counterpart of
`griduniverse_tpu/parallel/bitplane.py`.

Each rank runs the port's fast engine on its rows of the batch:

  * `compile_rollout_random_sharded` — K1 (`ops.bitplane.random_scan_bits`)
    once a rank on its rows, then three reductions of the statistics;
  * `compile_q_learning_fast_sharded` — K5's sharded form
    (`algos.td_fast.td_scan_fast_sharded`): one launch a step, each step's
    64-bit fixed-point aggregate summed over the ranks before Q moves.

Determinism contract: every env's actions come from its GLOBAL lane —
`xorshift_init(seed, (B/n,), offset=shard·B/n)`, or the threefry stream's
lane offset — so a sharded run steps exactly the per-env trajectories of
the unsharded `compile_rollout_random` / `compile_q_learning_fast`. The
episode counts and lengths are integers and equal; Q of the shared-Q
learner is an integer function of integer sums, so it equals the
unsharded K5's bit for bit on every rank, at any world size and on any
backend; only the float return sums are added in another order (rank
order). A per-env (batched) level is cut to each rank's rows.
"""

from __future__ import annotations

from ..algos.td_fast import (
    ALGOS,
    FastTDResult,
    FastTDTrainState,
    fast_td_init,
    td_scan_fast_sharded,
)
from ..core.semantics import Semantics
from ..ops.bitplane import (
    BitLevel,
    _check_rng_name,
    random_scan_bits,
    reset_bits,
    threefry_keys,
    xorshift_init,
)
from .mesh import EnvMesh, all_reduce_sum, local_batch, shard_index, shard_rows


def local_bitlevel(mesh: EnvMesh, bl: BitLevel, batch_size: int) -> BitLevel:
    """The packed level a rank steps: a shared level whole, a batched one
    its rows."""
    if not bl.batched:
        return bl
    if int(bl.code_words.shape[0]) != batch_size:
        raise ValueError(
            f"batched BitLevel has {int(bl.code_words.shape[0])} levels; "
            f"expected batch_size={batch_size}"
        )
    rows = shard_rows(mesh, batch_size)
    return BitLevel(bl.code_words[rows], bl.start_idx[rows], bl.start_code[rows], bl.height, bl.width)


def compile_rollout_random_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    unroll: int = 16,
    rng: str = "xorshift",
):
    """Factory of `fn(seed) -> (this rank's final FastState, stats)`: a K1
    scan of this rank's rows on their global lanes, then the statistics
    reduced over the ranks (episodes and the length sum exactly, the return
    sum in rank order), the same on every rank. `unroll` is a TPU
    scheduling knob, accepted and ignored."""
    del unroll
    _check_rng_name(rng)
    local = local_batch(mesh, batch_size)
    offset = shard_index(mesh) * local
    bl_local = local_bitlevel(mesh, bl, batch_size)

    def fn(seed):
        state = reset_bits(bl_local, None if bl_local.batched else local)
        if rng == "threefry":
            rs, keys = None, threefry_keys(seed, 0, offset)
        else:
            rs, keys = xorshift_init(seed, (local,), offset, device=bl_local.device), None
        state, n_eps, ret_sum, len_sum = random_scan_bits(
            sem, bl_local, state, rs, keys, num_steps, max_episode_steps, rng
        )
        n = all_reduce_sum(mesh, n_eps.sum())
        denom = n.clamp(min=1)
        return state, {
            "episodes": n,
            "mean_return": all_reduce_sum(mesh, ret_sum.sum()) / denom,
            "mean_length": all_reduce_sum(mesh, len_sum.sum()) / denom,
        }

    return fn


def fast_td_init_sharded(
    mesh: EnvMesh, sem: Semantics, bl: BitLevel, seed, batch_size: int, q0=None
) -> FastTDTrainState:
    """This rank's rows of `algos.td_fast.fast_td_init(sem, bl, seed,
    batch_size, q0)`: its envs at their starts on their global lanes, and
    the whole table."""
    local = local_batch(mesh, batch_size)
    bl_local = local_bitlevel(mesh, bl, batch_size)
    return fast_td_init(sem, bl_local, seed, local, q0, lane_offset=shard_index(mesh) * local)


def fast_td_result_sharded(mesh: EnvMesh, ts: FastTDTrainState) -> FastTDResult:
    """A sharded train state's summary, the same on every rank."""
    n = all_reduce_sum(mesh, ts.n_eps_env.sum())
    return FastTDResult(
        q=ts.q, episodes=n, mean_return=all_reduce_sum(mesh, ts.ret_sum_env.sum()) / n.clamp(min=1)
    )


def compile_q_learning_fast_sharded(
    mesh: EnvMesh,
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
    """Factory of `fn(seed, q0=None) -> FastTDResult`: the shared-Q learner
    with envs sharded over the mesh and Q replicated (the reference's
    "sharded tabular learner via all-reduce" on the fast engine). Q equals
    the unsharded `compile_q_learning_fast` run's bit for bit on every rank."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo: {algo!r}")
    local_batch(mesh, batch_size)
    bl_local = local_bitlevel(mesh, bl, batch_size)

    def reduce(agg):
        return all_reduce_sum(mesh, agg)

    def fn(seed, q0=None):
        ts = fast_td_init_sharded(mesh, sem, bl, seed, batch_size, q0)
        ts = td_scan_fast_sharded(
            sem, bl_local, ts, num_steps, alpha, gamma, epsilon, algo, max_episode_steps, reduce
        )
        return fast_td_result_sharded(mesh, ts)

    return fn
