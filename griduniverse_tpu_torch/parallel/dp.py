"""Sharded dynamic programming — counterpart of `griduniverse_tpu/parallel/dp.py`.

Two ways to shard a solve:

  * on the STATE axis (`value_iteration_sharded`, `policy_iteration_sharded`):
    one model table, each rank holding its rows of the states (padded to a
    multiple of the mesh with terminal self-loops of reward 0, which never
    move); each sweep all-gathers V, backs up the local rows, and reduces
    max |ΔV| over the ranks for the global stop. Plain torch, as
    `algos/dp.py`.
  * on the MAZE axis (the batched forms): N mazes, each rank solving its
    rows. The batched-table forms are plain torch (`algos/dp_batched.py`);
    the grid forms run K4 on each rank's mazes (`csrc/dp_grid.cu`, one
    call a rank). The host's stop rule (`algos.dp_batched._sweep_until_cuda`)
    reads each K4 launch's per-sweep maxima; sharded, that (k,) vector goes
    through an all-reduce MAX before the host picks the first sweep under
    theta, so every rank stops at the same sweep and reruns the same
    partial launch. PI's "changed" flag is made global the same way.

Every sweep is the unsharded solver's on the rank's rows, and maxima are
exact, so V, the policy and the iterations equal the unsharded solver's
bit for bit at any world size. Results are returned whole (gathered in
rank order) on every rank.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..algos.dp import action_values, first_argmax, sweep_until
from ..algos.dp_batched import (
    _check_batched,
    _grid_backup,
    _howard,
    _pick,
    _sweep_until_cuda,
    _zeros,
    action_values_batched,
)
from ..core.model import ModelTable
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.dp_grid import grid_greedy_cuda
from .mesh import EnvMesh, all_gather_rows, all_reduce_max, shard_rows


def _pad_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """`x` with its leading axis padded to `n` with `fill`."""
    pad = n - int(x.shape[0])
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def _state_rows(mesh: EnvMesh, model: ModelTable) -> ModelTable:
    """This rank's rows of the model's states, padded to a multiple of the
    mesh with terminal self-loops of reward 0."""
    s = model.num_states
    s_pad = -(-s // mesh.size) * mesh.size
    rows = shard_rows(mesh, s_pad)
    return ModelTable(
        next_state=_pad_to(model.next_state, s_pad)[rows].to(mesh.device),
        reward=_pad_to(model.reward, s_pad)[rows].to(mesh.device),
        done=_pad_to(model.done, s_pad, True)[rows].to(mesh.device),
        terminal=_pad_to(model.terminal, s_pad, True)[rows].to(mesh.device),
    )


def _maze_rows(mesh: EnvMesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"maze count {n} not divisible by mesh size {mesh.size}")
    return shard_rows(mesh, n)


def _global_max(mesh: EnvMesh):
    return lambda x: all_reduce_max(mesh, x)


def _stable(mesh: EnvMesh, new_policy: torch.Tensor, policy: torch.Tensor) -> bool:
    """True once no rank's policy changed."""
    changed = (new_policy != policy).any().to(torch.int32).reshape(1)
    return not bool(all_reduce_max(mesh, changed))


def value_iteration_sharded(
    mesh: EnvMesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """VI with the states sharded over the mesh. Returns (V (S,), greedy
    policy (S,), iters), bit for bit `algos.dp.value_iteration`'s."""
    s = model.num_states
    local = _state_rows(mesh, model)

    def q_of(v_local):
        return action_values(local, all_gather_rows(mesh, v_local), gamma)

    v0 = torch.zeros(local.num_states, dtype=torch.float32, device=mesh.device)
    v, iters = sweep_until(
        lambda v: q_of(v).max(dim=1).values, v0, theta, max_iters, _global_max(mesh)
    )
    policy = first_argmax(q_of(v))
    return all_gather_rows(mesh, v)[:s], all_gather_rows(mesh, policy)[:s], iters


def policy_iteration_sharded(
    mesh: EnvMesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Howard PI with the states sharded over the mesh: each evaluation
    sweep all-gathers V and backs up the local rows under the local policy,
    improvement is a local argmax, and the stop waits for every rank's
    policy to be stable. Returns (V (S,), policy (S,), policy iterations),
    bit for bit `algos.dp.policy_iteration`'s."""
    s = model.num_states
    local = _state_rows(mesh, model)

    def q_of(v_local):
        return action_values(local, all_gather_rows(mesh, v_local), gamma)

    v0 = torch.zeros(local.num_states, dtype=torch.float32, device=mesh.device)

    def evaluate(policy):
        pick = policy.long()[:, None]
        return sweep_until(
            lambda v: q_of(v).gather(1, pick)[:, 0], v0, theta, max_eval_iters, _global_max(mesh)
        )[0]

    policy, v, iters, stable = torch.zeros_like(v0, dtype=torch.int32), v0, 0, False
    while not stable and iters < max_policy_iters:
        v = evaluate(policy)
        new_policy = first_argmax(q_of(v))
        stable = _stable(mesh, new_policy, policy)
        policy, iters = new_policy, iters + 1
    return all_gather_rows(mesh, v)[:s], all_gather_rows(mesh, policy)[:s], iters


def _maze_model(mesh: EnvMesh, model: ModelTable) -> ModelTable:
    rows = _maze_rows(mesh, int(model.terminal.shape[0]))
    return ModelTable(*(x[rows].to(mesh.device) for x in
                        (model.next_state, model.reward, model.done, model.terminal)))


def value_iteration_batched_sharded(
    mesh: EnvMesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """VI over N mazes (batched tables of `algos.dp_batched.build_model_tables`)
    sharded on the maze axis; every rank runs as many sweeps as the slowest
    maze needs (further sweeps of a converged maze are fixed points).
    Returns (V (N, S), policy (N, S), iters), bit for bit
    `value_iteration_batched`'s. `lookup` is accepted and ignored."""
    del lookup
    local = _maze_model(mesh, model)
    v, iters = sweep_until(
        lambda v: action_values_batched(local, v, gamma).max(dim=-1).values,
        _zeros(local.terminal, torch.float32), theta, max_iters, _global_max(mesh),
    )
    policy = first_argmax(action_values_batched(local, v, gamma))
    return all_gather_rows(mesh, v), all_gather_rows(mesh, policy), iters


def policy_iteration_batched_sharded(
    mesh: EnvMesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    lookup: str = "auto",
):
    """Howard PI over N mazes sharded on the maze axis: evaluation sweeps
    in lockstep on the global max |ΔV|, and the stop once every rank's
    policies are stable. Returns (V (N, S), policy (N, S), iters), bit for
    bit `policy_iteration_batched`'s. `lookup` is accepted and ignored."""
    del lookup
    local = _maze_model(mesh, model)
    v0 = _zeros(local.terminal, torch.float32)

    def evaluate(policy):
        return sweep_until(
            lambda v: _pick(action_values_batched(local, v, gamma), policy),
            v0, theta, max_eval_iters, _global_max(mesh),
        )[0]

    def improve(v, policy):
        new_policy = first_argmax(action_values_batched(local, v, gamma))
        return new_policy, _stable(mesh, new_policy, policy)

    v, policy, iters = _howard(
        evaluate, improve, _zeros(local.terminal, torch.int32), v0, max_policy_iters
    )
    return all_gather_rows(mesh, v), all_gather_rows(mesh, policy), iters


def _maze_grids(mesh: EnvMesh, levels: Level, what: str) -> torch.Tensor:
    _check_batched(levels, what)
    rows = _maze_rows(mesh, int(levels.grid.shape[0]))
    return levels.grid[rows].to(mesh.device).contiguous()


def value_iteration_batched_grid_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """VI straight from the batched (N, H, W) grid, sharded on the maze
    axis: K4 on each rank's mazes on CUDA (the plain grid backup on the
    CPU), the stop on the maxima of every rank. Returns (V (N, S), policy
    (N, S), iters), bit for bit `algos.value_iteration_batched_grid`'s."""
    grids = _maze_grids(mesh, levels, "value_iteration_batched_grid_sharded")
    if kernels.on_cuda(grids, sem.deltas):
        v, iters = _sweep_until_cuda(sem, grids, None, gamma, theta, max_iters, _global_max(mesh))
        policy, _ = grid_greedy_cuda(sem, grids, v, gamma, None)
    else:
        backup = _grid_backup(sem, grids, gamma)
        v, iters = sweep_until(
            lambda v: backup(v).max(dim=-1).values, _zeros(grids, torch.float32),
            theta, max_iters, _global_max(mesh),
        )
        policy = first_argmax(backup(v))
    return all_gather_rows(mesh, v), all_gather_rows(mesh, policy), iters


def policy_iteration_batched_grid_sharded(
    mesh: EnvMesh,
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Howard PI straight from the batched grid, sharded on the maze axis
    (K4 on CUDA): evaluation sweeps stop on the maxima of every rank, and
    the outer loop once no rank's policy changed (K4's `changed` flag
    reduced by MAX). Returns (V (N, S), policy (N, S), iters), bit for bit
    `algos.policy_iteration_batched_grid`'s."""
    grids = _maze_grids(mesh, levels, "policy_iteration_batched_grid_sharded")
    v0 = _zeros(grids, torch.float32)
    if kernels.on_cuda(grids, sem.deltas):
        def evaluate(policy):
            return _sweep_until_cuda(sem, grids, policy, gamma, theta, max_eval_iters, _global_max(mesh))[0]

        def improve(v, policy):
            new_policy, changed = grid_greedy_cuda(sem, grids, v, gamma, policy)
            return new_policy, not bool(all_reduce_max(mesh, changed))
    else:
        backup = _grid_backup(sem, grids, gamma)

        def evaluate(policy):
            return sweep_until(
                lambda v: _pick(backup(v), policy), v0, theta, max_eval_iters, _global_max(mesh)
            )[0]

        def improve(v, policy):
            new_policy = first_argmax(backup(v))
            return new_policy, _stable(mesh, new_policy, policy)

    v, policy, iters = _howard(evaluate, improve, _zeros(grids, torch.int32), v0, max_policy_iters)
    return all_gather_rows(mesh, v), all_gather_rows(mesh, policy), iters
