"""Batched DP solvers — value/policy iteration over N mazes at once.

PyTorch counterpart of `griduniverse_tpu/algos/dp_batched.py`.

  * Table form (`build_model_tables`, `action_values_batched`,
    `value_iteration_batched`, `policy_evaluation_batched`,
    `policy_iteration_batched`): the model tables gain a leading maze axis
    and a sweep is one `torch.gather` over (N, S·A). Plain torch, for
    models that are not built from a grid.
  * Grid form (`value_iteration_batched_grid`,
    `policy_iteration_batched_grid`): solves straight from the (N, H, W)
    tile codes. On CUDA this is kernel K4 (`csrc/dp_grid.cu`): up to
    16,384 cells a maze, V in shared memory and up to 16 Jacobi sweeps a
    launch, several small mazes a block or several cells a thread
    (`kernels.dp_grid.packing`); above that, one thread per cell from
    global memory, one launch per sweep. On the CPU it is the plain version beside
    it (`*_reference`).

All solvers stop on the GLOBAL max |ΔV| over every maze and return V after
exactly that many sweeps for every maze, as the reference does. K4 records
the global max of each sweep of a launch; where convergence falls inside a
launch, the wrapper reruns the shorter count from the launch's input V, so
V, policy and `iters` equal the plain version's bit for bit.

The reference's defenses against its TPU toolchain (re-solving a sample,
batch padding) and its select-tree lookup are not carried over; `validate`
and `lookup` are accepted and ignored so that callers port unchanged.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.model import ModelTable
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.dp_grid import grid_greedy_cuda, grid_sweeps_cuda
from .dp import below, first_argmax, sweep_until

# Sweeps per K4 launch. The host reads the launch's per-sweep maxima once,
# so a larger count means fewer round trips and a longer rerun (at most
# this many sweeps) when convergence falls inside a launch.
SWEEPS_PER_LAUNCH = 16


def _check_batched(levels: Level, what: str) -> None:
    if levels.grid.dim() != 3:
        raise ValueError(
            f"{what} expects a batched (N, H, W) level grid; got shape "
            f"{tuple(levels.grid.shape)}"
        )


def _grid_geometry(sem: Semantics, h: int, w: int):
    """Candidate successor of every (state, action) and whether it is in
    bounds — the same for every maze: (cand_idx (S, A) int64, in_bounds)."""
    dev = sem.device
    states = torch.arange(h * w, device=dev)
    row, col = states // w, states % w
    nrow = row[:, None] + sem.deltas[None, :, 0]
    ncol = col[:, None] + sem.deltas[None, :, 1]
    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    cand = nrow.clamp(0, h - 1) * w + ncol.clamp(0, w - 1)
    return cand.long(), in_bounds


def _grid_tables(sem: Semantics, grids: torch.Tensor):
    """Per maze, from the tile codes alone: (cand_idx (S, A), blocked,
    code after the move (N, S, A), codes (N, S))."""
    n, h, w = grids.shape
    codes = grids.reshape(n, h * w).long()
    cand_idx, in_bounds = _grid_geometry(sem, h, w)
    cand_code = codes[:, cand_idx]
    blocked = ~in_bounds[None] | ~sem.passable[cand_code]
    new_code = torch.where(blocked, codes[:, :, None], cand_code)
    return cand_idx, blocked, new_code, codes


def build_model_tables(sem: Semantics, levels: Level) -> ModelTable:
    """Model tables of a batched level: next_state/reward/done (N, S, A),
    terminal (N, S). Bit-identical to `build_model_table` maze by maze."""
    _check_batched(levels, "build_model_tables")
    cand_idx, blocked, new_code, codes = _grid_tables(sem, levels.grid)
    states = torch.arange(codes.shape[1], device=codes.device)
    next_state = torch.where(blocked, states[None, :, None], cand_idx[None])
    return ModelTable(
        next_state=next_state.to(torch.int32),
        reward=sem.reward[new_code],
        done=sem.terminal[new_code],
        terminal=sem.terminal[codes],
    )


def action_values_batched(
    model: ModelTable, v: torch.Tensor, gamma: float, lookup: str = "auto"
) -> torch.Tensor:
    """Batched Q(n, s, a) = r + γ·V(n, s') with no bootstrap through
    terminals. `lookup` is accepted and ignored: a lookup is one gather."""
    del lookup
    n, s, a = model.next_state.shape
    succ = v.gather(1, model.next_state.reshape(n, s * a).long()).reshape(n, s, a)
    q = model.reward + gamma * torch.where(model.done, 0.0, succ)
    return torch.where(model.terminal[:, :, None], 0.0, q)


def _pick(q: torch.Tensor, policy: torch.Tensor) -> torch.Tensor:
    """q[n, s, policy[n, s]] — the reference's one-hot sum, as a gather."""
    return q.gather(2, policy.long()[:, :, None])[:, :, 0]


def _howard(evaluate, improve, policy0, v0, max_policy_iters):
    """Evaluate-then-improve until no maze's policy changed."""
    policy, v, iters, stable = policy0, v0, 0, False
    while not stable and iters < max_policy_iters:
        v = evaluate(policy)
        new_policy, stable = improve(v, policy)
        policy, iters = new_policy, iters + 1
    return v, policy, iters


def _zeros(like: torch.Tensor, dtype) -> torch.Tensor:
    """(N, S) zeros beside an (N, S) table or (N, H, W) grids."""
    return like.new_zeros((like.shape[0], like[0].numel()), dtype=dtype)


def value_iteration_batched(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """VI over all N mazes at once (table form). Returns (V (N, S), policy
    (N, S), iters — sweeps until EVERY maze converged). `lookup` is accepted
    and ignored."""
    del lookup
    v, iters = sweep_until(
        lambda v: action_values_batched(model, v, gamma).max(dim=-1).values,
        _zeros(model.terminal, torch.float32), theta, max_iters,
    )
    return v, first_argmax(action_values_batched(model, v, gamma)), iters


def policy_evaluation_batched(
    model: ModelTable,
    policy: torch.Tensor,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """Iterative evaluation of per-maze policies: (N, S) int32
    deterministic or (N, S, A) float32 stochastic. Returns (V (N, S), iters).
    `lookup` is accepted and ignored."""
    del lookup
    if policy.dim() == 2:
        def backup(v):
            return _pick(action_values_batched(model, v, gamma), policy)
    else:
        def backup(v):
            return (policy * action_values_batched(model, v, gamma)).sum(dim=-1)
    return sweep_until(backup, _zeros(model.terminal, torch.float32), theta, max_iters)


def policy_iteration_batched(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    lookup: str = "auto",
):
    """Howard PI over all N mazes at once (table form). Returns (V (N, S),
    policy (N, S), policy iterations). `lookup` is accepted and ignored."""
    del lookup
    def evaluate(policy):
        return policy_evaluation_batched(model, policy, gamma, theta, max_eval_iters)[0]

    def improve(v, policy):
        new_policy = first_argmax(action_values_batched(model, v, gamma))
        return new_policy, bool((new_policy == policy).all())

    return _howard(
        evaluate, improve, _zeros(model.terminal, torch.int32), _zeros(model.terminal, torch.float32),
        max_policy_iters,
    )


# ---------------------------------------------------------------------------
# Grid form: kernel K4 on CUDA, the plain version on the CPU
# ---------------------------------------------------------------------------


def _grid_backup(sem: Semantics, grids: torch.Tensor, gamma: float):
    """`backup(v) -> Q (N, S, A)` from the grids: the candidate cell of each
    (s, a) is the same in every maze, so V is reindexed by one constant
    index and selected against the per-maze blocked mask."""
    cand_idx, blocked, new_code, codes = _grid_tables(sem, grids)
    rew = sem.reward[new_code]
    done = sem.terminal[new_code]
    term = sem.terminal[codes][:, :, None]

    def backup(v):
        cont = torch.where(blocked, v[:, :, None], v[:, cand_idx])
        cont = torch.where(done, 0.0, cont)
        return torch.where(term, 0.0, rew + gamma * cont)

    return backup


def value_iteration_batched_grid_reference(
    sem: Semantics, levels: Level, gamma: float = 0.99, theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Plain PyTorch version of K4's VI: `V[:, cand_idx]`, `torch.where`
    and a Python `while` over sweeps."""
    _check_batched(levels, "value_iteration_batched_grid")
    backup = _grid_backup(sem, levels.grid, gamma)
    v, iters = sweep_until(
        lambda v: backup(v).max(dim=-1).values, _zeros(levels.grid, torch.float32),
        theta, max_iters,
    )
    return v, first_argmax(backup(v)), iters


def policy_iteration_batched_grid_reference(
    sem: Semantics, levels: Level, gamma: float = 0.99, theta: float = 1e-6,
    max_eval_iters: int = 10_000, max_policy_iters: int = 100,
):
    """Plain PyTorch version of K4's Howard PI."""
    _check_batched(levels, "policy_iteration_batched_grid")
    backup = _grid_backup(sem, levels.grid, gamma)
    v0 = _zeros(levels.grid, torch.float32)

    def evaluate(policy):
        return sweep_until(lambda v: _pick(backup(v), policy), v0, theta, max_eval_iters)[0]

    def improve(v, policy):
        new_policy = first_argmax(backup(v))
        return new_policy, bool((new_policy == policy).all())

    return _howard(evaluate, improve, _zeros(levels.grid, torch.int32), v0, max_policy_iters)


def _sweep_until_cuda(sem, grids, policy, gamma, theta, max_iters, reduce_max=None):
    """`dp.sweep_until` through K4: launches of up to SWEEPS_PER_LAUNCH
    sweeps; the host reads each launch's per-sweep global maxima once.
    Where sweep j < the launch's count is the first under theta, V after
    exactly j+1 sweeps comes from rerunning that count on the launch's
    input. `reduce_max` (a sharded solver's all-reduce over its ranks) takes
    the launch's (k,) maxima to their maxima over every rank first, so that
    every rank stops at the same sweep."""
    v, iters = _zeros(grids, torch.float32), 0
    while iters < max_iters:
        k = min(SWEEPS_PER_LAUNCH, max_iters - iters)
        v_out, maxima = grid_sweeps_cuda(sem, grids, v, policy, gamma, k)
        if reduce_max is not None:
            maxima = reduce_max(maxima)
        hit = [j for j, m in enumerate(maxima.tolist()) if below(m, theta)]
        if hit:
            if hit[0] + 1 < k:
                v_out, _ = grid_sweeps_cuda(sem, grids, v, policy, gamma, hit[0] + 1)
            return v_out, iters + hit[0] + 1
        v, iters = v_out, iters + k
    return v, iters


def value_iteration_batched_grid(
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    validate: bool | None = None,
):
    """VI over N mazes straight from the batched grid (K4 on CUDA).

    Returns (V (N, S), policy (N, S), iters), the contract of
    `value_iteration_batched(build_model_tables(sem, levels))`. `validate`
    is accepted and ignored (it armed the reference's defense against its
    TPU toolchain)."""
    del validate
    _check_batched(levels, "value_iteration_batched_grid")
    if not kernels.on_cuda(levels.grid, sem.deltas):
        return value_iteration_batched_grid_reference(sem, levels, gamma, theta, max_iters)
    grids = levels.grid.contiguous()
    v, iters = _sweep_until_cuda(sem, grids, None, gamma, theta, max_iters)
    policy, _ = grid_greedy_cuda(sem, grids, v, gamma, None)
    return v, policy, iters


def policy_iteration_batched_grid(
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    validate: bool | None = None,
):
    """Howard PI over N mazes straight from the batched grid (K4 on CUDA):
    evaluation sweeps take the current policy's action value, improvement
    is an argmax, and it stops when every maze's policy is stable.

    Returns (V (N, S), policy (N, S), outer iters). `validate` is accepted
    and ignored, as in `value_iteration_batched_grid`."""
    del validate
    _check_batched(levels, "policy_iteration_batched_grid")
    if not kernels.on_cuda(levels.grid, sem.deltas):
        return policy_iteration_batched_grid_reference(
            sem, levels, gamma, theta, max_eval_iters, max_policy_iters
        )
    grids = levels.grid.contiguous()

    def evaluate(policy):
        return _sweep_until_cuda(sem, grids, policy, gamma, theta, max_eval_iters)[0]

    def improve(v, policy):
        new_policy, changed = grid_greedy_cuda(sem, grids, v, gamma, policy)
        return new_policy, not bool(changed)

    return _howard(
        evaluate, improve, _zeros(grids, torch.int32), _zeros(grids, torch.float32),
        max_policy_iters,
    )
