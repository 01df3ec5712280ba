"""Wrappers of K5 (`csrc/td_fast.cu`): check, plan the grid, allocate, launch.

The scan's plain PyTorch version is `algos.td_fast.td_scan_fast_reference`;
its sharded form's (one launch a step) is `algos.td_fast.td_step_sharded_reference`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .rollout import NARROW_ACTIONS, level_args, max_steps_arg, semantics_args

THREADS = 512      # a block of the scan kernel
MAX_STAGED_ENTRIES = 8192  # S·A up to which every block holds Q in shared memory


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """The scan's grid: `blocks` blocks of `THREADS` threads, thread g
    walking envs g, g + T, g + 2T, ... (T = blocks · THREADS), `walks` of
    them; `ept` is 1 where the kernel keeps a thread's one env in
    registers, 0 where it keeps the envs' state in global memory."""

    blocks: int
    ept: int
    walks: int


def grid_plan(batch: int, sms: int, resident: Callable[[int], int]) -> GridPlan:
    """The plan for `batch` envs on `sms` SMs, `resident(ept)` the blocks of
    that kernel an SM holds at once: an env a thread where the card holds
    that grid at once (a grid barrier must never wait on a block that is
    not running), else the form with the state in global memory over the
    whole resident grid."""
    blocks = -(-batch // THREADS)
    if blocks <= resident(1) * sms:
        return GridPlan(blocks, 1, 1)
    blocks = resident(0) * sms
    if blocks < 1:
        raise RuntimeError("K5's scan kernel does not fit an SM")
    return GridPlan(blocks, 0, -(-batch // (blocks * THREADS)))


def thread_envs(plan: GridPlan, batch: int) -> torch.Tensor:
    """(blocks · THREADS, walks) int64: the env each thread walks at each of
    its walks, −1 past the batch, as the kernel assigns them."""
    total = plan.blocks * THREADS
    envs = torch.arange(total)[:, None] + total * torch.arange(plan.walks)[None, :]
    return torch.where(envs < batch, envs, -1)


_resident_cache: dict[tuple[int, int, int, bool], tuple[int, int]] = {}


def _resident(device: torch.device, n_entries: int, ept: int, num_actions: int = 4) -> tuple[int, int]:
    """(blocks an SM holds at once, SMs) of the kernel for (n_entries, ept,
    num_actions: up to NARROW_ACTIONS, or the wide form above) on `device`;
    raises where the device has no cooperative launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, n_entries, ept, num_actions > NARROW_ACTIONS)
    if key not in _resident_cache:
        out = (ctypes.c_int * 2)()
        launch("gu_td_scan_fast_resident", device, n_entries, ept, num_actions, ctypes.addressof(out))
        _resident_cache[key] = (out[0], out[1])
    return _resident_cache[key]


def td_scan_fast_cuda(
    sem, bl, q, env_state, rs, run_ret, n_eps_env, ret_sum_env,
    num_steps: int, alpha: float, gamma: float, epsilon: float,
    expected_sarsa: int, max_episode_steps: int | None,
):
    """Launch K5 once for `num_steps` steps (`LAUNCHES` counts the one
    launch). Returns the new (q, agent_idx, agent_code, t, rs, run_ret,
    n_eps_env, ret_sum_env); the inputs are left as they were."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"td_scan_fast_cuda takes CUDA tensors, got {device}")
    b = int(rs.shape[0]) if rs.dim() == 1 else 0
    n_entries = bl.num_states * sem.num_actions
    num_steps = check_int("num_steps", num_steps)
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
    args += level_args(
        bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, device
    )
    state_in = [
        ("agent_idx", env_state.agent_idx, torch.int32),
        ("agent_code", env_state.agent_code, torch.int32),
        ("t", env_state.t, torch.int32),
        ("rs", rs, torch.int32),
        ("run_ret", run_ret, torch.float32),
        ("n_eps_env", n_eps_env, torch.int32),
        ("ret_sum_env", ret_sum_env, torch.float32),
    ]
    q_ptr = check_tensor("q", q, torch.float32, (bl.num_states, sem.num_actions), device)
    in_ptrs = [check_tensor(name, x, dtype, (b,), device) for name, x, dtype in state_in]
    if num_steps == 0:
        return (q.clone(), *[x.clone() for _, x, _ in state_in])
    na = sem.num_actions
    plan = grid_plan(b, _resident(device, n_entries, 1, na)[1],
                     lambda ept: _resident(device, n_entries, ept, na)[0])
    q_out = torch.empty_like(q)
    state = [torch.empty_like(x) for _, x, _ in state_in]
    staged = n_entries <= MAX_STAGED_ENTRIES
    q_buf = None if staged else torch.empty((2, n_entries), dtype=torch.float32, device=device)
    acc = torch.empty((3, n_entries), dtype=torch.int64, device=device)
    cnt = torch.empty((3, n_entries), dtype=torch.int32, device=device)
    launch(
        "gu_td_scan_fast", device, *args,
        b, num_steps, max_steps_arg(max_episode_steps), int(expected_sarsa),
        float(alpha), float(gamma), float(epsilon), 1.0 - float(epsilon),
        int(float(epsilon) * 65536.0), plan.blocks, plan.ept, plan.walks,
        q_ptr, q_out.data_ptr(), *in_ptrs, *[x.data_ptr() for x in state],
        None if q_buf is None else q_buf.data_ptr(), acc.data_ptr(), cnt.data_ptr(),
    )
    LAUNCHES["td_scan_fast"] += 1
    return (q_out, *state)



# -- the sharded form: one launch a step -------------------------------------
STATE_FIELDS = ("agent_idx", "agent_code", "t", "rs", "run_ret", "n_eps_env", "ret_sum_env")
_STATE_DTYPES = (torch.int32,) * 4 + (torch.float32, torch.int32, torch.float32)


def step_blocks(batch: int, n_entries: int, act: bool) -> int:
    """Blocks of `THREADS` of a sharded-form launch: an env a thread where
    it steps (`act`), else enough to write the table's `n_entries` once."""
    return max(1, -(-(batch if act else n_entries) // THREADS))


def step_slots(step: int) -> tuple[int | None, int, int]:
    """The aggregate rows (of three) that the launch of `step` reads (the
    summed aggregate of step - 1, None at step 0), adds to and clears: each
    row is added to at step t, summed over the ranks, read at t + 1 and
    cleared at t + 2, ready for t + 3."""
    return (None if step == 0 else (step - 1) % 3), step % 3, (step + 1) % 3


def td_step_sharded_cuda(
    sem, bl, q_prev, q_cur, agg_prev, agg_cur, agg_clear, state,
    alpha: float, gamma: float, epsilon: float, expected_sarsa: int,
    max_episode_steps: int | None, act: bool = True,
) -> None:
    """One launch of K5's sharded form (`LAUNCHES["td_step_sharded"]` + 1):
    Q_t = q_prev + the mean of the summed aggregate `agg_prev` (None at step
    0) written to `q_cur`; with `act`, this rank's envs stepped against Q_t
    (`state`, the seven (B,) tensors of `STATE_FIELDS`, in place) and their
    fixed-point increments and counts added to `agg_cur`; `agg_clear` (or
    None) cleared. Each aggregate is (2, S·A) int64, sums then counts, and
    `agg_cur` must be clear."""
    device = q_prev.device
    if device.type != "cuda":
        raise ValueError(f"td_step_sharded_cuda takes CUDA tensors, got {device}")
    b = int(state[3].shape[0]) if state[3].dim() == 1 else 0
    n_entries = bl.num_states * sem.num_actions
    args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
    args += level_args(
        bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, device
    )
    table = (bl.num_states, sem.num_actions)
    agg = (2, n_entries)
    ptrs = [
        check_tensor("q_prev", q_prev, torch.float32, table, device),
        check_tensor("q_cur", q_cur, torch.float32, table, device),
        None if agg_prev is None else check_tensor("agg_prev", agg_prev, torch.int64, agg, device),
        check_tensor("agg_cur", agg_cur, torch.int64, agg, device),
        None if agg_clear is None else check_tensor("agg_clear", agg_clear, torch.int64, agg, device),
    ]
    ptrs += [check_tensor(name, x, dtype, (b,), device)
             for name, x, dtype in zip(STATE_FIELDS, state, _STATE_DTYPES)]
    launch(
        "gu_td_step_sharded", device, *args,
        b, max_steps_arg(max_episode_steps), int(expected_sarsa),
        float(alpha), float(gamma), float(epsilon), 1.0 - float(epsilon),
        int(float(epsilon) * 65536.0), int(act), step_blocks(b, n_entries, act), *ptrs,
    )
    LAUNCHES["td_step_sharded"] += 1
