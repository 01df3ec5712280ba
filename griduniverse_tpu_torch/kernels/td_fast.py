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
MAX_CLUSTER = 8  # blocks a cluster of the staged form (the portable limit)
# entries of Q_t a block of a cluster rebuilds and owns, about, as `step_cluster`
# aims for: the size at which a cluster paid on the H100 (`PERF.md` §6, PR 21)
CLUSTER_ENTRIES = 1_024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _TdFastArgs(ctypes.Structure):
    """`TdFastArgs` of `csrc/td_fast.cu`, field for field."""

    _fields_ = [
        ("passable", _P), ("terminal", _P), ("reward", _P), ("deltas", _P), ("num_actions", _I),
        ("words", _P), ("n_words", _I), ("per_env", _I), ("start_idx", _P), ("start_code", _P),
        ("h", _I), ("w", _I), ("batch", _I), ("num_steps", _I), ("max_episode_steps", _I),
        ("expected_sarsa", _I), ("alpha", _F), ("gamma", _F), ("epsilon", _F), ("one_minus_epsilon", _F),
        ("eps16", ctypes.c_uint32), ("walks", _I), ("q_in", _P), ("q_out", _P),
        ("state_in", _P * 7), ("state", _P * 7), ("q_buf", _P), ("acc", _P), ("cnt", _P),
    ]


class _TdStepPlanArgs(ctypes.Structure):
    """`TdStepPlan` of `csrc/td_fast.cu`, field for field."""

    _fields_ = [("g", _TdFastArgs), ("q", _P * 2), ("agg", _P * 3), ("blocks", _I), ("cluster", _I)]


def step_blocks(batch: int, n_entries: int, act: bool) -> int:
    """Blocks of `THREADS` of a sharded-form launch: an env a thread where
    it steps (`act`), else enough to write the table's `n_entries` once."""
    return max(1, -(-(batch if act else n_entries) // THREADS))


def step_cluster(blocks: int, n_entries: int) -> int:
    """Blocks a cluster of the staged form's launch of `blocks` blocks over a
    table of `n_entries`: the largest count that divides the grid, up to
    ⌈n_entries / CLUSTER_ENTRIES⌉ but at least 2 and at most MAX_CLUSTER
    (1 for one block). A block of a larger cluster rebuilds and flushes
    fewer entries but waits on more blocks at each cluster barrier and adds
    to more of them: on the H100 two blocks were the fastest at walls16
    (1,024 entries) and at nine actions (2,304), eight at 8,100 entries."""
    target = min(MAX_CLUSTER, max(2, -(-n_entries // CLUSTER_ENTRIES)))
    return next(k for k in range(min(target, blocks), 0, -1) if blocks % k == 0)


def step_slots(step: int) -> tuple[int | None, int, int]:
    """The aggregate rows (of three) that the launch of `step` reads (the
    summed aggregate of step - 1, None at step 0), adds to and clears: each
    row is added to at step t, summed over the ranks, read at t + 1 and
    cleared at t + 2, ready for t + 3. The kernel derives the same rows from
    the step's index (`rows_of`)."""
    return (None if step == 0 else (step - 1) % 3), step % 3, (step + 1) % 3


class TdStepPlan:
    """K5's sharded form for one scan (`algos.td_fast.td_scan_fast_sharded`
    builds one a call): the semantics, the level, the seven (B,) state
    tensors of `STATE_FIELDS` (stepped IN PLACE), Q before step 0 (`q0`,
    read) and the plan's rows checked once, and the C plan that holds them
    packed once.

    The rows: Q_t is written into `q_rows[t % 2]`, step t's aggregate is
    added into `aggregates[t % 3]` ((2, S·A) int64, sums then counts) and
    the last launch writes `q_final`. By default the plan allocates them (the
    aggregates zeroed, so a plan drives one scan); `td_step_sharded_cuda`
    hands its own. `cluster` forces the blocks a cluster of the staged form
    (it must divide the grid); by default `step_cluster`'s.

    `step(t)` is one launch of step t: Q_t from Q_{t-1} and step t-1's
    aggregate (already summed over the ranks), this rank's envs acted and
    stepped against it, their increments added to step t's aggregate, which
    it returns for the caller's all-reduce. `finish(t)` is the last launch:
    Q after step t - 1 into `q_final`, which it returns.

    The plan is stream-ordered: its calls must follow one another on the
    stream current on its device when it was built (a CUDA graph's capture
    stream, for a captured scan). A call from another stream raises, and so
    does a call of a plan built on CPU tensors."""

    def __init__(self, sem, bl, q0, state, alpha: float, gamma: float, epsilon: float, expected_sarsa: int,
                 max_episode_steps: int | None, q_rows=None, aggregates=None, q_final=None,
                 cluster: int | None = None):
        device = q0.device
        self.sem, self.bl, self.max_episode_steps = sem, bl, max_episode_steps
        b = int(state[3].shape[0]) if state[3].dim() == 1 else 0
        args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
        args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, device)
        table = (bl.num_states, sem.num_actions)
        n = bl.num_states * sem.num_actions
        if len(state) != len(STATE_FIELDS):
            raise ValueError(f"state must be the {len(STATE_FIELDS)} tensors {STATE_FIELDS}")
        state_ptrs = [check_tensor(name, x, dtype, (b,), device)
                      for name, x, dtype in zip(STATE_FIELDS, state, _STATE_DTYPES)]
        q0_ptr = check_tensor("q0", q0, torch.float32, table, device)
        if q_rows is None:
            q_rows = tuple(torch.empty(table, dtype=torch.float32, device=device) for _ in range(2))
        if aggregates is None:
            aggregates = tuple(torch.zeros((3, 2, n), dtype=torch.int64, device=device).unbind(0))
        if q_final is None:
            q_final = torch.empty(table, dtype=torch.float32, device=device)
        q_ptrs = [None if x is None else check_tensor(f"q_rows[{i}]", x, torch.float32, table, device)
                  for i, x in enumerate(q_rows)]
        agg_ptrs = [None if x is None else check_tensor(f"aggregates[{i}]", x, torch.int64, (2, n), device)
                    for i, x in enumerate(aggregates)]
        final_ptr = check_tensor("q_final", q_final, torch.float32, table, device)
        blocks = step_blocks(b, n, True)
        cluster = step_cluster(blocks, n) if cluster is None else check_int("cluster", cluster, low=1)
        if cluster > MAX_CLUSTER or blocks % cluster:
            raise ValueError(f"a cluster of {cluster} blocks does not divide a grid of {blocks} "
                             f"(at most {MAX_CLUSTER})")
        # the tensors the plan's pointers name, kept alive with it
        self.q0, self.state, self.q_rows, self.aggregates, self.q_final = q0, state, q_rows, aggregates, q_final
        self.batch, self.device, self.blocks, self.cluster = b, device, blocks, cluster
        g = _TdFastArgs(*args, b, 1, max_steps_arg(max_episode_steps), int(expected_sarsa), float(alpha),
                        float(gamma), float(epsilon), 1.0 - float(epsilon), int(float(epsilon) * 65536.0), 1,
                        q0_ptr, final_ptr, (_P * 7)(), (_P * 7)(*state_ptrs), None, None, None)
        self._args = _TdStepPlanArgs(g, (_P * 2)(*q_ptrs), (_P * 3)(*agg_ptrs), blocks, cluster)
        self._addr = ctypes.addressof(self._args)
        self._stream = torch._C._cuda_getCurrentRawStream(device.index) if device.type == "cuda" else None

    def check_level(self, sem, bl, max_episode_steps) -> None:
        """Raise unless (sem, bl, max_episode_steps) are those the plan was built for."""
        if sem is not self.sem or bl is not self.bl or max_episode_steps != self.max_episode_steps:
            raise ValueError("this TdStepPlan was built for another semantics, level or time limit")

    def _launch(self, step: int, act: int) -> None:
        if self._stream is None:
            raise ValueError(f"K5's sharded form takes CUDA tensors, got {self.device}")
        if torch._C._cuda_getCurrentRawStream(self.device.index) != self._stream:
            raise RuntimeError("a TdStepPlan is stream-ordered: it was called from another stream than the one "
                               "it was built on")
        launch("gu_td_step", self.device, self._addr, step, act)
        LAUNCHES["td_step_sharded"] += 1

    def step(self, t: int):
        """Step `t`: one launch. Returns step t's aggregate row, to be summed
        over the ranks before step t + 1."""
        self._launch(t, 1)
        return self.aggregates[step_slots(t)[1]]

    def finish(self, t: int):
        """The last launch, after steps 0..t-1: Q_t into `q_final`, returned."""
        self._launch(t, 0)
        return self.q_final


def td_step_sharded_cuda(
    sem, bl, q_prev, q_cur, agg_prev, agg_cur, agg_clear, state,
    alpha: float, gamma: float, epsilon: float, expected_sarsa: int,
    max_episode_steps: int | None, act: bool = True, cluster: int | None = None,
) -> None:
    """One launch of K5's sharded form on explicit rows, through a plan
    built for the call (`LAUNCHES["td_step_sharded"]` + 1): Q_t = q_prev +
    the mean of the summed aggregate `agg_prev` (None at step 0) written to
    `q_cur`; with `act`, this rank's envs stepped against Q_t (`state`, the
    seven (B,) tensors of `STATE_FIELDS`, in place) and their fixed-point
    increments and counts added to `agg_cur`; `agg_clear` (or None)
    cleared. Each aggregate is (2, S·A) int64, sums then counts, and
    `agg_cur` must be clear. A scan builds one `TdStepPlan` instead."""
    device = q_prev.device
    if device.type != "cuda":
        raise ValueError(f"td_step_sharded_cuda takes CUDA tensors, got {device}")
    kw = dict(alpha=alpha, gamma=gamma, epsilon=epsilon, expected_sarsa=expected_sarsa,
              max_episode_steps=max_episode_steps, cluster=cluster)
    if agg_prev is None:  # step 0: Q_0 is q_prev itself
        plan = TdStepPlan(sem, bl, q_prev, state, q_rows=(q_cur, None), aggregates=(agg_cur, agg_clear, None),
                          q_final=q_cur, **kw)
        step = 0
    else:  # step 1's rows: Q_{t-1} in row 0, Q_t in row 1, the aggregates in rows 0, 1, 2
        plan = TdStepPlan(sem, bl, q_prev, state, q_rows=(q_prev, q_cur), aggregates=(agg_prev, agg_cur, agg_clear),
                          q_final=q_cur, **kw)
        step = 1
    if act:
        plan.step(step)
    else:
        plan.finish(step)
