"""Wrapper of K7c (`csrc/dqn_act.cu`): a host plan built once a run, then
one check, one allocation and one launch a call; in its store form the
launch also writes the step's transitions into the run's replay ring.

The plain PyTorch versions are `models.dqn.dqn_act_step_reference` and,
for the store form, `models.dqn.dqn_act_store_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_int, check_tensor, launch
from .replay import RING_FIELDS, ring_pointers
from .rollout import level_args, max_steps_arg, semantics_args

CHUNK = 256  # envs a block: the first level of the fixed-order sum of ended returns

_P, _I = ctypes.c_void_p, ctypes.c_int

# the outputs in the order K7c returns them (and `csrc/dqn_act.cu` `Outputs`)
OUTPUTS = ("agent_idx", "agent_code", "t", "state_done", "action", "next_obs", "reward", "done",
           "run_ret", "episodes", "ret_sum")


class _RingArgs(ctypes.Structure):
    """`Ring` of `csrc/dqn_act.cu`, field for field."""

    _fields_ = [(name, _P) for name, _ in RING_FIELDS] + [("prio", _P), ("cap", ctypes.c_longlong)]


class _PlanArgs(ctypes.Structure):
    """`ActPlan` of `csrc/dqn_act.cu`, field for field."""

    _fields_ = [
        ("passable", _P), ("terminal", _P), ("reward", _P), ("deltas", _P), ("num_actions", _I),
        ("words", _P), ("n_words", _I), ("per_env", _I), ("start_idx", _P), ("start_code", _P),
        ("h", _I), ("w", _I), ("batch", _I), ("max_episode_steps", _I),
        ("chunk_sum", _P), ("chunk_count", _P), ("ticket", _P),
        ("out_offset", ctypes.c_longlong * len(OUTPUTS)),
    ]


def _round16(n: int) -> int:
    return (n + 15) & ~15


def output_offsets(b: int) -> tuple[dict[str, tuple[int, torch.dtype, tuple[int, ...]]], int]:
    """({name: (byte offset, dtype, shape)}, bytes in all) of the buffer
    that holds K7c's eleven outputs for `b` envs, each at a 16-byte
    boundary: the five int32 and two float32 rows, the two bool rows, then
    episodes and ret_sum. The only statement of the layout: the plan hands
    the offsets to the kernel."""
    words, flags = _round16(4 * b), _round16(b)
    tail = 7 * words + 2 * flags
    at = {
        "agent_idx": (0, torch.int32, (b,)), "agent_code": (words, torch.int32, (b,)),
        "t": (2 * words, torch.int32, (b,)), "action": (3 * words, torch.int32, (b,)),
        "next_obs": (4 * words, torch.int32, (b,)), "reward": (5 * words, torch.float32, (b,)),
        "run_ret": (6 * words, torch.float32, (b,)), "state_done": (7 * words, torch.bool, (b,)),
        "done": (7 * words + flags, torch.bool, (b,)), "episodes": (tail, torch.int64, ()),
        "ret_sum": (tail + 16, torch.float32, ()),
    }
    return at, tail + 32


def _carve_spec(b: int):
    """Per output, in the order of `OUTPUTS`: (dtype, shape, stride, offset
    in elements of that dtype)."""
    at, _ = output_offsets(b)
    spec = []
    for name in OUTPUTS:
        offset, dtype, shape = at[name]
        spec.append((dtype, shape, (1,) * len(shape), offset // dtype.itemsize))
    return spec


def _carved(buf: torch.Tensor, spec) -> tuple[torch.Tensor, ...]:
    # one view of the buffer a dtype, then a strided view an output
    by_dtype = {torch.int32: buf}
    for dtype in (torch.float32, torch.bool, torch.int64):
        by_dtype[dtype] = buf.view(dtype)
    return tuple(by_dtype[dtype].as_strided(shape, stride, offset) for dtype, shape, stride, offset in spec)


def carve(buf: torch.Tensor, b: int) -> tuple[torch.Tensor, ...]:
    """K7c's eleven outputs as views of `buf`, an int32 tensor of
    `output_offsets(b)[1]` bytes whose data is 16-byte aligned, in the order
    of `OUTPUTS`."""
    return _carved(buf, _carve_spec(b))


class DqnActPlan:
    """K7c for one run: the semantics and the level checked once, the C
    plan that holds them, and the scratch of the statistics' fold (a
    partial sum and count a chunk of `CHUNK` envs, and the ticket of the
    last block), built once a run (`models.dqn.dqn_learner`).

    The scratch is stream-ordered: every call reuses it, so the calls of a
    plan must follow one another on one stream, the stream current on the
    plan's device when it was built. A call from another stream raises.

    A call (`plan(state, q, explore, rand_a, run_ret, episodes, ret_sum)`)
    checks the step's tensors at once, allocates one buffer that holds all
    eleven outputs (`carve`; fresh on every call, as the caller keeps them),
    and launches once. It raises on a tensor of another device, dtype or
    shape (the batch) than the plan's, and `check_level` on another level.

    The store form: `bind_ring(buf, prio)` checks a run's replay ring once
    and keeps it; a call with `ring=(buf, prio, at, p_max)` then launches
    the kernel that also writes the step's B transitions into slots `at`..
    of that ring (and `p_max` into those of `prio`), `at` and `p_max` read
    on the card. A call whose ring is not the bound one raises."""

    def __init__(self, sem, bl, batch: int, max_episode_steps: int | None):
        device = sem.deltas.device
        args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
        args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, batch, device)
        self.sem, self.bl, self.batch, self.device = sem, bl, batch, device
        self.max_episode_steps = max_episode_steps
        self.num_actions = args[4]
        chunks = -(-batch // CHUNK)
        # chunk_sum (float32), chunk_count (int32), the ticket: only the ticket needs its zero
        self._scratch = torch.zeros(2 * chunks + 1, dtype=torch.int32, device=device)
        base = self._scratch.data_ptr()
        at, total = output_offsets(batch)
        offsets = (ctypes.c_longlong * len(OUTPUTS))(*[at[name][0] for name in OUTPUTS])
        self._args = _PlanArgs(*args, batch, max_steps_arg(max_episode_steps),
                               base, base + 4 * chunks, base + 8 * chunks, offsets)
        self._words = total // 4
        self._spec = _carve_spec(batch)
        b, a = batch, self.num_actions
        # (dtype, shape, device, contiguous) of q, explore, rand_a, agent_idx,
        # agent_code, t, run_ret, episodes, ret_sum
        self._expected = [(dtype, torch.Size(shape), device, True) for dtype, shape in (
            (torch.float32, (b, a)), (torch.bool, (b,)), (torch.int32, (b,)), (torch.int32, (b,)),
            (torch.int32, (b,)), (torch.int32, (b,)), (torch.float32, (b,)), (torch.int64, ()),
            (torch.float32, ()))]
        self._stream = torch._C._cuda_getCurrentRawStream(device.index) if device.type == "cuda" else None
        self._ring = None  # (the five fields, prio) of the bound ring
        self._ring_args = None

    def bind_ring(self, buf, prio) -> None:
        """Check a run's replay ring once and keep it for the store form:
        `buf` the five (cap,) fields of a `models.dqn.ReplayBuffer`, `prio`
        their (cap,) float32 priorities or None (uniform replay), all on the
        plan's device, cap a multiple of the batch (so that a step's store
        never wraps). Raises on any other ring; a later call binds anew."""
        cap = check_int("capacity", int(buf.obs.shape[0]) if buf.obs.dim() == 1 else 0, low=1)
        if cap % self.batch:
            raise ValueError(f"the ring's capacity ({cap}) must be a multiple of the batch ({self.batch}) "
                             "so that a step's store never wraps")
        ptrs = ring_pointers(buf, cap, self.device)
        prio_ptr = None if prio is None else check_tensor("prio", prio, torch.float32, (cap,), self.device)
        self._ring = (tuple(buf), prio)
        self._ring_args = _RingArgs(*ptrs, prio_ptr, cap)
        # a call's at and p_max (only at without priorities)
        scalar = (torch.Size(()), self.device, True)
        self._expected_store = self._expected + [(torch.int64, *scalar)] + (
            [] if prio is None else [(torch.float32, *scalar)])

    def check_level(self, sem, bl, max_episode_steps) -> None:
        """Raise unless (sem, bl, max_episode_steps) are those the plan was built for."""
        if sem is not self.sem or bl is not self.bl or max_episode_steps != self.max_episode_steps:
            raise ValueError("this DqnActPlan was built for another semantics, level or time limit")

    def check(self, tensors, expected=None) -> None:
        """One check of the step's nine tensors (q, explore, rand_a,
        agent_idx, agent_code, t, run_ret, episodes, ret_sum; the store form
        adds at and, with priorities, p_max) against the plan; on a
        mismatch, the tensor at fault is named."""
        expected = self._expected if expected is None else expected
        try:
            if [(x.dtype, x.shape, x.device, x.is_contiguous()) for x in tensors] == expected:
                return
        except AttributeError:
            pass
        names = ("q", "explore", "rand_a", "agent_idx", "agent_code", "t", "run_ret", "episodes", "ret_sum",
                 "at", "p_max")
        for name, x, (dtype, shape, device, _) in zip(names, tensors, expected):
            check_tensor(name, x, dtype, shape, device)
        raise ValueError("K7c's step tensors do not match the plan")

    def _check_ring(self, ring) -> tuple:
        """The store form's extra tensors (at, and p_max with priorities),
        once the ring is found to be the bound one."""
        buf, prio, at, p_max = ring
        if self._ring is None:
            raise ValueError("this DqnActPlan has no ring: bind_ring(buf, prio) first")
        fields, bound_prio = self._ring
        if prio is not bound_prio or len(buf) != len(fields) or any(x is not y for x, y in zip(buf, fields)):
            raise ValueError("this DqnActPlan's ring was bound to other tensors (bind_ring, once a run)")
        return (at,) if prio is None else (at, p_max)

    def __call__(self, state, q, explore, rand_a, run_ret, episodes, ret_sum, ring=None):
        """One act-and-step (see the class docstring); with `ring` = (buf,
        prio, at, p_max) the store form. Returns the new (agent_idx,
        agent_code, t, done), the step's (action, next_obs, reward, done)
        and the new (run_ret, episodes, ret_sum)."""
        tensors = (q, explore, rand_a, state.agent_idx, state.agent_code, state.t, run_ret, episodes, ret_sum)
        if ring is None:
            self.check(tensors)
        else:
            extra = self._check_ring(ring)
            self.check(tensors + extra, self._expected_store)
        if self._stream is None:
            raise ValueError(f"K7c takes CUDA tensors, got {self.device}")
        if torch._C._cuda_getCurrentRawStream(self.device.index) != self._stream:
            raise RuntimeError("a DqnActPlan is stream-ordered: it was called from another stream than "
                               "the one it was built on")
        buf = torch.empty(self._words, dtype=torch.int32, device=self.device)
        ptrs = [x.data_ptr() for x in tensors]
        if ring is None:
            launch("gu_dqn_act_step", self.device, ctypes.addressof(self._args), *ptrs, buf.data_ptr())
        else:
            launch("gu_dqn_act_store", self.device, ctypes.addressof(self._args),
                   ctypes.addressof(self._ring_args), *ptrs, extra[0].data_ptr(),
                   extra[1].data_ptr() if len(extra) == 2 else None, buf.data_ptr())
        LAUNCHES["dqn_act"] += 1
        return _carved(buf, self._spec)

