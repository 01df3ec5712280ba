"""Wrapper of K7b (`csrc/act_step.cu`): a host plan built once a run, then
one check and one launch a rollout step, and nothing allocated.

The plain PyTorch versions are `models.a2c.act_step_reference` and
`models.a2c.greedy_step_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.bitplane import FastState
from . import LAUNCHES
from .build import check_tensor, launch
from .rollout import level_args, max_steps_arg, semantics_args

_P, _I = ctypes.c_void_p, ctypes.c_int

ROWS = ("obs", "action", "logp", "reward", "done")  # the trajectory's (T, B) rows, in `csrc/act_step.cu`'s order
SLOT = ("agent_idx", "agent_code", "t", "done", "reached")  # one of the two slots of env state, each (B,)
_ROW_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.bool)
_SLOT_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool, torch.bool)


class _PlanArgs(ctypes.Structure):
    """`ActPlan` of `csrc/act_step.cu`, field for field."""

    _fields_ = [
        ("passable", _P), ("terminal", _P), ("reward", _P), ("deltas", _P), ("num_actions", _I),
        ("words", _P), ("n_words", _I), ("per_env", _I), ("start_idx", _P), ("start_code", _P),
        ("h", _I), ("w", _I), ("batch", _I), ("max_episode_steps", _I),
        ("gumbel", _P), ("rows", _P * len(ROWS)), ("slot", (_P * len(SLOT)) * 2),
    ]


def _round16(n: int) -> int:
    return (n + 15) & ~15


def layout(t: int, b: int) -> tuple[list[tuple[int, torch.dtype, tuple[int, ...]]], int]:
    """([(byte offset, dtype, shape)], bytes in all) of the buffer that holds
    the five (t, b) rows of `ROWS`, then the two slots of `SLOT`, each piece
    at a 16-byte boundary. The only statement of the layout: the plan hands
    the pointers to the kernel."""
    pieces, at = [], 0
    for dtype, shape in [(d, (t, b)) for d in _ROW_DTYPES] + [(d, (b,)) for d in _SLOT_DTYPES] * 2:
        pieces.append((at, dtype, shape))
        at += _round16(dtype.itemsize * t * b if len(shape) == 2 else dtype.itemsize * b)
    return pieces, at


def carve(buf: torch.Tensor, t: int, b: int) -> tuple[torch.Tensor, ...]:
    """The plan's fifteen pieces as views of `buf`, an int32 tensor of
    `layout(t, b)[1]` bytes whose data is 16-byte aligned: the rows of
    `ROWS`, then slot 0's and slot 1's fields of `SLOT`."""
    views = {torch.int32: buf, torch.float32: buf.view(torch.float32), torch.bool: buf.view(torch.bool)}
    return tuple(views[dtype].as_strided(shape, (shape[-1], 1)[-len(shape):], offset // dtype.itemsize)
                 for offset, dtype, shape in layout(t, b)[0])


class ActStepPlan:
    """K7b for one run: the semantics and the level checked once, the C plan
    that holds them, one buffer for the rollout's (T, B) trajectory rows
    (`ROWS`) and for two slots of env state, carved once (`carve`), built
    once a run (`models.a2c.a2c_learner`, `models.ppo.ppo_learner`,
    `models.evaluation.greedy_reached`).

    A rollout is `begin(state, gumbel)` (the (T, B, A) noise and the start
    state checked once), then `step(t, logits)` for t = 0..T−1: one check of
    the logits and one launch, which reads the state from a slot (or, at the
    first step, the caller's tensors), writes the other slot and row t, and
    returns that slot as a `FastState`; `rows` are then the trajectory. The
    greedy form, `greedy(state, reached, logits)`, steps through the same
    slots. Nothing is allocated a step and no view is made.

    What a plan returns are views of its buffer: the next rollout through
    the plan writes them again, so a caller that keeps a trajectory or a
    state past it clones them. The buffer is stream-ordered: the calls of a
    plan must follow one another on one stream, the stream current on the
    plan's device when it was built (a CUDA-graph capture builds its plan on
    the capture's stream). A call from another stream raises."""

    def __init__(self, sem, bl, batch: int, rollout_len: int, max_episode_steps: int | None):
        device = sem.deltas.device
        args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, device)
        args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, batch, device)
        self.sem, self.bl, self.batch, self.device = sem, bl, batch, device
        self.rollout_len, self.max_episode_steps = rollout_len, max_episode_steps
        self.num_actions = args[4]
        pieces, total = layout(rollout_len, batch)
        self._buf = torch.zeros(total // 4, dtype=torch.int32, device=device)
        views = carve(self._buf, rollout_len, batch)
        self.rows = views[:len(ROWS)]
        slots = (views[len(ROWS):len(ROWS) + len(SLOT)], views[len(ROWS) + len(SLOT):])
        self.states = tuple(FastState(*slot[:4]) for slot in slots)
        self.reached = tuple(slot[4] for slot in slots)
        base = self._buf.data_ptr()
        ptrs = [base + offset for offset, _, _ in pieces]
        self._args = _PlanArgs(*args, batch, max_steps_arg(max_episode_steps), None,
                               (_P * len(ROWS))(*ptrs[:len(ROWS)]),
                               ((_P * len(SLOT)) * 2)((_P * len(SLOT))(*ptrs[len(ROWS):len(ROWS) + len(SLOT)]),
                                                      (_P * len(SLOT))(*ptrs[len(ROWS) + len(SLOT):])))
        self._addr = ctypes.addressof(self._args)
        # a slot's pointers as the greedy step reads them, and the act step's three
        self._slot_in = tuple(tuple(p.data_ptr() for p in slot) for slot in slots)
        self._slot_act = tuple(ptrs[:3] for ptrs in self._slot_in)
        self._logits_key = (torch.float32, torch.Size((batch, self.num_actions)), device, True)
        self._noise = None  # the rollout's noise, kept alive while the rollout reads it
        self._in, self._out = None, 0
        self._stream = torch._C._cuda_getCurrentRawStream(device.index) if device.type == "cuda" else None

    def check_level(self, sem, bl, max_episode_steps) -> None:
        """Raise unless (sem, bl, max_episode_steps) are those the plan was built for."""
        if sem is not self.sem or bl is not self.bl or max_episode_steps != self.max_episode_steps:
            raise ValueError("this ActStepPlan was built for another semantics, level or time limit")

    def _source(self, state: FastState, reached=None) -> tuple[tuple[int, ...], int]:
        """(the state's pointers, the slot to write): one of the plan's own
        slots is read in place and the other written; the caller's tensors
        are checked once."""
        for k in (0, 1):
            if state is self.states[k] and reached is None:
                return self._slot_act[k], 1 - k
            if state is self.states[k] and reached is self.reached[k]:
                return self._slot_in[k], 1 - k
        b = self.batch
        ptrs = [check_tensor(name, x, torch.int32, (b,), self.device)
                for name, x in zip(SLOT, (state.agent_idx, state.agent_code, state.t))]
        if reached is not None:
            ptrs.append(check_tensor("done", state.done, torch.bool, (b,), self.device))
            ptrs.append(check_tensor("reached", reached, torch.bool, (b,), self.device))
        return tuple(ptrs), 0

    def _ready(self, logits) -> None:
        try:
            key = (logits.dtype, logits.shape, logits.device, logits.is_contiguous())
        except AttributeError:
            key = None
        if key != self._logits_key:
            check_tensor("logits", logits, torch.float32, (self.batch, self.num_actions), self.device)
        if self._stream is None:
            raise ValueError(f"K7b takes CUDA tensors, got {self.device}")
        if torch._C._cuda_getCurrentRawStream(self.device.index) != self._stream:
            raise RuntimeError("an ActStepPlan is stream-ordered: it was called from another stream than "
                               "the one it was built on")

    def begin(self, state: FastState, gumbel) -> None:
        """Start a rollout from `state` on the (T, B, A) float32 `gumbel`."""
        check_tensor("gumbel", gumbel, torch.float32, (self.rollout_len, self.batch, self.num_actions),
                     self.device)
        self._in, self._out = self._source(state)
        self._noise = gumbel
        self._args.gumbel = gumbel.data_ptr()

    def step(self, t: int, logits) -> FastState:
        """Rollout step `t` (see the class docstring) from the policy's
        (B, A) float32 logits: one launch. Returns the new state."""
        self._ready(logits)
        if not 0 <= t < self.rollout_len or self._in is None:
            raise ValueError(f"step {t} of a rollout of {self.rollout_len} not begun")
        out = self._out
        launch("gu_act_step", self.device, self._addr, t, logits.data_ptr(), *self._in, out)
        LAUNCHES["act_step"] += 1
        self._in, self._out = self._slot_act[out], 1 - out
        return self.states[out]

    def greedy(self, state: FastState, reached, logits) -> tuple[FastState, torch.Tensor]:
        """One greedy, freeze-on-done step (K7b's greedy form) from the
        (B, A) float32 logits: one launch. Returns the new state and
        `reached`."""
        self._ready(logits)
        src, out = self._source(state, reached)
        launch("gu_greedy_step", self.device, self._addr, logits.data_ptr(), *src, out)
        LAUNCHES["act_step"] += 1
        return self.states[out], self.reached[out]
