"""Dense transition-model table — the functional `look_step_ahead`.

PyTorch counterpart of `griduniverse_tpu/core/model.py`: the whole model of
a shared level as dense (S, A) tensors, built by one batched call of the
core transition over every (state, action) pair.
"""

from __future__ import annotations

import dataclasses

import torch

from .semantics import Semantics
from .step import _move, tile_at
from .types import Level


@dataclasses.dataclass
class ModelTable:
    """Dense deterministic MDP model.

    next_state[s, a] — int32 successor index.
    reward[s, a]     — float32 reward for taking a in s.
    done[s, a]       — bool, successor is terminal.
    terminal[s]      — bool, s itself is terminal.
    """

    next_state: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    terminal: torch.Tensor

    @property
    def num_states(self) -> int:
        return int(self.next_state.shape[0])

    @property
    def num_actions(self) -> int:
        return int(self.next_state.shape[1])


def build_model_table(sem: Semantics, level: Level) -> ModelTable:
    """The core transition over all (s, a) of a shared level, in one call."""
    if level.batched:
        raise ValueError("build_model_table takes a shared (H, W) level")
    n, a = level.num_states, sem.num_actions
    dev = level.device
    states = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(a)
    actions = torch.arange(a, dtype=torch.int32, device=dev).repeat(n)
    next_state, reward, done = _move(sem, level, states, actions)
    all_states = torch.arange(n, dtype=torch.int32, device=dev)
    return ModelTable(
        next_state=next_state.reshape(n, a),
        reward=reward.reshape(n, a),
        done=done.reshape(n, a),
        terminal=sem.terminal[tile_at(level, all_states).long()],
    )
