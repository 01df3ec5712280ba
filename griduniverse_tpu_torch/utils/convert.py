"""Carry objects of the JAX package across into the port.

Each function reads the fields of a reference object (a `Semantics`,
`Level`, `BitLevel`, `FastState` or `EnvState` of `griduniverse_tpu`, or
anything with the same attributes) as NumPy arrays and builds the port's
counterpart on `device`. Nothing here imports JAX: the reference's arrays
are converted with `numpy.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.semantics import Semantics
from ..core.types import EnvState, Level
from ..ops.bitplane import BitLevel, FastState


def _t(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def to_semantics(sem, *, device=None) -> Semantics:
    """Reference `Semantics` → port `Semantics`."""
    return Semantics(
        passable=_t(sem.passable, np.bool_, device),
        terminal=_t(sem.terminal, np.bool_, device),
        reward=_t(sem.reward, np.float32, device),
        deltas=_t(sem.deltas, np.int32, device),
    )


def to_level(level, *, device=None) -> Level:
    """Reference `Level`, shared (H, W) or batched (B, H, W) → port `Level`."""
    return Level(
        grid=_t(level.grid, np.int32, device),
        start_idx=_t(level.start_idx, np.int32, device),
    )


def to_bit_level(bl, *, device=None) -> BitLevel:
    """Reference `BitLevel` → port `BitLevel`; the `uint32` code words are
    viewed as `int32` with the same bits."""
    words = np.array(bl.code_words, dtype=np.uint32)  # a writable copy
    return BitLevel(
        code_words=torch.as_tensor(words.view(np.int32), device=device),
        start_idx=_t(bl.start_idx, np.int32, device),
        start_code=_t(bl.start_code, np.int32, device),
        height=int(bl.height),
        width=int(bl.width),
    )


def _batched(x, dtype, device) -> torch.Tensor:
    return _t(np.atleast_1d(np.asarray(x)), dtype, device)


def to_fast_state(state, *, device=None) -> FastState:
    """Reference `FastState` (scalar or (B,) fields) → port `FastState`."""
    return FastState(
        agent_idx=_batched(state.agent_idx, np.int32, device),
        agent_code=_batched(state.agent_code, np.int32, device),
        t=_batched(state.t, np.int32, device),
        done=_batched(state.done, np.bool_, device),
    )


def to_env_state(state, *, device=None) -> EnvState:
    """Reference `EnvState` (scalar or (B,) fields) → port `EnvState`; the
    PRNG key is dropped."""
    return EnvState(
        agent_idx=_batched(state.agent_idx, np.int32, device),
        t=_batched(state.t, np.int32, device),
        done=_batched(state.done, np.bool_, device),
    )
