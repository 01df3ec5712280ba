"""Carry objects of the JAX package across into the port.

Each function reads the fields of a reference object (a `Semantics`,
`Level`, `BitLevel`, `FastState`, `EnvState`, `ModelTable`, one of the
solvers' or trainers' (TD, PPO, A2C, DQN) train states, a flax parameter
tree or an optax Adam state of `griduniverse_tpu`, or anything with the same
attributes) as NumPy arrays and builds the port's counterpart on `device`
(default: the card). Nothing here imports JAX: the reference's arrays are
converted with `numpy.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algos.td import TDTrainState
from ..algos.td_batched import BatchedTDState
from ..algos.td_fast import FastTDTrainState
from ..core.model import ModelTable
from ..core.semantics import Semantics
from ..core.types import EnvState, Level
from ..models.a2c import A2CTrainState
from ..models.dqn import DQNTrainState, ReplayBuffer
from ..models.optim import AdamState
from ..models.ppo import PPOTrainState
from ..ops.bitplane import BitLevel, FastState, xorshift_init
from .platform import resolve_device


def _t(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=resolve_device(device))


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
        code_words=torch.as_tensor(words.view(np.int32), device=resolve_device(device)),
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


def to_model_table(model, *, device=None) -> ModelTable:
    """Reference `ModelTable`, (S, A) or batched (N, S, A) → port `ModelTable`."""
    return ModelTable(
        next_state=_t(model.next_state, np.int32, device),
        reward=_t(model.reward, np.float32, device),
        done=_t(model.done, np.bool_, device),
        terminal=_t(model.terminal, np.bool_, device),
    )


def _lanes(rs, device) -> torch.Tensor:
    """`uint32` xorshift lanes → `int32` with the same bits."""
    lanes = np.array(rs, dtype=np.uint32)
    return torch.as_tensor(lanes.view(np.int32), device=resolve_device(device))


def to_fast_td_state(ts, *, device=None) -> FastTDTrainState:
    """Reference `FastTDTrainState` → the port's: Q, env state, xorshift
    lanes and accumulators."""
    return FastTDTrainState(
        q=_t(ts.q, np.float32, device),
        env_state=to_fast_state(ts.env_state, device=device),
        rs=_lanes(ts.rs, device),
        step=int(ts.step),
        run_ret=_batched(ts.run_ret, np.float32, device),
        n_eps_env=_batched(ts.n_eps_env, np.int32, device),
        ret_sum_env=_batched(ts.ret_sum_env, np.float32, device),
    )


def _fresh_lanes(rs, seed, n, device) -> torch.Tensor:
    if rs is not None:
        return _lanes(rs, device)
    return xorshift_init(seed, (n,), device=device)


def to_batched_td_state(st, *, rs=None, seed: int = 0, device=None) -> BatchedTDState:
    """Reference `BatchedTDState` → the port's. The reference keys its
    draws by step and has no lanes: pass `rs`, or lanes are seeded from
    `seed`. Its pooled `episodes` and `ret_sum` go to maze 0's
    accumulators, so the pooled statistics carry on."""
    q = np.asarray(st.q)
    n = q.shape[0]
    q_t = torch.as_tensor(np.array(q, dtype=np.float32), device=resolve_device(device))
    if q.dtype != np.float32:  # bfloat16 tables stay bfloat16
        q_t = q_t.to(torch.bfloat16)
    n_eps_env = np.zeros(n, np.int32)
    ret_sum_env = np.zeros(n, np.float32)
    n_eps_env[0], ret_sum_env[0] = int(st.episodes), float(st.ret_sum)
    return BatchedTDState(
        q=q_t,
        env_state=to_fast_state(st.env_state, device=device),
        a=_batched(st.a, np.int32, device),
        rs=_fresh_lanes(rs, seed, n, device),
        run_ret=_batched(st.run_ret, np.float32, device),
        n_eps_env=_t(n_eps_env, np.int32, device),
        ret_sum_env=_t(ret_sum_env, np.float32, device),
        episodes=_t(st.episodes, np.int64, device),
        ret_sum=_t(st.ret_sum, np.float32, device),
        t=int(st.t),
    )


def to_td_state(ts, *, rs=None, seed: int = 0, device=None) -> TDTrainState:
    """Reference `TDTrainState` → the port's. The PRNG key is dropped: pass
    `rs`, or lanes are seeded from `seed`."""
    action = _batched(ts.action, np.int32, device)
    return TDTrainState(
        q=_t(ts.q, np.float32, device),
        env_state=to_env_state(ts.env_state, device=device),
        action=action,
        rs=_fresh_lanes(rs, seed, action.shape[0], device),
        step=int(ts.step),
        run_ret=_batched(ts.run_ret, np.float32, device),
        episodes=_t(ts.episodes, np.int64, device),
        ret_sum=_t(ts.ret_sum, np.float32, device),
    )


def to_network_state(params, net=None, *, device=None) -> dict[str, torch.Tensor]:
    """A flax parameter tree of one of the actor-critic networks (nested
    dicts of arrays, with or without the top-level "params") → the port
    module's `state_dict`: `embed`, `conv_0_kernel` and `conv_0_bias` keep
    their names, a Dense `kernel` (in, out) becomes `weight` (out, in), a
    conv kernel HWIO becomes OIHW. With `net`, the tensors go to its device
    and their names and shapes are checked against it."""
    if net is not None:
        device = next(net.parameters()).device
    tree = params["params"] if "params" in params else params
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            kernel = np.asarray(leaf["kernel"], dtype=np.float32)
            kernel = kernel.T if kernel.ndim == 2 else kernel.transpose(3, 2, 0, 1)
            out[f"{name}.weight"] = _t(kernel, np.float32, device)
            out[f"{name}.bias"] = _t(leaf["bias"], np.float32, device)
        elif name == "conv_0_kernel":
            out[name] = _t(np.asarray(leaf, dtype=np.float32).transpose(3, 2, 0, 1), np.float32, device)
        else:
            out[name] = _t(leaf, np.float32, device)
    if net is not None:
        want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in out.items()}
        if want != got:
            raise ValueError(f"parameter tree does not fit the network: {got} vs {want}")
        out = {k: out[k] for k in want}
    return out


def to_adam_state(opt_state, net=None, *, device=None) -> AdamState:
    """optax's state of `chain(clip_by_global_norm, adam(lr))`, that is
    `(EmptyState, (ScaleByAdamState(count, mu, nu), ...))`, → the port's
    `AdamState`. A schedule's own count equals Adam's and is dropped."""
    if net is not None:
        device = next(net.parameters()).device
    adam = next(s for s in opt_state[1] if hasattr(s, "mu"))
    return AdamState(
        count=_t(adam.count, np.int32, device),
        mu=to_network_state(adam.mu, net, device=device),
        nu=to_network_state(adam.nu, net, device=device),
    )


def _train_state_fields(ts, net, seed, device) -> dict:
    if net is not None:
        device = next(net.parameters()).device
    return dict(
        params=to_network_state(ts.params, net, device=device),
        opt_state=to_adam_state(ts.opt_state, net, device=device),
        env_state=to_fast_state(ts.env_state, device=device),
        seed=int(seed),
        update=int(ts.update),
        run_ret=_batched(ts.run_ret, np.float32, device),
        episodes=_t(ts.episodes, np.int64, device),
        ret_sum=_t(ts.ret_sum, np.float32, device),
        last_loss=_t(ts.last_loss, np.float32, device),
    )


def to_ppo_train_state(ts, net=None, *, seed: int = 0, device=None) -> PPOTrainState:
    """Reference `PPOTrainState` → the port's. The PRNG key is dropped: the
    port's draws come from `seed` (or are injected into `ppo_run`)."""
    return PPOTrainState(**_train_state_fields(ts, net, seed, device))


def to_a2c_train_state(ts, net=None, *, seed: int = 0, device=None) -> A2CTrainState:
    """Reference `A2CTrainState` → the port's; see `to_ppo_train_state`."""
    return A2CTrainState(**_train_state_fields(ts, net, seed, device))


def to_dqn_train_state(ts, net=None, *, seed: int = 0, device=None) -> DQNTrainState:
    """Reference `DQNTrainState` → the port's: parameters, target, Adam
    state, env state, the whole replay buffer, priorities, running maximum
    and counters. The PRNG key is dropped: the port's draws come from `seed`
    (or are injected into `dqn_run`)."""
    if net is not None:
        device = next(net.parameters()).device
    dtypes = (np.int32, np.int32, np.float32, np.int32, np.bool_)
    return DQNTrainState(
        params=to_network_state(ts.params, net, device=device),
        target_params=to_network_state(ts.target_params, net, device=device),
        opt_state=to_adam_state(ts.opt_state, net, device=device),
        env_state=to_fast_state(ts.env_state, device=device),
        buf=ReplayBuffer(*(_t(x, dt, device) for x, dt in zip(ts.buf, dtypes))),
        prio=_t(ts.prio, np.float32, device),
        p_max=_t(ts.p_max, np.float32, device),
        seed=int(seed),
        t=_t(ts.t, np.int32, device),
        run_ret=_batched(ts.run_ret, np.float32, device),
        episodes=_t(ts.episodes, np.int64, device),
        ret_sum=_t(ts.ret_sum, np.float32, device),
        last_loss=_t(ts.last_loss, np.float32, device),
    )
