"""Advantage actor-critic (A2C), env-batched, on one device or data-parallel
over the ranks of a `parallel.mesh.EnvMesh`.

PyTorch counterpart of `griduniverse_tpu/models/a2c.py`. One update is a T-step rollout of B
auto-reset envs on the bit-packed step, the bootstrapped n-step returns, one
forward and backward pass over the (T, B) batch, and one clipped Adam step.

The reference is one jitted scan; here, on the card, `a2c_run` is one
update captured in a CUDA graph and replayed (`utils/capture.py`): the
policy forward and one fused kernel a rollout step (K7b, `act_step`:
sample, log-prob, env step, behind a plan built once a run that writes the
trajectory in place), the return scan (K7a) and the network's passes (K9a
or K9b inside the network). Nothing in an update reads a device value on
the host. The plain version of the captured run, `_a2c_run_eager`, is the
host loop that enqueues every update; the sharded trainers run that loop.

Randomness is counter-based, as in the reference: a train state holds an
integer seed, and update `u` draws its Gumbel noise (T, B, A), all of it
before the rollout, from a generator seeded from (seed, u) alone. So a run
of 2N updates equals two runs of N from a saved state, bit for bit.
`a2c_run` also takes the noise as `gumbel=`, which is how the tests feed it
`jax.random`'s draws: `jax.random.categorical(key, logits)` is
`argmax(logits + gumbel(key, logits.shape))`.

The sharded trainers (`a2c_init_sharded`, `a2c_run_sharded`,
`a2c_train_sharded`, and PPO's and DQN's in their modules) run on every
rank of a process group, one rank a shard (`parallel.mesh`). Their train
state is the unsharded one laid out as the reference lays it out, each rank
holding its part: `params`, `opt_state`, `seed`, `update` / `t`,
`last_loss` (and DQN's target) replicated; `env_state` and `run_ret` (and
DQN's ring and priorities, `capacity / n` slots a rank) the rank's rows;
`episodes`, `ret_sum` (and DQN's `p_max`) one element a shard, (1,) on a
rank, summed only by `*_result`. Each rank runs the unsharded update on its
rows through its own plans (K7a, K7b, K9a, K9b; for DQN K7c's store form
into its ring, K8a, K8b); once a minibatch the flat gradients and the loss
are all-gathered in rank order, added in that order and divided by n
(`_rank_mean`), so clip, Adam and the target's move run alike and the
parameters are the same bits on every rank. A world of one without a
process group takes no collective. Randomness comes from (seed, shard,
update) — update `u` of shard k draws from `update_generator(device,
shard_seed(seed, k), u)`, the reference's `fold_in(fold_in(key, shard),
u)` — so chunked runs repeat; `gumbel=` / `draws=` inject the global draws,
of which each rank takes its slice. `gather_train_state` brings a rank's
state to the host whole (its sharded fields through
`parallel.distributed.fetch_global`), `reshard_stats` adapts such a state
to another world size, and a `*_run_sharded` given a state of host (numpy)
leaves takes this rank's part of it.

The kernels' plain PyTorch versions are here (`act_step_reference`,
`greedy_step_reference`, `nstep_returns_reference`); CPU tensors take them,
CUDA tensors launch the kernels, or raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from .. import kernels
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.act_step import ActStepPlan
from ..kernels.gae import nstep_returns_cuda
from ..ops.bitplane import BitLevel, FastState, pack_level, reset_bits, step_bits
from ..parallel.distributed import fetch_global
from ..parallel.mesh import EnvMesh, all_gather_rows, all_reduce_sum, env_axes, local_batch, shard_rows, tree_map
from ..parallel.rollout import local_level
from ..utils import capture
from .networks import ActorCritic, BatchedConvActorCritic, ConvActorCritic, exact_kernels
from .optim import AdamState, Params, adam_init, adam_update, clip_by_global_norm, make_lr


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    rollout_len: int = 16
    lr: float = 3e-4
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = None  # auto-reset time-limit truncation
    # Gridworld state spaces (a few thousand states at most) need no wide
    # trunk: the defaults keep the (B, hidden) activations small.
    hidden: tuple[int, ...] = (64, 64)
    embed_dim: int = 16
    # dtype of the matmuls and convs; parameters and losses stay float32
    # (models/networks.py). "float32" rounds nothing.
    compute_dtype: str = "bfloat16"
    # Observation encoding: "index" (embedding MLP) or "grid" (tile and
    # agent planes through a conv trunk; a shared level is baked into the
    # network, per-env levels enter at call time as tile planes).
    obs: str = "index"
    conv_channels: tuple[int, ...] = (32, 32)  # obs="grid" trunk widths
    # accepted as in the reference; both values run the same fused pass
    # (networks.BatchedConvActorCritic)
    agent_plane: str = "stamp"
    # Learning-rate schedule, see models/optim.py. Unit: A2C updates (one
    # Adam step each). A function of the Adam count in the optimizer state,
    # so chunked runs read the same rates.
    lr_schedule: str = "constant"
    lr_decay_updates: int | None = None
    lr_final_frac: float = 0.0


@dataclasses.dataclass
class A2CResult:
    params: Params
    episodes: torch.Tensor
    mean_return: torch.Tensor
    final_loss: torch.Tensor


def make_network(level: Level, num_actions: int, cfg, *, seed: int = 0,
                 families=(ActorCritic, ConvActorCritic, BatchedConvActorCritic)):
    """Build the policy network for `cfg.obs` on the level's device.

    obs='grid' with a batched (N, H, W) level gives the per-env-level trunk
    (`BatchedConvActorCritic`): the level enters at call time as tile
    planes, so one agent trains across N distinct mazes. `families` names
    the (index, shared-grid, per-env-grid) classes to build, for a caller
    that subclasses them (`models.dqn.make_q_network`)."""
    index_net, conv_net, batched_conv_net = families
    obs_mode = getattr(cfg, "obs", "index")
    cdt = getattr(cfg, "compute_dtype", "bfloat16")
    if obs_mode == "grid":
        channels = getattr(cfg, "conv_channels", (32, 32))
        if level.grid.dim() == 3:
            return batched_conv_net(
                height=level.height, width=level.width, num_actions=num_actions,
                channels=channels, hidden=cfg.hidden, compute_dtype=cdt,
                agent_plane=getattr(cfg, "agent_plane", "stamp"), seed=seed, device=level.device,
            )
        return conv_net(
            height=level.height, width=level.width, grid=level.grid.reshape(-1),
            num_actions=num_actions, channels=channels, hidden=cfg.hidden, compute_dtype=cdt,
            seed=seed, device=level.device,
        )
    if obs_mode != "index":
        raise ValueError(f"unknown obs mode: {obs_mode!r}")
    return index_net(
        num_states=level.num_states, num_actions=num_actions, hidden=cfg.hidden,
        embed_dim=cfg.embed_dim, compute_dtype=cdt, seed=seed, device=level.device,
    )


def _tiles_from_grids(net, grids):
    """Tile-code grids → the net's one-hot tile planes (the one place the
    grid → plane encoding lives)."""
    return F.one_hot(grids.long(), net.num_tile_types).to(net.cdt)


def _tiles_for(net, level: Level):
    """Per-env tile planes for a needs-tiles net (`BatchedConvActorCritic`);
    None for every other network. The env → level binding is fixed for a
    whole run, so the (N, H, W, C) planes are computed once per run."""
    if not getattr(net, "needs_tiles", False):
        return None
    return _tiles_from_grids(net, level.grid)


def init_network_params(net, seed: int) -> Params:
    """Fresh parameters for any network built by `make_network`, drawn from
    a generator seeded with `seed`: the way to get parameters outside a
    trainer, e.g. for an untrained baseline of
    `models.evaluation.greedy_success_rate`."""
    return _net_init(net, seed)


def _net_apply(net, params: Params, obs, tiles):
    """Uniform call across index, shared-grid and per-env-grid networks,
    with `params` in place of the module's own."""
    args = (obs,) if tiles is None else (obs, tiles)
    return functional_call(net, params, args)


def _net_init(net, seed: int) -> Params:
    device = next(net.parameters()).device
    return net.init_params(torch.Generator(device=device).manual_seed(int(seed)))


# ---------------------------------------------------------------------------
# K7b: sample, log-prob and env step, one launch a rollout step
# ---------------------------------------------------------------------------


def act_step_reference(sem, bl, state: FastState, logits, gumbel, max_episode_steps=None):
    """Plain PyTorch version of K7b: `a = argmax(logits + gumbel)` (first
    maximum), `logp = logits[a] − max − log Σ exp(logits − max)` in float32,
    the sum taken in index order as the kernel takes it (a library sum's
    order moves the log by more than 2 ulp at 25 actions), and one
    auto-reset `step_bits` with the optional time limit. Returns (new
    state, action int32, logp, obs int32, reward, done), each (B,); `obs`
    is the state the action was taken from."""
    a = torch.argmax(logits + gumbel, dim=-1)
    shifted = logits - logits.max(dim=-1, keepdim=True).values
    exps = torch.exp(shifted)
    total = exps[:, 0]
    for k in range(1, exps.shape[-1]):
        total = total + exps[:, k]
    logp = shifted.gather(-1, a[:, None])[:, 0] - torch.log(total)
    action = a.to(torch.int32)
    new_state, (_, reward, done) = step_bits(sem, bl, state, action, True, max_episode_steps)
    return new_state, action, logp, state.agent_idx, reward, done


def act_step(sem: Semantics, bl: BitLevel, state: FastState, logits, gumbel,
             max_episode_steps: int | None = None):
    """One rollout step for B envs from the policy's (B, A) float32 logits
    and pre-drawn Gumbel noise (K7b on CUDA, through a plan of one step
    built for the call): see `act_step_reference`. The kernel's `logp` goes
    through `expf`/`logf` and agrees with the plain version to 2 ulp;
    everything else is equal exactly. A rollout steps through one plan
    (`rollout`)."""
    if not kernels.on_cuda(logits, gumbel, state.agent_idx, bl.code_words, sem.deltas):
        return act_step_reference(sem, bl, state, logits, gumbel, max_episode_steps)
    plan = ActStepPlan(sem, bl, logits.shape[0], 1, max_episode_steps)
    plan.begin(state, gumbel.contiguous()[None])
    new_state = plan.step(0, logits.contiguous())
    obs, action, logp, reward, done = (row[0] for row in plan.rows)
    return new_state, action, logp, obs, reward, done


def greedy_step_reference(sem, bl, state: FastState, reached, logits):
    """Plain PyTorch version of K7b's greedy form: `a = argmax(logits)`, one
    freeze-on-done `step_bits`, and `reached | (done & reward > 0)`: the
    freeze mode emits a terminal's reward exactly once, so the flag fires
    only on the step that enters the goal."""
    a = torch.argmax(logits, dim=-1).to(torch.int32)
    state, (_, reward, done) = step_bits(sem, bl, state, a, False, None)
    return state, reached | (done & (reward > 0))


def greedy_step(sem: Semantics, bl: BitLevel, state: FastState, reached, logits,
                plan: ActStepPlan | None = None):
    """One greedy evaluation step for B envs (K7b's greedy form on CUDA).
    Returns (new state, updated `reached`). `plan`: K7b's host plan for
    (sem, bl, B), built once an evaluation (`models.evaluation`); without
    one a CUDA call builds its own, and what it returns is its own."""
    if plan is None:
        if not kernels.on_cuda(logits, reached, state.agent_idx, bl.code_words, sem.deltas):
            return greedy_step_reference(sem, bl, state, reached, logits)
        plan = ActStepPlan(sem, bl, logits.shape[0], 0, None)
    else:
        plan.check_level(sem, bl, None)
    return plan.greedy(state, reached, logits.contiguous())


# ---------------------------------------------------------------------------
# K7a: the n-step returns
# ---------------------------------------------------------------------------


def nstep_returns_reference(reward, done, bootstrap, gamma: float):
    """Plain PyTorch version of K7a's return scan: from t = T−1 down,
    `g = r + γ·(0 if done else g_next)`, starting from `bootstrap`."""
    g = bootstrap
    out = []
    for t in range(reward.shape[0] - 1, -1, -1):
        g = reward[t] + gamma * torch.where(done[t], 0.0, g)
        out.append(g)
    return torch.stack(out[::-1])


def nstep_returns(reward, done, bootstrap, gamma: float):
    """Bootstrapped n-step returns over a (T, B) rollout with episode ends
    (K7a on CUDA)."""
    if not kernels.on_cuda(reward, done, bootstrap):
        return nstep_returns_reference(reward, done, bootstrap, gamma)
    return nstep_returns_cuda(reward.contiguous(), done.contiguous(), bootstrap.contiguous(), gamma)


# ---------------------------------------------------------------------------
# What A2C and PPO share: noise, rollout, episode statistics
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def mix_seed(seed: int, update: int) -> int:
    """A 63-bit seed from (seed, update): one splitmix64 round of their mix.
    Update -1 is the parameters' initialisation."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(update) + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def update_generator(device, seed: int, update: int) -> torch.Generator:
    """The generator of update `update`, seeded from (seed, update) alone,
    so an update's draws do not depend on where a run was cut."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, update))


def draw_gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, `-log(-log(u))` with u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


@dataclasses.dataclass
class Trajectory:
    """One rollout, each field (T, B)."""

    obs: torch.Tensor      # int32 state indices the actions were taken from
    action: torch.Tensor   # int32
    logp: torch.Tensor     # behaviour log-prob of the action
    value: torch.Tensor    # V(s_t) under the behaviour parameters
    reward: torch.Tensor
    done: torch.Tensor     # bool


def rollout(sem, bl, net, params, tiles, env_state: FastState, gumbel, max_episode_steps,
            plan: ActStepPlan | None = None):
    """T policy steps of B auto-reset envs from pre-drawn (T, B, A) noise:
    a policy forward and one act-and-step a step. Returns (env state after
    the rollout, Trajectory, V of that state as the bootstrap). No
    gradients. On the card a step is one K7b launch through `plan`
    (`Learner.act_plan`; given none, one is built for the call) that
    writes its row of the trajectory in place, and the trajectory and the
    state are views of the plan's buffer, valid until its next rollout. On
    the CPU, the plain step a step and the rows stacked. The values are
    stacked either way."""
    if plan is None and kernels.on_cuda(env_state.agent_idx, bl.code_words, sem.deltas, gumbel):
        plan = ActStepPlan(sem, bl, gumbel.shape[1], gumbel.shape[0], max_episode_steps)
    with torch.no_grad():
        if plan is None:
            rows = []
            for g_t in gumbel:
                logits, value = _net_apply(net, params, env_state.agent_idx, tiles)
                env_state, action, logp, obs, reward, done = act_step_reference(
                    sem, bl, env_state, logits, g_t, max_episode_steps)
                rows.append((obs, action, logp, value, reward, done))
            traj = Trajectory(*(torch.stack(field) for field in zip(*rows)))
        else:
            plan.check_level(sem, bl, max_episode_steps)
            plan.begin(env_state, gumbel)
            values = []
            for t in range(gumbel.shape[0]):
                logits, value = _net_apply(net, params, env_state.agent_idx, tiles)
                env_state = plan.step(t, logits.contiguous())
                values.append(value)
            obs, action, logp, reward, done = plan.rows
            traj = Trajectory(obs, action, logp, torch.stack(values), reward, done)
        _, bootstrap = _net_apply(net, params, env_state.agent_idx, tiles)
    return env_state, traj, bootstrap


def fold_episode_stats(run_ret, episodes, ret_sum, reward, done):
    """The update's episode statistics from its (T, B) reward and done, in
    the reference's order per step: add the reward, count the ends, sum the
    returns of the envs that ended, clear them."""
    for r, d in zip(reward, done):
        run_ret = run_ret + r
        episodes = episodes + d.sum()
        ret_sum = ret_sum + torch.where(d, run_ret, 0.0).sum()
        run_ret = torch.where(d, 0.0, run_ret)
    return run_ret, episodes, ret_sum


def log_probs(logits, actions):
    """(log-softmax of the logits, its entry at `actions`); the entry is
    taken with a one-hot sum, as the reference does, which keeps scatters
    out of the backward."""
    logp_all = F.log_softmax(logits, dim=-1)
    picked = (logp_all * F.one_hot(actions.long(), logits.shape[-1])).sum(dim=-1)
    return logp_all, picked


def grads_of(loss, params: Params) -> Params:
    """d loss / d params, keyed as `params`; zeros for a parameter the loss
    does not reach."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}


def leaves(params: Params) -> Params:
    """The parameters as fresh autograd leaves (no copy)."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class A2CTrainState:
    """Full resumable A2C learner state. Per-update randomness comes from
    (seed, update), so training chunked at any update repeats an unbroken
    run bit for bit."""

    params: Params
    opt_state: AdamState
    env_state: FastState
    seed: int                # base seed (never consumed, only mixed)
    update: int              # global update counter
    run_ret: torch.Tensor    # (B,) running per-env episode returns
    episodes: torch.Tensor   # () int64
    ret_sum: torch.Tensor    # () float32
    last_loss: torch.Tensor  # () float32 most recent loss


def _a2c_rate(cfg: A2CConfig):
    # one A2C update is one Adam step, so the schedule's unit is updates
    return make_lr(cfg.lr, cfg.lr_schedule, cfg.lr_decay_updates, cfg.lr_final_frac, "lr_decay_updates")


def a2c_init(sem: Semantics, level: Level, seed: int, cfg: A2CConfig = A2CConfig(),
             batch_size: int = 256) -> A2CTrainState:
    """Build the initial resumable train state (see `A2CTrainState`)."""
    return A2CTrainState(**_init_fields(sem, level, seed, cfg, batch_size))


def _init_fields(sem, level, seed, cfg, batch_size) -> dict:
    net = make_network(level, sem.num_actions, cfg)
    params = _net_init(net, mix_seed(seed, -1))
    bl = pack_level(level)
    env_state = reset_bits(bl, None if bl.batched else batch_size)
    b = env_state.agent_idx.shape[0]
    dev = level.device
    return dict(
        params=params,
        opt_state=adam_init(params),
        env_state=env_state,
        seed=int(seed),
        update=0,
        run_ret=torch.zeros(b, dtype=torch.float32, device=dev),
        episodes=torch.zeros((), dtype=torch.int64, device=dev),
        ret_sum=torch.zeros((), dtype=torch.float32, device=dev),
        last_loss=torch.zeros((), dtype=torch.float32, device=dev),
    )


def a2c_loss(net, params, tiles, traj: Trajectory, returns, cfg: A2CConfig):
    """The A2C loss over a whole (T, B) rollout: policy gradient with the
    advantage `returns − V` held constant, value regression and an entropy
    bonus."""
    logits, values = _net_apply(net, params, traj.obs, tiles)
    logp_all, logp_a = log_probs(logits, traj.action)
    adv = (returns - values).detach()
    pg_loss = -(logp_a * adv).mean()
    vf_loss = ((returns - values) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()
    return pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * entropy


class Learner(NamedTuple):
    """What every update of a run shares, built once a run."""

    bl: BitLevel                 # the packed level
    net: torch.nn.Module
    tiles: torch.Tensor | None   # per-env tile planes of a needs-tiles net
    rate: Callable               # Adam count → learning rate
    act_plan: ActStepPlan | None  # K7b's host plan on the card; None on the CPU


def act_plan_for(sem: Semantics, level: Level, bl: BitLevel, cfg, batch: int) -> ActStepPlan | None:
    """K7b's plan for a run of `batch` envs on a level on the card; None on the CPU."""
    if level.device.type != "cuda":
        return None
    return ActStepPlan(sem, bl, batch, cfg.rollout_len, cfg.max_episode_steps)


def a2c_learner(sem: Semantics, level: Level, cfg: A2CConfig, batch: int) -> Learner:
    """What every update of a run of `batch` envs shares."""
    net = make_network(level, sem.num_actions, cfg)
    bl = pack_level(level)
    return Learner(bl, net, _tiles_for(net, level), _a2c_rate(cfg), act_plan_for(sem, level, bl, cfg, batch))


@dataclasses.dataclass
class A2CUpdate:
    """What one update gives: the learner's new tensors, and what it made
    on the way, so that a check can hold the kernels' own inputs and outputs
    against the plain versions. On the card `env_state` and `traj`'s obs,
    action, logp, reward and done are views of the learner's K7b plan
    (`rollout`): valid until the learner's next rollout, which writes them
    again; clone them to keep them past it."""

    params: Params
    opt_state: AdamState
    env_state: FastState
    loss: torch.Tensor
    traj: Trajectory
    bootstrap: torch.Tensor  # (B,) V of the state after the rollout
    returns: torch.Tensor    # (T, B) bootstrapped n-step returns


def a2c_update(sem: Semantics, learner: Learner, cfg: A2CConfig, params: Params,
               opt_state: AdamState, env_state: FastState, noise, pmean=None) -> A2CUpdate:
    """One A2C update from `noise` (T, B, A): the rollout, the n-step
    returns, one pass over the (T, B) batch and one clipped Adam step.
    `a2c_run` captures it, `_a2c_run_eager` loops over it, inside
    `exact_kernels()`. The update's `env_state` and trajectory rows are
    valid until the learner's next rollout (`A2CUpdate`). `pmean` (a sharded run's `_rank_mean`) takes the
    gradients and the loss to their means over the ranks before the clip."""
    bl, net, tiles, rate, act_plan = learner
    env_state, traj, bootstrap = rollout(
        sem, bl, net, params, tiles, env_state, noise, cfg.max_episode_steps, act_plan)
    returns = nstep_returns(traj.reward, traj.done, bootstrap, cfg.gamma)
    live = leaves(params)
    loss = a2c_loss(net, live, tiles, traj, returns, cfg)
    grads, loss = mean_grads(pmean, grads_of(loss, live), loss.detach())
    grads = clip_by_global_norm(grads, cfg.max_grad_norm)
    params, opt_state = adam_update(params, grads, opt_state, rate)
    return A2CUpdate(params, opt_state, env_state, loss, traj, bootstrap, returns)


def update_noise(device, seed: int, update: int, cfg, batch: int, num_actions: int):
    """The (T, B, A) Gumbel noise of update `update`, from a generator seeded
    from (seed, update) alone."""
    gen = update_generator(device, seed, update)
    return draw_gumbel(gen, (cfg.rollout_len, batch, num_actions), device)


def a2c_run(sem: Semantics, level: Level, ts: A2CTrainState, cfg: A2CConfig = A2CConfig(),
            num_updates: int = 500, *, gumbel=None) -> A2CTrainState:
    """Advance training by `num_updates`; chunk-invariant, bit for bit.
    `gumbel` (num_updates, T, B, A) replaces the state's own noise.

    On the card the run is one update captured in a CUDA graph and replayed
    `num_updates` times (`utils.capture.run`); on the CPU the same update
    runs eagerly over the same buffers. The plain version of the captured
    run is `_a2c_run_eager`."""
    dev = level.device
    b = ts.run_ret.shape[0]
    keys = list(ts.params)
    state = [x.clone() for x in _state_buffers(ts.params, ts.opt_state, ts.env_state, ts.run_ret, ts.episodes,
                                               ts.ret_sum, ts.last_loss)]

    def program() -> capture.Program:
        learner = a2c_learner(sem, level, cfg, b)

        def body(xs, gen, inputs):
            params, opt_state, env_state, (run_ret, episodes, ret_sum, _) = _state_from(keys, xs)
            noise = inputs[0] if gen is None else draw_gumbel(gen, (cfg.rollout_len, b, sem.num_actions), dev)
            upd = a2c_update(sem, learner, cfg, params, opt_state, env_state, noise)
            stats = fold_episode_stats(run_ret, episodes, ret_sum, upd.traj.reward, upd.traj.done)
            return _state_buffers(upd.params, upd.opt_state, upd.env_state, *stats, upd.loss)

        if gumbel is not None:
            return capture.Program(body, inputs=lambda i: [gumbel[i]])
        return capture.Program(body, seeds=lambda i: mix_seed(ts.seed, ts.update + i))

    return _run_onpolicy("a2c_run", ts, keys, state, program, num_updates)


def _run_onpolicy(name: str, ts, keys, state: list, program, num_updates: int):
    """`capture.run` of an A2C or PPO program over `state`, inside
    `exact_kernels()`, and the train state it ends in."""
    with exact_kernels():
        state = capture.run(name, state, program, num_updates)
    params, opt_state, env_state, (run_ret, episodes, ret_sum, loss) = _state_from(keys, state)
    return dataclasses.replace(ts, params=params, opt_state=opt_state, env_state=env_state,
                               update=ts.update + num_updates, run_ret=run_ret, episodes=episodes,
                               ret_sum=ret_sum, last_loss=loss)


def _a2c_run_eager(sem: Semantics, level: Level, ts: A2CTrainState, cfg: A2CConfig = A2CConfig(),
                   num_updates: int = 500, *, gumbel=None) -> A2CTrainState:
    """The plain version of `a2c_run`'s captured run: the same updates
    enqueued one after another from a host loop (`_a2c_updates_eager`),
    which a captured run equals bit for bit."""
    dev = level.device
    b = ts.run_ret.shape[0]
    learner = a2c_learner(sem, level, cfg, b)

    def noise(i):
        if gumbel is not None:
            return gumbel[i]
        return update_noise(dev, ts.seed, ts.update + i, cfg, b, sem.num_actions)

    return _a2c_updates_eager(sem, learner, cfg, ts, num_updates, noise)


def _a2c_updates_eager(sem, learner: Learner, cfg: A2CConfig, ts: A2CTrainState, num_updates: int, noise,
                       pmean=None) -> A2CTrainState:
    """`num_updates` A2C updates from `ts`, update i's noise `noise(i)`,
    from a host loop: the loop of `_a2c_run_eager` and `a2c_run_sharded`."""
    params, opt_state, env_state = ts.params, ts.opt_state, ts.env_state
    run_ret, episodes, ret_sum, loss = ts.run_ret, ts.episodes, ts.ret_sum, ts.last_loss
    with exact_kernels():
        for i in range(num_updates):
            upd = a2c_update(sem, learner, cfg, params, opt_state, env_state, noise(i), pmean)
            params, opt_state, env_state, loss = upd.params, upd.opt_state, upd.env_state, upd.loss
            run_ret, episodes, ret_sum = fold_episode_stats(
                run_ret, episodes, ret_sum, upd.traj.reward, upd.traj.done)
    return dataclasses.replace(
        ts, params=params, opt_state=opt_state, env_state=env_state,
        update=ts.update + num_updates, run_ret=run_ret, episodes=episodes, ret_sum=ret_sum,
        last_loss=loss,
    )


def _state_buffers(params: Params, opt_state: AdamState, env_state: FastState, *rest) -> list:
    """A train state's tensors as one list, the order `_state_from` reads:
    the parameters, Adam's count and moments, the env state, then `rest`."""
    return [*params.values(), opt_state.count, *opt_state.mu.values(), *opt_state.nu.values(),
            env_state.agent_idx, env_state.agent_code, env_state.t, env_state.done, *rest]


def _state_from(keys, xs) -> tuple:
    """(params, opt_state, env_state, rest) of a `_state_buffers` list whose
    parameters are keyed by `keys`."""
    n = len(keys)
    params = dict(zip(keys, xs[:n]))
    opt_state = AdamState(count=xs[n], mu=dict(zip(keys, xs[n + 1:2 * n + 1])),
                          nu=dict(zip(keys, xs[2 * n + 1:3 * n + 1])))
    return params, opt_state, FastState(*xs[3 * n + 1:3 * n + 5]), list(xs[3 * n + 5:])


def a2c_result(ts: A2CTrainState) -> A2CResult:
    """Train state → A2CResult. Works for the single-device (scalar stats)
    and the gathered sharded ((n,) per-shard stats) layouts: the stats are
    summed here, never inside the resumable state."""
    episodes = ts.episodes.sum()
    return A2CResult(
        params=ts.params,
        episodes=episodes,
        mean_return=ts.ret_sum.sum() / episodes.clamp(min=1),
        final_loss=ts.last_loss,
    )


def a2c_train(sem: Semantics, level: Level, seed: int, cfg: A2CConfig = A2CConfig(),
              num_updates: int = 500, batch_size: int = 256) -> A2CResult:
    """A2C on one device, on the level's device: `a2c_init`, `a2c_run`,
    `a2c_result`."""
    ts = a2c_init(sem, level, seed, cfg, batch_size)
    return a2c_result(a2c_run(sem, level, ts, cfg, num_updates))


# ---------------------------------------------------------------------------
# Sharded training: data parallel over the ranks of an EnvMesh
# ---------------------------------------------------------------------------

# the train-state fields a rank holds its part of; the others are replicated
SHARDED_FIELDS = ("env_state", "run_ret", "episodes", "ret_sum", "buf", "prio", "p_max")


def _level_specs(bl: BitLevel, batch_size: int, mesh: EnvMesh) -> BitLevel:
    """The packed level a rank steps, the reference's shard_map in_specs of
    a BitLevel: a shared level whole; a batched one's per-env leaves its
    rows, its 0-d leaves whole. Raises where a batched level does not hold
    `batch_size` levels."""
    if not bl.batched:
        return bl
    if int(bl.code_words.shape[0]) != batch_size:
        raise ValueError(
            f"batched BitLevel has {int(bl.code_words.shape[0])} levels; expected batch_size={batch_size}"
        )
    rows = shard_rows(mesh, batch_size)
    start_idx, start_code = (x if x.dim() == 0 else x[rows] for x in (bl.start_idx, bl.start_code))
    return BitLevel(bl.code_words[rows], start_idx, start_code, bl.height, bl.width)


def _sharded_env_specs(mesh: EnvMesh, bl: BitLevel, batch_size: int):
    """The env-sharded layout every sharded trainer uses: (axes, local_b,
    rows, the rank's BitLevel). Raises where the mesh does not divide the
    batch. `rows` also lays out the (n,) per-shard statistics, one element
    a shard in rank order."""
    local_b = local_batch(mesh, batch_size)
    return env_axes(mesh), local_b, shard_rows(mesh, batch_size), _level_specs(bl, batch_size, mesh)


def shard_seed(seed: int, shard: int) -> int:
    """The base seed of shard `shard`'s draws (the reference's
    `fold_in(key, shard)`): `mix_seed(seed, -2 - shard)`, apart from every
    update's (≥ 0) and the parameters' (-1)."""
    return mix_seed(seed, -2 - int(shard))


def _rank_mean(mesh: EnvMesh):
    """None where there is nothing to reduce (a world of one without a
    process group); else a function taking a list of float32 tensors to
    their means over the ranks: flattened into one vector, all-gathered,
    added in rank order and divided by n, the same bits on every rank. Each
    mean comes back as a tensor of its own: a reduction over a view at an
    unaligned offset of the vector may add in another order than over a
    fresh tensor, and a world of one must give the unsharded bits."""
    if mesh.group is None:
        return None

    def mean(xs):
        flat = all_reduce_sum(mesh, torch.cat([x.reshape(-1) for x in xs])) / mesh.size
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].reshape(x.shape).clone())
            at += x.numel()
        return out

    return mean


def mean_grads(pmean, grads: Params, *scalars):
    """(grads, *scalars), each taken to its mean over the ranks by `pmean`
    in one collective; as they are where `pmean` is None."""
    if pmean is None:
        return (grads, *scalars)
    flat = pmean([*grads.values(), *scalars])
    return (dict(zip(grads, flat[:len(grads)])), *flat[len(grads):])


def _host(x):
    return x.detach().cpu().numpy()


def gather_train_state(mesh: EnvMesh, ts):
    """A rank's part of a sharded train state (A2C, PPO or DQN) as the whole
    state on the host, on every rank: the sharded fields gathered in rank
    order (`parallel.distributed.fetch_global`), the replicated ones as
    this rank holds them, every tensor a numpy array. What a checkpoint of
    the global state holds, what `reshard_stats` takes, and what a
    `*_run_sharded` on another world takes its part of."""
    out = {}
    for f in dataclasses.fields(ts):
        x = getattr(ts, f.name)
        out[f.name] = fetch_global(mesh, x) if f.name in SHARDED_FIELDS else tree_map(_host, x)
    return dataclasses.replace(ts, **out)


def _local_state(mesh: EnvMesh, ts):
    """This rank's part of a train state: a state of host (numpy) leaves is
    the global one (`gather_train_state`, `reshard_stats`), and the rank
    takes its rows of the sharded fields and the replicated ones whole, on
    its device; any other state is already a rank's and is kept."""
    if not isinstance(ts.run_ret, np.ndarray):
        return ts
    dev = mesh.device

    def rows(x):
        n = x.shape[0] // mesh.size
        return torch.as_tensor(np.array(x[mesh.rank * n:(mesh.rank + 1) * n]), device=dev)

    def whole(x):
        return torch.as_tensor(np.array(x), device=dev)

    return dataclasses.replace(ts, **{
        f.name: tree_map(rows if f.name in SHARDED_FIELDS else whole, getattr(ts, f.name), np.ndarray)
        for f in dataclasses.fields(ts)
    })


def _result_sharded(mesh: EnvMesh, ts, result):
    """`result` of a rank's sharded state with its per-shard statistics
    gathered in rank order: the same global result on every rank."""
    return result(dataclasses.replace(
        ts, episodes=all_gather_rows(mesh, ts.episodes), ret_sum=all_gather_rows(mesh, ts.ret_sum)))


def reshard_stats(ts, mesh: EnvMesh):
    """Adapt a whole sharded train state (PPO, A2C or DQN; as
    `gather_train_state` gives it, or restored from its checkpoint) saved
    on one world size to the world of `mesh`: the elastic resume of the
    data-parallel trainers (the reference's `models/a2c.py:574-664`).

    Everything global survives untouched: parameters, optimizer moments,
    the target network, the env batch and the replay ring (global (B,) and
    (capacity,) arrays, which the new world's ranks take their rows of;
    B and the capacity must divide by the new size), the seed and the
    counter. The (n,) per-shard accumulators are rebucketed:
      * episodes / ret_sum — the totals moved to shard 0, zeros elsewhere:
        the global totals `*_result` reads are kept exactly;
      * p_max (DQN with PER) — the global maximum on every new shard.
    Not bit-exact against staying on the old world: shard k draws from
    `shard_seed(seed, k)`, so another world draws other streams.

    DQN: the ring must be FULL (`t·B >= capacity`), else this raises — a
    shard's valid region is derived from t alone, and a partly filled ring
    would expose never-written slots on the new world. Index observations
    only (a per-env-level grid network recovers a slot's env as `slot %
    B_local`, which a new world permutes); and the new write offset
    overwrites a rotation of the old FIFO order.

    Returns the state with host (numpy) leaves, as the reference does: the
    next `*_run_sharded` on the new world takes each rank's part of it."""
    ts = tree_map(_host, ts)
    n_new = mesh.size
    batch = int(np.shape(ts.run_ret)[0])
    if batch % n_new:
        raise ValueError(
            f"env batch {batch} not divisible by the new mesh size {n_new}; elastic resume needs every global "
            f"(B,) leaf to reshard evenly"
        )
    if hasattr(ts, "buf"):
        cap = int(np.shape(ts.buf.obs)[0])
        if cap % n_new:
            raise ValueError(f"replay capacity {cap} not divisible by the new mesh size {n_new}")
        if int(ts.t) * batch < cap:
            raise ValueError(
                f"DQN elastic resume requires a FULL replay buffer: t*B = {int(ts.t) * batch} < capacity {cap}. "
                "A partially-filled buffer's valid region is derived per-shard from t and would cover "
                "never-written slots on the new mesh (see reshard_stats docstring). Run more steps on the old "
                "mesh first."
            )
    eps = np.zeros((n_new,), np.asarray(ts.episodes).dtype)
    eps[0] = np.sum(ts.episodes)
    rets = np.zeros((n_new,), np.asarray(ts.ret_sum).dtype)
    rets[0] = np.sum(ts.ret_sum)
    ts = dataclasses.replace(ts, episodes=eps, ret_sum=rets)
    if hasattr(ts, "p_max"):
        ts = dataclasses.replace(ts, p_max=np.full((n_new,), np.max(ts.p_max), np.asarray(ts.p_max).dtype))
    return ts


def _sharded_init(mesh: EnvMesh, level: Level, batch_size: int, init):
    """This rank's part of an initial sharded train state: the unsharded
    `init(level, batch)` over the rank's B / n envs (its rows of a per-env
    level) on the mesh's device — the parameters and optimizer are the
    unsharded init's, the same on every rank — with its statistics (and
    DQN's `p_max`) made (1,) per-shard values."""
    level = level.to(mesh.device)
    _, local_b, _, _ = _sharded_env_specs(mesh, pack_level(level), batch_size)
    ts = init(local_level(mesh, level, batch_size), local_b)
    per_shard = {f: getattr(ts, f).reshape(1) for f in ("episodes", "ret_sum", "p_max") if hasattr(ts, f)}
    return dataclasses.replace(ts, **per_shard)


def _warm_started(mesh: EnvMesh, ts, init_params, init_opt_state):
    """`ts` with saved parameters (and a DQN target that restarts as their
    copy) and, where given, a saved optimizer state, on the mesh's device."""
    if init_params is not None:
        ts.params = {k: v.to(mesh.device) for k, v in init_params.items()}
        if hasattr(ts, "target_params"):
            ts.target_params = {k: v.clone() for k, v in ts.params.items()}
    if init_opt_state is not None:
        ts.opt_state = tree_map(lambda x: x.to(mesh.device), init_opt_state)
    return ts


def _sharded_run_setup(mesh: EnvMesh, level: Level, ts):
    """(this rank's state, the level on its device, the global batch, this
    rank's rows, its level) of a `*_run_sharded` call."""
    ts = _local_state(mesh, ts)
    level = level.to(mesh.device)
    batch = int(ts.run_ret.shape[0]) * mesh.size
    _, _, rows, _ = _sharded_env_specs(mesh, pack_level(level), batch)
    return ts, level, batch, rows, local_level(mesh, level, batch)


def _rank_noise(x, rows, device):
    """This rank's columns (axis 1) of an injected (T, B, ...) draw, as a
    contiguous tensor on `device` (the kernels' plans take no views)."""
    return x[:, rows].to(device).contiguous()


def a2c_init_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: A2CConfig = A2CConfig(),
                     batch_size: int = 256) -> A2CTrainState:
    """This rank's part of the initial sharded train state (module
    docstring), on the mesh's device: the unsharded init's parameters and
    optimizer, replicated; the rank's B / n envs; (1,) per-shard stats."""
    return _sharded_init(mesh, level, batch_size, lambda lvl, b: a2c_init(sem, lvl, seed, cfg, b))


def a2c_run_sharded(mesh: EnvMesh, sem: Semantics, level: Level, ts: A2CTrainState,
                    cfg: A2CConfig = A2CConfig(), num_updates: int = 500, *, gumbel=None) -> A2CTrainState:
    """Advance sharded training by `num_updates` on this rank, carrying the
    whole state: run(2N) equals run(N), a checkpoint, a restore and run(N)
    bit for bit on a fixed world. Shard k's update u draws from (seed, k,
    u); `gumbel` (num_updates, T, B, A) injects the global noise, of which
    the rank takes its columns. A state of host leaves is the global one
    (`_local_state`)."""
    ts, level, batch, rows, lvl = _sharded_run_setup(mesh, level, ts)
    local_b = rows.stop - rows.start
    learner = a2c_learner(sem, lvl, cfg, local_b)
    seed = shard_seed(ts.seed, mesh.rank)

    def noise(i):
        if gumbel is not None:
            return _rank_noise(gumbel[i], rows, mesh.device)
        return update_noise(mesh.device, seed, ts.update + i, cfg, local_b, sem.num_actions)

    return _a2c_updates_eager(sem, learner, cfg, ts, num_updates, noise, _rank_mean(mesh))


def a2c_train_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: A2CConfig = A2CConfig(),
                      num_updates: int = 500, batch_size: int = 256, init_params=None,
                      init_opt_state=None) -> A2CResult:
    """Data-parallel A2C: envs sharded over the ranks, parameters
    replicated, gradients averaged over the ranks once an update.
    `a2c_init_sharded`, `a2c_run_sharded` and the result, the same on every
    rank. `init_params` / `init_opt_state` warm-start from saved parameters
    (fresh envs; a fresh optimizer unless `init_opt_state` is given)."""
    ts = _warm_started(mesh, a2c_init_sharded(mesh, sem, level, seed, cfg, batch_size), init_params, init_opt_state)
    return _result_sharded(mesh, a2c_run_sharded(mesh, sem, level, ts, cfg, num_updates), a2c_result)


def greedy_actions(net, params: Params, obs, tiles=None):
    logits, _ = _net_apply(net, params, obs, tiles)
    return torch.argmax(logits, dim=-1).to(torch.int32)
