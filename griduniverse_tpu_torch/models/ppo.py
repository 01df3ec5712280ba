"""Proximal policy optimization (PPO), env-batched, on one device or
data-parallel over the ranks of a `parallel.mesh.EnvMesh`.

PyTorch counterpart of `griduniverse_tpu/models/ppo.py`. It shares A2C's machinery
(models/a2c.py): the bit-packed env step, the three network families, the
counter-based randomness.

  update = T-step rollout of B auto-reset envs, log-prob and value recorded
           (a policy forward and one K7b launch a step, writing the
           trajectory in place through a plan built once a run)
         → GAE(λ) advantages by one reverse scan (K7a)
         → E epochs × M minibatches of clipped-surrogate SGD

On the card `ppo_run` is one update captured in a CUDA graph and replayed
(`utils/capture.py`); nothing in an update reads a device value on the
host, the `target_kl` stop included. The plain version of the captured
run, `_ppo_run_eager`, is the host loop that enqueues every update; the
sharded trainers run that loop. Update `u` draws from a generator seeded
from (seed, u) alone, in a fixed order: the rollout's Gumbel noise
(T, B, A), then one shuffle draw per epoch. So a run of 2N updates equals
two runs of N from a saved state, bit for bit. `ppo_run` also takes the
draws as `gumbel=` and `shuffle_draws=` tensors.

The sharded trainers (`ppo_init_sharded`, `ppo_run_sharded`,
`ppo_train_sharded`) follow `models/a2c.py`'s layout and reductions: a
rank shuffles and cuts its own rows; the gradients, the loss and the
approximate KL of every minibatch are averaged over the ranks (so the
`target_kl` stop is taken in lockstep), and with `normalize_adv` the mean
and the standard deviation of the advantages too (the mean of the ranks'
deviations, as the reference's `pmean`). Their injected `shuffle_draws`
hold every shard's draws: each epoch's draw cut into n equal parts along
its last axis, shard k's the k-th (a "roll" offset (n,), an "env"
permutation (B,) of n local permutations, an "element" one (n·T·B/n,)).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.gae import gae_cuda
from ..ops.bitplane import FastState, pack_level
from ..parallel.mesh import EnvMesh
from ..utils import capture
from .a2c import (
    Learner,
    Trajectory,
    _init_fields,
    _net_apply,
    _rank_mean,
    _rank_noise,
    _result_sharded,
    _run_onpolicy,
    _sharded_init,
    _sharded_run_setup,
    _state_buffers,
    _state_from,
    _tiles_for,
    _warm_started,
    act_plan_for,
    draw_gumbel,
    fold_episode_stats,
    grads_of,
    leaves,
    log_probs,
    make_network,
    mean_grads,
    mix_seed,
    rollout,
    shard_seed,
    update_generator,
)
from .networks import exact_kernels
from .optim import AdamState, Params, adam_update, clip_by_global_norm, keep_where, make_lr

SHUFFLES = ("env", "element", "roll", "none")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_len: int = 16
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = None  # auto-reset time-limit truncation
    num_epochs: int = 4
    num_minibatches: int = 4
    normalize_adv: bool = True
    # Optional regularizers:
    #   vf_clip_eps — clip the value update around the behaviour value (the
    #     pessimistic max of the clipped and unclipped value losses).
    #   target_kl — once the (k3) approximate KL exceeds 1.5×target_kl, the
    #     remaining minibatch steps of this update are frozen: parameters
    #     and optimizer state, count included, chosen with `torch.where`, no
    #     branch on the host.
    vf_clip_eps: float | None = None
    target_kl: float | None = None
    # Epoch shuffle, by what it permutes:
    #   "element": a flat permutation of the T·B samples.
    #   "env": a permutation of the env axis; a minibatch is an env block.
    #     Envs are iid, so this is the same minibatching with B indices
    #     instead of T·B.
    #   "roll" (default): rotate the env axis by one random offset per
    #     epoch. Envs are exchangeable, so a contiguous block after the
    #     rotation is distributed as a random subset.
    #   "none": fixed contiguous env blocks, the same in every epoch.
    shuffle: str = "roll"
    hidden: tuple[int, ...] = (64, 64)
    embed_dim: int = 16
    compute_dtype: str = "bfloat16"  # see A2CConfig.compute_dtype
    obs: str = "index"               # see A2CConfig.obs
    conv_channels: tuple[int, ...] = (32, 32)
    agent_plane: str = "stamp"       # see A2CConfig.agent_plane
    # Learning-rate schedule: "constant" or "linear", from lr to
    # lr·lr_final_frac over lr_decay_updates PPO updates (required for
    # "linear"; later steps hold the final rate). A function of the Adam
    # count in the optimizer state, so chunked runs read the same rates.
    lr_schedule: str = "constant"
    lr_decay_updates: int | None = None
    lr_final_frac: float = 0.0


@dataclasses.dataclass
class PPOResult:
    params: Params
    episodes: torch.Tensor
    mean_return: torch.Tensor
    final_loss: torch.Tensor


@dataclasses.dataclass
class PPOTrainState:
    """Full resumable PPO learner state. Per-update randomness comes from
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
    last_loss: torch.Tensor  # () float32: last minibatch of the last epoch


def gae_advantages_reference(traj, bootstrap, gamma: float, lam: float):
    """Plain PyTorch version of K7a's GAE scan, from t = T−1 down:
    `delta = r + γ·v_next·nd − v`, `adv = delta + γλ·nd·adv_next` with
    nd = 1 − done, each product and sum rounded once."""
    adv = torch.zeros_like(bootstrap)
    v_next = bootstrap
    out = []
    for t in range(traj.value.shape[0] - 1, -1, -1):
        v = traj.value[t]
        notdone = 1.0 - traj.done[t].to(torch.float32)
        delta = traj.reward[t] + gamma * v_next * notdone - v
        adv = delta + gamma * lam * notdone * adv
        out.append(adv)
        v_next = v
    adv = torch.stack(out[::-1])
    return adv, adv + traj.value


def gae_advantages(traj, bootstrap, gamma: float, lam: float):
    """GAE(λ) by one reverse scan (K7a on CUDA). `traj` has (T, B) `value`,
    `reward` and `done`; `bootstrap` is V of the state after the rollout.
    An episode's end zeroes both the bootstrap and the advantage carry.
    Returns (advantages, value targets), (T, B)."""
    if not kernels.on_cuda(traj.value, traj.reward, traj.done, bootstrap):
        return gae_advantages_reference(traj, bootstrap, gamma, lam)
    return gae_cuda(traj.value.contiguous(), traj.reward.contiguous(), traj.done.contiguous(),
                    bootstrap.contiguous(), gamma, lam)


def ppo_loss(net, params, mb, mb_tiles, cfg: PPOConfig):
    """(loss, k3 approximate KL) of one minibatch `mb` = (obs, actions,
    behaviour logp, behaviour value, advantages, value targets)."""
    obs, actions, logp_old, v_old, adv, targets = mb
    logits, values = _net_apply(net, params, obs, mb_tiles)
    logp_all, logp = log_probs(logits, actions)
    log_ratio = logp - logp_old
    ratio = torch.exp(log_ratio)
    pg = -torch.minimum(ratio * adv, ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    if cfg.vf_clip_eps is not None:
        v_clip = v_old + (values - v_old).clamp(-cfg.vf_clip_eps, cfg.vf_clip_eps)
        vf = torch.maximum((targets - values) ** 2, (targets - v_clip) ** 2).mean()
    else:
        vf = ((targets - values) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()
    # k3 estimator of KL(old ‖ new): E[(r − 1) − log r] ≥ 0, low variance
    approx_kl = ((ratio - 1.0) - log_ratio).mean()
    return pg + cfg.vf_coef * vf - cfg.ent_coef * entropy, approx_kl


def _check(cfg: PPOConfig, batch: int, tiles) -> None:
    if tiles is not None and cfg.shuffle not in ("roll", "none"):
        raise ValueError(
            "per-env-level grid observations require shuffle='roll' (or 'none'): 'element'/'env' "
            "permutations would need the tile planes gathered per sample, while a roll keeps "
            "minibatches as contiguous env blocks whose planes roll along with the trajectory"
        )
    n_flat = cfg.rollout_len * batch
    if n_flat % cfg.num_minibatches:
        raise ValueError(
            f"rollout_len*batch ({n_flat}) not divisible by num_minibatches ({cfg.num_minibatches})")
    if cfg.shuffle not in SHUFFLES:
        raise ValueError(f"unknown shuffle mode: {cfg.shuffle!r}")
    if cfg.shuffle in ("env", "roll", "none") and batch % cfg.num_minibatches:
        raise ValueError(
            f"shuffle={cfg.shuffle!r} needs batch ({batch}) divisible by "
            f"num_minibatches ({cfg.num_minibatches})")


def shuffle_draw(generator, cfg: PPOConfig, batch: int, device):
    """One epoch's shuffle draw: a () offset in [0, B) for "roll", a
    permutation of B for "env", of T·B for "element", None for "none"."""
    if cfg.shuffle == "roll":
        return torch.randint(0, batch, (), generator=generator, device=device)
    if cfg.shuffle == "env":
        return torch.randperm(batch, generator=generator, device=device)
    if cfg.shuffle == "element":
        return torch.randperm(cfg.rollout_len * batch, generator=generator, device=device)
    return None


def _minibatches(slab, tiles, draw, cfg: PPOConfig, batch: int):
    """Cut the (T, B) slab into M minibatches by this epoch's draw. Returns
    (list of M tuples, list of M tile blocks or Nones). Without tiles a
    minibatch is flat (T·B/M,); with tiles it keeps its (T, B/M) env
    structure and its tile planes are the same env block."""
    m, t = cfg.num_minibatches, cfg.rollout_len
    if cfg.shuffle == "element":
        cut = [x.reshape(-1)[draw].reshape(m, -1) for x in slab]
        return list(zip(*cut)), [None] * m
    if cfg.shuffle == "none":
        columns = None
    elif cfg.shuffle == "roll":  # column i of the rolled slab is column (i + off) mod B
        columns = (torch.arange(batch, device=draw.device) + draw) % batch
    else:
        columns = draw
    b_mb = batch // m

    def blocks(x):  # (T, B) → (M, T, B/M)
        x = x if columns is None else x[:, columns]
        return x.reshape(t, m, b_mb).permute(1, 0, 2)

    if tiles is not None:
        planes = tiles if columns is None else tiles[columns]
        cut = [blocks(x) for x in slab]
        return list(zip(*cut)), list(planes.reshape(m, b_mb, *tiles.shape[1:]))
    cut = [blocks(x).reshape(m, -1) for x in slab]
    return list(zip(*cut)), [None] * m


def _rate(cfg: PPOConfig):
    # one PPO update is num_epochs·num_minibatches Adam steps
    steps = None if cfg.lr_decay_updates is None else (
        cfg.lr_decay_updates * cfg.num_epochs * cfg.num_minibatches)
    return make_lr(cfg.lr, cfg.lr_schedule, steps, cfg.lr_final_frac, "lr_decay_updates")


def ppo_init(sem: Semantics, level: Level, seed: int, cfg: PPOConfig = PPOConfig(),
             batch_size: int = 256) -> PPOTrainState:
    """Build the initial resumable train state (see `PPOTrainState`)."""
    return PPOTrainState(**_init_fields(sem, level, seed, cfg, batch_size))


def update_draws(device, seed: int, update: int, cfg: PPOConfig, batch: int, num_actions: int,
                 *, gumbel=None, shuffle=None):
    """The draws of update `update`, from a generator seeded from (seed,
    update) alone, in a fixed order: the rollout's (T, B, A) Gumbel noise,
    then one shuffle draw per epoch. An injected `gumbel` or `shuffle` (one
    draw per epoch) takes the place of its draws. Returns (noise, draws)."""
    return _draws_from(update_generator(device, seed, update), device, cfg, batch, num_actions, gumbel, shuffle)


def _draws_from(gen, device, cfg: PPOConfig, batch: int, num_actions: int, gumbel, shuffle):
    """`update_draws` from the generator `gen`, seeded for the update."""
    if gumbel is None:
        gumbel = draw_gumbel(gen, (cfg.rollout_len, batch, num_actions), device)
    if shuffle is None:
        shuffle = [shuffle_draw(gen, cfg, batch, device) for _ in range(cfg.num_epochs)]
    return gumbel, shuffle


@dataclasses.dataclass
class PPOUpdate:
    """What one update gives: the learner's new tensors, and what it made
    on the way, so that a check can hold the kernels' own inputs and outputs
    against the plain versions. On the card `env_state` and `traj`'s obs,
    action, logp, reward and done are views of the learner's K7b plan
    (`a2c.rollout`): valid until the learner's next rollout, which writes
    them again; clone them to keep them past it."""

    params: Params
    opt_state: AdamState
    env_state: FastState
    loss: torch.Tensor       # last minibatch of the last epoch
    traj: Trajectory
    bootstrap: torch.Tensor  # (B,) V of the state after the rollout
    adv: torch.Tensor        # (T, B) GAE's advantages, before normalisation
    targets: torch.Tensor    # (T, B) value targets
    first_minibatch: tuple   # (minibatch, its tile block or None) of the first epoch


def ppo_learner(sem: Semantics, level: Level, cfg: PPOConfig, batch: int) -> Learner:
    """What every update of a run shares; raises on a `cfg` that `batch`
    envs cannot be cut by."""
    net = make_network(level, sem.num_actions, cfg)
    tiles = _tiles_for(net, level)
    _check(cfg, batch, tiles)
    bl = pack_level(level)
    return Learner(bl, net, tiles, _rate(cfg), act_plan_for(sem, level, bl, cfg, batch))


def ppo_update(sem: Semantics, learner: Learner, cfg: PPOConfig, params: Params,
               opt_state: AdamState, env_state: FastState, noise, draws, pmean=None) -> PPOUpdate:
    """One PPO update from `noise` (T, B, A) and one shuffle draw per epoch
    (`update_draws`): the rollout, GAE, and E epochs × M minibatches of
    clipped-surrogate SGD. `ppo_run` captures it, `_ppo_run_eager` loops
    over it, inside `exact_kernels()`. The update's `env_state` and
    trajectory rows are valid until the learner's next rollout (`PPOUpdate`). `pmean` (a
    sharded run's `_rank_mean`) takes the advantages' mean and deviation,
    and each minibatch's gradients, loss and KL, to their means over the
    ranks."""
    bl, net, tiles, rate, act_plan = learner
    b = env_state.agent_idx.shape[0]
    env_state, traj, bootstrap = rollout(
        sem, bl, net, params, tiles, env_state, noise, cfg.max_episode_steps, act_plan)
    gae_adv, targets = gae_advantages(traj, bootstrap, cfg.gamma, cfg.gae_lambda)
    adv = gae_adv
    if cfg.normalize_adv:
        mu, sd = adv.mean(), adv.std(unbiased=False) + 1e-8
        if pmean is not None:  # the mean of the ranks' deviations, as the reference's pmean
            mu, sd = pmean([mu, sd])
        adv = (adv - mu) / sd
    slab = (traj.obs, traj.action, traj.logp, traj.value, adv, targets)
    active = torch.ones((), dtype=torch.bool, device=adv.device)
    first = None
    for e in range(cfg.num_epochs):
        for mb, mb_tiles in zip(*_minibatches(slab, tiles, draws[e], cfg, b)):
            first = (mb, mb_tiles) if first is None else first
            live = leaves(params)
            loss, kl = ppo_loss(net, live, mb, mb_tiles, cfg)
            grads, loss, kl = mean_grads(pmean, grads_of(loss, live), loss.detach(), kl.detach())
            grads = clip_by_global_norm(grads, cfg.max_grad_norm)
            new_params, new_opt_state = adam_update(params, grads, opt_state, rate)
            if cfg.target_kl is None:
                params, opt_state = new_params, new_opt_state
            else:  # once tripped, the ENTIRE step is frozen
                params = keep_where(active, new_params, params)
                opt_state = keep_where(active, new_opt_state, opt_state)
                active = active & (kl <= 1.5 * cfg.target_kl)
    return PPOUpdate(params, opt_state, env_state, loss, traj, bootstrap, gae_adv, targets, first)


def ppo_run(sem: Semantics, level: Level, ts: PPOTrainState, cfg: PPOConfig = PPOConfig(),
            num_updates: int = 500, *, gumbel=None, shuffle_draws=None) -> PPOTrainState:
    """Advance training by `num_updates`. Chunk-invariant: two runs of N
    equal one run of 2N bit for bit. `gumbel` (num_updates, T, B, A) and
    `shuffle_draws` (num_updates, num_epochs, ...) replace the state's own
    draws.

    On the card the run is one update captured in a CUDA graph and replayed
    `num_updates` times (`utils.capture.run`), the `target_kl` stop inside
    it; on the CPU the same update runs eagerly over the same buffers. The
    plain version of the captured run is `_ppo_run_eager`."""
    dev = level.device
    b = ts.run_ret.shape[0]
    keys = list(ts.params)
    state = [x.clone() for x in _state_buffers(ts.params, ts.opt_state, ts.env_state, ts.run_ret, ts.episodes,
                                               ts.ret_sum, ts.last_loss)]
    # injected draws, one list a update: the noise, then one shuffle draw an epoch
    shuffled = shuffle_draws is not None and cfg.shuffle != "none"
    injected = None
    if gumbel is not None or shuffled:
        def injected(i):
            return ([gumbel[i]] if gumbel is not None else []) + (
                [shuffle_draws[i][e] for e in range(cfg.num_epochs)] if shuffled else [])

    def program() -> capture.Program:
        learner = ppo_learner(sem, level, cfg, b)

        def body(xs, gen, inputs):
            params, opt_state, env_state, (run_ret, episodes, ret_sum, _) = _state_from(keys, xs)
            given = list(inputs or ())
            noise = given.pop(0) if gumbel is not None else None
            shuffle = given if shuffled else (None if gen is not None else [None] * cfg.num_epochs)
            noise, shuffle = _draws_from(gen, dev, cfg, b, sem.num_actions, noise, shuffle)
            upd = ppo_update(sem, learner, cfg, params, opt_state, env_state, noise, shuffle)
            stats = fold_episode_stats(run_ret, episodes, ret_sum, upd.traj.reward, upd.traj.done)
            return _state_buffers(upd.params, upd.opt_state, upd.env_state, *stats, upd.loss)

        # a generator a call unless every draw is injected ("none" draws nothing)
        drawn = gumbel is None or not (shuffled or cfg.shuffle == "none")
        return capture.Program(body, seeds=(lambda i: mix_seed(ts.seed, ts.update + i)) if drawn else None,
                               inputs=injected)

    return _run_onpolicy("ppo_run", ts, keys, state, program, num_updates)


def _ppo_run_eager(sem: Semantics, level: Level, ts: PPOTrainState, cfg: PPOConfig = PPOConfig(),
                   num_updates: int = 500, *, gumbel=None, shuffle_draws=None) -> PPOTrainState:
    """The plain version of `ppo_run`'s captured run: the same updates
    enqueued one after another from a host loop (`_ppo_updates_eager`),
    which a captured run equals bit for bit."""
    dev = level.device
    b = ts.run_ret.shape[0]
    learner = ppo_learner(sem, level, cfg, b)

    def draws(i):
        return update_draws(dev, ts.seed, ts.update + i, cfg, b, sem.num_actions,
                            gumbel=None if gumbel is None else gumbel[i],
                            shuffle=None if shuffle_draws is None else shuffle_draws[i])

    return _ppo_updates_eager(sem, learner, cfg, ts, num_updates, draws)


def _ppo_updates_eager(sem, learner: Learner, cfg: PPOConfig, ts: PPOTrainState, num_updates: int, draws,
                       pmean=None) -> PPOTrainState:
    """`num_updates` PPO updates from `ts`, update i's (noise, shuffle
    draws) `draws(i)`, from a host loop: the loop of `_ppo_run_eager` and
    `ppo_run_sharded`."""
    params, opt_state, env_state = ts.params, ts.opt_state, ts.env_state
    run_ret, episodes, ret_sum, loss = ts.run_ret, ts.episodes, ts.ret_sum, ts.last_loss
    with exact_kernels():
        for i in range(num_updates):
            noise, shuffle = draws(i)
            upd = ppo_update(sem, learner, cfg, params, opt_state, env_state, noise, shuffle, pmean)
            params, opt_state, env_state, loss = upd.params, upd.opt_state, upd.env_state, upd.loss
            run_ret, episodes, ret_sum = fold_episode_stats(
                run_ret, episodes, ret_sum, upd.traj.reward, upd.traj.done)
    return dataclasses.replace(
        ts, params=params, opt_state=opt_state, env_state=env_state,
        update=ts.update + num_updates, run_ret=run_ret, episodes=episodes, ret_sum=ret_sum,
        last_loss=loss,
    )


def ppo_result(ts: PPOTrainState) -> PPOResult:
    """Train state → PPOResult; sums the (scalar, or gathered (n,)
    per-shard) statistics, the only place they are aggregated."""
    episodes = ts.episodes.sum()
    return PPOResult(
        params=ts.params,
        episodes=episodes,
        mean_return=ts.ret_sum.sum() / episodes.clamp(min=1),
        final_loss=ts.last_loss,
    )


def ppo_train(sem: Semantics, level: Level, seed: int, cfg: PPOConfig = PPOConfig(),
              num_updates: int = 500, batch_size: int = 256) -> PPOResult:
    """PPO on one device, on the level's device: `ppo_init`, `ppo_run`,
    `ppo_result`."""
    ts = ppo_init(sem, level, seed, cfg, batch_size)
    return ppo_result(ppo_run(sem, level, ts, cfg, num_updates))


def ppo_init_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: PPOConfig = PPOConfig(),
                     batch_size: int = 256) -> PPOTrainState:
    """This rank's part of the initial sharded train state (`models/a2c.py`'s
    layout), on the mesh's device."""
    return _sharded_init(mesh, level, batch_size, lambda lvl, b: ppo_init(sem, lvl, seed, cfg, b))


def _shard_part(x, mesh: EnvMesh, cfg: PPOConfig):
    """Shard k's part of an injected shuffle draw: the k-th of n equal parts
    of its last axis (a () offset for "roll")."""
    if x is None:
        return None
    part = torch.as_tensor(x).chunk(mesh.size, dim=-1)[mesh.rank].to(mesh.device)
    return part.reshape(()) if cfg.shuffle == "roll" else part


def ppo_run_sharded(mesh: EnvMesh, sem: Semantics, level: Level, ts: PPOTrainState,
                    cfg: PPOConfig = PPOConfig(), num_updates: int = 500, *, gumbel=None,
                    shuffle_draws=None) -> PPOTrainState:
    """Advance sharded PPO by `num_updates` on this rank, carrying the whole
    state: run(2N) equals run(N), a checkpoint, a restore and run(N) bit
    for bit on a fixed world. Shard k's update u draws from (seed, k, u);
    `gumbel` (num_updates, T, B, A) and `shuffle_draws` (every shard's,
    module docstring) inject the global draws. A state of host leaves is
    the global one."""
    ts, level, batch, rows, lvl = _sharded_run_setup(mesh, level, ts)
    local_b = rows.stop - rows.start
    learner = ppo_learner(sem, lvl, cfg, local_b)
    seed = shard_seed(ts.seed, mesh.rank)

    def draws(i):
        shuffle = None
        if shuffle_draws is not None:
            shuffle = [_shard_part(shuffle_draws[i][e], mesh, cfg) for e in range(cfg.num_epochs)]
        return update_draws(mesh.device, seed, ts.update + i, cfg, local_b, sem.num_actions,
                            gumbel=None if gumbel is None else _rank_noise(gumbel[i], rows, mesh.device),
                            shuffle=shuffle)

    return _ppo_updates_eager(sem, learner, cfg, ts, num_updates, draws, _rank_mean(mesh))


def ppo_train_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: PPOConfig = PPOConfig(),
                      num_updates: int = 500, batch_size: int = 256, init_params=None,
                      init_opt_state=None) -> PPOResult:
    """Data-parallel PPO: envs sharded over the ranks, parameters and
    optimizer replicated, gradients averaged over the ranks each minibatch.
    `ppo_init_sharded`, `ppo_run_sharded` and the result, the same on every
    rank. `init_params` / `init_opt_state` warm-start from saved parameters
    (fresh envs; a fresh optimizer unless `init_opt_state` is given)."""
    ts = _warm_started(mesh, ppo_init_sharded(mesh, sem, level, seed, cfg, batch_size), init_params, init_opt_state)
    return _result_sharded(mesh, ppo_run_sharded(mesh, sem, level, ts, cfg, num_updates), ppo_result)
