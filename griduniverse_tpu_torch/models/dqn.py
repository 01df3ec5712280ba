"""DQN: off-policy value learning with a replay buffer on the device, on one
device or data-parallel over the ranks of a `parallel.mesh.EnvMesh`.

PyTorch counterpart of `griduniverse_tpu/models/dqn.py`. A step acts ε-greedily in B
auto-reset envs on the bit-packed step, writes the B transitions into a
circular buffer, samples a minibatch (uniformly, or by priority), takes one
clipped Adam step on the (double-)DQN loss and moves the target network
(Polyak, or a hard copy every `target_update_every` steps).

  * The buffer is fixed-size tensors on the device. A step's B transitions
    go to slots `(t·B) mod capacity`; `capacity % B == 0` keeps a write from
    wrapping. The trainer's write (with the priority fill) is part of K7c's
    launch (its store form, below). The minibatch gather and the priority
    refresh are kernel K8b (`csrc/replay.cu`), one launch each; K8b's own
    write stays as the kernel of the public `buffer_write`.
  * Prioritized replay has no sum-tree: Gumbel-top-k, the n best of
    `α·log p + Gumbel`, is an exact draw of n distinct slots with inclusion
    ∝ p^α. K8a takes the n best exactly (the reference's TPU primitive has
    recall ≥ 0.95), equal scores by lowest index. Samples are drawn WITHOUT
    replacement; importance weights keep the with-replacement form
    (N·P(i))^−β, max-normalised over the rows with mass.
  * The reference is one jitted scan; here, on the card, `dqn_run` is one
    step captured in a CUDA graph and replayed (`utils/capture.py`): ε, β,
    the write offset, the buffer's fill, the warm-up gate and the
    hard-update flag are computed in the graph from the step counter on the
    card (`step_scalars`), and nothing in a step reads a device value on the
    host. The plain version of the captured run, `_dqn_run_eager`, is the
    host loop that enqueues every step (the schedules of a run computed
    once); the sharded trainers run that loop.
  * The buffer and the priorities are updated IN PLACE inside a run;
    `dqn_run` copies the state once at its start into the run's buffers,
    so the state it was given is not written.

Randomness is counter-based: the train state holds an integer seed, and
step `t` draws its explore coins (B,), random actions (B,) and its minibatch
indices (n,) or Gumbel noise (capacity,) from a generator seeded from (seed,
t) alone, so two runs of N steps equal one of 2N bit for bit. `dqn_run` also
takes the draws as `draws=`, which is how the tests feed it `jax.random`'s.

The ε-greedy act, the env step, the episode statistics and the ring write
of a step are kernel K7c (`csrc/dqn_act.cu`, one launch: its store form,
through the run's `DqnActPlan` with the run's ring bound once). The
kernels' plain PyTorch versions are here (`dqn_act_step_reference`,
`dqn_act_store_reference`, `per_scores_reference`, `per_select_reference`,
`replay_write_reference`, `replay_gather_reference`,
`prio_refresh_reference`); CPU tensors take them, CUDA tensors launch the
kernels, or raise.

The sharded trainers (`dqn_init_sharded`, `dqn_run_sharded`,
`dqn_train_sharded`) follow `models/a2c.py`'s layout: each rank owns
`capacity / n` slots of the ring and its priorities (`_dqn_sharded_layout`)
and learns from its own shard's experience, through its own K7c store
form, K8a and K8b; its write offset is `(t·B/n) mod (capacity / n)` in
int64 (the reference's int32 product wraps). `p_max` is a per-shard (1,)
value. The gradients and the loss are averaged over the ranks each step,
so the online and target networks are the same bits on every rank. Step t
of shard k draws from (seed, k, t); `draws=` injects the global (explore
(T, B), rand_a (T, B), sample), of which each rank takes its columns: of
the minibatch slots (T, n·n_train) its n_train, of the Gumbel noise (T,
capacity) its capacity / n.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from .. import kernels
from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.dqn_act import CHUNK, DqnActPlan
from ..kernels.replay import (
    per_sample_cuda,
    prio_refresh_cuda,
    replay_gather_cuda,
    replay_write_cuda,
)
from ..ops.bitplane import (
    _U32,
    BitLevel,
    FastState,
    pack_level,
    reset_bits,
    step_bits,
)
from ..parallel.mesh import EnvMesh
from ..utils import capture
from ..utils.platform import resolve_device
from .a2c import (
    _net_apply,
    _net_init,
    _rank_mean,
    _rank_noise,
    _result_sharded,
    _sharded_env_specs,
    _sharded_init,
    _sharded_run_setup,
    _warm_started,
    mean_grads,
    shard_seed,
    _tiles_for,
    draw_gumbel,
    grads_of,
    leaves,
    make_network,
    mix_seed,
    _state_buffers,
    _state_from,
    update_generator,
)
from .networks import ActorCritic, BatchedConvActorCritic, ConvActorCritic, exact_kernels
from .optim import AdamState, Params, adam_init, adam_update, clip_by_global_norm, make_lr


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 16_384
    batch_size_train: int = 256     # minibatch sampled per train step
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_anneal_steps: int = 2_000
    tau: float = 0.01               # polyak target-update rate
    # target-network update rule: "polyak" (soft lerp every step) or "hard"
    # (classic DQN: full copy every target_update_every steps, by
    # `torch.where` on a device flag, no host branch)
    target_update: str = "polyak"
    target_update_every: int = 500
    double: bool = True
    learn_start: int = 64           # env-steps before training begins
    max_grad_norm: float = 10.0
    max_episode_steps: int | None = None
    hidden: tuple[int, ...] = (64, 64)
    embed_dim: int = 16
    # matmul precision (see A2CConfig.compute_dtype)
    compute_dtype: str = "bfloat16"
    # observation encoding (see A2CConfig.obs)
    obs: str = "index"
    conv_channels: tuple[int, ...] = (32, 32)
    agent_plane: str = "stamp"
    # lr schedule, see models/optim.py. Unit: train-loop steps (one Adam step
    # each; gradients are zeroed before learn_start, the count still runs).
    lr_schedule: str = "constant"
    lr_decay_steps: int | None = None
    lr_final_frac: float = 0.0
    # prioritized replay (Gumbel-top-k proportional sampling, module docs)
    prioritized: bool = False
    per_alpha: float = 0.6          # priority exponent
    per_beta0: float = 0.4          # initial importance-sampling exponent
    per_beta_anneal_steps: int = 10_000  # β: per_beta0 → 1 over this many steps
    per_eps: float = 1e-3           # priority floor added to |δ|


@dataclasses.dataclass
class DQNResult:
    params: Params
    episodes: torch.Tensor
    mean_return: torch.Tensor
    final_loss: torch.Tensor


class QNetwork(ActorCritic):
    """The ActorCritic trunk reused as a Q-network: the policy head's
    logits ARE the Q-values (value head unused)."""

    def q_values(self, params: Params, obs):
        return functional_call(self, params, (obs,))[0]


class ConvQNetwork(ConvActorCritic):
    """ConvActorCritic as a Q-network (obs='grid'; see models.networks)."""

    def q_values(self, params: Params, obs):
        return functional_call(self, params, (obs,))[0]


class BatchedConvQNetwork(BatchedConvActorCritic):
    """BatchedConvActorCritic as a Q-network: grid observations over
    PER-ENV levels (tile planes enter at call time)."""

    def q_values(self, params: Params, obs, tiles):
        return functional_call(self, params, (obs, tiles))[0]


def make_q_network(level: Level, num_actions: int, cfg: DQNConfig, *, seed: int = 0):
    """Build the Q-network for `cfg.obs` on the level's device: the
    value-learning twin of `a2c.make_network`."""
    return make_network(level, num_actions, cfg, seed=seed,
                        families=(QNetwork, ConvQNetwork, BatchedConvQNetwork))


# ---------------------------------------------------------------------------
# K8b: the replay ring
# ---------------------------------------------------------------------------


class ReplayBuffer(NamedTuple):
    """Fixed-size circular transition store, all device tensors."""

    obs: torch.Tensor       # (cap,) int32
    action: torch.Tensor    # (cap,) int32
    reward: torch.Tensor    # (cap,) float32
    next_obs: torch.Tensor  # (cap,) int32
    done: torch.Tensor      # (cap,) bool


def buffer_init(capacity: int, *, device=None) -> ReplayBuffer:
    dev = resolve_device(device)
    return ReplayBuffer(
        obs=torch.zeros(capacity, dtype=torch.int32, device=dev),
        action=torch.zeros(capacity, dtype=torch.int32, device=dev),
        reward=torch.zeros(capacity, dtype=torch.float32, device=dev),
        next_obs=torch.zeros(capacity, dtype=torch.int32, device=dev),
        done=torch.zeros(capacity, dtype=torch.bool, device=dev),
    )


def _scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(())


def replay_write_reference(buf: ReplayBuffer, prio, at, batch: ReplayBuffer, p_max) -> None:
    """Plain PyTorch version of K8b's write: the B transitions of `batch`
    into slots `at`..`at + B − 1` of the ring, IN PLACE, and `p_max` into
    those slots of `prio` unless it is None."""
    slots = at + torch.arange(batch.obs.shape[0], device=batch.obs.device)
    for full, part in zip(buf, batch):
        full[slots] = part
    if prio is not None:
        prio[slots] = p_max


def buffer_write(buf: ReplayBuffer, at, batch: ReplayBuffer, prio=None, p_max=None) -> ReplayBuffer:
    """Insert B contiguous transitions at offset `at` (an int or a () device
    tensor), IN PLACE (K8b on CUDA); the caller guarantees `at + B <=
    capacity` (the circular invariant `capacity % B == 0` makes every write
    non-wrapping). With `prio` and `p_max`, the new slots enter at the running
    maximum priority. Returns `buf`."""
    dev = buf.obs.device
    at = _scalar(at, torch.int64, dev)
    if prio is not None:
        p_max = _scalar(p_max, torch.float32, dev)
    batch = ReplayBuffer(*(x.to(full.dtype) for x, full in zip(batch, buf)))
    if not kernels.on_cuda(*buf, *batch):
        replay_write_reference(buf, prio, at, batch, p_max)
    else:
        replay_write_cuda(buf, prio, at, ReplayBuffer(*(x.contiguous() for x in batch)), p_max)
    return buf


def replay_gather_reference(buf: ReplayBuffer, idx):
    """Plain PyTorch version of K8b's gather: every field at `idx`."""
    rows = idx.long()
    return tuple(x[rows] for x in buf)


def replay_gather(buf: ReplayBuffer, idx) -> ReplayBuffer:
    """The transitions in slots `idx` (n,) int32 (K8b on CUDA)."""
    if not kernels.on_cuda(*buf, idx):
        return ReplayBuffer(*replay_gather_reference(buf, idx))
    return ReplayBuffer(*replay_gather_cuda(buf, idx.contiguous()))


def prio_refresh_reference(prio, idx, abs_err, eps: float, p_max):
    """Plain PyTorch version of K8b's refresh: `prio[idx[i]] = abs_err[i] +
    eps` IN PLACE, where of equal indices the HIGHEST i wins (what a
    sequential scatter gives): every row writes its winner's value, so the
    write's own order cannot show. Returns the new () `p_max`."""
    fresh = abs_err + eps
    same = idx[:, None] == idx[None, :]
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.where(same, rows[None, :], 0).max(dim=1).values
    prio[idx.long()] = fresh[winner]
    return torch.maximum(p_max, fresh.max())


def prio_refresh(prio, idx, abs_err, eps: float, p_max):
    """Refresh the sampled slots' priorities from this step's |δ|, IN PLACE
    (K8b on CUDA); returns the new running maximum."""
    if not kernels.on_cuda(prio, idx, abs_err, p_max):
        return prio_refresh_reference(prio, idx, abs_err, eps, p_max)
    return prio_refresh_cuda(prio, idx.contiguous(), abs_err.contiguous(), eps, p_max)


def buffer_sample_idx(generator: torch.Generator, size, n: int, *, device=None) -> torch.Tensor:
    """Slot indices (n,) int32 for a uniform sample from the first `size`
    valid rows (`size` an int or a () device tensor; no host read): a 62-bit
    draw reduced modulo `max(size, 1)`."""
    dev = generator.device if device is None else torch.device(device)
    size = _scalar(size, torch.int64, dev)
    raw = torch.randint(0, 1 << 62, (n,), generator=generator, device=dev)
    return (raw % size.clamp(min=1)).to(torch.int32)


def buffer_sample(buf: ReplayBuffer, generator: torch.Generator, size, n: int) -> ReplayBuffer:
    """Uniform sample of `n` transitions from the first `size` valid rows."""
    return replay_gather(buf, buffer_sample_idx(generator, size, n, device=buf.obs.device))


# ---------------------------------------------------------------------------
# K8a: the prioritized draw
# ---------------------------------------------------------------------------


def per_scores_reference(prio, noise, size, alpha: float):
    """Plain PyTorch version of K8a's first pass: (score, mass) per slot.
    `score = α·log max(p, 1e-30) + noise` over the first `size` slots and
    −inf beyond; `mass = p^α` there and 0 beyond."""
    valid = torch.arange(prio.shape[0], device=prio.device) < size
    logp = alpha * torch.log(prio.clamp(min=1e-30))
    score = torch.where(valid, logp + noise, -torch.inf)
    return score, torch.where(valid, torch.exp(logp), 0.0)


def per_select_reference(score, pa, size, beta, n: int):
    """Plain PyTorch version of K8a's second pass, which also defines its
    tie rule: the n best scores by a stable descending sort (equal scores by
    lowest index); a pick with no mass replaced by the hash `(idx·2654435761
    + position) mod 2^32 mod max(size, 1)` at weight exactly 1; the other
    weights `(max(size, 1)·mass/Σmass)^−β`, divided by their maximum.
    Returns (idx (n,) int32, w (n,) float32)."""
    cap = score.shape[0]
    k_eff = min(n, cap)
    idx = torch.sort(score, descending=True, stable=True).indices[:k_eff]
    if k_eff < n:  # a buffer smaller than the minibatch: pad with slot 0
        idx = torch.cat([idx, idx.new_zeros(n - k_eff)])
    picked = pa[idx]
    ok = picked > 0.0  # the selected slot carries sampling mass
    size1 = size.clamp(min=1)
    h = (idx * 2654435761 + torch.arange(n, device=idx.device)) & _U32
    idx = torch.where(ok, idx, h % size1)
    p_sel = picked / pa.sum().clamp(min=1e-30)
    w = (size1.to(torch.float32) * p_sel) ** (-beta)
    w_real_max = torch.where(ok, w, 0.0).max()
    return idx.to(torch.int32), torch.where(ok, w / w_real_max.clamp(min=1e-30), 1.0)


def _per_sample(prio, noise, size, n: int, alpha: float, beta):
    """(idx, w, score) of one prioritized draw; `size` () int64 and `beta`
    () float32 tensors."""
    if not kernels.on_cuda(prio, noise, size, beta):
        score, pa = per_scores_reference(prio, noise, size, alpha)
        return (*per_select_reference(score, pa, size, beta, n), score)
    return per_sample_cuda(prio, noise.contiguous(), size, beta, n, alpha)


def prioritized_sample(prio, noise, size, n: int, alpha: float, beta):
    """Proportional PER draw of `n` slots ∝ prio^α from the first `size`
    valid rows, WITHOUT a sum-tree and WITHOUT replacement (K8a on CUDA).

    Gumbel-top-k: argtop_n(α·log p_i + G_i) with G the (capacity,) standard
    Gumbel `noise` is an exact sample of n distinct slots with inclusion ∝
    p^α. The n best are taken exactly, in descending score, equal scores by
    lowest index.

    Any selected slot with zero sampling mass (top-k overflow when `size <
    n`) is replaced by a hashed valid slot with NEUTRAL weight 1, never fed
    to the loss at weight ∞/NaN. `size` and `beta` may be numbers or ()
    device tensors.

    Returns (idx (n,) int32, is_weights (n,): max-normalized (size·P(i))^−β).
    """
    dev = prio.device
    idx, w, _ = _per_sample(prio, noise, _scalar(size, torch.int64, dev), n, alpha,
                            _scalar(beta, torch.float32, dev))
    return idx, w


# ---------------------------------------------------------------------------
# K7c: the ε-greedy act, the env step and the episode statistics
# ---------------------------------------------------------------------------


def ended_return_sum_reference(ended: torch.Tensor) -> torch.Tensor:
    """Σ of the (B,) float32 returns of the envs whose episode ended (0
    elsewhere), in K7c's fixed order: in each chunk of `CHUNK` envs a tree
    (pairs i and i + half, half = CHUNK/2, ..., 1; envs past B add 0), then
    the chunks' sums in index order from 0."""
    b = ended.shape[0]
    chunks = -(-b // CHUNK)
    x = F.pad(ended, (0, chunks * CHUNK - b)).reshape(chunks, CHUNK)
    half = CHUNK // 2
    while half:
        x = x[:, :half] + x[:, half:2 * half]
        half //= 2
    total = torch.zeros((), dtype=torch.float32, device=ended.device)
    for c in range(chunks):
        total = total + x[c, 0]
    return total


def dqn_act_step_reference(sem, bl, state: FastState, q, explore, rand_a, run_ret, episodes,
                           ret_sum, max_episode_steps=None):
    """Plain PyTorch version of K7c: `a = explore ? rand_a : argmax(q)`
    (the first maximum), one auto-reset `step_bits` with the optional time
    limit, then the reference's statistics: `run_ret += r`, the ended
    episodes counted, their returns summed (`ended_return_sum_reference`)
    and cleared. Returns (new state, action int32, next_obs int32, reward,
    done, run_ret, episodes, ret_sum)."""
    greedy = torch.argmax(q.float(), dim=-1).to(torch.int32)
    actions = torch.where(explore, rand_a.to(torch.int32), greedy)
    new_state, (next_obs, reward, done) = step_bits(sem, bl, state, actions, True, max_episode_steps)
    run_ret = run_ret + reward
    episodes = episodes + done.sum()
    ret_sum = ret_sum + ended_return_sum_reference(torch.where(done, run_ret, 0.0))
    run_ret = torch.where(done, 0.0, run_ret)
    return new_state, actions, next_obs, reward, done, run_ret, episodes, ret_sum


def dqn_act_store_reference(sem, bl, state: FastState, q, explore, rand_a, run_ret, episodes, ret_sum,
                            ring, max_episode_steps=None):
    """Plain PyTorch version of K7c's store form: `dqn_act_step_reference`,
    then `replay_write_reference` of the step's transitions (obs =
    `state.agent_idx`) into `ring` = (buf, prio or None, at, p_max), IN
    PLACE. Returns what `dqn_act_step_reference` returns."""
    out = dqn_act_step_reference(sem, bl, state, q, explore, rand_a, run_ret, episodes, ret_sum,
                                 max_episode_steps)
    buf, prio, at, p_max = ring
    _, action, next_obs, reward, done = out[:5]
    replay_write_reference(buf, prio, at, ReplayBuffer(state.agent_idx, action, reward, next_obs, done), p_max)
    return out


def dqn_act_step(sem: Semantics, bl: BitLevel, state: FastState, q, explore, rand_a, run_ret,
                 episodes, ret_sum, max_episode_steps: int | None = None,
                 plan: DqnActPlan | None = None, ring=None):
    """One DQN act-and-step for B envs from the Q-values `q` (B, A) (cast to
    float32 once: the cast keeps order and ties) and the step's draws, with
    the episode statistics (K7c on CUDA): see `dqn_act_step_reference`; the
    kernel equals it bit for bit in every output. `plan`: K7c's host plan
    for (sem, bl, B, max_episode_steps), built once a run (`dqn_learner`);
    without one a CUDA call builds its own.

    `ring` = (buf, prio or None, at, p_max): the store form, which also
    writes the step's B transitions into slots `at`..`at + B − 1` of the
    replay ring `buf` IN PLACE, and `p_max` into those slots of `prio`
    (`dqn_act_store_reference`; `at` a () int64 and `p_max` a () float32
    device tensor on CUDA). A given plan must hold that ring
    (`DqnActPlan.bind_ring`, once a run), else the call raises."""
    q = q.float()
    rand_a = rand_a.to(torch.int32)
    if plan is None:
        if not kernels.on_cuda(q, explore, rand_a, state.agent_idx, run_ret, bl.code_words, sem.deltas):
            if ring is None:
                return dqn_act_step_reference(sem, bl, state, q, explore, rand_a, run_ret, episodes, ret_sum,
                                              max_episode_steps)
            return dqn_act_store_reference(sem, bl, state, q, explore, rand_a, run_ret, episodes, ret_sum,
                                           ring, max_episode_steps)
        plan = DqnActPlan(sem, bl, q.shape[0], max_episode_steps)
        if ring is not None:
            plan.bind_ring(ring[0], ring[1])
    else:
        plan.check_level(sem, bl, max_episode_steps)
    idx, code, t, sdone, action, next_obs, reward, done, run_ret, episodes, ret_sum = plan(
        state, q, explore, rand_a, run_ret, episodes, ret_sum, ring)
    return FastState(idx, code, t, sdone), action, next_obs, reward, done, run_ret, episodes, ret_sum


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DQNTrainState:
    """Full resumable DQN learner state: parameters, target, optimizer, env
    batch, the ENTIRE replay buffer (with the PER priorities), the base seed
    and the step counter. Step t's randomness comes from (seed, t), so
    chunked runs are bit-exact resumes of unbroken ones. The uniform-replay
    state carries a (0,)-sized `prio` so one structure serves both modes."""

    params: Params
    target_params: Params
    opt_state: AdamState
    env_state: FastState
    buf: ReplayBuffer
    prio: torch.Tensor       # (cap,) float32 PER priorities; (0,) when uniform
    p_max: torch.Tensor      # () float32 running max priority
    seed: int                # base seed (never consumed, only mixed)
    t: torch.Tensor          # () int32 global step counter
    run_ret: torch.Tensor    # (B,) running per-env episode returns
    episodes: torch.Tensor   # () int64
    ret_sum: torch.Tensor    # () float32
    last_loss: torch.Tensor  # () float32


def _dqn_rate(cfg: DQNConfig):
    # DQN applies Adam once per train-loop step, the unit of lr_decay_steps
    return make_lr(cfg.lr, cfg.lr_schedule, cfg.lr_decay_steps, cfg.lr_final_frac, "lr_decay_steps")


def dqn_init(sem: Semantics, level: Level, seed: int, cfg: DQNConfig = DQNConfig(),
             batch_size: int = 64) -> DQNTrainState:
    """Build the initial resumable train state (see `DQNTrainState`) on the
    level's device."""
    dev = level.device
    net = make_q_network(level, sem.num_actions, cfg)
    params = _net_init(net, mix_seed(seed, -1))
    bl = pack_level(level)
    env_state = reset_bits(bl, None if bl.batched else batch_size)
    b = env_state.agent_idx.shape[0]
    cap = cfg.buffer_capacity if cfg.prioritized else 0
    return DQNTrainState(
        params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=adam_init(params),
        env_state=env_state,
        buf=buffer_init(cfg.buffer_capacity, device=dev),
        prio=torch.zeros(cap, dtype=torch.float32, device=dev),
        p_max=torch.ones((), dtype=torch.float32, device=dev),
        seed=int(seed),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        run_ret=torch.zeros(b, dtype=torch.float32, device=dev),
        episodes=torch.zeros((), dtype=torch.int64, device=dev),
        ret_sum=torch.zeros((), dtype=torch.float32, device=dev),
        last_loss=torch.zeros((), dtype=torch.float32, device=dev),
    )


class DQNLearner(NamedTuple):
    """What every step of a run shares, built once a run."""

    bl: BitLevel                 # the packed level
    net: torch.nn.Module
    tiles: torch.Tensor | None   # per-env tile planes of a needs-tiles net
    rate: Callable               # Adam count → learning rate
    batch_env: int               # B, the envs stepped (and transitions written) a step
    act_plan: DqnActPlan | None  # K7c's host plan on the card (its ring bound by `dqn_run`); None on the CPU


def dqn_learner(sem: Semantics, level: Level, cfg: DQNConfig, batch_env: int) -> DQNLearner:
    """What every step of a run shares; raises on a `cfg` that `batch_env`
    envs cannot run."""
    if cfg.target_update not in ("polyak", "hard"):
        raise ValueError(f"unknown target_update mode: {cfg.target_update!r}")
    if cfg.buffer_capacity % batch_env:
        raise ValueError(
            f"buffer_capacity ({cfg.buffer_capacity}) must be a multiple of the env batch "
            f"({batch_env}) so circular writes never wrap mid-batch"
        )
    net = make_q_network(level, sem.num_actions, cfg)
    bl = pack_level(level)
    plan = DqnActPlan(sem, bl, batch_env, cfg.max_episode_steps) if level.device.type == "cuda" else None
    return DQNLearner(bl, net, _tiles_for(net, level), _dqn_rate(cfg), batch_env, plan)


@dataclasses.dataclass
class StepScalars:
    """The scalars a step needs that are functions of the step counter
    alone, as device tensors: (num_steps,) for a run, () for one step."""

    eps: torch.Tensor     # float32 exploration rate
    at: torch.Tensor      # int64 write offset, (t·B) mod capacity
    size: torch.Tensor    # int64 valid rows after the write, min((t+1)·B, capacity)
    valid: torch.Tensor   # float32 1 once learning runs, else 0 (the loss's gate)
    beta: torch.Tensor    # float32 importance-sampling exponent
    sync: torch.Tensor    # bool: a hard target update falls on this step

    def __getitem__(self, i: int) -> "StepScalars":
        return StepScalars(*(getattr(self, f.name)[i] for f in dataclasses.fields(self)))


def step_scalars(cfg: DQNConfig, t0: torch.Tensor, num_steps: int, batch_env: int) -> StepScalars:
    """The schedules of steps t0 .. t0 + num_steps − 1, from the () counter
    `t0` on its device, with no host read."""
    cap, n = cfg.buffer_capacity, cfg.batch_size_train
    t = t0.to(torch.int64) + torch.arange(num_steps, device=t0.device)
    tf = t.to(torch.float32)
    eps = cfg.eps_start + (tf / cfg.eps_anneal_steps).clamp(0.0, 1.0) * (cfg.eps_end - cfg.eps_start)
    size = ((t + 1) * batch_env).clamp(max=cap)
    # learning is gated on BOTH learn_start and a buffer that holds a full
    # minibatch; min() with cap keeps a buffer smaller than n trainable
    ready = size >= min(n, cap)
    valid = ((t >= cfg.learn_start // batch_env) & ready).to(torch.float32)
    beta = cfg.per_beta0 + (1.0 - cfg.per_beta0) * (tf / cfg.per_beta_anneal_steps).clamp(0.0, 1.0)
    return StepScalars(eps=eps, at=(t * batch_env) % cap, size=size, valid=valid, beta=beta,
                       sync=(t + 1) % cfg.target_update_every == 0)


def step_draws(device, seed: int, t: int, cfg: DQNConfig, batch_env: int, num_actions: int,
               eps, size):
    """The draws of step `t`, from a generator seeded from (seed, t) alone,
    in a fixed order: explore coins (B,) bool, random actions (B,) int32,
    then the minibatch's slot indices (n,) int32 (uniform replay) or the
    Gumbel noise (capacity,) (prioritized). `eps` and `size` are that
    step's () tensors."""
    return _draws_from(update_generator(device, seed, t), device, cfg, batch_env, num_actions, eps, size)


def _draws_from(gen: torch.Generator, device, cfg: DQNConfig, batch_env: int, num_actions: int, eps, size):
    """`step_draws` from the generator `gen`, seeded for the step."""
    explore = torch.rand((batch_env,), generator=gen, device=device) < eps
    rand_a = torch.randint(0, num_actions, (batch_env,), generator=gen, device=device, dtype=torch.int32)
    if cfg.prioritized:
        sample = draw_gumbel(gen, (cfg.buffer_capacity,), device)
    else:
        sample = buffer_sample_idx(gen, size, cfg.batch_size_train, device=device)
    return explore, rand_a, sample


def dqn_loss(net, params: Params, target_params: Params, mb: ReplayBuffer, w, valid, mb_tiles,
             cfg: DQNConfig):
    """(loss, |δ|) of one minibatch: `mean(w·δ²)·valid` with `δ = Q(s, a) −
    (r + γ·(1 − done)·V'(s'))`, V' the target network's value of the online
    network's greedy action (double DQN) or its own maximum. `w` are the PER
    importance weights (ones when uniform)."""
    num_actions = net.num_actions
    q, _ = _net_apply(net, params, mb.obs, mb_tiles)
    q_sa = (q * F.one_hot(mb.action.long(), num_actions)).sum(dim=-1)
    with torch.no_grad():
        q_next_t, _ = _net_apply(net, target_params, mb.next_obs, mb_tiles)
        if cfg.double:
            q_next_o, _ = _net_apply(net, params, mb.next_obs, mb_tiles)
            a_star = torch.argmax(q_next_o, dim=-1)
            v_next = (q_next_t * F.one_hot(a_star, num_actions)).sum(dim=-1)
        else:
            v_next = q_next_t.max(dim=-1).values
        target = mb.reward + cfg.gamma * torch.where(mb.done, 0.0, v_next)
    err = q_sa - target
    return (w * err ** 2).mean() * valid, err.detach().abs()


@dataclasses.dataclass
class DQNUpdate:
    """What one step gives: the learner's new tensors, and what it made on
    the way, so that a check can hold the kernels' own inputs and outputs
    against the plain versions. `buf` and `prio` are the tensors the step
    was given, written in place."""

    params: Params
    target_params: Params
    opt_state: AdamState
    env_state: FastState
    p_max: torch.Tensor
    loss: torch.Tensor
    batch: ReplayBuffer          # the B transitions this step wrote
    idx: torch.Tensor            # (n,) int32 slots of the minibatch
    w: torch.Tensor              # (n,) importance weights
    score: torch.Tensor | None   # (capacity,) the draw's scores (prioritized)
    mb: ReplayBuffer             # the minibatch
    abs_err: torch.Tensor        # (n,) |δ|
    stats: tuple                 # the new (run_ret (B,), episodes (), ret_sum ())


def dqn_update(sem: Semantics, learner: DQNLearner, cfg: DQNConfig, params: Params,
               target_params: Params, opt_state: AdamState, env_state: FastState,
               buf: ReplayBuffer, prio, p_max, sc: StepScalars, draws, stats, pmean=None) -> DQNUpdate:
    """One DQN step from its scalars `sc` (`step_scalars(...)[i]`), its
    `draws` (`step_draws`) and the episode statistics `stats` (run_ret,
    episodes, ret_sum): act ε-greedily, step the envs, fold the statistics
    and write the transitions (K7c's store form), sample, one clipped Adam
    step, move the target, refresh the priorities. `buf` and `prio` are
    written IN PLACE; on the card they must be the ring bound to
    `learner.act_plan` (`DqnActPlan.bind_ring`). `dqn_run` captures it,
    `_dqn_run_eager` loops over it, inside `exact_kernels()`. `pmean` (a
    sharded run's `_rank_mean`) takes the gradients and the loss to their
    means over the ranks."""
    bl, net, tiles, rate, batch_env, act_plan = learner
    explore, rand_a, sample = draws
    n = cfg.batch_size_train

    obs = env_state.agent_idx
    with torch.no_grad():
        q, _ = _net_apply(net, params, obs, tiles)
    # the act also stores the B transitions at slots sc.at..; fresh
    # transitions enter at the running max priority, so each is sampled at
    # least once with high probability
    ring = (buf, prio if cfg.prioritized else None, sc.at, p_max)
    env_state, actions, next_obs, reward, done, *stats = dqn_act_step(
        sem, bl, env_state, q, explore, rand_a, *stats, cfg.max_episode_steps, plan=act_plan, ring=ring)
    batch = ReplayBuffer(obs, actions, reward, next_obs, done)

    score = None
    if cfg.prioritized:
        idx, w, score = _per_sample(prio, sample, sc.size, n, cfg.per_alpha, sc.beta)
    else:
        idx = sample.to(torch.int32)
        w = torch.ones((n,), dtype=torch.float32, device=obs.device)
    mb = replay_gather(buf, idx)
    # the ring's layout makes slot → env free: env = slot mod B
    mb_tiles = None if tiles is None else tiles[(idx % batch_env).long()]

    live = leaves(params)
    loss, abs_err = dqn_loss(net, live, target_params, mb, w, sc.valid, mb_tiles, cfg)
    grads, loss = mean_grads(pmean, grads_of(loss, live), loss.detach())
    grads = clip_by_global_norm(grads, cfg.max_grad_norm)
    params, opt_state = adam_update(params, grads, opt_state, rate)
    if cfg.target_update == "hard":
        target_params = {k: torch.where(sc.sync, params[k], tp) for k, tp in target_params.items()}
    else:
        target_params = {k: tp + cfg.tau * (params[k] - tp) for k, tp in target_params.items()}
    if cfg.prioritized:
        p_max = prio_refresh(prio, idx, abs_err, cfg.per_eps, p_max)
    return DQNUpdate(params, target_params, opt_state, env_state, p_max, loss, batch,
                     idx, w, score, mb, abs_err, tuple(stats))


def dqn_run(sem: Semantics, level: Level, ts: DQNTrainState, cfg: DQNConfig = DQNConfig(),
            num_steps: int = 2_000, *, draws=None) -> DQNTrainState:
    """Advance training by `num_steps`. Chunk-invariant: two runs of N/2
    bit-equal one run of N. `draws` = (explore (T, B) bool, rand_a (T, B)
    int32, sample (T, n) slot indices or (T, capacity) Gumbel noise)
    replaces the state's own draws. The state given is not written: it is
    copied once into the run's buffers, which the steps then update.

    On the card the run is one step captured in a CUDA graph and replayed
    `num_steps` times (`utils.capture.run`), the counterpart of the
    reference's one jitted scan; on the CPU the same step runs eagerly over
    the same buffers. The plain version of the captured run is
    `_dqn_run_eager`, the loop that enqueues every step."""
    b = ts.run_ret.shape[0]
    keys = list(ts.params)
    dev = level.device
    # the one host read of a run: the steps' generators are seeded from (seed, t)
    t0 = int(ts.t) if draws is None else 0
    state = [x.clone() for x in _dqn_buffers(ts)]

    def program() -> capture.Program:
        learner = dqn_learner(sem, level, cfg, b)

        def body(xs, gen, inputs):
            params, target_params, opt_state, env_state, buf, prio, p_max, t, run_ret, episodes, ret_sum, _ = (
                _dqn_unflat(keys, xs))
            # the step's schedules from the counter on the card
            sc = step_scalars(cfg, t, 1, b)[0]
            step = tuple(inputs) if gen is None else _draws_from(gen, dev, cfg, b, sem.num_actions, sc.eps, sc.size)
            upd = dqn_update(sem, learner, cfg, params, target_params, opt_state, env_state, buf, prio, p_max,
                             sc, step, (run_ret, episodes, ret_sum))
            return _dqn_flat(upd.params, upd.target_params, upd.opt_state, upd.env_state, buf, prio, upd.p_max,
                             t + 1, *upd.stats, upd.loss)

        def bind(xs):
            if learner.act_plan is not None:  # the run's ring, checked once, for K7c's store form
                _, _, _, _, buf, prio, *_ = _dqn_unflat(keys, xs)
                learner.act_plan.bind_ring(buf, prio if cfg.prioritized else None)

        if draws is not None:
            return capture.Program(body, inputs=lambda i: [d[i] for d in draws], bind=bind)
        return capture.Program(body, seeds=lambda i: mix_seed(ts.seed, t0 + i), bind=bind)

    with exact_kernels():
        state = capture.run("dqn_run", state, program, num_steps)
    params, target_params, opt_state, env_state, buf, prio, p_max, t, run_ret, episodes, ret_sum, loss = (
        _dqn_unflat(keys, state))
    return dataclasses.replace(
        ts, params=params, target_params=target_params, opt_state=opt_state, env_state=env_state, buf=buf,
        prio=prio, p_max=p_max, t=t, run_ret=run_ret, episodes=episodes, ret_sum=ret_sum, last_loss=loss)


def _dqn_flat(params, target_params, opt_state, env_state, buf, prio, p_max, t, run_ret, episodes, ret_sum,
              loss) -> list:
    """A DQN state's tensors as one list: `a2c._state_buffers`' order, then
    the target, the ring, `prio`, `p_max`, `t`, the statistics and the loss."""
    return _state_buffers(params, opt_state, env_state, *target_params.values(), *buf, prio, p_max, t,
                          run_ret, episodes, ret_sum, loss)


def _dqn_unflat(keys, xs) -> tuple:
    """`_dqn_flat`'s arguments from its list, the parameters keyed by `keys`."""
    params, opt_state, env_state, rest = _state_from(keys, xs)
    n = len(keys)
    return (params, dict(zip(keys, rest[:n])), opt_state, env_state, ReplayBuffer(*rest[n:n + 5]),
            *rest[n + 5:])


def _dqn_buffers(ts: DQNTrainState) -> list:
    return _dqn_flat(ts.params, ts.target_params, ts.opt_state, ts.env_state, ts.buf, ts.prio, ts.p_max, ts.t,
                     ts.run_ret, ts.episodes, ts.ret_sum, ts.last_loss)


def _dqn_run_eager(sem: Semantics, level: Level, ts: DQNTrainState, cfg: DQNConfig = DQNConfig(),
                   num_steps: int = 2_000, *, draws=None) -> DQNTrainState:
    """The plain version of `dqn_run`'s captured run: the same steps
    enqueued one after another from a host loop (`_dqn_steps_eager`),
    which a captured run equals bit for bit."""
    b = ts.run_ret.shape[0]
    learner = dqn_learner(sem, level, cfg, b)
    return _dqn_steps_eager(sem, level.device, learner, cfg, ts, num_steps, ts.seed,
                            None if draws is None else (lambda i: tuple(d[i] for d in draws)))


def _dqn_steps_eager(sem, dev, learner: DQNLearner, cfg: DQNConfig, ts: DQNTrainState, num_steps: int, seed: int,
                     draws, pmean=None) -> DQNTrainState:
    """`num_steps` DQN steps from `ts`, step i's draws from (seed, t0 + i) or
    `draws(i)`, from a host loop: the loop of `_dqn_run_eager` and
    `dqn_run_sharded` (`cfg` the rank's, its capacity the rank's slots)."""
    b = learner.batch_env
    # the one host read of a run: the steps' generators are seeded from (seed, t)
    t0 = int(ts.t) if draws is None else 0
    scalars = step_scalars(cfg, ts.t, num_steps, b)
    params, target_params, opt_state, env_state = ts.params, ts.target_params, ts.opt_state, ts.env_state
    buf = ReplayBuffer(*(x.clone() for x in ts.buf))
    prio, p_max = ts.prio.clone(), ts.p_max.reshape(())
    if learner.act_plan is not None:  # the run's ring, checked once, for K7c's store form
        learner.act_plan.bind_ring(buf, prio if cfg.prioritized else None)
    # a sharded state's per-shard statistics are (1,); the step takes them 0-d
    stats, loss = (ts.run_ret, ts.episodes.reshape(()), ts.ret_sum.reshape(())), ts.last_loss
    with exact_kernels():
        for i in range(num_steps):
            sc = scalars[i]
            if draws is None:
                step = step_draws(dev, seed, t0 + i, cfg, b, sem.num_actions, sc.eps, sc.size)
            else:
                step = draws(i)
            upd = dqn_update(sem, learner, cfg, params, target_params, opt_state, env_state,
                             buf, prio, p_max, sc, step, stats, pmean)
            params, target_params, opt_state = upd.params, upd.target_params, upd.opt_state
            env_state, p_max, loss, stats = upd.env_state, upd.p_max, upd.loss, upd.stats
    run_ret, episodes, ret_sum = stats
    return dataclasses.replace(
        ts, params=params, target_params=target_params, opt_state=opt_state, env_state=env_state,
        buf=buf, prio=prio, p_max=p_max.reshape(ts.p_max.shape), t=ts.t + num_steps, run_ret=run_ret,
        episodes=episodes.reshape(ts.episodes.shape), ret_sum=ret_sum.reshape(ts.ret_sum.shape), last_loss=loss,
    )


def dqn_result(ts: DQNTrainState) -> DQNResult:
    """Train state → DQNResult; sums the (scalar, or gathered (n,)
    per-shard) statistics, the only place they are aggregated."""
    episodes = ts.episodes.sum()
    return DQNResult(
        params=ts.params,
        episodes=episodes,
        mean_return=ts.ret_sum.sum() / episodes.clamp(min=1),
        final_loss=ts.last_loss,
    )


def dqn_train(sem: Semantics, level: Level, seed: int, cfg: DQNConfig = DQNConfig(),
              num_steps: int = 2_000, batch_size: int = 64) -> DQNResult:
    """DQN on one device, on the level's device: `num_steps` iterations, each
    stepping `batch_size` envs once and doing one minibatch SGD step:
    `dqn_init`, `dqn_run`, `dqn_result`."""
    ts = dqn_init(sem, level, seed, cfg, batch_size)
    return dqn_result(dqn_run(sem, level, ts, cfg, num_steps))


def _dqn_sharded_layout(mesh: EnvMesh, cfg: DQNConfig, bl: BitLevel, batch_size: int):
    """(axes, local_b, local_cfg, rows, the rank's BitLevel, the rank's ring
    slots) of the env-sharded DQN layout. `buffer_capacity` is GLOBAL: the
    (capacity,) ring and priorities shard over the ranks, each owning
    capacity / n slots of its own experience (`local_cfg`'s capacity)."""
    axes, local_b, rows, bl_local = _sharded_env_specs(mesh, bl, batch_size)
    if cfg.buffer_capacity % mesh.size:
        raise ValueError(f"buffer_capacity {cfg.buffer_capacity} not divisible by mesh size {mesh.size}")
    cap = cfg.buffer_capacity // mesh.size
    local_cfg = dataclasses.replace(cfg, buffer_capacity=cap)
    return axes, local_b, local_cfg, rows, bl_local, slice(mesh.rank * cap, (mesh.rank + 1) * cap)


def dqn_init_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: DQNConfig = DQNConfig(),
                     batch_size: int = 64) -> DQNTrainState:
    """This rank's part of the initial sharded train state, on the mesh's
    device: the unsharded init's parameters, target and optimizer,
    replicated; the rank's B / n envs, its capacity / n ring slots and
    priorities; (1,) per-shard `p_max` and statistics."""
    _, _, local_cfg, _, _, _ = _dqn_sharded_layout(mesh, cfg, pack_level(level.to(mesh.device)), batch_size)
    return _sharded_init(mesh, level, batch_size, lambda lvl, b: dqn_init(sem, lvl, seed, local_cfg, b))


def dqn_run_sharded(mesh: EnvMesh, sem: Semantics, level: Level, ts: DQNTrainState,
                    cfg: DQNConfig = DQNConfig(), num_steps: int = 2_000, *, draws=None) -> DQNTrainState:
    """Advance sharded DQN by `num_steps` on this rank, carrying the whole
    state (parameters, target, optimizer, the rank's ring and priorities,
    envs, counter): run(2N) equals run(N), a checkpoint, a restore and
    run(N) bit for bit on a fixed world. Step t of shard k draws from
    (seed, k, t); `draws` injects the global draws (module docstring). A
    state of host leaves is the global one."""
    ts, level, batch, rows, lvl = _sharded_run_setup(mesh, level, ts)
    _, local_b, local_cfg, _, _, _ = _dqn_sharded_layout(mesh, cfg, pack_level(level), batch)
    learner = dqn_learner(sem, lvl, local_cfg, local_b)
    step = None
    if draws is not None:
        explore, rand_a, sample = draws

        def step(i):
            return (_rank_noise(explore[i][None], rows, mesh.device)[0],
                    _rank_noise(rand_a[i][None], rows, mesh.device)[0],
                    sample[i].chunk(mesh.size)[mesh.rank].to(mesh.device))

    return _dqn_steps_eager(sem, mesh.device, learner, local_cfg, ts, num_steps, shard_seed(ts.seed, mesh.rank),
                            step, _rank_mean(mesh))


def dqn_train_sharded(mesh: EnvMesh, sem: Semantics, level: Level, seed: int, cfg: DQNConfig = DQNConfig(),
                      num_steps: int = 2_000, batch_size: int = 64, init_params=None,
                      init_opt_state=None) -> DQNResult:
    """Data-parallel DQN: envs and the replay ring sharded over the ranks
    (each learns from its own shard's experience), the online and target
    networks replicated, gradients averaged over the ranks each step.
    `dqn_init_sharded`, `dqn_run_sharded` and the result, the same on every
    rank. `init_params` / `init_opt_state` warm-start from saved parameters
    (the target restarts as their copy; fresh envs and ring)."""
    ts = _warm_started(mesh, dqn_init_sharded(mesh, sem, level, seed, cfg, batch_size), init_params, init_opt_state)
    return _result_sharded(mesh, dqn_run_sharded(mesh, sem, level, ts, cfg, num_steps), dqn_result)


def greedy_q_actions(net, params: Params, obs, tiles=None) -> torch.Tensor:
    """Greedy action(s) under the Q-network. `tiles`: per-env tile planes,
    required iff `net` is a BatchedConvQNetwork (per-env levels)."""
    q = net.q_values(params, obs) if tiles is None else net.q_values(params, obs, tiles)
    return torch.argmax(q, dim=-1).to(torch.int32)
