"""Bit-packed step engine — the throughput path.

PyTorch counterpart of `griduniverse_tpu/ops/bitplane.py`. A level's tile
codes are packed 16 to a 32-bit word, 2 bits each (`BitLevel`), state 16k
in the low bits of word k. The words are stored as `torch.int32` holding
the bit pattern of the reference's `uint32` words: torch cannot shift
`uint32` tensors on the CPU.

The reference looks a code up with a select tree over the words because
the TPU has no cross-lane gather. Here a lookup is one index into the
words, both in the plain PyTorch functions and in the CUDA kernels.

Two functions have a hand-written CUDA kernel (`csrc/rollout.cu`):
  * `random_scan_bits` (K1) — the fused random-action auto-reset scan;
  * `rollout_actions_bits` (K2) — the pre-drawn-action rollout.
Each picks its path by device: CPU tensors take the plain version beside
it (`*_reference`), CUDA tensors launch the kernel, or raise.

K1 draws its actions from one of two streams (`rng=`):
  * "xorshift" — a per-env xorshift32 state (`xorshift_init`), the
    reference's stream bit for bit;
  * "threefry" — Threefry-2x32 with 20 rounds (Salmon et al., SC'11; the
    cipher under `jax.random`), keyed by `ThreefryKeys`. The block of env
    lane l at pair index p enciphers the counter (p, l) under the key
    (0, seed), the pair `PRNGKey(seed)` holds, and gives the words of two
    consecutive steps: global step g draws word g & 1 of the block at
    p = g >> 1. l is the env's global lane (its index plus the lane offset,
    as `xorshift_init`'s `offset`), so chunked and sharded scans draw what
    one unbroken scan draws. JAX's `split` / `randint` draws are not
    reproduced: a test that holds the port against them injects them.
A word becomes an action as `(word >> 9) % A` in both streams.

Semantics are identical to core.step; out-of-range actions are clamped as
in core.step (the reference's select tree reads only their low bits).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import kernels
from ..core.semantics import Semantics
from ..core.step import clamp_actions
from ..core.types import Level
from ..kernels.rollout import random_scan_bits_cuda, rollout_actions_bits_cuda
from ..utils.platform import resolve_device

# 4 tile codes → 2 bits each → 16 codes per 32-bit word.
CODE_BITS = 2
CODES_PER_WORD = 32 // CODE_BITS
CODE_MASK = (1 << CODE_BITS) - 1

# Largest level `pack_level` takes (1024 words, 4 KB of shared memory).
MAX_PACKED_STATES = 16_384

_U32 = 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_uint32_values(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern → int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _U32


@dataclasses.dataclass
class BitLevel:
    """A level with tile codes bit-packed 16 per word.

    code_words — (Wn,) int32 (shared level) or (B, Wn) (per-env levels).
    start_idx  — () or (B,) int32 row-major start state.
    start_code — () or (B,) int32 tile code at the start state.
    height, width — grid shape.
    """

    code_words: torch.Tensor
    start_idx: torch.Tensor
    start_code: torch.Tensor
    height: int
    width: int

    @property
    def num_states(self) -> int:
        return self.height * self.width

    @property
    def batched(self) -> bool:
        return self.code_words.dim() == 2

    @property
    def device(self) -> torch.device:
        return self.code_words.device


def pack_level(level: Level, *, device=None) -> BitLevel:
    """Pack a Level's tile codes (shared or per env) on `device` (default:
    the level's)."""
    grid = level.grid if device is None else level.grid.to(device)
    h, w = int(grid.shape[-2]), int(grid.shape[-1])
    s = h * w
    if s > MAX_PACKED_STATES:
        raise ValueError(
            f"pack_level: {s} states exceeds MAX_PACKED_STATES "
            f"({MAX_PACKED_STATES}); use the gather-based core.step path"
        )
    codes = grid.reshape(*grid.shape[:-2], s).to(torch.int64)
    n_words = -(-s // CODES_PER_WORD)
    codes = F.pad(codes, (0, n_words * CODES_PER_WORD - s))
    lanes = codes.reshape(*codes.shape[:-1], n_words, CODES_PER_WORD)
    shifts = torch.arange(CODES_PER_WORD, device=grid.device) * CODE_BITS
    # fields are disjoint (each code < 2^CODE_BITS), so sum == bitwise OR
    words = to_int32_bits((lanes << shifts).sum(-1))
    start_idx = level.start_idx.to(device=grid.device, dtype=torch.int32)
    bl = BitLevel(words, start_idx, torch.zeros_like(start_idx), h, w)
    bl.start_code = tile_code(bl, start_idx)
    return bl


def tile_code(bl: BitLevel, idx: torch.Tensor) -> torch.Tensor:
    """Tile code at state `idx` — one word lookup, then shift and mask.

    idx — int32, any shape for a shared BitLevel; for a batched one its
    leading axis is the level batch.
    """
    wsel = (idx >> 4).long()
    if bl.batched:
        b = bl.code_words.shape[0]
        word = bl.code_words.gather(1, wsel.reshape(b, -1)).reshape(idx.shape)
    else:
        word = bl.code_words[wsel]
    shift = (idx & (CODES_PER_WORD - 1)) * CODE_BITS
    return ((word >> shift) & CODE_MASK).to(torch.int32)


def move_bits(sem: Semantics, bl: BitLevel, agent_idx, agent_code, action):
    """Core transition mirroring core.step._move:
    (idx, code, action) → (new_idx, new_code, reward, done)."""
    h, w = bl.height, bl.width
    a = clamp_actions(action, sem.num_actions)
    row = agent_idx // w
    col = agent_idx - row * w
    nrow = row + sem.deltas[a, 0]
    ncol = col + sem.deltas[a, 1]
    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    cand_idx = (nrow.clamp(0, h - 1) * w + ncol.clamp(0, w - 1)).to(torch.int32)
    cand_code = tile_code(bl, cand_idx)
    blocked = ~in_bounds | ~sem.passable[cand_code.long()]
    new_idx = torch.where(blocked, agent_idx, cand_idx)
    new_code = torch.where(blocked, agent_code, cand_code)
    return new_idx, new_code, sem.reward[new_code.long()], sem.terminal[new_code.long()]


@dataclasses.dataclass
class FastState:
    """Rollout carry of the bitplane engine, each field (B,): the agent
    index, its tile code, the episode step counter (int32) and the done
    flag (bool; used only by the freeze-on-done mode)."""

    agent_idx: torch.Tensor
    agent_code: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor


def reset_bits(bl: BitLevel, batch_size: int | None = None) -> FastState:
    """All envs at the level start: B=`batch_size` (default 1) for a shared
    BitLevel; a batched BitLevel implies its own B."""
    if bl.batched:
        b = int(bl.code_words.shape[0])
        if batch_size is not None and batch_size != b:
            raise ValueError(f"batch_size {batch_size} != batched BitLevel's {b} levels")
    else:
        b = 1 if batch_size is None else int(batch_size)
    return FastState(
        agent_idx=bl.start_idx.expand(b).clone(),
        agent_code=bl.start_code.expand(b).clone(),
        t=torch.zeros(b, dtype=torch.int32, device=bl.device),
        done=torch.zeros(b, dtype=torch.bool, device=bl.device),
    )


def step_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    action: torch.Tensor,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
):
    """One batched step; semantics match core.step exactly:

      auto_reset=True  → step_autoreset (+ optional time-limit truncation);
      auto_reset=False → step (freeze after termination, no truncation).

    Returns (new FastState, (obs, reward, done)).
    """
    if max_episode_steps is not None and not auto_reset:
        raise ValueError("max_episode_steps requires auto_reset=True")
    new_idx, new_code, reward, done = move_bits(
        sem, bl, state.agent_idx, state.agent_code, action
    )
    if auto_reset:
        if max_episode_steps is not None:
            done = done | ((state.t + 1) >= max_episode_steps)
        next_state = FastState(
            agent_idx=torch.where(done, bl.start_idx, new_idx),
            agent_code=torch.where(done, bl.start_code, new_code),
            t=torch.where(done, 0, state.t + 1).to(torch.int32),
            done=torch.zeros_like(done),
        )
        return next_state, (new_idx, reward, done)

    was_done = state.done
    agent_idx = torch.where(was_done, state.agent_idx, new_idx)
    next_state = FastState(
        agent_idx=agent_idx,
        agent_code=torch.where(was_done, state.agent_code, new_code),
        t=torch.where(was_done, state.t, state.t + 1),
        done=was_done | done,
    )
    reward = torch.where(was_done, torch.zeros_like(reward), reward)
    return next_state, (agent_idx, reward, next_state.done)


def _sem_level_args(sem: Semantics, bl: BitLevel):
    return (
        sem.passable, sem.terminal, sem.reward, sem.deltas,
        bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width,
    )


def rollout_actions_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    actions: torch.Tensor,
    auto_reset: bool = False,
    max_episode_steps: int | None = None,
):
    """Pre-drawn-action rollout over (T, B) actions (K2 on CUDA).

    Returns (final FastState, (obs, reward, done)), each trajectory (T, B).
    """
    if max_episode_steps is not None and not auto_reset:
        raise ValueError("max_episode_steps requires auto_reset=True")
    if not kernels.on_cuda(actions, state.agent_idx, bl.code_words, sem.deltas):
        return rollout_actions_bits_reference(
            sem, bl, state, actions, auto_reset, max_episode_steps
        )
    idx, code, t, done, obs, reward, done_traj = rollout_actions_bits_cuda(
        *_sem_level_args(sem, bl),
        state.agent_idx, state.agent_code, state.t, state.done,
        actions.to(torch.int32).contiguous(), auto_reset, max_episode_steps,
    )
    return FastState(idx, code, t, done), (obs, reward, done_traj)


def rollout_actions_bits_reference(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    actions: torch.Tensor,
    auto_reset: bool = False,
    max_episode_steps: int | None = None,
):
    """Plain PyTorch version of K2: a Python loop of `step_bits`."""
    if actions.dim() != 2:
        raise ValueError(f"actions must be (T, B), got shape {tuple(actions.shape)}")
    obs, rew, don = [], [], []
    for a in actions:
        state, (o, r, d) = step_bits(sem, bl, state, a, auto_reset, max_episode_steps)
        obs.append(o)
        rew.append(r)
        don.append(d)
    b = state.agent_idx.shape[0]
    if not obs:
        empty = torch.empty((0, b), device=bl.device)
        return state, (empty.int(), empty.float(), empty.bool())
    return state, (torch.stack(obs), torch.stack(rew), torch.stack(don))


# ---------------------------------------------------------------------------
# In-scan action RNG: a per-env xorshift32 stream, bit-for-bit the
# reference's. States are int32 tensors holding the uint32 bit pattern; the
# plain code computes on int64 masked to 32 bits.
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def xorshift_init(seed, batch_shape, offset: int = 0, *, device=None) -> torch.Tensor:
    """Per-env xorshift32 states from a scalar seed, as int32 bit patterns,
    on `device` (default: the card).

    `offset` shifts the env-id lane numbering, so a shard can pass its
    global env offset and get the streams of an unsharded run.
    """
    device = resolve_device(device)
    n = 1
    for d in batch_shape:
        n *= int(d)
    lanes = (torch.arange(n, dtype=torch.int64, device=device) + int(offset)) & _U32
    s = _mul32(lanes, 2654435761) ^ (int(seed) & _U32)
    return to_int32_bits(s | 1).reshape(tuple(batch_shape))


def _xorshift_step(s: torch.Tensor) -> torch.Tensor:
    s = s ^ ((s << 13) & _U32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _U32)


def xorshift_next(s: torch.Tensor):
    """One xorshift32 round: (state) → (new state, random bits), int32."""
    s = to_int32_bits(_xorshift_step(to_uint32_values(s)))
    return s, s


# Threefry-2x32's rotations (two sets of four rounds, alternating) and the
# parity word of its key schedule.
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


@dataclasses.dataclass(frozen=True)
class ThreefryKeys:
    """Where a threefry scan draws: the cipher key (two uint32 words), the
    global step of the scan's first draw and the env lane offset."""

    key: tuple[int, int]
    step: int = 0
    offset: int = 0


def threefry_keys(seed, step: int = 0, offset: int = 0) -> ThreefryKeys:
    """The stream of `PRNGKey(seed)`'s key (0, seed mod 2^32) from global
    `step`, for envs numbered from `offset`. The seed is taken modulo 2^32,
    as the reference's `PRNGKey(jnp.asarray(seed, jnp.uint32))` and JAX's
    default 32-bit `PRNGKey(seed)` take it: seeds 11 and 2^32 + 11 draw
    the same stream, and seed -1 is (0, 2^32 - 1)."""
    return ThreefryKeys((0, int(seed) & _U32), int(step), int(offset))


def _rotl32(x, r: int):
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 values in [0, 2^32): the block of
    counter (x0, x1) under `key` (two ints), as two int64 tensors."""
    k0, k1 = (int(k) & _U32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _threefry_words(keys: ThreefryKeys, batch: int, num_steps: int, device):
    """The threefry stream's words, one (B,) int64 tensor a step."""
    lanes = (torch.arange(batch, dtype=torch.int64, device=device) + keys.offset) & _U32
    odd = None
    for s in range(num_steps):
        g = keys.step + s
        if g % 2 == 0 or s == 0:
            even, odd = threefry2x32(keys.key, torch.full_like(lanes, (g >> 1) & _U32), lanes)
            yield odd if g % 2 else even
        else:
            yield odd


RNGS = ("xorshift", "threefry")


def _check_rng_name(rng: str):
    if rng not in RNGS:
        raise ValueError(f"rng={rng!r}: expected one of {RNGS}")


def _check_rng(rng: str, keys):
    """The xorshift stream takes no keys, the threefry stream its
    `ThreefryKeys`."""
    _check_rng_name(rng)
    if rng == "threefry" and not isinstance(keys, ThreefryKeys):
        raise ValueError(f"rng='threefry' takes ThreefryKeys as keys, got {type(keys).__name__}")
    if rng == "xorshift" and keys is not None:
        raise ValueError("rng='xorshift' draws from rs and takes no keys")


def random_scan_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    rs: torch.Tensor,
    keys,
    num_steps: int,
    max_episode_steps: int | None,
    rng: str = "xorshift",
    unroll: int = 1,
):
    """The fused random-action auto-reset scan (K1 on CUDA), returning the
    final state and the PER-ENV accumulators (n_eps int32, folded ret_sum
    float32, folded len_sum int32). `rng="xorshift"` draws from the
    per-env states `rs` and takes `keys=None`; `rng="threefry"` draws from
    the `ThreefryKeys` `keys` and ignores `rs`. `unroll` is accepted and
    ignored."""
    del unroll
    _check_rng(rng, keys)
    rs = rs if rng == "xorshift" else None
    tensors = [x for x in (rs, state.agent_idx, bl.code_words, sem.deltas) if x is not None]
    if not kernels.on_cuda(*tensors):
        return random_scan_bits_reference(
            sem, bl, state, rs, num_steps, max_episode_steps, rng, keys
        )
    idx, code, t, done, n_eps, ret_sum, len_sum = random_scan_bits_cuda(
        *_sem_level_args(sem, bl),
        state.agent_idx, state.agent_code, state.t, rs,
        num_steps, max_episode_steps, keys,
    )
    return FastState(idx, code, t, done), n_eps, ret_sum, len_sum


def random_scan_bits_reference(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    rs: torch.Tensor | None,
    num_steps: int,
    max_episode_steps: int | None,
    rng: str = "xorshift",
    keys: ThreefryKeys | None = None,
    actions: torch.Tensor | None = None,
):
    """Plain PyTorch version of K1: a Python loop of `step_bits`, the
    xorshift32 or threefry stream on int64 masked to 32 bits, and the
    reference's order of float adds. Given (T, B) `actions`, it steps
    those instead of drawing (`rng`, `keys` and `rs` unread)."""
    num_actions = sem.num_actions
    if actions is not None:
        if tuple(actions.shape) != (num_steps, state.agent_idx.shape[0]):
            raise ValueError(f"actions must be (num_steps, B), got {tuple(actions.shape)}")
        draws = iter(actions)
    else:
        _check_rng(rng, keys)
        if rng == "threefry":
            words = _threefry_words(keys, state.agent_idx.shape[0], num_steps, bl.device)
        else:
            words = _xorshift_words(to_uint32_values(rs), num_steps)
        draws = ((w >> 9) % num_actions for w in words)  # top bits are the strongest
    zf = torch.zeros(state.agent_idx.shape, dtype=torch.float32, device=bl.device)
    zi = torch.zeros(state.agent_idx.shape, dtype=torch.int32, device=bl.device)
    run_ret, ret_sum, n_eps, len_sum = zf, zf, zi, zi
    for a in draws:
        ep_len = state.t + 1
        state, (_, reward, done) = step_bits(
            sem, bl, state, a, True, max_episode_steps
        )
        run_ret = run_ret + reward
        n_eps = n_eps + done.to(torch.int32)
        ret_sum = ret_sum + torch.where(done, run_ret, zf)
        len_sum = len_sum + torch.where(done, ep_len, zi)
        run_ret = torch.where(done, zf, run_ret)
    return state, n_eps, ret_sum, len_sum


def _xorshift_words(s: torch.Tensor, num_steps: int):
    """The xorshift32 stream's words, one (B,) int64 tensor a step."""
    for _ in range(num_steps):
        s = _xorshift_step(s)
        yield s


def rollout_random_bits(
    sem: Semantics,
    bl: BitLevel,
    seed,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    rng: str = "xorshift",
):
    """Fused random-action auto-reset rollout with on-device episode stats.
    `rng` — "xorshift" (`xorshift_init(seed)`) or "threefry"
    (`threefry_keys(seed)`). Returns (final FastState, stats dict of 0-d
    tensors)."""
    _check_rng_name(rng)
    state = reset_bits(bl, None if bl.batched else batch_size)
    if rng == "threefry":
        rs, keys = None, threefry_keys(seed)
    else:
        rs, keys = xorshift_init(seed, state.agent_idx.shape, device=bl.device), None
    state, n_eps, ret_sum, len_sum = random_scan_bits(
        sem, bl, state, rs, keys, num_steps, max_episode_steps, rng
    )
    # cross-env sums in int64: the reference's int32 sum of len_sum wraps
    # once B·T passes 2^31
    n = n_eps.sum()
    denom = n.clamp(min=1)
    stats = {
        "episodes": n,
        "mean_return": ret_sum.sum() / denom,
        "mean_length": len_sum.sum() / denom,
    }
    return state, stats


def compile_rollout_random(
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    rng: str = "xorshift",
    unroll: int = 16,
):
    """Factory of `fn(seed) -> (state, stats)` over fixed tables and level.
    `unroll` is a TPU scheduling knob, accepted and ignored."""
    del unroll
    _check_rng_name(rng)

    def fn(seed):
        return rollout_random_bits(
            sem, bl, seed, batch_size, num_steps, max_episode_steps, rng
        )

    return fn
