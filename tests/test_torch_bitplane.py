"""Port parity: griduniverse_tpu_torch.ops.bitplane against the JAX engine.

Packed words, lookups, steps and the plain PyTorch versions of K1
(`random_scan_bits_reference`) and K2 (`rollout_actions_bits_reference`)
are compared bit-exact with the reference; cross-env means with
rtol=1e-6 (the summation order differs). On the CPU the public functions
take the plain versions and launch nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.levels.maze import generate_mazes_device as j_mazes
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu.utils.oracle import OracleGridEnv
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.kernels.build import check_int
from griduniverse_tpu_torch.kernels.rollout import random_scan_bits_cuda
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def tt(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def assert_bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype in (np.float32, np.uint32):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def random_grid(rng, h, w):
    grid = rng.choice([0, 0, 0, 1, 1, 2, 3], size=(h, w)).astype(np.int32)
    grid[0, 0] = 0
    return grid


def level_pair(name, rng):
    if name == "empty8":
        return jb.empty_level(8, 8, goal=True), tb.empty_level(8, 8, goal=True, device=CPU)
    if name == "walls16":
        return jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    if name == "lava":
        return jb.lava_level(), tb.lava_level(device=CPU)
    h, w = {"random5x7": (5, 7), "random11x3": (11, 3)}[name]
    g = random_grid(rng, h, w)
    return J.make_level(g, 0), T.make_level(g, 0, device=CPU)


LEVELS = ["empty8", "walls16", "lava", "random5x7", "random11x3"]


def maze_pair(seed, b, cells=(4, 4)):
    grids, start = j_mazes(jax.random.PRNGKey(seed), cells, b, algorithm="binary_tree")
    jl = JLevel(grid=grids, start_idx=jnp.full((b,), start, jnp.int32))
    return jl, convert.to_level(jl, device=CPU)


@pytest.mark.parametrize("name", LEVELS)
def test_pack_level_words_and_tile_code(name, rng):
    jl, tl = level_pair(name, rng)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    assert tbl.code_words.dtype == torch.int32
    assert_bits_equal(np.asarray(jbl.code_words), tbl.code_words)
    assert_bits_equal(jbl.start_code, tbl.start_code)
    idx = torch.arange(tl.num_states, dtype=torch.int32)
    np.testing.assert_array_equal(tbp.tile_code(tbl, idx).numpy(), tl.grid.reshape(-1).numpy())
    conv = convert.to_bit_level(jbl, device=CPU)
    assert torch.equal(conv.code_words, tbl.code_words)
    assert (conv.height, conv.width) == (tbl.height, tbl.width)


def test_pack_level_batched_and_tile_code():
    jl, tl = maze_pair(3, 16, cells=(3, 3))
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    assert tbl.batched and tbl.code_words.shape == (16, 4)
    assert_bits_equal(np.asarray(jbl.code_words), tbl.code_words)
    assert_bits_equal(jbl.start_code, tbl.start_code)
    s = tl.num_states
    idx = torch.arange(s, dtype=torch.int32).expand(16, s)
    np.testing.assert_array_equal(tbp.tile_code(tbl, idx).numpy(), tl.grid.reshape(16, s).numpy())


@pytest.mark.parametrize("auto_reset,max_ep", [(False, None), (True, None), (True, 4)])
def test_step_bits_matches_jax(auto_reset, max_ep, rng):
    jl, tl = jb.lava_level(), tb.lava_level(device=CPU)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    b = 64
    grid = np.asarray(jl.grid).reshape(-1)
    idx = rng.choice(np.flatnonzero(grid != J.WALL), size=b).astype(np.int32)
    st = jbp.FastState(
        agent_idx=jnp.asarray(idx), agent_code=jnp.asarray(grid[idx]),
        t=jnp.asarray(rng.integers(0, 6, size=b).astype(np.int32)),
        done=jnp.asarray(rng.random(b) < 0.3),
    )
    actions = rng.integers(0, 4, size=b).astype(np.int32)
    jnew, jout = jbp.step_bits(JSEM, jbl, st, jnp.asarray(actions), auto_reset, max_ep)
    tnew, tout = tbp.step_bits(TSEM, tbl, convert.to_fast_state(st, device=CPU), tt(actions), auto_reset, max_ep)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert_bits_equal(getattr(jnew, f), getattr(tnew, f))
    for a, b_ in zip(jout, tout):
        assert_bits_equal(a, b_)
    with pytest.raises(ValueError):
        tbp.step_bits(TSEM, tbl, convert.to_fast_state(st, device=CPU), tt(actions), False, 5)


def _rollout_both(jbl, tbl, actions, b, auto_reset, max_ep):
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    _, jout = jax.jit(jbp.rollout_actions_bits, static_argnames=("auto_reset", "max_episode_steps"))(
        JSEM, jbl, jst, jnp.asarray(actions), auto_reset=auto_reset, max_episode_steps=max_ep
    )
    tst = tbp.reset_bits(tbl, None if tbl.batched else b)
    tfinal, tout = tbp.rollout_actions_bits_reference(TSEM, tbl, tst, tt(actions), auto_reset, max_ep)
    for a, b_ in zip(jout, tout):
        assert_bits_equal(a, b_)
    return tfinal


@pytest.mark.parametrize("name", LEVELS)
@pytest.mark.parametrize("auto_reset", [False, True])
def test_single_env_rollout_matches_jax(name, auto_reset, rng):
    jl, tl = level_pair(name, rng)
    actions = rng.integers(0, 4, size=(500, 1)).astype(np.int32)
    _rollout_both(jbp.pack_level(jl), tbp.pack_level(tl), actions, 1, auto_reset, None)


@pytest.mark.parametrize("max_episode_steps", [None, 13])
def test_batched_rollout_with_truncation_matches_jax(max_episode_steps, rng):
    jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    actions = rng.integers(0, 4, size=(300, 64)).astype(np.int32)
    _rollout_both(jbp.pack_level(jl), tbp.pack_level(tl), actions, 64, True, max_episode_steps)


@pytest.mark.parametrize("auto_reset", [False, True])
def test_per_env_maze_rollout_matches_jax(auto_reset, rng):
    jl, tl = maze_pair(5, 8)
    actions = rng.integers(0, 4, size=(200, 8)).astype(np.int32)
    _rollout_both(jbp.pack_level(jl), tbp.pack_level(tl), actions, 8, auto_reset, None)


def test_rollout_matches_oracle(rng):
    level = tb.lava_level(device=CPU)
    bl = tbp.pack_level(level)
    actions = rng.integers(0, 4, size=400).astype(np.int32)
    env = OracleGridEnv(level.grid.numpy(), int(level.start_idx), auto_reset=True)
    o_obs, o_rew, o_done = env.run_actions(actions)
    _, (obs, rew, done) = tbp.rollout_actions_bits(TSEM, bl, tbp.reset_bits(bl), tt(actions)[:, None], True)
    assert_bits_equal(o_obs, obs[:, 0])
    assert_bits_equal(o_rew, rew[:, 0])
    assert_bits_equal(o_done, done[:, 0])


def test_xorshift_matches_jax():
    for seed, offset in ((123, 0), (2**32 - 5, 70_000), (7, 2**31 + 3)):
        js = jbp.xorshift_init(jnp.uint32(seed), (4, 64), offset=offset)
        ts = tbp.xorshift_init(seed, (4, 64), offset=offset, device=CPU)
        assert ts.dtype == torch.int32 and ts.shape == (4, 64)
        assert_bits_equal(np.asarray(js), ts)
        for _ in range(20):
            js, jbits = jbp.xorshift_next(js)
            ts, tbits = tbp.xorshift_next(ts)
            assert_bits_equal(np.asarray(jbits), tbits)
        assert_bits_equal(np.asarray(js), ts)


@pytest.mark.parametrize("level", ["walls16", "mazes"])
def test_random_scan_bits_reference_matches_jax(level, rng):
    """K1's plain version equals the reference's xorshift scan per env."""
    b, steps, max_ep = 256, 500, 100
    if level == "walls16":
        jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    else:
        jl, tl = maze_pair(9, b)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    jrs = jbp.xorshift_init(jnp.uint32(7), (b,))
    ref = jax.jit(
        lambda s, r: jbp.random_scan_bits(JSEM, jbl, s, r, None, steps, max_ep, "xorshift")
    )(jst, jrs)
    tst = tbp.reset_bits(tbl, None if tbl.batched else b)
    got = tbp.random_scan_bits_reference(TSEM, tbl, tst, tbp.xorshift_init(7, (b,), device=CPU), steps, max_ep)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert_bits_equal(getattr(ref[0], f), getattr(got[0], f))
    for a, b_ in zip(ref[1:], got[1:]):
        assert_bits_equal(a, b_)
    assert int(got[1].sum()) > 0


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    before = dict(kernels.LAUNCHES)
    st = tbp.reset_bits(bl, 32)
    rs = tbp.xorshift_init(3, (32,), device=CPU)
    got = tbp.random_scan_bits(TSEM, bl, st, rs, None, 50, 20, unroll=8)
    ref = tbp.random_scan_bits_reference(TSEM, bl, st, rs, 50, 20)
    for a, b_ in zip(got[1:], ref[1:]):
        assert torch.equal(a, b_)
    actions = torch.randint(0, 4, (30, 32), generator=torch.Generator().manual_seed(0))
    tbp.rollout_actions_bits(TSEM, bl, st, actions, True, 10)
    tbp.compile_rollout_random(TSEM, bl, 32, 20)(1)
    assert kernels.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors_and_mixed_devices():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    st = tbp.reset_bits(bl, 4)
    with pytest.raises(ValueError, match="CUDA"):
        random_scan_bits_cuda(
            TSEM.passable, TSEM.terminal, TSEM.reward, TSEM.deltas,
            bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width,
            st.agent_idx, st.agent_code, st.t, tbp.xorshift_init(0, (4,), device=CPU), 10, None,
        )
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(1), torch.device("meta"))
    assert check_int("n", 2**31 - 1) == 2**31 - 1
    for bad in (2**31, -1):
        with pytest.raises(ValueError):
            check_int("n", bad)


@pytest.mark.parametrize("max_ep", [None, 100])
def test_rollout_random_bits_stats_match_jax(max_ep):
    jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    _, ref = jbp.rollout_random_bits(JSEM, jbl, jnp.uint32(7), 256, 500, max_episode_steps=max_ep)
    _, got = tbp.rollout_random_bits(TSEM, tbl, 7, 256, 500, max_episode_steps=max_ep)
    assert int(got["episodes"]) == int(ref["episodes"])
    for k in ("mean_return", "mean_length"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


def test_compile_rollout_random_ignores_unroll_and_takes_threefry():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    for rng in ("xorshift", "threefry"):
        results = [tbp.compile_rollout_random(TSEM, bl, 64, 333, 100, rng, unroll=u)(5) for u in (1, 16)]
        direct = tbp.rollout_random_bits(TSEM, bl, 5, 64, 333, 100, rng=rng)
        for (s0, st0), (s1, st1) in zip(results, [*results[1:], direct]):
            assert torch.equal(s0.agent_idx, s1.agent_idx)
            for k in st0:
                assert torch.equal(st0[k], st1[k])
    xs = tbp.rollout_random_bits(TSEM, bl, 5, 64, 333, 100)[0]
    assert not torch.equal(results[0][0].agent_idx, xs.agent_idx)  # two streams
    with pytest.raises(ValueError, match="rng"):
        tbp.compile_rollout_random(TSEM, bl, 64, 10, rng="philox")
    with pytest.raises(ValueError, match="rng"):
        tbp.rollout_random_bits(TSEM, bl, 0, 4, 10, rng="philox")


# ---------------------------------------------------------------------------
# The threefry action stream: Threefry-2x32-20 blocks of (step pair, lane)
# under the key (0, seed).
# ---------------------------------------------------------------------------

# Random123's known-answer vectors of threefry2x32_20: key, counter, block.
THREEFRY_KAT = (
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
)


def test_threefry_block_matches_known_answers_and_jax(rng):
    from jax._src.prng import threefry_2x32

    for key, (c0, c1), want in THREEFRY_KAT:
        got = tbp.threefry2x32(key, torch.tensor([c0]), torch.tensor([c1]))
        assert (int(got[0]), int(got[1])) == want
    for _ in range(8):
        key = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
        count = rng.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
        ref = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count.reshape(-1)))).reshape(2, 64)
        x0, x1 = tbp.threefry2x32(tuple(int(k) for k in key), *(torch.as_tensor(c.astype(np.int64)) for c in count))
        np.testing.assert_array_equal(ref[0], x0.numpy().astype(np.uint32))
        np.testing.assert_array_equal(ref[1], x1.numpy().astype(np.uint32))


def test_threefry_stream_layout():
    """Step g of lane l is word g & 1 of the block of (g >> 1, l) under
    (0, seed); actions are its bits 9 and up, modulo A."""
    keys = tbp.threefry_keys(2**32 + 11, step=5, offset=40)
    assert keys.key == (0, 11)
    words = list(tbp._threefry_words(keys, 3, 4, CPU))
    lanes = torch.arange(40, 43)
    for s, w in enumerate(words):
        g = 5 + s
        block = tbp.threefry2x32((0, 11), torch.full_like(lanes, g >> 1), lanes)
        assert torch.equal(w, block[g & 1])


@pytest.mark.parametrize("seed", [0, 11, 2**31, 2**32 - 1, 2**32 + 11, -1, -5, -2**31 - 1])
def test_threefry_keys_are_jax_prng_keys(seed):
    """The key is what JAX's default `PRNGKey(seed)` holds: (0, seed mod
    2^32), for seeds outside [0, 2^32) too."""
    assert tbp.threefry_keys(seed).key == tuple(int(k) for k in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("level,max_ep", [("walls16", None), ("walls16", 100), ("lava", 100)])
def test_threefry_scan_with_injected_jax_draws_matches_jax_stats(level, max_ep):
    """The reference's threefry draws, built as its scan body builds them and
    injected into the port's plain scan, give its `rollout_random_bits(
    rng="threefry")` statistics."""
    b, steps, seed = 256, 500, 7
    jl, tl = (jb.lava_level(), tb.lava_level(device=CPU)) if level == "lava" else (
        jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU))
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    _, ref = jbp.rollout_random_bits(JSEM, jbl, jnp.uint32(seed), b, steps, max_episode_steps=max_ep,
                                     rng="threefry")
    keys = jax.random.split(jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32)), steps)
    draws = jax.vmap(lambda k: jax.random.randint(k, (b,), 0, 4, jnp.int32))(keys)
    st = tbp.reset_bits(tbl, b)
    _, n_eps, ret_sum, len_sum = tbp.random_scan_bits_reference(TSEM, tbl, st, None, steps, max_ep,
                                                                actions=tt(draws))
    n = n_eps.sum()
    assert int(n) == int(ref["episodes"]) > 0
    np.testing.assert_allclose(float(ret_sum.sum() / n), float(ref["mean_return"]), rtol=1e-6)
    np.testing.assert_allclose(float(len_sum.sum() / n), float(ref["mean_length"]), rtol=1e-6)
    with pytest.raises(ValueError, match="actions"):
        tbp.random_scan_bits_reference(TSEM, tbl, st, None, steps - 1, max_ep, actions=tt(draws))


def test_threefry_rollout_stats():
    """The aggregate checks the reference's own tests make of both streams."""
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    for rng_kind in ("xorshift", "threefry"):
        _, stats = tbp.rollout_random_bits(TSEM, bl, 7, 256, 500, max_episode_steps=200, rng=rng_kind)
        assert int(stats["episodes"]) > 0
        assert 1.0 <= float(stats["mean_length"]) <= 200.0
        assert float(stats["mean_return"]) < 0.0
    _, stats = tbp.rollout_random_bits(TSEM, tbp.pack_level(tb.lava_level(device=CPU)), 7, 256, 500,
                                       max_episode_steps=200, rng="threefry")
    _, ref = jbp.rollout_random_bits(JSEM, jbp.pack_level(jb.lava_level()), jnp.uint32(7), 256, 500,
                                     max_episode_steps=200, rng="threefry")
    # a different stream of the same law: the lava level's episodes agree to a few percent
    np.testing.assert_allclose(float(stats["mean_length"]), float(ref["mean_length"]), rtol=0.1)
    np.testing.assert_allclose(float(stats["episodes"]), float(ref["episodes"]), rtol=0.1)


@pytest.mark.parametrize("split", [250, 251])
@pytest.mark.parametrize("level", ["walls16", "mazes"])
def test_threefry_two_chunks_equal_one_run(split, level):
    b, steps, max_ep = 64, 500, 30
    tl = tb.walls_and_goal_16x16(device=CPU) if level == "walls16" else maze_pair(4, b)[1]
    bl = tbp.pack_level(tl)
    st = tbp.reset_bits(bl, None if bl.batched else b)
    one = tbp.random_scan_bits(TSEM, bl, st, None, tbp.threefry_keys(9), steps, max_ep, "threefry")
    first = tbp.random_scan_bits(TSEM, bl, st, None, tbp.threefry_keys(9), split, max_ep, "threefry")
    second = tbp.random_scan_bits(TSEM, bl, first[0], None, tbp.threefry_keys(9, step=split), steps - split,
                                  max_ep, "threefry")
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert torch.equal(getattr(one[0], f), getattr(second[0], f))
    assert torch.equal(one[1], first[1] + second[1])
    assert torch.equal(one[3], first[3] + second[3])
    assert int(one[1].sum()) > 0


def test_threefry_lane_offsets_split_the_batch():
    bl = tbp.pack_level(tb.lava_level(device=CPU))
    whole = tbp.random_scan_bits(TSEM, bl, tbp.reset_bits(bl, 96), None, tbp.threefry_keys(3), 300, 40, "threefry")
    halves = [tbp.random_scan_bits(TSEM, bl, tbp.reset_bits(bl, n), None, tbp.threefry_keys(3, offset=o), 300, 40,
                                   "threefry") for o, n in ((0, 40), (40, 56))]
    for k in range(1, 4):
        assert torch.equal(whole[k], torch.cat([h[k] for h in halves]))
    assert torch.equal(whole[0].agent_idx, torch.cat([h[0].agent_idx for h in halves]))


def test_random_scan_bits_checks_its_stream():
    bl = tbp.pack_level(tb.lava_level(device=CPU))
    st = tbp.reset_bits(bl, 4)
    rs = tbp.xorshift_init(0, (4,), device=CPU)
    with pytest.raises(ValueError, match="ThreefryKeys"):
        tbp.random_scan_bits(TSEM, bl, st, rs, None, 10, None, "threefry")
    with pytest.raises(ValueError, match="no keys"):
        tbp.random_scan_bits(TSEM, bl, st, rs, tbp.threefry_keys(0), 10, None, "xorshift")
    with pytest.raises(ValueError, match="rng"):
        tbp.random_scan_bits(TSEM, bl, st, rs, None, 10, None, "philox")
    # rs is not read under threefry
    got = tbp.random_scan_bits(TSEM, bl, st, rs, tbp.threefry_keys(0), 10, None, "threefry")
    ref = tbp.random_scan_bits(TSEM, bl, st, None, tbp.threefry_keys(0), 10, None, "threefry")
    assert all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))


def test_pack_level_rejects_huge_grids():
    with pytest.raises(ValueError):
        tbp.pack_level(T.make_level(np.zeros((200, 200), np.int32), 0, device=CPU))


# ---------------------------------------------------------------------------
# More than four actions: 9 (the eight king moves and a stay) and 25 (every
# move of at most two rows and two columns). The reference takes any
# `action_deltas`; the port's plain versions of K1 and K2 must follow it.
# ---------------------------------------------------------------------------

ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


def sem_pair(a):
    deltas = ACTION_SETS[a]
    return (J.make_semantics(J.SemanticsConfig(action_deltas=deltas)),
            T.make_semantics(T.SemanticsConfig(action_deltas=deltas), device=CPU))


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("level,auto_reset,max_ep", [("walls16", False, None), ("walls16", True, None),
                                                      ("walls16", True, 64), ("mazes", True, 64),
                                                      ("mazes", False, None)])
def test_rollout_matches_jax_at_more_actions(a, level, auto_reset, max_ep, rng):
    """K2's plain version against `rollout_actions_bits` of the JAX engine,
    actions drawn over 0..A−1 and a few outside it (clamped as XLA's
    gather), on a shared level and on per-env mazes, in the three modes."""
    jsem, tsem = sem_pair(a)
    b = 64
    if level == "walls16":
        jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    else:
        jl, tl = maze_pair(6, b)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    actions = rng.integers(-1, a + 1, size=(100, b)).astype(np.int32)
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    jfinal, jout = jax.jit(jbp.rollout_actions_bits, static_argnames=("auto_reset", "max_episode_steps"))(
        jsem, jbl, jst, jnp.asarray(actions), auto_reset=auto_reset, max_episode_steps=max_ep
    )
    tst = tbp.reset_bits(tbl, None if tbl.batched else b)
    tfinal, tout = tbp.rollout_actions_bits_reference(tsem, tbl, tst, tt(actions), auto_reset, max_ep)
    for x, y in zip(jout, tout):
        assert_bits_equal(x, y)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert_bits_equal(getattr(jfinal, f), getattr(tfinal, f))
    # the public function takes the plain version for CPU tensors
    _, pub = tbp.rollout_actions_bits(tsem, tbl, tst, tt(actions), auto_reset, max_ep)
    assert all(torch.equal(x, y) for x, y in zip(pub, tout))


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("level", ["walls16", "mazes"])
def test_random_scan_bits_reference_matches_jax_at_more_actions(a, level):
    """K1's plain version against the reference's xorshift scan at A > 4:
    the action is (x >> 9) mod A."""
    jsem, tsem = sem_pair(a)
    b, steps, max_ep = 128, 300, 60
    if level == "walls16":
        jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    else:
        jl, tl = maze_pair(10, b)
    jbl, tbl = jbp.pack_level(jl), tbp.pack_level(tl)
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    ref = jax.jit(
        lambda s, r: jbp.random_scan_bits(jsem, jbl, s, r, None, steps, max_ep, "xorshift")
    )(jst, jbp.xorshift_init(jnp.uint32(11), (b,)))
    tst = tbp.reset_bits(tbl, None if tbl.batched else b)
    got = tbp.random_scan_bits_reference(tsem, tbl, tst, tbp.xorshift_init(11, (b,), device=CPU), steps, max_ep)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert_bits_equal(getattr(ref[0], f), getattr(got[0], f))
    for x, y in zip(ref[1:], got[1:]):
        assert_bits_equal(x, y)
    assert int(got[1].sum()) > 0
