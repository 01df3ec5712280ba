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


def test_compile_rollout_random_ignores_unroll_and_refuses_threefry():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    results = [tbp.compile_rollout_random(TSEM, bl, 64, 333, 100, unroll=u)(5) for u in (1, 16)]
    for (s0, st0), (s1, st1) in zip(results, results[1:]):
        assert torch.equal(s0.agent_idx, s1.agent_idx)
        for k in st0:
            assert torch.equal(st0[k], st1[k])
    with pytest.raises(ValueError, match="ROADMAP"):
        tbp.compile_rollout_random(TSEM, bl, 64, 10, rng="threefry")
    with pytest.raises(ValueError, match="ROADMAP"):
        tbp.rollout_random_bits(TSEM, bl, 0, 4, 10, rng="threefry")


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
