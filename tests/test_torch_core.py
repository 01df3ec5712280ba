"""Port parity: griduniverse_tpu_torch.core against the JAX core.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart. Trajectories, rewards and tables are compared
bit-exact (floats by their bits).

`python -m tests.test_torch_core`, run from the repo root, rewrites
tests/golden/torch/: the per-env maze grids of the cfg4 golden, which
chip_smoke.py reads without JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.core import step as jstep
from griduniverse_tpu.core.model import build_model_table as j_build_model_table
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.core.types import make_level as j_make_level
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.ops import rollout as jro
from griduniverse_tpu.utils.oracle import OracleGridEnv
from griduniverse_tpu_torch.core import step as tstep
from griduniverse_tpu_torch.core.model import build_model_table
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.ops import rollout as tro
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

GOLDEN_DIR = Path(__file__).parent / "golden"
TORCH_GOLDEN = GOLDEN_DIR / "torch" / "cfg4_mazes_grids.npz"
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)
KEY = jax.random.PRNGKey(0)


def assert_bits_equal(a, b):
    """Bit-exact equality of a JAX/numpy array and a torch tensor."""
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def random_grid(rng, h, w):
    grid = rng.choice([0, 0, 0, 1, 1, 2, 3], size=(h, w)).astype(np.int32)
    grid[0, 0] = 0
    return grid


def _levels(rng):
    """(name, JAX level, port level), shared levels."""
    g = random_grid(rng, 5, 7)
    return [
        ("empty8", jb.empty_level(8, 8, goal=True), tb.empty_level(8, 8, goal=True, device=CPU)),
        ("walls16", jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)),
        ("lava", jb.lava_level(), tb.lava_level(device=CPU)),
        ("random5x7", j_make_level(g, 0), T.make_level(g, 0, device=CPU)),
    ]


def _golden_configs():
    sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))
    from make_goldens import configs

    return configs()


def reference_cfg4_grids():
    """The cfg4 golden's per-env maze grids and starts, made by JAX."""
    (level, _), = [(lv, b) for name, lv, b in _golden_configs() if name == "cfg4_mazes"]
    return np.asarray(level.grid, np.int32), np.asarray(level.start_idx, np.int32)


def write_torch_goldens():
    grids, start = reference_cfg4_grids()
    TORCH_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(TORCH_GOLDEN, grids=grids, start_idx=start)


# -- semantics, types -------------------------------------------------------


def test_semantics_tables_match_numpy_tables():
    cfg = J.SemanticsConfig()
    for ref, got in zip(cfg.numpy_tables(), (TSEM.passable, TSEM.terminal, TSEM.reward, TSEM.deltas)):
        assert_bits_equal(ref, got)
    assert T.SemanticsConfig() == T.SemanticsConfig(**vars(cfg))
    assert (T.EMPTY, T.WALL, T.LAVA, T.GOAL, T.NUM_ACTIONS) == (J.EMPTY, J.WALL, J.LAVA, J.GOAL, J.NUM_ACTIONS)
    conv = convert.to_semantics(JSEM, device=CPU)
    for f in ("passable", "terminal", "reward", "deltas"):
        assert_bits_equal(getattr(JSEM, f), getattr(conv, f))


def test_make_level_validates():
    with pytest.raises(ValueError):
        T.make_level(np.zeros((3,), np.int32), 0, device=CPU)
    with pytest.raises(ValueError):
        T.make_level(np.zeros((3, 3), np.int32), 9, device=CPU)
    lv = T.make_level(np.zeros((2, 3, 3), np.int32), 4, device=CPU)
    assert lv.batched and lv.start_idx.tolist() == [4, 4]


# -- step -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["freeze", "autoreset", "truncated"])
def test_step_matches_jax_shared_level(mode, rng):
    b, t = 16, 300
    max_ep = 13 if mode == "truncated" else None
    auto = mode != "freeze"
    for name, jl, tl in _levels(rng):
        actions = rng.integers(0, 4, size=(t, b)).astype(np.int32)
        jstate = jro.reset_batch(jl, KEY, b)
        _, ref = jax.jit(jro.rollout_actions, static_argnames=("auto_reset", "max_episode_steps"))(
            JSEM, jl, jstate, jnp.asarray(actions), auto_reset=auto, max_episode_steps=max_ep
        )
        _, out = tro.rollout_actions(
            TSEM, tl, tro.reset_batch(tl, b), torch.as_tensor(actions), auto, max_ep
        )
        for f in ("obs", "reward", "done"):
            assert_bits_equal(getattr(ref, f), getattr(out, f))


@pytest.mark.parametrize("auto_reset,max_ep", [(False, None), (True, None), (True, 7)])
def test_step_matches_jax_per_env_levels(auto_reset, max_ep, rng):
    b, t = 8, 200
    grids = np.stack([random_grid(rng, 6, 5) for _ in range(b)])
    starts = np.zeros((b,), np.int32)
    jl = JLevel(grid=jnp.asarray(grids), start_idx=jnp.asarray(starts))
    tl = T.make_level(grids, starts, device=CPU)
    actions = rng.integers(0, 4, size=(t, b)).astype(np.int32)
    _, ref = jax.jit(jro.rollout_actions, static_argnames=("auto_reset", "max_episode_steps"))(
        JSEM, jl, jro.reset_batch(jl, KEY, b), jnp.asarray(actions),
        auto_reset=auto_reset, max_episode_steps=max_ep,
    )
    _, out = tro.rollout_actions(
        TSEM, tl, tro.reset_batch(tl, b), torch.as_tensor(actions), auto_reset, max_ep
    )
    for f in ("obs", "reward", "done"):
        assert_bits_equal(getattr(ref, f), getattr(out, f))


@pytest.mark.parametrize("fn", ["step", "step_autoreset", "step_autoreset_truncated"])
def test_single_step_functions_match_jax(fn, rng):
    """One call of each step function, from mid-episode states."""
    jl, tl = jb.lava_level(), tb.lava_level(device=CPU)
    b = 64
    idx = rng.choice(np.flatnonzero(np.asarray(jl.grid).reshape(-1) != J.WALL), size=b).astype(np.int32)
    t = rng.integers(0, 8, size=b).astype(np.int32)
    done = rng.random(b) < 0.3
    actions = rng.integers(0, 4, size=b).astype(np.int32)
    extra = (5,) if fn == "step_autoreset_truncated" else ()
    jst = jstep.EnvState(
        agent_idx=jnp.asarray(idx), t=jnp.asarray(t), done=jnp.asarray(done),
        key=jax.random.split(KEY, b),
    )
    jfn = jax.vmap(lambda s, a: getattr(jstep, fn)(JSEM, jl, s, a, *extra))
    jnew, jout = jfn(jst, jnp.asarray(actions))
    tst = convert.to_env_state(jst, device=CPU)
    tnew, tout = getattr(tstep, fn)(TSEM, tl, tst, torch.as_tensor(actions), *extra)
    for f in ("agent_idx", "t", "done"):
        assert_bits_equal(getattr(jnew, f), getattr(tnew, f))
    for f in ("obs", "reward", "done"):
        assert_bits_equal(getattr(jout, f), getattr(tout, f))


def test_oracle_2k_steps(rng):
    """The port's generic step matches the NumPy oracle over 2k steps."""
    for auto_reset, max_ep in ((False, None), (True, None), (True, 40)):
        level = tb.lava_level(device=CPU)
        actions = rng.integers(0, 4, size=2000).astype(np.int32)
        env = OracleGridEnv(
            level.grid.numpy(), int(level.start_idx), auto_reset=auto_reset, max_episode_steps=max_ep
        )
        o_obs, o_rew, o_done = env.run_actions(actions)
        _, out = tro.rollout_actions(
            TSEM, level, tro.reset_batch(level, 1), torch.as_tensor(actions)[:, None], auto_reset, max_ep
        )
        assert_bits_equal(o_obs, out.obs[:, 0])
        assert_bits_equal(o_rew, out.reward[:, 0])
        assert_bits_equal(o_done, out.done[:, 0])


@pytest.mark.parametrize("name", ["cfg1_empty8", "cfg2_walls16", "cfg3_lava", "cfg4_mazes"])
def test_goldens(name):
    """Both port engines reproduce the committed golden trajectories (the
    bit-packed one through its plain version on the CPU)."""
    levels = {
        "cfg1_empty8": (tb.empty_level(8, 8, goal=True, device=CPU), 2),
        "cfg2_walls16": (tb.walls_and_goal_16x16(device=CPU), 3),
        "cfg3_lava": (tb.lava_level(device=CPU), 3),
    }
    if name == "cfg4_mazes":
        g4 = np.load(TORCH_GOLDEN)
        levels[name] = (T.make_level(g4["grids"], g4["start_idx"], device=CPU), 4)
    level, b = levels[name]
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    actions = torch.as_tensor(g["actions"])
    _, out = tro.rollout_actions(TSEM, level, tro.reset_batch(level, b), actions, True, 64)
    bl = tbp.pack_level(level)
    _, (obs, rew, done) = tbp.rollout_actions_bits(
        TSEM, bl, tbp.reset_bits(bl, None if bl.batched else b), actions, True, 64
    )
    for got in ((out.obs, out.reward, out.done), (obs, rew, done)):
        assert_bits_equal(g["obs"], got[0])
        assert_bits_equal(g["reward"], got[1])
        assert_bits_equal(g["done"], got[2])


def test_torch_golden_grids_match_jax():
    """tests/golden/torch/ holds exactly the grids JAX makes for cfg4."""
    grids, start = reference_cfg4_grids()
    g4 = np.load(TORCH_GOLDEN)
    np.testing.assert_array_equal(g4["grids"], grids)
    np.testing.assert_array_equal(g4["start_idx"], start)


def test_action_clamping_matches_xla(rng):
    """Out-of-range actions behave as XLA's clamped gather makes them."""
    jl, tl = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    b, t = 12, 100
    actions = rng.integers(-7, 11, size=(t, b)).astype(np.int32)
    _, ref = jax.jit(jro.rollout_actions)(JSEM, jl, jro.reset_batch(jl, KEY, b), jnp.asarray(actions))
    _, out = tro.rollout_actions(TSEM, tl, tro.reset_batch(tl, b), torch.as_tensor(actions))
    for f in ("obs", "reward", "done"):
        assert_bits_equal(getattr(ref, f), getattr(out, f))


def test_build_model_table_matches_jax(rng):
    for _, jl, tl in _levels(rng):
        ref = j_build_model_table(JSEM, jl)
        got = build_model_table(TSEM, tl)
        for f in ("next_state", "reward", "done", "terminal"):
            assert_bits_equal(getattr(ref, f), getattr(got, f))
        assert (got.num_states, got.num_actions) == (ref.num_states, ref.num_actions)


def test_episode_stats_matches_jax_with_injected_draws():
    """The generic episode_stats with JAX's action draws injected."""
    level_j, level_t = jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)
    b, n = 64, 300
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, n)
    draws = jax.vmap(lambda k: jax.random.randint(k, (b,), 0, 4, dtype=jnp.int32))(keys)
    _, ref = jro.episode_stats(JSEM, level_j, jro.reset_batch(level_j, KEY, b), key, n, True, 50)
    _, got = tro.episode_stats(
        TSEM, level_t, tro.reset_batch(level_t, b), n, True, 50, actions=torch.as_tensor(np.array(draws))
    )
    assert int(ref["episodes"]) == int(got["episodes"])
    np.testing.assert_allclose(float(got["mean_return"]), float(ref["mean_return"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["mean_length"]), float(ref["mean_length"]), rtol=1e-6)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_torch_goldens()
    print(f"wrote {TORCH_GOLDEN}")


def _cuda_or_raises(make):
    """`make()` with no `device` asks for CUDA: it returns CUDA tensors, or
    raises where there is no card. It never returns a CPU tensor."""
    try:
        out = make()
    except (RuntimeError, AssertionError) as err:  # torch's own "no CUDA" errors
        assert any(word in str(err).lower() for word in ("cuda", "nvidia"))
        return
    assert out.device.type == "cuda"


@pytest.mark.parametrize(
    "make",
    [
        lambda: T.make_semantics().deltas,
        lambda: T.make_level(np.zeros((3, 3), np.int32), 0).grid,
        lambda: tb.walls_and_goal_16x16().grid,
        lambda: tbp.xorshift_init(1, (4,)),
        lambda: convert.to_semantics(JSEM).reward,
    ],
    ids=["make_semantics", "make_level", "walls16", "xorshift_init", "to_semantics"],
)
def test_constructor_without_device_asks_for_cuda(make):
    from griduniverse_tpu_torch.utils.platform import resolve_device

    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == CPU and resolve_device(CPU) == CPU
    _cuda_or_raises(make)
