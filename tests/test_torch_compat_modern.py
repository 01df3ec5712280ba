"""The port's modern compat surfaces against the JAX package's: the tests
of `tests/test_compat_modern.py` (the gymnasium adapter under the port's
own ID, `GridUniverseTorch-v0`, and the NumPy-facing vector env), and
`VectorGridEnv` held against the reference's bit for bit in all four
arrays of every step."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import griduniverse_tpu_torch as T
from griduniverse_tpu.compat import ENV_ID as J_ENV_ID
from griduniverse_tpu.compat import VectorGridEnv as JVectorGridEnv
from griduniverse_tpu.compat import register_envs as j_register_envs
from griduniverse_tpu.core import semantics as JS
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.levels.maze import generate_mazes_device as j_mazes
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.compat import (
    ENV_ID,
    GridUniverseEnv,
    GridUniverseGymnasiumEnv,
    VectorGridEnv,
    register_envs,
)
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEM = T.make_semantics(device=CPU)


class TestGymnasiumAdapter:
    def test_registry_and_make(self):
        register_envs()
        register_envs()  # idempotent
        env = gymnasium.make(ENV_ID, grid_shape=(6, 6), goal_states=[35], device=CPU)
        obs, info = env.reset(seed=3)
        assert env.observation_space.contains(obs)
        assert isinstance(info, dict)
        obs, r, term, trunc, info = env.step(env.action_space.sample())
        assert env.observation_space.contains(obs)
        assert isinstance(r, float) and isinstance(term, bool | np.bool_)
        assert env.unwrapped._env.backend == "torch"
        env.close()

    def test_own_id_beside_the_reference(self):
        j_register_envs()
        register_envs()
        assert ENV_ID == "GridUniverseTorch-v0" != J_ENV_ID
        assert gymnasium.spec(ENV_ID).entry_point.startswith("griduniverse_tpu_torch.")
        assert gymnasium.spec(J_ENV_ID).entry_point.startswith("griduniverse_tpu.")
        env = gymnasium.make(ENV_ID, grid_shape=(3, 3), backend="numpy")
        assert isinstance(env.unwrapped, GridUniverseGymnasiumEnv)

    @pytest.mark.parametrize("backend", ["torch", "numpy"])
    def test_passes_env_checker(self, backend):
        from gymnasium.utils.env_checker import check_env

        env = GridUniverseGymnasiumEnv(grid_shape=(5, 5), goal_states=[24], backend=backend, device=CPU)
        check_env(env, skip_render_check=True)

    def test_truncation_split_from_termination(self):
        env = GridUniverseGymnasiumEnv(grid_shape=(8, 8), goal_states=[63], max_episode_steps=3, device=CPU)
        env.reset(seed=0)
        for t in range(3):
            obs, r, term, trunc, _ = env.step(0)  # UP from the top row: no-op
        assert not term and trunc

    def test_termination_reports_terminated(self):
        env = GridUniverseGymnasiumEnv(grid_shape=(1, 2), goal_states=[1], max_episode_steps=50, device=CPU)
        env.reset(seed=0)
        obs, r, term, trunc, _ = env.step(1)  # RIGHT onto the goal
        assert term and not trunc
        assert int(obs) == 1 and r == 10.0

    def test_above_packed_limit_matches_reference_adapter(self):
        """129x129 (16,641 states, above the bit-packed engine's limit):
        the port's adapter steps `core.step` and equals the reference's
        adapter step for step, terminated and truncated split alike."""
        from griduniverse_tpu.compat import GridUniverseGymnasiumEnv as JGymEnv

        kw = dict(grid_shape=(129, 129), lava=[258], goal_states=[2, 16_640], max_episode_steps=60)
        env, ref = GridUniverseGymnasiumEnv(device=CPU, **kw), JGymEnv(**kw)
        assert not env._env._packed
        rng = np.random.default_rng(8)
        assert env.reset(seed=3) == ref.reset(seed=3)
        ends = set()
        for i in range(600):
            a = int(rng.integers(0, 4))
            got, want = env.step(a), ref.step(a)
            assert got == want and type(got[0]) is type(want[0]), f"step {i}: {got} != {want}"
            if got[2] or got[3]:
                ends.add("terminated" if got[2] else "truncated")
                assert env.reset() == ref.reset()
        assert ends == {"terminated", "truncated"}

    def test_render_modes(self):
        env = GridUniverseGymnasiumEnv(grid_shape=(4, 4), goal_states=[15], render_mode="rgb_array", device=CPU)
        env.reset(seed=0)
        frame = env.render()
        assert frame.ndim == 3 and frame.shape[-1] == 3
        assert GridUniverseGymnasiumEnv(grid_shape=(2, 2), device=CPU).render() is None
        with pytest.raises(ValueError, match="render_mode"):
            GridUniverseGymnasiumEnv(grid_shape=(4, 4), render_mode="bogus", device=CPU)


def _step_both(venv, jvenv, actions):
    """Step both envs through (T, B) actions; every array of every step
    equal (floats by their bits). Returns the summed flags."""
    terms = truncs = 0
    for t, a in enumerate(actions):
        got, want = venv.step(a), jvenv.step(a)
        for x, y in zip(got, want):
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, t
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=f"step {t}")
        assert not np.any(got[2] & got[3])
        terms += int(got[2].sum())
        truncs += int(got[3].sum())
    return terms, truncs


class TestVectorGridEnv:
    @pytest.mark.parametrize("level_fn,b", [("walls_and_goal_16x16", 64), ("lava_level", 256),
                                            ("lava_level", 1), ("walls_and_goal_16x16", 33)])
    def test_matches_functional_engine_and_reference(self, level_fn, b):
        T_, MES = 300, 50
        level = getattr(tb, level_fn)(device=CPU)
        venv = VectorGridEnv(level, num_envs=b, max_episode_steps=MES, device=CPU)
        jvenv = JVectorGridEnv(getattr(jb, level_fn)(), num_envs=b, max_episode_steps=MES)
        actions = np.random.default_rng(0).integers(0, 4, size=(T_, b)).astype(np.int32)

        bl = tbp.pack_level(level)
        _, (obs_f, rew_f, done_f) = tbp.rollout_actions_bits(
            SEM, bl, tbp.reset_bits(bl, b), torch.as_tensor(actions), auto_reset=True, max_episode_steps=MES)
        obs0 = venv.reset()
        np.testing.assert_array_equal(obs0, np.full(b, int(level.start_idx)))
        np.testing.assert_array_equal(obs0, jvenv.reset())
        for t in range(T_):
            obs, rew, term, trunc = venv.step(actions[t])
            np.testing.assert_array_equal(obs, obs_f[t].numpy())
            np.testing.assert_array_equal(rew, rew_f[t].numpy())
            np.testing.assert_array_equal(term | trunc, done_f[t].numpy())
        venv.reset(), jvenv.reset()
        terms, truncs = _step_both(venv, jvenv, actions)
        assert truncs > 0  # every env outlives 50 steps at least once in 300
        if level_fn == "lava_level" and b > 1:
            assert terms > 0  # walls16's goal is out of a random walk's reach in 50 steps

    def test_input_validation(self):
        venv = VectorGridEnv(tb.walls_and_goal_16x16(device=CPU), num_envs=8, device=CPU)
        venv.reset()
        with pytest.raises(ValueError, match="shape"):
            venv.step(np.zeros(4, np.int32))
        with pytest.raises(ValueError, match="range"):
            venv.step(np.full(8, 9, np.int32))
        with pytest.raises(ValueError, match="range"):
            venv.step(np.full(8, -1, np.int32))
        assert (venv.single_action_space.n, venv.single_observation_space.n) == (4, 256)

    def test_steps_launch_nothing_on_the_cpu(self):
        venv = VectorGridEnv(tb.empty_level(4, device=CPU), num_envs=4, max_episode_steps=5, device=CPU)
        before = dict(kernels.LAUNCHES)
        for _ in range(5):
            out = venv.step(np.zeros(4, np.int64))  # UP from the top row: a no-op
        assert kernels.LAUNCHES == before
        assert [x.dtype for x in out] == [np.int32, np.float32, np.bool_, np.bool_]
        assert out[3].all() and not out[2].any()  # truncated at the fifth step

    def test_constructor_without_device_asks_for_cuda(self):
        try:
            venv = VectorGridEnv(tb.lava_level(device=CPU), num_envs=2)
        except (RuntimeError, AssertionError) as err:
            assert any(word in str(err).lower() for word in ("cuda", "nvidia"))
        else:
            assert venv.device.type == "cuda"


def _mazes(n=8, cells=(2, 2)):
    grids, start = j_mazes(jax.random.PRNGKey(0), cells, n, algorithm="aldous_broder")
    grids = grids.at[:, 2 * cells[0] - 1, 2 * cells[1] - 1].set(JS.GOAL)
    return JLevel(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


class TestVectorEnvBatchedLevels:
    def test_num_envs_defaults_to_level_count(self):
        venv = VectorGridEnv(convert.to_level(_mazes(), device=CPU), max_episode_steps=30, device=CPU)
        assert venv.num_envs == 8
        obs = venv.reset()
        assert obs.shape == (8,)

    def test_per_env_dynamics_match_functional_engine(self):
        lv = convert.to_level(_mazes(), device=CPU)
        venv = VectorGridEnv(lv, max_episode_steps=30, device=CPU)
        venv.reset()
        bl = tbp.pack_level(lv)
        st = tbp.reset_bits(bl, None)
        rng = np.random.default_rng(3)
        for _ in range(25):
            a = rng.integers(0, 4, 8).astype(np.int32)
            obs_v, r_v, term_v, trunc_v = venv.step(a)
            st, (obs_f, r_f, done_f) = tbp.step_bits(SEM, bl, st, torch.as_tensor(a), True, 30)
            np.testing.assert_array_equal(obs_v, obs_f.numpy())
            np.testing.assert_array_equal(r_v, r_f.numpy())
            np.testing.assert_array_equal(term_v | trunc_v, done_f.numpy())

    @pytest.mark.parametrize("b,cells", [(128, (3, 3)), (33, (3, 3)), (1, (2, 2))])
    def test_per_env_mazes_match_reference(self, b, cells):
        jl = _mazes(b, cells)
        venv = VectorGridEnv(convert.to_level(jl, device=CPU), max_episode_steps=50, device=CPU)
        jvenv = JVectorGridEnv(jl, max_episode_steps=50)
        np.testing.assert_array_equal(venv.reset(), jvenv.reset())
        actions = np.random.default_rng(b).integers(0, 4, size=(300, b)).astype(np.int32)
        terms, truncs = _step_both(venv, jvenv, actions)
        assert terms > 0 and truncs > 0

    def test_num_envs_mismatch_raises(self):
        with pytest.raises(ValueError, match="one env per level"):
            VectorGridEnv(convert.to_level(_mazes(), device=CPU), num_envs=4, device=CPU)

    def test_shared_level_requires_num_envs(self):
        with pytest.raises(ValueError, match="num_envs"):
            VectorGridEnv(tb.lava_level(device=CPU), device=CPU)
