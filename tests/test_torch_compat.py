"""The port's Gym-style env (`griduniverse_tpu_torch.compat`) against the
JAX package's: the tests of `tests/test_compat.py`, each run with
`backend="torch"` (K2's plain version on the CPU) and `backend="numpy"`
(the port's oracle), and the port's env held against the reference's
`GridUniverseEnv` built the same way with the same seeds: long random
walks, renders and action samples equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from griduniverse_tpu.compat import GridUniverseEnv as JEnv
from griduniverse_tpu.levels.builders import LAVA_CROSSING_9x9
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.compat import Discrete, GridUniverseEnv
from griduniverse_tpu_torch.compat import rendering
from griduniverse_tpu_torch.core import semantics as S
from griduniverse_tpu_torch.utils.oracle import OracleGridEnv

torch.set_num_threads(1)
CPU = torch.device("cpu")
BACKENDS = ("torch", "numpy")


def make(backend, **kw):
    """The port's env; the torch backend on the CPU."""
    return GridUniverseEnv(backend=backend, **({"device": CPU} if backend == "torch" else {}), **kw)


class TestSpaces:
    def test_discrete(self):
        d = Discrete(4, seed=0)
        assert d.n == 4
        assert 3 in d and 4 not in d and -1 not in d
        assert "x" not in d
        assert 0 <= d.sample() < 4
        assert Discrete(4) == Discrete(4) != Discrete(5)
        assert repr(d) == "Discrete(4)"

    def test_invalid_n(self):
        with pytest.raises(ValueError):
            Discrete(0)


@pytest.mark.parametrize("backend", BACKENDS)
class TestEnvApi:
    def test_ctor_shapes_and_spaces(self, backend):
        env = make(backend, grid_shape=(8, 8))
        assert env.action_space == Discrete(4)
        assert env.observation_space == Discrete(64)
        assert env.num_states == 64
        assert env.reset() == 0

    def test_step_tuple_form(self, backend):
        env = make(backend, grid_shape=(3, 3), goal_states=[1])
        obs, reward, done, info = env.step(S.RIGHT)
        assert (obs, reward, done) == (1, 10.0, True)
        assert info == {}
        assert type(obs) is int and type(reward) is float and type(done) is bool
        assert env.done and env.step(S.DOWN) == (1, 0.0, True, {})  # frozen after done

    def test_invalid_action_raises(self, backend):
        env = make(backend, grid_shape=(3, 3))
        with pytest.raises(ValueError, match="invalid action"):
            env.step(7)

    def test_render_ansi(self, backend):
        env = make(backend, grid_shape=(3, 3), walls=[4], goal_states=[8])
        text = env.render(mode="ansi")
        assert text.splitlines()[0][0] == "A"  # agent at start
        assert "#" in text and "g" in text

    def test_custom_world_fp(self, backend, tmp_path):
        p = tmp_path / "lava.txt"
        p.write_text(LAVA_CROSSING_9x9)
        env = make(backend, custom_world_fp=str(p))
        assert env.observation_space.n == 81

    def test_random_maze(self, backend):
        env = make(backend, random_maze=True, grid_shape=(9, 9), seed=1)
        assert env.observation_space.n == 81
        env2 = make(backend, random_maze=True, grid_shape=(9, 9), seed=1)
        assert env.render(mode="ansi") == env2.render(mode="ansi")
        with pytest.raises(ValueError, match="odd-sized"):
            make(backend, random_maze=True, grid_shape=(8, 8))

    def test_max_steps_truncation(self, backend):
        env = make(backend, grid_shape=(8, 8), max_steps=3)
        for _ in range(2):
            _, _, done, info = env.step(S.RIGHT)
            assert not done
        _, _, done, info = env.step(S.RIGHT)
        assert done and info.get("TimeLimit.truncated")

    def test_lookahead_and_terminal(self, backend):
        env = make(backend, grid_shape=(3, 3), lava=[1], goal_states=[8])
        s2, r, d = env.look_step_ahead(0, S.RIGHT)
        assert (s2, r, d) == (1, -10.0, True)
        assert env.is_terminal(8) and env.is_terminal(1) and not env.is_terminal(0)
        assert env.current_state == 0  # lookahead does not mutate

    def test_start_state_must_be_empty(self, backend):
        with pytest.raises(ValueError, match="start_state"):
            make(backend, grid_shape=(3, 3), walls=[4], start_state=4)


class TestOracleLockstep:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_long_random_walk_matches_oracle(self, backend):
        env = make(backend, grid_shape=(6, 6), walls=[7, 8], lava=[14], goal_states=[35])
        oracle = OracleGridEnv(env.level.grid.numpy(), 0)
        rng = np.random.default_rng(5)
        env.reset()
        oracle.reset()
        for i in range(300):
            a = int(rng.integers(0, 4))
            o1, r1, d1, _ = env.step(a)
            o2, r2, d2, _ = oracle.step(a)
            assert (o1, r1, d1) == (int(o2), float(r2), bool(d2)), f"step {i}"

    def test_backends_bit_identical(self):
        kw = dict(grid_shape=(6, 6), walls=[7, 8], lava=[14], goal_states=[35], max_steps=37)
        e_np, e_pt = make("numpy", **kw), make("torch", **kw)
        rng = np.random.default_rng(11)
        for episode in range(4):
            assert e_np.reset() == e_pt.reset()
            for i in range(60):
                a = int(rng.integers(0, 4))
                t1, t2 = e_np.step(a), e_pt.step(a)
                assert t1 == t2, f"ep {episode} step {i}: {t1} != {t2}"
                assert e_np.current_state == e_pt.current_state
                assert e_np.done == e_pt.done

    @pytest.mark.parametrize("backend", ["jax", "cupy"])
    def test_jax_and_unknown_backends_raise(self, backend):
        with pytest.raises(ValueError, match="torch"):
            GridUniverseEnv(grid_shape=(4, 4), backend=backend)

    def test_torch_step_is_one_k2_call_and_launches_nothing_here(self, monkeypatch):
        import griduniverse_tpu_torch.compat.gym_env as G

        env = make("torch", grid_shape=(4, 4), goal_states=[15])
        calls = []
        real = G.rollout_actions_bits

        def spy(sem, bl, state, actions, *a):
            calls.append((tuple(actions.shape), a))
            return real(sem, bl, state, actions, *a)

        before = dict(kernels.LAUNCHES)
        monkeypatch.setattr(G, "rollout_actions_bits", spy)
        for a in (1, 2, 1):
            env.step(a)
        assert calls == [((1, 1), ())] * 3  # freeze-after-done mode, no time limit
        assert kernels.LAUNCHES == before
        assert env.device == CPU and env.level.device == CPU
        assert make("numpy", grid_shape=(2, 2)).level.device == CPU


class TestRgbRender:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_rgb_array_shape_and_colors(self, backend):
        env = make(backend, grid_shape=(3, 4), walls=[5], goal_states=[11])
        img = env.render(mode="rgb_array")
        assert img.shape == (3 * 16, 4 * 16, 3) and img.dtype == np.uint8
        assert tuple(img[8, 8]) == rendering.AGENT_COLOR
        assert tuple(img[16 + 8, 16 + 8]) == rendering.DEFAULT_PALETTE[1]

    def test_rgb_render_no_scale_lines(self):
        img = rendering.rgb_render(np.zeros((2, 2), np.int32), scale=1)
        assert img.shape == (2, 2, 3)

    def test_save_png(self, tmp_path):
        pytest.importorskip("matplotlib")
        path = tmp_path / "frame.png"
        rendering.save_png(rendering.rgb_render(np.eye(3, dtype=np.int32), agent_idx=0), str(path))
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


class TestEpisodeAnimation:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_episode_gif_roundtrip(self, backend, tmp_path):
        from PIL import Image

        env = make(backend, grid_shape=(4, 4), goal_states=[15])
        obs = [env.reset()]
        for a in (1, 1, 1, 2, 2, 2):
            o, _, done, _ = env.step(a)
            obs.append(o)
        path = tmp_path / "ep.gif"
        rendering.episode_gif(env.level.grid.numpy(), np.asarray(obs), str(path),
                              start_idx=int(env.level.start_idx))
        with Image.open(path) as im:
            assert im.format == "GIF"
            assert im.n_frames == len(obs)
            assert im.size == (4 * 16, 4 * 16)

    def test_save_gif_rejects_empty(self, tmp_path):
        with pytest.raises(ValueError):
            rendering.save_gif([], str(tmp_path / "nope.gif"))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_graphic_mode_errors_helpfully_without_pyglet(self, backend):
        env = make(backend, grid_shape=(3, 3), goal_states=[8])
        env.reset()
        try:
            import pyglet  # noqa: F401

            pytest.skip("pyglet present; graphic mode would open a window")
        except ImportError:
            pass
        with pytest.raises(RuntimeError, match="rgb_array"):
            env.render(mode="graphic")


# ---------------------------------------------------------------------------
# Against the JAX package's GridUniverseEnv, built the same way.
# ---------------------------------------------------------------------------

FORMS = {
    "example01": dict(grid_shape=(6, 6), walls=[7, 8, 13], lava=[21], goal_states=[35], seed=0),
    "truncated": dict(grid_shape=(7, 5), walls=[6, 12], lava=[18], goal_states=[34], start_state=2, max_steps=29,
                      seed=4),
    "maze": dict(random_maze=True, grid_shape=(11, 13), seed=3, max_steps=80),
    "lava_file": dict(seed=9),
}


def _pair(form, backend, tmp_path):
    kw = dict(FORMS[form])
    if form == "lava_file":
        p = tmp_path / "lava.txt"
        p.write_text(LAVA_CROSSING_9x9)
        kw["custom_world_fp"] = str(p)
    return JEnv(**kw), make(backend, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("form", FORMS)
def test_random_walk_matches_reference(form, backend, tmp_path):
    """2,000 steps of `action_space.sample()`, resetting on done: the same
    samples, (obs, reward, done, info), renders and state as the
    reference's env."""
    ref, env = _pair(form, backend, tmp_path)
    assert (env.num_states, env.action_space, env.observation_space) == (
        ref.num_states, Discrete(ref.action_space.n), Discrete(ref.observation_space.n))
    np.testing.assert_array_equal(env.level.grid.numpy(), np.asarray(ref.level.grid))
    assert env.reset() == ref.reset()
    episodes = 0
    for i in range(2000):
        a = env.action_space.sample()
        assert a == ref.action_space.sample(), f"sample {i}"
        got, want = env.step(a), ref.step(a)
        assert got == want, f"step {i}: {got} != {want}"
        assert type(got[1]) is type(want[1]) is float
        if i % 97 == 0:
            assert env.render(mode="ansi") == ref.render(mode="ansi")
            np.testing.assert_array_equal(env.render(mode="rgb_array"), ref.render(mode="rgb_array"))
            assert (env.current_state, env.done) == (ref.current_state, ref.done)
        if got[2]:
            episodes += 1
            assert env.reset() == ref.reset()
    assert episodes > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_helpers_and_seed_match_reference(backend, tmp_path):
    ref, env = _pair("maze", backend, tmp_path)
    for s in range(env.num_states):
        assert env.is_terminal(s) == ref.is_terminal(s)
        for a in range(4):
            assert env.look_step_ahead(s, a) == ref.look_step_ahead(s, a)
    assert env.seed(21) == ref.seed(21) == [21]
    assert [env.action_space.sample() for _ in range(50)] == [ref.action_space.sample() for _ in range(50)]
    assert [env.observation_space.sample() for _ in range(50)] == [ref.observation_space.sample() for _ in range(50)]


def test_human_render_prints_the_reference_text(capsys):
    printed = []
    for e in (JEnv(grid_shape=(4, 5), lava=[7], goal_states=[19]),
              make("numpy", grid_shape=(4, 5), lava=[7], goal_states=[19])):
        e.step(1)
        assert e.render() is None
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].startswith("sA")


def test_constructor_without_device_asks_for_cuda():
    """With no `device` the torch backend builds on the card, and raises
    torch's own error where there is none; the numpy backend needs no card."""
    try:
        env = GridUniverseEnv(grid_shape=(3, 3))
    except (RuntimeError, AssertionError) as err:
        assert any(word in str(err).lower() for word in ("cuda", "nvidia"))
    else:
        assert env.level.device.type == "cuda"
    assert GridUniverseEnv(grid_shape=(3, 3), backend="numpy").step(1) == (1, -1.0, False, {})


# ---------------------------------------------------------------------------
# Above the bit-packed engine's MAX_PACKED_STATES (16,384): the torch backend
# steps core.step, as the reference's "jax" backend steps its core.step.
# ---------------------------------------------------------------------------

LARGE_FORMS = {
    # 16,384 states: the K2 path's last size
    "128x128": dict(grid_shape=(128, 128), walls=[2, 130], lava=[257], goal_states=[3, 16_383], seed=2,
                    max_steps=300),
    # 16,641 states: the first size above it
    "129x129": dict(grid_shape=(129, 129), walls=[2, 131], lava=[259], goal_states=[3, 16_640], seed=5,
                    max_steps=300),
    # 65x65 cells: 17,161 states, and a time limit that truncates
    "maze131": dict(random_maze=True, grid_shape=(131, 131), seed=7, max_steps=40),
}


def _walk_against(ref, env, steps, seed, reset_every=None):
    """`steps` seeded actions through both envs, resetting on done and every
    `reset_every` steps mid-episode; returns how episodes ended."""
    rng = np.random.default_rng(seed)
    assert env.reset() == ref.reset()
    ends = {"done": 0, "truncated": 0, "reset": 0}
    for i in range(steps):
        a = int(rng.integers(0, env.action_space.n))
        got, want = env.step(a), ref.step(a)
        assert got == want, f"step {i}: {got} != {want}"
        assert (env.current_state, env.done) == (ref.current_state, ref.done)
        if got[2]:
            ends["truncated" if got[3] else "done"] += 1
            assert env.reset() == ref.reset()
        elif reset_every and i % reset_every == reset_every - 1:
            ends["reset"] += 1
            assert env.reset() == ref.reset()
            assert (env.current_state, env.done, env._episode_steps()) == (ref.current_state, False, 0)
    return ends


@pytest.mark.parametrize("form", LARGE_FORMS)
def test_torch_backend_above_packed_limit_matches_reference(form):
    """The torch backend on the CPU against the reference's default
    ("numpy") backend, step for step: obs, reward, done, info (truncation
    included), the state, and resets mid-episode."""
    from griduniverse_tpu_torch.ops.bitplane import MAX_PACKED_STATES

    kw = LARGE_FORMS[form]
    ref, env = JEnv(**kw), make("torch", **kw)
    assert env.num_states == ref.num_states
    assert env._packed == (env.num_states <= MAX_PACKED_STATES) == (form == "128x128")
    np.testing.assert_array_equal(env.level.grid.numpy(), np.asarray(ref.level.grid))
    ends = _walk_against(ref, env, 1_500, seed=len(form), reset_every=97)
    assert ends["reset"] > 0 and ends["done"] + ends["truncated"] > 0
    if form == "maze131":
        assert ends["truncated"] > 0
    assert env.render(mode="ansi") == ref.render(mode="ansi")


@pytest.mark.parametrize("form", ["129x129", "maze131"])
def test_torch_backend_above_packed_limit_matches_reference_jax_backend(form):
    """The same walk against the reference's jitted `core.step` engine."""
    kw = LARGE_FORMS[form]
    ref, env = JEnv(backend="jax", **kw), make("torch", **kw)
    ends = _walk_against(ref, env, 300, seed=3, reset_every=61)
    assert ends["reset"] > 0


def test_torch_backend_picks_its_engine_by_size(monkeypatch):
    """Up to 16,384 states a step is one K2 call; above, no K2 call and one
    `core.step` call; the path is fixed in the constructor."""
    import griduniverse_tpu_torch.compat.gym_env as G

    calls = []
    real_k2, real_step = G.rollout_actions_bits, G.core_step.step
    monkeypatch.setattr(G, "rollout_actions_bits", lambda *a: calls.append("k2") or real_k2(*a))
    monkeypatch.setattr(G.core_step, "step", lambda *a: calls.append("step") or real_step(*a))
    for shape, want in (((128, 128), "k2"), ((129, 129), "step"), ((1, 16_385), "step")):
        calls.clear()
        env = make("torch", grid_shape=shape)
        for a in (1, 2, 1):
            env.step(a)
        assert calls == [want] * 3, shape
        env.reset()
        assert env.current_state == 0 and env._episode_steps() == 0 and not env.done


def test_numpy_and_torch_backends_agree_above_packed_limit():
    kw = dict(random_maze=True, grid_shape=(131, 129), seed=11, max_steps=25)
    ends = _walk_against(make("numpy", **kw), make("torch", **kw), 800, seed=4, reset_every=53)
    assert ends["truncated"] > 0
