"""The port's NumPy oracle (`griduniverse_tpu_torch.utils.oracle`) against
the JAX package's (`griduniverse_tpu.utils.oracle`): the same grid, start
and actions give the same outputs of every call, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from griduniverse_tpu.core.semantics import SemanticsConfig as JConfig
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.utils.oracle import OracleGridEnv as JOracle
from griduniverse_tpu_torch.core.semantics import SemanticsConfig as TConfig
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels.maze import generate_maze_numpy
from griduniverse_tpu_torch.utils.oracle import OracleGridEnv as TOracle

KING_AND_STAY = ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0))


def _level(name):
    """(grid, start) of a named level, built on the host."""
    if name == "builder":
        grid = tb.build_grid((7, 9), walls=[2, 11, 20, 29, 40], lava=[13, 50], goals=[62])
        return grid, 0
    if name == "lava":
        jl = jb.lava_level()
        return np.asarray(jl.grid), int(jl.start_idx)
    if name == "walls16":
        jl = jb.walls_and_goal_16x16()
        return np.asarray(jl.grid), int(jl.start_idx)
    grid = generate_maze_numpy((5, 6), np.random.default_rng(3))
    grid[-2, -2] = 3  # goal
    return grid, grid.shape[1] + 1


LEVELS = ("builder", "lava", "walls16", "maze")
MODES = ((False, None), (True, None), (True, 7))


def _pair(name, auto_reset=False, max_ep=None, deltas=None):
    grid, start = _level(name)
    jcfg, tcfg = (JConfig(), TConfig()) if deltas is None else (JConfig(action_deltas=deltas),
                                                                  TConfig(action_deltas=deltas))
    return (JOracle(grid, start, jcfg, auto_reset=auto_reset, max_episode_steps=max_ep),
            TOracle(grid, start, tcfg, auto_reset=auto_reset, max_episode_steps=max_ep))


def _same_step(a, b):
    (o1, r1, d1, i1), (o2, r2, d2, i2) = a, b
    assert (int(o1), bool(d1), i1) == (int(o2), bool(d2), i2)
    assert type(r1) is type(r2) and np.float32(r1).view(np.int32) == np.float32(r2).view(np.int32)


@pytest.mark.parametrize("auto_reset,max_ep", MODES)
@pytest.mark.parametrize("name", LEVELS)
def test_step_and_run_actions_match(name, auto_reset, max_ep):
    j, t = _pair(name, auto_reset, max_ep)
    rng = np.random.default_rng(7)
    for i in range(400):
        a = int(rng.integers(0, 4))
        _same_step(j.step(a), t.step(a))
        assert (j.agent_idx, j.t, j.done) == (t.agent_idx, t.t, t.done), i
        if not auto_reset and j.done and rng.random() < 0.2:
            assert j.reset() == t.reset()
    j.reset(), t.reset()
    actions = rng.integers(0, 4, size=500).astype(np.int32)
    for x, y in zip(j.run_actions(actions), t.run_actions(actions)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", LEVELS)
def test_lookahead_and_terminal_over_every_state_and_action(name):
    j, t = _pair(name)
    for s in range(j.h * j.w):
        assert j.is_terminal(s) == t.is_terminal(s)
        for a in range(4):
            _same_step((*j.look_step_ahead(s, a), {}), (*t.look_step_ahead(s, a), {}))
    assert (t.agent_idx, t.t, t.done) == (t.start_idx, 0, False)  # lookahead mutates nothing


def test_more_actions_match():
    j, t = _pair("maze", True, 11, KING_AND_STAY)
    actions = np.random.default_rng(2).integers(0, 9, size=600)
    for x, y in zip(j.run_actions(actions), t.run_actions(actions)):
        np.testing.assert_array_equal(x, y)
    for s in range(j.h * j.w):
        for a in range(9):
            assert j.look_step_ahead(s, a) == t.look_step_ahead(s, a)


def test_constructor_checks():
    grid, start = _level("builder")
    with pytest.raises(ValueError, match="auto_reset"):
        TOracle(grid, start, max_episode_steps=5)
    with pytest.raises(ValueError, match="2-D"):
        TOracle(grid[None], start)
    env = TOracle(grid, start)
    assert env.config == TConfig() and env.grid.dtype == np.int32
