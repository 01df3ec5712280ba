"""Port parity: griduniverse_tpu_torch.levels against the JAX levels.

Text parsing, builders, shipped assets and the host maze generators must
give the reference's grids exactly; the batched binary-tree and sidewinder
generators must give them exactly when fed the reference's coins and keys.
"""

from __future__ import annotations

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.levels import maze as jm
from griduniverse_tpu.levels import registry as jr
from griduniverse_tpu.levels import text as jt
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.levels import registry as tr
from griduniverse_tpu_torch.levels import text as tt

torch.set_num_threads(1)
CPU = torch.device("cpu")


def assert_level_equal(jl, tl):
    np.testing.assert_array_equal(np.asarray(jl.grid), tl.grid.numpy())
    np.testing.assert_array_equal(np.asarray(jl.start_idx), tl.start_idx.numpy())
    assert tl.grid.dtype == torch.int32 and tl.start_idx.dtype == torch.int32


BAD_TEXTS = [
    "",                      # empty
    "so\nooo\n",             # ragged
    "oo\noo\n",              # no start
    "so\nos\n",              # two starts
    "s?\noo\n",              # unknown char
]


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_parse_errors(text):
    with pytest.raises(jt.LevelParseError):
        jt.parse_text_grid(text)
    with pytest.raises(tt.LevelParseError) as err:
        tt.parse_text_grid(text)
    assert isinstance(err.value, ValueError)


def test_parse_and_render_match_reference():
    text = "soooo\no##oo\no#goo\nl.ooo\n"
    g_ref, s_ref = jt.parse_text_grid(text)
    g, s = tt.parse_text_grid(text)
    np.testing.assert_array_equal(g_ref, g)
    assert s_ref == s
    assert_level_equal(jt.level_from_text(text), tt.level_from_text(text, device=CPU))
    assert jt.render_text(g_ref, agent_idx=7, start_idx=s_ref) == tt.render_text(
        torch.as_tensor(g), agent_idx=7, start_idx=s
    )


@pytest.mark.parametrize(
    "name",
    ["empty8", "empty5x3_goal", "walls16", "lava", "indices"],
)
def test_builder_grids(name):
    cases = {
        "empty8": lambda m, **kw: m.empty_level(**kw),
        "empty5x3_goal": lambda m, **kw: m.empty_level(5, 3, goal=True, **kw),
        "walls16": lambda m, **kw: m.walls_and_goal_16x16(**kw),
        "lava": lambda m, **kw: m.lava_level(**kw),
        "indices": lambda m, **kw: m.make_level_from_indices(
            (4, 6), start_idx=2, walls=[0, 7, 9], lava=[13], goals=[23], **kw
        ),
    }
    assert_level_equal(cases[name](jb), cases[name](tb, device=CPU))
    assert tb.LAVA_CROSSING_9x9 == jb.LAVA_CROSSING_9x9
    np.testing.assert_array_equal(
        jb.build_grid((3, 3), walls=[1], lava=[4], goals=[8]),
        tb.build_grid((3, 3), walls=[1], lava=[4], goals=[8]),
    )
    with pytest.raises(ValueError):
        tb.make_level_from_indices((3, 3), start_idx=1, walls=[1], device=CPU)


def test_asset_files_are_byte_equal_copies():
    names = jr.builtin_level_names()
    assert tr.builtin_level_names() == names and names
    for name in names:
        assert filecmp.cmp(jr.builtin_level_path(name), tr.builtin_level_path(name), shallow=False)
        assert_level_equal(jr.builtin_level(name), tr.builtin_level(name, device=CPU))
    with pytest.raises(KeyError):
        tr.builtin_level("no_such_level", device=CPU)


@pytest.mark.parametrize("cells", [(4, 4), (5, 3), (6, 6)])
def test_host_generators_match_under_same_seed(cells):
    for seed in range(3):
        g_ref = jm.generate_maze_numpy(cells, np.random.default_rng(seed))
        g = tm.generate_maze_numpy(cells, np.random.default_rng(seed))
        np.testing.assert_array_equal(g_ref, g)
        w_ref = jm.generate_maze_wilson(cells, np.random.default_rng(seed))
        w = tm.generate_maze_wilson(cells, np.random.default_rng(seed))
        np.testing.assert_array_equal(w_ref, w)
        assert tm.check_perfect_maze(g, cells) and tm.check_perfect_maze(w, cells)
        assert_level_equal(jm.random_maze_level(cells, seed), tm.random_maze_level(cells, seed, device=CPU))
    broken = g.copy()
    broken[1, 1] = 1
    assert not tm.check_perfect_maze(broken, cells)


@pytest.mark.parametrize("cells,b", [((4, 4), 64), ((3, 6), 32), ((1, 5), 8), ((5, 1), 8)])
def test_binary_tree_with_injected_coins(cells, b):
    key = jax.random.PRNGKey(11)
    ref = jm._binary_tree_mazes(key, cells, b)
    coin = jax.random.bernoulli(key, 0.5, (b, *cells))
    got = tm._binary_tree_mazes(cells, b, coin=torch.as_tensor(np.array(coin)))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("cells,b", [((4, 4), 64), ((3, 6), 32), ((2, 8), 64), ((5, 1), 8)])
def test_sidewinder_with_injected_coins_and_keys(cells, b):
    key = jax.random.PRNGKey(21)
    ref = jm._sidewinder_mazes(key, cells, b)
    k_close, k_key = jax.random.split(key)
    close = jax.random.bernoulli(k_close, 0.5, (b, *cells))
    rand = jax.random.bits(k_key, (b, *cells), jnp.uint32)
    got = tm._sidewinder_mazes(
        cells, b,
        close=torch.as_tensor(np.array(close)),
        rand=torch.as_tensor(np.asarray(rand).astype(np.int64)),
    )
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("algorithm", ["binary_tree", "sidewinder", "aldous_broder"])
def test_generate_mazes_device_perfect_on_cpu(algorithm):
    grids, start = tm.generate_mazes_device(3, (4, 5), 32, algorithm, device=CPU)
    assert grids.shape == (32, 9, 11) and grids.dtype == torch.int32
    assert int(start) == 12
    assert bool((grids[:, 7, 9] == 3).all())
    assert all(tm.check_perfect_maze(g, (4, 5)) for g in grids)
    again, _ = tm.generate_mazes_device(3, (4, 5), 32, algorithm, device=CPU)
    assert torch.equal(grids, again)


def test_generate_mazes_device_rejects_unported_and_unknown():
    # the reference's default algorithm, the backtracker, is ported (K11)
    grids, _ = tm.generate_mazes_device(0, (4, 4), 2, device=CPU)
    assert all(tm.check_perfect_maze(g, (4, 4)) for g in grids)
    with pytest.raises(ValueError):
        tm.generate_mazes_device(0, (4, 4), 2, algorithm="nope", device=CPU)
    with pytest.raises(ValueError):
        tm._sidewinder_mazes((2, 65), 1, device=CPU)
