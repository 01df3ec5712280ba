"""The on-policy learners end to end on the CPU: per-env mazes from the
port's generator → PPO with the per-env-level conv trunk → greedy evaluation;
and the evaluation API's semantics.

The same mazes, parameters and draws go through the JAX trainer: after two
whole updates in float32 the env states and episode counts are equal and the
parameters agree to atol 2e-5 (two updates of sums in another order); the
greedy evaluation of one parameter set gives the same per-env mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.models import a2c as ja2c
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.core import semantics as S
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tmz
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def maze_levels(seed, n, cells=(3, 3), algorithm="aldous_broder"):
    grids, start = tmz.generate_mazes_device(seed, cells, n, algorithm, device=CPU)
    tlevel = T.Level(grid=grids, start_idx=start.expand(n).contiguous())
    jlevel = JLevel(grid=jnp.asarray(grids.numpy()), start_idx=jnp.asarray(tlevel.start_idx.numpy()))
    return tlevel, jlevel


def test_ppo_over_per_env_mazes_matches_jax_and_evaluates_the_same():
    n = 32
    tlevel, jlevel = maze_levels(2026, n)
    kw = dict(rollout_len=8, max_episode_steps=24, obs="grid", conv_channels=(8, 8), hidden=(16,),
              compute_dtype="float32", num_epochs=2, num_minibatches=2, lr=1e-3)
    jcfg, tcfg = jm.PPOConfig(**kw), tm.PPOConfig(**kw)
    jts = jm.ppo_init(JSEM, jlevel, jax.random.PRNGKey(1), jcfg, n)
    tnet = tm.make_network(tlevel, 4, tcfg)
    tts = convert.to_ppo_train_state(tree_np(jts), tnet)
    gumbels, draws = [], []
    for u in range(2):
        key_roll, key_perm = jax.random.split(jax.random.fold_in(jts.key, u))
        gumbels.append(np.asarray(jax.random.gumbel(key_roll, (8, n, 4))))
        draws.append([torch.as_tensor(int(jax.random.randint(k, (), 0, n))) for k in jax.random.split(key_perm, 2)])
    jts = jm.ppo_run(JSEM, jlevel, jts, jcfg, 2)
    tts = tm.ppo_run(TSEM, tlevel, tts, tcfg, 2, gumbel=torch.as_tensor(np.stack(gumbels)), shuffle_draws=draws)
    for f in ("agent_idx", "agent_code", "t"):
        np.testing.assert_array_equal(getattr(tts.env_state, f).numpy(), np.asarray(getattr(jts.env_state, f)))
    assert int(tts.episodes) == int(jts.episodes)
    want = convert.to_network_state(tree_np(jts.params), tnet)
    for name in want:
        np.testing.assert_allclose(tts.params[name].numpy(), want[name].numpy(), atol=2e-5, rtol=1e-5, err_msg=name)
    # one parameter set through both evaluations
    jnet = ja2c.make_network(jlevel, 4, jcfg)
    jmask = jm.greedy_reached(JSEM, jnet, jts.params, jlevel, max_steps=30)
    tmask = tm.greedy_reached(TSEM, tnet, want, tlevel, max_steps=30)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    rate = tm.greedy_success_rate(TSEM, tnet, want, tlevel, max_steps=30)
    np.testing.assert_allclose(float(rate), float(tmask.float().mean()))
    # the wrong-tiles control takes the planes from other levels
    rolled = T.Level(grid=tlevel.grid.roll(1, 0), start_idx=tlevel.start_idx)
    jrolled = JLevel(grid=jnp.roll(jlevel.grid, 1, axis=0), start_idx=jlevel.start_idx)
    np.testing.assert_array_equal(
        tm.greedy_reached(TSEM, tnet, want, tlevel, 30, tiles_levels=rolled).numpy(),
        np.asarray(jm.greedy_reached(JSEM, jnet, jts.params, jlevel, 30, tiles_levels=jrolled)))


def test_index_ppo_over_per_env_mazes_learns_and_default_dtype_runs():
    """bfloat16 (the default) on the index path over per-env mazes: the
    return rises between the first and the second half of a short run."""
    tlevel, _ = maze_levels(7, 64, cells=(2, 2))
    cfg = tm.PPOConfig(rollout_len=8, max_episode_steps=24, hidden=(32,), embed_dim=16, lr=3e-3,
                       num_epochs=2, num_minibatches=2)
    ts0 = tm.ppo_init(TSEM, tlevel, 0, cfg)
    h1 = tm.ppo_run(TSEM, tlevel, ts0, cfg, 40)
    h2 = tm.ppo_run(TSEM, tlevel, h1, cfg, 40)
    r1 = tm.ppo_result(h1)
    mean2 = (h2.ret_sum - h1.ret_sum) / (h2.episodes - h1.episodes).clamp(min=1)
    assert int(r1.episodes) > 0 and torch.isfinite(h2.last_loss)
    assert float(mean2) > float(r1.mean_return)


class TestEvaluationApi:
    def test_greedy_reached_shapes_and_families(self):
        levels, _ = maze_levels(0, 8, algorithm="binary_tree")
        cfg = tm.A2CConfig(obs="grid", conv_channels=(8,), hidden=(16,), compute_dtype="float32")
        net = tm.make_network(levels, 4, cfg)
        p = tm.init_network_params(net, 0)
        mask = tm.greedy_reached(TSEM, net, p, levels, max_steps=20)
        assert mask.shape == (8,) and mask.dtype == torch.bool
        rate = tm.greedy_success_rate(TSEM, net, p, levels, max_steps=20)
        np.testing.assert_allclose(float(rate), float(mask.float().mean()))
        lv = tb.lava_level(device=CPU)
        net_i = tm.make_network(lv, 4, tm.A2CConfig(hidden=(16,), embed_dim=8, compute_dtype="float32"))
        mask_i = tm.greedy_reached(TSEM, net_i, tm.init_network_params(net_i, 0), lv, max_steps=20)
        assert mask_i.shape == (1,)
        with pytest.raises(ValueError, match="tiles_levels"):
            tm.greedy_reached(TSEM, net_i, tm.init_network_params(net_i, 0), lv, 5, tiles_levels=lv)

    def test_lava_termination_is_not_success(self):
        cfg = tm.A2CConfig(hidden=(8,), embed_dim=4, compute_dtype="float32")

        def walk_right(level):
            net = tm.make_network(level, 4, cfg)
            params = tm.init_network_params(net, 0)
            params["policy_head.weight"] = torch.zeros_like(params["policy_head.weight"])
            bias = torch.zeros_like(params["policy_head.bias"])
            bias[S.RIGHT] = 10.0
            params["policy_head.bias"] = bias
            return net, params

        lava_first = tb.make_level_from_indices((1, 4), start_idx=0, lava=[2], goals=[3], device=CPU)
        mask = tm.greedy_reached(TSEM, *walk_right(lava_first), lava_first, max_steps=10)
        assert not bool(mask.any())  # terminated in lava: not a success
        goal_only = tb.make_level_from_indices((1, 4), start_idx=0, goals=[3], device=CPU)
        mask2 = tm.greedy_reached(TSEM, *walk_right(goal_only), goal_only, max_steps=10)
        assert bool(mask2.all())

    def test_success_rate_reflects_a_working_policy(self):
        level = tb.make_level_from_indices((2, 6), start_idx=0, goals=[11], device=CPU)
        cfg = tm.PPOConfig(rollout_len=8, max_episode_steps=32, lr=1e-3, hidden=(32,), embed_dim=8,
                           compute_dtype="float32", num_epochs=2, num_minibatches=2)
        res = tm.ppo_train(TSEM, level, 0, cfg, num_updates=150, batch_size=64)
        net = tm.make_network(level, 4, cfg)
        assert float(tm.greedy_success_rate(TSEM, net, res.params, level, 30)) == 1.0


class TestTabularEvaluation:
    def test_vi_policies_solve_perfect_mazes(self):
        levels, jlevels = maze_levels(3, 32)
        _, policy, _ = ta.value_iteration_batched_grid(TSEM, levels)
        assert float(tm.greedy_success_rate_tabular(TSEM, levels, policy, max_steps=60)) == 1.0
        short = tm.greedy_reached_tabular(TSEM, levels, policy, max_steps=5)
        jshort = jm.greedy_reached_tabular(JSEM, jlevels, jnp.asarray(policy.numpy()), max_steps=5)
        np.testing.assert_array_equal(short.numpy(), np.asarray(jshort))
        long = tm.greedy_reached_tabular(TSEM, levels, policy, max_steps=60)
        assert short.shape == (32,) and bool((~short | long).all()) and not bool(short.all())

    def test_shared_level_and_goal_only_semantics(self):
        lava_first = tb.make_level_from_indices((1, 4), start_idx=0, lava=[2], goals=[3], device=CPU)
        walk_right = torch.full((4,), S.RIGHT, dtype=torch.int32)
        mask = tm.greedy_reached_tabular(TSEM, lava_first, walk_right, max_steps=10)
        assert mask.shape == (1,) and not bool(mask.any())
        goal_only = tb.make_level_from_indices((1, 4), start_idx=0, goals=[3], device=CPU)
        assert bool(tm.greedy_reached_tabular(TSEM, goal_only, walk_right, max_steps=10).all())
        # N policies, each in its own env of the shared level
        both = torch.stack([walk_right, torch.full((4,), S.LEFT, dtype=torch.int32)])
        assert tm.greedy_reached_tabular(TSEM, goal_only, both, max_steps=10).tolist() == [True, False]

    def test_shape_mismatch_raises(self):
        levels, _ = maze_levels(5, 4)
        s = levels.num_states
        with pytest.raises(ValueError):
            tm.greedy_reached_tabular(TSEM, levels, torch.zeros((4, s + 1), dtype=torch.int32))
        with pytest.raises(ValueError):
            tm.greedy_reached_tabular(TSEM, levels, torch.zeros((3, s), dtype=torch.int32))
