"""Port parity: the PPO and A2C trainers of griduniverse_tpu_torch.models on
the CPU against the JAX trainers.

One whole update is compared from the same converted train state with
`jax.random`'s own draws injected (Gumbel noise, roll offsets, permutations),
in float32: the rollout's actions, obs, reward and done, the env state and
the episode count must be equal exactly; parameters after the update agree to
atol 1e-5 (sums run in another order). Chunked runs must equal unbroken ones
bit for bit. The learning tests are the reference's own.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.models import a2c as ja2c
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.models import a2c as ta2c
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def corridor(device=CPU):
    return tb.make_level_from_indices((2, 6), start_idx=0, goals=[5], device=device)


def jax_draws(base_key, update, cfg, batch, num_actions=4):
    """The draws the JAX PPO update `update` makes from `base_key`."""
    key_roll, key_perm = jax.random.split(jax.random.fold_in(base_key, update))
    gumbel = jax.random.gumbel(key_roll, (cfg.rollout_len, batch, num_actions))
    keys_e = jax.random.split(key_perm, cfg.num_epochs)
    if cfg.shuffle == "roll":
        draws = [jax.random.randint(k, (), 0, batch) for k in keys_e]
    elif cfg.shuffle == "env":
        draws = [jax.random.permutation(k, batch) for k in keys_e]
    elif cfg.shuffle == "element":
        draws = [jax.random.permutation(k, cfg.rollout_len * batch) for k in keys_e]
    else:
        draws = [jnp.zeros((), jnp.int32) for _ in keys_e]
    return _t(gumbel), [_t(d).long() for d in draws]


def assert_params_close(tparams, jparams, tnet, atol=1e-5):
    want = convert.to_network_state(tree_np(jparams), tnet)
    assert set(want) == set(tparams)
    for name in want:
        np.testing.assert_allclose(tparams[name].numpy(), want[name].numpy(), atol=atol, rtol=1e-5, err_msg=name)


def assert_env_equal(tstate, jstate):
    for f in ("agent_idx", "agent_code", "t", "done"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)))


PPO_KW = dict(rollout_len=8, max_episode_steps=12, hidden=(32,), embed_dim=8, num_epochs=2,
              num_minibatches=2, compute_dtype="float32", lr=1e-3)


@pytest.mark.parametrize("shuffle", ["roll", "none", "env", "element"])
@pytest.mark.parametrize("extra", [{}, {"vf_clip_eps": 0.2, "target_kl": 1e-4}])
def test_one_ppo_update_matches_jax(shuffle, extra):
    batch = 32
    jlevel = jb.make_level_from_indices((2, 6), start_idx=0, goals=[5])
    tlevel = convert.to_level(jlevel, device=CPU)
    jcfg = jm.PPOConfig(shuffle=shuffle, **PPO_KW, **extra)
    tcfg = tm.PPOConfig(shuffle=shuffle, **PPO_KW, **extra)
    jts = jm.ppo_init(JSEM, jlevel, jax.random.PRNGKey(11), jcfg, batch)
    tnet = tm.make_network(tlevel, 4, tcfg)
    tts = convert.to_ppo_train_state(tree_np(jts), tnet)
    for u in range(2):  # the second update starts mid-episode, with warm Adam moments
        gumbel, draws = jax_draws(jts.key, u, jcfg, batch)
        jts = jm.ppo_run(JSEM, jlevel, jts, jcfg, 1)
        tts = tm.ppo_run(TSEM, tlevel, tts, tcfg, 1, gumbel=gumbel[None], shuffle_draws=[draws])
        assert_env_equal(tts.env_state, jts.env_state)
        assert int(tts.episodes) == int(jts.episodes) and tts.update == int(jts.update)
        np.testing.assert_allclose(tts.run_ret.numpy(), np.asarray(jts.run_ret), atol=1e-6)
        np.testing.assert_allclose(float(tts.ret_sum), float(jts.ret_sum), rtol=1e-6)
        np.testing.assert_allclose(float(tts.last_loss), float(jts.last_loss), rtol=1e-4, atol=1e-6)
        assert_params_close(tts.params, jts.params, tnet)
    assert int(tts.episodes) > 0
    back = convert.to_adam_state(tree_np(jts.opt_state), tnet)
    assert int(tts.opt_state.count) == int(back.count)
    if not extra:
        assert int(back.count) == 8
    for name in back.mu:
        np.testing.assert_allclose(tts.opt_state.mu[name].numpy(), back.mu[name].numpy(), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("obs", ["index", "grid"])
def test_one_a2c_update_matches_jax(obs):
    batch, t = 32, 8
    jlevel = jb.make_level_from_indices((2, 6), start_idx=0, goals=[5])
    tlevel = convert.to_level(jlevel, device=CPU)
    kw = dict(rollout_len=t, max_episode_steps=12, hidden=(32,), embed_dim=8, compute_dtype="float32",
              lr=1e-3, obs=obs, conv_channels=(8,))
    jcfg, tcfg = jm.A2CConfig(**kw), tm.A2CConfig(**kw)
    jts = jm.a2c_init(JSEM, jlevel, jax.random.PRNGKey(5), jcfg, batch)
    tnet = tm.make_network(tlevel, 4, tcfg)
    tts = convert.to_a2c_train_state(tree_np(jts), tnet)
    for u in range(2):
        key_roll, _ = jax.random.split(jax.random.fold_in(jts.key, u))
        # jax.random.categorical(key, logits) is argmax(logits + gumbel(key, logits.shape))
        gumbel = jnp.stack([jax.random.gumbel(k, (batch, 4)) for k in jax.random.split(key_roll, t)])
        jts = jm.a2c_run(JSEM, jlevel, jts, jcfg, 1)
        tts = tm.a2c_run(TSEM, tlevel, tts, tcfg, 1, gumbel=_t(gumbel)[None])
        assert_env_equal(tts.env_state, jts.env_state)
        assert int(tts.episodes) == int(jts.episodes)
        np.testing.assert_allclose(float(tts.ret_sum), float(jts.ret_sum), rtol=1e-6)
        np.testing.assert_allclose(float(tts.last_loss), float(jts.last_loss), rtol=1e-4, atol=1e-6)
        assert_params_close(tts.params, jts.params, tnet)
    assert int(tts.episodes) > 0


def test_rollout_matches_jax_rollout_step_by_step(rng):
    """The trajectory itself: actions, obs, reward, done exactly; logp and
    value to float32 tolerance."""
    _rollout_step_by_step(rng, JSEM, TSEM)


# 9: the eight king moves and a stay; 25: every move of at most two rows and two columns
ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


@pytest.mark.parametrize("a", [9, 25])
def test_rollout_matches_jax_rollout_step_by_step_at_more_actions(a, rng):
    """K7b's plain version at A above 8: the Gumbel-max draw and log-prob
    over A logits and the step by A deltas."""
    _rollout_step_by_step(rng, J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a])),
                          T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU))


def _rollout_step_by_step(rng, jsem, tsem):
    batch, t, na = 48, 10, tsem.num_actions
    jlevel = jb.lava_level()
    tlevel = convert.to_level(jlevel, device=CPU)
    cfg = tm.PPOConfig(hidden=(32,), embed_dim=8, compute_dtype="float32")
    jnet = ja2c.make_network(jlevel, na, jm.PPOConfig(hidden=(32,), embed_dim=8, compute_dtype="float32"))
    tnet = tm.make_network(tlevel, na, cfg)
    jparams = ja2c._net_init(jnet, jax.random.PRNGKey(2))
    tparams = convert.to_network_state(tree_np(jparams), tnet)
    gumbel = rng.gumbel(size=(t, batch, na)).astype(np.float32)
    jbl, tbl = jbp.pack_level(jlevel), tbp.pack_level(tlevel)
    jst = jbp.reset_bits(jbl, batch)
    rows = []
    for g in gumbel:
        logits, value = jnet.apply(jparams, jst.agent_idx)
        a = jnp.argmax(logits + g, axis=-1).astype(jnp.int32)
        logp = jnp.take_along_axis(jax.nn.log_softmax(logits), a[:, None], axis=-1)[:, 0]
        obs = jst.agent_idx
        jst, (_, reward, done) = jbp.step_bits(jsem, jbl, jst, a, True, 7)
        rows.append((obs, a, logp, value, reward, done))
    want = [np.stack([np.asarray(r[k]) for r in rows]) for k in range(6)]
    tst, traj, bootstrap = ta2c.rollout(tsem, tbl, tnet, tparams, None, tbp.reset_bits(tbl, batch), _t(gumbel), 7)
    got = dataclasses.astuple(traj)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=2e-6)
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=2e-6)
    assert_env_equal(tst, jst)
    _, jboot = jnet.apply(jparams, jst.agent_idx)
    np.testing.assert_allclose(bootstrap.numpy(), np.asarray(jboot), atol=2e-6)
    assert want[5].any() and not bootstrap.requires_grad


# ---------------------------------------------------------------------------
# Chunk invariance, bit for bit
# ---------------------------------------------------------------------------


def assert_states_bitequal(a, b):
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.opt_state.mu[name], b.opt_state.mu[name]), name
        assert torch.equal(a.opt_state.nu[name], b.opt_state.nu[name]), name
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f))
    for f in ("run_ret", "episodes", "ret_sum", "last_loss"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.update == b.update and a.seed == b.seed


CHUNK_KW = dict(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16, num_epochs=2, num_minibatches=2)


@pytest.mark.parametrize("extra", [
    {},
    {"lr_schedule": "linear", "lr_decay_updates": 8},
    {"target_kl": 1e-9, "lr": 1e-2},
    {"shuffle": "element", "compute_dtype": "float32"},
    {"obs": "grid", "conv_channels": (8,), "shuffle": "none"},
])
def test_ppo_chunking_is_bitexact(extra):
    level = corridor()
    cfg = tm.PPOConfig(**{**CHUNK_KW, **extra})
    ts0 = tm.ppo_init(TSEM, level, 3, cfg, batch_size=16)
    full = tm.ppo_run(TSEM, level, ts0, cfg, num_updates=8)
    half = tm.ppo_run(TSEM, level, ts0, cfg, num_updates=4)
    resumed = tm.ppo_run(TSEM, level, half, cfg, num_updates=4)
    assert_states_bitequal(full, resumed)
    assert full.update == 8 and ts0.update == 0  # the input state is not written
    assert_states_bitequal(full, tm.ppo_run(TSEM, level, ts0, cfg, num_updates=8))
    if "lr_schedule" in extra:  # the schedule is wired: a constant rate ends elsewhere
        const = tm.ppo_run(TSEM, level, ts0, tm.PPOConfig(**CHUNK_KW), num_updates=8)
        assert not torch.equal(const.params["embed"], full.params["embed"])


@pytest.mark.parametrize("extra", [{}, {"lr_schedule": "linear", "lr_decay_updates": 6, "lr_final_frac": 0.1},
                                   {"obs": "grid", "conv_channels": (8,)}])
def test_a2c_chunking_is_bitexact(extra):
    level = corridor()
    cfg = tm.A2CConfig(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16, **extra)
    ts0 = tm.a2c_init(TSEM, level, 8, cfg, batch_size=16)
    full = tm.a2c_run(TSEM, level, ts0, cfg, num_updates=8)
    half = tm.a2c_run(TSEM, level, ts0, cfg, num_updates=4)
    resumed = tm.a2c_run(TSEM, level, half, cfg, num_updates=4)
    assert_states_bitequal(full, resumed)
    assert full.update == 8 and int(full.opt_state.count) == 8


def test_per_env_conv_ppo_chunking_is_bitexact():
    from griduniverse_tpu_torch.levels import maze as tmz

    grids, start = tmz.generate_mazes_device(4, (2, 2), 16, "aldous_broder", device=CPU)
    levels = T.Level(grid=grids, start_idx=start.expand(16).contiguous())
    cfg = tm.PPOConfig(rollout_len=4, max_episode_steps=12, obs="grid", conv_channels=(8, 8), hidden=(16,),
                       num_epochs=2, num_minibatches=2)
    ts0 = tm.ppo_init(TSEM, levels, 1, cfg)
    full = tm.ppo_run(TSEM, levels, ts0, cfg, num_updates=4)
    resumed = tm.ppo_run(TSEM, levels, tm.ppo_run(TSEM, levels, ts0, cfg, num_updates=2), cfg, num_updates=2)
    assert_states_bitequal(full, resumed)
    assert full.run_ret.shape == (16,)


def test_tiny_target_kl_freezes_most_updates():
    level = corridor()
    base = dict(rollout_len=8, lr=1e-2, num_epochs=4, num_minibatches=4, hidden=(64,), embed_dim=32)
    tight, loose = tm.PPOConfig(target_kl=1e-9, **base), tm.PPOConfig(**base)
    r_t = tm.ppo_train(TSEM, level, 0, tight, num_updates=10, batch_size=64)
    r_l = tm.ppo_train(TSEM, level, 0, loose, num_updates=10, batch_size=64)
    p0 = tm.ppo_init(TSEM, level, 0, loose, batch_size=64).params

    def dist(a, b):
        return float(sum((a[k] - b[k]).abs().sum() for k in a))

    assert dist(r_t.params, p0) < 0.8 * dist(r_l.params, p0)
    # the frozen steps do not advance Adam's count: about 2 of 16 steps an update apply
    ts = tm.ppo_run(TSEM, level, tm.ppo_init(TSEM, level, 0, tight, 64), tight, 10)
    assert 10 <= int(ts.opt_state.count) < 80


# ---------------------------------------------------------------------------
# Learning, as the reference's own tests
# ---------------------------------------------------------------------------


def _greedy_rollout_reaches_goal(level, params, cfg, max_steps=12):
    net = tm.make_network(level, 4, cfg)
    state = T.reset(level, 1)
    for _ in range(max_steps):
        a = tm.greedy_actions(net, params, state.agent_idx)
        state, out = T.step(TSEM, level, state, a)
        if bool(out.done):
            return True, float(out.reward)
    return False, 0.0


def test_a2c_learns_corridor():
    level = corridor()
    cfg = tm.A2CConfig(rollout_len=8, lr=3e-3, ent_coef=0.01, hidden=(64,), embed_dim=32)
    res = tm.a2c_train(TSEM, level, 0, cfg, num_updates=300, batch_size=64)
    assert int(res.episodes) > 50
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0


PPO_LEARN = dict(rollout_len=8, lr=3e-3, num_epochs=2, num_minibatches=2, ent_coef=0.01, hidden=(64,), embed_dim=32)


@pytest.mark.parametrize("extra", [{}, {"vf_clip_eps": 10.0, "target_kl": 0.05}, {"shuffle": "env"}])
def test_ppo_learns_corridor(extra):
    level = corridor()
    cfg = tm.PPOConfig(**PPO_LEARN, **extra)
    res = tm.ppo_train(TSEM, level, 0, cfg, num_updates=150, batch_size=64)
    assert int(res.episodes) > 50
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0


def test_ppo_grid_obs_learns_corridor():
    level = corridor()
    cfg = tm.PPOConfig(rollout_len=8, lr=1e-3, max_episode_steps=32, obs="grid", conv_channels=(16,),
                       hidden=(64,), num_epochs=2, num_minibatches=2)
    res = tm.ppo_train(TSEM, level, 0, cfg, num_updates=150, batch_size=64)
    assert int(res.episodes) > 50
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0


def test_config_errors():
    level = corridor()
    with pytest.raises(ValueError, match="divisible"):
        tm.ppo_train(TSEM, level, 0, tm.PPOConfig(**{**PPO_LEARN, "num_minibatches": 7}), 1, 64)
    with pytest.raises(ValueError, match="unknown shuffle"):
        tm.ppo_train(TSEM, level, 0, tm.PPOConfig(shuffle="sort"), 1, 64)
    with pytest.raises(ValueError, match="unknown obs"):
        tm.a2c_train(TSEM, level, 0, tm.A2CConfig(obs="pixels"), 1, 8)
    with pytest.raises(ValueError, match="lr_decay_updates"):
        tm.a2c_train(TSEM, level, 0, tm.A2CConfig(lr_schedule="linear"), 1, 8)
    from griduniverse_tpu_torch.levels import maze as tmz

    grids, start = tmz.generate_mazes_device(3, (3, 3), 64, "binary_tree", device=CPU)
    levels = T.Level(grid=grids, start_idx=start.expand(64).contiguous())
    cfg = tm.PPOConfig(obs="grid", conv_channels=(8,), hidden=(16,), shuffle="env")
    with pytest.raises(ValueError, match="roll"):
        tm.ppo_train(TSEM, levels, 0, cfg, num_updates=2, batch_size=64)
    # a batched level brings its own batch: one env per level
    ts = tm.a2c_init(TSEM, levels, 0, tm.A2CConfig(rollout_len=4, hidden=(16,), embed_dim=8), 128)
    assert ts.run_ret.shape == (64,)
    net = tm.make_network(levels, 4, tm.A2CConfig(obs="grid"))
    assert isinstance(net, tm.BatchedConvActorCritic) and net.needs_tiles
