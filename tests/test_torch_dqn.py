"""Port parity: the DQN trainer of griduniverse_tpu_torch.models on the CPU
against the JAX trainer.

K7c's store form (`dqn_act_step(..., ring=...)`: the act, the step, the
statistics and the ring write of one step) is held bit for bit against its
plain composition (`dqn_act_step_reference`, then `replay_write_reference`)
and exactly against the reference's act, `step_bits`, `buffer_write` and
priority fill.

Whole steps are compared from the same converted train state with
`jax.random`'s own draws injected (explore coins, random actions, minibatch
indices or Gumbel noise), in float32: the env state, the replay buffer, the
slots whose priority was refreshed and the counters must be equal exactly;
parameters, target parameters and Adam moments agree to atol 1e-5, the
priorities to atol 1e-5 (sums run in another order, and XLA fuses a multiply
and an add where torch rounds twice). Chunked runs must equal unbroken ones
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
from griduniverse_tpu.levels import maze as jmz
from griduniverse_tpu.models import dqn as jdqn
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.models import dqn as tdqn
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


def jax_step_draws(base_key, t, cfg, batch, num_actions=4):
    """The draws the JAX train body makes at step `t` from `base_key`."""
    key_eps, key_a, key_mb = jax.random.split(jax.random.fold_in(base_key, t), 3)
    frac = jnp.clip(jnp.int32(t) / cfg.eps_anneal_steps, 0.0, 1.0)
    eps = cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)
    explore = jax.random.uniform(key_eps, (batch,)) < eps
    rand_a = jax.random.randint(key_a, (batch,), 0, num_actions, jnp.int32)
    if cfg.prioritized:
        sample = jax.random.gumbel(key_mb, (cfg.buffer_capacity,))
    else:
        size = min((t + 1) * batch, cfg.buffer_capacity)
        sample = jax.random.randint(key_mb, (cfg.batch_size_train,), 0, max(size, 1))
    return _t(explore), _t(rand_a), _t(sample)


def assert_tree_close(tparams, jparams, tnet, atol=1e-5):
    want = convert.to_network_state(tree_np(jparams), tnet)
    assert set(want) == set(tparams)
    for name in want:
        np.testing.assert_allclose(tparams[name].numpy(), want[name].numpy(), atol=atol, rtol=1e-5, err_msg=name)


def assert_matches_jax(tts, jts, tnet):
    for f in ("agent_idx", "agent_code", "t", "done"):
        np.testing.assert_array_equal(getattr(tts.env_state, f).numpy(), np.asarray(getattr(jts.env_state, f)), f)
    for name, tf, jf in zip(tdqn.ReplayBuffer._fields, tts.buf, jts.buf):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), name)
    assert int(tts.t) == int(jts.t) and int(tts.episodes) == int(jts.episodes)
    np.testing.assert_allclose(tts.run_ret.numpy(), np.asarray(jts.run_ret), atol=1e-6)
    np.testing.assert_allclose(float(tts.ret_sum), float(jts.ret_sum), rtol=1e-6)
    np.testing.assert_allclose(float(tts.last_loss), float(jts.last_loss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tts.prio.numpy(), np.asarray(jts.prio), atol=1e-5)
    np.testing.assert_allclose(float(tts.p_max), float(jts.p_max), atol=1e-5)
    assert_tree_close(tts.params, jts.params, tnet)
    assert_tree_close(tts.target_params, jts.target_params, tnet)
    back = convert.to_adam_state(tree_np(jts.opt_state), tnet)
    assert int(tts.opt_state.count) == int(back.count)
    for name in back.mu:
        np.testing.assert_allclose(tts.opt_state.mu[name].numpy(), back.mu[name].numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(tts.opt_state.nu[name].numpy(), back.nu[name].numpy(), atol=1e-5, err_msg=name)


STEP_KW = dict(lr=2e-3, buffer_capacity=128, batch_size_train=16, eps_anneal_steps=20, learn_start=64,
               hidden=(32,), embed_dim=8, max_episode_steps=12, compute_dtype="float32",
               target_update_every=3, per_beta_anneal_steps=10, conv_channels=(8,))


@pytest.mark.parametrize("prioritized,target_update,obs,double", [
    (False, "polyak", "index", True),
    (True, "hard", "index", True),
    (False, "hard", "grid", False),
    (True, "polyak", "grid", True),
])
def test_dqn_steps_match_jax(prioritized, target_update, obs, double):
    """Ten single steps, each from the state the last one left: the ring
    wraps after four, learning starts at the third, a hard update falls on
    every third."""
    _dqn_steps_match_jax(prioritized, target_update, obs, double, JSEM, TSEM)


# 9: the eight king moves and a stay; 25: every move of at most two rows and two columns
ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("prioritized,target_update,obs,double", [(False, "polyak", "index", True),
                                                                  (True, "hard", "grid", False)])
def test_dqn_steps_match_jax_at_more_actions(prioritized, target_update, obs, double, a):
    """K7c's plain version at A above 8: the greedy action over A Q-values,
    the explore draw over A, the step by A deltas; 14 steps, past the time
    limit of 12, since a walk of so many moves may not reach the goal in 10."""
    _dqn_steps_match_jax(prioritized, target_update, obs, double,
                         J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a])),
                         T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU), steps=14)


def _dqn_steps_match_jax(prioritized, target_update, obs, double, jsem, tsem, steps=10):
    batch, na = 32, tsem.num_actions
    jlevel = jb.make_level_from_indices((2, 6), start_idx=0, goals=[5])
    tlevel = convert.to_level(jlevel, device=CPU)
    kw = dict(STEP_KW, prioritized=prioritized, target_update=target_update, obs=obs, double=double)
    jcfg, tcfg = jm.DQNConfig(**kw), tm.DQNConfig(**kw)
    jts = jm.dqn_init(jsem, jlevel, jax.random.PRNGKey(7), jcfg, batch)
    tnet = tm.make_q_network(tlevel, na, tcfg)
    tts = convert.to_dqn_train_state(tree_np(jts), tnet)
    assert tts.prio.shape == ((128,) if prioritized else (0,))
    for t in range(steps):
        draws = tuple(d[None] for d in jax_step_draws(jts.key, t, jcfg, batch, na))
        before = np.asarray(jts.prio)
        jts = jm.dqn_run(jsem, jlevel, jts, jcfg, 1)
        t_before = tts.prio.clone()
        tts = tm.dqn_run(tsem, tlevel, tts, tcfg, 1, draws=draws)
        assert_matches_jax(tts, jts, tnet)
        if prioritized:  # the minibatch's slots: those whose priority the step wrote
            np.testing.assert_array_equal((tts.prio != t_before).numpy(), np.asarray(jts.prio) != before)
    assert int(tts.episodes) > 0 and float(tts.last_loss) > 0


def test_dqn_per_env_mazes_match_jax():
    """Grid observations over per-env levels: the minibatch's tile planes
    are recovered from the slots (env = slot mod B)."""
    n = 16
    grids, start = jmz.generate_mazes_device(jax.random.PRNGKey(2), (2, 2), n, "binary_tree")
    jlevels = J.Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))
    tlevels = convert.to_level(jlevels, device=CPU)
    kw = dict(STEP_KW, buffer_capacity=64, batch_size_train=8, learn_start=16, obs="grid", prioritized=True)
    jcfg, tcfg = jm.DQNConfig(**kw), tm.DQNConfig(**kw)
    jts = jm.dqn_init(JSEM, jlevels, jax.random.PRNGKey(1), jcfg, n)
    tnet = tm.make_q_network(tlevels, 4, tcfg)
    assert isinstance(tnet, tm.BatchedConvQNetwork) and tnet.needs_tiles
    tts = convert.to_dqn_train_state(tree_np(jts), tnet)
    for t in range(6):
        draws = tuple(d[None] for d in jax_step_draws(jts.key, t, jcfg, n))
        jts = jm.dqn_run(JSEM, jlevels, jts, jcfg, 1)
        tts = tm.dqn_run(TSEM, tlevels, tts, tcfg, 1, draws=draws)
        assert_matches_jax(tts, jts, tnet)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _fields_of(st):
    return st.agent_idx, st.agent_code, st.t, st.done


def _store_levels(form):
    """(JAX level, B): walls16 shared by 33 envs, or 33 per-env 9×9 mazes."""
    if form == "shared":
        return jb.walls_and_goal_16x16(), 33
    grids, start = jmz.generate_mazes_device(jax.random.PRNGKey(4), (4, 4), 33, "binary_tree")
    return J.Level(grid=grids, start_idx=jnp.broadcast_to(start, (33,))), 33


@pytest.mark.parametrize("at_end", [False, True])
@pytest.mark.parametrize("a", [4, 9])
@pytest.mark.parametrize("form", ["shared", "mazes"])
@pytest.mark.parametrize("prioritized", [False, True])
def test_dqn_act_store_form_equals_the_act_then_the_write(prioritized, form, a, at_end):
    """Six steps of the store form (K7c's plain path on the CPU) into a ring
    of four batches at `at` = 0 or cap − B, against `dqn_act_step_reference`
    followed by `replay_write_reference` bit for bit (the ring, the
    priorities and every output), and against the reference's act,
    `step_bits`, `buffer_write` and priority fill (the ring and priorities
    exactly; `ret_sum` to rtol 1e-6, summed in another order)."""
    jsem = J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a])) if a != 4 else JSEM
    tsem = T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU) if a != 4 else TSEM
    jlevel, b = _store_levels(form)
    cap = 4 * b
    at = cap - b if at_end else 0
    jbl = jbp.pack_level(jlevel)
    tbl = convert.to_bit_level(jbl, device=CPU)
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    st = ref_st = convert.to_fast_state(jst, device=CPU)
    rng = np.random.default_rng(a + 2 * b + at)
    ring0 = [rng.integers(0, 81, cap).astype(np.int32), rng.integers(0, a, cap).astype(np.int32),
             rng.normal(size=cap).astype(np.float32), rng.integers(0, 81, cap).astype(np.int32), rng.random(cap) < 0.3]
    buf, ref_buf = (tdqn.ReplayBuffer(*(torch.as_tensor(x.copy()) for x in ring0)) for _ in range(2))
    jbuf = jdqn.ReplayBuffer(*map(jnp.asarray, ring0))
    prio0 = rng.random(cap).astype(np.float32)
    prio, ref_prio = (torch.as_tensor(prio0.copy()) for _ in range(2)) if prioritized else (None, None)
    jprio = jnp.asarray(prio0)
    p_max = torch.tensor(2.5)
    at_t = torch.tensor(at, dtype=torch.int64)
    stats = ref_stats = (torch.zeros(b), torch.zeros((), dtype=torch.int64), torch.zeros(()))
    j_ret_sum = jnp.float32(0.0)
    for _ in range(6):
        q = (rng.integers(-2, 3, (b, a)) * 0.5).astype(np.float32)  # ties
        explore = rng.random(b) < 0.3
        rand_a = rng.integers(0, a, b).astype(np.int32)
        args = (torch.as_tensor(q), torch.as_tensor(explore), torch.as_tensor(rand_a))
        out = tdqn.dqn_act_step(tsem, tbl, st, *args, *stats, 5, ring=(buf, prio, at_t, p_max))
        ref = tdqn.dqn_act_step_reference(tsem, tbl, ref_st, *args, *ref_stats, 5)
        tdqn.replay_write_reference(ref_buf, ref_prio, at_t, tdqn.ReplayBuffer(ref_st.agent_idx, ref[1], ref[3],
                                                                               ref[2], ref[4]), p_max)
        for x, y in zip((*_fields_of(out[0]), *out[1:]), (*_fields_of(ref[0]), *ref[1:])):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip((*buf, *([prio] if prioritized else [])), (*ref_buf, *([ref_prio] if prioritized else []))):
            assert torch.equal(_bits(x), _bits(y))
        # the reference's lines: act, step, store, priority fill
        obs = jst.agent_idx
        greedy = jnp.argmax(jnp.asarray(q), axis=-1).astype(jnp.int32)
        actions = jnp.where(jnp.asarray(explore), jnp.asarray(rand_a), greedy)
        jst, (next_obs, reward, done) = jbp.step_bits(jsem, jbl, jst, actions, True, 5)
        jbuf = jdqn.buffer_write(jbuf, jnp.int32(at), jdqn.ReplayBuffer(obs, actions, reward, next_obs, done))
        jprio = jax.lax.dynamic_update_slice_in_dim(jprio, jnp.full((b,), 2.5, jnp.float32), at, 0)
        j_ret_sum = j_ret_sum + jnp.sum(jnp.where(done, jnp.asarray(stats[0].numpy()) + reward, 0.0))
        for name, x, y in zip(tdqn.ReplayBuffer._fields, buf, jbuf):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), name)
        if prioritized:
            np.testing.assert_array_equal(prio.numpy(), np.asarray(jprio))
        for f in ("agent_idx", "agent_code", "t", "done"):
            np.testing.assert_array_equal(getattr(out[0], f).numpy(), np.asarray(getattr(jst, f)), f)
        st, stats = out[0], tuple(out[5:])
        ref_st, ref_stats = ref[0], tuple(ref[5:])
        np.testing.assert_allclose(float(stats[2]), float(j_ret_sum), rtol=1e-6)
    untouched = torch.ones(cap, dtype=torch.bool)
    untouched[at:at + b] = False
    assert torch.equal(buf.obs[untouched], torch.as_tensor(ring0[0])[untouched])
    assert int(stats[1]) > 0  # the time limit of 5 ends every episode at least once


def test_step_scalars_match_the_reference_schedules():
    cfg = tm.DQNConfig(buffer_capacity=128, batch_size_train=48, eps_anneal_steps=7, learn_start=70,
                       per_beta_anneal_steps=5, target_update_every=4)
    sc = tdqn.step_scalars(cfg, torch.tensor(2, dtype=torch.int32), 8, 32)
    t = np.arange(2, 10)
    np.testing.assert_array_equal(sc.at.numpy(), (t * 32) % 128)
    np.testing.assert_array_equal(sc.size.numpy(), np.minimum((t + 1) * 32, 128))
    np.testing.assert_array_equal(sc.valid.numpy(), ((t >= 70 // 32) & (np.minimum((t + 1) * 32, 128) >= 48)))
    np.testing.assert_array_equal(sc.sync.numpy(), (t + 1) % 4 == 0)
    eps = np.asarray(1.0 + jnp.clip(jnp.asarray(t, jnp.int32) / 7, 0.0, 1.0) * (0.05 - 1.0))
    beta = np.asarray(0.4 + (1.0 - 0.4) * jnp.clip(jnp.asarray(t, jnp.int32) / 5, 0.0, 1.0))
    np.testing.assert_allclose(sc.eps.numpy(), eps, rtol=1e-6)
    np.testing.assert_allclose(sc.beta.numpy(), beta, rtol=1e-6)
    one = sc[3]
    assert one.at.shape == () and int(one.at) == (5 * 32) % 128


# ---------------------------------------------------------------------------
# Chunk invariance, bit for bit
# ---------------------------------------------------------------------------


def assert_states_bitequal(a, b):
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.target_params[name], b.target_params[name]), name
        assert torch.equal(a.opt_state.mu[name], b.opt_state.mu[name]), name
        assert torch.equal(a.opt_state.nu[name], b.opt_state.nu[name]), name
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert torch.equal(getattr(a.env_state, f), getattr(b.env_state, f))
    for x, y in zip(a.buf, b.buf):
        assert torch.equal(x, y)
    for f in ("prio", "p_max", "t", "run_ret", "episodes", "ret_sum", "last_loss"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.seed == b.seed


CHUNK_KW = dict(buffer_capacity=256, batch_size_train=32, hidden=(32,), embed_dim=16, max_episode_steps=16,
                eps_anneal_steps=100)


@pytest.mark.parametrize("extra", [
    {},
    {"prioritized": True},
    {"prioritized": True, "target_update": "hard", "target_update_every": 7, "double": False},
    {"lr_schedule": "linear", "lr_decay_steps": 100, "lr_final_frac": 0.1, "compute_dtype": "float32"},
    {"obs": "grid", "conv_channels": (8,), "prioritized": True},
])
def test_dqn_chunking_is_bitexact(extra):
    """120 steps against 60 + 60, as the reference's checkpoint test."""
    level = corridor()
    cfg = tm.DQNConfig(**{**CHUNK_KW, **extra})
    ts0 = tm.dqn_init(TSEM, level, 3, cfg, batch_size=16)
    full = tm.dqn_run(TSEM, level, ts0, cfg, num_steps=120)
    half = tm.dqn_run(TSEM, level, ts0, cfg, num_steps=60)
    resumed = tm.dqn_run(TSEM, level, half, cfg, num_steps=60)
    assert_states_bitequal(full, resumed)
    assert int(full.t) == 120 and int(ts0.t) == 0 and int(full.opt_state.count) == 120
    assert not ts0.buf.obs.any() and not ts0.prio.any()  # the input state is not written
    assert_states_bitequal(full, tm.dqn_run(TSEM, level, ts0, cfg, num_steps=120))
    if "lr_schedule" in extra:  # the schedule is wired: a constant rate ends elsewhere
        const = tm.dqn_run(TSEM, level, ts0, tm.DQNConfig(**{**CHUNK_KW, "compute_dtype": "float32"}), 120)
        assert not torch.equal(const.params["embed"], full.params["embed"])


# ---------------------------------------------------------------------------
# Learning, as the reference's own tests
# ---------------------------------------------------------------------------

LEARN_KW = dict(lr=2e-3, buffer_capacity=1024, batch_size_train=64, eps_anneal_steps=400, learn_start=64,
                hidden=(64,), embed_dim=32, max_episode_steps=32)


def _greedy_q_reaches_goal(level, params, cfg, max_steps=12):
    net = tm.make_q_network(level, 4, cfg)
    state = T.reset(level, 1)
    for _ in range(max_steps):
        a = tm.greedy_q_actions(net, params, state.agent_idx)
        state, out = T.step(TSEM, level, state, a)
        if bool(out.done):
            return True, float(out.reward)
    return False, 0.0


@pytest.mark.parametrize("extra", [{}, {"prioritized": True, "per_beta_anneal_steps": 600},
                                   {"target_update": "hard", "target_update_every": 50}])
def test_dqn_learns_corridor(extra):
    level = corridor()
    cfg = tm.DQNConfig(**LEARN_KW, **extra)
    res = tm.dqn_train(TSEM, level, 0, cfg, num_steps=800, batch_size=64)
    assert int(res.episodes) > 100
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_q_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0
    net = tm.make_q_network(level, 4, cfg)
    assert float(tm.greedy_success_rate(TSEM, net, res.params, level, max_steps=12)) == 1.0


def test_dqn_capacity_divisibility():
    bad = tm.DQNConfig(**{**LEARN_KW, "buffer_capacity": 1000})  # not divisible by 64
    with pytest.raises(ValueError, match="multiple"):
        tm.dqn_train(TSEM, corridor(), 0, bad, num_steps=4, batch_size=64)
    with pytest.raises(ValueError, match="target_update"):
        tm.dqn_train(TSEM, corridor(), 0, tm.DQNConfig(**LEARN_KW, target_update="soft"), 4, 64)
    with pytest.raises(ValueError, match="lr_decay_steps"):
        tm.dqn_train(TSEM, corridor(), 0, tm.DQNConfig(**LEARN_KW, lr_schedule="linear"), 4, 64)


def test_q_network_families():
    level = corridor()
    for cfg, cls in ((tm.DQNConfig(), tm.QNetwork), (tm.DQNConfig(obs="grid"), tm.ConvQNetwork)):
        net = tm.make_q_network(level, 4, cfg)
        assert isinstance(net, cls)
        params = tm.init_network_params(net, 0)
        obs = torch.tensor([0, 3, 5], dtype=torch.int32)
        q = net.q_values(params, obs)
        logits, _ = net(obs)
        assert q.shape == (3, 4)
        a = tm.greedy_q_actions(net, params, obs)
        assert a.dtype == torch.int32 and torch.equal(a, q.argmax(-1).int())
        assert logits.shape == q.shape
