"""Port parity: griduniverse_tpu_torch.algos.mc and .td_lambda on the CPU
against the JAX modules, held as tests/test_td_mc.py and
tests/test_td_lambda.py hold the reference.

With `jax.random`'s own draws injected the integer state (visited states,
actions, visit counts, episode counts) must be equal, and values and Q agree
to rtol 1e-6 (atol 1e-6 near zero): XLA may fuse r + γ·g into one
multiply-add and sums the env axis in another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import algos as ja
from griduniverse_tpu.algos import mc as jmc
from griduniverse_tpu.algos import td_lambda as jtl
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.utils.oracle import OracleGridEnv
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.algos import mc as tmc
from griduniverse_tpu_torch.algos import td_lambda as ttl
from griduniverse_tpu_torch.levels import builders as tb

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)
SMALL = dict(shape=(4, 4), start_idx=0, lava=[5], goals=[15])


def small_levels():
    return jb.make_level_from_indices(**SMALL), tb.make_level_from_indices(**SMALL, device=CPU)


def _t(x):
    return torch.as_tensor(np.array(x))


def _eps_pair(key_t, b, epsilon):
    ku, ka = jax.random.split(key_t)
    return jax.random.uniform(ku, (b,)) < epsilon, jax.random.randint(ka, (b,), 0, 4, dtype=jnp.int32)


def jax_mc_draws(key, b, steps, epsilon=None):
    """The draws of `mc._roll_episodes` under `key`: (T, B) actions of the
    random policy, or the ε-greedy pair (explore, rand_a)."""
    key, _ = jax.random.split(key)
    keys = jax.random.split(key, steps)
    if epsilon is None:
        return _t(jax.vmap(lambda k: jax.random.randint(k, (b,), 0, 4, dtype=jnp.int32))(keys))
    e, r = jax.vmap(lambda k: _eps_pair(k, b, epsilon))(keys)
    return _t(e), _t(r)


def jax_td_draws(key, b, steps, epsilon):
    """The draws of `_td_lambda_control` under `key`: (explore (T, B),
    rand_a (T, B), explore0 (B,), rand_a0 (B,))."""
    key, _, k_a0 = jax.random.split(key, 3)
    e0, r0 = _eps_pair(k_a0, b, epsilon)
    e, r = jax.vmap(lambda t: _eps_pair(jax.random.fold_in(key, t), b, epsilon))(jnp.arange(steps, dtype=jnp.int32))
    return _t(e), _t(r), _t(e0), _t(r0)


# ---------------------------------------------------------------------------
# Monte Carlo
# ---------------------------------------------------------------------------


def test_discounted_returns(rng):
    g = tmc.discounted_returns(torch.tensor([[1.0], [1.0], [1.0]]), 0.5)
    np.testing.assert_allclose(g[:, 0].numpy(), [1.75, 1.5, 1.0])
    r = rng.normal(size=(20, 7)).astype(np.float32)
    np.testing.assert_allclose(tmc.discounted_returns(_t(r), 0.9).numpy(),
                               np.asarray(jmc.discounted_returns(jnp.asarray(r), 0.9)), rtol=1e-6, atol=1e-6)


def test_first_visit_mask(rng):
    ids = torch.tensor([[0], [1], [0], [2], [1]], dtype=torch.int32)
    valid = torch.tensor([[True], [True], [True], [True], [False]])
    assert tmc.first_visit_mask(ids, valid)[:, 0].tolist() == [True, True, False, True, False]
    ids = rng.integers(0, 5, size=(12, 9)).astype(np.int32)
    valid = rng.random((12, 9)) < 0.8
    np.testing.assert_array_equal(tmc.first_visit_mask(_t(ids), _t(valid)).numpy(),
                                  np.asarray(jmc.first_visit_mask(jnp.asarray(ids), jnp.asarray(valid))))


@pytest.mark.parametrize("policy", ["random", "eps_greedy"])
def test_roll_episodes_match_jax(policy, rng):
    jlevel, tlevel = small_levels()
    key, b, t = jax.random.PRNGKey(11), 64, 12
    q = rng.normal(size=(16, 4)).astype(np.float32) if policy == "eps_greedy" else None
    eps = 0.3 if policy == "eps_greedy" else None
    want = jmc._roll_episodes(JSEM, jlevel, None if q is None else jnp.asarray(q), key, b, t, eps or 0.0)
    got = tmc._roll_episodes(TSEM, tlevel, None if q is None else _t(q), 0, b, t, eps or 0.0,
                             jax_mc_draws(key, b, t, eps))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4].any() and not got[4].all()


def test_mc_prediction_corridor_analytic():
    # 1x3 corridor s o g, deterministic RIGHT policy: V(0) = -1 + γ·10
    level = tb.make_level_from_indices((1, 3), start_idx=0, goals=[2], device=CPU)
    q_right = torch.zeros((3, 4))
    q_right[:, 1] = 1.0  # greedy = RIGHT
    res = ta.mc_prediction(TSEM, level, 5, policy_q=q_right, gamma=0.99, epsilon=0.0, batch_size=8, max_steps=10)
    np.testing.assert_allclose(float(res.value[0]), -1 + 0.99 * 10.0, atol=1e-5)
    np.testing.assert_allclose(float(res.value[1]), 10.0, atol=1e-5)
    assert res.counts.tolist() == [8.0, 8.0, 0.0]


@pytest.mark.parametrize("first_visit,include_unfinished", [(True, False), (False, False), (True, True)])
def test_mc_prediction_matches_jax(first_visit, include_unfinished):
    """A binding step budget (T=6 on 4x4 under the random policy): both
    finished and unfinished episodes are present."""
    jlevel, tlevel = small_levels()
    key, b, t = jax.random.PRNGKey(11), 256, 6
    kw = dict(gamma=0.9, batch_size=b, max_steps=t, first_visit=first_visit, include_unfinished=include_unfinished)
    want = ja.mc_prediction(JSEM, jlevel, key, policy_q=None, **kw)
    got = ta.mc_prediction(TSEM, tlevel, 0, policy_q=None, draws=jax_mc_draws(key, b, t), **kw)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-6, atol=1e-6)
    assert 0 < float(got.counts.sum())


def test_mc_prediction_truncation_unbiased():
    """Finished-episode-only first-visit aggregation against a straight-line
    NumPy aggregation of the SAME rolled episodes, and the biased estimator
    differs (the reference's test of the same name, on the native stream)."""
    _, level = small_levels()
    gamma, b, t = 0.9, 256, 6
    s, _, r, valid, finished = (x.numpy() for x in tmc._roll_episodes(TSEM, level, None, 11, b, t, 0.0))
    assert 0 < finished.sum() < b
    g = np.zeros_like(r)
    acc = np.zeros(b, np.float32)
    for step in reversed(range(t)):
        acc = r[step] + np.float32(gamma) * acc
        g[step] = acc
    v_sum, n = np.zeros(16, np.float64), np.zeros(16, np.float64)
    for e in range(b):
        if not finished[e]:
            continue
        seen = set()
        for step in range(t):
            if not valid[step, e] or s[step, e] in seen:
                continue
            seen.add(s[step, e])
            v_sum[s[step, e]] += g[step, e]
            n[s[step, e]] += 1
    v_np = np.where(n > 0, v_sum / np.maximum(n, 1), 0.0)
    res = ta.mc_prediction(TSEM, level, 11, policy_q=None, gamma=gamma, batch_size=b, max_steps=t)
    np.testing.assert_array_equal(res.counts.numpy(), n)
    np.testing.assert_allclose(res.value.numpy(), v_np, atol=1e-4)
    biased = ta.mc_prediction(TSEM, level, 11, policy_q=None, gamma=gamma, batch_size=b, max_steps=t,
                              include_unfinished=True)
    assert np.abs(biased.value.numpy() - v_np).max() > 0.05


def test_mc_control_matches_jax():
    jlevel, tlevel = small_levels()
    key, rounds, b, t = jax.random.PRNGKey(6), 6, 64, 20
    kw = dict(num_rounds=rounds, gamma=0.99, epsilon=0.2, alpha=0.1, batch_size=b, max_steps=t)
    want = ja.mc_control(JSEM, jlevel, key, **kw)
    draws = [jax_mc_draws(k, b, t, 0.2) for k in jax.random.split(key, rounds)]
    got = ta.mc_control(TSEM, tlevel, 0, draws=draws, **kw)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-6, atol=1e-6)
    assert int(got.episodes) == int(want.episodes) == rounds * b
    assert float(got.q.abs().max()) > 0


def test_mc_control_reaches_goal():
    _, level = small_levels()
    res = ta.mc_control(TSEM, level, 6, num_rounds=40, gamma=0.99, epsilon=0.2, alpha=0.1, batch_size=64, max_steps=30)
    policy = ta.greedy_policy_from_q(res.q)
    obs, _, length, done = ta.run_greedy_episode(TSEM, level, policy, max_steps=20)
    assert bool(done)
    assert int(level.grid.reshape(-1)[int(obs.reshape(-1)[int(length) - 1])]) == 3  # GOAL


# ---------------------------------------------------------------------------
# TD(λ)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
def test_trace_primitives_match_jax(kind, rng):
    e = (rng.random((5, 16, 4)) * (rng.random((5, 16, 4)) < 0.3)).astype(np.float32)
    e[0, 0, 0] = 1.2e-4  # decays under the cutoff
    s = rng.integers(0, 16, 5).astype(np.int32)
    a = rng.integers(0, 4, 5).astype(np.int32)
    delta = rng.normal(size=5).astype(np.float32)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    je = jtl.decay_traces(jnp.asarray(e), 0.9, 0.8, 1e-4)
    te = ttl.decay_traces(_t(e), 0.9, 0.8, 1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    assert float(te[0, 0, 0]) == 0.0
    je = jtl.bump_traces(je, jnp.asarray(s), jnp.asarray(a), 16, 4, kind)
    te = ttl.bump_traces(te, _t(s), _t(a), 16, 4, kind)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(ttl.apply_trace_updates(_t(q), _t(delta), te, 0.3).numpy(),
                               np.asarray(jtl.apply_trace_updates(jnp.asarray(q), jnp.asarray(delta), je, 0.3)),
                               rtol=1e-5, atol=1e-6)


def test_sarsa_lambda_update_b1_matches_sequential():
    """B=1 batched trace update == the sequential SARSA(λ) scalar rule on
    an identical pre-drawn transition stream (the reference's test)."""
    jlevel, _ = small_levels()
    env = OracleGridEnv(np.asarray(jlevel.grid), int(jlevel.start_idx), auto_reset=True)
    rng = np.random.default_rng(11)
    alpha, gamma, lam, cutoff = 0.5, 0.9, 0.8, 1e-4
    stream = []
    s = env.reset()
    a = int(rng.integers(0, 4))
    for _ in range(300):
        s2, r, d, _ = env.step(a)
        a2 = int(rng.integers(0, 4))
        stream.append((s, a, r, s2, d, a2))
        s, a = env.agent_idx, a2
    q_np, e_np = np.zeros((16, 4), np.float64), np.zeros((16, 4), np.float64)
    for s, a, r, s2, d, a2 in stream:
        e_np *= gamma * lam
        e_np[e_np < cutoff] = 0.0
        e_np[s, a] += 1.0
        delta = (r if d else r + gamma * q_np[s2, a2]) - q_np[s, a]
        q_np += alpha * delta * e_np
        if d:
            e_np[:] = 0.0
    q, e = torch.zeros((16, 4)), torch.zeros((1, 16, 4))
    for s, a, r, s2, d, a2 in stream:
        e = ttl.decay_traces(e, gamma, lam, cutoff)
        e = ttl.bump_traces(e, torch.tensor([s]), torch.tensor([a]), 16, 4, "accumulating")
        target = r if d else r + gamma * float(q[s2, a2])
        q = ttl.apply_trace_updates(q, torch.tensor([target - float(q[s, a])]), e, alpha)
        if d:
            e = torch.zeros_like(e)
    np.testing.assert_allclose(q.numpy(), q_np.astype(np.float32), rtol=2e-4, atol=2e-4)


def test_replacing_trace_caps_at_one():
    e = torch.zeros((1, 4, 2))
    s, a = torch.tensor([1]), torch.tensor([0])
    for _ in range(3):
        e = ttl.bump_traces(e, s, a, 4, 2, "replacing")
    assert float(e[0, 1, 0]) == 1.0
    e = ttl.bump_traces(e, s, a, 4, 2, "accumulating")
    assert float(e[0, 1, 0]) == 2.0


@pytest.mark.parametrize("algo,trace", [("sarsa", "accumulating"), ("sarsa", "replacing"),
                                        ("watkins", "accumulating"), ("watkins", "replacing")])
def test_td_lambda_control_matches_jax(algo, trace):
    jlevel, tlevel = small_levels()
    key, b, steps = jax.random.PRNGKey(5), 16, 120
    jfn = ja.sarsa_lambda if algo == "sarsa" else ja.watkins_q_lambda
    tfn = ta.sarsa_lambda if algo == "sarsa" else ta.watkins_q_lambda
    kw = dict(num_steps=steps, batch_size=b, alpha=0.2, gamma=0.99, epsilon=0.2, lam=0.9, trace=trace)
    want = jfn(JSEM, jlevel, key, **kw)
    got = tfn(TSEM, tlevel, 0, draws=jax_td_draws(key, b, steps, 0.2), **kw)
    assert int(got.episodes) == int(want.episodes) > 0
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.mean_return), float(want.mean_return), rtol=1e-6)


@pytest.mark.parametrize("algo", ["sarsa", "watkins"])
def test_td_lambda_control_matches_jax_across_chunks(algo):
    """B=300 spans two chunks of the trace pass's fixed order of adds."""
    jlevel, tlevel = small_levels()
    key, b, steps = jax.random.PRNGKey(8), 300, 60
    jfn = ja.sarsa_lambda if algo == "sarsa" else ja.watkins_q_lambda
    tfn = ta.sarsa_lambda if algo == "sarsa" else ta.watkins_q_lambda
    kw = dict(num_steps=steps, batch_size=b, alpha=0.2, gamma=0.99, epsilon=0.2, lam=0.9, trace="accumulating")
    want = jfn(JSEM, jlevel, key, **kw)
    got = tfn(TSEM, tlevel, 0, draws=jax_td_draws(key, b, steps, 0.2), **kw)
    assert int(got.episodes) == int(want.episodes) > 0
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.mean_return), float(want.mean_return), rtol=1e-6)


@pytest.mark.parametrize("fn,trace", [("sarsa_lambda", "accumulating"), ("watkins_q_lambda", "replacing")])
def test_td_lambda_reaches_optimal_policy(fn, trace):
    _, level = small_levels()
    res = getattr(ta, fn)(TSEM, level, 5, num_steps=3000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2,
                          lam=0.9, trace=trace)
    assert int(res.episodes) > 50
    policy = ta.greedy_policy_from_q(res.q)
    obs, _, length, done = ta.run_greedy_episode(TSEM, level, policy, max_steps=20)
    assert bool(done)
    assert int(level.grid.reshape(-1)[int(obs.reshape(-1)[int(length) - 1])]) == 3  # GOAL
    assert int(length) == 6  # shortest path


def test_trace_kind_validation():
    _, level = small_levels()
    for fn in (ta.sarsa_lambda, ta.watkins_q_lambda):
        with pytest.raises(ValueError, match="trace"):
            fn(TSEM, level, 0, trace="bogus")
    with pytest.raises(ValueError, match="trace"):
        ta.td_lambda_prediction(TSEM, level, torch.full((16, 4), 0.25), 0, trace="bogus")


def test_td_lambda_prediction_matches_jax(rng):
    jlevel, tlevel = small_levels()
    policy = rng.random((16, 4)).astype(np.float32) + 0.1
    policy /= policy.sum(axis=1, keepdims=True)
    key, b, steps = jax.random.PRNGKey(3), 16, 150
    kw = dict(num_steps=steps, batch_size=b, alpha=0.2, gamma=0.9, lam=0.8)
    want = ja.td_lambda_prediction(JSEM, jlevel, jnp.asarray(policy), key, **kw)
    k, _ = jax.random.split(key)
    gumbel = jax.vmap(lambda t: jax.random.gumbel(jax.random.fold_in(k, t), (b, 4)))(jnp.arange(steps, dtype=jnp.int32))
    got = ta.td_lambda_prediction(TSEM, tlevel, _t(policy), 0, draws=_t(gumbel), **kw)
    assert int(got.episodes) == int(want.episodes) > 0
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=1e-5, atol=1e-6)


def test_td_lambda_prediction_matches_exact_v():
    # 1x4 corridor, deterministic always-right policy: V converges to the
    # exact policy-evaluation values (the reference's test, native stream)
    level = tb.make_level_from_indices((1, 4), start_idx=0, goals=[3], device=CPU)
    policy = torch.nn.functional.one_hot(torch.full((4,), 1), 4).float()
    v_exact, _ = ta.policy_evaluation(T.build_model_table(TSEM, level), policy, gamma=0.9)
    res = ta.td_lambda_prediction(TSEM, level, policy, 0, num_steps=4000, batch_size=8, alpha=0.2, gamma=0.9, lam=0.9)
    assert int(res.episodes) > 100
    np.testing.assert_allclose(res.v[:3].numpy(), v_exact[:3].numpy(), atol=5e-2)
