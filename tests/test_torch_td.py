"""Port parity: griduniverse_tpu_torch.algos.td (K10's plain version on the
CPU) against the JAX TD learners and the NumPy oracle's sequential rule.

`apply_td_updates` sums each cell's α·δ in env order, which is the order of
XLA's CPU scatter, so it is compared with the reference bit for bit. In
`td_run` XLA may fuse r + γ·v into one multiply-add, so Q is compared with
rtol=1e-6 while the integer state must be equal.
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
from griduniverse_tpu.algos import td as jtd
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.utils.oracle import OracleGridEnv
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.algos import td as ttd
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)
SMALL = dict(shape=(4, 4), start_idx=0, lava=[5], goals=[15])


def small_levels():
    return jb.make_level_from_indices(**SMALL), tb.make_level_from_indices(**SMALL, device=CPU)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _collision_batch(rng, b, num_states=16):
    s = rng.integers(0, 3, size=b).astype(np.int32)  # most envs in three states
    s[::9] = rng.integers(0, num_states, size=len(s[::9]))
    a = rng.integers(0, 4, size=b).astype(np.int32)
    delta = (rng.normal(size=b) * 5).astype(np.float32)
    q = rng.normal(size=(num_states, 4)).astype(np.float32)
    return q, s, a, delta


def _td_batch(rng, b):
    """(q, s, a, delta, mask) for `test_apply_td_updates_bitexact`: a batch
    of `b` envs with heavy collisions, or one of K10's hard cases by name."""
    if b == "sa-1":  # one state, one action: every env in the one cell
        n = 300
        return (rng.normal(size=(1, 1)).astype(np.float32), np.zeros(n, np.int32), np.zeros(n, np.int32),
                (rng.normal(size=n) * 5).astype(np.float32), rng.random(n) < 0.5)
    n = {"one-cell": 512, "hot-cell-4096": 4096, "all-masked": 256}.get(b, b)
    q, s, a, delta = _collision_batch(rng, n)
    mask = rng.random(n) < 0.5
    if b == "one-cell":
        s[:], a[:] = 2, 1
    elif b == "hot-cell-4096":  # 90 % of the envs in one cell, the rest spread over Q
        s, a = rng.integers(0, 16, size=n).astype(np.int32), rng.integers(0, 4, size=n).astype(np.int32)
        hot = rng.random(n) < 0.9
        s[hot], a[hot] = 1, 3
    elif b == "all-masked":
        mask[:] = False
    return q, s, a, delta, mask


@pytest.mark.parametrize("b", [1, 32, 256, "one-cell", "hot-cell-4096", "sa-1", "all-masked"])
def test_apply_td_updates_bitexact(b, rng):
    q, s, a, delta, mask = _td_batch(rng, b)
    n = len(s)
    tq, ts, tacts, tdelta = (torch.as_tensor(x) for x in (q, s, a, delta))
    want = ja.apply_td_updates(jnp.asarray(q), jnp.asarray(s), jnp.asarray(a), jnp.asarray(delta), 0.3)
    got = ta.apply_td_updates(tq, ts, tacts, tdelta, 0.3)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want_m = jtd.apply_td_updates_masked(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(a), jnp.asarray(delta), 0.3, jnp.asarray(mask)
    )
    got_m = ttd.apply_td_updates_masked(tq, ts, tacts, tdelta, 0.3, torch.as_tensor(mask))
    np.testing.assert_array_equal(_bits(got_m.numpy()), _bits(want_m))
    none = ttd.apply_td_updates_masked(tq, ts, tacts, tdelta, 0.3, torch.zeros(n, dtype=torch.bool))
    assert torch.equal(none, tq)
    if b == 1:  # the sequential rule q[s, a] + α·δ, exactly
        ref = q.copy()
        ref[s[0], a[0]] = ref[s[0], a[0]] + np.float32(0.3) * delta[0]
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    if b == "all-masked":
        np.testing.assert_array_equal(_bits(got_m.numpy()), _bits(q))


def test_td_errors_match_jax(rng):
    q, s, a, _ = _collision_batch(rng, 64)
    s2 = rng.integers(0, 16, size=64).astype(np.int32)
    a2 = rng.integers(0, 4, size=64).astype(np.int32)
    r = rng.normal(size=64).astype(np.float32)
    d = rng.random(64) < 0.3
    jargs = [jnp.asarray(x) for x in (q, s, a, r, s2)]
    targs = [torch.as_tensor(x) for x in (q, s, a, r, s2)]
    # one multiply and one add from the same inputs: XLA may still fuse
    # them, so the tolerance is one float32 ulp of the target's size
    tol = dict(rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        ta.td_error_qlearning(*targs, torch.as_tensor(d), 0.9).numpy(),
        np.asarray(ja.td_error_qlearning(*jargs, jnp.asarray(d), 0.9)), **tol)
    np.testing.assert_allclose(
        ta.td_error_sarsa(*targs, torch.as_tensor(a2), torch.as_tensor(d), 0.9).numpy(),
        np.asarray(ja.td_error_sarsa(*jargs, jnp.asarray(a2), jnp.asarray(d), 0.9)), **tol)
    np.testing.assert_allclose(
        ta.td_error_expected_sarsa(*targs, torch.as_tensor(d), 0.9, 0.2).numpy(),
        np.asarray(ja.td_error_expected_sarsa(*jargs, jnp.asarray(d), 0.9, 0.2)), **tol)


def test_q_learning_update_bitparity_with_numpy_oracle():
    """B=1: the batched update path equals the sequential scalar rule bit
    for bit on a pre-drawn transition stream (the reference's own test)."""
    jl, _ = small_levels()
    env = OracleGridEnv(np.asarray(jl.grid), int(jl.start_idx), auto_reset=True)
    rng = np.random.default_rng(3)
    alpha, gamma = np.float32(0.5), np.float32(0.9)
    q_np = np.zeros((16, 4), np.float32)
    q = torch.zeros((16, 4))
    s = env.reset()
    for _ in range(500):
        a = int(rng.integers(0, 4))
        s2, r, d, _ = env.step(a)
        target = r if d else r + gamma * q_np[s2].max()
        q_np[s, a] = q_np[s, a] + alpha * np.float32(target - q_np[s, a])
        t = lambda x, dt: torch.as_tensor([x], dtype=dt)  # noqa: E731
        delta = ta.td_error_qlearning(
            q, t(s, torch.int32), t(a, torch.int32), t(r, torch.float32), t(s2, torch.int32),
            t(d, torch.bool), float(gamma),
        )
        q = ta.apply_td_updates(q, t(s, torch.int32), t(a, torch.int32), delta, float(alpha))
        s = env.agent_idx
    np.testing.assert_array_equal(_bits(q.numpy()), _bits(q_np))


def jax_td_draws(key, b, steps, epsilon, t0=0):
    """The draws of `td_init` + `td_run` under `key`: (explore (T, B),
    rand_a (T, B), explore0 (B,), rand_a0 (B,)) as torch tensors."""
    key, _, k_a0 = jax.random.split(key, 3)

    def one(k):
        ku, ka = jax.random.split(k)
        return (jax.random.uniform(ku, (b,)) < epsilon,
                jax.random.randint(ka, (b,), 0, 4, dtype=jnp.int32))

    e0, r0 = one(k_a0)
    e, r = jax.vmap(lambda t: one(jax.random.fold_in(key, t)))(t0 + jnp.arange(steps, dtype=jnp.int32))
    return tuple(torch.as_tensor(np.array(x)) for x in (e, r, e0, r0))


@pytest.mark.parametrize("algo", ["q_learning", "sarsa", "expected_sarsa"])
def test_td_run_matches_jax_with_injected_draws(algo):
    b, steps, eps = 32, 200, 0.2
    jl, tl = jb.lava_level(), tb.lava_level(device=CPU)
    key = jax.random.PRNGKey(5)
    jts = jtd.td_run(JSEM, jl, jtd.td_init(JSEM, jl, key, b, eps), steps, 0.2, 0.95, eps, algo)
    e, r, e0, r0 = jax_td_draws(key, b, steps, eps)
    tts = ttd.td_run(TSEM, tl, ttd.td_init(TSEM, tl, 0, b, eps, draw0=(e0, r0)), steps, 0.2, 0.95, eps,
                     algo, draws=(e, r))
    np.testing.assert_allclose(tts.q.numpy(), np.asarray(jts.q), rtol=1e-6, atol=1e-6)
    for f in ("agent_idx", "t", "done"):
        np.testing.assert_array_equal(getattr(tts.env_state, f).numpy(), np.asarray(getattr(jts.env_state, f)))
    np.testing.assert_array_equal(tts.action.numpy(), np.asarray(jts.action))
    assert int(tts.episodes) == int(jts.episodes) > 0 and tts.step == steps
    np.testing.assert_allclose(float(tts.ret_sum), float(jts.ret_sum), rtol=1e-6)
    # a converted reference state carries Q, envs, action and accumulators
    conv = convert.to_td_state(jts, seed=3, device=CPU)
    assert torch.equal(conv.action, tts.action) and conv.step == steps
    assert torch.equal(conv.env_state.agent_idx, tts.env_state.agent_idx)
    np.testing.assert_array_equal(conv.q.numpy(), np.asarray(jts.q))
    assert conv.rs.shape == (b,) and int(conv.episodes) == int(jts.episodes)


def _optimal(level, q):
    _, total, _, reached = ta.run_greedy_episode(TSEM, level, ta.greedy_policy_from_q(q), max_steps=50)
    v1, _, _ = ta.value_iteration(T.build_model_table(TSEM, level), gamma=1.0)
    return bool(reached) and float(total) == float(v1[int(level.start_idx)])


@pytest.mark.parametrize("fn", ["q_learning", "sarsa", "expected_sarsa"])
def test_learners_reach_the_goal_and_are_chunk_invariant(fn):
    _, level = small_levels()
    res = getattr(ta, fn)(TSEM, level, 0, num_steps=3000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2)
    assert int(res.episodes) > 0 and np.isfinite(float(res.mean_return))
    _, _, _, reached = ta.run_greedy_episode(TSEM, level, ta.greedy_policy_from_q(res.q), max_steps=50)
    assert bool(reached)
    if fn == "q_learning":
        assert _optimal(level, res.q)
    ts = ttd.td_init(TSEM, level, 1, 16, 0.2)
    full = ttd.td_run(TSEM, level, ts, 120, 0.2, 0.99, 0.2, fn)
    half = ttd.td_run(TSEM, level, ttd.td_run(TSEM, level, ts, 50, 0.2, 0.99, 0.2, fn), 70, 0.2, 0.99, 0.2, fn)
    assert torch.equal(full.q, half.q) and torch.equal(full.rs, half.rs) and half.step == 120
    assert torch.equal(full.ret_sum, half.ret_sum) and int(full.episodes) == int(half.episodes)


@pytest.mark.parametrize("coin", ["per_env", "global"])
def test_double_q_learning_reaches_optimal_policy(coin):
    _, level = small_levels()
    res = ta.double_q_learning(
        TSEM, level, 0, num_steps=3000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2, coin=coin
    )
    assert _optimal(level, res.q)
    assert torch.equal(res.q, (res.q_a + res.q_b) * 0.5) and not torch.equal(res.q_a, res.q_b)
    with pytest.raises(ValueError):
        ta.double_q_learning(TSEM, level, 0, num_steps=1, coin="nope")


def test_double_q_learning_matches_jax_with_injected_draws():
    b, steps, eps = 16, 120, 0.2
    jl, tl = small_levels()
    key = jax.random.PRNGKey(2)
    jres = ja.double_q_learning(JSEM, jl, key, num_steps=steps, batch_size=b, alpha=0.2, epsilon=eps)
    key2, _ = jax.random.split(key)

    def one(t):
        k_act, k_coin = jax.random.split(jax.random.fold_in(key2, t))
        ku, ka = jax.random.split(k_act)
        return (jax.random.uniform(ku, (b,)) < eps,
                jax.random.randint(ka, (b,), 0, 4, dtype=jnp.int32),
                jax.random.bernoulli(k_coin, shape=(b,)))

    draws = tuple(torch.as_tensor(np.array(x)) for x in jax.vmap(one)(jnp.arange(steps, dtype=jnp.int32)))
    tres = ta.double_q_learning(TSEM, tl, 0, num_steps=steps, batch_size=b, alpha=0.2, epsilon=eps, draws=draws)
    np.testing.assert_allclose(tres.q_a.numpy(), np.asarray(jres.q_a), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tres.q_b.numpy(), np.asarray(jres.q_b), rtol=1e-6, atol=1e-6)
    assert int(tres.episodes) == int(jres.episodes)


def test_epsilon_greedy_both_draw_forms_and_bad_algo():
    rows = torch.as_tensor(np.float32([[0, 2, 2, 1], [3, 3, 0, 0], [1, 0, 0, 5]]))
    explore = torch.tensor([False, True, False])
    rand_a = torch.tensor([3, 2, 1], dtype=torch.int32)
    assert ta.epsilon_greedy(rows, (explore, rand_a), 0.5).tolist() == [1, 2, 3]
    bits = torch.tensor([0x0003FFFF, 0x40000000, -1], dtype=torch.int32)
    # coin = low 16 bits < eps·65536; explore action = top 16 bits · 4 >> 16
    assert ta.epsilon_greedy(rows, bits, 0.5).tolist() == [1, 1, 3]
    assert ta.epsilon_greedy(rows, bits, 1.0).tolist() == [0, 1, 3]
    _, level = small_levels()
    with pytest.raises(ValueError):
        ttd.td_run(TSEM, level, ttd.td_init(TSEM, level, 0, 4), 1, algo="nope")
