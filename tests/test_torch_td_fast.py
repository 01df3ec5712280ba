"""Port parity: griduniverse_tpu_torch.algos.td_fast (K5's plain version on
the CPU) against the JAX fast TD engine.

The reference reads Q and writes α·δ through bfloat16 and promises a
learning outcome, not bits; the port keeps float32 and aggregates in exact
fixed point. So: everything discrete (actions, env state, xorshift lanes,
episode counts) is bit-exact for one step from a Q that bfloat16 holds
exactly; the new Q agrees to the reference's bfloat16 rounding; and both
reach the optimal policy.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.algos import td_fast as jtf
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.algos import td_fast as ttf
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def _random_train_state(rng, jbl, b, max_ep, jsem=JSEM):
    """A reference FastTDTrainState mid-run, made with numpy: agents on
    random open tiles, Q in multiples of 1/8 (exact in bfloat16)."""
    codes = np.asarray(jb.walls_and_goal_16x16().grid).reshape(-1)
    open_idx = np.flatnonzero(codes == 0)
    idx = rng.choice(open_idx, size=b).astype(np.int32)
    q = (rng.integers(-64, 65, size=(codes.size, jsem.num_actions)) / 8.0).astype(np.float32)
    ts = jtf.fast_td_init(jsem, jbl, jnp.uint32(11), b, q0=jnp.asarray(q))
    state = jbp.FastState(
        agent_idx=jnp.asarray(idx),
        agent_code=jnp.asarray(codes[idx].astype(np.int32)),
        t=jnp.asarray(rng.integers(0, max_ep, size=b).astype(np.int32)),
        done=jnp.zeros(b, bool),
    )
    return ts.replace(
        env_state=state,
        rs=jnp.asarray(rng.integers(1, 2**32, size=b, dtype=np.uint64).astype(np.uint32)),
        run_ret=jnp.asarray(-rng.integers(0, 30, size=b).astype(np.float32)),
        n_eps_env=jnp.asarray(rng.integers(0, 5, size=b).astype(np.int32)),
        ret_sum_env=jnp.asarray(-rng.integers(0, 90, size=b).astype(np.float32)),
    )


def _assert_discrete_state_equal(jts, tts):
    for f in ("agent_idx", "agent_code", "t", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(jts.env_state, f)), getattr(tts.env_state, f).numpy())
    np.testing.assert_array_equal(np.asarray(jts.rs).view(np.int32), tts.rs.numpy())
    np.testing.assert_array_equal(np.asarray(jts.n_eps_env), tts.n_eps_env.numpy())
    np.testing.assert_array_equal(np.asarray(jts.run_ret), tts.run_ret.numpy())
    np.testing.assert_array_equal(np.asarray(jts.ret_sum_env), tts.ret_sum_env.numpy())
    assert int(jts.step) == tts.step


@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
def test_one_step_matches_jax(algo, rng):
    _one_step_matches_jax(algo, rng, JSEM, TSEM)


# 9: the eight king moves and a stay; 25: every move of at most two rows and two columns
ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
def test_one_step_matches_jax_at_more_actions(algo, a, rng):
    """K5's plain version at A above 8: the ε-greedy draw over A actions,
    the row's maximum and expectation over A."""
    _one_step_matches_jax(algo, rng, J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a])),
                          T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU))


def _one_step_matches_jax(algo, rng, jsem, tsem):
    b, max_ep, alpha, gamma, eps = 512, 40, 0.25, 0.9, 0.3
    jbl = jbp.pack_level(jb.walls_and_goal_16x16())
    tbl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    jts = _random_train_state(rng, jbl, b, max_ep, jsem)
    tts = convert.to_fast_td_state(jts, device=CPU)
    _assert_discrete_state_equal(jts, tts)
    np.testing.assert_array_equal(np.asarray(jts.q), tts.q.numpy())

    jnew = jtf.compile_fast_td_run(jsem, jbl, 1, alpha, gamma, eps, algo, max_ep)(jts)
    tnew = ttf.td_scan_fast(tsem, tbl, tts, 1, alpha, gamma, eps, algo, max_ep)
    # actions, s2, r and done all show in these: the env state after the
    # step, the running returns and the episode counts
    _assert_discrete_state_equal(jnew, tnew)
    # The reference rounds each α·δ to bfloat16, so the new Q agrees to
    # 2^-8·max|α·δ|, with |δ| <= max|r| + (1 + γ)·max|Q| = 10 + (1 + γ)·8
    # here; for expected SARSA it also reads the target v (|v| <= 8)
    # through bfloat16.
    dq = np.abs(tnew.q.numpy() - tts.q.numpy())
    atol = 2.0**-8 * alpha * (10.0 + (1.0 + gamma) * 8.0)
    if algo == "expected_sarsa":
        atol += alpha * gamma * 8.0 * 2.0**-8
    assert dq.max() > 0.1
    np.testing.assert_allclose(tnew.q.numpy(), np.asarray(jnew.q), atol=atol, rtol=0)
    # cells no env visited keep their bits
    untouched = dq == 0
    np.testing.assert_array_equal(tnew.q.numpy()[untouched], np.asarray(jts.q)[untouched])


def test_epsilon_greedy_bits_matches_jax(rng):
    rows = (rng.integers(-4, 5, size=(4096, 4)) / 2.0).astype(np.float32)  # many ties
    bits = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for eps in (0.0, 0.1, 0.5, 1.0):
        want = np.asarray(jtf._epsilon_greedy_bits(jnp.asarray(rows), jnp.asarray(bits), eps))
        got = ttf._epsilon_greedy_bits(torch.as_tensor(rows), torch.as_tensor(bits.view(np.int32)), eps)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_shared_q_update_is_order_free_and_a_mean(rng):
    q = torch.as_tensor(rng.normal(size=(9, 4)).astype(np.float32))
    b = 2000
    s = torch.as_tensor(rng.integers(0, 3, size=b).astype(np.int32))  # heavy collisions
    a = torch.as_tensor(rng.integers(0, 4, size=b).astype(np.int32))
    delta = torch.as_tensor(rng.normal(size=b).astype(np.float32) * 7)
    out = ttf.shared_q_update(q, s, a, delta, 0.1)
    perm = torch.as_tensor(rng.permutation(b))
    assert torch.equal(out, ttf.shared_q_update(q, s[perm], a[perm], delta[perm], 0.1))
    # against a float64 mean: the fixed-point unit is 2^-32 per addend
    want = q.double().clone()
    inc = (0.1 * delta).double()
    for cell in range(12):
        sel = (s.long() * 4 + a.long()) == cell
        want.view(-1)[cell] += inc[sel].mean()
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-7, atol=2.0**-31)
    # one env: q + α·δ to within the fixed-point unit
    one = ttf.shared_q_update(q, s[:1], a[:1], delta[:1], 0.1)
    want1 = q.clone()
    want1[s[0].item(), a[0].item()] += 0.1 * delta[0]
    np.testing.assert_allclose(one.numpy(), want1.numpy(), rtol=0, atol=2.0**-24)


@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
def test_fast_td_converges_to_optimal_policy(algo):
    level = tb.lava_level(device=CPU)
    fn = ta.compile_q_learning_fast(
        TSEM, tbp.pack_level(level), batch_size=256, num_steps=3000, alpha=0.2, gamma=0.99,
        epsilon=0.2, algo=algo, max_episode_steps=100,
    )
    res = fn(0)
    assert int(res.episodes) > 0 and res.q.dtype == torch.float32
    # the learned greedy policy's return from the start equals the optimal
    # undiscounted return (gamma=1 value iteration), as the reference's test
    policy = ta.greedy_policy_from_q(res.q)
    _, total, _, reached = ta.run_greedy_episode(TSEM, level, policy, max_steps=50)
    v1, _, _ = ta.value_iteration(T.build_model_table(TSEM, level), gamma=1.0)
    assert bool(reached) and float(total) == float(v1[int(level.start_idx)]) == -5.0
    # the reference, same settings, reaches the same return
    jres = jtf.compile_q_learning_fast(
        JSEM, jbp.pack_level(jb.lava_level()), 256, 3000, 0.2, 0.99, 0.2, algo, 100
    )(jnp.uint32(0))
    jpol = torch.as_tensor(np.asarray(jnp.argmax(jres.q, axis=-1)).astype(np.int32))
    assert float(ta.run_greedy_episode(TSEM, level, jpol, max_steps=50)[1]) == float(total)
    np.testing.assert_allclose(int(res.episodes), int(jres.episodes), rtol=0.05)


def test_fast_td_improves_return_over_training():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    short = ta.compile_q_learning_fast(TSEM, bl, 128, 200, epsilon=0.1, max_episode_steps=200)(1)
    long = ta.compile_q_learning_fast(TSEM, bl, 128, 4000, epsilon=0.1, max_episode_steps=200)(1)
    assert float(long.mean_return) > float(short.mean_return)


def _fields(ts):
    st = ts.env_state
    return (ts.q, st.agent_idx, st.agent_code, st.t, st.done, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env)


@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
def test_chunked_and_repeated_runs_are_bitexact(algo):
    bl = tbp.pack_level(tb.lava_level(device=CPU))
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=100)
    ref = ta.compile_q_learning_fast(TSEM, bl, batch_size=64, num_steps=600, **kw)(5)
    again = ta.compile_q_learning_fast(TSEM, bl, batch_size=64, num_steps=600, **kw)(5)
    run = ta.compile_fast_td_run(TSEM, bl, chunk_steps=200, **kw)
    ts = ta.fast_td_init(TSEM, bl, 5, batch_size=64)
    for _ in range(3):
        ts = run(ts)
    res = ta.fast_td_result(ts)
    assert ts.step == 600
    for got in (res, again):
        assert torch.equal(got.q.view(torch.int32), ref.q.view(torch.int32))
        assert int(got.episodes) == int(ref.episodes) > 0
        assert torch.equal(got.mean_return, ref.mean_return)
    # resuming from a copy of a mid-run state continues identically
    mid = run(ta.fast_td_init(TSEM, bl, 5, batch_size=64))
    copy = ttf.FastTDTrainState(*[x.clone() if isinstance(x, torch.Tensor) else x for x in (
        mid.q, tbp.FastState(*[f.clone() for f in (mid.env_state.agent_idx, mid.env_state.agent_code,
                                                  mid.env_state.t, mid.env_state.done)]),
        mid.rs, mid.step, mid.run_ret, mid.n_eps_env, mid.ret_sum_env)])
    for x, y in zip(_fields(run(copy)), _fields(run(mid))):
        assert torch.equal(x, y)


def test_q0_warm_start_and_per_env_levels():
    level = tb.lava_level(device=CPU)
    bl = tbp.pack_level(level)
    q0 = torch.full((81, 4), -3.0)
    ts = ta.fast_td_init(TSEM, bl, 2, 16, q0=q0)
    assert torch.equal(ts.q, q0) and ts.q is not q0 and ts.rs.shape == (16,)
    # per-env copies of one level learn like the shared level
    per_env = tbp.pack_level(T.Level(level.grid.expand(32, 9, 9).contiguous(), level.start_idx.expand(32).contiguous()))
    kw = dict(num_steps=300, alpha=0.2, epsilon=0.2, max_episode_steps=50)
    a = ta.compile_q_learning_fast(TSEM, bl, 32, **kw)(4)
    b = ta.compile_q_learning_fast(TSEM, per_env, 32, **kw)(4)
    assert torch.equal(a.q, b.q) and int(a.episodes) == int(b.episodes)


def test_fast_td_rejects_bad_algo():
    bl = tbp.pack_level(tb.lava_level(device=CPU))
    with pytest.raises(ValueError):
        ta.compile_q_learning_fast(TSEM, bl, 32, 10, algo="dyna")
    with pytest.raises(ValueError):
        ta.compile_fast_td_run(TSEM, bl, 10, algo="sarsa")
    with pytest.raises(ValueError):
        ttf.td_scan_fast(TSEM, bl, ta.fast_td_init(TSEM, bl, 0, 4), 1, 0.1, 0.9, 0.1, "nope", None)
    # the reference's TPU lookups are not carried over
    for name in ("_factor_split",):
        assert hasattr(jtf, name) and not hasattr(ttf, name)
