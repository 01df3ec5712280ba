"""Port parity: griduniverse_tpu_torch.algos.td_batched (K6's plain version
on the CPU) against the JAX per-maze TD learner.

With the reference's own draws injected (its per-step keys are
`fold_in(key, t)`; `epsilon_greedy` takes one uniform and one randint per
env), float32 tables, env states and episode counts are compared bit for
bit; `ret_sum` is summed in another order (per maze, then across mazes) and
is compared with rtol=1e-6. bfloat16 tables are compared to one bfloat16
ulp (the port rounds where the reference does on the CPU; an ulp is left
for a fused multiply-add at a rounding tie). The native xorshift stream is
tested for what it must do: solve the mazes, keep mazes isolated, resume
exactly.
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
from griduniverse_tpu.algos import td_batched as jtb
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.algos import td_batched as ttb
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def ab_mazes(seed, n, cells=(2, 2)):
    """N Aldous–Broder mazes from the port's generator (goal bottom-right),
    as both packages' batched levels."""
    grids, start = tm.generate_mazes_device(seed, cells, n, "aldous_broder", device=CPU)
    g = grids.numpy()
    start = np.full((n,), int(start), np.int32)
    return JLevel(grid=jnp.asarray(g), start_idx=jnp.asarray(start)), T.make_level(g, start, device=CPU)


def jax_draws(key, n, steps, epsilon, t0=0, num_actions=4):
    """The draws `q_learning_batched(..., key)` makes: (explore (T, N),
    rand_a (T, N), explore0 (N,), rand_a0 (N,)) as torch tensors."""
    key, k_a0 = jax.random.split(key)

    def one(k):
        ku, ka = jax.random.split(k)
        return (jax.random.uniform(ku, (n,)) < epsilon,
                jax.random.randint(ka, (n,), 0, num_actions, dtype=jnp.int32))

    e0, r0 = one(k_a0)
    e, r = jax.vmap(lambda t: one(jax.random.fold_in(key, t)))(t0 + jnp.arange(steps, dtype=jnp.int32))
    return tuple(torch.as_tensor(np.array(x)) for x in (e, r, e0, r0))


def success_rate(levels, q, max_steps=30):
    policy = ta.greedy_policy_from_q(q.float())
    return float(ta.run_greedy_episode(TSEM, levels, policy, max_steps=max_steps)[3].float().mean())


@pytest.mark.parametrize("algo", ["q_learning", "sarsa", "expected_sarsa"])
def test_float32_matches_jax_with_injected_draws(algo):
    n, steps, eps = 24, 300, 0.2
    jl, tl = ab_mazes(1, n, (3, 3))
    kw = dict(alpha=0.2, gamma=0.95, epsilon=eps, algo=algo, max_episode_steps=40)
    key = jax.random.PRNGKey(4)
    jres = ja.q_learning_batched(JSEM, jl, key, num_steps=steps, **kw)
    tres = ta.q_learning_batched(TSEM, tl, 0, num_steps=steps, draws=jax_draws(key, n, steps, eps), **kw)
    # XLA's CPU backend may fuse r + γ·v into one multiply-add, which can
    # move δ by an ulp; the integer state is equal as long as no greedy
    # tie flips, which holds over these 300 steps
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), rtol=1e-6, atol=1e-6)
    for f in ("agent_idx", "agent_code", "t"):
        np.testing.assert_array_equal(getattr(tres.state.env_state, f).numpy(), np.asarray(getattr(jres.state.env_state, f)))
    np.testing.assert_array_equal(tres.state.a.numpy(), np.asarray(jres.state.a))
    np.testing.assert_array_equal(tres.state.run_ret.numpy(), np.asarray(jres.state.run_ret))
    assert int(tres.episodes) == int(jres.episodes) > 0
    np.testing.assert_allclose(float(tres.mean_return), float(jres.mean_return), rtol=1e-6)
    assert tres.state.t == int(jres.state.t) == steps and tres.q.dtype == torch.float32

    # a reference carry converted into the port resumes the same stream
    more = 100
    jres2 = ja.q_learning_batched(JSEM, jl, key, num_steps=more, state0=jres.state, **kw)
    e, r, _, _ = jax_draws(key, n, more, eps, t0=steps)
    st = convert.to_batched_td_state(jres.state, device=CPU)
    assert int(st.n_eps_env.sum()) == int(jres.episodes)
    tres2 = ta.q_learning_batched(TSEM, tl, 0, num_steps=more, state0=st,
                                  draws=(e, r, e[0], r[0]), **kw)
    np.testing.assert_allclose(tres2.q.numpy(), np.asarray(jres2.q), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tres2.state.env_state.agent_idx.numpy(), np.asarray(jres2.state.env_state.agent_idx))
    assert int(tres2.episodes) == int(jres2.episodes) and tres2.state.t == steps + more


@pytest.mark.parametrize("algo", ["q_learning", "sarsa", "expected_sarsa"])
def test_bfloat16_matches_jax_within_one_ulp(algo):
    n, steps, eps = 16, 200, 0.2
    jl, tl = ab_mazes(2, n, (3, 3))
    kw = dict(alpha=0.2, gamma=0.95, epsilon=eps, algo=algo, max_episode_steps=40, dtype="bfloat16")
    key = jax.random.PRNGKey(9)
    jres = ja.q_learning_batched(JSEM, jl, key, num_steps=steps, **kw)
    tres = ta.q_learning_batched(TSEM, tl, 0, num_steps=steps, draws=jax_draws(key, n, steps, eps), **kw)
    assert tres.q.dtype == torch.bfloat16
    got, want = tres.q.float().numpy(), np.asarray(jres.q.astype(jnp.float32))
    # one bfloat16 ulp is 2^-7 of the value's binade; entries near 0 get
    # an absolute 2^-7 (an ulp at magnitude 1, the size of one step cost)
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7)
    assert int(tres.episodes) == int(jres.episodes)


def test_solves_every_maze_with_the_native_stream():
    _, tl = ab_mazes(0, 16)
    res = ta.q_learning_batched(TSEM, tl, 1, num_steps=3000, epsilon=0.2, max_episode_steps=40)
    assert success_rate(tl, res.q) == 1.0
    assert int(res.episodes) > 0 and np.isfinite(float(res.mean_return))
    assert int(res.episodes) == int(res.state.n_eps_env.sum())


@pytest.mark.parametrize("algo,dtype", [("sarsa", "float32"), ("expected_sarsa", "float32"), ("q_learning", "bfloat16")])
def test_variants_solve(algo, dtype):
    _, tl = ab_mazes(2, 8)
    res = ta.q_learning_batched(
        TSEM, tl, 3, num_steps=3000, epsilon=0.2, algo=algo, max_episode_steps=40, dtype=dtype
    )
    assert res.q.dtype == ttb._DTYPES[dtype]
    assert success_rate(tl, res.q) >= 0.9


def test_mazes_learn_in_isolation():
    _, a = ab_mazes(4, 4)
    _, b = ab_mazes(5, 4)
    mix = T.Level(grid=torch.cat([a.grid[:1], b.grid[1:]]), start_idx=a.start_idx)
    r1 = ta.q_learning_batched(TSEM, mix, 6, num_steps=400, max_episode_steps=20)
    r2 = ta.q_learning_batched(TSEM, a, 6, num_steps=400, max_episode_steps=20)
    assert torch.equal(r1.q[0], r2.q[0]) and not torch.equal(r1.q[1:], r2.q[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_resume_bitexact(dtype):
    _, tl = ab_mazes(9, 8)
    kw = dict(epsilon=0.2, max_episode_steps=20, algo="sarsa", dtype=dtype)
    full = ta.q_learning_batched(TSEM, tl, 10, num_steps=400, **kw)
    h1 = ta.q_learning_batched(TSEM, tl, 10, num_steps=150, **kw)
    q_mid = h1.q.clone()
    h2 = ta.q_learning_batched(TSEM, tl, 10, num_steps=250, state0=h1.state, **kw)
    assert torch.equal(full.q, h2.q) and torch.equal(h1.q, q_mid)  # the carry is not mutated
    assert int(full.episodes) == int(h2.episodes)
    assert torch.equal(full.mean_return, h2.mean_return)
    assert torch.equal(full.state.rs, h2.state.rs) and h2.state.t == 400
    # a bare q0 warm start restarts the envs and the stream: not a resume
    warm = ta.q_learning_batched(TSEM, tl, 10, num_steps=250, q0=h1.q, **kw)
    assert not torch.equal(warm.q, h2.q) and warm.state.t == 250


def test_close_to_vi_values_on_visited_states():
    _, tl = ab_mazes(7, 8)
    v_star, _, _ = ta.value_iteration_batched_grid(TSEM, tl, gamma=0.95)
    res = ta.q_learning_batched(
        TSEM, tl, 8, num_steps=6000, epsilon=0.3, gamma=0.95, alpha=0.2, max_episode_steps=40
    )
    start = int(tl.start_idx[0])
    v_hat = res.q.max(dim=-1).values[:, start]
    np.testing.assert_allclose(v_hat.numpy(), v_star[:, start].numpy(), atol=0.5)


def test_rejects_shared_level_unknown_algo_and_bad_draws():
    _, tl = ab_mazes(0, 4)
    with pytest.raises(ValueError, match="batched"):
        ta.q_learning_batched(TSEM, tb.lava_level(device=CPU), 0)
    with pytest.raises(ValueError):
        ta.q_learning_batched(TSEM, tl, 0, algo="nope")
    e = torch.zeros((5, 4), dtype=torch.bool)
    r = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="draws"):
        ta.q_learning_batched(TSEM, tl, 0, num_steps=6, draws=(e, r, e[0], r[0]))
    assert hasattr(jtb, "_q_rows") and not hasattr(ttb, "_SELECT_TREE_MAX_STATES")


# 9: the eight king moves and a stay; 25: every move of at most two rows and two columns
ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("algo", ["q_learning", "sarsa", "expected_sarsa"])
def test_float32_matches_jax_with_injected_draws_at_more_actions(algo, a):
    """K6's plain version at A above 8 with the reference's draws over A
    actions, to the same tolerances as at four. XLA's CPU backend fuses
    r + γ·v into one multiply-add; with nine or 25 actions several actions
    of a cell share a value exactly (moves into a wall and the stay), so a
    one-ulp difference between such twins flips a greedy tie sooner than at
    four (after about 140 steps here): the run is 100 steps."""
    jsem = J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a]))
    tsem = T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU)
    n, steps, eps = 24, 100, 0.2
    jl, tl = ab_mazes(3, n, (3, 3))
    kw = dict(alpha=0.2, gamma=0.95, epsilon=eps, algo=algo, max_episode_steps=40)
    key = jax.random.PRNGKey(a)
    jres = ja.q_learning_batched(jsem, jl, key, num_steps=steps, **kw)
    tres = ta.q_learning_batched(tsem, tl, 0, num_steps=steps, draws=jax_draws(key, n, steps, eps, num_actions=a), **kw)
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), rtol=1e-6, atol=1e-6)
    for f in ("agent_idx", "agent_code", "t"):
        np.testing.assert_array_equal(getattr(tres.state.env_state, f).numpy(), np.asarray(getattr(jres.state.env_state, f)))
    np.testing.assert_array_equal(tres.state.a.numpy(), np.asarray(jres.state.a))
    assert int(tres.episodes) == int(jres.episodes) > 0
    np.testing.assert_allclose(float(tres.mean_return), float(jres.mean_return), rtol=1e-6)
