"""Port parity: the sharded TD(λ) and Monte-Carlo learners of
griduniverse_tpu_torch.parallel.learner (Gloo worlds on the CPU) against the
unsharded port and against the JAX package's sharded functions.

A module-scoped fixture spawns Gloo worlds on the CPU (2 ranks, 4 ranks, and
4 ranks laid out 2 hosts × 2), each rank a fresh process with its own
timeout (`tests/torch_parallel_worker.py` `run_learner_entries`). The tests
hold:

  (i)   each entry against the unsharded port: bit for bit where every
        shard is whole chunks of 256 envs (TD(λ)) and in the parity modes
        (MC, TD(λ) prediction at any batch), else to rtol 1e-6;
  (ii)  each entry against the reference's sharded function on its
        8-device CPU mesh at the same world size, with the same
        numpy-made inputs and JAX's draws injected;
  (iii) Q and V the same bits on every rank;
  (iv)  the reference's errors;
  (v)   the plain version of K12's partial-sums form against `_live_sums`
        and against the reference's `einsum`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.parallel import learner as jplearn
from griduniverse_tpu.parallel import mesh as jmesh
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch import parallel
from griduniverse_tpu_torch.algos import mc as tmc
from griduniverse_tpu_torch.algos import td_lambda as ttl
from griduniverse_tpu_torch.kernels import trace_pass as k12
from griduniverse_tpu_torch.parallel import learner as tplearn
from griduniverse_tpu_torch.parallel.mesh import EnvMesh

from tests import torch_parallel_worker as W

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
WORLDS = {"2": (2, 1), "4": (4, 1), "2x2": (4, 2)}
TDL_KEY, PRED_KEY, MC_KEY = 5, 3, 9


def _t(x):
    return torch.as_tensor(np.array(x))


def _jmesh(name):
    world, hosts = WORLDS[name]
    return jmesh.make_host_env_mesh(hosts, world // hosts) if hosts > 1 else jmesh.make_env_mesh(world)


def _jlevel():
    return jb.make_level_from_indices(**W.LEARNER_LEVEL)


def _eps_pair(key, b, epsilon):
    ku, ka = jax.random.split(key)
    return jax.random.uniform(ku, (b,)) < epsilon, jax.random.randint(ka, (b,), 0, 4, dtype=jnp.int32)


def jax_tdl_sharded_draws(key, world, b, steps, epsilon):
    """The draws of the reference's `td_lambda_sharded` on a mesh of `world`
    shards (each shard's from `fold_in(step key, shard)`), as the global
    (explore (T, B), rand_a (T, B), explore0 (B,), rand_a0 (B,))."""
    key, _, k_a0 = jax.random.split(key, 3)
    lb = b // world

    def global_pair(k):
        pairs = [_eps_pair(jax.random.fold_in(k, idx), lb, epsilon) for idx in range(world)]
        return jnp.concatenate([p[0] for p in pairs]), jnp.concatenate([p[1] for p in pairs])

    e0, r0 = global_pair(k_a0)
    e, r = jax.vmap(lambda t: global_pair(jax.random.fold_in(key, t)))(jnp.arange(steps, dtype=jnp.int32))
    return _t(e), _t(r), _t(e0), _t(r0)


def jax_pred_gumbel(key, b, steps):
    """The (T, B, A) noise of the reference's `td_lambda_prediction_sharded`
    in parity mode (and of the unsharded `td_lambda_prediction`)."""
    k, _ = jax.random.split(key)
    return _t(jax.vmap(lambda t: jax.random.gumbel(jax.random.fold_in(k, t), (b, 4)))(
        jnp.arange(steps, dtype=jnp.int32)))


def jax_mc_draws(key, b, steps, epsilon=None):
    """The draws of the reference's MC roll under a round's `key` (parity
    mode: the full batch's): (T, B) actions, or the pair (explore, rand_a)."""
    key, _ = jax.random.split(key)
    keys = jax.random.split(key, steps)
    if epsilon is None:
        return _t(jax.vmap(lambda k: jax.random.randint(k, (b,), 0, 4, dtype=jnp.int32))(keys))
    e, r = jax.vmap(lambda k: _eps_pair(k, b, epsilon))(keys)
    return _t(e), _t(r)


@pytest.fixture(scope="module")
def policy():
    rng = np.random.default_rng(1)
    p = rng.random((16, 4)).astype(np.float32) + 0.1
    return torch.as_tensor(p / p.sum(axis=1, keepdims=True))


@pytest.fixture(scope="module")
def q0():
    rng = np.random.default_rng(2)
    return torch.as_tensor((rng.integers(-4, 5, size=(16, 4)) / 4.0).astype(np.float32))


def _extra(world, policy, q0):
    eps, steps = W.MC_KW["epsilon"], W.MC_KW["max_steps"]
    rounds = jax.random.split(jax.random.PRNGKey(MC_KEY), W.MC_ROUNDS)
    return dict(
        policy=policy, q0=q0,
        tdl_draws=jax_tdl_sharded_draws(jax.random.PRNGKey(TDL_KEY), world, W.B_TDL_SMALL, W.T_TDL,
                                        W.TDL_KW["epsilon"]),
        pred_gumbel=jax_pred_gumbel(jax.random.PRNGKey(PRED_KEY), W.B_TDL_SMALL, W.T_TDL),
        mc_control_draws=[jax_mc_draws(k, W.B_MC, steps, eps) for k in rounds],
        mc_prediction_draws=jax_mc_draws(jax.random.PRNGKey(MC_KEY), W.B_MC, steps),
    )


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, policy, q0):
    """Every world's per-rank results, by world name."""
    return {name: W.run_world(world, hosts, tmp_path_factory.mktemp(f"learner{name}"), _extra(world, policy, q0),
                              "learner")
            for name, (world, hosts) in WORLDS.items()}


@pytest.fixture(scope="module")
def sem():
    return T.make_semantics(device=CPU)


@pytest.fixture(scope="module")
def level():
    return W.learner_level()


def _bits(x):
    x = torch.as_tensor(x).detach().cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    assert torch.equal(_bits(a), _bits(b))


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(a)), np.asarray(b), rtol=rtol, atol=atol)


# -- (i) against the unsharded port, and (iii) the same bits on every rank -------


@pytest.mark.parametrize("algo,trace", W.TDL_CASES)
@pytest.mark.parametrize("name", WORLDS)
def test_td_lambda_sharded_whole_chunks_equal_the_unsharded_run(worlds, sem, level, name, algo, trace):
    """Every shard one chunk of 256 envs: Q and the episodes bit for bit;
    the mean return to rounding (the ranks' return sums added in rank
    order)."""
    world = WORLDS[name][0]
    fn = ta.sarsa_lambda if algo == "sarsa" else ta.watkins_q_lambda
    want = fn(sem, level, 5, W.T_TDL, W.tdl_batch(world), trace=trace, **W.TDL_KW)
    for r in worlds[name]:
        q, episodes, mean_return = r[f"tdl {algo} {trace}"]
        _equal(q, want.q)
        assert int(episodes) == int(want.episodes) > 0
        _close(mean_return, float(want.mean_return))


@pytest.mark.parametrize("name", WORLDS)
def test_td_lambda_sharded_split_chunks_agree_with_the_unsharded_run(worlds, sem, level, name):
    """B/n = 12 or 6: the chunks fall otherwise than in the unsharded run,
    and Q agrees to rtol 1e-6; the ranks hold the same bits."""
    want = ta.watkins_q_lambda(sem, level, 5, W.T_TDL, W.B_TDL_SMALL, **W.TDL_KW)
    results = worlds[name]
    for r in results:
        q, episodes, _ = r["tdl small"]
        _close(q, want.q)
        assert int(episodes) == int(want.episodes) > 0
        _equal(q, results[0]["tdl small"][0])


@pytest.mark.parametrize("case", ["pred big", "pred big parity", "pred small parity", "pred small"])
@pytest.mark.parametrize("name", WORLDS)
def test_td_lambda_prediction_sharded_equals_the_unsharded_run(worlds, sem, level, policy, name, case):
    """Whole chunks, or parity mode at any batch: V bit for bit; B/n not a
    multiple of 256 in scalable mode: to rtol 1e-6."""
    world = WORLDS[name][0]
    b = W.tdl_batch(world) if "big" in case else W.B_TDL_SMALL
    want = ta.td_lambda_prediction(sem, level, policy, 3, W.T_TDL, b, **W.PRED_KW)
    results = worlds[name]
    for r in results:
        v, episodes = r[case]
        if case == "pred small":
            _close(v, want.v)
        else:
            _equal(v, want.v)
        assert int(episodes) == int(want.episodes) > 0
        _equal(v, results[0][case][0])


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("name", WORLDS)
def test_mc_sharded_equals_the_unsharded_run(worlds, sem, level, q0, name, parity):
    """Parity mode: Q, V and the counts bit for bit (K10 once over the
    gathered (T, B) samples); scalable mode: the counts exactly, Q and V to
    rtol 1e-6 (the ranks' sums added in rank order)."""
    check = _equal if parity else _close
    want_q = tmc.mc_control(sem, level, 7, W.MC_ROUNDS, alpha=0.1, batch_size=W.B_MC, **W.MC_KW)
    want_v = tmc.mc_prediction(sem, level, 7, batch_size=W.B_MC, **W.MC_KW)
    want_eps = tmc.mc_prediction(sem, level, 7, q0, batch_size=W.B_MC, first_visit=False, **W.MC_KW)
    results = worlds[name]
    for r in results:
        q, episodes = r[f"mc control {parity}"]
        check(q, want_q.q)
        assert int(episodes) == W.MC_ROUNDS * W.B_MC
        for key, want in ((f"mc prediction {parity}", want_v), (f"mc prediction eps {parity}", want_eps)):
            v, counts = r[key]
            check(v, want.value)
            _equal(counts, want.counts)
            assert float(counts.sum()) > 0
            _equal(v, results[0][key][0])
        _equal(q, results[0][f"mc control {parity}"][0])


def test_world_of_one_equals_the_unsharded_entries(sem, level, policy):
    """Without a process group every new entry is its unsharded learner, bit
    for bit, at any batch."""
    one = parallel.make_env_mesh(device=CPU)
    for algo, fn in (("sarsa", ta.sarsa_lambda), ("watkins", ta.watkins_q_lambda)):
        got = parallel.td_lambda_sharded(one, sem, level, 2, 20, 300, algo=algo, **W.TDL_KW)
        want = fn(sem, level, 2, 20, 300, **W.TDL_KW)
        _equal(got.q, want.q)
        _equal(got.episodes, want.episodes)
        _equal(got.mean_return, want.mean_return)
    for parity in (False, True):
        got = parallel.td_lambda_prediction_sharded(one, sem, level, policy, 2, 20, 300, parity=parity)
        _equal(got.v, ta.td_lambda_prediction(sem, level, policy, 2, 20, 300).v)
        got = parallel.mc_control_sharded(one, sem, level, 4, 2, batch_size=20, max_steps=25, parity=parity)
        _equal(got.q, tmc.mc_control(sem, level, 4, 2, batch_size=20, max_steps=25).q)
        got = parallel.mc_prediction_sharded(one, sem, level, 4, batch_size=20, max_steps=25, parity=parity)
        want = tmc.mc_prediction(sem, level, 4, batch_size=20, max_steps=25)
        _equal(got.value, want.value)
        _equal(got.counts, want.counts)


# -- (ii) against the reference's sharded functions -------------------------------


@pytest.mark.parametrize("name", WORLDS)
def test_td_lambda_sharded_matches_jax_sharded(worlds, name):
    """The reference's per-shard draws injected: Q to rtol 1e-6 (XLA's
    `einsum` sums the env axis in its own order), the episodes equal."""
    kw = W.TDL_KW
    jres = jplearn.td_lambda_sharded(
        _jmesh(name), JSEM, _jlevel(), jax.random.PRNGKey(TDL_KEY), W.T_TDL, W.B_TDL_SMALL, kw["alpha"],
        kw["gamma"], kw["epsilon"], kw["lam"], algo="sarsa",
    )
    for r in worlds[name]:
        q, episodes, mean_return = r["tdl jax"]
        _close(q, jres.q)
        assert int(episodes) == int(jres.episodes) > 0
        _close(mean_return, float(jres.mean_return))


@pytest.mark.parametrize("name", WORLDS)
def test_td_lambda_prediction_sharded_matches_jax_sharded(worlds, policy, name):
    jres = jplearn.td_lambda_prediction_sharded(
        _jmesh(name), JSEM, _jlevel(), jnp.asarray(policy.numpy()), jax.random.PRNGKey(PRED_KEY), W.T_TDL,
        W.B_TDL_SMALL, parity=True, **W.PRED_KW,
    )
    for r in worlds[name]:
        v, episodes = r["pred jax"]
        _close(v, jres.v, rtol=1e-5)
        assert int(episodes) == int(jres.episodes) > 0


@pytest.mark.parametrize("name", WORLDS)
def test_mc_sharded_matches_jax_sharded(worlds, name):
    """Parity mode with the reference's draws: the counts equal, Q and V to
    rtol 1e-6 (XLA may fuse r + γ·g)."""
    kw = dict(W.MC_KW)
    max_steps = kw.pop("max_steps")
    jq = jplearn.mc_control_sharded(_jmesh(name), JSEM, _jlevel(), jax.random.PRNGKey(MC_KEY), W.MC_ROUNDS,
                                    alpha=0.1, batch_size=W.B_MC, max_steps=max_steps, parity=True, **kw)
    jv = jplearn.mc_prediction_sharded(_jmesh(name), JSEM, _jlevel(), jax.random.PRNGKey(MC_KEY),
                                       batch_size=W.B_MC, max_steps=max_steps, parity=True, **kw)
    for r in worlds[name]:
        q, episodes = r["mc control jax"]
        _close(q, jq.q)
        assert int(episodes) == int(jq.episodes)
        v, counts = r["mc prediction jax"]
        _close(v, jv.value)
        _equal(counts, torch.as_tensor(np.array(jv.counts)))


# -- (iv) the reference's errors ------------------------------------------------------


def _mesh_of(n):
    """A mesh of `n` shards seen from rank 0, to reach the checks that come
    before any collective."""
    return EnvMesh(("env",), (n,), 0, n, CPU, None)


def _error_cases(sem, level, policy):
    two, three = _mesh_of(2), _mesh_of(3)
    batched = T.Level(grid=level.grid.expand(4, -1, -1).contiguous(), start_idx=level.start_idx.expand(4).contiguous())
    return {
        "tdl algo": (lambda: parallel.td_lambda_sharded(two, sem, level, 0, 2, 8, algo="q_learning"), "q_learning"),
        "tdl trace": (lambda: parallel.td_lambda_sharded(two, sem, level, 0, 2, 8, trace="dutch"),
                      "unknown trace kind"),
        "tdl batch": (lambda: parallel.td_lambda_sharded(three, sem, level, 0, 2, 8), "not divisible by mesh size"),
        "pred trace": (lambda: parallel.td_lambda_prediction_sharded(two, sem, level, policy, 0, 2, 8, trace="x"),
                       "unknown trace kind"),
        "pred batch": (lambda: parallel.td_lambda_prediction_sharded(three, sem, level, policy, 0, 2, 8),
                       "not divisible by mesh size"),
        "mc control level": (lambda: parallel.mc_control_sharded(two, sem, batched, 0, batch_size=4),
                             "mc_control_sharded requires a single shared"),
        "mc control batch": (lambda: parallel.mc_control_sharded(three, sem, level, 0, batch_size=8),
                             "not divisible by mesh size"),
        "mc prediction level": (lambda: parallel.mc_prediction_sharded(two, sem, batched, 0, batch_size=4),
                                "mc_prediction_sharded requires a single shared"),
        "mc prediction batch": (lambda: parallel.mc_prediction_sharded(three, sem, level, 0, batch_size=8),
                                "not divisible by mesh size"),
    }


@pytest.mark.parametrize("case", ["tdl algo", "tdl trace", "tdl batch", "pred trace", "pred batch",
                                  "mc control level", "mc control batch", "mc prediction level",
                                  "mc prediction batch"])
def test_the_reference_errors(sem, level, policy, case):
    fn, match = _error_cases(sem, level, policy)[case]
    with pytest.raises(ValueError, match=match):
        fn()


# -- (v) K12's partial-sums form, its plain versions --------------------------------


@pytest.mark.parametrize("b,shape", [(1, (16, 4)), (300, (16, 4)), (513, (81,)), (256, (9, 9))])
def test_chunk_partials_add_up_to_live_sums(b, shape):
    """The chunks' partial sums, added in order from 0.0, are `_live_sums`
    bit for bit, and the counts its counts; against the reference's
    `einsum` (which adds in its own order) to 2e-6 of each cell's Σ |δ·e|."""
    rng = np.random.default_rng(b)
    e = torch.as_tensor((rng.random((b, *shape)) * (rng.random((b, *shape)) < 0.3)).astype(np.float32))
    delta = torch.as_tensor(rng.standard_normal(b).astype(np.float32))
    part, count = ttl.chunk_partials_reference(delta, e)
    assert part.shape == (-(-b // k12.CHUNK), int(np.prod(shape))) and count.dtype == torch.int32
    num, cnt = ttl._live_sums(delta, e)
    total = torch.zeros_like(part[0])
    for row in part:
        total = total + row
    _equal(total.reshape(shape), num)
    _equal(count.to(torch.float32).reshape(shape), cnt)
    eq = "b,bs->s" if len(shape) == 1 else "b,bsa->sa"
    want = np.asarray(jnp.einsum(eq, jnp.asarray(delta.numpy()), jnp.asarray(e.numpy())))
    scale = np.einsum(eq, np.abs(delta.numpy()).astype(np.float64), e.numpy().astype(np.float64))
    assert np.all(np.abs(num.numpy() - want) <= 2e-6 * scale + 1e-30)
    _equal(cnt, torch.as_tensor(np.array(jnp.sum(jnp.asarray(e.numpy()) != 0.0, axis=0)), dtype=torch.float32))


@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_partials_then_apply_is_the_trace_pass(kind, ranks):
    """The form's two plain steps over `ranks` ranks' rows, the partials
    gathered in rank order: with one rank (two chunks), or whole chunks a
    rank, the table and the trace of `trace_pass_reference` bit for bit."""
    rng = np.random.default_rng(ranks)
    b = 256 if ranks > 1 else 300
    shape = (ranks * b, 16, 4)
    e = torch.as_tensor((rng.random(shape) * (rng.random(shape) < 0.3)).astype(np.float32))
    s = torch.as_tensor(rng.integers(0, 16, ranks * b).astype(np.int32))
    a = torch.as_tensor(rng.integers(0, 4, ranks * b).astype(np.int32))
    delta = torch.as_tensor(rng.standard_normal(ranks * b).astype(np.float32))
    cut = torch.as_tensor(rng.random(ranks * b) < 0.2)
    table = torch.as_tensor(rng.standard_normal((16, 4)).astype(np.float32))
    e_p, e_w = e.clone(), e.clone()
    parts, counts = zip(*(ttl.trace_partials_reference(e_p[r * b:(r + 1) * b], s[r * b:(r + 1) * b],
                                                        a[r * b:(r + 1) * b], delta[r * b:(r + 1) * b],
                                                        cut[r * b:(r + 1) * b], 0.9, 0.8, 1e-4, kind)
                          for r in range(ranks)))
    got = ttl.apply_partials_reference(table, torch.cat(parts), sum(c.to(torch.int64) for c in counts), 0.3)
    want = ttl.trace_pass_reference(table, e_w, s, a, delta, cut, 0.9, 0.8, 1e-4, 0.3, kind)
    _equal(e_p, e_w)
    _equal(got, want)


def test_the_partial_sums_form_refuses_cpu_tensors():
    """K12's partial-sums form launches or raises: the learners take its
    plain versions by where their tensors lie."""
    with pytest.raises(ValueError, match="CUDA"):
        k12.TracePartialsPlan(torch.zeros((16, 4)), 8, True)
    assert tplearn._ShardedTraceStep(parallel.make_env_mesh(device=CPU), torch.zeros((16, 4)), 8, True).plan is None
