"""Port parity: griduniverse_tpu_torch.parallel (sharded runs on Gloo) against
the unsharded port and against the JAX package's sharded functions.

A module-scoped fixture spawns Gloo worlds on the CPU (2 ranks, 4 ranks, and
4 ranks laid out 2 hosts × 2), each rank a fresh process with its own
timeout (`tests/torch_parallel_worker.py`), running every ported entry once
at a small size. The tests then hold:

  (i)   the sharded results against the unsharded port, bit for bit: the
        rollouts' per-env state and integer statistics, the fast learner's
        Q and state, V / policy / iterations of every solver, the per-maze
        tables, `q_learning_sharded(parity=True)` against `td_run`;
  (ii)  the same entries against the reference's sharded functions on its
        8-device virtual CPU mesh at the same world size, with the same
        numpy-made inputs (JAX's draws injected where the port draws
        otherwise);
  (iii) Q and V the same bits on every rank;
  (iv)  the reference's errors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.core.model import build_model_table as jbuild_model_table
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu.parallel import bitplane as jpbit
from griduniverse_tpu.parallel import dp as jpdp
from griduniverse_tpu.parallel import learner as jplearn
from griduniverse_tpu.parallel import mesh as jmesh
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch import parallel
from griduniverse_tpu_torch.algos import dp_batched as tdb
from griduniverse_tpu_torch.algos import td as ttd
from griduniverse_tpu_torch.algos import td_batched as ttb
from griduniverse_tpu_torch.algos import td_fast as ttf
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.ops import rollout as tro
from griduniverse_tpu_torch.parallel.mesh import EnvMesh

from tests import torch_parallel_worker as W

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
WORLDS = {"2": (2, 1), "4": (4, 1), "2x2": (4, 2)}
TD_KEY, BATCHED_KEY = 5, 4


def _jax_td_draws(key, b, steps, epsilon):
    """The draws of the reference's `q_learning_sharded(parity=True)` (and of
    `td_init` + `td_run`): (explore (T, B), rand_a (T, B), explore0 (B,),
    rand_a0 (B,))."""
    key, _, k_a0 = jax.random.split(key, 3)

    def one(k):
        ku, ka = jax.random.split(k)
        return (jax.random.uniform(ku, (b,)) < epsilon,
                jax.random.randint(ka, (b,), 0, 4, dtype=jnp.int32))

    e0, r0 = one(k_a0)
    e, r = jax.vmap(lambda t: one(jax.random.fold_in(key, t)))(jnp.arange(steps, dtype=jnp.int32))
    return tuple(torch.as_tensor(np.array(x)) for x in (e, r, e0, r0))


def _jax_batched_draws(key, n, steps, epsilon):
    """The draws of the reference's `q_learning_batched_sharded(parity=True)`."""
    key, k_a0 = jax.random.split(key)

    def one(k):
        ku, ka = jax.random.split(k)
        return (jax.random.uniform(ku, (n,)) < epsilon,
                jax.random.randint(ka, (n,), 0, 4, dtype=jnp.int32))

    e0, r0 = one(k_a0)
    e, r = jax.vmap(lambda t: one(jax.random.fold_in(key, t)))(jnp.arange(steps, dtype=jnp.int32))
    return tuple(torch.as_tensor(np.array(x)) for x in (e, r, e0, r0))


@pytest.fixture(scope="module")
def extra():
    rng = np.random.default_rng(0)
    return dict(
        q0=torch.as_tensor((rng.integers(-8, 9, size=(256, 4)) / 2.0).astype(np.float32)),
        td_draws=_jax_td_draws(jax.random.PRNGKey(TD_KEY), W.B_TD, W.T_TD, W.TD_KW["epsilon"]),
        batched_draws=_jax_batched_draws(jax.random.PRNGKey(BATCHED_KEY), W.N_MAZES, W.T_BATCHED,
                                         W.BATCHED_KW["epsilon"]),
        stats_actions=torch.as_tensor(rng.integers(0, 4, size=(W.T_STATS, W.B_STATS)).astype(np.int32)),
    )


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, extra):
    """Every world's per-rank results, by world name."""
    return {name: W.run_world(world, hosts, tmp_path_factory.mktemp(f"world{name}"), extra)
            for name, (world, hosts) in WORLDS.items()}


@pytest.fixture(scope="module")
def inp():
    return W.make_inputs()


def _bits(x):
    x = x.detach().cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    assert torch.equal(_bits(a), _bits(b))


def _rows(results, get):
    """The ranks' rows of a sharded result, concatenated in rank order."""
    return torch.cat([get(r) for r in results])


# -- the mesh ---------------------------------------------------------------


@pytest.mark.parametrize("name", WORLDS)
def test_each_rank_sees_its_place_in_the_mesh(worlds, name):
    world, hosts = WORLDS[name]
    results = worlds[name]
    for rank, r in enumerate(results):
        assert (r["rank"], r["size"], r["backend"]) == (rank, world, "gloo")
        if hosts > 1:
            assert r["shape"] == (hosts, world // hosts) and r["axes"] == ("host", "env")
        else:
            assert r["shape"] == (world,) and r["axes"] == ("env",)


def test_world_of_one_needs_no_process_group():
    mesh = parallel.make_env_mesh(device=CPU)
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None, None)
    x = torch.arange(4)
    assert parallel.mesh.all_reduce_sum(mesh, x) is x and parallel.mesh.all_gather_rows(mesh, x) is x
    two = parallel.make_host_env_mesh(device=CPU)
    assert two.shape == (1, 1) and two.axis_names == ("host", "env")
    with pytest.raises(ValueError, match="process group has 1 rank"):
        parallel.make_env_mesh(2, device=CPU)


# -- (i) against the unsharded port, bit for bit ------------------------------


@pytest.mark.parametrize("kind", ["rollout", "rollout_mazes", "rollout_threefry"])
@pytest.mark.parametrize("name", WORLDS)
def test_rollout_matches_unsharded(worlds, inp, name, kind):
    bl = inp["bl_mazes"] if kind == "rollout_mazes" else inp["bl_walls"]
    b, steps = (W.N_MAZES, W.T_MAZES) if bl.batched else (W.B_ROLL, W.T_ROLL)
    rng = "threefry" if kind == "rollout_threefry" else "xorshift"
    state, stats = tbp.compile_rollout_random(inp["sem"], bl, b, steps, W.MAX_EP, rng)(11)
    results = worlds[name]
    for f in ("agent_idx", "agent_code", "t", "done"):
        _equal(_rows(results, lambda r: r[kind][0][f]), getattr(state, f))
    for r in results:
        got = r[kind][1]
        _equal(got["episodes"], stats["episodes"])
        _equal(got["mean_length"], stats["mean_length"])
        np.testing.assert_allclose(float(got["mean_return"]), float(stats["mean_return"]), rtol=1e-6)
    assert int(stats["episodes"]) > 0


@pytest.mark.parametrize("name", WORLDS)
def test_fast_learner_matches_unsharded(worlds, inp, name):
    sem, bl = inp["sem"], inp["bl_walls"]
    ref = ttf.compile_q_learning_fast(sem, bl, W.B_FAST, W.T_FAST, **W.FAST_KW)(13)
    ts = ttf.td_scan_fast(sem, bl, ttf.fast_td_init(sem, bl, 13, W.B_FAST), W.T_FAST,
                          W.FAST_KW["alpha"], W.FAST_KW["gamma"], W.FAST_KW["epsilon"], "q_learning",
                          W.FAST_KW["max_episode_steps"])
    results = worlds[name]
    for r in results:
        q, episodes, mean_return = r["fast"]
        _equal(q, ref.q)
        _equal(r["fast_state"]["q"], ref.q)
        _equal(episodes, ref.episodes)
        np.testing.assert_allclose(float(mean_return), float(ref.mean_return), rtol=1e-6)
    for f, want in (("agent_idx", ts.env_state.agent_idx), ("t", ts.env_state.t), ("rs", ts.rs),
                    ("n_eps_env", ts.n_eps_env), ("ret_sum_env", ts.ret_sum_env)):
        _equal(_rows(results, lambda r: r["fast_state"][f]), want)
    assert int(ref.episodes) > 0


def _solver_refs(inp):
    sem, kw = inp["sem"], W.DP_KW
    return {
        "vi_grid": lambda: ta.value_iteration_batched_grid(sem, inp["mazes"], **kw),
        "pi_grid": lambda: ta.policy_iteration_batched_grid(sem, inp["mazes"], **kw),
        "vi_tables": lambda: tdb.value_iteration_batched(inp["tables"], **kw),
        "pi_tables": lambda: tdb.policy_iteration_batched(inp["tables"], **kw),
        "vi_state_walls": lambda: ta.value_iteration(T.build_model_table(sem, inp["walls"]), **kw),
        "vi_state_lava": lambda: ta.value_iteration(T.build_model_table(sem, inp["lava"]), **kw),
        "pi_state_lava": lambda: ta.policy_iteration(T.build_model_table(sem, inp["lava"]), **kw),
    }


SOLVERS = ("vi_grid", "pi_grid", "vi_tables", "pi_tables", "vi_state_walls", "vi_state_lava", "pi_state_lava")


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("name", WORLDS)
def test_solver_matches_unsharded(worlds, inp, name, solver):
    v, policy, iters = _solver_refs(inp)[solver]()
    for r in worlds[name]:
        got_v, got_policy, got_iters = r[solver]
        _equal(got_v, v)
        _equal(got_policy, policy)
        assert got_iters == iters > 1


@pytest.mark.parametrize("name", WORLDS)
def test_q_learning_sharded_parity_matches_td_run(worlds, inp, extra, name):
    sem, lava = inp["sem"], inp["lava"]
    ref = ta.q_learning(sem, lava, 7, W.T_TD, W.B_TD, **W.TD_KW)
    injected = ta.q_learning(sem, lava, 0, W.T_TD, W.B_TD, **W.TD_KW, draws=extra["td_draws"])
    for r in worlds[name]:
        for key, want in (("td_parity", ref), ("td_parity_jax", injected)):
            q, episodes, mean_return = r[key]
            _equal(q, want.q)
            _equal(episodes, want.episodes)
            np.testing.assert_allclose(float(mean_return), float(want.mean_return), rtol=1e-6)
    assert int(ref.episodes) > 0


@pytest.mark.parametrize("name", WORLDS)
def test_q_learning_sharded_scalable_and_windowed(worlds, inp, name):
    """The scalable mode adds each rank's env-order sums in rank order, so an
    update is within float rounding of `td_run`'s (one step; later steps may
    act on those last bits, so a long run is held to its outcome). The
    windowed mode's first window equals the port's own windowed run in a
    world of one to the same rounding. In a world of one the scalable mode
    is K10's sums form and apply, which is `td_run` bit for bit."""
    sem, lava = inp["sem"], inp["lava"]
    one = parallel.make_env_mesh(device=CPU)
    ref = ta.q_learning(sem, lava, 7, W.T_TD, W.B_TD, **W.TD_KW)
    _equal(parallel.q_learning_sharded(one, sem, lava, 7, W.T_TD, W.B_TD, **W.TD_KW).q, ref.q)
    step1 = ta.q_learning(sem, lava, 7, 1, W.B_TD, **W.TD_KW)
    window = parallel.q_learning_sharded(one, sem, lava, 7, W.PSUM_EVERY, W.B_TD, **W.TD_KW,
                                         psum_every=W.PSUM_EVERY)
    assert not torch.equal(window.q, ta.q_learning(sem, lava, 7, W.PSUM_EVERY, W.B_TD, **W.TD_KW).q)
    for r in worlds[name]:
        for key, want in (("td_scalable_1", step1), ("td_window_1", window)):
            q, episodes, _ = r[key]
            np.testing.assert_allclose(q.numpy(), want.q.numpy(), rtol=1e-6, atol=1e-7)
            _equal(episodes, want.episodes)
        for key in ("td_scalable", "td_window"):
            q, episodes, mean_return = r[key]
            assert bool(torch.isfinite(q).all()) and int(episodes) > 0 and float(mean_return) < 0
            assert float(q.abs().max()) > 0.1


@pytest.mark.parametrize("name", WORLDS)
def test_q_learning_batched_sharded_matches_unsharded(worlds, inp, extra, name):
    sem, lv = inp["sem"], inp["mazes"]
    ref = ttb.q_learning_batched(sem, lv, 9, W.T_BATCHED, **W.BATCHED_KW)
    injected = ttb.q_learning_batched(sem, lv, 0, W.T_BATCHED, **W.BATCHED_KW, draws=extra["batched_draws"])
    results = worlds[name]
    for key, want in (("batched", ref), ("batched_jax", injected)):
        for r in results:
            q, episodes, mean_return, _ = r[key]
            _equal(q, want.q)
            _equal(episodes, want.episodes)
            np.testing.assert_allclose(float(mean_return), float(want.mean_return), rtol=1e-6)
        _equal(_rows(results, lambda r: r[key][3]), want.state.env_state.agent_idx)
    assert int(ref.episodes) > 0


@pytest.mark.parametrize("name", WORLDS)
def test_generic_rollout_reset_and_data_feed(worlds, inp, extra, name):
    sem, walls = inp["sem"], inp["walls"]
    state, stats = tro.episode_stats(sem, walls, tro.reset_batch(walls, W.B_STATS), W.T_STATS, True, 32,
                                     actions=extra["stats_actions"])
    results = worlds[name]
    _equal(_rows(results, lambda r: r["stats"][0]), state.agent_idx)
    world = WORLDS[name][0]
    natives = [r["stats_native"] for r in results]
    for r in results:
        got = r["stats"][1]
        _equal(got["episodes"], stats["episodes"])
        _equal(got["mean_length"], stats["mean_length"])
        np.testing.assert_allclose(float(got["mean_return"]), float(stats["mean_return"]), rtol=1e-6)
        assert int(got["steps"]) == W.T_STATS * W.B_STATS
        # native draws: per-rank streams, the same statistics on every rank
        for k in ("episodes", "mean_return", "mean_length"):
            _equal(r["stats_native"][k], natives[0][k])
    _equal(_rows(results, lambda r: r["reset"]), tro.reset_batch(walls, W.B_STATS).agent_idx)
    _equal(_rows(results, lambda r: r["shard_env_state"]),
           tbp.reset_bits(inp["bl_mazes"], None).agent_code)
    whole = torch.arange(W.B_STATS * 3).reshape(W.B_STATS, 3)
    _equal(_rows(results, lambda r: r["global_array"][0]), whole)
    local = W.B_STATS // world
    for rank, r in enumerate(results):
        rows, fetched, index = r["global_array"]
        np.testing.assert_array_equal(fetched["x"], whole.numpy())
        assert int(fetched["n"]) == 5
        assert index == slice(rank * local, (rank + 1) * local)


# -- (iii) replicated values are the same bits on every rank -------------------


REPLICATED = {
    "fast": lambda r: r["fast"][0],
    "fast_one_step": lambda r: r["fast_one_step_q_learning"][0],
    "td_parity": lambda r: r["td_parity"][0],
    "td_scalable": lambda r: r["td_scalable"][0],
    "td_window": lambda r: r["td_window"][0],
    "td_scalable_1": lambda r: r["td_scalable_1"][0],
    "batched": lambda r: r["batched"][0],
    **{s: (lambda s: lambda r: r[s][0])(s) for s in SOLVERS},
}


@pytest.mark.parametrize("value", REPLICATED)
@pytest.mark.parametrize("name", WORLDS)
def test_replicated_values_are_the_same_bits_on_every_rank(worlds, name, value):
    results = worlds[name]
    first = REPLICATED[value](results[0])
    for r in results[1:]:
        _equal(REPLICATED[value](r), first)


# -- (ii) against the reference's sharded functions ----------------------------


def _jmesh(name):
    world, hosts = WORLDS[name]
    return jmesh.make_host_env_mesh(hosts, world // hosts) if hosts > 1 else jmesh.make_env_mesh(world)


def _jlevel(level):
    return JLevel(grid=jnp.asarray(level.grid.numpy()), start_idx=jnp.asarray(level.start_idx.numpy()))


@pytest.mark.parametrize("kind", ["rollout", "rollout_mazes"])
@pytest.mark.parametrize("name", WORLDS)
def test_rollout_matches_jax_sharded(worlds, inp, name, kind):
    level = inp["mazes"] if kind == "rollout_mazes" else inp["walls"]
    b, steps = (W.N_MAZES, W.T_MAZES) if level.batched else (W.B_ROLL, W.T_ROLL)
    fn = jpbit.compile_rollout_random_sharded(_jmesh(name), JSEM, jbp.pack_level(_jlevel(level)), b, steps,
                                              W.MAX_EP)
    jstate, jstats = fn(jnp.uint32(11))
    results = worlds[name]
    for f in ("agent_idx", "agent_code", "t"):
        got = _rows(results, lambda r: r[kind][0][f])
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jstate, f)))
    got = results[0][kind][1]
    assert int(got["episodes"]) == int(jstats["episodes"]) > 0
    np.testing.assert_allclose(float(got["mean_length"]), float(jstats["mean_length"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["mean_return"]), float(jstats["mean_return"]), rtol=1e-6)


@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
@pytest.mark.parametrize("name", WORLDS)
def test_fast_learner_one_step_matches_jax_sharded(worlds, inp, extra, name, algo):
    """Within `test_torch_td_fast.py::test_one_step_matches_jax`'s bound: the
    reference rounds each α·δ (and expected SARSA's target) to bfloat16."""
    kw = W.ONE_STEP_KW
    jbl = jbp.pack_level(jb.walls_and_goal_16x16())
    fn = jpbit.compile_q_learning_fast_sharded(_jmesh(name), JSEM, jbl, W.B_FAST, 1, algo=algo, **kw)
    jres = fn(jnp.uint32(17), jnp.asarray(extra["q0"].numpy()))
    alpha, gamma = kw["alpha"], kw["gamma"]
    atol = 2.0**-8 * alpha * (10.0 + (1.0 + gamma) * 8.0)
    if algo == "expected_sarsa":
        atol += alpha * gamma * 8.0 * 2.0**-8
    for r in worlds[name]:
        q, episodes = r[f"fast_one_step_{algo}"]
        dq = np.abs(q.numpy() - extra["q0"].numpy())
        assert dq.max() > 0.1
        np.testing.assert_allclose(q.numpy(), np.asarray(jres.q), atol=atol, rtol=0)
        assert int(episodes) == int(jres.episodes)


def _unique_argmax(q):
    """Where the largest entry of the last axis beats the next by > 1e-5."""
    top = torch.topk(q, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) > 1e-5


@pytest.mark.parametrize("solver", ["vi_grid", "pi_grid", "vi_state_walls", "vi_state_lava", "pi_state_lava"])
@pytest.mark.parametrize("name", WORLDS)
def test_solver_matches_jax_sharded(worlds, inp, name, solver):
    """V within atol 1e-4; the policy equal where the reference's argmax is
    unique (XLA fuses r + γ·v, the port rounds it twice)."""
    mesh, sem, kw = _jmesh(name), inp["sem"], W.DP_KW
    if solver.endswith("grid"):
        fn = jpdp.value_iteration_batched_grid_sharded if solver == "vi_grid" \
            else jpdp.policy_iteration_batched_grid_sharded
        jv, jpolicy, _ = fn(mesh, JSEM, _jlevel(inp["mazes"]), **kw)
        q = tdb._grid_backup(sem, inp["mazes"].grid, kw["gamma"])(torch.as_tensor(np.array(jv)))
    else:
        level = inp["walls"] if solver == "vi_state_walls" else inp["lava"]
        fn = jpdp.value_iteration_sharded if solver.startswith("vi") else jpdp.policy_iteration_sharded
        jv, jpolicy, _ = fn(mesh, jbuild_model_table(JSEM, _jlevel(level)), **kw)
        q = ta.action_values(T.build_model_table(sem, level), torch.as_tensor(np.array(jv)), kw["gamma"])
    unique = _unique_argmax(q)
    assert bool(unique.any())
    for r in worlds[name]:
        v, policy, _ = r[solver]
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(policy.numpy()[unique.numpy()], np.asarray(jpolicy)[unique.numpy()])


@pytest.mark.parametrize("name", WORLDS)
def test_q_learning_sharded_parity_matches_jax_sharded(worlds, name):
    kw = W.TD_KW
    jres = jplearn.q_learning_sharded(
        _jmesh(name), JSEM, jb.lava_level(), jax.random.PRNGKey(TD_KEY), W.T_TD, W.B_TD,
        kw["alpha"], kw["gamma"], kw["epsilon"], parity=True,
    )
    for r in worlds[name]:
        q, episodes, mean_return = r["td_parity_jax"]
        np.testing.assert_allclose(q.numpy(), np.asarray(jres.q), rtol=1e-6, atol=1e-6)
        assert int(episodes) == int(jres.episodes) > 0
        np.testing.assert_allclose(float(mean_return), float(jres.mean_return), rtol=1e-6)


@pytest.mark.parametrize("name", WORLDS)
@pytest.mark.parametrize("key", ["batched_jax", "batched_jax_pow2"])
def test_q_learning_batched_sharded_matches_jax_sharded(worlds, inp, name, key):
    """With the reference's draws injected: the tables equal where α and γ
    are powers of two (α·δ and γ·v exact, so XLA's fused multiply-add in the
    sharded program rounds as the port's two operations), else within rtol
    1e-6 (the chosen divergence of the TD tables); the episodes equal."""
    kw = W.BATCHED_POW2_KW if key.endswith("pow2") else W.BATCHED_KW
    jres = jplearn.q_learning_batched_sharded(
        _jmesh(name), JSEM, _jlevel(inp["mazes"]), jax.random.PRNGKey(BATCHED_KEY), W.T_BATCHED,
        parity=True, **kw,
    )
    for r in worlds[name]:
        q, episodes, _, _ = r[key]
        if key.endswith("pow2"):
            np.testing.assert_array_equal(q.numpy(), np.asarray(jres.q))
        else:
            np.testing.assert_allclose(q.numpy(), np.asarray(jres.q), rtol=1e-6, atol=1e-6)
        assert int(episodes) == int(jres.episodes) > 0


# -- (iv) the reference's errors -----------------------------------------------


def _mesh_of(n):
    """A mesh of `n` shards seen from rank 0, to reach the checks that come
    before any collective."""
    return EnvMesh(("env",), (n,), 0, n, CPU, None)


def _error_cases(inp):
    sem, walls, lava, lv = inp["sem"], inp["walls"], inp["lava"], inp["mazes"]
    three = _mesh_of(3)
    return {
        "rollout batch": (lambda: parallel.compile_rollout_random_sharded(three, sem, inp["bl_walls"], 32, 10),
                          "not divisible by mesh size"),
        "fast batch": (lambda: parallel.compile_q_learning_fast_sharded(three, sem, inp["bl_walls"], 32, 10),
                       "not divisible by mesh size"),
        "fast algo": (lambda: parallel.compile_q_learning_fast_sharded(_mesh_of(2), sem, inp["bl_walls"], 32, 10,
                                                                       algo="dyna"), "unknown algo"),
        "td batch": (lambda: parallel.q_learning_sharded(three, sem, lava, 0, 10, 32), "not divisible"),
        "stats batch": (lambda: parallel.episode_stats_sharded(three, sem, walls, 0, 32, 10), "not divisible"),
        "mazes count": (lambda: parallel.value_iteration_batched_grid_sharded(three, sem, lv), "maze count"),
        "batched count": (lambda: parallel.q_learning_batched_sharded(three, sem, lv, 0, 10), "maze count"),
        "batched level": (lambda: parallel.compile_rollout_random_sharded(_mesh_of(2), sem, inp["bl_mazes"], 32, 10),
                          "batched BitLevel has 16 levels; expected batch_size=32"),
        "shared grid": (lambda: parallel.q_learning_batched_sharded(_mesh_of(2), sem, walls, 0, 10),
                        "batched"),
        "psum_every 0": (lambda: parallel.q_learning_sharded(_mesh_of(2), sem, lava, 0, 10, 32, psum_every=0),
                         "psum_every must be >= 1"),
        "psum_every parity": (lambda: parallel.q_learning_sharded(_mesh_of(2), sem, lava, 0, 10, 32, parity=True,
                                                                  psum_every=2), "parity mode"),
        "psum_every steps": (lambda: parallel.q_learning_sharded(_mesh_of(2), sem, lava, 0, 10, 32, psum_every=3),
                             "must be divisible by psum_every"),
        "host layout": (lambda: parallel.make_host_env_mesh(2, 2, device=CPU), "!= world size 1"),
    }


@pytest.mark.parametrize("case", [
    "rollout batch", "fast batch", "fast algo", "td batch", "stats batch", "mazes count", "batched count",
    "batched level", "shared grid", "psum_every 0", "psum_every parity", "psum_every steps", "host layout",
])
def test_the_reference_errors(inp, case):
    fn, match = _error_cases(inp)[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_world_of_one_equals_the_unsharded_entries(inp):
    """Without a process group every sharded entry is its unsharded one."""
    sem, one = inp["sem"], parallel.make_env_mesh(device=CPU)
    got = parallel.compile_q_learning_fast_sharded(one, sem, inp["bl_walls"], 32, 40, algo="expected_sarsa")(3)
    want = ttf.compile_q_learning_fast(sem, inp["bl_walls"], 32, 40, algo="expected_sarsa")(3)
    _equal(got.q, want.q)
    res = parallel.q_learning_sharded(one, sem, inp["lava"], 2, 30, 8, algo="sarsa", parity=True)
    _equal(res.q, ttd.sarsa(sem, inp["lava"], 2, 30, 8).q)


def test_the_new_forms_refuse_cpu_tensors(inp):
    """K5's sharded form and K10's sums form launch or raise: only the
    public functions take the plain versions, by where the tensors lie."""
    from griduniverse_tpu_torch.kernels import segment_mean as k10
    from griduniverse_tpu_torch.kernels import td_fast as k5

    sem, bl = inp["sem"], inp["bl_walls"]
    ts = ttf.fast_td_init(sem, bl, 0, 4)
    agg = torch.zeros((2, ts.q.numel()), dtype=torch.int64)
    state = [ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs, ts.run_ret, ts.n_eps_env,
             ts.ret_sum_env]
    with pytest.raises(ValueError, match="CUDA"):
        k5.td_step_sharded_cuda(sem, bl, ts.q, ts.q.clone(), None, agg, None, state, 0.1, 0.9, 0.1, 0, None)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k10.segment_sums_cuda(s, s, torch.zeros(4), 0.1, 256, 4)
