"""Port parity: the sharded neural trainers of griduniverse_tpu_torch.models
(A2C, PPO, DQN data-parallel over Gloo worlds on the CPU) against the
unsharded port and against the JAX package's sharded trainers, and their
resume drills.

A module-scoped fixture spawns Gloo worlds on the CPU (2 ranks, 4 ranks, and
4 ranks laid out 2 hosts × 2), each rank a fresh process with its own
timeout (`tests/torch_parallel_worker.py` `run_model_entries`), and then a
world of 2 that resumes the 4-rank world's PPO and DQN states through
`reshard_stats`. The tests hold:

  (i)   one update of a world against the unsharded update with the same
        noise, to atol 1e-5 (a world of one without a process group, bit
        for bit, in this process);
  (ii)  each trainer against the reference's sharded trainer on its
        8-device CPU mesh at the same world size, from its parameters and
        with its per-shard draws injected;
  (iii) parameters, target and Adam state the same bits on every rank;
  (iv)  the reference's errors;
  and the resume drills: a chunked run through a checkpoint on every rank
  equal to the unbroken run (A2C, PPO, DQN), a SIGKILL of a rank after a
  checkpoint and a restarted world equal to the unbroken run (PPO, DQN),
  and the elastic resume from 4 ranks to 2 (`reshard_stats`). Last, the
  port's `parallel.learner` and `models` cover the reference's public names.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.parallel import learner as jplearn
from griduniverse_tpu.parallel import mesh as jmesh
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch import parallel
from griduniverse_tpu_torch.models import a2c as ta2c
from griduniverse_tpu_torch.parallel import learner as tplearn
from griduniverse_tpu_torch.parallel.mesh import EnvMesh
from griduniverse_tpu_torch.utils import convert

from tests import torch_parallel_worker as W

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
JSEM = J.make_semantics()
WORLDS = {"2": (2, 1), "4": (4, 1), "2x2": (4, 2)}
JAX_KEY = 21
DRILL_TIMEOUT_S = 180


def _t(x):
    return torch.as_tensor(np.array(x))


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(name):
    world, hosts = WORLDS[name]
    return jmesh.make_host_env_mesh(hosts, world // hosts) if hosts > 1 else jmesh.make_env_mesh(world)


def _jcfg(cfg):
    """The reference's config of the same fields."""
    kind = {tm.A2CConfig: jm.A2CConfig, tm.PPOConfig: jm.PPOConfig, tm.DQNConfig: jm.DQNConfig}[type(cfg)]
    return kind(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _jlevel():
    return jb.make_level_from_indices((4, 4), start_idx=0, goals=[15])


def _tnet(cfg):
    make = tm.make_q_network if isinstance(cfg, tm.DQNConfig) else tm.make_network
    return make(W.model_level(), 4, cfg)


# -- the reference's sharded runs and their per-shard draws ----------------------


def _a2c_gumbel(base_key, update, cfg, b):
    key_roll, _ = jax.random.split(jax.random.fold_in(base_key, update))
    return jnp.stack([jax.random.gumbel(k, (b, 4)) for k in jax.random.split(key_roll, cfg.rollout_len)])


def _ppo_draws(base_key, update, cfg, b):
    key_roll, key_perm = jax.random.split(jax.random.fold_in(base_key, update))
    gumbel = jax.random.gumbel(key_roll, (cfg.rollout_len, b, 4))
    offsets = [jax.random.randint(k, (), 0, b) for k in jax.random.split(key_perm, cfg.num_epochs)]
    return gumbel, offsets


def _dqn_draws(base_key, t, cfg, b):
    key_eps, key_a, key_mb = jax.random.split(jax.random.fold_in(base_key, t), 3)
    frac = jnp.clip(jnp.int32(t) / cfg.eps_anneal_steps, 0.0, 1.0)
    eps = cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)
    explore = jax.random.uniform(key_eps, (b,)) < eps
    rand_a = jax.random.randint(key_a, (b,), 0, 4, jnp.int32)
    if cfg.prioritized:
        sample = jax.random.gumbel(key_mb, (cfg.buffer_capacity,))
    else:
        sample = jax.random.randint(key_mb, (cfg.batch_size_train,), 0, max(min((t + 1) * b, cfg.buffer_capacity), 1))
    return explore, rand_a, sample


def _reference_runs(name):
    """The reference's sharded A2C, PPO and DQN runs on this world's mesh, and
    what the ranks need to repeat them: the initial parameters and every
    shard's draws, laid out globally."""
    world = WORLDS[name][0]
    mesh, level, lb = _jmesh(name), _jlevel(), W.B_NN // world
    key = jax.random.PRNGKey(JAX_KEY)
    out, refs = {}, {}
    cfg = _jcfg(W.A2C_CFG)
    jts = jm.a2c_init_sharded(mesh, JSEM, level, key, cfg, W.B_NN)
    out["a2c_params"] = convert.to_network_state(tree_np(jts.params), _tnet(W.A2C_CFG))
    out["a2c_gumbel"] = _t(jnp.stack([jnp.concatenate(
        [_a2c_gumbel(jax.random.fold_in(jts.key, k), u, cfg, lb) for k in range(world)], axis=1)
        for u in range(W.NN_UPDATES)]))
    refs["a2c jax"] = jm.a2c_run_sharded(mesh, JSEM, level, jts, cfg, W.NN_UPDATES)

    cfg = _jcfg(W.PPO_CFG)
    jts = jm.ppo_init_sharded(mesh, JSEM, level, key, cfg, W.B_NN)
    out["ppo_params"] = convert.to_network_state(tree_np(jts.params), _tnet(W.PPO_CFG))
    draws = [[_ppo_draws(jax.random.fold_in(jts.key, k), u, cfg, lb) for k in range(world)]
             for u in range(W.NN_UPDATES)]
    out["ppo_gumbel"] = _t(jnp.stack([jnp.concatenate([d[0] for d in du], axis=1) for du in draws]))
    # (U, E, shards): every epoch's offset of each shard
    out["ppo_shuffle"] = _t(jnp.stack([jnp.stack([jnp.stack([d[1][e] for d in du]) for e in range(cfg.num_epochs)])
                                       for du in draws]))
    refs["ppo jax"] = jm.ppo_run_sharded(mesh, JSEM, level, jts, cfg, W.NN_UPDATES)

    for kind, tcfg in (("dqn jax", W.DQN_CFG), ("dqn per jax", W.DQN_PER_CFG)):
        cfg = _jcfg(tcfg)
        local = dataclasses.replace(cfg, buffer_capacity=cfg.buffer_capacity // world)
        jts = jm.dqn_init_sharded(mesh, JSEM, level, key, cfg, W.B_NN)
        out["dqn_params"] = convert.to_network_state(tree_np(jts.params), _tnet(tcfg))
        steps = [[_dqn_draws(jax.random.fold_in(jts.key, k), t, local, lb) for k in range(world)]
                 for t in range(W.NN_STEPS)]
        out[kind.replace(" ", "_") + "_draws"] = tuple(
            _t(jnp.stack([jnp.concatenate([d[i] for d in st]) for st in steps])) for i in range(3))
        refs[kind] = jm.dqn_run_sharded(mesh, JSEM, level, jts, cfg, W.NN_STEPS)
    return out, refs


def _one_update_inputs(world, rng):
    """numpy-made noise of one update, and one DQN step's draws: each rank's
    two slots among its first B/n transitions."""
    u = rng.random((1, W.A2C_CFG.rollout_len, W.B_NN, 4)).clip(1e-7, 1.0)
    gumbel = torch.as_tensor(-np.log(-np.log(u)).astype(np.float32))
    lb = W.B_NN // world
    idx = rng.integers(0, lb, size=(world, W.DQN_ONE_CFG.batch_size_train)).astype(np.int32)
    draws = (torch.as_tensor(rng.random((1, W.B_NN)) < 0.3),
             torch.as_tensor(rng.integers(0, 4, size=(1, W.B_NN)).astype(np.int32)),
             torch.as_tensor(idx.reshape(1, -1)))
    unsharded = draws[:2] + (torch.as_tensor((idx + lb * np.arange(world)[:, None]).reshape(1, -1)),)
    return gumbel, draws, unsharded


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Every world's per-rank results, the reference's runs, the one-update
    inputs, and the elastic world's results."""
    worlds, refs, ones = {}, {}, {}
    for name, (world, hosts) in WORLDS.items():
        out_dir = tmp_path_factory.mktemp(f"models{name}")
        extra, refs[name] = _reference_runs(name)
        gumbel, draws, unsharded = _one_update_inputs(world, np.random.default_rng(world + hosts))
        ones[name] = (gumbel, unsharded)
        extra.update(one_gumbel=gumbel, dqn_one_draws=draws, dir=str(out_dir))
        worlds[name] = W.run_world(world, hosts, out_dir, extra, "models")
        if name == "4":
            elastic_dir = out_dir
    elastic = W.run_world(2, 1, elastic_dir, {"dir": str(elastic_dir)}, "elastic")
    return dict(worlds=worlds, refs=refs, ones=ones, elastic=elastic, elastic_dir=elastic_dir)


@pytest.fixture(scope="module")
def sem():
    return T.make_semantics(device=CPU)


@pytest.fixture(scope="module")
def level():
    return W.model_level()


def _bits(x):
    x = torch.as_tensor(x).detach().cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    assert torch.equal(_bits(a), _bits(b))


def _params(leaves, prefix="params/"):
    return {k[len(prefix):]: v for k, v in leaves.items() if k.startswith(prefix)}


def _rows(results, key, field):
    return torch.cat([r[key][field] for r in results])


def _close_params(got, want, atol=1e-5):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol, rtol=1e-5, err_msg=name)


ENV_FIELDS = ("env_state/agent_idx", "env_state/agent_code", "env_state/t", "env_state/done")
REPLICATED = ("params/", "target_params/", "opt_state/", "t", "update", "seed", "last_loss")


# -- (i) one update against the unsharded update ------------------------------------


@pytest.mark.parametrize("kind", ["a2c", "ppo", "dqn"])
@pytest.mark.parametrize("name", WORLDS)
def test_one_update_agrees_with_the_unsharded_update(setup, sem, level, name, kind):
    """With the same noise (for DQN, each rank's minibatch slots as the
    unsharded ring's): the env rows equal, the parameters to atol 1e-5 (the
    mean of the ranks' mean gradients is the unsharded mean, up to
    rounding)."""
    gumbel, dqn_draws = setup["ones"][name]
    if kind == "a2c":
        want = tm.a2c_run(sem, level, tm.a2c_init(sem, level, 0, W.A2C_CFG, W.B_NN), W.A2C_CFG, 1, gumbel=gumbel)
    elif kind == "ppo":
        want = tm.ppo_run(sem, level, tm.ppo_init(sem, level, 0, W.PPO_ONE_CFG, W.B_NN), W.PPO_ONE_CFG, 1,
                          gumbel=gumbel)
    else:
        cfg = dataclasses.replace(W.DQN_ONE_CFG, batch_size_train=dqn_draws[2].shape[1])
        want = tm.dqn_run(sem, level, tm.dqn_init(sem, level, 0, cfg, W.B_NN), cfg, 1, draws=dqn_draws)
    results = setup["worlds"][name]
    for field in ENV_FIELDS:
        _equal(_rows(results, f"{kind} one", field), getattr(want.env_state, field.split("/")[1]))
    assert int(_rows(results, f"{kind} one", "episodes").sum()) == int(want.episodes)
    for r in results:
        _close_params(_params(r[f"{kind} one"]), want.params)
        if kind == "dqn":
            _close_params(_params(r[f"{kind} one"], "target_params/"), want.target_params)


@pytest.mark.parametrize("kind", ["a2c", "ppo", "dqn", "dqn per"])
def test_world_of_one_equals_the_unsharded_trainer(sem, level, kind):
    """Without a process group a sharded trainer given the same noise is the
    unsharded one bit for bit; natively it draws shard 0's stream,
    `shard_seed(seed, 0)`, which injected into the unsharded trainer gives
    its bits again."""
    one = parallel.make_env_mesh(device=CPU)
    gen = torch.Generator().manual_seed(7)
    if kind in ("a2c", "ppo"):
        cfg = W.A2C_CFG if kind == "a2c" else W.PPO_CFG
        init, run = (tm.a2c_init, tm.a2c_run) if kind == "a2c" else (tm.ppo_init, tm.ppo_run)
        init_s, run_s = (tm.a2c_init_sharded, tm.a2c_run_sharded) if kind == "a2c" else \
            (tm.ppo_init_sharded, tm.ppo_run_sharded)
        noise = ta2c.draw_gumbel(gen, (3, cfg.rollout_len, W.B_NN, 4), CPU)
        kw, kw_s = {}, {}
        if kind == "ppo":  # every epoch's roll offset: (n,) over the shards, () unsharded
            offsets = torch.randint(0, W.B_NN, (3, cfg.num_epochs, 1), generator=gen)
            kw_s, kw = dict(shuffle_draws=offsets), dict(shuffle_draws=offsets[..., 0])
        got = run_s(one, sem, level, init_s(one, sem, level, 4, cfg, W.B_NN), cfg, 3, gumbel=noise, **kw_s)
        want = run(sem, level, init(sem, level, 4, cfg, W.B_NN), cfg, 3, gumbel=noise, **kw)
        native = run_s(one, sem, level, init_s(one, sem, level, 4, cfg, W.B_NN), cfg, 3)
        again = run(sem, level, dataclasses.replace(init(sem, level, 4, cfg, W.B_NN), seed=ta2c.shard_seed(4, 0)),
                    cfg, 3)
    else:
        cfg = W.DQN_PER_CFG if kind == "dqn per" else W.DQN_CFG
        draws = (torch.rand((10, W.B_NN), generator=gen) < 0.3,
                 torch.randint(0, 4, (10, W.B_NN), generator=gen, dtype=torch.int32),
                 ta2c.draw_gumbel(gen, (10, 64), CPU) if cfg.prioritized
                 else torch.randint(0, 16, (10, 8), generator=gen, dtype=torch.int32))
        got = tm.dqn_run_sharded(one, sem, level, tm.dqn_init_sharded(one, sem, level, 4, cfg, W.B_NN), cfg, 10,
                                 draws=draws)
        want = tm.dqn_run(sem, level, tm.dqn_init(sem, level, 4, cfg, W.B_NN), cfg, 10, draws=draws)
        native = tm.dqn_run_sharded(one, sem, level, tm.dqn_init_sharded(one, sem, level, 4, cfg, W.B_NN), cfg, 10)
        again = tm.dqn_run(sem, level, dataclasses.replace(tm.dqn_init(sem, level, 4, cfg, W.B_NN),
                                                            seed=ta2c.shard_seed(4, 0)), cfg, 10)
        _equal(got.buf.obs, want.buf.obs)
        _equal(got.prio, want.prio)
        _equal(got.p_max.reshape(()), want.p_max)
    for a, b in ((got, want), (native, again)):
        for k in a.params:
            _equal(a.params[k], b.params[k])
            _equal(a.opt_state.mu[k], b.opt_state.mu[k])
        _equal(a.env_state.agent_idx, b.env_state.agent_idx)
        _equal(a.episodes.reshape(()), b.episodes)
        _equal(a.last_loss, b.last_loss)


# -- (ii) against the reference's sharded trainers ---------------------------------


@pytest.mark.parametrize("kind", ["a2c jax", "ppo jax", "dqn jax", "dqn per jax"])
@pytest.mark.parametrize("name", WORLDS)
def test_trainer_matches_jax_sharded(setup, name, kind):
    """From the reference's parameters with its per-shard draws: the env
    rows and the episodes equal, the parameters (and DQN's target and
    ring) to atol 1e-5."""
    jts = setup["refs"][name][kind]
    cfg = W.DQN_CFG if kind.startswith("dqn") else (W.A2C_CFG if kind.startswith("a2c") else W.PPO_CFG)
    want = convert.to_network_state(tree_np(jts.params), _tnet(cfg))
    results = setup["worlds"][name]
    for field in ENV_FIELDS:
        np.testing.assert_array_equal(_rows(results, kind, field).numpy(),
                                      np.asarray(getattr(jts.env_state, field.split("/")[1])), field)
    assert int(sum(int(r[kind]["episodes"].sum()) for r in results)) == int(np.sum(jts.episodes))
    np.testing.assert_allclose(_rows(results, kind, "ret_sum").numpy(), np.asarray(jts.ret_sum), rtol=1e-5)
    for r in results:
        _close_params(_params(r[kind]), want)
        np.testing.assert_allclose(float(r[kind]["last_loss"]), float(jts.last_loss), rtol=1e-4, atol=1e-6)
    if kind.startswith("dqn"):
        np.testing.assert_array_equal(_rows(results, kind, "buf/obs").numpy(), np.asarray(jts.buf.obs))
        np.testing.assert_array_equal(_rows(results, kind, "buf/action").numpy(), np.asarray(jts.buf.action))
        for r in results:
            _close_params(_params(r[kind], "target_params/"),
                          convert.to_network_state(tree_np(jts.target_params), _tnet(cfg)))
        if kind == "dqn per jax":
            np.testing.assert_allclose(_rows(results, kind, "prio").numpy(), np.asarray(jts.prio), atol=1e-5)
            np.testing.assert_allclose(_rows(results, kind, "p_max").numpy(), np.asarray(jts.p_max), atol=1e-5)


# -- (iii) the same bits on every rank ---------------------------------------------


@pytest.mark.parametrize("name", WORLDS)
def test_replicated_values_are_the_same_bits_on_every_rank(setup, name):
    results = setup["worlds"][name]
    keys = [k for k, v in results[0].items() if isinstance(v, dict)]
    assert len(keys) >= 7
    for key in keys:
        for path, value in results[0][key].items():
            if path.startswith(REPLICATED):
                for r in results[1:]:
                    if isinstance(value, torch.Tensor):
                        _equal(r[key][path], value)
                    else:
                        assert r[key][path] == value, (key, path)
    for key in ("ppo train", "dqn train"):
        params, episodes, mean_return, loss = results[0][key]
        assert int(episodes) > 0 and bool(torch.isfinite(mean_return)) and bool(torch.isfinite(loss))
        for r in results[1:]:
            for k in params:
                _equal(r[key][0][k], params[k])
            _equal(r[key][1], episodes)
            _equal(r[key][2], mean_return)


# -- the resume drills ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["a2c", "ppo", "dqn"])
@pytest.mark.parametrize("name", WORLDS)
def test_chunked_resume_through_disk_equals_the_unbroken_run(setup, name, kind):
    """run(2N) ≡ run(N) ∘ save ∘ restore ∘ run(N) on every rank, every
    leaf bit for bit (`utils/checkpoint.py`), the ring included."""
    for r in setup["worlds"][name]:
        whole, resumed = r[f"{kind} resume"]
        assert set(whole) == set(resumed)
        for path, value in whole.items():
            if isinstance(value, torch.Tensor):
                _equal(resumed[path], value)
            else:
                assert resumed[path] == value, path
        assert int(whole["update" if kind != "dqn" else "t"]) == 2 * (W.NN_STEPS if kind == "dqn" else W.NN_UPDATES)


def test_elastic_resume_from_four_ranks_to_two(setup):
    """The 4-rank PPO and DQN states, gathered whole, resume on 2 ranks
    through `reshard_stats`: the totals kept on shard 0, `p_max` the global
    maximum, the ring's contents kept as data; the counters go on, and the
    ranks agree to the bit."""
    elastic = setup["elastic"]
    for kind, moved_steps, steps, field in (("ppo", 4, 3, "update"), ("dqn", 8, 6, "t")):
        whole = torch.load(setup["elastic_dir"] / f"elastic_{kind}.pt", weights_only=False)
        assert whole.episodes.shape == (4,)
        for r in elastic:
            moved, after, gathered = r[kind]
            assert isinstance(moved.run_ret, np.ndarray) and moved.episodes.shape == (2,)
            assert int(moved.episodes[0]) == int(whole.episodes.sum()) and int(moved.episodes[1]) == 0
            np.testing.assert_array_equal(moved.ret_sum, [np.float32(whole.ret_sum.sum()), 0.0])
            assert np.shape(getattr(gathered, field)) == () and int(getattr(gathered, field)) == moved_steps + steps
            assert int(gathered.episodes.sum()) >= int(whole.episodes.sum())
            assert np.isfinite(float(gathered.last_loss))
            if kind == "dqn":
                assert moved.p_max.shape == (2,) and np.all(moved.p_max == whole.p_max.max())
                np.testing.assert_array_equal(moved.buf.obs, whole.buf.obs)
        for path, value in elastic[0][kind][1].items():
            if path.startswith(REPLICATED) and isinstance(value, torch.Tensor):
                _equal(elastic[1][kind][1][path], value)


def _drill(engine_dir: Path, port: int, crash_after: int | None):
    """A world of two drill ranks (`sharded_resume`), each a subprocess with
    a timeout; returns [(returncode, stderr)]."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GU_CRASH_AFTER_CHUNK", None)
    if crash_after is not None:
        env["GU_CRASH_AFTER_CHUNK"] = str(crash_after)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", "sharded_resume", str(rank), "2",
                               str(port), str(engine_dir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    out = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, err))
    return out


def test_sigkill_of_a_rank_then_a_restart_equals_the_unbroken_run(tmp_path):
    """PPO then DQN over two ranks, a checkpoint on every rank after each
    chunk: rank 1 SIGKILLs itself after chunk 1's checkpoint, rank 0's next
    collective fails; a restarted world on a fresh port resumes both from
    their checkpoints and ends on the unbroken world's bits."""
    unbroken, broken = tmp_path / "unbroken", tmp_path / "broken"
    codes = _drill(unbroken, W.free_port(), None)
    assert all(rc == 0 for rc, _ in codes), codes
    codes = _drill(broken, W.free_port(), 1)
    assert codes[1][0] == -signal.SIGKILL, codes
    assert codes[0][0] != 0, codes  # the survivor's collective raised
    for kind in ("ppo", "dqn"):
        assert not (broken / f"final_{kind}_rank0.pt").exists()
    codes = _drill(broken, W.free_port(), None)
    assert all(rc == 0 for rc, _ in codes), codes
    for kind in ("ppo", "dqn"):
        for rank in range(2):
            want = torch.load(unbroken / f"final_{kind}_rank{rank}.pt", weights_only=False)
            got = torch.load(broken / f"final_{kind}_rank{rank}.pt", weights_only=False)
            assert set(got) == set(want)
            for path, value in want.items():
                if isinstance(value, torch.Tensor):
                    _equal(got[path], value)
                else:
                    assert got[path] == value, path


# -- (iv) the reference's errors ----------------------------------------------------


def _mesh_of(n):
    return EnvMesh(("env",), (n,), 0, n, CPU, None)


def test_the_reference_errors(sem, level):
    three = _mesh_of(3)
    mazes = W.mazes(3, 8)
    cases = [
        (lambda: tm.a2c_init_sharded(three, sem, level, 0, W.A2C_CFG, 16), "not divisible by mesh size"),
        (lambda: tm.ppo_init_sharded(three, sem, level, 0, W.PPO_CFG, 16), "not divisible by mesh size"),
        (lambda: tm.dqn_init_sharded(_mesh_of(2), sem, level, 0, dataclasses.replace(W.DQN_CFG, buffer_capacity=63),
                                     16), "buffer_capacity 63 not divisible by mesh size 2"),
        (lambda: tm.a2c_init_sharded(_mesh_of(2), sem, mazes, 0, W.A2C_CFG, 16),
         "batched BitLevel has 8 levels; expected batch_size=16"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    one = parallel.make_env_mesh(device=CPU)
    ts = tm.dqn_run_sharded(one, sem, level, tm.dqn_init_sharded(one, sem, level, 0, W.DQN_CFG, 16), W.DQN_CFG, 3)
    with pytest.raises(ValueError, match="FULL replay"):
        tm.reshard_stats(tm.gather_train_state(one, ts), _mesh_of(2))
    with pytest.raises(ValueError, match="divisible"):
        tm.reshard_stats(tm.gather_train_state(one, ts), three)
    ppo = tm.gather_train_state(one, tm.ppo_init_sharded(one, sem, level, 0, W.PPO_CFG, 16))
    with pytest.raises(ValueError, match="divisible"):
        tm.reshard_stats(ppo, three)
    moved = tm.reshard_stats(ppo, _mesh_of(2))
    for leaf in (moved.run_ret, moved.episodes, moved.params["pi.weight"] if "pi.weight" in moved.params
                 else next(iter(moved.params.values())), moved.opt_state.count):
        assert isinstance(leaf, np.ndarray)


# -- the public names ---------------------------------------------------------------

# names of the reference's modules the port does not carry, each for a reason
# (ROADMAP "Chosen divergences"): JAX and its sharding objects, the
# reference's imports and private step picker
NOT_CARRIED = {
    "learner": {"jax", "jnp", "Mesh", "P", "partial", "env_spec", "_pick_step", "td_error_qlearning",
                "td_error_sarsa", "td_error_expected_sarsa", "env_axes", "NamedTuple"},
    "models": set(),
}


@pytest.mark.parametrize("module", ["learner", "models"])
def test_the_port_covers_the_reference_public_names(module):
    ref, port = (jplearn, tplearn) if module == "learner" else (jm, tm)
    wanted = {n for n in dir(ref) if not n.startswith("_")} - NOT_CARRIED[module]
    missing = wanted - set(dir(port))
    assert not missing, sorted(missing)
    assert NOT_CARRIED[module] <= {n for n in dir(ref)}
    for name in ("td_lambda_sharded", "mc_control_sharded", "mc_prediction_sharded", "td_lambda_prediction_sharded"):
        assert name in dir(parallel)
    for name in ("a2c_init_sharded", "a2c_run_sharded", "a2c_train_sharded", "ppo_init_sharded", "ppo_run_sharded",
                 "ppo_train_sharded", "dqn_init_sharded", "dqn_run_sharded", "dqn_train_sharded", "reshard_stats"):
        assert name in dir(tm)
    for name in ("_level_specs", "_sharded_env_specs"):
        assert callable(getattr(ta2c, name))
    assert callable(tm.dqn._dqn_sharded_layout)
