"""The off-policy slice end to end on the CPU: backtracker mazes from the
port's generator (K11's plain version) → DQN with the per-env-level conv
Q-network and prioritized replay (K8a's and K8b's plain versions) → greedy
evaluation of the Q-network; the gather probe; and what holds the slice
together (every kernel has a source, a count and a plain version; the port
imports no JAX).

The same mazes, parameters and draws go through the JAX trainer: after
twelve steps in float32 the env state, the whole replay buffer and the
episode counts are equal, parameters and priorities agree to atol 2e-5
(twelve steps of sums in another order), and the greedy evaluation of one
parameter set gives the same per-env mask.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.levels import maze as tmz
from griduniverse_tpu_torch.models import dqn as tdqn
from griduniverse_tpu_torch.tools import gather_probe
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)
PORT = Path(T.__file__).resolve().parent


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def mazes():
    n, cells = 16, (2, 3)
    grids, start = tmz.generate_mazes_device(2026, cells, n, "backtracker", device=CPU)
    return T.Level(grid=grids, start_idx=start.expand(n).contiguous())


def jax_run_draws(base_key, t0, steps, cfg, batch):
    """Stacked draws of JAX steps t0 .. t0 + steps − 1 (prioritized)."""
    rows = []
    for t in range(t0, t0 + steps):
        key_eps, key_a, key_mb = jax.random.split(jax.random.fold_in(base_key, t), 3)
        frac = jnp.clip(jnp.int32(t) / cfg.eps_anneal_steps, 0.0, 1.0)
        eps = cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)
        rows.append((jax.random.uniform(key_eps, (batch,)) < eps,
                     jax.random.randint(key_a, (batch,), 0, 4, jnp.int32),
                     jax.random.gumbel(key_mb, (cfg.buffer_capacity,))))
    return tuple(_t(np.stack([np.asarray(r[k]) for r in rows])) for k in range(3))


def test_dqn_over_backtracker_mazes_matches_jax(mazes):
    n = mazes.grid.shape[0]
    jlevels = JLevel(grid=jnp.asarray(mazes.grid.numpy()), start_idx=jnp.asarray(mazes.start_idx.numpy()))
    kw = dict(lr=2e-3, buffer_capacity=64, batch_size_train=8, eps_anneal_steps=10, learn_start=16,
              hidden=(16,), max_episode_steps=10, compute_dtype="float32", obs="grid", conv_channels=(8,),
              prioritized=True, per_beta_anneal_steps=8)
    jcfg, tcfg = jm.DQNConfig(**kw), tm.DQNConfig(**kw)
    jts = jm.dqn_init(JSEM, jlevels, jax.random.PRNGKey(4), jcfg, n)
    tnet = tm.make_q_network(mazes, 4, tcfg)
    tts = convert.to_dqn_train_state(tree_np(jts), tnet)
    draws = jax_run_draws(jts.key, 0, 12, jcfg, n)
    jts = jm.dqn_run(JSEM, jlevels, jts, jcfg, 12)
    tts = tm.dqn_run(TSEM, mazes, tts, tcfg, 12, draws=draws)
    for f in ("agent_idx", "agent_code", "t", "done"):
        np.testing.assert_array_equal(getattr(tts.env_state, f).numpy(), np.asarray(getattr(jts.env_state, f)))
    for name, tf, jf in zip(tdqn.ReplayBuffer._fields, tts.buf, jts.buf):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), name)
    assert int(tts.t) == int(jts.t) == 12 and int(tts.episodes) == int(jts.episodes) > 0
    np.testing.assert_allclose(tts.prio.numpy(), np.asarray(jts.prio), atol=2e-5)
    want = convert.to_network_state(tree_np(jts.params), tnet)
    for name in want:
        np.testing.assert_allclose(tts.params[name].numpy(), want[name].numpy(), atol=2e-5, rtol=1e-5, err_msg=name)
    # greedy evaluation of one parameter set: the same per-env mask
    jnet = jm.make_q_network(jlevels, 4, jcfg)
    jmask = jm.greedy_reached(JSEM, jnet, jts.params, jlevels, max_steps=12)
    tmask = tm.greedy_reached(TSEM, tnet, want, mazes, max_steps=12)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    rate = tm.greedy_success_rate(TSEM, tnet, want, mazes, max_steps=12)
    assert float(rate) == float(np.asarray(jmask).mean())


def test_dqn_learns_backtracker_mazes_and_vi_is_its_ceiling(mazes):
    """A short run on the slice's own mazes: finite, episodes end, and the
    tabular optimum (every maze solved) bounds the Q-network's rate."""
    cfg = tm.DQNConfig(buffer_capacity=512, batch_size_train=32, eps_anneal_steps=100, hidden=(32,),
                       max_episode_steps=24, obs="grid", conv_channels=(8,), prioritized=True)
    res = tm.dqn_train(TSEM, mazes, 0, cfg, num_steps=150)
    assert int(res.episodes) > 20 and np.isfinite(float(res.final_loss))
    net = tm.make_q_network(mazes, 4, cfg)
    rate = float(tm.greedy_success_rate(TSEM, net, res.params, mazes, max_steps=24))
    _, policy, _ = ta.value_iteration_batched_grid(TSEM, mazes)
    ceiling = float(tm.greedy_success_rate_tabular(TSEM, mazes, policy, max_steps=24))
    assert ceiling == 1.0 and 0.0 <= rate <= ceiling


def test_gather_probe_on_the_cpu():
    assert gather_probe.probe_gather_1d(device=CPU) == "OK"
    assert gather_probe.probe_take_along_axis(device=CPU) == "OK"
    table = torch.arange(10, dtype=torch.int32) * 3
    idx = torch.tensor([[9, 0], [4, 4]], dtype=torch.int32)
    assert gather_probe.gather_1d(table, idx).tolist() == [[27, 0], [12, 12]]
    rows = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    assert gather_probe.take_along_axis1(rows, torch.tensor([[2, 0], [1, 1]], dtype=torch.int32)).tolist() == [[3, 1], [5, 5]]
    with pytest.raises(AssertionError, match="differ"):
        gather_probe._held("x", table, table + 1)


def test_every_kernel_has_a_source_an_entry_point_and_a_count():
    """Nineteen kernels and the three sharded forms (K5's, K10's and K12's);
    on the CPU nothing is launched."""
    assert len(kernels.LAUNCHES) == 22
    for name in ("per_sample", "replay", "backtracker_mazes", "gather_1d", "take_along_axis1", "trace_pass",
                 "dqn_act", "mc_returns", "trace_partials"):
        assert name in kernels.LAUNCHES
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    sources = "".join((build.CSRC_DIR / s).read_text() for s in build.SOURCES)
    for entry in build._SIGNATURES:
        assert re.search(rf'extern "C" int {entry}\(', sources), entry
    for s in ("replay.cu", "backtracker.cu", "gather_probe.cu", "trace_pass.cu", "dqn_act.cu", "mc_returns.cu"):
        assert s in build.SOURCES and (build.CSRC_DIR / s).is_file()


def test_signatures_match_the_c_parameter_lists():
    """Each entry point's argtypes has one entry per C parameter."""
    sources = "".join((build.CSRC_DIR / s).read_text() for s in build.SOURCES)
    kinds = {"int": build._I, "float": build._F, "long": ctypes.c_longlong}  # "long long"
    for entry in build._SIGNATURES:
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', sources).group(1).split(",")
        want = [build._P if "*" in p else kinds[p.split()[0]] for p in params]
        assert build._SIGNATURES[entry] == want, entry


def test_the_port_imports_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|griduniverse_tpu)(\.|\s|$)", re.M)
    files = list(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 40
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches or raises; only the public functions pick the
    plain version, and only by where the tensors lie."""
    from griduniverse_tpu_torch.kernels import gather_probe as gp
    from griduniverse_tpu_torch.kernels import maze as km
    from griduniverse_tpu_torch.kernels import replay

    buf = tm.buffer_init(8, device=CPU)
    one = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        replay.replay_write_cuda(buf, None, one, buf, None)
    with pytest.raises(ValueError, match="CUDA"):
        replay.replay_gather_cuda(buf, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        replay.prio_refresh_cuda(torch.zeros(8), torch.zeros(2, dtype=torch.int32), torch.zeros(2), 1e-3, torch.ones(()))
    with pytest.raises(ValueError, match="CUDA"):
        replay.per_sample_cuda(torch.ones(8), torch.zeros(8), one, torch.ones(()), 2, 0.6)
    with pytest.raises(ValueError, match="CUDA"):
        km.backtracker_mazes_cuda((2, 2), 4, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        gp.gather_1d_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        gp.take_along_axis1_cuda(torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        kernels.on_cuda(torch.zeros(1), torch.device("cuda"))
