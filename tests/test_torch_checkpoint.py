"""Checkpoint / resume of the port (`griduniverse_tpu_torch.utils.checkpoint`),
the mirror of `tests/test_checkpoint.py`: resume must be BIT-EXACT, run(2N)
equal to run(N) ∘ save ∘ restore ∘ run(N), for the generic TD learner, PPO,
A2C and DQN (uniform and prioritized replay), with synchronous and with
background writes. Also the manager's bookkeeping, the checks of a restore
against its template, `MetricsLogger`, and one JAX train state carried
through the port's disk format.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import models as jm
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.algos.td import td_init, td_run
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.utils import checkpoint as ckpt
from griduniverse_tpu_torch.utils import convert
from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from griduniverse_tpu_torch.utils.metrics import MetricsLogger, debug_scalar

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEM = T.make_semantics(device=CPU)
_INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}


def small_level():
    return tb.make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device=CPU)


def corridor():
    return tb.make_level_from_indices((2, 6), start_idx=0, goals=[5], device=CPU)


def assert_states_bitequal(a, b):
    """Every leaf equal: tensors by their bits (dtype and shape included),
    scalars by value."""
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert list(fa) == list(fb)
    for path, x in fa.items():
        y = fb[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            if x.dtype in _INT_OF:
                x, y = x.view(_INT_OF[x.dtype]), y.view(_INT_OF[y.dtype])
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


TD_KW = dict(alpha=0.2, epsilon=0.2)


class TestChunkInvariance:
    def test_td_run_chunking_is_bitexact(self):
        level = small_level()
        ts0 = td_init(SEM, level, 0, 32, epsilon=0.2)
        full = td_run(SEM, level, ts0, 200, **TD_KW)
        resumed = td_run(SEM, level, td_run(SEM, level, ts0, 100, **TD_KW), 100, **TD_KW)
        assert_states_bitequal(full, resumed)
        assert full.step == 200


class TestRoundTrip:
    def test_save_restore_train_state(self, tmp_path):
        level = small_level()
        ts = td_run(SEM, level, td_init(SEM, level, 1, 32, epsilon=0.2), 50, **TD_KW)
        save_checkpoint(tmp_path / "ckpt", ts)
        restored = restore_checkpoint(tmp_path / "ckpt", td_init(SEM, level, 0, 32))
        assert_states_bitequal(ts, restored)
        assert restored.step == 50
        manifest = json.loads((tmp_path / "ckpt" / ckpt.MANIFEST).read_text())
        assert manifest["scalars"] == {"step": 50} and "q" in manifest["tensors"]

    def test_resume_through_disk_is_bitexact(self, tmp_path):
        level = small_level()
        ts0 = td_init(SEM, level, 2, 32, epsilon=0.2)
        full = td_run(SEM, level, ts0, 120, **TD_KW)
        save_checkpoint(tmp_path / "mid", td_run(SEM, level, ts0, 60, **TD_KW))
        restored = restore_checkpoint(tmp_path / "mid", ts0)
        assert_states_bitequal(full, td_run(SEM, level, restored, 60, **TD_KW))

    @pytest.mark.parametrize("learner", ["a2c", "ppo", "dqn"])
    def test_params_round_trip(self, tmp_path, learner):
        if learner == "a2c":
            res = tm.a2c_train(SEM, small_level(), 3, tm.A2CConfig(rollout_len=4, hidden=(32,), embed_dim=16), 3, 16)
        elif learner == "ppo":
            cfg = tm.PPOConfig(rollout_len=4, num_epochs=1, num_minibatches=2, hidden=(32,), embed_dim=16)
            res = tm.ppo_train(SEM, small_level(), 5, cfg, 2, 16)
        else:
            cfg = tm.DQNConfig(buffer_capacity=64, batch_size_train=16, hidden=(32,), embed_dim=16)
            res = tm.dqn_train(SEM, small_level(), 6, cfg, 4, 16)
        save_checkpoint(tmp_path / learner, res.params)
        back = restore_checkpoint(tmp_path / learner, {k: torch.zeros_like(v) for k, v in res.params.items()})
        assert_states_bitequal(res.params, back)

    def test_overwrite_is_atomic_and_leaves_no_temporaries(self, tmp_path):
        save_checkpoint(tmp_path / "c", {"a": torch.zeros(3)})
        save_checkpoint(tmp_path / "c", {"a": torch.ones(3)})
        assert sorted(p.name for p in tmp_path.iterdir()) == ["c"]
        assert torch.equal(restore_checkpoint(tmp_path / "c", {"a": torch.zeros(3)})["a"], torch.ones(3))

    @pytest.mark.parametrize("change", ["shape", "dtype", "path", "scalar"])
    def test_restore_raises_on_a_template_mismatch(self, tmp_path, change):
        state = {"w": torch.zeros((2, 3)), "n": 4, "nested": (torch.ones(2), {"b": torch.zeros((), dtype=torch.int64)})}
        save_checkpoint(tmp_path / "s", state)
        template = {
            "shape": {**state, "w": torch.zeros((3, 2))},
            "dtype": {**state, "w": torch.zeros((2, 3), dtype=torch.float64)},
            "path": {**state, "extra": torch.zeros(1)},
            "scalar": {**state, "n": 4.0},
        }[change]
        with pytest.raises(ValueError):
            restore_checkpoint(tmp_path / "s", template)
        assert_states_bitequal(restore_checkpoint(tmp_path / "s", state), state)

    def test_unsupported_leaf_raises(self, tmp_path):
        with pytest.raises(TypeError, match="cannot checkpoint"):
            save_checkpoint(tmp_path / "x", {"f": object()})


class TestManager:
    def test_keep_latest_k(self, tmp_path):
        level = small_level()
        ts = td_init(SEM, level, 4, 16)
        mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
        for step in (10, 20, 30):
            ts = td_run(SEM, level, ts, 10)
            mgr.save(step, ts)
        assert mgr.steps() == [20, 30]
        step, restored = mgr.restore_latest(td_init(SEM, level, 0, 16))
        assert step == 30
        assert_states_bitequal(ts, restored)

    def test_restore_empty_returns_template(self, tmp_path):
        mgr = CheckpointManager(tmp_path / "none")
        template = {"a": torch.zeros(3)}
        step, state = mgr.restore_latest(template)
        assert step == 0 and state is template

    def test_async_saves_do_not_perturb_resume(self, tmp_path):
        level = small_level()
        full = td_run(SEM, level, td_init(SEM, level, 4, 16), 30)
        ts = td_init(SEM, level, 4, 16)
        with CheckpointManager(tmp_path / "async", max_to_keep=2, async_=True) as mgr:
            for step in (10, 20, 30):
                ts = td_run(SEM, level, ts, 10)
                mgr.save(step, ts)  # returns before the write has finished
            # restore_latest must see the step-30 write still in flight
            step, restored = mgr.restore_latest(td_init(SEM, level, 0, 16))
        assert step == 30
        assert mgr.steps() == [20, 30]
        assert_states_bitequal(ts, restored)
        assert_states_bitequal(full, restored)

    def test_async_close_idempotent_and_falls_back_to_sync(self, tmp_path):
        level = small_level()
        ts = td_init(SEM, level, 4, 16)
        mgr = CheckpointManager(tmp_path / "closed", async_=True)
        mgr.save(5, ts)
        mgr.close()
        mgr.close()
        mgr.save(6, ts)  # the sync path after close still works
        assert mgr.steps() == [5, 6]

    def test_many_async_saves_in_a_row(self, tmp_path):
        """One write in flight at a time: each save joins the last, so every
        kept step holds its own state and pruning never races a write."""
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            t0 = time.monotonic()
            with CheckpointManager(tmp_path / "many", max_to_keep=3, async_=True) as mgr:
                for step in range(1, 13):
                    mgr.save(step, {"x": torch.full((4096,), float(step)), "step": step})
            assert time.monotonic() - t0 < 60
        finally:
            sys.setswitchinterval(interval)
        assert mgr.steps() == [10, 11, 12]
        for step in (10, 11, 12):
            back = restore_checkpoint(mgr._step_dir(step), {"x": torch.zeros(4096), "step": 0})
            assert back["step"] == step and bool((back["x"] == step).all())
        assert sorted(p.name for p in (tmp_path / "many").iterdir()) == [f"step_{s:012d}" for s in (10, 11, 12)]

    def test_async_write_error_surfaces_at_the_next_call(self, tmp_path):
        mgr = CheckpointManager(tmp_path / "err", async_=True)
        with mock.patch.object(ckpt, "_write", side_effect=OSError("disk full")):
            mgr.save(1, {"a": torch.zeros(2)})
            with pytest.raises(OSError, match="disk full"):
                mgr.wait()
        mgr.wait()  # raised once, then cleared
        assert mgr.steps() == []


class TestMetricsLogger:
    def test_history_and_jsonl(self, tmp_path):
        m = MetricsLogger(jsonl_path=tmp_path / "m.jsonl")
        m.log(1, {"loss": 0.5, "ret": torch.tensor(1.25)})
        m.log(2, {"loss": 0.25, "note": "warm-up"})
        assert m.series("loss") == [0.5, 0.25]
        assert m.latest()["step"] == 2 and m.latest()["note"] == "warm-up"
        rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
        assert rows[0]["ret"] == 1.25 and len(rows) == 2

    def test_debug_scalar_logs_the_value(self, caplog):
        with caplog.at_level(logging.INFO, logger="griduniverse_tpu_torch"):
            debug_scalar("eps", torch.tensor(0.5))
        assert "eps = 0.5" in caplog.text


# ---------------------------------------------------------------------------
# The trainers: run(N) → save → restore into a fresh template → run(N)
# ---------------------------------------------------------------------------

PPO_CFG = tm.PPOConfig(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16, num_epochs=1,
                       num_minibatches=2)
A2C_CFG = tm.A2CConfig(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16)
DQN_CFG = tm.DQNConfig(buffer_capacity=256, batch_size_train=32, learn_start=32, eps_anneal_steps=100,
                       hidden=(32,), embed_dim=16, max_episode_steps=16)


def _trainer(name):
    """(init(seed) -> state, run(state, n) -> state, n) of one learner."""
    level = corridor()
    if name == "td":
        return (lambda seed: td_init(SEM, level, seed, 16, epsilon=0.2),
                lambda ts, n: td_run(SEM, level, ts, n, **TD_KW), 40)
    if name == "ppo":
        return (lambda seed: tm.ppo_init(SEM, level, seed, PPO_CFG, 16),
                lambda ts, n: tm.ppo_run(SEM, level, ts, PPO_CFG, n), 3)
    if name == "a2c":
        return (lambda seed: tm.a2c_init(SEM, level, seed, A2C_CFG, 16),
                lambda ts, n: tm.a2c_run(SEM, level, ts, A2C_CFG, n), 4)
    cfg = DQN_CFG if name == "dqn" else dataclasses.replace(DQN_CFG, prioritized=True)
    return (lambda seed: tm.dqn_init(SEM, level, seed, cfg, 16),
            lambda ts, n: tm.dqn_run(SEM, level, ts, cfg, n), 50)


@pytest.mark.parametrize("async_", [False, True])
@pytest.mark.parametrize("name", ["td", "ppo", "a2c", "dqn", "dqn_per"])
def test_resume_through_disk_is_bitexact(tmp_path, name, async_):
    init, run, n = _trainer(name)
    ts0 = init(5)
    full = run(ts0, 2 * n)
    with CheckpointManager(tmp_path / name, async_=async_) as mgr:
        mgr.save(n, run(ts0, n))
        step, restored = mgr.restore_latest(init(0))  # a fresh template: another seed, step 0
    assert step == n
    resumed = run(restored, n)
    assert_states_bitequal(full, resumed)


def test_jax_dqn_state_through_the_port_disk_format(tmp_path):
    """A reference train state, converted, saved, restored and run, equals
    the same run without the disk."""
    kw = dict(buffer_capacity=128, batch_size_train=16, learn_start=32, eps_anneal_steps=20, hidden=(32,),
              embed_dim=8, max_episode_steps=12, compute_dtype="float32", prioritized=True)
    jlevel = jb.make_level_from_indices((2, 6), start_idx=0, goals=[5])
    tlevel = convert.to_level(jlevel, device=CPU)
    tcfg = tm.DQNConfig(**kw)
    jts = jm.dqn_run(J.make_semantics(), jlevel, jm.dqn_init(J.make_semantics(), jlevel, jax.random.PRNGKey(3),
                                                             jm.DQNConfig(**kw), 16), jm.DQNConfig(**kw), 5)
    tts = convert.to_dqn_train_state(jax.tree.map(np.asarray, jts), tm.make_q_network(tlevel, 4, tcfg), seed=9)
    save_checkpoint(tmp_path / "jax_dqn", tts)
    restored = restore_checkpoint(tmp_path / "jax_dqn", tm.dqn_init(SEM, tlevel, 0, tcfg, 16))
    assert_states_bitequal(tts, restored)
    assert restored.seed == 9 and int(restored.t) == 5
    assert_states_bitequal(tm.dqn_run(SEM, tlevel, tts, tcfg, 20), tm.dqn_run(SEM, tlevel, restored, tcfg, 20))
