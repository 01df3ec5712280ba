"""The captured trainers' step on the CPU: `utils/capture.py` and the
programs of `dqn_run`, `ppo_run` and `a2c_run`.

On the card each run is one step (DQN) or update (PPO, A2C) captured in a
CUDA graph and replayed; on the CPU the same body runs eagerly over the same
static buffers. Here, at 32 envs and a few steps:

  (a) the body over static buffers equals the eager loop (`_*_run_eager`,
      the plain version of the captured run, which the card's tests hold
      against it) bit for bit in every state field; the eager loop and the
      body are held against the JAX trainers by `test_torch_dqn.py` and
      `test_torch_a2c_ppo.py`, whose `*_run` calls now run the body;
  (b) the body reads nothing on the host: `Tensor.item`, `__bool__`,
      `__int__`, `__float__`, `tolist`, `numpy` and `cpu` raise while it runs;
  (c) after a step each state tensor is the buffer it was (`data_ptr`).

The cases run with their own draws and with injected ones. The capture
itself, the replays and the launch counts need the card
(`tests/test_torch_cuda.py -k capture`, `chip_smoke.py` phase 29).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import griduniverse_tpu_torch as T
from griduniverse_tpu_torch import models as tm
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.models import a2c as ta2c
from griduniverse_tpu_torch.models import dqn as tdqn
from griduniverse_tpu_torch.models import ppo as tppo
from griduniverse_tpu_torch.utils import capture

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEM = T.make_semantics(device=CPU)
B = 32
STEPS = 3

HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "numpy", "cpu")


def level():
    return tb.walls_and_goal_16x16(device=CPU)


def _dqn(prioritized):
    cfg = tm.DQNConfig(buffer_capacity=128, batch_size_train=16, learn_start=32, max_episode_steps=40,
                       prioritized=prioritized, eps_anneal_steps=4, compute_dtype="float32")
    lv = level()
    return cfg, lv, tm.dqn_init(SEM, lv, 3, cfg, B), tm.dqn_run, tdqn._dqn_run_eager


def _ppo():
    cfg = tm.PPOConfig(rollout_len=4, num_epochs=2, num_minibatches=2, max_episode_steps=30, target_kl=1e-4,
                       hidden=(16,), compute_dtype="float32")
    lv = level()
    return cfg, lv, tm.ppo_init(SEM, lv, 3, cfg, B), tm.ppo_run, tppo._ppo_run_eager


def _a2c():
    cfg = tm.A2CConfig(rollout_len=4, max_episode_steps=30, hidden=(16,), compute_dtype="float32")
    lv = level()
    return cfg, lv, tm.a2c_init(SEM, lv, 3, cfg, B), tm.a2c_run, ta2c._a2c_run_eager


CASES = {"dqn uniform": lambda: _dqn(False), "dqn per": lambda: _dqn(True), "ppo target_kl": _ppo, "a2c": _a2c}


def _injected(name, cfg, ts, steps):
    """Draws of `steps` steps made from a numpy-free torch generator, as a
    caller would inject them."""
    g = torch.Generator().manual_seed(11)
    if name.startswith("dqn"):
        explore = torch.rand((steps, B), generator=g) < 0.5
        rand_a = torch.randint(0, 4, (steps, B), generator=g, dtype=torch.int32)
        if cfg.prioritized:
            sample = ta2c.draw_gumbel(g, (steps, cfg.buffer_capacity), CPU)
        else:
            sample = torch.randint(0, B, (steps, cfg.batch_size_train), generator=g, dtype=torch.int32)
        return {"draws": (explore, rand_a, sample)}
    gumbel = ta2c.draw_gumbel(g, (steps, cfg.rollout_len, B, 4), CPU)
    if name.startswith("ppo"):
        shuffle = [[torch.randint(0, B, (), generator=g) for _ in range(cfg.num_epochs)] for _ in range(steps)]
        return {"gumbel": gumbel, "shuffle_draws": shuffle}
    return {"gumbel": gumbel}


def _fields(ts) -> dict:
    """Every state field, by name: a train state's tensors, ints and the seed."""
    out = {}
    for f in dataclasses.fields(ts):
        x = getattr(ts, f.name)
        if isinstance(x, dict):
            out.update({f"{f.name}.{k}": v for k, v in x.items()})
        elif dataclasses.is_dataclass(x):
            out.update({f"{f.name}.{k}": v for k, v in _fields(x).items()})
        elif isinstance(x, tuple):
            out.update({f"{f.name}.{k}": v for k, v in x._asdict().items()})
        else:
            out[f.name] = x
    return out


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("inject", [False, True], ids=["own draws", "injected"])
@pytest.mark.parametrize("name", list(CASES))
def test_body_over_static_buffers_equals_the_eager_loop(name, inject):
    cfg, lv, ts0, run, eager = CASES[name]()
    kw = _injected(name, cfg, ts0, STEPS) if inject else {}
    got = run(SEM, lv, ts0, cfg, STEPS, **kw)
    want = eager(SEM, lv, ts0, cfg, STEPS, **kw)
    _assert_same(got, want)
    # the state given was not written
    _assert_same(ts0, CASES[name]()[2])


@pytest.mark.parametrize("name", list(CASES))
def test_body_reads_nothing_on_the_host_and_keeps_its_buffers(name, monkeypatch):
    cfg, lv, ts0, run, eager = CASES[name]()
    calls = []
    step = capture.Steps.step

    def refuse(what):
        def read(*args, **kwargs):
            raise AssertionError(f"the body read a tensor on the host: Tensor.{what}")
        return read

    def guarded(self, state):
        before = [x.data_ptr() for x in state]
        with monkeypatch.context() as m:
            for what in HOST_READS:
                m.setattr(torch.Tensor, what, refuse(what))
            step(self, state)
        assert [x.data_ptr() for x in state] == before
        calls.append(len(state))

    monkeypatch.setattr(capture.Steps, "step", guarded)
    got = run(SEM, lv, ts0, cfg, STEPS)
    assert len(calls) == STEPS
    monkeypatch.undo()
    _assert_same(got, eager(SEM, lv, ts0, cfg, STEPS))


def test_the_patched_reads_do_raise(monkeypatch):
    x = torch.ones(2)
    for what in HOST_READS:
        monkeypatch.setattr(torch.Tensor, what, lambda *a, **k: (_ for _ in ()).throw(AssertionError(what)))
    for read in (lambda: x.sum().item(), lambda: bool(x[0]), lambda: int(x[0]), lambda: float(x[0]),
                 lambda: x.tolist(), lambda: x.numpy(), lambda: x.cpu()):
        with pytest.raises(AssertionError):
            read()


def test_run_on_the_cpu_seeds_each_step_and_copies_its_inputs():
    """A toy program: step i's generator gives a fresh generator's draws
    for seed 100 + i, and its input buffer holds draws[i]."""
    draws = torch.arange(12.0).reshape(4, 3)
    state = [torch.zeros(3), torch.zeros((), dtype=torch.int64)]

    def body(xs, gen, inputs):
        acc, n = xs
        return [acc + torch.rand(3, generator=gen) + inputs[0], n + 1]

    out = capture.run("toy", state, lambda: capture.Program(body, seeds=lambda i: 100 + i,
                                                           inputs=lambda i: [draws[i]]), 4)
    want = torch.zeros(3)
    for i in range(4):
        want = want + torch.rand(3, generator=torch.Generator().manual_seed(100 + i)) + draws[i]
    assert out is state and torch.equal(out[0], want) and int(out[1]) == 4


def test_write_back_copies_by_dtype_and_refuses_another_shape():
    a, b, c = torch.zeros(3), torch.zeros(2, dtype=torch.int32), torch.ones(())
    pa, pb = a.data_ptr(), b.data_ptr()
    capture.write_back([a, b, c], [torch.ones(3), torch.full((2,), 7, dtype=torch.int32), c])
    assert a.data_ptr() == pa and b.data_ptr() == pb
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, torch.full((2,), 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="buffer"):
        capture.write_back([a], [torch.ones(4)])
    with pytest.raises(ValueError, match="buffer"):
        capture.write_back([a], [torch.ones(3, dtype=torch.float64)])
    with pytest.raises(ValueError, match="returned"):
        capture.write_back([a, b], [a])
