"""Port parity: the TD(λ) trace pass (`algos.td_lambda.trace_pass`, K12 on
CUDA) on the CPU against the JAX primitives, and its fixed order of adds.

`trace_pass_reference` is one step of the reference's `decay_traces` →
`bump_traces` → `apply_trace_updates` → cut. Against JAX the traces agree to
rtol 1e-6 and the table to rtol 1e-5 (atol 1e-6): the reference's `einsum`
sums the env axis in another order. Against a NumPy float32 walk in the
kernel's order (the envs of each chunk of `CHUNK` in index order, then the
chunks in order) the table is equal bit for bit, which is what K12 is held
to on the card.
"""

from __future__ import annotations

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from griduniverse_tpu.algos import td_lambda as jtl
from griduniverse_tpu_torch.algos import td_lambda as ttl
from griduniverse_tpu_torch.kernels import trace_pass as k12
from griduniverse_tpu_torch.kernels.trace_pass import CHUNK

torch.set_num_threads(1)

GAMMA, LAM, CUTOFF, ALPHA = 0.9, 0.8, 1e-4, 0.3


def _t(x):
    return torch.as_tensor(np.array(x))


def _inputs(rng, b, s, a):
    shape = (b, s) if a is None else (b, s, a)
    e = (rng.random(shape) * 2 * (rng.random(shape) < 0.3)).astype(np.float32)
    e.reshape(b, -1)[::7, 0] = 1.2e-4  # decays under the cutoff
    states = rng.integers(0, s, b).astype(np.int32)
    actions = None if a is None else rng.integers(0, a, b).astype(np.int32)
    delta = rng.normal(size=b).astype(np.float32)
    cut = rng.random(b) < 0.2
    table = rng.normal(size=shape[1:]).astype(np.float32)
    return e, states, actions, delta, cut, table


def _jax_step(e, s, a, delta, cut, table, kind):
    """The reference's primitives, in the order of its scan body."""
    e = jtl.decay_traces(jnp.asarray(e), GAMMA, LAM, CUTOFF)
    if a is not None:
        e = jtl.bump_traces(e, jnp.asarray(s), jnp.asarray(a), e.shape[1], e.shape[2], kind)
        table = jtl.apply_trace_updates(jnp.asarray(table), jnp.asarray(delta), e, ALPHA)
    else:  # td_lambda_prediction's lines
        hot = jax.nn.one_hot(jnp.asarray(s), e.shape[1], dtype=e.dtype)
        e = e + hot if kind == "accumulating" else jnp.maximum(e, hot)
        num = jnp.einsum("b,bs->s", jnp.asarray(delta), e)
        table = jnp.asarray(table) + ALPHA * num / jnp.maximum(jnp.sum(e != 0.0, axis=0), 1.0)
    cut_b = jnp.asarray(cut).reshape((-1,) + (1,) * (e.ndim - 1))
    return np.asarray(jnp.where(cut_b, 0.0, e)), np.asarray(table)


def _port_step(e, s, a, delta, cut, table, kind, fn=ttl.trace_pass_reference):
    te = _t(e).clone()
    tq = fn(_t(table), te, _t(s), None if a is None else _t(a), _t(delta), _t(cut),
            GAMMA, LAM, CUTOFF, ALPHA, kind)
    return te.numpy(), tq.numpy()


@pytest.mark.parametrize("b,a", [(300, 4), (5, 4), (300, None), (257, None)])
@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
def test_trace_pass_reference_matches_jax_primitives(b, a, kind, rng):
    inputs = _inputs(rng, b, 16, a)
    je, jq = _jax_step(*inputs, kind)
    te, tq = _port_step(*inputs, kind)
    np.testing.assert_allclose(te, je, rtol=1e-6)
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-6)
    cut = inputs[4]
    assert not te[cut].any()  # a cut env's whole trace is zero


def _numpy_in_kernel_order(e, s, a, delta, cut, table, kind):
    """One trace step in float32 NumPy, the sums in K12's order."""
    b = e.shape[0]
    x = (np.float32(GAMMA * LAM) * e.reshape(b, -1)).astype(np.float32)
    x[x < np.float32(CUTOFF)] = 0.0
    hot = s if a is None else s * e.shape[2] + a
    rows = np.arange(b)
    x[rows, hot] = x[rows, hot] + 1.0 if kind == "accumulating" else np.maximum(x[rows, hot], 1.0)
    num = np.zeros(x.shape[1], np.float32)
    for c0 in range(0, b, CHUNK):
        part = np.zeros(x.shape[1], np.float32)
        for i in range(c0, min(c0 + CHUNK, b)):
            part = part + delta[i] * x[i]
        num = num + part
    cnt = (x != 0).sum(axis=0).astype(np.float32)
    new = table.reshape(-1) + np.float32(ALPHA) * num / np.maximum(cnt, np.float32(1.0))
    x[cut] = 0.0
    return x.reshape(e.shape), new.reshape(table.shape)


@pytest.mark.parametrize("b,a", [(600, 4), (256, None)])
@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
def test_trace_pass_adds_in_the_kernels_order(b, a, kind, rng):
    inputs = _inputs(rng, b, 16, a)
    ne, nq = _numpy_in_kernel_order(*inputs, kind)
    te, tq = _port_step(*inputs, kind)
    assert np.array_equal(te.view(np.int32), ne.view(np.int32))
    assert np.array_equal(tq.view(np.int32), nq.view(np.int32))
    # the public function takes the plain version on CPU tensors, and
    # apply_trace_updates sums in the same order
    de, dq = _port_step(*inputs, kind, fn=ttl.trace_pass)
    assert np.array_equal(de.view(np.int32), te.view(np.int32))
    assert np.array_equal(dq.view(np.int32), tq.view(np.int32))
    if a is not None:
        e, s, act, delta, _, table = inputs
        x = ttl.bump_traces(ttl.decay_traces(_t(e), GAMMA, LAM, CUTOFF), _t(s), _t(act), 16, a, kind)
        q = ttl.apply_trace_updates(_t(table), _t(delta), x, ALPHA)
        assert np.array_equal(q.numpy().view(np.int32), tq.view(np.int32))


def test_trace_pass_rejects_unknown_devices_mix():
    e = torch.zeros((4, 3, 2))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ttl.trace_pass(torch.zeros((3, 2)), e.to("meta"), torch.zeros(4, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), torch.zeros(4), torch.zeros(4, dtype=torch.bool),
                       GAMMA, LAM, CUTOFF, ALPHA, "accumulating")


def test_trace_pass_wrapper_refuses_cpu_tensors():
    """The wrapper launches K12 or raises; only `trace_pass` picks the plain
    version, and only by where the tensors lie."""
    from griduniverse_tpu_torch.kernels.trace_pass import trace_pass_cuda

    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        trace_pass_cuda(torch.zeros((3, 2)), torch.zeros((4, 3, 2)), i32, i32, torch.zeros(4),
                        torch.zeros(4, dtype=torch.bool), GAMMA * LAM, CUTOFF, ALPHA, False)


@pytest.mark.parametrize("b,shape", [(1, (16, 4)), (300, (16, 4)), (65_536, (256, 4)), (65_536, (256,)),
                                     (16_776_961, (1, 2))])
def test_trace_pass_plan_scratch_and_one_launch(b, shape):
    """K12 is one launch a step at any batch; a plan's scratch is a partial
    sum a (chunk, cell), a count a cell and a ticket a tile, zeroed once."""
    cells = int(np.prod(shape))
    assert k12.launches(b) == 1
    words = k12.scratch_words(b, cells)
    chunks = -(-b // CHUNK)
    assert words == {"partial": -(-chunks // 256) * 256 * cells, "count": cells, "tickets": 2 * -(-cells // k12.TILE)}
    plan = k12.TracePassPlan(torch.zeros(shape), b, len(shape) == 2)
    assert plan.words == words and plan.num_actions == (shape[-1] if len(shape) == 2 else 1)
    assert plan._scratch.numel() == sum(words.values()) and not plan._scratch.any()


@pytest.mark.parametrize("cells,sms,want", [(256, 132, 4), (1024, 132, 4), (128 * 66, 132, 4), (128 * 67, 132, 2),
                                           (128 * 132, 132, 2), (128 * 133, 132, 1), (2, 1, 2), (129, 1, 1)])
def test_trace_pass_appliers_keep_to_two_blocks_an_sm(cells, sms, want):
    """Four blocks a tile add its sums while the tiles' appliers together
    stay within two blocks an SM; then two, then one (which never waits)."""
    assert k12.appliers(cells, sms) == want
    assert want == 1 or want * -(-cells // k12.TILE) <= 2 * sms


def test_trace_pass_plan_checks_the_step_against_its_shapes():
    plan = k12.TracePassPlan(torch.zeros((16, 4)), 300, True)
    i32 = torch.zeros(300, dtype=torch.int32)
    step = (torch.zeros((16, 4)), torch.zeros((300, 16, 4)), i32, i32, torch.zeros(300),
            torch.zeros(300, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):  # the shapes pass; the CPU does not
        plan(*step, GAMMA * LAM, CUTOFF, ALPHA, False)
    with pytest.raises(ValueError, match="e has shape"):
        plan(step[0], torch.zeros((301, 16, 4)), *step[2:], GAMMA * LAM, CUTOFF, ALPHA, False)
    with pytest.raises(ValueError, match="a is None"):
        plan(*step[:3], None, *step[4:], GAMMA * LAM, CUTOFF, ALPHA, False)
    with pytest.raises(ValueError, match="prediction table"):
        k12.TracePassPlan(torch.zeros((16, 4)), 300, False)


# ---------------------------------------------------------------------------
# The public names of each subpackage against the reference's
# ---------------------------------------------------------------------------


def _public(module) -> set[str]:
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items() if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("name", ["core", "levels", "ops", "algos", "models", "utils", "utils.checkpoint",
                                  "utils.metrics"])
def test_subpackage_names_match_reference(name):
    """Every name the reference's subpackage exports, the port's does too;
    only the sharded trainers (which come with `parallel/`) may be missing."""
    ref = importlib.import_module(f"griduniverse_tpu.{name}")
    port = importlib.import_module(f"griduniverse_tpu_torch.{name}")
    missing = {n for n in _public(ref) - _public(port) if not n.endswith("_sharded") and n != "reshard_stats"}
    assert not missing, sorted(missing)
