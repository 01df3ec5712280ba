"""Port parity: griduniverse_tpu_torch.models (networks, optimizer and the
plain versions of K7a, K7b, K9a, K9b on the CPU) against the JAX package.

Inputs come from numpy seeds; JAX parameters are loaded into the port's
modules with `utils.convert.to_network_state`. Tolerances, stated per test:
float32 forward atol 1e-5 (sum order differs between XLA and torch); bfloat16
logits and values atol 3e-2 (the two frameworks round bfloat16 products and
sums at other places; measured up to 7.8e-3 at these sizes over 12 seeds);
gradients rtol
1e-4; optimizer rtol 1e-6 (2e-5 for the linear schedule's rate); GAE and
returns rtol 1e-5, atol 1e-5 (XLA may fuse a multiply-add).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.models import networks as jn
from griduniverse_tpu.models import ppo as jppo
from griduniverse_tpu.models.optim import make_lr as j_make_lr
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch.kernels import agent_stamp as k9b
from griduniverse_tpu_torch.kernels import embed_rows as k9a
from griduniverse_tpu_torch.models import a2c as ta2c
from griduniverse_tpu_torch.models import networks as tn
from griduniverse_tpu_torch.models import optim as topt
from griduniverse_tpu_torch.models import ppo as tppo
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# K7a: GAE and n-step returns
# ---------------------------------------------------------------------------


def _rollout_arrays(seed, t, b):
    rng = np.random.default_rng(seed)
    value = rng.normal(size=(t, b)).astype(np.float32)
    reward = rng.normal(size=(t, b)).astype(np.float32)
    done = rng.random(size=(t, b)) < 0.25
    bootstrap = rng.normal(size=(b,)).astype(np.float32)
    return value, reward, done, bootstrap


# T at the register tier (1), just above it (33) and in groups (128); B of one env, and odd
# either side of 4,096, where K7a takes one env a thread
K7A_TB = [(t, b) for t in (1, 33, 128) for b in (1, 4095, 4097)]


@pytest.mark.parametrize("seed,t,b", [(0, 12, 5), (1, 16, 257), (2, 1, 3)] + [(10 + i, t, b) for i, (t, b) in enumerate(K7A_TB)])
def test_gae_matches_jax_and_numpy(seed, t, b):
    value, reward, done, bootstrap = _rollout_arrays(seed, t, b)
    gamma, lam = 0.97, 0.9
    z = np.zeros((t, b))
    jtraj = jppo._Traj(jnp.asarray(z, jnp.int32), jnp.asarray(z, jnp.int32), jnp.asarray(z, jnp.float32),
                       jnp.asarray(value), jnp.asarray(reward), jnp.asarray(done))
    jadv, jtargets = jppo.gae_advantages(jtraj, jnp.asarray(bootstrap), gamma, lam)
    ttraj = ta2c.Trajectory(None, None, None, _t(value), _t(reward), _t(done))
    adv, targets = tppo.gae_advantages(ttraj, _t(bootstrap), gamma, lam)
    exp = np.zeros((t, b), np.float32)
    carry, v_next = np.zeros(b, np.float32), bootstrap
    for k in range(t - 1, -1, -1):
        nd = 1.0 - done[k].astype(np.float32)
        delta = reward[k] + gamma * v_next * nd - value[k]
        carry = delta + gamma * lam * nd * carry
        exp[k] = carry
        v_next = value[k]
    for got, want in ((adv, jadv), (targets, jtargets), (adv, exp), (targets, exp + value)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert adv.dtype == torch.float32 and adv.shape == (t, b)


@pytest.mark.parametrize("seed,t,b", [(3, 12, 5), (4, 16, 257)] + [(20 + i, t, b) for i, (t, b) in enumerate(K7A_TB)])
def test_nstep_returns_match_jax_scan_and_numpy(seed, t, b):
    _, reward, done, bootstrap = _rollout_arrays(seed, t, b)
    gamma = 0.95

    def body(g_next, x):  # models/a2c.py `returns_from`
        r, d = x
        g = r + gamma * jnp.where(d, 0.0, g_next)
        return g, g

    _, want = jax.lax.scan(body, jnp.asarray(bootstrap), (jnp.asarray(reward), jnp.asarray(done)), reverse=True)
    got = ta2c.nstep_returns(_t(reward), _t(done), _t(bootstrap), gamma)
    exp, g = np.zeros((t, b), np.float32), bootstrap
    for k in range(t - 1, -1, -1):
        g = reward[k] + np.float32(gamma) * np.where(done[k], np.float32(0), g)
        exp[k] = g
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,b,width,tier", [
    (1, 65_536, 4, "registers"), (16, 65_536, 4, "registers"), (17, 65_536, 4, "groups"), (128, 4096, 4, "groups"),
    (16, 4098, 2, "registers"), (33, 4098, 2, "groups"), (1, 1, 1, "registers"), (33, 4095, 1, "groups"),
    (128, 4097, 1, "groups"), (16, 65_537, 1, "registers")])
def test_k7a_plan_tiers_and_widths(t, b, width, tier):
    """K7a's plan as a function of (T, B) with aligned pointers: envs a
    thread (16-byte accesses where B % 4 == 0, 8-byte where B % 2 == 0, else
    the scalar path), the register tier up to T = 16, groups of 8 above."""
    from griduniverse_tpu_torch.kernels import gae as k7a

    got = k7a.plan(t, b)
    assert got == (width, tier, k7a.THREADS, -(-(b // width) // k7a.THREADS))
    assert (t <= k7a.REGISTER_T) == (tier == "registers") and k7a.GROUP == 8


@pytest.mark.parametrize("floats,done,width", [((256, 512), 256, 4), ((256, 520), 256, 2), ((256, 512), 258, 2),
                                               ((256, 512), 257, 1), ((260, 512), 256, 1), ((), 1, 1)])
def test_k7a_plan_takes_the_scalar_edge_off_alignment(floats, done, width):
    """A pointer off its width's alignment (a float pointer off 16 or 8 bytes,
    the done bytes off 4 or 2, as a view into a larger buffer gives) narrows
    the plan to what every pointer allows."""
    from griduniverse_tpu_torch.kernels import gae as k7a

    assert k7a.plan(16, 65_536, floats, done).width == width


# ---------------------------------------------------------------------------
# K7b: act_step and greedy_step (plain versions) against the JAX rollout body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_ep", [None, 3])
def test_act_step_matches_jax_rollout_body(max_ep, rng):
    jlevel = jb.lava_level()
    tlevel = convert.to_level(jlevel, device=CPU)
    jbl, tbl = jbp.pack_level(jlevel), tbp.pack_level(tlevel)
    b = 64
    jst, tst = jbp.reset_bits(jbl, b), tbp.reset_bits(tbl, b)
    for _ in range(6):
        logits = rng.normal(size=(b, 4)).astype(np.float32) * 2
        noise = rng.gumbel(size=(b, 4)).astype(np.float32)
        ja = jnp.argmax(jnp.asarray(logits) + jnp.asarray(noise), axis=-1).astype(jnp.int32)
        jlogp = jnp.take_along_axis(jax.nn.log_softmax(jnp.asarray(logits)), ja[:, None], axis=-1)[:, 0]
        jobs = jst.agent_idx
        jst, (_, jr, jd) = jbp.step_bits(JSEM, jbl, jst, ja, True, max_ep)
        tst, a, logp, obs, r, d = ta2c.act_step(TSEM, tbl, tst, _t(logits), _t(noise), max_ep)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=0, atol=5e-7)
        for f in ("agent_idx", "agent_code", "t"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    assert a.dtype == torch.int32 and d.dtype == torch.bool


def test_greedy_step_matches_jax_freeze_step(rng):
    jlevel = jb.lava_level()
    tlevel = convert.to_level(jlevel, device=CPU)
    jbl, tbl = jbp.pack_level(jlevel), tbp.pack_level(tlevel)
    b = 128
    jst, tst = jbp.reset_bits(jbl, b), tbp.reset_bits(tbl, b)
    jreached = jnp.zeros(b, bool)
    treached = torch.zeros(b, dtype=torch.bool)
    for _ in range(25):
        logits = rng.normal(size=(b, 4)).astype(np.float32)
        ja = jnp.argmax(jnp.asarray(logits), axis=-1).astype(jnp.int32)
        jst, (_, jr, jd) = jbp.step_bits(JSEM, jbl, jst, ja, False, None)
        jreached = jreached | (jd & (jr > 0))
        tst, treached = ta2c.greedy_step(TSEM, tbl, tst, treached, _t(logits))
        np.testing.assert_array_equal(treached.numpy(), np.asarray(jreached))
        for f in ("agent_idx", "agent_code", "t", "done"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    assert bool(tst.done.any())


# ---------------------------------------------------------------------------
# Networks: forward parity with JAX parameters
# ---------------------------------------------------------------------------

GRID = np.zeros((5, 6), np.int32)
GRID[2, 2] = 1
GRID[3, 4] = 3
GRID[1, 4] = 2
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _nets(family, cdt):
    if family == "index":
        kw = dict(num_states=30, num_actions=4, hidden=(32, 16), embed_dim=8, compute_dtype=cdt)
        return jn.ActorCritic(**kw), tn.ActorCritic(**kw, device=CPU)
    kw = dict(height=5, width=6, num_actions=4, channels=(8, 8), hidden=(16,), compute_dtype=cdt)
    if family == "conv":
        grid = tuple(int(v) for v in GRID.reshape(-1))
        return jn.ConvActorCritic(grid=grid, **kw), tn.ConvActorCritic(grid=grid, **kw, device=CPU)
    return jn.BatchedConvActorCritic(**kw), tn.BatchedConvActorCritic(**kw, device=CPU)


def _apply_both(family, jnet, tnet, jparams, obs, tiles=None):
    tparams = convert.to_network_state(tree_np(jparams), tnet)
    if family == "batched":
        jout = jnet.apply(jparams, jnp.asarray(obs), jnp.asarray(tiles))
        tout = ta2c._net_apply(tnet, tparams, _t(obs), _t(tiles))
    else:
        jout = jnet.apply(jparams, jnp.asarray(obs))
        tout = ta2c._net_apply(tnet, tparams, _t(obs), None)
    return jout, tout


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["index", "conv", "batched"])
@pytest.mark.parametrize("shape", [(), (7,), (3, 7)])
def test_forward_matches_jax(family, cdt, shape, rng):
    jnet, tnet = _nets(family, cdt)
    obs = rng.integers(0, 30, size=shape).astype(np.int32)
    # per-env levels for the trailing axis (none for a scalar observation)
    lvl_shape = shape[-1:] if shape else ()
    tiles = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=lvl_shape + (5, 6))]
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    if family == "batched":
        jparams = jnet.init(key, jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 6, 4)))
    else:
        jparams = jnet.init(key, jnp.zeros((1,), jnp.int32))
    # biases start at zero; make them matter
    jparams = jax.tree.map(lambda x: x + 0.05 if x.ndim == 1 else x, jparams)
    (jl, jv), (tl, tv) = _apply_both(family, jnet, tnet, jparams, obs, tiles)
    assert tl.shape == shape + (4,) and tv.shape == shape
    assert tl.dtype == torch.float32 and tv.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL[cdt])
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **TOL[cdt])


def test_batched_conv_equals_static_conv_on_a_shared_level(rng):
    jstatic, tstatic = _nets("conv", "float32")
    _, tbatched = _nets("batched", "float32")
    jparams = jstatic.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    params = convert.to_network_state(tree_np(jparams), tstatic)
    obs = torch.tensor([0, 7, 13, 22], dtype=torch.int32)
    tiles = torch.as_tensor(np.eye(4, dtype=np.float32)[GRID])
    l1, v1 = ta2c._net_apply(tstatic, params, obs, None)
    l2, v2 = ta2c._net_apply(tbatched, params, obs, tiles)  # () level suffix
    torch.testing.assert_close(l1, l2, atol=1e-6, rtol=0)
    torch.testing.assert_close(v1, v2, atol=1e-6, rtol=0)
    l3, _ = ta2c._net_apply(tbatched, params, obs.expand(3, 4), tiles.expand(4, 5, 6, 4))
    torch.testing.assert_close(l3[1], l1, atol=1e-6, rtol=0)
    # against the JAX static trunk too
    jl, _ = jstatic.apply(jparams, jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(l1.detach().numpy(), np.asarray(jl), atol=1e-5)


def test_tiles_shape_validation_and_modes():
    net = tn.BatchedConvActorCritic(height=5, width=6, num_actions=4, channels=(8,), hidden=(16,), device=CPU)
    obs = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="trailing"):
        net(obs, torch.zeros((3, 6, 5, 4)))  # H/W swapped
    with pytest.raises(ValueError, match="suffix"):
        net(obs, torch.zeros((2, 5, 6, 4)))  # 2 != 3
    with pytest.raises(ValueError, match="agent_plane"):
        tn.BatchedConvActorCritic(height=5, width=6, num_actions=4, agent_plane="fft", device=CPU)
    with pytest.raises(ValueError, match="at least one conv"):
        tn.ConvActorCritic(height=5, width=6, grid=GRID.reshape(-1), num_actions=4, channels=(), device=CPU)
    with pytest.raises(ValueError, match="compute_dtype"):
        tn.ActorCritic(num_states=4, num_actions=4, compute_dtype="float16", device=CPU)


@pytest.mark.parametrize("mode", ["stamp", "conv"])
def test_agent_plane_modes_match_jax_conv_with_gradients(mode, rng):
    """Both modes of the port run K9b's function; held here against the JAX
    trunk with the DIRECT conv lowering: values, and the gradient of
    sum(logits²) on every leaf (this pins the stamp's flip and dk's index)."""
    kw = dict(height=5, width=6, num_actions=4, channels=(8, 8), hidden=(16,), compute_dtype="float32")
    jnet = jn.BatchedConvActorCritic(agent_plane="conv", **kw)
    tnet = tn.BatchedConvActorCritic(agent_plane=mode, **kw, device=CPU)
    obs = rng.integers(0, 30, size=(7, 12)).astype(np.int32)
    tiles = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(12, 5, 6))]
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(tiles))
    jl, jv = jnet.apply(jparams, jnp.asarray(obs), jnp.asarray(tiles))
    jgrads = jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(obs), jnp.asarray(tiles))[0] ** 2))(jparams)
    live = ta2c.leaves(convert.to_network_state(tree_np(jparams), tnet))
    tl, tv = ta2c._net_apply(tnet, live, _t(obs), _t(tiles))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=2e-5, rtol=2e-5)
    grads = ta2c.grads_of((tl ** 2).sum(), live)
    want = convert.to_network_state(tree_np(jgrads), tnet)
    for name in want:
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(), atol=2e-4, rtol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# K9a and K9b: the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,e,n", [(256, 16, 1500), (4225, 64, 700), (7, 3, 1)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_embed_rows_plain_forward_and_fixed_order_backward(s, e, n, cdt, rng):
    table = torch.as_tensor(rng.normal(size=(s, e)).astype(np.float32), ).requires_grad_(True)
    obs = rng.integers(0, min(s, 9), size=n).astype(np.int32)  # heavy collisions
    obs[::5] = rng.integers(0, s, size=len(obs[::5]))
    out = tn.embed_rows(table, _t(obs), cdt)
    want = jnp.asarray(table.detach().numpy()).astype(jnp.dtype(str(cdt).split(".")[1]))[obs]
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(want, dtype=np.float32))
    assert out.dtype == cdt and out.shape == (n, e)
    g = torch.as_tensor(rng.normal(size=(n, e)).astype(np.float32)).to(cdt)
    (auto,) = torch.autograd.grad(out, table, g)
    fixed = tn.embed_rows_backward_reference(g, _t(obs), s)
    exact = np.zeros((s, e), np.float64)
    np.add.at(exact, obs, g.float().numpy().astype(np.float64))
    np.testing.assert_allclose(fixed.numpy(), exact, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(auto.numpy(), exact, rtol=1e-5, atol=1e-5)
    # the fixed order is a function of the inputs alone
    assert torch.equal(fixed, tn.embed_rows_backward_reference(g, _t(obs), s))


@pytest.mark.parametrize("cdt,s_max", [(torch.bfloat16, 911), (torch.float32, 655)])
def test_embed_rows_backward_shared_tier_limit(cdt, s_max):
    """The backward's shared tier takes the trainers' table (S=256, E=16)
    and its largest table at E=16 (a partial table with a spare row, 512
    indices and 512 gradient rows within three blocks an SM); one row more,
    and S=4,225, E=64, take the global tier."""
    assert k9a.uses_shared_tier(256, 16, cdt)
    assert k9a.shared_tier_bytes(s_max, 16, cdt) <= k9a.SHARED_TIER_MAX_BYTES
    assert k9a.uses_shared_tier(s_max, 16, cdt) and not k9a.uses_shared_tier(s_max + 1, 16, cdt)
    assert not k9a.uses_shared_tier(4225, 64, cdt)
    assert 3 * (k9a.SHARED_TIER_MAX_BYTES + 1024) <= 228 * 1024


@pytest.mark.parametrize("s,e", [(256, 16), (4225, 64)])
def test_embed_rows_fixed_order_backward_matches_jax_autograd(s, e, rng):
    """The plain fixed-order backward against JAX's autograd of the
    reference's own lookup (`ActorCritic` in float32, its policy head the
    identity, so its logits are the looked-up rows: the hi/lo one-hot at
    S=256, the plain one-hot at 4,225) at N = 1,537, three whole chunks and
    a partial fourth. Both sum the same float32 terms in other orders:
    rtol 1e-5."""
    n = 1537
    obs = rng.integers(0, 9, size=n).astype(np.int32)  # heavy collisions
    obs[::5] = rng.integers(0, s, size=len(obs[::5]))
    table = rng.normal(size=(s, e)).astype(np.float32)
    g = rng.normal(size=(n, e)).astype(np.float32)
    jnet = jn.ActorCritic(num_states=s, num_actions=e, hidden=(), embed_dim=e, compute_dtype="float32")
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs))["params"]
    head = {"kernel": jnp.eye(e, dtype=jnp.float32), "bias": jnp.zeros(e, jnp.float32)}

    def lookup(tab):
        return jnet.apply({"params": {**params, "embed": tab, "policy_head": head}}, jnp.asarray(obs))[0]

    rows, vjp = jax.vjp(lookup, jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(rows), table[obs])
    (want,) = vjp(jnp.asarray(g))
    fixed = tn.embed_rows_backward_reference(_t(g), _t(obs), s)
    np.testing.assert_allclose(fixed.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nl,t", [(1, 9), (6, 4)])
def test_agent_stamp_plain_matches_jax_conv_with_gradients(nl, t, rng):
    _stamp_matches_jax_conv(nl, t, 8, rng)


@pytest.mark.parametrize("ch", [257, 514])
def test_agent_stamp_plain_matches_jax_conv_above_the_channel_limit(ch, rng):
    """C / vector width above MAX_THREADS, where the kernel cuts the
    channels into slices: the plain version is the same function."""
    _stamp_matches_jax_conv(3, 2, ch, rng)


def _stamp_matches_jax_conv(nl, t, ch, rng):
    h, w = 5, 6
    n = nl * t
    y_tiles = rng.normal(size=(nl, h, w, ch)).astype(np.float32)
    k = rng.normal(size=(3, 3, ch)).astype(np.float32)
    bias = rng.normal(size=(ch,)).astype(np.float32)
    obs = rng.integers(0, h * w, size=n).astype(np.int32)
    obs[:4] = [0, w - 1, (h - 1) * w, h * w - 1][: min(4, n)]  # the corners
    cot = rng.normal(size=(n, h, w, ch)).astype(np.float32)

    def jfn(y_tiles, k, bias):
        agent = jax.nn.one_hot(obs, h * w).reshape(n, h, w, 1)
        y_agent = jax.lax.conv_general_dilated(
            agent, k[:, :, None, :], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = y_agent.reshape(t, nl, h, w, ch) + y_tiles
        return jax.nn.relu(y + bias).reshape(n, h, w, ch)

    want, vjp = jax.vjp(jfn, jnp.asarray(y_tiles), jnp.asarray(k), jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(cot))
    targs = [_t(x).requires_grad_(True) for x in (y_tiles, k, bias)]
    got = tn.agent_stamp(*targs, _t(obs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    grads = torch.autograd.grad(got, targs, _t(cot))
    for name, a, b in zip(("dy_tiles", "dk_agent", "dbias"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-5, err_msg=name)
    # bfloat16: parameters rounded first, float32 sums, one rounding at the end
    got16 = tn.agent_stamp(_t(y_tiles).bfloat16(), _t(k), _t(bias), _t(obs))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want), atol=5e-2, rtol=2e-2)


def _stamp_case(rng, nl, t, h, w, ch, cdt):
    """K9b's inputs and saved output for (Nl, T, H, W, C), the agents of
    the first samples in the four corners."""
    n = nl * t
    y_tiles = _t(rng.normal(size=(nl, h, w, ch)).astype(np.float32)).to(cdt).requires_grad_(True)
    k = _t(rng.normal(size=(3, 3, ch)).astype(np.float32)).requires_grad_(True)
    bias = _t(rng.normal(size=(ch,)).astype(np.float32)).requires_grad_(True)
    obs = rng.integers(0, h * w, size=n).astype(np.int32)
    obs[:4] = [0, w - 1, (h - 1) * w, h * w - 1][: min(4, n)]  # the corners
    cot = _t(rng.normal(size=(n, h, w, ch)).astype(np.float32)).to(cdt)
    out = tn.agent_stamp(y_tiles, k, bias, _t(obs))
    return y_tiles, k, bias, obs, cot, out


def _hold_stamp_backward(y_tiles, k, bias, obs, cot, out, nl, cdt):
    """The fixed-order backward against a float64 numpy sum over the masked
    gradient (rtol 1e-5, atol 1e-4; dy_tiles in bfloat16 is rounded once,
    rtol 1e-2) and against autograd through the plain forward in float32;
    two calls give the same bits."""
    n, h, w, ch = cot.shape
    dy, dk, dbias = tn.agent_stamp_backward_reference(cot, out.detach(), _t(obs), nl)
    assert dy.dtype == cdt and dk.dtype == dbias.dtype == torch.float32
    gm = np.where(out.detach().float().numpy() > 0, cot.float().numpy(), 0.0).astype(np.float64)
    want_dk = np.zeros((3, 3, ch))
    for s, cell in enumerate(obs):
        ay, ax = divmod(int(cell), w)
        for i in range(3):
            for j in range(3):
                y, x = ay - i + 1, ax - j + 1
                if 0 <= y < h and 0 <= x < w:
                    want_dk[i, j] += gm[s, y, x]
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dbias.numpy(), gm.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-4)
    dy_tol = dict(rtol=1e-5, atol=1e-4) if cdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(dy.float().numpy(), gm.reshape(n // nl, nl, h, w, ch).sum(axis=0), **dy_tol)
    if cdt == torch.float32:
        auto = torch.autograd.grad(out, (y_tiles, k, bias), cot)
        for name, a, b in zip(("dy_tiles", "dk_agent", "dbias"), (dy, dk, dbias), auto):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4, err_msg=name)
    # the fixed order is a function of the inputs alone
    again = tn.agent_stamp_backward_reference(cot, out.detach(), _t(obs), nl)
    assert all(torch.equal(a, b) for a, b in zip((dy, dk, dbias), again))
    return dy, dk, dbias


@pytest.mark.parametrize("nl,t", [(1, 150), (6, 4), (70, 3)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_fixed_order_backward(nl, t, cdt, rng):
    """The add-by-add version of K9b's backward against float64 sums and
    autograd: a level split into several ranges (Nl=1), one range over
    several tiles, and many levels a tile."""
    _hold_stamp_backward(*_stamp_case(rng, nl, t, 5, 6, 8, cdt), nl, cdt)


@pytest.mark.parametrize("nl,t,h,w,ch", [
    (1, 200, 9, 9, 8),     # Nl = 1: four ranges of T_RANGE, dy_tiles summed over them
    (2, 70, 5, 6, 12),     # two ranges, the last one short, over two levels
    (40, 1, 9, 9, 16),     # Nl = N: a rollout step or DQN's minibatch
    (9, 4, 9, 9, 32),      # the trunk's width at the minibatch's T / 4
    (3, 4, 17, 17, 8),     # a level above one tile of cells
    (2, 3, 5, 6, 3),       # a C no vector divides: a thread a channel
])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_backward_edge_shapes(nl, t, h, w, ch, cdt, rng):
    _hold_stamp_backward(*_stamp_case(rng, nl, t, h, w, ch, cdt), nl, cdt)


def _literal_walk(grad, out, obs, nl):
    """K9b's backward as `csrc/agent_stamp.cu` states it, thread by thread
    and add by add in float32, from `plan`'s cut: an independent statement
    of the order that the vectorised plain backward must repeat."""
    n, h, w, ch = grad.shape
    p = k9b.plan(n, nl, h, w, ch, grad.dtype)
    t_len, hw, n_cells = n // nl, h * w, nl * h * w
    g, o = grad.float().numpy().reshape(t_len, n_cells, ch), out.float().numpy().reshape(t_len, n_cells, ch)
    gm = np.where(o > 0, g, np.float32(0)).astype(np.float32)
    dy = np.zeros((p.ranges, n_cells, ch), np.float32)
    part = np.zeros((p.blocks, 10, ch), np.float32)
    for b in range(p.blocks):
        sums = np.zeros((10, p.cells, ch), np.float32)
        for row in range(p.cells):
            for u in range(b * p.upb, min(b * p.upb + p.upb, p.units)):
                r, k = divmod(u, p.tiles)
                gc = k * p.cells + row
                if gc >= n_cells:
                    continue
                lvl, cy, cx = gc // hw, (gc % hw) // w, gc % w
                d = np.zeros(ch, np.float32)
                for t in range(r * k9b.T_RANGE, min(r * k9b.T_RANGE + k9b.T_RANGE, t_len)):
                    d = d + gm[t, gc]
                    ay, ax = divmod(int(obs[t * nl + lvl]), w)
                    di, dj = ay - cy + 1, ax - cx + 1
                    if 0 <= di < 3 and 0 <= dj < 3:
                        sums[di * 3 + dj, row] = sums[di * 3 + dj, row] + gm[t, gc]
                dy[r, gc] = d
                sums[9, row] = sums[9, row] + d
        s = p.cells // 2
        while s:
            sums[:, :s] = sums[:, :s] + sums[:, s:2 * s]
            s //= 2
        part[b] = sums[:, 0]
    total = np.zeros((10, ch), np.float32)
    for rho in range(k9b.SUM_LANES):
        lane = np.zeros((10, ch), np.float32)
        for m in range(rho, p.blocks, k9b.SUM_LANES):
            lane = lane + part[m]
        total = total + lane
    dy_sum = dy[0]
    if p.ranges > 1:
        dy_sum = np.zeros((n_cells, ch), np.float32)
        for r in range(p.ranges):
            dy_sum = dy_sum + dy[r]
    return dy_sum.reshape(nl, h, w, ch), total[:9].reshape(3, 3, ch), total[9]


def _same_stamp_grads(got, want, cdt):
    dy, dk, dbias = got
    assert torch.equal(dy, torch.from_numpy(want[0]).to(cdt))
    np.testing.assert_array_equal(dk.numpy().view(np.int32), want[1].view(np.int32))
    np.testing.assert_array_equal(dbias.numpy().view(np.int32), want[2].view(np.int32))


# (Nl, T, H, W, C, cdt, the constants changed from the wrapper's): a range
# split, runs of several units a block (a small MAX_BLOCKS), narrower tiles
# (a small MAX_THREADS) and a thread a channel
@pytest.mark.parametrize("nl,t,h,w,ch,cdt,consts", [
    (1, 150, 5, 6, 8, torch.float32, {}),
    (3, 70, 5, 6, 12, torch.bfloat16, {"MAX_BLOCKS": 4}),
    (6, 4, 5, 6, 8, torch.float32, {"MAX_BLOCKS": 3, "MAX_THREADS": 32}),
    (2, 5, 17, 17, 8, torch.bfloat16, {"MAX_BLOCKS": 5, "T_RANGE": 2}),
    (5, 2, 3, 3, 3, torch.float32, {"MAX_BLOCKS": 2, "SUM_LANES": 4}),
    (3, 70, 5, 6, 9, torch.float32, {"MAX_THREADS": 4, "MAX_BLOCKS": 7}),   # three slices of 3 channels
    (2, 5, 5, 6, 10, torch.bfloat16, {"MAX_THREADS": 2}),                  # slices of 4, 4 and 2 channels
])
def test_agent_stamp_backward_order_matches_a_literal_walk(nl, t, h, w, ch, cdt, consts, rng, monkeypatch):
    """The vectorised plain backward equals the kernel's order walked thread
    by thread, bit for bit, also where the cut's constants differ."""
    for name, value in consts.items():
        monkeypatch.setattr(k9b, name, value)
    _, _, _, obs, cot, out = _stamp_case(rng, nl, t, h, w, ch, cdt)
    got = tn.agent_stamp_backward_reference(cot, out.detach(), _t(obs), nl)
    _same_stamp_grads(got, _literal_walk(cot, out.detach(), obs, nl), cdt)


# `plan` at the shapes the tier below MAX_THREADS threads a cell took before
# the channel slices: (N, Nl, H, W, C, dtype) -> (vec, cells, tiles, ranges,
# units, upb, blocks), as the code before the slices computed them; one slice
# of all C channels
@pytest.mark.parametrize("n,nl,h,w,ch,cdt,want", [
    (262_144, 16_384, 9, 9, 32, torch.bfloat16, (8, 32, 41_472, 1, 41_472, 21, 1975)),  # a PPO minibatch
    (65_536, 65_536, 9, 9, 32, torch.bfloat16, (8, 32, 165_888, 1, 165_888, 81, 2048)),  # a rollout step
    (256, 256, 9, 9, 32, torch.float32, (4, 32, 648, 1, 648, 1, 648)),          # DQN's minibatch
    (65_536, 1, 9, 9, 32, torch.bfloat16, (8, 32, 3, 1024, 3072, 2, 1536)),      # a shared level
    (200, 1, 9, 9, 8, torch.float32, (4, 32, 3, 4, 12, 1, 12)),
    (140, 2, 5, 6, 12, torch.bfloat16, (4, 32, 2, 2, 4, 1, 4)),
    (12, 3, 17, 17, 8, torch.float32, (4, 32, 28, 1, 28, 1, 28)),
    (6, 2, 5, 6, 3, torch.bfloat16, (1, 32, 2, 1, 2, 1, 2)),
    (10, 2, 33, 33, 32, torch.float32, (4, 32, 69, 1, 69, 1, 69)),
    (65_536, 4096, 9, 9, 32, torch.float32, (4, 32, 10_368, 1, 10_368, 6, 1728)),
    (64, 16, 9, 9, 256, torch.float32, (4, 4, 324, 1, 324, 1, 324)),
    (64, 16, 9, 9, 255, torch.float32, (1, 1, 1296, 1, 1296, 1, 1296)),          # 255 threads a cell
    (64, 16, 9, 9, 512, torch.float32, (4, 2, 648, 1, 648, 1, 648)),
    (64, 16, 9, 9, 1024, torch.bfloat16, (8, 2, 648, 1, 648, 1, 648)),
    (64, 16, 9, 9, 2048, torch.bfloat16, (8, 1, 1296, 1, 1296, 1, 1296)),        # 256 threads a cell
])
def test_agent_stamp_plan_is_unchanged_below_the_channel_limit(n, nl, h, w, ch, cdt, want):
    p = k9b.plan(n, nl, h, w, ch, cdt)
    assert tuple(p)[:7] == want
    assert (p.slices, p.width) == (1, ch)


@pytest.mark.parametrize("ch", [257, 514, 1031, 1032, 2048, 65_537])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_plan_slices_channels_above_the_limit(ch, cdt):
    """Above MAX_THREADS threads a cell the channels are cut into the fewest
    slices of whole threads, each within MAX_THREADS, the last one no wider
    than the others; a block's rows of cells fit MAX_THREADS."""
    p = k9b.plan(64, 16, 9, 9, ch, cdt)
    threads = ch // p.vec
    assert p.vec == k9b.vector_width(ch, cdt) and p.width % p.vec == 0
    assert p.width // p.vec <= k9b.MAX_THREADS and p.cells * (p.width // p.vec) <= k9b.MAX_THREADS
    assert (p.slices - 1) * p.width < ch <= p.slices * p.width
    assert p.slices == -(-threads // k9b.MAX_THREADS)
    assert (p.slices > 1) == (threads > k9b.MAX_THREADS)
    # the tiles and blocks are those of a slice's width, the same for every slice
    assert p.tiles == -(-16 * 81 // p.cells) and p.units == p.tiles and p.blocks == p.units


@pytest.mark.parametrize("ch", [257, 514])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_backward_above_the_channel_limit(ch, cdt, rng):
    """The fixed-order backward where the kernel cuts the channels into
    slices: float64 sums and autograd as `_hold_stamp_backward` holds them,
    and the order walked thread by thread."""
    nl, t = 2, 70  # two ranges of T_RANGE over two levels
    case = _stamp_case(rng, nl, t, 5, 6, ch, cdt)
    assert k9b.plan(nl * t, nl, 5, 6, ch, cdt).slices == 2
    got = _hold_stamp_backward(*case, nl, cdt)
    _same_stamp_grads(got, _literal_walk(case[4], case[5].detach(), case[3], nl), cdt)


@pytest.mark.parametrize("name,value,changed", [
    ("T_RANGE", 16, "dy_tiles"),    # a range is dy_tiles' first level, and dbias adds the ranges
    ("MAX_BLOCKS", 8, "dk"),        # fewer blocks, longer runs of units each
    ("MAX_THREADS", 64, "dk"),      # a tile of 16 cells, not 32
    ("SUM_LANES", 4, "dk"),         # the second launch's interleave
])
def test_agent_stamp_backward_order_follows_the_wrappers_constants(name, value, changed, rng, monkeypatch):
    """The plain backward reads its cut from `kernels.agent_stamp`: where one
    of the constants the wrapper launches with changes, the bits change
    (and the sums stay the same function)."""
    nl, t, ch, cdt = 4, 80, 32, torch.float32
    y_tiles, k, bias, obs, cot, out = _stamp_case(rng, nl, t, 9, 9, ch, cdt)
    base = tn.agent_stamp_backward_reference(cot, out.detach(), _t(obs), nl)
    monkeypatch.setattr(k9b, name, value)
    moved = _hold_stamp_backward(y_tiles, k, bias, obs, cot, out, nl, cdt)
    names = ("dy_tiles", "dk", "dbias")
    assert not torch.equal(moved[names.index(changed)], base[names.index(changed)])
    assert not torch.equal(moved[2], base[2])  # dbias adds every term of every order


# ---------------------------------------------------------------------------
# Loss gradients against jax.value_and_grad
# ---------------------------------------------------------------------------


def _minibatch(rng, n, num_states=30):
    return dict(
        obs=rng.integers(0, num_states, size=n).astype(np.int32),
        actions=rng.integers(0, 4, size=n).astype(np.int32),
        logp_old=(-1.4 + 0.3 * rng.normal(size=n)).astype(np.float32),
        v_old=rng.normal(size=n).astype(np.float32),
        adv=rng.normal(size=n).astype(np.float32),
        targets=rng.normal(size=n).astype(np.float32),
    )


@pytest.mark.parametrize("vf_clip_eps", [None, 0.3])
def test_ppo_loss_and_gradients_match_jax(vf_clip_eps, rng):
    jnet, tnet = _nets("index", "float32")
    mb = _minibatch(rng, 96)
    cfg = tppo.PPOConfig(vf_clip_eps=vf_clip_eps, compute_dtype="float32")
    jparams = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1,), jnp.int32))

    def jloss(params):  # models/ppo.py `loss_fn`
        logits, values = jnet.apply(params, jnp.asarray(mb["obs"]))
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.sum(logp_all * jax.nn.one_hot(mb["actions"], 4), axis=-1)
        log_ratio = logp - mb["logp_old"]
        ratio = jnp.exp(log_ratio)
        pg = -jnp.mean(jnp.minimum(ratio * mb["adv"], jnp.clip(ratio, 0.8, 1.2) * mb["adv"]))
        if vf_clip_eps is not None:
            v_clip = mb["v_old"] + jnp.clip(values - mb["v_old"], -vf_clip_eps, vf_clip_eps)
            vf = jnp.mean(jnp.maximum((mb["targets"] - values) ** 2, (mb["targets"] - v_clip) ** 2))
        else:
            vf = jnp.mean((mb["targets"] - values) ** 2)
        entropy = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
        return pg + 0.5 * vf - 0.01 * entropy, jnp.mean((ratio - 1.0) - log_ratio)

    (jl, jkl), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    live = ta2c.leaves(convert.to_network_state(tree_np(jparams), tnet))
    loss, kl = tppo.ppo_loss(tnet, live, tuple(_t(mb[k]) for k in mb), None, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-4, atol=1e-7)
    grads = ta2c.grads_of(loss, live)
    want = convert.to_network_state(tree_np(jgrads), tnet)
    for name in want:
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("family", ["index", "conv"])
def test_a2c_loss_and_gradients_match_jax(family, rng):
    jnet, tnet = _nets(family, "float32")
    t, b = 6, 16
    obs = rng.integers(0, 30, size=(t, b)).astype(np.int32)
    actions = rng.integers(0, 4, size=(t, b)).astype(np.int32)
    returns = rng.normal(size=(t, b)).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(6), jnp.zeros((1,), jnp.int32))

    def jloss(params):  # models/a2c.py `loss_fn`
        logits, values = jnet.apply(params, jnp.asarray(obs))
        logp = jax.nn.log_softmax(logits)
        logp_a = jnp.sum(logp * jax.nn.one_hot(actions, 4), axis=-1)
        adv = jax.lax.stop_gradient(returns - values)
        entropy = -jnp.mean(jnp.sum(jnp.exp(logp) * logp, axis=-1))
        return -jnp.mean(logp_a * adv) + 0.5 * jnp.mean((returns - values) ** 2) - 0.01 * entropy

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    live = ta2c.leaves(convert.to_network_state(tree_np(jparams), tnet))
    traj = ta2c.Trajectory(_t(obs), _t(actions), None, None, None, None)
    loss = ta2c.a2c_loss(tnet, live, None, traj, _t(returns), ta2c.A2CConfig(compute_dtype="float32"))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = ta2c.grads_of(loss, live)
    want = convert.to_network_state(tree_np(jgrads), tnet)
    for name in want:
        np.testing.assert_allclose(grads[name].numpy(), want[name].numpy(), rtol=1e-4, atol=2e-7, err_msg=name)


# ---------------------------------------------------------------------------
# Optimizer against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["constant", "linear"])
def test_clip_and_adam_match_optax(schedule, rng):
    jnet, tnet = _nets("index", "float32")
    jparams = jnet.init(jax.random.PRNGKey(7), jnp.zeros((1,), jnp.int32))
    lr = j_make_lr(3e-3, schedule, 4 if schedule == "linear" else None, 0.1, "lr_decay_updates")
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr))
    jstate = tx.init(jparams)
    params = convert.to_network_state(tree_np(jparams), tnet)
    state = convert.to_adam_state(tree_np_state(jstate), tnet)
    rate = topt.make_lr(3e-3, schedule, 4 if schedule == "linear" else None, 0.1, "lr_decay_updates")
    norms = []
    for step in range(5):
        # alternate a gradient far above the clip norm with one far below it
        scale = 3.0 if step % 2 == 0 else 1e-3
        jgrads = jax.tree.map(lambda x: jnp.asarray(scale * rng.normal(size=x.shape), jnp.float32), jparams)
        norms.append(float(optax.global_norm(jgrads)))
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = topt.clip_by_global_norm(convert.to_network_state(tree_np(jgrads), tnet), 0.5)
        params, state = topt.adam_update(params, grads, state, rate)
        want = convert.to_network_state(tree_np(jparams), tnet)
        tol = 1e-6 if schedule == "constant" else 2e-5
        for name in want:
            np.testing.assert_allclose(params[name].numpy(), want[name].numpy(), rtol=tol, atol=1e-8, err_msg=name)
    assert max(norms) > 0.5 > min(norms)
    assert int(state.count) == 5
    back = convert.to_adam_state(tree_np_state(jstate), tnet)
    assert int(back.count) == 5
    for name in back.mu:
        np.testing.assert_allclose(state.mu[name].numpy(), back.mu[name].numpy(), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(state.nu[name].numpy(), back.nu[name].numpy(), rtol=1e-5, atol=1e-12)


def tree_np_state(opt_state):
    """optax's state with numpy leaves (its namedtuples are kept)."""
    return jax.tree.map(np.asarray, opt_state)


def test_make_lr_errors_and_keep_where():
    with pytest.raises(ValueError, match="lr_decay_updates"):
        topt.make_lr(1e-3, "linear", None, 0.0, "lr_decay_updates")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        topt.make_lr(1e-3, "cosine", 4, 0.0, "lr_decay_updates")
    rate = topt.make_lr(1e-2, "linear", 10, 0.5, "x")
    got = [float(rate(torch.tensor(c, dtype=torch.int32))) for c in (0, 5, 10, 50)]
    want = [float(optax.linear_schedule(1e-2, 5e-3, 10)(c)) for c in (0, 5, 10, 50)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    p = {"w": torch.ones(3)}
    s0 = topt.adam_init(p)
    p1, s1 = topt.adam_update(p, {"w": torch.ones(3)}, s0, lambda c: 0.1)
    frozen_p, frozen_s = topt.keep_where(torch.tensor(False), p1, p), topt.keep_where(torch.tensor(False), s1, s0)
    assert torch.equal(frozen_p["w"], p["w"]) and int(frozen_s.count) == 0
    assert torch.equal(frozen_s.mu["w"], s0.mu["w"])
    kept = topt.keep_where(torch.tensor(True), s1, s0)
    assert int(kept.count) == 1 and torch.equal(kept.nu["w"], s1.nu["w"])


def test_initialisers_have_flax_scales():
    net = tn.ActorCritic(num_states=256, num_actions=4, hidden=(64, 64), embed_dim=16, seed=3, device=CPU)
    sd = net.state_dict()
    assert abs(float(sd["embed"].std()) - 0.25) < 0.02  # normal(1/sqrt(embed_dim))
    assert abs(float(sd["dense_1.weight"].std()) - 1 / 8) < 0.01  # lecun_normal, fan_in 64
    assert float(sd["dense_1.weight"].abs().max()) <= 2 / 0.87962566 / 8 + 1e-6  # truncated at 2 sigma
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("bias"))
    again = tn.ActorCritic(num_states=256, num_actions=4, hidden=(64, 64), embed_dim=16, seed=3, device=CPU)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    fresh = ta2c.init_network_params(net, 4)
    assert set(fresh) == set(sd) and not torch.equal(fresh["embed"], sd["embed"])
    conv = tn.ConvActorCritic(height=5, width=6, grid=GRID.reshape(-1), num_actions=4, channels=(32, 32), device=CPU)
    assert abs(float(conv.state_dict()["conv_1.weight"].std()) - 1 / np.sqrt(9 * 32)) < 0.005
    assert list(conv.state_dict()) == ["conv_0_kernel", "conv_0_bias", "conv_1.weight", "conv_1.bias",
                                       "dense_0.weight", "dense_0.bias", "policy_head.weight",
                                       "policy_head.bias", "value_head.weight", "value_head.bias"]
