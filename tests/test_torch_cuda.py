"""The CUDA kernels K1–K7, K9 and K10 against their plain PyTorch versions.

These tests need a CUDA card and the CUDA toolkit (`nvcc`); without a card
they skip. This file imports no JAX, so it also runs on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

import griduniverse_tpu_torch as T
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.algos import dp_batched, td, td_batched, td_fast
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.models import a2c, networks, ppo
from griduniverse_tpu_torch.levels import maze as M
from griduniverse_tpu_torch.ops import bitplane as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _levels(dev):
    walls = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    grids, start = M.generate_mazes_device(4, (4, 4), 1024, "binary_tree", device=dev)
    mazes = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(1024).contiguous()))
    return {"walls16": walls, "mazes": mazes}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", [(False, None), (True, None), (True, 32)])
def test_rollout_actions_kernel_matches_plain(dev, mode):
    sem = T.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        actions = torch.randint(-2, 6, (300, 1024), generator=gen, device=dev, dtype=torch.int32)
        before = kernels.LAUNCHES["rollout_actions_bits"]
        got_state, got = bp.rollout_actions_bits(sem, bl, st, actions, *mode)
        assert kernels.LAUNCHES["rollout_actions_bits"] == before + 1
        ref_state, ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, *mode)
        _assert_same(got, ref)
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got_state, f), getattr(ref_state, f))


def test_random_scan_kernel_matches_plain(dev):
    sem = T.make_semantics(device=dev)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        rs = bp.xorshift_init(9, (1024,), device=dev)
        before = kernels.LAUNCHES["random_scan_bits"]
        got = bp.random_scan_bits(sem, bl, st, rs, None, 700, 100)
        assert kernels.LAUNCHES["random_scan_bits"] == before + 1
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 700, 100)
        _assert_same(got[1:], ref[1:])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got[0], f), getattr(ref[0], f))


@pytest.mark.parametrize("cells,max_iters", [((4, 4), 3000), ((5, 5), 20), ((16, 16), None)])
def test_aldous_broder_kernel_matches_plain(dev, cells, max_iters):
    b = 256
    before = kernels.LAUNCHES["aldous_broder_mazes"]
    got = M._aldous_broder_mazes(cells, b, max_iters, seed=3, device=dev)
    assert kernels.LAUNCHES["aldous_broder_mazes"] == before + 1
    assert torch.equal(got, M.aldous_broder_mazes_reference(cells, b, max_iters, seed=3, device=dev))
    if max_iters is not None:
        dirs = torch.randint(0, 4, (max_iters, b), device=dev, dtype=torch.int8)
        got = M._aldous_broder_mazes(cells, b, max_iters, directions=dirs)
        assert torch.equal(got, M.aldous_broder_mazes_reference(cells, b, max_iters, directions=dirs))
    assert all(M.check_perfect_maze(g, cells) for g in got.cpu())


def test_wrappers_raise_on_bad_input(dev):
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    st = bp.reset_bits(bl, 8)
    with pytest.raises(ValueError):
        bp.random_scan_bits(sem, bl, st, bp.xorshift_init(0, (8,), device=dev).long(), None, 5, None)
    with pytest.raises(ValueError):
        bp.rollout_actions_bits(sem, bl, st, torch.zeros((5, 8), dtype=torch.int32), True)
    with pytest.raises(ValueError):
        M._aldous_broder_mazes((17, 16), 4, 10, device=dev)


def _maze_levels(dev, cells, n, seed=5):
    grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder", device=dev)
    return T.Level(grid=grids, start_idx=start.expand(n).contiguous())


@pytest.mark.parametrize("cells,n", [((4, 4), 256), ((8, 8), 64), ((1, 1), 3)])
def test_grid_vi_and_pi_kernel_match_plain(dev, cells, n):
    sem = T.make_semantics(device=dev)
    levels = _maze_levels(dev, cells, n)
    before = kernels.LAUNCHES["dp_grid"]
    v, pol, iters = dp_batched.value_iteration_batched_grid(sem, levels)
    assert kernels.LAUNCHES["dp_grid"] > before
    v_ref, pol_ref, iters_ref = dp_batched.value_iteration_batched_grid_reference(sem, levels)
    assert iters == iters_ref
    _assert_same((v, pol), (v_ref, pol_ref))
    # a cap that falls inside a launch, and one on a launch boundary
    for cap in (5, dp_batched.SWEEPS_PER_LAUNCH):
        got = dp_batched.value_iteration_batched_grid(sem, levels, max_iters=cap)
        ref = dp_batched.value_iteration_batched_grid_reference(sem, levels, max_iters=cap)
        assert got[2] == ref[2]
        _assert_same(got[:2], ref[:2])
    got = dp_batched.policy_iteration_batched_grid(sem, levels, gamma=0.95)
    ref = dp_batched.policy_iteration_batched_grid_reference(sem, levels, gamma=0.95)
    assert got[2] == ref[2]
    _assert_same(got[:2], ref[:2])


def _fast_fields(ts):
    st = ts.env_state
    return (ts.q, st.agent_idx, st.agent_code, st.t, ts.rs, ts.run_ret, ts.n_eps_env, ts.ret_sum_env)


@pytest.mark.parametrize("algo", td_fast.ALGOS)
def test_td_scan_fast_kernel_matches_plain(dev, algo):
    sem = T.make_semantics(device=dev)
    for bl in _levels(dev).values():
        ts = td_fast.fast_td_init(sem, bl, 3, None if bl.batched else 1024)
        kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=64)
        before = kernels.LAUNCHES["td_scan_fast"]
        got = td_fast.td_scan_fast(sem, bl, ts, 300, **kw)
        # one step kernel a step, and the kernel that applies the last aggregate
        assert kernels.LAUNCHES["td_scan_fast"] == before + 300 + 1
        ref = td_fast.td_scan_fast_reference(sem, bl, ts, 300, **kw)
        _assert_same(_fast_fields(got), _fast_fields(ref))
        # chunked equals unbroken, and a second run repeats the bits
        half = td_fast.td_scan_fast(sem, bl, td_fast.td_scan_fast(sem, bl, ts, 100, **kw), 200, **kw)
        _assert_same(_fast_fields(half), _fast_fields(got))
        _assert_same(_fast_fields(td_fast.td_scan_fast(sem, bl, ts, 300, **kw)), _fast_fields(got))


def _batched_fields(res):
    st = res.state
    q = st.q.view(torch.int16) if st.q.dtype == torch.bfloat16 else st.q
    return (q, st.env_state.agent_idx, st.env_state.agent_code, st.env_state.t, st.a, st.rs,
            st.run_ret, st.n_eps_env, st.ret_sum_env, res.episodes, res.mean_return)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", td_batched.ALGOS)
def test_td_batched_kernel_matches_plain(dev, algo, dtype):
    sem = T.make_semantics(device=dev)
    n, steps = 256, 300
    levels = _maze_levels(dev, (3, 3), n)
    kw = dict(alpha=0.2, epsilon=0.2, algo=algo, max_episode_steps=40, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    draws = (
        torch.rand((steps, n), generator=gen, device=dev) < 0.2,
        torch.randint(0, 4, (steps, n), generator=gen, device=dev, dtype=torch.int32),
        torch.rand((n,), generator=gen, device=dev) < 0.2,
        torch.randint(0, 4, (n,), generator=gen, device=dev, dtype=torch.int32),
    )
    for d in (None, draws):
        before = kernels.LAUNCHES["td_batched"]
        got = td_batched.q_learning_batched(sem, levels, 7, steps, draws=d, **kw)
        assert kernels.LAUNCHES["td_batched"] == before + 1
        ref = td_batched.q_learning_batched_reference(sem, levels, 7, steps, draws=d, **kw)
        _assert_same(_batched_fields(got), _batched_fields(ref))
    h1 = td_batched.q_learning_batched(sem, levels, 7, 100, **kw)
    h2 = td_batched.q_learning_batched(sem, levels, 7, 200, state0=h1.state, **kw)
    full = td_batched.q_learning_batched(sem, levels, 7, 300, **kw)
    _assert_same(_batched_fields(h2), _batched_fields(full))


@pytest.mark.parametrize("b", [1, 32, 4096])
def test_segment_mean_kernel_matches_plain(dev, b):
    gen = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn((256, 4), generator=gen, device=dev)
    # heavy collisions: most envs in a handful of cells
    s = torch.randint(0, 6, (b,), generator=gen, device=dev, dtype=torch.int32)
    s[::7] = torch.randint(0, 256, (len(s[::7]),), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)
    mask = torch.rand((b,), generator=gen, device=dev) < 0.5
    before = kernels.LAUNCHES["segment_mean"]
    got = td.apply_td_updates(q, s, a, delta, 0.1)
    got_m = td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)
    assert kernels.LAUNCHES["segment_mean"] == before + 2
    _assert_same((got,), (td.apply_td_updates_reference(q, s, a, delta, 0.1),))
    _assert_same((got_m,), (td.apply_td_updates_reference(q, s, a, delta, 0.1, mask),))
    if b == 1:
        want = q.clone()
        want[s[0].item(), a[0].item()] += 0.1 * delta[0]
        _assert_same((got,), (want,))


def test_td_run_on_cuda_is_chunk_invariant(dev):
    sem = T.make_semantics(device=dev)
    level = builders.lava_level(device=dev)
    ts = td.td_init(sem, level, 4, 64, 0.2)
    full = td.td_run(sem, level, ts, 60, 0.2, 0.99, 0.2, "sarsa")
    half = td.td_run(sem, level, td.td_run(sem, level, ts, 30, 0.2, 0.99, 0.2, "sarsa"), 30, 0.2, 0.99, 0.2, "sarsa")
    _assert_same((full.q, full.rs, full.ret_sum), (half.q, half.rs, half.ret_sum))
    assert int(full.episodes) == int(half.episodes)


def test_solver_wrappers_raise_on_bad_input(dev):
    sem = T.make_semantics(device=dev)
    levels = _maze_levels(dev, (2, 2), 4)
    with pytest.raises(ValueError):
        dp_batched.value_iteration_batched_grid(sem, T.Level(levels.grid.long(), levels.start_idx))
    q = torch.zeros((25, 4), device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        td.apply_td_updates(q, idx.long(), idx, torch.zeros(8, device=dev), 0.1)
    with pytest.raises(ValueError):
        td.apply_td_updates(q, idx, idx, torch.zeros(8, device="cpu"), 0.1)
    big = bp.pack_level(T.make_level(torch.zeros((60, 60), dtype=torch.int32).numpy(), 0, device=dev))
    with pytest.raises(ValueError):
        td_fast.fast_td_init(sem, big, 0, 8) and td_fast.compile_q_learning_fast(sem, big, 8, 1)(0)


# ---------------------------------------------------------------------------
# The neural learners' kernels: K7a, K7b, K9a, K9b
# ---------------------------------------------------------------------------


def test_gae_and_nstep_kernels_match_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    t, b = 12, 4096
    value = torch.randn((t, b), generator=gen, device=dev)
    reward = torch.randn((t, b), generator=gen, device=dev)
    done = torch.rand((t, b), generator=gen, device=dev) < 0.25
    bootstrap = torch.randn((b,), generator=gen, device=dev)
    traj = a2c.Trajectory(None, None, None, value, reward, done)
    before = kernels.LAUNCHES["gae"]
    got = ppo.gae_advantages(traj, bootstrap, 0.99, 0.95)
    ret = a2c.nstep_returns(reward, done, bootstrap, 0.99)
    assert kernels.LAUNCHES["gae"] == before + 2
    _assert_same(got, ppo.gae_advantages_reference(traj, bootstrap, 0.99, 0.95))
    _assert_same((ret,), (a2c.nstep_returns_reference(reward, done, bootstrap, 0.99),))
    with pytest.raises(ValueError):
        ppo.gae_advantages(a2c.Trajectory(None, None, None, value, reward, done.int()), bootstrap, 0.99, 0.95)


def logp_within_2ulp(got, ref):
    return bool(((got - ref).abs() <= 2 * 2.0 ** -23 * ref.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("max_ep", [None, 64])
def test_act_step_and_greedy_step_kernels_match_plain(dev, max_ep):
    sem = T.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        ref_st = st
        gst, reached = st, torch.zeros(1024, dtype=torch.bool, device=dev)
        ref_gst, ref_reached = gst, reached
        for _ in range(100):
            logits = 2 * torch.randn((1024, 4), generator=gen, device=dev)
            noise = a2c.draw_gumbel(gen, (1024, 4), dev)
            before = kernels.LAUNCHES["act_step"]
            st, *got = a2c.act_step(sem, bl, st, logits, noise, max_ep)
            gst, reached = a2c.greedy_step(sem, bl, gst, reached, logits)
            assert kernels.LAUNCHES["act_step"] == before + 2
            ref_st, *ref = a2c.act_step_reference(sem, bl, ref_st, logits, noise, max_ep)
            ref_gst, ref_reached = a2c.greedy_step_reference(sem, bl, ref_gst, ref_reached, logits)
            action, logp, obs, reward, done = got
            _assert_same((action, obs, reward, done), (ref[0], ref[2], ref[3], ref[4]))
            assert logp_within_2ulp(logp, ref[1])
            assert torch.equal(reached, ref_reached)
            for f in ("agent_idx", "agent_code", "t", "done"):
                assert torch.equal(getattr(st, f), getattr(ref_st, f))
                assert torch.equal(getattr(gst, f), getattr(ref_gst, f))


@pytest.mark.parametrize("s,e", [(256, 16), (4225, 64)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_embed_rows_kernel_matches_plain(dev, s, e, cdt):
    gen = torch.Generator(device=dev).manual_seed(s)
    n = 5000
    table = torch.randn((s, e), generator=gen, device=dev, requires_grad=True)
    obs = torch.randint(0, 9, (n,), generator=gen, device=dev, dtype=torch.int32)  # heavy collisions
    obs[::5] = torch.randint(0, s, (len(obs[::5]),), generator=gen, device=dev, dtype=torch.int32)
    before = kernels.LAUNCHES["embed_rows"]
    out = networks.embed_rows(table, obs, cdt)
    assert kernels.LAUNCHES["embed_rows"] == before + 1
    assert torch.equal(out, networks.embed_rows_reference(table, obs, cdt))
    g = torch.randn((n, e), generator=gen, device=dev).to(cdt)
    (grad,) = torch.autograd.grad(out, table, g)
    assert kernels.LAUNCHES["embed_rows"] == before + 3
    _assert_same((grad,), (networks.embed_rows_backward_reference(g, obs, s),))
    (auto,) = torch.autograd.grad(networks.embed_rows_reference(table, obs, cdt), table, g)
    torch.testing.assert_close(grad, auto, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nl,ch", [(1, 16), (512, 32)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_kernel_matches_plain(dev, nl, ch, cdt):
    gen = torch.Generator(device=dev).manual_seed(nl)
    h, w, t = 9, 9, 4
    n = nl * t
    y_tiles = torch.randn((nl, h, w, ch), generator=gen, device=dev).to(cdt).requires_grad_(True)
    k = torch.randn((3, 3, ch), generator=gen, device=dev, requires_grad=True)
    bias = torch.randn((ch,), generator=gen, device=dev, requires_grad=True)
    obs = torch.randint(0, h * w, (n,), generator=gen, device=dev, dtype=torch.int32)
    cot = torch.randn((n, h, w, ch), generator=gen, device=dev).to(cdt)
    before = kernels.LAUNCHES["agent_stamp"]
    out = networks.agent_stamp(y_tiles, k, bias, obs)
    assert kernels.LAUNCHES["agent_stamp"] == before + 1
    ref = networks.agent_stamp_reference(y_tiles, k, bias, obs)
    assert torch.equal(out, ref)
    grads = torch.autograd.grad(out, (y_tiles, k, bias), cot)
    assert kernels.LAUNCHES["agent_stamp"] == before + 4
    again = torch.autograd.grad(networks.agent_stamp(y_tiles, k, bias, obs), (y_tiles, k, bias), cot)
    for a, b in zip(grads, again):  # the same bits on every run
        assert torch.equal(a, b)
    _assert_same(grads, networks.agent_stamp_backward_reference(cot, out.detach(), obs, nl))
    auto = torch.autograd.grad(ref, (y_tiles, k, bias), cot)
    # autograd sums in another order (and dy_tiles in the compute dtype)
    tol = dict(rtol=2e-2, atol=2e-1) if cdt == torch.bfloat16 else dict(rtol=1e-4, atol=1e-3)
    for a, b in zip(grads, auto):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_ppo_and_a2c_on_cuda_are_chunk_invariant(dev):
    sem = T.make_semantics(device=dev)
    level = builders.lava_level(device=dev)
    cfg = ppo.PPOConfig(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16,
                        num_epochs=2, num_minibatches=2, target_kl=0.02)
    ts0 = ppo.ppo_init(sem, level, 3, cfg, 64)
    full = ppo.ppo_run(sem, level, ts0, cfg, 6)
    half = ppo.ppo_run(sem, level, ppo.ppo_run(sem, level, ts0, cfg, 3), cfg, 3)
    for name in full.params:
        assert torch.equal(full.params[name], half.params[name])
        assert torch.equal(full.opt_state.nu[name], half.opt_state.nu[name])
    assert torch.equal(full.env_state.agent_idx, half.env_state.agent_idx)
    grids, start = M.generate_mazes_device(5, (2, 2), 64, "aldous_broder", device=dev)
    mazes = T.Level(grid=grids, start_idx=start.expand(64).contiguous())
    acfg = a2c.A2CConfig(rollout_len=4, max_episode_steps=16, obs="grid", conv_channels=(8, 8), hidden=(16,))
    ts0 = a2c.a2c_init(sem, mazes, 4, acfg)
    full = a2c.a2c_run(sem, mazes, ts0, acfg, 4)
    half = a2c.a2c_run(sem, mazes, a2c.a2c_run(sem, mazes, ts0, acfg, 2), acfg, 2)
    for name in full.params:
        assert torch.equal(full.params[name], half.params[name])
    assert int(full.opt_state.count) == 4 and float(full.last_loss) == float(half.last_loss)
