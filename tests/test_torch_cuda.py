"""The CUDA kernels K1–K13, P1 and P2 against their plain PyTorch versions.

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
from griduniverse_tpu_torch.algos import dp_batched, td, td_batched, td_fast, td_lambda
from griduniverse_tpu_torch.kernels import act_step as act_kernels
from griduniverse_tpu_torch.kernels import agent_stamp as stamp_kernels
from griduniverse_tpu_torch.kernels import dqn_act as dqn_act_kernels
from griduniverse_tpu_torch.kernels import embed_rows as embed_kernels
from griduniverse_tpu_torch.kernels import replay as replay_kernels
from griduniverse_tpu_torch.kernels import segment_mean as k10
from griduniverse_tpu_torch.kernels import td_batched as td_batched_kernels
from griduniverse_tpu_torch.kernels import td_fast as td_fast_kernels
from griduniverse_tpu_torch.kernels import trace_pass as trace_kernels
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.models import a2c, dqn, networks, ppo
from griduniverse_tpu_torch.levels import maze as M
from griduniverse_tpu_torch.ops import bitplane as bp
from griduniverse_tpu_torch.tools import gather_probe
from griduniverse_tpu_torch.utils import capture

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


def _k10_launches(dev, batch, n_seg):
    """Kernels a K10 call launches: 1 where the plan takes a cluster, 4 for the passes."""
    return k10.call_plan(batch, n_seg, dev).launches


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


@pytest.mark.parametrize("b", [1, 33, 1024, 4096, 65_536])
def test_random_scan_kernel_matches_plain(dev, b):
    """K1 at batches from one warp-block to the one-wave limit's half, on a
    shared level and on per-env 4x4 mazes (their warps staged), with a
    time limit."""
    sem = T.make_semantics(device=dev)
    grids, start = M.generate_mazes_device(4, (4, 4), b, "binary_tree", device=dev)
    mazes = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    for bl in (_levels(dev)["walls16"], mazes):
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(9, (b,), device=dev)
        before = kernels.LAUNCHES["random_scan_bits"]
        got = bp.random_scan_bits(sem, bl, st, rs, None, 700, 100)
        assert kernels.LAUNCHES["random_scan_bits"] == before + 1
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 700, 100)
        _assert_same(got[1:], ref[1:])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got[0], f), getattr(ref[0], f))


@pytest.mark.parametrize("tier", ["planned", "device"])
@pytest.mark.parametrize("a", [4, 9, 25])
@pytest.mark.parametrize("b", [33, 4096, 65_536])
def test_random_scan_kernel_matches_plain_over_33x33_mazes(dev, monkeypatch, b, a, tier):
    """K1 over per-env 33x33 mazes (69 words a level) in both streams and
    both tiers: as `plan` picks them (staged in shared memory in one-warp
    blocks, 8,832 bytes; at 65,536 read through L1, since a block of eight
    warps would stage 70,656 bytes, above STAGE_BYTES), and read through L1
    (the plan forced); no time limit and one."""
    from griduniverse_tpu_torch.kernels import rollout as rollout_kernels

    plan = rollout_kernels.plan
    if tier == "device":
        monkeypatch.setattr(rollout_kernels, "plan", lambda *args: plan(*args)._replace(
            level=rollout_kernels.LEVEL_DEVICE, shared=0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one_warp_blocks = b <= sms * rollout_kernels.SCHEDULERS * rollout_kernels.WARP
    assert plan(b, 69, True, a, sms).level == (
        rollout_kernels.LEVEL_STAGED if one_warp_blocks else rollout_kernels.LEVEL_DEVICE)
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    grids, start = M.generate_mazes_device(5, (16, 16), b, "aldous_broder", device=dev)
    bl = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    st = bp.reset_bits(bl)
    for rng, keys, max_ep in (("xorshift", None, None), ("threefry", bp.threefry_keys(3, step=5, offset=7), 90)):
        rs = bp.xorshift_init(2, (b,), device=dev) if rng == "xorshift" else None
        got = bp.random_scan_bits(sem, bl, st, rs, keys, 400, max_ep, rng)
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 400, max_ep, rng, keys)
        _assert_same(got[1:], ref[1:])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(got[0], f), getattr(ref[0], f))


@pytest.mark.parametrize("split", [1, 8, 333])
def test_random_scan_kernel_two_chunks_equal_one_run(dev, split):
    """K1's xorshift form in two chunks (the second from the first's state
    and the states drawn on, as `td_run`-style callers chunk a scan) equals
    one run, mid-episode, across a block of eight draws and its tail."""
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    st = bp.reset_bits(bl, 4096)
    rs = bp.xorshift_init(4, (4096,), device=dev)
    one = bp.random_scan_bits(sem, bl, st, rs, None, 1000, 64)
    first = bp.random_scan_bits(sem, bl, st, rs, None, split, 64)
    rs_mid = rs
    for _ in range(split):
        rs_mid = bp.xorshift_next(rs_mid)[0]
    second = bp.random_scan_bits(sem, bl, first[0], rs_mid, None, 1000 - split, 64)
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert torch.equal(getattr(one[0], f), getattr(second[0], f))
    _assert_same((one[1], one[3]), (first[1] + second[1], first[3] + second[3]))


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
    with pytest.raises(ValueError):  # a maze needs a cell each way
        M._aldous_broder_mazes((0, 4), 4, 10, device=dev)


def _maze_levels(dev, cells, n, seed=5):
    grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder", device=dev)
    return T.Level(grid=grids, start_idx=start.expand(n).contiguous())


@pytest.mark.parametrize("cells,n", [((4, 4), 256), ((8, 8), 64), ((1, 1), 3),
                                     # three 9x9 mazes a block: the last block partial or full
                                     ((4, 4), 1), ((4, 4), 2), ((4, 4), 3), ((4, 4), 4), ((4, 4), 257),
                                     ((16, 16), 33)])  # 33x33: several cells a thread
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


def _plain_sweeps(sem, grids, v, policy, k):
    backup = dp_batched._grid_backup(sem, grids, 0.99)
    maxima = []
    for _ in range(k):
        q = backup(v)
        new = q.max(dim=-1).values if policy is None else q.gather(2, policy.long()[:, :, None])[:, :, 0]
        maxima.append((new - v).abs().max())
        v = new
    return v, torch.stack(maxima)


@pytest.mark.parametrize("cells,n,lava,actions", [
    ((4, 4), 257, 0.1, 4),     # registers, three mazes a block
    ((4, 4), 100, 0.1, 8),     # eight actions
    ((8, 8), 65, 0.1, 4),      # a table of decoded actions, two cells a thread
    ((16, 16), 9, 0.1, 5),     # five actions, a table
    ((32, 32), 3, 0.05, 4),    # a word a cell, 17 cells a thread
    ((63, 63), 2, 0.0, 4),     # 16,129 cells, 64 a thread
])
def test_grid_sweeps_kernel_maxima_and_changed_match_plain(dev, cells, n, lava, actions):
    """Each packing of K4's shared tier against the plain sweeps from a
    random V, with lava: V and every sweep's maximum over 1, 5, 16 and 20
    sweeps (two launches), evaluation sweeps of a policy with out-of-range
    actions, the greedy step and its `changed` flag."""
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig
    from griduniverse_tpu_torch.kernels import dp_grid

    deltas = ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1))
    if actions == 5:
        deltas = deltas[:4] + ((0, 0),)
    sem = T.make_semantics(SemanticsConfig(action_deltas=deltas[:actions]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    grids, _ = M.generate_mazes_device(n, cells, n, "aldous_broder", device=dev)
    grids = torch.where((grids == 0) & (torch.rand(grids.shape, generator=gen, device=dev) < lava),
                        torch.full_like(grids, 2), grids).contiguous()
    s = grids.shape[1] * grids.shape[2]
    v0 = torch.rand((n, s), generator=gen, device=dev) * 3
    for k in (1, 5, 16, 20):
        before = kernels.LAUNCHES["dp_grid"]
        got = dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, k)
        assert kernels.LAUNCHES["dp_grid"] - before == -(-k // dp_grid.SWEEPS_A_LAUNCH)
        _assert_same(got, _plain_sweeps(sem, grids, v0, None, k))
    policy = torch.randint(-2, actions + 2, (n, s), generator=gen, device=dev, dtype=torch.int32)
    clamped = torch.where(policy < 0, policy + actions, policy).clamp(0, actions - 1)  # as XLA's gather
    _assert_same(dp_grid.grid_sweeps_cuda(sem, grids, v0, policy, 0.99, 7), _plain_sweeps(sem, grids, v0, clamped, 7))
    want = dp_batched.first_argmax(dp_batched._grid_backup(sem, grids, 0.99)(v0)).to(torch.int32)
    greedy, changed = dp_grid.grid_greedy_cuda(sem, grids, v0, 0.99, clamped)
    assert torch.equal(greedy, want) and int(changed) == int(bool((want != clamped).any()))
    assert int(dp_grid.grid_greedy_cuda(sem, grids, v0, 0.99, want)[1]) == 0
    assert int(dp_grid.grid_greedy_cuda(sem, grids, v0, 0.99, None)[1]) == 0


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
        # one cooperative launch a scan
        assert kernels.LAUNCHES["td_scan_fast"] == before + 1
        ref = td_fast.td_scan_fast_reference(sem, bl, ts, 300, **kw)
        _assert_same(_fast_fields(got), _fast_fields(ref))
        # chunked equals unbroken, and a second run repeats the bits
        half = td_fast.td_scan_fast(sem, bl, td_fast.td_scan_fast(sem, bl, ts, 100, **kw), 200, **kw)
        _assert_same(_fast_fields(half), _fast_fields(got))
        _assert_same(_fast_fields(td_fast.td_scan_fast(sem, bl, ts, 300, **kw)), _fast_fields(got))


def _maze_bits(dev, cells, n, seed=4):
    grids, start = M.generate_mazes_device(seed, cells, n, "binary_tree", device=dev)
    return bp.pack_level(T.Level(grid=grids, start_idx=start.expand(n).contiguous()))


@pytest.mark.parametrize("case", ["777", "777 expected_sarsa", "777 per-env mazes", "two envs a thread",
                                  "three envs a thread", "global tier 300,000"])
def test_td_scan_fast_kernel_matches_plain_at_other_batches(dev, case):
    """Odd batches, per-env levels, more envs than the card holds threads
    (two and three envs a thread of the form that keeps their state in
    global memory), and the global-memory tier: one launch a scan, the
    plain version's bits, chunked equal to unbroken, and two runs the
    same."""
    sem = T.make_semantics(device=dev)
    algo = "expected_sarsa" if "expected" in case else "q_learning"
    bl = _levels(dev)["walls16"]
    steps, b = 120, 777
    n_entries = bl.num_states * sem.num_actions
    threads = td_fast_kernels.THREADS * td_fast_kernels._resident(dev, n_entries, 1)[1]  # a block an SM
    if "per-env" in case:
        bl = _maze_bits(dev, (4, 4), b)
    elif case == "two envs a thread":
        b, steps = td_fast_kernels._resident(dev, n_entries, 1)[0] * threads + 1_001, 60
    elif case == "three envs a thread":
        b, steps = 2 * td_fast_kernels._resident(dev, n_entries, 0)[0] * threads + 1_001, 30
    elif case == "global tier 300,000":
        bl, b, steps = _one_maze(dev, (32, 32), 6), 300_000, 40
    n_entries = bl.num_states * sem.num_actions
    plan = td_fast_kernels.grid_plan(b, td_fast_kernels._resident(dev, n_entries, 1)[1],
                                     lambda ept: td_fast_kernels._resident(dev, n_entries, ept)[0])
    want_walks = {"two envs a thread": 2, "three envs a thread": 3}.get(case)
    if want_walks is not None:
        assert plan.ept == 0 and plan.walks == want_walks
    elif b == 300_000:
        assert plan.walks > 1
    ts = td_fast.fast_td_init(sem, bl, 3, None if bl.batched else b)
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=16)
    before = kernels.LAUNCHES["td_scan_fast"]
    got = td_fast.td_scan_fast(sem, bl, ts, steps, **kw)
    assert kernels.LAUNCHES["td_scan_fast"] == before + 1
    _assert_same(_fast_fields(got), _fast_fields(td_fast.td_scan_fast_reference(sem, bl, ts, steps, **kw)))
    half = td_fast.td_scan_fast(sem, bl, td_fast.td_scan_fast(sem, bl, ts, steps // 3, **kw), steps - steps // 3, **kw)
    _assert_same(_fast_fields(half), _fast_fields(got))
    _assert_same(_fast_fields(td_fast.td_scan_fast(sem, bl, ts, steps, **kw)), _fast_fields(got))
    assert int(got.n_eps_env.sum()) > 0


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


# K6's layouts: (maze cells, N, whether the global tier is forced, the tier)
_K6_LAYOUTS = {
    "shared N=1": ((4, 4), 1, False, "shared"),
    "shared N=31": ((4, 4), 31, False, "shared"),
    "shared N=161": ((4, 4), 161, False, "shared"),
    "shared N=4097": ((4, 4), 4097, False, "shared"),
    "global, forced": ((4, 4), 777, True, "global"),
    "global 33x33": ((16, 16), 257, False, "global"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", td_batched.ALGOS)
@pytest.mark.parametrize("case", sorted(_K6_LAYOUTS))
def test_td_batched_kernel_matches_plain_in_each_layout(dev, monkeypatch, case, algo, dtype):
    """Native and injected draws against the plain version, and 60 + 60
    steps against 120, in each of K6's tiers (the global tier forced at
    9x9 by patching `plan`)."""
    cells, n, forced, tier = _K6_LAYOUTS[case]
    if forced:
        monkeypatch.setattr(td_batched_kernels, "plan", lambda *_, **__: td_batched_kernels.global_plan(n))
    sem = T.make_semantics(device=dev)
    levels = _maze_levels(dev, cells, n, seed=n)
    assert td_batched_kernels.plan(levels.num_states, sem.num_actions, dtype, n).tier == tier
    steps = 120
    kw = dict(alpha=0.2, epsilon=0.2, algo=algo, max_episode_steps=40, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(n)
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
    h1 = td_batched.q_learning_batched(sem, levels, 7, 60, **kw)
    h2 = td_batched.q_learning_batched(sem, levels, 7, 60, state0=h1.state, **kw)
    _assert_same(_batched_fields(h2), _batched_fields(td_batched.q_learning_batched(sem, levels, 7, steps, **kw)))
    assert int(got.episodes) > 0


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
    assert kernels.LAUNCHES["segment_mean"] == before + 2 * _k10_launches(dev, b, q.numel())
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
    with pytest.raises(ValueError):  # more than the 16,384 packed states K5 steps on
        bp.pack_level(T.make_level(torch.zeros((130, 130), dtype=torch.int32).numpy(), 0, device=dev))
    walls = _levels(dev)["walls16"]
    ts = td_fast.fast_td_init(sem, walls, 0, 8)
    ts.q = ts.q.double()
    with pytest.raises(ValueError):
        td_fast.td_scan_fast(sem, walls, ts, 1, 0.1, 0.99, 0.1, "q_learning", None)


# ---------------------------------------------------------------------------
# The neural learners' kernels: K7a, K7b, K9a, K9b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 12, 16, 33, 128])
@pytest.mark.parametrize("b", [1, 4095, 4096, 4098, 65_536, 65_537])
def test_gae_and_nstep_kernels_match_plain(dev, t, b):
    """K7a at both tiers and every width, and with the done bytes a view
    that starts off a 4-byte boundary (the scalar path)."""
    from griduniverse_tpu_torch.kernels import gae as k7a

    gen = torch.Generator(device=dev).manual_seed(t * b)
    value = torch.randn((t, b), generator=gen, device=dev)
    reward = torch.randn((t, b), generator=gen, device=dev)
    done = torch.rand((t, b), generator=gen, device=dev) < 0.25
    bootstrap = torch.randn((b,), generator=gen, device=dev)
    shifted = torch.zeros(t * b + 1, dtype=torch.bool, device=dev)
    shifted[1:] = done.reshape(-1)
    off = shifted[1:].view(t, b)
    assert off.data_ptr() % 4 != 0 and k7a.plan(t, b, (), off.data_ptr()).width == 1
    for d in (done, off):
        traj = a2c.Trajectory(None, None, None, value, reward, d)
        before = kernels.LAUNCHES["gae"]
        got = ppo.gae_advantages(traj, bootstrap, 0.99, 0.95)
        ret = a2c.nstep_returns(reward, d, bootstrap, 0.99)
        assert kernels.LAUNCHES["gae"] == before + 2
        _assert_same(got, ppo.gae_advantages_reference(traj, bootstrap, 0.99, 0.95))
        _assert_same((ret,), (a2c.nstep_returns_reference(reward, d, bootstrap, 0.99),))
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


@pytest.mark.parametrize("n,offset", [(5000, 0), (1, 0), (1001, 0), (5000, 2)])
@pytest.mark.parametrize("s,e", [(256, 16), (4225, 64), (40, 1), (40, 3), (40, 12), (40, 65)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_embed_rows_kernel_matches_plain(dev, s, e, cdt, n, offset):
    """Forward and backward at the trainers' and the tests' shapes, at widths
    E that allow 16, 8, 4 or 2 bytes a thread, on a table that starts
    `offset` floats into its storage (8 bytes: the 16-byte path falls
    back), one sample and counts that are no multiple of a block."""
    gen = torch.Generator(device=dev).manual_seed(s * e + n + offset)
    base = torch.randn((s * e + offset,), generator=gen, device=dev)
    table = base[offset:].view(s, e).requires_grad_(True)
    assert table.data_ptr() % 16 == 4 * offset % 16
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
    # an index outside [0, S) gives a zero row (the plain version takes none)
    wild = obs.clone()
    wild[::3] = torch.tensor([-1, s, -(1 << 31), s + 7, (1 << 31) - 1], device=dev, dtype=torch.int32).repeat(n)[
        :len(wild[::3])]
    ok = (wild >= 0) & (wild < s)
    want = torch.where(ok[:, None], table.detach()[wild.clamp(0, s - 1).long()], 0.0).to(cdt)
    assert torch.equal(embed_kernels.embed_rows_cuda(table.detach(), wild, cdt), want)


def _shared_tier_limit(e, cdt):
    """The most rows S of a (S, e) table whose backward takes the shared tier."""
    s = 1
    while embed_kernels.uses_shared_tier(s + 1, e, cdt):
        s += 1
    return s


@pytest.mark.parametrize("above", [False, True])
@pytest.mark.parametrize("n", [1, 511, 513, 5000])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_embed_rows_backward_kernel_matches_plain_at_the_shared_limit(dev, above, n, cdt):
    """The backward at the shared tier's largest table and one row above it
    (the global tier): a chunk, less, one more, and several with a partial
    last one, heavy collisions; bit-equal to the fixed-order plain backward."""
    e = 16
    s = _shared_tier_limit(e, cdt) + above
    assert embed_kernels.uses_shared_tier(s, e, cdt) is not above
    gen = torch.Generator(device=dev).manual_seed(n)
    obs = torch.randint(0, 9, (n,), generator=gen, device=dev, dtype=torch.int32)  # heavy collisions
    obs[::5] = torch.randint(0, s, (len(obs[::5]),), generator=gen, device=dev, dtype=torch.int32)
    obs[-1] = s - 1  # the last row
    g = torch.randn((n, e), generator=gen, device=dev).to(cdt)
    before = kernels.LAUNCHES["embed_rows"]
    got = embed_kernels.embed_rows_backward_cuda(g, obs, s)
    assert kernels.LAUNCHES["embed_rows"] == before + 2
    _assert_same((got,), (networks.embed_rows_backward_reference(g, obs, s),))


@pytest.mark.parametrize("nl,t,h,w,ch", [
    (1, 4, 9, 9, 16), (512, 4, 9, 9, 32),
    (1, 200, 9, 9, 8),      # Nl = 1, the level's samples split over four ranges
    (256, 1, 9, 9, 32),     # Nl = N: a rollout step, DQN's minibatch
    (3, 70, 5, 6, 12),      # two ranges, C = 12 (four channels a thread in bfloat16)
    (3, 4, 17, 17, 8),      # a level above one tile of cells
    (2, 5, 33, 33, 32),     # 33x33
    (2, 3, 5, 6, 3),        # a thread a channel
    (4096, 16, 9, 9, 32),   # several units a block
    # above 256 threads a cell the channels are cut into slices
    (4, 8, 9, 9, 257),      # two slices of a channel a thread
    (1, 100, 9, 9, 514),    # two slices, two ranges of a shared level
    (4, 8, 9, 9, 1032),     # above the forward's 1,024 channels a block; two slices in float32
])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_agent_stamp_kernel_matches_plain(dev, nl, t, h, w, ch, cdt):
    gen = torch.Generator(device=dev).manual_seed(nl * t)
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
    assert kernels.LAUNCHES["agent_stamp"] == before + 1 + stamp_kernels.backward_launches()
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


def _act_plan_case(dev, level_name, b):
    sem = T.make_semantics(device=dev)
    levels = _levels(dev)
    bl = levels[level_name]
    if bl.batched:  # per-env mazes: as many as envs
        grids, start = M.generate_mazes_device(9, (4, 4), b, "binary_tree", device=dev)
        bl = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    return sem, bl, bp.reset_bits(bl, None if bl.batched else b)


@pytest.mark.parametrize("case", ["walls16", "mazes", "odd batch", "unaligned logits"])
def test_act_step_plan_rollout_matches_plain_step_by_step(dev, case):
    """Two rollouts of T = 8 through one plan (the second from the state the
    first left in the plan's slot) and a greedy loop through another,
    against the plain versions chained step by step: one launch a step, the
    rows written in place, every output equal but logp (2 ulp)."""
    b = 777 if case == "odd batch" else 1024
    sem, bl, st = _act_plan_case(dev, "mazes" if case == "mazes" else "walls16", b)
    t_len, max_ep = 8, 12
    plan = act_kernels.ActStepPlan(sem, bl, b, t_len, max_ep)
    gen = torch.Generator(device=dev).manual_seed(5)
    ref_st = st
    for _ in range(2):
        gumbel = a2c.draw_gumbel(gen, (t_len, b, 4), dev)
        plan.begin(st, gumbel)
        refs = []
        for t in range(t_len):
            logits = 2 * torch.randn((b, 4), generator=gen, device=dev)
            if case == "unaligned logits":  # the kernel's scalar loads
                logits = torch.cat([torch.zeros(1, device=dev), logits.reshape(-1)])[1:].view(b, 4)
            before = kernels.LAUNCHES["act_step"]
            st = plan.step(t, logits)
            assert kernels.LAUNCHES["act_step"] == before + 1
            ref_st, *ref = a2c.act_step_reference(sem, bl, ref_st, logits, gumbel[t], max_ep)
            refs.append(ref)
            for f in ("agent_idx", "agent_code", "t", "done"):
                assert torch.equal(getattr(st, f), getattr(ref_st, f)), f
        obs, action, logp, reward, done = plan.rows
        for t, (r_action, r_logp, r_obs, r_reward, r_done) in enumerate(refs):
            _assert_same((action[t], obs[t], reward[t], done[t]), (r_action, r_obs, r_reward, r_done))
            assert logp_within_2ulp(logp[t], r_logp)
    assert int(done.sum()) > 0
    greedy = act_kernels.ActStepPlan(sem, bl, b, 0, None)
    gst = ref_gst = bp.reset_bits(bl, None if bl.batched else b)
    reached = ref_reached = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(30):
        logits = torch.randn((b, 4), generator=gen, device=dev)
        gst, reached = a2c.greedy_step(sem, bl, gst, reached, logits, greedy)
        ref_gst, ref_reached = a2c.greedy_step_reference(sem, bl, ref_gst, ref_reached, logits)
        assert torch.equal(reached, ref_reached)
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(gst, f), getattr(ref_gst, f)), f


def test_act_step_plan_allocates_nothing_a_step(dev):
    sem, bl, st = _act_plan_case(dev, "walls16", 4096)
    plan = act_kernels.ActStepPlan(sem, bl, 4096, 16, 64)
    gen = torch.Generator(device=dev).manual_seed(6)
    gumbel = a2c.draw_gumbel(gen, (16, 4096, 4), dev)
    logits = torch.randn((4096, 4), generator=gen, device=dev)
    reached = torch.zeros(4096, dtype=torch.bool, device=dev)
    plan.begin(st, gumbel)
    st = plan.step(0, logits)
    gst, reached = plan.greedy(st, reached, logits)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    for t in range(1, 16):
        st = plan.step(t, logits)
        gst, reached = plan.greedy(gst, reached, logits)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    for key in ("allocation.all.allocated", "allocated_bytes.all.allocated", "segment.all.allocated"):
        assert after[key] == before[key], key


def test_act_step_plan_raises_on_another_stream(dev):
    sem, bl, st = _act_plan_case(dev, "walls16", 256)
    plan = act_kernels.ActStepPlan(sem, bl, 256, 4, None)
    gen = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn((256, 4), generator=gen, device=dev)
    plan.begin(st, a2c.draw_gumbel(gen, (4, 256, 4), dev))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="stream"):
            plan.step(0, logits)
        with pytest.raises(RuntimeError, match="stream"):
            plan.greedy(st, torch.zeros(256, dtype=torch.bool, device=dev), logits)
        # a plan built on that stream takes calls there
        other = act_kernels.ActStepPlan(sem, bl, 256, 4, None)
        other.begin(st, a2c.draw_gumbel(gen, (4, 256, 4), dev))
        other.step(0, logits)
    torch.cuda.current_stream().wait_stream(side)
    plan.step(0, logits)


@pytest.mark.parametrize("algo", ["a2c", "ppo"])
def test_update_trajectory_is_valid_until_the_learners_next_rollout(dev, algo):
    """An update's trajectory rows and env state are views of the learner's
    K7b plan: the next update through the learner writes them again with
    its own rollout, while the stacked values and the bootstrap stay, and
    clones keep the first rollout. A rollout given no plan builds one and
    gives the same trajectory, one launch a step."""
    sem = T.make_semantics(device=dev)
    level = builders.lava_level(device=dev)
    b = 64
    kw = dict(rollout_len=4, max_episode_steps=16, hidden=(32,), embed_dim=16)
    cfg = a2c.A2CConfig(**kw) if algo == "a2c" else ppo.PPOConfig(num_epochs=1, num_minibatches=2, **kw)
    ts = a2c.a2c_init(sem, level, 3, cfg, b) if algo == "a2c" else ppo.ppo_init(sem, level, 3, cfg, b)

    def update(learner, params, opt_state, env_state, u):
        if algo == "a2c":
            return a2c.a2c_update(sem, learner, cfg, params, opt_state, env_state,
                                  a2c.update_noise(dev, 3, u, cfg, b, sem.num_actions))
        noise, draws = ppo.update_draws(dev, 3, u, cfg, b, sem.num_actions)
        return ppo.ppo_update(sem, learner, cfg, params, opt_state, env_state, noise, draws)

    learner = a2c.a2c_learner(sem, level, cfg, b) if algo == "a2c" else ppo.ppo_learner(sem, level, cfg, b)
    rows = ("obs", "action", "logp", "reward", "done")
    first = update(learner, ts.params, ts.opt_state, ts.env_state, 0)
    kept = {f: getattr(first.traj, f).clone() for f in rows + ("value",)}
    fields = ("agent_idx", "agent_code", "t", "done")
    kept_state = {f: getattr(first.env_state, f).clone() for f in fields}
    kept_boot = first.bootstrap.clone()
    second = update(learner, first.params, first.opt_state, first.env_state, 1)
    for f in rows:  # the same storage, now the second rollout's rows
        assert getattr(first.traj, f).data_ptr() == getattr(second.traj, f).data_ptr()
        assert torch.equal(getattr(first.traj, f), getattr(second.traj, f)), f
    assert any(not torch.equal(getattr(first.traj, f), kept[f]) for f in rows)
    # T = 4 steps ping-pong back to the slot the first rollout ended in
    assert first.env_state.agent_idx.data_ptr() == second.env_state.agent_idx.data_ptr()
    assert any(not torch.equal(getattr(first.env_state, f), kept_state[f]) for f in fields)
    assert torch.equal(first.traj.value, kept["value"]) and torch.equal(first.bootstrap, kept_boot)
    # the clones are the first rollout: a fresh learner repeats it
    again = update(a2c.a2c_learner(sem, level, cfg, b) if algo == "a2c" else ppo.ppo_learner(sem, level, cfg, b),
                   ts.params, ts.opt_state, ts.env_state, 0)
    for f in rows + ("value",):
        assert torch.equal(_bits(getattr(again.traj, f)), _bits(kept[f])), f
    for f in fields:
        assert torch.equal(getattr(again.env_state, f), kept_state[f]), f
    # a rollout given no plan builds its own, one launch a step
    bl, net, tiles = learner.bl, learner.net, learner.tiles
    noise = a2c.update_noise(dev, 3, 0, cfg, b, sem.num_actions)
    before = kernels.LAUNCHES["act_step"]
    end, traj, boot = a2c.rollout(sem, bl, net, ts.params, tiles, ts.env_state, noise, cfg.max_episode_steps)
    assert kernels.LAUNCHES["act_step"] == before + cfg.rollout_len
    ref_end, ref_traj, ref_boot = a2c.rollout(sem, bl, net, ts.params, tiles, ts.env_state, noise,
                                              cfg.max_episode_steps, learner.act_plan)
    for f in rows + ("value",):
        assert torch.equal(_bits(getattr(traj, f)), _bits(getattr(ref_traj, f))), f
    assert torch.equal(boot, ref_boot) and torch.equal(end.agent_idx, ref_end.agent_idx)


# ---------------------------------------------------------------------------
# K8a, K8b, K11, P1, P2
# ---------------------------------------------------------------------------


def _ring(dev, gen, cap):
    return dqn.ReplayBuffer(
        torch.randint(0, 256, (cap,), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 4, (cap,), generator=gen, device=dev, dtype=torch.int32),
        torch.randn((cap,), generator=gen, device=dev),
        torch.randint(0, 256, (cap,), generator=gen, device=dev, dtype=torch.int32),
        torch.rand((cap,), generator=gen, device=dev) < 0.3,
    )


@pytest.mark.parametrize("cap,b,n", [(64, 16, 8), (4096, 1024, 256), (131_072, 65_536, 256), (131_072, 65_536, 4096)])
def test_replay_ring_kernels_match_plain(dev, cap, b, n):
    gen = torch.Generator(device=dev).manual_seed(5)
    got, ref = _ring(dev, gen, cap), None
    ref = dqn.ReplayBuffer(*(x.clone() for x in got))
    prio_g = torch.rand((cap,), generator=gen, device=dev)
    prio_r = prio_g.clone()
    p_max = torch.tensor(3.5, device=dev)
    for at in (0, cap - b):
        batch = _ring(dev, gen, b)
        at_t = torch.tensor(at, device=dev)
        before = kernels.LAUNCHES["replay"]
        assert dqn.buffer_write(got, at_t, batch, prio_g, p_max) is got
        assert kernels.LAUNCHES["replay"] == before + 1
        dqn.replay_write_reference(ref, prio_r, at_t, batch, p_max)
        _assert_same((*got, prio_g), (*ref, prio_r))
    idx = torch.randint(0, cap, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[n // 2:] = idx[: n - n // 2]  # equal indices: the highest position wins
    mb = dqn.replay_gather(got, idx)
    for x, full in zip(mb, got):  # five (n,) tensors, each of its field's type
        assert x.shape == (n,) and x.dtype == full.dtype and x.is_contiguous()
    _assert_same(mb, dqn.replay_gather_reference(ref, idx))
    abs_err = torch.rand((n,), generator=gen, device=dev) * 5
    pm_g = dqn.prio_refresh(prio_g, idx, abs_err, 1e-3, p_max)
    pm_r = dqn.prio_refresh_reference(prio_r, idx, abs_err, 1e-3, p_max)
    _assert_same((prio_g, pm_g), (prio_r, pm_r))
    assert kernels.LAUNCHES["replay"] == before + 3
    assert torch.equal(prio_g[idx[-1].long()], abs_err[-1] + 1e-3)
    # a write without priorities (uniform replay) leaves them alone
    dqn.buffer_write(got, 0, _ring(dev, gen, b))
    assert torch.equal(prio_g, prio_r)


def _held_draw(prio, noise, size, n, alpha, beta):
    """K8a against its plain version: scores within 4 ulp, the selection
    bit-exact on the kernel's own scores, weights to rtol 2e-5."""
    dev = prio.device
    size_t = torch.as_tensor(size, dtype=torch.int64, device=dev)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    before = kernels.LAUNCHES["per_sample"]
    idx, w, score = dqn._per_sample(prio, noise, size_t, n, alpha, beta_t)
    # score, four histogram passes, count, compaction, finish; above 16,384
    # picks the sort is four passes of three launches more
    assert kernels.LAUNCHES["per_sample"] == before + (8 if n <= 16_384 else 20)
    ref_score, pa = dqn.per_scores_reference(prio, noise, size_t, alpha)
    finite = torch.isfinite(ref_score)
    assert torch.equal(finite, torch.isfinite(score))
    gap = (score[finite] - ref_score[finite]).abs()
    assert bool((gap <= 4 * 2.0 ** -23 * ref_score[finite].abs().clamp(min=1.0)).all())
    ref_idx, ref_w = dqn.per_select_reference(score, pa, size_t, beta_t, n)
    assert torch.equal(idx, ref_idx)
    torch.testing.assert_close(w, ref_w, rtol=2e-5, atol=0)
    return idx, w


@pytest.mark.parametrize("cap,size,n", [(64, 64, 64), (4096, 4096, 256), (4096, 1000, 256),
                                        (131_072, 131_072, 256), (131_072, 65_536, 256), (100_003, 77_777, 1024)])
def test_per_sample_kernel_matches_plain(dev, cap, size, n):
    gen = torch.Generator(device=dev).manual_seed(cap + size)
    prio = torch.rand((cap,), generator=gen, device=dev) * 4 + 1e-3
    prio[torch.randint(0, cap, (cap // 16,), generator=gen, device=dev)] = 0.0
    noise = a2c.draw_gumbel(gen, (cap,), dev)
    idx, w = _held_draw(prio, noise, size, n, 0.6, 0.4)
    assert bool((idx >= 0).all()) and bool((idx < size).all())
    assert float(w.max()) == 1.0 and bool((w > 0).all())
    again, w2 = _held_draw(prio, noise, size, n, 0.6, 0.4)
    assert torch.equal(idx, again) and torch.equal(w, w2)


def test_per_sample_kernel_ties_and_overflow(dev):
    # every score equal: the picks are slots 0..n-1, in order
    prio = torch.ones(4096, device=dev)
    noise = torch.zeros(4096, device=dev)
    idx, w = _held_draw(prio, noise, 4096, 256, 0.6, 0.4)
    assert idx.tolist() == list(range(256)) and bool((w == 1.0).all())
    # two levels of ties across the warps' ranges
    noise[torch.arange(0, 4096, 37, device=dev)] = 1.0
    idx, _ = _held_draw(prio, noise, 4096, 256, 0.6, 0.4)
    top = list(range(0, 4096, 37))
    assert idx.tolist()[: len(top)] == top
    # size < n: the -inf slots come out by lowest index and take the fallback at weight 1
    gen = torch.Generator(device=dev).manual_seed(2)
    noise = a2c.draw_gumbel(gen, (4096,), dev)
    idx, w = _held_draw(prio, noise, 100, 256, 0.6, 0.4)
    assert bool((idx < 100).all()) and bool((w[100:] == 1.0).all())
    with pytest.raises(ValueError, match="capacity"):  # more picks than slots
        dqn._per_sample(prio, noise, torch.tensor(10, device=dev), 4097, 0.6, torch.tensor(0.4, device=dev))


@pytest.mark.parametrize("cells,b", [((1, 1), 8), ((2, 2), 512), ((4, 4), 4096), ((3, 7), 300), ((16, 16), 256)])
def test_backtracker_kernel_matches_plain(dev, cells, b):
    before = kernels.LAUNCHES["backtracker_mazes"]
    got, start = M.generate_mazes_device(11, cells, b, "backtracker", device=dev)
    assert kernels.LAUNCHES["backtracker_mazes"] == before + 1
    ref = M.backtracker_mazes_reference(cells, b, seed=11, device=dev)
    assert torch.equal(got, ref) and int(start) == 2 * cells[1] + 2
    assert all(M.check_perfect_maze(g, cells) for g in got[:64].cpu().numpy())
    other, _ = M.generate_mazes_device(12, cells, b, "backtracker", device=dev)
    assert cells == (1, 1) or not torch.equal(got, other)
    with pytest.raises(ValueError, match="cells"):  # a maze needs a cell each way
        M.generate_mazes_device(0, (4, 0), 4, "backtracker", device=dev)


def test_gather_probe_kernels_match_plain(dev):
    before = dict(kernels.LAUNCHES)
    assert gather_probe.probe_gather_1d(device=dev) == "OK"
    assert gather_probe.probe_take_along_axis(device=dev) == "OK"
    assert kernels.LAUNCHES["gather_1d"] == before["gather_1d"] + 3
    assert kernels.LAUNCHES["take_along_axis1"] == before["take_along_axis1"] + 2
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-9, 9, (7, 33), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.randint(0, 33, (7, 5), generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(gather_probe.take_along_axis1(table, idx), gather_probe.take_along_axis1_reference(table, idx))
    flat = torch.randint(0, 33, (3, 4, 5), generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(gather_probe.gather_1d(table[0].contiguous(), flat), gather_probe.gather_1d_reference(table[0], flat))
    with pytest.raises(ValueError):
        gather_probe.take_along_axis1(table, idx[:3])


@pytest.mark.parametrize("extra", [{}, {"prioritized": True}, {"prioritized": True, "obs": "grid", "conv_channels": (8,)}])
def test_dqn_on_cuda_is_chunk_invariant(dev, extra):
    sem = T.make_semantics(device=dev)
    level = builders.walls_and_goal_16x16(device=dev)
    cfg = dqn.DQNConfig(buffer_capacity=4096, batch_size_train=128, max_episode_steps=64, hidden=(32,), **extra)
    ts0 = dqn.dqn_init(sem, level, 3, cfg, 1024)
    kernels.reset_launches()
    full = dqn.dqn_run(sem, level, ts0, cfg, 24)
    per = bool(extra.get("prioritized"))
    # a step: K7c's store form (act, step, statistics, the ring write), the gather, with PER the refresh;
    # the captured run's 24 replays and the warm-up's step
    steps = 24 + capture.WARMUP_STEPS
    assert kernels.LAUNCHES["dqn_act"] == steps
    assert kernels.LAUNCHES["replay"] == steps * (2 if per else 1)
    assert kernels.LAUNCHES["per_sample"] == (steps * 8 if per else 0)
    resumed = dqn.dqn_run(sem, level, dqn.dqn_run(sem, level, ts0, cfg, 12), cfg, 12)
    for name in full.params:
        assert torch.equal(full.params[name], resumed.params[name]), name
        assert torch.equal(full.target_params[name], resumed.target_params[name]), name
    _assert_same((*full.buf, full.prio, full.p_max, full.run_ret, full.ret_sum, full.last_loss),
                 (*resumed.buf, resumed.prio, resumed.p_max, resumed.run_ret, resumed.ret_sum, resumed.last_loss))
    assert int(full.t) == 24 and int(ts0.t) == 0 and not bool(ts0.buf.obs.any())
    assert bool(torch.isfinite(full.last_loss)) and float(full.last_loss) > 0


def test_mc_and_td_lambda_run_on_cuda(dev):
    from griduniverse_tpu_torch import algos

    sem = T.make_semantics(device=dev)
    level = builders.make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device=dev)
    cpu_sem = T.make_semantics(device="cpu")
    cpu_level = builders.make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device="cpu")
    before = kernels.LAUNCHES["segment_mean"]
    res = algos.mc_prediction(sem, level, 3)  # the default 256 episodes of 100 steps: 25,600 samples in K10
    ref = algos.mc_prediction(cpu_sem, cpu_level, 3)
    assert kernels.LAUNCHES["segment_mean"] == before + _k10_launches(dev, 25_600, 16)
    assert torch.equal(res.counts.cpu(), ref.counts)
    assert torch.equal(res.value.cpu().view(torch.int32), ref.value.view(torch.int32))
    ctl = algos.mc_control(sem, level, 6, num_rounds=5, batch_size=64, max_steps=30)
    ctl_ref = algos.mc_control(cpu_sem, cpu_level, 6, num_rounds=5, batch_size=64, max_steps=30)
    assert torch.equal(ctl.q.cpu().view(torch.int32), ctl_ref.q.view(torch.int32))
    a = algos.sarsa_lambda(sem, level, 5, num_steps=50, batch_size=64)
    b = algos.sarsa_lambda(sem, level, 5, num_steps=50, batch_size=64)
    assert torch.equal(a.q, b.q) and int(a.episodes) == int(b.episodes)


# ---------------------------------------------------------------------------
# Above the kernels' old shape ceilings (K10, K5, K3, K11, K8a, K8b), and K12
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [28_673, 65_536, 102_400])
def test_segment_mean_kernel_matches_plain_over_several_tiles(dev, b):
    gen = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn((81, 4), generator=gen, device=dev)
    s = torch.randint(0, 6, (b,), generator=gen, device=dev, dtype=torch.int32)
    s[::7] = torch.randint(0, 81, (len(s[::7]),), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)
    mask = torch.rand((b,), generator=gen, device=dev) < 0.5
    before = kernels.LAUNCHES["segment_mean"]
    got = td.apply_td_updates(q, s, a, delta, 0.1)
    got_m = td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)
    assert kernels.LAUNCHES["segment_mean"] == before + 2 * _k10_launches(dev, b, q.numel())
    _assert_same((got,), (td.apply_td_updates_reference(q, s, a, delta, 0.1),))
    _assert_same((got_m,), (td.apply_td_updates_reference(q, s, a, delta, 0.1, mask),))


def _skewed_batch(dev, b, n_states, num_actions, kind, seed):
    """(q, s, a, delta, mask) of K10 with `kind`'s skew: every env in one
    cell, 90 % in one cell, every env masked off, or spread over Q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n_states, num_actions), generator=gen, device=dev)
    s = torch.randint(0, n_states, (b,), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, num_actions, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)
    mask = torch.rand((b,), generator=gen, device=dev) < 0.5
    if kind == "one cell":
        s.fill_(n_states // 2)
        a.fill_(num_actions - 1)
    elif kind == "hot cell":
        hot = torch.rand((b,), generator=gen, device=dev) < 0.9
        s[hot], a[hot] = n_states // 3, 0
    elif kind == "all masked":
        mask.zero_()
    return q, s, a, delta, mask


@pytest.mark.parametrize("kind", ["one cell", "hot cell", "all masked", "spread"])
@pytest.mark.parametrize("b,n_states", [(65_536, 256), (65_536, 4225), (30_000, 10_000)])
def test_segment_mean_kernel_matches_plain_on_skewed_batches(dev, b, n_states, kind):
    """Many chunks of envs; S·A = 1,024, 16,900, and 40,000, whose counters
    are above shared memory and live in the global array."""
    q, s, a, delta, mask = _skewed_batch(dev, b, n_states, 4, kind, b + n_states)
    before = kernels.LAUNCHES["segment_mean"]
    got = td.apply_td_updates(q, s, a, delta, 0.1)
    got_m = td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)
    assert kernels.LAUNCHES["segment_mean"] == before + 2 * _k10_launches(dev, b, q.numel())
    _assert_same((got,), (td.apply_td_updates_reference(q, s, a, delta, 0.1),))
    _assert_same((got_m,), (td.apply_td_updates_reference(q, s, a, delta, 0.1, mask),))
    if kind == "all masked":
        assert torch.equal(_bits(got_m), _bits(q + 0.0))


@pytest.mark.parametrize("b", [1, 4096, 65_536])
def test_segment_mean_kernel_matches_plain_on_one_segment(dev, b):
    """S·A = 1: every env in the one cell."""
    q, s, a, delta, mask = _skewed_batch(dev, b, 1, 1, "one cell", b)
    before = kernels.LAUNCHES["segment_mean"]
    got = td.apply_td_updates(q, s, a, delta, 0.1)
    got_m = td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)
    assert kernels.LAUNCHES["segment_mean"] == before + 2 * _k10_launches(dev, b, q.numel())
    _assert_same((got,), (td.apply_td_updates_reference(q, s, a, delta, 0.1),))
    _assert_same((got_m,), (td.apply_td_updates_reference(q, s, a, delta, 0.1, mask),))


def _one_maze(dev, cells, seed):
    grids, start = M.generate_mazes_device(seed, cells, 1, device=dev)
    return bp.pack_level(T.Level(grid=grids[0].contiguous(), start_idx=start))


@pytest.mark.parametrize("algo", td_fast.ALGOS)
def test_td_scan_fast_kernel_matches_plain_above_shared_memory(dev, algo):
    """65x65 with 4 actions: 16,900 Q entries, more than the 8,192 the
    staged step kernel holds, so Q and the aggregate stay in global memory."""
    sem = T.make_semantics(device=dev)
    bl = _one_maze(dev, (32, 32), 6)
    ts = td_fast.fast_td_init(sem, bl, 3, 4096)
    assert ts.q.numel() == 16_900
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=64)
    before = kernels.LAUNCHES["td_scan_fast"]
    got = td_fast.td_scan_fast(sem, bl, ts, 200, **kw)
    assert kernels.LAUNCHES["td_scan_fast"] == before + 1
    _assert_same(_fast_fields(got), _fast_fields(td_fast.td_scan_fast_reference(sem, bl, ts, 200, **kw)))
    half = td_fast.td_scan_fast(sem, bl, td_fast.td_scan_fast(sem, bl, ts, 80, **kw), 120, **kw)
    _assert_same(_fast_fields(half), _fast_fields(got))


@pytest.mark.parametrize("cells,b", [((17, 16), 64), ((32, 32), 256), ((63, 63), 32)])
def test_maze_kernels_match_plain_above_local_memory(dev, cells, b):
    before = dict(kernels.LAUNCHES)
    got, _ = M.generate_mazes_device(11, cells, b, "backtracker", device=dev)
    assert kernels.LAUNCHES["backtracker_mazes"] == before["backtracker_mazes"] + 1
    assert torch.equal(got, M.backtracker_mazes_reference(cells, b, seed=11, device=dev))
    assert all(M.check_perfect_maze(g, cells) for g in got[:8].cpu().numpy())
    max_iters = 3000  # short of covering the larger mazes: the safety net carves the rest
    dirs = torch.randint(0, 4, (max_iters, b), device=dev, dtype=torch.int8)
    ab = M._aldous_broder_mazes(cells, b, max_iters, directions=dirs)
    assert torch.equal(ab, M.aldous_broder_mazes_reference(cells, b, max_iters, directions=dirs))
    seeded = M._aldous_broder_mazes(cells, b, max_iters, seed=3, device=dev)
    assert torch.equal(seeded, M.aldous_broder_mazes_reference(cells, b, max_iters, seed=3, device=dev))
    assert kernels.LAUNCHES["aldous_broder_mazes"] == before["aldous_broder_mazes"] + 2
    assert all(M.check_perfect_maze(g, cells) for g in ab[:8].cpu().numpy())


def _covering_directions(cells, b, gen, dev):
    """(T, B) int8 directions that cover every maze well before T: a random
    prefix of up to 2S steps, then west and north to the corner, then a
    boustrophedon over the rows, then random steps. Returns (dirs, the step
    by which every walk has covered its maze)."""
    ch, cw = cells
    sweep = [3] * (cw - 1) + [0] * (ch - 1)
    for r in range(ch):
        sweep += [1 if r % 2 == 0 else 3] * (cw - 1) + ([2] if r < ch - 1 else [])
    prefix = 2 * ch * cw
    covered = prefix + len(sweep)
    dirs = torch.randint(0, 4, (covered + 500, b), generator=gen, device=dev, dtype=torch.int8)
    starts = torch.randint(0, prefix + 1, (b,), generator=gen, device=dev)
    rows = torch.arange(len(sweep), device=dev)[:, None] + starts[None, :]
    dirs.scatter_(0, rows, torch.tensor(sweep, dtype=torch.int8, device=dev)[:, None].expand(-1, b).contiguous())
    return dirs, covered


@pytest.mark.parametrize("b", [1, 33, 4097])
@pytest.mark.parametrize("cells", [(1, 1), (1, 63), (63, 1), (32, 32), (63, 63)])
def test_maze_kernels_match_plain_at_the_edges(dev, cells, b):
    """The nibble trees and the warp's writer at the lattice's edges and its
    largest shape, with whole, partial (33 = 32 + 1) and single warps; K3
    injected short of cover (the safety net carves the rest) and past it
    (directions that sweep every cell, then more steps: each walk stops at
    its own cover), and seeded short of cover."""
    before = dict(kernels.LAUNCHES)
    got = M._backtracker_mazes(cells, b, seed=5, device=dev)
    assert torch.equal(got, M.backtracker_mazes_reference(cells, b, seed=5, device=dev))
    assert kernels.LAUNCHES["backtracker_mazes"] == before["backtracker_mazes"] + 1
    s = cells[0] * cells[1]
    gen = torch.Generator(device=dev).manual_seed(s + b)
    short = 2 * s + 3
    dirs = torch.randint(0, 4, (short, b), generator=gen, device=dev, dtype=torch.int8)
    ab = M._aldous_broder_mazes(cells, b, short, directions=dirs)
    assert torch.equal(ab, M.aldous_broder_mazes_reference(cells, b, short, directions=dirs))
    dirs, covered = _covering_directions(cells, b, gen, dev)
    full = M._aldous_broder_mazes(cells, b, covered + 500, directions=dirs)
    ref, steps = M.aldous_broder_mazes_reference(cells, b, covered + 500, directions=dirs, count_steps=True)
    assert torch.equal(full, ref) and bool((steps <= covered).all())  # every walk covered its maze
    seeded = M._aldous_broder_mazes(cells, b, short, seed=9, device=dev)
    assert torch.equal(seeded, M.aldous_broder_mazes_reference(cells, b, short, seed=9, device=dev))
    assert kernels.LAUNCHES["aldous_broder_mazes"] == before["aldous_broder_mazes"] + 3
    assert all(M.check_perfect_maze(g, cells) for g in torch.cat([got[:4], ab[:4], full[:4], seeded[:4]]).cpu().numpy())


# (cells, B, whether the device tier is forced): mazes above 63x63 cells,
# which `plan` cuts into blocks of 32 mazes up to 100x100 at these B, of 8
# at 200x200 and of one at 58,048x1 (the most words one block's shared
# memory holds), or, with SHARED_LIMIT lowered, into the device tier
_ABOVE_63 = [((64, 64), 33, False), ((64, 1), 33, False), ((100, 100), 4, False), ((200, 200), 2, False),
             ((58_048, 1), 2, False), ((64, 64), 5, True), ((33, 70), 3, True)]


@pytest.mark.parametrize("cells,b,device_tier", _ABOVE_63)
def test_maze_kernels_match_plain_above_63x63(dev, cells, b, device_tier, monkeypatch):
    """K11 through `generate_mazes_device` and K3 in both modes against the
    plain versions; K3's walks capped (at most 20,000 steps, short of cover
    at the large shapes: the safety net carves the rest) so that the plain
    walk stays within seconds, and past cover where the lattice is small."""
    from griduniverse_tpu_torch.kernels import maze as km

    if device_tier:
        monkeypatch.setattr(km, "SHARED_LIMIT", 1024)
    p = km.plan(cells, b)
    assert (p.scratch > 0) == device_tier
    before = dict(kernels.LAUNCHES)
    got, _ = M.generate_mazes_device(7, cells, b, "backtracker", device=dev)
    assert torch.equal(got, M.backtracker_mazes_reference(cells, b, seed=7, device=dev))
    s = cells[0] * cells[1]
    cap = min(2 * s + 3, 20_000)
    gen = torch.Generator(device=dev).manual_seed(s + b)
    dirs = torch.randint(0, 4, (cap, b), generator=gen, device=dev, dtype=torch.int8)
    ab = M._aldous_broder_mazes(cells, b, cap, directions=dirs)
    assert torch.equal(ab, M.aldous_broder_mazes_reference(cells, b, cap, directions=dirs))
    seeded = M._aldous_broder_mazes(cells, b, cap, seed=9, device=dev)
    assert torch.equal(seeded, M.aldous_broder_mazes_reference(cells, b, cap, seed=9, device=dev))
    launched = 3
    if s <= 4_096:  # past cover: every walk stops at its own
        dirs, covered = _covering_directions(cells, b, gen, dev)
        full = M._aldous_broder_mazes(cells, b, covered + 500, directions=dirs)
        ref, steps = M.aldous_broder_mazes_reference(cells, b, covered + 500, directions=dirs, count_steps=True)
        assert torch.equal(full, ref) and bool((steps <= covered).all())
        launched += 1
    assert kernels.LAUNCHES["backtracker_mazes"] == before["backtracker_mazes"] + 1
    assert kernels.LAUNCHES["aldous_broder_mazes"] == before["aldous_broder_mazes"] + launched - 1
    assert all(M.check_perfect_maze(g, cells) for g in torch.cat([got[:2], ab[:2], seeded[:2]]).cpu().numpy())


@pytest.mark.parametrize("cap,size,n", [(131_072, 131_072, 4096), (8192, 3000, 4096), (65_536, 50_000, 20_000)])
def test_per_sample_kernel_matches_plain_above_one_block_of_picks(dev, cap, size, n):
    """n > 1,024 picks; above 16,384 the picks' keys live in global scratch."""
    gen = torch.Generator(device=dev).manual_seed(n)
    prio = torch.rand((cap,), generator=gen, device=dev) * 4 + 1e-3
    prio[torch.randint(0, cap, (cap // 16,), generator=gen, device=dev)] = 0.0
    noise = a2c.draw_gumbel(gen, (cap,), dev)
    idx, w = _held_draw(prio, noise, size, n, 0.6, 0.4)
    assert bool((idx >= 0).all()) and bool((idx < size).all())
    if size < n:
        assert bool((w[size:] == 1.0).all())
    again, w2 = _held_draw(prio, noise, size, n, 0.6, 0.4)
    assert torch.equal(idx, again) and torch.equal(w, w2)


@pytest.mark.parametrize("kind", ["random", "all equal", "size < n"])
@pytest.mark.parametrize("n", [1, 16_384, 16_385, 131_072])
def test_per_sample_kernel_matches_plain_at_the_sort_limits(dev, n, kind):
    """One pick, the most one block sorts, one more (multi-block passes),
    and the whole ring of 131,072; every score equal, and `size < n`."""
    cap = 131_072
    gen = torch.Generator(device=dev).manual_seed(n + len(kind))
    prio = torch.rand((cap,), generator=gen, device=dev) * 4 + 1e-3
    prio[torch.randint(0, cap, (cap // 16,), generator=gen, device=dev)] = 0.0
    noise = a2c.draw_gumbel(gen, (cap,), dev)
    size = cap if n == cap else cap // 2
    if kind == "all equal":
        prio, noise = torch.ones_like(prio), torch.zeros_like(noise)
    elif kind == "size < n":
        size = n // 2
    idx, w = _held_draw(prio, noise, size, n, 0.6, 0.4)
    if kind == "all equal":
        assert idx.tolist() == list(range(n)) and bool((w == 1.0).all())
    if size < n:  # the -inf slots come out by lowest index and take the fallback at weight 1
        assert bool((w[size:] == 1.0).all())
    assert bool((idx >= 0).all()) and bool((idx < max(size, 1)).all())


@pytest.mark.parametrize("cap,n", [(131_072, 1025), (131_072, 4096), (8192, 20_000), (131_072, 8192),
                                   (131_072, 8193), (64, 8192), (64, 8193)])
def test_prio_refresh_kernel_matches_plain_above_one_block(dev, cap, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    prio_g = torch.rand((cap,), generator=gen, device=dev)
    prio_r = prio_g.clone()
    idx = torch.randint(0, cap, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[n // 2:] = idx[: n - n // 2].clone()  # equal indices: the highest position wins
    abs_err = torch.rand((n,), generator=gen, device=dev) * 5
    p_max = torch.tensor(3.5, device=dev)
    before = kernels.LAUNCHES["replay"]
    pm_g = dqn.prio_refresh(prio_g, idx, abs_err, 1e-3, p_max)
    # one launch over a hash table in shared memory up to the limit, two above
    assert kernels.LAUNCHES["replay"] == before + (1 if n <= replay_kernels.MAX_HASH_REFRESH else 2)
    pm_r = dqn.prio_refresh_reference(prio_r, idx, abs_err, 1e-3, p_max)
    _assert_same((prio_g, pm_g), (prio_r, pm_r))
    assert torch.equal(prio_g[idx[-1].long()], abs_err[-1] + 1e-3)


@pytest.mark.parametrize("b,s,a", [(1, 16, 4), (300, 16, 4), (4096, 256, 4), (513, 81, None),
                                   (16_776_961, 1, 2),  # above 65,535 chunks of 256 envs
                                   (65_536, 256, None), (65_536, 256, 4)])  # the TD(λ) runs' traces
@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
def test_trace_pass_kernel_matches_plain(dev, b, s, a, kind):
    gen = torch.Generator(device=dev).manual_seed(b)
    shape = (b, s) if a is None else (b, s, a)
    e = torch.rand(shape, generator=gen, device=dev) * 2 * (torch.rand(shape, generator=gen, device=dev) < 0.3)
    e.reshape(b, -1)[::5, 1] = 1e-4 / 0.72  # decays to about the cutoff, on both sides of it
    states = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    actions = None if a is None else torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32)
    delta = torch.randn((b,), generator=gen, device=dev)
    cut = torch.rand((b,), generator=gen, device=dev) < 0.2
    table = torch.randn(shape[1:], generator=gen, device=dev)
    e_g, e_r = e.clone(), e.clone()
    args = (states, actions, delta, cut, 0.9, 0.8, 1e-4, 0.3, kind)
    before = kernels.LAUNCHES["trace_pass"]
    got = td_lambda.trace_pass(table, e_g, *args)
    assert kernels.LAUNCHES["trace_pass"] == before + trace_kernels.launches(b) == before + 1
    _assert_same((got, e_g), (td_lambda.trace_pass_reference(table, e_r, *args), e_r))


def _trace_step_inputs(dev, gen, b, s, a):
    states = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    actions = None if a is None else torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32)
    return (states, actions, torch.randn((b,), generator=gen, device=dev),
            torch.rand((b,), generator=gen, device=dev) < 0.1)


@pytest.mark.parametrize("b,s,a", [(4096, 256, 4), (65_536, 256, None), (1000, 81, None)])
def test_trace_pass_plan_chains_steps_bit_for_bit(dev, b, s, a):
    """Five steps through one plan equal five plain steps: each launch
    leaves the counts and tickets at 0 for the next."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (b, s) if a is None else (b, s, a)
    e_g = torch.zeros(shape, device=dev)
    e_r = e_g.clone()
    t_g = t_r = torch.randn(shape[1:], generator=gen, device=dev)
    plan = trace_kernels.TracePassPlan(t_g, b, a is not None)
    before = kernels.LAUNCHES["trace_pass"]
    for _ in range(5):
        step = _trace_step_inputs(dev, gen, b, s, a) + (0.9, 0.8, 1e-4, 0.3, "replacing")
        t_g = td_lambda.trace_pass(t_g, e_g, *step, plan=plan)
        t_r = td_lambda.trace_pass_reference(t_r, e_r, *step)
        _assert_same((t_g, e_g), (t_r, e_r))
    assert kernels.LAUNCHES["trace_pass"] == before + 5
    assert not plan._scratch[plan.words["partial"]:].any()


def test_trace_pass_step_replays_in_a_cuda_graph(dev):
    """One step captured in a CUDA graph (the plan built on the capture's
    stream) and replayed three times equals three plain steps."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, a = 4096, 256, 4
    e = torch.rand((b, s, a), generator=gen, device=dev) * (torch.rand((b, s, a), generator=gen, device=dev) < 0.3)
    e_r = e.clone()
    table = torch.randn((s, a), generator=gen, device=dev)
    step = _trace_step_inputs(dev, gen, b, s, a) + (0.9, 0.8, 1e-4, 0.3, "accumulating")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plan = trace_kernels.TracePassPlan(table, b, True)
        warm = e.clone()
        td_lambda.trace_pass(table, warm, *step, plan=plan)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = td_lambda.trace_pass(table, e, *step, plan=plan)
    for _ in range(3):  # the captured step reads the same table and decays the same trace again
        graph.replay()
        want = td_lambda.trace_pass_reference(table, e_r, *step)
        torch.cuda.synchronize()
        _assert_same((out, e), (want, e_r))


@pytest.mark.parametrize("b,s,a,ranks", [(1, 16, 4, 1), (300, 16, 4, 1), (4096, 256, 4, 1), (513, 81, None, 1),
                                         (300, 16, 4, 3), (512, 256, 4, 2), (65_536, 256, None, 1),
                                         (65_536, 256, 4, 1), (32_768, 256, 4, 2)])
@pytest.mark.parametrize("kind", ["accumulating", "replacing"])
def test_trace_partials_kernel_matches_plain(dev, b, s, a, ranks, kind):
    """K12's partial-sums form: each rank's pass (its partials, counts and
    cut trace) and the apply over the ranks' gathered chunks equal the plain
    versions bit for bit; where one rank's batch is a multiple of 256, or
    there is one rank, the new table is K12's own step's; the apply leaves
    the counts 0."""
    gen = torch.Generator(device=dev).manual_seed(b + ranks)
    shape = (ranks * b, s) if a is None else (ranks * b, s, a)
    e = torch.rand(shape, generator=gen, device=dev) * 2 * (torch.rand(shape, generator=gen, device=dev) < 0.3)
    e.reshape(ranks * b, -1)[::5, 1] = 1e-4 / 0.72
    states, actions, delta, cut = _trace_step_inputs(dev, gen, ranks * b, s, a)
    table = torch.randn(shape[1:], generator=gen, device=dev)
    plans = [trace_kernels.TracePartialsPlan(table, b, a is not None, ranks) for _ in range(ranks)]
    e_g, e_r, e_k = e.clone(), e.clone(), e.clone()
    parts, counts = [], []
    before = kernels.LAUNCHES["trace_partials"]
    for r, plan in enumerate(plans):
        rows = slice(r * b, (r + 1) * b)
        local, count = plan.partials(e_g[rows], states[rows], None if a is None else actions[rows], delta[rows],
                                     cut[rows], 0.9 * 0.8, 1e-4, kind == "replacing")
        want = td_lambda.trace_partials_reference(e_r[rows], states[rows], None if a is None else actions[rows],
                                                  delta[rows], cut[rows], 0.9, 0.8, 1e-4, kind)
        _assert_same((local, count, e_g[rows]), (*want, e_r[rows]))
        parts.append(local.clone())
        counts.append(count.clone())
    total = torch.stack(counts).sum(dim=0).to(torch.int32)
    plans[0].gathered[: plans[0].total_chunks] = torch.cat(parts)
    plans[0].count.copy_(total)
    got = plans[0].apply(table, 0.3)
    assert kernels.LAUNCHES["trace_partials"] == before + ranks + 1
    assert not plans[0].count.any()
    _assert_same((got,), (td_lambda.apply_partials_reference(table, torch.cat(parts), total, 0.3),))
    if ranks == 1 or b % trace_kernels.CHUNK == 0:
        whole = td_lambda.trace_pass(table, e_k, states, actions, delta, cut, 0.9, 0.8, 1e-4, 0.3, kind)
        _assert_same((got, e_g), (whole, e_k))


def test_td_lambda_on_cuda_equals_the_cpu_run(dev):
    from griduniverse_tpu_torch import algos

    level = builders.make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device=dev)
    cpu_level = builders.make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device="cpu")
    sem, cpu_sem = T.make_semantics(device=dev), T.make_semantics(device="cpu")
    kw = dict(num_steps=40, batch_size=300, alpha=0.2, epsilon=0.2)
    for fn in (algos.sarsa_lambda, algos.watkins_q_lambda):
        before = kernels.LAUNCHES["trace_pass"]
        got = fn(sem, level, 5, **kw)
        assert kernels.LAUNCHES["trace_pass"] == before + 40
        want = fn(cpu_sem, cpu_level, 5, **kw)
        assert torch.equal(got.q.cpu().view(torch.int32), want.q.view(torch.int32))
        assert int(got.episodes) == int(want.episodes)
    policy = torch.full((16, 4), 0.25)
    got = algos.td_lambda_prediction(sem, level, policy.to(dev), 5, num_steps=40, batch_size=300)
    want = algos.td_lambda_prediction(cpu_sem, cpu_level, policy, 5, num_steps=40, batch_size=300)
    assert torch.equal(got.v.cpu().view(torch.int32), want.v.view(torch.int32))


# ---------------------------------------------------------------------------
# K4's global-memory tier, K7c, K13 and a resume through disk
# ---------------------------------------------------------------------------


def test_grid_kernels_match_plain_above_shared_memory(dev):
    """Two sidewinder mazes of 65x64 cells (16,899 states): the cluster
    tier's one launch for 7 sweeps (a cluster of one block a maze), the
    sweep maxima, V, the policy and `changed` bit for bit."""
    from griduniverse_tpu_torch.kernels import dp_grid

    sem = T.make_semantics(device=dev)
    grids, start = M.generate_mazes_device(11, (65, 64), 2, "sidewinder", device=dev)
    levels = T.Level(grid=grids, start_idx=start.expand(2).contiguous())
    s = levels.num_states
    assert not dp_grid.uses_shared_tier(s) and dp_grid.grid_tier(131, 129) == "cluster"
    v0 = torch.zeros((2, s), device=dev)
    before = kernels.LAUNCHES["dp_grid"]
    v, maxima = dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 7)
    assert kernels.LAUNCHES["dp_grid"] == before + 1
    backup = dp_batched._grid_backup(sem, grids, 0.99)
    ref, ref_max = v0, []
    for _ in range(7):
        new = backup(ref).max(dim=-1).values
        ref_max.append((new - ref).abs().max())
        ref = new
    _assert_same((v, maxima), (ref, torch.stack(ref_max)))
    policy = torch.randint(0, 4, (2, s), device=dev, dtype=torch.int32)
    pv, _ = dp_grid.grid_sweeps_cuda(sem, grids, v, policy, 0.99, 3)
    pref = v
    for _ in range(3):
        pref = backup(pref).gather(2, policy.long()[:, :, None])[:, :, 0]
    _assert_same((pv,), (pref,))
    greedy, changed = dp_grid.grid_greedy_cuda(sem, grids, pv, 0.99, policy)
    want = torch.argmax(backup(pv), dim=-1).to(torch.int32)
    assert torch.equal(greedy, want) and int(changed) == int(bool((want != policy).any()))
    _, unchanged = dp_grid.grid_greedy_cuda(sem, grids, pv, 0.99, want)
    assert int(unchanged) == 0
    got = dp_batched.value_iteration_batched_grid(sem, levels)
    ref = dp_batched.value_iteration_batched_grid_reference(sem, levels)
    assert got[2] == ref[2]
    _assert_same(got[:2], ref[:2])
    kw = dict(max_eval_iters=300, max_policy_iters=3)
    got = dp_batched.policy_iteration_batched_grid(sem, levels, **kw)
    ref = dp_batched.policy_iteration_batched_grid_reference(sem, levels, **kw)
    assert got[2] == ref[2]
    _assert_same(got[:2], ref[:2])


@pytest.mark.parametrize("shape", ["walls16", "mazes", "odd_batch", "wide", "wider"])
def test_dqn_act_step_kernel_matches_plain(dev, shape):
    """40 calls through one host plan, so that every call after the first
    finds the ticket its last block set back to 0."""
    sem = T.make_semantics(device=dev)
    levels = _levels(dev)
    bl = levels["mazes"] if shape == "mazes" else levels["walls16"]
    b = {"odd_batch": 777, "wide": 65_536, "wider": 131_073}.get(shape, 1024)
    plan = dqn_act_kernels.DqnActPlan(sem, bl, b, 10)
    gen = torch.Generator(device=dev).manual_seed(3)
    st = bp.reset_bits(bl, None if bl.batched else b)
    stats = (torch.zeros(b, device=dev), torch.zeros((), dtype=torch.int64, device=dev), torch.zeros((), device=dev))
    ref_st, ref_stats = st, stats
    for i in range(40):
        q = torch.randint(-2, 3, (b, 4), generator=gen, device=dev).float() * 0.5  # ties
        explore = torch.rand(b, generator=gen, device=dev) < 0.3
        rand_a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
        before = kernels.LAUNCHES["dqn_act"]
        st, *out, r1, r2, r3 = dqn.dqn_act_step(sem, bl, st, q, explore, rand_a, *stats, 10, plan=plan)
        assert kernels.LAUNCHES["dqn_act"] == before + 1
        stats = (r1, r2, r3)
        ref_st, *ref_out, s1, s2, s3 = dqn.dqn_act_step_reference(sem, bl, ref_st, q, explore, rand_a, *ref_stats, 10)
        ref_stats = (s1, s2, s3)
        _assert_same(out, ref_out)
        _assert_same((*stats[:1], stats[2]), (*ref_stats[:1], ref_stats[2]))
        assert int(stats[1]) == int(ref_stats[1])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(st, f), getattr(ref_st, f)), f
    assert int(stats[1]) > 0


# q: a 16-byte aligned (B, 4) row (the vec4 load), the same off a 16-byte
# boundary (the scalar loads), and the wide form at 9 and 25 actions
_STORE_FORMS = {"vec4": 4, "unaligned q": 4, "nine": 9, "twenty-five": 25}


def _store_steps(dev, sem, bl, b, a, cap, at, prioritized, steps, unaligned=False, seed=0):
    """`steps` calls of K7c's store form through one plan with the ring
    bound once, each against `dqn_act_store_reference` on a copy of the
    ring: all eleven outputs, the ring and the priorities bit for bit.
    `at` is a view into a (steps,) int64 tensor, as the trainer's; p_max
    changes every step."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = dqn_act_kernels.DqnActPlan(sem, bl, b, 10)
    buf = _ring(dev, gen, cap)
    prio = torch.rand((cap,), generator=gen, device=dev) if prioritized else None
    ref_buf = dqn.ReplayBuffer(*(x.clone() for x in buf))
    ref_prio = None if prio is None else prio.clone()
    plan.bind_ring(buf, prio)
    ats = torch.full((steps,), at, dtype=torch.int64, device=dev)
    st = ref_st = bp.reset_bits(bl, None if bl.batched else b)
    stats = ref_stats = (torch.zeros(b, device=dev), torch.zeros((), dtype=torch.int64, device=dev),
                         torch.zeros((), device=dev))
    for i in range(steps):
        q = torch.randint(-2, 3, (b, a), generator=gen, device=dev).float() * 0.5  # ties
        if unaligned:
            q = torch.cat([torch.zeros(1, device=dev), q.reshape(-1)])[1:].view(b, a)
            assert q.data_ptr() % 16 != 0 and q.is_contiguous()
        explore = torch.rand(b, generator=gen, device=dev) < 0.3
        rand_a = torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32)
        p_max = torch.rand((), generator=gen, device=dev) * 4
        before = dict(kernels.LAUNCHES)
        st, *out = dqn.dqn_act_step(sem, bl, st, q, explore, rand_a, *stats, 10, plan=plan,
                                    ring=(buf, prio, ats[i], p_max))
        assert kernels.LAUNCHES["dqn_act"] == before["dqn_act"] + 1
        assert kernels.LAUNCHES["replay"] == before["replay"]
        ref_st, *ref_out = dqn.dqn_act_store_reference(sem, bl, ref_st, q, explore, rand_a, *ref_stats,
                                                       (ref_buf, ref_prio, ats[i], p_max), 10)
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(st, f), getattr(ref_st, f)), f
        _assert_same(out, ref_out)
        _assert_same(buf, ref_buf)
        if prioritized:
            _assert_same((prio,), (ref_prio,))
        stats, ref_stats = tuple(out[4:]), tuple(ref_out[4:])
    return buf, prio


@pytest.mark.parametrize("prioritized", [True, False])
@pytest.mark.parametrize("at_end", [False, True])
@pytest.mark.parametrize("form", sorted(_STORE_FORMS))
@pytest.mark.parametrize("b", [1, 33, 65_536])
def test_dqn_act_store_form_matches_plain(dev, b, form, at_end, prioritized):
    a = _STORE_FORMS[form]
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    bl = _levels(dev)["walls16"]
    cap = 2 * b if b == 65_536 else 4 * b
    at = cap - b if at_end else 0
    buf, _ = _store_steps(dev, sem, bl, b, a, cap, at, prioritized, 10, unaligned=form == "unaligned q", seed=b + a)
    if b > 1:  # the tenth step meets the time limit: the last store holds ended episodes
        assert bool(buf.done[at:at + b].any())


def test_dqn_act_store_form_matches_plain_over_per_env_mazes(dev):
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["mazes"]
    _store_steps(dev, sem, bl, 1024, 4, 4096, 3072, True, 24, seed=9)


def test_dqn_act_store_form_raises_on_another_ring(dev):
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    gen = torch.Generator(device=dev).manual_seed(2)
    plan = dqn_act_kernels.DqnActPlan(sem, bl, 64, 10)
    buf, prio = _ring(dev, gen, 256), torch.zeros(256, device=dev)
    st = bp.reset_bits(bl, 64)
    step = (st, torch.zeros(64, 4, device=dev), torch.zeros(64, dtype=torch.bool, device=dev),
            torch.zeros(64, dtype=torch.int32, device=dev), torch.zeros(64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev), torch.zeros((), device=dev))
    at, p_max = torch.zeros((), dtype=torch.int64, device=dev), torch.ones((), device=dev)
    with pytest.raises(ValueError, match="no ring"):
        plan(*step, ring=(buf, prio, at, p_max))
    for bad in ((dqn.ReplayBuffer(*(x[:200] for x in buf)), None),           # 64 does not divide 200
                (buf._replace(reward=buf.reward.double()), None),            # another dtype
                (buf._replace(obs=buf.obs.cpu()), None),                     # another device
                (buf, prio[:128])):                                          # prio of another size
        with pytest.raises(ValueError):
            plan.bind_ring(*bad)
    plan.bind_ring(buf, prio)
    other = _ring(dev, gen, 256)
    copy = [x.clone() for x in other]
    with pytest.raises(ValueError, match="other tensors"):  # another run's ring: raised, never written
        plan(*step, ring=(other, prio, at, p_max))
    torch.cuda.synchronize()
    _assert_same(other, copy)
    with pytest.raises(ValueError, match="at"):
        plan(*step, ring=(buf, prio, at.cpu(), p_max))
    before = kernels.LAUNCHES["dqn_act"]
    plan(*step, ring=(buf, prio, at, p_max))
    assert kernels.LAUNCHES["dqn_act"] == before + 1


@pytest.mark.parametrize("t,b,num_ids", [
    (1, 5, 4), (7, 300, 3), (100, 256, 81), (100, 1024, 324), (31, 1, 5), (33, 33, 40), (31, 4097, 81),
    (257, 33, 81), (257, 4097, 300), (1000, 1, 50), (1000, 33, 700), (6000, 3, 900)])
def test_mc_returns_kernel_matches_plain(dev, t, b, num_ids):
    """T on either side of a warp, across several tiles of rows of the
    staged group and above one tile of the block's shared memory (6,000);
    B of one episode, one past a group and one past 4,096; episode 0's ids
    all equal."""
    from griduniverse_tpu_torch.algos import mc

    gen = torch.Generator(device=dev).manual_seed(t * b)
    valid = torch.arange(t, device=dev)[:, None] < torch.randint(0, t + 1, (b,), generator=gen, device=dev)[None]
    rewards = torch.where(valid, torch.randn((t, b), generator=gen, device=dev), 0.0)
    ids = torch.randint(0, num_ids, (t, b), generator=gen, device=dev, dtype=torch.int32)
    ids[:, 0] = 7
    before = kernels.LAUNCHES["mc_returns"]
    g, mask = mc.mc_returns(rewards, 0.99, ids, valid)
    only, none = mc.mc_returns(rewards, 0.99)
    assert kernels.LAUNCHES["mc_returns"] == before + 2 and none is None
    _assert_same((g, mask, only), (mc.discounted_returns(rewards, 0.99), mc.first_visit_mask(ids, valid), g))
    for edge in (torch.ones_like(valid), torch.zeros_like(valid)):
        _assert_same(mc.mc_returns(rewards, 0.99, torch.zeros_like(ids), edge)[1:],
                     (mc.first_visit_mask(torch.zeros_like(ids), edge),))


@pytest.mark.parametrize("t,b,group,tiles", [(100, 256, 2, 1), (100, 1024, 4, 1), (170, 2048, 8, 1),
                                             (100, 4096, 16, 1), (170, 8192, 32, 1), (3000, 5, 1, 1),
                                             (6000, 2, 1, 2)])
def test_mc_returns_kernel_gives_the_same_bits_at_every_group(dev, t, b, group, tiles):
    """Every group of episodes a block that `kernels.mc_returns.plan` picks,
    reached through the shapes it picks it at, gives the plain version's
    bits: 2 to 32 episodes a block in one tile of T rows (T = 170 is the
    most for 32), one episode a block in one tile and, above 5,461 steps, in
    two (the first tile's steps from device memory); ids over the whole
    int32 range."""
    from griduniverse_tpu_torch.algos import mc
    from griduniverse_tpu_torch.kernels import mc_returns as k13

    p = k13.plan(t, b)
    assert p.group == group and -(-t // p.tile) == tiles
    gen = torch.Generator(device=dev).manual_seed(group * tiles)
    valid = torch.rand((t, b), generator=gen, device=dev) < 0.8
    rewards = torch.randn((t, b), generator=gen, device=dev)
    ids = torch.randint(-(1 << 31), (1 << 31) - 1, (8,), generator=gen, device=dev, dtype=torch.int32)[
        torch.randint(0, 8, (t, b), generator=gen, device=dev)]
    before = kernels.LAUNCHES["mc_returns"]
    got = mc.mc_returns(rewards, 0.99, ids, valid)
    assert kernels.LAUNCHES["mc_returns"] == before + 1
    _assert_same(got, (mc.discounted_returns(rewards, 0.99), mc.first_visit_mask(ids, valid)))


@pytest.mark.parametrize("prioritized", [True, False])
def test_dqn_resume_through_disk_on_cuda(dev, tmp_path, prioritized):
    from griduniverse_tpu_torch.utils.checkpoint import CheckpointManager, flatten

    sem = T.make_semantics(device=dev)
    level = builders.walls_and_goal_16x16(device=dev)
    cfg = dqn.DQNConfig(buffer_capacity=4096, batch_size_train=128, max_episode_steps=64, hidden=(32,),
                        prioritized=prioritized)
    ts0 = dqn.dqn_init(sem, level, 3, cfg, 1024)
    full = dqn.dqn_run(sem, level, ts0, cfg, 24)
    with CheckpointManager(tmp_path / "dqn", async_=True) as mgr:
        mgr.save(12, dqn.dqn_run(sem, level, ts0, cfg, 12))
        step, restored = mgr.restore_latest(dqn.dqn_init(sem, level, 0, cfg, 1024))
    assert step == 12 and restored.seed == 3 and restored.buf.obs.device.type == "cuda"
    kernels.reset_launches()
    resumed = dqn.dqn_run(sem, level, restored, cfg, 12)
    # the restored ring is written by K7c's store form: no launch of K8b's write
    assert kernels.LAUNCHES["dqn_act"] == 12
    assert kernels.LAUNCHES["replay"] == 12 * (2 if prioritized else 1)
    got, want = flatten(resumed), flatten(full)
    assert list(got) == list(want)
    for key, x in want.items():
        if isinstance(x, torch.Tensor):
            _assert_same((got[key],), (x,))
        else:
            assert got[key] == x, key


# ---------------------------------------------------------------------------
# Any number of actions: the wide forms of K1, K2, K4, K5, K6, K7b and K7c
# ---------------------------------------------------------------------------

# 9: the eight king moves and a stay; 25: every move of at most two rows
# and two columns (jumps over a tile included)
_ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


def _sem_of(dev, a):
    from griduniverse_tpu_torch.core.semantics import SemanticsConfig

    return T.make_semantics(SemanticsConfig(action_deltas=_ACTION_SETS[a]), device=dev)


@pytest.mark.parametrize("a", [9, 25])
def test_rollout_kernels_match_plain_at_many_actions(dev, a):
    """K2 in its three modes and K1, on a shared level and per-env mazes,
    with actions outside 0..A−1 (clamped as XLA's gather)."""
    sem = _sem_of(dev, a)
    gen = torch.Generator(device=dev).manual_seed(a)
    for bl in _levels(dev).values():
        st = bp.reset_bits(bl, None if bl.batched else 1024)
        actions = torch.randint(-2, a + 2, (200, 1024), generator=gen, device=dev, dtype=torch.int32)
        for mode in ((False, None), (True, None), (True, 32)):
            before = kernels.LAUNCHES["rollout_actions_bits"]
            got_state, got = bp.rollout_actions_bits(sem, bl, st, actions, *mode)
            assert kernels.LAUNCHES["rollout_actions_bits"] == before + 1
            ref_state, ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, *mode)
            _assert_same(got, ref)
            for f in ("agent_idx", "agent_code", "t", "done"):
                assert torch.equal(getattr(got_state, f), getattr(ref_state, f))
        rs = bp.xorshift_init(9, (1024,), device=dev)
        before = kernels.LAUNCHES["random_scan_bits"]
        got = bp.random_scan_bits(sem, bl, st, rs, None, 300, 40)
        assert kernels.LAUNCHES["random_scan_bits"] == before + 1
        ref = bp.random_scan_bits_reference(sem, bl, st, rs, 300, 40)
        _assert_same(got[1:], ref[1:])


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("cells,n,lava", [((4, 4), 257, 0.1), ((8, 8), 65, 0.1), ((16, 16), 9, 0.1),
                                          ((32, 32), 3, 0.05)])
def test_grid_sweeps_kernel_matches_plain_at_many_actions(dev, a, cells, n, lava):
    """K4's shared tier in each packing (registers at 4x4; at 8x8 and 16x16
    a table of decoded actions or, where it does not fit, the wide form's
    decode of every action each sweep; 32x32 the decode) against the plain
    sweeps: V and the maxima, evaluation sweeps of a policy, the greedy
    step and `changed`."""
    from griduniverse_tpu_torch.kernels import dp_grid

    sem = _sem_of(dev, a)
    gen = torch.Generator(device=dev).manual_seed(n * a)
    grids, _ = M.generate_mazes_device(n, cells, n, "aldous_broder", device=dev)
    grids = torch.where((grids == 0) & (torch.rand(grids.shape, generator=gen, device=dev) < lava),
                        torch.full_like(grids, 2), grids).contiguous()
    s = grids.shape[1] * grids.shape[2]
    v0 = torch.rand((n, s), generator=gen, device=dev) * 3
    for k in (1, 16, 20):
        _assert_same(dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, k), _plain_sweeps(sem, grids, v0, None, k))
    policy = torch.randint(-2, a + 2, (n, s), generator=gen, device=dev, dtype=torch.int32)
    clamped = torch.where(policy < 0, policy + a, policy).clamp(0, a - 1)
    _assert_same(dp_grid.grid_sweeps_cuda(sem, grids, v0, policy, 0.99, 7), _plain_sweeps(sem, grids, v0, clamped, 7))
    want = dp_batched.first_argmax(dp_batched._grid_backup(sem, grids, 0.99)(v0)).to(torch.int32)
    greedy, changed = dp_grid.grid_greedy_cuda(sem, grids, v0, 0.99, clamped)
    assert torch.equal(greedy, want) and int(changed) == int(bool((want != clamped).any()))


@pytest.mark.parametrize("a", [9, 25])
def test_grid_kernels_match_plain_at_many_actions(dev, a):
    """K4's VI and PI solves over 4x4 mazes, and its global-memory tier
    (two sidewinder mazes of 65x64 cells) sweep by sweep, at A above 8."""
    from griduniverse_tpu_torch.kernels import dp_grid

    sem = _sem_of(dev, a)
    levels = _maze_levels(dev, (4, 4), 100)
    got = dp_batched.value_iteration_batched_grid(sem, levels)
    ref = dp_batched.value_iteration_batched_grid_reference(sem, levels)
    assert got[2] == ref[2]
    _assert_same(got[:2], ref[:2])
    got = dp_batched.policy_iteration_batched_grid(sem, levels, gamma=0.95)
    ref = dp_batched.policy_iteration_batched_grid_reference(sem, levels, gamma=0.95)
    assert got[2] == ref[2]
    _assert_same(got[:2], ref[:2])
    grids, _ = M.generate_mazes_device(11, (65, 64), 2, "sidewinder", device=dev)
    s = grids.shape[1] * grids.shape[2]
    assert not dp_grid.uses_shared_tier(s)
    gen = torch.Generator(device=dev).manual_seed(a)
    v0 = torch.rand((2, s), generator=gen, device=dev)
    _assert_same(dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 3), _plain_sweeps(sem, grids, v0, None, 3))
    policy = torch.randint(0, a, (2, s), generator=gen, device=dev, dtype=torch.int32)
    _assert_same(dp_grid.grid_sweeps_cuda(sem, grids, v0, policy, 0.99, 2), _plain_sweeps(sem, grids, v0, policy, 2))
    want = dp_batched.first_argmax(dp_batched._grid_backup(sem, grids, 0.99)(v0)).to(torch.int32)
    greedy, changed = dp_grid.grid_greedy_cuda(sem, grids, v0, 0.99, policy)
    assert torch.equal(greedy, want) and int(changed) == int(bool((want != policy).any()))


def _snake_grid(dev, h, w):
    """One h x w maze with walls on every other row, each row open at its
    ends, and the goal in the far corner: a grid of any size, no generator."""
    g = torch.zeros((1, h, w), dtype=torch.int32, device=dev)
    g[0, 1:h - 1:2, 1:w - 1] = 1
    g[0, h - 1, w - 1] = 3
    return g


# K4's cluster tier at one block a maze (131x129), two bands of 81 and 80 rows
# (161x129: no count of blocks divides the height), three bands (401x129),
# fourteen (a 2,000x129 maze, a cluster above the portable eight), at four and
# nine actions; from a random V so that every band edge carries values
@pytest.mark.parametrize("shape,a", [((131, 129, 2), 4), ((161, 129, 2), 4), ((161, 129, 2), 9),
                                     ((401, 129, 1), 4), ((2_000, 129, 1), 4), ((131, 129, 2), 25)])
def test_grid_cluster_tier_matches_plain_and_the_global_tier(dev, shape, a):
    from griduniverse_tpu_torch.kernels import dp_grid

    h, w, n = shape
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    if h == 2_000:
        grids = _snake_grid(dev, h, w)
    else:
        grids, _ = M.generate_mazes_device(h, ((h - 1) // 2, (w - 1) // 2), n, "sidewinder", device=dev)
    cp = dp_grid.cluster_plan(h, w)
    assert dp_grid.grid_tier(h, w) == "cluster" and cp.blocks == {131: 1, 161: 2, 401: 3, 2_000: 14}[h]
    gen = torch.Generator(device=dev).manual_seed(h + a)
    v0 = torch.rand((n, h * w), generator=gen, device=dev) * 10 - 5
    before = kernels.LAUNCHES["dp_grid"]
    got = dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 19)
    assert kernels.LAUNCHES["dp_grid"] == before + 2  # 16 sweeps, then 3
    _assert_same(got, _plain_sweeps(sem, grids, v0, None, 19))
    _assert_same(got, dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 19, tier="global"))
    policy = torch.randint(-1, a + 1, (n, h * w), generator=gen, device=dev, dtype=torch.int32)
    clamped = torch.where(policy < 0, policy + a, policy).clamp(0, a - 1)  # as XLA's gather
    got_e = dp_grid.grid_sweeps_cuda(sem, grids, v0, policy, 0.99, 5)
    _assert_same(got_e, _plain_sweeps(sem, grids, v0, clamped, 5))
    _assert_same(got_e, dp_grid.grid_sweeps_cuda(sem, grids, v0, policy, 0.99, 5, tier="global"))


def test_grid_global_tier_above_a_cluster(dev):
    """A maze that 16 blocks do not hold (2,401x129) keeps the global tier:
    one launch a sweep, the plain version's bits; forcing the cluster tier
    on it raises."""
    from griduniverse_tpu_torch.kernels import dp_grid

    sem = T.make_semantics(device=dev)
    grids = _snake_grid(dev, 2_401, 129)
    assert dp_grid.grid_tier(2_401, 129) == "global"
    v0 = torch.zeros((1, 2_401 * 129), device=dev)
    before = kernels.LAUNCHES["dp_grid"]
    got = dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 5)
    assert kernels.LAUNCHES["dp_grid"] == before + 5
    _assert_same(got, _plain_sweeps(sem, grids, v0, None, 5))
    with pytest.raises(ValueError, match="cluster"):
        dp_grid.grid_sweeps_cuda(sem, grids, v0, None, 0.99, 5, tier="cluster")


@pytest.mark.parametrize("b", [1, 33, 1_536, 65_536])
@pytest.mark.parametrize("a", [4, 9])
def test_td_step_plan_cluster_sizes_give_the_same_bits(dev, b, a):
    """K5's sharded form on clusters of every size that divides its grid (one
    block a cluster is PR 20's form: each block rebuilding all of Q_t and
    flushing all its counters) gives the same Q, state and lanes, step by
    step, and the plain version's."""
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    bl = _levels(dev)["walls16"]
    ts = td_fast.fast_td_init(sem, bl, 4, b)
    blocks = td_fast_kernels.step_blocks(b, ts.q.numel(), True)
    runs = {}
    for cluster in [k for k in (1, 2, 3, 4, 8) if blocks % k == 0]:
        state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                     ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
        plan = td_fast_kernels.TdStepPlan(sem, bl, ts.q, state, 0.2, 0.99, 0.2, 1, 64, cluster=cluster)
        for t in range(40):
            plan.step(t)
        runs[cluster] = (plan.finish(40), *state)
    ref = td_fast.td_scan_fast_sharded_reference(sem, bl, ts, 40, 0.2, 0.99, 0.2, "expected_sarsa", 64,
                                                 _identity_reduce)
    for got in runs.values():
        _assert_same(got, _fast_fields(ref))


def test_td_step_plan_is_stream_ordered(dev):
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    ts = td_fast.fast_td_init(sem, bl, 4, 64)
    state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                 ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
    plan = td_fast_kernels.TdStepPlan(sem, bl, ts.q, state, 0.2, 0.99, 0.2, 0, 64)
    plan.step(0)
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="stream"):
            plan.step(1)
    with pytest.raises(ValueError, match="q_rows"):
        td_fast_kernels.TdStepPlan(sem, bl, ts.q, state, 0.2, 0.99, 0.2, 0, 64, q_rows=(ts.q.cpu(), ts.q.clone()))


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("algo", td_fast.ALGOS)
def test_td_scan_fast_kernel_matches_plain_at_many_actions(dev, a, algo):
    """K5 on walls16 and per-env mazes (Q in shared memory) and on a 32x32
    maze (Q in global memory), one launch a scan, chunked equal to unbroken."""
    sem = _sem_of(dev, a)
    cases = list(_levels(dev).values()) + [_one_maze(dev, (32, 32), 6)]
    for bl in cases:
        ts = td_fast.fast_td_init(sem, bl, 3, None if bl.batched else 1024)
        kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=64)
        before = kernels.LAUNCHES["td_scan_fast"]
        got = td_fast.td_scan_fast(sem, bl, ts, 150, **kw)
        assert kernels.LAUNCHES["td_scan_fast"] == before + 1
        _assert_same(_fast_fields(got), _fast_fields(td_fast.td_scan_fast_reference(sem, bl, ts, 150, **kw)))
        half = td_fast.td_scan_fast(sem, bl, td_fast.td_scan_fast(sem, bl, ts, 50, **kw), 100, **kw)
        _assert_same(_fast_fields(half), _fast_fields(got))


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", td_batched.ALGOS)
@pytest.mark.parametrize("cells,n,tier", [((3, 3), 257, "shared"), ((16, 16), 33, "global")])
def test_td_batched_kernel_matches_plain_at_many_actions(dev, a, algo, dtype, cells, n, tier):
    sem = _sem_of(dev, a)
    levels = _maze_levels(dev, cells, n, seed=n)
    assert td_batched_kernels.plan(levels.num_states, a, dtype, n).tier == tier
    steps = 120
    kw = dict(alpha=0.2, epsilon=0.2, algo=algo, max_episode_steps=40, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(n + a)
    draws = (
        torch.rand((steps, n), generator=gen, device=dev) < 0.2,
        torch.randint(0, a, (steps, n), generator=gen, device=dev, dtype=torch.int32),
        torch.rand((n,), generator=gen, device=dev) < 0.2,
        torch.randint(0, a, (n,), generator=gen, device=dev, dtype=torch.int32),
    )
    for d in (None, draws):
        before = kernels.LAUNCHES["td_batched"]
        got = td_batched.q_learning_batched(sem, levels, 7, steps, draws=d, **kw)
        assert kernels.LAUNCHES["td_batched"] == before + 1
        ref = td_batched.q_learning_batched_reference(sem, levels, 7, steps, draws=d, **kw)
        _assert_same(_batched_fields(got), _batched_fields(ref))


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("level_name", ["walls16", "mazes"])
def test_act_step_kernels_match_plain_at_many_actions(dev, a, level_name):
    """K7b's sampled step (two rollouts of T = 8 through one plan) and its
    greedy step at A above 8, every output equal but logp (2 ulp)."""
    b, t_len, max_ep = 777, 8, 12
    _, bl, st = _act_plan_case(dev, level_name, b)
    sem = _sem_of(dev, a)
    plan = act_kernels.ActStepPlan(sem, bl, b, t_len, max_ep)
    gen = torch.Generator(device=dev).manual_seed(a)
    ref_st = st
    for _ in range(2):
        gumbel = a2c.draw_gumbel(gen, (t_len, b, a), dev)
        plan.begin(st, gumbel)
        refs = []
        for t in range(t_len):
            logits = 2 * torch.randn((b, a), generator=gen, device=dev)
            st = plan.step(t, logits)
            ref_st, *ref = a2c.act_step_reference(sem, bl, ref_st, logits, gumbel[t], max_ep)
            refs.append(ref)
            for f in ("agent_idx", "agent_code", "t", "done"):
                assert torch.equal(getattr(st, f), getattr(ref_st, f)), f
        obs, action, logp, reward, done = plan.rows
        for t, (r_action, r_logp, r_obs, r_reward, r_done) in enumerate(refs):
            _assert_same((action[t], obs[t], reward[t], done[t]), (r_action, r_obs, r_reward, r_done))
            assert logp_within_2ulp(logp[t], r_logp)
    greedy = act_kernels.ActStepPlan(sem, bl, b, 0, None)
    gst = ref_gst = bp.reset_bits(bl, None if bl.batched else b)
    reached = ref_reached = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(20):
        logits = torch.randn((b, a), generator=gen, device=dev)
        gst, reached = a2c.greedy_step(sem, bl, gst, reached, logits, greedy)
        ref_gst, ref_reached = a2c.greedy_step_reference(sem, bl, ref_gst, ref_reached, logits)
        assert torch.equal(reached, ref_reached)
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(gst, f), getattr(ref_gst, f)), f


@pytest.mark.parametrize("a", [9, 25])
def test_dqn_act_step_kernel_matches_plain_at_many_actions(dev, a):
    sem = _sem_of(dev, a)
    bl, b = _levels(dev)["walls16"], 1024
    plan = dqn_act_kernels.DqnActPlan(sem, bl, b, 10)
    gen = torch.Generator(device=dev).manual_seed(a)
    st = ref_st = bp.reset_bits(bl, b)
    stats = ref_stats = (torch.zeros(b, device=dev), torch.zeros((), dtype=torch.int64, device=dev),
                         torch.zeros((), device=dev))
    for _ in range(30):
        q = torch.randint(-2, 3, (b, a), generator=gen, device=dev).float() * 0.5  # ties
        explore = torch.rand(b, generator=gen, device=dev) < 0.3
        rand_a = torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32)
        before = kernels.LAUNCHES["dqn_act"]
        st, *out, r1, r2, r3 = dqn.dqn_act_step(sem, bl, st, q, explore, rand_a, *stats, 10, plan=plan)
        assert kernels.LAUNCHES["dqn_act"] == before + 1
        stats = (r1, r2, r3)
        ref_st, *ref_out, s1, s2, s3 = dqn.dqn_act_step_reference(sem, bl, ref_st, q, explore, rand_a, *ref_stats, 10)
        ref_stats = (s1, s2, s3)
        _assert_same(out, ref_out)
        _assert_same((stats[0], stats[2]), (ref_stats[0], ref_stats[2]))
        assert int(stats[1]) == int(ref_stats[1])
        for f in ("agent_idx", "agent_code", "t", "done"):
            assert torch.equal(getattr(st, f), getattr(ref_st, f)), f


@pytest.mark.parametrize("a", [4, 9, 25])
@pytest.mark.parametrize("form", ["shared level", "staged levels", "device levels"])
def test_rollout_actions_kernel_matches_plain_in_each_level_form(dev, a, form):
    """K2 a warp a block: a shared level in shared memory, a warp's 32
    per-env 4x4 mazes staged in shared memory, and per-env 40x40 mazes
    (411 words a level, above the staged bytes) read from device memory;
    a batch that is not a whole number of warps and T that is not a whole
    number of blocks of staged actions, in the three modes."""
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    b = 777 if form != "device levels" else 45
    if form == "shared level":
        bl = _levels(dev)["walls16"]
    else:
        grids, start = M.generate_mazes_device(3, (4, 4) if form == "staged levels" else (40, 40), b,
                                               "binary_tree", device=dev)
        bl = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    gen = torch.Generator(device=dev).manual_seed(a)
    st = bp.reset_bits(bl, None if bl.batched else b)
    for t_len in (37, 16, 0):
        actions = torch.randint(-1, a + 1, (t_len, b), generator=gen, device=dev, dtype=torch.int32)
        for mode in ((False, None), (True, None), (True, 5)):
            got_state, got = bp.rollout_actions_bits(sem, bl, st, actions, *mode)
            ref_state, ref = bp.rollout_actions_bits_reference(sem, bl, st, actions, *mode)
            _assert_same(got, ref)
            for f in ("agent_idx", "agent_code", "t", "done"):
                assert torch.equal(getattr(got_state, f), getattr(ref_state, f))
            if not mode[0]:
                frozen = got_state
        st = frozen  # the next T from the frozen mode's state: its done envs stay frozen


# ---------------------------------------------------------------------------
# K1's threefry stream, K2 at T = 1 (the compat step), the compat envs
# ---------------------------------------------------------------------------


def _same_state(got, ref):
    for f in ("agent_idx", "agent_code", "t", "done"):
        assert torch.equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("max_ep", [None, 40])
@pytest.mark.parametrize("a", [4, 9])
@pytest.mark.parametrize("b", [1, 33, 4096, 65_536, 65_537])
def test_random_scan_threefry_kernel_matches_plain(dev, b, a, max_ep):
    """K1's threefry instantiation, narrow (4 actions) and wide (9), on a
    shared level and on per-env mazes, from an odd first step and a lane
    offset, against the plain cipher scan bit for bit."""
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    walls = _levels(dev)["walls16"]
    grids, start = M.generate_mazes_device(6, (3, 3), b, "binary_tree", device=dev)
    mazes = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    for bl in (walls, mazes):
        st = bp.reset_bits(bl, None if bl.batched else b)
        keys = bp.ThreefryKeys((0x9E3779B9, 2**32 - 3), step=7, offset=1_000)
        before = kernels.LAUNCHES["random_scan_bits"]
        got = bp.random_scan_bits(sem, bl, st, None, keys, 150, max_ep, "threefry")
        assert kernels.LAUNCHES["random_scan_bits"] == before + 1
        ref = bp.random_scan_bits_reference(sem, bl, st, None, 150, max_ep, "threefry", keys)
        _assert_same(got[1:], ref[1:])
        _same_state(got[0], ref[0])
        assert int(got[1].sum()) > 0 or max_ep is None


@pytest.mark.parametrize("b", [1, 33, 4096, 65_536])
def test_random_scan_threefry_kernel_chunks_and_lanes(dev, b):
    """Two chunks of the kernel equal one run (the second from an odd
    step); two parts of the batch with their lane offsets (split inside a
    warp) equal the whole; rollout_random_bits is one launch."""
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["walls16"]
    st = bp.reset_bits(bl, b)
    one = bp.random_scan_bits(sem, bl, st, None, bp.threefry_keys(5), 1000, 64, "threefry")
    first = bp.random_scan_bits(sem, bl, st, None, bp.threefry_keys(5), 333, 64, "threefry")
    second = bp.random_scan_bits(sem, bl, first[0], None, bp.threefry_keys(5, step=333), 667, 64, "threefry")
    _same_state(one[0], second[0])
    _assert_same((one[1], one[3]), (first[1] + second[1], first[3] + second[3]))
    cut = (1000 * b) // 4096 | 1  # odd: the second part's lanes start inside a warp
    parts = [(o, n) for o, n in ((0, cut), (cut, b - cut)) if n > 0]
    halves = [bp.random_scan_bits(sem, bl, bp.reset_bits(bl, n), None, bp.threefry_keys(5, offset=o), 1000, 64,
                                  "threefry") for o, n in parts]
    for k in range(1, 4):
        _assert_same((one[k],), (torch.cat([h[k] for h in halves]),))
    before = kernels.LAUNCHES["random_scan_bits"]
    _, stats = bp.compile_rollout_random(sem, bl, b, 1000, 64, rng="threefry")(5)
    assert kernels.LAUNCHES["random_scan_bits"] == before + 1
    assert int(stats["episodes"]) == int(one[1].sum())


@pytest.mark.parametrize("mode", [(False, None), (True, None), (True, 20)])
@pytest.mark.parametrize("b", [1, 33, 4096])
def test_rollout_actions_kernel_at_one_step_a_call(dev, b, mode):
    """K2 at T = 1, the compat envs' step: a partial block of staged
    actions on every call and, at B = 1 and 33, a partial warp; 60 calls in
    a row on a shared level and on per-env mazes against the plain version."""
    sem = T.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(b)
    grids, start = M.generate_mazes_device(8, (2, 2), b, "aldous_broder", device=dev)
    mazes = bp.pack_level(T.Level(grid=grids, start_idx=start.expand(b).contiguous()))
    for bl in (_levels(dev)["walls16"], mazes):
        got_st = ref_st = bp.reset_bits(bl, None if bl.batched else b)
        for t in range(60):
            actions = torch.randint(0, 4, (1, b), generator=gen, device=dev, dtype=torch.int32)
            before = kernels.LAUNCHES["rollout_actions_bits"]
            got_st, got = bp.rollout_actions_bits(sem, bl, got_st, actions, *mode)
            assert kernels.LAUNCHES["rollout_actions_bits"] == before + 1
            ref_st, ref = bp.rollout_actions_bits_reference(sem, bl, ref_st, actions, *mode)
            _assert_same(got, ref)
            _same_state(got_st, ref_st)


@pytest.mark.parametrize("shape", ["walls16", "mazes"])
def test_vector_env_on_the_card_equals_its_cpu_run(dev, shape):
    import numpy as np

    from griduniverse_tpu_torch.compat import VectorGridEnv

    b = 2048
    if shape == "walls16":
        level, kw = builders.walls_and_goal_16x16(device=dev), dict(num_envs=b)
    else:
        grids, start = M.generate_mazes_device(2, (3, 3), b, "aldous_broder", device=dev)
        level, kw = T.Level(grid=grids, start_idx=start.expand(b).contiguous()), {}
    card = VectorGridEnv(level, max_episode_steps=64, device=dev, **kw)
    host = VectorGridEnv(level.to("cpu"), max_episode_steps=64, device="cpu", **kw)
    assert card._bl.device.type == "cuda"
    np.testing.assert_array_equal(card.reset(), host.reset())
    rng = np.random.default_rng(0)
    before = kernels.LAUNCHES["rollout_actions_bits"]
    flags = np.zeros(2, np.int64)
    for t in range(200):
        a = rng.integers(0, 4, b)
        got, want = card.step(a), host.step(a)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                                          y.view(np.int32) if y.dtype == np.float32 else y)
        flags += (got[2].sum(), got[3].sum())
    assert kernels.LAUNCHES["rollout_actions_bits"] == before + 200
    assert flags[1] > 0 and (shape == "walls16" or flags[0] > 0)


@pytest.mark.parametrize("form", [dict(grid_shape=(6, 6), walls=[7, 8, 13], lava=[21], goal_states=[35], seed=0),
                                  dict(random_maze=True, grid_shape=(33, 33), seed=2, max_steps=300)])
def test_gym_env_torch_backend_on_the_card_equals_numpy(dev, form):
    from griduniverse_tpu_torch.compat import GridUniverseEnv

    card = GridUniverseEnv(backend="torch", device=dev, **form)
    host = GridUniverseEnv(backend="numpy", **form)
    assert card.level.device.type == "cuda"
    before = kernels.LAUNCHES["rollout_actions_bits"]
    assert card.reset() == host.reset()
    for t in range(500):
        a = card.action_space.sample()
        assert a == host.action_space.sample()
        got = card.step(a)
        assert got == host.step(a), t
        if got[2]:
            assert card.reset() == host.reset()
    assert (card.current_state, card.done) == (host.current_state, host.done)
    assert kernels.LAUNCHES["rollout_actions_bits"] == before + 500


def test_fence_synchronizes_the_card(dev):
    from griduniverse_tpu_torch.utils import profiling

    x = torch.ones(1 << 20, device=dev)
    assert profiling.fence({"x": x})["x"] is x
    dt, out = profiling.time_fn(lambda: x * 2, repeats=3)
    assert dt > 0 and out.device.type == "cuda"


def _identity_reduce(agg):
    """A world of one's all-reduce of the sharded form's aggregate."""
    return agg


@pytest.mark.parametrize("b", [1, 33, 65_536])
@pytest.mark.parametrize("a", [4, 9])
@pytest.mark.parametrize("tier", ["staged", "global"])
def test_td_step_sharded_kernel_matches_plain(dev, b, a, tier):
    """K5's sharded form in a world of one: T + 1 launches, the plain
    version's bits (Q, env state, lanes, accumulators), the cooperative K5's
    bits, and chunked equal to unbroken; Q staged in shared memory (walls16)
    or in global memory (a 65x65 maze)."""
    sem = T.make_semantics(device=dev) if a == 4 else _sem_of(dev, a)
    bl = _levels(dev)["walls16"] if tier == "staged" else _one_maze(dev, (32, 32), 6)
    staged = bl.num_states * a <= td_fast_kernels.MAX_STAGED_ENTRIES
    assert staged == (tier == "staged")
    steps = 60 if b == 65_536 else 150
    for algo in td_fast.ALGOS:
        kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, algo=algo, max_episode_steps=64)
        ts = td_fast.fast_td_init(sem, bl, 3, b)
        before = kernels.LAUNCHES["td_step_sharded"]
        got = td_fast.td_scan_fast_sharded(sem, bl, ts, steps, **kw, all_reduce_sum=_identity_reduce)
        assert kernels.LAUNCHES["td_step_sharded"] == before + steps + 1
        ref = td_fast.td_scan_fast_sharded_reference(sem, bl, ts, steps, **kw, all_reduce_sum=_identity_reduce)
        _assert_same(_fast_fields(got), _fast_fields(ref))
        _assert_same(_fast_fields(got), _fast_fields(td_fast.td_scan_fast(sem, bl, ts, steps, **kw)))
        half = td_fast.td_scan_fast_sharded(sem, bl, ts, steps // 3, **kw, all_reduce_sum=_identity_reduce)
        rest = td_fast.td_scan_fast_sharded(sem, bl, half, steps - steps // 3, **kw,
                                            all_reduce_sum=_identity_reduce)
        _assert_same(_fast_fields(rest), _fast_fields(got))


def test_td_step_sharded_kernel_one_step_matches_plain(dev):
    """One launch against `td_step_sharded_reference` from a random Q and a
    random summed aggregate: Q_t written, the envs stepped in place, the
    step's aggregate added, the next one cleared."""
    sem = T.make_semantics(device=dev)
    bl = _levels(dev)["mazes"]
    gen = torch.Generator(device=dev).manual_seed(3)
    ts = td_fast.fast_td_init(sem, bl, 5, None)
    n = ts.q.numel()
    q_prev = torch.randn(ts.q.shape, generator=gen, device=dev)
    agg_prev = torch.stack([torch.randint(-2**40, 2**40, (n,), generator=gen, device=dev),
                            torch.randint(0, 5, (n,), generator=gen, device=dev)])
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, max_episode_steps=64)
    ref_ts, ref_agg = td_fast.td_step_sharded_reference(sem, bl, q_prev, agg_prev, ts, algo="q_learning", **kw)
    state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                 ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
    q_cur = torch.empty_like(q_prev)
    agg_cur = torch.zeros((2, n), dtype=torch.int64, device=dev)
    agg_clear = torch.ones((2, n), dtype=torch.int64, device=dev)
    td_fast_kernels.td_step_sharded_cuda(sem, bl, q_prev, q_cur, agg_prev, agg_cur, agg_clear, state,
                                         expected_sarsa=0, **kw)
    _assert_same((q_cur, agg_cur, *state), (ref_ts.q, ref_agg, ref_ts.env_state.agent_idx,
                                           ref_ts.env_state.agent_code, ref_ts.env_state.t, ref_ts.rs,
                                           ref_ts.run_ret, ref_ts.n_eps_env, ref_ts.ret_sum_env))
    assert not bool(agg_clear.any())


@pytest.mark.parametrize("b", [1, 4096, 65_536])
@pytest.mark.parametrize("hot", [False, True])
def test_segment_sums_kernel_matches_plain(dev, b, hot):
    """K10's sums form: the env-order float sums and the counts of the plain
    version, masked and not, the plan's launches each; followed by the apply,
    K10's bits."""
    gen = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn((256, 4), generator=gen, device=dev)
    s = torch.randint(0, 256, (b,), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
    if hot:  # most envs in one cell
        in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
        s[in_cell], a[in_cell] = 17, 2
    delta = torch.randn((b,), generator=gen, device=dev)
    mask = torch.rand((b,), generator=gen, device=dev) < 0.5
    before = kernels.LAUNCHES["segment_sums"]
    got = td.segment_sums(s, a, delta, 0.1, 256, 4)
    got_m = td.segment_sums(s, a, delta, 0.1, 256, 4, mask)
    assert kernels.LAUNCHES["segment_sums"] == before + 2 * _k10_launches(dev, b, 1024)
    _assert_same(got, td.segment_sums_reference(s, a, delta, 0.1, 256, 4))
    _assert_same(got_m, td.segment_sums_reference(s, a, delta, 0.1, 256, 4, mask))
    _assert_same((td.apply_segment_sums(q, *got),), (td.apply_td_updates(q, s, a, delta, 0.1),))


# ---------------------------------------------------------------------------
# K10's tiers: one launch of a thread-block cluster, and the four passes


def _k10_edges(dev):
    """(batch, S, A) at each boundary of the plan: the largest call of a lone
    block and of each cluster size, the first call of two blocks and of the
    passes (S·A = 1,024); the largest S·A a cluster block holds, at 4,096
    and 65,536 envs, and one more (4,096 envs)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    most = k10.cluster_blocks(dev)

    def largest(k):  # the largest batch the plan gives at most k blocks
        lo, hi = 1, 16 * k10.MAX_BLOCK_ENVS + 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            p = k10.plan(mid, 1024, sms, most)
            lo, hi = (mid, hi) if p.tier == "cluster" and p.blocks <= k else (lo, mid - 1)
        return lo

    edges = [(largest(k), 256, 4) for k in range(1, most + 1)]
    edges += [(edges[0][0] + 1, 256, 4), (edges[-1][0] + 1, 256, 4)]
    assert k10.plan(edges[-1][0], 1024, sms, most).tier == "passes"
    widest = k10.MAX_CLUSTER_SEGMENTS
    edges += [(4096, widest, 1), (4096, widest + 1, 1), (65_536, widest, 1)]
    return edges


def _k10_held(dev, b, n_states, n_actions, kind, seed):
    """Both forms of K10 on `kind`'s inputs against the plain versions and
    against the passes forced; the launches the plan gives."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n_states, n_actions), generator=gen, device=dev)
    s = torch.randint(0, n_states, (b,), generator=gen, device=dev, dtype=torch.int32)
    a = torch.randint(0, n_actions, (b,), generator=gen, device=dev, dtype=torch.int32)
    if kind == "hot":
        in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
        s[in_cell], a[in_cell] = n_states // 3, 0
    delta = torch.randn((b,), generator=gen, device=dev)
    mask = torch.rand((b,), generator=gen, device=dev) < 0.5 if kind == "masked" else None
    launches = _k10_launches(dev, b, n_states * n_actions)
    before = (kernels.LAUNCHES["segment_mean"], kernels.LAUNCHES["segment_sums"])
    got = td.apply_td_updates(q, s, a, delta, 0.1) if mask is None else td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)
    got_s = td.segment_sums(s, a, delta, 0.1, n_states, n_actions, mask)
    assert (kernels.LAUNCHES["segment_mean"], kernels.LAUNCHES["segment_sums"]) == (before[0] + launches,
                                                                                    before[1] + launches)
    ref_s = td.segment_sums_reference(s, a, delta, 0.1, n_states, n_actions, mask)
    _assert_same(got_s, ref_s)
    _assert_same((got,), (td.apply_segment_sums(q, *ref_s),))
    _assert_same((got,), (k10.segment_mean_cuda(q, s, a, delta, 0.1, mask, tier="passes"),))
    _assert_same(got_s, k10.segment_sums_cuda(s, a, delta, 0.1, n_states, n_actions, mask, tier="passes"))


def test_segment_mean_tiers_at_their_boundaries(dev):
    """Every cluster size the card's plan uses at its largest call, the
    first calls of two blocks and of the passes, and the S·A boundaries."""
    for i, (b, n_states, n_actions) in enumerate(_k10_edges(dev)):
        _k10_held(dev, b, n_states, n_actions, "uniform", i)


def _k10_cases():
    """The paths' batches and tables, S·A up to 2,048 (the cluster's most)
    and 16,900 (the passes'), uniform and masked; hot cells up to 4,096 envs
    and at 25,600 and 65,536 over S·A = 324 (the plain version takes one
    pass a member of the hot cell)."""
    shapes = [(1, 81, 4), (32, 256, 4), (4096, 81, 1), (4096, 256, 4), (4096, 512, 4), (4096, 4225, 4),
              (25_600, 81, 4), (65_536, 81, 4), (65_536, 512, 4), (65_536, 4225, 4), (102_400, 81, 1)]
    cases = [(*shape, kind) for shape in shapes for kind in ("uniform", "masked")]
    return cases + [(*shape, "hot") for shape in shapes if shape[0] <= 4096 or shape[1:] == (81, 4)]


@pytest.mark.parametrize("b,n_states,n_actions,kind", _k10_cases())
def test_segment_mean_cluster_tier_matches_plain(dev, b, n_states, n_actions, kind):
    _k10_held(dev, b, n_states, n_actions, kind, b + n_states)


def test_segment_cluster_shared_bytes_match_the_plan(dev):
    """The source's count of a cluster block's shared bytes is the plan's."""
    import ctypes

    from griduniverse_tpu_torch.kernels import build

    lib = build.load()
    out = ctypes.c_longlong(0)
    for n in (1, 81, 324, 1024, 2048, 16_900):
        assert lib.gu_segment_cluster_bytes(n, ctypes.addressof(out)) == 0
        assert out.value == k10.cluster_shared_bytes(n)
    assert 1 <= k10.cluster_blocks(dev) <= k10.MAX_CLUSTER_BLOCKS


# -- the captured trainers (`utils/capture.py`) ----------------------------------


def _capture_case(dev, name):
    """(run, eager, init, level, cfg, batch, steps) of a small captured trainer."""
    sem = T.make_semantics(device=dev)
    walls = builders.walls_and_goal_16x16(device=dev)
    grids, start = M.generate_mazes_device(5, (4, 4), 512, "backtracker", device=dev)
    mazes = T.Level(grid=grids, start_idx=start.expand(512).contiguous())
    dqn_cfg = dict(buffer_capacity=4096, batch_size_train=128, max_episode_steps=64, hidden=(32,), learn_start=512)
    cases = {
        "dqn uniform": (dqn, walls, dqn.DQNConfig(**dqn_cfg), 1024, 12),
        "dqn per": (dqn, walls, dqn.DQNConfig(**dqn_cfg, prioritized=True), 1024, 12),
        "dqn mazes grid": (dqn, mazes, dqn.DQNConfig(**{**dqn_cfg, "learn_start": 0}, prioritized=True, obs="grid",
                                                     conv_channels=(8,)), 512, 6),
        "ppo target_kl": (ppo, walls, ppo.PPOConfig(rollout_len=4, max_episode_steps=32, hidden=(32,), num_epochs=2,
                                                    num_minibatches=2, target_kl=0.002), 1024, 4),
        "ppo mazes grid": (ppo, mazes, ppo.PPOConfig(rollout_len=4, max_episode_steps=32, obs="grid",
                                                     conv_channels=(8,), hidden=(16,)), 512, 3),
        "a2c": (a2c, walls, a2c.A2CConfig(rollout_len=4, max_episode_steps=32, hidden=(32,)), 1024, 4),
    }
    mod, level, cfg, b, steps = cases[name]
    kind = mod.__name__.rsplit(".", 1)[1]
    run, eager = getattr(mod, f"{kind}_run"), getattr(mod, f"_{kind}_run_eager")
    return sem, run, eager, getattr(mod, f"{kind}_init"), level, cfg, b, steps


def _state_tensors(ts) -> dict:
    """Every tensor of a train state by name, and its ints."""
    out = {}
    for f in ts.__dataclass_fields__:
        x = getattr(ts, f)
        if isinstance(x, dict):
            out.update({f"{f}.{k}": v for k, v in x.items()})
        elif hasattr(x, "__dataclass_fields__"):
            out.update({f"{f}.{k}": v for k, v in _state_tensors(x).items()})
        elif isinstance(x, tuple):
            out.update({f"{f}.{k}": v for k, v in x._asdict().items()})
        else:
            out[f] = x
    return out


def _assert_same_state(got, want):
    a, b = _state_tensors(got), _state_tensors(want)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].device.type == "cuda" and a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
        else:
            assert a[k] == b[k], k


CAPTURE_CASES = ["dqn uniform", "dqn per", "dqn mazes grid", "ppo target_kl", "ppo mazes grid", "a2c"]


@pytest.mark.parametrize("name", CAPTURE_CASES)
def test_captured_run_equals_the_eager_loop(dev, name):
    """One graph replay a step, the same launches as the eager loop's step,
    and the same bits in every state field."""
    sem, run, eager, init, level, cfg, b, steps = _capture_case(dev, name)
    ts0 = init(sem, level, 3, cfg, b)
    kernels.reset_launches()
    capture.reset_counts()
    got = run(sem, level, ts0, cfg, steps)
    torch.cuda.synchronize()
    captured = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert capture.COUNTS == {"captures": 1, "warmup_steps": capture.WARMUP_STEPS, "replays": steps}
    record = capture.LAST[run.__name__]
    assert record.replays == steps and record.capture_ms > 0 and record.pool_bytes > 0
    kernels.reset_launches()
    want = eager(sem, level, ts0, cfg, steps)
    torch.cuda.synchronize()
    plain = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert plain == {k: n * steps for k, n in record.launches.items()}
    assert captured == {k: n * (steps + capture.WARMUP_STEPS) for k, n in record.launches.items()}
    _assert_same_state(got, want)
    _assert_same_state(ts0, init(sem, level, 3, cfg, b))  # the state given is not written


@pytest.mark.parametrize("name", ["dqn per", "ppo target_kl", "a2c"])
def test_captured_runs_are_chunk_invariant(dev, name):
    sem, run, eager, init, level, cfg, b, steps = _capture_case(dev, name)
    ts0 = init(sem, level, 3, cfg, b)
    whole = run(sem, level, ts0, cfg, 2 * steps)
    _assert_same_state(run(sem, level, run(sem, level, ts0, cfg, steps), cfg, steps), whole)
    _assert_same_state(eager(sem, level, ts0, cfg, 2 * steps), whole)


def test_repeated_captured_calls_give_their_memory_back(dev):
    """A call releases the last call's graph and the warm-up's cached
    blocks before it captures, so the card's reserved memory stays flat
    over calls after the first (it grew by a graph pool a call before)."""
    sem, run, eager, init, level, cfg, b, steps = _capture_case(dev, "ppo mazes grid")
    ts0 = init(sem, level, 3, cfg, b)
    reserved = []
    for _ in range(5):
        run(sem, level, ts0, cfg, 1)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert len(set(reserved[1:])) == 1, reserved


def test_captured_run_takes_injected_draws(dev):
    sem, run, eager, init, level, cfg, b, steps = _capture_case(dev, "ppo target_kl")
    ts0 = init(sem, level, 3, cfg, b)
    gen = torch.Generator(device=dev).manual_seed(7)
    gumbel = a2c.draw_gumbel(gen, (steps, cfg.rollout_len, b, sem.num_actions), dev)
    shuffle = torch.randint(0, b, (steps, cfg.num_epochs), generator=gen, device=dev)
    got = run(sem, level, ts0, cfg, steps, gumbel=gumbel, shuffle_draws=shuffle)
    _assert_same_state(got, eager(sem, level, ts0, cfg, steps, gumbel=gumbel, shuffle_draws=shuffle))
    sem, run, eager, init, level, cfg, b, steps = _capture_case(dev, "dqn per")
    ts0 = init(sem, level, 3, cfg, b)
    draws = (torch.rand((steps, b), generator=gen, device=dev) < 0.3,
             torch.randint(0, 4, (steps, b), generator=gen, device=dev, dtype=torch.int32),
             a2c.draw_gumbel(gen, (steps, cfg.buffer_capacity), dev))
    _assert_same_state(run(sem, level, ts0, cfg, steps, draws=draws), eager(sem, level, ts0, cfg, steps, draws=draws))


def test_a_failing_capture_raises(dev):
    """A body that makes a generator, which a capture refuses, raises; so
    does one that reads a tensor on the host (in its warm-up); a later run
    captures as usual."""
    def program(body):
        return lambda: capture.Program(body, seeds=lambda i: i)

    def new_generator(xs, gen, inputs):
        return [xs[0] + torch.rand(4, generator=torch.Generator(device=dev).manual_seed(1), device=dev)]

    def host_read(xs, gen, inputs):
        return [xs[0] + float(xs[0].sum())]

    for body in (new_generator, host_read):
        with pytest.raises(RuntimeError):
            capture.run("failing", [torch.zeros(4, device=dev)], program(body), 3)
    state = capture.run("ok", [torch.zeros(4, device=dev)],
                        program(lambda xs, gen, inputs: [xs[0] + torch.rand(4, generator=gen, device=dev)]), 3)
    want = sum(torch.rand(4, generator=torch.Generator(device=dev).manual_seed(i), device=dev) for i in range(3))
    assert torch.equal(state[0], torch.zeros(4, device=dev) + want)
