"""The host side of K3's, K5's, K6's, K7b's, K7c's, K11's and K13's designs, on the CPU.

  * K5 (`kernels.td_fast`): `grid_plan` puts every env on exactly one
    (thread, walk) of a grid that the card holds at once, an env a thread
    where that grid fits, for odd batches and small and large cards.
  * K7c (`kernels.dqn_act`): `carve` cuts one buffer into the eleven
    outputs as disjoint, 16-byte-aligned views of the plain version's dtypes
    and shapes; `DqnActPlan` raises on a step tensor of another shape, dtype
    or device and on another level; `bind_ring` raises on a ring that B does
    not divide, a field or `prio` of another dtype, device or size, and a
    store-form call on a ring other than the bound one, or on none; and a
    literal walk of the kernel's one
    launch (a tree in each block, then the last block's walk of the blocks'
    sums in tiles) gives `ended_return_sum_reference`'s bits.
  * K6 (`kernels.td_batched`): `plan` picks the tier, the mazes a block in
    shared memory and their bytes, and puts every maze on exactly one thread.
  * K7b (`kernels.act_step`): `carve` cuts one buffer into the trajectory's
    (T, B) rows and two slots of env state as disjoint, 16-byte-aligned views
    of the plain version's dtypes; `ActStepPlan` raises on another level,
    on wrong tensors and off the card, and reads one of its own slots in place.
  * K13 (`kernels.mc_returns`): `plan` puts every episode in exactly one
    block, keeps a block's staged tile within its shared memory and stages
    whole episodes up to T = 5,461 steps (above, one episode a block in
    tiles of 5,461 rows); it picks the measured groups at the trainers'
    shapes; a literal walk of the kernel's cut
    (blocks, tiles from the last, the returns carried across tiles, the
    first-visit test against the staged rows and then the earlier tiles)
    writes every sample once and gives the plain versions' bits.
  * K3 and K11 (`kernels.maze`): `plan` puts every maze on exactly one
    thread of a block of whole warps, never asks for more than the H100's
    227 KB of opt-in shared memory at any maze up to 63×63 cells, and cuts
    the main paths' shapes as measured (`tests/test_torch_maze.py` walks the
    kernels literally).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import griduniverse_tpu_torch as T
from griduniverse_tpu_torch.kernels import act_step as k7b
from griduniverse_tpu_torch.algos import mc
from griduniverse_tpu_torch.kernels import dqn_act
from griduniverse_tpu_torch.kernels import maze as km
from griduniverse_tpu_torch.kernels import mc_returns as k13
from griduniverse_tpu_torch.kernels import td_batched as k6
from griduniverse_tpu_torch.kernels import td_fast as k5
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.models import a2c, dqn
from griduniverse_tpu_torch.ops import bitplane as bp

CPU = torch.device("cpu")

# blocks an SM holds at once, by envs a thread (0: the form with the state in global memory)
H100_LIKE = {1: 2, 0: 2}  # as the H100 80GB HBM3 reports them for a 16x16 level
TIGHT = {1: 1, 0: 3}


@pytest.mark.parametrize("batch", [1, 511, 777, 65_535, 65_536, 135_169, 300_001, 540_673, 1_000_003])
@pytest.mark.parametrize("sms,resident", [(132, H100_LIKE), (3, TIGHT)])
def test_k5_grid_plan_covers_every_env_once(batch, sms, resident):
    plan = k5.grid_plan(batch, sms, resident.__getitem__)
    # a grid barrier must never wait on a block the card cannot hold
    assert 1 <= plan.blocks <= resident[plan.ept] * sms
    envs = k5.thread_envs(plan, batch)
    assert envs.shape == (plan.blocks * k5.THREADS, plan.walks)
    seen = envs[envs >= 0]
    assert seen.numel() == batch and torch.equal(seen.sort().values, torch.arange(batch))
    if plan.ept:
        assert plan.ept == plan.walks == 1 and plan.blocks == -(-batch // k5.THREADS)
    else:
        # an env a thread would not fit the card
        assert -(-batch // k5.THREADS) > resident[1] * sms
        assert plan.blocks == resident[0] * sms and (plan.walks - 1) * plan.blocks * k5.THREADS < batch


def test_k5_grid_plan_refuses_a_kernel_that_fits_no_sm():
    with pytest.raises(RuntimeError):
        k5.grid_plan(10**7, 132, lambda ept: 0)


@pytest.mark.parametrize("b", [1, 5, 16, 777, 65_536, 131_073])
def test_k7c_carve_gives_disjoint_aligned_views(b):
    at, total = dqn_act.output_offsets(b)
    buf = torch.empty(total // 4, dtype=torch.int32)
    outs = dqn_act.carve(buf, b)
    assert len(outs) == len(dqn_act.OUTPUTS) == 11
    spans = []
    for name, x in zip(dqn_act.OUTPUTS, outs):
        offset, dtype, shape = at[name]
        assert x.dtype == dtype and tuple(x.shape) == shape and x.is_contiguous(), name
        start = x.data_ptr() - buf.data_ptr()
        assert start == offset and start % 16 == 0, name
        spans.append((start, start + x.numel() * x.element_size()))
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= total
    assert all(end <= nxt for (_, end), (nxt, _) in zip(spans, spans[1:]))
    # writing each view leaves the others as they were
    for x in outs:
        x.zero_()
    for i, x in enumerate(outs):
        x.fill_(1)
        assert all(bool((y == 0).all()) for j, y in enumerate(outs) if j != i)
        x.zero_()


def test_k7c_carve_matches_the_plain_outputs():
    """The views have the dtypes and shapes of `dqn_act_step_reference`'s
    outputs, in the order the kernel's wrapper returns them."""
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.lava_level(device=CPU))
    b = 37
    st = bp.reset_bits(bl, b)
    new_st, *ref = dqn.dqn_act_step_reference(
        sem, bl, st, torch.zeros(b, 4), torch.zeros(b, dtype=torch.bool), torch.zeros(b, dtype=torch.int32),
        torch.zeros(b), torch.zeros((), dtype=torch.int64), torch.zeros(()), 9)
    ref = [new_st.agent_idx, new_st.agent_code, new_st.t, new_st.done, *ref]
    outs = dqn_act.carve(torch.empty(dqn_act.output_offsets(b)[1] // 4, dtype=torch.int32), b)
    assert [(x.dtype, x.shape) for x in outs] == [(x.dtype, x.shape) for x in ref]


def _step_tensors(b, a=4):
    st = bp.FastState(torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32),
                      torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.bool))
    return dict(q=torch.zeros(b, a), explore=torch.zeros(b, dtype=torch.bool),
                rand_a=torch.zeros(b, dtype=torch.int32), agent_idx=st.agent_idx, agent_code=st.agent_code,
                t=st.t, run_ret=torch.zeros(b), episodes=torch.zeros((), dtype=torch.int64),
                ret_sum=torch.zeros(()))


_FAULTS = {
    "q of another batch": ("q", lambda x: torch.zeros(x.shape[0] + 1, 4)),
    "q of another width": ("q", lambda x: torch.zeros(x.shape[0], 5)),
    "q in float64": ("q", lambda x: x.double()),
    "rand_a in int64": ("rand_a", lambda x: x.long()),
    "explore as uint8": ("explore", lambda x: x.to(torch.uint8)),
    "t of another batch": ("t", lambda x: x[:-1]),
    "run_ret not contiguous": ("run_ret", lambda x: torch.zeros(2 * x.shape[0])[::2]),
    "episodes of shape (1,)": ("episodes", lambda x: x.reshape(1)),
    "ret_sum on another device": ("ret_sum", lambda x: torch.zeros((), device="meta")),
    "agent_idx not a tensor": ("agent_idx", lambda x: x.tolist()),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_k7c_plan_raises_on_a_wrong_step_tensor(fault):
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=CPU))
    b = 77
    plan = dqn_act.DqnActPlan(sem, bl, b, 16)
    good = _step_tensors(b)
    plan.check(tuple(good.values()))  # the plan's own shapes pass
    name, spoil = _FAULTS[fault]
    bad = dict(good, **{name: spoil(good[name])})
    with pytest.raises((ValueError, TypeError), match=name):
        plan.check(tuple(bad.values()))


def test_k7c_plan_raises_on_another_level_and_off_the_card():
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=CPU))
    other = bp.pack_level(builders.lava_level(device=CPU))
    plan = dqn_act.DqnActPlan(sem, bl, 8, 16)
    plan.check_level(sem, bl, 16)
    for args in ((sem, other, 16), (sem, bl, 17), (T.make_semantics(device=CPU), bl, 16)):
        with pytest.raises(ValueError, match="another"):
            plan.check_level(*args)
    with pytest.raises(ValueError):  # the level's own checks run once, when the plan is built
        dqn_act.DqnActPlan(sem, bl, 0, 16)
    t = _step_tensors(8)
    st = bp.FastState(t["agent_idx"], t["agent_code"], t["t"], torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        plan(st, t["q"], t["explore"], t["rand_a"], t["run_ret"], t["episodes"], t["ret_sum"])
    # the learner builds a plan only for a level on the card
    learner = dqn.dqn_learner(sem, builders.walls_and_goal_16x16(device=CPU),
                              dqn.DQNConfig(buffer_capacity=64, max_episode_steps=16), 8)
    assert learner.act_plan is None


def _ring(cap, prio=True):
    buf = dqn.ReplayBuffer(torch.zeros(cap, dtype=torch.int32), torch.zeros(cap, dtype=torch.int32),
                           torch.zeros(cap), torch.zeros(cap, dtype=torch.int32), torch.zeros(cap, dtype=torch.bool))
    return buf, (torch.zeros(cap) if prio else None)


_RING_FAULTS = {
    "a capacity that B does not divide": ("capacity", lambda buf, prio: (dqn.ReplayBuffer(*(x[:60] for x in buf)),
                                                                          prio[:60])),
    "reward in float64": ("buf.reward", lambda buf, prio: (buf._replace(reward=buf.reward.double()), prio)),
    "done as uint8": ("buf.done", lambda buf, prio: (buf._replace(done=buf.done.to(torch.uint8)), prio)),
    "obs on another device": ("buf.obs", lambda buf, prio: (buf._replace(obs=torch.zeros(64, dtype=torch.int32,
                                                                                          device="meta")), prio)),
    "next_obs of another size": ("buf.next_obs", lambda buf, prio: (buf._replace(next_obs=buf.next_obs[:56]), prio)),
    "prio of the wrong size": ("prio", lambda buf, prio: (buf, prio[:56])),
    "prio in float64": ("prio", lambda buf, prio: (buf, prio.double())),
    "prio on another device": ("prio", lambda buf, prio: (buf, torch.zeros(64, device="meta"))),
}


@pytest.mark.parametrize("fault", sorted(_RING_FAULTS))
def test_k7c_plan_raises_on_a_wrong_ring(fault):
    sem = T.make_semantics(device=CPU)
    plan = dqn_act.DqnActPlan(sem, bp.pack_level(builders.walls_and_goal_16x16(device=CPU)), 8, 16)
    buf, prio = _ring(64)
    plan.bind_ring(buf, prio)  # the plan's own shapes pass, with priorities and without
    plan.bind_ring(buf, None)
    name, spoil = _RING_FAULTS[fault]
    with pytest.raises((ValueError, TypeError), match=name):
        plan.bind_ring(*spoil(buf, prio))


def test_k7c_store_form_raises_on_a_ring_it_was_not_bound_to():
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=CPU))
    plan = dqn_act.DqnActPlan(sem, bl, 8, 16)
    t = _step_tensors(8)
    st = bp.FastState(t["agent_idx"], t["agent_code"], t["t"], torch.zeros(8, dtype=torch.bool))
    step = (st, t["q"], t["explore"], t["rand_a"], t["run_ret"], t["episodes"], t["ret_sum"])
    buf, prio = _ring(64)
    at, p_max = torch.zeros((), dtype=torch.int64), torch.ones(())
    with pytest.raises(ValueError, match="no ring"):  # never a write through another path
        plan(*step, ring=(buf, prio, at, p_max))
    plan.bind_ring(buf, prio)
    other, other_prio = _ring(64)
    for ring in ((other, prio), (buf, other_prio), (buf._replace(done=other.done), prio), (buf, None)):
        with pytest.raises(ValueError, match="other tensors"):
            plan(*step, ring=(*ring, at, p_max))
    for bad in ((torch.zeros((), dtype=torch.int32), p_max), (at, torch.ones(1)), (at.reshape(1), p_max)):
        with pytest.raises(ValueError, match="at|p_max"):
            plan(*step, ring=(buf, prio, *bad))
    with pytest.raises(ValueError, match="CUDA"):  # the bound ring and the step's tensors pass
        plan(*step, ring=(buf, prio, at, p_max))
    plan.bind_ring(buf, None)  # without priorities p_max is not read
    with pytest.raises(ValueError, match="CUDA"):
        plan(*step, ring=(buf, None, at, None))
    assert not buf.obs.any() and not prio.any()
    # the public entry: on the CPU the plain composition; a plan it is given must hold the ring
    with pytest.raises(ValueError, match="other tensors"):
        dqn.dqn_act_step(sem, bl, st, t["q"], t["explore"], t["rand_a"], t["run_ret"], t["episodes"],
                         t["ret_sum"], 16, plan=plan, ring=(other, None, at, p_max))


def _one_launch_walk(ended: np.ndarray) -> np.float32:
    """K7c's one launch, literally: each block of CHUNK envs sums its envs
    by a tree in shared memory (envs past B add 0); the last block stages
    the blocks' sums a tile of CHUNK at a time and its thread 0 adds them
    in index order, from 0."""
    chunk = dqn_act.CHUNK
    blocks = -(-ended.shape[0] // chunk)
    partial = np.zeros(blocks, np.float32)
    for blk in range(blocks):
        red = np.zeros(chunk, np.float32)
        part = ended[blk * chunk:(blk + 1) * chunk]
        red[: part.shape[0]] = part
        half = chunk // 2
        while half:
            for i in range(half):
                red[i] = np.float32(red[i] + red[i + half])
            half //= 2
        partial[blk] = red[0]
    total = np.float32(0.0)
    for base in range(0, blocks, chunk):
        tile = partial[base:base + chunk].copy()
        for i in range(tile.shape[0]):
            total = np.float32(total + tile[i])
    return total


@pytest.mark.parametrize("b", [1, 255, 256, 257, 4_097, 65_793])
def test_k7c_one_launch_fold_matches_the_plain_sum(b):
    rng = np.random.default_rng(b)
    ended = np.where(rng.random(b) < 0.3, rng.normal(size=b) * 50, 0.0).astype(np.float32)
    got = dqn.ended_return_sum_reference(torch.as_tensor(ended))
    assert np.float32(got.item()).view(np.int32) == _one_launch_walk(ended).view(np.int32)


# K6: (states, dtype) -> (tier, mazes a block, all in shared memory, their bytes) at N = 65,536
_K6_TIERS = {
    # 64 tables a block, two blocks an SM: one warp a scheduler, four waves (160 fit an SM: four waves too)
    "9x9 float32": (81, "float32", "shared", 64, 64 * 1296 + 64 * 4 * 6),
    # 128 a block, two an SM: two warps a scheduler, two waves (320 fit an SM: two waves of three)
    "9x9 bfloat16": (81, "bfloat16", "shared", 128, 128 * 648 + 128 * 4 * 6),
    "33x33 float32": (1089, "float32", "global", 0, 0),
    "33x33 bfloat16": (1089, "bfloat16", "global", 0, 0),
    "161x129 float32": (161 * 129, "float32", "global", 0, 0),
    "161x129 bfloat16": (161 * 129, "bfloat16", "global", 0, 0),
}


@pytest.mark.parametrize("case", sorted(_K6_TIERS))
def test_k6_plan_picks_the_tier(case):
    states, dtype, tier, mazes, nbytes = _K6_TIERS[case]
    p = k6.plan(states, 4, dtype, 65_536)
    assert (p.tier, p.shared_bytes) == (tier, nbytes)
    itemsize = 4 if dtype == "float32" else 2
    if tier == "shared":
        assert (p.threads, p.blocks) == (mazes, 65_536 // mazes)
        # the most that fit a block: 160 float32 tables, 320 bfloat16
        most = 160 if dtype == "float32" else 320
        assert k6.shared_bytes(most + 32, states, 4, itemsize) > k6.SHARED_BYTES >= k6.shared_bytes(most, states, 4, itemsize)
    else:
        assert p == k6.global_plan(65_536)
        assert (p.threads, p.blocks) == (k6.GLOBAL_THREADS, 65_536 // k6.GLOBAL_THREADS)
        # not even 32 tables fit a block
        assert k6.shared_bytes(32, states, 4, itemsize) > k6.SHARED_BYTES


@pytest.mark.parametrize("n", [1, 5, 31, 32, 161, 4_097, 65_536, 100_003])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the H100 SXM's 132 SMs (the default), its PCIe form's 114, a card of 66 and of 1
@pytest.mark.parametrize("options", [{}, {"sms": 1}, {"tier": "global"}, {"sms": 114}, {"sms": 66}], ids=str)
def test_k6_plan_covers_every_maze_once(n, dtype, options):
    p = k6.global_plan(n) if options.get("tier") == "global" else k6.plan(81, 4, dtype, n, **options)
    assert p.tier == options.get("tier", "shared")
    # the maze each thread runs (maze b·threads + i in thread i of block b), -1 for none
    slots = torch.arange(p.blocks * p.threads).reshape(p.blocks, p.threads)
    slots = torch.where(slots < n, slots, -1)
    assert slots.shape == (p.blocks, p.threads)
    seen = slots[slots >= 0]
    assert seen.numel() == n and torch.equal(seen.sort().values, torch.arange(n))
    assert (p.blocks - 1) * p.threads < n  # no block without a maze
    assert 32 <= p.threads <= k6.MAX_THREADS and p.threads % 32 == 0  # whole warps
    itemsize = 4 if dtype == "float32" else 2
    if p.tier == "shared":  # every maze of a block in shared memory
        assert p.shared_bytes == k6.shared_bytes(p.threads, 81, 4, itemsize) <= k6.SHARED_BYTES
    else:
        assert p.shared_bytes == 0


@pytest.mark.parametrize("t,b", [(1, 1), (16, 5), (16, 777), (16, 65_536), (0, 4_096), (7, 130)])
def test_k7b_carve_gives_disjoint_aligned_views(t, b):
    pieces, total = k7b.layout(t, b)
    buf = torch.empty(total // 4, dtype=torch.int32)
    views = k7b.carve(buf, t, b)
    assert len(views) == len(k7b.ROWS) + 2 * len(k7b.SLOT) == len(pieces)
    spans = []
    for x, (offset, dtype, shape) in zip(views, pieces):
        assert x.dtype == dtype and tuple(x.shape) == shape and x.is_contiguous()
        if x.numel():  # an empty row (t = 0, the greedy form's plan) has no data
            start = x.data_ptr() - buf.data_ptr()
            assert start == offset and start % 16 == 0
            spans.append((start, start + x.numel() * x.element_size()))
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= total
    assert all(end <= nxt for (_, end), (nxt, _) in zip(spans, spans[1:]))
    for x in views:
        x.zero_()
    for i, x in enumerate(views):
        x.fill_(1)
        assert all(bool((y == 0).all()) for j, y in enumerate(views) if j != i)
        x.zero_()


def test_k7b_rows_match_the_plain_outputs():
    """The rows have the dtypes of `act_step_reference`'s outputs stacked
    over T, and a slot those of its state."""
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.lava_level(device=CPU))
    b, t_len = 37, 3
    st = bp.reset_bits(bl, b)
    new_st, action, logp, obs, reward, done = a2c.act_step_reference(sem, bl, st, torch.zeros(b, 4),
                                                                      torch.zeros(b, 4), 9)
    plan = k7b.ActStepPlan(sem, bl, b, t_len, 9)
    want = [(x.dtype, (t_len, b)) for x in (obs, action, logp, reward, done)]
    assert [(x.dtype, tuple(x.shape)) for x in plan.rows] == want
    fields = ("agent_idx", "agent_code", "t", "done")
    for k in (0, 1):
        assert [(getattr(plan.states[k], f).dtype, getattr(plan.states[k], f).shape) for f in fields] == \
            [(getattr(new_st, f).dtype, getattr(new_st, f).shape) for f in fields]
        assert plan.reached[k].dtype == torch.bool and plan.reached[k].shape == (b,)


def test_k7b_plan_raises_on_another_level_and_off_the_card():
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=CPU))
    b = 8
    plan = k7b.ActStepPlan(sem, bl, b, 4, 16)
    plan.check_level(sem, bl, 16)
    for args in ((sem, bp.pack_level(builders.lava_level(device=CPU)), 16), (sem, bl, 17),
                 (T.make_semantics(device=CPU), bl, 16)):
        with pytest.raises(ValueError, match="another"):
            plan.check_level(*args)
    with pytest.raises(ValueError):  # the level's own checks run once, when the plan is built
        k7b.ActStepPlan(sem, bl, 0, 4, 16)
    st = bp.reset_bits(bl, b)
    for gumbel in (torch.zeros(3, b, 4), torch.zeros(4, b, 4).double(), torch.zeros(4, b, 5)):
        with pytest.raises(ValueError, match="gumbel"):
            plan.begin(st, gumbel)
    with pytest.raises(ValueError, match="agent_idx"):
        plan.begin(bp.FastState(st.agent_idx[:-1], st.agent_code, st.t, st.done), torch.zeros(4, b, 4))
    plan.begin(st, torch.zeros(4, b, 4))
    for logits in (torch.zeros(b, 5), torch.zeros(b, 4).double(), torch.zeros(2 * b, 4)[::2], [0.0] * b):
        with pytest.raises((ValueError, TypeError), match="logits"):
            plan.step(0, logits)
    with pytest.raises(ValueError, match="CUDA"):
        plan.step(0, torch.zeros(b, 4))
    with pytest.raises(ValueError, match="CUDA"):
        plan.greedy(st, torch.zeros(b, dtype=torch.bool), torch.zeros(b, 4))
    # the learners build a plan only for a level on the card
    learner = a2c.a2c_learner(sem, builders.walls_and_goal_16x16(device=CPU), a2c.A2CConfig(), b)
    assert learner.act_plan is None


def test_k7b_plan_reads_its_own_slot_in_place():
    """A state the plan returned is read from its slot and the other slot
    written; the caller's state is checked and slot 0 written."""
    sem = T.make_semantics(device=CPU)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=CPU))
    plan = k7b.ActStepPlan(sem, bl, 8, 4, None)
    st = bp.reset_bits(bl, 8)
    ptrs, out = plan._source(st)
    assert out == 0 and ptrs == (st.agent_idx.data_ptr(), st.agent_code.data_ptr(), st.t.data_ptr())
    for k in (0, 1):
        slot = [getattr(plan.states[k], f).data_ptr() for f in ("agent_idx", "agent_code", "t", "done")]
        ptrs, out = plan._source(plan.states[k])
        assert out == 1 - k and ptrs == tuple(slot[:3])
        ptrs, out = plan._source(plan.states[k], plan.reached[k])
        assert out == 1 - k and ptrs == (*slot, plan.reached[k].data_ptr())


@pytest.mark.parametrize("t", [1, 31, 33, 100, 257, 1_000, 4_096, 5_461, 5_462, 20_000])
@pytest.mark.parametrize("b", [1, 33, 256, 1_024, 4_097, 65_536])
def test_k13_plan_covers_every_episode_once(t, b):
    p = k13.plan(t, b)
    # block k takes episodes k·group .. k·group + group − 1 below B
    starts = np.arange(p.blocks) * p.group
    episodes = np.concatenate([np.arange(s0, min(s0 + p.group, b)) for s0 in starts])
    assert np.array_equal(episodes, np.arange(b))
    assert (p.blocks - 1) * p.group < b  # no block without an episode
    assert 1 <= p.group <= k13.MAX_GROUP and p.group & (p.group - 1) == 0
    # the tiles cover the steps once, and a block's tile fits its shared memory
    assert 1 <= p.tile <= t and (-(-t // p.tile) - 1) * p.tile < t
    assert p.shared == k13.BYTES_PER_CELL * p.tile * p.group <= k13.SHARED_BYTES
    if t <= 4_096:  # whole episodes: the first-visit test reads no device memory
        assert p.tile == t
    if b >= k13.MAX_GROUP * k13.TARGET_BLOCKS and t * k13.MAX_GROUP * k13.BYTES_PER_CELL <= k13.SHARED_BYTES:
        assert p.group == k13.MAX_GROUP  # wide calls stage 128 bytes of rewards a row


# (T, B): the groups the plan picks at the trainers' shapes (the measured optimum)
_K13_GROUPS = {(100, 256): 2, (100, 1_024): 4, (100, 4_096): 16, (100, 65_536): 32, (1_000, 4_097): 4,
               (4_096, 8): 1, (170, 2_048): 8, (170, 8_192): 32, (171, 8_192): 16, (2_730, 9): 2, (2_731, 9): 1}


@pytest.mark.parametrize("shape", sorted(_K13_GROUPS))
def test_k13_plan_picks_the_group(shape):
    p = k13.plan(*shape)
    assert p.group == _K13_GROUPS[shape]
    assert p.blocks == -(-shape[1] // p.group)


@pytest.mark.parametrize("t", [5_462, 6_000, 10_922, 10_923, 20_000])
def test_k13_plan_cuts_long_episodes_into_tiles(t):
    """Above 5,461 steps not even one episode fits a block's shared memory:
    one episode a block, its steps in tiles of 5,461 rows from the first."""
    p = k13.plan(t, 3)
    assert p.group == 1 and p.blocks == 3
    assert p.tile == k13.SHARED_BYTES // k13.BYTES_PER_CELL == 5_461
    assert -(-t // p.tile) == (2 if t <= 10_922 else 3 if t <= 16_383 else 4)


def _k13_walk(p, rewards, gamma, ids, valid):
    """`csrc/mc_returns.cu` walked literally on numpy arrays: block by block,
    each block's tiles from the last; the staged tile's returns from its last
    row up with G carried across tiles (float32, the multiply and the add
    rounded apart); each valid step tested against the staged earlier rows
    and then the earlier tiles' rows in device memory. Returns (returns,
    mask, writes of each sample)."""
    t, b = rewards.shape
    returns = np.zeros((t, b), np.float32)
    mask = np.zeros((t, b), bool)
    writes = np.zeros((t, b), np.int64)
    gamma = np.float32(gamma)
    for block in range(p.blocks):
        b0 = block * p.group
        cols = slice(b0, min(b0 + p.group, b))
        g = np.zeros(cols.stop - b0, np.float32)
        for j in reversed(range(-(-t // p.tile))):
            t0 = j * p.tile
            rows = slice(t0, min(t0 + p.tile, t))
            r_s, id_s, v_s = rewards[rows, cols].copy(), ids[rows, cols], valid[rows, cols]
            for r in reversed(range(r_s.shape[0])):
                g = r_s[r] + gamma * g
                r_s[r] = g
            for r in range(r_s.shape[0]):
                for c in range(r_s.shape[1]):
                    first = bool(v_s[r, c])
                    if first:
                        first = not np.any(v_s[:r, c] & (id_s[:r, c] == id_s[r, c]))
                    if first and t0:
                        first = not np.any(valid[:t0, b0 + c] & (ids[:t0, b0 + c] == id_s[r, c]))
                    mask[t0 + r, b0 + c] = first
            returns[rows, cols] = r_s
            writes[rows, cols] += 1
    return returns, mask, writes


@pytest.mark.parametrize("t,b", [(1, 1), (7, 5), (33, 33), (100, 19), (100, 256), (100, 1_024), (3_000, 2),
                                 (6_000, 2)])
def test_k13_literal_walk_matches_the_plain_versions(t, b):
    rng = np.random.default_rng(t * 1000 + b)
    valid = np.arange(t)[:, None] < rng.integers(0, t + 1, b)[None]
    rewards = np.where(valid, rng.standard_normal((t, b)), 0.0).astype(np.float32)
    ids = rng.integers(0, max(2, t // 3), (t, b)).astype(np.int32)
    ids[:, 0] = 5  # one episode of one id
    p = k13.plan(t, b)
    got, got_mask, writes = _k13_walk(p, rewards, 0.99, ids, valid)
    assert (writes == 1).all()
    want = mc.discounted_returns(torch.from_numpy(rewards), 0.99).numpy()
    want_mask = mc.first_visit_mask(torch.from_numpy(ids), torch.from_numpy(valid)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got_mask, want_mask)


@pytest.mark.parametrize("batch", [1, 31, 33, 1_024, 4_097, 65_536])
def test_maze_plan_covers_every_maze_once_and_fits(batch):
    """Every maze shape the port packs, up to 63x63 cells: walking thread t
    of block k is maze k·32·warps + t below B."""
    for ch in range(1, 64):
        for cw in range(1, 64):
            p = km.plan((ch, cw), batch)
            per_block = 32 * p.warps
            assert p.warps in (1, 2, 4)
            assert p.shared == per_block * 4 * ch * -(-cw // 8) <= km.SHARED_LIMIT == 232_448
            assert (p.blocks - 1) * per_block < batch <= p.blocks * per_block  # no block without a maze
            if p.warps > 1:  # more warps a block only while the blocks still fill the card
                assert p.blocks >= km.TARGET_BLOCKS
    for cells in ((1, 1), (4, 4), (32, 32), (63, 63)):
        p = km.plan(cells, batch)
        per_block = 32 * p.warps
        b = (np.arange(p.blocks)[:, None] * per_block + np.arange(per_block)[None, :]).ravel()
        assert np.array_equal(b[b < batch], np.arange(batch))


# (cells, B): the warps a block the plan gives the main paths' shapes
_MAZE_PLANS = {((4, 4), 65_536): 4, ((16, 16), 8_192): 1, ((32, 32), 65_536): 4, ((63, 63), 1_024): 1,
               ((32, 32), 256): 1, ((63, 63), 65_536): 2, ((2, 2), 4_096): 1, ((6, 6), 512): 1}


@pytest.mark.parametrize("shape", sorted(_MAZE_PLANS))
def test_maze_plan_picks_the_warps(shape):
    p = km.plan(*shape)
    assert p.warps == _MAZE_PLANS[shape]
    assert p.blocks == -(-shape[1] // (32 * p.warps))


# (cells, B): mazes above 63x63 cells. 32 trees fit a block up to ch·⌈cw/8⌉
# = 1,814 words (about 120x120 cells), one up to 58,048 (680x680 square,
# or 58,048 rows of one cell, the most words a one-maze block holds beside
# the kernels' static shared memory); above, the trees live in device memory.
_BIG_MAZES = [((64, 64), 33), ((64, 1), 33), ((100, 100), 4), ((121, 121), 70), ((200, 200), 2),
              ((680, 680), 3), ((58_048, 1), 2), ((681, 681), 2), ((64, 64), 65_536), ((120, 120), 10_000)]


@pytest.mark.parametrize("cells,batch", _BIG_MAZES)
def test_maze_plan_above_63_covers_every_maze_once_or_names_the_device_tier(cells, batch):
    p = km.plan(cells, batch)
    words = km.tree_words(cells)
    room = km.SHARED_LIMIT - km.STATIC_SHARED
    if 4 * words > room:  # not even one tree fits: the device tier, a maze a block
        assert (p.mazes, p.blocks, p.shared, p.scratch) == (1, batch, 0, batch * words)
        return
    assert p.scratch == 0
    assert p.mazes in (1, 2, 4, 8, 16, 32, 64, 128)
    assert p.shared == p.mazes * 4 * words <= room == 232_448 - 256
    assert 2 * p.shared > room or p.mazes >= 32  # below a warp, only where twice as many do not fit
    assert (p.blocks - 1) * p.mazes < batch <= p.blocks * p.mazes
    b = (np.arange(p.blocks)[:, None] * p.mazes + np.arange(p.mazes)[None, :]).ravel()
    assert np.array_equal(b[b < batch], np.arange(batch))
    assert p.warps == -(-p.mazes // 32)


@pytest.mark.parametrize("cells,mazes", [((64, 64), 64), ((121, 121), 16), ((200, 200), 8), ((680, 680), 1),
                                         ((58_048, 1), 1), ((58_049, 1), 0), ((681, 681), 0)])
def test_maze_plan_mazes_a_block_above_63(cells, mazes):
    """0: the device tier."""
    p = km.plan(cells, 1 << 20)
    assert (p.mazes if p.scratch == 0 else 0) == mazes


def test_maze_plan_device_tier_follows_the_shared_limit(monkeypatch):
    monkeypatch.setattr(km, "SHARED_LIMIT", 1024 + km.STATIC_SHARED)
    p = km.plan((64, 64), 5)  # 2,048 bytes a tree
    assert (p.mazes, p.blocks, p.shared, p.scratch) == (1, 5, 0, 5 * 512)
    assert km.plan((16, 16), 5).mazes == 8  # 128 bytes a tree: 8 fit, a warp's 32 do not


def test_maze_plan_refuses_a_bad_batch():
    with pytest.raises(ValueError):
        km.plan((4, 4), 0)


@pytest.mark.parametrize("batch,n_entries", [(1, 1_024), (33, 1_024), (512, 16_900), (65_536, 1_024),
                                             (65_536, 16_900), (1_000_003, 2_304)])
def test_k5_sharded_form_launches_cover_every_env_and_entry(batch, n_entries):
    """K5's sharded form: a step launch has a thread for every env (and at
    least one block to write Q_t over its grid-stride loop); the last
    launch, which only writes Q_T, has a thread for every entry."""
    blocks = k5.step_blocks(batch, n_entries, act=True)
    assert (blocks - 1) * k5.THREADS < batch <= blocks * k5.THREADS
    final = k5.step_blocks(batch, n_entries, act=False)
    assert (final - 1) * k5.THREADS < n_entries <= final * k5.THREADS


def test_k5_sharded_form_rotates_three_aggregates():
    """Each step's aggregate is added at step t, summed over the ranks, read
    at t + 1 and cleared at t + 2, before step t + 3 adds to it again: no
    launch reads, adds to and clears the same row, and the row a launch adds
    to was cleared by the launch before (the first two start clear)."""
    slots = [k5.step_slots(t) for t in range(12)]
    assert slots[0][0] is None
    for t, (prev, cur, clear) in enumerate(slots):
        assert len({cur, clear} | ({prev} - {None})) == (2 if prev is None else 3)
        if t >= 2:
            assert slots[t - 1][2] == cur
        if t >= 1:
            assert prev == slots[t - 1][1]
