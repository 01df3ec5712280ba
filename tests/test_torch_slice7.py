"""Port parity of the last two TPU-shaped loops and of K4's global tier, on
the CPU against the JAX package.

  * K7c (`models.dqn.dqn_act_step`): the plain version against the lines of
    the reference's DQN train body (argmax, `where`, `step_bits`, the episode
    statistics) on the same inputs, step after step: every discrete output,
    the running returns and the episode count equal exactly, `ret_sum` to
    rtol 1e-6 (the two sum the ended returns in another order). Its fixed
    order of adds is held bit for bit against a NumPy float32 walk.
  * K13 (`algos.mc.mc_returns`): `discounted_returns` against the
    reference's reverse scan to rtol 1e-6 (XLA's CPU backend may fuse the
    multiply-add; against a NumPy float32 walk with two roundings it is
    bit-exact), `first_visit_mask` exactly.
  * K4 above 16,384 states a maze: the plain grid-form VI and PI against the
    reference's on two sidewinder mazes of 16,899 states, V to atol 1e-4 and
    the policy wherever the best two action values are apart; and which tier
    the wrapper picks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import algos as ja
from griduniverse_tpu.algos import mc as jmc
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu.ops import bitplane as jbp
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch import kernels
from griduniverse_tpu_torch.algos import dp_batched as tdb
from griduniverse_tpu_torch.algos import mc as tmc
from griduniverse_tpu_torch.kernels import dp_grid, dqn_act, mc_returns
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tmz
from griduniverse_tpu_torch.models import a2c as ta2c
from griduniverse_tpu_torch.models import dqn as tdqn
from griduniverse_tpu_torch.ops import bitplane as tbp
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")
JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


# ---------------------------------------------------------------------------
# K7c: DQN's ε-greedy act, step and episode statistics
# ---------------------------------------------------------------------------


def _jax_body(bl, st, q, explore, rand_a, run_ret, n_eps, ret_sum, max_ep):
    """`_make_train_body`'s act and step (347-357) and its episode
    statistics (418-422), as written there."""
    greedy = jnp.argmax(q, axis=-1).astype(jnp.int32)
    actions = jnp.where(explore, rand_a, greedy)
    st, (next_obs, reward, done) = jbp.step_bits(JSEM, bl, st, actions, True, max_ep)
    run_ret = run_ret + reward
    n_eps = n_eps + jnp.sum(done, dtype=jnp.int32)
    ret_sum = ret_sum + jnp.sum(jnp.where(done, run_ret, 0.0))
    run_ret = jnp.where(done, 0.0, run_ret)
    return st, actions, next_obs, reward, done, run_ret, n_eps, ret_sum


def _levels(name):
    if name == "walls16":
        return jb.walls_and_goal_16x16(), 512
    if name == "lava":
        return jb.lava_level(), 512
    grids, start = tmz.generate_mazes_device(3, (2, 2), 256, "binary_tree", device=CPU)
    return J.Level(grid=jnp.asarray(grids.numpy()), start_idx=jnp.full((256,), int(start), jnp.int32)), 256


@pytest.mark.parametrize("name,q_dtype", [("walls16", "float32"), ("lava", "float32"),
                                          ("mazes", "float32"), ("lava", "bfloat16")])
def test_dqn_act_step_matches_the_reference_body(name, q_dtype):
    jlevel, b = _levels(name)
    jbl = jbp.pack_level(jlevel)
    tbl = convert.to_bit_level(jbl, device=CPU)
    jst = jbp.reset_bits(jbl, None if jbl.batched else b)
    tst = convert.to_fast_state(jst, device=CPU)
    rng = np.random.default_rng(7)
    max_ep = 6
    run_ret_j, n_eps_j, ret_sum_j = jnp.zeros(b, jnp.float32), jnp.int32(0), jnp.float32(0.0)
    run_ret_t = torch.zeros(b)
    n_eps_t, ret_sum_t = torch.zeros((), dtype=torch.int64), torch.zeros(())
    terminal_ends = truncations = 0
    for _ in range(25):
        # many ties: q takes five values, each exactly a bfloat16
        q = (rng.integers(-2, 3, (b, 4)) * 0.5).astype(np.float32)
        explore = rng.random(b) < 0.5
        rand_a = rng.integers(0, 4, b).astype(np.int32)
        t_before = np.asarray(jst.t)
        jout = _jax_body(jbl, jst, jnp.asarray(q), jnp.asarray(explore), jnp.asarray(rand_a),
                         run_ret_j, n_eps_j, ret_sum_j, max_ep)
        tq = torch.as_tensor(q).to(getattr(torch, q_dtype))
        tout = tdqn.dqn_act_step(TSEM, tbl, tst, tq, torch.as_tensor(explore), torch.as_tensor(rand_a),
                                 run_ret_t, n_eps_t, ret_sum_t, max_ep)
        jst, run_ret_j, n_eps_j, ret_sum_j = jout[0], jout[5], jout[6], jout[7]
        tst, run_ret_t, n_eps_t, ret_sum_t = tout[0], tout[5], tout[6], tout[7]
        for f in ("agent_idx", "agent_code", "t", "done"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), f)
        for label, x, y in zip(("action", "next_obs", "reward", "done", "run_ret"), tout[1:6], jout[1:6]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), label)
        assert tout[1].dtype == torch.int32 and tout[2].dtype == torch.int32
        assert int(n_eps_t) == int(n_eps_j) and n_eps_t.dtype == torch.int64
        np.testing.assert_allclose(float(ret_sum_t), float(ret_sum_j), rtol=1e-6)
        done = np.asarray(jout[4])
        truncations += int((done & (t_before + 1 >= max_ep)).sum())
        terminal_ends += int((done & (t_before + 1 < max_ep)).sum())
    # walls16's goal is out of reach in six steps; lava and the small mazes end both ways
    assert truncations > 0 and (terminal_ends > 0 or name == "walls16")
    assert int(n_eps_t) == truncations + terminal_ends


def test_dqn_act_step_takes_the_first_maximum():
    """`torch.argmax`'s tie rule, which the kernel copies: the lowest index."""
    jlevel, b = jb.walls_and_goal_16x16(), 4
    tbl = convert.to_bit_level(jbp.pack_level(jlevel), device=CPU)
    st = tbp.reset_bits(tbl, b)
    q = torch.tensor([[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 1.0], [3.0, 0.0, 0.0, 3.0], [-1.0, -1.0, -1.0, 0.0]])
    out = tdqn.dqn_act_step(TSEM, tbl, st, q, torch.zeros(b, dtype=torch.bool), torch.full((b,), 3, dtype=torch.int32),
                            torch.zeros(b), torch.zeros((), dtype=torch.int64), torch.zeros(()))
    assert out[1].tolist() == [0, 1, 0, 3]
    out = tdqn.dqn_act_step(TSEM, tbl, st, q, torch.ones(b, dtype=torch.bool), torch.full((b,), 3, dtype=torch.int32),
                            torch.zeros(b), torch.zeros((), dtype=torch.int64), torch.zeros(()))
    assert out[1].tolist() == [3, 3, 3, 3]


def _walk_sum(ended: np.ndarray) -> np.float32:
    """K7c's order in NumPy float32: a tree in each chunk, then the chunks."""
    chunk = dqn_act.CHUNK
    n = -(-ended.shape[0] // chunk)
    x = np.zeros(n * chunk, np.float32)
    x[: ended.shape[0]] = ended
    x = x.reshape(n, chunk)
    half = chunk // 2
    while half:
        x = (x[:, :half] + x[:, half:2 * half]).astype(np.float32)
        half //= 2
    total = np.float32(0.0)
    for c in range(n):
        total = np.float32(total + x[c, 0])
    return total


@pytest.mark.parametrize("b", [1, 64, 300, 1000])
def test_ended_return_sum_order(b):
    rng = np.random.default_rng(b)
    ended = np.where(rng.random(b) < 0.3, rng.normal(size=b) * 50, 0.0).astype(np.float32)
    got = tdqn.ended_return_sum_reference(torch.as_tensor(ended))
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.float32(got.item()).view(np.int32) == _walk_sum(ended).view(np.int32)
    np.testing.assert_allclose(got.item(), ended.astype(np.float64).sum(), rtol=1e-5, atol=1e-4)


def test_dqn_act_step_statistics_match_fold_episode_stats():
    """K7c's statistics against the fold that PPO and A2C keep using, on the
    step's own rewards and ends: the same running returns and count, the
    sum to rtol 1e-6 (another order of adds)."""
    level = tb.lava_level(device=CPU)
    bl = tbp.pack_level(level)
    b = 700
    st = tbp.reset_bits(bl, b)
    rng = np.random.default_rng(5)
    stats = (torch.zeros(b), torch.zeros((), dtype=torch.int64), torch.zeros(()))
    folded = stats
    for _ in range(30):
        q = torch.as_tensor(rng.normal(size=(b, 4)).astype(np.float32))
        explore = torch.as_tensor(rng.random(b) < 0.6)
        rand_a = torch.as_tensor(rng.integers(0, 4, b).astype(np.int32))
        st, _, _, reward, done, *stats = tdqn.dqn_act_step(TSEM, bl, st, q, explore, rand_a, *stats, 9)
        folded = ta2c.fold_episode_stats(*folded, reward[None], done[None])
        assert torch.equal(stats[0], folded[0]) and int(stats[1]) == int(folded[1])
        np.testing.assert_allclose(float(stats[2]), float(folded[2]), rtol=1e-6)
    assert int(stats[1]) > 50


# ---------------------------------------------------------------------------
# K13: the returns and the first-visit mask
# ---------------------------------------------------------------------------


def _episodes(rng, t, b, num_ids):
    lengths = rng.integers(0, t + 1, b)
    steps = np.arange(t)[:, None]
    valid = steps < lengths[None, :]
    rewards = np.where(valid, rng.normal(size=(t, b)), 0.0).astype(np.float32)
    ids = rng.integers(0, num_ids, (t, b)).astype(np.int32)
    return rewards, ids, valid


def _walk_returns(rewards: np.ndarray, gamma: float) -> np.ndarray:
    """The reverse pass in NumPy float32, the multiply and the add rounded
    separately, as the kernel does."""
    g = np.zeros(rewards.shape[1], np.float32)
    out = np.empty_like(rewards)
    gam = np.float32(gamma)
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = (rewards[t] + (gam * g).astype(np.float32)).astype(np.float32)
        out[t] = g
    return out


@pytest.mark.parametrize("t", [1, 7, 100])
@pytest.mark.parametrize("ids", ["states", "state_actions"])
def test_mc_returns_and_first_visit_match_jax(t, ids):
    rng = np.random.default_rng(t)
    num_ids = 81 if ids == "states" else 81 * 4
    rewards, id_arr, valid = _episodes(rng, t, 64, num_ids)
    g, mask = tmc.mc_returns(torch.as_tensor(rewards), 0.99, torch.as_tensor(id_arr), torch.as_tensor(valid))
    jg = jmc.discounted_returns(jnp.asarray(rewards), 0.99)
    jmask = jmc.first_visit_mask(jnp.asarray(id_arr), jnp.asarray(valid))
    # XLA's fused multiply-adds drift by a few ulp of the running sum (|G| up to
    # about 30, an ulp 2e-6), which shows as absolute error where G crosses 0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(g.numpy().view(np.int32), _walk_returns(rewards, 0.99).view(np.int32))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert g.dtype == torch.float32 and mask.dtype == torch.bool and g.shape == mask.shape == (t, 64)
    only, none = tmc.mc_returns(torch.as_tensor(rewards), 0.99)
    assert none is None and torch.equal(only, g)


@pytest.mark.parametrize("case", ["all_valid", "none_valid", "one_id", "repeats"])
def test_first_visit_mask_edges(case):
    t, b = 12, 8
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 3, (t, b)).astype(np.int32)
    valid = np.ones((t, b), bool)
    if case == "none_valid":
        valid[:] = False
    elif case == "one_id":
        ids[:] = 5
    elif case == "repeats":
        valid = rng.random((t, b)) < 0.5  # an id seen while invalid does not count
    got = tmc.first_visit_mask(torch.as_tensor(ids), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmc.first_visit_mask(jnp.asarray(ids), jnp.asarray(valid))))
    want = np.zeros((t, b), bool)
    for e in range(b):
        seen = set()
        for s in range(t):
            if valid[s, e] and ids[s, e] not in seen:
                want[s, e] = True
            if valid[s, e]:
                seen.add(ids[s, e])
    np.testing.assert_array_equal(got, want)
    if case == "one_id":
        assert (got.sum(axis=0) == 1).all()


def test_mc_prediction_and_control_use_mc_returns():
    """The entry points' results on the CPU are unchanged by the new
    dispatch: `mc_returns` equals the two plain functions it calls."""
    lava = tb.lava_level(device=CPU)
    pred = tmc.mc_prediction(TSEM, lava, 3, batch_size=32, max_steps=20)
    assert torch.isfinite(pred.value).all() and float(pred.counts.sum()) >= 0
    ctl = tmc.mc_control(TSEM, lava, 2, num_rounds=2, batch_size=16, max_steps=20, first_visit=False)
    assert torch.isfinite(ctl.q).all() and int(ctl.episodes) == 32


# ---------------------------------------------------------------------------
# K4 above 16,384 states a maze
# ---------------------------------------------------------------------------


def test_k4_tier_dispatch():
    assert dp_grid.uses_shared_tier(dp_grid.MAX_STATES)
    assert dp_grid.uses_shared_tier(81) and not dp_grid.uses_shared_tier(dp_grid.MAX_STATES + 1)
    # the only ceiling left is N·S < 2^31 cells in all, checked from the shape alone
    huge = torch.empty((1 << 17, 128, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        dp_grid._grid_args(TSEM, huge, None, CPU)
    grids = torch.zeros((2, 131, 129), dtype=torch.int32)
    args, n, s = dp_grid._grid_args(TSEM, grids, None, CPU)
    assert (n, s) == (2, 16_899) and not dp_grid.uses_shared_tier(s)
    with pytest.raises(ValueError, match="CUDA"):
        dp_grid.grid_sweeps_cuda(TSEM, grids, torch.zeros((2, s)), None, 0.99, 4)
    with pytest.raises(ValueError, match="CUDA"):
        dp_grid.grid_greedy_cuda(TSEM, grids, torch.zeros((2, s)), 0.99, None)
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    st = tbp.reset_bits(bl, 2)
    with pytest.raises(ValueError, match="CUDA"):
        dqn_act.DqnActPlan(TSEM, bl, 2, None)(st, torch.zeros((2, 4)), torch.zeros(2, dtype=torch.bool),
                                              torch.zeros(2, dtype=torch.int32), torch.zeros(2),
                                              torch.zeros((), dtype=torch.int64), torch.zeros(()))
    with pytest.raises(ValueError, match="CUDA"):
        mc_returns.mc_returns_cuda(torch.zeros((3, 2)), 0.99)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.fixture(scope="module")
def big_mazes():
    """Two sidewinder mazes of 65×64 cells: 131×129 = 16,899 states each,
    above the shared-memory tier (sidewinder takes at most 64 cell columns)."""
    grids, start = tmz.generate_mazes_device(11, (65, 64), 2, "sidewinder", device=CPU)
    g = grids.numpy()
    start = np.full((2,), int(start), np.int32)
    return J.Level(grid=jnp.asarray(g), start_idx=jnp.asarray(start)), T.make_level(g, start, device=CPU)


def _policy_off_ties(q, pol_a, pol_b, min_clear, atol=1e-4):
    """Policies agree wherever the best two action values are > atol apart,
    and at least `min_clear` cells are."""
    top2 = np.sort(np.asarray(q), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > atol
    np.testing.assert_array_equal(np.asarray(pol_a)[clear], np.asarray(pol_b)[clear])
    assert clear.sum() >= min_clear


def test_grid_vi_above_16384_states_matches_jax(big_mazes):
    jl, tl = big_mazes
    assert tl.num_states == 16_899 > dp_grid.MAX_STATES
    v, policy, iters = ta.value_iteration_batched_grid(TSEM, tl)
    jv, jp, ji = ja.value_iteration_batched_grid(JSEM, jl, validate=False)
    assert iters == int(ji) > 100
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    q = tdb._grid_backup(TSEM, tl.grid, 0.99)(v)
    _policy_off_ties(q.numpy(), policy.numpy(), jp, 0.2 * q.shape[0] * q.shape[1])
    ref = tdb.value_iteration_batched_grid_reference(TSEM, tl)
    assert ref[2] == iters and torch.equal(ref[0], v) and torch.equal(ref[1], policy)


def test_grid_pi_above_16384_states_matches_jax(big_mazes):
    """Howard PI to a cap of three improvements (these mazes need far more
    than the reference's 100 to settle): the same V and policy after it."""
    jl, tl = big_mazes
    kw = dict(max_eval_iters=400, max_policy_iters=3)
    v, policy, iters = ta.policy_iteration_batched_grid(TSEM, tl, **kw)
    jv, jp, ji = ja.policy_iteration_batched_grid(JSEM, jl, validate=False, **kw)
    assert iters == int(ji) == 3
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    q = tdb._grid_backup(TSEM, tl.grid, 0.99)(v)
    # after three improvements most cells still tie (every action loops)
    _policy_off_ties(q.numpy(), policy.numpy(), jp, 1000)
