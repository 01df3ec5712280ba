"""Port parity: griduniverse_tpu_torch.algos.{dp, dp_batched, utils} against
the JAX solvers, on the CPU (K4's plain version stands in for the kernel).

Tolerances. One backup application from the same V is bit-exact, and so is
`build_model_tables`. Across sweeps XLA's CPU backend may fuse `rew +
gamma*cont` into one multiply-add while torch rounds twice (the reference
says so in `value_iteration_batched_grid`'s docstring), so converged V is
compared with atol=1e-4, rtol=1e-5, `iters` must be equal, and policies
must agree wherever the two best action values differ by more than 1e-4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import algos as ja
from griduniverse_tpu.algos import dp_batched as jdb
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu.levels import builders as jb
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.algos import dp_batched as tdb
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.utils import convert

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)
ATOL, RTOL = 1e-4, 1e-5


def assert_policy_equal_off_ties(q, pol_a, pol_b, min_clear=0.2):
    """Policies agree wherever the best two action values are > ATOL apart,
    and more than `min_clear` of the states have such a clear best action."""
    q = np.asarray(q)
    top2 = np.sort(q, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > ATOL
    np.testing.assert_array_equal(np.asarray(pol_a)[clear], np.asarray(pol_b)[clear])
    assert clear.mean() > min_clear


def shared_levels():
    rng = np.random.default_rng(5)
    g = rng.choice([0, 0, 0, 1, 2], size=(6, 7)).astype(np.int32)
    g[0, 0], g[5, 6] = 0, 3
    return {
        "lava": (jb.lava_level(), tb.lava_level(device=CPU)),
        "walls16": (jb.walls_and_goal_16x16(), tb.walls_and_goal_16x16(device=CPU)),
        "random6x7": (J.make_level(g, 0), T.make_level(g, 0, device=CPU)),
    }


def maze_levels(cells, n, seed, lava=False):
    """N Aldous–Broder mazes from the port's generator, as both packages'
    batched levels; optionally with one wall pillar per maze turned to lava."""
    grids, start = tm.generate_mazes_device(seed, cells, n, "aldous_broder", device=CPU)
    g = grids.numpy().copy()
    if lava:
        g[:, 2, 2] = 2  # a pillar between four wall slots: a hazard that blocks no path
    start = np.full((n,), int(start), np.int32)
    return JLevel(grid=jnp.asarray(g), start_idx=jnp.asarray(start)), T.make_level(g, start, device=CPU)


@pytest.mark.parametrize("name", ["lava", "walls16", "random6x7"])
def test_action_values_and_vi_match_jax(name):
    jl, tl = shared_levels()[name]
    jm, tmod = J.build_model_table(JSEM, jl), T.build_model_table(TSEM, tl)
    v0 = np.random.default_rng(1).normal(size=jm.num_states).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(ja.action_values(jm, jnp.asarray(v0), 0.9)),
        ta.action_values(tmod, torch.as_tensor(v0), 0.9).numpy(),
    )
    jv, jp, ji = ja.value_iteration(jm, gamma=0.95)
    tv, tp, ti = ta.value_iteration(tmod, gamma=0.95)
    assert int(ji) == ti
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    assert_policy_equal_off_ties(ja.action_values(jm, jv, 0.95), tp.numpy(), jp)
    np.testing.assert_array_equal(
        ta.greedy_policy_from_v(tmod, tv, 0.95).numpy(), tp.numpy()
    )
    # the model converted from the reference gives the same solve
    cv, cp, ci = ta.value_iteration(convert.to_model_table(jm, device=CPU), gamma=0.95)
    assert ci == ti and torch.equal(cv, tv) and torch.equal(cp, tp)


@pytest.mark.parametrize("name", ["lava", "random6x7"])
def test_policy_evaluation_and_iteration_match_jax(name):
    jl, tl = shared_levels()[name]
    jm, tmod = J.build_model_table(JSEM, jl), T.build_model_table(TSEM, tl)
    rng = np.random.default_rng(2)
    pol = rng.integers(0, 4, size=jm.num_states).astype(np.int32)
    probs = rng.dirichlet(np.ones(4), size=jm.num_states).astype(np.float32)
    for jpol, tpol in ((jnp.asarray(pol), torch.as_tensor(pol)), (jnp.asarray(probs), torch.as_tensor(probs))):
        # a random policy loops, so V runs to -1/(1-gamma) = -10, where one
        # float32 ulp (9.5e-7) is the default theta: the sweep count would
        # hang on the last bit (XLA's fused multiply-add). theta=1e-4 is
        # clear of it.
        jv, ji = ja.policy_evaluation(jm, jpol, gamma=0.9, theta=1e-4, max_iters=500)
        tv, ti = ta.policy_evaluation(tmod, tpol, gamma=0.9, theta=1e-4, max_iters=500)
        assert int(ji) == ti
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    jv, jp, ji = ja.policy_iteration(jm)
    tv, tp, ti = ta.policy_iteration(tmod)
    assert int(ji) == ti
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    assert_policy_equal_off_ties(ja.action_values(jm, jv, 0.99), tp.numpy(), jp)
    v_vi, _, _ = ta.value_iteration(tmod)
    np.testing.assert_allclose(tv.numpy(), v_vi.numpy(), atol=1e-3)


def test_vi_known_optimal_tiny_grid_and_iteration_caps():
    # 1x3 corridor, goal at the right end: V = [step + gamma*goal, goal, 0]
    level = T.make_level(np.array([[0, 0, 3]], np.int32), 0, device=CPU)
    model = T.build_model_table(TSEM, level)
    v, pol, iters = ta.value_iteration(model, gamma=0.5)
    np.testing.assert_array_equal(v.numpy(), np.float32([-1 + 0.5 * 10, 10, 0]))
    assert pol.tolist()[:2] == [1, 1] and iters == 3
    v0, pol0, it0 = ta.value_iteration(model, max_iters=0)
    assert it0 == 0 and not v0.any() and pol0.dtype == torch.int32
    assert ta.value_iteration(model, max_iters=1)[2] == 1


@pytest.mark.parametrize("name", ["lava", "walls16"])
def test_greedy_rollout_and_display_helpers(name):
    jl, tl = shared_levels()[name]
    tmod = T.build_model_table(TSEM, tl)
    _, pol, _ = ta.value_iteration(tmod)
    jobs, jret, jlen, jdone = ja.run_greedy_episode(JSEM, jl, jnp.asarray(pol.numpy()), max_steps=60)
    tobs, tret, tlen, tdone = ta.run_greedy_episode(TSEM, tl, pol, max_steps=60)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert float(tret) == float(jret) and int(tlen) == int(jlen) and bool(tdone) and bool(jdone)
    assert ta.policy_arrows(pol, tl) == ja.policy_arrows(jnp.asarray(pol.numpy()), jl)
    v = torch.arange(tl.num_states, dtype=torch.float32)
    np.testing.assert_array_equal(ta.value_grid(v, tl), ja.value_grid(jnp.asarray(v.numpy()), jl))
    q = torch.as_tensor(np.random.default_rng(0).integers(0, 3, (10, 4)).astype(np.float32))
    np.testing.assert_array_equal(
        ta.greedy_policy_from_q(q).numpy(), np.asarray(ja.greedy_policy_from_q(jnp.asarray(q.numpy())))
    )


MAZE_CASES = {
    "9x9": ((4, 4), 16, False),
    "9x9_lava": ((4, 4), 12, True),
    "17x17": ((8, 8), 6, False),
    "33x33": ((16, 16), 2, False),
}


@pytest.mark.parametrize("case", list(MAZE_CASES))
def test_build_model_tables_bitexact(case):
    cells, n, lava = MAZE_CASES[case]
    jl, tl = maze_levels(cells, n, 3, lava)
    jm, tmod = ja.build_model_tables(JSEM, jl), ta.build_model_tables(TSEM, tl)
    for f in ("next_state", "reward", "done", "terminal"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)), getattr(tmod, f).numpy())
    single = T.build_model_table(TSEM, T.Level(tl.grid[1], tl.start_idx[1]))
    for f in ("next_state", "reward", "done", "terminal"):
        assert torch.equal(getattr(tmod, f)[1], getattr(single, f))
    conv = convert.to_model_table(jm, device=CPU)
    assert torch.equal(conv.next_state, tmod.next_state) and conv.reward.dtype == torch.float32


@pytest.mark.parametrize("case", list(MAZE_CASES))
def test_one_backup_bitexact_table_and_grid_form(case):
    cells, n, lava = MAZE_CASES[case]
    jl, tl = maze_levels(cells, n, 4, lava)
    jm, tmod = ja.build_model_tables(JSEM, jl), ta.build_model_tables(TSEM, tl)
    v = np.random.default_rng(7).normal(size=(n, tl.num_states)).astype(np.float32)
    want = np.asarray(ja.action_values_batched(jm, jnp.asarray(v), 0.97, lookup="gather"))
    got_table = ta.action_values_batched(tmod, torch.as_tensor(v), 0.97, lookup="gather")
    got_grid = tdb._grid_backup(TSEM, tl.grid, 0.97)(torch.as_tensor(v))
    np.testing.assert_array_equal(got_table.numpy(), want)
    np.testing.assert_array_equal(got_grid.numpy(), want)


@pytest.mark.parametrize("case", list(MAZE_CASES))
def test_batched_vi_matches_jax(case):
    cells, n, lava = MAZE_CASES[case]
    jl, tl = maze_levels(cells, n, 5, lava)
    jm, tmod = ja.build_model_tables(JSEM, jl), ta.build_model_tables(TSEM, tl)
    jv, jp, ji = ja.value_iteration_batched(jm, lookup="gather")
    jgv, jgp, jgi = ja.value_iteration_batched_grid(JSEM, jl, validate=False)
    tv, tp, ti = ta.value_iteration_batched(tmod, lookup="gather")
    gv, gp, gi = ta.value_iteration_batched_grid(TSEM, tl, validate=False)
    assert int(ji) == int(jgi) == ti == gi > 1
    # table and grid form of the port run the same float ops
    assert torch.equal(tv, gv) and torch.equal(tp, gp)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    q = ja.action_values_batched(jm, jv, 0.99, lookup="gather")
    assert_policy_equal_off_ties(q, gp.numpy(), jgp)
    # the dispatching function took the plain version on the CPU
    rv, rp, ri = tdb.value_iteration_batched_grid_reference(TSEM, tl)
    assert ri == gi and torch.equal(rv, gv) and torch.equal(rp, gp)
    # every maze's greedy policy reaches its goal (terminal, and no lava on
    # the way: the return is (length-1) step costs plus the goal reward)
    _, ret, length, done = ta.run_greedy_episode(TSEM, tl, gp, max_steps=tl.num_states)
    assert bool(done.all())
    np.testing.assert_array_equal(ret.numpy(), (length.numpy() - 1) * -1.0 + 10.0)
    # and per maze the batched solve equals the unbatched one
    single = T.build_model_table(TSEM, T.Level(tl.grid[0], tl.start_idx[0]))
    sv, _, _ = ta.value_iteration(single)
    np.testing.assert_allclose(gv[0].numpy(), sv.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["9x9", "9x9_lava", "17x17"])
def test_batched_pi_and_evaluation_match_jax(case):
    cells, n, lava = MAZE_CASES[case]
    jl, tl = maze_levels(cells, n, 6, lava)
    jm, tmod = ja.build_model_tables(JSEM, jl), ta.build_model_tables(TSEM, tl)
    jv, jp, ji = ja.policy_iteration_batched(jm, lookup="gather")
    jgv, jgp, jgi = ja.policy_iteration_batched_grid(JSEM, jl, validate=False)
    tv, tp, ti = ta.policy_iteration_batched(tmod, lookup="gather")
    gv, gp, gi = ta.policy_iteration_batched_grid(TSEM, tl, validate=False)
    assert int(ji) == int(jgi) == ti == gi >= 2
    assert torch.equal(tv, gv) and torch.equal(tp, gp)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), atol=ATOL, rtol=RTOL)
    q = ja.action_values_batched(jm, jv, 0.99, lookup="gather")
    assert_policy_equal_off_ties(q, gp.numpy(), jgp)
    v_vi, _, _ = ta.value_iteration_batched_grid(TSEM, tl)
    np.testing.assert_allclose(gv.numpy(), v_vi.numpy(), atol=1e-3)
    # evaluation of a fixed policy, deterministic and stochastic
    rng = np.random.default_rng(8)
    pol = rng.integers(0, 4, size=(n, tl.num_states)).astype(np.int32)
    probs = rng.dirichlet(np.ones(4), size=(n, tl.num_states)).astype(np.float32)
    for jpol, tpol in ((jnp.asarray(pol), torch.as_tensor(pol)), (jnp.asarray(probs), torch.as_tensor(probs))):
        # theta=1e-4 for the reason given in the unbatched test
        jev, jei = ja.policy_evaluation_batched(jm, jpol, gamma=0.9, theta=1e-4, max_iters=300, lookup="gather")
        tev, tei = ta.policy_evaluation_batched(tmod, tpol, gamma=0.9, theta=1e-4, max_iters=300, lookup="gather")
        assert int(jei) == tei
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), atol=ATOL, rtol=RTOL)


def test_batched_solvers_reject_shared_level_and_drop_tpu_defenses():
    lava = tb.lava_level(device=CPU)
    for fn in (ta.build_model_tables, ta.value_iteration_batched_grid, ta.policy_iteration_batched_grid):
        with pytest.raises(ValueError, match="batched"):
            fn(TSEM, lava)
    for name in ("_validated_solve", "_pad_bad_batch", "_vi_grid_check", "_pi_grid_check",
                 "_close", "_close_expr", "_MISCOMPILED_BATCH", "_PAD_ROWS",
                 "_VALIDATE_MIN_CELLS", "_SELECT_TREE_MAX_STATES", "_successor_values"):
        assert hasattr(jdb, name) and not hasattr(tdb, name)
    # validate= and lookup= are accepted and change nothing
    _, tl = maze_levels((2, 2), 4, 1)
    a = ta.value_iteration_batched_grid(TSEM, tl, validate=True)
    b = ta.value_iteration_batched_grid(TSEM, tl, validate=None)
    assert a[2] == b[2] and torch.equal(a[0], b[0])
    m = ta.build_model_tables(TSEM, tl)
    assert torch.equal(
        ta.value_iteration_batched(m, lookup="select_tree")[0], ta.value_iteration_batched(m)[0]
    )


def test_sweep_loop_stops_inside_and_on_launch_boundaries(monkeypatch):
    """K4's host loop (`_sweep_until_cuda`) with the kernel replaced by the
    plain backup: whatever the launch size, it returns the plain loop's V
    and `iters`, also where convergence falls inside a launch."""
    _, tl = maze_levels((3, 3), 8, 2)
    backup = tdb._grid_backup(TSEM, tl.grid, 0.99)

    def fake_sweeps(sem, grids, v, policy, gamma, k):
        maxima = []
        for _ in range(k):
            q = backup(v)
            v_new = q.max(dim=-1).values if policy is None else tdb._pick(q, policy)
            maxima.append((v_new - v).abs().max())
            v = v_new
        return v, torch.stack(maxima)

    monkeypatch.setattr(tdb, "grid_sweeps_cuda", fake_sweeps)
    v_ref, _, iters_ref = tdb.value_iteration_batched_grid_reference(TSEM, tl)
    for per_launch in (1, 4, iters_ref, 16):
        monkeypatch.setattr(tdb, "SWEEPS_PER_LAUNCH", per_launch)
        for cap in (10_000, iters_ref, 5):
            v, iters = tdb._sweep_until_cuda(TSEM, tl.grid, None, 0.99, 1e-6, cap)
            want = tdb.value_iteration_batched_grid_reference(TSEM, tl, max_iters=cap)
            assert iters == want[2] and torch.equal(v, want[0])
    assert iters_ref > 5 and torch.equal(v_ref, tdb._sweep_until_cuda(TSEM, tl.grid, None, 0.99, 1e-6, 10_000)[0])


# K4's packing: (S, A) -> (mazes a block, threads a block, cells a thread,
# table of decoded actions). Three 9x9 mazes a block of 256 threads (243 lanes
# busy), a maze a block above 256 cells, the table up to 72 KB of shared memory.
@pytest.mark.parametrize("s,a,want", [
    (1, 4, (256, 256, 1, False)),
    (9, 4, (28, 256, 1, False)),        # 3x3 mazes
    (81, 4, (3, 256, 1, False)),        # 9x9
    (81, 8, (3, 256, 1, False)),
    (100, 4, (2, 224, 1, False)),       # whole warps: 200 cells on 7 warps
    (256, 4, (1, 256, 1, False)),
    (257, 4, (1, 160, 2, True)),
    (1089, 4, (1, 224, 5, True)),       # 33x33: 1,120 slots for 1,089 cells
    (1089, 8, (1, 224, 5, True)),       # its table at 8 actions, 62 KB
    (4225, 4, (1, 256, 17, False)),     # 65x65: a table would take 139 KB
    (16_384, 4, (1, 256, 64, False)),   # the shared tier's limit: 13 bytes a cell
])
def test_k4_packing(s, a, want):
    from griduniverse_tpu_torch.kernels import dp_grid

    pk = dp_grid.packing(s, a)
    assert tuple(pk) == want
    assert pk.threads % 32 == 0 and pk.threads <= dp_grid.BLOCK_THREADS
    assert pk.mazes * s <= pk.threads * pk.cells          # a thread for every cell
    assert pk.mazes == 1 or pk.cells == 1                 # several mazes a block, or several cells a thread
    assert (pk.cells - 1) * pk.threads < s                # no thread has a pass with no cell at all
    assert pk.table == (pk.cells > 1 and dp_grid.table_bytes(s, a) <= dp_grid.TABLE_BYTES)
    assert 13 * s <= 227 * 1024                           # the word a cell fits a block
    # N mazes make ceil(N / mazes) groups; the last one holds the rest
    for n in (1, 2, 3, 4, 257):
        groups = -(-n // pk.mazes)
        assert 0 < n - (groups - 1) * pk.mazes <= pk.mazes


def test_k4_packing_refuses_the_global_tier():
    from griduniverse_tpu_torch.kernels import dp_grid

    assert dp_grid.uses_shared_tier(dp_grid.MAX_STATES) and not dp_grid.uses_shared_tier(dp_grid.MAX_STATES + 1)
    with pytest.raises(ValueError, match="shared tier"):
        dp_grid.packing(dp_grid.MAX_STATES + 1)


# K4's plain versions at more than four actions: 9 (the eight king moves and
# a stay) and 25 (every move of at most two rows and two columns), against
# the reference's grid-form solvers and its table backup
ACTION_SETS = {
    9: ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, -1), (-1, 1), (1, 1), (1, -1), (0, 0)),
    25: tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3)),
}


@pytest.mark.parametrize("a", [9, 25])
@pytest.mark.parametrize("case", ["9x9", "9x9_lava", "17x17"])
def test_grid_solvers_match_jax_at_more_actions(a, case):
    jsem = J.make_semantics(J.SemanticsConfig(action_deltas=ACTION_SETS[a]))
    tsem = T.make_semantics(T.SemanticsConfig(action_deltas=ACTION_SETS[a]), device=CPU)
    cells, n, lava = MAZE_CASES[case]
    jl, tl = maze_levels(cells, n, 9, lava)
    jm = ja.build_model_tables(jsem, jl)
    v = np.random.default_rng(a).normal(size=(n, tl.num_states)).astype(np.float32)
    want = np.asarray(ja.action_values_batched(jm, jnp.asarray(v), 0.97, lookup="gather"))
    np.testing.assert_array_equal(tdb._grid_backup(tsem, tl.grid, 0.97)(torch.as_tensor(v)).numpy(), want)
    jgv, jgp, jgi = ja.value_iteration_batched_grid(jsem, jl, validate=False)
    gv, gp, gi = ta.value_iteration_batched_grid(tsem, tl, validate=False)
    # with 25 moves, blocked jumps and terminal cells tie many actions: a
    # clear best action in about an eighth of the states at 17x17
    min_clear = 0.2 if a == 9 else 0.08
    assert int(jgi) == gi > 1
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), atol=ATOL, rtol=RTOL)
    assert_policy_equal_off_ties(ja.action_values_batched(jm, jgv, 0.99, lookup="gather"), gp.numpy(), jgp, min_clear)
    jgv, jgp, jgi = ja.policy_iteration_batched_grid(jsem, jl, validate=False)
    gv, gp, gi = ta.policy_iteration_batched_grid(tsem, tl, validate=False)
    assert int(jgi) == gi >= 2
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), atol=ATOL, rtol=RTOL)
    assert_policy_equal_off_ties(ja.action_values_batched(jm, jgv, 0.99, lookup="gather"), gp.numpy(), jgp, min_clear)


# Above 16,384 states a maze (K4's cluster tier on the card; its plain
# version here): two sidewinder mazes of 65x64 cells (131x129, 16,899
# states), a few sweeps of VI and of PI's evaluation, against the JAX
# package's grid solvers on the same grids.
@pytest.mark.parametrize("solver", ["vi", "pi"])
def test_grid_solvers_above_16384_states_match_jax(solver):
    grids, start = tm.generate_mazes_device(17, (65, 64), 2, "sidewinder", device=CPU)
    g = grids.numpy().copy()
    assert g.shape[1] * g.shape[2] == 16_899
    st = np.full((2,), int(start), np.int32)
    jl, tl = JLevel(grid=jnp.asarray(g), start_idx=jnp.asarray(st)), T.make_level(g, st, device=CPU)
    if solver == "vi":
        jv, jp, ji = ja.value_iteration_batched_grid(JSEM, jl, max_iters=24, validate=False)
        tv, tp, ti = ta.value_iteration_batched_grid(TSEM, tl, max_iters=24)
        rv, rp, ri = tdb.value_iteration_batched_grid_reference(TSEM, tl, max_iters=24)
    else:
        kw = dict(max_eval_iters=12, max_policy_iters=3)
        jv, jp, ji = ja.policy_iteration_batched_grid(JSEM, jl, validate=False, **kw)
        tv, tp, ti = ta.policy_iteration_batched_grid(TSEM, tl, **kw)
        rv, rp, ri = tdb.policy_iteration_batched_grid_reference(TSEM, tl, **kw)
    assert int(ji) == ti == ri == (24 if solver == "vi" else 3)
    assert torch.equal(tv, rv) and torch.equal(tp, rp)  # the plain version on the CPU
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
    q = tdb._grid_backup(TSEM, tl.grid, 0.99)(tv)
    assert_policy_equal_off_ties(q.numpy(), tp.numpy(), np.asarray(jp), min_clear=0.0)
    assert bool((tv < 0).any()) and bool((tv > 0).any())  # the sweeps moved V both ways
