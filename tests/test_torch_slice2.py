"""The tabular solvers end to end on the CPU: mazes from the port's generator
→ grid-form VI (K4's plain version) → greedy policies reach every goal;
per-maze Q-learning (K6's plain version) on the same mazes approaches VI's
values; the shared-Q learner (K5's plain version) improves its return on
walls16. The same mazes go through the JAX solvers: V agrees to atol=1e-4,
rtol=1e-5 (XLA's CPU backend may fuse the backup's multiply-add) and the
sweep counts are equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import griduniverse_tpu as J
import griduniverse_tpu_torch as T
from griduniverse_tpu import algos as ja
from griduniverse_tpu.core.types import Level as JLevel
from griduniverse_tpu_torch import algos as ta
from griduniverse_tpu_torch.levels import builders as tb
from griduniverse_tpu_torch.levels import maze as tm
from griduniverse_tpu_torch.ops import bitplane as tbp

torch.set_num_threads(1)
CPU = torch.device("cpu")

JSEM = J.make_semantics()
TSEM = T.make_semantics(device=CPU)


@pytest.fixture(scope="module")
def mazes():
    n, cells = 32, (3, 3)
    grids, start = tm.generate_mazes_device(2026, cells, n, "aldous_broder", device=CPU)
    return T.Level(grid=grids, start_idx=start.expand(n).contiguous())


def test_generated_mazes_are_solved_by_vi_like_the_reference(mazes):
    v, policy, iters = ta.value_iteration_batched_grid(TSEM, mazes)
    jl = JLevel(grid=jnp.asarray(mazes.grid.numpy()), start_idx=jnp.asarray(mazes.start_idx.numpy()))
    jv, _, jiters = ja.value_iteration_batched_grid(JSEM, jl, validate=False)
    assert iters == int(jiters) > 5
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    _, ret, length, done = ta.run_greedy_episode(TSEM, mazes, policy, max_steps=49)
    assert bool(done.all())
    np.testing.assert_array_equal(ret.numpy(), 10.0 - (length.numpy() - 1))
    # the policy replayed on the bit-packed engine ends every episode too
    bl = tbp.pack_level(mazes)
    state = tbp.reset_bits(bl)
    for _ in range(int(length.max())):
        a = policy.gather(1, state.agent_idx.long()[:, None])[:, 0]
        state, (_, _, d) = tbp.step_bits(TSEM, bl, state, a, auto_reset=False)
    assert bool(state.done.all())
    pv, ppol, _ = ta.policy_iteration_batched_grid(TSEM, mazes)
    np.testing.assert_allclose(pv.numpy(), v.numpy(), atol=1e-3)


def test_per_maze_q_learning_approaches_vi_on_the_same_mazes(mazes):
    small = T.Level(grid=mazes.grid[:8].contiguous(), start_idx=mazes.start_idx[:8].contiguous())
    v_star, _, _ = ta.value_iteration_batched_grid(TSEM, small, gamma=0.95)
    res = ta.q_learning_batched(
        TSEM, small, 8, num_steps=8000, epsilon=0.3, gamma=0.95, alpha=0.2, max_episode_steps=60
    )
    start = int(small.start_idx[0])
    np.testing.assert_allclose(
        res.q.max(dim=-1).values[:, start].numpy(), v_star[:, start].numpy(), atol=0.5
    )
    policy = ta.greedy_policy_from_q(res.q)
    assert bool(ta.run_greedy_episode(TSEM, small, policy, max_steps=49)[3].all())


def test_shared_q_learner_improves_its_return_on_walls16():
    bl = tbp.pack_level(tb.walls_and_goal_16x16(device=CPU))
    run = ta.compile_fast_td_run(TSEM, bl, 1500, epsilon=0.1, max_episode_steps=200)
    first = run(ta.fast_td_init(TSEM, bl, 1, 128))
    second = run(first)
    r1 = ta.fast_td_result(first)
    n2 = second.n_eps_env.sum() - first.n_eps_env.sum()
    mean2 = (second.ret_sum_env.sum() - first.ret_sum_env.sum()) / n2
    assert int(r1.episodes) > 0 and int(n2) > int(r1.episodes)
    assert float(mean2) > float(r1.mean_return)


def test_solver_entry_points_without_device_ask_for_cuda():
    """`fast_td_init` and the solvers follow their tensors; the factories
    that take no tensor resolve `device=None` to CUDA (see test_torch_core)."""
    bl = tbp.pack_level(tb.lava_level(device=CPU))
    ts = ta.fast_td_init(TSEM, bl, 0, 4)
    assert ts.q.device == CPU and ts.rs.device == CPU
