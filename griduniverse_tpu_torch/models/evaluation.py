"""Policy evaluation utilities for the neural learners.

PyTorch counterpart of `griduniverse_tpu/models/evaluation.py`: roll every
env's greedy policy in lockstep on the bit-packed step in freeze-on-done
mode and report which envs reached the goal. Works over the three network
families (tile planes are derived for a needs-tiles net), as policy networks
or as Q-networks (`models.dqn`: the logits are the Q-values, so the greedy
action is the same argmax), and over shared or batched levels. A network
policy's step is K7b's greedy form (`models.a2c.greedy_step`), through one
plan an evaluation; a tabular policy's action lookup is one
`torch.gather` (the reference's select tree is the TPU's).
"""

from __future__ import annotations

import torch

from ..core.semantics import Semantics
from ..core.types import Level
from ..kernels.act_step import ActStepPlan
from ..ops.bitplane import pack_level, reset_bits, step_bits
from .a2c import _net_apply, _tiles_for, greedy_step
from .networks import exact_kernels


def greedy_reached(sem: Semantics, net, params, levels: Level, max_steps: int = 60,
                   tiles_levels: Level | None = None):
    """(B,) bool: did each env's greedy rollout SUCCEED, that is terminate
    on a positively rewarded terminal (the goal), within `max_steps`?
    Terminating on a negative terminal (lava) is failure. Levels may be
    shared ((H, W) grid → a single env) or batched ((N, H, W) → one env per
    level).

    `tiles_levels` (needs-tiles nets only): take the network's tile PLANES
    from another Level than the step dynamics: the wrong-tiles ablation
    control (pass e.g. a roll-by-one of `levels`; a policy that reads the
    maze collapses, a motion prior does not)."""
    if tiles_levels is not None and not getattr(net, "needs_tiles", False):
        raise ValueError(
            "tiles_levels only applies to per-env-level (needs-tiles) networks; this net takes "
            "no tile planes, so the ablation would silently evaluate the UNROLLED planes"
        )
    bl = pack_level(levels)
    tiles = _tiles_for(net, levels if tiles_levels is None else tiles_levels)
    st = reset_bits(bl, None if bl.batched else 1)
    reached = torch.zeros(st.agent_idx.shape, dtype=torch.bool, device=bl.device)
    # K7b's plan on the card: every step reads one of its two slots and writes the other
    plan = ActStepPlan(sem, bl, st.agent_idx.shape[0], 0, None) if bl.device.type == "cuda" else None
    with torch.no_grad(), exact_kernels():
        for _ in range(max_steps):
            logits, _ = _net_apply(net, params, st.agent_idx, tiles)
            st, reached = greedy_step(sem, bl, st, reached, logits, plan)
    return reached


def greedy_success_rate(sem: Semantics, net, params, levels: Level, max_steps: int = 60,
                        tiles_levels: Level | None = None) -> torch.Tensor:
    """Scalar fraction of envs whose greedy policy reaches the GOAL within
    `max_steps`: the held-out generalization metric. `tiles_levels`: see
    `greedy_reached`."""
    return greedy_reached(sem, net, params, levels, max_steps, tiles_levels).float().mean()


def greedy_reached_tabular(sem: Semantics, levels: Level, policy: torch.Tensor, max_steps: int = 60):
    """(B,) bool: does each env's TABULAR policy reach the GOAL within
    `max_steps`? The twin of `greedy_reached` for the (N, S) / (S,) int
    policies that `algos.dp` / `algos.dp_batched` produce, on the same
    engine with the same goal-only success rule.

    policy — (S,) int actions for a shared level, or (N, S): one policy per
    maze for a batched (N, H, W) level, or N policies each rolled in its own
    env of a SHARED level."""
    bl = pack_level(levels)
    if policy.shape[-1] != bl.height * bl.width:
        raise ValueError(
            f"policy last axis {policy.shape[-1]} != level state count {bl.height * bl.width}")
    if bl.batched and policy.dim() == 2 and policy.shape[0] != levels.grid.shape[0]:
        raise ValueError(f"policy batch {policy.shape[0]} != level batch {levels.grid.shape[0]}")
    if bl.batched:
        batch = None
    else:
        batch = policy.shape[0] if policy.dim() == 2 else 1
    st = reset_bits(bl, batch)
    table = policy.to(torch.int32)
    reached = torch.zeros(st.agent_idx.shape, dtype=torch.bool, device=bl.device)
    for _ in range(max_steps):
        idx = st.agent_idx.long()
        a = table.gather(1, idx[:, None])[:, 0] if table.dim() == 2 else table[idx]
        st, (_, reward, done) = step_bits(sem, bl, st, a, False, None)
        reached = reached | (done & (reward > 0))
    return reached


def greedy_success_rate_tabular(sem: Semantics, levels: Level, policy: torch.Tensor,
                                max_steps: int = 60) -> torch.Tensor:
    """Scalar fraction of envs whose tabular policy reaches the GOAL within
    `max_steps`, e.g. the optimal ceiling from batched VI."""
    return greedy_reached_tabular(sem, levels, policy, max_steps).float().mean()
