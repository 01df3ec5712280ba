"""Algorithm utilities — greedy extraction, policy rollouts, value plots.

PyTorch counterpart of `griduniverse_tpu/algos/utils.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import semantics as S
from ..core.model import ModelTable
from ..core.semantics import Semantics
from ..core.step import reset, step
from ..core.types import Level
from .dp import action_values, first_argmax


def greedy_policy_from_q(q: torch.Tensor) -> torch.Tensor:
    """(..., S, A) → (..., S) int32 greedy policy; ties → lowest action."""
    return first_argmax(q)


def greedy_policy_from_v(model: ModelTable, v: torch.Tensor, gamma: float) -> torch.Tensor:
    """One-step lookahead greedy policy from a state-value function."""
    return first_argmax(action_values(model, v, gamma))


def run_greedy_episode(
    sem: Semantics, level: Level, policy: torch.Tensor, key=None, max_steps: int = 200
):
    """Follow a policy from the start state with freeze-on-done steps.

    A shared (H, W) level takes an (S,) policy and returns (obs (T,), total
    return, length, reached terminal) as 0-d tensors, like the reference. A
    per-env (B, H, W) level takes a (B, S) policy and returns the same with
    a leading B axis (obs (T, B)). `key` is accepted and ignored: the
    rollout is deterministic.
    """
    del key
    state = reset(level)
    pol = policy.reshape(-1, level.num_states).long()
    obs, total = [], torch.zeros(state.agent_idx.shape, dtype=torch.float32, device=level.device)
    for _ in range(max_steps):
        a = pol.gather(1, state.agent_idx.long()[:, None])[:, 0]
        state, out = step(sem, level, state, a)
        obs.append(out.obs)
        total = total + out.reward
    traj = torch.stack(obs) if obs else torch.empty((0,) + total.shape, dtype=torch.int32, device=level.device)
    if level.batched:
        return traj, total, state.t, state.done
    return traj[:, 0], total[0], state.t[0], state.done[0]


def value_grid(v, level: Level) -> np.ndarray:
    """(S,) value vector → (H, W) NumPy array for display/plotting."""
    v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.reshape(level.height, level.width)


def policy_arrows(policy, level: Level, chars: str = "↑→↓←") -> str:
    """ASCII picture of a deterministic policy (default action order
    UP/RIGHT/DOWN/LEFT). Walls render '#', terminals '·'."""
    grid = level.grid.cpu().numpy()
    pol = (policy.cpu().numpy() if isinstance(policy, torch.Tensor) else np.asarray(policy)).reshape(grid.shape)
    out = []
    for r in range(grid.shape[0]):
        row = []
        for c in range(grid.shape[1]):
            code = grid[r, c]
            if code == S.WALL:
                row.append("#")
            elif code in (S.LAVA, S.GOAL):
                row.append("·")
            else:
                row.append(chars[int(pol[r, c])])
        out.append("".join(row))
    return "\n".join(out)


def plot_value(v, level: Level, path: str | None = None):
    """Heatmap of V over the grid. matplotlib is imported here, so installs
    without it can still import the module."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("matplotlib is required for plot_value") from e

    fig, ax = plt.subplots()
    im = ax.imshow(value_grid(v, level), cmap="viridis")
    fig.colorbar(im, ax=ax, label="V(s)")
    ax.set_title("State values")
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
