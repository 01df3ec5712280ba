"""Example 2 — plan with dynamic programming: build the dense model table,
run value iteration on the device, print the value grid and the policy
arrows, roll the greedy policy, optionally save a plot.

    python examples_torch/02_value_iteration.py --plot /tmp/values.png
"""

import numpy as np

from _common import parse_args


def main():
    args = parse_args(
        "Value iteration on the lava-crossing level",
        gamma=(float, 0.99, "discount"),
        plot=(str, "", "path to save a V-heatmap PNG (optional; needs matplotlib)"),
    )

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.algos import (
        policy_arrows,
        run_greedy_episode,
        value_grid,
        value_iteration,
    )
    from griduniverse_tpu_torch.levels.builders import lava_level
    from griduniverse_tpu_torch.levels.text import render_text

    sem = gu.make_semantics(device=args.device)
    level = lava_level(device=args.device)
    print("Level:")
    print(render_text(level.grid.cpu().numpy(), start_idx=int(level.start_idx)))

    model = gu.build_model_table(sem, level)
    v, policy, iters = value_iteration(model, gamma=args.gamma, theta=1e-6)
    print(f"\nconverged in {int(iters)} sweeps")
    np.set_printoptions(precision=1, suppress=True, linewidth=200)
    print("V(s):")
    print(value_grid(v, level))
    print("\ngreedy policy:")
    print(policy_arrows(policy, level))

    obs, ret, length, done = run_greedy_episode(sem, level, policy)
    print(
        f"\ngreedy rollout: return={float(ret):.1f} length={int(length)} "
        f"reached_terminal={bool(done)}"
    )

    if args.plot:
        from griduniverse_tpu_torch.algos.utils import plot_value

        plot_value(v, level, path=args.plot)
        print(f"saved V heatmap to {args.plot}")


if __name__ == "__main__":
    main()
