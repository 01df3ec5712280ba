"""Example 3 — vectorized tabular Q-learning: thousands of auto-reset envs
stepped together, their TD updates averaged per (state, action) (K10 on
the card), then a greedy evaluation.

    python examples_torch/03_q_learning_vectorized.py --envs 4096 --steps 3000
"""

from _common import parse_args


def main():
    args = parse_args(
        "Vectorized Q-learning",
        envs=(int, 4096, "parallel envs"),
        steps=(int, 3000, "training steps (each steps all envs once)"),
    )
    import time

    import torch

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.algos import (
        greedy_policy_from_q,
        policy_arrows,
        q_learning,
        run_greedy_episode,
    )
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16

    sem = gu.make_semantics(device=args.device)
    level = walls_and_goal_16x16(device=args.device)

    t0 = time.perf_counter()
    res = q_learning(
        sem, level, 0,
        num_steps=args.steps, batch_size=args.envs,
        alpha=0.15, gamma=0.99, epsilon=0.3,
    )
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)
    dt = time.perf_counter() - t0
    total = args.steps * args.envs
    print(
        f"trained on {total:,} transitions in {dt:.2f}s "
        f"({total / dt:,.0f} steps/s incl. the kernels' first load)"
    )
    print(f"episodes completed: {int(res.episodes):,}")
    print(f"mean episode return: {float(res.mean_return):.2f}")

    policy = greedy_policy_from_q(res.q)
    print("\ngreedy policy:")
    print(policy_arrows(policy, level))
    _, ret, length, done = run_greedy_episode(sem, level, policy, max_steps=64)
    print(
        f"greedy rollout: return={float(ret):.1f} length={int(length)} "
        f"done={bool(done)}"
    )


if __name__ == "__main__":
    main()
