"""Example 10 — TD(λ), prioritized replay and grid observations on one
level, back to back:

  1. SARSA(λ): eligibility traces between one-step TD and Monte-Carlo
     (per-env trace tensors; on the card one K12 launch a step).
  2. DQN with prioritized replay, without a sum-tree: a Gumbel top-k draw
     (K8a on the card).
  3. PPO with `obs="grid"`: the tile and agent planes through a conv trunk
     (the agent plane stamped by K9b) instead of the index-embedding MLP.

    python examples_torch/10_traces_per_gridobs.py
    python examples_torch/10_traces_per_gridobs.py --device cpu --envs 16
"""

from _common import parse_args


def main():
    args = parse_args(
        "TD(lambda) + PER + grid-obs demo",
        envs=(int, 64, "parallel envs"),
        td_steps=(int, 3000, "SARSA(lambda) train steps"),
        dqn_steps=(int, 800, "prioritized-DQN train steps"),
        ppo_updates=(int, 60, "grid-obs PPO updates"),
    )
    import time

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.algos import greedy_policy_from_q, run_greedy_episode, sarsa_lambda
    from griduniverse_tpu_torch.algos.utils import policy_arrows
    from griduniverse_tpu_torch.levels.builders import make_level_from_indices
    from griduniverse_tpu_torch.models import DQNConfig, PPOConfig, dqn_train, ppo_train

    sem = gu.make_semantics(device=args.device)
    level = make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15], device=args.device)

    # --- 1. SARSA(λ) ---
    t0 = time.perf_counter()
    res = sarsa_lambda(
        sem, level, 0,
        num_steps=args.td_steps, batch_size=args.envs,
        alpha=0.2, gamma=0.99, epsilon=0.2, lam=0.9,
    )
    pol = greedy_policy_from_q(res.q)
    _, ret, length, done = run_greedy_episode(sem, level, pol, max_steps=20)
    print(f"SARSA(λ): {int(res.episodes)} episodes in "
          f"{time.perf_counter() - t0:.1f}s; greedy episode: done={bool(done)} "
          f"len={int(length)} return={float(ret):.1f}")
    print(policy_arrows(pol, level))

    # --- 2. prioritized DQN ---
    t0 = time.perf_counter()
    cfg = DQNConfig(
        buffer_capacity=max(1024, args.envs * 4),
        batch_size_train=64,
        eps_anneal_steps=args.dqn_steps // 2,
        max_episode_steps=64,
        hidden=(64,),
        prioritized=True,
    )
    dres = dqn_train(sem, level, 1, cfg, num_steps=args.dqn_steps, batch_size=args.envs)
    print(f"PER-DQN: {int(dres.episodes)} episodes, "
          f"mean return {float(dres.mean_return):.1f} "
          f"({time.perf_counter() - t0:.1f}s)")

    # --- 3. grid-obs PPO ---
    t0 = time.perf_counter()
    pcfg = PPOConfig(
        rollout_len=8, lr=1e-3, max_episode_steps=32,
        obs="grid", conv_channels=(16,), hidden=(64,),
        num_epochs=2, num_minibatches=2,
    )
    pres = ppo_train(sem, level, 2, pcfg, num_updates=args.ppo_updates, batch_size=args.envs)
    print(f"grid-obs PPO: {int(pres.episodes)} episodes, "
          f"mean return {float(pres.mean_return):.1f} "
          f"({time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main()
