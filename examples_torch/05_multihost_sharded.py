"""Example 5 — the distributed stack: envs sharded over a ('host', 'env')
mesh of ranks, all-reduce Q-learning, state-sharded value iteration, and
A2C with its gradients averaged over the ranks.

The script starts its own ranks, one process each, joined into one
`torch.distributed` process group: NCCL with one rank a card on the card
(every card this process sees, by default), Gloo on the CPU (two ranks by
default, laid out as 2 hosts × 1 rank).

    python examples_torch/05_multihost_sharded.py
    python examples_torch/05_multihost_sharded.py --device cpu --ranks 4
"""

from _common import default_ranks, parse_args, run_ranks


def rank_main(rank, world, dev, envs, steps):
    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.algos import greedy_policy_from_q, run_greedy_episode
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu_torch.models import A2CConfig, a2c_train_sharded
    from griduniverse_tpu_torch.parallel import (
        episode_stats_sharded,
        make_host_env_mesh,
        q_learning_sharded,
        value_iteration_sharded,
    )

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    mesh = make_host_env_mesh(device=dev)
    say(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} over {world} rank(s)")
    sem = gu.make_semantics(device=dev)
    level = walls_and_goal_16x16(device=dev)

    _, stats = episode_stats_sharded(mesh, sem, level, 0, envs, 200)
    say(f"sharded rollout: {200 * envs:,} steps, episodes={int(stats['episodes'])}")

    res = q_learning_sharded(
        mesh, sem, level, 1,
        num_steps=steps, batch_size=envs, epsilon=0.3, alpha=0.15,
    )
    policy = greedy_policy_from_q(res.q)
    _, ret, length, done = run_greedy_episode(sem, level, policy, max_steps=64)
    say(
        f"distributed Q-learning: episodes={int(res.episodes):,}, greedy "
        f"return={float(ret):.1f} len={int(length)} done={bool(done)}"
    )

    model = gu.build_model_table(sem, level)
    v, pol, iters = value_iteration_sharded(mesh, model)
    say(f"sharded VI converged in {int(iters)} sweeps")

    cfg = A2CConfig(rollout_len=8, hidden=(64,), embed_dim=32, lr=1e-3)
    a2c = a2c_train_sharded(mesh, sem, level, 2, cfg, num_updates=50, batch_size=envs)
    say(f"sharded A2C: episodes={int(a2c.episodes):,}, final loss={float(a2c.final_loss):.3f}")


def main():
    args = parse_args(
        "Multi-host sharded training",
        envs=(int, 1024, "total envs across the mesh"),
        steps=(int, 2000, "Q-learning steps"),
        ranks=(int, 0, "ranks (0: every card, or two on the CPU)"),
    )
    run_ranks(rank_main, args.ranks or default_ranks(args.device), args.device, args.envs, args.steps)


if __name__ == "__main__":
    main()
