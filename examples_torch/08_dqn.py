"""Example 8 — DQN with its replay ring on the card: each step one K7c
launch acts ε-greedily, steps the envs and stores the transitions into the
ring; the minibatch gather (K8b), double-DQN targets and polyak target
updates follow. Pass --sharded 1 to shard the envs and the ring over
ranks (one a card on the card, two Gloo ranks on the CPU).

    python examples_torch/08_dqn.py --steps 1500 --envs 64
    python examples_torch/08_dqn.py --device cpu --sharded 1
"""

from _common import default_ranks, parse_args, run_ranks


def make(dev, steps, per, hard_target):
    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu_torch.models import DQNConfig

    cfg = DQNConfig(
        buffer_capacity=16_384,
        batch_size_train=256,
        eps_anneal_steps=steps // 2,
        max_episode_steps=128,
        hidden=(128,),
        prioritized=bool(per),
        target_update="hard" if hard_target else "polyak",
    )
    return gu.make_semantics(device=dev), walls_and_goal_16x16(device=dev), cfg


def report(res, level, cfg, steps, envs, dt):
    import torch

    from griduniverse_tpu_torch.algos.utils import policy_arrows
    from griduniverse_tpu_torch.models import greedy_q_actions, make_q_network

    print(f"{steps} train steps / {steps * envs:,} env transitions in {dt:.1f}s "
          f"(incl. the kernels' first load)")
    print(f"episodes: {int(res.episodes):,}  mean return: {float(res.mean_return):.2f}")
    net = make_q_network(level, 4, cfg)
    all_states = torch.arange(level.num_states, dtype=torch.int32, device=level.device)
    policy = greedy_q_actions(net, res.params, all_states)
    print("\ngreedy Q policy:")
    print(policy_arrows(policy, level))


def rank_main(rank, world, dev, steps, envs, per, hard_target):
    import time

    from griduniverse_tpu_torch.models import dqn_train_sharded
    from griduniverse_tpu_torch.parallel import make_env_mesh

    sem, level, cfg = make(dev, steps, per, hard_target)
    mesh = make_env_mesh(device=dev)
    if rank == 0:
        print(f"mesh: {mesh.shape}")
    t0 = time.perf_counter()
    res = dqn_train_sharded(mesh, sem, level, 0, cfg, num_steps=steps, batch_size=envs)
    if rank == 0:
        report(res, level, cfg, steps, envs, time.perf_counter() - t0)


def main():
    args = parse_args(
        "DQN training",
        steps=(int, 1500, "train steps (each steps all envs once)"),
        envs=(int, 64, "parallel envs"),
        sharded=(int, 0, "1 = shard envs + ring over ranks"),
        per=(int, 0, "1 = prioritized replay (a Gumbel top-k draw, K8a; no sum-tree)"),
        hard_target=(int, 0, "1 = classic periodic target copies (else polyak)"),
    )
    if args.sharded:
        run_ranks(rank_main, default_ranks(args.device), args.device, args.steps, args.envs,
                  args.per, args.hard_target)
        return
    import time

    import torch

    from griduniverse_tpu_torch.models import dqn_train

    sem, level, cfg = make(args.device, args.steps, args.per, args.hard_target)
    t0 = time.perf_counter()
    res = dqn_train(sem, level, 0, cfg, num_steps=args.steps, batch_size=args.envs)
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)
    report(res, level, cfg, args.steps, args.envs, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
