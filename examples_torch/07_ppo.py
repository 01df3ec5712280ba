"""Example 7 — PPO: GAE (K7a) and the clipped surrogate, each rollout step
a policy forward and one K7b launch on the card. Pass --sharded 1 to run
it data-parallel over ranks (envs sharded, parameters replicated,
gradients averaged over the ranks each minibatch): one rank a card on the
card, two Gloo ranks on the CPU.

    python examples_torch/07_ppo.py --updates 200 --envs 128
    python examples_torch/07_ppo.py --device cpu --sharded 1
"""

from _common import default_ranks, parse_args, run_ranks


def make(dev):
    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu_torch.models import PPOConfig

    cfg = PPOConfig(rollout_len=16, lr=1e-3, num_epochs=2, num_minibatches=4, max_episode_steps=128)
    return gu.make_semantics(device=dev), walls_and_goal_16x16(device=dev), cfg


def report(res, sem, level, cfg, updates, envs, dt):
    import torch

    from griduniverse_tpu_torch.algos.utils import policy_arrows
    from griduniverse_tpu_torch.models import greedy_actions, make_network

    total = updates * cfg.rollout_len * envs
    print(f"{updates} updates / {total:,} env transitions in {dt:.1f}s (incl. the kernels' first load)")
    print(f"episodes: {int(res.episodes):,}  mean return: {float(res.mean_return):.2f}")
    # greedy policy over all states, rendered as arrows
    net = make_network(level, 4, cfg)
    all_states = torch.arange(level.num_states, dtype=torch.int32, device=level.device)
    policy = greedy_actions(net, res.params, all_states)
    print("\ngreedy policy:")
    print(policy_arrows(policy, level))


def rank_main(rank, world, dev, updates, envs):
    import time

    from griduniverse_tpu_torch.models import ppo_train_sharded
    from griduniverse_tpu_torch.parallel import make_env_mesh

    sem, level, cfg = make(dev)
    mesh = make_env_mesh(device=dev)
    if rank == 0:
        print(f"mesh: {mesh.shape}")
    t0 = time.perf_counter()
    res = ppo_train_sharded(mesh, sem, level, 0, cfg, num_updates=updates, batch_size=envs)
    if rank == 0:
        report(res, sem, level, cfg, updates, envs, time.perf_counter() - t0)


def main():
    args = parse_args(
        "PPO training",
        updates=(int, 200, "PPO updates"),
        envs=(int, 128, "parallel envs"),
        sharded=(int, 0, "1 = shard envs over ranks"),
    )
    if args.sharded:
        run_ranks(rank_main, default_ranks(args.device), args.device, args.updates, args.envs)
        return
    import time

    import torch

    from griduniverse_tpu_torch.models import ppo_train

    sem, level, cfg = make(args.device)
    t0 = time.perf_counter()
    res = ppo_train(sem, level, 0, cfg, num_updates=args.updates, batch_size=args.envs)
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)
    report(res, sem, level, cfg, args.updates, args.envs, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
