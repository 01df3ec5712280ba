"""One agent, thousands of mazes: per-env-level PPO with grid observations.

Generate N distinct perfect mazes on the device (K3's Aldous–Broder walks),
train one conv-trunk PPO agent across all of them at once (each env lives
in its own maze; the level's tiles enter the network as per-sample planes,
the agent plane stamped by K9b), then evaluate the greedy policy on
held-out mazes it never trained on.

Also shows the solver side of the same composition: batched value
iteration solves every training maze at once, giving the optimal
success ceiling for comparison.

Run (the second line is the gate's 7×7 recipe,
`python -m griduniverse_tpu_torch.tools.gen_artifact --configs 7x7_ch32`):
    python examples_torch/11_maze_generalization.py --device cpu --mazes 64 --updates 20
    python examples_torch/11_maze_generalization.py --mazes 1024 --updates 1500 --channels 32 --hidden 64
"""

from __future__ import annotations

import time

from _common import parse_args


def main():
    args = parse_args(
        "PPO generalization across distinct on-device mazes",
        mazes=(int, 1024, "number of training mazes (= env batch)"),
        eval_mazes=(int, 64, "held-out mazes for the generalization check"),
        cells=(int, 3, "maze cells per side (grid is 2*cells+1 square)"),
        updates=(int, 200, "PPO updates"),
        channels=(int, 16, "conv trunk width"),
        hidden=(int, 32, "dense trunk width"),
    )
    import torch

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.algos import build_model_tables, value_iteration_batched
    from griduniverse_tpu_torch.models import (
        PPOConfig, greedy_success_rate, greedy_success_rate_tabular,
        init_network_params, make_network, ppo_train,
    )
    from griduniverse_tpu_torch.tools.gen_artifact import EVAL_MAZES_SEED, TRAIN_MAZES_SEED, maze_levels

    dev = args.device
    sem = gu.make_semantics(device=dev)
    cells = (args.cells, args.cells)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    train_lv = maze_levels(TRAIN_MAZES_SEED, args.mazes, cells, dev)
    eval_lv = maze_levels(EVAL_MAZES_SEED, args.eval_mazes, cells, dev)
    sync()
    print(f"generated {args.mazes}+{args.eval_mazes} uniform mazes on device "
          f"in {time.perf_counter() - t0:.1f}s")

    # the optimal ceiling: solve EVERY training maze at once (batched VI),
    # then roll the optimal tabular policies on the same engine and success
    # metric the PPO agent is scored with
    t0 = time.perf_counter()
    models = build_model_tables(sem, train_lv)
    _, pi_star, iters = value_iteration_batched(models)
    ceiling = float(greedy_success_rate_tabular(sem, train_lv, pi_star))
    print(f"batched VI solved all {args.mazes} mazes in "
          f"{time.perf_counter() - t0:.1f}s ({int(iters)} sweeps); "
          f"optimal-policy success ceiling {ceiling:.2f}")

    # the gate's 7×7 recipe (`tools/gen_artifact.py` CONFIGS["7x7_ch32"] at
    # --mazes 1024 --updates 1500 --channels 32 --hidden 64)
    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=(args.channels,), hidden=(args.hidden,),
        num_epochs=4, num_minibatches=4, lr=1e-3, ent_coef=0.03, gamma=0.97,
        compute_dtype="float32",
    )
    net = make_network(train_lv, 4, cfg)

    def greedy_success(params, levels, max_steps=60):
        return float(greedy_success_rate(sem, net, params, levels, max_steps))

    p0 = init_network_params(net, 7)
    print(f"untrained held-out success: {greedy_success(p0, eval_lv):.2f}")

    t0 = time.perf_counter()
    res = ppo_train(sem, train_lv, 1, cfg, num_updates=args.updates, batch_size=args.mazes)
    episodes = int(res.episodes)
    print(f"trained {args.updates} updates x {args.mazes} mazes in "
          f"{time.perf_counter() - t0:.1f}s ({episodes} episodes)")
    print(f"train-maze greedy success:    {greedy_success(res.params, train_lv):.2f} "
          f"vs optimal ceiling {ceiling:.2f}")
    print(f"HELD-OUT-maze greedy success: {greedy_success(res.params, eval_lv):.2f}")


if __name__ == "__main__":
    main()
