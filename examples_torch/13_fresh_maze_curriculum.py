"""Unbounded maze diversity at bounded memory: the fresh-maze curriculum.

When generalization becomes DATA-bound (any fixed set of N mazes trains
well but generalizes poorly because N mazes no longer cover the maze
space, first seen at 11×11), the fix is not a bigger batch but chunked
training: regenerate the training set from a fresh seed every chunk, and
carry the parameters and the optimizer state (the lr schedule's Adam count
included) across the level swap. Every chunk has the same shapes, but the
agent sees `chunks × mazes` distinct mazes over the run; regenerating them
is one K3 launch.

This composes three public pieces the earlier examples showed separately:
on-device maze generation (example 04), per-env-level conv-trunk PPO
(example 11), and warm-started chunked training (example 12). The
curriculum itself is `tools/gen_artifact.py`'s `curriculum_train`.

Run (the second line is the gate's 11×11 recipe,
`python -m griduniverse_tpu_torch.tools.gen_artifact --configs 11x11_curriculum`):
    python examples_torch/13_fresh_maze_curriculum.py --device cpu --mazes 64 --chunks 2 --updates_per_chunk 10
    python examples_torch/13_fresh_maze_curriculum.py --cells 5 --mazes 1024 --eval_mazes 256 \
        --chunks 32 --updates_per_chunk 500 --channels 32 --hidden 64
"""

from __future__ import annotations

import time

from _common import parse_args


def main():
    args = parse_args(
        "PPO trained on a fresh batch of on-device mazes every chunk",
        cells=(int, 3, "maze cells per side (grid is 2*cells+1 square)"),
        mazes=(int, 256, "training mazes per chunk (= env batch)"),
        eval_mazes=(int, 64, "held-out mazes for the generalization check"),
        chunks=(int, 3, "training chunks; each sees a fresh maze set"),
        updates_per_chunk=(int, 60, "PPO updates per chunk"),
        channels=(int, 16, "conv trunk width (one layer per value given)"),
        hidden=(int, 32, "dense trunk width"),
        seed=(int, 1, "seed for maze regeneration and training"),
    )
    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.models import PPOConfig, greedy_success_rate, make_network
    from griduniverse_tpu_torch.tools.gen_artifact import (
        EVAL_MAZES_SEED, curriculum_train, maze_levels, rolled_tiles_level,
    )

    dev = args.device
    sem = gu.make_semantics(device=dev)
    cells = (args.cells, args.cells)
    side = 2 * args.cells + 1
    total_updates = args.chunks * args.updates_per_chunk

    eval_lv = maze_levels(EVAL_MAZES_SEED, args.eval_mazes, cells, dev)
    # ablation control: same agent, WRONG tile planes: success here is a
    # motion prior, not maze reading
    abl_lv = rolled_tiles_level(eval_lv)

    # conv_channels=(c, c) for cells >= 4: at 9x9 and up a second layer
    # widens the receptive field to 5x5
    ch = (args.channels,) * (2 if args.cells >= 4 else 1)
    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=ch, hidden=(args.hidden,),
        num_epochs=4, num_minibatches=4,
        lr=1e-3, lr_schedule="linear", lr_decay_updates=total_updates,
        ent_coef=0.05 if args.cells >= 4 else 0.03, gamma=0.97,
        compute_dtype="float32",
    )
    print(f"{side}x{side} fresh-maze curriculum: {args.chunks} chunks x "
          f"{args.updates_per_chunk} updates, {args.chunks * args.mazes} distinct training mazes total")

    t0 = time.perf_counter()
    ts, lv = curriculum_train(sem, cfg, args.seed, args.chunks, args.updates_per_chunk, args.mazes,
                              cells, dev)
    episodes = int(ts.episodes)  # a read of the device: the training has ended
    print(f"trained {total_updates} updates in {time.perf_counter() - t0:.1f}s "
          f"({episodes} episodes in the last chunk)")

    net = make_network(eval_lv, 4, cfg)
    budget = 60 if args.cells <= 4 else 100
    tr = float(greedy_success_rate(sem, net, ts.params, lv, budget))
    he = float(greedy_success_rate(sem, net, ts.params, eval_lv, budget))
    ab = float(greedy_success_rate(sem, net, ts.params, eval_lv, budget, tiles_levels=abl_lv))
    print(f"last-chunk train success:     {tr:.3f}")
    print(f"HELD-OUT success:             {he:.3f}")
    print(f"wrong-tiles ablation control: {ab:.3f}  (motion prior only)")


if __name__ == "__main__":
    main()
