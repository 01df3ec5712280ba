"""Example 4 — on-device procedural mazes: generate one perfect maze PER
ENV with the recursive backtracker (K11 on the card), then roll random
actions with auto-reset and report episode stats.

    python examples_torch/04_procedural_mazes.py --envs 1024 --cells 5
"""

from _common import parse_args


def main():
    args = parse_args(
        "Per-env procedural mazes",
        envs=(int, 1024, "parallel envs (one maze each)"),
        cells=(int, 5, "maze size in cells (grid is 2c+1 square)"),
        steps=(int, 512, "rollout steps"),
    )
    import torch

    import griduniverse_tpu_torch as gu
    from griduniverse_tpu_torch.core.types import Level
    from griduniverse_tpu_torch.levels.maze import generate_mazes_device
    from griduniverse_tpu_torch.levels.text import render_text
    from griduniverse_tpu_torch.ops.rollout import episode_stats, reset_batch

    sem = gu.make_semantics(device=args.device)
    grids, start = generate_mazes_device(0, (args.cells, args.cells), args.envs, device=args.device)
    print(f"generated {args.envs} mazes of shape {tuple(grids.shape[1:])} on device")
    print("maze #0:")
    print(render_text(grids[0].cpu().numpy(), start_idx=int(start)))

    levels = Level(grid=grids, start_idx=start.expand(args.envs).contiguous())
    state = reset_batch(levels, args.envs)
    gen = torch.Generator(device=args.device).manual_seed(2)
    _, stats = episode_stats(sem, levels, state, args.steps, generator=gen)
    print(
        f"random rollout over {args.steps * args.envs:,} steps: "
        f"episodes={int(stats['episodes']):,} "
        f"mean_return={float(stats['mean_return']):.2f} "
        f"mean_length={float(stats['mean_length']):.1f}"
    )


if __name__ == "__main__":
    main()
