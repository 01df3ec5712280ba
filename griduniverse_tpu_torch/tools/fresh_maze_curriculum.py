"""Fresh-maze curriculum probe for 11×11 generalization.

Counterpart of `tools/fresh_maze_curriculum.py`, with the same flags (plus
`--device`) and output lines. Train in chunks, regenerating the 1,024-maze
training set from a fresh seed every chunk and carrying the parameters and
the Adam state across chunks: every chunk has the same shapes, but the
agent sees chunks × mazes distinct mazes over the run. The curriculum is
`gen_artifact.curriculum_train`, and the mazes `gen_artifact.maze_levels`
(K3 on the card).

Run: python -m griduniverse_tpu_torch.tools.fresh_maze_curriculum --cells 5 --chunks 8
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import make_semantics
from ..models import greedy_success_rate, make_network
from ..utils.platform import resolve_device
from .gen_artifact import EVAL_MAZES_SEED, curriculum_train, gate_config, maze_levels, rolled_tiles_level


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=5)
    ap.add_argument("--mazes", type=int, default=1024)
    ap.add_argument("--eval_mazes", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--updates_per_chunk", type=int, default=500)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--ent", type=float, default=0.05)
    ap.add_argument("--budget", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sem = make_semantics(device=device)
    cells = (args.cells, args.cells)
    eval_lv = maze_levels(EVAL_MAZES_SEED, args.eval_mazes, cells, device)
    abl_lv = rolled_tiles_level(eval_lv)
    spec = dict(ch=(32, 32), lr_schedule="linear", ent=args.ent, fresh_maze_chunks=args.chunks)
    cfg = gate_config(spec, args.updates_per_chunk)
    side = 2 * args.cells + 1
    print(f"== {side}x{side} fresh-maze curriculum: {args.chunks} chunks x "
          f"{args.updates_per_chunk} updates, {args.chunks * args.mazes} distinct training mazes total",
          flush=True)
    net = make_network(eval_lv, sem.num_actions, cfg)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ts, lv = curriculum_train(sem, cfg, seed, args.chunks, args.updates_per_chunk, args.mazes,
                                  cells, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        tr = float(greedy_success_rate(sem, net, ts.params, lv, args.budget))
        he = float(greedy_success_rate(sem, net, ts.params, eval_lv, args.budget))
        ab = float(greedy_success_rate(sem, net, ts.params, eval_lv, args.budget, tiles_levels=abl_lv))
        print(f"  seed {seed}: last-chunk-train {tr:.3f} heldout {he:.3f} ablation {ab:.3f} ({wall:.0f}s)",
              flush=True)


if __name__ == "__main__":
    main()
