"""Example 9 — the multi-process runtime (one OS process a rank).

Self-launching demo of `parallel.distributed`: run with no worker
arguments and it starts `--procs` copies of itself, joins them into ONE
`torch.distributed` process group (`distributed.initialize` with the
address, world size and rank given: nothing on a machine tells a process
of a cluster), and trains the sharded Q-learner across the process
boundary: every process runs the same program on its own env shard, and
the all-reduces ride the collective fabric (Gloo on the CPU, NCCL with
one rank a card on the card).

    python examples_torch/09_multiprocess.py --device cpu --procs 2
    python examples_torch/09_multiprocess.py --procs 1          # a world of one on one card

On a cluster, skip the launcher: run each rank's command with its own
`--worker` rank and one shared `--port` on the first host.
"""

from __future__ import annotations

import os
import subprocess
import sys

from _common import free_port, join


def worker(pid: int, nproc: int, port: int, device, steps: int, envs: int):
    dev = join(pid, nproc, port, device)

    from griduniverse_tpu_torch import make_semantics
    from griduniverse_tpu_torch.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu_torch.parallel import distributed, make_host_env_mesh, q_learning_sharded
    from griduniverse_tpu_torch.parallel.distributed import fetch_replicated

    mesh = make_host_env_mesh(device=dev)
    print(f"[proc {pid}] joined: {nproc} processes, backend {mesh.backend}, device {dev}; "
          f"mesh {dict(zip(mesh.axis_names, mesh.shape))}", flush=True)
    res = q_learning_sharded(
        mesh, make_semantics(device=dev), walls_and_goal_16x16(device=dev), 0,
        num_steps=steps, batch_size=envs,
    )
    print(f"[proc {pid}] episodes={int(res.episodes)} mean_return={float(res.mean_return):.2f} "
          f"(Q replicated: sum={float(fetch_replicated(res.q).sum()):.3f})", flush=True)
    distributed.shutdown()


def main():
    # plain argparse here (not _common.parse_args): the launcher and its
    # workers share one command line
    import argparse

    import torch

    p = argparse.ArgumentParser(description="multi-process sharded training")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--procs", type=int, default=0, help="ranks (0: every card, or two on the CPU)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args()
    device = torch.device(args.device)
    procs = args.procs or (torch.cuda.device_count() if device.type == "cuda" else 2)

    if args.worker >= 0:
        worker(args.worker, procs, args.port, device, args.steps, args.envs)
        return

    if device.type == "cuda":
        from griduniverse_tpu_torch.kernels import build

        build.load()  # built once, before the workers that load it start
    port = free_port()
    children = [
        subprocess.Popen([
            sys.executable, os.path.abspath(__file__),
            "--worker", str(i), "--port", str(port), "--procs", str(procs),
            "--device", args.device, "--steps", str(args.steps), "--envs", str(args.envs),
        ])
        for i in range(procs)
    ]
    rcs = [c.wait() for c in children]
    if any(rcs):
        sys.exit(f"worker exit codes: {rcs}")
    print(f"all {procs} processes completed")


if __name__ == "__main__":
    main()
