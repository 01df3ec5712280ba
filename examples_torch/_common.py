"""Shared example-script plumbing: the device flag, argparse, and the ranks
of the sharded examples (05, 09, 12).

The examples run on the card unless `--device cpu` is given, where every
kernel takes its plain PyTorch version. They import the port from this
checkout, so they run without an install.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(description: str, **extra_flags):
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="cuda: the card and its kernels (default); cpu: the kernels' plain PyTorch versions",
    )
    for flag, (typ, default, help_) in extra_flags.items():
        p.add_argument(f"--{flag}", type=typ, default=default, help=help_)
    args = p.parse_args()

    import torch

    args.device = torch.device(args.device)
    return args


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    """NCCL for ranks on cards (one card a rank), Gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device, rank: int):
    """Rank `rank`'s device: card `rank`, or the CPU."""
    import torch

    return torch.device("cuda", rank) if device.type == "cuda" else torch.device("cpu")


def default_ranks(device) -> int:
    """Every card this process sees (NCCL takes one rank a card), or two
    ranks on the CPU."""
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 2


def join(rank: int, world: int, port: int, device, timeout_s: float = 120.0):
    """Join rank `rank` of `world` to the process group at
    tcp://127.0.0.1:`port`; returns the rank's device."""
    from griduniverse_tpu_torch.parallel import distributed

    dev = rank_device(device, rank)
    distributed.initialize(backend_for(device), f"tcp://127.0.0.1:{port}", world, rank,
                           device=dev, timeout_s=timeout_s)
    return dev


def _rank_main(fn, rank: int, world: int, port: int, device_type: str, args: tuple):
    import torch

    from griduniverse_tpu_torch.parallel import distributed

    dev = join(rank, world, port, torch.device(device_type))
    try:
        fn(rank, world, dev, *args)
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, device, *args, timeout_s: float = 900.0) -> None:
    """Run `fn(rank, world, rank_device, *args)` on `world` spawned ranks
    joined into one process group (the way the port's sharded tests start
    them); exit with an error if a rank fails or outlives `timeout_s`."""
    if device.type == "cuda":
        import torch

        if world > torch.cuda.device_count():
            raise SystemExit(f"{world} ranks need {world} cards for NCCL (one a rank); "
                             f"this process sees {torch.cuda.device_count()}")
        from griduniverse_tpu_torch.kernels import build

        build.load()  # built once, before the ranks that load it start
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, device.type, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if late or any(codes):
        raise SystemExit(f"rank exit codes {codes}, {len(late)} killed at the deadline")
