"""The host's cost of one `torch.distributed` collective over NCCL in a world
of one, on one CUDA card: whether a collective waits for the device, and
what it costs the host when the card is busy. The measurement behind
`PERF.md`'s reading of the sharded trainers' time a collective (phase 27
(d) of `chip_smoke.py`). A one-off experiment, kept to reproduce its
readings; it is not part of the package.

    python -m experiments.nccl_host_cost

From the root of a checkout, on a machine with a CUDA card. It prints the
card's name and power limit (`nvidia-smi`), then for an all-gather into a
list (what `parallel/mesh.py` `_gather` calls), an all-gather into one
tensor, an int32 all-reduce and a plain `torch.add` as the control, the
host µs of five calls each, first with the card idle and then with about
10 ms of device work queued ahead of each call.
"""

from __future__ import annotations

import socket
import subprocess
import time

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    dev = torch.device("cuda", 0)
    a = torch.randn(4096, 4096, device=dev)
    x = torch.randn(30_000, device=dev)  # about a small trainer's flat gradients
    ints = torch.ones(1024, dtype=torch.int32, device=dev)

    def queued(n: int) -> None:  # n elementwise kernels over 64 MB, about 50 µs each
        for _ in range(n):
            a.mul_(1.0000001)

    for _ in range(3):
        dist.all_gather([torch.empty_like(x)], x)
        dist.all_reduce(ints)
    torch.cuda.synchronize()
    ops = {
        "all_gather list": lambda: dist.all_gather([torch.empty_like(x)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(torch.empty_like(x), x),
        "all_reduce int32": lambda: dist.all_reduce(ints),
        "torch add (control)": lambda: x.add(1.0),
    }
    for name, op in ops.items():
        for work in (0, 200):
            rows = []
            for _ in range(5):
                queued(work)
                t0 = time.perf_counter()
                op()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rows.append((t1 - t0) * 1e6)
            t0 = time.perf_counter()
            queued(work)
            torch.cuda.synchronize()
            dev_ms = (time.perf_counter() - t0) * 1e3
            print(f"{name}, {work} queued kernels (~{dev_ms:.2f} ms of device work): host µs a call {sorted(rows)}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
