"""Rates of the port's main path on one CUDA card, and where its time goes.

    python -m griduniverse_tpu_torch.tools.profile_rollout

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints, one line each:

- the card's name and power limit (`nvidia-smi`);
- steps/s of `compile_rollout_random` (K1) at the reference's scan length,
  three calls per shape, each timed with CUDA events after a warm-up:
  walls16 at 65,536 and 4,096 envs, lava at 16,384, empty 8×8 at 1 env
  (100,000 steps), and 65,536 per-env 4×4-cell Aldous–Broder mazes
  (50,000 steps); all with `max_episode_steps=512`;
- K3 alone, seeded, 65,536 mazes of 4×4, 8×8 and 16×16 cells: mean ms of
  5 calls and mazes/s;
- one walls16 call of 65,536 envs × 10,000 steps under `torch.profiler`:
  the device time of each kernel, K1's share of it, and the same call's
  time between CUDA events without the profiler.
"""

from __future__ import annotations

import subprocess
import sys

import torch

MAX_EPISODE_STEPS = 512


def _event_ms(fn) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build.load()

    sem = gt.make_semantics(device=dev)
    walls16 = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    grids, start = M.generate_mazes_device(2026, (4, 4), 65_536, "aldous_broder", device=dev)
    mazes = bp.pack_level(gt.Level(grid=grids, start_idx=start.expand(65_536).contiguous()))
    shapes = (
        ("walls16", walls16, 65_536, 100_000),
        ("walls16", walls16, 4_096, 100_000),
        ("lava", bp.pack_level(builders.lava_level(device=dev)), 16_384, 100_000),
        ("empty8", bp.pack_level(builders.empty_level(8, 8, goal=True, device=dev)), 1, 100_000),
        ("mazes64k", mazes, 65_536, 50_000),
    )
    for name, bl, b, steps in shapes:
        fn = bp.compile_rollout_random(sem, bl, b, steps, max_episode_steps=MAX_EPISODE_STEPS)
        fn(1)  # warm-up
        ms = [_event_ms(lambda: fn(7 + k)) for k in range(3)]
        rates = [b * steps / (m / 1e3) for m in ms]
        print(f"rollout {name} B={b} T={steps}: ms={ms!r} steps/s={rates!r} ({smi})")

    for cells in ((4, 4), (8, 8), (16, 16)):
        M._aldous_broder_mazes(cells, 65_536, seed=1, device=dev)  # warm-up
        ms = sum(_event_ms(lambda: M._aldous_broder_mazes(cells, 65_536, seed=5 + k, device=dev))
                 for k in range(5)) / 5
        print(f"K3 seeded cells={cells} B=65536: ms={ms!r} mazes/s={65_536 / (ms / 1e3)!r} ({smi})")

    fn = bp.compile_rollout_random(sem, walls16, 65_536, 10_000, max_episode_steps=MAX_EPISODE_STEPS)
    fn(1)  # warm-up
    plain_ms = _event_ms(lambda: fn(7))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(7)
        torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(per_kernel.values())
    if not busy:
        print("profile walls16 B=65536 T=10000: the profiler recorded no device time")
    else:
        k1 = sum(us for n, us in per_kernel.items() if "random_scan_bits" in n)
        print(f"profile walls16 B=65536 T=10000: device busy {busy!r} us, K1 {k1!r} us "
              f"({100 * k1 / busy:.2f} %), event time without profiler {plain_ms!r} ms ({smi})")
        for n, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {us:10.1f} us  {n[:100]}")


if __name__ == "__main__":
    main()
