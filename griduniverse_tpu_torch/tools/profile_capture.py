"""Where a captured trainer's step goes against the eager loop's, on one
CUDA card.

    python -m griduniverse_tpu_torch.tools.profile_capture [NAME ...]

From the root of a checkout, on a machine with a Hopper card and nvcc. The
arguments pick cases whose names start with them (all by default): `dqn_run`
on walls16 (uniform) at 65,536 envs and a ring of 131,072, `ppo_run` on
walls16 and over 65,536 per-env 9×9 backtracker mazes with the conv trunk,
and the gate's 7×7 ch32 PPO over 1,024 mazes. For each case and each way
(`*_run`, one step captured in a CUDA graph and replayed; `_*_run_eager`,
the plain loop), two calls from one state under `torch.profiler`, of n and
2n steps, so that a call's set-up (the warm-up step, the capture, the
learner's plans) cancels. It prints, a step: the device's busy µs, the span
from the first kernel's start to the last one's end, the gaps (span −
busy), the device events, and the ten kernel names whose µs a step differ
most between the two ways, with their counts.
"""

from __future__ import annotations

import subprocess
import sys
from collections import defaultdict

import torch

MAX_EPISODE_STEPS = 512
NUM_ENVS = 65_536


def _trace(fn) -> tuple[float, float, dict[str, list[float]]]:
    """(busy µs, span µs, {kernel name: [µs, count]}) of one call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    return sum(v[0] for v in by_name.values()), span, dict(by_name)


def _per_step(fn, n: int):
    """A step's (busy µs, span µs, {name: [µs, count]}): a call of 2n less
    a call of n, each over n."""
    b1, s1, k1 = _trace(lambda: fn(n))
    b2, s2, k2 = _trace(lambda: fn(2 * n))
    names = set(k1) | set(k2)
    kernels = {k: [(k2.get(k, [0, 0])[0] - k1.get(k, [0, 0])[0]) / n,
                   (k2.get(k, [0, 0])[1] - k1.get(k, [0, 0])[1]) / n] for k in names}
    return (b2 - b1) / n, (s2 - s1) / n, kernels


def main(argv: list[str] | None = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_capture: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.models import dqn, ppo
    from griduniverse_tpu_torch.tools import gen_artifact as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build.load()
    sem = gt.make_semantics()
    walls16 = builders.walls_and_goal_16x16()
    grids, start = M.generate_mazes_device(2026, (4, 4), NUM_ENVS, "backtracker")
    mazes = gt.Level(grid=grids, start_idx=start.expand(NUM_ENVS).contiguous())
    grid = dict(obs="grid", conv_channels=(32,), hidden=(64,))
    specs = [
        ("dqn walls16 uniform", "dqn", walls16,
         models.DQNConfig(buffer_capacity=2 * NUM_ENVS, max_episode_steps=MAX_EPISODE_STEPS), NUM_ENVS, 20),
        ("ppo walls16", "ppo", walls16, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS), NUM_ENVS, 2),
        ("ppo mazes64k", "ppo", mazes, models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS, **grid), NUM_ENVS, 1),
        ("gate 7x7 ch32", "ppo", G.maze_levels(G.TRAIN_MAZES_SEED, 1024, (3, 3), torch.device("cuda")),
         G.gate_config(G.CONFIGS["7x7_ch32"], 10), 1024, 2),
    ]
    api = {"dqn": (models.dqn_init, models.dqn_run, dqn._dqn_run_eager),
           "ppo": (models.ppo_init, models.ppo_run, ppo._ppo_run_eager)}
    picked = sys.argv[1:] if argv is None else argv
    for name, kind, level, cfg, b, n in specs:
        if picked and not any(name.startswith(p) for p in picked):
            continue
        init, run, eager = api[kind]
        ts0 = init(sem, level, 5, cfg, b)
        rows = {}
        for way, fn in (("captured", run), ("eager", eager)):
            call = (lambda k, fn=fn: fn(sem, level, ts0, cfg, k))
            call(1)  # first calls: library handles, the allocator
            busy, span, per_kernel = _per_step(call, n)
            rows[way] = per_kernel
            print(f"{name} {way}: a step {busy!r} us busy, {span!r} us span, {span - busy!r} us of gaps, "
                  f"{sum(c for _, c in per_kernel.values())!r} device events (from calls of {n} and {2 * n}) ({smi})")
        names = set(rows["captured"]) | set(rows["eager"])
        diff = sorted(names, key=lambda k: -abs(rows["captured"].get(k, [0, 0])[0] - rows["eager"].get(k, [0, 0])[0]))
        for k in diff[:10]:
            c, e = rows["captured"].get(k, [0.0, 0.0]), rows["eager"].get(k, [0.0, 0.0])
            print(f"  {c[0]:10.1f} us {c[1]:7.1f} x captured | {e[0]:10.1f} us {e[1]:7.1f} x eager | {k[:90]}")


if __name__ == "__main__":
    main()
