"""Rates of the tabular solvers on one CUDA card, and where their time goes.

    python -m griduniverse_tpu_torch.tools.profile_solvers

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints, one line each:

- the card's name and power limit (`nvidia-smi`);
- for each solver entry point at its full width, three calls timed on the
  host clock around a synchronize, and the rate: grid-form VI over 65,536
  9×9 and 8,192 33×33 Aldous–Broder mazes and PI over 4,096 9×9 mazes
  (mazes/s); `compile_q_learning_fast` on walls16 at 65,536 envs × 2,000
  steps, `q_learning_batched` over the 65,536 mazes × 2,000 steps in float32
  and bfloat16, and `q_learning` (the generic step with K10) on walls16 at
  32 and 4,096 envs × 2,000 steps (transitions/s);
- one call of each under `torch.profiler`: the device time of each kernel
  by name, every hand-written kernel's share of the busy time, and the
  device's idle share of the call: 1 − busy time / the call's median wall
  time WITHOUT the profiler (the profiler slows the host). For `td_run`'s
  host loop the idle share is the time the card waits for the next small
  launch.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

MAX_EPISODE_STEPS = 512
STEPS = 2_000
OUR_KERNELS = ("grid_sweeps", "grid_sweep_global", "grid_greedy", "td_fast", "td_batched", "segment_count",
               "segment_scan", "segment_scatter", "segment_sum", "random_scan_bits", "rollout_actions_bits",
               "aldous_broder", "mc_returns", "trace_pass")


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(name: str, fn, wall_ms: float, smi: str) -> None:
    """One call under the profiler: busy time by kernel, and the idle share
    of the unprofiled call (`wall_ms`)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = wall_ms * 1e3
    per_kernel: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = per_kernel.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy = sum(us for us, _ in per_kernel.values())
    if not busy:
        print(f"profile {name}: the profiler recorded no device time")
        return
    ours = sum(us for n, (us, _) in per_kernel.items() if any(k in n for k in OUR_KERNELS))
    print(f"profile {name}: wall {wall_us!r} us without the profiler, device busy {busy!r} us "
          f"(idle share {100 * (1 - busy / wall_us):.2f} %), hand-written kernels {ours!r} us "
          f"({100 * ours / busy:.2f} % of busy), {sum(c for _, c in per_kernel.values())} device events ({smi})")
    for n, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {us:12.1f} us  {count:7d} x  {n[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_solvers: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build.load()

    # no `device` anywhere: the entry points run on the card by default
    sem = gt.make_semantics()
    walls16 = builders.walls_and_goal_16x16()
    bl_walls = bp.pack_level(walls16)

    def mazes(seed, cells, n):
        grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder")
        return gt.Level(grid=grids, start_idx=start.expand(n).contiguous())

    lv64, lv33 = mazes(2026, (4, 4), 65_536), mazes(2027, (16, 16), 8_192)
    lv_pi = gt.Level(grid=lv64.grid[:4096].contiguous(), start_idx=lv64.start_idx[:4096].contiguous())
    fast = algos.compile_q_learning_fast(sem, bl_walls, 65_536, STEPS, max_episode_steps=MAX_EPISODE_STEPS)
    cases = [
        ("VI 9x9 N=65536", 65_536, "mazes/s", lambda: algos.value_iteration_batched_grid(sem, lv64)),
        ("VI 33x33 N=8192", 8_192, "mazes/s",
         lambda: algos.value_iteration_batched_grid(sem, lv33, max_iters=400)),
        ("PI 9x9 N=4096", 4_096, "mazes/s", lambda: algos.policy_iteration_batched_grid(sem, lv_pi)),
        (f"shared-Q walls16 B=65536 T={STEPS}", 65_536 * STEPS, "transitions/s", lambda: fast(7)),
    ]
    for dtype in ("float32", "bfloat16"):
        cases.append((
            f"per-maze Q {dtype} N=65536 T={STEPS}", 65_536 * STEPS, "transitions/s",
            lambda dtype=dtype: algos.q_learning_batched(
                sem, lv64, 9, STEPS, dtype=dtype, max_episode_steps=MAX_EPISODE_STEPS),
        ))
    for b in (32, 4096):
        cases.append((
            f"q_learning (td_run) walls16 B={b} T={STEPS}", b * STEPS, "transitions/s",
            lambda b=b: algos.q_learning(sem, walls16, 11, num_steps=STEPS, batch_size=b),
        ))
    wall_of = {}
    for name, work, unit, fn in cases:
        fn()  # warm-up
        ms = [_wall_ms(fn) for _ in range(3)]
        wall_of[name] = sorted(ms)[1]
        print(f"{name}: ms={ms!r} {unit}={[work / (m / 1e3) for m in ms]!r} ({smi})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").sum().item()  # the profiler's own start-up
    for name, _, _, fn in cases:
        _profile(name, fn, wall_of[name], smi)


if __name__ == "__main__":
    main()
