"""Rates of the neural trainers on one CUDA card, and where their time goes.

    python -m griduniverse_tpu_torch.tools.profile_learners [NAME ...]

From the root of a checkout, on a machine with a Hopper card and nvcc. The
arguments pick cases whose names start with them (e.g. `"ppo mazes64k"`; all
six by default). It prints, one line each:

- the card's name and power limit (`nvidia-smi`);
- for each trainer at its full width (65,536 envs, `max_episode_steps=512`),
  three calls of `*_run` from one initial state timed on the host clock around
  a synchronize, and the env steps/s: PPO on walls16 with the defaults (3
  updates a call), PPO over 65,536 per-env 9×9 Aldous–Broder mazes with the
  conv trunk (`obs="grid"`, `conv_channels=(32,)`, `hidden=(64,)`; 2 updates),
  A2C on walls16 with the defaults (3 updates); DQN on walls16 with a ring
  of 131,072 transitions, once with uniform and once with prioritized replay
  (100 steps a call), and DQN over 65,536 per-env 9×9 backtracker mazes with
  the conv Q-network (`obs="grid"`, `conv_channels=(32,)`, `hidden=(64,)`; 50
  steps);
- one call of each under `torch.profiler`: the device time of each kernel by
  name (the top twelve), the hand-written kernels' share of the busy time, the
  number of device events, and the device's idle share of the call: 1 − busy
  time / the call's median wall time WITHOUT the profiler (the profiler slows
  the host). A `*_run` call on the card is one step or update captured in a
  CUDA graph and replayed (`utils/capture.py`), after one eager warm-up step
  and the capture, which take most of the idle share at these few steps a
  call (`tools/profile_capture.py` splits a step's time against the eager
  loop's; `chip_smoke.py` phase 29 times the replays alone).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from .profile_solvers import _wall_ms

MAX_EPISODE_STEPS = 512
NUM_ENVS = 65_536
OUR_KERNELS = ("gae_kernel", "nstep_returns", "act_step", "greedy_step", "embed_rows", "agent_stamp",
               "aldous_broder", "backtracker", "per_score", "per_hist", "per_count", "per_compact",
               "per_finish", "pick_sort", "replay_write", "replay_gather", "prio_refresh", "refresh_claim",
               "refresh_write", "dqn_act_step", "segment_count", "segment_scan",
               "segment_scatter", "segment_sum", "mc_returns", "trace_pass", "random_scan_bits",
               "rollout_actions_bits", "grid_sweep", "grid_greedy", "td_fast_scan", "td_fast_step",
               "td_batched")


def _profile(name: str, fn, wall_ms: float, smi: str, top: int = 12):
    """One call of `fn` under the profiler, printed; returns (busy us,
    device events, idle share, {kernel name: (us, count)}), or None if no
    device time was recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = per_kernel.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy = sum(us for us, _ in per_kernel.values())
    if not busy:
        print(f"profile {name}: the profiler recorded no device time")
        return None
    wall_us = wall_ms * 1e3
    events = sum(c for _, c in per_kernel.values())
    ours = sum(us for n, (us, _) in per_kernel.items() if any(k in n for k in OUR_KERNELS))
    print(f"profile {name}: wall {wall_us!r} us without the profiler, device busy {busy!r} us "
          f"(idle share {100 * (1 - busy / wall_us):.2f} %), hand-written kernels {ours!r} us "
          f"({100 * ours / busy:.2f} % of busy), {events} device events ({smi})")
    for n, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us:12.1f} us  {count:7d} x  {n[:100]}")
    return busy, events, 1 - busy / wall_us, {n: tuple(v) for n, v in per_kernel.items()}


def main(argv: list[str] | None = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_learners: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.kernels import build
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M

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
    grids, start = M.generate_mazes_device(2026, (4, 4), NUM_ENVS, "aldous_broder")
    mazes = gt.Level(grid=grids, start_idx=start.expand(NUM_ENVS).contiguous())
    specs = [
        ("ppo walls16", models.ppo_init, models.ppo_run, walls16,
         models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS), 3),
        ("ppo mazes64k conv", models.ppo_init, models.ppo_run, mazes,
         models.PPOConfig(max_episode_steps=MAX_EPISODE_STEPS, obs="grid", conv_channels=(32,), hidden=(64,)), 2),
        ("a2c walls16", models.a2c_init, models.a2c_run, walls16,
         models.A2CConfig(max_episode_steps=MAX_EPISODE_STEPS), 3),
    ]
    cases = []
    for name, init, run, level, cfg, updates in specs:
        ts0 = init(sem, level, 5, cfg, NUM_ENVS)
        cases.append((f"{name} B={NUM_ENVS} T={cfg.rollout_len} updates={updates}",
                      updates * cfg.rollout_len * NUM_ENVS,
                      lambda run=run, level=level, ts0=ts0, cfg=cfg, updates=updates: run(sem, level, ts0, cfg, updates)))
    grids, start = M.generate_mazes_device(2026, (4, 4), NUM_ENVS, "backtracker")
    backtracker = gt.Level(grid=grids, start_idx=start.expand(NUM_ENVS).contiguous())
    ring = dict(buffer_capacity=2 * NUM_ENVS, max_episode_steps=MAX_EPISODE_STEPS)
    dqn_specs = [
        ("dqn walls16 uniform", walls16, models.DQNConfig(**ring), 100),
        ("dqn walls16 per", walls16, models.DQNConfig(**ring, prioritized=True), 100),
        ("dqn mazes64k conv", backtracker,
         models.DQNConfig(**ring, obs="grid", conv_channels=(32,), hidden=(64,)), 50),
    ]
    for name, level, cfg, steps in dqn_specs:
        # start from a filled ring, past the warm-up gate
        ts0 = models.dqn_run(sem, level, models.dqn_init(sem, level, 5, cfg, NUM_ENVS), cfg, 4)
        cases.append((f"{name} B={NUM_ENVS} capacity={cfg.buffer_capacity} steps={steps}", steps * NUM_ENVS,
                      lambda level=level, ts0=ts0, cfg=cfg, steps=steps: models.dqn_run(sem, level, ts0, cfg, steps)))
    picked = sys.argv[1:] if argv is None else argv
    cases = [c for c in cases if not picked or any(c[0].startswith(p) for p in picked)]
    wall_of = {}
    for name, work, fn in cases:
        fn()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        ms = [_wall_ms(fn) for _ in range(3)]
        wall_of[name] = sorted(ms)[1]
        print(f"{name}: ms={ms!r} env steps/s={[work / (m / 1e3) for m in ms]!r} "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({smi})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").sum().item()  # the profiler's own start-up
    for name, _, fn in cases:
        _profile(name, fn, wall_of[name], smi)


if __name__ == "__main__":
    main()
