"""K1's, K2's, K3's, K4's, K5's, K6's, K7a's, K7b's, K7c's, K9a's, K9b's, K10's, K11's, K12's and K13's times on one CUDA card, beside another tree's.

    python -m griduniverse_tpu_torch.tools.profile_turns [--against DIR] [--tiers] [PART ...]

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints the card's name and power limit (`nvidia-smi`), then, for this tree
(and with `--against DIR` for the tree at DIR too, in turns: DIR, this
tree, this tree, DIR, each in a process of its own that imports that
tree's package and builds its kernels):

- K4's call (`grid_sweeps_cuda`) of 16 VI sweeps over 65,536 9×9 and 8,192
  33×33 Aldous–Broder mazes from V = 0, of 16 evaluation sweeps of a random
  policy over 4,096 and 65,536 9×9 mazes, and its greedy step
  (`grid_greedy_cuda`) over the 65,536: CUDA events around 30 calls after
  a warm-up, the wrapper's checks and allocations included, and the
  host's time of a call (the least of five rounds of 100 calls with no
  synchronize inside);
- the solves on the host clock around a synchronize, three calls each:
  `value_iteration_batched_grid` over the 65,536 9×9 and the 8,192 33×33
  mazes (at most 400 sweeps), `policy_iteration_batched_grid` over the
  first 4,096 9×9 mazes, with the rate in mazes/s;
- one VI solve over the 9×9 mazes and one PI solve under `torch.profiler`:
  the device time by kernel and the idle share (1 − busy / the median wall);
- K9b's forward and backward (`agent_stamp_cuda`,
  `agent_stamp_backward_cuda`) at a PPO minibatch over per-env 9×9 mazes
  (N = 262,144 samples over Nl = 16,384 levels, C = 32, bfloat16), timed as
  K4's calls are;
- K5 (`td_scan_fast`) as a 2,000-step Q-learning scan at walls16 with
  B = 65,536 and as a 300-step scan at one 65×65 backtracker maze (16,900 Q
  entries, its global-memory tier) with B = 65,536 (CUDA events around 3
  scans after a warm-up), and one `compile_q_learning_fast` run of the
  first under `torch.profiler`, with its idle share;
- K7c (`dqn_act_step` at walls16, B = 65,536, A = 4, through the learner's
  host plan) and a step's act-and-store (K7c's store form where the tree
  has it, else K7c followed by `buffer_write`), uniform and prioritized
  into a ring of 131,072: as timed over 200 calls, as the host's µs a
  call and in a CUDA graph of ten, with a hash of the ring and the
  transition, which every turn must print alike; and 20 DQN steps
  (`dqn_run`) under `torch.profiler`: device events a step and the idle
  share.

- K6 (`q_learning_batched`) as a 2,000-step Q-learning run over 65,536 9×9
  Aldous–Broder mazes in float32 and in bfloat16, and as a 200-step run over
  8,192 33×33 mazes (the tier of tables in device memory), CUDA events
  around 2 runs after a warm-up; beside each, a call of no steps (the
  call's fixed cost: the set-up, the tables' copies in and out, the first
  draw), and at 9×9 one such call under `torch.profiler` (the device time
  by kernel: K6's own against the wrapper's set-up, and the idle share);
- K7b at walls16 with B = 65,536 and A = 4 (through a host plan where the
  tree has one, `kernels.act_step.ActStepPlan`; else `a2c.act_step`) as timed
  over 200 calls, as the host's µs a call and as a call in a CUDA graph of
  ten (the plan built on the capture's stream), and three `ppo_run` calls
  of 3 updates at walls16, B = 65,536, on the host clock, one of them under
  `torch.profiler` (device events an update, the idle share).

- K9a's forward (`embed_rows_cuda`, S = 256, E = 16) in bfloat16 at
  N = 65,536, 262,144 and 1,048,576 (a rollout step, a PPO minibatch, an
  A2C update) and in float32 at 262,144: a call as timed (30 calls), in a
  CUDA graph of ten, and the host's µs a call, of the wrapper and of the
  layer (`networks.embed_rows` under `torch.no_grad`, as a rollout calls
  it); beside it `F.embedding(obs, table.to(cdt))`, the library's way to
  the same function (the table's cast and the lookup: two launches), as
  timed and in a graph; bit for bit the same rows;
- K13 (`mc_returns_cuda`) at T = 100 over B = 256 and 1,024 episodes (a
  round of `mc_control`, `mc_prediction` at 1,024), the returns alone and
  with the first-visit mask: as timed, in a CUDA graph of ten, the host's
  µs (`experiments/k13_groups.py` times each group of episodes a block).

- K12 (`td_lambda.trace_pass`, through a `TracePassPlan` built once where
  the tree has one) on the control trace (65,536 envs × 256 states × 4
  actions, SARSA(λ)'s and Watkins Q(λ)'s) and the prediction trace
  (65,536 × 256 states, `td_lambda_prediction`'s): a step as timed, the
  host's µs, a step in a CUDA graph of ten, the device time by kernel
  (`torch.profiler`), and the hash of one step from the same trace, which
  every turn must print alike;
- K7a (`gae_cuda`, `nstep_returns_cuda`) at T = 16 and 128 over
  B = 65,536 envs (`ppo_64k`'s and `a2c_64k`'s rollout, and a long one):
  a call as timed, in a CUDA graph of ten and on the host, with the hash
  of the call's outputs, which every turn must print alike.

- K11 (`_backtracker_mazes`, what `generate_mazes_device` calls) at the maze path's four
  shapes: 65,536 mazes of 4×4 cells, 8,192 of 16×16, 65,536 of 32×32 and
  1,024 of 63×63; K3 (`_aldous_broder_mazes`) seeded over 65,536 mazes of
  4×4 cells and injected over 256 of 32×32 for 5,000 steps: a call as timed
  (CUDA events around calls after a warm-up), the two 4×4 shapes and K11's
  16×16 also in a CUDA graph of ten, with the cycles an iteration or step
  at the widest shape (the call's time over its longest chain) and a hash
  of each call's grids, which every turn must print alike; and on the host
  clock (median of three), phase 16's four `generate_mazes_device` calls of
  `chip_smoke.py` (`k11`) and the PPO-over-mazes set-up, 65,536 4×4
  Aldous–Broder mazes generated and packed (`k3`).

- K2 (`rollout_actions_bits`, auto-reset, max_episode_steps 64) at walls16
  with B = 4,096 and T = 512, over 4,096 per-env 4×4 Aldous–Broder mazes
  with T = 512, at walls16 with B = 65,536 and T = 512, and as the golden
  replay over four 4×4 mazes (`tests/golden/cfg4_mazes.npz`): a call as
  timed (CUDA events around 30 calls after a warm-up) and in a CUDA graph
  of ten, with a hash of the call's outputs, which every turn must print
  alike; and K1 (`random_scan_bits`) at walls16, B = 65,536, T = 1,000, as
  timed (`experiments/k2_cycles.py` reads K2's cycles a step).

- K4 above 16,384 states a maze (`k4c`): `grid_sweeps_cuda` of 16 VI
  sweeps and of 16 evaluation sweeps of a random policy over 64 sidewinder
  mazes of 161×129 (the tier the tree picks: the cluster tier here, the
  global tier in a tree without it): a call as timed (30 calls), in a CUDA
  graph of ten and on the host, with a hash of V and the maxima, which
  every turn must print alike; and `value_iteration_batched_grid` over the
  64 on the host clock (three calls), with the launches of one;
- K5's sharded form (`k5s`) at walls16 with B = 65,536: one step on the
  same rows again and again (step 1 of the explicit form: Q_1 from a Q and
  a summed aggregate, the envs stepped, the step's aggregate added, the
  next cleared), through a `TdStepPlan` built once where the tree has one,
  else through `td_step_sharded_cuda`: as timed (200 calls), on the host
  and in a CUDA graph of ten; and a 2,000-step `td_scan_fast_sharded` with
  an all-reduce that returns its input (as timed, three scans; the hash of
  Q and the lanes, which every turn must print alike), one scan profiled
  (device time by kernel and the idle share).

- K1 (`random_scan_bits`, `k1`) with max_episode_steps 512 at the rollout
  shapes of `bench.py`: walls16 with B = 65,536 and T = 1,000 in the
  xorshift and the threefry stream, lava with B = 16,384, per-env 9×9
  Aldous–Broder mazes with B = 65,536, per-env 33×33 mazes with B = 16,384
  (T = 1,000 each), walls16 with B = 4,096 (T = 1,000) and an empty 8×8
  level with B = 1 and T = 100,000 (`cfg1b`'s chain): a call as timed and
  in a CUDA graph of ten, the cycles a step of the call in the graph at the
  SM's clock (its time over T; `experiments/k1_cycles.py` reads the warps'
  own), and a hash of the call's outputs, which every turn must print alike.

- K10 (`k10`) in its mean form (`td.apply_td_updates`, `_masked`) and its
  sums form (`td.segment_sums`) at the paths' shapes: walls16's 256 × 4
  table at B = 4,096 and 65,536, with uniform cells and with 90 % of the
  envs in one cell, without a mask and with half the envs masked; and on
  the samples of a round of `mc_control` (25,600 at S·A = 324, under its
  first-visit mask) and of `mc_prediction` at 1,024 episodes (102,400 at
  S·A = 81), recorded from the runs themselves. Each call in a CUDA graph
  of ten, as timed (30 calls) and on the host, with the tier the tree's
  `plan` picks where it has one, and a hash of the outputs, which every
  turn must print alike (`experiments/k10_phases.py` splits a call into
  its steps).

PART picks parts by name, all by default: `k1`, `k2` (K2 and K1), `k3`, `k4` (the K4 calls and
solves), `k4c`, `k5`, `k5s`, `k6`, `k7a`, `k7b`, `k7c`, `k9a`, `k9b`, `k10`, `k11`, `k12`, `k13`. With `--graph`, this tree's K5 scan is
also captured in a CUDA graph, replayed and held bit for bit against an
eager scan (or the capture's error is printed): whether a cooperative
launch can be captured on the card's CUDA.

With `--tiers` it times this tree's 16-sweep launch (VI and evaluation)
with and without the table of decoded actions (`packing`'s `table`, the
other way the word a cell; `grid_sweeps_cuda`'s `table`) over 16,384
17×17, 8,192 33×33, 2,048 65×65 and 1,024 81×81 mazes, both ways bit for
bit the same: the measurement behind `kernels.dp_grid.TABLE_BYTES`.
`tools/k4_ablation.py` times the pieces of K4's design one by one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

SWEEPS = 16


def _events_ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, calls: int = 100, rounds: int = 5) -> float:
    """The host's time of a call: the least over rounds of `calls` calls
    with no synchronize inside."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - start) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def _mazes(gt, dev, seed, cells, n):
    from griduniverse_tpu_torch.levels import maze as M

    grids, start = M.generate_mazes_device(seed, cells, n, "aldous_broder", device=dev)
    return gt.Level(grid=grids.contiguous(), start_idx=start.expand(n).contiguous())


def _profiled(name, fn, wall_ms, smi):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = per_kernel.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy = sum(v[0] for v in per_kernel.values())
    print(f"{name}: device busy {busy / 1e3!r} ms, idle {1 - busy / (wall_ms * 1e3)!r} of the median wall "
          f"{wall_ms!r} ms ({smi})")
    for k, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {us / 1e3!r} ms in {count} launches: {k[:110]}")


PARTS = ("k1", "k2", "k3", "k4", "k4c", "k5", "k5s", "k6", "k7a", "k7b", "k7c", "k9a", "k9b", "k10", "k11", "k12",
         "k13")


def measure(tag: str, parts=PARTS, graph: bool = False) -> None:
    """The readings of the module's docstring for the package on sys.path."""
    smi = _smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if "k1" in parts:
        k1_calls(tag, dev, smi)
    if "k10" in parts:
        k10_calls(tag, dev, smi)
    if "k2" in parts:
        k2_calls(tag, dev, smi)
    if "k4" in parts:
        k4_calls(tag, dev, gen, smi)
    if "k4c" in parts:
        k4_big_calls(tag, dev, gen, smi)
    if "k5s" in parts:
        k5_sharded_calls(tag, dev, smi)
    if "k12" in parts:
        k12_calls(tag, dev, smi)
    if "k7a" in parts:
        k7a_calls(tag, dev, smi)
    if "k9b" in parts:
        k9b_calls(tag, dev, gen, smi)
    if "k5" in parts:
        k5_scans(tag, dev, smi, graph)
    if "k6" in parts:
        k6_runs(tag, dev, smi)
    if "k7b" in parts:
        k7b_calls(tag, dev, smi)
    if "k7c" in parts:
        k7c_calls(tag, dev, smi)
    if "k9a" in parts:
        k9a_calls(tag, dev, smi)
    if "k13" in parts:
        k13_calls(tag, dev, smi)
    if "k3" in parts or "k11" in parts:
        maze_calls(tag, dev, smi, parts)


def _max_sm_hz() -> float:
    return 1e6 * float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                      check=True, capture_output=True, text=True).stdout.split()[0])


def maze_calls(tag, dev, smi, parts) -> None:
    """K11 at the maze path's four shapes and K3 at its two, as timed and
    (the small shapes) in a CUDA graph; the grids' hash, alike in every turn."""
    import hashlib

    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    hz = _max_sm_hz()
    calls = []
    if "k11" in parts:
        for cells, b, seed in (((4, 4), 65_536, 2026), ((16, 16), 8_192, 2027), ((32, 32), 65_536, 2029),
                               ((63, 63), 1_024, 2030)):
            s = cells[0] * cells[1]
            calls.append((f"K11 cells={cells} B={b}", 2 * s - 1, s <= 256,
                          lambda cells=cells, b=b, seed=seed: M._backtracker_mazes(cells, b, seed=seed, device=dev)))
    if "k3" in parts:
        calls.append(("K3 seeded cells=(4, 4) B=65536", None, True,
                      lambda: M._aldous_broder_mazes((4, 4), 65_536, seed=5, device=dev)))
        gen = torch.Generator(device=dev).manual_seed(32)
        dirs = torch.randint(0, 4, (5_000, 256), generator=gen, device=dev, dtype=torch.int8)
        _, steps = M.aldous_broder_mazes_reference((32, 32), 256, 5_000, directions=dirs, count_steps=True)
        calls.append(("K3 injected cells=(32, 32) B=256 max_iters=5000", int(steps.max()), False,
                      lambda: M._aldous_broder_mazes((32, 32), 256, 5_000, directions=dirs)))
    # end to end on the host clock, the median of three: phase 16's four
    # generate_mazes_device calls, and the PPO-over-mazes set-up (65,536 4x4
    # Aldous-Broder mazes, packed)
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.ops import bitplane as bp

    def phase16():
        for seed, cells, b in ((2026, (4, 4), 65_536), (2027, (16, 16), 8_192), (2029, (32, 32), 65_536),
                               (2030, (63, 63), 1_024)):
            M.generate_mazes_device(seed, cells, b, device=dev)

    def ppo_mazes_setup():
        grids, start = M.generate_mazes_device(2026, (4, 4), 65_536, "aldous_broder", device=dev)
        bp.pack_level(gt.Level(grid=grids, start_idx=start.expand(65_536).contiguous()))

    for name, fn, part in (("phase 16's maze path (four generate_mazes_device calls)", phase16, "k11"),
                           ("the PPO-over-mazes set-up (65,536 4x4 mazes, packed)", ppo_mazes_setup, "k3")):
        if part in parts:
            fn()
            walls = sorted(_wall_ms(fn) for _ in range(3))
            print(f"[{tag}] {name}: {walls[1]!r} ms on the host clock (of {walls!r}) ({smi})")
    for name, chain, graph, fn in calls:
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        ms = _events_ms(fn, 10)
        line = f"[{tag}] {name}: {ms!r} ms a call as timed"
        if graph:
            line += f", {_graph_ms(fn)!r} ms in a CUDA graph"
        if chain is not None:
            line += f", {ms * 1e-3 * hz / chain!r} cycles a link of its {chain}-long chain at {hz / 1e6!r} MHz"
        print(f"{line}; grids {digest} ({smi})")


def k4_calls(tag, dev, gen, smi) -> None:
    """K4's calls and the solves."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.kernels.dp_grid import grid_greedy_cuda, grid_sweeps_cuda

    sem = gt.make_semantics(device=dev)
    lv9 = _mazes(gt, dev, 2026, (4, 4), 65_536)
    lv33 = _mazes(gt, dev, 2027, (16, 16), 8_192)
    lv_pi = gt.Level(grid=lv9.grid[:4096].contiguous(), start_idx=lv9.start_idx[:4096].contiguous())
    for name, lv, evaluate in (("16 VI sweeps, 65,536 mazes 9x9", lv9, False),
                               ("16 VI sweeps, 8,192 mazes 33x33", lv33, False),
                               ("16 evaluation sweeps, 4,096 mazes 9x9", lv_pi, True),
                               ("16 evaluation sweeps, 65,536 mazes 9x9", lv9, True)):
        n, h, w = lv.grid.shape
        v0 = torch.zeros((n, h * w), device=dev)
        pol = torch.randint(0, 4, (n, h * w), generator=gen, device=dev, dtype=torch.int32) if evaluate else None
        def call(lv=lv, v0=v0, pol=pol):
            return grid_sweeps_cuda(sem, lv.grid, v0, pol, 0.99, SWEEPS)

        print(f"[{tag}] K4 {name}: {_events_ms(call)!r} ms a call, {_host_us(call)!r} us of host time ({smi})")
    v0 = torch.zeros((65_536, 81), device=dev)
    pol = torch.randint(0, 4, (65_536, 81), generator=gen, device=dev, dtype=torch.int32)
    def greedy():
        return grid_greedy_cuda(sem, lv9.grid, v0, 0.99, pol)

    print(f"[{tag}] K4 greedy step, 65,536 mazes 9x9: {_events_ms(greedy)!r} ms a call, "
          f"{_host_us(greedy)!r} us of host time ({smi})")

    solves = {
        "VI 65,536 mazes 9x9": lambda: algos.value_iteration_batched_grid(sem, lv9),
        "VI 8,192 mazes 33x33": lambda: algos.value_iteration_batched_grid(sem, lv33, max_iters=400),
        "PI 4,096 mazes 9x9": lambda: algos.policy_iteration_batched_grid(sem, lv_pi),
    }
    for name, fn in solves.items():
        out = fn()
        walls = [_wall_ms(fn) for _ in range(3)]
        n = int(name.split()[1].replace(",", ""))
        rates = [n / ms * 1e3 for ms in walls]
        print(f"[{tag}] solve {name} ({out[2]} iterations): {walls!r} ms, {rates!r} mazes/s ({smi})")
        if name != "VI 8,192 mazes 33x33":
            _profiled(f"[{tag}] solve {name} profiled", fn, sorted(walls)[1], smi)


def k4_big_calls(tag, dev, gen, smi) -> None:
    """K4 above 16,384 states: 16-sweep calls and a VI solve at 64 x 161x129."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import algos, kernels
    from griduniverse_tpu_torch.kernels import dp_grid
    from griduniverse_tpu_torch.levels import maze as M

    sem = gt.make_semantics(device=dev)
    grids, start = M.generate_mazes_device(2029, (80, 64), 64, "sidewinder", device=dev)
    n, s = 64, 161 * 129
    tier = dp_grid.grid_tier(161, 129) if hasattr(dp_grid, "grid_tier") else "global"
    v0 = torch.zeros((n, s), device=dev)
    pol = torch.randint(0, 4, (n, s), generator=gen, device=dev, dtype=torch.int32)
    for name, p in (("16 VI sweeps", None), ("16 evaluation sweeps", pol)):
        def call(p=p):
            return dp_grid.grid_sweeps_cuda(sem, grids, v0, p, 0.99, SWEEPS)

        graph = _plan_graph_ms(lambda: None, lambda _: call())
        print(f"[{tag}] K4 {name}, 64 mazes 161x129 ({tier} tier): {_events_ms(call)!r} ms a call as timed, "
              f"{graph!r} ms in a CUDA graph of ten, {_host_us(call)!r} us of host time; hash {_hash(call())} ({smi})")
    lv = gt.Level(grid=grids, start_idx=start.expand(n).contiguous())
    before = kernels.LAUNCHES["dp_grid"]
    out = algos.value_iteration_batched_grid(sem, lv)
    launched = kernels.LAUNCHES["dp_grid"] - before
    walls = [_wall_ms(lambda: algos.value_iteration_batched_grid(sem, lv)) for _ in range(3)]
    print(f"[{tag}] solve VI 64 mazes 161x129 ({out[2]} sweeps, {launched} launches): {walls!r} ms, "
          f"{[n / ms * 1e3 for ms in walls]!r} mazes/s; hash {_hash(out[:2])} ({smi})")


def k5_sharded_calls(tag, dev, smi) -> None:
    """K5's sharded form: one step as timed, on the host and in a graph, and a scan."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.kernels import td_fast as k5
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    bl = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    b = 65_536
    ts = td_fast.fast_td_init(sem, bl, 7, b)
    n = ts.q.numel()
    kw = dict(alpha=0.1, gamma=0.99, epsilon=0.1, expected_sarsa=0, max_episode_steps=512)

    def rows():
        """A state, Q_0, Q_1 and three aggregate rows, the summed one random."""
        state = [x.clone() for x in (ts.env_state.agent_idx, ts.env_state.agent_code, ts.env_state.t, ts.rs,
                                     ts.run_ret, ts.n_eps_env, ts.ret_sum_env)]
        g = torch.Generator(device=dev).manual_seed(1)
        agg = torch.zeros((3, 2, n), dtype=torch.int64, device=dev)
        agg[0, 0] = torch.randint(-2**36, 2**36, (n,), generator=g, device=dev)
        agg[0, 1] = torch.randint(0, 64, (n,), generator=g, device=dev)
        return state, ts.q.clone(), torch.empty_like(ts.q), agg

    if hasattr(k5, "TdStepPlan"):
        def make():
            state, q_prev, q_cur, agg = rows()
            return k5.TdStepPlan(sem, bl, q_prev, state, q_rows=(q_prev, q_cur), aggregates=tuple(agg.unbind(0)),
                                 q_final=q_cur, **kw)

        def call(plan):
            plan.step(1)
        form = f"through a TdStepPlan (clusters of {make().cluster})"
    else:
        def make():
            return rows()

        def call(r):
            state, q_prev, q_cur, agg = r
            k5.td_step_sharded_cuda(sem, bl, q_prev, q_cur, agg[0], agg[1], agg[2], state, **kw)
        form = "through td_step_sharded_cuda"
    made = make()
    timed = _events_ms(lambda: call(made), reps=200)
    host = _host_us(lambda: call(made))
    graph = _plan_graph_ms(make, call)
    print(f"[{tag}] K5 sharded step walls16 B={b} {form}: {timed * 1e3!r} us as timed, {host!r} us of host time, "
          f"{graph * 1e3!r} us in a CUDA graph of ten ({smi})")

    def scan():
        return td_fast.td_scan_fast_sharded(sem, bl, ts, 2_000, 0.1, 0.99, 0.1, "q_learning", 512, lambda x: x)

    out = scan()
    print(f"[{tag}] K5 sharded scan walls16 B={b} T=2000: {_events_ms(scan, reps=3)!r} ms a scan as timed; hash "
          f"{_hash((out.q, out.rs, out.ret_sum_env))} ({smi})")
    walls = sorted(_wall_ms(scan) for _ in range(3))
    _profiled(f"[{tag}] K5 sharded scan walls16 profiled", scan, walls[1], smi)


def k5_scans(tag, dev, smi, graph: bool) -> None:
    """K5's scans, the idle share of a `compile_q_learning_fast` run, and
    with `graph` the scan captured in a CUDA graph."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.algos import td_fast
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M
    from griduniverse_tpu_torch.ops import bitplane as bp

    sem = gt.make_semantics(device=dev)
    kw = dict(alpha=0.1, gamma=0.99, epsilon=0.1, algo="q_learning", max_episode_steps=512)
    walls = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    g65, start65 = M.generate_mazes_device(2028, (32, 32), 1, device=dev)
    maze65 = bp.pack_level(gt.Level(grid=g65[0].contiguous(), start_idx=start65))
    b = 65_536
    for name, bl, steps in (("walls16", walls, 2_000), ("one 65x65 maze", maze65, 300)):
        ts = td_fast.fast_td_init(sem, bl, 7, b)

        def scan(bl=bl, ts=ts, steps=steps):
            return td_fast.td_scan_fast(sem, bl, ts, steps, **kw)

        print(f"[{tag}] K5 {steps}-step scan, {name}, B={b}: {_events_ms(scan, reps=3)!r} ms a scan ({smi})")
    run = algos.compile_q_learning_fast(sem, walls, b, 2_000, alpha=0.1, gamma=0.99, epsilon=0.1,
                                        max_episode_steps=512)
    walls_ms = sorted(_wall_ms(lambda: run(7)) for _ in range(3))
    print(f"[{tag}] compile_q_learning_fast walls16 B={b} T=2000: {walls_ms!r} ms on the host clock ({smi})")
    _profiled(f"[{tag}] compile_q_learning_fast walls16 profiled", lambda: run(7), walls_ms[1], smi)
    if graph:
        ts = td_fast.fast_td_init(sem, walls, 7, b)
        want = td_fast.td_scan_fast(sem, walls, ts, 200, **kw)
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                got = td_fast.td_scan_fast(sem, walls, ts, 200, **kw)
            g.replay()
            torch.cuda.synchronize()
            same = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                   y.view(torch.int32) if y.dtype == torch.float32 else y)
                       for x, y in ((got.q, want.q), (got.rs, want.rs), (got.ret_sum_env, want.ret_sum_env)))
            print(f"[{tag}] K5 in a CUDA graph (torch {torch.__version__}, CUDA {torch.version.cuda}): captured "
                  f"and replayed; bit-exact against the eager scan: {same} ({smi})")
        except Exception as exc:  # the answer is the error itself
            print(f"[{tag}] K5 in a CUDA graph (torch {torch.__version__}, CUDA {torch.version.cuda}): the capture "
                  f"failed: {type(exc).__name__}: {exc} ({smi})")


def k6_runs(tag, dev, smi) -> None:
    """K6's runs over per-env mazes, both dtypes, and the device-memory tier."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import algos

    sem = gt.make_semantics(device=dev)
    for cells, n, steps, dtypes in (((4, 4), 65_536, 2_000, ("float32", "bfloat16")),
                                    ((16, 16), 8_192, 200, ("float32",))):
        lv = _mazes(gt, dev, 2026, cells, n)
        h, w = lv.grid.shape[1:]
        for dtype in dtypes:
            for t in (steps, 0):
                def run(lv=lv, t=t, dtype=dtype):
                    return algos.q_learning_batched(sem, lv, 9, t, dtype=dtype, max_episode_steps=512)

                ms = _events_ms(run, reps=2)
                rate = f", {n * t / ms * 1e3!r} transitions/s" if t else ""
                print(f"[{tag}] K6 {t}-step run, {n} mazes {h}x{w} {dtype}: {ms!r} ms a run{rate} ({smi})")
            if n == 65_536:
                walls_ms = sorted(_wall_ms(run) for _ in range(3))
                _profiled(f"[{tag}] K6 0-step run, {n} mazes {h}x{w} {dtype}, profiled", run, walls_ms[1], smi)


def _plan_graph_ms(make_plan, call, calls: int = 10, replays: int = 10) -> float:
    """A call's time in a CUDA graph of `calls`, the plan built on the
    capture's stream (a plan is stream-ordered)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plan = make_plan()
        for _ in range(3):
            call(plan)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            call(plan)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _hash(tensors) -> int:
    """A checksum of a call's outputs, to show that every turn computed the same."""
    return sum(int((t.view(torch.int32) if t.dtype == torch.float32 else t.int()).long().sum()) * (k + 1)
               for k, t in enumerate(tensors))


def k2_calls(tag, dev, smi) -> None:
    """K2 at its four shapes as timed and in a CUDA graph of ten; K1 as timed."""
    import numpy as np

    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    sem = gt.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    walls = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    golden = Path.cwd() / "tests" / "golden"
    cfg4 = np.load(golden / "torch" / "cfg4_mazes_grids.npz")
    shapes = (("walls16 B=4096 T=512", walls, 4096, None),
              ("4096 per-env 4x4 mazes T=512", bp.pack_level(_mazes(gt, dev, 11, (4, 4), 4096)), 4096, None),
              ("walls16 B=65536 T=512", walls, 65_536, None),
              ("golden cfg4_mazes B=4", bp.pack_level(gt.make_level(cfg4["grids"], cfg4["start_idx"], device=dev)), 4,
               torch.as_tensor(np.load(golden / "cfg4_mazes.npz")["actions"], device=dev)))
    for name, bl, b, actions in shapes:
        if actions is None:
            actions = torch.randint(0, 4, (512, b), generator=gen, device=dev, dtype=torch.int32)
        st = bp.reset_bits(bl, None if bl.batched else b)

        def call(bl=bl, st=st, actions=actions):
            return bp.rollout_actions_bits(sem, bl, st, actions, True, 64)

        state, outs = call()
        print(f"[{tag}] K2 {name}: {_events_ms(call)!r} ms a call as timed, {_graph_ms(call)!r} ms in a CUDA graph "
              f"of ten; outputs' hash {_hash((*outs, state.agent_idx, state.t))} ({smi})")
    st = bp.reset_bits(walls, 65_536)
    rs = bp.xorshift_init(3, (65_536,), device=dev)

    def scan():
        return bp.random_scan_bits(sem, walls, st, rs, None, 1000, 64)

    print(f"[{tag}] K1 walls16 B=65536 T=1000: {_events_ms(scan, 10)!r} ms a call as timed; outputs' hash "
          f"{_hash(scan()[1:])} ({smi})")


# K1's shapes: (name, level, B, T, stream)
K1_SHAPES = (
    ("walls16 B=65536 T=1000 xorshift", "walls16", 65_536, 1_000, "xorshift"),
    ("walls16 B=65536 T=1000 threefry", "walls16", 65_536, 1_000, "threefry"),
    ("lava B=16384 T=1000", "lava", 16_384, 1_000, "xorshift"),
    ("per-env 9x9 mazes B=65536 T=1000", (4, 4), 65_536, 1_000, "xorshift"),
    ("per-env 33x33 mazes B=16384 T=1000", (16, 16), 16_384, 1_000, "xorshift"),
    ("walls16 B=4096 T=1000", "walls16", 4_096, 1_000, "xorshift"),
    ("empty 8x8 B=1 T=100000", "empty8", 1, 100_000, "xorshift"),
)


def k1_levels(gt, dev) -> dict:
    """The packed levels of K1_SHAPES, by their names."""
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.ops import bitplane as bp

    levels = {"walls16": bp.pack_level(builders.walls_and_goal_16x16(device=dev)),
              "lava": bp.pack_level(builders.lava_level(device=dev)),
              "empty8": bp.pack_level(builders.empty_level(8, 8, goal=True, device=dev))}
    for _, level, b, _, _ in K1_SHAPES:
        if isinstance(level, tuple):
            levels[level] = bp.pack_level(_mazes(gt, dev, 7, level, b))
    return levels


def k1_calls(tag, dev, smi) -> None:
    """K1 at its shapes as timed and in a CUDA graph of ten, with the cycles
    a step of the call in the graph."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    sem = gt.make_semantics(device=dev)
    levels = k1_levels(gt, dev)
    hz = _max_sm_hz()
    for name, level, b, steps, rng in K1_SHAPES:
        bl = levels[level]
        st = bp.reset_bits(bl, None if bl.batched else b)
        rs = bp.xorshift_init(3, (b,), device=dev) if rng == "xorshift" else None
        keys = bp.threefry_keys(3) if rng == "threefry" else None

        def scan(bl=bl, st=st, rs=rs, keys=keys, steps=steps, rng=rng):
            return bp.random_scan_bits(sem, bl, st, rs, keys, steps, 512, rng)

        out = scan()
        timed = _events_ms(scan, 3 if steps > 1_000 else 10)
        graph = _graph_ms(scan, 10, 2 if steps > 1_000 else 10)
        print(f"[{tag}] K1 {name}: {timed!r} ms a call as timed, {graph!r} ms in a CUDA graph of ten, "
              f"{graph * 1e-3 * hz / steps!r} cycles a step at {hz / 1e6!r} MHz, {b * steps / (graph * 1e-3)!r} "
              f"steps/s; outputs' hash {_hash((*out[1:], out[0].agent_idx, out[0].t))} ({smi})")


def k7b_calls(tag, dev, smi) -> None:
    """K7b's call as timed, on the host and in a graph, and PPO's updates."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import kernels, models
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.models import a2c
    from griduniverse_tpu_torch.ops import bitplane as bp
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
    from griduniverse_tpu_torch.tools.profile_learners import _profile

    sem = gt.make_semantics(device=dev)
    level = builders.walls_and_goal_16x16(device=dev)
    bl = bp.pack_level(level)
    b = 65_536
    gen = torch.Generator(device=dev).manual_seed(1)
    st = bp.reset_bits(bl, b)
    logits = 2 * torch.randn((b, 4), generator=gen, device=dev)
    noise = a2c.draw_gumbel(gen, (1, b, 4), dev)
    Plan = getattr(getattr(kernels, "act_step", None), "ActStepPlan", None)
    if Plan is None:  # a tree of one wrapper call a step
        def call():
            return a2c.act_step(sem, bl, st, logits, noise[0], 64)

        graph_ms = _graph_ms(call)
        how = "a2c.act_step a call"
    else:
        def make_plan():
            plan = Plan(sem, bl, b, 1, 64)
            plan.begin(st, noise)
            return plan

        plan = make_plan()

        def call():
            return plan.step(0, logits)

        graph_ms = _plan_graph_ms(make_plan, lambda p: p.step(0, logits))
        how = "a plan a run"
    print(f"[{tag}] K7b walls16 B={b} A=4 ({how}): {_events_ms(call, reps=200)!r} ms a call as timed, "
          f"{_host_us(call)!r} us of host time, {graph_ms!r} ms a call in a CUDA graph ({smi})")

    cfg = models.PPOConfig(max_episode_steps=512)
    ts = models.ppo_init(sem, level, 5, cfg, b)
    models.ppo_run(sem, level, ts, cfg, 1)  # library handles, allocator

    def updates():
        return models.ppo_run(sem, level, ts, cfg, 3)

    walls_ms = sorted(_wall_ms(updates) for _ in range(3))
    prof = _profile(f"[{tag}] ppo walls16 B={b} 3 updates", updates, walls_ms[1], smi, top=4)
    if prof is not None:
        print(f"[{tag}] PPO walls16 update: {walls_ms[1] / 3!r} ms an update on the host clock ({walls_ms!r} ms a "
              f"call of 3), {prof[1] / 3!r} device events an update, idle share {100 * prof[2]:.2f} % ({smi})")


def k7c_calls(tag, dev, smi) -> None:
    """K7c, and a DQN step's act-and-store, as timed, on the host and in a
    CUDA graph of ten; a DQN step's device events and idle share. Where the
    tree has K7c's store form, the act-and-store is that one launch; else
    K7c followed by `buffer_write` (K8b's write), as that tree's trainer
    runs it."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch import models
    from griduniverse_tpu_torch.kernels.dqn_act import DqnActPlan
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.models import a2c, dqn, networks
    from griduniverse_tpu_torch.tools.profile_learners import _profile

    sem = gt.make_semantics(device=dev)
    level = builders.walls_and_goal_16x16(device=dev)
    b = 65_536
    store = hasattr(DqnActPlan, "bind_ring")
    for per in (False, True):
        cfg = models.DQNConfig(buffer_capacity=2 * b, max_episode_steps=512, prioritized=per)
        ts = models.dqn_run(sem, level, models.dqn_init(sem, level, 5, cfg, b), cfg, 4)
        learner = dqn.dqn_learner(sem, level, cfg, b)
        plan = learner.act_plan
        with torch.no_grad(), networks.exact_kernels():
            q, _ = a2c._net_apply(learner.net, ts.params, ts.env_state.agent_idx, learner.tiles)
        gen = torch.Generator(device=dev).manual_seed(1)
        explore = torch.rand(b, generator=gen, device=dev) < 0.05
        rand_a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
        args = (sem, learner.bl, ts.env_state, q, explore, rand_a, ts.run_ret, ts.episodes, ts.ret_sum, 512)
        at = torch.tensor(b, dtype=torch.int64, device=dev)  # the ring's second half, as step 5 writes it
        p_max = ts.p_max
        kind = f"walls16 B={b} A=4, ring {2 * b} {'PER' if per else 'uniform'}"

        def ring_of(plan):
            buf = dqn.ReplayBuffer(*(x.clone() for x in ts.buf))
            prio = ts.prio.clone() if per else None
            if store:
                plan.bind_ring(buf, prio)
            return buf, prio

        def act(plan):
            return dqn.dqn_act_step(*args, plan=plan)

        def act_and_store(plan, ring):
            buf, prio = ring
            if store:
                return dqn.dqn_act_step(*args, plan=plan, ring=(buf, prio, at, p_max))
            out = dqn.dqn_act_step(*args, plan=plan)
            dqn.buffer_write(buf, at, dqn.ReplayBuffer(ts.env_state.agent_idx, out[1], out[3], out[2], out[4]),
                             prio, p_max)
            return out

        ring = ring_of(plan)
        out = act_and_store(plan, ring)
        torch.cuda.synchronize()
        digest = _hash([*ring[0], *([ring[1]] if per else []), *out[1:5]])

        def new_plan():  # on the capture's stream: a plan is stream-ordered
            return DqnActPlan(sem, learner.bl, b, 512)

        def make_plan():
            fresh = new_plan()
            return fresh, ring_of(fresh)

        graph_pair = _plan_graph_ms(make_plan, lambda pr: act_and_store(*pr))
        graph_act = _plan_graph_ms(new_plan, act)
        what = "K7c's store form" if store else "K7c + buffer_write"
        print(f"[{tag}] act-and-store ({what}) {kind}: {_events_ms(lambda: act_and_store(plan, ring), reps=200)!r} "
              f"ms a call as timed, {_host_us(lambda: act_and_store(plan, ring))!r} us of host time, "
              f"{graph_pair!r} ms a call in a CUDA graph of ten; hash of the ring and the transition {digest} ({smi})")
        print(f"[{tag}] K7c alone {kind}: {_events_ms(lambda: act(plan), reps=200)!r} ms a call as timed, "
              f"{_host_us(lambda: act(plan))!r} us of host time, {graph_act!r} ms a call in a CUDA graph of ten "
              f"({smi})")

        def steps():
            return models.dqn_run(sem, level, ts, cfg, 20)

        walls_ms = sorted(_wall_ms(steps) for _ in range(3))
        prof = _profile(f"[{tag}] dqn {kind} 20 steps", steps, walls_ms[1], smi, top=4)
        if prof is not None:
            print(f"[{tag}] DQN step {kind}: {walls_ms[1] / 20!r} ms a step on the host clock ({walls_ms!r} ms a "
                  f"call of 20), {prof[1] / 20!r} device events a step, idle share {100 * prof[2]:.2f} % ({smi})")


def k9a_calls(tag, dev, smi) -> None:
    """K9a's forward as timed, in a graph and on the host, beside the library's lookup."""
    import torch.nn.functional as F

    from griduniverse_tpu_torch.kernels import embed_rows as k9a
    from griduniverse_tpu_torch.models import networks
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    gen = torch.Generator(device=dev).manual_seed(9)
    s, e = 256, 16
    table = torch.randn((s, e), generator=gen, device=dev, requires_grad=True)
    for n, cdt in ((65_536, torch.bfloat16), (262_144, torch.bfloat16), (1_048_576, torch.bfloat16),
                   (262_144, torch.float32)):
        obs = torch.randint(0, s, (n,), generator=gen, device=dev, dtype=torch.int32)
        w = table.detach()

        def kernel(obs=obs, cdt=cdt):
            return k9a.embed_rows_cuda(w, obs, cdt)

        def layer(obs=obs, cdt=cdt):
            with torch.no_grad():
                return networks.embed_rows(table, obs, cdt)

        def library(obs=obs, cdt=cdt):
            return F.embedding(obs, w.to(cdt))

        if not torch.equal(kernel(), library()):
            raise SystemExit(f"profile_turns k9a: the kernel and F.embedding differ at N={n} {cdt}")
        # the bytes: indices in, rows out, the table once
        bound_ms = (n * 4 + s * e * 4 + n * e * cdt.itemsize) / 3.35e12 * 1e3
        print(f"[{tag}] K9a forward N={n} S={s} E={e} {str(cdt)[6:]}: {_events_ms(kernel)!r} ms a call as timed, "
              f"{_graph_ms(kernel)!r} ms in a CUDA graph, {_host_us(kernel)!r} us of host time (the layer under "
              f"no_grad {_host_us(layer)!r} us); F.embedding(obs, table.to(cdt)) {_events_ms(library)!r} ms as "
              f"timed, {_graph_ms(library)!r} ms in a graph; bound {bound_ms!r} ms by bytes ({smi})")


def k13_calls(tag, dev, smi) -> None:
    """K13 as timed, in a graph and on the host, with and without the mask."""
    from griduniverse_tpu_torch.kernels import mc_returns as k13
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    gen = torch.Generator(device=dev).manual_seed(13)
    t = 100
    for b, n_ids in ((256, 81), (1024, 324)):
        valid = torch.arange(t, device=dev)[:, None] < torch.randint(0, t + 1, (b,), generator=gen, device=dev)[None]
        rewards = torch.where(valid, torch.randn((t, b), generator=gen, device=dev), 0.0)
        ids = torch.randint(0, n_ids, (t, b), generator=gen, device=dev, dtype=torch.int32)
        for what, args in (("returns alone", ()), ("returns and mask", (ids, valid))):
            def call(args=args):
                return k13.mc_returns_cuda(rewards, 0.99, *args)

            print(f"[{tag}] K13 T={t} B={b} {what}: {_events_ms(call)!r} ms a call as timed, {_graph_ms(call)!r} ms "
                  f"in a CUDA graph, {_host_us(call)!r} us of host time ({smi})")


def _by_kernel(fn, calls: int = 10) -> dict:
    """Device time (ms) and launches a call, by kernel name, from `torch.profiler`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            slot = per.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    return {k: (us / calls / 1e3, n / calls) for k, (us, n) in per.items()}


def k12_calls(tag, dev, smi) -> None:
    """K12 at the control and the prediction trace: one step's hash, a step
    as timed, on the host and in a CUDA graph of ten, and the device time by
    kernel. Through a plan built once where the tree has one."""
    from griduniverse_tpu_torch.algos import td_lambda
    from griduniverse_tpu_torch.kernels import trace_pass as k12
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    gen = torch.Generator(device=dev).manual_seed(12)
    b = 65_536
    Plan = getattr(k12, "TracePassPlan", None)
    for s, a in ((256, 4), (256, None)):
        shape = (b, s) if a is None else (b, s, a)
        e0 = torch.rand(shape, generator=gen, device=dev) * (torch.rand(shape, generator=gen, device=dev) < 0.3)
        table = torch.randn(shape[1:], generator=gen, device=dev)
        step = (torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32),
                None if a is None else torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32),
                torch.randn((b,), generator=gen, device=dev), torch.rand((b,), generator=gen, device=dev) < 0.01,
                0.99, 0.9, 1e-4, 0.1, "accumulating")
        e = e0.clone()
        if Plan is None:  # a tree of two kernels a step and no plan
            def call(e=e, table=table, step=step):
                return td_lambda.trace_pass(table, e, *step)

            graph_ms = _graph_ms(call)
            how = "no plan"
        else:
            def call_with(plan, e=e, table=table, step=step):
                return td_lambda.trace_pass(table, e, *step, plan=plan)

            def make_plan(table=table, a=a):
                return Plan(table, b, a is not None)

            plan = make_plan()

            def call(call_with=call_with, plan=plan):
                return call_with(plan)

            graph_ms = _plan_graph_ms(make_plan, call_with)
            how = "a plan a run"
        first = e0.clone()
        out = (td_lambda.trace_pass(table, first, *step) if Plan is None
               else td_lambda.trace_pass(table, first, *step, plan=make_plan()))
        name = f"K12 trace ({b}, {table.numel()}) {'prediction' if a is None else 'control'} ({how})"
        print(f"[{tag}] {name}: {_events_ms(call)!r} ms a step as timed, {_host_us(call)!r} us of host time, "
              f"{graph_ms!r} ms a step in a CUDA graph of ten; one step's hash {_hash((out, first))} ({smi})")
        for kname, (ms, n) in sorted(_by_kernel(call).items(), key=lambda kv: -kv[1][0]):
            print(f"    {ms!r} ms in {n!r} launches a step: {kname[:110]}")


def k10_inputs(dev) -> list:
    """(name, form, args) of the K10 calls `k10_calls` times: walls16's table
    at 4,096 and 65,536 envs (uniform and hot, unmasked and masked), and the
    samples `mc_control` and `mc_prediction` hand K10 on lava, recorded from
    the runs."""
    import griduniverse_tpu_torch as gt
    from unittest import mock

    from griduniverse_tpu_torch import algos
    from griduniverse_tpu_torch.algos import mc
    from griduniverse_tpu_torch.levels import builders

    gen = torch.Generator(device=dev).manual_seed(10)
    calls = []
    for b in (4096, 65_536):
        for hot in (False, True):
            q = torch.randn((256, 4), generator=gen, device=dev)
            s = torch.randint(0, 256, (b,), generator=gen, device=dev, dtype=torch.int32)
            a = torch.randint(0, 4, (b,), generator=gen, device=dev, dtype=torch.int32)
            if hot:  # 90 % of the envs in one cell
                in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
                s[in_cell], a[in_cell] = 17, 2
            delta = torch.randn((b,), generator=gen, device=dev)
            mask = torch.rand((b,), generator=gen, device=dev) < 0.5
            for m in (None, mask):
                name = f"B={b} S*A=1024 {'90 % in one cell' if hot else 'uniform'} {'masked' if m is not None else 'unmasked'}"
                calls.append((name, (q, s, a, delta, 0.1, m)))
    recorded = []
    real = mc.apply_td_updates_masked

    def record(*args):
        recorded.append(args)
        return real(*args)

    sem, lava = gt.make_semantics(device=dev), builders.lava_level(device=dev)
    with mock.patch.object(mc, "apply_td_updates_masked", record):
        algos.mc_control(sem, lava, 6, num_rounds=1)
        algos.mc_prediction(sem, lava, 4, batch_size=1024)
    for what, args in zip(("a round of mc_control", "mc_prediction at 1,024 episodes"), recorded):
        calls.append((f"{what}: {args[1].shape[0]} samples, S*A={args[0].numel()}", tuple(args)))
    return calls


def k10_calls(tag, dev, smi) -> None:
    """K10's mean and sums forms in a graph, as timed and on the host."""
    from griduniverse_tpu_torch.algos import td
    from griduniverse_tpu_torch.kernels import segment_mean as k10
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    for name, (q, s, a, delta, alpha, mask) in k10_inputs(dev):
        n_states, n_actions = q.shape
        forms = {
            "mean": lambda: (td.apply_td_updates(q, s, a, delta, alpha) if mask is None
                             else td.apply_td_updates_masked(q, s, a, delta, alpha, mask),),
            "sums": lambda: td.segment_sums(s, a, delta, alpha, n_states, n_actions, mask),
        }
        tier = (k10.call_plan(s.shape[0], q.numel(), dev) if hasattr(k10, "call_plan") else "the four passes")
        for form, fn in forms.items():
            print(f"[{tag}] K10 {form} form, {name} ({tier}): {_graph_ms(fn)!r} ms in a CUDA graph of ten, "
                  f"{_events_ms(fn)!r} ms as timed, {_host_us(fn)!r} us of host time; outputs' hash "
                  f"{_hash(fn())} ({smi})", flush=True)


def k7a_calls(tag, dev, smi) -> None:
    """K7a's GAE and n-step-return scans as timed, in a graph and on the host."""
    from griduniverse_tpu_torch.kernels import gae as k7a
    from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms

    gen = torch.Generator(device=dev).manual_seed(7)
    for t, b in ((16, 65_536), (128, 65_536)):
        value = torch.randn((t, b), generator=gen, device=dev)
        reward = torch.randn((t, b), generator=gen, device=dev)
        done = torch.rand((t, b), generator=gen, device=dev) < 0.05
        boot = torch.randn((b,), generator=gen, device=dev)
        calls = {"GAE": lambda: k7a.gae_cuda(value, reward, done, boot, 0.99, 0.95),
                 "n-step returns": lambda: (k7a.nstep_returns_cuda(reward, done, boot, 0.99),)}
        for name, fn in calls.items():
            print(f"[{tag}] K7a {name} T={t} B={b}: {_events_ms(fn)!r} ms a call as timed, {_graph_ms(fn)!r} ms in "
                  f"a CUDA graph of ten, {_host_us(fn)!r} us of host time; outputs' hash {_hash(fn())} ({smi})")


def k9b_calls(tag, dev, gen, smi) -> None:
    """K9b at a PPO minibatch, as K4's calls are timed."""
    from griduniverse_tpu_torch.kernels import agent_stamp as k9b

    n, nl, ch = 262_144, 16_384, 32
    y = torch.randn((nl, 9, 9, ch), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((3, 3, ch), generator=gen, device=dev)
    bias = torch.randn((ch,), generator=gen, device=dev)
    obs = torch.randint(0, 81, (n,), generator=gen, device=dev, dtype=torch.int32)
    cot = torch.randn((n, 9, 9, ch), generator=gen, device=dev).to(torch.bfloat16)
    out = k9b.agent_stamp_cuda(y, k, bias, obs)
    calls = {
        f"K9b forward, N={n} Nl={nl} 9x9 C={ch} bfloat16": lambda: k9b.agent_stamp_cuda(y, k, bias, obs),
        f"K9b backward, N={n} Nl={nl} 9x9 C={ch} bfloat16": lambda: k9b.agent_stamp_backward_cuda(cot, out, obs, nl),
    }
    for name, fn in calls.items():
        print(f"[{tag}] {name}: {_events_ms(fn)!r} ms a call, {_host_us(fn)!r} us of host time ({smi})")


def tiers() -> None:
    """K4's table of decoded actions against the word a cell, both forced."""
    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.kernels import dp_grid

    smi = _smi()
    dev = torch.device("cuda", 0)
    sem = gt.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for cells, n in (((8, 8), 16_384), ((16, 16), 8_192), ((32, 32), 2_048), ((40, 40), 1_024)):
        lv = _mazes(gt, dev, 5, cells, n)
        s = lv.grid.shape[1] * lv.grid.shape[2]
        v0 = torch.zeros((n, s), device=dev)
        pol = torch.randint(0, 4, (n, s), generator=gen, device=dev, dtype=torch.int32)
        outs = []
        for table in (True, False):
            def sweeps(pol=None, table=table):
                return dp_grid.grid_sweeps_cuda(sem, lv.grid, v0, pol, 0.99, SWEEPS, table=table)

            outs.append(sweeps())
            vi, ev = _events_ms(sweeps), _events_ms(lambda: sweeps(pol))
            print(f"[tiers] K4 {n} mazes {lv.grid.shape[1]}x{lv.grid.shape[2]}, table={table} "
                  f"({dp_grid.table_bytes(s, 4)} bytes a table; chosen: {dp_grid.packing(s).table}): 16 VI sweeps "
                  f"{vi!r} ms, 16 evaluation sweeps {ev!r} ms ({smi})")
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*outs)):
            raise SystemExit("profile_turns --tiers: the two ways differ")


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("profile_turns: torch.cuda.is_available() is False; this runs only on a GPU")
    parts = [a for a in args if a in PARTS] or list(PARTS)
    if args[:1] == ["--measure"]:  # one turn, in a process of its own
        measure(args[1], parts, "--graph" in args)
        return
    against = Path(args[args.index("--against") + 1]).resolve() if "--against" in args else None
    print(_smi())
    here = Path(__file__).resolve().parents[2]
    turns = [here] if against is None else [against, here, here, against]
    for i, root in enumerate(turns):
        tag = "this tree" if root == here else str(root)
        # the graph's question, once, in this tree's first turn
        graph = ["--graph"] if "--graph" in args and root == here and here not in turns[:i] else []
        # this file, run as a script, imports the package of the tree it is pointed at
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", tag, *parts, *graph],
                       check=True, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)))
    if "--tiers" in args:
        tiers()


if __name__ == "__main__":
    main()
