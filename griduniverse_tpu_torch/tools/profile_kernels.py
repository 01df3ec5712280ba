"""Where the time of seven kernels' calls and of the compat envs' steps goes, on one CUDA card.

    python -m griduniverse_tpu_torch.tools.profile_kernels [k10] [k8a] [k9a] [k8b] [k8bw] [k9b] [tileconv] [probes] [compat]

From the root of a checkout, on a machine with a Hopper card and nvcc. The
arguments pick the parts (all nine by default). It prints the card's name
and power limit (`nvidia-smi`), then takes these calls:

- K10 (`apply_td_updates`): 4,096 and 65,536 envs over S·A = 1,024, 102,400
  samples of which about 5 % are under the mask over S·A = 81, and 65,536
  envs with 90 % in one cell;
- K8a (`prioritized_sample`'s draw) from a full ring of 131,072 at 256,
  4,096, 16,384 and 16,385 picks;
- K9a's backward (`embed_rows_backward_cuda`, S=256, E=16, a bfloat16
  gradient) at N = 65,536, 262,144 and 1,048,576 (a rollout step, a PPO
  minibatch, an A2C update), beside `F.embedding`'s backward
  (`aten.embedding_backward`) on the same inputs;
- K8b's gather (`replay_gather`) and refresh (`prio_refresh`) on a full
  ring of 131,072 at n = 256, 4,096, 8,192 and 8,193 rows (the refresh's
  one-block limits), half the rows repeating a slot, beside the library's
  `index_select` ×5 and `index_put_` + max;
- K8b's ring write (`buffer_write`, with the priorities) of B = 65,536
  transitions into a ring of 131,072 (`k8bw`), beside the library's
  `index_copy_` ×5 and `index_fill_` into the same slots;
- the gather probes P1 (`gather_1d`: a 65×65 level's 4,225 tile codes at
  65,536 indices) and P2 (`take_along_axis1`: (8, 256) at (8, 256)
  indices) (`probes`), beside their library calls `table[idx]` and
  `torch.take_along_dim`;
- K9b's forward (`agent_stamp_cuda`) and backward
  (`agent_stamp_backward_cuda`) on 9×9 levels, C = 32, bfloat16, at
  N = 262,144 over Nl = 16,384 levels (a PPO minibatch over per-env mazes),
  N = Nl = 65,536 (a rollout step), N = Nl = 256 (DQN's minibatch) and
  N = 65,536 over Nl = 1 (a shared level), beside the library's way to the
  same function: `F.one_hot` of the agent's cell through `F.conv2d`, the
  add of the tile response and the bias and `relu`, forward alone and
  forward with autograd's backward;
- the conv trunk's library conv of the one-hot tile planes
  (`models/networks.py` `_trunk`: `F.conv2d` of (Nl, 4, 9, 9) bfloat16
  planes by the (32, 4, 3, 3) tile kernel under `exact_kernels()`) at
  Nl = 16,384 (a PPO minibatch over per-env mazes) and 65,536 (a rollout
  step), forward alone and forward with autograd's backward to the kernel,
  with its bound: the larger of the bytes (planes in, output out; with the
  backward, the output's gradient in and the planes again) over 3.35 TB/s
  and the multiply-adds over the card's bfloat16 tensor rate, 989 TFLOP/s.

- the compat envs' steps (`compat`): `VectorGridEnv` (a K2 launch a step,
  auto-reset, max_episode_steps 512) over walls16 at B = 4,096 and 65,536
  and over 65,536 per-env 9×9 mazes, and `GridUniverseEnv` on example 01's
  6×6 level with `backend="torch"` (a K2 launch a step) and
  `backend="numpy"` (the host oracle). A step ends on the host, so these
  print only the host's time a step (as below) and, for the card's steps,
  50 steps under `torch.profiler`: the host's self time by operation and
  the device's time by kernel.

For each of the kernels' calls it prints four readings:

- the time of a call as `chip_smoke.py` times it: CUDA events around 30
  calls, the wrapper's checks and allocations included;
- the time of a call in a CUDA graph of ten calls, replayed ten times:
  the device's time without the host's enqueue;
- the host's time of a call: the host clock around 200 calls with no
  synchronize inside, the least of five rounds (what a call costs the
  host where the card keeps up);
- 20 calls under `torch.profiler`: the device time of each kernel by name.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from .profile_learners import _profile

CAP = 131_072


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


def _graph_ms(fn, calls: int = 10, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _host_us(fn, calls: int = 200, rounds: int = 5) -> float:
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


def _compat(dev, smi: str, steps: int = 50, top: int = 8) -> None:
    """The compat part: each env's host µs a step and, on the card, where
    `steps` steps spend the host's and the device's time."""
    import itertools

    import numpy as np

    import griduniverse_tpu_torch as gt
    from griduniverse_tpu_torch.compat import GridUniverseEnv, VectorGridEnv
    from griduniverse_tpu_torch.levels import builders
    from griduniverse_tpu_torch.levels import maze as M

    rng = np.random.default_rng(0)
    walls16 = builders.walls_and_goal_16x16(device=dev)
    grids, start = M.generate_mazes_device(3, (4, 4), 65_536, "aldous_broder", device=dev)
    mazes = gt.Level(grid=grids, start_idx=start.expand(65_536).contiguous())
    envs = {}
    for name, level, b in (("walls16", walls16, 4096), ("walls16", walls16, 65_536), ("mazes 9x9", mazes, 65_536)):
        venv = VectorGridEnv(level, num_envs=b, max_episode_steps=512, device=dev)
        actions = itertools.cycle(rng.integers(0, 4, (64, b)).astype(np.int32))
        envs[f"VectorGridEnv {name} B={b}"] = (b, lambda venv=venv, actions=actions: venv.step(next(actions)))
    for backend in ("torch", "numpy"):
        env = GridUniverseEnv(grid_shape=(6, 6), walls=[7, 8, 13], lava=[21], goal_states=[35], seed=0,
                              backend=backend, device=dev if backend == "torch" else None)
        actions = itertools.cycle(rng.integers(0, 4, 64).tolist())

        def step(env=env, actions=actions):
            if env.step(next(actions))[2]:
                env.reset()

        envs[f"GridUniverseEnv(backend={backend!r}) 6x6"] = (1, step)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, (b, step) in envs.items():
        us = _host_us(step)
        print(f"{name}: {us!r} host µs a step, {b / us * 1e6!r} env steps/s ({smi})")
        if "numpy" in name:
            continue
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                step()
        rows = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)
        print(f"  host self time by operation, {steps} steps")
        for e in rows[:top]:
            print(f"    {e.self_cpu_time_total / steps:9.1f} us a step  {e.count // steps:3d} x  {e.key[:80]}")
        kernels: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                slot = kernels.setdefault(e.name, [0.0, 0])
                slot[0] += e.time_range.elapsed_us()
                slot[1] += 1
        busy, events = sum(us for us, _ in kernels.values()), sum(c for _, c in kernels.values())
        print(f"  device busy {busy / steps!r} us a step, {events // steps} device events a step")
        for n, (kus, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"    {kus / steps:9.2f} us a step  {count // steps:3d} x  {n[:80]}")


def main(argv: list[str] | None = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: torch.cuda.is_available() is False; this runs only on a GPU")
    from griduniverse_tpu_torch.algos import td
    from griduniverse_tpu_torch.kernels import agent_stamp as k9b
    from griduniverse_tpu_torch.kernels import embed_rows as k9a
    from griduniverse_tpu_torch.models import a2c, dqn

    known = {"k10", "k8a", "k9a", "k8b", "k8bw", "k9b", "tileconv", "probes", "compat"}
    picked = set(sys.argv[1:] if argv is None else argv) or known
    unknown = picked - known
    if unknown:
        raise SystemExit(f"profile_kernels: unknown kernels {sorted(unknown)}; pick from {', '.join(sorted(known))}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def k10_call(b, n_states, num_actions, hot=False, mask_share=None):
        q = torch.randn((n_states, num_actions), generator=gen, device=dev)
        s = torch.randint(0, n_states, (b,), generator=gen, device=dev, dtype=torch.int32)
        a = torch.randint(0, num_actions, (b,), generator=gen, device=dev, dtype=torch.int32)
        if hot:
            in_cell = torch.rand((b,), generator=gen, device=dev) < 0.9
            s[in_cell], a[in_cell] = 3, 0
        delta = torch.randn((b,), generator=gen, device=dev)
        if mask_share is None:
            return lambda: td.apply_td_updates(q, s, a, delta, 0.1)
        mask = torch.rand((b,), generator=gen, device=dev) < mask_share
        return lambda: td.apply_td_updates_masked(q, s, a, delta, 0.1, mask)

    prio = torch.rand((CAP,), generator=gen, device=dev) * 4 + 1e-3
    noise = a2c.draw_gumbel(gen, (CAP,), dev)
    size, beta = torch.tensor(CAP, device=dev), torch.tensor(0.4, device=dev)

    def k8a_draw(n):
        return lambda: dqn.prioritized_sample(prio, noise, size, n, 0.6, beta)

    def k9a_backward(n, library=False):
        obs = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn((n, 16), generator=gen, device=dev).to(torch.bfloat16)
        if library:  # timed here, used nowhere in the port
            return lambda: torch.ops.aten.embedding_backward(g, obs, 256, -1, False, False)
        return lambda: k9a.embed_rows_backward_cuda(g, obs, 256)

    ring = dqn.ReplayBuffer(
        torch.randint(0, 256, (CAP,), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 4, (CAP,), generator=gen, device=dev, dtype=torch.int32),
        torch.randn((CAP,), generator=gen, device=dev),
        torch.randint(0, 256, (CAP,), generator=gen, device=dev, dtype=torch.int32),
        torch.rand((CAP,), generator=gen, device=dev) < 0.3)
    ring_prio, p_max = prio.clone(), torch.tensor(5.0, device=dev)

    def k8b_rows(n):
        idx = torch.randint(0, CAP, (n,), generator=gen, device=dev, dtype=torch.int32)
        idx[n // 2:] = idx[: n - n // 2].clone()  # equal slots: the highest row wins
        return idx, torch.rand((n,), generator=gen, device=dev) * 4

    def k8b_gather(idx, library=False):
        if library:  # timed here, used nowhere in the port
            rows = idx.long()
            return lambda: [torch.index_select(full, 0, rows) for full in ring]
        return lambda: dqn.replay_gather(ring, idx)

    def k8b_refresh(idx, abs_err, library=False):
        if library:  # timed here, used nowhere in the port
            rows = idx.long()

            def refresh():
                fresh = abs_err + 1e-3
                ring_prio.index_put_((rows,), fresh)
                return torch.maximum(p_max, fresh.max())

            return refresh
        return lambda: dqn.prio_refresh(ring_prio, idx, abs_err, 1e-3, p_max)

    def k9b_calls(n, nl, h=9, w=9, ch=32, cdt=torch.bfloat16):
        """K9b's forward and backward and the library's conv + add + ReLU
        (forward, and forward with autograd's backward) on one shape."""
        y = torch.randn((nl, h, w, ch), generator=gen, device=dev).to(cdt)
        k = torch.randn((3, 3, ch), generator=gen, device=dev)
        b = torch.randn((ch,), generator=gen, device=dev)
        obs = torch.randint(0, h * w, (n,), generator=gen, device=dev, dtype=torch.int32)
        cot = torch.randn((n, h, w, ch), generator=gen, device=dev).to(cdt)
        out = k9b.agent_stamp_cuda(y, k, b, obs)
        k_lib = k.permute(2, 0, 1)[:, None].contiguous().requires_grad_(True)  # (C, 1, 3, 3)
        b_lib = b.clone().requires_grad_(True)
        y_lib = y.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        cot_lib = cot.permute(0, 3, 1, 2)

        def library():  # timed here, used nowhere in the port
            plane = torch.nn.functional.one_hot(obs.long(), h * w).to(cdt).reshape(n, 1, h, w)
            y_agent = torch.nn.functional.conv2d(plane, k_lib.to(cdt), padding=1)
            y_sum = y_agent.reshape(n // nl, nl, ch, h, w) + y_lib
            return torch.relu(y_sum + b_lib.to(cdt)[:, None, None]).reshape(n, ch, h, w)

        def library_forward():
            with torch.no_grad():
                return library()

        tag = f"N={n} Nl={nl} {h}x{w} C={ch} {str(cdt).split('.')[-1]}"
        return {
            f"K9b forward {tag}": lambda: k9b.agent_stamp_cuda(y, k, b, obs),
            f"K9b backward {tag}": lambda: k9b.agent_stamp_backward_cuda(cot, out, obs, nl),
            f"library one_hot + conv2d + add + relu {tag}": library_forward,
            f"library forward + autograd backward {tag}":
                lambda: torch.autograd.grad(library(), (y_lib, k_lib, b_lib), cot_lib),
        }

    def tile_conv(nl, backward=False, ch=32, c=4):
        """The trunk's conv of the tile planes (NHWC in memory, as `_trunk`
        passes them) and its bound in ms."""
        from griduniverse_tpu_torch.models.networks import exact_kernels

        codes = torch.randint(0, c, (nl, 9, 9), generator=gen, device=dev)
        tiles = torch.nn.functional.one_hot(codes, c).to(torch.bfloat16)  # (Nl, 9, 9, 4)
        kernel = torch.randn((ch, c, 3, 3), generator=gen, device=dev, requires_grad=backward)
        cot = torch.randn((nl, ch, 9, 9), generator=gen, device=dev).to(torch.bfloat16)
        elems_in, elems_out = nl * 81 * c, nl * 81 * ch
        n_bytes = 2 * (elems_in + elems_out) + (2 * (elems_out + elems_in) if backward else 0)
        flops = 2 * elems_out * c * 9 * (2 if backward else 1)
        bound = max(n_bytes / 3.35e12, flops / 989e12) * 1e3

        def call():
            with exact_kernels():
                y = torch.nn.functional.conv2d(tiles.permute(0, 3, 1, 2), kernel.to(torch.bfloat16), padding=1)
                if backward:
                    return torch.autograd.grad(y, kernel, cot)
                return y

        return call, bound

    calls = {}
    bounds = {}
    if "tileconv" in picked:
        for nl in (16_384, 65_536):
            for backward in (False, True):
                name = f"library tile conv Nl={nl} 9x9 4 codes to 32 channels bfloat16{' + backward' if backward else ''}"
                calls[name], bounds[name] = tile_conv(nl, backward)
    if "k10" in picked:
        calls.update({
            "K10 B=4,096, S*A=1,024": k10_call(4096, 256, 4),
            "K10 B=65,536, S*A=1,024": k10_call(65_536, 256, 4),
            "K10 102,400 samples, 5.3 % under the mask, S*A=81": k10_call(102_400, 81, 1, mask_share=0.053),
            "K10 B=65,536, S*A=1,024, 90 % in one cell": k10_call(65_536, 256, 4, hot=True),
        })
    if "k8a" in picked:
        calls.update({f"K8a capacity {CAP}, n={n}": k8a_draw(n) for n in (256, 4096, 16_384, 16_385)})
    if "k9a" in picked:
        for n in (65_536, 262_144, 1_048_576):
            calls[f"K9a backward N={n}, S=256, E=16, bfloat16"] = k9a_backward(n)
            calls[f"F.embedding backward N={n}, S=256, E=16, bfloat16"] = k9a_backward(n, library=True)
    if "k8b" in picked:
        for n in (256, 4096, 8192, 8193):
            idx, abs_err = k8b_rows(n)
            calls[f"K8b gather capacity {CAP}, n={n}"] = k8b_gather(idx)
            calls[f"index_select x5 capacity {CAP}, n={n}"] = k8b_gather(idx, library=True)
            calls[f"K8b refresh capacity {CAP}, n={n}"] = k8b_refresh(idx, abs_err)
            calls[f"index_put_ + max capacity {CAP}, n={n}"] = k8b_refresh(idx, abs_err, library=True)
    if "k8bw" in picked:
        b = 65_536
        batch = dqn.ReplayBuffer(*(x[:b].clone() for x in ring))
        at, w_max = torch.tensor(b, device=dev), torch.tensor(5.0, device=dev)
        slots = torch.arange(b, 2 * b, device=dev)

        def library_write():  # timed here, used nowhere in the port
            for full, part in zip(ring, batch):
                full.index_copy_(0, slots, part)
            ring_prio.index_fill_(0, slots, 5.0)

        calls[f"K8b write B={b}, capacity {CAP}"] = lambda: dqn.buffer_write(ring, at, batch, ring_prio, w_max)
        calls[f"index_copy_ x5 + index_fill_ B={b}, capacity {CAP}"] = library_write
    if "probes" in picked:
        from . import gather_probe

        states, envs = gather_probe.STEP_LOOKUP
        codes = torch.randint(0, 4, (states,), generator=gen, device=dev, dtype=torch.int32)
        pos = torch.randint(0, states, (envs,), generator=gen, device=dev, dtype=torch.int32)
        table = torch.randint(0, 1000, (8, 256), generator=gen, device=dev, dtype=torch.int32)
        idx = torch.randint(0, 256, (8, 256), generator=gen, device=dev, dtype=torch.int32)
        rows = idx.long()
        calls[f"P1 gather_1d table ({states},), {envs} indices"] = lambda: gather_probe.gather_1d(codes, pos)
        calls[f"table[idx] table ({states},), {envs} indices"] = lambda: codes[pos]  # P1's library call
        calls["P2 take_along_axis1 (8, 256)"] = lambda: gather_probe.take_along_axis1(table, idx)
        calls["torch.take_along_dim (8, 256)"] = lambda: torch.take_along_dim(table, rows, dim=1)  # P2's
    if "k9b" in picked:
        for n, nl in ((262_144, 16_384), (65_536, 65_536), (256, 256), (65_536, 1)):
            calls.update(k9b_calls(n, nl))
    if "compat" in picked:
        _compat(dev, smi)
    for name, fn in calls.items():
        ms = _events_ms(fn)
        bound = f", bound {bounds[name]!r} ms" if name in bounds else ""
        print(f"{name}: {ms!r} ms a call as timed, {_graph_ms(fn)!r} ms a call in a CUDA graph, "
              f"{_host_us(fn)!r} us of host time a call{bound} ({smi})")

        def twenty(fn=fn):
            for _ in range(20):
                fn()

        _profile(f"{name}, 20 calls", twenty, 20 * ms, smi, top=12)


if __name__ == "__main__":
    main()
