"""Where the time of a K10 call and of a K8a draw goes, on one CUDA card.

    python -m griduniverse_tpu_torch.tools.profile_kernels

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints the card's name and power limit (`nvidia-smi`), then for K10
(`apply_td_updates`: 4,096 and 65,536 envs over S·A = 1,024, 102,400
samples of which about 5 % are under the mask over S·A = 81, and 65,536
envs with 90 % in one cell) and K8a (`prioritized_sample`'s draw from a
full ring of 131,072 at 256, 4,096, 16,384 and 16,385 picks), one line
each:

- the time of a call as `chip_smoke.py` times it: CUDA events around 30
  calls, the wrapper's checks and allocations included;
- the time of a call in a CUDA graph of ten calls, replayed ten times:
  the device's time without the host's enqueue;
- 20 calls under `torch.profiler`: the device time of each kernel by name.
"""

from __future__ import annotations

import subprocess

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: torch.cuda.is_available() is False; this runs only on a GPU")
    from griduniverse_tpu_torch.algos import td
    from griduniverse_tpu_torch.models import a2c, dqn

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

    calls = {
        "K10 B=4,096, S*A=1,024": k10_call(4096, 256, 4),
        "K10 B=65,536, S*A=1,024": k10_call(65_536, 256, 4),
        "K10 102,400 samples, 5.3 % under the mask, S*A=81": k10_call(102_400, 81, 1, mask_share=0.053),
        "K10 B=65,536, S*A=1,024, 90 % in one cell": k10_call(65_536, 256, 4, hot=True),
        **{f"K8a capacity {CAP}, n={n}": k8a_draw(n) for n in (256, 4096, 16_384, 16_385)},
    }
    for name, fn in calls.items():
        ms = _events_ms(fn)
        print(f"{name}: {ms!r} ms a call as timed, {_graph_ms(fn)!r} ms a call in a CUDA graph ({smi})")

        def twenty(fn=fn):
            for _ in range(20):
                fn()

        _profile(f"{name}, 20 calls", twenty, 20 * ms, smi, top=12)


if __name__ == "__main__":
    main()
