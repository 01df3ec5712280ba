"""Why K13's call as timed in `chip_smoke.py`'s phase 21 reads several times
its host time at B = 1,024: the whole smoke, with the timing of K13's two
calls taken apart. A one-off experiment, kept to reproduce its readings; it
is not part of the package.

    python -m experiments.k13_as_timed

From the root of a checkout, on a machine with a CUDA card and nvcc. It runs
`chip_smoke.main()` as it is, with `chip_smoke._cuda_ms` wrapped: where the
smoke times `mc.mc_returns` (50 calls after a warm-up, CUDA events around
them), the wrapper times each call on the host clock and, inside it, `plan`,
the two `torch.empty` of the outputs and `launch`; records the collector's
passes (`gc.callbacks`) and the caching allocator's counts of device
allocations and frees (`torch.cuda.memory_stats`) over the 50 calls; and
prints them beside the smoke's own reading, then the same timing run three
times more. The smoke's reading is what the smoke prints; the wrapper adds
about a µs a call.
"""

from __future__ import annotations

import gc
import time

import torch

import chip_smoke
from griduniverse_tpu_torch.kernels import mc_returns as k13

_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries", "segment.all.current")


def _stats() -> dict:
    m = torch.cuda.memory_stats()
    return {k: m.get(k, 0) for k in _STATS}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k13_as_timed: torch.cuda.is_available() is False; this runs only on a GPU")
    real_cuda_ms, real_empty, real_launch, real_plan = chip_smoke._cuda_ms, torch.empty, k13.launch, k13.plan
    parts: list[list] = []
    passes: list[list] = []
    window = [False]

    def on_gc(phase, info):
        if window[0]:
            if phase == "start":
                passes.append([info["generation"], time.perf_counter()])
            else:
                passes[-1][1] = round((time.perf_counter() - passes[-1][1]) * 1e3, 3)

    def timer(name, f):
        def timed(*a, **k):
            t = time.perf_counter()
            out = f(*a, **k)
            parts[-1].append((name, round((time.perf_counter() - t) * 1e6, 1)))
            return out
        return timed

    def cuda_ms(fn, reps, warm=True):
        if not (reps == 50 and "mc_returns" in fn.__code__.co_names):
            return real_cuda_ms(fn, reps, warm)
        shape = tuple(fn.__closure__[0].cell_contents[0].shape)
        per = []

        def call():
            parts.append([])
            t = time.perf_counter()
            out = fn()
            per.append((time.perf_counter() - t) * 1e6)
            return out

        parts.clear()
        passes.clear()
        before = _stats()
        torch.empty, k13.launch, k13.plan = timer("empty", real_empty), timer("launch", real_launch), timer("plan", real_plan)
        window[0] = True
        try:
            out = real_cuda_ms(call, reps, warm)
        finally:
            window[0] = False
            torch.empty, k13.launch, k13.plan = real_empty, real_launch, real_plan
        after = _stats()
        slowest = sorted(range(len(per)), key=lambda i: -per[i])[:3]
        print(f"[k13_as_timed] the smoke's reading at {shape}: {out[0]!r} ms a call; the calls on the host (call 0 "
              f"the warm-up): median {sorted(per)[len(per) // 2]:.1f} us, sum {sum(per) / 1e3:.3f} ms; the slowest "
              f"(call, us, parts): {[(i, round(per[i], 1), parts[i]) for i in slowest]}; collector passes "
              f"(generation, ms): {passes}; allocator {before} -> {after}", flush=True)
        print(f"[k13_as_timed] the same timing again at {shape}: {[real_cuda_ms(fn, 50)[0] for _ in range(3)]} ms",
              flush=True)
        return out

    gc.callbacks.append(on_gc)
    chip_smoke._cuda_ms = cuda_ms
    chip_smoke.main()


if __name__ == "__main__":
    main()
