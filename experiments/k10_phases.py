"""Where a K10 call's time goes on one CUDA card: each step's start and end
by the device's global timer. A one-off experiment of the redesign, kept to
reproduce its readings; it is not part of the package.

    python -m experiments.k10_phases [VARIANT ...]

From the root of a checkout, on a machine with a Hopper card and nvcc. It
builds `griduniverse_tpu_torch/csrc/segment_mean.cu` with the package's
flags into a shared library of its own, with lines added at exact places:
each kernel of the four passes (count, scan, scatter, sum) stamps
`%globaltimer` when each block starts and when it ends, and the cluster
kernel when each block enters and leaves each of its four steps (count and
rank, scan, scatter, sum; the stamps a block barrier after the step's
last thread), into device words that keep the earliest start and the latest
end of each step (`atomicMin`, `atomicMax`), and the most SM clock cycles
(`clock64`) a block spent in each step and, in the cluster kernel, in each
of ten parts of the steps (`PARTS`). The package's wrappers launch it
(`kernels.segment_mean.launch` pointed at this library), so the plan and the
checks are the package's. Each call is captured alone in a CUDA graph and
replayed 200 times, the stamps read after each replay; the timer ticks in
steps of its own, so the means over the replays are what is printed: each
step's span, the gap from one step's end to the next one's start, the
call's span from the first start to the last end, and each step's cycles
in its slowest block. It prints the card's
name and power limit (`nvidia-smi`), then for every shape of
`tools/profile_turns.py` `k10_inputs` both tiers of both forms, each held
bit for bit against the package's own call. Each VARIANT named
(`VARIANTS`) builds one more library with that part made another way, and
times its cluster tier beside the source's.
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.kernels import segment_mean as sm
from griduniverse_tpu_torch.tools.profile_turns import _smi, k10_inputs

PRELUDE = """
__device__ unsigned long long gu_k10_stamps[34];  // 8 steps: earliest start, latest end, most cycles; 10 parts
__shared__ long long gu_clk[8];
__shared__ long long gu_prev;
__device__ __forceinline__ unsigned long long gu_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void gu_first(int i) {
  gu_clk[i] = clock64();
  atomicMin(&gu_k10_stamps[2 * i], gu_now());
}
__device__ __forceinline__ void gu_last(int i) {
  atomicMax(&gu_k10_stamps[2 * i + 1], gu_now());
  atomicMax(&gu_k10_stamps[16 + i], static_cast<unsigned long long>(clock64() - gu_clk[i]));
}
// the cluster kernel's parts: the cycles from mark i - 1 to mark i, the most of any block
__device__ __forceinline__ void gu_mark(int i) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  if (i > 0) atomicMax(&gu_k10_stamps[24 + i - 1], static_cast<unsigned long long>(now - gu_prev));
  gu_prev = now;
}
extern "C" int gu_k10_stamps_out(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, gu_k10_stamps, sizeof(gu_k10_stamps));
  unsigned long long fresh[34];
  for (int i = 0; i < 34; ++i) fresh[i] = i < 16 && (i & 1) == 0 ? ~0ull : 0ull;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gu_k10_stamps, fresh, sizeof(fresh));
  return static_cast<int>(err);
}
"""
STAMP_END = "  __syncthreads();\n  if (threadIdx.x == 0) gu_last({});\n"
SYNC = "  cluster_barrier(cluster, blocks);  // "
# exact lines of the kernels and what each becomes; steps 0-3 the passes', 4-7 the cluster kernel's
EDITS = (
    ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + PRELUDE),
    ("  const int c = blockIdx.x;\n  int* const h = kShared ?",
     "  const int c = blockIdx.x;\n  if (threadIdx.x == 0) gu_first(0);\n  int* const h = kShared ?"),
    ("      counts[static_cast<size_t>(k) * n_chunks + c] = h[k];\n  }\n}\n",
     "      counts[static_cast<size_t>(k) * n_chunks + c] = h[k];\n  }\n" + STAMP_END.format(0) + "}\n"),
    ("  if (threadIdx.x == 0) sh_tile = atomicAdd(ticket, 1);\n",
     "  if (threadIdx.x == 0) gu_first(1);\n  if (threadIdx.x == 0) sh_tile = atomicAdd(ticket, 1);\n"),
    ("    run += v[i];\n  }\n}\n", "    run += v[i];\n  }\n" + STAMP_END.format(1) + "}\n"),
    ("  const int c = blockIdx.x;\n  // the chunk's next free place",
     "  const int c = blockIdx.x;\n  if (threadIdx.x == 0) gu_first(2);\n  // the chunk's next free place"),
    ("    if (k >= 0) vals[first + __popc(peers & below)] = v;\n  }\n}\n",
     "    if (k >= 0) vals[first + __popc(peers & below)] = v;\n  }\n" + STAMP_END.format(2) + "}\n"),
    ("  if (k >= n_seg) return;\n", "  if (threadIdx.x == 0) gu_first(3);\n  if (k >= n_seg) return;\n"),
    ("      q_out[k] = q_in[k] + sum / static_cast<float>(count > 1 ? count : 1);\n    }\n  }\n}\n",
     "      q_out[k] = q_in[k] + sum / static_cast<float>(count > 1 ? count : 1);\n    }\n    gu_last(3);\n  }\n}\n"),
    ("  const cg::cluster_group cluster = cg::this_cluster();\n  __shared__ int warp_sum",
     "  const cg::cluster_group cluster = cg::this_cluster();\n  if (threadIdx.x == 0) gu_first(4);\n  gu_mark(0);\n"
     "  __shared__ int warp_sum"),
    ("  __syncthreads();\n\n  // 1. Count and rank.", "  __syncthreads();\n  gu_mark(1);\n\n  // 1. Count and rank."),
    ("  __syncthreads();\n  // each segment's count over the warps",
     "  __syncthreads();\n  gu_mark(2);\n  // each segment's count over the warps"),
    ("    l.h[k] = static_cast<unsigned short>(run);\n  }\n  __syncthreads();\n",
     "    l.h[k] = static_cast<unsigned short>(run);\n  }\n  __syncthreads();\n  gu_mark(3);\n"),
    (SYNC + "every block's histogram is complete; the regions are free\n",
     STAMP_END.format(4) + "  gu_mark(4);\n" + SYNC + "every block's histogram is complete; the regions are free\n"
     "  if (threadIdx.x == 0) gu_first(5);\n  gu_mark(5);\n"),
    ("  int part = 0;\n", "  __syncthreads();\n  gu_mark(6);\n  int part = 0;\n"),
    ("  if (t == 0) l.start[n_seg] = all;\n  __syncthreads();\n",
     "  if (t == 0) l.start[n_seg] = all;\n  __syncthreads();\n  if (threadIdx.x == 0) gu_last(5);\n"
     "  gu_mark(7);\n  if (threadIdx.x == 0) gu_first(6);\n"),
    (SYNC + "every value is in its place; no block reads another's memory after this\n",
     STAMP_END.format(6) + "  gu_mark(8);\n" + SYNC
     + "every value is in its place; no block reads another's memory after this\n"
     "  if (threadIdx.x == 0) gu_first(7);\n  gu_mark(9);\n"),
    ("  while (w.k < w.last) emit<kSums>(w, l.start, q_own, seg0, out, counts_out);\n}\n",
     "  while (w.k < w.last) emit<kSums>(w, l.start, q_own, seg0, out, counts_out);\n"
     + STAMP_END.format(7) + "  gu_mark(10);\n}\n"),
)
STEPS = {"passes": ("count", "scan", "scatter", "sum"), "cluster": ("count and rank", "scan", "scatter", "sum")}
PARTS = ("clear and load", "rounds", "warps' scan", "ranks", "barrier 1", "counts read", "block scan", "scatter",
         "barrier 2", "sum")
# other designs of a part, each text edits on top of the stamps: `python -m experiments.k10_phases match_any`
VARIANTS = {
    # each round's groups of equal keys by `__match_any_sync` in place of the lane masks
    "match_any": (("      if (k >= 0) atomicOr(held + k, 1u << lane);\n      __syncwarp();\n"
                   "      const unsigned peers = k >= 0 ? held[k] : 0u;\n",
                   "      const unsigned peers = __match_any_sync(kFull, k);\n"),),
    # on more than one block, every value through the scratch in L2 in place of the owner's shared memory
    "scatter_l2": (("    l.off[k] = l.start[min((o + 1) * owned, n_seg)] - base <= l.cap ?",
                    "    l.off[k] = blocks == 1 && l.start[min((o + 1) * owned, n_seg)] - base <= l.cap ?"),
                   ("  if (run <= l.cap) {\n", "  if (blocks == 1 && run <= l.cap) {\n")),
}


def _build(out: Path, variant: str | None = None) -> ctypes.CDLL:
    text = (Path(build.CSRC_DIR) / "segment_mean.cu").read_text()
    for old, new in EDITS + (VARIANTS[variant] if variant else ()):
        if text.count(old) != 1:
            raise SystemExit(f"k10_phases: segment_mean.cu lacks the lines {old!r} (or has them twice)")
        text = text.replace(old, new)
    src = out / f"segment_mean_{variant or 'as_is'}.cu"
    src.write_text(text)
    lib = out / f"k10_stamped_{variant or 'as_is'}.so"
    build._run_all([[build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o", str(lib),
                     str(src)]])
    so = ctypes.CDLL(str(lib))
    for name in ("gu_segment_mean", "gu_segment_sums", "gu_segment_cluster"):
        getattr(so, name).argtypes = build._SIGNATURES[name]
        getattr(so, name).restype = ctypes.c_int
    so.gu_k10_stamps_out.argtypes = [ctypes.c_void_p]
    return so


def _bits(outs) -> list:
    return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in outs]


def main(argv: list[str] | None = None) -> None:
    variants = sys.argv[1:] if argv is None else argv
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"k10_phases: no variant {unknown}; there are {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("k10_phases: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    replays = 200
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs = {None: _build(Path(tmp)), **{v: _build(Path(tmp), v) for v in variants}}
        stamps = np.zeros(34, np.uint64)
        package_launch = sm.launch
        for shape, (q, s, a, delta, alpha, mask) in k10_inputs(dev):
            n_states, n_actions = q.shape
            for variant, so in libs.items():
                so.gu_k10_stamps_out(stamps.ctypes.data)  # the words' first state

                def stamped(name, device, *args, so=so):
                    code = getattr(so, name)(*args, torch._C._cuda_getCurrentRawStream(device.index or 0))
                    if code:
                        raise SystemExit(f"k10_phases: {name} failed with CUDA error {code}")

                for tier in ("passes", None) if variant is None else (None,):
                    for form in ("mean", "sums"):
                        def call(tier=tier, form=form):
                            if form == "mean":
                                return (sm.segment_mean_cuda(q, s, a, delta, alpha, mask, tier=tier),)
                            return sm.segment_sums_cuda(s, a, delta, alpha, n_states, n_actions, mask, tier=tier)

                        want = call()
                        sm.launch = stamped
                        try:
                            got = call()
                            side = torch.cuda.Stream()
                            side.wait_stream(torch.cuda.current_stream())
                            with torch.cuda.stream(side):
                                call()
                            torch.cuda.current_stream().wait_stream(side)
                            graph = torch.cuda.CUDAGraph()
                            with torch.cuda.graph(graph):
                                call()
                        finally:
                            sm.launch = package_launch
                        torch.cuda.synchronize()
                        so.gu_k10_stamps_out(stamps.ctypes.data)
                        rows = []
                        for _ in range(replays):
                            graph.replay()
                            torch.cuda.synchronize()
                            so.gu_k10_stamps_out(stamps.ctypes.data)
                            rows.append(stamps.astype(np.float64))
                        t = np.mean(rows, axis=0)
                        p = sm.call_plan(s.shape[0], q.numel(), dev) if tier is None else sm.PASSES
                        steps = range(4) if p.tier == "passes" else range(4, 8)
                        names = STEPS[p.tier]
                        first, last = t[2 * steps[0]], t[2 * steps[-1] + 1]
                        parts, cycles = [], []
                        for j, i in enumerate(steps):
                            parts.append(f"{names[j]} {(t[2 * i + 1] - t[2 * i]) / 1e3:.3f}")
                            cycles.append(f"{names[j]} {t[16 + i]:.0f}")
                            if j + 1 < len(steps):
                                parts.append(f"gap {(t[2 * i + 2] - t[2 * i + 1]) / 1e3:.3f}")
                        same = all(torch.equal(x, y) for x, y in zip(_bits(got), _bits(want)))
                        print(f"K10 {form} form, {shape}, {p}{'' if variant is None else ', variant ' + variant}: "
                              f"{(last - first) / 1e3:.3f} us from the first start to the last end; {', '.join(parts)} "
                              f"us; cycles in the slowest block: {', '.join(cycles)}"
                              + ("" if p.tier == "passes" else "; by part: " + ", ".join(
                                  f"{name} {t[24 + i]:.0f}" for i, name in enumerate(PARTS)))
                              + f" (means of {replays} replays; "
                              f"{'bit-exact vs the package' if same else 'DIFFERS FROM THE PACKAGE'}) ({smi})",
                              flush=True)
                        if not same:
                            sys.exit(1)


if __name__ == "__main__":
    main()
