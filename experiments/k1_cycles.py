"""K1's cycles a step on one CUDA card, read by the SM's clock, and its
block size tried at the batches where it matters. A one-off experiment of
the redesign, kept to reproduce its readings; it is not part of the
package.

    python -m experiments.k1_cycles

From the root of a checkout, on a machine with a Hopper card and nvcc. It
builds `griduniverse_tpu_torch/csrc/rollout.cu` with the package's flags
into a shared library of its own, with lines added at exact places of K1's
kernel: lane 0 of each warp reads `clock64()` before the loop over steps
and after it, into a device array that `gu_k1_clocks_out` copies out. The
package's wrapper launches it (`kernels.rollout.launch` pointed at this
library), so the plan and the checks are the package's. It prints the
card's name and power limit (`nvidia-smi`), then for every shape of
`tools/profile_turns.py` `K1_SHAPES`: the call's time in a CUDA graph of
ten, the warps' mean and largest cycles in the loop and those over T, the
cycles a step of the chain; then walls16 with B = 1, 4,096 and 65,536
(T = 1,000, xorshift) in blocks of 32 (the plan's), 64, 128 and 256
threads. Every call is held bit for bit against the package's own K1.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import griduniverse_tpu_torch as gt
from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.kernels import rollout as rk
from griduniverse_tpu_torch.ops import bitplane as bp
from griduniverse_tpu_torch.tools.profile_kernels import _graph_ms
from griduniverse_tpu_torch.tools.profile_turns import K1_SHAPES, _smi, k1_levels

PRELUDE = """
__device__ long long gu_k1_clocks[1 << 12];
extern "C" int gu_k1_clocks_out(void* host, int warps) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, gu_k1_clocks, warps * sizeof(long long)));
}
"""
# exact lines of K1's kernel and what each becomes
EDITS = (
    ('#include "step.cuh"\n', '#include "step.cuh"\n' + PRELUDE),
    ("  int left = num_steps;\n", "  int left = num_steps;\n  const long long gu_c0 = clock64();\n"),
    ("  idx_out[b] = e.row * w + e.col;\n",
     "  if (lane == 0) gu_k1_clocks[b >> 5] = clock64() - gu_c0;\n  idx_out[b] = e.row * w + e.col;\n"),
)


def _build(out: Path) -> ctypes.CDLL:
    text = (Path(build.CSRC_DIR) / "rollout.cu").read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"k1_cycles: rollout.cu lacks the line {old!r} (or has it twice)")
        text = text.replace(old, new)
    src = out / "rollout.cu"
    src.write_text(text)
    lib = out / "k1_clocked.so"
    build._run_all([[build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o", str(lib),
                     str(src)]])
    so = ctypes.CDLL(str(lib))
    so.gu_random_scan_bits.argtypes = build._SIGNATURES["gu_random_scan_bits"]
    so.gu_random_scan_bits.restype = ctypes.c_int
    so.gu_k1_clocks_out.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def _same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip((*a[1:], a[0].agent_idx, a[0].agent_code, a[0].t),
                               (*b[1:], b[0].agent_idx, b[0].agent_code, b[0].t)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_cycles: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    sem = gt.make_semantics(device=dev)
    levels = k1_levels(gt, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                              check=True, capture_output=True, text=True).stdout.split()[0]) * 1e6
    cases = [(name, level, b, steps, rng, None) for name, level, b, steps, rng in K1_SHAPES]
    cases += [(f"walls16 B={b} T=1000 in blocks of {threads}", "walls16", b, 1_000, "xorshift", threads)
              for b in (1, 4096, 65_536) for threads in (32, 64, 128, 256)]
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        so = _build(Path(tmp))
        package_launch, package_plan = rk.launch, rk.plan
        for name, level, b, steps, rng, threads in cases:
            bl = levels[level]
            st = bp.reset_bits(bl, None if bl.batched else b)
            rs = bp.xorshift_init(3, (b,), device=dev) if rng == "xorshift" else None
            keys = bp.threefry_keys(3) if rng == "threefry" else None

            def scan():
                return bp.random_scan_bits(sem, bl, st, rs, keys, steps, 512, rng)

            want = scan()  # the package's own K1

            def clocked(name_, device, *args):
                code = so.gu_random_scan_bits(*args, torch._C._cuda_getCurrentRawStream(device.index or 0))
                if code:
                    raise SystemExit(f"k1_cycles: launch failed with CUDA error {code}")

            def plan(batch, n_words, per_env, actions, sms, threads=threads):
                p = package_plan(batch, n_words, per_env, actions, sms)
                if threads is None:
                    return p
                shared = threads * n_words * 4 if p.level == rk.LEVEL_STAGED else p.shared
                return p._replace(threads=threads, blocks=-(-batch // threads), shared=shared)

            rk.launch, rk.plan = clocked, plan
            try:
                got = scan()
                ms = _graph_ms(scan, 10, 2 if steps > 1_000 else 10)
                torch.cuda.synchronize()
                p = plan(b, bl.code_words.shape[-1], bl.batched, sem.num_actions, sms)
            finally:
                rk.launch, rk.plan = package_launch, package_plan
            warps = -(-b // 32)
            clocks = np.zeros(warps, np.int64)
            so.gu_k1_clocks_out(clocks.ctypes.data, warps)
            same = _same(got, want)
            print(f"K1 {name} ({p.threads} threads a block, level form {p.level}): {ms!r} ms a call in a CUDA "
                  f"graph of ten ({'bit-exact vs the package' if same else 'DIFFERS FROM THE PACKAGE'}); cycles in "
                  f"the loop, a warp's mean / largest: {clocks.mean():.0f} / {clocks.max()}; "
                  f"{clocks.mean() / steps:.1f} / {clocks.max() / steps:.1f} cycles a step; the call's time is "
                  f"{ms * 1e-3 * hz / steps:.1f} cycles a step at {hz / 1e6:.0f} MHz ({smi})", flush=True)
            if not same:
                sys.exit(1)


if __name__ == "__main__":
    main()
