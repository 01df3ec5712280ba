"""K2's cycles a step of its chain on one CUDA card, read by the SM's
clock. A one-off experiment of the redesign, kept to reproduce its
readings; it is not part of the package.

    python -m experiments.k2_cycles

From the root of a checkout, on a machine with a Hopper card and nvcc. It
builds `griduniverse_tpu_torch/csrc/rollout.cu` with the package's flags
into a shared library of its own, with lines added at exact places of
K2's kernel: lane 0 of each warp reads `clock64()` before the loop over
steps and after it, into a device array that `gu_k2_clocks` copies out.
It prints the card's name and power limit (`nvidia-smi`), then, for K2 in
the auto-reset mode with max_episode_steps 64 at walls16 with B = 4,096
and 65,536, over 4,096 per-env 4×4 mazes (T = 512 each) and at the golden
replay over four 4×4 mazes: the call's time (CUDA events around 10 calls
after a warm-up), the warps' mean and largest cycles in the loop, and
those over T, the cycles a step of the chain; every call held bit for bit
against the package's own K2.
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
from griduniverse_tpu_torch.kernels.rollout import level_args, max_steps_arg, semantics_args
from griduniverse_tpu_torch.levels import builders
from griduniverse_tpu_torch.levels import maze as M
from griduniverse_tpu_torch.ops import bitplane as bp
from griduniverse_tpu_torch.tools.profile_turns import _smi

PRELUDE = """
__device__ long long gu_k2_clocks[1 << 12];
extern "C" int gu_k2_clocks_out(void* host, int warps) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, gu_k2_clocks, warps * sizeof(long long)));
}
"""
# exact lines of K2's kernel and what each becomes
EDITS = (
    ('#include "step.cuh"\n', '#include "step.cuh"\n' + PRELUDE),
    ("  size_t o = b;  // [t, b] of the step\n",
     "  size_t o = b;  // [t, b] of the step\n  const long long gu_c0 = clock64();\n"),
    ("  idx_out[b] = p.idx;\n",
     "  if (lane == 0) gu_k2_clocks[blockIdx.x] = clock64() - gu_c0;\n  idx_out[b] = p.idx;\n"),
)


def _build(out: Path) -> ctypes.CDLL:
    text = (Path(build.CSRC_DIR) / "rollout.cu").read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"k2_cycles: rollout.cu lacks the line {old!r} (or has it twice)")
        text = text.replace(old, new)
    src = out / "rollout.cu"
    src.write_text(text)
    lib = out / "k2_clocked.so"
    build._run_all([[build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o", str(lib),
                     str(src)]])
    so = ctypes.CDLL(str(lib))
    so.gu_rollout_actions_bits.argtypes = build._SIGNATURES["gu_rollout_actions_bits"]
    so.gu_rollout_actions_bits.restype = ctypes.c_int
    so.gu_k2_clocks_out.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def _events_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_cycles: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    sem = gt.make_semantics(device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    walls = bp.pack_level(builders.walls_and_goal_16x16(device=dev))
    grids, start = M.generate_mazes_device(11, (4, 4), 4096, "aldous_broder", device=dev)
    mazes = bp.pack_level(gt.Level(grid=grids, start_idx=start.expand(4096).contiguous()))
    golden = Path("tests") / "golden"
    cfg4 = np.load(golden / "torch" / "cfg4_mazes_grids.npz")
    shapes = [("walls16 B=4096 T=512", walls, 4096, None), ("4096 per-env 4x4 mazes T=512", mazes, 4096, None),
              ("walls16 B=65536 T=512", walls, 65_536, None),
              ("golden cfg4_mazes B=4", bp.pack_level(gt.make_level(cfg4["grids"], cfg4["start_idx"], device=dev)), 4,
               torch.as_tensor(np.load(golden / "cfg4_mazes.npz")["actions"], device=dev))]
    hz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                              check=True, capture_output=True, text=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        so = _build(Path(tmp))
        for name, bl, b, actions in shapes:
            if actions is None:
                actions = torch.randint(0, 4, (512, b), generator=gen, device=dev, dtype=torch.int32)
            n_steps = actions.shape[0]
            st = bp.reset_bits(bl, None if bl.batched else b)
            want_state, want = bp.rollout_actions_bits(sem, bl, st, actions, True, 64)
            outs = [torch.empty(b, dtype=torch.int32, device=dev) for _ in range(3)]
            outs.append(torch.empty(b, dtype=torch.bool, device=dev))
            outs += [torch.empty((n_steps, b), dtype=d, device=dev) for d in (torch.int32, torch.float32, torch.bool)]
            args = semantics_args(sem.passable, sem.terminal, sem.reward, sem.deltas, dev)
            args += level_args(bl.code_words, bl.start_idx, bl.start_code, bl.height, bl.width, b, dev)
            args += [b, n_steps, 1, max_steps_arg(64), actions.data_ptr(), st.agent_idx.data_ptr(),
                     st.agent_code.data_ptr(), st.t.data_ptr(), st.done.data_ptr()]
            args += [o.data_ptr() for o in outs]

            def call():
                code = so.gu_rollout_actions_bits(*args, stream)
                if code:
                    raise SystemExit(f"k2_cycles: launch failed with CUDA error {code}")

            ms = _events_ms(call)
            same = all(torch.equal(g, w) for g, w in zip(outs[4:], want)) and torch.equal(outs[0], want_state.agent_idx)
            warps = -(-b // 32)
            clocks = np.zeros(warps, np.int64)
            so.gu_k2_clocks_out(clocks.ctypes.data, warps)
            print(f"{name}: {ms!r} ms a call ({'bit-exact vs the package' if same else 'DIFFERS FROM THE PACKAGE'}); "
                  f"cycles in the loop over steps, a warp's mean / largest: {clocks.mean():.0f} / {clocks.max()}; "
                  f"{clocks.mean() / n_steps:.1f} / {clocks.max() / n_steps:.1f} cycles a step; the call's time is "
                  f"{ms * 1e-3 * hz / n_steps:.1f} cycles a step at {hz / 1e6:.0f} MHz ({smi})", flush=True)
            if not same:
                sys.exit(1)


if __name__ == "__main__":
    main()
