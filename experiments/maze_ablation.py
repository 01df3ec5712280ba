"""K3's and K11's costs on one CUDA card: each phase of a warp timed by the
SM's clock, and each call with one phase cut. A one-off experiment of the
redesign, kept to reproduce its readings; it is not part of the package.

    python -m experiments.maze_ablation [DIR ...]

From the root of a checkout, on a machine with a Hopper card and nvcc. For
the sources in `griduniverse_tpu_torch/csrc/` and for those in each DIR (a
directory with its own `maze.cu`, `backtracker.cu` and `maze_tree.cuh` of the
same C interface: the device tier's scratch argument and K3's 64-bit cap),
it builds `maze.cu` and
`backtracker.cu` with the package's flags four ways, one shared library each,
by text edits at exact lines of those files:

- as written;
- the walk cut (no iteration or step runs: K11's trees stay all unvisited,
  K3's safety net carves the whole tree);
- the wall bits and the writer cut (the grids are not written);
- as written with `clock64()` read by lane 0 of every warp at its start,
  after its walk, after the wall bits and the block's barrier, and after
  the grids (into a device array that `gu_maze_clocks` copies out).

It prints the card's name and power limit (`nvidia-smi`), then, at the maze
path's shapes (K11 at 65,536 mazes of 4×4 cells, 8,192 of 16×16, 65,536 of
32×32 and 1,024 of 63×63; K3 seeded over 65,536 of 4×4 and injected over
256 of 32×32 for 5,000 steps), each build's time a call (CUDA events around
10 calls after a warm-up) and the warps' mean and largest cycles in each
phase, with the walk's cycles a link of its chain (an iteration of K11, a
step of K3's longest walk in the warp). The builds as written are held bit
for bit against the plain versions.
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

from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.kernels import maze as km
from griduniverse_tpu_torch.levels import maze as M
from griduniverse_tpu_torch.tools.profile_turns import _smi

CUTS = {"as written": "", "walk cut": "-DGU_CUT_WALK=1", "writer cut": "-DGU_CUT_WRITE=1",
        "clocked": "-DGU_CLOCK=1"}
PRELUDE = """
#ifndef GU_CUT_WALK
#define GU_CUT_WALK 0
#endif
#ifndef GU_CUT_WRITE
#define GU_CUT_WRITE 0
#endif
#ifndef GU_CLOCK
#define GU_CLOCK 0
#endif
__device__ long long gu_clocks[1 << 13][4];
extern "C" int gu_maze_clocks(void* host, int warps) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, gu_clocks, warps * 4 * sizeof(long long)));
}
#define GU_RECORD                                                                      \
  if (GU_CLOCK && (threadIdx.x & 31) == 0) {                                           \
    const long long gu_c3 = clock64();                                                 \
    long long* gu_r = gu_clocks[(blockIdx.x * blockDim.x + threadIdx.x) >> 5];         \
    gu_r[0] = gu_c1 - gu_c0;                                                           \
    gu_r[1] = gu_c2 - gu_c1;                                                           \
    gu_r[2] = gu_c3 - gu_c2;                                                           \
    gu_r[3] = gu_c3 - gu_c0;                                                           \
  }
"""
# exact lines of both kernels and what each becomes
EDITS = (
    ('#include "maze_tree.cuh"\n', '#include "maze_tree.cuh"\n' + PRELUDE),
    ("  uint32_t* col = trees + slot;\n",
     "  uint32_t* col = trees + slot;\n  const long long gu_c0 = clock64();\n  long long gu_c1 = gu_c0;\n"),
    ("    tree_to_walls(col, stride, ch, cw);\n  }\n  __syncthreads();\n",
     "    gu_c1 = clock64();\n    if (!GU_CUT_WRITE) tree_to_walls(col, stride, ch, cw);\n  }\n  __syncthreads();\n"
     "  const long long gu_c2 = clock64();\n"),
    ("  write_grids<Index>(trees, stride, nm, ch, cw, grids + first, static_cast<int>(-first & 3), slot);\n}\n",
     "  if (!GU_CUT_WRITE) write_grids<Index>(trees, stride, nm, ch, cw, grids + first, static_cast<int>(-first & 3), slot);\n"
     "  GU_RECORD\n}\n"),
)
WALK_LOOPS = (("for (Index it = 0; it < 2 * static_cast<Index>(ch) * cw - 1; ++it)",
               "for (Index it = 0; it < (GU_CUT_WALK ? 0 : 2 * static_cast<Index>(ch) * cw - 1); ++it)"),
              ("t0 < max_iters && walk.n_visited < s;", "t0 < (GU_CUT_WALK ? 0 : max_iters) && walk.n_visited < s;"))


def _edited(src: Path, name: str) -> str:
    text = (src / name).read_text()
    loop = WALK_LOOPS[0] if name == "backtracker.cu" else WALK_LOOPS[1]
    for old, new in EDITS + (loop,):
        if old not in text:
            raise SystemExit(f"maze_ablation: {src / name} lacks the line {old!r}")
        text = text.replace(old, new)
    return text


def build_all(dirs: list[Path], out: Path) -> dict:
    """{(dir, cut, kernel file): loaded library}; every nvcc at once."""
    jobs, cmds = [], []
    for d in dirs:
        edited = out / f"src{len(jobs)}"
        edited.mkdir()
        (edited / "maze_tree.cuh").write_text((d / "maze_tree.cuh").read_text())
        for name in ("maze.cu", "backtracker.cu"):
            (edited / name).write_text(_edited(d, name))
            for cut, flag in CUTS.items():
                lib = out / f"{len(jobs)}.so"
                jobs.append(((d, cut, name), lib))
                cmds.append([build.find_nvcc(), *build.NVCC_FLAGS, *([flag] if flag else []), "-shared",
                             "-I", str(edited), "-o", str(lib), str(edited / name)])
    build._run_all(cmds)
    libs = {}
    for key, lib in jobs:
        so = ctypes.CDLL(str(lib))
        fn = so.gu_backtracker_mazes if key[2] == "backtracker.cu" else so.gu_aldous_broder_mazes
        fn.argtypes = build._SIGNATURES["gu_backtracker_mazes" if key[2] == "backtracker.cu" else "gu_aldous_broder_mazes"]
        fn.restype = ctypes.c_int
        so.gu_maze_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[key] = (so, fn)
    return libs


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
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("maze_ablation: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    here = Path(build.CSRC_DIR)
    dirs = [here] + [Path(a).resolve() for a in args]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(32)
    dirs32 = torch.randint(0, 4, (5_000, 256), generator=gen, device=dev, dtype=torch.int8)
    _, steps32 = M.aldous_broder_mazes_reference((32, 32), 256, 5_000, directions=dirs32, count_steps=True)
    _, steps4 = M.aldous_broder_mazes_reference((4, 4), 65_536, seed=5, device=dev, count_steps=True)
    # (name, kernel file, cells, B, K3's max_iters and directions or None, the walk's steps a maze or None)
    shapes = [(f"K11 cells={c} B={b}", "backtracker.cu", c, b, None, None)
              for c, b in (((4, 4), 65_536), ((16, 16), 8_192), ((32, 32), 65_536), ((63, 63), 1_024))]
    shapes += [("K3 seeded cells=(4, 4) B=65536", "maze.cu", (4, 4), 65_536, (M._ab_default_max_iters(16), None), steps4),
               ("K3 injected cells=(32, 32) B=256 max_iters=5000", "maze.cu", (32, 32), 256, (5_000, dirs32), steps32)]
    hz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                              check=True, capture_output=True, text=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs = build_all(dirs, Path(tmp))
        for name, file, cells, b, k3, steps in shapes:
            ch, cw = cells
            p = km.plan(cells, b)
            if k3 is None:
                ref = M.backtracker_mazes_reference(cells, b, seed=7, device=dev)
            else:
                ref = M.aldous_broder_mazes_reference(cells, b, k3[0], directions=k3[1], seed=5, device=dev)
            for d in dirs:
                for cut in CUTS:
                    so, fn = libs[(d, cut, file)]
                    grids = torch.empty((b, 2 * ch + 1, 2 * cw + 1), dtype=torch.int32, device=dev)

                    def call(fn=fn, grids=grids):
                        if k3 is None:
                            code = fn(ch, cw, b, 7, grids.data_ptr(), p.mazes, p.shared, None, stream)
                        else:
                            ptr = None if k3[1] is None else k3[1].data_ptr()
                            code = fn(ch, cw, b, k3[0], ptr, 5, grids.data_ptr(), p.mazes, p.shared, None, stream)
                        if code:
                            raise SystemExit(f"maze_ablation: launch failed with CUDA error {code}")

                    ms = _events_ms(call)
                    line = f"[{'this tree' if d == here else d}] {name} {cut}: {ms!r} ms a call"
                    if cut == "as written":
                        line += ", bit-exact vs plain" if torch.equal(grids, ref) else ", DIFFERS FROM PLAIN"
                    if cut == "clocked":  # lane 0 of each walking warp: warp j < p.warps of each block
                        clocks = np.zeros((p.blocks * 4, 4), np.int64)
                        so.gu_maze_clocks(clocks.ctypes.data, p.blocks * 4)
                        walking = (np.arange(p.blocks * 4) % 4 < p.warps) & (np.arange(p.blocks * 4) // 4 * 32 * p.warps
                                                                             + np.arange(p.blocks * 4) % 4 * 32 < b)
                        clocks = clocks[walking]
                        warps = len(clocks)
                        links = (2 * ch * cw - 1) * np.ones(warps) if steps is None else np.maximum(1, np.pad(
                            steps.reshape(-1).cpu().numpy(), (0, warps * 32 - b)).reshape(warps, 32).max(axis=1))
                        line += "; cycles a walking warp, mean / largest: " + ", ".join(
                            f"{part} {clocks[:, k].mean():.0f} / {clocks[:, k].max()}"
                            for k, part in enumerate(("walk", "wall bits and barrier", "writer", "total")))
                        line += f"; walk {np.mean(clocks[:, 0] / links):.1f} cycles a link (mean over warps)"
                    print(f"{line} ({smi}, {hz / 1e6:.0f} MHz)", flush=True)
                    del grids


if __name__ == "__main__":
    main()
