"""What pieces of K4's shared tier buy: its source built with one piece cut
or added at a time, each build's 16-sweep launch timed on one CUDA card.

    python -m griduniverse_tpu_torch.tools.k4_ablation [--old DIR]

From the root of a checkout, on a machine with a Hopper card and nvcc. It
prints the card's name and power limit (`nvidia-smi`), then builds this
tree's `csrc/dp_grid.cu` into a library of its own under
`build/k4_ablation/` as it is, with one piece cut:

- "grid = groups": the grid capped at the blocks the card holds at once,
  each walking every gridDim.x-th group; instead one block a group, the
  scratch of maxima a row a group, which the last block reduces;

and with one piece added:

- "prefetch": the packed kernel loads the next group's inputs one group
  ahead, while it sweeps this one, instead of each group loading its own
  after the last group's sweeps (the table and word kernels load a maze
  at a time either way).

It times each build's call of 16 VI sweeps over 65,536 9×9 and 8,192 33×33
Aldous–Broder mazes and of 16 evaluation sweeps of a random policy over
4,096 9×9 mazes, from V = 0 (CUDA events around 30 calls after a warm-up,
in turns: the builds in order, then in reverse), and holds each other
build's V and sweep maxima bit for bit against the unchanged one.

With `--old DIR`, where DIR is a tree of commit 8ea520d (its `dp_grid.cu`
is K4's earlier design: one maze a block, and a `gu_grid_sweeps` that zeroes a
`sweep_max` which each block's atomicMax accumulates every sweep), it also
builds that source as it is, without the atomicMax a block and sweep, and
without the block's maximum too (the sweep keeps its swap barrier), and
times each's 16 VI sweeps over the 65,536 9×9 mazes: what each of the two
costs. The two cut versions compute wrong maxima; they are timed, never
used.

A patch that no longer fits its source stops the run: the cuts are written
against the sources of the trees named above.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from griduniverse_tpu_torch.kernels import build, dp_grid
from griduniverse_tpu_torch.tools.profile_turns import SWEEPS, _events_ms, _mazes, _smi

HERE = Path(__file__).resolve().parents[2]
OUT = Path("build/k4_ablation")

# the packed kernel's loop over groups, as built and with the prefetch
_LOOP = """  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const bool active = t < span && static_cast<long long>(grp) * mazes + j < n;
    const size_t at = static_cast<size_t>(grp) * span + t;
    int code = 0, chosen = 0;
    float v_own = 0.0f;
    if (active) {
      code = g.grids[at] & 3;
      v_own = v_in[at];
      if (kEval) chosen = g.policy[at];
      codes[t] = static_cast<uint8_t>(code);
      v0[t] = v_own;
    }
"""
_PREFETCH_LOOP = """  auto live = [&](int grp) { return t < span && static_cast<long long>(grp) * mazes + j < n; };
  int code_ahead = 0, policy_ahead = 0;
  float v_ahead = 0.0f;
  if (blockIdx.x < groups && live(blockIdx.x)) {
    const size_t at = static_cast<size_t>(blockIdx.x) * span + t;
    code_ahead = g.grids[at];
    v_ahead = v_in[at];
    if (kEval) policy_ahead = g.policy[at];
  }
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const bool active = live(grp);
    const size_t at = static_cast<size_t>(grp) * span + t;
    const int code = code_ahead & 3;
    const int chosen = policy_ahead;
    float v_own = v_ahead;
    if (active) {
      codes[t] = static_cast<uint8_t>(code);
      v0[t] = v_own;
    }
    const int after = grp + gridDim.x;
    if (after < groups && live(after)) {
      const size_t at_after = static_cast<size_t>(after) * span + t;
      code_ahead = g.grids[at_after];
      v_ahead = v_in[at_after];
      if (kEval) policy_ahead = g.policy[at_after];
    }
"""

# this tree's dp_grid.cu, one piece cut or added a variant
CUTS = {
    "as built": {},
    "grid = groups": {
        "blocks = std::min(std::min(blocks, groups), partial_rows);": "blocks = std::min(groups, partial_rows);",
    },
    # the packed kernel loads the next group's inputs while it sweeps this one
    "prefetch": {_LOOP: _PREFETCH_LOOP},
}
# the earlier one-maze-a-block dp_grid.cu, one cost cut a variant
ATOMIC = "if (threadIdx.x == 0) atomicMax(&sweep_max[k], __float_as_uint(m));"
OLD_CUTS = {
    "as built": {},
    "without the atomicMax a block and sweep": {ATOMIC: "if (m < 0.0f) sweep_max[k] = 0u;"},
    "without the block maximum and the atomicMax": {
        "const float m = block_max(local, red);": "const float m = local;",
        ATOMIC: "if (m < 0.0f) sweep_max[k] = 0u;"},
}


def _library(src: Path, out_dir: Path, patches: dict[str, str]) -> ctypes.CDLL:
    """`src` with each key replaced by its value, built into a library of
    its own."""
    text = src.read_text()
    for old, new in patches.items():
        if old not in text:
            raise SystemExit(f"k4_ablation: {src} has no `{old}`")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "dp_grid.cu", out_dir / "libk4.so"
    cu.write_text(text)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o", str(lib), str(cu)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def ablate_shared_tier(sem, dev, smi) -> None:
    import griduniverse_tpu_torch as gt

    gen = torch.Generator(device=dev).manual_seed(0)
    lv9 = _mazes(gt, dev, 2026, (4, 4), 65_536)
    lv33 = _mazes(gt, dev, 2027, (16, 16), 8_192)
    g_pi = lv9.grid[:4096].contiguous()
    shapes = {
        "16 VI sweeps, 65,536 mazes 9x9": (lv9.grid, None),
        "16 VI sweeps, 8,192 mazes 33x33": (lv33.grid, None),
        "16 evaluation sweeps, 4,096 mazes 9x9": (g_pi, torch.randint(0, 4, (4096, 81), generator=gen, device=dev,
                                                                      dtype=torch.int32)),
    }
    fns = {}
    for i, (name, patches) in enumerate(CUTS.items()):
        fn = _library(HERE / "griduniverse_tpu_torch/csrc/dp_grid.cu", OUT / f"cut{i}", patches).gu_grid_sweeps
        fn.argtypes = build._SIGNATURES["gu_grid_sweeps"]  # the stream last
        fn.restype = ctypes.c_int
        fns[name] = fn
    calls, results = {}, {}
    for shape, (grids, pol) in shapes.items():
        n, h, w = grids.shape
        pk = dp_grid.packing(h * w)
        groups = -(-n // pk.mazes)
        v0 = torch.zeros((n, h * w), device=dev)
        sem_args = [sem.passable.data_ptr(), sem.terminal.data_ptr(), sem.reward.data_ptr(), sem.deltas.data_ptr(), 4]
        for name, fn in fns.items():
            v_out = torch.empty_like(v0)
            maxima = torch.empty(SWEEPS, device=dev)
            # a row of maxima a group, then the ticket
            scratch = torch.zeros(groups * SWEEPS + 1, dtype=torch.int32, device=dev)

            def call(fn=fn, v_out=v_out, maxima=maxima, scratch=scratch, grids=grids, pol=pol, v0=v0, n=n, h=h, w=w,
                     pk=pk, groups=groups):
                code = fn(*sem_args, grids.data_ptr(), n, h, w, None if pol is None else pol.data_ptr(),
                          v0.data_ptr(), v_out.data_ptr(), 0.99, SWEEPS, pk.mazes, pk.threads, pk.cells,
                          int(pk.table), scratch.data_ptr(), groups, maxima.data_ptr(),
                          scratch.data_ptr() + 4 * groups * SWEEPS, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"gu_grid_sweeps: CUDA error {code}")
                return v_out, maxima

            calls[shape, name] = call
            out = call()
            torch.cuda.synchronize()
            results[shape, name] = tuple(x.clone() for x in out)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(results[shape, name], results[shape, "as built"])):
                raise SystemExit(f"k4_ablation: {name} differs from the unchanged kernel at {shape}")
    times: dict = {}
    order = list(fns)
    for rnd in (order, order[::-1]):
        for name in rnd:
            for shape in shapes:
                times.setdefault((shape, name), []).append(_events_ms(calls[shape, name]))
    for shape in shapes:
        for name in fns:
            print(f"[ablation] K4 {shape}, {name}: {times[shape, name]!r} ms a call; bit-exact against the "
                  f"unchanged kernel ({smi})")


def ablate_old_design(old: Path, sem, dev, smi) -> None:
    import griduniverse_tpu_torch as gt

    lv = _mazes(gt, dev, 2026, (4, 4), 65_536)
    n = lv.grid.shape[0]
    v0 = torch.zeros((n, 81), device=dev)
    v_out = torch.empty_like(v0)
    sweep_max = torch.empty(SWEEPS, dtype=torch.int32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for i, (name, patches) in enumerate(OLD_CUTS.items()):
        fn = _library(old / "griduniverse_tpu_torch/csrc/dp_grid.cu", OUT / f"old{i}", patches).gu_grid_sweeps
        fn.argtypes = [P, P, P, P, I, P, I, I, I, P, P, P, F, I, P, P]
        fn.restype = I

        def call(fn=fn):
            code = fn(sem.passable.data_ptr(), sem.terminal.data_ptr(), sem.reward.data_ptr(),
                      sem.deltas.data_ptr(), 4, lv.grid.data_ptr(), n, 9, 9, None, v0.data_ptr(),
                      v_out.data_ptr(), 0.99, SWEEPS, sweep_max.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"gu_grid_sweeps: CUDA error {code}")

        print(f"[ablation] one-maze-a-block K4, 16 VI sweeps, 65,536 mazes 9x9, {name}: {_events_ms(call)!r} ms "
              f"a call ({smi})")


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k4_ablation: torch.cuda.is_available() is False; this runs only on a GPU")
    import griduniverse_tpu_torch as gt

    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    sem = gt.make_semantics(device=dev)
    ablate_shared_tier(sem, dev, smi)
    if "--old" in args:
        ablate_old_design(Path(args[args.index("--old") + 1]).resolve(), sem, dev, smi)


if __name__ == "__main__":
    main()
