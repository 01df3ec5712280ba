"""K12's design choices timed one at a time on one CUDA card. A one-off
experiment of the redesign, kept to reproduce its readings; it is not part
of the package.

    python -m experiments.k12_variants

From the root of a checkout, on a machine with a Hopper card and nvcc. It
builds `griduniverse_tpu_torch/csrc/trace_pass.cu` with the package's flags
into one shared library a variant, each with exact lines of the source
replaced (`VARIANTS`): the grid's order (chunk-major as built: a chunk's
tiles adjacent, so the blocks running at once read whole rows; or
tile-major), the streaming hints of the trace's loads and stores, the
cells a block, the trace loads a group, the blocks a tile that add its
partial sums (4 as built at these shapes, or 1: the tile's last block
alone), and those adds cut; and with %globaltimer stamps of each block's
start and the end of its pass, and the appliers' end and clock64() cycles
of their adds (from the end of their wait). It prints the card's name and
power limit (`nvidia-smi`), the registers and spills of each build
(`-Xptxas -v`), then for SARSA(λ)'s trace (65,536 envs, 256 states × 4
actions) and TD(λ) prediction's (65,536 × 256): a step's time for each
variant (CUDA events around 20 steps after a warm-up), every variant but
the cut one held bit for bit against the package's own K12 on one step
from the same trace.
"""

from __future__ import annotations

import ctypes
import re
import sys
import tempfile
from pathlib import Path

import torch

from griduniverse_tpu_torch.algos import td_lambda
from griduniverse_tpu_torch.kernels import build
from griduniverse_tpu_torch.tools.profile_turns import _smi

PLAIN = """
__device__ __forceinline__ float gu_plain_load(const float* p) { return *p; }
__device__ __forceinline__ void gu_plain_store(float* p, float x) { *p = x; }
"""
CHUNK_MAJOR = "  const int chunk = blockIdx.x / tiles;\n  const int tile = blockIdx.x - chunk * tiles;\n"
TILE_MAJOR = "  const int tile = blockIdx.x / n_chunks;\n  const int chunk = blockIdx.x - tile * n_chunks;\n"
CLOCKS = """
__device__ unsigned long long gu_k12_t[4 * 8192];
__device__ __forceinline__ unsigned long long gu_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
// copies the first n stamps out, then sets all of them to 0
extern "C" int gu_k12_times_out(void* host, int n) {
  static const unsigned long long zeros[4 * 8192] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(host, gu_k12_t, n * sizeof(unsigned long long));
  return static_cast<int>(err != cudaSuccess ? err : cudaMemcpyToSymbol(gu_k12_t, zeros, sizeof(zeros)));
}
"""
# a block's start and the end of its pass (before its ticket), an applier's
# end, in ns of %globaltimer, and its clock64() cycles from the end of its wait
CLOCK_EDITS = [
    ("#include <cstdint>\n", "#include <cstdint>\n" + CLOCKS),
    ("  __shared__ int s_role;\n",
     "  __shared__ int s_role;\n  if (threadIdx.x == 0) gu_k12_t[4 * blockIdx.x] = gu_now();\n"),
    ("  unsigned int* const done = tickets + tiles;",
     "  if (threadIdx.x == 0) gu_k12_t[4 * blockIdx.x + 1] = gu_now();\n"
     "  unsigned int* const done = tickets + tiles;"),
    ("  __syncthreads();\n  __threadfence();\n  for (int q = role;",
     "  __syncthreads();\n  __threadfence();\n  const long long gu_c0 = clock64();\n  for (int q = role;"),
    ("    done[tile] = 0;\n  }\n}",
     "    done[tile] = 0;\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) { gu_k12_t[4 * blockIdx.x + 2] = gu_now(); "
     "gu_k12_t[4 * blockIdx.x + 3] = clock64() - gu_c0; }\n}"),
]


def edits(order="chunk", hints=True, tile=128, group=16, cut=False, clocks=False, appliers=None):
    """The (old line, new line) pairs of one variant, its tile and the
    appliers a tile it is launched with (None: as the package chooses)."""
    out = [("constexpr int kTile = 128;", f"constexpr int kTile = {tile};"),
           ("__launch_bounds__(kTile, 4)", f"__launch_bounds__(kTile, {512 // tile})"),
           ("constexpr int kGroup = 16;", f"constexpr int kGroup = {group};")]
    if order == "tile":
        out.append((CHUNK_MAJOR, TILE_MAJOR))
    if not hints:
        out += [("#include <cstdint>\n", "#include <cstdint>\n" + PLAIN), ("__ldcs(p)", "gu_plain_load(p)"),
                ("__stcs(p, ", "gu_plain_store(p, ")]
    if cut:
        out.append(("  if (role < 0) return;\n", "  return;\n"))
    if clocks:
        out += CLOCK_EDITS
    return out, tile, appliers


VARIANTS = {
    "as built (chunk-major, 128 cells, hints, 16 loads, 4 appliers a tile)": edits(),
    "as built, the adds of the partial sums cut": edits(cut=True),
    "as built, clocked": edits(clocks=True),
    "one applier a tile (its last block), clocked": edits(clocks=True, appliers=1),
    "two appliers a tile": edits(appliers=2),
    "64 cells a block (2 appliers)": edits(tile=64),
    "256 cells a block (8 appliers)": edits(tile=256),
    "tile-major": edits(order="tile"),
    "plain loads and stores": edits(hints=False),
    "8 loads a group": edits(group=8),
    "32 loads a group": edits(group=32),
}


def _appliers(cells: int, sms: int, tile: int, forced) -> int:
    """`kernels.trace_pass.appliers` for a tile of `tile` cells."""
    if forced is not None:
        return forced
    tiles = -(-cells // tile)
    return next((r for r in (tile // 32, 2) if r * tiles <= 2 * sms), 1)


def _build(out: Path) -> tuple[dict, str]:
    source = (Path(build.CSRC_DIR) / "trace_pass.cu").read_text()
    cmds, libs = [], {}
    for k, (name, (pairs, tile, forced)) in enumerate(VARIANTS.items()):
        text = source
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"k12_variants: trace_pass.cu lacks {old!r} (or has it twice)")
            text = text.replace(old, new)
        src = out / f"v{k}.cu"
        src.write_text(text)
        libs[name] = (out / f"v{k}.so", tile, forced)
        cmds.append([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(libs[name][0]), str(src)])
    log = build._run_all(cmds)
    loaded = {}
    for name, (path, tile, forced) in libs.items():
        so = ctypes.CDLL(str(path))
        so.gu_trace_pass.argtypes = build._SIGNATURES["gu_trace_pass"]
        so.gu_trace_pass.restype = ctypes.c_int
        if "clocked" in name:
            so.gu_k12_times_out.argtypes = [ctypes.c_void_p, ctypes.c_int]
            so.gu_k12_times_out.restype = ctypes.c_int
        loaded[name] = (so, tile, forced)
    return loaded, log


def _stamps(so, blocks: int, step) -> str:
    """One step's stamps, read as the line `main` prints."""
    t = (ctypes.c_ulonglong * (4 * blocks))()
    so.gu_k12_times_out(ctypes.addressof(t), 4 * blocks)  # clears the earlier steps' stamps
    step()
    torch.cuda.synchronize()
    so.gu_k12_times_out(ctypes.addressof(t), 4 * blocks)
    t = torch.tensor(list(t), dtype=torch.float64).reshape(blocks, 4)
    t0 = float(t[:, 0].min())
    ends = (t[:, 1] - t0) / 1e3
    appl = t[:, 2] > 0
    q = torch.quantile(ends, torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64))
    return (f"one step, us from the first block's start: blocks' starts up to {float((t[:, 0] - t0).max() / 1e3)!r}; "
            f"ends of the pass min/median/90 %/max {[round(float(x), 3) for x in q]}; the appliers end at "
            f"{[round(float(x), 3) for x in ((t[appl, 2] - t0) / 1e3)]} after {[int(x) for x in t[appl, 3]]} cycles "
            "of adds")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k12_variants: torch.cuda.is_available() is False; this runs only on a GPU")
    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs, log = _build(Path(tmp))
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        for k, name in enumerate(VARIANTS):  # two kernels a build: accumulating and replacing traces
            print(f"  {' and '.join(regs[2 * k:2 * k + 2])} registers, {' and '.join(spills[2 * k:2 * k + 2])} "
                  f"bytes of spill stores: {name}")
        gen = torch.Generator(device=dev).manual_seed(12)
        b = 65_536
        for s, a in ((256, 4), (256, None)):
            shape = (b, s) if a is None else (b, s, a)
            e0 = torch.rand(shape, generator=gen, device=dev) * (torch.rand(shape, generator=gen, device=dev) < 0.3)
            table = torch.randn(shape[1:], generator=gen, device=dev)
            st = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
            at = None if a is None else torch.randint(0, a, (b,), generator=gen, device=dev, dtype=torch.int32)
            delta = torch.randn((b,), generator=gen, device=dev)
            cut = torch.rand((b,), generator=gen, device=dev) < 0.01
            args = (st, at, delta, cut, 0.99, 0.9, 1e-4, 0.1, "accumulating")
            e_ref = e0.clone()
            want = td_lambda.trace_pass(table, e_ref, *args)
            cells = table.numel()
            bytes_bound = 2 * b * cells * 4 / 3.35e12 * 1e3
            print(f"trace ({b}, {cells}), {'control' if a is not None else 'prediction'}: bytes bound "
                  f"{bytes_bound!r} ms ({smi})")
            for name, (so, tile, forced) in libs.items():
                chunks, tiles = -(-b // 256), -(-cells // tile)
                per = tile // 32 * 64  # `kApplyChunks` of the variant's tile
                padded = -(-chunks // per) * per
                scratch = torch.zeros(padded * cells + cells + 2 * tiles, dtype=torch.int32, device=dev)
                base = scratch.data_ptr()
                out = torch.empty_like(table)
                e = e0.clone()
                r = _appliers(cells, sms, tile, forced)

                def step(e=e, so=so, out=out, base=base, r=r):
                    code = so.gu_trace_pass(
                        e.data_ptr(), st.data_ptr(), None if at is None else at.data_ptr(), delta.data_ptr(),
                        cut.data_ptr(), table.data_ptr(), out.data_ptr(), 0.99 * 0.9, 1e-4, 0.1, 0, 1 if a is None else a,
                        b, cells, r, base, base + 4 * padded * cells, base + 4 * (padded * cells + cells),
                        torch._C._cuda_getCurrentRawStream(0))
                    if code != 0:
                        raise SystemExit(f"k12_variants: {name}: CUDA error {code}")

                step()
                torch.cuda.synchronize()
                same = "cut" in name or (torch.equal(out.view(torch.int32), want.view(torch.int32))
                                         and torch.equal(e.view(torch.int32), e_ref.view(torch.int32)))
                if not same:
                    raise SystemExit(f"k12_variants: {name} differs from the package's K12")
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    step()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                print(f"  {ms!r} ms a step, {100 * bytes_bound / ms:.1f} % of the bound: {name}"
                      f"{'' if 'cut' in name else ', bit-exact'}")
                if "clocked" in name:
                    print(f"    {_stamps(so, chunks * tiles, step)}")
                del scratch, e
    sys.stdout.flush()


if __name__ == "__main__":
    main()
