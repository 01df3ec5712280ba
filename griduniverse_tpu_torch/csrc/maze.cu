// maze.cu — K3, Aldous–Broder maze generation, one maze per thread.
//
// Replaces: griduniverse_tpu/levels/maze.py `_aldous_broder_mazes` (331).
// A random walk on the cell graph records, for every cell, the edge by
// which the walk first entered it; those edges form a spanning tree that
// is exactly uniform over all spanning trees. The walk is capped at
// `max_iters` steps (the reference's default is 64·S·⌈log2 S⌉²). A cell the
// walk never reached is joined by the binary-tree rule (north, or west on
// row 0), which keeps the maze perfect. The tree is then carved into a
// (2ch+1, 2cw+1) grid with the goal at the bottom-right cell.
//
// Bound on the card: the walk's length. The JAX version walks all mazes in
// lockstep until the LAST one is covered, so its cost is the batch's
// slowest cover time times B·S lane work; that tail is the bound the TPU
// hit. Here each thread stops at its own maze's cover time, and a step is
// a few integer ops and one byte of local memory.
//
// Design: one thread per maze; the first-entry edges (one byte per cell)
// live in the thread's local memory up to kMaxLocalCells = 256 cells. A
// larger maze (up to the 63×63 cells whose grid fits 16,384 packed states)
// keeps them in a scratch buffer of S·B bytes that the wrapper allocates,
// cell-major (edge i of maze b at i·B + b) so that the threads of a warp
// touch neighbouring bytes, as in local memory: a local array of 3,969
// bytes would reserve that much for every thread the card can hold (about
// 1 GB), whatever B is, while the buffer grows with B and goes back to
// PyTorch's allocator after the call. Two modes share the walk:
//   * injected: the direction of step t for maze b is dirs[t, b] (int8),
//     so the reference's draws can be replayed. After cover the walk
//     enters no new cell, so stopping early gives the same grid as the
//     reference's lockstep loop.
//   * seeded: a per-maze xorshift32 stream seeded with fmix32(b·φ + seed);
//     the direction is its top two bits.
// Each thread writes its own maze row by row at the end.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLocalCells = 256;
constexpr uint8_t kUnvisited = 0xFF;
constexpr uint8_t kRoot = 4;
constexpr int kEmpty = 0, kWall = 1, kGoal = 3;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kScratch>
__global__ void aldous_broder_kernel(int ch, int cw, int batch, int max_iters,
                                     const int8_t* __restrict__ dirs,
                                     uint32_t seed, int* __restrict__ grids,
                                     uint8_t* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int s = ch * cw;

  // first-entry edge of each cell, seen from the entered cell: 0=N 1=E 2=S 3=W
  uint8_t own[kScratch ? 1 : kMaxLocalCells];
  uint8_t* const base = kScratch ? scratch + b : own;
  const size_t stride = kScratch ? static_cast<size_t>(batch) : 1;
  auto par = [&](int i) -> uint8_t& { return base[i * stride]; };
  for (int i = 0; i < s; ++i) par(i) = kUnvisited;
  par(0) = kRoot;  // the walk starts at cell (0, 0)

  uint32_t x = fmix32(static_cast<uint32_t>(b) * 0x9E3779B9u + seed) | 1u;
  int p = 0, n_visited = 1;
  for (int t = 0; t < max_iters && n_visited < s; ++t) {
    int d;
    if (dirs != nullptr) {
      d = dirs[static_cast<size_t>(t) * batch + b];
    } else {
      x ^= x << 13;
      x ^= x >> 17;
      x ^= x << 5;
      d = static_cast<int>(x >> 30);
    }
    const int r = p / cw, c = p - (p / cw) * cw;
    const int nr = r + (d == 0 ? -1 : (d == 2 ? 1 : 0));
    const int nc = c + (d == 1 ? 1 : (d == 3 ? -1 : 0));
    if (nr >= 0 && nr < ch && nc >= 0 && nc < cw) {  // off-grid moves stay
      p = nr * cw + nc;
      if (par(p) == kUnvisited) {
        par(p) = static_cast<uint8_t>((d + 2) & 3);
        ++n_visited;
      }
    }
  }
  // safety net: an unreached cell carves north (west on row 0)
  for (int i = 0; i < s; ++i) {
    if (par(i) == kUnvisited) par(i) = i >= cw ? 0 : 3;
  }

  const int h = 2 * ch + 1, w = 2 * cw + 1;
  int* g = grids + static_cast<size_t>(b) * h * w;
  for (int gr = 0; gr < h; ++gr) {
    for (int gc = 0; gc < w; ++gc) {
      int v = kWall;
      if ((gr & 1) && (gc & 1)) {
        v = kEmpty;  // a cell
      } else if (!(gr & 1) && (gc & 1) && gr > 0 && gr < h - 1) {
        // north wall of cell (r, c): open iff (r, c) entered from the north
        // or (r-1, c) entered from the south
        const int cell = (gr / 2) * cw + gc / 2;
        if (par(cell) == 0 || par(cell - cw) == 2) v = kEmpty;
      } else if ((gr & 1) && !(gc & 1) && gc > 0 && gc < w - 1) {
        // west wall of cell (r, c): open iff (r, c) entered from the west
        // or (r, c-1) entered from the east
        const int cell = (gr / 2) * cw + gc / 2;
        if (par(cell) == 3 || par(cell - 1) == 1) v = kEmpty;
      }
      g[gr * w + gc] = v;
    }
  }
  g[(h - 2) * w + (w - 2)] = kGoal;
}

}  // namespace

// `scratch`: S·B bytes when S > 256 cells, else unused (may be null).
extern "C" int gu_aldous_broder_mazes(int ch, int cw, int batch, int max_iters,
                                      const void* dirs, int seed, void* grids, void* scratch,
                                      void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  auto* kernel = ch * cw > kMaxLocalCells ? aldous_broder_kernel<true>
                                          : aldous_broder_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, cw, batch, max_iters, static_cast<const int8_t*>(dirs),
      static_cast<uint32_t>(seed), static_cast<int*>(grids), static_cast<uint8_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
