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
// hit. Here each thread stops at its own maze's cover time, and a step is a
// few integer operations and one word of shared memory; the chain of a
// step is that word's load, its test and its store.
//
// Design (`maze_tree.cuh`): one thread per maze, the first-entry edges the
// nibble tree in shared memory (a thread's own column), the position
// carried as (row, column) so no step divides, a step without a branch (the
// bound test is two unsigned compares, the mark a predicated store), and
// the grids written once, coalesced, by the block. The walk checks for
// cover every 16 steps: after cover it enters no new cell, so the extra
// steps change nothing. Two modes share the walk:
//   * injected: the direction of step t for maze b is dirs[t, b] (int8),
//     so the reference's draws can be replayed. Each thread loads its next
//     16 directions into registers while it walks the current 16, so no
//     step waits on device memory, and it never reads a row at or past
//     `max_iters`. A direction outside 0..3 leaves the walk where it is, as
//     in the reference.
//   * seeded: a per-maze xorshift32 stream seeded with fmix32(b·φ + seed);
//     the direction is its top two bits.
// `kernels/maze.py` `plan` picks the mazes a block (128 down to 1) and its
// shared memory, or the device-memory tier (kGlobal: one maze a block, its
// tree in a scratch the wrapper allocates) where one tree does not fit.
// `max_iters` is 64-bit: the reference's default, 64·S·⌈log2 S⌉², passes
// 2^31 above about 340×340 cells.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "maze_tree.cuh"

namespace {

using namespace maze_tree;

constexpr int kBlockSteps = 16;
constexpr int kStay = 4;  // a direction that moves nowhere (any value above 3)

// A walk's steps, pipelined: each step is first prepared (the move and the
// load of the new cell's word), then finished (the first-entry test and the
// mark) after the next step has been prepared, so that no load waits for
// the store before it. The store that a prepared load may have missed is
// the one finished just before it, and `finish` forwards it in registers.
template <typename Index>
struct Walk {
  int r = 0, c = 0;
  Index n_visited = 1;
  int at = 0, sh = 0;   // the prepared step's cell: word offset in the column, shift
  uint32_t raw = 0, mask = 0;  // its word as loaded, its mark as an xor
  int at_prev = -1;      // the last finished step's stored word (-1: none)
  uint32_t stored = 0;

  // Direction d: N 0, E 1, S 2, W 3. Any other value, or a move off the
  // grid, stays on the current cell, which is visited.
  __device__ __forceinline__ void prepare(unsigned d, int ch, int cw, const uint32_t* col, int stride,
                                          int row_stride) {
    const bool odd = d & 1u;  // odd moves along the row, by 2 − d; even ones across, by d − 1
    const int nr = r + (odd ? 0 : static_cast<int>(d) - 1), nc = c + (odd ? 2 - static_cast<int>(d) : 0);
    const bool ok = (d < 4u) & (static_cast<unsigned>(nr) < static_cast<unsigned>(ch)) &
                    (static_cast<unsigned>(nc) < static_cast<unsigned>(cw));
    r = ok ? nr : r;
    c = ok ? nc : c;
    at = r * row_stride + (c >> 3) * stride;
    sh = (c & 7) * 4;
    raw = col[at];
    mask = (kUnvisited ^ (d ^ 2u)) << sh;  // the way back; a stay never marks
  }

  // The prepared step's test and mark; `next` is prepared before this runs.
  __device__ __forceinline__ void finish(int at_step, int sh_step, uint32_t raw_step, uint32_t mask_step,
                                         uint32_t* col) {
    const uint32_t word = at_step == at_prev ? stored : raw_step;
    const bool fresh = nibble_at(word, sh_step) == kUnvisited;
    if (fresh) col[at_step] = word ^ mask_step;
    n_visited += fresh;
    at_prev = fresh ? at_step : -1;
    stored = word ^ mask_step;
  }

  // Prepare the step in direction d_next, then finish the one prepared before it.
  __device__ __forceinline__ void step(unsigned d_next, int ch, int cw, uint32_t* col, int stride,
                                       int row_stride) {
    const int at_step = at, sh_step = sh;
    const uint32_t raw_step = raw, mask_step = mask;
    prepare(d_next, ch, cw, col, stride, row_stride);
    finish(at_step, sh_step, raw_step, mask_step, col);
  }
};

// Directions t0 .. t0 + 15 of maze b, zero-extended bytes as loaded (kStay
// at and past max_iters); nothing waits on them until the walk reaches them.
__device__ __forceinline__ void load_block(unsigned (&dst)[kBlockSteps], const uint8_t* __restrict__ dirs,
                                           long long t0, long long max_iters, int batch, int b) {
  const uint8_t* row = dirs + static_cast<size_t>(t0) * batch + b;
  const long long left = max_iters - t0;
#pragma unroll
  for (int k = 0; k < kBlockSteps; ++k, row += batch) {
    dst[k] = kStay;
    if (k < left) dst[k] = *row;
  }
}

// Block: kThreads threads, of which the first M = mazes_a_block (a power of
// two) walk a maze each, their trees in dynamic shared memory (M·ch·⌈cw/8⌉
// words, word-major), or with kGlobal (M = 1) in the block's part of
// `scratch`; then all write the block's grids.
template <bool kInjected, bool kGlobal>
__global__ void __launch_bounds__(kThreads) aldous_broder_kernel(int ch, int cw, int batch, long long max_iters,
                                                                 const uint8_t* __restrict__ dirs, uint32_t seed,
                                                                 int mazes_a_block, int* __restrict__ grids,
                                                                 uint32_t* scratch) {
  using Index = typename std::conditional<kGlobal, long long, int>::type;
  extern __shared__ uint32_t smem_trees[];
  const int stride = mazes_a_block, slot = threadIdx.x;
  const int base = blockIdx.x * stride;  // the block's first maze
  const int b = base + slot;
  const Index s = static_cast<Index>(ch) * cw;
  const int wpr = row_words(cw), row_stride = wpr * stride;
  uint32_t* const trees = kGlobal ? scratch + static_cast<size_t>(blockIdx.x) * ch * row_stride : smem_trees;
  uint32_t* col = trees + slot;

  if (slot < stride && b < batch) {
    tree_init(col, stride, ch, cw);  // the walk starts at cell (0, 0), the root
    Walk<Index> walk;
    if (kInjected) {
      unsigned now[kBlockSteps], next[kBlockSteps];
      load_block(now, dirs, 0, max_iters, batch, b);
      load_block(next, dirs, kBlockSteps, max_iters, batch, b);
      walk.prepare(now[0], ch, cw, col, stride, row_stride);
      for (long long t0 = 0; t0 < max_iters && walk.n_visited < s; t0 += kBlockSteps) {
#pragma unroll
        for (int k = 0; k < kBlockSteps; ++k)  // finishes step t0 + k
          walk.step(k + 1 < kBlockSteps ? now[k + 1] : next[0], ch, cw, col, stride, row_stride);
#pragma unroll
        for (int k = 0; k < kBlockSteps; ++k) now[k] = next[k];
        load_block(next, dirs, t0 + 2 * kBlockSteps, max_iters, batch, b);
      }
    } else {
      uint32_t x = xorshift(stream_init(b, seed));
      walk.prepare(max_iters > 0 ? x >> 30 : kStay, ch, cw, col, stride, row_stride);
      for (long long t0 = 0; t0 < max_iters && walk.n_visited < s; t0 += kBlockSteps) {
        // steps of this block below the cap, plus one (at most kBlockSteps + 1)
        const int left = static_cast<int>(min(max_iters - t0, static_cast<long long>(kBlockSteps + 1)));
#pragma unroll
        for (int k = 0; k < kBlockSteps; ++k) {  // finishes step t0 + k
          x = xorshift(x);
          walk.step(k + 1 < left ? x >> 30 : kStay, ch, cw, col, stride, row_stride);
        }
      }
    }
    // safety net: an unreached cell carves north (west on row 0)
    if (walk.n_visited < s) {
      for (int rr = 0; rr < ch; ++rr) {
        for (int j = 0; j < wpr; ++j) {
          uint32_t* at = col + rr * row_stride + j * stride;
          uint32_t word = *at;
          for (int k = 0; k < 8 && 8 * j + k < cw; ++k) {
            if (nibble_at(word, 4 * k) == kUnvisited) word ^= (kUnvisited ^ (rr > 0 ? 0u : 3u)) << (4 * k);
          }
          *at = word;
        }
      }
    }
    tree_to_walls(col, stride, ch, cw);
  }
  __syncthreads();
  const int nm = min(stride, batch - base);
  const size_t first = static_cast<size_t>(base) * (2 * ch + 1) * (2 * cw + 1);
  write_grids<Index>(trees, stride, nm, ch, cw, grids + first, static_cast<int>(-first & 3), slot);
}

}  // namespace

// `dirs`: (≥ max_iters, batch) int8, or null for the seeded walk.
// `mazes_a_block`: 128, 64, ..., 1, the block's walking threads; `shared`:
// its bytes of trees, mazes_a_block · ch · ⌈cw/8⌉ · 4 (`kernels/maze.py`
// `plan`); or, with `scratch` (batch · ch · ⌈cw/8⌉ words), the trees in
// device memory, one maze a block.
extern "C" int gu_aldous_broder_mazes(int ch, int cw, int batch, long long max_iters,
                                      const void* dirs, int seed, void* grids, int mazes_a_block,
                                      int shared, void* scratch, void* stream) {
  auto* kernel = scratch != nullptr ? (dirs != nullptr ? aldous_broder_kernel<true, true>
                                                       : aldous_broder_kernel<false, true>)
                                    : (dirs != nullptr ? aldous_broder_kernel<true, false>
                                                       : aldous_broder_kernel<false, false>);
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + mazes_a_block - 1) / mazes_a_block;
  kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      ch, cw, batch, max_iters, static_cast<const uint8_t*>(dirs), static_cast<uint32_t>(seed), mazes_a_block,
      static_cast<int*>(grids), static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
