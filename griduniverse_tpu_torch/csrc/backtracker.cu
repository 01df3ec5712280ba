// backtracker.cu — K11, recursive-backtracker maze generation, one maze per
// thread.
//
// Replaces: griduniverse_tpu/levels/maze.py `_generate_one_maze` (142),
// vmapped over the batch at 477. The iterative backtracker keeps a stack of
// cells: every iteration looks at the four neighbours of the top cell in a
// random order, carves to the first one not yet visited and pushes it, or
// pops when there is none. A maze of S cells takes S − 1 pushes and S pops,
// 2S − 1 iterations whatever the draws, and ends with the stack empty. The
// goal goes to the bottom-right cell.
//
// Bound on the card: the chain of an iteration. Its own operations (a
// xorshift round, the order, four neighbour tests, a push or a pop) are far
// below the card's issue rate, and the grids once are 1.1 GB at 32×32 cells
// × 65,536 mazes (0.33 ms of bytes). But one thread is one maze, which is
// the only layout that keeps the reference's draws, so each iteration waits
// on the one before it: the next cell needs this one's neighbour tests.
// The reference vmaps a `while_loop` whose every iteration rewrites the
// whole grid, visited map and stack of every maze with `where`.
//
// Design (`maze_tree.cuh`):
//  * No stack. The stack is always the path from the root to the current
//    cell in the tree being carved, so a pop lands on the parent of the
//    popped cell. The tree, each cell's direction to its parent in four bits
//    (0xF unvisited), in shared memory replaces both the stack and the
//    visited bits: a push writes the target's nibble (the reverse
//    direction) and moves there, a pop reads the current cell's nibble and
//    moves to its parent. The walk makes no store to device memory.
//  * A short chain without a branch. The current cell is carried as (row,
//    column), so no iteration divides; its word and its northern and
//    southern neighbours' words are three loads from the thread's own
//    column of shared memory at one shift (a fourth at a word's edge, for
//    the western or eastern neighbour). The pick, "the first unvisited
//    neighbour in the order", is one lookup: for each of the 24 orders a
//    64-bit word in shared memory holds the answer to each of the 16 sets
//    of unvisited neighbours in three bits (4: none, pop), read an
//    iteration ahead (the order depends on the draw alone). Push and pop
//    are selects of offsets and one predicated store.
//  * The grids written once, coalesced, by the block (`write_grids`).
// `kernels/maze.py` `plan` picks the mazes a block (128 down to 1) and its
// shared memory, or the device-memory tier (kGlobal: one maze a block, its
// tree in a scratch the wrapper allocates) where one tree does not fit.
// Random numbers: the maze's xorshift32 stream, seeded as K3's is with
// fmix32(b·φ + seed) | 1, one round an iteration; the neighbour order is
// permutation number ((x >> 16)·24) >> 16 of (N, E, S, W) in lexicographic
// order.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "maze_tree.cuh"

namespace {

using namespace maze_tree;

// The 24 orders of the four directions, lexicographic, two bits a place
// (first place in the low bits); `levels.maze.NEIGHBOUR_ORDERS` is the same table.
constexpr uint8_t kOrders[24] = {
    0xE4, 0xB4, 0xD8, 0x78, 0x9C, 0x6C, 0xE1, 0xB1, 0xC9, 0x39, 0x8D, 0x2D,
    0xD2, 0x72, 0xC6, 0x36, 0x4E, 0x1E, 0x93, 0x63, 0x87, 0x27, 0x4B, 0x1B,
};

// The pick of order p: bits 3F .. 3F + 2 of kPick[p] are the first direction
// in the order whose bit is set in F (bit d: neighbour d is unvisited), or 4.
constexpr uint64_t pick_word(int p) {
  uint64_t v = 0;
  for (int f = 15; f >= 0; --f) {
    int first = 4;
    for (int k = 3; k >= 0; --k) {
      const int d = (kOrders[p] >> (2 * k)) & 3;
      if ((f >> d) & 1) first = d;
    }
    v = (v << 3) | static_cast<uint64_t>(first);
  }
  return v;
}
struct PickTable {
  uint64_t word[24];
};
constexpr PickTable pick_table() {
  PickTable t{};
  for (int p = 0; p < 24; ++p) t.word[p] = pick_word(p);
  return t;
}
constexpr PickTable kPick = pick_table();
// order 0 is N E S W: none free → 4; only S (F = 4) → 2; N and W (F = 9) → 0
static_assert((kPick.word[0] & 7) == 4 && ((kPick.word[0] >> 12) & 7) == 2 && ((kPick.word[0] >> 27) & 7) == 0,
              "the pick table");
__constant__ PickTable kPickDevice = kPick;

// Block: kThreads threads, of which the first M = mazes_a_block (a power of
// two) walk a maze each, their trees in dynamic shared memory (M·ch·⌈cw/8⌉
// words, word-major), or with kGlobal (M = 1) in the block's part of
// `scratch`; then all write the block's grids.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads) backtracker_kernel(int ch, int cw, int batch, uint32_t seed,
                                                               int mazes_a_block, int* __restrict__ grids,
                                                               uint32_t* scratch) {
  using Index = typename std::conditional<kGlobal, long long, int>::type;
  extern __shared__ uint32_t smem_trees[];
  __shared__ uint64_t pick[24];
  const int stride = mazes_a_block, slot = threadIdx.x;
  const int base = blockIdx.x * stride;  // the block's first maze
  const int b = base + slot;
  const int wpr = row_words(cw), row_stride = wpr * stride;
  uint32_t* const trees = kGlobal ? scratch + static_cast<size_t>(blockIdx.x) * ch * row_stride : smem_trees;
  if (slot < 24) pick[slot] = kPickDevice.word[slot];
  __syncthreads();
  uint32_t* col = trees + slot;

  if (slot < stride && b < batch) {
    tree_init(col, stride, ch, cw);
    uint32_t x = xorshift(stream_init(b, seed));
    uint64_t table = pick[((x >> 16) * 24u) >> 16];  // read an iteration ahead of its use
    int r = 0, c = 0;
    for (Index it = 0; it < 2 * static_cast<Index>(ch) * cw - 1; ++it) {
      const uint64_t order = table;
      x = xorshift(x);
      table = pick[((x >> 16) * 24u) >> 16];
      const int a = r * row_stride + (c >> 3) * stride;  // the cell's word in the thread's column
      const int sh = (c & 7) * 4, sh_w = (sh - 4) & 31, sh_e = (sh + 4) & 31;
      const bool in_n = r > 0, in_s = r < ch - 1, in_w = c > 0, in_e = c < cw - 1;
      const bool w_edge = (c & 7) == 0, e_edge = (c & 7) == 7;
      const uint32_t w_c = col[a];
      const uint32_t w_n = in_n ? col[a - row_stride] : 0u;
      const uint32_t w_s = in_s ? col[a + row_stride] : 0u;
      const uint32_t w_w = w_edge && in_w ? col[a - stride] : w_c;
      const uint32_t w_e = e_edge && in_e ? col[a + stride] : w_c;
      const uint32_t fresh = (in_n && nibble_at(w_n, sh) == kUnvisited ? 1u : 0u) |
                             (in_e && nibble_at(w_e, sh_e) == kUnvisited ? 2u : 0u) |
                             (in_s && nibble_at(w_s, sh) == kUnvisited ? 4u : 0u) |
                             (in_w && nibble_at(w_w, sh_w) == kUnvisited ? 8u : 0u);
      const int d_push = static_cast<int>(order >> (3 * fresh)) & 7;
      // push: mark the target with the way back and move there; pop: move to
      // the parent (the root, 4, only on the last iteration)
      const bool push = d_push < 4, odd = d_push & 1, high = d_push & 2;  // N 00, E 01, S 10, W 11
      const int t_off = odd ? (high ? (w_edge ? -stride : 0) : (e_edge ? stride : 0))
                            : (high ? row_stride : -row_stride);
      const uint32_t w_t = odd ? (high ? w_w : w_e) : (high ? w_s : w_n);
      const int sh_t = odd ? (high ? sh_w : sh_e) : sh;
      if (push) col[a + t_off] = w_t ^ ((kUnvisited ^ static_cast<uint32_t>((d_push + 2) & 3)) << sh_t);
      const int d = push ? d_push : static_cast<int>(nibble_at(w_c, sh));
      r += d == 0 ? -1 : (d == 2 ? 1 : 0);
      c += d == 1 ? 1 : (d == 3 ? -1 : 0);
    }
    tree_to_walls(col, stride, ch, cw);
  }
  __syncthreads();
  const int nm = min(stride, batch - base);
  const size_t first = static_cast<size_t>(base) * (2 * ch + 1) * (2 * cw + 1);
  write_grids<Index>(trees, stride, nm, ch, cw, grids + first, static_cast<int>(-first & 3), slot);
}

}  // namespace

// `mazes_a_block`: 128, 64, ..., 1, the block's walking threads; `shared`:
// its bytes of trees, mazes_a_block · ch · ⌈cw/8⌉ · 4 (`kernels/maze.py`
// `plan`); or, with `scratch` (batch · ch · ⌈cw/8⌉ words), the trees in
// device memory, one maze a block.
extern "C" int gu_backtracker_mazes(int ch, int cw, int batch, int seed, void* grids,
                                    int mazes_a_block, int shared, void* scratch, void* stream) {
  auto* kernel = scratch != nullptr ? backtracker_kernel<true> : backtracker_kernel<false>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + mazes_a_block - 1) / mazes_a_block;
  kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      ch, cw, batch, static_cast<uint32_t>(seed), mazes_a_block, static_cast<int*>(grids),
      static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
