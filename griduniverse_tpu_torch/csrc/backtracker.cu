// backtracker.cu — K11, recursive-backtracker maze generation, one maze per
// thread.
//
// Replaces: griduniverse_tpu/levels/maze.py `_generate_one_maze` (142),
// vmapped over the batch at 477. The iterative backtracker keeps an explicit
// stack of cells: every iteration looks at the four neighbours of the top
// cell in a random order, carves to the first one not yet visited and pushes
// it, or pops when there is none. A maze of S cells takes S − 1 pushes and S
// pops, 2S − 1 iterations whatever the draws, and ends with the stack empty.
// The goal goes to the bottom-right cell.
//
// Bound on the card: operations, the 2S − 1 dependent iterations of a thread.
// The reference vmaps a `while_loop` whose every iteration rewrites the
// whole grid, visited map and stack of every maze with `where` (the TPU has
// no scatter worth using); here an iteration is one random draw, four bit
// tests and at most two 4-byte stores.
//
// Design: one thread a maze. Up to kMaxLocalCells = 256 cells, the visited
// bits (8 words) and the stack of cell ids (one byte a cell) live in the
// thread's local memory. A larger maze (up to the 63×63 cells whose grid
// fits 16,384 packed states) takes two-byte cell ids, and its visited bits
// and stack live in a scratch buffer that the wrapper allocates,
// ⌈S/32⌉ words and S ids a maze, laid out slot-major (slot i of maze b at
// i·B + b) so that a warp's threads touch neighbouring words, as in local
// memory. Local arrays of S = 3,969 ids would reserve 8.4 KB for every
// thread the card can hold (about 2.3 GB) whatever B is; the buffer grows
// with B and goes back to PyTorch's allocator after the call. The draws
// depend on (seed, b) alone, so both tiers make the same mazes.
// The thread fills its grid with walls first and writes each carve as it
// makes it; both are its own stores, so they stay in order. Random numbers:
// the maze's xorshift32 stream, seeded as K3's is with fmix32(b·φ + seed) | 1,
// one round an iteration; the neighbour order is permutation number
// ((x >> 16)·24) >> 16 of (N, E, S, W) in lexicographic order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLocalCells = 256;
constexpr int kEmpty = 0, kWall = 1, kGoal = 3;

// The 24 orders of the four directions, lexicographic, two bits a place
// (first place in the low bits); `levels.maze.NEIGHBOUR_ORDERS` is the same table.
__constant__ uint8_t kOrders[24] = {
    0xE4, 0xB4, 0xD8, 0x78, 0x9C, 0x6C, 0xE1, 0xB1, 0xC9, 0x39, 0x8D, 0x2D,
    0xD2, 0x72, 0xC6, 0x36, 0x4E, 0x1E, 0x93, 0x63, 0x87, 0x27, 0x4B, 0x1B,
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Id: the stack's cell id type; kScratch: visited bits and stack in
// `scratch` (⌈S/32⌉·B words, then S·B ids) instead of local memory.
template <typename Id, bool kScratch>
__global__ void backtracker_kernel(int ch, int cw, int batch, uint32_t seed,
                                   int* __restrict__ grids, uint32_t* __restrict__ scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int s = ch * cw;
  const int h = 2 * ch + 1, w = 2 * cw + 1;
  int* g = grids + static_cast<size_t>(b) * h * w;
  for (int i = 0; i < h * w; ++i) g[i] = kWall;
  g[w + 1] = kEmpty;  // cell (0, 0)

  const int n_words = kScratch ? (s + 31) / 32 : kMaxLocalCells / 32;
  const size_t stride = kScratch ? static_cast<size_t>(batch) : 1;
  uint32_t own_visited[kScratch ? 1 : kMaxLocalCells / 32];
  Id own_stack[kScratch ? 1 : kMaxLocalCells];
  uint32_t* const vbase = kScratch ? scratch + b : own_visited;
  Id* const sbase =
      kScratch ? reinterpret_cast<Id*>(scratch + n_words * stride) + b : own_stack;
  auto visited = [&](int i) -> uint32_t& { return vbase[i * stride]; };
  auto stack = [&](int i) -> Id& { return sbase[i * stride]; };
  for (int i = 0; i < n_words; ++i) visited(i) = 0u;
  visited(0) = 1u;
  stack(0) = 0;
  int sp = 1;

  uint32_t x = fmix32(static_cast<uint32_t>(b) * 0x9E3779B9u + seed) | 1u;
  for (int it = 0; it < 2 * s - 1; ++it) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    const uint32_t order = kOrders[((x >> 16) * 24u) >> 16];
    const int cur = stack(sp - 1);
    const int r = cur / cw, c = cur - r * cw;
    int pick = -1, target = 0;
    for (int k = 3; k >= 0; --k) {  // the first free neighbour in the order wins
      const int d = (order >> (2 * k)) & 3;
      const int nr = r + (d == 0 ? -1 : (d == 2 ? 1 : 0));
      const int nc = c + (d == 1 ? 1 : (d == 3 ? -1 : 0));
      if (nr < 0 || nr >= ch || nc < 0 || nc >= cw) continue;
      const int cell = nr * cw + nc;
      if ((visited(cell >> 5) >> (cell & 31)) & 1u) continue;
      pick = d;
      target = cell;
    }
    if (pick < 0) {
      --sp;
      continue;
    }
    const int dr = pick == 0 ? -1 : (pick == 2 ? 1 : 0);
    const int dc = pick == 1 ? 1 : (pick == 3 ? -1 : 0);
    g[(2 * r + 1 + dr) * w + 2 * c + 1 + dc] = kEmpty;
    g[(2 * r + 1 + 2 * dr) * w + 2 * c + 1 + 2 * dc] = kEmpty;
    visited(target >> 5) |= 1u << (target & 31);
    stack(sp++) = static_cast<Id>(target);
  }
  g[(h - 2) * w + (w - 2)] = kGoal;
}

}  // namespace

// `scratch`: ⌈S/32⌉·B words and then S·B two-byte ids when S > 256 cells,
// else unused (may be null).
extern "C" int gu_backtracker_mazes(int ch, int cw, int batch, int seed, void* grids,
                                    void* scratch, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  auto* kernel = ch * cw > kMaxLocalCells ? backtracker_kernel<uint16_t, true>
                                          : backtracker_kernel<uint8_t, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, cw, batch, static_cast<uint32_t>(seed), static_cast<int*>(grids),
      static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
