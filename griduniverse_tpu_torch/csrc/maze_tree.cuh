// maze_tree.cuh — what K3 (`maze.cu`) and K11 (`backtracker.cu`) share: a
// maze's spanning tree in shared memory, four bits a cell, and the block's
// writer that carves its trees into their grids.
//
// The tree. Each cell holds one nibble: 0xF unvisited, 0–3 the direction to
// its parent (N E S W, the edge the cell was entered by), 4 the root. Eight
// cells make a 32-bit word, and each row of cw cells takes ⌈cw/8⌉ words (the
// row's last nibbles past cw stay 0xF), so a cell's northern and southern
// neighbours sit at the same shift of the words one row away. The words of
// a block's M mazes (M a multiple of 32, a thread a maze) lie word-major:
// word k of the block's maze m at k·M + m. A thread then only ever touches
// its own column, and the 32 lanes of a warp sit in 32 distinct banks
// whatever words they ask for: no bank conflicts, no atomics. A 63×63-cell
// maze takes 504 words (2,016 bytes), so one warp's 32 mazes take 63 KB of
// the block's opt-in shared memory. Where 32 trees do not fit, a block walks
// fewer mazes (M = 16, 8, ..., 1 lanes of its first warp; a power of two, so
// the lanes' words still lie in distinct banks), and where not even one
// does, the trees lie in a device-memory scratch in the same layout (M = 1).
//
// The carve rule (both generators): the wall between two neighbouring cells
// is open iff one of them was entered through it, i.e. iff the cell's nibble
// points at the other. A north wall is open iff the cell's nibble is N or
// the northern cell's is S; a west wall iff the cell's is W or the western
// cell's is E. The grid is (2ch+1, 2cw+1) int32: cells EMPTY, walls WALL
// unless open, corners WALL, the goal at (h − 2, w − 2).
//
// The writer. After the walks (a barrier) the block's M mazes are finished,
// and their grids are M·h·w int32 that lie next to each other in the
// output. All kThreads threads of the block, the walkers and, where the
// block has fewer than four walking warps, warps that only write, write that
// region once, front to back, with 16-byte stores: thread t takes the 16
// bytes at 16·(t + kThreads·k) past the region's first 16-byte boundary, so
// a warp's store covers 512 consecutive bytes. Where M is a multiple of 4
// the region starts on one (h·w is odd, so only then); otherwise its first
// 1–3 int32 (the lead) are written plainly, as are its last 1–3. No tile is
// written twice and there is no wall fill.
// Before it, each walker turns its own tree into two bits a cell in place
// (`tree_to_walls`): word j of a row holds the north walls of the row's
// cells 16j .. 16j + 15 in its low half and their west walls in its high
// half. A store's four tiles lie in at most two grid rows, so a thread
// reads one window of three cells' bits for each (one or two words) and
// turns it into the four tiles with a few bit operations (`wall_mask`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace maze_tree {

constexpr int kEmpty = 0, kWall = 1, kGoal = 3;
constexpr uint32_t kUnvisited = 0xFu;
constexpr uint32_t kRoot = 4u;
constexpr int kThreads = 128;  // a block: 1, 2 or 4 warps walk, all 4 write

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// A maze's xorshift32 stream, seeded from (seed, b) alone.
__device__ __forceinline__ uint32_t stream_init(int b, uint32_t seed) {
  return fmix32(static_cast<uint32_t>(b) * 0x9E3779B9u + seed) | 1u;
}

__device__ __forceinline__ uint32_t xorshift(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

// Words of one row of a maze's tree: eight cells a word.
__host__ __device__ __forceinline__ int row_words(int cw) { return (cw + 7) >> 3; }

__device__ __forceinline__ uint32_t nibble_at(uint32_t word, int shift) { return (word >> shift) & 0xFu; }

// A walker's tree, all unvisited but the root (cell 0).
__device__ __forceinline__ void tree_init(uint32_t* col, int stride, int ch, int cw) {
  const int n = ch * row_words(cw);
  for (int k = 1; k < n; ++k) col[k * stride] = 0xFFFFFFFFu;
  col[0] = 0xFFFFFFF0u | kRoot;
}

// Bit 4k + 3 set iff nibble k of x equals v (exact: no carry crosses a nibble).
__device__ __forceinline__ uint32_t nibbles_equal(uint32_t x, uint32_t v) {
  const uint32_t t = x ^ (v * 0x11111111u);
  return ~(((t & 0x77777777u) + 0x77777777u) | t) & 0x88888888u;
}

// Bits 4k + 3 → bits k, k = 0..7.
__device__ __forceinline__ uint32_t compress8(uint32_t z) {
  uint32_t x = z >> 3;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// In place: the tree's nibbles become the open walls, two bits a cell. Word
// j of row r takes cells 16j .. 16j + 15 of the row (low half north walls,
// high half west walls). Rows go from the last up, and words along a row
// from the first, so each code word is written after every read of the
// tree words it replaces: word j of row r reads words 2j − 1 .. 2j + 1 of
// its row and 2j, 2j + 1 of the row above. Row 0 has no nibble N, column 0
// no W, the last column no E, and the padding past cw is 0xF, so no edge
// needs a mask: a neighbour outside the lattice reads as unvisited.
__device__ __forceinline__ void tree_to_walls(uint32_t* col, int stride, int ch, int cw) {
  const int wpr = row_words(cw);
  for (int r = ch - 1; r >= 0; --r) {
    uint32_t* row = col + r * wpr * stride;
    for (int j = 0; 16 * j < cw; ++j) {
      uint32_t north = 0, west = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * j + half;
        if (t >= wpr) break;
        const uint32_t own = row[t * stride];
        const uint32_t above = r > 0 ? row[(t - wpr) * stride] : 0xFFFFFFFFu;
        const uint32_t left = (own << 4) | (t > 0 ? row[(t - 1) * stride] >> 28 : 0xFu);
        north |= compress8(nibbles_equal(own, 0) | nibbles_equal(above, 2)) << (8 * half);
        west |= compress8(nibbles_equal(own, 3) | nibbles_equal(left, 1)) << (8 * half);
      }
      row[j * stride] = north | (west << 16);
    }
  }
}

// Walls' bits of cells c0, c0 + 1, c0 + 2 of grid row gr of the block's
// maze m (bit j: cell c0 + j's wall is open): the north walls on an even
// row, the west walls on an odd one; none on the last row (the south edge)
// or past the row's last cell (the east edge: c0 = cw, or the code word's
// bits past cw, which are 0). Loads are predicated, not branched around.
__device__ __forceinline__ uint32_t wall_window(const uint32_t* walls, int stride, int m, int gr, int c0,
                                                int ch, int cw) {
  const int r = gr >> 1, j = c0 >> 4, sh = c0 & 15;
  const bool valid = r < ch && c0 < cw;
  const uint32_t* at = walls + (valid ? r * row_words(cw) + j : 0) * stride + m;
  const uint32_t lo = valid ? at[0] : 0u;
  const uint32_t hi = valid && sh > 13 && 16 * (j + 1) < cw ? at[stride] : 0u;
  // the two words' low halves (even rows) or high halves (odd rows), side by side
  return (__byte_perm(lo, hi, gr & 1 ? 0x7632 : 0x5410) >> sh) & 7u;
}

// Which of four tiles in a row, from a tile of column parity odd_c on, are
// WALL (bit e for tile e): the wall tiles (the first if odd_r != odd_c, else
// the second, and two on) from `bits` (wall_window at the first tile's
// cell), the others cells (EMPTY) on an odd row and corners (WALL) on an
// even one.
__device__ __forceinline__ uint32_t wall_mask(uint32_t bits, bool odd_r, bool odd_c) {
  const bool first = odd_r != odd_c;
  const uint32_t used = (first ? bits : bits >> odd_c) & 3u;  // the two walls' bits
  const uint32_t shut = (~used & 1u) | ((~used & 2u) << 1);   // closed walls at tiles 0 and 2
  return (first ? shut : shut << 1) | (odd_r ? 0u : (first ? 0xAu : 0x5u));
}

// The tile at (gr, gc) of the block's maze m.
__device__ __forceinline__ int one_tile(const uint32_t* walls, int stride, int m, int gr, int gc, int ch,
                                        int cw) {
  const int h = 2 * ch + 1, w = 2 * cw + 1;
  if (gr == h - 2 && gc == w - 2) return kGoal;
  return wall_mask(wall_window(walls, stride, m, gr, gc >> 1, ch, cw), gr & 1, gc & 1) & 1u ? kWall : kEmpty;
}

// Int32 f of the region, by its maze, row and column.
template <typename Index>
__device__ __forceinline__ int tile_at(const uint32_t* walls, int stride, Index f, Index hw, int ch, int cw) {
  const int w = 2 * cw + 1;
  const int m = static_cast<int>(f / hw);
  const Index rt = f - m * hw;
  const int gr = static_cast<int>(rt / w);
  return one_tile(walls, stride, m, gr, static_cast<int>(rt - static_cast<Index>(gr) * w), ch, cw);
}

// The block writes the grids of its nm mazes (walls' words in columns
// walls[k·stride + m], m < nm) into `out` (nm·h·w int32, 4-byte aligned;
// the first `lead` < 4 of them lie before a 16-byte boundary). Index is
// int, or long long where one maze's grid may pass 2^31 tiles.
template <typename Index>
__device__ __forceinline__ void write_grids(const uint32_t* walls, int stride, int nm, int ch, int cw,
                                            int* __restrict__ out, int lead, int t) {
  const int h = 2 * ch + 1, w = 2 * cw + 1;
  const Index hw = static_cast<Index>(h) * w;
  const Index n_ints = nm * hw;
  const int head = n_ints < lead ? static_cast<int>(n_ints) : lead;
  const Index n4 = (n_ints - head) >> 2;
  int4* out4 = reinterpret_cast<int4*>(out + head);
  // thread t starts at int head + 4t and moves 4·kThreads ints a store: (m, gr, gc) carried
  const Index i0 = head + 4 * t;
  int m = static_cast<int>(i0 / hw);
  const Index r0 = i0 - m * hw;
  int gr = static_cast<int>(r0 / w);
  int gc = static_cast<int>(r0 - static_cast<Index>(gr) * w);
  const int rows = 4 * kThreads / w, step_c = 4 * kThreads - rows * w;
  const int step_r = rows % h, step_m = rows / h;
  for (Index q = t; q < n4; q += kThreads) {
    int v[4];
    if (cw > 1) {  // w ≥ 5: the four tiles lie in this row and at most the next
      const int k = w - gc;  // tiles left in this row
      uint32_t walls4 = wall_mask(wall_window(walls, stride, m, gr, gc >> 1, ch, cw), gr & 1, gc & 1);
      if (k < 4) {  // the rest from the next row's first tiles (row 0 of the next maze after the last)
        const bool wraps = gr + 1 == h;
        const int gr2 = wraps ? 0 : gr + 1;
        const uint32_t next = wall_mask(wall_window(walls, stride, wraps ? m + 1 : m, gr2, 0, ch, cw), gr2 & 1, 0);
        walls4 = (walls4 & ((1u << k) - 1u)) | ((next << k) & 0xFu);
      }
      const int goal = gr == h - 2 ? w - 2 - gc : -1;  // the goal's tile of the four, if any
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = goal == e ? kGoal : ((walls4 >> e) & 1u ? kWall : kEmpty);
    } else {  // one cell a row (w = 3): tile by tile
      int mm = m, rr = gr, cc = gc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = one_tile(walls, stride, mm, rr, cc, ch, cw);
        if (++cc == w) {
          cc = 0;
          if (++rr == h) {
            rr = 0;
            ++mm;
          }
        }
      }
    }
    out4[q] = make_int4(v[0], v[1], v[2], v[3]);
    gc += step_c;
    if (gc >= w) {
      gc -= w;
      ++gr;
    }
    gr += step_r;
    m += step_m;
    if (gr >= h) {
      gr -= h;
      ++m;
    }
  }
  if (t < head) out[t] = tile_at(walls, stride, static_cast<Index>(t), hw, ch, cw);  // the lead
  const Index f = head + 4 * n4 + t;  // the region's last 1–3 int32
  if (f < n_ints) out[f] = tile_at(walls, stride, f, hw, ch, cw);
}

}  // namespace maze_tree
