// dp_grid.cu — K4: grid-form value iteration and Howard policy iteration
// over N mazes.
//
// Replaces griduniverse_tpu/algos/dp_batched.py `_grid_backup` (390),
// `_vi_grid_impl` (422) and `_pi_grid_impl` (605). Per sweep and maze,
//   Q(s,a) = rew + γ·where(done, 0, where(blocked, V[s], V[cand])),
// rows of terminal cells are 0, and V_new is max_a Q (VI) or the policy's
// entry (PI evaluation). The JAX version turns `V[:, cand]` into a constant
// reindex because the TPU has no gather; here the candidate cell is row and
// column arithmetic and the lookup is one shared-memory load.
//
// Bound on the card: operations. A sweep reads and writes nothing but
// shared memory, so a solve moves each grid once in and V and the policy
// once out, and spends between them, a cell and sweep, a load, a multiply
// and an add an action, a max for each action after the first, |ΔV|, its
// maximum and the store: 18 operations at 4 actions (6 for an evaluation
// sweep). 16 VI sweeps over 65,536 9×9 mazes are thus at least 0.0457 ms on
// an H100 SXM (3.345e13 lane operations a second), against the 0.019 ms
// their bytes take; `chip_smoke.py` computes the bound from its own run
// and `PERF.md` §6 holds it beside the kernel's time.
//
// The shared-memory tier, up to 16,384 cells a maze. The wrapper's
// `packing` cuts the work: a maze of S ≤ 256 cells shares a block of 256
// threads with ⌊256 / S⌋ − 1 others (three 9×9 mazes a block), one thread
// a cell; a larger maze takes a block of its own, a thread ⌈S / 256⌉ cells
// (and its 13 bytes a cell fit at 16,384 cells). A block walks groups
// of mazes (blockIdx.x, then every gridDim.x-th), the grid being as many
// blocks as fit the card at once: one block a group instead took 1.7× as
// long at 65,536 9×9 mazes (`tools/k4_ablation.py`), as each block's
// reduction of its sweep maxima then runs once a group. For each group it
// derives, once, what a sweep needs of each (cell, action):
//   * one cell a thread: in registers, the index into the block's V of the
//     value the action continues from (a slot that always holds 0.0 where
//     the move ends the episode or the cell is terminal) and the reward (0
//     for a terminal cell), so an action is a load, a multiply, an add and
//     a max;
//   * several cells a thread, where it fits (the packing's `table`): the
//     same index and reward in shared memory, 6 bytes an action and cell;
//   * beyond (up to 16,384 cells): a 4-bit code an action in a word a cell
//     in shared memory (the kind of move, stay, move, cut or terminal, and
//     the reward's tile code; for PI the policy's action and its
//     neighbour): 13 bytes a cell.
// Then it runs `num_sweeps` Jacobi sweeps between two V buffers with one
// barrier a sweep: every V_new reads the old buffer, as the reference's
// `v_new = f(v)`. rew + γ·cont rounds twice (the file is built with
// -fmad=false), and cont is selected, never multiplied by 0, so V agrees
// bit for bit with the plain version.
//
// The stopping rule is global (max |ΔV| over ALL mazes). Each thread keeps
// its sweeps' maxima in registers; a block reduces them once, writes its
// row of a scratch, and the last block to finish (a ticket) takes the
// maximum of the rows into `maxima`, and sets the ticket back to 0. The
// maximum is exact in any order, so the maxima keep their bits; nothing is
// accumulated across launches, so nothing is zeroed before one. The greedy
// step reduces its `changed` flag the same way.
//
// Above 16,384 cells a maze no longer fits the shared tier's block, and
// the cluster tier takes it: one maze a thread-block cluster of k blocks
// (the wrapper's `cluster_plan`: the least k whose blocks' 227 KB hold a
// band of ⌈H / k⌉ rows at 12 bytes a cell, two V buffers and a word; k = 1
// up to about 19,000 cells, k = 2 at 161×129, at most 16, the H100's
// largest cluster, above 8 with the non-portable size allowed). Each block
// holds its band's V and words in its own shared memory; a cell on a
// band's edge reads its neighbour's V_old from the neighbour's block
// through distributed shared memory, and a cluster barrier separates the
// sweeps. Up to 16 sweeps a launch, as in the shared tier, with the same
// row-and-ticket reduction of the sweep maxima: the grids are read once a
// launch and V written once. A maze that needs more than 16 blocks keeps
// the global-memory tier: one thread per cell of all N mazes, the packed
// words and the second V buffer in a scratch the wrapper allocates. Nothing
// orders blocks within a launch there, so a sweep is one launch and the
// launch boundary is the barrier between Jacobi sweeps; the first sweep of
// a call derives each cell's word and stores it for the rest. That tier is
// bound by bytes: a sweep reads V and the words and writes V, 12 bytes a
// cell, from and to L2. A Jacobi sweep is order-free per cell, so V, the
// sweep maxima and the policy are the same bits in every tier and in the
// plain version. The greedy step above 16,384 cells is the global tier's,
// one launch a policy iteration, in either case.
//
// Above eight actions (kA = −1 in the shared tier, Tab = gu::WideTables in
// the global one) no action is kept decoded in registers or packed into a
// word: each sweep decodes every action from the tile codes where it uses
// it (one maze's table of decoded actions, where the packing keeps one,
// takes any A). The maximum runs over the actions in index order and each
// Q rounds as above, so the bits are the same.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "step.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;  // a block of the global tier
constexpr int kClusterThreads = 1024;  // a block of the cluster tier (512 took 1.34x as long)
constexpr int kMaxClusterBlocks = 16;  // the H100's largest cluster (8 is the portable one)
constexpr int kBlockMax = 256;    // a block of the shared tier at most
constexpr int kMinBlocks = 4;     // blocks an SM the shared tier's kernels are built for
constexpr int kMaxSweeps = 16;    // sweeps a shared-tier launch; `kernels.dp_grid.SWEEPS_A_LAUNCH`
constexpr int kTermBit = 24;      // info bit: the cell itself is terminal
constexpr int kPolicyShift = 25;  // info bits 25..27: the policy's action

extern __shared__ unsigned char smem_raw[];

struct GridArgs {
  const uint8_t* passable;
  const uint8_t* terminal;
  const float* reward;
  const int* deltas;
  int num_actions;
  const int* grids;  // (N, H, W) tile codes
  int h;
  int w;
  const int* policy;  // (N, S) or null
};

// ---------------------------------------------------------------------------
// The shared-memory tier
// ---------------------------------------------------------------------------

// What a backup of a cell takes from one action: kStay (blocked: V of the
// cell), kMove (V of the neighbour), kCut (the move ends the episode: 0),
// kTerminal (the cell itself is terminal: Q is 0).
enum : int { kStay = 0, kMove = 1, kCut = 2, kTerminal = 3 };

struct Action {
  int kind;
  int next;  // the cell whose V the action continues from (kStay, kMove)
  int code;  // the tile code after the move: the reward's index
};

// The shared tier's table for kA actions (4, up to 8 as 0, any as −1).
template <int kA>
using TablesOf = typename std::conditional<(kA < 0), gu::WideTables, gu::Tables>::type;

// Action `a` of cell s = (row, col), tile code `code`, of the maze whose
// tile codes are `codes`; bit for bit the reference's blocked / done /
// terminal masks.
// `codes` are the shared tier's bytes or the grid's own int32 tile codes
// (the cluster tier reads those), each taken to its two low bits.
template <typename Tab, typename Code>
__device__ __forceinline__ Action decode_action(const Tab& tab, const Code* codes, int h,
                                                int w, int s, int row, int col, int code, int a) {
  const int2 d = gu::delta(tab, a);
  const int nrow = row + d.x;
  const int ncol = col + d.y;
  const bool in_bounds = nrow >= 0 && nrow < h && ncol >= 0 && ncol < w;
  const int cand = min(max(nrow, 0), h - 1) * w + min(max(ncol, 0), w - 1);
  const int cand_code = static_cast<int>(codes[cand]) & 3;
  const bool blocked = !in_bounds || !((tab.passable >> cand_code) & 1);
  Action act;
  act.code = blocked ? code : cand_code;
  act.next = blocked ? s : cand;
  // blocked, the tile stays the cell's own: it ends the episode only where
  // the cell is terminal, which the first test takes
  act.kind = ((tab.terminal >> code) & 1)        ? kTerminal
             : blocked                           ? kStay
             : ((tab.terminal >> cand_code) & 1) ? kCut
                                                 : kMove;
  return act;
}

// The maxima of the block's threads, one a sweep, into red[k][warp].
__device__ __forceinline__ void warp_rows(const float (&m)[kMaxSweeps], float (*red)[32]) {
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) {
    float x = m[k];
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if ((threadIdx.x & 31) == 0) red[k][threadIdx.x >> 5] = x;
  }
}

__device__ __forceinline__ float row_max(const float* row, int n) {
  float x = 0.0f;
  for (int i = 0; i < n; ++i) x = fmaxf(x, row[i]);
  return x;
}

// The end of a sweeps launch: the block's maximum of each sweep goes to its
// row of `partial` (kMaxSweeps floats), and the last block to take a ticket
// writes the rows' maxima to `maxima` and sets the ticket back to 0.
__device__ void finish_sweep_maxima(const float (&mk)[kMaxSweeps], float (*red)[32], bool& last,
                                    float* __restrict__ partial, float* __restrict__ maxima,
                                    int num_sweeps, unsigned int* __restrict__ ticket) {
  const int warps = blockDim.x >> 5;
  warp_rows(mk, red);
  __syncthreads();
  if (threadIdx.x < kMaxSweeps) {
    partial[static_cast<size_t>(blockIdx.x) * kMaxSweeps + threadIdx.x] = row_max(red[threadIdx.x], warps);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float m[kMaxSweeps];
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) m[k] = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    const float4* row = reinterpret_cast<const float4*>(partial + static_cast<size_t>(b) * kMaxSweeps);
#pragma unroll
    for (int q = 0; q < kMaxSweeps / 4; ++q) {
      const float4 x = __ldcg(row + q);
      m[4 * q] = fmaxf(m[4 * q], x.x);
      m[4 * q + 1] = fmaxf(m[4 * q + 1], x.y);
      m[4 * q + 2] = fmaxf(m[4 * q + 2], x.z);
      m[4 * q + 3] = fmaxf(m[4 * q + 3], x.w);
    }
  }
  warp_rows(m, red);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < num_sweeps) maxima[threadIdx.x] = row_max(red[threadIdx.x], warps);
  if (threadIdx.x == 0) *ticket = 0u;
}

// The end of a greedy launch: `changed` is 1 where a thread of any block
// found a cell whose action differs from the given policy, else 0.
__device__ void finish_changed(bool differs, bool& last, int* __restrict__ partial,
                               int* __restrict__ changed, unsigned int* __restrict__ ticket) {
  const int any = __syncthreads_or(differs);
  if (threadIdx.x == 0) partial[blockIdx.x] = any;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int x = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) x |= __ldcg(partial + b);
  const int all = __syncthreads_or(x);
  if (threadIdx.x == 0) {
    *changed = all != 0;
    *ticket = 0u;
  }
}

// One cell a thread (the wrapper's packing for S ≤ 256): a group is
// `mazes` consecutive mazes, thread t its cell t. V and the codes live in
// dynamic shared memory, each V buffer with a slot `span` that holds 0.0.
template <int kA, bool kEval>
__global__ void __launch_bounds__(kBlockMax, kMinBlocks)
grid_sweeps_packed_kernel(GridArgs g, int n, int mazes, int cells, const float* __restrict__ v_in,
                          float* __restrict__ v_out, float gamma, int num_sweeps,
                          float* __restrict__ partial, float* __restrict__ maxima,
                          unsigned int* __restrict__ ticket) {
  // the actions a cell keeps: all of them (VI) or the policy's (PI
  // evaluation); none in the wide form's VI, which decodes them each sweep
  constexpr bool kDecode = kA < 0 && !kEval;
  constexpr int kN = kEval || kDecode ? 1 : (kA > 0 ? kA : gu::kMaxActions);
  __shared__ TablesOf<kA> tab;
  __shared__ float red[kMaxSweeps][32];
  __shared__ bool last;
  const int s_dim = g.h * g.w;
  const int span = mazes * s_dim;
  float* const v0 = reinterpret_cast<float*>(smem_raw);
  float* const v1 = v0 + span + 1;
  uint8_t* const codes = reinterpret_cast<uint8_t*>(v1 + span + 1);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (threadIdx.x == 0) {
    v0[span] = 0.0f;
    v1[span] = 0.0f;
  }
  const int num_actions = kA > 0 ? kA : g.num_actions;
  const int t = threadIdx.x;
  const int j = t / s_dim;  // the thread's maze in the group
  const int s = t - j * s_dim;
  const int row = s / g.w;
  const int col = s - row * g.w;
  const int base = j * s_dim;  // that maze's first cell in the block's buffers
  float mk[kMaxSweeps];
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) mk[k] = 0.0f;

  const int groups = (n + mazes - 1) / mazes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
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
    __syncthreads();  // the group's codes and V (and, the first time, the tables)
    int next[kN];
    float rew[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      next[i] = span;
      rew[i] = 0.0f;
      if (!kDecode && active && (kEval || kA > 0 || i < num_actions)) {
        const int a = kEval ? gu::clamp_action(chosen, num_actions) : i;
        const Action act = decode_action(tab, codes + base, g.h, g.w, s, row, col, code, a);
        if (act.kind == kStay || act.kind == kMove) next[i] = base + act.next;
        if (act.kind != kTerminal) rew[i] = tab.reward[act.code];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSweeps; ++k) {
      if (k < num_sweeps) {
        // sweep k reads what sweep k − 1 wrote: known at each unrolled k,
        // so the buffers' addresses are fixed and nothing is swapped
        const float* const v_old = (k & 1) ? v1 : v0;
        float* const v_new = (k & 1) ? v0 : v1;
        if (active) {
          float best;
          if constexpr (kDecode) {
            for (int a = 0; a < num_actions; ++a) {
              const Action act = decode_action(tab, codes + base, g.h, g.w, s, row, col, code, a);
              const float r = act.kind == kTerminal ? 0.0f : tab.reward[act.code];
              const float q = r + gamma * v_old[act.kind <= kMove ? base + act.next : span];
              best = a == 0 ? q : fmaxf(best, q);
            }
          } else {
            best = rew[0] + gamma * v_old[next[0]];
#pragma unroll
            for (int i = 1; i < kN; ++i) {
              if (kA > 0 || i < num_actions) best = fmaxf(best, rew[i] + gamma * v_old[next[i]]);
            }
          }
          v_new[t] = best;
          mk[k] = fmaxf(mk[k], fabsf(best - v_own));
          v_own = best;
        }
        __syncthreads();  // the sweep's V_new complete; the old buffer free
      }
    }
    if (active) v_out[at] = v_own;
  }
  finish_sweep_maxima(mk, red, last, partial, maxima, num_sweeps, ticket);
}

// Several cells a thread, one maze a group, where the decoded actions fit
// (the wrapper's packing says `table`): for each (action i, cell s) the
// cell its V comes from, `next[i·S + s]` (S, the 0.0 slot, where the move
// ends the episode or the cell is terminal), and the reward `rew[i·S + s]`
// (0 for a terminal cell), so an action is three shared loads, a
// multiply, an add and a max, as in the packed kernel. Thread t takes
// cells t + c·blockDim.x, c < `cells`.
template <int kA, bool kEval>
__global__ void __launch_bounds__(kBlockMax, kMinBlocks)
grid_sweeps_table_kernel(GridArgs g, int n, int mazes, int cells, const float* __restrict__ v_in,
                         float* __restrict__ v_out, float gamma, int num_sweeps,
                         float* __restrict__ partial, float* __restrict__ maxima,
                         unsigned int* __restrict__ ticket) {
  constexpr int kN = kEval ? 1 : (kA > 0 ? kA : gu::kMaxActions);
  __shared__ TablesOf<kA> tab;
  __shared__ float red[kMaxSweeps][32];
  __shared__ bool last;
  const int s_dim = g.h * g.w;
  const int num_actions = kA > 0 ? kA : g.num_actions;
  const int decoded = kEval ? 1 : num_actions;  // actions a cell keeps
  float* const v0 = reinterpret_cast<float*>(smem_raw);
  float* const v1 = v0 + s_dim + 1;
  float* const rew = v1 + s_dim + 1;
  uint16_t* const next = reinterpret_cast<uint16_t*>(rew + decoded * s_dim);
  uint8_t* const codes = reinterpret_cast<uint8_t*>(next + decoded * s_dim);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (threadIdx.x == 0) {
    v0[s_dim] = 0.0f;
    v1[s_dim] = 0.0f;
  }
  const int t = threadIdx.x;
  float mk[kMaxSweeps];
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) mk[k] = 0.0f;

  for (int m = blockIdx.x; m < n; m += gridDim.x) {
    const size_t base = static_cast<size_t>(m) * s_dim;
    for (int c = 0; c < cells; ++c) {
      const int s = t + c * blockDim.x;
      if (s < s_dim) {
        codes[s] = static_cast<uint8_t>(g.grids[base + s] & 3);
        v0[s] = v_in[base + s];
      }
    }
    __syncthreads();  // the maze's codes and V (and, the first time, the tables)
    for (int c = 0; c < cells; ++c) {  // a thread reads only its own cells' entries
      const int s = t + c * blockDim.x;
      if (s >= s_dim) break;
      const int row = s / g.w;
      const int col = s - row * g.w;
      const int code = codes[s];
      for (int i = 0; i < decoded; ++i) {
        const int a = kEval ? gu::clamp_action(g.policy[base + s], num_actions) : i;
        const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code, a);
        next[i * s_dim + s] = static_cast<uint16_t>(act.kind <= kMove ? act.next : s_dim);
        rew[i * s_dim + s] = act.kind == kTerminal ? 0.0f : tab.reward[act.code];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSweeps; ++k) {
      if (k < num_sweeps) {
        // sweep k reads what sweep k − 1 wrote: known at each unrolled k,
        // so the buffers' addresses are fixed and nothing is swapped
        const float* const v_old = (k & 1) ? v1 : v0;
        float* const v_new = (k & 1) ? v0 : v1;
        for (int c = 0; c < cells; ++c) {
          const int s = t + c * blockDim.x;
          if (s >= s_dim) break;
          float best = rew[s] + gamma * v_old[next[s]];
          if constexpr (kA < 0 && !kEval) {  // any number of actions, in index order
            for (int i = 1; i < num_actions; ++i) {
              best = fmaxf(best, rew[i * s_dim + s] + gamma * v_old[next[i * s_dim + s]]);
            }
          } else {
#pragma unroll
            for (int i = 1; i < kN; ++i) {
              if (kA > 0 || i < num_actions) {
                best = fmaxf(best, rew[i * s_dim + s] + gamma * v_old[next[i * s_dim + s]]);
              }
            }
          }
          v_new[s] = best;
          mk[k] = fmaxf(mk[k], fabsf(best - v_old[s]));
        }
        __syncthreads();  // the sweep's V_new complete; the old buffer free
      }
    }
    for (int c = 0; c < cells; ++c) {
      const int s = t + c * blockDim.x;
      if (s < s_dim) v_out[base + s] = ((num_sweeps & 1) ? v1 : v0)[s];
    }
  }
  finish_sweep_maxima(mk, red, last, partial, maxima, num_sweeps, ticket);
}

// Several cells a thread, one maze a group (`mazes` = 1), where the table
// does not fit: thread t takes
// cells t + c·blockDim.x, c < `cells`. Each cell's actions are one word in
// shared memory: 4 bits an action, (kind << 2) | tile code, the reward
// looked up in `rtab`; for PI evaluation the policy's action alone, with
// the cell its V comes from above bit 4.
template <int kA, bool kEval>
__global__ void __launch_bounds__(kBlockMax, kMinBlocks)
grid_sweeps_words_kernel(GridArgs g, int n, int mazes, int cells, const float* __restrict__ v_in,
                         float* __restrict__ v_out, float gamma, int num_sweeps,
                         float* __restrict__ partial, float* __restrict__ maxima,
                         unsigned int* __restrict__ ticket) {
  // the wide form's VI keeps no word: it decodes each action from the codes each sweep
  constexpr bool kDecode = kA < 0 && !kEval;
  constexpr int kN = kA > 0 ? kA : (kA == 0 ? gu::kMaxActions : 1);
  __shared__ TablesOf<kA> tab;
  __shared__ float red[kMaxSweeps][32];
  __shared__ float rtab[16];  // the reward of a 4-bit action code; 0 for kTerminal
  __shared__ bool last;
  const int s_dim = g.h * g.w;
  float* const v0 = reinterpret_cast<float*>(smem_raw);
  float* const v1 = v0 + s_dim;
  uint32_t* const words = reinterpret_cast<uint32_t*>(v1 + s_dim);
  uint8_t* const codes = reinterpret_cast<uint8_t*>(words + s_dim);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) rtab[i] = (i >> 2) == kTerminal ? 0.0f : tab.reward[i & 3];
  }
  __syncthreads();
  const int num_actions = kA > 0 ? kA : g.num_actions;
  const int t = threadIdx.x;
  int off[kN];  // the neighbour's offset of each action
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int2 d = kDecode || i >= num_actions ? make_int2(0, 0) : gu::delta(tab, i);
    off[i] = d.x * g.w + d.y;
  }
  float mk[kMaxSweeps];
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) mk[k] = 0.0f;

  for (int m = blockIdx.x; m < n; m += gridDim.x) {
    const size_t base = static_cast<size_t>(m) * s_dim;
    for (int c = 0; c < cells; ++c) {
      const int s = t + c * blockDim.x;
      if (s < s_dim) {
        codes[s] = static_cast<uint8_t>(g.grids[base + s] & 3);
        v0[s] = v_in[base + s];
      }
    }
    __syncthreads();  // the maze's codes and V
    for (int c = 0; c < cells; ++c) {  // a thread reads only its own cells' words
      const int s = t + c * blockDim.x;
      if (s >= s_dim) break;
      const int row = s / g.w;
      const int col = s - row * g.w;
      const int code = codes[s];
      uint32_t word = 0;
      if (kEval) {
        const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code,
                                         gu::clamp_action(g.policy[base + s], num_actions));
        word = static_cast<uint32_t>((act.kind << 2) | act.code) | (static_cast<uint32_t>(act.next) << 4);
      } else if (!kDecode) {
        for (int a = 0; a < num_actions; ++a) {
          const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code, a);
          word |= static_cast<uint32_t>((act.kind << 2) | act.code) << (4 * a);
        }
      }
      words[s] = word;
    }
#pragma unroll
    for (int k = 0; k < kMaxSweeps; ++k) {
      if (k < num_sweeps) {
        // sweep k reads what sweep k − 1 wrote: known at each unrolled k,
        // so the buffers' addresses are fixed and nothing is swapped
        const float* const v_old = (k & 1) ? v1 : v0;
        float* const v_new = (k & 1) ? v0 : v1;
        for (int c = 0; c < cells; ++c) {
          const int s = t + c * blockDim.x;
          if (s >= s_dim) break;
          const uint32_t word = words[s];
          float best;
          if constexpr (kDecode) {
            const int row = s / g.w;
            const int col = s - row * g.w;
            const int code = codes[s];
            for (int a = 0; a < num_actions; ++a) {
              const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code, a);
              const float r = act.kind == kTerminal ? 0.0f : tab.reward[act.code];
              const float q = r + gamma * (act.kind <= kMove ? v_old[act.next] : 0.0f);
              best = a == 0 ? q : fmaxf(best, q);
            }
          } else if (kEval) {
            const uint32_t nib = word & 15u;
            const float cont = (nib >> 2) >= kCut ? 0.0f : v_old[word >> 4];
            best = rtab[nib] + gamma * cont;
          } else {
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              if (kA > 0 || i < num_actions) {
                const uint32_t nib = (word >> (4 * i)) & 15u;
                const uint32_t kind = nib >> 2;
                const float v = v_old[kind == kMove ? s + off[i] : s];
                const float q = rtab[nib] + gamma * (kind >= kCut ? 0.0f : v);
                best = i == 0 ? q : fmaxf(best, q);
              }
            }
          }
          v_new[s] = best;
          mk[k] = fmaxf(mk[k], fabsf(best - v_old[s]));
        }
        __syncthreads();  // the sweep's V_new complete; the old buffer free
      }
    }
    for (int c = 0; c < cells; ++c) {
      const int s = t + c * blockDim.x;
      if (s < s_dim) v_out[base + s] = ((num_sweeps & 1) ? v1 : v0)[s];
    }
  }
  finish_sweep_maxima(mk, red, last, partial, maxima, num_sweeps, ticket);
}

// The improvement step of the shared tier, on the same packing: policy_out
// is argmax_a Q(s, a) under V (ties to the lowest action; 0 for a terminal
// cell, whose row is all 0). Cell lc = t + c·blockDim.x of a group's `span`
// cells; codes and V in shared memory.
template <int kA>
__global__ void __launch_bounds__(kBlockMax, kMinBlocks)
grid_greedy_shared_kernel(GridArgs g, int n, int mazes, int cells, const float* __restrict__ v_in,
                          float gamma, int* __restrict__ policy_out, int* __restrict__ partial,
                          int* __restrict__ changed, unsigned int* __restrict__ ticket) {
  __shared__ TablesOf<kA> tab;
  __shared__ bool last;
  const int s_dim = g.h * g.w;
  const int span = mazes * s_dim;
  float* const v = reinterpret_cast<float*>(smem_raw);
  uint8_t* const codes = reinterpret_cast<uint8_t*>(v + span);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  const int num_actions = kA > 0 ? kA : g.num_actions;
  const int t = threadIdx.x;
  bool differs = false;
  const int groups = (n + mazes - 1) / mazes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const size_t first = static_cast<size_t>(grp) * span;
    const int live = static_cast<int>(min(static_cast<long long>(span),
                                          (static_cast<long long>(n) - static_cast<long long>(grp) * mazes) * s_dim));
    for (int c = 0; c < cells; ++c) {
      const int lc = t + c * blockDim.x;
      if (lc < live) {
        codes[lc] = static_cast<uint8_t>(g.grids[first + lc] & 3);
        v[lc] = v_in[first + lc];
      }
    }
    __syncthreads();  // the group's codes and V (and, the first time, the tables)
    for (int c = 0; c < cells; ++c) {
      const int lc = t + c * blockDim.x;
      if (lc >= live) break;
      const int j = lc / s_dim;
      const int s = lc - j * s_dim;
      const int row = s / g.w;
      const int col = s - row * g.w;
      const int base = j * s_dim;
      const int code = codes[lc];
      int best = 0;
      float best_q = 0.0f;
#pragma unroll
      for (int a = 0; a < (kA > 0 ? kA : (kA == 0 ? gu::kMaxActions : num_actions)); ++a) {
        if (kA > 0 || a < num_actions) {
          const Action act = decode_action(tab, codes + base, g.h, g.w, s, row, col, code, a);
          const float cont = act.kind <= kMove ? v[base + act.next] : 0.0f;
          const float q = (act.kind == kTerminal ? 0.0f : tab.reward[act.code]) + gamma * cont;
          if (a == 0 || q > best_q) {
            best_q = q;
            best = a;
          }
        }
      }
      policy_out[first + lc] = best;
      if (g.policy != nullptr) differs |= best != g.policy[first + lc];
    }
    __syncthreads();  // the group's codes and V read before the next group's
  }
  finish_changed(differs, last, partial, changed, ticket);
}

// ---------------------------------------------------------------------------
// The cluster tier
// ---------------------------------------------------------------------------

// V_old of maze cell `c` in the cluster tier's bands (block b of the
// cluster holds cells [b·band, (b+1)·band)): from this block's buffer where
// the cell is its own (cells [first, first + mine)), else from its owner's
// buffer through distributed shared memory. The old buffer is written by
// no block during a sweep, so the read needs no other order.
__device__ __forceinline__ float v_of(const cg::cluster_group& cluster, const float* v_old, int c,
                                      int first, int mine, int band) {
  const int l = c - first;
  if (static_cast<unsigned>(l) < static_cast<unsigned>(mine)) return v_old[l];
  const int owner = c / band;
  return *cluster.map_shared_rank(v_old + (c - owner * band), owner);
}

// One maze a thread-block cluster of `rows`-row bands (the wrapper's
// `cluster_plan`): block `rank` of the cluster holds rows [rank·rows,
// (rank+1)·rows) of the maze, its two V buffers and a word a cell (the
// words kernel's encoding: 4 bits an action, or for PI evaluation the
// policy's action and its neighbour), 12 bytes a cell of dynamic shared
// memory. The words are derived once a launch from the grid's tile codes
// in device memory (a neighbour's code may lie in another band); the wide
// form's VI keeps no word and decodes each action from those codes each
// sweep. A cell on a band's edge reads its neighbour's V_old from the
// neighbour's block through distributed shared memory: a Jacobi sweep
// writes only the new buffer, so no halo is copied, and `cluster.sync()` is
// the barrier between sweeps. Thread t takes the band's cells t +
// c·kClusterThreads, c < `cells`. The grid is a whole number of clusters,
// each walking mazes (cluster index, then every clusters-th); the sweep
// maxima go through the shared tier's row-and-ticket reduction.
template <int kA, bool kEval>
__global__ void __launch_bounds__(kClusterThreads, 1)
grid_sweeps_cluster_kernel(GridArgs g, int n, int rows, int cells, const float* __restrict__ v_in,
                           float* __restrict__ v_out, float gamma, int num_sweeps,
                           float* __restrict__ partial, float* __restrict__ maxima,
                           unsigned int* __restrict__ ticket) {
  constexpr bool kDecode = kA < 0 && !kEval;
  constexpr int kN = kA > 0 ? kA : (kA == 0 ? gu::kMaxActions : 1);
  const cg::cluster_group cluster = cg::this_cluster();
  __shared__ TablesOf<kA> tab;
  __shared__ float red[kMaxSweeps][32];
  __shared__ float rtab[16];  // the reward of a 4-bit action code; 0 for kTerminal
  __shared__ bool last;
  const int s_dim = g.h * g.w;
  const int band = rows * g.w;
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int first = static_cast<int>(cluster.block_rank()) * band;
  const int mine = min(band, s_dim - first);
  float* const v0 = reinterpret_cast<float*>(smem_raw);
  float* const v1 = v0 + band;
  uint32_t* const words = reinterpret_cast<uint32_t*>(v1 + band);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) rtab[i] = (i >> 2) == kTerminal ? 0.0f : tab.reward[i & 3];
  }
  __syncthreads();
  const int num_actions = kA > 0 ? kA : g.num_actions;
  const int t = threadIdx.x;
  int off[kN];  // the neighbour's offset of each action
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int2 d = kDecode || kEval || i >= num_actions ? make_int2(0, 0) : gu::delta(tab, i);
    off[i] = d.x * g.w + d.y;
  }
  float mk[kMaxSweeps];
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) mk[k] = 0.0f;

  const int clusters = static_cast<int>(gridDim.x) / blocks;
  for (int m = static_cast<int>(blockIdx.x) / blocks; m < n; m += clusters) {
    const size_t base = static_cast<size_t>(m) * s_dim;
    const int* const codes = g.grids + base;
    for (int c = 0; c < cells; ++c) {  // the band's V and words
      const int l = t + c * kClusterThreads;
      if (l >= mine) break;
      const int s = first + l;
      v0[l] = v_in[base + s];
      const int row = s / g.w;
      const int col = s - row * g.w;
      const int code = codes[s] & 3;
      uint32_t word = 0;
      if (kEval) {
        const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code,
                                         gu::clamp_action(g.policy[base + s], num_actions));
        word = static_cast<uint32_t>((act.kind << 2) | act.code) | (static_cast<uint32_t>(act.next) << 4);
      } else if (!kDecode) {
        for (int a = 0; a < num_actions; ++a) {
          const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code, a);
          word |= static_cast<uint32_t>((act.kind << 2) | act.code) << (4 * a);
        }
      }
      words[l] = word;
    }
    cluster.sync();  // every band's V in, and every block of the cluster running
#pragma unroll
    for (int k = 0; k < kMaxSweeps; ++k) {
      if (k < num_sweeps) {
        const float* const v_old = (k & 1) ? v1 : v0;
        float* const v_new = (k & 1) ? v0 : v1;
        for (int c = 0; c < cells; ++c) {
          const int l = t + c * kClusterThreads;
          if (l >= mine) break;
          const int s = first + l;
          const uint32_t word = words[l];
          float best;
          if constexpr (kDecode) {
            const int row = s / g.w;
            const int col = s - row * g.w;
            const int code = codes[s] & 3;
            for (int a = 0; a < num_actions; ++a) {
              const Action act = decode_action(tab, codes, g.h, g.w, s, row, col, code, a);
              const float r = act.kind == kTerminal ? 0.0f : tab.reward[act.code];
              const float q = r + gamma * (act.kind <= kMove ? v_of(cluster, v_old, act.next, first, mine, band) : 0.0f);
              best = a == 0 ? q : fmaxf(best, q);
            }
          } else if (kEval) {
            const uint32_t nib = word & 15u;
            const float cont = (nib >> 2) >= kCut ? 0.0f : v_of(cluster, v_old, static_cast<int>(word >> 4), first, mine, band);
            best = rtab[nib] + gamma * cont;
          } else {
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              if (kA > 0 || i < num_actions) {
                const uint32_t nib = (word >> (4 * i)) & 15u;
                const uint32_t kind = nib >> 2;
                const float v = kind == kMove ? v_of(cluster, v_old, s + off[i], first, mine, band) : v_old[l];
                const float q = rtab[nib] + gamma * (kind >= kCut ? 0.0f : v);
                best = i == 0 ? q : fmaxf(best, q);
              }
            }
          }
          v_new[l] = best;
          mk[k] = fmaxf(mk[k], fabsf(best - v_old[l]));
        }
        cluster.sync();  // the sweep's V_new complete in every band; the old buffers free
      }
    }
    for (int c = 0; c < cells; ++c) {
      const int l = t + c * kClusterThreads;
      if (l >= mine) break;
      v_out[base + first + l] = ((num_sweeps & 1) ? v1 : v0)[l];
    }
  }
  finish_sweep_maxima(mk, red, last, partial, maxima, num_sweeps, ticket);
}

// ---------------------------------------------------------------------------
// The global-memory tier
// ---------------------------------------------------------------------------

// The packed word of cell `s` of the maze whose tile codes are `codes`
// (the low two bits of each entry) and whose policy row is `policy` (or
// null).
template <typename Code>
__device__ uint32_t cell_word(const GridArgs& g, const gu::Tables& tab, const Code* codes,
                              const int* policy, int s) {
  const int row = s / g.w;
  const int col = s - row * g.w;
  const int code = static_cast<int>(codes[s]) & 3;
  uint32_t word = 0;
  for (int a = 0; a < tab.num_actions; ++a) {
    const int nrow = row + tab.drow[a];
    const int ncol = col + tab.dcol[a];
    const bool in_bounds = nrow >= 0 && nrow < g.h && ncol >= 0 && ncol < g.w;
    const int cand = min(max(nrow, 0), g.h - 1) * g.w + min(max(ncol, 0), g.w - 1);
    const int cand_code = static_cast<int>(codes[cand]) & 3;
    const bool blocked = !in_bounds || !((tab.passable >> cand_code) & 1);
    const uint32_t new_code = blocked ? code : cand_code;
    word |= (static_cast<uint32_t>(blocked) | (new_code << 1)) << (3 * a);
  }
  word |= static_cast<uint32_t>((tab.terminal >> code) & 1) << kTermBit;
  if (policy != nullptr) {
    const int a = gu::clamp_action(policy[s], tab.num_actions);
    word |= static_cast<uint32_t>(a) << kPolicyShift;
  }
  return word;
}

// Q(s, a) of the backup, from the packed word and the old V.
__device__ __forceinline__ float q_value(const gu::Tables& tab, uint32_t word, int a, int s,
                                         int w, const float* v, float gamma) {
  const uint32_t bits = (word >> (3 * a)) & 7u;
  const int new_code = bits >> 1;
  const int next = (bits & 1u) ? s : s + tab.drow[a] * w + tab.dcol[a];
  const float cont = ((tab.terminal >> new_code) & 1) ? 0.0f : v[next];
  return tab.reward[new_code] + gamma * cont;
}

// V_new of one cell: the policy's action value (PI evaluation) or the
// maximum over actions (VI); 0 for a terminal cell.
__device__ __forceinline__ float cell_backup(const gu::Tables& tab, uint32_t word, int s, int w,
                                             const float* v, float gamma, bool evaluate) {
  if ((word >> kTermBit) & 1u) return 0.0f;
  if (evaluate) return q_value(tab, word, (word >> kPolicyShift) & 7u, s, w, v, gamma);
  float best = q_value(tab, word, 0, s, w, v, gamma);
  for (int a = 1; a < tab.num_actions; ++a) best = fmaxf(best, q_value(tab, word, a, s, w, v, gamma));
  return best;
}

// The greedy action of one cell under v: the first maximum, 0 if terminal.
__device__ __forceinline__ int cell_greedy(const gu::Tables& tab, uint32_t word, int s, int w,
                                           const float* v, float gamma) {
  int best = 0;
  if (!((word >> kTermBit) & 1u)) {
    float best_q = q_value(tab, word, 0, s, w, v, gamma);
    for (int a = 1; a < tab.num_actions; ++a) {
      const float q = q_value(tab, word, a, s, w, v, gamma);
      if (q > best_q) {
        best_q = q;
        best = a;
      }
    }
  }
  return best;
}

// The wide form (any number of actions): Q(s, a) decoded from the tile
// codes where it is used, the same arithmetic as `q_value` on its word.
__device__ __forceinline__ float q_decoded(const GridArgs& g, const gu::WideTables& tab, const int* codes,
                                           int s, int row, int col, int code, int a, const float* v,
                                           float gamma) {
  const int2 d = gu::delta(tab, a);
  const int nrow = row + d.x;
  const int ncol = col + d.y;
  const bool in_bounds = nrow >= 0 && nrow < g.h && ncol >= 0 && ncol < g.w;
  const int cand = min(max(nrow, 0), g.h - 1) * g.w + min(max(ncol, 0), g.w - 1);
  const int cand_code = codes[cand] & 3;
  const bool blocked = !in_bounds || !((tab.passable >> cand_code) & 1);
  const int new_code = blocked ? code : cand_code;
  const float cont = ((tab.terminal >> new_code) & 1) ? 0.0f : v[blocked ? s : cand];
  return tab.reward[new_code] + gamma * cont;
}

// `cell_backup` (policy: the maze's row, or null for VI) and `cell_greedy`
// of the wide form.
__device__ __forceinline__ float cell_backup_decoded(const GridArgs& g, const gu::WideTables& tab,
                                                     const int* codes, const int* policy, int s,
                                                     const float* v, float gamma) {
  const int row = s / g.w, col = s - (s / g.w) * g.w, code = codes[s] & 3;
  if ((tab.terminal >> code) & 1) return 0.0f;
  if (policy != nullptr) {
    return q_decoded(g, tab, codes, s, row, col, code, gu::clamp_action(policy[s], tab.num_actions), v, gamma);
  }
  float best = q_decoded(g, tab, codes, s, row, col, code, 0, v, gamma);
  for (int a = 1; a < tab.num_actions; ++a) best = fmaxf(best, q_decoded(g, tab, codes, s, row, col, code, a, v, gamma));
  return best;
}

__device__ __forceinline__ int cell_greedy_decoded(const GridArgs& g, const gu::WideTables& tab,
                                                   const int* codes, int s, const float* v, float gamma) {
  const int row = s / g.w, col = s - (s / g.w) * g.w, code = codes[s] & 3;
  int best = 0;
  if (!((tab.terminal >> code) & 1)) {
    float best_q = q_decoded(g, tab, codes, s, row, col, code, 0, v, gamma);
    for (int a = 1; a < tab.num_actions; ++a) {
      const float q = q_decoded(g, tab, codes, s, row, col, code, a, v, gamma);
      if (q > best_q) {
        best_q = q;
        best = a;
      }
    }
  }
  return best;
}

__device__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;  // valid in thread 0
}

// The global-memory tier: one sweep over every cell of the N mazes, one
// thread a cell. With `build` the thread derives its cell's word and stores
// it in `info`; later sweeps of the call read it back. The wide form (Tab =
// gu::WideTables) keeps no word and decodes from the tile codes each sweep.
template <typename Tab>
__global__ void grid_sweep_global_kernel(GridArgs g, int n, const float* __restrict__ v_old,
                                         float* __restrict__ v_new, uint32_t* __restrict__ info,
                                         int build, float gamma,
                                         unsigned int* __restrict__ sweep_max) {
  __shared__ Tab tab;
  __shared__ float red[32];
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  const int s_dim = g.h * g.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float local = 0.0f;
  if (i < n * s_dim) {
    const int m = i / s_dim;
    const int s = i - m * s_dim;
    const size_t base = static_cast<size_t>(m) * s_dim;
    float v;
    if constexpr (Tab::kWide) {
      v = cell_backup_decoded(g, tab, g.grids + base, g.policy != nullptr ? g.policy + base : nullptr, s,
                              v_old + base, gamma);
    } else {
      uint32_t word;
      if (build) {
        word = cell_word(g, tab, g.grids + base, g.policy != nullptr ? g.policy + base : nullptr, s);
        info[i] = word;
      } else {
        word = info[i];
      }
      v = cell_backup(tab, word, s, g.w, v_old + base, gamma, g.policy != nullptr);
    }
    v_new[i] = v;
    local = fabsf(v - v_old[i]);
  }
  const float mx = block_max(local, red);  // every thread of the block takes part
  if (threadIdx.x == 0) atomicMax(sweep_max, __float_as_uint(mx));
}

// The global-memory tier of the improvement step, one thread a cell.
template <typename Tab>
__global__ void grid_greedy_global_kernel(GridArgs g, int n, const float* __restrict__ v,
                                          float gamma, int* __restrict__ policy_out,
                                          int* __restrict__ changed) {
  __shared__ Tab tab;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  const int s_dim = g.h * g.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool differs = false;
  if (i < n * s_dim) {
    const int m = i / s_dim;
    const int s = i - m * s_dim;
    const size_t base = static_cast<size_t>(m) * s_dim;
    int best;
    if constexpr (Tab::kWide) {
      best = cell_greedy_decoded(g, tab, g.grids + base, s, v + base, gamma);
    } else {
      const uint32_t word = cell_word(g, tab, g.grids + base, static_cast<const int*>(nullptr), s);
      best = cell_greedy(tab, word, s, g.w, v + base, gamma);
    }
    policy_out[i] = best;
    if (g.policy != nullptr) differs = best != g.policy[i];
  }
  if (g.policy != nullptr && __syncthreads_or(differs) && threadIdx.x == 0) {
    atomicOr(changed, 1);
  }
}

GridArgs grid_args(const void* passable, const void* terminal, const void* reward,
                   const void* deltas, int num_actions, const void* grids, int h, int w,
                   const void* policy) {
  return GridArgs{static_cast<const uint8_t*>(passable),
                  static_cast<const uint8_t*>(terminal),
                  static_cast<const float*>(reward),
                  static_cast<const int*>(deltas),
                  num_actions,
                  static_cast<const int*>(grids),
                  h,
                  w,
                  static_cast<const int*>(policy)};
}

// How many blocks of `fn` at `threads` and `bytes` of dynamic shared memory
// the card holds at once (blocks an SM × SMs). Found once a (kernel,
// device, threads, bytes) and kept; the kernel's dynamic shared-memory
// limit is raised once too, to the most it was asked for.
struct Resident {
  const void* fn;
  int device;
  int threads;
  size_t bytes;
  int blocks;
};
std::mutex resident_mu;
Resident resident_seen[64];
int resident_count = 0;

cudaError_t resident_blocks(const void* fn, int threads, size_t bytes, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(resident_mu);
  size_t raised = 0;  // this kernel's limit on this device, as set so far
  for (int i = 0; i < resident_count; ++i) {
    const Resident& r = resident_seen[i];
    if (r.fn != fn || r.device != device) continue;
    if (r.threads == threads && r.bytes == bytes) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
    raised = r.bytes > raised ? r.bytes : raised;
  }
  if (bytes > 48 * 1024 && bytes > raised) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  // the limit raised stays raised, so an entry may be dropped when the table is full
  resident_seen[resident_count < 64 ? resident_count++ : 0] = Resident{fn, device, threads, bytes, *blocks};
  return cudaSuccess;
}

size_t round16(size_t bytes) { return (bytes + 15) & ~static_cast<size_t>(15); }

// The cluster tier's kernel `fn` on the current device: its dynamic
// shared-memory limit raised to `bytes` and, for `nonportable`, clusters
// above eight blocks allowed, each set once (kept as `resident_seen` keeps
// the other tiers'), so that a launch that needs nothing new, as a captured
// one after its warm-up, calls no attribute setter.
struct ClusterAttrs {
  const void* fn;
  int device;
  size_t bytes;
  bool nonportable;
};
ClusterAttrs cluster_seen[32];
int cluster_count = 0;

cudaError_t cluster_attributes(const void* fn, size_t bytes, bool nonportable) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(resident_mu);
  ClusterAttrs* seen = nullptr;
  for (int i = 0; i < cluster_count; ++i) {
    if (cluster_seen[i].fn == fn && cluster_seen[i].device == device) seen = &cluster_seen[i];
  }
  if (seen == nullptr) {
    if (cluster_count == 32) return cudaErrorInvalidValue;  // more (kernel, device) pairs than there are
    seen = &cluster_seen[cluster_count++];
    *seen = ClusterAttrs{fn, device, 0, false};
  }
  if (bytes > seen->bytes) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    seen->bytes = bytes;
  }
  if (nonportable && !seen->nonportable) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    seen->nonportable = true;
  }
  return cudaSuccess;
}

using SweepsKernel = void (*)(GridArgs, int, int, int, const float*, float*, float, int, float*,
                              float*, unsigned int*);

enum : int { kPacked = 0, kTable = 1, kWords = 2 };  // the packing's way to keep the actions

template <int kA>
SweepsKernel sweeps_kernel(int tier, bool evaluate) {
  if (tier == kPacked) return evaluate ? grid_sweeps_packed_kernel<kA, true> : grid_sweeps_packed_kernel<kA, false>;
  if (tier == kTable) return evaluate ? grid_sweeps_table_kernel<kA, true> : grid_sweeps_table_kernel<kA, false>;
  return evaluate ? grid_sweeps_words_kernel<kA, true> : grid_sweeps_words_kernel<kA, false>;
}

}  // namespace

// The shared tier: `num_sweeps` (≤ kMaxSweeps) sweeps in one launch, with
// the wrapper's packing (`mazes` a group, `threads` a block, `cells` a
// thread, `table` where several cells a thread keep decoded actions). `partial` holds `partial_rows` rows of kMaxSweeps floats (the
// blocks' maxima; the grid takes no more blocks than that); `ticket` is one
// unsigned int that is 0 before the launch and after it.
extern "C" int gu_grid_sweeps(const void* passable, const void* terminal, const void* reward,
                              const void* deltas, int num_actions, const void* grids, int n, int h,
                              int w, const void* policy, const void* v_in, void* v_out, float gamma,
                              int num_sweeps, int mazes, int threads, int cells, int table,
                              void* partial, int partial_rows, void* maxima, void* ticket,
                              void* stream) {
  if (num_sweeps < 1 || num_sweeps > kMaxSweeps || threads > kBlockMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t s_dim = static_cast<size_t>(h) * w;
  const int tier = cells == 1 ? kPacked : table ? kTable : kWords;
  const size_t span = static_cast<size_t>(mazes) * s_dim;
  const size_t decoded = policy != nullptr ? 1 : num_actions;
  // two V buffers (each with its 0.0 slot) and the codes; and for the
  // table, a float and a uint16 an action and cell; for the words, a word
  // a cell (and no 0.0 slot)
  const size_t bytes = round16(tier == kPacked ? 2 * (span + 1) * sizeof(float) + span
                               : tier == kTable ? 2 * (s_dim + 1) * sizeof(float) + decoded * s_dim * 6 + s_dim
                                                : s_dim * 13);
  const SweepsKernel fn = num_actions == 4               ? sweeps_kernel<4>(tier, policy != nullptr)
                          : num_actions > gu::kMaxActions ? sweeps_kernel<-1>(tier, policy != nullptr)
                                                          : sweeps_kernel<0>(tier, policy != nullptr);
  int blocks = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(fn), threads, bytes, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + mazes - 1) / mazes;
  blocks = std::min(std::min(blocks, groups), partial_rows);
  fn<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy), n, mazes,
      cells, static_cast<const float*>(v_in), static_cast<float*>(v_out), gamma, num_sweeps,
      static_cast<float*>(partial), static_cast<float*>(maxima), static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// The shared tier's improvement step, on the same packing; `partial` holds
// `partial_rows` ints, `ticket` as in `gu_grid_sweeps`. `changed` (one int)
// is written: 1 if the greedy policy differs anywhere from `policy`, else 0.
extern "C" int gu_grid_greedy(const void* passable, const void* terminal, const void* reward,
                              const void* deltas, int num_actions, const void* grids, int n, int h,
                              int w, const void* policy, const void* v_in, float gamma,
                              void* policy_out, void* changed, int mazes, int threads, int cells,
                              void* partial, int partial_rows, void* ticket, void* stream) {
  if (threads > kBlockMax) return static_cast<int>(cudaErrorInvalidValue);
  const size_t span = static_cast<size_t>(mazes) * h * w;
  const size_t bytes = round16(span * (sizeof(float) + 1));
  using GreedyKernel = void (*)(GridArgs, int, int, int, const float*, float, int*, int*, int*,
                                unsigned int*);
  const GreedyKernel fn = num_actions == 4               ? grid_greedy_shared_kernel<4>
                          : num_actions > gu::kMaxActions ? grid_greedy_shared_kernel<-1>
                                                          : grid_greedy_shared_kernel<0>;
  int blocks = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(fn), threads, bytes, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + mazes - 1) / mazes;
  blocks = std::min(std::min(blocks, groups), partial_rows);
  fn<<<blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy), n, mazes,
      cells, static_cast<const float*>(v_in), gamma, static_cast<int*>(policy_out),
      static_cast<int*>(partial), static_cast<int*>(changed), static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// The cluster tier: `num_sweeps` (≤ kMaxSweeps) sweeps in one launch of
// clusters of `blocks` blocks of kClusterThreads threads, one maze a
// cluster, `rows` rows a band and `cells` cells a thread (the wrapper's
// `cluster_plan`); `partial`, `maxima` and `ticket` as in
// `gu_grid_sweeps`. The grid takes min(n, partial_rows / blocks) clusters.
// A launch the card refuses returns its error.
extern "C" int gu_grid_sweeps_cluster(const void* passable, const void* terminal, const void* reward,
                                      const void* deltas, int num_actions, const void* grids, int n,
                                      int h, int w, const void* policy, const void* v_in, void* v_out,
                                      float gamma, int num_sweeps, int blocks, int rows, int cells,
                                      void* partial, int partial_rows, void* maxima, void* ticket,
                                      void* stream) {
  const long long band = static_cast<long long>(rows) * w;
  if (num_sweeps < 1 || num_sweeps > kMaxSweeps || blocks < 1 || blocks > kMaxClusterBlocks ||
      partial_rows < blocks || static_cast<long long>(blocks - 1) * rows >= h ||
      static_cast<long long>(blocks) * rows < h || band > static_cast<long long>(cells) * kClusterThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Kernel = void (*)(GridArgs, int, int, int, const float*, float*, float, int, float*, float*,
                          unsigned int*);
  const bool eval = policy != nullptr;
  const Kernel fn = num_actions == 4 ? (eval ? grid_sweeps_cluster_kernel<4, true> : grid_sweeps_cluster_kernel<4, false>)
                    : num_actions > gu::kMaxActions
                        ? (eval ? grid_sweeps_cluster_kernel<-1, true> : grid_sweeps_cluster_kernel<-1, false>)
                        : (eval ? grid_sweeps_cluster_kernel<0, true> : grid_sweeps_cluster_kernel<0, false>);
  // two V buffers and a word a cell of the band
  const size_t bytes = round16(static_cast<size_t>(band) * 12);
  cudaError_t err = cluster_attributes(reinterpret_cast<const void*>(fn), bytes, blocks > 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = std::min(n, partial_rows / blocks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy),
                           n, rows, cells, static_cast<const float*>(v_in), static_cast<float*>(v_out), gamma,
                           num_sweeps, static_cast<float*>(partial), static_cast<float*>(maxima),
                           static_cast<unsigned int*>(ticket));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The global-memory tier of `gu_grid_sweeps`: `num_sweeps` launches, one a
// sweep, ping-ponging between `v_tmp` and `v_out` so that the last lands in
// `v_out`. `info` is scratch of N·S words; `sweep_max` is zeroed here.
extern "C" int gu_grid_sweeps_global(const void* passable, const void* terminal,
                                     const void* reward, const void* deltas, int num_actions,
                                     const void* grids, int n, int h, int w, const void* policy,
                                     const void* v_in, void* v_out, void* v_tmp, void* info,
                                     float gamma, int num_sweeps, void* sweep_max,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(sweep_max, 0, sizeof(unsigned int) * num_sweeps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GridArgs g = grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy);
  const int blocks = static_cast<int>((static_cast<long long>(n) * h * w + kMaxThreads - 1) / kMaxThreads);
  const float* src = static_cast<const float*>(v_in);
  for (int k = 0; k < num_sweeps; ++k) {
    float* dst = static_cast<float*>((num_sweeps - 1 - k) % 2 == 0 ? v_out : v_tmp);
    auto* kernel = num_actions > gu::kMaxActions ? grid_sweep_global_kernel<gu::WideTables>
                                                 : grid_sweep_global_kernel<gu::Tables>;
    kernel<<<blocks, kMaxThreads, 0, st>>>(g, n, src, dst, static_cast<uint32_t*>(info), k == 0, gamma,
                                           static_cast<unsigned int*>(sweep_max) + k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// The global-memory tier of `gu_grid_greedy`; `changed` is zeroed here.
extern "C" int gu_grid_greedy_global(const void* passable, const void* terminal,
                                     const void* reward, const void* deltas, int num_actions,
                                     const void* grids, int n, int h, int w, const void* policy,
                                     const void* v_in, float gamma, void* policy_out,
                                     void* changed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((static_cast<long long>(n) * h * w + kMaxThreads - 1) / kMaxThreads);
  auto* kernel = num_actions > gu::kMaxActions ? grid_greedy_global_kernel<gu::WideTables>
                                               : grid_greedy_global_kernel<gu::Tables>;
  kernel<<<blocks, kMaxThreads, 0, st>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy), n,
      static_cast<const float*>(v_in), gamma, static_cast<int*>(policy_out),
      static_cast<int*>(changed));
  return static_cast<int>(cudaGetLastError());
}
