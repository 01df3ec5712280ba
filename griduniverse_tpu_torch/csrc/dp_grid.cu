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
// once out, and spends sweeps·N·S·A multiply-add-compare steps in between.
//
// Design: one block per maze. The block derives, once per launch, a packed
// word per cell (per action: blocked bit and the tile code after the move;
// the cell's terminal bit; the policy's action) and keeps it with two V
// buffers in dynamic shared memory (12 bytes a cell). A launch runs
// `num_sweeps` Jacobi sweeps: every V_new[s] reads the old buffer, then the
// buffers swap, as the reference's `v_new = f(v)`. The stopping rule is
// global (max |ΔV| over ALL mazes), so each sweep's block maximum goes to
// `sweep_max[k]` by atomicMax on the float's bits, which is exact and
// order-free for non-negative floats; the host reads the launch's maxima
// once and decides. The file is built with -fmad=false: `rew + γ·cont` is
// two roundings, as in the plain version, so V agrees bit for bit.
//
// Above 16,384 cells a maze no longer fits one block's shared memory, and
// a second, global-memory tier takes over: one thread per cell of all N
// mazes, the packed words and the second V buffer in a scratch the wrapper
// allocates (N·S·8 bytes beside V itself; 6.7 MB in all for 64 mazes of
// 161×161, which stays in the 50 MB L2). Nothing orders blocks within a
// launch, so a sweep is one launch and the launch boundary is the barrier
// between Jacobi sweeps; the first sweep of a call derives each cell's word
// and stores it for the rest. A Jacobi sweep is order-free per cell, so V,
// the sweep maxima and the policy are the same bits as in the shared tier
// and in the plain version. This tier is bound by bytes: a sweep reads V
// and the words and writes V, 12 bytes a cell, from and to L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTermBit = 24;    // info bit: the cell itself is terminal
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

// Fills `info[s]` for the block's maze; `codes` is scratch of S bytes.
__device__ void build_info(const GridArgs& g, const gu::Tables& tab, uint32_t* info,
                           uint8_t* codes) {
  const int s_dim = g.h * g.w;
  const size_t base = static_cast<size_t>(blockIdx.x) * s_dim;
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) {
    codes[s] = static_cast<uint8_t>(g.grids[base + s] & 3);
  }
  __syncthreads();
  const int* policy = g.policy != nullptr ? g.policy + base : nullptr;
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) {
    info[s] = cell_word(g, tab, codes, policy, s);
  }
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

// `num_sweeps` Jacobi sweeps from v_in to v_out. With a policy the sweep
// takes that action's value (PI evaluation), else the maximum (VI).
__global__ void grid_sweeps_kernel(GridArgs g, const float* __restrict__ v_in,
                                   float* __restrict__ v_out, float gamma, int num_sweeps,
                                   unsigned int* __restrict__ sweep_max) {
  __shared__ gu::Tables tab;
  __shared__ float red[32];
  const int s_dim = g.h * g.w;
  float* v_old = reinterpret_cast<float*>(smem_raw);
  float* v_new = v_old + s_dim;
  uint32_t* info = reinterpret_cast<uint32_t*>(v_new + s_dim);
  uint8_t* codes = reinterpret_cast<uint8_t*>(info + s_dim);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  build_info(g, tab, info, codes);
  const size_t base = static_cast<size_t>(blockIdx.x) * s_dim;
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) v_old[s] = v_in[base + s];
  __syncthreads();

  const bool evaluate = g.policy != nullptr;
  for (int k = 0; k < num_sweeps; ++k) {
    float local = 0.0f;
    for (int s = threadIdx.x; s < s_dim; s += blockDim.x) {
      const float v = cell_backup(tab, info[s], s, g.w, v_old, gamma, evaluate);
      v_new[s] = v;
      local = fmaxf(local, fabsf(v - v_old[s]));
    }
    const float m = block_max(local, red);
    if (threadIdx.x == 0) atomicMax(&sweep_max[k], __float_as_uint(m));
    __syncthreads();  // v_new complete, red free again
    float* tmp = v_old;
    v_old = v_new;
    v_new = tmp;
  }
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) v_out[base + s] = v_old[s];
}

// policy_out[s] = argmax_a Q(s, a) under v (ties to the lowest action;
// terminal rows are all 0, so 0). With a policy in `g`, `changed` is set
// to 1 if any cell of any maze differs from it.
__global__ void grid_greedy_kernel(GridArgs g, const float* __restrict__ v_in, float gamma,
                                   int* __restrict__ policy_out, int* __restrict__ changed) {
  __shared__ gu::Tables tab;
  const int s_dim = g.h * g.w;
  float* v = reinterpret_cast<float*>(smem_raw);
  uint32_t* info = reinterpret_cast<uint32_t*>(v + 2 * s_dim);
  uint8_t* codes = reinterpret_cast<uint8_t*>(info + s_dim);
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  build_info(g, tab, info, codes);
  const size_t base = static_cast<size_t>(blockIdx.x) * s_dim;
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) v[s] = v_in[base + s];
  __syncthreads();

  bool differs = false;
  for (int s = threadIdx.x; s < s_dim; s += blockDim.x) {
    const int best = cell_greedy(tab, info[s], s, g.w, v, gamma);
    policy_out[base + s] = best;
    if (g.policy != nullptr) differs |= best != g.policy[base + s];
  }
  if (g.policy != nullptr && __syncthreads_or(differs) && threadIdx.x == 0) {
    atomicOr(changed, 1);
  }
}

// The global-memory tier: one sweep over every cell of the N mazes, one
// thread a cell. With `build` the thread derives its cell's word and stores
// it in `info`; later sweeps of the call read it back.
__global__ void grid_sweep_global_kernel(GridArgs g, int n, const float* __restrict__ v_old,
                                         float* __restrict__ v_new, uint32_t* __restrict__ info,
                                         int build, float gamma,
                                         unsigned int* __restrict__ sweep_max) {
  __shared__ gu::Tables tab;
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
    uint32_t word;
    if (build) {
      word = cell_word(g, tab, g.grids + base, g.policy != nullptr ? g.policy + base : nullptr, s);
      info[i] = word;
    } else {
      word = info[i];
    }
    const float v = cell_backup(tab, word, s, g.w, v_old + base, gamma, g.policy != nullptr);
    v_new[i] = v;
    local = fabsf(v - v_old[i]);
  }
  const float mx = block_max(local, red);  // every thread of the block takes part
  if (threadIdx.x == 0) atomicMax(sweep_max, __float_as_uint(mx));
}

// The global-memory tier of the improvement step, one thread a cell.
__global__ void grid_greedy_global_kernel(GridArgs g, int n, const float* __restrict__ v,
                                          float gamma, int* __restrict__ policy_out,
                                          int* __restrict__ changed) {
  __shared__ gu::Tables tab;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  const int s_dim = g.h * g.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool differs = false;
  if (i < n * s_dim) {
    const int m = i / s_dim;
    const int s = i - m * s_dim;
    const size_t base = static_cast<size_t>(m) * s_dim;
    const uint32_t word = cell_word(g, tab, g.grids + base, static_cast<const int*>(nullptr), s);
    const int best = cell_greedy(tab, word, s, g.w, v + base, gamma);
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

// two V buffers, the packed words and the codes; rounded up to 16 bytes
size_t grid_smem_bytes(int s_dim) {
  return (static_cast<size_t>(s_dim) * 13 + 15) & ~static_cast<size_t>(15);
}

// whole warps, no more than the maze has cells
int grid_threads(int s_dim) {
  const int warps = (s_dim + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

}  // namespace

// `sweep_max` (num_sweeps floats, as bits) is zeroed here, on the stream.
extern "C" int gu_grid_sweeps(const void* passable, const void* terminal,
                              const void* reward, const void* deltas, int num_actions,
                              const void* grids, int n, int h, int w, const void* policy,
                              const void* v_in, void* v_out, float gamma, int num_sweeps,
                              void* sweep_max, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = grid_smem_bytes(h * w);
  cudaError_t err = cudaFuncSetAttribute(
      grid_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(sweep_max, 0, sizeof(unsigned int) * num_sweeps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_sweeps_kernel<<<n, grid_threads(h * w), bytes, st>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy),
      static_cast<const float*>(v_in), static_cast<float*>(v_out), gamma, num_sweeps,
      static_cast<unsigned int*>(sweep_max));
  return static_cast<int>(cudaGetLastError());
}

// `changed` (one int) is zeroed here, on the stream.
extern "C" int gu_grid_greedy(const void* passable, const void* terminal,
                              const void* reward, const void* deltas, int num_actions,
                              const void* grids, int n, int h, int w, const void* policy,
                              const void* v_in, float gamma, void* policy_out, void* changed,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = grid_smem_bytes(h * w);
  cudaError_t err = cudaFuncSetAttribute(
      grid_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(changed, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_greedy_kernel<<<n, grid_threads(h * w), bytes, st>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy),
      static_cast<const float*>(v_in), gamma, static_cast<int*>(policy_out),
      static_cast<int*>(changed));
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
    grid_sweep_global_kernel<<<blocks, kMaxThreads, 0, st>>>(
        g, n, src, dst, static_cast<uint32_t*>(info), k == 0, gamma,
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
  grid_greedy_global_kernel<<<blocks, kMaxThreads, 0, st>>>(
      grid_args(passable, terminal, reward, deltas, num_actions, grids, h, w, policy), n,
      static_cast<const float*>(v_in), gamma, static_cast<int*>(policy_out),
      static_cast<int*>(changed));
  return static_cast<int>(cudaGetLastError());
}
