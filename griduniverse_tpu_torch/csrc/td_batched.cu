// td_batched.cu — K6: per-maze TD control, one Q-table per maze.
//
// Replaces griduniverse_tpu/algos/td_batched.py `_td_step` (78) under the
// scan of `q_learning_batched` (128). N independent agents, agent n in maze
// n with its own Q[n] (S, A): per step the bit-packed auto-reset env step,
// the rows Q[n,s] and Q[n,s2], the next action (ε-greedy on the row of the
// post-reset state, read BEFORE the update commits), the Q-learning / SARSA /
// expected-SARSA target, and the single-entry update Q[n,s,a] += α·δ. The
// JAX version looks rows up with a select tree and updates with a one-hot
// outer product over the whole table; here both are one indexed access.
//
// Bound on the card: latency. A maze's steps form a chain (the next action
// needs the row of the next state, and the next state needs the action),
// and a maze is one thread, so a step costs the latency of its chain of
// dependent operations and accesses. The function's own operations are 94
// a step (`chip_smoke.py`'s INSTR_K6_STEP), 0.37 ms of issue for 2,000
// steps of 65,536 mazes on the H100; the tables once each way are 0.05 ms
// of bytes. Cutting costs out of the kernel of one thread a maze over
// tables in device memory (`experiments/k6_k7b_ablation.py`) showed that
// its chain was mostly arithmetic, not loads: rows made from a constant
// took 18–36 % off, and with no memory on the chain at all it still took
// 4 ms.
//
// Design:
//  * A short chain. Each thread carries its agent's row and column beside
//    its index, so no step divides by the width. The rows it reads stay in
//    registers (A is a template parameter, 4 or up to 8; an entry is picked
//    by selects, never by a dynamic index into a local array; above 8 the
//    wide form, kA = 0, reads each entry from the table where it is used,
//    with the same first argmax, maximum and sum in index order), the argmax
//    and the target are unrolled, and the algorithm and the draws' source
//    are template parameters: the loop has no branch on either, and the
//    injected draws are loaded a step ahead.
//  * Tables in shared memory. In the shared tier a block holds M mazes, a
//    thread each (M a multiple of 32, from `kernels/td_batched.py` `plan`,
//    in whole warps a scheduler), and every one keeps its table and packed
//    level in dynamic shared memory for the whole scan, entry-major and
//    maze-minor (entry e of the block's maze m at e·M + m), so the 32 lanes
//    of a warp, each at a row of its own, read words of 32 distinct banks
//    (in bfloat16, two lanes share a word). Each warp stages its 32 mazes
//    in and out itself (`stage_in`, `stage_out`): it moves 32 consecutive
//    entries of one maze at a time (a coalesced access of device memory)
//    and transposes the 32 × 32 tile in registers, so that each lane then
//    writes or reads a column of its own maze (32 distinct banks). Where 32
//    tables do not fit a block (the global tier: 33x33 and up), every maze
//    reads its rows from device memory. Every maze runs the same
//    arithmetic, so the tiers give the same bits.
//
// Actions come from the maze's xorshift32 lane (one round a draw) or from
// injected (T, N) tensors. Tables are float32 or bfloat16. In bfloat16 the
// rows are read exactly into float32 and values round to bfloat16 where the
// reference's do: the expectation target (mean, both products, their sum),
// α·δ and the updated entry; γ·target and δ are float32. The wrapper hands
// γ, 1−ε and ε already rounded to bfloat16 in that mode. Built with
// -fmad=false, so kernel and plain version round alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "step.cuh"

namespace {

constexpr int kMaxThreads = 512;  // `kernels/td_batched.py` MAX_THREADS
enum Algo { kQLearning = 0, kSarsa = 1, kExpectedSarsa = 2 };

extern __shared__ __align__(16) unsigned char smem_raw[];

__device__ __forceinline__ float load_q(const float& x) { return x; }
__device__ __forceinline__ float load_q(const __nv_bfloat16& x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_q(float& x, float v) { x = v; }
__device__ __forceinline__ void store_q(__nv_bfloat16& x, float v) { x = __float2bfloat16_rn(v); }

// Rounding to the table's type and back: the identity for float32.
template <typename QT>
__device__ __forceinline__ float as_stored(float x) {
  return x;
}
template <>
__device__ __forceinline__ float as_stored<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element i of one maze's array: p[i * stride] in a block's shared memory
// (its column), p[i] in device memory (its row).
template <typename T, bool kStrided>
struct Column {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int i) const { return kStrided ? p[i * stride] : p[i]; }
};

struct TdBatchedArgs {
  const uint8_t* passable;
  const uint8_t* terminal;
  const float* reward;
  const int* deltas;
  int num_actions;
  const uint32_t* words;  // (N, n_words)
  int n_words;
  const int* start_idx;
  const int* start_code;
  int h;
  int w;
  int n;
  int num_steps;
  int max_episode_steps;
  float alpha;
  float gamma;
  float epsilon;
  float one_minus_epsilon;
  uint32_t eps16;
  int draw_first;
  int shared;               // the shared tier: every maze of a block in shared memory
  const uint8_t* explore;   // (T, N), the injected draws
  const int* rand_a;        // (T, N)
  const uint8_t* explore0;  // (N,)
  const int* rand_a0;       // (N,)
  // per-maze state, updated in place
  int* idx;
  int* code;
  int* t;
  int* a;
  uint32_t* rs;
  float* run_ret;
  int* n_eps;
  float* ret_sum;
};

// The row Q[s] into registers; entries past `na` are 0 and never read.
template <int kA, typename Table>
__device__ __forceinline__ void load_row(const Table& q, int s, int na, float (&row)[kA]) {
#pragma unroll
  for (int k = 0; k < kA; ++k) row[k] = k < na ? load_q(q[s * na + k]) : 0.0f;
}

// row[a] by selects, so the row stays in registers
template <int kA>
__device__ __forceinline__ float pick(const float (&row)[kA], int a) {
  float v = row[0];
#pragma unroll
  for (int k = 1; k < kA; ++k) v = a == k ? row[k] : v;
  return v;
}

// The first index of the maximum, as gu::first_argmax
template <int kA>
__device__ __forceinline__ int argmax(const float (&row)[kA], int na) {
  int best = 0;
  float top = row[0];
#pragma unroll
  for (int k = 1; k < kA; ++k) {
    if (k < na && row[k] > top) {
      best = k;
      top = row[k];
    }
  }
  return best;
}

// The table for kA actions: gu::Tables, or with kA = 0 (any A) gu::WideTables.
template <int kA>
using TablesOf = typename std::conditional<kA == 0, gu::WideTables, gu::Tables>::type;

// One maze's whole scan, on its table `q` and packed level `lw` wherever
// they live.
template <typename QT, int kA, int kAlgo, bool kInjected, typename Table, typename Words>
__device__ __forceinline__ void run_maze(const TdBatchedArgs& g, const TablesOf<kA>& tab, int n,
                                         const Table& q, const Words& lw) {
  constexpr int kR = kA > 0 ? kA : 1;  // a row's registers (none used at kA = 0)
  const int na = kA == 4 ? 4 : g.num_actions;
  const gu::Pos start = gu::at_index(g.start_idx[n], g.start_code[n], g.w);
  gu::Pos p = gu::at_index(g.idx[n], g.code[n], g.w);
  int t = g.t[n], a = g.a[n];
  uint32_t rs = g.rs[n];
  gu::Episode ep{g.run_ret[n], g.ret_sum[n], g.n_eps[n], 0};
  float row_s[kR], row_s2[kR], row_n[kR];

  // the first argmax of Q[s]: of its row in registers, or read from the table
  auto greedy_of = [&](const float (&row)[kR], int s) {
    if constexpr (kA > 0) {
      return argmax(row, na);
    } else {
      int best = 0;
      float top = load_q(q[s * na]);
      for (int k = 1; k < na; ++k) {
        const float x = load_q(q[s * na + k]);
        if (x > top) {
          best = k;
          top = x;
        }
      }
      return best;
    }
  };

  // ε-greedy on the row of state s from the lane, or from an injected (explore, rand_a)
  auto draw = [&](const float (&row)[kR], int s, bool inj_explore, int inj_rand) {
    bool explore;
    int ra;
    if constexpr (kInjected) {
      explore = inj_explore;
      ra = min(max(inj_rand, 0), na - 1);
    } else {
      rs = gu::xorshift32(rs);
      explore = gu::explore_coin(rs, g.eps16);
      ra = gu::explore_action(rs, na);
    }
    return explore ? ra : greedy_of(row, s);
  };

  if (g.draw_first) {
    if constexpr (kA > 0) load_row(q, p.idx, na, row_n);
    a = draw(row_n, p.idx, kInjected && g.explore0[n] != 0, kInjected ? g.rand_a0[n] : 0);
  }
  bool next_explore = false;  // the injected draws of the coming step, loaded a step ahead
  int next_rand = 0;
  if (kInjected && g.num_steps > 0) {
    next_explore = g.explore[n] != 0;
    next_rand = g.rand_a[n];
  }

  for (int step = 0; step < g.num_steps; ++step) {
    const bool inj_explore = next_explore;
    const int inj_rand = next_rand;
    if (kInjected && step + 1 < g.num_steps) {
      const size_t o = static_cast<size_t>(step + 1) * g.n + n;
      next_explore = g.explore[o] != 0;
      next_rand = g.rand_a[o];
    }
    const int s = p.idx;
    if constexpr (kA > 0) load_row(q, s, na, row_s);
    const float q_sa_wide = kA > 0 ? 0.0f : load_q(q[s * na + a]);
    const gu::Transition tr =
        gu::step_autoreset_from(tab, lw, g.h, g.w, start, g.max_episode_steps, a, p, t, ep);
    if constexpr (kA > 0) {
      load_row(q, tr.obs, na, row_s2);
      load_row(q, p.idx, na, row_n);  // the post-reset state, before the update
    }
    const float q_sa = kA > 0 ? pick(row_s, a) : q_sa_wide;
    const int a_next = draw(row_n, p.idx, inj_explore, inj_rand);

    float boot;
    if constexpr (kAlgo == kSarsa) {
      boot = kA > 0 ? pick(row_s2, a_next) : load_q(q[tr.obs * na + a_next]);
    } else {
      float greedy, total;
      if constexpr (kA > 0) {
        greedy = row_s2[0];
        total = row_s2[0];
#pragma unroll
        for (int k = 1; k < kA; ++k) {
          if (k < na) {
            greedy = fmaxf(greedy, row_s2[k]);
            total = total + row_s2[k];
          }
        }
      } else {
        greedy = load_q(q[tr.obs * na]);
        total = greedy;
        for (int k = 1; k < na; ++k) {
          const float x = load_q(q[tr.obs * na + k]);
          greedy = fmaxf(greedy, x);
          total = total + x;
        }
      }
      if constexpr (kAlgo == kQLearning) {
        boot = greedy;
      } else {
        const float mean = as_stored<QT>(total / static_cast<float>(na));
        boot = as_stored<QT>(as_stored<QT>(g.one_minus_epsilon * greedy) +
                             as_stored<QT>(g.epsilon * mean));
      }
    }
    const float delta = tr.reward + g.gamma * (tr.done ? 0.0f : boot) - q_sa;
    store_q(q[s * na + a], q_sa + as_stored<QT>(g.alpha * delta));
    a = a_next;
  }

  g.idx[n] = p.idx;
  g.code[n] = p.code;
  g.t[n] = t;
  g.a[n] = a;
  g.rs[n] = rs;
  g.run_ret[n] = ep.run_ret;
  g.n_eps[n] = ep.n_eps;
  g.ret_sum[n] = ep.ret_sum;
}

// The 32 × 32 tile r[i] of the 32 lanes of a warp, transposed in
// registers: what lane l held in r[i], lane i holds in r[l]. Five rounds
// of 16 exchanges; every register index is a constant of the build.
__device__ __forceinline__ void transpose32(uint32_t (&r)[32], int lane) {
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1) {
    const bool upper = (lane & b) != 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & b) continue;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, upper ? r[i] : r[i | b], b);
      if (upper) {
        r[i] = got;
      } else {
        r[i | b] = got;
      }
    }
  }
}

// One warp's mazes (the first `mazes` of its 32; maze i's `n` items at
// dev[i·n .. i·n + n) in device memory) into their columns of shared
// memory (item e of maze i at col[e·stride + i]). A round reads 32
// consecutive items of each maze (32 coalesced accesses, all in flight),
// transposes the tile, and each lane writes its own maze's 32 items (a
// warp's stores in 32 distinct banks). U is the item's bits (uint32_t, or
// uint16_t for bfloat16).
template <typename U>
__device__ __forceinline__ void stage_in(const U* __restrict__ dev, U* col, int n, int stride,
                                         int mazes, int lane) {
  for (int e0 = 0; e0 < n; e0 += 32) {
    uint32_t r[32];
    const bool item = e0 + lane < n;
#pragma unroll
    for (int i = 0; i < 32; ++i) r[i] = i < mazes && item ? dev[i * n + e0 + lane] : 0u;
    transpose32(r, lane);
    if (lane < mazes) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (e0 + j < n) col[(e0 + j) * stride + lane] = static_cast<U>(r[j]);
      }
    }
  }
}

// The reverse of `stage_in`: each lane reads its own maze's 32 items of a
// round from its column, the warp transposes the tile and writes 32
// consecutive items of each maze to device memory.
template <typename U>
__device__ __forceinline__ void stage_out(const U* col, U* __restrict__ dev, int n, int stride,
                                          int mazes, int lane) {
  for (int e0 = 0; e0 < n; e0 += 32) {
    uint32_t r[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) r[j] = lane < mazes && e0 + j < n ? col[(e0 + j) * stride + lane] : 0u;
    transpose32(r, lane);
    if (e0 + lane < n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i < mazes) dev[i * n + e0 + lane] = static_cast<U>(r[i]);
      }
    }
  }
}

template <typename QT>
using Bits = typename std::conditional<sizeof(QT) == 2, uint16_t, uint32_t>::type;

// A thread a maze. In the shared tier each warp stages its mazes' tables
// and levels into their columns of shared memory, runs them there and
// stages the tables back; no warp reads another's columns, so the block
// meets at one barrier only, after the semantics tables. In the global
// tier each thread runs its maze on device memory.
template <typename QT, int kA, int kAlgo, bool kInjected>
__global__ void __launch_bounds__(kMaxThreads) td_batched_kernel(TdBatchedArgs g,
                                                                 QT* __restrict__ q_all) {
  __shared__ TablesOf<kA> tab;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_entries = g.h * g.w * g.num_actions;
  if (!g.shared) {
    if (n >= g.n) return;
    run_maze<QT, kA, kAlgo, kInjected>(
        g, tab, n, Column<QT, false>{q_all + static_cast<size_t>(n) * n_entries, 1},
        Column<const uint32_t, false>{g.words + static_cast<size_t>(n) * g.n_words, 1});
    return;
  }
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane, stride = blockDim.x;
  const int first = n - lane;                 // the warp's first maze
  const int mazes = min(32, g.n - first);     // the warp's mazes
  if (mazes <= 0) return;                     // the whole warp: none
  const size_t q_bytes = (static_cast<size_t>(stride) * n_entries * sizeof(QT) + 15) & ~size_t{15};
  Bits<QT>* q_col = reinterpret_cast<Bits<QT>*>(smem_raw) + warp0;
  uint32_t* w_col = reinterpret_cast<uint32_t*>(smem_raw + q_bytes) + warp0;
  Bits<QT>* q_dev = reinterpret_cast<Bits<QT>*>(q_all) + static_cast<size_t>(first) * n_entries;
  stage_in(q_dev, q_col, n_entries, stride, mazes, lane);
  stage_in(g.words + static_cast<size_t>(first) * g.n_words, w_col, g.n_words, stride, mazes, lane);
  __syncwarp();
  if (lane < mazes) {
    run_maze<QT, kA, kAlgo, kInjected>(g, tab, n,
                                       Column<QT, true>{reinterpret_cast<QT*>(q_col) + lane, stride},
                                       Column<uint32_t, true>{w_col + lane, stride});
  }
  __syncwarp();
  stage_out(q_col, q_dev, n_entries, stride, mazes, lane);
}

template <typename QT, int kA, int kAlgo, bool kInjected>
cudaError_t launch(const TdBatchedArgs& g, QT* q, int threads, int blocks, int shared_bytes,
                   cudaStream_t st) {
  const auto kernel = td_batched_kernel<QT, kA, kAlgo, kInjected>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, shared_bytes, st>>>(g, q);
  return cudaGetLastError();
}

template <typename QT, int kA>
cudaError_t launch_algo(const TdBatchedArgs& g, QT* q, int algo, bool injected, int threads,
                        int blocks, int shared_bytes, cudaStream_t st) {
#define GU_K6_LAUNCH(ALGO)                                                                  \
  return injected ? launch<QT, kA, ALGO, true>(g, q, threads, blocks, shared_bytes, st)    \
                  : launch<QT, kA, ALGO, false>(g, q, threads, blocks, shared_bytes, st)
  if (algo == kSarsa) GU_K6_LAUNCH(kSarsa);
  if (algo == kExpectedSarsa) GU_K6_LAUNCH(kExpectedSarsa);
  GU_K6_LAUNCH(kQLearning);
#undef GU_K6_LAUNCH
}

template <typename QT>
cudaError_t launch_actions(const TdBatchedArgs& g, QT* q, int algo, bool injected, int threads,
                           int blocks, int shared_bytes, cudaStream_t st) {
  if (g.num_actions == 4) {
    return launch_algo<QT, 4>(g, q, algo, injected, threads, blocks, shared_bytes, st);
  }
  if (g.num_actions > gu::kMaxActions) {  // the wide form: no rows in registers
    return launch_algo<QT, 0>(g, q, algo, injected, threads, blocks, shared_bytes, st);
  }
  return launch_algo<QT, gu::kMaxActions>(g, q, algo, injected, threads, blocks, shared_bytes,
                                          st);
}

}  // namespace

// `q` (N, S, A), float32 or bfloat16 (`bf16` != 0), and the per-maze state
// are updated in place. The plan (`kernels/td_batched.py` `plan`): `blocks`
// blocks of `threads` mazes, every maze of a block in its `shared_bytes` of
// dynamic shared memory (0: the global tier, every maze in device memory).
extern "C" int gu_td_batched(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int n, int num_steps, int max_episode_steps,
    int algo, int bf16, float alpha, float gamma, float epsilon, float one_minus_epsilon,
    int eps16, int draw_first, int threads, int blocks, int shared_bytes,
    const void* explore, const void* rand_a, const void* explore0, const void* rand_a0, void* q,
    void* idx, void* code, void* t, void* a, void* rs, void* run_ret, void* n_eps, void* ret_sum,
    void* stream) {
  const int shared = shared_bytes > 0;
  const size_t q_bytes =
      (static_cast<size_t>(threads) * h * w * num_actions * (bf16 ? 2 : 4) + 15) & ~size_t{15};
  const size_t need = q_bytes + static_cast<size_t>(threads) * n_words * 4;
  if (!per_env || threads < 1 || threads > kMaxThreads || shared_bytes < 0 ||
      (shared && (threads % 32 != 0 || static_cast<size_t>(shared_bytes) < need)) ||
      static_cast<long long>(blocks) * threads < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TdBatchedArgs g{static_cast<const uint8_t*>(passable),
                  static_cast<const uint8_t*>(terminal),
                  static_cast<const float*>(reward),
                  static_cast<const int*>(deltas),
                  num_actions,
                  static_cast<const uint32_t*>(words),
                  n_words,
                  static_cast<const int*>(start_idx),
                  static_cast<const int*>(start_code),
                  h,
                  w,
                  n,
                  num_steps,
                  max_episode_steps,
                  alpha,
                  gamma,
                  epsilon,
                  one_minus_epsilon,
                  static_cast<uint32_t>(eps16),
                  draw_first,
                  shared,
                  static_cast<const uint8_t*>(explore),
                  static_cast<const int*>(rand_a),
                  static_cast<const uint8_t*>(explore0),
                  static_cast<const int*>(rand_a0),
                  static_cast<int*>(idx),
                  static_cast<int*>(code),
                  static_cast<int*>(t),
                  static_cast<int*>(a),
                  static_cast<uint32_t*>(rs),
                  static_cast<float*>(run_ret),
                  static_cast<int*>(n_eps),
                  static_cast<float*>(ret_sum)};
  const bool injected = explore != nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_actions(g, static_cast<__nv_bfloat16*>(q), algo, injected, threads, blocks,
                            shared_bytes, st)
           : launch_actions(g, static_cast<float*>(q), algo, injected, threads, blocks,
                            shared_bytes, st);
  return static_cast<int>(e);
}
