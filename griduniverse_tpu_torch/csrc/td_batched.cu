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
// Bound on the card: bytes, by latency. A thread's three row reads and one
// write per step land at data-dependent rows of its own table (1.3 KB in
// float32 at 9x9), and all tables together outgrow the L2 cache at 65,536
// mazes, so a step is a chain of dependent L2 or device-memory accesses.
//
// Design: one thread per maze, the whole T loop inside one launch, no
// traffic between threads. Env state, carried action, xorshift lane and
// episode accumulators stay in registers. Actions come from the maze's
// xorshift32 lane (one round a draw) or from injected (T, N) tensors.
// Tables are float32 or bfloat16. In bfloat16 the rows are read exactly
// into float32 and values round to bfloat16 where the reference's do: the
// expectation target (mean, both products, their sum), α·δ and the updated
// entry; γ·target and δ are float32. The wrapper hands γ, 1−ε and ε already
// rounded to bfloat16 in that mode. Built with -fmad=false, so kernel and
// plain version round alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kThreads = 128;
enum Algo { kQLearning = 0, kSarsa = 1, kExpectedSarsa = 2 };

__device__ __forceinline__ float load_q(const float* p) { return *p; }
__device__ __forceinline__ float load_q(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_q(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_q(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rounding to the table's type and back: the identity for float32.
template <typename QT>
__device__ __forceinline__ float as_stored(float x) {
  return x;
}
template <>
__device__ __forceinline__ float as_stored<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
  int algo;
  float alpha;
  float gamma;
  float epsilon;
  float one_minus_epsilon;
  uint32_t eps16;
  int draw_first;
  const uint8_t* explore;   // (T, N) or null: draw from the lanes
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

template <typename QT>
__device__ __forceinline__ void load_row(const QT* q, int s, int na, float* row) {
  for (int k = 0; k < na; ++k) row[k] = load_q(q + s * na + k);
}

template <typename QT>
__global__ void td_batched_kernel(TdBatchedArgs g, QT* __restrict__ q_all) {
  __shared__ gu::Tables tab;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.n) return;

  const int na = g.num_actions;
  const uint32_t* lw = g.words + static_cast<size_t>(n) * g.n_words;
  const int s_idx = g.start_idx[n], s_code = g.start_code[n];
  QT* q = q_all + static_cast<size_t>(n) * g.h * g.w * na;
  const bool injected = g.explore != nullptr;

  int idx = g.idx[n], code = g.code[n], t = g.t[n], a = g.a[n];
  uint32_t rs = g.rs[n];
  gu::Episode ep{g.run_ret[n], g.ret_sum[n], g.n_eps[n], 0};
  float row_s[gu::kMaxActions], row_s2[gu::kMaxActions], row_n[gu::kMaxActions];

  // ε-greedy on `row` from the lane, or from an injected (explore, rand_a)
  auto draw = [&](const float* row, bool inj_explore, int inj_rand) {
    bool explore;
    int ra;
    if (injected) {
      explore = inj_explore;
      ra = min(max(inj_rand, 0), na - 1);
    } else {
      rs = gu::xorshift32(rs);
      explore = gu::explore_coin(rs, g.eps16);
      ra = gu::explore_action(rs, na);
    }
    return explore ? ra : gu::first_argmax(row, na);
  };

  if (g.draw_first) {
    load_row(q, idx, na, row_n);
    a = draw(row_n, injected && g.explore0[n] != 0, injected ? g.rand_a0[n] : 0);
  }

  for (int step = 0; step < g.num_steps; ++step) {
    const int s = idx;
    const gu::Transition tr = gu::step_autoreset(tab, lw, g.h, g.w, s_idx, s_code,
                                                 g.max_episode_steps, a, idx, code, t, ep);
    load_row(q, s, na, row_s);
    load_row(q, tr.obs, na, row_s2);
    load_row(q, idx, na, row_n);  // the post-reset state, before the update
    const float q_sa = row_s[a];
    const size_t o = static_cast<size_t>(step) * g.n + n;
    const int a_next =
        draw(row_n, injected && g.explore[o] != 0, injected ? g.rand_a[o] : 0);

    float boot;
    if (g.algo == kSarsa) {
      boot = row_s2[a_next];
    } else {
      float greedy = row_s2[0], total = row_s2[0];
      for (int k = 1; k < na; ++k) {
        greedy = fmaxf(greedy, row_s2[k]);
        total = total + row_s2[k];
      }
      if (g.algo == kQLearning) {
        boot = greedy;
      } else {
        const float mean = as_stored<QT>(total / static_cast<float>(na));
        boot = as_stored<QT>(as_stored<QT>(g.one_minus_epsilon * greedy) +
                             as_stored<QT>(g.epsilon * mean));
      }
    }
    const float delta = tr.reward + g.gamma * (tr.done ? 0.0f : boot) - q_sa;
    store_q(q + s * na + a, q_sa + as_stored<QT>(g.alpha * delta));
    a = a_next;
  }

  g.idx[n] = idx;
  g.code[n] = code;
  g.t[n] = t;
  g.a[n] = a;
  g.rs[n] = rs;
  g.run_ret[n] = ep.run_ret;
  g.n_eps[n] = ep.n_eps;
  g.ret_sum[n] = ep.ret_sum;
}

}  // namespace

// `q` (N, S, A), float32 or bfloat16 (`bf16` != 0), and the per-maze state
// are updated in place.
extern "C" int gu_td_batched(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int n, int num_steps, int max_episode_steps,
    int algo, int bf16, float alpha, float gamma, float epsilon, float one_minus_epsilon,
    int eps16, int draw_first, const void* explore, const void* rand_a,
    const void* explore0, const void* rand_a0, void* q, void* idx, void* code, void* t,
    void* a, void* rs, void* run_ret, void* n_eps, void* ret_sum, void* stream) {
  if (!per_env) return static_cast<int>(cudaErrorInvalidValue);
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
                  algo,
                  alpha,
                  gamma,
                  epsilon,
                  one_minus_epsilon,
                  static_cast<uint32_t>(eps16),
                  draw_first,
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
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    td_batched_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, st>>>(g, static_cast<__nv_bfloat16*>(q));
  } else {
    td_batched_kernel<float><<<blocks, kThreads, 0, st>>>(g, static_cast<float*>(q));
  }
  return static_cast<int>(cudaGetLastError());
}
