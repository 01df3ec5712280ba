// td_fast.cu — K5: the shared-Q TD scan (Q-learning / expected SARSA).
//
// Replaces griduniverse_tpu/algos/td_fast.py `td_scan_fast` (243) with
// `_epsilon_greedy_bits` (152). B envs share one Q(S, A). Per step, against
// the SAME pre-update Q for every env: row lookup Q[s]; ε-greedy action from
// one xorshift32 word; the bit-packed auto-reset env step; v = max_a Q[s2]
// (or the ε-greedy expectation); δ = r + γ·(done ? 0 : v) − Q[s,a]; then
// Q[s,a] += mean of α·δ over the envs at (s,a); then the per-env episode
// accumulators. The JAX version writes the lookups and the aggregate as
// one-hot matrix products, the TPU's way to gather and scatter; here a
// lookup is a shared-memory load and the aggregate an integer atomic add.
//
// Bound on the card: the grid-wide dependency. No env may read Q of step
// t+1 before every env's δ of step t is in, so each step is one kernel, and
// a kernel is three dependent phases (rebuild Q from L2, act and add, flush
// to L2), each a round trip. Their latency sets the pace, not bytes (a step
// moves 28 bytes of env state per env and 16 bytes per Q entry per block,
// all from L2) or arithmetic: on an H100 at 65,536 envs the step kernel is
// busy 8.5 µs.
//
// Design. One launch per step, one thread per env. Step t's kernel first
// rebuilds Q_t in every block's shared memory from Q_{t-1} and step t-1's
// aggregate (block 0 also stores Q_t for the next launch and clears the
// aggregate buffer of step t+1); then every thread acts, steps and adds its
// α·δ to a per-block aggregate in shared memory; then the block flushes the
// touched cells to the step's global aggregate. Three aggregate buffers
// rotate, so that no buffer is cleared while another block may still read
// or write it. A last small kernel applies the final aggregate.
//
// Determinism. Float atomics would sum in an order that changes from run to
// run. The aggregate is therefore integer: each env adds
// round-to-nearest-even(α·δ · 2^32) as a 64-bit integer and 1 to a 32-bit
// count. Integer addition is associative, so any order gives the same sum.
// The mean, sum·2^-32 / max(count, 1), is taken in float64 and rounded once
// to float32. The plain version does the same integer arithmetic, so the
// two agree bit for bit, two runs agree, and a chunked run equals the
// unbroken run. The file is built with -fmad=false, so `r + γ·v − q` and
// `α·δ` round as the plain version's separate multiply and add.
//
// Large tables. The rebuild stages 16 bytes a Q entry in every block, which
// is done up to kMaxStagedEntries (8,192 entries, 128 KB). Above it a second
// form of the step kernel keeps Q out of shared memory: a thread rebuilds
// each Q entry it reads, q_{t-1} + mean(aggregate_{t-1}), straight from the
// global buffers (the same function of the same integers, so the same bits),
// the grid's threads share the store of Q_t and the clearing of step t+1's
// aggregate, and each env adds its fixed-point α·δ and its count straight
// into the step's global aggregate with integer atomics. Integer addition is
// associative, so this form gives the plain version's bits too. Hot cells
// make those atomics contend; the form is right, not tuned.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedEntries = 8192;  // 16 bytes each in shared memory
constexpr double kFixedOne = 4294967296.0;  // 2^32

extern __shared__ unsigned char smem_raw[];

struct TdFastArgs {
  const uint8_t* passable;
  const uint8_t* terminal;
  const float* reward;
  const int* deltas;
  int num_actions;
  const uint32_t* words;
  int n_words;
  int per_env;
  const int* start_idx;
  const int* start_code;
  int h;
  int w;
  int batch;
  int max_episode_steps;
  int expected_sarsa;
  float alpha;
  float gamma;
  float epsilon;
  float one_minus_epsilon;
  uint32_t eps16;
  // per-env state, updated in place
  int* idx;
  int* code;
  int* t;
  uint32_t* rs;
  float* run_ret;
  int* n_eps;
  float* ret_sum;
};

// q + sum·2^-32 / max(count, 1), the mean in float64, rounded once.
__device__ __forceinline__ float apply_mean(float q, long long sum, int count) {
  const double mean = __ll2double_rn(sum) * (1.0 / kFixedOne) /
                      static_cast<double>(count > 1 ? count : 1);
  return q + static_cast<float>(mean);
}

// Q_t[i]: q_prev[i], plus the mean of step t-1's aggregate if `apply_prev`.
__device__ __forceinline__ float rebuilt(int apply_prev, const float* __restrict__ q_prev,
                                         const long long* __restrict__ acc_prev,
                                         const int* __restrict__ cnt_prev, int i) {
  const float q = q_prev[i];
  return apply_prev ? apply_mean(q, acc_prev[i], cnt_prev[i]) : q;
}

// One step. q_prev + (acc_prev, cnt_prev) is this step's Q (q_prev alone
// if `apply_prev` is 0); this step's aggregate goes to (acc_cur, cnt_cur).
// kStaged: Q and the block's aggregate in shared memory (at most
// kMaxStagedEntries entries); otherwise both stay in global memory.
template <bool kStaged>
__global__ void td_fast_step_kernel(TdFastArgs g, int apply_prev,
                                    const float* __restrict__ q_prev,
                                    const long long* __restrict__ acc_prev,
                                    const int* __restrict__ cnt_prev,
                                    float* __restrict__ q_cur,
                                    unsigned long long* __restrict__ acc_cur,
                                    int* __restrict__ cnt_cur,
                                    long long* __restrict__ acc_next,
                                    int* __restrict__ cnt_next) {
  __shared__ gu::Tables tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  const int n_entries = g.h * g.w * g.num_actions;
  unsigned long long* s_acc = reinterpret_cast<unsigned long long*>(smem_raw);
  float* s_q = reinterpret_cast<float*>(s_acc + n_entries);
  int* s_cnt = reinterpret_cast<int*>(s_q + n_entries);

  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (!g.per_env) {
    for (int i = threadIdx.x; i < g.n_words; i += blockDim.x) s_words[i] = g.words[i];
  }
  if (kStaged) {
    for (int i = threadIdx.x; i < n_entries; i += blockDim.x) {
      const float q = rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, i);
      s_q[i] = q;
      s_acc[i] = 0ull;
      s_cnt[i] = 0;
      if (blockIdx.x == 0) {
        q_cur[i] = q;
        acc_next[i] = 0ll;
        cnt_next[i] = 0;
      }
    }
  } else {
    // Q_t is read by the next launch only, and step t+1's aggregate was last
    // read by step t-1's: no block of this launch reads what these stores write
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_entries; i += stride) {
      q_cur[i] = rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, i);
      acc_next[i] = 0ll;
      cnt_next[i] = 0;
    }
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < g.batch) {
    const uint32_t* lw =
        g.per_env ? g.words + static_cast<size_t>(b) * g.n_words : s_words;
    const int s_idx = g.per_env ? g.start_idx[b] : g.start_idx[0];
    const int s_code = g.per_env ? g.start_code[b] : g.start_code[0];
    const int na = g.num_actions;
    int idx = g.idx[b], code = g.code[b], t = g.t[b];
    const uint32_t bits = gu::xorshift32(g.rs[b]);

    float row[gu::kMaxActions];
    for (int k = 0; k < na; ++k) {
      row[k] = kStaged ? s_q[idx * na + k]
                       : rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, idx * na + k);
    }
    const int a = gu::explore_coin(bits, g.eps16) ? gu::explore_action(bits, na)
                                                  : gu::first_argmax(row, na);
    const int cell = idx * na + a;
    const float q_sa = row[a];
    gu::Episode ep{g.run_ret[b], g.ret_sum[b], g.n_eps[b], 0};
    const gu::Transition tr = gu::step_autoreset(tab, lw, g.h, g.w, s_idx, s_code,
                                                 g.max_episode_steps, a, idx, code, t, ep);
    float row2[gu::kMaxActions];
    for (int k = 0; k < na; ++k) {
      row2[k] = kStaged ? s_q[tr.obs * na + k]
                        : rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, tr.obs * na + k);
    }
    float v = row2[0], total = row2[0];
    for (int k = 1; k < na; ++k) {
      v = fmaxf(v, row2[k]);
      total = total + row2[k];
    }
    if (g.expected_sarsa) {
      v = g.one_minus_epsilon * v + g.epsilon * (total / static_cast<float>(na));
    }
    const float delta = tr.reward + g.gamma * (tr.done ? 0.0f : v) - q_sa;
    const long long inc =
        __double2ll_rn(static_cast<double>(g.alpha * delta) * kFixedOne);
    if (kStaged) {
      atomicAdd(&s_acc[cell], static_cast<unsigned long long>(inc));
      atomicAdd(&s_cnt[cell], 1);
    } else {
      atomicAdd(&acc_cur[cell], static_cast<unsigned long long>(inc));
      atomicAdd(&cnt_cur[cell], 1);
    }

    g.idx[b] = idx;
    g.code[b] = code;
    g.t[b] = t;
    g.rs[b] = bits;
    g.run_ret[b] = ep.run_ret;
    g.n_eps[b] = ep.n_eps;
    g.ret_sum[b] = ep.ret_sum;
  }
  if (!kStaged) return;
  __syncthreads();

  for (int i = threadIdx.x; i < n_entries; i += blockDim.x) {
    const int c = s_cnt[i];
    if (c != 0) {
      atomicAdd(&acc_cur[i], s_acc[i]);
      atomicAdd(&cnt_cur[i], c);
    }
  }
}

// q_out = q_prev + the last step's aggregate.
__global__ void td_fast_apply_kernel(int n_entries, const float* __restrict__ q_prev,
                                     const long long* __restrict__ acc_prev,
                                     const int* __restrict__ cnt_prev,
                                     float* __restrict__ q_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_entries) q_out[i] = apply_mean(q_prev[i], acc_prev[i], cnt_prev[i]);
}

}  // namespace

// Scratch, all of `n_entries` = S·A elements a row: q_buf (2 rows, float),
// acc (3 rows, int64), cnt (3 rows, int32). q_in and q_out may not alias
// the scratch. `num_steps` >= 1. `*n_launched` (host memory) receives the
// number of kernels launched: one per step and the final apply.
extern "C" int gu_td_scan_fast(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int batch, int num_steps, int max_episode_steps,
    int expected_sarsa, float alpha, float gamma, float epsilon, float one_minus_epsilon,
    int eps16, const void* q_in, void* q_out, void* idx, void* code, void* t, void* rs,
    void* run_ret, void* n_eps, void* ret_sum, void* q_buf, void* acc, void* cnt,
    void* n_launched, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(n_launched);
  *launched = 0;
  const int n_entries = h * w * num_actions;
  const bool staged = n_entries <= kMaxStagedEntries;
  const size_t smem = staged ? static_cast<size_t>(n_entries) * 16 : 0;
  cudaError_t err = cudaFuncSetAttribute(td_fast_step_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxStagedEntries * 16);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* qb = static_cast<float*>(q_buf);
  long long* accb = static_cast<long long*>(acc);
  int* cntb = static_cast<int*>(cnt);
  // Q_{-1} is q_in, in the buffer that step 0 reads; steps 0 and 1 need
  // clean aggregates (later ones are cleared by the step before the last).
  err = cudaMemcpyAsync(qb + n_entries, q_in, sizeof(float) * n_entries,
                        cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(accb, 0, sizeof(long long) * 3 * n_entries, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(cntb, 0, sizeof(int) * 3 * n_entries, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  TdFastArgs g{static_cast<const uint8_t*>(passable),
               static_cast<const uint8_t*>(terminal),
               static_cast<const float*>(reward),
               static_cast<const int*>(deltas),
               num_actions,
               static_cast<const uint32_t*>(words),
               n_words,
               per_env,
               static_cast<const int*>(start_idx),
               static_cast<const int*>(start_code),
               h,
               w,
               batch,
               max_episode_steps,
               expected_sarsa,
               alpha,
               gamma,
               epsilon,
               one_minus_epsilon,
               static_cast<uint32_t>(eps16),
               static_cast<int*>(idx),
               static_cast<int*>(code),
               static_cast<int*>(t),
               static_cast<uint32_t*>(rs),
               static_cast<float*>(run_ret),
               static_cast<int*>(n_eps),
               static_cast<float*>(ret_sum)};
  const int blocks = (batch + kThreads - 1) / kThreads;
  for (int step = 0; step < num_steps; ++step) {
    const int prev = (step + 2) % 3, cur = step % 3, next = (step + 1) % 3;
    auto* kernel = staged ? td_fast_step_kernel<true> : td_fast_step_kernel<false>;
    kernel<<<blocks, kThreads, smem, st>>>(
        g, step > 0, qb + ((step + 1) & 1) * n_entries, accb + prev * n_entries,
        cntb + prev * n_entries, qb + (step & 1) * n_entries,
        reinterpret_cast<unsigned long long*>(accb + cur * n_entries), cntb + cur * n_entries,
        accb + next * n_entries, cntb + next * n_entries);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  const int last = num_steps - 1;
  td_fast_apply_kernel<<<(n_entries + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      n_entries, qb + (last & 1) * n_entries, accb + (last % 3) * n_entries,
      cntb + (last % 3) * n_entries, static_cast<float*>(q_out));
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}
