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
// t+1 before every env's δ of step t is in, so every step ends at a grid
// barrier, and a step is a chain of dependent round trips (the act and
// step in shared memory, the flush of the block's aggregate to L2, the
// barrier, the read of the step's aggregate back from L2). Their latency
// sets the pace, not bytes or arithmetic. `chip_smoke.py` holds the scan
// against the function's own operations at four actions (232
// thread-instructions an env step, 10 a Q entry's update a step): for 2,000
// steps of 65,536 envs on a 16x16 level, 0.91 ms at the H100's issue rate.
//
// Design: one persistent cooperative launch a scan. The grid is at most
// the blocks the card holds at once (the wrapper's `grid_plan`, from
// `gu_td_scan_fast_resident`), so a grid barrier (cooperative groups'
// `grid.sync()`) cannot wait on a block that never runs; the launch is
// refused where the device has no cooperative launch.
//  * Each thread keeps its envs' state (idx, code, t, rs, run_ret, n_eps,
//    ret_sum) in registers for the whole scan, an env a thread (kEpt = 1),
//    read once and written once. Where B exceeds the threads of the
//    resident grid, the form kEpt = 0 walks as many envs a thread as it
//    takes (env b = thread + k·threads of the grid) and keeps their state
//    in the output arrays, one load and one store a step.
//  * Each block holds Q_t in shared memory for the whole scan (up to
//    kMaxStagedEntries entries) and, after each step's barrier, advances it
//    in place by the mean of the step's aggregate: the same function of the
//    same integers as the plain version, so the same bits.
//  * The lanes of a warp that add to the same cell are combined first
//    (`__match_any_sync`, then the sum of their integer increments), and
//    the block's shared counters are flushed once a step to the step's
//    global aggregate with integer atomics: fewer, larger blocks than one
//    block per 256 envs, so fewer blocks add to each hot cell.
//  * Three global aggregate buffers rotate: step t adds into t % 3, every
//    block reads it after the barrier, and step t clears (t + 2) % 3, last
//    read at step t − 1 and next added to at step t + 2, after a barrier,
//    so no second barrier a step is needed.
//  * The set-up (the first two aggregates cleared, Q staged) sits before
//    one more barrier at the start, and the final Q is written after the
//    last one: nothing else is launched, copied or cleared.
//
// Large tables. Above kMaxStagedEntries Q stays in global memory (the
// kStaged = false form of the same kernel, in the same loop): each step
// the grid's threads share the store of Q_t = Q_{t-1} + mean(aggregate of
// step t-1) into one of two buffers and the clearing of step t+1's
// aggregate, every Q entry an env reads is rebuilt from Q_{t-1} and that
// aggregate (the same function of the same integers), and the warp-combined
// increments go straight to the step's global aggregate. One barrier a
// step there too.
//
// Determinism. Float atomics would sum in an order that changes from run to
// run. The aggregate is therefore integer: each env adds
// round-to-nearest-even(α·δ · 2^32) as a 64-bit integer and 1 to a 32-bit
// count. Integer addition is associative, so any order (of lanes, warps or
// blocks) gives the same sum. The mean, sum·2^-32 / max(count, 1), is taken
// in float64 and rounded once to float32. The plain version does the same
// integer arithmetic, so the two agree bit for bit, two runs agree, and a
// chunked run equals the unbroken run. The file is built with -fmad=false,
// so `r + γ·v − q` and `α·δ` round as the plain version's separate
// multiply and add.
//
// The sharded form (`td_step_cluster_kernel`, `td_step_global_kernel`).
// Replaces the same function with its `psum_axes`
// (griduniverse_tpu/algos/td_fast.py:323-327), called by
// griduniverse_tpu/parallel/bitplane.py:224: each rank steps its envs and
// the step's aggregate is summed over the ranks before Q moves. A
// collective cannot sit inside the scan's cooperative launch, so this form
// is one ordinary launch a step, with the envs' state in device memory
// between launches and the all-reduce between them:
//  1. The launch of step t starts from Q_{t-1} and the SUMMED aggregate of
//     step t-1 (sums, then counts, 64-bit; none at step 0) and takes Q_t =
//     Q_{t-1} + sum·2^-32 / max(count, 1), the integer function of the
//     scan. It writes Q_t for the next launch and clears the aggregate of
//     step t+1 (last read by the launch of step t-1).
//  2. Each thread acts and steps one env against Q_t and adds its
//     fixed-point α·δ and a count to the step's aggregate.
//  3. The wrapper all-reduces that aggregate (integer sums: exact in any
//     order, on any backend and at any world size), and the next launch
//     applies it.
//  4. A last launch with `act` = 0 writes Q_T alone.
// Q after T steps is the same integer function of the same integers as the
// scan's, so the sharded run equals the unsharded K5 bit for bit on every
// rank.
//
// The host's share. A plan (`kernels/td_fast.py` `TdStepPlan`) checks the
// level, the semantics, the state, the Q rows and the aggregates once a
// scan and packs this file's `TdStepPlan` once; a step is then one C call
// with the step's index, from which the kernel derives its rows (Q_t in
// row t % 2, the aggregates in rows t % 3), so the launch's arguments are
// the plan and that index alone.
//
// The device's share, up to kMaxStagedEntries entries: a thread-block
// cluster of up to eight blocks (the plan's `cluster`, which divides the
// grid: about one block a 1,024 entries, at least two, and one block at
// B <= 512 envs). Q_t is a chain of L2 reads and a
// float64 divide an entry, the same in every block, so each block of a
// cluster rebuilds only its slice of ⌈S·A / cluster⌉ entries and stores it
// into every block of the cluster through distributed shared memory; a
// cluster barrier, and every block holds Q_t whole. Each block owns the
// counters of its slice: the warp-combined increments go to the owner's
// shared counters by distributed-shared-memory atomics, a second cluster
// barrier, and each owner flushes only its slice to the global aggregate.
// Against one block doing it all, that is `cluster` times fewer rebuilds
// and global atomics (a hot cell takes two atomics a cluster). On the H100
// the cluster paid where the table is large (8,100 entries: 10.9 µs a step
// on clusters of eight against 17.3 on one block); at walls16's 1,024 it
// costs about what it saves (6.2 µs on two blocks, 6.7 on one, 8.0 on
// eight), and the single-block kernel this replaced took 5.9. Each env's seven state words are loaded first, so that
// their latency hides behind the rebuild; the first store into another
// block waits only for the cluster's blocks to have started (a relaxed
// arrive at the top, its wait before the stores). Above kMaxStagedEntries
// entries the global-memory form rebuilds every entry an env reads from
// Q_{t-1} and the aggregate, and adds straight to the global aggregate.
// Bound: latency, a launch and a collective a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStagedEntries = 8192;  // 16 bytes each in shared memory
constexpr double kFixedOne = 4294967296.0;  // 2^32

// A profiling build may define GU_K5_CUT to time the scan with one cost cut
// (`experiments/k5_k7c_ablation.py`): 1, each step is its grid barrier
// alone; 2, the blocks' counters never reach the global aggregate; 3, each
// lane adds to the block's counters with no combine across the warp; 4, no
// block reads the step's aggregate back to advance its Q. A cut kernel
// computes wrong values. The default, 0, cuts nothing.
#ifndef GU_K5_CUT
#define GU_K5_CUT 0
#endif

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
  int num_steps;
  int max_episode_steps;
  int expected_sarsa;
  float alpha;
  float gamma;
  float epsilon;
  float one_minus_epsilon;
  uint32_t eps16;
  int walks;  // envs a thread walks a step (kEpt, or more where kEpt is 0)
  const float* q_in;
  float* q_out;
  // the state read once, and written once (kEpt = 0: stepped in place there)
  const int* idx_in;
  const int* code_in;
  const int* t_in;
  const uint32_t* rs_in;
  const float* run_ret_in;
  const int* n_eps_in;
  const float* ret_sum_in;
  int* idx;
  int* code;
  int* t;
  uint32_t* rs;
  float* run_ret;
  int* n_eps;
  float* ret_sum;
  float* q_buf;    // 2 rows of n entries: Q_t of the global-memory form
  long long* acc;  // 3 rows: the steps' fixed-point sums
  int* cnt;        // 3 rows: the steps' counts
};

struct Env {
  int idx, code, t;
  uint32_t rs;
  float run_ret, ret_sum;
  int n_eps;
};

__device__ __forceinline__ Env load_env(const TdFastArgs& g, int b, bool from_input) {
  if (from_input) {
    return Env{g.idx_in[b], g.code_in[b], g.t_in[b], g.rs_in[b],
               g.run_ret_in[b], g.ret_sum_in[b], g.n_eps_in[b]};
  }
  return Env{g.idx[b], g.code[b], g.t[b], g.rs[b], g.run_ret[b], g.ret_sum[b], g.n_eps[b]};
}

__device__ __forceinline__ void store_env(const TdFastArgs& g, int b, const Env& e) {
  g.idx[b] = e.idx;
  g.code[b] = e.code;
  g.t[b] = e.t;
  g.rs[b] = e.rs;
  g.run_ret[b] = e.run_ret;
  g.n_eps[b] = e.n_eps;
  g.ret_sum[b] = e.ret_sum;
}

// q + sum·2^-32 / max(count, 1), the mean in float64, rounded once. The
// count is an int (the scan's) or a 64-bit integer (the sharded step's).
template <typename Cnt>
__device__ __forceinline__ float apply_mean(float q, long long sum, Cnt count) {
  const double mean = __ll2double_rn(sum) * (1.0 / kFixedOne) /
                      static_cast<double>(count > 1 ? count : 1);
  return q + static_cast<float>(mean);
}

// Q_t[i] of the global-memory form: q_prev[i], plus the mean of step t-1's
// aggregate if `apply_prev`. Read past L1: other blocks wrote these this scan.
template <typename Cnt>
__device__ __forceinline__ float rebuilt(int apply_prev, const float* q_prev,
                                         const long long* acc_prev, const Cnt* cnt_prev, int i) {
  const float q = __ldcg(q_prev + i);
  return apply_prev ? apply_mean(q, __ldcg(acc_prev + i), __ldcg(cnt_prev + i)) : q;
}

// One env's step against Q_t (`s_q`, or rebuilt from q_prev and step t-1's
// aggregate); returns the cell (s, a) it adds to and its fixed-point α·δ.
// Above kMaxActions (Tab = WideTables) the loops over actions run to A and
// keep no row: the same first argmax, maximum and sum in index order.
template <bool kStaged, typename Tab, typename Cnt>
__device__ __forceinline__ int env_step(const TdFastArgs& g, const Tab& tab,
                                        const uint32_t* s_words, const float* s_q, int apply_prev,
                                        const float* q_prev, const long long* acc_prev,
                                        const Cnt* cnt_prev, int b, Env& e, long long& inc) {
  const uint32_t* lw = g.per_env ? g.words + static_cast<size_t>(b) * g.n_words : s_words;
  const int s_idx = g.per_env ? g.start_idx[b] : g.start_idx[0];
  const int s_code = g.per_env ? g.start_code[b] : g.start_code[0];
  const int na = g.num_actions;
  e.rs = gu::xorshift32(e.rs);
  const uint32_t bits = e.rs;
  auto q_at = [&](int i) {
    return kStaged ? s_q[i] : rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, i);
  };
  if constexpr (Tab::kWide) {
    int greedy = 0;
    float best = q_at(e.idx * na);
    for (int k = 1; k < na; ++k) {
      const float x = q_at(e.idx * na + k);
      if (x > best) {
        best = x;
        greedy = k;
      }
    }
    const int a = gu::explore_coin(bits, g.eps16) ? gu::explore_action(bits, na) : greedy;
    const int cell = e.idx * na + a;
    const float q_sa = q_at(cell);
    gu::Episode ep{e.run_ret, e.ret_sum, e.n_eps, 0};
    const gu::Transition tr = gu::step_autoreset(tab, lw, g.h, g.w, s_idx, s_code,
                                                 g.max_episode_steps, a, e.idx, e.code, e.t, ep);
    float v = q_at(tr.obs * na), total = v;
    for (int k = 1; k < na; ++k) {
      const float x = q_at(tr.obs * na + k);
      v = fmaxf(v, x);
      total = total + x;
    }
    if (g.expected_sarsa) {
      v = g.one_minus_epsilon * v + g.epsilon * (total / static_cast<float>(na));
    }
    const float delta = tr.reward + g.gamma * (tr.done ? 0.0f : v) - q_sa;
    inc = __double2ll_rn(static_cast<double>(g.alpha * delta) * kFixedOne);
    e.run_ret = ep.run_ret;
    e.ret_sum = ep.ret_sum;
    e.n_eps = ep.n_eps;
    return cell;
  }

  // the loops over actions run to kMaxActions, unrolled, so that the rows
  // stay in registers
  float row[gu::kMaxActions];
#pragma unroll
  for (int k = 0; k < gu::kMaxActions; ++k) {
    row[k] = k >= na ? 0.0f
             : kStaged ? s_q[e.idx * na + k]
                       : rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, e.idx * na + k);
  }
  // the first maximum, as gu::first_argmax
  int greedy = 0;
  float best = row[0];
#pragma unroll
  for (int k = 1; k < gu::kMaxActions; ++k) {
    if (k < na && row[k] > best) {
      best = row[k];
      greedy = k;
    }
  }
  const int a = gu::explore_coin(bits, g.eps16) ? gu::explore_action(bits, na) : greedy;
  const int cell = e.idx * na + a;
  float q_sa = row[0];
#pragma unroll
  for (int k = 1; k < gu::kMaxActions; ++k) {
    if (k == a) q_sa = row[k];
  }
  gu::Episode ep{e.run_ret, e.ret_sum, e.n_eps, 0};
  const gu::Transition tr = gu::step_autoreset(tab, lw, g.h, g.w, s_idx, s_code,
                                               g.max_episode_steps, a, e.idx, e.code, e.t, ep);
  float row2[gu::kMaxActions];
#pragma unroll
  for (int k = 0; k < gu::kMaxActions; ++k) {
    row2[k] = k >= na ? 0.0f
              : kStaged ? s_q[tr.obs * na + k]
                        : rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, tr.obs * na + k);
  }
  float v = row2[0], total = row2[0];
#pragma unroll
  for (int k = 1; k < gu::kMaxActions; ++k) {
    if (k < na) {
      v = fmaxf(v, row2[k]);
      total = total + row2[k];
    }
  }
  if (g.expected_sarsa) {
    v = g.one_minus_epsilon * v + g.epsilon * (total / static_cast<float>(na));
  }
  const float delta = tr.reward + g.gamma * (tr.done ? 0.0f : v) - q_sa;
  inc = __double2ll_rn(static_cast<double>(g.alpha * delta) * kFixedOne);
  e.run_ret = ep.run_ret;
  e.ret_sum = ep.ret_sum;
  e.n_eps = ep.n_eps;
  return cell;
}

// Adds `inc` and a count of one at `cell` (< 0: nothing), the lanes of the
// warp with the same cell combined first: the lowest of them adds their
// sum (integer, so in any order the same) and their number. Every lane of
// the warp calls it. `w_inc` is the warp's 32 slots of shared memory. The
// counts are ints (the scan's) or 64-bit (the sharded step's aggregate).
template <typename Cnt>
__device__ __forceinline__ void add_combined(int cell, long long inc, long long* w_inc,
                                             unsigned long long* acc, Cnt* cnt) {
  if constexpr (GU_K5_CUT == 3) {
    if (cell >= 0) {
      atomicAdd(acc + cell, static_cast<unsigned long long>(inc));
      atomicAdd(cnt + cell, static_cast<Cnt>(1));
    }
    return;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  const int lane = threadIdx.x & 31;
  w_inc[lane] = inc;
  __syncwarp();
  if (cell >= 0 && lane == __ffs(peers) - 1) {
    unsigned long long sum = static_cast<unsigned long long>(inc);
    for (unsigned rest = peers & (peers - 1); rest != 0; rest &= rest - 1) {
      sum += static_cast<unsigned long long>(w_inc[__ffs(rest) - 1]);
    }
    atomicAdd(acc + cell, sum);
    atomicAdd(cnt + cell, static_cast<Cnt>(__popc(peers)));
  }
  __syncwarp();
}

// The whole scan. kStaged: Q in every block's shared memory (at most
// kMaxStagedEntries entries), else in global memory. kEpt: 1, a thread's
// one env in registers; 0: `walks` envs a thread, their state in the output
// arrays. Tab: gu::Tables up to kMaxActions actions, gu::WideTables above.
template <bool kStaged, int kEpt, typename Tab>
__global__ void __launch_bounds__(kThreads, kEpt == 1 ? 2 : 1) td_fast_scan_kernel(TdFastArgs g) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Tab tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  __shared__ long long s_warp[kThreads];
  const int n = g.h * g.w * g.num_actions;
  unsigned long long* s_acc = reinterpret_cast<unsigned long long*>(smem_raw);
  float* s_q = reinterpret_cast<float*>(s_acc + n);
  int* s_cnt = reinterpret_cast<int*>(s_q + n);
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gstride = gridDim.x * kThreads;
  long long* const w_inc = s_warp + (threadIdx.x & ~31);

  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (!g.per_env) {
    for (int i = threadIdx.x; i < g.n_words; i += kThreads) s_words[i] = g.words[i];
  }
  // the aggregates of steps 0 and 1 start clean; each later one is cleared
  // two steps ahead
  for (int i = gtid; i < 2 * n; i += gstride) {
    g.acc[i] = 0ll;
    g.cnt[i] = 0;
  }
  if (kStaged) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_q[i] = g.q_in[i];
      s_acc[i] = 0ull;
      s_cnt[i] = 0;
    }
  }
  Env env[kEpt > 0 ? kEpt : 1];
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int b = gtid + k * gstride;
    if (b < g.batch) env[k] = load_env(g, b, true);
  }
  grid.sync();

  for (int step = 0; step < g.num_steps; ++step) {
    if constexpr (GU_K5_CUT == 1) {
      grid.sync();
      continue;
    }
    const int cur = step % 3;
    const int apply_prev = step > 0;
    const float* q_prev = g.q_in;
    const long long* acc_prev = g.acc + ((step + 2) % 3) * n;
    const int* cnt_prev = g.cnt + ((step + 2) % 3) * n;
    if (!kStaged) {
      // Q_t for the next step to rebuild from, and step t+1's aggregate
      // cleared: no block reads either of these this step
      if (step > 0) q_prev = g.q_buf + ((step + 1) & 1) * n;
      float* q_cur = g.q_buf + (step & 1) * n;
      long long* acc_next = g.acc + ((step + 1) % 3) * n;
      int* cnt_next = g.cnt + ((step + 1) % 3) * n;
      for (int i = gtid; i < n; i += gstride) {
        q_cur[i] = rebuilt(apply_prev, q_prev, acc_prev, cnt_prev, i);
        acc_next[i] = 0ll;
        cnt_next[i] = 0;
      }
    }
    unsigned long long* add_acc =
        kStaged ? s_acc : reinterpret_cast<unsigned long long*>(g.acc + cur * n);
    int* add_cnt = kStaged ? s_cnt : g.cnt + cur * n;
    if constexpr (kEpt > 0) {
#pragma unroll
      for (int k = 0; k < kEpt; ++k) {
        const int b = gtid + k * gstride;
        int cell = -1;
        long long inc = 0;
        if (b < g.batch) {
          cell = env_step<kStaged>(g, tab, s_words, s_q, apply_prev, q_prev, acc_prev, cnt_prev,
                                   b, env[k], inc);
        }
        add_combined(cell, inc, w_inc, add_acc, add_cnt);
      }
    } else {
      for (int k = 0; k < g.walks; ++k) {
        const int b = gtid + k * gstride;
        int cell = -1;
        long long inc = 0;
        if (b < g.batch) {
          Env e = load_env(g, b, step == 0);
          cell = env_step<kStaged>(g, tab, s_words, s_q, apply_prev, q_prev, acc_prev, cnt_prev,
                                   b, e, inc);
          store_env(g, b, e);
        }
        add_combined(cell, inc, w_inc, add_acc, add_cnt);
      }
    }
    if (kStaged) {
      __syncthreads();
      unsigned long long* acc_cur = reinterpret_cast<unsigned long long*>(g.acc + cur * n);
      int* cnt_cur = g.cnt + cur * n;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int c = s_cnt[i];
        if (c != 0) {
          if constexpr (GU_K5_CUT != 2) {
            atomicAdd(acc_cur + i, s_acc[i]);
            atomicAdd(cnt_cur + i, c);
          }
          s_acc[i] = 0ull;
          s_cnt[i] = 0;
        }
      }
    }
    grid.sync();
    if (kStaged) {
      // Q_{t+1} = Q_t + the mean of step t's aggregate, in every block. An
      // entry no env added to gains +0.0, which changes nothing after the
      // first step (only a -0.0 of q_in becomes +0.0, and no sum of a q and
      // a mean that is never -0.0 gives -0.0), so only step 0 applies it.
      const long long* acc_cur = g.acc + cur * n;
      const int* cnt_cur = g.cnt + cur * n;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const long long a = __ldcg(acc_cur + i);
        const int c = __ldcg(cnt_cur + i);
        if (GU_K5_CUT != 4 && (c != 0 || step == 0)) s_q[i] = apply_mean(s_q[i], a, c);
      }
      // step t+2's aggregate was last read at step t-1, before this barrier
      long long* acc_after = g.acc + ((step + 2) % 3) * n;
      int* cnt_after = g.cnt + ((step + 2) % 3) * n;
      for (int i = gtid; i < n; i += gstride) {
        acc_after[i] = 0ll;
        cnt_after[i] = 0;
      }
      __syncthreads();
    }
  }

  if (kStaged) {
    for (int i = gtid; i < n; i += gstride) g.q_out[i] = s_q[i];
  } else {
    const int last = g.num_steps - 1;
    for (int i = gtid; i < n; i += gstride) {
      g.q_out[i] = rebuilt(1, g.q_buf + (last & 1) * n, g.acc + (last % 3) * n,
                           g.cnt + (last % 3) * n, i);
    }
  }
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int b = gtid + k * gstride;
    if (b < g.batch) store_env(g, b, env[k]);
  }
}

template <typename Tab>
void* scan_kernel_of(bool staged, int ept) {
  switch (ept) {
    case 0: return staged ? reinterpret_cast<void*>(td_fast_scan_kernel<true, 0, Tab>)
                          : reinterpret_cast<void*>(td_fast_scan_kernel<false, 0, Tab>);
    case 1: return staged ? reinterpret_cast<void*>(td_fast_scan_kernel<true, 1, Tab>)
                          : reinterpret_cast<void*>(td_fast_scan_kernel<false, 1, Tab>);
    default: return nullptr;
  }
}

// The kernel of (staged, ept, wide), or nullptr for an ept it does not take.
void* scan_kernel(bool staged, int ept, bool wide) {
  return wide ? scan_kernel_of<gu::WideTables>(staged, ept) : scan_kernel_of<gu::Tables>(staged, ept);
}

size_t scan_smem(int n_entries) {
  return n_entries <= kMaxStagedEntries ? static_cast<size_t>(n_entries) * 16 : 0;
}

// Blocks of the (n_entries, ept, wide) kernel an SM holds at once; an error
// where the device has no cooperative launch.
cudaError_t resident_blocks(int n_entries, int ept, bool wide, int* blocks_per_sm, int* sms) {
  void* kernel = scan_kernel(n_entries <= kMaxStagedEntries, ept, wide);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scan_smem(kMaxStagedEntries)));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        scan_smem(n_entries));
  }
  return err;
}

}  // namespace

// out[0] = blocks of K5's scan kernel for `ept` envs a thread (0: its form
// that keeps them in global memory) and `num_actions` actions an SM holds
// at once, out[1] = the SMs. Fails where the device has no cooperative
// launch.
extern "C" int gu_td_scan_fast_resident(int n_entries, int ept, int num_actions, void* out, void* stream) {
  (void)stream;
  int* o = static_cast<int*>(out);
  return static_cast<int>(resident_blocks(n_entries, ept, num_actions > gu::kMaxActions, o, o + 1));
}

// One cooperative launch of `blocks` blocks of 512 threads, each thread
// `walks` envs (kept in registers if `ept` is 1; 0: in the output
// arrays). The state is read from the *_in arrays and written to the
// outputs; q_in is read, q_out written. Scratch, all of `n_entries` = S·A
// elements a row: q_buf (2 rows, float; the global-memory form only), acc
// (3 rows, int64), cnt (3 rows, int32), none of it initialised. `num_steps`
// >= 1. Refused (cudaErrorCooperativeLaunchTooLarge) if `blocks` exceeds
// what the card holds at once.
extern "C" int gu_td_scan_fast(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int batch, int num_steps, int max_episode_steps,
    int expected_sarsa, float alpha, float gamma, float epsilon, float one_minus_epsilon,
    int eps16, int blocks, int ept, int walks, const void* q_in, void* q_out,
    const void* idx_in, const void* code_in, const void* t_in, const void* rs_in,
    const void* run_ret_in, const void* n_eps_in, const void* ret_sum_in, void* idx, void* code,
    void* t, void* rs, void* run_ret, void* n_eps, void* ret_sum, void* q_buf, void* acc,
    void* cnt, void* stream) {
  const int n_entries = h * w * num_actions;
  const bool wide = num_actions > gu::kMaxActions;
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_blocks(n_entries, ept, wide, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
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
               num_steps,
               max_episode_steps,
               expected_sarsa,
               alpha,
               gamma,
               epsilon,
               one_minus_epsilon,
               static_cast<uint32_t>(eps16),
               walks,
               static_cast<const float*>(q_in),
               static_cast<float*>(q_out),
               static_cast<const int*>(idx_in),
               static_cast<const int*>(code_in),
               static_cast<const int*>(t_in),
               static_cast<const uint32_t*>(rs_in),
               static_cast<const float*>(run_ret_in),
               static_cast<const int*>(n_eps_in),
               static_cast<const float*>(ret_sum_in),
               static_cast<int*>(idx),
               static_cast<int*>(code),
               static_cast<int*>(t),
               static_cast<uint32_t*>(rs),
               static_cast<float*>(run_ret),
               static_cast<int*>(n_eps),
               static_cast<float*>(ret_sum),
               static_cast<float*>(q_buf),
               static_cast<long long*>(acc),
               static_cast<int*>(cnt)};
  void* args[] = {&g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      scan_kernel(n_entries <= kMaxStagedEntries, ept, wide), dim3(blocks), dim3(kThreads), args,
      scan_smem(n_entries), static_cast<cudaStream_t>(stream)));
}

namespace {

// The sharded form's plan, packed once a scan in host memory by
// `kernels/td_fast.py` `TdStepPlan` and passed by value to every launch,
// whose only other argument is the step's index. g.q_in is Q before step 0
// and g.q_out the Q the last launch (act = 0) writes; the state arrays
// g.idx..g.ret_sum are stepped in place. Step t writes Q_t into q[t % 2],
// adds to agg[t % 3], reads agg[(t + 2) % 3] (step t-1's, summed over the
// ranks; none at step 0) and clears agg[(t + 1) % 3] (null: nothing to
// clear). Each aggregate is 2·S·A int64: sums, then counts.
struct TdStepPlan {
  TdFastArgs g;
  float* q[2];
  long long* agg[3];
  int blocks;   // blocks of a step's launch, a multiple of `cluster`
  int cluster;  // blocks a cluster of the staged form (1..8)
};
// `kernels/td_fast.py` mirrors the plan field for field with ctypes
static_assert(sizeof(TdFastArgs) == 272 && sizeof(TdStepPlan) == 320, "TdStepPlan's layout changed");

// The rows that step `step` reads, writes and clears.
struct StepRows {
  const float* q_prev;
  float* q_cur;
  const long long* agg_prev;  // null at step 0
  long long* agg_cur;
  long long* agg_clear;
};

__device__ __forceinline__ StepRows rows_of(const TdStepPlan& p, int step) {
  return StepRows{step == 0 ? p.g.q_in : p.q[(step + 1) & 1], p.q[step & 1],
                  step == 0 ? nullptr : p.agg[(step + 2) % 3], p.agg[step % 3],
                  p.agg[(step + 1) % 3]};
}

// The global-memory form (S·A above kMaxStagedEntries), and the last launch
// of every scan (act = 0: Q written to g.q_out, nothing cleared). One env a
// thread. The grid's threads share the store of Q_t and the clearing of
// step t+1's aggregate; every Q entry an env reads is rebuilt from Q_{t-1}
// and step t-1's aggregate; the warp-combined increments go straight to the
// step's global aggregate.
template <typename Tab>
__global__ void __launch_bounds__(kThreads) td_step_global_kernel(TdStepPlan p, int step, int act) {
  const TdFastArgs& g = p.g;
  __shared__ Tab tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  __shared__ long long s_warp[kThreads];
  const int n = g.h * g.w * g.num_actions;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gstride = gridDim.x * kThreads;
  const StepRows r = rows_of(p, step);
  const int apply_prev = r.agg_prev != nullptr;
  const long long* cnt_prev = apply_prev ? r.agg_prev + n : nullptr;
  float* const q_out = act ? r.q_cur : g.q_out;
  for (int i = gtid; i < n; i += gstride) {
    q_out[i] = rebuilt(apply_prev, r.q_prev, r.agg_prev, cnt_prev, i);
    if (act && r.agg_clear != nullptr) {
      r.agg_clear[i] = 0ll;
      r.agg_clear[n + i] = 0ll;
    }
  }
  if (!act) return;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (!g.per_env) {
    for (int i = threadIdx.x; i < g.n_words; i += kThreads) s_words[i] = g.words[i];
  }
  __syncthreads();
  int cell = -1;
  long long inc = 0;
  if (gtid < g.batch) {
    Env e = load_env(g, gtid, false);
    cell = env_step<false>(g, tab, s_words, nullptr, apply_prev, r.q_prev, r.agg_prev, cnt_prev, gtid,
                           e, inc);
    store_env(g, gtid, e);
  }
  unsigned long long* const acc_cur = reinterpret_cast<unsigned long long*>(r.agg_cur);
  add_combined(cell, inc, s_warp + (threadIdx.x & ~31), acc_cur, acc_cur + n);
}

// Adds `inc` and a count of one at `cell` (< 0: nothing) to the counters of
// the block of the cluster that owns the cell (block `cell / slice`, its
// entry `cell % slice`), through distributed shared memory: the lanes of
// the warp with the same cell are combined first, and the lowest of them
// adds their integer sum and their number. Every lane of the warp calls it.
__device__ __forceinline__ void add_to_owner(const cg::cluster_group& cluster, int cell, long long inc,
                                             long long* w_inc, unsigned long long* s_acc, int* s_cnt,
                                             int slice) {
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  const int lane = threadIdx.x & 31;
  w_inc[lane] = inc;
  __syncwarp();
  if (cell >= 0 && lane == __ffs(peers) - 1) {
    unsigned long long sum = static_cast<unsigned long long>(inc);
    for (unsigned rest = peers & (peers - 1); rest != 0; rest &= rest - 1) {
      sum += static_cast<unsigned long long>(w_inc[__ffs(rest) - 1]);
    }
    const int owner = cell / slice;
    const int at = cell - owner * slice;
    atomicAdd(cluster.map_shared_rank(s_acc + at, owner), sum);
    atomicAdd(cluster.map_shared_rank(s_cnt + at, owner), __popc(peers));
  }
  __syncwarp();
}

// One step of the staged form (S·A up to kMaxStagedEntries) on thread-block
// clusters of `cluster` blocks, an env a thread (see the note at the top).
// Block `rank` of a cluster rebuilds entries [rank·slice, (rank+1)·slice)
// of Q_t and owns their counters (slice = ⌈S·A / cluster⌉). Dynamic shared
// memory: the slice's 64-bit sums, Q_t whole, the slice's counts.
template <typename Tab>
__global__ void __launch_bounds__(kThreads) td_step_cluster_kernel(TdStepPlan p, int step) {
  const cg::cluster_group cluster = cg::this_cluster();
  // this block is running: the others may store into its memory once every
  // block of the cluster has arrived here (waited for below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const TdFastArgs& g = p.g;
  __shared__ Tab tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  __shared__ long long s_warp[kThreads];
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  // the env's state first, so that its loads are in flight during Q's rebuild
  const bool live = gtid < g.batch;
  Env e{};
  if (live) e = load_env(g, gtid, false);
  const int n = g.h * g.w * g.num_actions;
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int slice = (n + blocks - 1) / blocks;
  const int lo = rank * slice;
  const int mine = max(0, min(n, lo + slice) - lo);
  unsigned long long* const s_acc = reinterpret_cast<unsigned long long*>(smem_raw);
  float* const s_q = reinterpret_cast<float*>(s_acc + slice);
  int* const s_cnt = reinterpret_cast<int*>(s_q + n);
  const StepRows r = rows_of(p, step);
  const int apply_prev = r.agg_prev != nullptr;
  const long long* cnt_prev = apply_prev ? r.agg_prev + n : nullptr;
  gu::load_tables(tab, g.passable, g.terminal, g.reward, g.deltas, g.num_actions);
  if (!g.per_env) {
    for (int i = threadIdx.x; i < g.n_words; i += kThreads) s_words[i] = g.words[i];
  }
  for (int i = threadIdx.x; i < mine; i += kThreads) {
    s_acc[i] = 0ull;
    s_cnt[i] = 0;
  }
  if (r.agg_clear != nullptr) {  // step t+1's aggregate, over the whole grid
    for (int i = gtid; i < 2 * n; i += gridDim.x * kThreads) r.agg_clear[i] = 0ll;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the slice of Q_t, rebuilt once in the cluster (the same integer function
  // as the scan's, rounded once) and stored into every block of it; the
  // grid's first cluster also writes it for the next launch
  const bool writer = static_cast<int>(blockIdx.x) < blocks;
  for (int i = threadIdx.x; i < mine; i += kThreads) {
    const float q = rebuilt(apply_prev, r.q_prev, r.agg_prev, cnt_prev, lo + i);
    for (int b = 0; b < blocks; ++b) *cluster.map_shared_rank(s_q + lo + i, b) = q;
    if (writer) r.q_cur[lo + i] = q;
  }
  cluster.sync();  // Q_t whole in every block, every counter clear
  int cell = -1;
  long long inc = 0;
  if (live) {
    cell = env_step<true>(g, tab, s_words, s_q, apply_prev, r.q_prev, r.agg_prev, cnt_prev, gtid, e,
                          inc);
    store_env(g, gtid, e);
  }
  add_to_owner(cluster, cell, inc, s_warp + (threadIdx.x & ~31), s_acc, s_cnt, slice);
  cluster.sync();  // every add is in; from here each block reads only its own memory
  unsigned long long* const acc_cur = reinterpret_cast<unsigned long long*>(r.agg_cur);
  for (int i = threadIdx.x; i < mine; i += kThreads) {
    const int c = s_cnt[i];
    if (c != 0) {
      atomicAdd(acc_cur + lo + i, s_acc[i]);
      atomicAdd(acc_cur + n + lo + i, static_cast<unsigned long long>(c));
    }
  }
}

// Dynamic shared memory of the cluster kernel for n entries on clusters of `cluster`.
size_t cluster_smem(int n, int cluster) {
  const size_t slice = (static_cast<size_t>(n) + cluster - 1) / cluster;
  return slice * 12 + static_cast<size_t>(n) * 4;
}

template <typename Tab>
cudaError_t launch_step(const TdStepPlan& p, int step, int act, cudaStream_t st) {
  const int n = p.g.h * p.g.w * p.g.num_actions;
  if (!act || n > kMaxStagedEntries) {
    const int blocks = act ? p.blocks : (n + kThreads - 1) / kThreads;
    td_step_global_kernel<Tab><<<blocks, kThreads, 0, st>>>(p, step, act);
    return cudaGetLastError();
  }
  if (p.cluster < 1 || p.cluster > 8 || p.blocks % p.cluster != 0) return cudaErrorInvalidValue;
  auto* const kernel = td_step_cluster_kernel<Tab>;
  const size_t smem = cluster_smem(n, p.cluster);
  // the limit raised once a device to the most any plan needs (a cluster of
  // one at kMaxStagedEntries), so that no later launch, as a captured one,
  // calls the setter; raised in every case, as the static shared memory
  // counts against the default 48 KB too
  static bool raised[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (!raised[device & 63]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cluster_smem(kMaxStagedEntries, 1)));
    if (err != cudaSuccess) return err;
    raised[device & 63] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, step);
}

}  // namespace

// One launch of K5's sharded form through a plan (`TdStepPlan`, in host
// memory): step `step` of this rank's envs (`act` = 1: the staged form on
// clusters of plan.cluster blocks, or the global-memory form above
// kMaxStagedEntries entries), or (`act` = 0) Q_step, the Q after the last
// step step - 1, written to g.q_out alone.
extern "C" int gu_td_step(const void* plan, int step, int act, void* stream) {
  const TdStepPlan& p = *static_cast<const TdStepPlan*>(plan);
  if (step < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.g.num_actions > gu::kMaxActions ? launch_step<gu::WideTables>(p, step, act, st)
                                                            : launch_step<gu::Tables>(p, step, act, st));
}
