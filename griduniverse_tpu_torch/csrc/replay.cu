// replay.cu — K8a `per_sample` (the prioritized draw) and K8b, the replay
// ring (`replay_write`, `replay_gather`, `prio_refresh`).
//
// Replaces: griduniverse_tpu/models/dqn.py `prioritized_sample` (207) and
// `buffer_write` (180) with the priority fill (368), the minibatch gather
// (392) and the priority refresh (414) of the train body.
//
// K8a. The reference scores every slot with α·log p + Gumbel and hands the
// scores to `lax.approx_max_k`, the TPU's partial-reduction top-k (recall
// ≥ 0.95). Here the n best are exact, and equal scores go to the lowest
// index, so a draw is a function of its inputs alone:
//   1. `per_score_kernel`, one thread a slot: the score (−inf beyond `size`),
//      the mass p^α, and each block's sum of the mass by a fixed tree (no
//      float atomics), one partial a block.
//   2. `per_select_kernel`, one block: the partials summed in block order; a
//      radix select of the n-th largest score on the order-preserving 32-bit
//      key of the float (four passes of an 8-bit histogram in shared memory,
//      integer atomics only); a compaction of the slots above that key, then
//      of the ties at it by lowest index (each warp owns a contiguous range
//      of slots, ranks by ballot); a rank sort of the n picks by (score
//      descending, index ascending); then the fallback hash for a pick with
//      no mass and the max-normalised importance weights.
//    The n picks' keys, ids and sorted ids (12 bytes a pick) sit in dynamic
//    shared memory up to kMaxSharedPicks = 16,384 picks, and in a scratch
//    buffer that the wrapper allocates above that; a thread takes picks
//    tid, tid + 1,024, ... in the sort and the weights.
// Bound on the card: bytes, and barely: 8 bytes a slot read once (1 MB at
// 131,072 slots, 0.3 µs at the memory rate) against six passes of one
// block over scores that sit in L2. The block's passes are the cost, and
// the rank sort is n² compares over 1,024 threads; a multi-block select is
// later work.
//
// K8b. One launch writes the five fields of B transitions at `at` and fills
// the new slots' priority from the device scalar `p_max` (the reference
// makes six `dynamic_update_slice`s); one launch gathers the five fields at
// n indices; one launch writes the n refreshed priorities, where of equal
// indices the highest minibatch position wins (what a sequential scatter
// gives), and folds their maximum into `p_max`. Up to kMaxPicks = 1,024 rows
// the refresh is one block, each row scanning the later rows for its slot.
// Above that it is two launches over the rows: the first takes each slot's
// highest position by an integer atomicMax into a per-slot scratch (-1 where
// untouched, filled by the wrapper) and copies the old `p_max` out; the
// second lets only that winner write, and folds each block's maximum into
// `p_max` by a compare-and-swap loop. A maximum is the same in any order, so
// both forms give the plain version's bits. Bound: bytes, 17 a transition;
// all three are launches in truth.
//
// `size`, `at`, `beta` and `p_max` are read from device memory, so the
// trainer's loop never reads a value on the host.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kScoreThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kMaxPicks = 1024;  // rows of a one-block refresh
constexpr int kMaxSharedPicks = 16384;  // picks whose keys, ids, sorted ids fit shared memory
constexpr int kRefreshThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Larger float <=> larger key; −0 and +0 share a key, as they compare equal.
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float slot_logp(float prio, float alpha) {
  return alpha * logf(fmaxf(prio, 1e-30f));
}

__global__ void per_score_kernel(const float* __restrict__ prio,
                                 const float* __restrict__ noise,
                                 const int64_t* __restrict__ size_p, float alpha,
                                 int cap, float* __restrict__ score,
                                 float* __restrict__ partial) {
  __shared__ float red[kScoreThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kScoreThreads + tid;
  const int64_t size = *size_p;
  float pa = 0.0f;
  if (i < cap) {
    const float logp = slot_logp(prio[i], alpha);
    const bool valid = i < size;
    score[i] = valid ? logp + noise[i] : -INFINITY;
    pa = valid ? expf(logp) : 0.0f;
  }
  red[tid] = pa;
  __syncthreads();
  for (int s = kScoreThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x] = red[0];
}

extern __shared__ unsigned char pick_smem[];

// kGlobal: the picks' keys, ids and sorted ids in `scratch` (3n words)
// instead of dynamic shared memory.
template <bool kGlobal>
__global__ void __launch_bounds__(kSelectThreads)
per_select_kernel(const float* __restrict__ score, const float* __restrict__ prio,
                  const float* __restrict__ partial, int n_partial,
                  const int64_t* __restrict__ size_p,
                  const float* __restrict__ beta_p, float alpha, int cap, int n,
                  int* __restrict__ idx_out, float* __restrict__ w_out,
                  uint32_t* __restrict__ scratch) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sh_prefix, sh_need;
  __shared__ float sh_sum;
  __shared__ int warp_gt[32], warp_eq[32];
  __shared__ float red[kSelectThreads];
  uint32_t* const keys = kGlobal ? scratch : reinterpret_cast<uint32_t*>(pick_smem);
  int* const ids = reinterpret_cast<int*>(keys + n);
  int* const sorted = ids + n;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {  // the mass, block partials added in block order
    float s = 0.0f;
    for (int j = 0; j < n_partial; ++j) s += partial[j];
    sh_sum = s;
  }

  // -- the key of the n-th largest score, one byte a pass from the top ------
  uint32_t prefix = 0u, need = static_cast<uint32_t>(n);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kSelectThreads) hist[b] = 0u;
    __syncthreads();
    const uint32_t mask = shift == 24 ? 0u : (kFull << (shift + 8));
    for (int i = tid; i < cap; i += kSelectThreads) {
      const uint32_t k = order_key(score[i]);
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t left = need;
      int d = 255;
      for (; d > 0; --d) {
        const uint32_t c = hist[d];
        if (c >= left) break;
        left -= c;
      }
      sh_prefix = prefix | (static_cast<uint32_t>(d) << shift);
      sh_need = left;
    }
    __syncthreads();
    prefix = sh_prefix;
    need = sh_need;
  }
  const uint32_t kth = prefix;  // `need` of the slots at this key are picked

  // -- compaction: warp w owns slots [w·seg, (w+1)·seg), a multiple of 32 ---
  const int seg = ((cap + 31) / 32 + 31) / 32 * 32;
  const int begin = min(warp * seg, cap), end = min(begin + seg, cap);
  int count_gt = 0, count_eq = 0;
  for (int base = begin; base < end; base += 32) {
    const int i = base + lane;
    const uint32_t k = i < end ? order_key(score[i]) : 0u;
    count_gt += __popc(__ballot_sync(kFull, i < end && k > kth));
    count_eq += __popc(__ballot_sync(kFull, i < end && k == kth));
  }
  if (lane == 0) {
    warp_gt[warp] = count_gt;
    warp_eq[warp] = count_eq;
  }
  __syncthreads();
  int off_gt = 0, off_eq = 0, total_gt = 0;
  for (int j = 0; j < 32; ++j) {
    if (j < warp) {
      off_gt += warp_gt[j];
      off_eq += warp_eq[j];
    }
    total_gt += warp_gt[j];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int base = begin; base < end; base += 32) {
    const int i = base + lane;
    const uint32_t k = i < end ? order_key(score[i]) : 0u;
    const bool gt = i < end && k > kth, eq = i < end && k == kth;
    const unsigned m_gt = __ballot_sync(kFull, gt), m_eq = __ballot_sync(kFull, eq);
    if (gt) {
      const int pos = off_gt + __popc(m_gt & below);
      keys[pos] = k;
      ids[pos] = i;
    }
    if (eq) {
      const int rank = off_eq + __popc(m_eq & below);
      if (rank < static_cast<int>(need)) {
        keys[total_gt + rank] = k;
        ids[total_gt + rank] = i;
      }
    }
    off_gt += __popc(m_gt);
    off_eq += __popc(m_eq);
  }
  __syncthreads();

  // -- rank sort by (score descending, index ascending) ----------------------
  for (int t = tid; t < n; t += kSelectThreads) {
    const uint32_t k = keys[t];
    const int id = ids[t];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      rank += (keys[j] > k) || (keys[j] == k && ids[j] < id);
    }
    sorted[rank] = id;
  }
  __syncthreads();

  // -- fallback for a pick with no mass, and the importance weights ----------
  const int64_t size = *size_p;
  const int64_t size1 = size > 1 ? size : 1;
  const float beta = *beta_p;
  // pick t's slot, whether it has mass, and its weight before the normalisation
  auto weigh = [&](int t, int& id, bool& ok) {
    id = sorted[t];
    const float pa = id < size ? expf(slot_logp(prio[id], alpha)) : 0.0f;
    ok = pa > 0.0f;
    const float p_sel = pa / fmaxf(sh_sum, 1e-30f);
    return powf(static_cast<float>(size1) * p_sel, -beta);
  };
  float w_max = 0.0f;
  for (int t = tid; t < n; t += kSelectThreads) {
    int id;
    bool ok;
    const float w = weigh(t, id, ok);
    if (ok) w_max = fmaxf(w_max, w);
  }
  red[tid] = w_max;
  __syncthreads();
  for (int s = kSelectThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  for (int t = tid; t < n; t += kSelectThreads) {
    int id;
    bool ok;
    const float w = weigh(t, id, ok);
    const uint32_t h = static_cast<uint32_t>(id) * 2654435761u + static_cast<uint32_t>(t);
    const int fallback = static_cast<int>(h % static_cast<uint32_t>(size1));
    idx_out[t] = ok ? id : fallback;
    w_out[t] = ok ? w / fmaxf(red[0], 1e-30f) : 1.0f;
  }
}

__global__ void replay_write_kernel(int* __restrict__ obs, int* __restrict__ action,
                                    float* __restrict__ reward, int* __restrict__ next_obs,
                                    uint8_t* __restrict__ done, float* __restrict__ prio,
                                    const int* __restrict__ s_obs,
                                    const int* __restrict__ s_action,
                                    const float* __restrict__ s_reward,
                                    const int* __restrict__ s_next_obs,
                                    const uint8_t* __restrict__ s_done,
                                    const int64_t* __restrict__ at_p,
                                    const float* __restrict__ p_max, int batch, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const int64_t j = *at_p + i;
  if (j < 0 || j >= cap) return;  // the ring's invariant keeps a write inside
  obs[j] = s_obs[i];
  action[j] = s_action[i];
  reward[j] = s_reward[i];
  next_obs[j] = s_next_obs[i];
  done[j] = s_done[i];
  if (prio != nullptr) prio[j] = *p_max;
}

__global__ void replay_gather_kernel(const int* __restrict__ obs,
                                     const int* __restrict__ action,
                                     const float* __restrict__ reward,
                                     const int* __restrict__ next_obs,
                                     const uint8_t* __restrict__ done,
                                     const int* __restrict__ idx, int n, int cap,
                                     int* __restrict__ o_obs, int* __restrict__ o_action,
                                     float* __restrict__ o_reward,
                                     int* __restrict__ o_next_obs,
                                     uint8_t* __restrict__ o_done) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = min(max(idx[i], 0), cap - 1);
  o_obs[i] = obs[j];
  o_action[i] = action[j];
  o_reward[i] = reward[j];
  o_next_obs[i] = next_obs[j];
  o_done[i] = done[j];
}

__global__ void __launch_bounds__(kMaxPicks)
prio_refresh_kernel(float* __restrict__ prio, const int* __restrict__ idx,
                    const float* __restrict__ abs_err, float eps, int n, int cap,
                    const float* __restrict__ p_max_in, float* __restrict__ p_max_out) {
  __shared__ int slot[kMaxPicks];
  __shared__ float red[kMaxPicks];
  const int tid = threadIdx.x;
  if (tid < n) slot[tid] = idx[tid];
  __syncthreads();
  float fresh = -INFINITY;
  if (tid < n) {
    fresh = abs_err[tid] + eps;
    const int s = slot[tid];
    bool wins = s >= 0 && s < cap;
    for (int j = tid + 1; j < n && wins; ++j) wins = slot[j] != s;  // a later row wins
    if (wins) prio[s] = fresh;
  }
  red[tid] = fresh;
  __syncthreads();
  for (int s = kMaxPicks / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) *p_max_out = fmaxf(*p_max_in, red[0]);
}

// The refresh above kMaxPicks rows, first launch: each slot's highest row
// into `owner` (all -1 on entry), and the old p_max copied out.
__global__ void refresh_claim_kernel(const int* __restrict__ idx, int n, int cap,
                                     int* __restrict__ owner,
                                     const float* __restrict__ p_max_in,
                                     float* __restrict__ p_max_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *p_max_out = *p_max_in;
  if (i >= n) return;
  const int s = idx[i];
  if (s >= 0 && s < cap) atomicMax(&owner[s], i);
}

// fmaxf(*addr, v) stored at *addr, whatever other threads store meanwhile.
__device__ __forceinline__ void atomic_fmax(float* addr, float v) {
  int* word = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(word);
  for (;;) {
    const int want = __float_as_int(fmaxf(__int_as_float(old), v));
    if (want == old) return;
    const int seen = atomicCAS(word, old, want);
    if (seen == old) return;
    old = seen;
  }
}

// Second launch: the winner of each slot writes, every row's fresh
// priority goes into p_max.
__global__ void __launch_bounds__(kRefreshThreads)
refresh_write_kernel(float* __restrict__ prio, const int* __restrict__ idx,
                     const float* __restrict__ abs_err, float eps, int n, int cap,
                     const int* __restrict__ owner, float* __restrict__ p_max_out) {
  __shared__ float red[kRefreshThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kRefreshThreads + tid;
  float fresh = -INFINITY;
  if (i < n) {
    fresh = abs_err[i] + eps;
    const int s = idx[i];
    if (s >= 0 && s < cap && owner[s] == i) prio[s] = fresh;
  }
  red[tid] = fresh;
  __syncthreads();
  for (int s = kRefreshThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) atomic_fmax(p_max_out, red[0]);
}

}  // namespace

// Both kernels of one draw; `*launched` counts those that were launched.
// `scratch`: 3n words when n > kMaxSharedPicks, else unused (may be null).
extern "C" int gu_per_sample(const void* prio, const void* noise, const void* size,
                             const void* beta, float alpha, int cap, int n,
                             void* score, void* partial, void* idx_out, void* w_out,
                             void* scratch, int* launched, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (cap + kScoreThreads - 1) / kScoreThreads;
  *launched = 0;
  per_score_kernel<<<blocks, kScoreThreads, 0, st>>>(
      static_cast<const float*>(prio), static_cast<const float*>(noise),
      static_cast<const int64_t*>(size), alpha, cap, static_cast<float*>(score),
      static_cast<float*>(partial));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 1;
  const bool in_shared = n <= kMaxSharedPicks;
  err = static_cast<int>(cudaFuncSetAttribute(per_select_kernel<false>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              kMaxSharedPicks * 12));
  if (err != 0) return err;
  auto* select = in_shared ? per_select_kernel<false> : per_select_kernel<true>;
  select<<<1, kSelectThreads, in_shared ? static_cast<size_t>(n) * 12 : 0, st>>>(
      static_cast<const float*>(score), static_cast<const float*>(prio),
      static_cast<const float*>(partial), blocks, static_cast<const int64_t*>(size),
      static_cast<const float*>(beta), alpha, cap, n, static_cast<int*>(idx_out),
      static_cast<float*>(w_out), static_cast<uint32_t*>(scratch));
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 2;
  return err;
}

extern "C" int gu_replay_write(void* obs, void* action, void* reward, void* next_obs,
                               void* done, void* prio, const void* s_obs,
                               const void* s_action, const void* s_reward,
                               const void* s_next_obs, const void* s_done,
                               const void* at, const void* p_max, int batch, int cap,
                               void* stream) {
  constexpr int threads = 256;
  replay_write_kernel<<<(batch + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(obs), static_cast<int*>(action), static_cast<float*>(reward),
      static_cast<int*>(next_obs), static_cast<uint8_t*>(done), static_cast<float*>(prio),
      static_cast<const int*>(s_obs), static_cast<const int*>(s_action),
      static_cast<const float*>(s_reward), static_cast<const int*>(s_next_obs),
      static_cast<const uint8_t*>(s_done), static_cast<const int64_t*>(at),
      static_cast<const float*>(p_max), batch, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_replay_gather(const void* obs, const void* action, const void* reward,
                                const void* next_obs, const void* done, const void* idx,
                                int n, int cap, void* o_obs, void* o_action,
                                void* o_reward, void* o_next_obs, void* o_done,
                                void* stream) {
  constexpr int threads = 256;
  replay_gather_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(obs), static_cast<const int*>(action),
      static_cast<const float*>(reward), static_cast<const int*>(next_obs),
      static_cast<const uint8_t*>(done), static_cast<const int*>(idx), n, cap,
      static_cast<int*>(o_obs), static_cast<int*>(o_action), static_cast<float*>(o_reward),
      static_cast<int*>(o_next_obs), static_cast<uint8_t*>(o_done));
  return static_cast<int>(cudaGetLastError());
}

// One launch up to kMaxPicks rows, two above (`owner`: cap ints, all -1;
// unused, may be null, up to kMaxPicks); `*launched` counts them.
extern "C" int gu_prio_refresh(void* prio, const void* idx, const void* abs_err, float eps,
                               int n, int cap, const void* p_max_in, void* p_max_out,
                               void* owner, int* launched, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (n <= kMaxPicks) {
    prio_refresh_kernel<<<1, kMaxPicks, 0, st>>>(
        static_cast<float*>(prio), static_cast<const int*>(idx),
        static_cast<const float*>(abs_err), eps, n, cap,
        static_cast<const float*>(p_max_in), static_cast<float*>(p_max_out));
    const int err = static_cast<int>(cudaGetLastError());
    if (err == 0) *launched = 1;
    return err;
  }
  const int blocks = (n + kRefreshThreads - 1) / kRefreshThreads;
  refresh_claim_kernel<<<blocks, kRefreshThreads, 0, st>>>(
      static_cast<const int*>(idx), n, cap, static_cast<int*>(owner),
      static_cast<const float*>(p_max_in), static_cast<float*>(p_max_out));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 1;
  refresh_write_kernel<<<blocks, kRefreshThreads, 0, st>>>(
      static_cast<float*>(prio), static_cast<const int*>(idx),
      static_cast<const float*>(abs_err), eps, n, cap, static_cast<const int*>(owner),
      static_cast<float*>(p_max_out));
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 2;
  return err;
}
