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
// index, so a draw is a function of its inputs alone. Keys are the
// order-preserving 32-bit images of the scores (`order_key`); every count
// is an integer, exact in any order, and the only float sum (the mass) is
// added in a fixed order.
//   1. `per_score_kernel`, one thread a slot: the score (−inf beyond `size`),
//      the mass p^α, and each block's sum of the mass by a fixed tree (no
//      float atomics), one partial a block; block 0 zeroes the histograms.
//   2. `per_hist_kernel`, four launches, one a byte of the key from the
//      top: each of cap/1,024 blocks takes the launch before's decision
//      from its histogram (a scan over the 256 digits, from the top),
//      counts the next byte of its 1,024 slots that match the prefix so far
//      in a private histogram (equal digits of a warp grouped by
//      `__match_any_sync`, one shared atomic a group), and adds the nonzero
//      bins to the global 256-bin histogram with integer atomics. The first
//      launch's block 0 also adds the partials of the mass in block order
//      from 0.0f, after loading them coalesced into shared memory.
//   3. `per_count_kernel`: the last byte's decision gives the key of the
//      n-th largest score and how many of the slots at it are picked; each
//      block counts its slots above that key and at it.
//   4. `per_compact_kernel`: each block adds the counts of the blocks before
//      it and writes its slots above the key, then its first ties, in index
//      order: the picks' keys and slots, those above the key first.
//   5. `per_finish_kernel`, one block of 512 threads: a stable LSD radix
//      sort of the picks by key, descending (four 8-bit passes; each warp
//      takes a contiguous range and ranks its items by `__match_any_sync`;
//      per-warp digit counts give every item its place; a pass whose digit
//      is the same for all picks moves nothing). Stability keeps equal keys
//      in the compaction's index order, so the order is (score descending,
//      index ascending) with no compare of indices. Then the fallback hash
//      for a pick with no mass and the max-normalised importance weights.
//      The picks' keys and two permutations sit in shared memory (12 bytes
//      a pick) up to kMaxSharedPicks = 16,384 picks. Above that the sort is
//      multi-block passes over the scratch (`pick_sort_count_kernel`,
//      `pick_sort_scan_kernel`, `pick_sort_scatter_kernel` a byte, chunks
//      of 4,096 picks), and the finish kernel only weighs.
// Eight launches a draw up to 16,384 picks, twenty above. Each byte's pass
// is a launch, not a cooperative grid barrier: a barrier would save some
// 2 µs a pass, and a launch cannot hang the card if a block is not
// resident. The first byte's histogram is not fused into the score pass: it
// must start from zero, and the score pass is the draw's first launch.
// Bound on the card: bytes, and barely: 8 bytes a slot read once (1 MB at
// 131,072 slots, 0.3 µs at the memory rate). The earlier design ran the
// whole selection in one block: four passes over all the scores, two
// compaction passes and an n² rank sort (16.8 M compares at 4,096 picks),
// with one bin's atomics serialised when the valid scores share a top byte.
// Now each pass is spread over the SMs and the sort is four passes of n.
//
// K8b. One launch writes the five fields of B transitions at `at` and fills
// the new slots' priority from the device scalar `p_max` (the reference
// makes six `dynamic_update_slice`s); one launch gathers the five fields at
// n indices; one launch writes the n refreshed priorities, where of equal
// indices the highest minibatch position wins (what a sequential scatter
// gives), and folds their maximum into `p_max`. Up to kMaxPicks = 1,024 rows
// the refresh is one block, each row scanning the later rows for its slot.
// Up to kMaxHashRows = 8,192 rows it is one launch of a thread block
// cluster (eight blocks of 1,024 threads, a row a thread) over a hash table
// of at least 2n entries spread over the blocks' shared memory and reached
// through distributed shared memory: a row claims its slot's entry with
// atomicCAS on the key and raises the entry's owner to its position with
// atomicMax; after a cluster barrier each block writes the winners of its
// own entries. The highest position wins however the table fills. Above
// that it is two launches over the rows: the first takes each slot's
// highest position by an integer atomicMax into a per-slot scratch (-1
// where untouched, filled by the wrapper) and copies the old `p_max` out; the
// second lets only that winner write, and folds each block's maximum into
// `p_max` by a compare-and-swap loop. A maximum is the same in any order, so
// every form gives the plain version's bits. The gather writes its five
// fields into one buffer the wrapper cuts into views. Bound: bytes, 17 a
// transition; all three are launches in truth.
//
// `size`, `at`, `beta` and `p_max` are read from device memory, so the
// trainer's loop never reads a value on the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kScoreThreads = 256;
constexpr int kSelThreads = 256;  // the histogram, count and compaction blocks
constexpr int kSelSlice = 1024;   // slots one of those blocks takes
constexpr int kSortThreads = 512;  // the finish block, and the multi-block sort's
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortChunk = 4096;  // picks a block of the multi-block sort takes
constexpr int kMaxSharedPicks = 16384;  // picks whose keys and permutations fit shared memory
constexpr int kMaxPicks = 1024;  // rows of a one-block refresh that scans the later rows
constexpr int kHashThreads = 1024;
constexpr int kClusterBlocks = 8;  // a thread block cluster: one row a thread
constexpr int kMaxHashRows = kClusterBlocks * kHashThreads;  // rows of a one-launch refresh
// The selection's scratch (32-bit words): four 256-bin histograms, then the
// state (the mass; after each byte, the prefix and the count still needed),
// then the blocks' counts above and at the key, then the picks' keys and
// slots (and above kMaxSharedPicks the sort's permutations and counts).
constexpr int kStateWords = 16;
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
                                 float* __restrict__ partial, uint32_t* __restrict__ hist) {
  __shared__ float red[kScoreThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kScoreThreads + tid;
  if (blockIdx.x == 0)
    for (int b = tid; b < 4 * 256; b += kScoreThreads) hist[b] = 0u;
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

static_assert(kSelThreads == 256, "a histogram block takes one digit a thread");
static_assert(256 * kSortWarps == 8 * kSortThreads, "the one-block sort scans 8 counters a thread");

// Larger key <=> smaller digit: an ascending sort on the digit is a
// descending sort on the key.
__device__ __forceinline__ int sort_digit(uint32_t key, int shift) {
  return static_cast<int>((~key >> shift) & 255u);
}

// Exclusive prefix of `v` over the block's threads in thread order, and the
// block's sum in `*total`. `tmp`: a word a warp, in shared memory.
template <int kThreadsT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int off = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreadsT / 32; ++w) {
    const int x = tmp[w];
    if (w < warp) off += x;
    sum += x;
  }
  __syncthreads();  // `tmp` may be written again
  *total = sum;
  return off + incl - v;
}

// The byte at `shift` of the need-th largest key among those that match
// `prefix` above it, from that byte's histogram: thread t takes digit
// 255 - t, so the scan counts from the top. Updates prefix and need.
__device__ void decide_byte(const uint32_t* __restrict__ hist, int shift, uint32_t& prefix,
                            uint32_t& need, int* tmp, uint32_t* sh) {
  const int d = 255 - static_cast<int>(threadIdx.x);
  const int c = static_cast<int>(hist[d]);
  int total;
  const uint32_t above = static_cast<uint32_t>(block_exclusive_scan<kSelThreads>(c, &total, tmp));
  if (above < need && above + static_cast<uint32_t>(c) >= need) {
    sh[0] = prefix | (static_cast<uint32_t>(d) << shift);
    sh[1] = need - above;
  }
  __syncthreads();
  prefix = sh[0];
  need = sh[1];
}

// One byte of the radix select. `pass` p counts byte 3 - p (from the top)
// of the slots that match the bytes decided so far; it first decides byte
// 4 - p from the launch before's histogram (block 0 keeps the decision in
// the state). Pass 0's block 0 also adds the mass.
__global__ void __launch_bounds__(kSelThreads)
per_hist_kernel(const float* __restrict__ score, int cap, int n, int pass,
                uint32_t* __restrict__ sel, const float* __restrict__ partial, int n_partial) {
  __shared__ uint32_t h[256];
  __shared__ int tmp[kSelThreads / 32];
  __shared__ uint32_t sh[2];
  __shared__ float part[kSelSlice];
  uint32_t* const state = sel + 4 * 256;
  const int tid = threadIdx.x, lane = tid & 31;
  h[tid] = 0u;
  uint32_t prefix = 0u, need = static_cast<uint32_t>(n);
  if (pass > 0) {
    if (pass > 1) {
      prefix = state[1 + 2 * (pass - 2)];
      need = state[2 + 2 * (pass - 2)];
    }
    decide_byte(sel + 256 * (pass - 1), 32 - 8 * pass, prefix, need, tmp, sh);
    if (blockIdx.x == 0 && tid == 0) {
      state[1 + 2 * (pass - 1)] = prefix;
      state[2 + 2 * (pass - 1)] = need;
    }
  }
  __syncthreads();
  const int shift = 24 - 8 * pass;
  const uint32_t mask = pass == 0 ? 0u : (kFull << (shift + 8));
  const int base = blockIdx.x * kSelSlice;
  for (int i0 = 0; i0 < kSelSlice; i0 += kSelThreads) {
    const int i = base + i0 + tid;
    int d = 256;
    if (i < cap) {
      const uint32_t k = order_key(score[i]);
      if ((k & mask) == prefix) d = static_cast<int>((k >> shift) & 255u);
    }
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[d], static_cast<uint32_t>(__popc(peers)));
  }
  __syncthreads();
  if (h[tid] != 0u) atomicAdd(&sel[256 * pass + tid], h[tid]);
  if (pass == 0 && blockIdx.x == 0) {  // the mass: the partials in block order, from 0.0f
    float s = 0.0f;
    for (int j0 = 0; j0 < n_partial; j0 += kSelSlice) {
      const int m = min(kSelSlice, n_partial - j0);
      for (int j = tid; j < m; j += kSelThreads) part[j] = partial[j0 + j];
      __syncthreads();
      if (tid == 0)
        for (int j = 0; j < m; ++j) s += part[j];
      __syncthreads();
    }
    if (tid == 0) state[0] = __float_as_uint(s);
  }
}

// The last byte's decision (the key of the n-th largest score, and how many
// slots at it are picked), then each block's count of its slots above that
// key and at it.
__global__ void __launch_bounds__(kSelThreads)
per_count_kernel(const float* __restrict__ score, int cap, uint32_t* __restrict__ sel, int nb) {
  __shared__ int tmp[kSelThreads / 32];
  __shared__ uint32_t sh[2];
  __shared__ int warp_gt[kSelThreads / 32], warp_eq[kSelThreads / 32];
  uint32_t* const state = sel + 4 * 256;
  uint32_t prefix = state[5], need = state[6];
  decide_byte(sel + 3 * 256, 0, prefix, need, tmp, sh);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[7] = prefix;
    state[8] = need;
  }
  const uint32_t kth = prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kSelSlice;
  int gt = 0, eq = 0;
  for (int i0 = 0; i0 < kSelSlice; i0 += kSelThreads) {
    const int i = base + i0 + threadIdx.x;
    const uint32_t k = i < cap ? order_key(score[i]) : 0u;
    gt += __popc(__ballot_sync(kFull, i < cap && k > kth));
    eq += __popc(__ballot_sync(kFull, i < cap && k == kth));
  }
  if (lane == 0) {
    warp_gt[warp] = gt;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = 0, e = 0;
    for (int w = 0; w < kSelThreads / 32; ++w) {
      g += warp_gt[w];
      e += warp_eq[w];
    }
    int* const counts = reinterpret_cast<int*>(state + kStateWords);
    counts[blockIdx.x] = g;
    counts[nb + blockIdx.x] = e;
  }
}

// The picks in index order: each block's slots above the key at the blocks'
// running count of them, then its slots at the key while fewer than `need`
// came before, after all those above. Warp w of a block owns 128
// consecutive slots, ranked by ballot.
__global__ void __launch_bounds__(kSelThreads)
per_compact_kernel(const float* __restrict__ score, int cap, const uint32_t* __restrict__ sel,
                   int nb, uint32_t* __restrict__ keys, int* __restrict__ ids) {
  __shared__ int tmp[kSelThreads / 32];
  __shared__ int warp_gt[kSelThreads / 32], warp_eq[kSelThreads / 32];
  const uint32_t* const state = sel + 4 * 256;
  const uint32_t kth = state[7];
  const int need = static_cast<int>(state[8]);
  const int* const block_gt = reinterpret_cast<const int*>(state + kStateWords);
  const int* const block_eq = block_gt + nb;
  const int block = static_cast<int>(blockIdx.x);
  int before_gt = 0, before_eq = 0, all_gt = 0;
  for (int j = threadIdx.x; j < nb; j += kSelThreads) {
    const int g = block_gt[j];
    all_gt += g;
    if (j < block) {
      before_gt += g;
      before_eq += block_eq[j];
    }
  }
  int off_gt, off_eq, total_gt;
  block_exclusive_scan<kSelThreads>(before_gt, &off_gt, tmp);
  block_exclusive_scan<kSelThreads>(before_eq, &off_eq, tmp);
  block_exclusive_scan<kSelThreads>(all_gt, &total_gt, tmp);

  constexpr int kSeg = kSelSlice / (kSelThreads / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int begin = min(block * kSelSlice + warp * kSeg, cap), end = min(begin + kSeg, cap);
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
  for (int j = 0; j < warp; ++j) {
    off_gt += warp_gt[j];
    off_eq += warp_eq[j];
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
      if (rank < need) {
        keys[total_gt + rank] = k;
        ids[total_gt + rank] = i;
      }
    }
    off_gt += __popc(m_gt);
    off_eq += __popc(m_eq);
  }
}

// Warp w's contiguous share of the items [begin, end), a multiple of 32 long.
__device__ __forceinline__ void warp_range(int begin, int end, int& wb, int& we) {
  const int warp = threadIdx.x >> 5;
  const int len = end - begin;
  const int per = ((len + kSortWarps - 1) / kSortWarps + 31) / 32 * 32;
  wb = begin + min(warp * per, len);
  we = begin + min((warp + 1) * per, len);
}

// hist[d · kSortWarps + w] = how many of warp w's items have digit d. An
// item j is the position src[j] (j itself where src is null).
__device__ void warp_digit_counts(const uint32_t* keys, const int* src, int begin, int end,
                                  int shift, int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 256 * kSortWarps; i += kSortThreads) hist[i] = 0;
  __syncthreads();
  int wb, we;
  warp_range(begin, end, wb, we);
  for (int j0 = wb; j0 < we; j0 += 32) {
    const int j = j0 + lane;
    const int d = j < we ? sort_digit(keys[src != nullptr ? src[j] : j], shift) : 256;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256 && lane == __ffs(peers) - 1) hist[d * kSortWarps + warp] += __popc(peers);
  }
  __syncthreads();
}

// hist[d · kSortWarps + w] holds the first place of warp w's items of digit
// d; each warp writes its items there in order, a group of equal digits at
// a time.
__device__ void warp_digit_scatter(const uint32_t* keys, const int* src, int* dst, int begin,
                                   int end, int shift, int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int wb, we;
  warp_range(begin, end, wb, we);
  for (int j0 = wb; j0 < we; j0 += 32) {
    const int j = j0 + lane;
    const int p = j < we ? (src != nullptr ? src[j] : j) : 0;
    const int d = j < we ? sort_digit(keys[p], shift) : 256;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256) dst[hist[d * kSortWarps + warp] + __popc(peers & below)] = p;
    __syncwarp();
    if (d < 256 && lane == __ffs(peers) - 1) hist[d * kSortWarps + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// One stable pass of the one-block sort: the n positions of src into dst by
// the byte at `shift` of their keys. Returns false, moving nothing, when
// every key has the same byte there.
__device__ bool block_sort_pass(const uint32_t* keys, const int* src, int* dst, int n, int shift,
                                int* hist, int* tmp) {
  warp_digit_counts(keys, src, 0, n, shift, hist);
  int* const mine = hist + threadIdx.x * 8;  // digit threadIdx.x / 2, eight warps of it
  int v[8];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = mine[i];
    sum += v[i];
  }
  if (__syncthreads_or(sum + __shfl_xor_sync(kFull, sum, 1) == n)) return false;
  int total;
  int run = block_exclusive_scan<kSortThreads>(sum, &total, tmp);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mine[i] = run;
    run += v[i];
  }
  __syncthreads();
  warp_digit_scatter(keys, src, dst, 0, n, shift, hist);
  return true;
}

// The multi-block sort, one byte: each chunk's digit counts, digit-major
// (counts[d · n_chunks + c]) ...
__global__ void __launch_bounds__(kSortThreads)
pick_sort_count_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ src, int n,
                       int shift, int n_chunks, int* __restrict__ counts) {
  __shared__ int h[256];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 256) h[threadIdx.x] = 0;
  __syncthreads();
  const int begin = blockIdx.x * kSortChunk, end = min(begin + kSortChunk, n);
  for (int j0 = begin; j0 < end; j0 += kSortThreads) {
    const int j = j0 + threadIdx.x;
    const int d = j < end ? sort_digit(keys[src != nullptr ? src[j] : j], shift) : 256;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < 256) counts[threadIdx.x * n_chunks + blockIdx.x] = h[threadIdx.x];
}

// ... their exclusive scan in that order, one block ...
__global__ void __launch_bounds__(kSortThreads)
pick_sort_scan_kernel(int* __restrict__ data, int len) {
  __shared__ int tmp[kSortWarps];
  int carry = 0;
  for (int t0 = 0; t0 < len; t0 += kSortThreads * 8) {
    const int base = t0 + threadIdx.x * 8;
    int v[8];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = base + i < len ? data[base + i] : 0;
      sum += v[i];
    }
    int total;
    int run = carry + block_exclusive_scan<kSortThreads>(sum, &total, tmp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (base + i < len) data[base + i] = run;
      run += v[i];
    }
    carry += total;
  }
}

// ... and each chunk's stable scatter from its digits' first places.
__global__ void __launch_bounds__(kSortThreads)
pick_sort_scatter_kernel(const uint32_t* __restrict__ keys, const int* src, int* dst, int n,
                         int shift, int n_chunks, const int* __restrict__ offsets) {
  __shared__ int hist[256 * kSortWarps];
  const int begin = blockIdx.x * kSortChunk, end = min(begin + kSortChunk, n);
  warp_digit_counts(keys, src, begin, end, shift, hist);
  if (threadIdx.x < 256) {
    int run = offsets[threadIdx.x * n_chunks + blockIdx.x];
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = hist[threadIdx.x * kSortWarps + w];
      hist[threadIdx.x * kSortWarps + w] = run;
      run += c;
    }
  }
  __syncthreads();
  warp_digit_scatter(keys, src, dst, begin, end, shift, hist);
}

// One block: the sort of the picks (kSort: in shared memory; else `g_perm`
// holds their sorted positions), then the fallback hash for a pick with no
// mass and the max-normalised importance weights.
template <bool kSort>
__global__ void __launch_bounds__(kSortThreads)
per_finish_kernel(const float* __restrict__ prio, const int64_t* __restrict__ size_p,
                  const float* __restrict__ beta_p, float alpha, int n,
                  const uint32_t* __restrict__ sel, const uint32_t* __restrict__ g_keys,
                  const int* __restrict__ g_ids, const int* __restrict__ g_perm,
                  int* __restrict__ idx_out, float* __restrict__ w_out) {
  __shared__ int tmp[kSortWarps];
  __shared__ float red[kSortWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* perm = g_perm;
  if (kSort) {
    uint32_t* const keys = reinterpret_cast<uint32_t*>(pick_smem);
    int* src = reinterpret_cast<int*>(keys + n);
    int* dst = src + n;
    int* const hist = dst + n;
    for (int t = tid; t < n; t += kSortThreads) {
      keys[t] = g_keys[t];
      src[t] = t;
    }
    __syncthreads();
    for (int shift = 0; shift < 32; shift += 8) {
      if (block_sort_pass(keys, src, dst, n, shift, hist, tmp)) {
        int* const moved = dst;
        dst = src;
        src = moved;
      }
    }
    perm = src;
  }

  const int64_t size = *size_p;
  const int64_t size1 = size > 1 ? size : 1;
  const float beta = *beta_p;
  const float mass = __uint_as_float(sel[4 * 256]);
  // pick t's slot, whether it has mass, and its weight before the normalisation
  auto weigh = [&](int t, int& id, bool& ok) {
    id = g_ids[perm[t]];
    const float pa = id < size ? expf(slot_logp(prio[id], alpha)) : 0.0f;
    ok = pa > 0.0f;
    const float p_sel = pa / fmaxf(mass, 1e-30f);
    return powf(static_cast<float>(size1) * p_sel, -beta);
  };
  float w_max = 0.0f;
#pragma unroll 4
  for (int t = tid; t < n; t += kSortThreads) {
    int id;
    bool ok;
    const float w = weigh(t, id, ok);
    if (ok) w_max = fmaxf(w_max, w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w_max = fmaxf(w_max, __shfl_xor_sync(kFull, w_max, o));
  if (lane == 0) red[warp] = w_max;
  __syncthreads();
  float top = 0.0f;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) top = fmaxf(top, red[w]);
#pragma unroll 4
  for (int t = tid; t < n; t += kSortThreads) {
    int id;
    bool ok;
    const float w = weigh(t, id, ok);
    const uint32_t h = static_cast<uint32_t>(id) * 2654435761u + static_cast<uint32_t>(t);
    const int fallback = static_cast<int>(h % static_cast<uint32_t>(size1));
    idx_out[t] = ok ? id : fallback;
    w_out[t] = ok ? w / fmaxf(top, 1e-30f) : 1.0f;
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

// The refresh above kMaxHashRows rows, first launch: each slot's highest row
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

// The refresh of kMaxPicks < n <= kMaxHashRows rows in one launch: one
// cluster of kClusterBlocks blocks, a row a thread, over a hash table of
// 2^log2_entries entries spread over the blocks' shared memory (block b
// holds entries b·E/8 .. (b+1)·E/8 − 1), which each block reaches through
// distributed shared memory. An entry is a key (the slot, -1 where empty)
// and an owner (the highest row of the slot). Linear probing from a
// multiplicative hash; the table holds at least 2n entries, so a probe
// ends. After the claims each block writes the winners of its own entries,
// so no block reads another's memory after the second cluster barrier and
// none waits for a third; the blocks' maxima go into `p_max` by a
// compare-and-swap loop. The loads of the rows and the scattered writes
// are spread over the cluster's SMs.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kHashThreads)
prio_refresh_hash_kernel(float* __restrict__ prio, const int* __restrict__ idx,
                         const float* __restrict__ abs_err, float eps, int n, int cap,
                         int log2_entries, const float* __restrict__ p_max_in,
                         float* __restrict__ p_max_out) {
  namespace cg = cooperative_groups;
  extern __shared__ int table[];
  __shared__ float red[kHashThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int log2_local = log2_entries - 3;  // kClusterBlocks = 8 blocks
  const int local_entries = 1 << log2_local;
  int* const keys = table;
  int* const owner = table + local_entries;
  const int tid = threadIdx.x;
  const int i = rank * kHashThreads + tid;
  const int slot = i < n ? idx[i] : -1;
  float fresh = i < n ? abs_err[i] + eps : -INFINITY;
  for (int k = tid; k < local_entries; k += kHashThreads) {
    keys[k] = -1;
    owner[k] = -1;
  }
  if (rank == 0 && tid == 0) *p_max_out = *p_max_in;
  cluster.sync();  // every block's entries are empty, and the old p_max is out
  const bool valid = slot >= 0 && slot < cap;
  uint32_t h = (static_cast<uint32_t>(slot) * 2654435761u) >> (32 - log2_entries);
  while (valid) {
    const unsigned block = h >> log2_local;
    const int k = static_cast<int>(h & (local_entries - 1));
    const int seen = atomicCAS(cluster.map_shared_rank(keys, block) + k, -1, slot);
    if (seen == -1 || seen == slot) {
      atomicMax(cluster.map_shared_rank(owner, block) + k, i);
      break;
    }
    h = (h + 1) & ((1u << log2_entries) - 1);
  }
  cluster.sync();  // every claim is in; from here each block reads only its own entries
  for (int k = tid; k < local_entries; k += kHashThreads) {
    if (keys[k] >= 0) prio[keys[k]] = abs_err[owner[k]] + eps;  // the slot's highest row
  }
  float top = fresh;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
  if ((tid & 31) == 0) red[tid >> 5] = top;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kHashThreads / 32; ++w) top = fmaxf(top, red[w]);
    atomic_fmax(p_max_out, top);  // block 0 wrote the old p_max before the first sync
  }
}

}  // namespace

// The kernels of one draw; `*launched` counts those launched: eight up to
// kMaxSharedPicks picks, twenty above. `scratch` (32-bit words): 4·256 +
// kStateWords + 2·ceil(cap / kSelSlice) + 2n, and above kMaxSharedPicks
// picks 2n + 256·ceil(n / kSortChunk) more.
extern "C" int gu_per_sample(const void* prio, const void* noise, const void* size,
                             const void* beta, float alpha, int cap, int n,
                             void* score, void* partial, void* idx_out, void* w_out,
                             void* scratch, int* launched, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int score_blocks = (cap + kScoreThreads - 1) / kScoreThreads;
  const int sel_blocks = (cap + kSelSlice - 1) / kSelSlice;
  auto* const sel = static_cast<uint32_t*>(scratch);
  uint32_t* const keys = sel + 4 * 256 + kStateWords + 2 * sel_blocks;
  int* const ids = reinterpret_cast<int*>(keys + n);
  int* const perm_a = ids + n;
  int* const perm_b = perm_a + n;
  int* const counts = perm_b + n;
  const auto* const sc = static_cast<const float*>(score);
  const auto* const pr = static_cast<const float*>(prio);
  const auto* const sz = static_cast<const int64_t*>(size);
  const auto* const be = static_cast<const float*>(beta);
  auto* const idx = static_cast<int*>(idx_out);
  auto* const w = static_cast<float*>(w_out);
  int err = 0;
  auto launched_ok = [&]() {
    err = static_cast<int>(cudaGetLastError());
    if (err == 0) ++*launched;
    return err == 0;
  };
  per_score_kernel<<<score_blocks, kScoreThreads, 0, st>>>(
      pr, static_cast<const float*>(noise), sz, alpha, cap, static_cast<float*>(score),
      static_cast<float*>(partial), sel);
  if (!launched_ok()) return err;
  for (int pass = 0; pass < 4; ++pass) {
    per_hist_kernel<<<sel_blocks, kSelThreads, 0, st>>>(sc, cap, n, pass, sel,
                                                        static_cast<const float*>(partial),
                                                        score_blocks);
    if (!launched_ok()) return err;
  }
  per_count_kernel<<<sel_blocks, kSelThreads, 0, st>>>(sc, cap, sel, sel_blocks);
  if (!launched_ok()) return err;
  per_compact_kernel<<<sel_blocks, kSelThreads, 0, st>>>(sc, cap, sel, sel_blocks, keys, ids);
  if (!launched_ok()) return err;
  if (n <= kMaxSharedPicks) {
    constexpr size_t kHistBytes = 256 * kSortWarps * sizeof(int);
    err = static_cast<int>(cudaFuncSetAttribute(per_finish_kernel<true>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                kMaxSharedPicks * 12 + kHistBytes));
    if (err != 0) return err;
    per_finish_kernel<true><<<1, kSortThreads, static_cast<size_t>(n) * 12 + kHistBytes, st>>>(
        pr, sz, be, alpha, n, sel, keys, ids, nullptr, idx, w);
    launched_ok();
    return err;
  }
  const int n_chunks = (n + kSortChunk - 1) / kSortChunk;
  const int* src = nullptr;  // the compaction's order
  int* dst = perm_a;
  for (int shift = 0; shift < 32; shift += 8) {
    pick_sort_count_kernel<<<n_chunks, kSortThreads, 0, st>>>(keys, src, n, shift, n_chunks,
                                                              counts);
    if (!launched_ok()) return err;
    pick_sort_scan_kernel<<<1, kSortThreads, 0, st>>>(counts, 256 * n_chunks);
    if (!launched_ok()) return err;
    pick_sort_scatter_kernel<<<n_chunks, kSortThreads, 0, st>>>(keys, src, dst, n, shift,
                                                                n_chunks, counts);
    if (!launched_ok()) return err;
    src = dst;
    dst = dst == perm_a ? perm_b : perm_a;
  }
  per_finish_kernel<false><<<1, kSortThreads, 0, st>>>(pr, sz, be, alpha, n, sel, keys, ids, src,
                                                       idx, w);
  launched_ok();
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

// `out`: obs, action, reward and next_obs (n 4-byte words each), then done
// (n bytes).
extern "C" int gu_replay_gather(const void* obs, const void* action, const void* reward,
                                const void* next_obs, const void* done, const void* idx,
                                int n, int cap, void* out, void* stream) {
  constexpr int threads = 256;
  auto* const words = static_cast<int*>(out);
  replay_gather_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(obs), static_cast<const int*>(action),
      static_cast<const float*>(reward), static_cast<const int*>(next_obs),
      static_cast<const uint8_t*>(done), static_cast<const int*>(idx), n, cap, words,
      words + n, reinterpret_cast<float*>(words + 2 * static_cast<size_t>(n)),
      words + 3 * static_cast<size_t>(n),
      reinterpret_cast<uint8_t*>(words + 4 * static_cast<size_t>(n)));
  return static_cast<int>(cudaGetLastError());
}

// One launch up to kMaxHashRows rows, two above (`owner`: cap ints, all -1;
// unused, may be null, up to kMaxHashRows); `*launched` counts them.
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
  if (n <= kMaxHashRows) {
    int log2_entries = 1;
    while ((1 << log2_entries) < 2 * n) ++log2_entries;
    // two ints an entry, an eighth of the entries a block: 16 KB at the limit
    const size_t bytes = 2 * sizeof(int) << (log2_entries - 3);
    prio_refresh_hash_kernel<<<kClusterBlocks, kHashThreads, bytes, st>>>(
        static_cast<float*>(prio), static_cast<const int*>(idx),
        static_cast<const float*>(abs_err), eps, n, cap, log2_entries,
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
