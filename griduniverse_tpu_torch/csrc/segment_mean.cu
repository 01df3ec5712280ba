// segment_mean.cu — K10: the deterministic per-(s, a) mean of α·δ.
//
// Replaces griduniverse_tpu/algos/td.py `apply_td_updates` (78) and
// `apply_td_updates_masked` (273): for each cell (s, a) of Q, the float sum
// of α·δ_b over the envs b at that cell (times the mask), the count, and
// q + sum / max(count, 1). The JAX version is two `segment_sum` scatters.
//
// Why not float atomics: with one env the result must be bit-exactly the
// sequential rule q[s,a] + α·δ, so the sum is a float sum, and a float sum
// needs a fixed order to repeat. The order here is increasing env index, the
// order of a sequential scatter.
//
// Bound on the card: latency. The inputs are 12 bytes per env and the table
// once in and once out, under 1 MB at 65,536 envs; the time is the launches
// and a few dependent passes. The earlier design gave each (s, a) segment a
// warp that walked every env's key, so its work was n_seg × batch / 32
// ballots, and its grid of n_seg / 8 blocks left most SMs idle when Q is
// small (11 blocks at S·A = 81).
//
// Design: a stable counting sort of the envs by key, then one ordered sum
// per segment; four launches, each a pass over the batch or the counters.
//   1. `segment_count_kernel`: block c takes a chunk of `chunk` envs and
//      counts its keys (s·A + a; a masked-out env has no key and is
//      dropped). Lanes with equal keys are grouped by `__match_any_sync` and
//      their leader adds the group's size, so a hot cell costs one atomic a
//      warp. The counters are a shared-memory histogram up to
//      kMaxSharedSeg segments, the block's own column of the global array
//      above that. Out: counts[k · n_chunks + c].
//   2. `segment_scan_kernel`: an exclusive scan of the counts in (segment,
//      chunk) order, one tile of 4,096 a block, across blocks by a
//      decoupled look-back (each tile publishes its sum, then its inclusive
//      prefix; a tile's number comes from an atomic ticket, so every tile it
//      waits on is running). Integer sums: exact in any order.
//   3. `segment_scatter_kernel`: block c writes α·δ of each env of its chunk
//      to counts[k · n_chunks + c] + its rank among the chunk's envs of key
//      k, taken in env order: its place in its warp's group, after the
//      chunk's earlier tiles and the tile's earlier warps (the warps take
//      their places one after the other, a barrier apart).
//   4. `segment_sum_kernel`: one warp a segment adds its contiguous run from
//      the start, in order (the lanes load 128 neighbours into shared
//      memory, and one lane adds them), and writes q + sum / max(count, 1).
// The integer counts are exact whatever the order; the float adds happen
// only in 4, in env order, so the bits are those of the plain version. A hot
// cell is still one chain of dependent adds: no order-keeping design avoids
// it. Built with -fmad=false; α·δ is one rounding and the sum adds only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 16;  // counters one thread of the scan takes
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kSumRows = 4;  // rows of 32 values a warp of the sum stages
constexpr int kMaxSharedSeg = 32768;  // segments whose counters fit shared memory (128 KB)
constexpr unsigned kFull = 0xffffffffu;
// look-back words: flag in the high half, a tile's sum or inclusive prefix below
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

extern __shared__ int seg_smem[];

// The segment of env b, or -1 past the chunk's end, where the mask is clear,
// or (for a cell outside Q) where no segment takes it.
__device__ __forceinline__ int env_key(const int* __restrict__ s, const int* __restrict__ a,
                                       const uint8_t* __restrict__ mask, int b, int end,
                                       int num_actions, int n_seg) {
  if (b >= end || (mask != nullptr && mask[b] == 0)) return -1;
  const int k = s[b] * num_actions + a[b];
  return static_cast<unsigned>(k) < static_cast<unsigned>(n_seg) ? k : -1;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_count_kernel(const int* __restrict__ s, const int* __restrict__ a,
                     const uint8_t* __restrict__ mask, int batch, int num_actions, int n_seg,
                     int chunk, int n_chunks, int* __restrict__ counts, int len,
                     unsigned long long* __restrict__ status, int n_tiles) {
  const int c = blockIdx.x;
  int* const h = kShared ? seg_smem : counts + c;
  const size_t stride = kShared ? 1 : n_chunks;
  for (int k = threadIdx.x; k < n_seg; k += kThreads) h[k * stride] = 0;
  if (c == 0) {  // the scan's look-back words, its ticket and its last counter
    for (int t = threadIdx.x; t < n_tiles; t += kThreads) status[t] = 0ull;
    if (threadIdx.x == 0) counts[len - 1] = counts[len] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int begin = c * chunk, end = min(begin + chunk, batch);
  for (int base = begin; base < end; base += kThreads) {
    const int k = env_key(s, a, mask, base + threadIdx.x, end, num_actions, n_seg);
    const unsigned peers = __match_any_sync(kFull, k);
    if (k >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[k * stride], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_seg; k += kThreads)
      counts[static_cast<size_t>(k) * n_chunks + c] = h[k];
  }
}

__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(int* __restrict__ data, int len, unsigned long long* word,
                    int* __restrict__ ticket) {
  __shared__ int sh_tile, sh_excl;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) sh_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = sh_tile;
  const size_t base = static_cast<size_t>(tile) * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < static_cast<size_t>(len) ? data[base + i] : 0;
    sum += v[i];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int warp_off = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) warp_off += warp_sum[w];
    agg += warp_sum[w];
  }
  if (threadIdx.x == 0) {
    int excl = 0;
    if (tile == 0) {
      atomicExch(word, kPrefix | static_cast<unsigned>(agg));
    } else {
      atomicExch(word + tile, kAggregate | static_cast<unsigned>(agg));
      for (int j = tile - 1;; --j) {
        unsigned long long st;
        do {
          st = *reinterpret_cast<volatile unsigned long long*>(word + j);
        } while ((st >> 32) == 0ull);
        excl += static_cast<int>(static_cast<unsigned>(st));
        if ((st & kPrefix) != 0ull) break;
      }
      atomicExch(word + tile, kPrefix | static_cast<unsigned>(excl + agg));
    }
    sh_excl = excl;
  }
  __syncthreads();
  int run = sh_excl + warp_off + incl - sum;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < static_cast<size_t>(len)) data[base + i] = run;
    run += v[i];
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_scatter_kernel(const int* __restrict__ s, const int* __restrict__ a,
                       const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                       float alpha, int batch, int num_actions, int n_seg, int chunk,
                       int n_chunks, int* __restrict__ offsets, float* __restrict__ vals) {
  const int c = blockIdx.x;
  // the chunk's next free place for each key; in global memory it is the
  // block's own column of the offsets, which it advances
  int* const run = kShared ? seg_smem : offsets + c;
  const size_t stride = kShared ? 1 : n_chunks;
  if (kShared) {
    for (int k = threadIdx.x; k < n_seg; k += kThreads)
      run[k] = offsets[static_cast<size_t>(k) * n_chunks + c];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int begin = c * chunk, end = min(begin + chunk, batch);
  for (int base = begin; base < end; base += kThreads) {
    const int b = base + threadIdx.x;
    const int k = env_key(s, a, mask, b, end, num_actions, n_seg);
    const float v = k >= 0 ? alpha * delta[b] : 0.0f;
    const unsigned peers = __match_any_sync(kFull, k);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    for (int w = 0; w < kWarps; ++w) {  // the warps in env order
      if (w == warp && lane == leader && k >= 0) {
        first = run[k * stride];
        run[k * stride] = first + __popc(peers);
      }
      __syncthreads();
    }
    first = __shfl_sync(kFull, first, leader);
    if (k >= 0) vals[first + __popc(peers & below)] = v;
  }
}

// One warp a segment. `advanced`: the scatter advanced each column of the
// offsets in place (global counters), so the start of segment k is now at
// k·n_chunks - 1 and its end at (k+1)·n_chunks - 1. The warp loads 128
// values at a time into its stage in shared memory, and lane 0 adds them
// from there, four to a load, while the next 128 are on their way: the
// chain of dependent adds sets the pace.
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ q_in, float* __restrict__ q_out,
                   const int* __restrict__ offsets, const float* __restrict__ vals, int n_seg,
                   int n_chunks, int advanced) {
  __shared__ float4 stage[kWarps][kSumRows * 8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n_seg) return;
  const size_t at = static_cast<size_t>(k) * n_chunks;
  const int begin = advanced ? (k > 0 ? offsets[at - 1] : 0) : offsets[at];
  const int end = offsets[at + n_chunks - advanced];
  float* const mine = reinterpret_cast<float*>(stage[warp]);
  float sum = 0.0f;
  float v[kSumRows];
#pragma unroll
  for (int r = 0; r < kSumRows; ++r) {
    const int i = begin + 32 * r + lane;
    v[r] = i < end ? vals[i] : 0.0f;
  }
  for (int i0 = begin; i0 < end; i0 += 32 * kSumRows) {
    float next[kSumRows];
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) {
      const int i = i0 + 32 * (kSumRows + r) + lane;
      next[r] = i < end ? vals[i] : 0.0f;
      mine[32 * r + lane] = v[r];
    }
    __syncwarp();
    if (lane == 0) {  // env order
      const int m = end - i0;
      if (m >= 32 * kSumRows) {
#pragma unroll
        for (int j = 0; j < kSumRows * 8; ++j) {
          const float4 x = stage[warp][j];
          sum = sum + x.x;
          sum = sum + x.y;
          sum = sum + x.z;
          sum = sum + x.w;
        }
      } else {
        for (int j = 0; j < m; ++j) sum = sum + mine[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) v[r] = next[r];
  }
  const int count = end - begin;
  if (lane == 0) q_out[k] = q_in[k] + sum / static_cast<float>(count > 1 ? count : 1);
}

}  // namespace

// The four kernels of one update; `*launched` counts those launched.
// `counts`: n_seg · ceil(batch / chunk) + 2 ints; `vals`: batch floats;
// `status`: one 8-byte word per scan tile of 4,096 counters.
extern "C" int gu_segment_mean(const void* q_in, void* q_out, const void* s, const void* a,
                               const void* delta, const void* mask, float alpha, int batch,
                               int num_actions, int n_seg, int chunk, void* counts, void* vals,
                               void* status, int* launched, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int n_chunks = (batch + chunk - 1) / chunk;
  const int len = n_seg * n_chunks + 1;  // the counters and the total after them
  const int n_tiles = (len + kScanTile - 1) / kScanTile;
  const bool in_shared = n_seg <= kMaxSharedSeg;
  const size_t smem = in_shared ? static_cast<size_t>(n_seg) * sizeof(int) : 0;
  auto* count = in_shared ? segment_count_kernel<true> : segment_count_kernel<false>;
  auto* scatter = in_shared ? segment_scatter_kernel<true> : segment_scatter_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int* const cnt = static_cast<int*>(counts);
  auto* const words = static_cast<unsigned long long*>(status);
  const int* const si = static_cast<const int*>(s);
  const int* const ai = static_cast<const int*>(a);
  const uint8_t* const m = static_cast<const uint8_t*>(mask);
  count<<<n_chunks, kThreads, smem, st>>>(si, ai, m, batch, num_actions, n_seg, chunk, n_chunks,
                                          cnt, len, words, n_tiles);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 1;
  segment_scan_kernel<<<n_tiles, kThreads, 0, st>>>(cnt, len, words, cnt + len);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 2;
  scatter<<<n_chunks, kThreads, smem, st>>>(si, ai, static_cast<const float*>(delta), m, alpha,
                                            batch, num_actions, n_seg, chunk, n_chunks, cnt,
                                            static_cast<float*>(vals));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  *launched = 3;
  const int sum_blocks = (n_seg + kWarps - 1) / kWarps;
  segment_sum_kernel<<<sum_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(q_in), static_cast<float*>(q_out), cnt,
      static_cast<const float*>(vals), n_seg, n_chunks, in_shared ? 0 : 1);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 4;
  return err;
}
