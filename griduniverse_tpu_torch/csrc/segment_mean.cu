// segment_mean.cu — K10: the deterministic per-(s, a) mean of α·δ.
//
// Replaces griduniverse_tpu/algos/td.py `apply_td_updates` (78) and
// `apply_td_updates_masked` (273): for each cell (s, a) of Q, the float sum
// of α·δ_b over the envs b at that cell (times the mask), the count, and
// q + sum / max(count, 1). The JAX version is two `segment_sum` scatters.
// The sums form (`gu_segment_sums`, `kSums`) stops before the divide and
// writes each segment's sum and count, for the sharded learner to sum over
// the ranks (griduniverse_tpu/parallel/learner.py:179-185, the
// `segment_sum`s before the `psum`) and then add the mean; followed by that
// apply in a world of one, it gives K10's bits.
//
// Why not float atomics: with one env the result must be bit-exactly the
// sequential rule q[s,a] + α·δ, so the sum is a float sum, and a float sum
// needs a fixed order to repeat. The order here is increasing env index, the
// order of a sequential scatter: a stable counting sort of the envs by key
// (s·A + a; a masked-out env, or a cell outside Q, has none), then one
// ordered sum a segment from 0.0. The integer counts are exact in any order;
// the float adds happen only in the sum, in env order, so the bits are those
// of the plain version. Built with -fmad=false: α·δ is one rounding and the
// sum adds only.
//
// Bound on the card: the bytes (12 an env, the table once each way: under
// 1 MB at 65,536 envs, 0.24 µs) and, on a hot cell, the chain of dependent
// adds of that cell's run (59,000 adds at 4 cycles, about 0.12 ms): no
// order-keeping design avoids it. What a call costs above that is its
// launches and the waits between dependent steps.
//
// Two tiers, picked by shape in `kernels/segment_mean.py` `plan`:
//
// The cluster tier (`segment_cluster_kernel`): ONE launch, a thread-block
// cluster of 1-16 blocks of 512 threads, block r taking a contiguous range
// of at most 8,192 envs (sixteen a thread, in registers) and owning a
// contiguous range of ⌈S·A / blocks⌉ segments. Four steps, two cluster
// barriers in all (a block barrier where the cluster is one block), where
// the four passes below wait for a launch each:
//   1. Count and rank: warp w of a block takes a contiguous part of the
//      block's envs, 32 a round, and counts them in a histogram of its own
//      (a 16-bit count a segment). A round's lanes of equal keys find each
//      other in shared memory (each sets its bit in the warp's mask word of
//      its key and reads the word back), and the group's leader reads the
//      warp's count of the key and advances it: an env's rank among the
//      warp's envs of its key is that count plus its place in its group.
//      Env order, no atomic on a count, no block barrier a round, and a
//      cost that does not grow with the distinct keys of a warp (a ballot a
//      key bit, or `__match_any_sync`, measured slower: PERF.md, PR 25). A
//      scan of each segment's counts over the 16 warps gives the block's
//      histogram and, in place of each warp's count, its offset.
//   2. Scan, the same in every block: thread t reads segments [8t, 8t + 8)
//      in every block's histogram through distributed shared memory, 16
//      bytes a block, each block starting at its own and taking the others
//      in turn after it (all blocks reading block 0 first made one SM serve
//      every reader: 8,600 cycles against 190); a block scan gives each
//      segment's start in the sorted order and this block's offset in each.
//      Integer sums, no look-back, no global ticket, and no cluster barrier
//      after it: no block writes what another reads in it.
//   3. Scatter: each env's α·δ goes to its block's offset for its key plus
//      its rank: into the shared memory of the block that owns the key where
//      that owner's run fits there, else into a scratch in device memory (B
//      floats, in L2), at its place in the sorted order.
//   4. Sum: each thread of an owner takes a contiguous run of its segments
//      and adds their values in order from 0.0, sixteen loaded ahead of the
//      sixteen being added, so the chain of adds sets the pace; a run in
//      device memory is streamed through shared memory 8,192 at a time, the
//      next chunk's loads in flight under the adds. It writes the sum and
//      count (kSums) or q + sum / max(count, 1), q staged in shared memory
//      before the last barrier.

// The passes (`segment_launches`), for what a cluster cannot hold (more
// than 131,072 envs, or S·A above 2,048, whose warps' histograms and lane
// masks outgrow a block's shared memory): four launches, each a pass over the
// batch or the counters, each waiting for the last one's last block.
//   1. `segment_count_kernel`: block c takes a chunk of `chunk` envs and
//      counts its keys, one atomic a warp's group. The counters are a
//      shared-memory histogram up to kMaxSharedSeg segments, the block's own
//      column of the global array above that. Out: counts[k · n_chunks + c].
//   2. `segment_scan_kernel`: an exclusive scan of the counts in (segment,
//      chunk) order, one tile of 4,096 a block, across blocks by a
//      decoupled look-back (each tile publishes its sum, then its inclusive
//      prefix; a tile's number comes from an atomic ticket, so every tile it
//      waits on is running).
//   3. `segment_scatter_kernel`: block c writes α·δ of each env of its chunk
//      to counts[k · n_chunks + c] + its rank among the chunk's envs of key
//      k, taken in env order: its place in its warp's group, after the
//      chunk's earlier tiles and the tile's earlier warps (the warps take
//      their places one after the other, a barrier apart).
//   4. `segment_sum_kernel`: one warp a segment adds its contiguous run from
//      the start, in order (the lanes load 128 neighbours into shared
//      memory, and one lane adds them), and writes q + sum / max(count, 1),
//      or in the sums form the sum and the count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

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
// kSums: write the sum to q_out and the count to counts_out (the sums
// form), else q_in + sum / max(count, 1) to q_out.
template <bool kSums>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ q_in, float* __restrict__ q_out,
                   int* __restrict__ counts_out, const int* __restrict__ offsets,
                   const float* __restrict__ vals, int n_seg, int n_chunks, int advanced) {
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
  if (lane == 0) {
    if (kSums) {
      q_out[k] = sum;
      counts_out[k] = count;
    } else {
      q_out[k] = q_in[k] + sum / static_cast<float>(count > 1 ? count : 1);
    }
  }
}


// ---------------------------------------------------------------------------
// The cluster tier: one launch.

constexpr int kCThreads = 512;  // a block of the cluster tier: 128 registers a thread
constexpr int kCWarps = kCThreads / 32;
constexpr int kCRounds = 16;  // envs a thread at most: 8,192 a block, 512 a warp
constexpr int kMaxCluster = 16;
constexpr int kChunk = 8192;  // floats of a run in device memory streamed a step

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~static_cast<size_t>(15); }

// A region that first holds the warps' histograms (a 16-bit count a warp
// and segment) and their masks of the lanes that hold each segment in a
// round (32 bits a warp and segment), and then the stage of the owner's
// values (at least two chunks of a streamed run).
__host__ __device__ constexpr size_t cluster_region_bytes(int n_seg) {
  return align16(6ull * kCWarps * n_seg) > 8ull * kChunk ? align16(6ull * kCWarps * n_seg) : 8ull * kChunk;
}

// The shared memory of a cluster block, in this order: the block's
// histogram (a 16-bit count a segment, read by every block of the
// cluster), where each segment's values of this block go, the segments'
// starts in the sorted order, and the region.
__host__ __device__ constexpr size_t cluster_shared_bytes(int n_seg) {
  return align16(2ull * n_seg) + align16(4ull * n_seg) + align16(4ull * (n_seg + 1)) +
         cluster_region_bytes(n_seg);
}

struct ClusterLayout {
  unsigned short* h;
  int* off;
  int* start;
  unsigned short* hist;  // [kCWarps][n_seg]
  unsigned* lanes;       // [kCWarps][n_seg], after the histograms
  float* stage;
  int cap;  // values the stage holds
};

__device__ __forceinline__ ClusterLayout cluster_layout(int n_seg) {
  char* p = reinterpret_cast<char*>(seg_smem);
  ClusterLayout l;
  l.h = reinterpret_cast<unsigned short*>(p);
  p += align16(2ull * n_seg);
  l.off = reinterpret_cast<int*>(p);
  p += align16(4ull * n_seg);
  l.start = reinterpret_cast<int*>(p);
  p += align16(4ull * (n_seg + 1));
  l.hist = reinterpret_cast<unsigned short*>(p);
  l.lanes = reinterpret_cast<unsigned*>(p + 2ull * kCWarps * n_seg);
  l.stage = reinterpret_cast<float*>(p);
  l.cap = static_cast<int>(cluster_region_bytes(n_seg) / 4);
  return l;
}

// sum + p[0] + p[1] + ... + p[n-1], in that order. From a 16-byte boundary
// on, sixteen values are loaded (four float4s) while the sixteen before
// them are added, so the chain of dependent adds sets the pace.
__device__ __forceinline__ float add_run(float sum, const float* p, int n) {
  int i = 0;
  const int lead = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4));
  for (; i < lead; ++i) sum = sum + p[i];
  const float4* q = reinterpret_cast<const float4*>(p + i);
  const int groups = (n - i) / 16;
  if (groups > 0) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = q[u];
    for (int g = 0; g < groups; ++g) {
      float4 y[4];
      if (g + 1 < groups) {
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = q[4 * (g + 1) + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum = sum + x[u].x;
        sum = sum + x[u].y;
        sum = sum + x[u].z;
        sum = sum + x[u].w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = y[u];
    }
    i += 16 * groups;
  }
  for (; i < n; ++i) sum = sum + p[i];
  return sum;
}

// One thread's walk over its segments [k, last) of the sorted order: the
// segment being added, where its run ends, its sum so far.
struct SegWalk {
  int k, last, end;
  float sum;
};

// Write segment w.k's sum and count (kSums) or q + sum / max(count, 1), q
// from `q_own` (the block's segments' q, from `seg0` on), and go on to the
// next segment.
template <bool kSums>
__device__ __forceinline__ void emit(SegWalk& w, const int* start, const float* q_own, int seg0, float* out,
                                     int* counts_out) {
  const int count = start[w.k + 1] - start[w.k];
  if (kSums) {
    out[w.k] = w.sum;
    counts_out[w.k] = count;
  } else {
    out[w.k] = q_own[w.k - seg0] + w.sum / static_cast<float>(count > 1 ? count : 1);
  }
  ++w.k;
  w.sum = 0.0f;
}

// Add the values [lo, hi) of the sorted order, which `buf` holds from c0
// on, to the walk, finishing (and writing) each segment whose run ends
// there.
template <bool kSums>
__device__ __forceinline__ void walk(SegWalk& w, const float* buf, int c0, int lo, int hi, const int* start,
                                     const float* q_own, int seg0, float* out, int* counts_out) {
  for (int j = lo; j < hi;) {
    while (j == w.end) {
      emit<kSums>(w, start, q_own, seg0, out, counts_out);
      w.end = start[w.k + 1];
    }
    const int stop = min(hi, w.end);
    w.sum = add_run(w.sum, buf + (j - c0), stop - j);
    j = stop;
  }
}

constexpr int kKeyBits = 12;  // S·A below 4,096, a rank below 8,192 above it
constexpr int kMaxSegments = 2048;  // S·A of the cluster tier at most (the plan's MAX_CLUSTER_SEGMENTS)
constexpr int kMaxOwnedThread = kMaxSegments / kCThreads;  // a block's segments a thread

// Where segment k's values of this block go, packed: the owner o and the
// offset in its stage (o << 20 | offset) where the owner's run fits its
// shared memory, else 1 << 24 | the place in the sorted order.
constexpr int kInDevice = 1 << 24;
constexpr int kPlaceMask = (1 << 20) - 1;

// The cluster's barrier, or the block's where the cluster is one block.
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cluster, int blocks) {
  if (blocks == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// The cluster's blocks split the envs into ranges of `per_block` and own
// ranges of `owned` segments (the last ones fewer or none).
template <bool kSums>
__global__ void __launch_bounds__(kCThreads, 1)
segment_cluster_kernel(const float* __restrict__ q_in, float* __restrict__ out,
                       int* __restrict__ counts_out, const int* __restrict__ s,
                       const int* __restrict__ a, const float* __restrict__ delta,
                       const uint8_t* __restrict__ mask, float alpha, int batch, int num_actions,
                       int n_seg, int per_block, int owned, float* __restrict__ vals) {
  const cg::cluster_group cluster = cg::this_cluster();
  __shared__ int warp_sum[kCWarps];
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const ClusterLayout l = cluster_layout(n_seg);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;

  {  // the warps' histograms and lane masks to 0, sixteen bytes a store
    uint4* const z = reinterpret_cast<uint4*>(l.hist);
    const int words = static_cast<int>(align16(6ull * kCWarps * n_seg) / 16);
    for (int i = t; i < words; i += kCThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // warp w takes envs [w0, w1) of the block's, 32 a round; an env's key and
  // rank are packed in one word (-1 for an env without a key). Every load
  // of the envs is issued before any is used.
  const int e0 = min(r * per_block, batch), e1 = min(e0 + per_block, batch);
  const int span = ((e1 - e0 + kCThreads - 1) / kCThreads) * 32;
  const int w0 = e0 + warp * span, w1 = min(w0 + span, e1);
  const int rounds = span / 32;
  int kr[kCRounds];
  float val[kCRounds];
#pragma unroll
  for (int i = 0; i < kCRounds; ++i) {
    const int b = w0 + 32 * i + lane;
    const bool in = i < rounds && b < w1;
    const int sb = in ? s[b] : 0, ab = in ? a[b] : 0;
    const bool on = in && (mask == nullptr || mask[b] != 0);
    val[i] = in ? delta[b] : 0.0f;
    const int k = sb * num_actions + ab;
    kr[i] = on && static_cast<unsigned>(k) < static_cast<unsigned>(n_seg) ? k : -1;
  }
#pragma unroll
  for (int i = 0; i < kCRounds; ++i) val[i] = alpha * val[i];
  __syncthreads();

  // 1. Count and rank. Each warp counts its envs in its own histogram, in
  // env order: a group of equal keys takes its place after the warp's
  // earlier envs of that key, its leader advancing the count. The group is
  // found in shared memory: each lane sets its bit in the warp's mask word
  // of its key, and reads the word back; the leader clears it.
  unsigned short* const mine = l.hist + static_cast<size_t>(warp) * n_seg;
  unsigned* const held = l.lanes + static_cast<size_t>(warp) * n_seg;
#pragma unroll
  for (int i = 0; i < kCRounds; ++i) {
    if (i < rounds) {
      const int k = kr[i];
      if (k >= 0) atomicOr(held + k, 1u << lane);
      __syncwarp();
      const unsigned peers = k >= 0 ? held[k] : 0u;
      const int leader = __ffs(peers) - 1;
      const bool leads = k >= 0 && lane == leader;
      const int first = __shfl_sync(kFull, leads ? static_cast<int>(mine[k]) : 0, max(leader, 0));
      if (leads) {
        mine[k] = static_cast<unsigned short>(first + __popc(peers));
        held[k] = 0u;
      }
      if (k >= 0) kr[i] = k | ((first + __popc(peers & below)) << kKeyBits);
      __syncwarp();
    }
  }
  __syncthreads();
  // each segment's count over the warps: the block's histogram, and each
  // warp's offset in place of its count
  for (int k = t; k < n_seg; k += kCThreads) {
    int c[kCWarps];
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) c[w] = l.hist[w * n_seg + k];
    int run = 0;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      l.hist[w * n_seg + k] = static_cast<unsigned short>(run);
      run += c[w];
    }
    l.h[k] = static_cast<unsigned short>(run);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCRounds; ++i) {
    if (i < rounds && kr[i] >= 0) kr[i] += mine[kr[i] & ((1 << kKeyBits) - 1)] << kKeyBits;
  }
  cluster_barrier(cluster, blocks);  // every block's histogram is complete; the regions are free

  // 2. Scan, the same in every block: thread t takes segments [8t, 8t + 8)
  // and reads their counts in every block's histogram (sixteen bytes a
  // block, block r starting at its own and the others in turn after it, so
  // that no block serves every reader at once), keeping this block's offset
  // within each segment and the segment's total; a block scan of the totals
  // gives each segment's start in the sorted order. The mean form's q of
  // this block's segments is loaded meanwhile.
  const int seg0 = min(r * owned, n_seg), seg1 = min(seg0 + owned, n_seg);
  float q_mine[kMaxOwnedThread];
#pragma unroll
  for (int u = 0; u < kMaxOwnedThread; ++u) {
    const int k = seg0 + t + u * kCThreads;
    q_mine[u] = !kSums && k < seg1 ? q_in[k] : 0.0f;
  }
  const int i0 = min(8 * t, n_seg), i1 = min(i0 + 8, n_seg);
  int pre[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tot[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (i0 < i1) {
    const uint4* const h8 = reinterpret_cast<const uint4*>(l.h + i0);
#pragma unroll 4
    for (int j = 0; j < blocks; ++j) {
      const int q = r + j < blocks ? r + j : r + j - blocks;
      const uint4 c = j == 0 ? *h8 : *cluster.map_shared_rank(h8, q);
      const unsigned v[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = static_cast<int>((v[u >> 1] >> (16 * (u & 1))) & 0xffffu);
        pre[u] += q < r ? n : 0;
        tot[u] += n;
      }
    }
  }
  int part = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) part += i0 + u < i1 ? tot[u] : 0;
  int incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int excl = incl - part, all = 0;
#pragma unroll
  for (int w = 0; w < kCWarps; ++w) {
    if (w < warp) excl += warp_sum[w];
    all += warp_sum[w];
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (i0 + u < i1) {
      l.start[i0 + u] = excl;
      l.off[i0 + u] = excl + pre[u];
      excl += tot[u];
    }
  }
  if (t == 0) l.start[n_seg] = all;
  __syncthreads();
  // each segment's destination for this block's values
  for (int k = t; k < n_seg; k += kCThreads) {
    const int o = k / owned;
    const int base = l.start[o * owned];
    l.off[k] = l.start[min((o + 1) * owned, n_seg)] - base <= l.cap ? o << 20 | (l.off[k] - base)
                                                                  : kInDevice | l.off[k];
  }
  __syncthreads();

  // 3. Scatter, into the owner's shared memory where its run fits the
  // stage, else into the scratch at the value's place in the sorted order.
#pragma unroll
  for (int i = 0; i < kCRounds; ++i) {
    if (i < rounds && kr[i] >= 0) {
      const int d = l.off[kr[i] & ((1 << kKeyBits) - 1)];
      const int place = (d & kPlaceMask) + (kr[i] >> kKeyBits);
      if (d >= kInDevice) {
        __stcg(vals + place, val[i]);
      } else if ((d >> 20) == r) {
        l.stage[place] = val[i];
      } else {
        *cluster.map_shared_rank(l.stage + place, d >> 20) = val[i];
      }
    }
  }
  // 4. Sum: this block's segments [seg0, seg1), values [start[seg0],
  // start[seg1]); thread t's segments a contiguous part [j0, j1) of them.
  // In the mean form their q goes where the destinations were.
  const int each = (seg1 - seg0 + kCThreads - 1) / kCThreads;
  const int j0 = min(seg0 + t * each, seg1), j1 = min(j0 + each, seg1);
  SegWalk w{j0, j1, j0 < j1 ? l.start[j0 + 1] : 0, 0.0f};
  float* const q_own = reinterpret_cast<float*>(l.off);
  __syncthreads();  // every destination read
  if (!kSums) {
#pragma unroll
    for (int u = 0; u < kMaxOwnedThread; ++u) {
      const int k = seg0 + t + u * kCThreads;
      if (k < seg1) q_own[k - seg0] = q_mine[u];
    }
  }
  cluster_barrier(cluster, blocks);  // every value is in its place; no block reads another's memory after this

  const int base = l.start[seg0], run = l.start[seg1] - base;
  const int lo = l.start[j0] - base, hi = l.start[j1] - base;
  if (run <= l.cap) {
    walk<kSums>(w, l.stage, base, lo + base, hi + base, l.start, q_own, seg0, out, counts_out);
  } else {  // the run in device memory, through the two halves of the stage
    const float* const g = vals + base;
    constexpr int kPer = kChunk / kCThreads;
    float next[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = u * kCThreads + t;
      if (x < run) l.stage[x] = __ldcg(g + x);
    }
    __syncthreads();
    const int chunks = (run + kChunk - 1) / kChunk;
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * kChunk;
      const bool more = c + 1 < chunks;
      if (more) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int x = c0 + kChunk + u * kCThreads + t;
          next[u] = x < run ? __ldcg(g + x) : 0.0f;
        }
      }
      walk<kSums>(w, l.stage + (c & 1) * kChunk, base + c0, base + max(lo, c0), base + min(hi, c0 + kChunk),
                  l.start, q_own, seg0, out, counts_out);
      if (more) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) l.stage[((c + 1) & 1) * kChunk + u * kCThreads + t] = next[u];
      }
      __syncthreads();
    }
  }
  while (w.k < w.last) emit<kSums>(w, l.start, q_own, seg0, out, counts_out);
}

}  // namespace

namespace {

// The four kernels; the last writes Q (`counts_out` null) or, in the sums
// form, the sums to `q_out` and the counts to `counts_out`.
int segment_launches(const void* q_in, void* q_out, int* counts_out, const void* s, const void* a,
                     const void* delta, const void* mask, float alpha, int batch, int num_actions,
                     int n_seg, int chunk, void* counts, void* vals, void* status, int* launched,
                     void* stream) {
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
  auto* sum = counts_out != nullptr ? segment_sum_kernel<true> : segment_sum_kernel<false>;
  sum<<<sum_blocks, kThreads, 0, st>>>(static_cast<const float*>(q_in),
                                       static_cast<float*>(q_out), counts_out, cnt,
                                       static_cast<const float*>(vals), n_seg, n_chunks,
                                       in_shared ? 0 : 1);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 4;
  return err;
}


// The cluster kernel `fn` on the current device: its dynamic shared-memory
// limit raised to `bytes` and clusters above eight blocks allowed, each set
// once, so that a launch that needs nothing new (a captured one after its
// warm-up) calls no attribute setter.
struct ClusterAttrs {
  const void* fn;
  int device;
  size_t bytes;
};
ClusterAttrs cluster_seen[16];
int cluster_count = 0;
std::mutex cluster_mu;

cudaError_t cluster_attributes(const void* fn, size_t bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cluster_mu);
  ClusterAttrs* seen = nullptr;
  for (int i = 0; i < cluster_count; ++i) {
    if (cluster_seen[i].fn == fn && cluster_seen[i].device == device) seen = &cluster_seen[i];
  }
  if (seen == nullptr) {
    if (cluster_count == 16) return cudaErrorInvalidValue;  // more (kernel, device) pairs than there are
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    seen = &cluster_seen[cluster_count++];
    *seen = ClusterAttrs{fn, device, 0};
  }
  if (bytes > seen->bytes) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    seen->bytes = bytes;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int blocks, size_t bytes, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of `segment_cluster_kernel` on a cluster of `blocks`.
int cluster_launch(const void* q_in, void* out, int* counts_out, const void* s, const void* a,
                   const void* delta, const void* mask, float alpha, int batch, int num_actions,
                   int n_seg, int blocks, void* vals, void* stream) {
  const int per_block = (batch + blocks - 1) / blocks;
  if (blocks < 1 || blocks > kMaxCluster || per_block > kCRounds * kCThreads || n_seg < 1 ||
      n_seg > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = cluster_shared_bytes(n_seg);
  auto* fn = counts_out != nullptr ? segment_cluster_kernel<true> : segment_cluster_kernel<false>;
  cudaError_t err = cluster_attributes(reinterpret_cast<const void*>(fn), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(blocks, bytes, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float*>(q_in), static_cast<float*>(out), counts_out,
                           static_cast<const int*>(s), static_cast<const int*>(a),
                           static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), alpha,
                           batch, num_actions, n_seg, per_block, (n_seg + blocks - 1) / blocks,
                           static_cast<float*>(vals));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four kernels of one update; `*launched` counts those launched.
// `counts`: n_seg · ceil(batch / chunk) + 2 ints; `vals`: batch floats;
// `status`: one 8-byte word per scan tile of 4,096 counters.
extern "C" int gu_segment_mean(const void* q_in, void* q_out, const void* s, const void* a,
                               const void* delta, const void* mask, float alpha, int batch,
                               int num_actions, int n_seg, int chunk, void* counts, void* vals,
                               void* status, int* launched, void* stream) {
  return segment_launches(q_in, q_out, nullptr, s, a, delta, mask, alpha, batch, num_actions,
                          n_seg, chunk, counts, vals, status, launched, stream);
}

// The sums form: the same four kernels, the last writing each segment's
// env-order float sum of α·δ to `sums` and its count to `seg_counts`
// (n_seg each) instead of Q. The scratch is `gu_segment_mean`'s.
extern "C" int gu_segment_sums(void* sums, void* seg_counts, const void* s, const void* a,
                               const void* delta, const void* mask, float alpha, int batch,
                               int num_actions, int n_seg, int chunk, void* counts, void* vals,
                               void* status, int* launched, void* stream) {
  return segment_launches(nullptr, sums, static_cast<int*>(seg_counts), s, a, delta, mask, alpha,
                          batch, num_actions, n_seg, chunk, counts, vals, status, launched, stream);
}

// The cluster tier: one launch of a cluster of `blocks` (1-16), the mean
// (`counts_out` null: `out` the new Q) or the sums form (`out` the sums,
// `counts_out` the counts). `vals`: `batch` floats, where an owner's run
// does not fit its shared memory.
extern "C" int gu_segment_cluster(const void* q_in, void* out, void* counts_out, const void* s,
                                  const void* a, const void* delta, const void* mask, float alpha,
                                  int batch, int num_actions, int n_seg, int blocks, void* vals,
                                  void* stream) {
  return cluster_launch(q_in, out, static_cast<int*>(counts_out), s, a, delta, mask, alpha, batch,
                        num_actions, n_seg, blocks, vals, stream);
}

// The most clusters of `blocks` blocks, each with `bytes` of dynamic shared
// memory, that the current device holds at once (both forms' kernels; 0 if
// it holds none), from cudaOccupancyMaxActiveClusters.
extern "C" int gu_segment_cluster_fits(int blocks, int bytes, int* clusters) {
  *clusters = 0;
  if (blocks < 1 || blocks > kMaxCluster || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  int least = 1 << 30;
  using Kernel = void (*)(const float*, float*, int*, const int*, const int*, const float*, const uint8_t*,
                          float, int, int, int, int, int, float*);
  const Kernel forms[2] = {segment_cluster_kernel<true>, segment_cluster_kernel<false>};
  for (const Kernel fn : forms) {
    cudaError_t err = cluster_attributes(reinterpret_cast<const void*>(fn), static_cast<size_t>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(blocks, static_cast<size_t>(bytes), nullptr, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    least = n < least ? n : least;
  }
  *clusters = least;
  return 0;
}

// The shared bytes a cluster block takes at S·A = `n_seg`, for the plan to
// check against its own count.
extern "C" int gu_segment_cluster_bytes(int n_seg, long long* bytes) {
  if (n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = static_cast<long long>(cluster_shared_bytes(n_seg));
  return 0;
}
