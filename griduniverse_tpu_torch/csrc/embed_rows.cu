// embed_rows.cu — K9a: the index embedding of the MLP actor-critic, forward
// and backward.
//
// Replaces the lookup of griduniverse_tpu/models/networks.py
// `ActorCritic.__call__` (54-80): `one_hot(obs) @ table.astype(cdt)`, which
// the JAX version routes through the matrix unit (with a hi/lo factorised
// one-hot) because the TPU has no fast gather. A one-hot product selects
// exact rows, so the function is `table.astype(cdt)[obs]`; on this card a
// row lookup is one indexed load.
//
// Forward: out[n, :] = cdt(table[obs[n], :]). A thread owns one sample's
// slice of VEC consecutive output elements, 16 bytes where E and the
// alignment of `table` and `out` allow it (8 bfloat16 or 4 float32; else the
// most of 4, 2, 1 that they allow, `forward_vec`). It reads the sample's
// index once, the float32 slice of its row with 16-byte read-only loads
// (the table stays in L1 and L2 at the trainers' S=256, E=16), converts
// with round-to-nearest-even as `.to(torch.bfloat16)` does, and writes its
// slice with one store. A block is (slices a row) × (samples), so the sample
// and the slice come from the block's two thread indices with no divide;
// offsets into `out` are 64-bit. An index outside [0, S) gives a zero row,
// as a one-hot of it would.
//
// Backward: dtable[s, :] = Σ_{n: obs[n] = s} g[n, :] in float32. A resumed
// training run must repeat an unbroken one bit for bit, so the sum may not
// depend on the order in which threads arrive (float atomics do). The order
// is fixed by the shapes alone, in two levels:
//   1. the N samples are cut into chunks of `chunk` consecutive samples;
//      each (s, e) cell of chunk j's partial table adds the chunk's samples
//      one by one, in sample order, from 0.0f;
//   2. each (s, e) adds the chunks' partial tables in chunk order, from 0.0f.
// The plain version (`embed_rows_backward_reference`) makes the same adds in
// the same order with one indexed add per sample position, and the two
// agree bit for bit. Two tiers compute level 1:
//   * Shared (where the wrapper's `shared_tier_bytes` fits three blocks on
//     an SM): one block a chunk. It stages the chunk's indices and gradient
//     rows into shared memory with coalesced 16-byte `cp.async`, zeroes its
//     partial table there, runs the adds in sample order against shared
//     memory, and writes the partial out once with coalesced stores. Thread
//     e takes column e. It reads `kUnroll` samples' rows at once; where
//     they are distinct (a flag set once a group while staging) the adds
//     are independent, and where a later sample of the group hits an
//     earlier one's row it adds to that sample's new value in registers, so
//     a group waits on one shared-memory round trip, not one per sample. An
//     index outside [0, S) and the padding of the last chunk go to a spare
//     row that is never written out.
//   * Global (above that, e.g. S=4,225, E=64): thread (j, e) adds chunk j's
//     samples straight into a zeroed global partial table.
// Level 2 is one lane a cell, 32 cells a block: the block's eight warps
// stage 192 chunks' rows at a time in shared memory, every load in flight at
// once, while one warp adds the tile before in chunk order, so only the
// float adds form a chain.
// No two threads write one address, so there are no atomics. Two launches
// a backward in either tier.
//
// Bound on the card: bytes. The forward moves 4 bytes of index and E
// elements per sample (a thread an element, as it was written before, took
// 155 instructions an element and was bound by their issue at 7.4× its
// bytes at N = 1,048,576); the backward reads them back. The partial tables
// (N / chunk × S × E floats, 8 MB at a PPO minibatch) are written once and
// read once, from L2 at the shapes of the trainers. The global tier chains
// `chunk` read-modify-writes a thread through L2; the shared tier's chain
// runs against shared memory, a block a chunk, and its groups of samples
// with distinct rows add in parallel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kForwardThreads = 256;  // a block of the forward: (slices a row) × samples

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive floats of a row: 16-byte read-only loads from VEC = 4 up
template <int VEC>
__device__ __forceinline__ void load_slice(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

// one store of VEC elements
template <int VEC>
__device__ __forceinline__ void store_slice(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_slice(__nv_bfloat16* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    unsigned w[VEC / 2];  // pairs of bfloat16 bits, element 2q in the low half
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      memcpy(&w[q], &h, sizeof(unsigned));
    }
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

// Thread (x, y) of block k: sample k * blockDim.y + y, slices x, x + blockDim.x, ...
// of its row, each VEC elements.
template <typename T, int VEC>
__global__ void __launch_bounds__(kForwardThreads)
embed_rows_kernel(const float* __restrict__ table, const int* __restrict__ obs, T* __restrict__ out,
                  int num_samples, int num_states, int slices) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (n >= num_samples) return;
  const int s = __ldg(obs + n);
  const bool ok = static_cast<unsigned>(s) < static_cast<unsigned>(num_states);
  const int embed_dim = slices * VEC;
  const float* row = table + static_cast<size_t>(ok ? s : 0) * embed_dim;
  T* dst = out + static_cast<size_t>(n) * embed_dim;
  for (int k = threadIdx.x; k < slices; k += blockDim.x) {
    float v[VEC];
    if (ok) {
      load_slice<VEC>(row + k * VEC, v);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
    }
    store_slice<VEC>(dst + k * VEC, v);
  }
}

// The forward's elements a thread: the most of 16 bytes of output (8
// bfloat16, 4 float32), halved until E and the alignment of `table` (16
// bytes for a 16-byte load, else VEC floats) and `out` (VEC elements) allow it.
inline int forward_vec(int embed_dim, int elem, const void* table, const void* out) {
  int vec = 16 / elem;
  const auto t = reinterpret_cast<uintptr_t>(table), o = reinterpret_cast<uintptr_t>(out);
  while (vec > 1 && (embed_dim % vec != 0 || t % (vec * 4 < 16 ? vec * 4 : 16) != 0 || o % (vec * elem) != 0)) {
    vec /= 2;
  }
  return vec;
}

template <typename T, int VEC>
int launch_forward(const void* table, const void* obs, void* out, int num_samples, int num_states,
                   int embed_dim, cudaStream_t s) {
  const int slices = embed_dim / VEC;
  const int x = slices < kForwardThreads ? slices : kForwardThreads;
  const int y = kForwardThreads / x;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(num_samples) + y - 1) / y);
  embed_rows_kernel<T, VEC><<<blocks, dim3(x, y), 0, s>>>(
      static_cast<const float*>(table), static_cast<const int*>(obs), static_cast<T*>(out),
      num_samples, num_states, slices);
  return static_cast<int>(cudaGetLastError());
}

// Level 1, global tier: thread (j, e) adds chunk j's samples to
// partial[j, obs[n], e] in sample order. `partial` arrives zeroed.
template <typename T>
__global__ void embed_rows_partial_kernel(const T* __restrict__ grad, const int* __restrict__ obs,
                                          float* __restrict__ partial, int num_samples, int chunk,
                                          int num_chunks, int num_states, int embed_dim) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long j = id / embed_dim;
  if (j >= num_chunks) return;
  const int e = static_cast<int>(id - j * embed_dim);
  float* mine = partial + static_cast<size_t>(j) * num_states * embed_dim;
  const long long first = j * chunk;
  for (int c = 0; c < chunk; ++c) {
    const long long n = first + c;
    if (n >= num_samples) break;
    const int s = obs[n];
    if (s < 0 || s >= num_states) continue;
    float* cell = mine + static_cast<size_t>(s) * embed_dim + e;
    *cell = *cell + to_float(grad[n * embed_dim + e]);
  }
}

constexpr int kChunkThreads = 128;  // a block of the shared tier
constexpr int kUnroll = 8;          // samples whose rows one thread reads at once
constexpr int kRowMask = (1 << 30) - 1;  // a staged row; bit 30 of a group's first: all distinct
constexpr int kSumWarps = 8;        // a block of level 2: 32 cells, 8 warps loading
constexpr int kSumTile = 192;       // chunks a block of level 2 stages at once (two 24 KB buffers)

// Floats of the shared tier's partial table: S rows and the spare row,
// rounded up to 16 bytes so that the indices after it are aligned.
__host__ __device__ inline int shared_table_words(int num_states, int embed_dim) {
  return ((num_states + 1) * embed_dim + 3) / 4 * 4;
}

// Starts copying `count` elements of `src` into `dst` (16-byte aligned):
// 16 bytes a `cp.async` where `src` is aligned too, so that every load of
// the block is in flight at once; the rest by plain loads. Zeroes `dst`
// from `count` to `total`. The copies land after `cp_async_wait`.
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int count,
                                      int total) {
  constexpr int kVec = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count / kVec * kVec;
    for (int k = threadIdx.x * kVec; k < done; k += blockDim.x * kVec) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + k));
    }
  }
  for (int k = done + threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
  for (int k = count + threadIdx.x; k < total; k += blockDim.x) dst[k] = T(0.0f);
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Level 1, shared tier: block j takes chunk j. Dynamic shared memory: the
// partial table (`shared_table_words` floats), the chunk's rows (`chunk`
// ints), its gradient rows (`chunk` × E elements).
template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
embed_rows_chunk_kernel(const T* __restrict__ grad, const int* __restrict__ obs,
                        float* __restrict__ partial, int num_samples, int chunk, int num_states,
                        int embed_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = shared_table_words(num_states, embed_dim);
  float* const part = reinterpret_cast<float*>(smem);
  int* const rows = reinterpret_cast<int*>(part + words);
  T* const g = reinterpret_cast<T*>(rows + chunk);
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * chunk;
  const int count = static_cast<int>(min(static_cast<long long>(chunk), num_samples - first));

  stage(rows, obs + first, count, chunk);
  stage(g, grad + first * embed_dim, count * embed_dim, chunk * embed_dim);
  for (int k = tid; k < words; k += kChunkThreads) part[k] = 0.0f;
  cp_async_wait();
  __syncthreads();
  // thread q takes group q: an index outside [0, S), or the padding, goes to
  // the spare row; bit 30 of the group's first row says its rows are distinct
  for (int q = tid; q < chunk / kUnroll; q += kChunkThreads) {
    int s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = q * kUnroll + u;
      s[u] = rows[c];
      s[u] = c < count && s[u] >= 0 && s[u] < num_states ? s[u] : num_states;
    }
    bool distinct = true;
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) {
#pragma unroll
      for (int w = 0; w < u; ++w) distinct = distinct && s[w] != s[u];
    }
    s[0] |= distinct ? 1 << 30 : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) rows[q * kUnroll + u] = s[u];
  }
  __syncthreads();

  for (int e = tid; e < embed_dim; e += kChunkThreads) {
    int s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] = rows[u];
    for (int c = 0; c < chunk; c += kUnroll) {
      const bool distinct = s[0] >> 30;
      s[0] &= kRowMask;
      float x[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = to_float(g[(c + u) * embed_dim + e]);
        v[u] = part[s[u] * embed_dim + e];
      }
      if (distinct) {  // the same for every thread of the chunk
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = v[u] + x[u];
      } else {
        // in sample order; a sample whose row an earlier sample of the
        // group hit adds to that sample's new value
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float base = v[u];
#pragma unroll
          for (int w = 0; w < u; ++w) base = s[w] == s[u] ? v[w] : base;
          v[u] = base + x[u];
        }
      }
      int next[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) next[u] = c + kUnroll < chunk ? rows[c + kUnroll + u] : 0;
      // the same row stored twice: the later sample's value lands last
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        part[s[u] * embed_dim + e] = v[u];
        s[u] = next[u];
      }
    }
  }
  __syncthreads();

  const int table = num_states * embed_dim;
  float* const out = partial + static_cast<size_t>(blockIdx.x) * table;
  if (table % 4 == 0) {
    const float4* src = reinterpret_cast<const float4*>(part);
    float4* dst = reinterpret_cast<float4*>(out);
    for (int k = tid; k < table / 4; k += kChunkThreads) dst[k] = src[k];
  } else {
    for (int k = tid; k < table; k += kChunkThreads) out[k] = part[k];
  }
}

// Level 2: block b takes cells 32b..32b+31, lane l cell 32b + l. Its eight
// warps stage `kSumTile` chunks' rows of those cells in shared memory, each
// thread's loads all in flight, while warp 0 adds the tile staged before in
// chunk order (two buffers).
__global__ void __launch_bounds__(kSumWarps * 32)
embed_rows_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dtable,
                         int num_chunks, int table_size) {
  constexpr int kPerWarp = kSumTile / kSumWarps;
  __shared__ float tiles[2][kSumTile][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const bool live = k < table_size;
  float v[kPerWarp];
  auto load = [&](int base) {
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int j = base + warp + t * kSumWarps;
      v[t] = live && j < num_chunks ? partial[static_cast<size_t>(j) * table_size + k] : 0.0f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) tiles[buf][warp + t * kSumWarps][lane] = v[t];
  };
  load(0);
  put(0);
  __syncthreads();
  float acc = 0.0f;
  for (int base = 0, buf = 0; base < num_chunks; base += kSumTile, buf ^= 1) {
    const bool more = base + kSumTile < num_chunks;
    if (more) load(base + kSumTile);
    if (warp == 0) {
      const int rows = min(kSumTile, num_chunks - base);
      for (int r = 0; r < rows; ++r) acc = acc + tiles[buf][r][lane];
    }
    if (more) put(buf ^ 1);
    __syncthreads();
  }
  if (warp == 0 && live) dtable[k] = acc;
}

template <typename T>
int launch_chunks(const void* grad, const void* obs, void* partial, int num_samples, int chunk,
                  int num_chunks, int num_states, int embed_dim, int shared_bytes,
                  cudaStream_t s) {
  if (shared_bytes > 48 * 1024) {  // above the default, granted on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        embed_rows_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  embed_rows_chunk_kernel<T><<<num_chunks, kChunkThreads, shared_bytes, s>>>(
      static_cast<const T*>(grad), static_cast<const int*>(obs), static_cast<float*>(partial),
      num_samples, chunk, num_states, embed_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of `out`, and of `grad` in the backward).
// The wrapper checks the tensors; N, S and E must be at least 1.
extern "C" int gu_embed_rows(const void* table, const void* obs, void* out, int num_samples,
                             int num_states, int embed_dim, int dtype, void* stream) {
  if (num_samples < 1 || num_states < 1 || embed_dim < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_samples, ns = num_states, e = embed_dim;
  if (dtype == 0) {
    switch (forward_vec(e, 4, table, out)) {
      case 4: return launch_forward<float, 4>(table, obs, out, n, ns, e, s);
      case 2: return launch_forward<float, 2>(table, obs, out, n, ns, e, s);
      default: return launch_forward<float, 1>(table, obs, out, n, ns, e, s);
    }
  }
  switch (forward_vec(e, 2, table, out)) {
    case 8: return launch_forward<__nv_bfloat16, 8>(table, obs, out, n, ns, e, s);
    case 4: return launch_forward<__nv_bfloat16, 4>(table, obs, out, n, ns, e, s);
    case 2: return launch_forward<__nv_bfloat16, 2>(table, obs, out, n, ns, e, s);
    default: return launch_forward<__nv_bfloat16, 1>(table, obs, out, n, ns, e, s);
  }
}

// Launches two kernels: the partial tables, then their sum. `shared_bytes`
// is the shared tier's dynamic shared memory (`shared_tier_bytes` of the
// wrapper), or 0 for the global tier, whose `partial` arrives zeroed.
extern "C" int gu_embed_rows_backward(const void* grad, const void* obs, void* partial,
                                      void* dtable, int num_samples, int chunk, int num_chunks,
                                      int num_states, int embed_dim, int dtype, int shared_bytes,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (shared_bytes > 0) {
    const int elem = dtype == 0 ? 4 : 2;
    const int need =
        4 * shared_table_words(num_states, embed_dim) + 4 * chunk + chunk * embed_dim * elem;
    if (need != shared_bytes || chunk % kUnroll != 0 || num_states > kRowMask) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = dtype == 0 ? launch_chunks<float>(grad, obs, partial, num_samples, chunk, num_chunks,
                                            num_states, embed_dim, shared_bytes, s)
                     : launch_chunks<__nv_bfloat16>(grad, obs, partial, num_samples, chunk,
                                                    num_chunks, num_states, embed_dim,
                                                    shared_bytes, s);
  } else {
    const long long threads = static_cast<long long>(num_chunks) * embed_dim;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    if (dtype == 0) {
      embed_rows_partial_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(grad), static_cast<const int*>(obs),
          static_cast<float*>(partial), num_samples, chunk, num_chunks, num_states, embed_dim);
    } else {
      embed_rows_partial_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(grad), static_cast<const int*>(obs),
          static_cast<float*>(partial), num_samples, chunk, num_chunks, num_states, embed_dim);
    }
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  const int table_size = num_states * embed_dim;
  embed_rows_reduce_kernel<<<(table_size + 31) / 32, kSumWarps * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dtable), num_chunks, table_size);
  return static_cast<int>(cudaGetLastError());
}
