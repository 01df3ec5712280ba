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
// Forward: out[n, :] = cdt(table[obs[n], :]), one thread per output element.
// An index outside [0, S) gives a zero row, as a one-hot of it would.
//
// Backward: dtable[s, :] = Σ_{n: obs[n] = s} g[n, :] in float32. A resumed
// training run must repeat an unbroken one bit for bit, so the sum may not
// depend on the order in which threads arrive (float atomics do). The order
// is fixed by the shapes alone, in two levels:
//   1. the N samples are cut into chunks of `chunk` consecutive samples;
//      thread (j, e) owns column e of chunk j's partial table and adds the
//      chunk's samples to it one by one, in sample order;
//   2. thread (s, e) adds the chunks' partial tables in chunk order.
// No two threads write one address, so there are no atomics. The plain
// version (`embed_rows_backward_reference`) makes the same adds in the same
// order with one indexed add per sample position, and the two agree bit for
// bit.
//
// Bound on the card: bytes. The forward moves 4 bytes of index and E
// elements per sample; the backward reads them back. The partial tables
// (N / chunk × S × E floats) stay in L2 at the shapes of the trainers. The
// backward's first level is a chain of `chunk` dependent read-modify-writes
// a thread, so its time is latency, not bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void embed_rows_kernel(const float* __restrict__ table, const int* __restrict__ obs,
                                  T* __restrict__ out, long long total, int num_states,
                                  int embed_dim) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long n = i / embed_dim;
  const int e = static_cast<int>(i - n * embed_dim);
  const int s = obs[n];
  const bool ok = s >= 0 && s < num_states;
  store(out + i, ok ? table[static_cast<size_t>(s) * embed_dim + e] : 0.0f);
}

// Level 1: thread (j, e) adds chunk j's samples to partial[j, obs[n], e] in
// sample order. `partial` arrives zeroed.
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

// Level 2: thread k = (s, e) adds the partial tables in chunk order.
__global__ void embed_rows_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dtable, int num_chunks,
                                         int table_size) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= table_size) return;
  float acc = 0.0f;
  for (int j = 0; j < num_chunks; ++j) acc = acc + partial[static_cast<size_t>(j) * table_size + k];
  dtable[k] = acc;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of `out`, and of `grad` in the backward).
extern "C" int gu_embed_rows(const void* table, const void* obs, void* out, int num_samples,
                             int num_states, int embed_dim, int dtype, void* stream) {
  const long long total = static_cast<long long>(num_samples) * embed_dim;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    embed_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(obs), static_cast<float*>(out),
        total, num_states, embed_dim);
  } else {
    embed_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(obs),
        static_cast<__nv_bfloat16*>(out), total, num_states, embed_dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches two kernels: the partial tables, then their sum.
extern "C" int gu_embed_rows_backward(const void* grad, const void* obs, void* partial,
                                      void* dtable, int num_samples, int chunk, int num_chunks,
                                      int num_states, int embed_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int table_size = num_states * embed_dim;
  embed_rows_reduce_kernel<<<(table_size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dtable), num_chunks, table_size);
  return static_cast<int>(cudaGetLastError());
}
