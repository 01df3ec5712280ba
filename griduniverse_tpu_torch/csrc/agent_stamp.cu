// agent_stamp.cu — K9b: the agent plane of the conv trunks' first layer,
// fused with the add of the tile response, the bias and the ReLU; forward
// and backward.
//
// Replaces griduniverse_tpu/models/networks.py:178-206
// (`BatchedConvActorCritic`) and :277-289 (`ConvActorCritic`). The first
// conv layer is split there: the tile planes go through a conv once per
// level, and the agent plane, a one-hot image, contributes the layer's 3×3
// agent kernel stamped around the agent's cell. The JAX version lowers the
// stamp to a (B, S) @ (S, S·ch0) product with a table of S conv responses
// (or to a one-channel conv), then adds the tile response and the bias and
// applies the ReLU as separate passes.
//
// Forward, one block per sample n and one thread per few elements (y, x, c)
// of it, NHWC:
//   v = (k[ay−y+1, ax−x+1, c] or 0) + y_tiles[level(n), y, x, c]
//   out = cdt(relu(v + bias[c]))
// where (ay, ax) is the agent's cell of sample n, the stamp term is present
// where |ay−y| ≤ 1 and |ax−x| ≤ 1 (a cross-correlation with SAME padding),
// level(n) = n mod Nl (samples are (T, Nl) row-major; Nl = 1 for a shared
// level), and k and bias are the float32 parameters rounded to cdt first,
// as the reference casts them. The sums are float32; only the output is
// rounded. The one-hot image and the stamp table are never materialised.
//
// Backward, with the ReLU mask from the saved output (gm = g where out > 0):
//   dy_tiles[l, y, x, c] = Σ_t gm[t·Nl + l, y, x, c], one thread per
//     element, t ascending;
//   dk[i, j, c] = Σ_n gm[n, ay−i+1, ax−j+1, c] and dbias[c] = Σ_{n,y,x} gm:
//     the samples are cut into chunks; thread (chunk, c) adds its chunk's
//     samples in sample order (within a sample in (y, x) raster order) into
//     ten registers, then thread (q, c) adds the chunks' partial sums in
//     chunk order.
// The order of every float sum is fixed by the shapes, and there are no
// atomics, so two runs give the same bits. All sums are float32.
//
// Bound on the card: bytes. The forward writes N·H·W·ch0 elements and reads
// a T-th of that; the backward reads the gradient and the saved output
// twice (once for dy_tiles, once for dk and dbias).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 10;  // nine stamp positions and the bias

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// The float32 parameter as the trunk sees it: rounded to the compute type.
template <typename T>
__device__ __forceinline__ float rounded(float x);
template <>
__device__ __forceinline__ float rounded<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One block per sample: the agent's cell is read once a block, threadIdx.x
// walks the channels and threadIdx.y the cells, so no thread divides a flat
// 64-bit index and a warp writes neighbouring channels of one cell.
template <typename T>
__global__ void agent_stamp_kernel(const T* __restrict__ y_tiles, const float* __restrict__ k_agent,
                                   const float* __restrict__ bias, const int* __restrict__ obs,
                                   T* __restrict__ out, int num_levels, int h, int w, int ch) {
  const int n = blockIdx.x;
  const int hw = h * w;
  const int o = obs[n];
  const int ay = o / w, ax = o - ay * w;
  const T* tiles = y_tiles + static_cast<size_t>(n % num_levels) * hw * ch;
  T* dst = out + static_cast<size_t>(n) * hw * ch;
  for (int p = threadIdx.y; p < hw; p += blockDim.y) {
    const int y = p / w, x = p - y * w;
    const int di = ay - y + 1, dj = ax - x + 1;
    const bool hit = di >= 0 && di < 3 && dj >= 0 && dj < 3;
    for (int c = threadIdx.x; c < ch; c += blockDim.x) {
      const float k = hit ? rounded<T>(k_agent[(di * 3 + dj) * ch + c]) : 0.0f;
      const float v = (k + to_float(tiles[p * ch + c])) + rounded<T>(bias[c]);
      store(dst + p * ch + c, v > 0.0f ? v : 0.0f);
    }
  }
}

// dy_tiles: thread i = (l, y, x, c) sums its element over the T samples of
// level l, t ascending.
template <typename T>
__global__ void agent_stamp_dtiles_kernel(const T* __restrict__ grad, const T* __restrict__ out,
                                          T* __restrict__ dy_tiles, long long level_elems,
                                          int samples_per_level) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= level_elems) return;
  float acc = 0.0f;
  for (int t = 0; t < samples_per_level; ++t) {
    const long long o = static_cast<long long>(t) * level_elems + i;
    acc = acc + (to_float(out[o]) > 0.0f ? to_float(grad[o]) : 0.0f);
  }
  store(dy_tiles + i, acc);
}

// Level 1 of dk and dbias: thread (j, c) walks chunk j's samples in order.
template <typename T>
__global__ void agent_stamp_partial_kernel(const T* __restrict__ grad, const T* __restrict__ out,
                                           const int* __restrict__ obs,
                                           float* __restrict__ partial, int num_samples, int chunk,
                                           int num_chunks, int h, int w, int ch) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long j = id / ch;
  if (j >= num_chunks) return;
  const int c = static_cast<int>(id - j * ch);
  const int hw = h * w;
  float sums[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) sums[q] = 0.0f;
  const long long first = j * chunk;
  for (int s = 0; s < chunk; ++s) {
    const long long n = first + s;
    if (n >= num_samples) break;
    const long long base = n * hw * ch + c;
    for (int p = 0; p < hw; ++p) {
      const long long o = base + static_cast<long long>(p) * ch;
      sums[9] = sums[9] + (to_float(out[o]) > 0.0f ? to_float(grad[o]) : 0.0f);
    }
    const int a = obs[n];
    const int ay = a / w, ax = a - ay * w;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int y = ay - di + 1, x = ax - dj + 1;
        if (y >= 0 && y < h && x >= 0 && x < w) {
          const long long o = base + static_cast<long long>(y * w + x) * ch;
          sums[di * 3 + dj] =
              sums[di * 3 + dj] + (to_float(out[o]) > 0.0f ? to_float(grad[o]) : 0.0f);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) partial[(static_cast<size_t>(j) * kSums + q) * ch + c] = sums[q];
}

// Level 2: thread k = (q, c) adds the chunks' partial sums in chunk order;
// q < 9 is dk[q, c], q = 9 is dbias[c].
__global__ void agent_stamp_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dk, float* __restrict__ dbias,
                                          int num_chunks, int ch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_out = kSums * ch;
  if (k >= n_out) return;
  float acc = 0.0f;
  for (int j = 0; j < num_chunks; ++j) acc = acc + partial[static_cast<size_t>(j) * n_out + k];
  if (k < 9 * ch) {
    dk[k] = acc;
  } else {
    dbias[k - 9 * ch] = acc;
  }
}

template <typename T>
int forward(const void* y_tiles, const void* k_agent, const void* bias, const void* obs, void* out,
            int num_samples, int num_levels, int h, int w, int ch, cudaStream_t s) {
  const int bx = ch < 32 ? ch : 32;
  const dim3 block(bx, kThreads / bx);
  agent_stamp_kernel<T><<<num_samples, block, 0, s>>>(
      static_cast<const T*>(y_tiles), static_cast<const float*>(k_agent),
      static_cast<const float*>(bias), static_cast<const int*>(obs), static_cast<T*>(out),
      num_levels, h, w, ch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* grad, const void* out, const void* obs, void* dy_tiles, void* partial,
             void* dk, void* dbias, int num_samples, int num_levels, int chunk, int num_chunks,
             int h, int w, int ch, cudaStream_t s) {
  const long long level_elems = static_cast<long long>(num_levels) * h * w * ch;
  agent_stamp_dtiles_kernel<T>
      <<<static_cast<unsigned>((level_elems + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          static_cast<const T*>(grad), static_cast<const T*>(out), static_cast<T*>(dy_tiles),
          level_elems, num_samples / num_levels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(num_chunks) * ch;
  agent_stamp_partial_kernel<T>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          static_cast<const T*>(grad), static_cast<const T*>(out), static_cast<const int*>(obs),
          static_cast<float*>(partial), num_samples, chunk, num_chunks, h, w, ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  agent_stamp_reduce_kernel<<<(kSums * ch + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dk), static_cast<float*>(dbias),
      num_chunks, ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of y_tiles, out, grad and dy_tiles).
extern "C" int gu_agent_stamp(const void* y_tiles, const void* k_agent, const void* bias,
                              const void* obs, void* out, int num_samples, int num_levels, int h,
                              int w, int ch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? forward<float>(y_tiles, k_agent, bias, obs, out, num_samples, num_levels, h, w, ch, s)
             : forward<__nv_bfloat16>(y_tiles, k_agent, bias, obs, out, num_samples, num_levels,
                                      h, w, ch, s);
}

// Launches three kernels: dy_tiles, the partial sums of dk and dbias, and
// their sum.
extern "C" int gu_agent_stamp_backward(const void* grad, const void* out, const void* obs,
                                       void* dy_tiles, void* partial, void* dk, void* dbias,
                                       int num_samples, int num_levels, int chunk, int num_chunks,
                                       int h, int w, int ch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? backward<float>(grad, out, obs, dy_tiles, partial, dk, dbias, num_samples,
                                      num_levels, chunk, num_chunks, h, w, ch, s)
                    : backward<__nv_bfloat16>(grad, out, obs, dy_tiles, partial, dk, dbias,
                                              num_samples, num_levels, chunk, num_chunks, h, w,
                                              ch, s);
}
