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
// The function, NHWC, sample n = t·Nl + l on level l (samples are (T, Nl)
// row-major; Nl = 1 for a shared level):
//   out[n, y, x, c] = cdt(relu((k[ay−y+1, ax−x+1, c] or 0) + y_tiles[l, y, x, c]
//                              + bias[c]))
// where (ay, ax) is the agent's cell of sample n and the stamp term is
// present where |ay−y| ≤ 1 and |ax−x| ≤ 1 (a cross-correlation with SAME
// padding); k and bias are the float32 parameters rounded to cdt first, as
// the reference casts them. The sums are float32; only the output is
// rounded. The one-hot image and the stamp table are never materialised.
//
// Layout of the work. Sample n's plane starts at element n·H·W·C, so the
// planes of the samples t·Nl + l, l = 0..Nl−1, are one run of Nl·H·W "global
// cells" gc = l·H·W + (y·W + x), and element (t, gc, c) lies at
// (t·Nl·H·W + gc)·C + c for every t. A thread owns one global cell and V
// channels, V·sizeof(cdt) ≤ 16 bytes (the wrapper's `vector_width`: 8 for
// bfloat16, 4 for float32 where C allows), and walks t; its level and cell
// are divided out once.
//
// Forward: one block of 256 threads a run of (cell, channel group) slots
// and a range of at most `t_range` samples a level. A thread loads its
// slice of y_tiles[l] once, keeps relu(0 + y + bias) as its answer for
// every sample whose agent is not next to its cell, and for each t reads
// obs[t·Nl + l] (one address a warp, mostly), adds the stamp where the
// agent is within one cell, and stores 16 bytes. k is staged in shared
// memory, rounded once a block. Above kForwardSlice channels the channels
// are cut into slices of that many (the last one shorter), the slice on the
// grid beside the range and the slots, and a block stages only its slice
// of k (36 KB at most).
//
// Backward, with gm = grad where out > 0 and 0 elsewhere, all sums float32,
// in two launches and in this order, a function of the shapes alone (the
// wrapper's `plan`; `agent_stamp_backward_reference` repeats it add by
// add):
//   1. A unit is (range r of `t_range` samples a level, tile k of `cells`
//      consecutive global cells), u = r·tiles + k. Where C / V is above the
//      block's 256 threads, the channels are cut into `slices` of `width`
//      (the last one shorter; `plan` picks them), each its own `blocks`
//      blocks, and `cells` is counted on a slice; the sums of one channel
//      keep the order below. Block β (of a slice) takes units
//      [β·upb, (β+1)·upb) in order, with upb = ceil(units / max_blocks).
//      Thread (row ρ, channel c) of a block takes global cell k·cells + ρ
//      of each unit (none past the last cell). For each unit it adds, t
//      ascending over the range, from 0.0: D += gm (the unit's dy_tiles
//      term), and A[i·3 + j] += gm where its cell is (ay−i+1, ax−j+1) of
//      the sample's agent. After the unit, B += D. A and B live in the
//      thread's own slots of shared memory, from 0.0 at the block's start.
//      D goes out as dy_tiles[l, y, x, c] (rounded to cdt) where the level
//      has one range, else as a float partial of range r.
//   2. The block then adds its rows' ten sums (A[0..8], B) by a tree in
//      shared memory: for s = cells/2, ..., 1, row ρ < s takes
//      v[ρ] + v[ρ + s]. Row 0 is the block's partial.
//   3. The second launch: dk[i, j, c] and dbias[c] are Σ_{ρ<32} (Σ_{m}
//      P[m·32 + ρ]) over the blocks' partials P, each sum from 0.0 and
//      ascending, 32 warps loading at once; where a level has several
//      ranges, dy_tiles = cdt(Σ_r partial_r), r ascending, from 0.0.
// No two threads write one address and there are no atomics, so two runs
// give the same bits. grad and out are read once, 16 bytes a load.
//
// Bound on the card: bytes. The forward writes N·H·W·C elements and reads
// a T-th of that; the backward reads the gradient and the saved output
// once and writes dy_tiles. The blocks' partials are at most 2,048 rows of
// 10·C floats (2.6 MB at C = 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kForwardThreads = 256;
constexpr int kForwardSlice = 1024;  // channels of k a forward block stages at most; `FORWARD_SLICE`
constexpr int kSums = 10;      // nine stamp positions and the bias
constexpr int kSumLanes = 32;  // rows of blocks' partials summed at once in launch 2

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

// V elements of T moved as one access of V·sizeof(T) bytes.
template <int Bytes>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<2> { using type = unsigned short; };

template <typename T, int V>
struct Pack {
  using Raw = typename RawOf<sizeof(T) * V>::type;
  Raw raw;
  __device__ __forceinline__ float get(int j) const { return to_float(reinterpret_cast<const T*>(&raw)[j]); }
  __device__ __forceinline__ void set(int j, float x) { store(reinterpret_cast<T*>(&raw) + j, x); }
  __device__ __forceinline__ static Pack load(const T* p) {
    Pack a;
    a.raw = *reinterpret_cast<const Raw*>(p);
    return a;
  }
  __device__ __forceinline__ void put(T* p) const { *reinterpret_cast<Raw*>(p) = raw; }
};

// floor(o / w) for |o| < 2^22 without an integer divide: a float quotient
// is off by at most one, which the remainder corrects.
__device__ __forceinline__ int floor_div(int o, int w, float inv_w) {
  int q = __float2int_rz(__int2float_rn(o) * inv_w);
  const int r = o - q * w;
  return q + (r >= w) - (r < 0);
}

template <typename T, int V>
__global__ void __launch_bounds__(kForwardThreads)
agent_stamp_kernel(const T* __restrict__ y_tiles, const float* __restrict__ k_agent,
                   const float* __restrict__ bias, const int* __restrict__ obs,
                   T* __restrict__ out, int slot_blocks, int ranges, int num_levels,
                   int samples_per_level, int t_range, int h, int w, float inv_w, int ch) {
  extern __shared__ float k_s[];  // 9·cw: the block's slice of k, rounded to cdt
  const int rs = blockIdx.x / slot_blocks;  // slice · ranges + range
  const int slice = rs / ranges;
  const int r = rs - slice * ranges;
  const int c_lo = slice * kForwardSlice;
  const int cw = min(kForwardSlice, ch - c_lo);
  for (int i = threadIdx.x; i < 9 * cw; i += blockDim.x) {
    const int q = i / cw;
    k_s[i] = rounded<T>(k_agent[q * ch + c_lo + (i - q * cw)]);
  }
  __syncthreads();
  const int groups = cw / V;
  const int hw = h * w;
  const long long slots = static_cast<long long>(num_levels) * hw * groups;
  const long long i = static_cast<long long>(blockIdx.x - rs * slot_blocks) * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const long long gc = i / groups;
  const int c_in = static_cast<int>(i - gc * groups) * V;  // in the slice
  const int c0 = c_lo + c_in;
  const int l = static_cast<int>(gc / hw);
  const int p = static_cast<int>(gc - static_cast<long long>(l) * hw);
  const int y = p / w, x = p - y * w;
  const Pack<T, V> tile = Pack<T, V>::load(y_tiles + gc * ch + c0);
  float yt[V], b[V];
  Pack<T, V> plain;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    yt[j] = tile.get(j);
    b[j] = rounded<T>(bias[c0 + j]);
    const float v = (0.0f + yt[j]) + b[j];
    plain.set(j, v > 0.0f ? v : 0.0f);
  }
  const long long plane = static_cast<long long>(num_levels) * hw * ch;  // elements of one t
  const int t0 = r * t_range;
  const int t1 = min(t0 + t_range, samples_per_level);
  T* dst = out + gc * ch + c0;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const int o = obs[static_cast<long long>(t) * num_levels + l];
    const int ay = floor_div(o, w, inv_w);
    const int di = ay - y + 1, dj = (o - ay * w) - x + 1;
    Pack<T, V> res = plain;
    if (static_cast<unsigned>(di) < 3u && static_cast<unsigned>(dj) < 3u) {
      const float* kq = k_s + (di * 3 + dj) * cw + c_in;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = (kq[j] + yt[j]) + b[j];
        res.set(j, v > 0.0f ? v : 0.0f);
      }
    }
    res.put(dst + t * plane);
  }
}

// Launch 1 of the backward: the units of a block, then the block's tree.
template <typename T, int V>
__global__ void __launch_bounds__(256)
agent_stamp_units_kernel(const T* __restrict__ grad, const T* __restrict__ out,
                         const int* __restrict__ obs, T* __restrict__ dy_tiles,
                         float* __restrict__ dy_partial, float* __restrict__ block_partial,
                         int num_levels, int samples_per_level, int h, int w, float inv_w, int ch,
                         int cells, int tiles, int ranges, int t_range, int units,
                         int units_per_block, int blocks, int width) {
  extern __shared__ float sums[];  // [kSums][cells][width]: A[0..8] and B of each thread
  const int slice = blockIdx.x / blocks;  // the channels [c_lo, c_lo + cw)
  const int beta = blockIdx.x - slice * blocks;
  const int c_lo = slice * width;
  const int cw = min(width, ch - c_lo);
  const int groups = width / V;
  const int row = threadIdx.x / groups;
  const int c_in = (static_cast<int>(threadIdx.x) - row * groups) * V;  // in the slice
  const int c0 = c_lo + c_in;
  const bool live = c_in < cw;  // the last slice may be narrower than the block
  const int hw = h * w;
  const int row_stride = cells * width;  // floats between one sum's rows of consecutive q
  float* mine = sums + row * width + c_in;
#pragma unroll
  for (int q = 0; q < kSums; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) mine[q * row_stride + j] = 0.0f;

  const long long cells_all = static_cast<long long>(num_levels) * hw;
  const long long plane = cells_all * ch;
  const int u0 = beta * units_per_block;
  const int u1 = min(u0 + units_per_block, units);
  for (int u = u0; u < u1; ++u) {
    const int r = u / tiles;
    const long long gc = static_cast<long long>(u - r * tiles) * cells + row;
    if (gc >= cells_all || !live) continue;
    const int l = static_cast<int>(gc / hw);
    const int p = static_cast<int>(gc - static_cast<long long>(l) * hw);
    const int y = p / w, x = p - y * w;
    const int t0 = r * t_range;
    const int t1 = min(t0 + t_range, samples_per_level);
    const T* g_at = grad + gc * ch + c0;
    const T* o_at = out + gc * ch + c0;
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = 0.0f;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const long long e = static_cast<long long>(t) * plane;
      const Pack<T, V> gv = Pack<T, V>::load(g_at + e);
      const Pack<T, V> ov = Pack<T, V>::load(o_at + e);
      const int o = obs[static_cast<long long>(t) * num_levels + l];
      const int ay = floor_div(o, w, inv_w);
      const int di = ay - y + 1, dj = (o - ay * w) - x + 1;
      float gm[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        gm[j] = ov.get(j) > 0.0f ? gv.get(j) : 0.0f;
        d[j] = d[j] + gm[j];
      }
      if (static_cast<unsigned>(di) < 3u && static_cast<unsigned>(dj) < 3u) {
        float* a = mine + (di * 3 + dj) * row_stride;
#pragma unroll
        for (int j = 0; j < V; ++j) a[j] = a[j] + gm[j];
      }
    }
    if (ranges == 1) {
      Pack<T, V> res;
#pragma unroll
      for (int j = 0; j < V; ++j) res.set(j, d[j]);
      res.put(dy_tiles + gc * ch + c0);
    } else {
      float* dst = dy_partial + static_cast<long long>(r) * plane + gc * ch + c0;
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = d[j];
    }
    float* bsum = mine + 9 * row_stride;
#pragma unroll
    for (int j = 0; j < V; ++j) bsum[j] = bsum[j] + d[j];
  }
  __syncthreads();
  for (int s = cells / 2; s > 0; s >>= 1) {
    const int span = s * width;  // the rows ρ < s of one sum
    for (int i = threadIdx.x; i < kSums * span; i += blockDim.x) {
      const int q = i / span;
      float* v = sums + q * row_stride + (i - q * span);
      v[0] = v[0] + v[span];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kSums * cw; i += blockDim.x) {
    const int q = i / cw;
    const int j = i - q * cw;
    block_partial[(static_cast<long long>(beta) * kSums + q) * ch + c_lo + j] = sums[q * row_stride + j];
  }
}

// Launch 2 of the backward. Blocks [0, sum_blocks): 32 columns of the
// blocks' partials each; warp ρ adds rows ρ, ρ + 32, ... in order, then
// warp 0 adds the 32 warps' sums in order. Blocks past them (where a level
// has several ranges): dy_tiles, an element a thread, ranges in order.
template <typename T>
__global__ void __launch_bounds__(1024)
agent_stamp_finish_kernel(const float* __restrict__ block_partial, int blocks, int ch,
                          float* __restrict__ dk, float* __restrict__ dbias, int sum_blocks,
                          const float* __restrict__ dy_partial, T* __restrict__ dy_tiles,
                          long long dy_elems, int ranges) {
  const int cols = kSums * ch;
  if (static_cast<int>(blockIdx.x) < sum_blocks) {
    __shared__ float lanes[kSumLanes][33];
    const int lane = threadIdx.x & 31, rho = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    float acc = 0.0f;
    if (col < cols) {
#pragma unroll 8
      for (int m = rho; m < blocks; m += kSumLanes) acc = acc + block_partial[static_cast<long long>(m) * cols + col];
    }
    lanes[rho][lane] = acc;
    __syncthreads();
    if (rho == 0 && col < cols) {
      float total = 0.0f;
#pragma unroll
      for (int k = 0; k < kSumLanes; ++k) total = total + lanes[k][lane];
      if (col < 9 * ch) {
        dk[col] = total;
      } else {
        dbias[col - 9 * ch] = total;
      }
    }
    return;
  }
  const long long e = static_cast<long long>(blockIdx.x - sum_blocks) * blockDim.x + threadIdx.x;
  if (e >= dy_elems) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < ranges; ++r) acc = acc + dy_partial[static_cast<long long>(r) * dy_elems + e];
  store(dy_tiles + e, acc);
}

template <typename T, int V>
int forward(const void* y_tiles, const void* k_agent, const void* bias, const void* obs, void* out,
            int num_levels, int samples_per_level, int t_range, int h, int w, int ch,
            cudaStream_t s) {
  const int width = ch < kForwardSlice ? ch : kForwardSlice;  // the widest slice
  const long long slices = (ch + kForwardSlice - 1) / kForwardSlice;
  const long long slots = static_cast<long long>(num_levels) * h * w * (width / V);
  const long long slot_blocks = (slots + kForwardThreads - 1) / kForwardThreads;
  const long long ranges = (samples_per_level + t_range - 1) / t_range;
  agent_stamp_kernel<T, V><<<static_cast<unsigned>(slot_blocks * ranges * slices), kForwardThreads,
                             9 * width * sizeof(float), s>>>(
      static_cast<const T*>(y_tiles), static_cast<const float*>(k_agent),
      static_cast<const float*>(bias), static_cast<const int*>(obs), static_cast<T*>(out),
      static_cast<int>(slot_blocks), static_cast<int>(ranges), num_levels, samples_per_level,
      t_range, h, w, 1.0f / w, ch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int backward(const void* grad, const void* out, const void* obs, void* dy_tiles, void* dy_partial,
             void* block_partial, void* dk, void* dbias, int num_levels, int samples_per_level,
             int h, int w, int ch, int cells, int tiles, int ranges, int t_range, int units,
             int units_per_block, int blocks, int slices, int width, cudaStream_t s) {
  const int shared = kSums * cells * width * static_cast<int>(sizeof(float));
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        agent_stamp_units_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  agent_stamp_units_kernel<T, V><<<blocks * slices, cells * (width / V), shared, s>>>(
      static_cast<const T*>(grad), static_cast<const T*>(out), static_cast<const int*>(obs),
      static_cast<T*>(dy_tiles), static_cast<float*>(dy_partial),
      static_cast<float*>(block_partial), num_levels, samples_per_level, h, w, 1.0f / w, ch,
      cells, tiles, ranges, t_range, units, units_per_block, blocks, width);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_blocks = (kSums * ch + 31) / 32;
  const long long dy_elems = static_cast<long long>(num_levels) * h * w * ch;
  const long long dy_blocks = ranges > 1 ? (dy_elems + 1023) / 1024 : 0;
  agent_stamp_finish_kernel<T><<<static_cast<unsigned>(sum_blocks + dy_blocks), 1024, 0, s>>>(
      static_cast<const float*>(block_partial), blocks, ch, static_cast<float*>(dk),
      static_cast<float*>(dbias), sum_blocks, static_cast<const float*>(dy_partial),
      static_cast<T*>(dy_tiles), dy_elems, ranges);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadWidth = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int forward_v(int vec, const void* y_tiles, const void* k_agent, const void* bias, const void* obs,
              void* out, int num_levels, int samples_per_level, int t_range, int h, int w, int ch,
              cudaStream_t s) {
#define GU_STAMP_FORWARD(VEC)                                                                   \
  forward<T, VEC>(y_tiles, k_agent, bias, obs, out, num_levels, samples_per_level, t_range, h, w, \
                  ch, s)
  switch (vec) {
    case 1: return GU_STAMP_FORWARD(1);
    case 2: return GU_STAMP_FORWARD(2);
    case 4: return GU_STAMP_FORWARD(4);
    // eight channels only in bfloat16 (16 bytes); float32 stops at four
    case 8: return sizeof(T) == 2 ? GU_STAMP_FORWARD(16 / sizeof(T)) : kBadWidth;
    default: return kBadWidth;
  }
#undef GU_STAMP_FORWARD
}

template <typename T>
int backward_v(int vec, const void* grad, const void* out, const void* obs, void* dy_tiles,
               void* dy_partial, void* block_partial, void* dk, void* dbias, int num_levels,
               int samples_per_level, int h, int w, int ch, int cells, int tiles, int ranges,
               int t_range, int units, int units_per_block, int blocks, int slices, int width,
               cudaStream_t s) {
#define GU_STAMP_BACKWARD(VEC)                                                                   \
  backward<T, VEC>(grad, out, obs, dy_tiles, dy_partial, block_partial, dk, dbias, num_levels,  \
                   samples_per_level, h, w, ch, cells, tiles, ranges, t_range, units,           \
                   units_per_block, blocks, slices, width, s)
  switch (vec) {
    case 1: return GU_STAMP_BACKWARD(1);
    case 2: return GU_STAMP_BACKWARD(2);
    case 4: return GU_STAMP_BACKWARD(4);
    case 8: return sizeof(T) == 2 ? GU_STAMP_BACKWARD(16 / sizeof(T)) : kBadWidth;
    default: return kBadWidth;
  }
#undef GU_STAMP_BACKWARD
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of y_tiles and out); vec: channels a thread
// (16 bytes of them where C allows).
extern "C" int gu_agent_stamp(const void* y_tiles, const void* k_agent, const void* bias,
                              const void* obs, void* out, int num_levels, int samples_per_level,
                              int t_range, int h, int w, int ch, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? forward_v<float>(vec, y_tiles, k_agent, bias, obs, out, num_levels,
                                       samples_per_level, t_range, h, w, ch, s)
                    : forward_v<__nv_bfloat16>(vec, y_tiles, k_agent, bias, obs, out, num_levels,
                                               samples_per_level, t_range, h, w, ch, s);
}

// Launches two kernels: the units with each block's tree, then the sum of
// the blocks' partials (and of dy_tiles' ranges where there are several).
extern "C" int gu_agent_stamp_backward(const void* grad, const void* out, const void* obs,
                                       void* dy_tiles, void* dy_partial, void* block_partial,
                                       void* dk, void* dbias, int num_levels,
                                       int samples_per_level, int h, int w, int ch, int cells,
                                       int tiles, int ranges, int t_range, int units,
                                       int units_per_block, int blocks, int slices, int width,
                                       int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? backward_v<float>(vec, grad, out, obs, dy_tiles, dy_partial, block_partial, dk,
                                 dbias, num_levels, samples_per_level, h, w, ch, cells, tiles,
                                 ranges, t_range, units, units_per_block, blocks, slices, width, s)
             : backward_v<__nv_bfloat16>(vec, grad, out, obs, dy_tiles, dy_partial,
                                         block_partial, dk, dbias, num_levels, samples_per_level,
                                         h, w, ch, cells, tiles, ranges, t_range, units,
                                         units_per_block, blocks, slices, width, s);
}
