// segment_mean.cu — K10: the deterministic per-(s, a) mean of α·δ.
//
// Replaces griduniverse_tpu/algos/td.py `apply_td_updates` (78) and
// `apply_td_updates_masked` (273): for each cell (s, a) of Q, the float sum
// of α·δ_b over the envs b at that cell (times the mask), the count, and
// q + sum / max(count, 1). The JAX version is two `segment_sum` scatters.
//
// Why not integer atomics, as in K5: with one env the result must be
// bit-exactly the sequential rule q[s,a] + α·δ, so the sum is a float sum.
// A float sum needs a fixed order to repeat; the order here is increasing
// env index, the order of a sequential scatter.
//
// Bound on the card: latency. The inputs are 12 bytes per env and the table
// once in and once out; at S·A = 1,024 cells and a few thousand envs that
// is tens of KB, so the time is the launch and one pass over the keys.
//
// Design: one warp owns a segment. The block stages the keys (s·A + a, or
// -1 where the mask is clear) and the values α·δ in shared memory, a tile
// of at most kTile envs at a time (8 bytes an env), and every warp carries
// its segment's running sum and count in registers from one tile to the
// next. A warp walks a tile's keys 32 at a time: a ballot marks the lanes
// whose key is the warp's segment, and the marked values are added one by
// one, lowest lane first, so each segment's sum runs in env order whatever
// the scheduling and whatever the tile size. A batch of at most kTile envs
// is one tile, staged once for all of the block's segments. Built with
// -fmad=false; α·δ is one rounding and the sum adds only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two per SM on the H100
constexpr int kTile = 28672;     // envs staged at a time: 224 KB of the 227 a block can use

extern __shared__ unsigned char smem_raw[];

__global__ void segment_mean_kernel(const float* __restrict__ q_in, float* __restrict__ q_out,
                                    const int* __restrict__ s, const int* __restrict__ a,
                                    const float* __restrict__ delta,
                                    const uint8_t* __restrict__ mask, float alpha, int batch,
                                    int num_actions, int n_seg) {
  const int tile = batch < kTile ? batch : kTile;
  int* keys = reinterpret_cast<int*>(smem_raw);
  float* vals = reinterpret_cast<float*>(keys + tile);

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  // every warp of the block takes the same number of rounds, so that all of
  // them reach each tile's barriers; a round past the last segment only stages
  const int first = (blockIdx.x * blockDim.x) >> 5;
  const int rounds = first < n_seg ? (n_seg - 1 - first) / n_warps + 1 : 0;
  for (int r = 0; r < rounds; ++r) {
    const int k = warp + r * n_warps;
    float sum = 0.0f;
    int count = 0;
    for (int t0 = 0; t0 < batch; t0 += tile) {
      const int len = batch - t0 < tile ? batch - t0 : tile;
      if (r == 0 || batch > tile) {  // one tile stays staged for every round
        __syncthreads();
        for (int i = threadIdx.x; i < len; i += blockDim.x) {
          const int b = t0 + i;
          const bool on = mask == nullptr || mask[b] != 0;
          keys[i] = on ? s[b] * num_actions + a[b] : -1;
          vals[i] = alpha * delta[b];
        }
        __syncthreads();
      }
      if (k >= n_seg) continue;
      for (int base = 0; base < len; base += 32) {
        const int i = base + lane;
        const bool hit = i < len && keys[i] == k;
        const float v = hit ? vals[i] : 0.0f;
        unsigned m = __ballot_sync(full, hit);
        while (m) {  // the same in every lane: env order, lowest lane first
          sum = sum + __shfl_sync(full, v, __ffs(m) - 1);
          count += 1;
          m &= m - 1;
        }
      }
    }
    if (k < n_seg && lane == 0)
      q_out[k] = q_in[k] + sum / static_cast<float>(count > 1 ? count : 1);
  }
}

}  // namespace

extern "C" int gu_segment_mean(const void* q_in, void* q_out, const void* s, const void* a,
                               const void* delta, const void* mask, float alpha, int batch,
                               int num_actions, int n_seg, void* stream) {
  const size_t smem = static_cast<size_t>(batch < kTile ? batch : kTile) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      segment_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kThreads / 32;
  int blocks = (n_seg + warps_per_block - 1) / warps_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_mean_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_in), static_cast<float*>(q_out), static_cast<const int*>(s),
      static_cast<const int*>(a), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), alpha, batch, num_actions, n_seg);
  return static_cast<int>(cudaGetLastError());
}
