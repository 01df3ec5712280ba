// mc_returns.cu — K13: Monte-Carlo returns and the first-visit mask of B
// episodes of T steps, one launch.
//
// Replaces griduniverse_tpu/algos/mc.py `discounted_returns` (59-68), a
// reverse `lax.scan` of `G_t = r_t + γ·G_{t+1}`, and `first_visit_mask`
// (71-82), the reference's TPU-first redesign: a (T, T, B) broadcast
// compare of every step's id against every earlier one, O(T²·B) work in
// dense vector operations because the TPU has no cheap per-lane loop.
//
// Bound on the card: bytes. It reads each sample's reward, id and valid
// flag once and writes its return and mask flag once, 14 bytes a sample
// (358 KB for 100 steps of 256 episodes); at these sizes the launch.
//
// Design. The (T, B) arrays are row-major. A block takes a group of
// `group` consecutive episodes (a power of two up to 32) and walks their
// steps in tiles of `tile` rows from the last tile to the first; the plan
// (`kernels/mc_returns.py` `plan`) makes one tile of all T steps where
// 9 × T × group bytes fit the block's 48 KB, and at the trainers' T = 100
// every episode is one tile. For each tile the block
//   1. stages the tile's rewards, ids and valid flags into shared memory,
//      a row of the group at a time: `group` consecutive addresses of each
//      array (128 bytes of rewards at 32 episodes);
//   2. runs the returns in warp 0, one lane an episode, from the tile's
//      last row up, carrying G across tiles: the same chain of a multiply
//      and an add, rounded apart (-fmad=false), as the plain version, with
//      its loads from shared memory, eight rows ahead. The chain stays
//      serial per episode: a parallel scan would round in another order;
//   3. spreads the first-visit test over the block's threads, a thread a
//      (step, episode) pair: a valid step is first unless a valid earlier
//      step of its episode has its id, tested against the staged earlier
//      rows of the tile (eight at a time, stopping at the first match) and
//      then, where the episode has earlier tiles, against those in device
//      memory. The mask is a yes/no of integer compares, so any split of
//      the work gives the plain version's bits, for any int32 ids;
//   4. writes the returns back from shared memory with coalesced stores;
//      each thread writes its pairs' mask flags.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShift = 5;               // 32 episodes a block at most: the returns' lanes are warp 0's
constexpr int kSharedBytes = 48 * 1024;    // a block's staged tile, without an opt-in
constexpr int kBytesPerCell = 9;           // a reward (then its return), an id, a valid flag
constexpr int kChainRows = 8;              // rows of the returns' chain loaded at once
constexpr int kScanRows = 8;               // earlier rows the first-visit test reads at once

// Is `id` the id of a valid earlier row of the episode in column c? Rows
// u < r of the staged tile, kScanRows compares in flight at once.
__device__ __forceinline__ bool seen_in_tile(const int* ids, const uint8_t* valid, int c, int r,
                                             int shift, int id) {
  int u = 0;
  for (; u + kScanRows <= r; u += kScanRows) {
    int i[kScanRows];
    uint8_t v[kScanRows];
#pragma unroll
    for (int q = 0; q < kScanRows; ++q) {
      i[q] = ids[((u + q) << shift) + c];
      v[q] = valid[((u + q) << shift) + c];
    }
    bool hit = false;
#pragma unroll
    for (int q = 0; q < kScanRows; ++q) hit |= v[q] && i[q] == id;
    if (hit) return true;
  }
  for (; u < r; ++u) {
    const int k = (u << shift) + c;
    if (valid[k] && ids[k] == id) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
mc_returns_kernel(const float* __restrict__ rewards, const int* __restrict__ ids,
                  const uint8_t* __restrict__ valid, int num_steps, int batch, float gamma,
                  float* __restrict__ returns, uint8_t* __restrict__ mask, int shift, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = 1 << shift;
  float* const r_s = reinterpret_cast<float*>(smem);
  int* const id_s = reinterpret_cast<int*>(r_s + tile * group);
  uint8_t* const v_s = reinterpret_cast<uint8_t*>(id_s + tile * group);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x << shift;
  const int width = min(group, batch - b0);  // episodes of this block
  const bool with_mask = ids != nullptr;
  float g = 0.0f;                            // lane tid < width: its episode's return
  const int tiles = (num_steps + tile - 1) / tile;
  for (int j = tiles - 1; j >= 0; --j) {
    const int t0 = j * tile;
    const int cells = min(tile, num_steps - t0) << shift;
    for (int k = tid; k < cells; k += kThreads) {
      const int c = k & (group - 1);
      if (c < width) {
        const size_t i = static_cast<size_t>(t0 + (k >> shift)) * batch + b0 + c;
        r_s[k] = __ldg(rewards + i);
        if (with_mask) {
          id_s[k] = __ldg(ids + i);
          v_s[k] = __ldg(valid + i);
        }
      }
    }
    __syncthreads();
    if (tid < width) {
      // eight rows' rewards loaded before their eight steps of the chain,
      // so that a step waits on the multiply and the add, not on a load
      int k = cells - group + tid;
      for (; k >= kChainRows * group - group; k -= kChainRows * group) {
        float r[kChainRows];
#pragma unroll
        for (int q = 0; q < kChainRows; ++q) r[q] = r_s[k - q * group];
#pragma unroll
        for (int q = 0; q < kChainRows; ++q) {
          g = r[q] + gamma * g;
          r_s[k - q * group] = g;
        }
      }
      for (; k >= 0; k -= group) {
        g = r_s[k] + gamma * g;
        r_s[k] = g;
      }
    }
    if (with_mask) {
      for (int k = tid; k < cells; k += kThreads) {
        const int c = k & (group - 1);
        if (c >= width) continue;
        const int r = k >> shift;
        bool first = v_s[k] != 0;
        if (first) {
          const int id = id_s[k];
          first = !seen_in_tile(id_s, v_s, c, r, shift, id);
          // earlier tiles, from device memory (only where T is above one tile)
          for (int t = 0; first && t < t0; ++t) {
            const size_t i = static_cast<size_t>(t) * batch + b0 + c;
            first = !(__ldg(valid + i) && __ldg(ids + i) == id);
          }
        }
        mask[static_cast<size_t>(t0 + r) * batch + b0 + c] = first;
      }
    }
    __syncthreads();
    for (int k = tid; k < cells; k += kThreads) {
      const int c = k & (group - 1);
      if (c < width) returns[static_cast<size_t>(t0 + (k >> shift)) * batch + b0 + c] = r_s[k];
    }
    __syncthreads();  // the next tile's staging overwrites this one
  }
}

}  // namespace

// `ids`, `valid` and `mask` are null when only the returns are wanted. A
// block takes `group` = 2^shift episodes in tiles of `tile` steps (the
// wrapper's `plan`); `9 × tile × group` bytes of shared memory.
extern "C" int gu_mc_returns(const void* rewards, const void* ids, const void* valid,
                             int num_steps, int batch, float gamma, void* returns, void* mask,
                             int shift, int tile, void* stream) {
  if (num_steps < 1 || batch < 1 || shift < 0 || shift > kMaxShift || tile < 1 ||
      tile > num_steps || static_cast<long long>(tile) * kBytesPerCell << shift > kSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((static_cast<long long>(batch) + (1 << shift) - 1) >> shift);
  const int shared = (tile << shift) * kBytesPerCell;
  mc_returns_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(valid), num_steps, batch, gamma, static_cast<float*>(returns),
      static_cast<uint8_t*>(mask), shift, tile);
  return static_cast<int>(cudaGetLastError());
}
