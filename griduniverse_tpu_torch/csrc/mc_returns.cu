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
// Design: one thread per episode b, the (T, B) arrays row-major, so the
// threads of a warp read and write neighbouring addresses at every t. The
// thread walks t from T−1 down to 0 for the returns, in float32 with the
// multiply and the add rounded separately (-fmad=false), as the plain
// version; then from t = 0 up for the mask, comparing each valid step's id
// with the earlier valid steps of its own episode and stopping at the
// first match. The mask is a yes/no of integer compares, so it equals the
// plain version exactly whatever the order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // 256 episodes fill four blocks

__global__ void mc_returns_kernel(const float* __restrict__ rewards, const int* __restrict__ ids,
                                  const uint8_t* __restrict__ valid, int num_steps, int batch,
                                  float gamma, float* __restrict__ returns,
                                  uint8_t* __restrict__ mask) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float g = 0.0f;
  for (int t = num_steps - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * batch + b;
    g = rewards[i] + gamma * g;
    returns[i] = g;
  }
  if (ids == nullptr) return;
  for (int t = 0; t < num_steps; ++t) {
    const size_t i = static_cast<size_t>(t) * batch + b;
    bool first = valid[i] != 0;
    if (first) {
      const int id = ids[i];
      for (int u = 0; u < t; ++u) {
        const size_t j = static_cast<size_t>(u) * batch + b;
        if (valid[j] != 0 && ids[j] == id) {
          first = false;
          break;
        }
      }
    }
    mask[i] = first;
  }
}

}  // namespace

// `ids`, `valid` and `mask` are null when only the returns are wanted.
extern "C" int gu_mc_returns(const void* rewards, const void* ids, const void* valid,
                             int num_steps, int batch, float gamma, void* returns, void* mask,
                             void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  mc_returns_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(valid), num_steps, batch, gamma, static_cast<float*>(returns),
      static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}
