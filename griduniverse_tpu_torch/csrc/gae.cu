// gae.cu — K7a: the reverse scans over a rollout, one thread per env.
//
// Replaces griduniverse_tpu/models/ppo.py `gae_advantages` (159): GAE(λ)
// advantages and value targets, and griduniverse_tpu/models/a2c.py
// `returns_from` (240): bootstrapped n-step returns. The JAX versions are
// `lax.scan(reverse=True)` over (T, B) arrays.
//
// Bound on the card: bytes. GAE reads 9 bytes and writes 8 per (t, env) and
// does a handful of float operations on them, so the least time is the
// trajectory once over the memory rate; at T = 16 and 65,536 envs that is a
// few microseconds, less than a launch.
//
// Design: one thread per env walks t from T-1 down to 0 with the carry in
// registers. The arrays are (T, B) row-major, so a warp reads 32
// neighbouring envs of one row. The float operations are in the plain
// version's order (`delta = r + γ·v_next·nd − v`, `adv = delta + γλ·nd·adv`),
// each product and sum rounded once (the file is built with -fmad=false), so
// the results equal the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void gae_kernel(const float* __restrict__ value, const float* __restrict__ reward,
                           const uint8_t* __restrict__ done, const float* __restrict__ bootstrap,
                           float* __restrict__ adv_out, float* __restrict__ targets, int num_steps,
                           int batch, float gamma, float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float adv = 0.0f;
  float v_next = bootstrap[b];
  for (int t = num_steps - 1; t >= 0; --t) {
    const size_t o = static_cast<size_t>(t) * batch + b;
    const float v = value[o];
    const float notdone = 1.0f - (done[o] ? 1.0f : 0.0f);
    const float delta = reward[o] + gamma * v_next * notdone - v;
    adv = delta + gamma_lam * notdone * adv;
    adv_out[o] = adv;
    targets[o] = adv + v;
    v_next = v;
  }
}

__global__ void nstep_returns_kernel(const float* __restrict__ reward,
                                     const uint8_t* __restrict__ done,
                                     const float* __restrict__ bootstrap, float* __restrict__ returns,
                                     int num_steps, int batch, float gamma) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float g = bootstrap[b];
  for (int t = num_steps - 1; t >= 0; --t) {
    const size_t o = static_cast<size_t>(t) * batch + b;
    g = reward[o] + gamma * (done[o] ? 0.0f : g);
    returns[o] = g;
  }
}

}  // namespace

extern "C" int gu_gae(const void* value, const void* reward, const void* done,
                      const void* bootstrap, void* adv, void* targets, int num_steps, int batch,
                      float gamma, float gamma_lam, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(reward),
      static_cast<const uint8_t*>(done), static_cast<const float*>(bootstrap),
      static_cast<float*>(adv), static_cast<float*>(targets), num_steps, batch, gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_nstep_returns(const void* reward, const void* done, const void* bootstrap,
                                void* returns, int num_steps, int batch, float gamma,
                                void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  nstep_returns_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(reward), static_cast<const uint8_t*>(done),
      static_cast<const float*>(bootstrap), static_cast<float*>(returns), num_steps, batch, gamma);
  return static_cast<int>(cudaGetLastError());
}
