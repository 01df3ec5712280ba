// gae.cu — K7a: the reverse scans over a rollout.
//
// Replaces griduniverse_tpu/models/ppo.py `gae_advantages` (159): GAE(λ)
// advantages and value targets, and griduniverse_tpu/models/a2c.py
// `returns_from` (240): bootstrapped n-step returns. The JAX versions are
// `lax.scan(reverse=True)` over (T, B) arrays.
//
// Bound on the card: bytes. GAE reads 9 bytes and writes 8 per (t, env) and
// does a handful of float operations on them, so the least time is the
// trajectory once over the memory rate: at T = 16 and 65,536 envs 17.3 MB,
// 5.2 µs at 3.35 TB/s (the n-step scan 9.2 MB, 2.8 µs).
//
// Design: a thread takes W adjacent envs (`kernels.gae.plan`: 4 where B
// and every pointer allow 16-byte accesses of value, reward and the
// outputs and a 4-byte one of the done bytes, else 2, else 1) and walks t
// from T-1 down to 0 with the carries in registers. Its rows are loaded
// ahead of the walk: up to kRegRows steps (the register tier) every row
// before the first is used; above, in groups of kGroup rows, the next
// group's loads issued before this group is walked (the group tier). So at
// T = 16 the whole rollout is in flight at once, and a warp reads and
// writes 512 contiguous bytes of a float row and 128 of the done row. The
// float operations are in the plain version's order (`delta = r +
// γ·v_next·nd − v`, `adv = delta + γλ·nd·adv`; `g = r + γ·(done ? 0 : g)`),
// each product and sum rounded once (the file is built with -fmad=false),
// so the results equal the plain versions' bit for bit at every width.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 64;  // `kernels.gae.THREADS`
constexpr int kRegRows = 16;  // the register tier's largest T; `kernels.gae.REGISTER_T`
constexpr int kGroup = 8;     // rows a group above it; `kernels.gae.GROUP`

template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The W done bytes of a row, byte w for env w.
template <int W>
__device__ __forceinline__ uint32_t load_done(const uint8_t* p) {
  if constexpr (W == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else if constexpr (W == 2) return __ldg(reinterpret_cast<const unsigned short*>(p));
  else return __ldg(p);
}

__device__ __forceinline__ bool done_at(uint32_t bits, int w) { return ((bits >> (8 * w)) & 0xffu) != 0u; }

// R rows of W envs: rows hi, hi - 1, ..., hi - R + 1 (those ≥ 0).
template <int W, int R>
struct Rows {
  float v[R][W];  // value (GAE only)
  float r[R][W];  // reward
  uint32_t d[R];  // done bytes

  template <bool kValue>
  __device__ __forceinline__ void load(const float* value, const float* reward, const uint8_t* done,
                                       int hi, int batch, int b) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = hi - j;
      if (t >= 0) {
        const size_t o = static_cast<size_t>(t) * batch + b;
        if constexpr (kValue) load_row<W>(value + o, v[j]);
        load_row<W>(reward + o, r[j]);
        d[j] = load_done<W>(done + o);
      }
    }
  }
};

template <int W, int R>
__device__ __forceinline__ void gae_walk(const Rows<W, R>& x, int hi, int batch, int b, float gamma,
                                         float gamma_lam, float (&adv)[W], float (&v_next)[W],
                                         float* adv_out, float* targets) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int t = hi - j;
    if (t < 0) break;
    float a_row[W], t_row[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float v = x.v[j][w];
      const float notdone = 1.0f - (done_at(x.d[j], w) ? 1.0f : 0.0f);
      const float delta = x.r[j][w] + gamma * v_next[w] * notdone - v;
      adv[w] = delta + gamma_lam * notdone * adv[w];
      a_row[w] = adv[w];
      t_row[w] = adv[w] + v;
      v_next[w] = v;
    }
    const size_t o = static_cast<size_t>(t) * batch + b;
    store_row<W>(adv_out + o, a_row);
    store_row<W>(targets + o, t_row);
  }
}

template <int W, int R>
__device__ __forceinline__ void nstep_walk(const Rows<W, R>& x, int hi, int batch, int b, float gamma,
                                           float (&g)[W], float* returns) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int t = hi - j;
    if (t < 0) break;
#pragma unroll
    for (int w = 0; w < W; ++w) g[w] = x.r[j][w] + gamma * (done_at(x.d[j], w) ? 0.0f : g[w]);
    store_row<W>(returns + static_cast<size_t>(t) * batch + b, g);
  }
}

// kAll: T ≤ R, every row loaded before the walk (the register tier); else
// groups of R rows, two in flight (the group tier).
template <int W, int R, bool kAll>
__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ value, const float* __restrict__ reward,
           const uint8_t* __restrict__ done, const float* __restrict__ bootstrap,
           float* __restrict__ adv_out, float* __restrict__ targets, int num_steps, int batch,
           float gamma, float gamma_lam) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * W;
  if (b >= batch) return;
  float adv[W], v_next[W];
  load_row<W>(bootstrap + b, v_next);
#pragma unroll
  for (int w = 0; w < W; ++w) adv[w] = 0.0f;
  Rows<W, R> x;
  x.template load<true>(value, reward, done, num_steps - 1, batch, b);
  if constexpr (kAll) {
    gae_walk(x, num_steps - 1, batch, b, gamma, gamma_lam, adv, v_next, adv_out, targets);
  } else {
    Rows<W, R> y;
    for (int hi = num_steps - 1; hi >= 0; hi -= 2 * R) {
      y.template load<true>(value, reward, done, hi - R, batch, b);
      gae_walk(x, hi, batch, b, gamma, gamma_lam, adv, v_next, adv_out, targets);
      x.template load<true>(value, reward, done, hi - 2 * R, batch, b);
      gae_walk(y, hi - R, batch, b, gamma, gamma_lam, adv, v_next, adv_out, targets);
    }
  }
}

template <int W, int R, bool kAll>
__global__ void __launch_bounds__(kThreads)
nstep_returns_kernel(const float* __restrict__ reward, const uint8_t* __restrict__ done,
                     const float* __restrict__ bootstrap, float* __restrict__ returns, int num_steps,
                     int batch, float gamma) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * W;
  if (b >= batch) return;
  float g[W];
  load_row<W>(bootstrap + b, g);
  Rows<W, R> x;
  x.template load<false>(nullptr, reward, done, num_steps - 1, batch, b);
  if constexpr (kAll) {
    nstep_walk(x, num_steps - 1, batch, b, gamma, g, returns);
  } else {
    Rows<W, R> y;
    for (int hi = num_steps - 1; hi >= 0; hi -= 2 * R) {
      y.template load<false>(nullptr, reward, done, hi - R, batch, b);
      nstep_walk(x, hi, batch, b, gamma, g, returns);
      x.template load<false>(nullptr, reward, done, hi - 2 * R, batch, b);
      nstep_walk(y, hi - R, batch, b, gamma, g, returns);
    }
  }
}

// True if B and every pointer allow W envs a thread.
bool fits(int width, int batch, const void* done, std::initializer_list<const void*> floats) {
  if (width != 1 && width != 2 && width != 4) return false;
  if (batch % width != 0 || reinterpret_cast<uintptr_t>(done) % width != 0) return false;
  for (const void* p : floats) {
    if (reinterpret_cast<uintptr_t>(p) % (4 * width) != 0) return false;
  }
  return true;
}

unsigned int blocks(int batch, int width) {
  return static_cast<unsigned int>((batch / width + kThreads - 1) / kThreads);
}

template <int W>
void launch_gae(const void* value, const void* reward, const void* done, const void* bootstrap,
                void* adv, void* targets, int num_steps, int batch, float gamma, float gamma_lam,
                cudaStream_t st) {
  const auto* v = static_cast<const float*>(value);
  const auto* r = static_cast<const float*>(reward);
  const auto* d = static_cast<const uint8_t*>(done);
  const auto* boot = static_cast<const float*>(bootstrap);
  auto* a = static_cast<float*>(adv);
  auto* t = static_cast<float*>(targets);
  if (num_steps <= kRegRows) {
    gae_kernel<W, kRegRows, true><<<blocks(batch, W), kThreads, 0, st>>>(
        v, r, d, boot, a, t, num_steps, batch, gamma, gamma_lam);
  } else {
    gae_kernel<W, kGroup, false><<<blocks(batch, W), kThreads, 0, st>>>(
        v, r, d, boot, a, t, num_steps, batch, gamma, gamma_lam);
  }
}

template <int W>
void launch_nstep(const void* reward, const void* done, const void* bootstrap, void* returns,
                  int num_steps, int batch, float gamma, cudaStream_t st) {
  const auto* r = static_cast<const float*>(reward);
  const auto* d = static_cast<const uint8_t*>(done);
  const auto* boot = static_cast<const float*>(bootstrap);
  auto* out = static_cast<float*>(returns);
  if (num_steps <= kRegRows) {
    nstep_returns_kernel<W, kRegRows, true><<<blocks(batch, W), kThreads, 0, st>>>(
        r, d, boot, out, num_steps, batch, gamma);
  } else {
    nstep_returns_kernel<W, kGroup, false><<<blocks(batch, W), kThreads, 0, st>>>(
        r, d, boot, out, num_steps, batch, gamma);
  }
}

}  // namespace

// `width`: envs a thread, from `kernels.gae.plan`; refused (invalid value)
// where B or a pointer does not allow it.
extern "C" int gu_gae(const void* value, const void* reward, const void* done,
                      const void* bootstrap, void* adv, void* targets, int num_steps, int batch,
                      float gamma, float gamma_lam, int width, void* stream) {
  if (num_steps < 1 || batch < 1 ||
      !fits(width, batch, done, {value, reward, bootstrap, adv, targets})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (width == 4) launch_gae<4>(value, reward, done, bootstrap, adv, targets, num_steps, batch, gamma, gamma_lam, st);
  else if (width == 2) launch_gae<2>(value, reward, done, bootstrap, adv, targets, num_steps, batch, gamma, gamma_lam, st);
  else launch_gae<1>(value, reward, done, bootstrap, adv, targets, num_steps, batch, gamma, gamma_lam, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_nstep_returns(const void* reward, const void* done, const void* bootstrap,
                                void* returns, int num_steps, int batch, float gamma, int width,
                                void* stream) {
  if (num_steps < 1 || batch < 1 || !fits(width, batch, done, {reward, bootstrap, returns})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (width == 4) launch_nstep<4>(reward, done, bootstrap, returns, num_steps, batch, gamma, st);
  else if (width == 2) launch_nstep<2>(reward, done, bootstrap, returns, num_steps, batch, gamma, st);
  else launch_nstep<1>(reward, done, bootstrap, returns, num_steps, batch, gamma, st);
  return static_cast<int>(cudaGetLastError());
}
