// rollout.cu — K1 (random-action scan) and K2 (pre-drawn-action rollout).
//
// K1 replaces griduniverse_tpu/ops/bitplane.py `random_scan_bits` (334):
// T random-action auto-reset steps per env, actions drawn from a per-env
// xorshift32 stream, with per-env episode accumulators. K2 replaces
// `rollout_actions_bits` (278), which replays pre-drawn (T, B) actions in
// the freeze-on-done or the auto-reset mode of `step_bits` (230).
//
// Bound on the card: nothing but the step itself. K1 reads and writes a
// few words per env at the start and the end and nothing in between, so
// it is bound by the latency of each env's chain of dependent steps and by
// how many envs are in flight (one thread each). K2 also writes 9 bytes
// per env and step (obs, reward, done), which at large T makes it bound by
// device-memory writes.
//
// Design: one thread per env, the whole T loop inside one launch. The env
// state, the xorshift state and the accumulators live in registers. A
// shared level's packed words are copied into shared memory (at most 4 KB);
// a per-env level reads its own row of words, which stays in L1/L2. K2
// writes element [t, b], so neighbouring threads write neighbouring
// addresses. Float adds keep the JAX order (`run_ret += reward`, then
// `ret_sum += run_ret` on done), and the file must be built without
// --use_fast_math, so the accumulators equal the plain version's bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void random_scan_bits_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas,
    int num_actions, const uint32_t* __restrict__ words, int n_words,
    int per_env, const int* __restrict__ start_idx,
    const int* __restrict__ start_code, int h, int w, int batch, int num_steps,
    int max_episode_steps, const int* __restrict__ idx_in,
    const int* __restrict__ code_in, const int* __restrict__ t_in,
    const uint32_t* __restrict__ rs_in, int* __restrict__ idx_out,
    int* __restrict__ code_out, int* __restrict__ t_out,
    uint8_t* __restrict__ done_out, int* __restrict__ n_eps_out,
    float* __restrict__ ret_sum_out, int* __restrict__ len_sum_out) {
  __shared__ gu::Tables tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  gu::load_tables(tab, passable, terminal, reward, deltas, num_actions);
  if (!per_env) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_words[i] = words[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint32_t* lw = per_env ? words + static_cast<size_t>(b) * n_words : s_words;
  const int s_idx = per_env ? start_idx[b] : start_idx[0];
  const int s_code = per_env ? start_code[b] : start_code[0];
  const unsigned na = static_cast<unsigned>(num_actions);

  int idx = idx_in[b], code = code_in[b], t = t_in[b];
  uint32_t rs = rs_in[b];
  gu::Episode ep{0.0f, 0.0f, 0, 0};
  for (int step = 0; step < num_steps; ++step) {
    rs = gu::xorshift32(rs);
    const int a = static_cast<int>((rs >> 9) % na);  // top bits are the strongest
    gu::step_autoreset(tab, lw, h, w, s_idx, s_code, max_episode_steps, a, idx, code, t, ep);
  }
  idx_out[b] = idx;
  code_out[b] = code;
  t_out[b] = t;
  done_out[b] = 0;
  n_eps_out[b] = ep.n_eps;
  ret_sum_out[b] = ep.ret_sum;
  len_sum_out[b] = ep.len_sum;
}

__global__ void rollout_actions_bits_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas,
    int num_actions, const uint32_t* __restrict__ words, int n_words,
    int per_env, const int* __restrict__ start_idx,
    const int* __restrict__ start_code, int h, int w, int batch, int num_steps,
    int auto_reset, int max_episode_steps, const int* __restrict__ actions,
    const int* __restrict__ idx_in, const int* __restrict__ code_in,
    const int* __restrict__ t_in, const uint8_t* __restrict__ done_in,
    int* __restrict__ idx_out, int* __restrict__ code_out,
    int* __restrict__ t_out, uint8_t* __restrict__ done_out,
    int* __restrict__ obs_traj, float* __restrict__ reward_traj,
    uint8_t* __restrict__ done_traj) {
  __shared__ gu::Tables tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  gu::load_tables(tab, passable, terminal, reward, deltas, num_actions);
  if (!per_env) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_words[i] = words[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint32_t* lw = per_env ? words + static_cast<size_t>(b) * n_words : s_words;
  const int s_idx = per_env ? start_idx[b] : start_idx[0];
  const int s_code = per_env ? start_code[b] : start_code[0];

  int idx = idx_in[b], code = code_in[b], t = t_in[b];
  bool was_done = auto_reset ? false : (done_in[b] != 0);
  gu::Episode unused{0.0f, 0.0f, 0, 0};
  for (int step = 0; step < num_steps; ++step) {
    const size_t o = static_cast<size_t>(step) * batch + b;
    const int a = gu::clamp_action(actions[o], num_actions);
    if (auto_reset) {
      const gu::Transition tr = gu::step_autoreset(
          tab, lw, h, w, s_idx, s_code, max_episode_steps, a, idx, code, t, unused);
      obs_traj[o] = tr.obs;
      reward_traj[o] = tr.reward;
      done_traj[o] = tr.done;
    } else {
      const gu::Move m = gu::move_bits(tab, lw, h, w, idx, code, a);
      if (was_done) {  // frozen after termination
        reward_traj[o] = 0.0f;
      } else {
        idx = m.idx;
        code = m.code;
        t += 1;
        was_done = m.done;
        reward_traj[o] = m.reward;
      }
      obs_traj[o] = idx;
      done_traj[o] = was_done;
    }
  }
  idx_out[b] = idx;
  code_out[b] = code;
  t_out[b] = t;
  done_out[b] = was_done;
}

}  // namespace

extern "C" const char* gu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gu_random_scan_bits(
    const void* passable, const void* terminal, const void* reward,
    const void* deltas, int num_actions, const void* words, int n_words,
    int per_env, const void* start_idx, const void* start_code, int h, int w,
    int batch, int num_steps, int max_episode_steps, const void* idx_in,
    const void* code_in, const void* t_in, const void* rs_in, void* idx_out,
    void* code_out, void* t_out, void* done_out, void* n_eps, void* ret_sum,
    void* len_sum, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  random_scan_bits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env,
      static_cast<const int*>(start_idx), static_cast<const int*>(start_code), h, w,
      batch, num_steps, max_episode_steps, static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const uint32_t*>(rs_in), static_cast<int*>(idx_out),
      static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(done_out), static_cast<int*>(n_eps),
      static_cast<float*>(ret_sum), static_cast<int*>(len_sum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_rollout_actions_bits(
    const void* passable, const void* terminal, const void* reward,
    const void* deltas, int num_actions, const void* words, int n_words,
    int per_env, const void* start_idx, const void* start_code, int h, int w,
    int batch, int num_steps, int auto_reset, int max_episode_steps,
    const void* actions, const void* idx_in, const void* code_in,
    const void* t_in, const void* done_in, void* idx_out, void* code_out,
    void* t_out, void* done_out, void* obs, void* reward_traj, void* done_traj,
    void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  rollout_actions_bits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env,
      static_cast<const int*>(start_idx), static_cast<const int*>(start_code), h, w,
      batch, num_steps, auto_reset, max_episode_steps,
      static_cast<const int*>(actions), static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const uint8_t*>(done_in), static_cast<int*>(idx_out),
      static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(done_out), static_cast<int*>(obs),
      static_cast<float*>(reward_traj), static_cast<uint8_t*>(done_traj));
  return static_cast<int>(cudaGetLastError());
}
