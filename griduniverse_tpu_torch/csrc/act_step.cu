// act_step.cu — K7b: sample an action from the policy's logits and step the
// env, one thread per env; and its greedy, freeze-on-done form.
//
// Replaces the rollout bodies of griduniverse_tpu/models/ppo.py (199-214)
// and griduniverse_tpu/models/a2c.py (226-234): `a = argmax(logits + g)`
// (Gumbel-max sampling with pre-drawn noise), `logp = log_softmax(logits)[a]`
// and one auto-reset step with the optional time limit; and the body of
// griduniverse_tpu/models/evaluation.py `greedy_reached` (57-64):
// `a = argmax(logits)`, one freeze-on-done step, and the sticky flag "this
// env entered a positively rewarded terminal". The JAX versions are XLA
// fusions inside a `lax.scan`, with one-hot sums in place of gathers.
//
// Bound on the card: bytes, and at these sizes the launch. Per env it reads
// 2·A floats and 12 bytes of state and writes 29 bytes; the step itself is
// `gu::step_autoreset` of step.cuh, a short chain of integer operations on
// tables in shared memory.
//
// Design: one thread per env. The semantics tables, and a shared level's
// packed words, are staged in shared memory as K1 does. The argmax takes
// the first maximum, as `jnp.argmax` and `torch.argmax` do. `logp` is
// `logits[a] − max − log Σ exp(logits − max)` in float32 through `expf` and
// `logf`; it is the one output that need not equal the plain version to the
// last bit (the library's exp, log and sum order differ). Everything else
// (action, new state, obs, reward, done) equals the plain version exactly.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void act_step_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas, int num_actions,
    const uint32_t* __restrict__ words, int n_words, int per_env,
    const int* __restrict__ start_idx, const int* __restrict__ start_code, int h, int w,
    int batch, int max_episode_steps, const float* __restrict__ logits,
    const float* __restrict__ gumbel, const int* __restrict__ idx_in,
    const int* __restrict__ code_in, const int* __restrict__ t_in, int* __restrict__ idx_out,
    int* __restrict__ code_out, int* __restrict__ t_out, uint8_t* __restrict__ state_done_out,
    int* __restrict__ action_out, float* __restrict__ logp_out, int* __restrict__ obs_out,
    float* __restrict__ reward_out, uint8_t* __restrict__ done_out) {
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

  float row[gu::kMaxActions];
  float noisy[gu::kMaxActions];
  const size_t base = static_cast<size_t>(b) * num_actions;
  for (int a = 0; a < num_actions; ++a) {
    row[a] = logits[base + a];
    noisy[a] = row[a] + gumbel[base + a];
  }
  const int a = gu::first_argmax(noisy, num_actions);
  float m = row[0];
  for (int k = 1; k < num_actions; ++k) m = fmaxf(m, row[k]);
  float sum = 0.0f;
  for (int k = 0; k < num_actions; ++k) sum += expf(row[k] - m);
  const float logp = row[a] - m - logf(sum);

  int idx = idx_in[b], code = code_in[b], t = t_in[b];
  obs_out[b] = idx;  // the observation the action was taken from
  gu::Episode unused{0.0f, 0.0f, 0, 0};
  const gu::Transition tr = gu::step_autoreset(tab, lw, h, w, s_idx, s_code, max_episode_steps, a,
                                               idx, code, t, unused);
  idx_out[b] = idx;
  code_out[b] = code;
  t_out[b] = t;
  state_done_out[b] = 0;
  action_out[b] = a;
  logp_out[b] = logp;
  reward_out[b] = tr.reward;
  done_out[b] = tr.done;
}

__global__ void greedy_step_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas, int num_actions,
    const uint32_t* __restrict__ words, int n_words, int per_env, int h, int w, int batch,
    const float* __restrict__ logits, const int* __restrict__ idx_in,
    const int* __restrict__ code_in, const int* __restrict__ t_in,
    const uint8_t* __restrict__ done_in, const uint8_t* __restrict__ reached_in,
    int* __restrict__ idx_out, int* __restrict__ code_out, int* __restrict__ t_out,
    uint8_t* __restrict__ done_out, uint8_t* __restrict__ reached_out) {
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
  const int a = gu::first_argmax(logits + static_cast<size_t>(b) * num_actions, num_actions);

  int idx = idx_in[b], code = code_in[b], t = t_in[b];
  bool done = done_in[b] != 0;
  bool reached = reached_in[b] != 0;
  if (!done) {  // frozen after termination
    const gu::Move m = gu::move_bits(tab, lw, h, w, idx, code, a);
    idx = m.idx;
    code = m.code;
    t += 1;
    done = m.done;
    reached = reached || (m.done && m.reward > 0.0f);
  }
  idx_out[b] = idx;
  code_out[b] = code;
  t_out[b] = t;
  done_out[b] = done;
  reached_out[b] = reached;
}

}  // namespace

extern "C" int gu_act_step(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int batch, int max_episode_steps, const void* logits,
    const void* gumbel, const void* idx_in, const void* code_in, const void* t_in, void* idx_out,
    void* code_out, void* t_out, void* state_done_out, void* action_out, void* logp_out,
    void* obs_out, void* reward_out, void* done_out, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  act_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env, static_cast<const int*>(start_idx),
      static_cast<const int*>(start_code), h, w, batch, max_episode_steps,
      static_cast<const float*>(logits), static_cast<const float*>(gumbel),
      static_cast<const int*>(idx_in), static_cast<const int*>(code_in),
      static_cast<const int*>(t_in), static_cast<int*>(idx_out), static_cast<int*>(code_out),
      static_cast<int*>(t_out), static_cast<uint8_t*>(state_done_out),
      static_cast<int*>(action_out), static_cast<float*>(logp_out), static_cast<int*>(obs_out),
      static_cast<float*>(reward_out), static_cast<uint8_t*>(done_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_greedy_step(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, int h, int w, int batch,
    const void* logits, const void* idx_in, const void* code_in, const void* t_in,
    const void* done_in, const void* reached_in, void* idx_out, void* code_out, void* t_out,
    void* done_out, void* reached_out, void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  greedy_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env, h, w, batch,
      static_cast<const float*>(logits), static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const uint8_t*>(done_in), static_cast<const uint8_t*>(reached_in),
      static_cast<int*>(idx_out), static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(done_out), static_cast<uint8_t*>(reached_out));
  return static_cast<int>(cudaGetLastError());
}
