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
// Bound on the card: bytes, and at these sizes the launch and the host's
// work around it. Per env it reads 2·A floats and 12 bytes of state and
// writes 30 bytes; the step itself is `gu::step_autoreset` of step.cuh, a
// short chain of integer operations on tables in shared memory.
//
// Design: one launch a rollout step behind a host plan (`kernels/act_step.py`
// `ActStepPlan`), built once a run. The plan holds, in one C struct, the
// checked semantics and level, the rollout's noise, the (T, B) rows of the
// trajectory and two slots of env state; a step reads its state from a slot
// (or the caller's tensors) and writes the other slot and row t of the
// trajectory in place, so a step allocates nothing and makes no view. One
// thread per env; the semantics tables, and a shared level's packed words,
// are staged in shared memory as K1 does. At A = 4 a row of logits and one
// of noise are one 16-byte load each. The argmax takes the first maximum,
// as `jnp.argmax` and `torch.argmax` do. `logp` is
// `logits[a] − max − log Σ exp(logits − max)` in float32 through `expf` and
// `logf`; it is the one output that need not equal the plain version to the
// last bit (the library's exp, log and sum order differ). Everything else
// (action, new state, obs, reward, done) equals the plain version exactly.
// Above eight actions (kForm = kWide) the rows stay in device memory and
// the loops keep none: a running first argmax of logits + noise, the
// maximum, then Σ exp in index order, the same operations in the same
// order as the row in registers.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStateFields = 5;  // a slot: agent_idx, agent_code, t, done, reached

// `kernels/act_step.py` `_PlanArgs`, field for field
struct ActPlan {
  const uint8_t* passable;
  const uint8_t* terminal;
  const float* reward;
  const int* deltas;
  int num_actions;
  const uint32_t* words;
  int n_words;
  int per_env;
  const int* start_idx;
  const int* start_code;
  int h;
  int w;
  int batch;
  int max_episode_steps;
  const float* gumbel;  // (T, B, A): the rollout's noise
  int* obs;             // the trajectory's (T, B) rows
  int* action;
  float* logp;
  float* reward_row;
  uint8_t* done;
  void* slot[2][kStateFields];
};

struct StateIn {
  const int* idx;
  const int* code;
  const int* t;
  const uint8_t* done;
  const uint8_t* reached;
};

// A kernel's form: a row of four in one 16-byte load, up to eight in
// registers, or any number read where used (gu::WideTables).
enum Form : int { kVec4 = 0, kRow = 1, kWide = 2 };

template <int kForm>
using TablesOf = typename std::conditional<kForm == kWide, gu::WideTables, gu::Tables>::type;

// The plan's semantics tables, and a shared level's words, into shared memory.
template <typename Tab>
__device__ __forceinline__ void stage(const ActPlan& p, Tab& tab, uint32_t* s_words) {
  gu::load_tables(tab, p.passable, p.terminal, p.reward, p.deltas, p.num_actions);
  if (!p.per_env) {
    for (int i = threadIdx.x; i < p.n_words; i += blockDim.x) s_words[i] = p.words[i];
  }
  __syncthreads();
}

// The env's row of `x` (B, A) into `row`: one 16-byte load where kFour.
template <bool kFour>
__device__ __forceinline__ void load_logits(const float* x, int b, int na, float* row) {
  if constexpr (kFour) {
    const float4 v = reinterpret_cast<const float4*>(x)[b];
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  } else {
    for (int k = 0; k < na; ++k) row[k] = x[static_cast<size_t>(b) * na + k];
  }
}

// (the sampled action, its log-probability) from the env's logits and
// noise rows, read where used (the wide form): the first maximum of
// logits + noise, then logits[a] − max − log Σ exp(logits − max), in the
// order of the row in registers.
__device__ __forceinline__ int sample_wide(const float* lg, const float* g, int na, float& logp) {
  int a = 0;
  float top = lg[0] + g[0];
  float m = lg[0];
  for (int k = 1; k < na; ++k) {
    const float x = lg[k];
    const float noisy = x + g[k];
    if (noisy > top) {
      top = noisy;
      a = k;
    }
    m = fmaxf(m, x);
  }
  float sum = 0.0f;
  for (int k = 0; k < na; ++k) sum += expf(lg[k] - m);
  logp = lg[a] - m - logf(sum);
  return a;
}

template <int kForm>
__global__ void act_step_kernel(ActPlan p, int step, const float* __restrict__ logits,
                                StateIn in, int out) {
  constexpr bool kV4 = kForm == kVec4;
  __shared__ TablesOf<kForm> tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  stage(p, tab, s_words);

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const int na = kV4 ? 4 : p.num_actions;
  const uint32_t* lw = p.per_env ? p.words + static_cast<size_t>(b) * p.n_words : s_words;
  const int s_idx = p.per_env ? p.start_idx[b] : p.start_idx[0];
  const int s_code = p.per_env ? p.start_code[b] : p.start_code[0];

  int a;
  float logp;
  if constexpr (kForm == kWide) {
    const size_t row0 = static_cast<size_t>(b) * na;
    a = sample_wide(logits + row0, p.gumbel + static_cast<size_t>(step) * p.batch * na + row0, na, logp);
  } else {
    float row[gu::kMaxActions];
    float noisy[gu::kMaxActions];
    load_logits<kV4>(logits, b, na, row);
    load_logits<kV4>(p.gumbel + static_cast<size_t>(step) * p.batch * na, b, na, noisy);
    for (int k = 0; k < na; ++k) noisy[k] = row[k] + noisy[k];
    a = gu::first_argmax(noisy, na);
    float m = row[0];
    for (int k = 1; k < na; ++k) m = fmaxf(m, row[k]);
    float sum = 0.0f;
    for (int k = 0; k < na; ++k) sum += expf(row[k] - m);
    logp = row[a] - m - logf(sum);
  }

  int idx = in.idx[b], code = in.code[b], t = in.t[b];
  const size_t o = static_cast<size_t>(step) * p.batch + b;
  p.obs[o] = idx;  // the observation the action was taken from
  gu::Episode unused{0.0f, 0.0f, 0, 0};
  const gu::Transition tr = gu::step_autoreset(tab, lw, p.h, p.w, s_idx, s_code,
                                               p.max_episode_steps, a, idx, code, t, unused);
  static_cast<int*>(p.slot[out][0])[b] = idx;
  static_cast<int*>(p.slot[out][1])[b] = code;
  static_cast<int*>(p.slot[out][2])[b] = t;
  static_cast<uint8_t*>(p.slot[out][3])[b] = 0;
  p.action[o] = a;
  p.logp[o] = logp;
  p.reward_row[o] = tr.reward;
  p.done[o] = tr.done;
}

template <int kForm>
__global__ void greedy_step_kernel(ActPlan p, const float* __restrict__ logits, StateIn in,
                                   int out) {
  constexpr bool kV4 = kForm == kVec4;
  __shared__ TablesOf<kForm> tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  stage(p, tab, s_words);

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  const int na = kV4 ? 4 : p.num_actions;
  const uint32_t* lw = p.per_env ? p.words + static_cast<size_t>(b) * p.n_words : s_words;
  int a;
  if constexpr (kForm == kWide) {
    a = gu::first_argmax(logits + static_cast<size_t>(b) * na, na);
  } else {
    float row[gu::kMaxActions];
    load_logits<kV4>(logits, b, na, row);
    a = gu::first_argmax(row, na);
  }

  int idx = in.idx[b], code = in.code[b], t = in.t[b];
  bool done = in.done[b] != 0;
  bool reached = in.reached[b] != 0;
  if (!done) {  // frozen after termination
    const gu::Move m = gu::move_bits(tab, lw, p.h, p.w, idx, code, a);
    idx = m.idx;
    code = m.code;
    t += 1;
    done = m.done;
    reached = reached || (m.done && m.reward > 0.0f);
  }
  static_cast<int*>(p.slot[out][0])[b] = idx;
  static_cast<int*>(p.slot[out][1])[b] = code;
  static_cast<int*>(p.slot[out][2])[b] = t;
  static_cast<uint8_t*>(p.slot[out][3])[b] = done;
  static_cast<uint8_t*>(p.slot[out][4])[b] = reached;
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

}  // namespace

// Rollout step `step` of the plan (host memory): logits (B, A), the state
// in (idx, code, t), written to the plan's slot `out` and row `step`.
extern "C" int gu_act_step(const void* plan, int step, const void* logits, const void* idx_in,
                           const void* code_in, const void* t_in, int out, void* stream) {
  const ActPlan& p = *static_cast<const ActPlan*>(plan);
  const StateIn in{static_cast<const int*>(idx_in), static_cast<const int*>(code_in),
                   static_cast<const int*>(t_in), nullptr, nullptr};
  const int blocks = (p.batch + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  if (p.num_actions == 4 && aligned16(lg) && aligned16(p.gumbel)) {
    act_step_kernel<kVec4><<<blocks, kThreads, 0, st>>>(p, step, lg, in, out);
  } else if (p.num_actions > gu::kMaxActions) {
    act_step_kernel<kWide><<<blocks, kThreads, 0, st>>>(p, step, lg, in, out);
  } else {
    act_step_kernel<kRow><<<blocks, kThreads, 0, st>>>(p, step, lg, in, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// One greedy step of the plan: logits (B, A), the state and flags in,
// written to the plan's slot `out`.
extern "C" int gu_greedy_step(const void* plan, const void* logits, const void* idx_in,
                              const void* code_in, const void* t_in, const void* done_in,
                              const void* reached_in, int out, void* stream) {
  const ActPlan& p = *static_cast<const ActPlan*>(plan);
  const StateIn in{static_cast<const int*>(idx_in), static_cast<const int*>(code_in),
                   static_cast<const int*>(t_in), static_cast<const uint8_t*>(done_in),
                   static_cast<const uint8_t*>(reached_in)};
  const int blocks = (p.batch + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  if (p.num_actions == 4 && aligned16(lg)) {
    greedy_step_kernel<kVec4><<<blocks, kThreads, 0, st>>>(p, lg, in, out);
  } else if (p.num_actions > gu::kMaxActions) {
    greedy_step_kernel<kWide><<<blocks, kThreads, 0, st>>>(p, lg, in, out);
  } else {
    greedy_step_kernel<kRow><<<blocks, kThreads, 0, st>>>(p, lg, in, out);
  }
  return static_cast<int>(cudaGetLastError());
}
