// dqn_act.cu — K7c: DQN's ε-greedy act, auto-reset step and episode
// statistics, one thread per env, in one launch.
//
// Replaces the body of griduniverse_tpu/models/dqn.py `_make_train_body`
// (284): the act and step at 347-357 (`greedy = argmax(q)`, `a =
// where(explore, rand_a, greedy)`, `step_bits` with auto-reset and the time
// limit) and the episode statistics at 418-422 (`run_ret += r`, the count
// of ended episodes, the sum of their returns, the reset of `run_ret`). The
// JAX version is a chain of XLA fusions inside the train scan; the port ran
// it as about fifty small launches a step.
//
// Bound on the card: bytes, and at these sizes the launch and the host's
// work around it. Per env it reads A floats of q, the two draws (5 bytes),
// the state (12 bytes) and the running return (4), and writes the new state
// (13 bytes), the transition (13 bytes) and the running return (4): under
// 5 MB at 65,536 envs, a few µs of the card. So the design cuts the host's
// share: the wrapper (`kernels/dqn_act.py` `DqnActPlan`) checks the
// semantics and the level once a run and keeps them here in `ActPlan`, with
// the scratch and the outputs' layout; a call checks its step's tensors at
// once, allocates one buffer that holds all eleven outputs and launches
// once.
//
// The store form (`kStore`, `gu_dqn_act_store`) also replaces the
// reference's ring write of the same body (360-364, `buffer_write`) and its
// priority fill (368): the step's transition goes from registers straight
// into slot `*at + b` of the ring's five fields, and `*p_max` into that slot
// of the priorities where there are any. Before it, K8b's write
// (`csrc/replay.cu` `replay_write_kernel`) read the transition back from
// this kernel's outputs in a launch of its own. `at` and `p_max` are read on
// the card, from the run's tensors. The stores are one a field a thread,
// warp-contiguous, with the default cache policy: the same step's gather
// reads random rows of the ring, which stays in L2. `at` is a multiple of B
// but not always of 4, so no store is wider than its field. Per env it
// writes 17 bytes more, 21 with the priorities.
//
// Design: one thread per env, as K7b's `act_step_kernel`: the semantics
// tables and a shared level's packed words are staged in shared memory, the
// step is `gu::step_autoreset` of step.cuh. A row of q is one 16-byte load
// where A = 4 and q is 16-byte aligned, else A loads; the argmax takes the
// first maximum, as `torch.argmax`. The statistics must repeat their bits
// in any run, so the ended returns are summed in a fixed order: in each
// block of kChunk envs a tree in shared memory (pairs i and i + half, half
// = 128, 64, ..., 1; envs past B add 0); each block writes its sum and
// count, fences, and takes a ticket; the last block to take one walks the
// blocks' sums in index order, adds the total to `ret_sum` and the counts
// to `episodes`, and sets the ticket back to 0 for the next call, so
// nothing is cleared before a launch. The plain version
// (`models.dqn.ended_return_sum_reference`) makes the same adds. The count
// of ended episodes is an integer, exact in any order. Built with
// -fmad=false, as every source here.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kChunk = 256;  // envs a block, and the first level of the sum

constexpr int kOutputs = 11;

// What every call of a run shares: the checked semantics and level, the
// batch, the time limit, the scratch and the byte offsets of the outputs in
// a call's buffer, in the order of `Outputs` (laid out by
// `kernels/dqn_act.py` `output_offsets`). Mirrored field for field by
// `kernels/dqn_act.py` `_PlanArgs`.
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
  float* chunk_sum;       // ceil(B / kChunk) floats
  int* chunk_count;       // ceil(B / kChunk) ints
  unsigned int* ticket;   // 0 between calls
  long long out_offset[kOutputs];
};

// The ring a store form writes, checked once a run by the plan
// (`kernels/dqn_act.py` `DqnActPlan.bind_ring`, `_RingArgs` field for field):
// the five fields of `cap` slots, and the priorities, or null (uniform replay).
struct Ring {
  int* obs;
  int* action;
  float* reward;
  int* next_obs;
  uint8_t* done;
  float* prio;
  long long cap;
};

// The outputs in one buffer, in the order of `kernels/dqn_act.py` `OUTPUTS`.
struct Outputs {
  int* idx;
  int* code;
  int* t;
  uint8_t* state_done;
  int* action;
  int* next_obs;
  float* reward;
  uint8_t* done;
  float* run_ret;
  long long* episodes;
  float* ret_sum;
};

__device__ __forceinline__ Outputs carve(unsigned char* out, const ActPlan& p) {
  const long long* at = p.out_offset;
  return Outputs{reinterpret_cast<int*>(out + at[0]), reinterpret_cast<int*>(out + at[1]),
                 reinterpret_cast<int*>(out + at[2]), out + at[3],
                 reinterpret_cast<int*>(out + at[4]), reinterpret_cast<int*>(out + at[5]),
                 reinterpret_cast<float*>(out + at[6]), out + at[7],
                 reinterpret_cast<float*>(out + at[8]), reinterpret_cast<long long*>(out + at[9]),
                 reinterpret_cast<float*>(out + at[10])};
}

// Tab: gu::Tables up to eight actions, gu::WideTables above (the deltas
// read from device memory); the row of q is read where used either way.
// kStore: the store form; the ring's parameters come last, so the form
// without the store reads its own at the same offsets as before.
template <bool kVec4, typename Tab, bool kStore>
__global__ void __launch_bounds__(kChunk) dqn_act_step_kernel(
    ActPlan p, const float* __restrict__ q, const uint8_t* __restrict__ explore,
    const int* __restrict__ rand_a, const int* __restrict__ idx_in, const int* __restrict__ code_in,
    const int* __restrict__ t_in, const float* __restrict__ run_ret_in,
    const long long* __restrict__ episodes_in, const float* __restrict__ ret_sum_in,
    unsigned char* __restrict__ out, Ring ring, const long long* __restrict__ at,
    const float* __restrict__ p_max) {
  __shared__ Tab tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  __shared__ float red[kChunk];
  __shared__ int cnt[kChunk];
  __shared__ bool last;
  gu::load_tables(tab, p.passable, p.terminal, p.reward, p.deltas, p.num_actions);
  if (!p.per_env) {
    for (int i = threadIdx.x; i < p.n_words; i += blockDim.x) s_words[i] = p.words[i];
  }
  __syncthreads();

  const Outputs o = carve(out, p);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  float ended = 0.0f;
  int ended_count = 0;
  if (b < p.batch) {  // no early return: every thread takes part in the sums below
    const uint32_t* lw = p.per_env ? p.words + static_cast<size_t>(b) * p.n_words : s_words;
    const int s_idx = p.per_env ? p.start_idx[b] : p.start_idx[0];
    const int s_code = p.per_env ? p.start_code[b] : p.start_code[0];
    int greedy;
    if (kVec4) {
      const float4 r = reinterpret_cast<const float4*>(q)[b];
      const float row[4] = {r.x, r.y, r.z, r.w};
      greedy = gu::first_argmax(row, 4);
    } else {
      greedy = gu::first_argmax(q + static_cast<size_t>(b) * p.num_actions, p.num_actions);
    }
    const int a = explore[b] ? rand_a[b] : greedy;
    int idx = idx_in[b], code = code_in[b], t = t_in[b];
    [[maybe_unused]] const int obs = idx;
    [[maybe_unused]] long long slot = 0;
    [[maybe_unused]] float fill = 0.0f;
    if constexpr (kStore) {  // loaded here, so that the step hides their latency
      slot = *at + b;
      if (ring.prio != nullptr) fill = *p_max;
    }
    gu::Episode unused{0.0f, 0.0f, 0, 0};
    const gu::Transition tr = gu::step_autoreset(tab, lw, p.h, p.w, s_idx, s_code,
                                                 p.max_episode_steps,
                                                 gu::clamp_action(a, p.num_actions), idx, code, t,
                                                 unused);
    const float run_ret = run_ret_in[b] + tr.reward;
    if (tr.done) {
      ended = run_ret;
      ended_count = 1;
    }
    o.idx[b] = idx;
    o.code[b] = code;
    o.t[b] = t;
    o.state_done[b] = 0;
    o.action[b] = a;
    o.next_obs[b] = tr.obs;
    o.reward[b] = tr.reward;
    o.done[b] = tr.done;
    o.run_ret[b] = tr.done ? 0.0f : run_ret;
    if constexpr (kStore) {
      if (slot >= 0 && slot < ring.cap) {  // the ring's invariant keeps a store inside
        ring.obs[slot] = obs;
        ring.action[slot] = a;
        ring.reward[slot] = tr.reward;
        ring.next_obs[slot] = tr.obs;
        ring.done[slot] = tr.done;
        if (ring.prio != nullptr) ring.prio[slot] = fill;
      }
    }
  }
  red[threadIdx.x] = ended;
  cnt[threadIdx.x] = ended_count;
  __syncthreads();
  for (int half = kChunk / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red[threadIdx.x] += red[threadIdx.x + half];
      cnt[threadIdx.x] += cnt[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    p.chunk_sum[blockIdx.x] = red[0];
    p.chunk_count[blockIdx.x] = cnt[0];
    __threadfence();  // the partials are seen by whichever block is last
    last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: the blocks' sums in index order, a tile of kChunk at a
  // time staged in shared memory; the counts in any order.
  const int chunks = gridDim.x;
  float total = 0.0f;
  long long count = 0;
  for (int base = 0; base < chunks; base += kChunk) {
    const int c = base + threadIdx.x;
    __syncthreads();  // the tile before is read
    if (c < chunks) {
      red[threadIdx.x] = __ldcg(p.chunk_sum + c);
      count += __ldcg(p.chunk_count + c);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kChunk, chunks - base);
      for (int i = 0; i < m; ++i) total += red[i];
    }
  }
  __syncthreads();
  cnt[threadIdx.x] = static_cast<int>(count);  // a thread's count is below 2^31 / kChunk chunks of 256
  __syncthreads();
  if (threadIdx.x == 0) {
    long long all = 0;
    for (int i = 0; i < kChunk; ++i) all += cnt[i];
    *o.episodes = episodes_in[0] + all;
    *o.ret_sum = ret_sum_in[0] + total;
    *p.ticket = 0u;
  }
}

template <bool kStore>
int launch_act(const ActPlan& p, const Ring& ring, const void* q, const void* explore,
               const void* rand_a, const void* idx_in, const void* code_in, const void* t_in,
               const void* run_ret_in, const void* episodes_in, const void* ret_sum_in,
               const void* at, const void* p_max, void* out, cudaStream_t st) {
  const int blocks = (p.batch + kChunk - 1) / kChunk;
  const bool vec4 = p.num_actions == 4 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  auto* kernel = vec4 ? dqn_act_step_kernel<true, gu::Tables, kStore>
                 : p.num_actions > gu::kMaxActions ? dqn_act_step_kernel<false, gu::WideTables, kStore>
                                                   : dqn_act_step_kernel<false, gu::Tables, kStore>;
  kernel<<<blocks, kChunk, 0, st>>>(
      p, static_cast<const float*>(q), static_cast<const uint8_t*>(explore),
      static_cast<const int*>(rand_a), static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const float*>(run_ret_in), static_cast<const long long*>(episodes_in),
      static_cast<const float*>(ret_sum_in), static_cast<unsigned char*>(out), ring,
      static_cast<const long long*>(at), static_cast<const float*>(p_max));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch: the act-and-step pass, whose last block folds the statistics.
// `plan` is host memory holding an `ActPlan`; `out` the outputs' buffer,
// laid out at the plan's offsets. Calls that share a plan's scratch must be ordered on
// one stream.
extern "C" int gu_dqn_act_step(const void* plan, const void* q, const void* explore,
                               const void* rand_a, const void* idx_in, const void* code_in,
                               const void* t_in, const void* run_ret_in, const void* episodes_in,
                               const void* ret_sum_in, void* out, void* stream) {
  return launch_act<false>(*static_cast<const ActPlan*>(plan), Ring{}, q, explore, rand_a, idx_in,
                           code_in, t_in, run_ret_in, episodes_in, ret_sum_in, nullptr, nullptr,
                           out, static_cast<cudaStream_t>(stream));
}

// The store form, one launch as well: the same, and the step's transitions
// into slots `*at`.. of the ring, with `*p_max` into those of its
// priorities where `ring` has them. `ring` is host memory holding a `Ring`;
// `at` a device int64, `p_max` a device float (not read without priorities).
extern "C" int gu_dqn_act_store(const void* plan, const void* ring, const void* q,
                                const void* explore, const void* rand_a, const void* idx_in,
                                const void* code_in, const void* t_in, const void* run_ret_in,
                                const void* episodes_in, const void* ret_sum_in, const void* at,
                                const void* p_max, void* out, void* stream) {
  return launch_act<true>(*static_cast<const ActPlan*>(plan), *static_cast<const Ring*>(ring), q,
                          explore, rand_a, idx_in, code_in, t_in, run_ret_in, episodes_in,
                          ret_sum_in, at, p_max, out, static_cast<cudaStream_t>(stream));
}
