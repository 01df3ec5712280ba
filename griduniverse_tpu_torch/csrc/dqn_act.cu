// dqn_act.cu — K7c: DQN's ε-greedy act, auto-reset step and episode
// statistics, one thread per env; and the fold of the statistics.
//
// Replaces the body of griduniverse_tpu/models/dqn.py `_make_train_body`
// (284): the act and step at 347-357 (`greedy = argmax(q)`, `a =
// where(explore, rand_a, greedy)`, `step_bits` with auto-reset and the time
// limit) and the episode statistics at 418-422 (`run_ret += r`, the count
// of ended episodes, the sum of their returns, the reset of `run_ret`). The
// JAX version is a chain of XLA fusions inside the train scan; the port ran
// it as about fifty small launches a step.
//
// Bound on the card: bytes, and at these sizes the launch. Per env it reads
// A floats of q, the two draws (5 bytes), the state (12 bytes) and the
// running return (4), and writes the new state (13 bytes), the transition
// (13 bytes) and the running return (4): under 5 MB at 65,536 envs.
//
// Design: one thread per env, as K7b's `act_step_kernel`: the semantics
// tables and a shared level's packed words are staged in shared memory, the
// step is `gu::step_autoreset` of step.cuh. The argmax takes the first
// maximum, as `torch.argmax`. The statistics must repeat their bits in any
// run, so the ended returns are summed in a fixed order: in each block of
// kChunk envs a tree in shared memory (pairs i and i + half, half = 128, 64,
// ..., 1; envs past B add 0), then a second launch walks the blocks' sums
// in index order and adds the total to `ret_sum`. The plain version
// (`models.dqn.ended_return_sum_reference`) makes the same adds. The count
// of ended episodes is an integer, exact in any order. Built with
// -fmad=false, as every source here.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kChunk = 256;  // envs a block, and the first level of the sum

__global__ void dqn_act_step_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas, int num_actions,
    const uint32_t* __restrict__ words, int n_words, int per_env,
    const int* __restrict__ start_idx, const int* __restrict__ start_code, int h, int w,
    int batch, int max_episode_steps, const float* __restrict__ q,
    const uint8_t* __restrict__ explore, const int* __restrict__ rand_a,
    const int* __restrict__ idx_in, const int* __restrict__ code_in, const int* __restrict__ t_in,
    const float* __restrict__ run_ret_in, int* __restrict__ idx_out, int* __restrict__ code_out,
    int* __restrict__ t_out, uint8_t* __restrict__ state_done_out, int* __restrict__ action_out,
    int* __restrict__ next_obs_out, float* __restrict__ reward_out, uint8_t* __restrict__ done_out,
    float* __restrict__ run_ret_out, float* __restrict__ chunk_sum, int* __restrict__ chunk_count) {
  __shared__ gu::Tables tab;
  __shared__ uint32_t s_words[gu::kMaxWords];
  __shared__ float red[kChunk];
  __shared__ int cnt[kChunk];
  gu::load_tables(tab, passable, terminal, reward, deltas, num_actions);
  if (!per_env) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_words[i] = words[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  float ended = 0.0f;
  int ended_count = 0;
  if (b < batch) {  // no early return: every thread takes part in the sums below
    const uint32_t* lw = per_env ? words + static_cast<size_t>(b) * n_words : s_words;
    const int s_idx = per_env ? start_idx[b] : start_idx[0];
    const int s_code = per_env ? start_code[b] : start_code[0];
    const int a = explore[b] ? rand_a[b]
                             : gu::first_argmax(q + static_cast<size_t>(b) * num_actions, num_actions);
    int idx = idx_in[b], code = code_in[b], t = t_in[b];
    gu::Episode unused{0.0f, 0.0f, 0, 0};
    const gu::Transition tr = gu::step_autoreset(tab, lw, h, w, s_idx, s_code, max_episode_steps,
                                                 gu::clamp_action(a, num_actions), idx, code, t,
                                                 unused);
    const float run_ret = run_ret_in[b] + tr.reward;
    if (tr.done) {
      ended = run_ret;
      ended_count = 1;
    }
    idx_out[b] = idx;
    code_out[b] = code;
    t_out[b] = t;
    state_done_out[b] = 0;
    action_out[b] = a;
    next_obs_out[b] = tr.obs;
    reward_out[b] = tr.reward;
    done_out[b] = tr.done;
    run_ret_out[b] = tr.done ? 0.0f : run_ret;
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
    chunk_sum[blockIdx.x] = red[0];
    chunk_count[blockIdx.x] = cnt[0];
  }
}

// One thread: the blocks' sums in index order, then the run's statistics.
__global__ void dqn_fold_stats_kernel(const float* __restrict__ chunk_sum,
                                      const int* __restrict__ chunk_count, int num_chunks,
                                      const long long* __restrict__ episodes_in,
                                      const float* __restrict__ ret_sum_in,
                                      long long* __restrict__ episodes_out,
                                      float* __restrict__ ret_sum_out) {
  float total = 0.0f;
  long long count = 0;
  for (int c = 0; c < num_chunks; ++c) {
    total += chunk_sum[c];
    count += chunk_count[c];
  }
  episodes_out[0] = episodes_in[0] + count;
  ret_sum_out[0] = ret_sum_in[0] + total;
}

}  // namespace

// Two launches: the act-and-step pass, then the fold. `chunk_sum` and
// `chunk_count` are scratch of ceil(B / 256) entries each.
extern "C" int gu_dqn_act_step(
    const void* passable, const void* terminal, const void* reward, const void* deltas,
    int num_actions, const void* words, int n_words, int per_env, const void* start_idx,
    const void* start_code, int h, int w, int batch, int max_episode_steps, const void* q,
    const void* explore, const void* rand_a, const void* idx_in, const void* code_in,
    const void* t_in, const void* run_ret_in, const void* episodes_in, const void* ret_sum_in,
    void* idx_out, void* code_out, void* t_out, void* state_done_out, void* action_out,
    void* next_obs_out, void* reward_out, void* done_out, void* run_ret_out, void* episodes_out,
    void* ret_sum_out, void* chunk_sum, void* chunk_count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (batch + kChunk - 1) / kChunk;
  dqn_act_step_kernel<<<blocks, kChunk, 0, st>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env, static_cast<const int*>(start_idx),
      static_cast<const int*>(start_code), h, w, batch, max_episode_steps,
      static_cast<const float*>(q), static_cast<const uint8_t*>(explore),
      static_cast<const int*>(rand_a), static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const float*>(run_ret_in), static_cast<int*>(idx_out),
      static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(state_done_out), static_cast<int*>(action_out),
      static_cast<int*>(next_obs_out), static_cast<float*>(reward_out),
      static_cast<uint8_t*>(done_out), static_cast<float*>(run_ret_out),
      static_cast<float*>(chunk_sum), static_cast<int*>(chunk_count));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqn_fold_stats_kernel<<<1, 1, 0, st>>>(
      static_cast<const float*>(chunk_sum), static_cast<const int*>(chunk_count), blocks,
      static_cast<const long long*>(episodes_in), static_cast<const float*>(ret_sum_in),
      static_cast<long long*>(episodes_out), static_cast<float*>(ret_sum_out));
  return static_cast<int>(cudaGetLastError());
}
