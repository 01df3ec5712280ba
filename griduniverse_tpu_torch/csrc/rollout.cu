// rollout.cu — K1 (random-action scan) and K2 (pre-drawn-action rollout).
//
// K1 replaces griduniverse_tpu/ops/bitplane.py `random_scan_bits` (334):
// T random-action auto-reset steps per env, actions drawn from a per-env
// xorshift32 stream or from the threefry stream (below), with per-env
// episode accumulators. K2 replaces
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
// K1's design: one thread per env, the whole T loop inside one launch. The
// env state, the xorshift state and the accumulators live in registers. A
// shared level's packed words are copied into shared memory (at most 4 KB);
// a per-env level reads its own row of words, which stays in L1/L2. Float
// adds keep the JAX order (`run_ret += reward`, then `ret_sum += run_ret` on
// done), and the file must be built without --use_fast_math, so the
// accumulators equal the plain version's bit for bit.
//
// K1's threefry stream (`ops/bitplane.py` module docstring): the action of
// global step g of env lane l is word g & 1 of Threefry-2x32-20's block of
// the counter (g >> 1, l) under the key (key0, key1). A thread enciphers
// one block every other step and keeps its second word for the next. The
// stream is a template parameter, so the xorshift loop is what it was.
//
// K2's design, for Hopper. Its path in the port is the golden replays and
// rollouts of a few thousand envs, where a launch of 256-thread blocks ran
// on a few SMs and each env's chain of T steps was the whole time: a step
// waited on its action's load from device memory and divided its position
// by the width. Now:
//  * a block is one warp (kK2Threads), so 4,096 envs are 128 blocks, one an
//    SM, and 65,536 are 2,048 blocks, all resident at once;
//  * the actions leave the chain: each lane loads the next kAhead actions
//    (a warp's loads of a step are 128 consecutive bytes) while it steps the
//    current kAhead, and turns each into its row and column delta and index
//    offset at the start of its block of steps;
//  * the position is carried as (index, row, column), so no step divides,
//    and the candidate cell is the index plus the action's offset, taken
//    only where the move stays on the grid (a move off it is blocked
//    whatever cell is read, as in the reference's clipped lookup);
//  * a shared level's words, or the warp's 32 per-env levels (word k of lane
//    l at k·32 + l, so the lanes read 32 distinct banks) where they fit
//    kStageBytes, sit in shared memory; larger per-env levels stay in L1/L2;
//  * the outputs are written at [t, b], 128 + 128 + 32 consecutive bytes a
//    warp and step.
// A step's chain is then the move's few integer operations and one shared
// load of the level's word. The mode (freeze on done, or auto-reset with
// its optional time limit) is a template parameter.

#include <cuda_runtime.h>

#include <cstdint>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;    // K1's block
constexpr int kK2Threads = 32;   // K2's block: one warp
constexpr int kAhead = 16;       // K2's actions in registers, a block of steps ahead
constexpr int kStageBytes = 48 * 1024;  // the most bytes of a warp's per-env levels K2 stages

// K2's level: one shared level in shared memory, the warp's per-env levels
// staged in shared memory, or each env's level read from device memory.
enum LevelForm : int { kSharedLevel = 0, kStagedLevels = 1, kDeviceLevels = 2 };

// K1's action streams (`kernels/rollout.py` STREAM_*).
enum ActionStream : int { kXorshift = 0, kThreefry = 1 };

// Four Threefry-2x32 rounds: each adds, rotates left and xors.
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  const int r[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, r[i]) ^ x0;
  }
}

// Threefry-2x32 with 20 rounds (Salmon et al., SC'11; Random123's
// threefry2x32_20): five groups of four rounds, the key injected after each.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

template <typename Tab, int kStream>
__global__ void random_scan_bits_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas,
    int num_actions, const uint32_t* __restrict__ words, int n_words,
    int per_env, const int* __restrict__ start_idx,
    const int* __restrict__ start_code, int h, int w, int batch, int num_steps,
    int max_episode_steps, const int* __restrict__ idx_in,
    const int* __restrict__ code_in, const int* __restrict__ t_in,
    const uint32_t* __restrict__ rs_in, uint32_t key0, uint32_t key1,
    uint32_t first_step, uint32_t lane_offset, int* __restrict__ idx_out,
    int* __restrict__ code_out, int* __restrict__ t_out,
    uint8_t* __restrict__ done_out, int* __restrict__ n_eps_out,
    float* __restrict__ ret_sum_out, int* __restrict__ len_sum_out) {
  __shared__ Tab tab;
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
  uint32_t rs = 0, odd_word = 0;  // the xorshift state; the threefry block's second word
  if constexpr (kStream == kXorshift) rs = rs_in[b];
  const uint32_t lane = lane_offset + static_cast<uint32_t>(b);
  gu::Episode ep{0.0f, 0.0f, 0, 0};
  for (int step = 0; step < num_steps; ++step) {
    uint32_t bits;
    if constexpr (kStream == kXorshift) {
      rs = gu::xorshift32(rs);
      bits = rs;
    } else {
      const uint32_t g = first_step + static_cast<uint32_t>(step);
      if ((g & 1u) == 0u || step == 0) {
        const uint2 block = threefry2x32(key0, key1, g >> 1, lane);
        odd_word = block.y;
        bits = (g & 1u) ? block.y : block.x;
      } else {
        bits = odd_word;
      }
    }
    const int a = static_cast<int>((bits >> 9) % na);  // top bits are the strongest
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

// Word k of the warp's staged per-env levels for this lane.
struct StagedWords {
  const uint32_t* lane_words;  // the lane's first word; word k at k·32
  __device__ __forceinline__ uint32_t operator[](int k) const { return lane_words[k * kK2Threads]; }
};

// Actions t0 .. t0 + kAhead − 1 of env b (0 past num_steps), in flight
// until the loop reaches them.
__device__ __forceinline__ void load_actions(int (&dst)[kAhead], const int* __restrict__ actions, int t0,
                                             int num_steps, int batch, int b) {
  const int* at = actions + static_cast<size_t>(t0) * batch + b;
#pragma unroll
  for (int k = 0; k < kAhead; ++k, at += batch) dst[k] = t0 + k < num_steps ? __ldg(at) : 0;
}

template <typename Tab, int kLevel, bool kAuto>
__global__ void __launch_bounds__(kK2Threads) rollout_actions_bits_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas,
    int num_actions, const uint32_t* __restrict__ words, int n_words,
    const int* __restrict__ start_idx,
    const int* __restrict__ start_code, int h, int w, int batch, int num_steps,
    int max_episode_steps, const int* __restrict__ actions,
    const int* __restrict__ idx_in, const int* __restrict__ code_in,
    const int* __restrict__ t_in, const uint8_t* __restrict__ done_in,
    int* __restrict__ idx_out, int* __restrict__ code_out,
    int* __restrict__ t_out, uint8_t* __restrict__ done_out,
    int* __restrict__ obs_traj, float* __restrict__ reward_traj,
    uint8_t* __restrict__ done_traj) {
  __shared__ Tab tab;
  extern __shared__ uint32_t s_level[];  // n_words (a shared level) or 32·n_words (staged)
  const int lane = threadIdx.x;
  const int first = blockIdx.x * kK2Threads;  // the warp's first env
  const int b = first + lane;
  gu::load_tables(tab, passable, terminal, reward, deltas, num_actions);
  if constexpr (kLevel == kSharedLevel) {
    for (int i = lane; i < n_words; i += kK2Threads) s_level[i] = words[i];
  } else if constexpr (kLevel == kStagedLevels) {
    // the warp's levels are consecutive in device memory: read them in
    // order, write word k of env e at k·32 + e
    const int envs = min(kK2Threads, batch - first);
    const uint32_t* src = words + static_cast<size_t>(first) * n_words;
    for (int i = lane; i < envs * n_words; i += kK2Threads) {
      const int e = i / n_words;
      s_level[(i - e * n_words) * kK2Threads + e] = src[i];
    }
  }
  __syncthreads();
  if (b >= batch) return;

  const bool per_env = kLevel != kSharedLevel;
  const int s_idx = per_env ? start_idx[b] : start_idx[0];
  const int s_code = per_env ? start_code[b] : start_code[0];
  const int s_row = s_idx / w;
  const gu::Pos start{s_idx, s_code, s_row, s_idx - s_row * w};
  gu::Pos p = gu::at_index(idx_in[b], code_in[b], w);
  int t = t_in[b];
  bool was_done = done_in[b] != 0;  // auto-reset clears it at the first step, as `step_bits` does
  const uint32_t* lw = kLevel == kSharedLevel ? s_level : words + static_cast<size_t>(b) * n_words;
  const StagedWords staged{s_level + lane};

  const int pass_bits = tab.passable, end_bits = tab.terminal;  // in registers, off the tables
  int next[kAhead];
  load_actions(next, actions, 0, num_steps, batch, b);
  size_t o = b;  // [t, b] of the step
  for (int t0 = 0; t0 < num_steps; t0 += kAhead) {
    int dr[kAhead], dc[kAhead], off[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int2 d = gu::delta(tab, gu::clamp_action(next[k], num_actions));
      dr[k] = d.x;
      dc[k] = d.y;
      off[k] = d.x * w + d.y;
      // held in registers from here: left to itself the compiler loads the
      // delta from the table inside the step, where the move waits on it
      asm volatile("" : "+r"(dr[k]), "+r"(dc[k]), "+r"(off[k]));
    }
    load_actions(next, actions, t0 + kAhead, num_steps, batch, b);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k >= num_steps) break;
      // the move: blocked off the grid or onto a tile that cannot be entered
      const int nrow = p.row + dr[k], ncol = p.col + dc[k];
      const bool in_bounds = static_cast<unsigned>(nrow) < static_cast<unsigned>(h) &&
                             static_cast<unsigned>(ncol) < static_cast<unsigned>(w);
      const int cand = in_bounds ? p.idx + off[k] : p.idx;
      const int cand_code = kLevel == kStagedLevels ? gu::tile_code(staged, cand) : gu::tile_code(lw, cand);
      const bool blocked = !in_bounds || !((pass_bits >> cand_code) & 1);
      const gu::Pos m{blocked ? p.idx : cand, blocked ? p.code : cand_code, blocked ? p.row : nrow,
                      blocked ? p.col : ncol};
      const float r = tab.reward[m.code];
      const bool ends = (end_bits >> m.code) & 1;
      if constexpr (kAuto) {
        const bool done = ends || (max_episode_steps >= 0 && t + 1 >= max_episode_steps);
        obs_traj[o] = m.idx;
        reward_traj[o] = r;
        done_traj[o] = done;
        p = done ? start : m;
        t = done ? 0 : t + 1;
        was_done = false;
      } else {
        const bool frozen = was_done;  // frozen after termination
        if (!frozen) {
          p = m;
          t += 1;
          was_done = ends;
        }
        obs_traj[o] = p.idx;
        reward_traj[o] = frozen ? 0.0f : r;
        done_traj[o] = was_done;
      }
      o += batch;
    }
  }
  idx_out[b] = p.idx;
  code_out[b] = p.code;
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
    const void* code_in, const void* t_in, const void* rs_in, int rng, int key0,
    int key1, int first_step, int lane_offset, void* idx_out, void* code_out,
    void* t_out, void* done_out, void* n_eps, void* ret_sum, void* len_sum,
    void* stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  const bool wide = num_actions > gu::kMaxActions;
  auto* kernel = rng == kThreefry ? (wide ? random_scan_bits_kernel<gu::WideTables, kThreefry>
                                          : random_scan_bits_kernel<gu::Tables, kThreefry>)
                                  : (wide ? random_scan_bits_kernel<gu::WideTables, kXorshift>
                                          : random_scan_bits_kernel<gu::Tables, kXorshift>);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words, per_env,
      static_cast<const int*>(start_idx), static_cast<const int*>(start_code), h, w,
      batch, num_steps, max_episode_steps, static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const uint32_t*>(rs_in), static_cast<uint32_t>(key0), static_cast<uint32_t>(key1),
      static_cast<uint32_t>(first_step), static_cast<uint32_t>(lane_offset), static_cast<int*>(idx_out),
      static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(done_out), static_cast<int*>(n_eps),
      static_cast<float*>(ret_sum), static_cast<int*>(len_sum));
  return static_cast<int>(cudaGetLastError());
}

namespace {

using RolloutKernel = void (*)(const uint8_t*, const uint8_t*, const float*, const int*, int, const uint32_t*,
                               int, const int*, const int*, int, int, int, int, int, const int*, const int*,
                               const int*, const int*, const uint8_t*, int*, int*, int*, uint8_t*, int*, float*,
                               uint8_t*);

template <typename Tab, int kLevel>
RolloutKernel rollout_kernel(bool auto_reset) {
  return auto_reset ? rollout_actions_bits_kernel<Tab, kLevel, true> : rollout_actions_bits_kernel<Tab, kLevel, false>;
}

template <typename Tab>
RolloutKernel rollout_kernel(int level, bool auto_reset) {
  return level == kSharedLevel    ? rollout_kernel<Tab, kSharedLevel>(auto_reset)
         : level == kStagedLevels ? rollout_kernel<Tab, kStagedLevels>(auto_reset)
                                  : rollout_kernel<Tab, kDeviceLevels>(auto_reset);
}

}  // namespace

// K2: a block a warp of envs; a per-env level is staged in shared memory
// where the warp's 32 fit kStageBytes.
extern "C" int gu_rollout_actions_bits(
    const void* passable, const void* terminal, const void* reward,
    const void* deltas, int num_actions, const void* words, int n_words,
    int per_env, const void* start_idx, const void* start_code, int h, int w,
    int batch, int num_steps, int auto_reset, int max_episode_steps,
    const void* actions, const void* idx_in, const void* code_in,
    const void* t_in, const void* done_in, void* idx_out, void* code_out,
    void* t_out, void* done_out, void* obs, void* reward_traj, void* done_traj,
    void* stream) {
  const size_t staged_bytes = static_cast<size_t>(kK2Threads) * n_words * sizeof(uint32_t);
  const int level = !per_env ? kSharedLevel : staged_bytes <= kStageBytes ? kStagedLevels : kDeviceLevels;
  const size_t shared = level == kSharedLevel    ? n_words * sizeof(uint32_t)
                        : level == kStagedLevels ? staged_bytes
                                                 : 0;
  const RolloutKernel kernel = num_actions > gu::kMaxActions ? rollout_kernel<gu::WideTables>(level, auto_reset)
                                                             : rollout_kernel<gu::Tables>(level, auto_reset);
  const int blocks = (batch + kK2Threads - 1) / kK2Threads;
  kernel<<<blocks, kK2Threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions,
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int*>(start_idx), static_cast<const int*>(start_code), h, w,
      batch, num_steps, max_episode_steps,
      static_cast<const int*>(actions), static_cast<const int*>(idx_in),
      static_cast<const int*>(code_in), static_cast<const int*>(t_in),
      static_cast<const uint8_t*>(done_in), static_cast<int*>(idx_out),
      static_cast<int*>(code_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(done_out), static_cast<int*>(obs),
      static_cast<float*>(reward_traj), static_cast<uint8_t*>(done_traj));
  return static_cast<int>(cudaGetLastError());
}
