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
// it is bound by each env's chain of dependent steps and by the
// instructions the card runs for all of them (one thread an env). K2
// also writes 9 bytes per env and step (obs, reward, done), which at large
// T makes it bound by device-memory writes.
//
// K1's design, for Hopper (its kernel below): the whole T loop inside one
// launch, the env state, the draw's state and the accumulators in
// registers. A step's chain is its move alone:
//  * no divide: the position is carried as (row, column), the index written
//    once at the end, and the action's remainder `(bits >> 9) % A` is a
//    mask for A a power of two and a multiply-high by ⌈2³²/A⌉ below 512
//    actions (`kernels/rollout.py` `draw_form`; `%` above);
//  * the draws leave the chain: the next kK1Ahead steps' actions are drawn
//    and turned into their deltas ahead of the steps that take them;
//  * the candidate cell's attributes (its code, whether it can be entered,
//    whether entering it ends the episode) come from shared memory: a
//    shared level as a byte a cell, one load (a move off the grid reads the
//    cell past the last, which is 0); the block's per-env levels staged a
//    warp at a time as K2 stages them, where they fit kStageBytes, their
//    codes' attributes from a register; larger per-env levels' packed words
//    through L1;
//  * blocks of one warp while each of the card's schedulers gets one warp
//    at most, so a small batch spreads over the SMs; above, blocks of eight
//    warps, which spread evenly over an SM's four schedulers (`plan`).
// Float adds keep the JAX order (`run_ret += reward`, then `ret_sum +=
// run_ret` on done), and the file is built with -fmad=false, so the
// accumulators equal the plain version's bit for bit.
//
// K1's threefry stream (`ops/bitplane.py` module docstring): the action of
// global step g of env lane l is word g & 1 of Threefry-2x32-20's block of
// the counter (g >> 1, l) under the key (key0, key1). The loop is unrolled
// by two: each block feeds two steps with no branch (an odd first step takes
// its block's second word alone). The stream is a template parameter.

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
#include <type_traits>

#include "step.cuh"

namespace {

constexpr int kK2Threads = 32;   // K2's block: one warp
constexpr int kAhead = 16;       // K2's actions in registers, a block of steps ahead
constexpr int kStageBytes = 48 * 1024;  // the most bytes of per-env levels a block stages (K2's warp, K1's block)

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

// ---------------------------------------------------------------------------
// K1: the random-action scan
// ---------------------------------------------------------------------------

constexpr int kK1Ahead = 8;         // K1's actions drawn a block of steps ahead
constexpr int kK1MaxThreads = 256;  // K1's largest block (`kernels/rollout.py` MAX_THREADS)

// How K1 turns the draw's top 23 bits x into an action (`kernels/rollout.py`
// `draw_form`): x & (A − 1) for A a power of two; x − A·⌊x·m / 2³²⌋ with
// m = ⌈2³²/A⌉ below 512 actions, exact there since x·(m·A − 2³²) < 2³²;
// else x % A.
enum DrawForm : int { kDrawMask = 0, kDrawMulhi = 1, kDrawModulo = 2 };

// K1's semantics tables: the codes' rewards and bits as `gu::Tables`, and up
// to kMaxActions (row, column) deltas, one 8-byte shared load an action.
struct ScanTables {
  float reward[gu::kNumCodes];
  int2 move[gu::kMaxActions];
  int passable;
  int terminal;
  int num_actions;
};

// Threefry-2x32 with 20 rounds (Salmon et al., SC'11; Random123's
// threefry2x32_20) under one key: five groups of four rounds, the key
// injected after each. The schedule, the words each injection adds, is
// computed once a thread.
struct Threefry {
  uint32_t k0, k1;
  uint32_t inj0[5], inj1[5];

  __device__ Threefry(uint32_t key0, uint32_t key1) : k0(key0), k1(key1) {
    const uint32_t ks[3] = {key0, key1, key0 ^ key1 ^ 0x1BD11BDAu};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      inj0[i] = ks[(i + 1) % 3];
      inj1[i] = ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }

  // The block of counter (x0, x1).
  __device__ __forceinline__ uint2 block(uint32_t x0, uint32_t x1) const {
    x0 += k0;
    x1 += k1;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i % 2 == 0) {
        threefry_rounds(x0, x1, 13, 15, 26, 6);
      } else {
        threefry_rounds(x0, x1, 17, 29, 16, 24);
      }
      x0 += inj0[i];
      x1 += inj1[i];
    }
    return make_uint2(x0, x1);
  }
};

// The action of the draw `bits` in form kForm; `neg_na` is 2³² − A.
template <int kForm>
__device__ __forceinline__ int action_of(uint32_t bits, uint32_t na, uint32_t neg_na, uint32_t magic) {
  const uint32_t x = bits >> 9;  // top bits are the strongest
  if constexpr (kForm == kDrawMask) {
    return static_cast<int>(x & (na - 1u));
  } else if constexpr (kForm == kDrawMulhi) {
    return static_cast<int>(x + neg_na * __umulhi(x, magic));  // x − A·q, one multiply-add
  } else {
    return static_cast<int>(x % na);
  }
}

// Action a's (row, column) delta: from shared memory, or (wide) device memory.
template <bool kWide>
__device__ __forceinline__ int2 move_of(const ScanTables& tab, const int* deltas, int a) {
  if constexpr (kWide) {
    return __ldg(reinterpret_cast<const int2*>(deltas) + a);
  } else {
    return tab.move[a];
  }
}

// Calls f with the launch's draw form as a compile-time constant: the one
// place the form is chosen.
template <bool kWide, typename F>
__device__ __forceinline__ void in_form(int form, F&& f) {
  if (form == kDrawMask) {
    f(std::integral_constant<int, kDrawMask>{});
  } else if (kWide && form == kDrawModulo) {
    f(std::integral_constant<int, kDrawModulo>{});
  } else {
    f(std::integral_constant<int, kDrawMulhi>{});
  }
}

// The deltas of kK1Ahead draws, in registers from here: left to itself the
// compiler loads a delta inside its step, where the move waits on it.
template <bool kWide>
__device__ __forceinline__ void moves_of(const ScanTables& tab, const int* deltas, int form, uint32_t na,
                                         uint32_t neg_na, uint32_t magic, const uint32_t (&bits)[kK1Ahead],
                                         int2 (&mv)[kK1Ahead]) {
  in_form<kWide>(form, [&](auto k) {
#pragma unroll
    for (int i = 0; i < kK1Ahead; ++i) {
      mv[i] = move_of<kWide>(tab, deltas, action_of<decltype(k)::value>(bits[i], na, neg_na, magic));
      asm volatile("" : "+r"(mv[i].x), "+r"(mv[i].y));
    }
  });
}

// One draw's delta (a scan's odd first step and the steps after its last
// block of kK1Ahead).
template <bool kWide>
__device__ __forceinline__ int2 move_of_bits(const ScanTables& tab, const int* deltas, int form, uint32_t na,
                                             uint32_t neg_na, uint32_t magic, uint32_t bits) {
  int2 mv;
  in_form<kWide>(form, [&](auto k) {
    mv = move_of<kWide>(tab, deltas, action_of<decltype(k)::value>(bits, na, neg_na, magic));
  });
  return mv;
}

// A cell's attributes, four bits: its tile code (bits 0-1), kAttrPass if it
// can be entered, and kAttrEnter too if entering it ends the episode
// (passable and terminal). So a cell can be entered where its attributes
// are at least kAttrPass and ends the episode where they are at least
// kAttrEnter: one compare each. Off the grid they are 0.
constexpr int kAttrPass = 4;
constexpr int kAttrEnter = 8;

// The four codes' attributes, a nibble each (code c at bits 4c to 4c + 3).
__device__ __forceinline__ int code_attrs(const uint8_t* passable, const uint8_t* terminal) {
  int attrs = 0;
#pragma unroll
  for (int c = 0; c < gu::kNumCodes; ++c) {
    const int pass = passable[c] != 0;
    attrs |= (c | pass * kAttrPass | (pass && terminal[c] != 0) * kAttrEnter) << (4 * c);
  }
  return attrs;
}

// A shared level's cells: a byte of attributes a cell in shared memory;
// cell h·w, the one a move off the grid reads, is 0.
struct SharedCells {
  const uint8_t* cells;
  int off_grid;  // h·w
  __device__ __forceinline__ int attr(bool on_grid, int cand) const { return cells[on_grid ? cand : off_grid]; }
};

// A per-env level's cells: its packed codes (`Words`: the warp's staged
// levels or its own row in device memory), cell i's code taken by a rotate
// of its word, its attributes from the nibbles in a register.
template <typename Words>
struct WordCells {
  Words words;
  int attrs;
  __device__ __forceinline__ int attr(bool on_grid, int cand) const {
    const int i = on_grid ? cand : 0;
    const int table = on_grid ? attrs : 0;  // off the grid every attribute is 0
    const uint32_t word = words[i >> 4];
    // a rotate by 2·i − 2 takes cell i's code to bits 2-3: four times the code
    const uint32_t shift = __funnelshift_r(word, word, (static_cast<uint32_t>(i) << 1) - 2u) & 12u;
    return (table >> shift) & 15;
  }
};

// A per-env level's packed words read from device memory through L1.
struct DeviceWords {
  const uint32_t* __restrict__ words;
  __device__ __forceinline__ uint32_t operator[](int k) const { return __ldg(words + k); }
};

// Where a K1 env stands and what it has gathered. Its index is row·w + col,
// written once at the end, so no step divides by the width. `on_end` is 1
// where its tile's code is terminal (a blocked move there ends the
// episode); only a start or a state handed in can be.
struct ScanEnv {
  int row, col, code, t, on_end;
  float run_ret, ret_sum;
  int n_eps, len_sum;
};

// Where an episode starts.
struct ScanStart {
  int row, col, code, on_end;
};

// One auto-reset step of action delta mv, bit-exactly `step_bits` followed
// by the reference's accumulators. The chain from one step to the next is
// the move: the new row and column, the bounds test, one lookup of the
// candidate cell's attributes, and the selects. Everything that happens when
// an episode ends sits in one branch; the float adds keep the order
// run_ret += r, then ret_sum += run_ret on done.
template <typename Cells>
__device__ __forceinline__ void scan_step(const Cells& cells, const float* reward, int h, int w, bool limit,
                                          int max_episode_steps, const ScanStart& s, int2 mv, ScanEnv& e) {
  const int nrow = e.row + mv.x, ncol = e.col + mv.y;
  const bool on_grid = static_cast<unsigned>(nrow) < static_cast<unsigned>(h) &&
                       static_cast<unsigned>(ncol) < static_cast<unsigned>(w);
  const int a = cells.attr(on_grid, static_cast<int>(static_cast<unsigned>(nrow) * w + ncol));
  const int t1 = e.t + 1;
  const bool timeout = limit && t1 >= max_episode_steps;
  const bool moves = a >= kAttrPass;
  const bool done = moves ? (a >= kAttrEnter || timeout) : (e.on_end != 0 || timeout);
  const int code = moves ? (a & 3) : e.code;
  e.run_ret += reward[code];
  if (done) {
    e.n_eps += 1;
    e.ret_sum += e.run_ret;
    e.len_sum += t1;
    e.run_ret = 0.0f;
    e.row = s.row;
    e.col = s.col;
    e.code = s.code;
    e.on_end = s.on_end;
    e.t = 0;
  } else {
    e.row = moves ? nrow : e.row;
    e.col = moves ? ncol : e.col;
    e.code = code;
    e.on_end = 0;  // not done: neither the tile kept nor the one entered ends
    e.t = t1;
  }
}

// K1: a thread an env for all T steps (the design: the file's head).
template <bool kWide, int kStream, int kLevel>
__global__ void __launch_bounds__(kK1MaxThreads) random_scan_bits_kernel(
    const uint8_t* __restrict__ passable, const uint8_t* __restrict__ terminal,
    const float* __restrict__ reward, const int* __restrict__ deltas, int num_actions, int form,
    uint32_t magic, const uint32_t* __restrict__ words, int n_words, const int* __restrict__ start_idx,
    const int* __restrict__ start_code, int h, int w, int batch, int num_steps, int max_episode_steps,
    const int* __restrict__ idx_in, const int* __restrict__ code_in, const int* __restrict__ t_in,
    const uint32_t* __restrict__ rs_in, uint32_t key0, uint32_t key1, uint32_t first_step,
    uint32_t lane_offset, int* __restrict__ idx_out, int* __restrict__ code_out, int* __restrict__ t_out,
    uint8_t* __restrict__ done_out, int* __restrict__ n_eps_out, float* __restrict__ ret_sum_out,
    int* __restrict__ len_sum_out) {
  __shared__ ScanTables tab;
  // a shared level's bytes (16·n_words + 4 of them) or the block's warps'
  // staged words (32·n_words a warp)
  extern __shared__ uint32_t s_level[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = h * w;
  const int attrs = code_attrs(passable, terminal);
  if (threadIdx.x == 0) gu::load_codes(tab, passable, terminal, reward, num_actions);
  if (!kWide && static_cast<int>(threadIdx.x) < num_actions) {
    tab.move[threadIdx.x] = make_int2(deltas[2 * threadIdx.x], deltas[2 * threadIdx.x + 1]);
  }
  uint32_t* warp_level = s_level + (threadIdx.x - lane) * n_words;
  if constexpr (kLevel == kSharedLevel) {
    uint8_t* cells = reinterpret_cast<uint8_t*>(s_level);
    for (int i = threadIdx.x; i <= hw; i += blockDim.x) {
      cells[i] = i < hw ? (attrs >> (((words[i >> 4] >> ((i & 15) * 2)) & 3u) * 4)) & 15 : 0;
    }
  } else if constexpr (kLevel == kStagedLevels) {
    // the warp's levels are consecutive in device memory: read them in
    // order, write word k of env e at k·32 + e
    const int first = b - lane;
    const int envs = min(32, batch - first);
    const uint32_t* src = words + static_cast<size_t>(first) * n_words;
    for (int i = lane; i < envs * n_words; i += 32) {
      const int e = i / n_words;
      warp_level[(i - e * n_words) * 32 + e] = src[i];
    }
  }
  __syncthreads();
  if (b >= batch) return;

  const bool per_env = kLevel != kSharedLevel;
  const int end_bits = tab.terminal;
  const int s_idx = per_env ? start_idx[b] : start_idx[0];
  const int s_row = s_idx / w;
  const int s_code = per_env ? start_code[b] : start_code[0];
  const ScanStart start{s_row, s_idx - s_row * w, s_code, (end_bits >> s_code) & 1};
  const int idx0 = idx_in[b], code0 = code_in[b];
  const int row0 = idx0 / w;
  ScanEnv e{row0, idx0 - row0 * w, code0, t_in[b], (end_bits >> code0) & 1, 0.0f, 0.0f, 0, 0};
  const bool limit = max_episode_steps >= 0;
  const uint32_t na = static_cast<uint32_t>(num_actions);
  uint32_t neg_na = 0u - na;
  asm("" : "+r"(neg_na));  // an opaque register: the compiler would turn x + neg_na·q back into a negate and a multiply-add

  const SharedCells shared_cells{reinterpret_cast<const uint8_t*>(s_level), hw};
  const WordCells<StagedWords> staged{StagedWords{warp_level + lane}, attrs};
  const WordCells<DeviceWords> own{DeviceWords{words + static_cast<size_t>(b) * n_words}, attrs};
  auto step = [&](int2 mv) {
    if constexpr (kLevel == kSharedLevel) {
      scan_step(shared_cells, tab.reward, h, w, limit, max_episode_steps, start, mv, e);
    } else if constexpr (kLevel == kStagedLevels) {
      scan_step(staged, tab.reward, h, w, limit, max_episode_steps, start, mv, e);
    } else {
      scan_step(own, tab.reward, h, w, limit, max_episode_steps, start, mv, e);
    }
  };
  auto step_bits = [&](uint32_t bits) { step(move_of_bits<kWide>(tab, deltas, form, na, neg_na, magic, bits)); };

  int left = num_steps;
  if constexpr (kStream == kXorshift) {
    uint32_t rs = rs_in[b];
    for (; left >= kK1Ahead; left -= kK1Ahead) {
      uint32_t bits[kK1Ahead];
#pragma unroll
      for (int k = 0; k < kK1Ahead; ++k) bits[k] = rs = gu::xorshift32(rs);
      int2 mv[kK1Ahead];
      moves_of<kWide>(tab, deltas, form, na, neg_na, magic, bits, mv);
#pragma unroll
      for (int k = 0; k < kK1Ahead; ++k) step(mv[k]);
    }
    for (; left > 0; --left) step_bits(rs = gu::xorshift32(rs));
  } else {
    // the action of global step g is word g & 1 of the block of counter
    // (g >> 1, lane): an odd first step takes its block's second word alone,
    // then each block feeds two steps
    const Threefry tf(key0, key1);
    const uint32_t env_lane = lane_offset + static_cast<uint32_t>(b);
    uint32_t g = first_step;
    if ((g & 1u) && left > 0) {
      step_bits(tf.block(g >> 1, env_lane).y);
      ++g;
      --left;
    }
    for (; left >= kK1Ahead; left -= kK1Ahead, g += kK1Ahead) {
      uint32_t bits[kK1Ahead];
#pragma unroll
      for (int j = 0; j < kK1Ahead / 2; ++j) {
        const uint2 block = tf.block((g >> 1) + j, env_lane);
        bits[2 * j] = block.x;
        bits[2 * j + 1] = block.y;
      }
      int2 mv[kK1Ahead];
      moves_of<kWide>(tab, deltas, form, na, neg_na, magic, bits, mv);
#pragma unroll
      for (int k = 0; k < kK1Ahead; ++k) step(mv[k]);
    }
    for (; left > 0; left -= 2, g += 2) {
      const uint2 block = tf.block(g >> 1, env_lane);
      step_bits(block.x);
      if (left > 1) step_bits(block.y);
    }
  }
  idx_out[b] = e.row * w + e.col;
  code_out[b] = e.code;
  t_out[b] = e.t;
  done_out[b] = 0;
  n_eps_out[b] = e.n_eps;
  ret_sum_out[b] = e.ret_sum;
  len_sum_out[b] = e.len_sum;
}

using ScanKernel = void (*)(const uint8_t*, const uint8_t*, const float*, const int*, int, int, uint32_t,
                            const uint32_t*, int, const int*, const int*, int, int, int, int, int, const int*,
                            const int*, const int*, const uint32_t*, uint32_t, uint32_t, uint32_t, uint32_t, int*,
                            int*, int*, uint8_t*, int*, float*, int*);

template <bool kWide, int kStream>
ScanKernel scan_kernel(int level) {
  return level == kSharedLevel    ? random_scan_bits_kernel<kWide, kStream, kSharedLevel>
         : level == kStagedLevels ? random_scan_bits_kernel<kWide, kStream, kStagedLevels>
                                  : random_scan_bits_kernel<kWide, kStream, kDeviceLevels>;
}

template <bool kWide>
ScanKernel scan_kernel(int rng, int level) {
  return rng == kThreefry ? scan_kernel<kWide, kThreefry>(level) : scan_kernel<kWide, kXorshift>(level);
}

}  // namespace

extern "C" const char* gu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1 in `plan`'s blocks: `threads` a block, the level in form `level` with
// `shared` bytes of it a block (at most kStageBytes), the actions drawn in
// `form` (`magic` the multiply-high's ⌈2³²/A⌉).
extern "C" int gu_random_scan_bits(
    const void* passable, const void* terminal, const void* reward,
    const void* deltas, int num_actions, const void* words, int n_words,
    int level, const void* start_idx, const void* start_code, int h, int w,
    int batch, int num_steps, int max_episode_steps, const void* idx_in,
    const void* code_in, const void* t_in, const void* rs_in, int rng, int key0,
    int key1, int first_step, int lane_offset, int threads, int shared, int form, int magic,
    void* idx_out, void* code_out, void* t_out, void* done_out, void* n_eps, void* ret_sum,
    void* len_sum, void* stream) {
  const ScanKernel kernel = num_actions > gu::kMaxActions ? scan_kernel<true>(rng, level)
                                                          : scan_kernel<false>(rng, level);
  const int blocks = (batch + threads - 1) / threads;
  kernel<<<blocks, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(passable), static_cast<const uint8_t*>(terminal),
      static_cast<const float*>(reward), static_cast<const int*>(deltas), num_actions, form,
      static_cast<uint32_t>(magic), static_cast<const uint32_t*>(words), n_words,
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
