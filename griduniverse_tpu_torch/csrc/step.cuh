// step.cuh — the device step of the bit-packed engine, shared by the
// rollout kernels K1 and K2 (rollout.cu), the TD kernels K5 (td_fast.cu)
// and K6 (td_batched.cu), and the act-and-step kernels K7b (act_step.cu)
// and K7c (dqn_act.cu).
//
// Replaces: griduniverse_tpu/ops/bitplane.py `move_bits` (160) with its
// callees `tile_code` (140) and `_per_code` (154). The JAX version looks a
// tile code up with a select tree over the packed words, because the TPU
// has no cross-lane gather. On Hopper a lookup is one indexed load, so the
// step reads `(w[idx >> 4] >> ((idx & 15) * 2)) & 3` directly.
//
// Bound on the card: the step is a short chain of dependent integer ops
// and two lookups (the packed word, then the per-code tables), so a thread
// is latency bound. The tables sit in shared memory and the packed level
// in shared memory (shared level) or in L1/L2 (per-env levels, 4 bytes per
// 16 tiles), so the step touches no device memory in steady state.
//
// Any number of actions. Up to kMaxActions the deltas sit in `Tables`, in
// shared memory, and the kernels keep rows of Q or logits in registers.
// Above it every kernel has a wide instantiation on `WideTables`: the
// (A, 2) deltas stay in device memory (read through L1, 8 bytes an
// action), and its loops over actions keep no row: a running first argmax
// or maximum, and sums in index order, so both give the same bits.

#pragma once

#include <cstdint>

namespace gu {

constexpr int kNumCodes = 4;
constexpr int kMaxActions = 8;
constexpr int kMaxWords = 1024;  // MAX_PACKED_STATES / 16

// Semantics tables, loaded once per block into shared memory.
struct Tables {
  static constexpr bool kWide = false;
  float reward[kNumCodes];
  int drow[kMaxActions];
  int dcol[kMaxActions];
  int passable;  // bit c set: tile code c can be entered
  int terminal;  // bit c set: entering tile code c ends the episode
  int num_actions;
};

// The same for any number of actions: the deltas stay in device memory.
struct WideTables {
  static constexpr bool kWide = true;
  float reward[kNumCodes];
  const int2* deltas;  // (A, 2) int32: row and column of each action
  int passable;
  int terminal;
  int num_actions;
};

// Action a's (row, column) delta.
__device__ __forceinline__ int2 delta(const Tables& s, int a) { return make_int2(s.drow[a], s.dcol[a]); }
__device__ __forceinline__ int2 delta(const WideTables& s, int a) { return __ldg(s.deltas + a); }

template <typename Tab>
__device__ inline void load_codes(Tab& s, const uint8_t* passable, const uint8_t* terminal,
                                  const float* reward, int num_actions) {
  int p = 0, t = 0;
  for (int c = 0; c < kNumCodes; ++c) {
    p |= (passable[c] != 0) << c;
    t |= (terminal[c] != 0) << c;
    s.reward[c] = reward[c];
  }
  s.passable = p;
  s.terminal = t;
  s.num_actions = num_actions;
}

// Thread 0 fills `s`; the caller runs __syncthreads() afterwards.
__device__ inline void load_tables(Tables& s, const uint8_t* passable,
                                   const uint8_t* terminal, const float* reward,
                                   const int* deltas, int num_actions) {
  if (threadIdx.x != 0) return;
  load_codes(s, passable, terminal, reward, num_actions);
  for (int a = 0; a < num_actions; ++a) {
    s.drow[a] = deltas[2 * a];
    s.dcol[a] = deltas[2 * a + 1];
  }
}

// `deltas` must be 8-byte aligned (a tensor's storage is).
__device__ inline void load_tables(WideTables& s, const uint8_t* passable,
                                   const uint8_t* terminal, const float* reward,
                                   const int* deltas, int num_actions) {
  if (threadIdx.x != 0) return;
  load_codes(s, passable, terminal, reward, num_actions);
  s.deltas = reinterpret_cast<const int2*>(deltas);
}

// `words` is anything indexed like an array of the packed words: a pointer,
// or a strided column of them (K6's levels in shared memory).
template <typename Words>
__device__ __forceinline__ int tile_code(const Words& words, int idx) {
  return static_cast<int>((words[idx >> 4] >> ((idx & 15) * 2)) & 3u);
}

// Out-of-range actions follow XLA's gather: negative counts from the end,
// then clip to [0, n).
__device__ __forceinline__ int clamp_action(int a, int n) {
  if (a < 0) a += n;
  return a < 0 ? 0 : (a >= n ? n - 1 : a);
}

// Where an agent stands: its index, the tile code there, and its row and
// column (idx = row * w + col).
struct Pos {
  int idx;
  int code;
  int row;
  int col;
};

struct Move {
  int idx;
  int code;
  float reward;
  bool done;
  int row;
  int col;
};

// (position, (row, column) delta) -> (new position, reward, terminal),
// bit-exactly the JAX `move_bits`. The row and column come with the
// position, so a caller that carries them never divides by the width.
template <typename Tab, typename Words>
__device__ __forceinline__ Move move_by(const Tab& s, const Words& words, int h, int w,
                                        const Pos& p, int drow, int dcol) {
  const int nrow = p.row + drow;
  const int ncol = p.col + dcol;
  const bool in_bounds = nrow >= 0 && nrow < h && ncol >= 0 && ncol < w;
  const int crow = min(max(nrow, 0), h - 1);
  const int ccol = min(max(ncol, 0), w - 1);
  const int cand = crow * w + ccol;
  const int cand_code = tile_code(words, cand);
  const bool blocked = !in_bounds || !((s.passable >> cand_code) & 1);
  Move m;
  m.idx = blocked ? p.idx : cand;
  m.code = blocked ? p.code : cand_code;
  m.row = blocked ? p.row : crow;
  m.col = blocked ? p.col : ccol;
  m.reward = s.reward[m.code];
  m.done = (s.terminal >> m.code) & 1;
  return m;
}

// The same for action a.
template <typename Tab, typename Words>
__device__ __forceinline__ Move move_from(const Tab& s, const Words& words, int h, int w,
                                          const Pos& p, int a) {
  const int2 d = delta(s, a);
  return move_by(s, words, h, w, p, d.x, d.y);
}

__device__ __forceinline__ Pos at_index(int idx, int code, int w) {
  const int row = idx / w;
  return Pos{idx, code, row, idx - row * w};
}

// (idx, code at idx, action) -> the move, the row and column computed here.
template <typename Tab, typename Words>
__device__ __forceinline__ Move move_bits(const Tab& s, const Words& words, int h, int w,
                                          int idx, int code, int a) {
  return move_from(s, words, h, w, at_index(idx, code, w), a);
}

// What one auto-reset step hands back beside the new env state: the
// transition's own (obs, reward, done), as `step_bits(auto_reset=True)`.
struct Transition {
  int obs;
  float reward;
  bool done;
};

// Per-env episode accumulators, folded in the reference's order of float
// adds: run_ret += r; on done, n_eps += 1, ret_sum += run_ret, len_sum +=
// the episode's length, and run_ret starts again at 0.
struct Episode {
  float run_ret;
  float ret_sum;
  int n_eps;
  int len_sum;
};

// The auto-reset step of `step_autoreset_from` after its move `m`.
__device__ __forceinline__ Transition finish_autoreset(const Move& m, const Pos& start,
                                                      int max_episode_steps, Pos& p, int& t,
                                                      Episode& ep) {
  const bool done = m.done || (max_episode_steps >= 0 && t + 1 >= max_episode_steps);
  ep.run_ret += m.reward;
  if (done) {
    ep.n_eps += 1;
    ep.ret_sum += ep.run_ret;
    ep.len_sum += t + 1;
    ep.run_ret = 0.0f;
    p = start;
    t = 0;
  } else {
    p = Pos{m.idx, m.code, m.row, m.col};
    t += 1;
  }
  return Transition{m.idx, m.reward, done};
}

// One auto-reset step with the optional time limit (`max_episode_steps`
// < 0: none). Updates the position `p` and `t` in place, reset to `start`
// when the episode ended, else advanced, and folds the step into `ep`.
// Everything that happens when an episode ends sits in one branch; a
// caller that reads none of `ep` pays nothing for it.
template <typename Tab, typename Words>
__device__ __forceinline__ Transition step_autoreset_from(
    const Tab& s, const Words& words, int h, int w, const Pos& start,
    int max_episode_steps, int a, Pos& p, int& t, Episode& ep) {
  return finish_autoreset(move_from(s, words, h, w, p, a), start, max_episode_steps, p, t, ep);
}

// The same step on (idx, code), the row and column computed here; the
// start's are never read.
template <typename Tab, typename Words>
__device__ __forceinline__ Transition step_autoreset(
    const Tab& s, const Words& words, int h, int w, int start_idx,
    int start_code, int max_episode_steps, int a, int& idx, int& code, int& t,
    Episode& ep) {
  Pos p = at_index(idx, code, w);
  const Transition tr = step_autoreset_from(s, words, h, w, Pos{start_idx, start_code, 0, 0},
                                            max_episode_steps, a, p, t, ep);
  idx = p.idx;
  code = p.code;
  return tr;
}

// One xorshift32 round; the new state is also the random word.
__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

// ε-greedy from one random word, as `_epsilon_greedy_bits`: the low 16
// bits are the explore coin against `eps16` = int(ε·65536), the top 16
// bits pick the explore action by multiply-shift.
__device__ __forceinline__ bool explore_coin(uint32_t bits, uint32_t eps16) {
  return (bits & 0xFFFFu) < eps16;
}
__device__ __forceinline__ int explore_action(uint32_t bits, int num_actions) {
  return static_cast<int>(((bits >> 16) * static_cast<uint32_t>(num_actions)) >> 16);
}

// First index of the maximum of `row[0..n)` (ties to the lowest index).
template <typename T>
__device__ __forceinline__ int first_argmax(const T* row, int n) {
  int best = 0;
  for (int a = 1; a < n; ++a) {
    if (row[a] > row[best]) best = a;
  }
  return best;
}

}  // namespace gu
