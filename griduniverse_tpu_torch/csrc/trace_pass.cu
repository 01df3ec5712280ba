// trace_pass.cu — K12: one step of the TD(λ) eligibility-trace pass.
//
// Replaces: griduniverse_tpu/algos/td_lambda.py `decay_traces` (41),
// `bump_traces` (47), `apply_trace_updates` (59) and the trace cut of
// `_td_lambda_control` (126-130), and the same lines of
// `td_lambda_prediction` (222-231). The reference writes them as dense
// passes over the whole (B, K) trace — a one-hot outer product for the bump
// ("no scatters, the slow primitive on TPU") and an `einsum` on the MXU for
// Σ_b δ_b·e_b — so a step reads and writes the trace several times.
//
// One step over the trace e (B, K), K = S·A for control and S for
// prediction. For every env b and cell k, in this order:
//   1. decay: x = γλ·e[b,k] (γλ rounded to float once, as the plain version's
//      scalar);
//   2. flush: x = 0 where x < cutoff;
//   3. bump at k == s_b·A + a_b (k == s_b for prediction): x + 1 for
//      accumulating traces, max(x, 1) for replacing ones;
//   4. num[k] += δ_b·x and cnt[k] += (x ≠ 0);
//   5. e[b,k] = cut_b ? 0 : x.
// Then table[k] + α·num[k] / max(cnt[k], 1).
//
// Bound on the card: bytes. The trace is read once and written once a step,
// 2·B·K·4 bytes (537 MB, 0.160 ms at 3.35 TB/s, at 65,536 envs × 256 states
// × 4 actions; 134 MB, 0.040 ms, at 65,536 × 256 states for prediction);
// the per-env inputs and the table are noise beside it. At 3.35 TB/s and
// about a microsecond from a load's issue to its data under load, the card
// needs some 3 MB of loads in flight to stream at its rate.
//
// Design: one launch a step. A block takes one (tile of kTile cells, chunk
// of kChunk envs), a thread a cell; the grid is chunks × tiles on x alone,
// chunk-major (a chunk's tiles are adjacent blocks, so the blocks running
// at once read and write whole rows), so a batch of any size is one
// launch, and at K = 256 the 512 blocks of 128 threads spread over every
// SM. The block stages its chunk's per-env inputs in shared memory, 8 bytes
// an env (the bump's cell with the cut flag in its sign bit, and δ), read
// with one broadcast load a row; each thread walks its chunk's envs in
// index order with two groups of kGroup trace loads in flight: the next
// group's loads are issued before this group's stores (32 loads of 4 bytes
// a thread, 8 MB over the 65,536 threads at K = 256). A row's address is
// the last one's plus the row's stride, and a full chunk takes a path
// without bounds tests: 27 SASS instructions a trace element (a 64-bit
// multiply an address and a test a row made 40, and the pass waited on its
// SM's issue). Adjacent threads take adjacent cells, so every row read and
// write is coalesced; the trace is read and written with the streaming
// hints. Each thread writes its chunk's partial num and adds its live count
// to the cell's count (an integer sum, so its order changes no bit); the
// block then takes a ticket on its tile's counter.
//
// The tile's last `appliers` tickets (`kernels.trace_pass.appliers`: 4 at
// the TD(λ) runs' traces) make their blocks the tile's appliers, each over
// a quarter of its cells: an applier waits until every chunk's block has
// taken its ticket, then its four warps add the partials of a quarter of
// the chunks each, in turn, a lane a cell, every load issued before the
// first add (read at L2 with __ldcg: other SMs wrote them, and L1 is not
// coherent). The partials are padded with zero rows to whole groups, so no
// add is tested. The tile's last block alone takes about 15,000 cycles for
// the four quarters one after another; four appliers about 4,300
// (`experiments/k12_variants.py`). Appliers of all tiles together are
// at most two blocks an SM, and the kernel holds four, so the blocks they
// wait for always find room. The last applier sets the ticket back to 0 and
// each sets its cells' counts to 0, so the next step, or a CUDA-graph
// replay, finds them clean. The scratch (`kernels.trace_pass.TracePassPlan`)
// is zeroed once a run.
//
// The partial-sums form (`gu_trace_partials`, then `gu_trace_apply`) serves
// the sharded TD(λ) learners (`parallel/learner.py`), whose ranks hold their
// envs' traces and a replicated table. It replaces the `psum` of Σ_b δ_b·e_b
// and of the live counts in the reference's `td_lambda_sharded` (387-388)
// and `td_lambda_prediction_sharded` (876-877). `trace_partials_kernel` is
// the pass above without its appliers: each (tile, chunk) block writes its
// chunk's partial sums and adds its live counts, then stops; the cut is
// applied in the pass, as it is known before the update. The ranks gather
// the partials in rank order and all-reduce the counts (exact integers);
// then `trace_apply_kernel`, the appliers' `apply_cells` alone, a block a
// 32 cells, adds every rank's chunks in order from 0.0 and writes the
// table. Where every rank's batch is a multiple of kChunk the gathered
// chunks are the unsharded run's, and the table its bits.
//
// kChunk is a constant of the algorithm, not of the card, so the order of
// the float adds is fixed: within a chunk in env order from 0.0, then the
// chunks in order from 0.0. `algos.td_lambda.trace_pass_reference` adds in
// that order, so the kernel equals it bit for bit, and two runs give the
// same bits. Built with -fmad=false: δ·x and the add round separately, as
// the plain version's product and sum do.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kChunk = 256;     // envs a thread walks; `kernels.trace_pass.CHUNK`
constexpr int kTile = 128;      // cells a block, a thread a cell; `kernels.trace_pass.TILE`
constexpr int kGroup = 16;      // trace loads a thread issues as one group; two groups in flight
static_assert(kChunk % (2 * kGroup) == 0, "a full chunk is whole pairs of groups");
constexpr int kWarp = 32;
constexpr int kApplyWarps = kTile / kWarp;  // an applier's warps, each over a quarter of the chunks
constexpr int kApplyGroup = 32; // partial sums a lane loads as one group; two groups in flight
constexpr int kApplyChunks = kApplyWarps * 2 * kApplyGroup;  // `kernels.trace_pass.APPLY_CHUNKS`
constexpr int kCutBit = INT_MIN;  // an env's cut flag, kept in its cell's sign bit

// The rows i0 .. i0 + kGroup - 1 of the thread's column from `p` (row i0)
// on: kFull, every row of the chunk exists; else rows from `len` on read 0.
template <bool kFull>
__device__ __forceinline__ void load_group(float (&v)[kGroup], const float* p, size_t stride, int i0,
                                           int len) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    v[j] = kFull || i0 + j < len ? __ldcs(p) : 0.0f;
    p += stride;
  }
}

// Steps 1-5 for the group's rows. `env[i]`: the env's cell (the bump's k),
// its cut flag in the sign bit, and δ's bits.
template <bool kReplacing, bool kFull>
__device__ __forceinline__ void walk_group(const float (&v)[kGroup], float* p, size_t stride, int i0,
                                           int len, int k, const int2* env, float gamma_lam,
                                           float cutoff, float& num, int& cnt) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (!kFull && i0 + j >= len) break;
    const int2 ed = env[i0 + j];
    float x = gamma_lam * v[j];
    if (x < cutoff) x = 0.0f;
    if (k == (ed.x & ~kCutBit)) x = kReplacing ? fmaxf(x, 1.0f) : x + 1.0f;
    num = num + __int_as_float(ed.y) * x;
    cnt += x != 0.0f;
    __stcs(p, ed.x < 0 ? 0.0f : x);
    p += stride;
  }
}

// The chunk's rows of the thread's column, from `col` (row 0), the next
// group's loads in flight before this group's stores.
template <bool kReplacing, bool kFull>
__device__ __forceinline__ void pass(float* col, size_t stride, int len, int k, const int2* env,
                                     float gamma_lam, float cutoff, float& num, int& cnt) {
  const size_t group = kGroup * stride;
  const float* next = col;  // the row of the next load
  float va[kGroup], vb[kGroup];
  load_group<kFull>(va, next, stride, 0, len);
  next += group;
  for (int i0 = 0; i0 < len; i0 += 2 * kGroup) {
    // a full chunk is whole pairs of groups: the tests below are uniform branches
    if (kFull || i0 + kGroup < len) load_group<kFull>(vb, next, stride, i0 + kGroup, len);
    next += group;
    walk_group<kReplacing, kFull>(va, col, stride, i0, len, k, env, gamma_lam, cutoff, num, cnt);
    col += group;
    if (i0 + 2 * kGroup < len) load_group<kFull>(va, next, stride, i0 + 2 * kGroup, len);
    next += group;
    walk_group<kReplacing, kFull>(vb, col, stride, i0 + kGroup, len, k, env, gamma_lam, cutoff, num, cnt);
    col += group;
  }
}

// The partial sums of kApplyGroup chunks of a cell from `p` on, read at L2.
__device__ __forceinline__ void load_partials(float (&v)[kApplyGroup], const float* p, size_t stride) {
#pragma unroll
  for (int j = 0; j < kApplyGroup; ++j) {
    v[j] = __ldcg(p);
    p += stride;
  }
}

__device__ __forceinline__ void add_partials(const float (&v)[kApplyGroup], float& num) {
#pragma unroll
  for (int j = 0; j < kApplyGroup; ++j) num = num + v[j];
}

// The chunks a plan's partial sums have room for: a multiple of kApplyChunks,
// the rows past the batch's chunks zero (`kernels.trace_pass.scratch_words`).
__host__ __device__ constexpr long long padded_chunks(long long n_chunks) {
  return (n_chunks + kApplyChunks - 1) / kApplyChunks * kApplyChunks;
}

// The table's cells k0 .. k0 + kWarp - 1 (those < n_cells), a lane a cell:
// each cell's partial sums added in chunk order from 0.0 by the block's
// warps in turn, warp w over the w-th quarter of the chunks, starting from
// the sum the warp before it left in `carry`. Every warp's first two groups
// of loads are issued before the first add, so the quarters arrive
// together. The rows past the batch's chunks hold +0.0, and a sum that
// starts from +0.0 is never -0.0, so adding them changes no bit. Then the
// new table and the cell's count set back to 0.
__device__ __forceinline__ void apply_cells(int k0, int n_cells, int n_chunks,
                                            const float* __restrict__ partial, int* __restrict__ count,
                                            const float* __restrict__ table_in,
                                            float* __restrict__ table_out, float alpha, float* carry) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int k = k0 + lane;
  const bool live = k < n_cells;
  const size_t stride = static_cast<size_t>(n_cells);
  const int quarter = static_cast<int>(padded_chunks(n_chunks)) / kApplyWarps;
  const size_t group = kApplyGroup * stride;
  // a lane past the table reads its neighbour's column and writes nothing
  const float* next = partial + static_cast<size_t>(warp) * quarter * stride + (live ? k : n_cells - 1);
  float va[kApplyGroup], vb[kApplyGroup];
  load_partials(va, next, stride);
  next += group;
  load_partials(vb, next, stride);
  next += group;
  float num = 0.0f;
  for (int w = 0; w < kApplyWarps; ++w) {
    if (w == warp) {
      if (warp > 0) num = carry[lane];
      for (int c0 = 0; c0 < quarter; c0 += 2 * kApplyGroup) {
        add_partials(va, num);
        if (c0 + 2 * kApplyGroup < quarter) load_partials(va, next, stride);
        next += group;
        add_partials(vb, num);
        if (c0 + 3 * kApplyGroup < quarter) load_partials(vb, next, stride);
        next += group;
      }
      carry[lane] = num;
    }
    __syncthreads();
  }
  if (warp == 0 && live) {
    const float n_live = static_cast<float>(__ldcg(count + k));
    table_out[k] = table_in[k] + (alpha * carry[lane]) / (n_live > 1.0f ? n_live : 1.0f);
    count[k] = 0;
  }
  __syncthreads();  // `carry` is read before the next cells' warps write it
}

// Steps 1-5 for a block's (tile, chunk): the chunk's per-env inputs staged
// in `s_env`, each thread's cell walked over the chunk's envs, its partial
// sum written to row `chunk` of `partial` and its live count added to
// `count`.
template <bool kReplacing>
__device__ __forceinline__ void chunk_pass(int2* s_env, float* __restrict__ e, const int* __restrict__ s,
                                           const int* __restrict__ a, const float* __restrict__ delta,
                                           const uint8_t* __restrict__ cut, float gamma_lam, float cutoff,
                                           int num_actions, int batch, int n_cells, int chunk, int tile,
                                           float* __restrict__ partial, int* __restrict__ count) {
  const int b0 = chunk * kChunk;
  const int len = batch - b0 < kChunk ? batch - b0 : kChunk;
  for (int i = threadIdx.x; i < len; i += kTile) {
    const int b = b0 + i;
    const int hot = a == nullptr ? s[b] : s[b] * num_actions + a[b];
    s_env[i] = make_int2(cut[b] ? hot | kCutBit : hot, __float_as_int(delta[b]));
  }
  __syncthreads();

  const int k = tile * kTile + threadIdx.x;
  const size_t stride = static_cast<size_t>(n_cells);
  if (k < n_cells) {
    float* const col = e + static_cast<size_t>(b0) * stride + k;
    float num = 0.0f;
    int cnt = 0;
    if (len == kChunk) {
      pass<kReplacing, true>(col, stride, len, k, s_env, gamma_lam, cutoff, num, cnt);
    } else {
      pass<kReplacing, false>(col, stride, len, k, s_env, gamma_lam, cutoff, num, cnt);
    }
    partial[static_cast<size_t>(chunk) * stride + k] = num;
    if (cnt != 0) atomicAdd(count + k, cnt);
  }
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// At least four blocks an SM: the 512 blocks at K = 256 all resident at
// once, and the spinning appliers (`appliers` a tile, at most two blocks an
// SM in all, `kernels.trace_pass.appliers`) never fill the card.
template <bool kReplacing>
__global__ void __launch_bounds__(kTile, 4)
trace_step_kernel(float* __restrict__ e, const int* __restrict__ s, const int* __restrict__ a,
                  const float* __restrict__ delta, const uint8_t* __restrict__ cut,
                  const float* __restrict__ table_in, float* __restrict__ table_out, float gamma_lam,
                  float cutoff, float alpha, int num_actions, int batch, int n_cells, int tiles,
                  int n_chunks, int appliers, float* __restrict__ partial, int* __restrict__ count,
                  unsigned int* __restrict__ tickets) {
  __shared__ int2 s_env[kChunk];
  __shared__ float s_carry[kWarp];
  __shared__ int s_role;
  // chunk-major: a chunk's tiles are adjacent blocks, so the blocks running
  // at once read and write whole rows
  const int chunk = blockIdx.x / tiles;
  const int tile = blockIdx.x - chunk * tiles;
  chunk_pass<kReplacing>(s_env, e, s, a, delta, cut, gamma_lam, cutoff, num_actions, batch, n_cells, chunk,
                         tile, partial, count);
  if (tile * kTile + static_cast<int>(threadIdx.x) < n_cells) {
    __threadfence();  // this thread's partial and count before the block's ticket
  }
  __syncthreads();
  // The tile's last `appliers` tickets (all of its chunks' blocks when there
  // are fewer) make a block an applier of a quarter (or more) of the tile's
  // cells: it waits until every chunk's partials are written, then adds them.
  unsigned int* const done = tickets + tiles;  // appliers finished, a tile
  const int in_tile = appliers < n_chunks ? appliers : n_chunks;
  if (threadIdx.x == 0) {
    s_role = static_cast<int>(atomicAdd(tickets + tile, 1u)) - (n_chunks - in_tile);
  }
  __syncthreads();
  const int role = s_role;
  if (role < 0) return;
  if (threadIdx.x == 0) {
    while (load_acquire(tickets + tile) < static_cast<unsigned int>(n_chunks)) __nanosleep(64);
  }
  __syncthreads();
  __threadfence();
  for (int q = role; q < kTile / kWarp; q += in_tile) {
    apply_cells(tile * kTile + q * kWarp, n_cells, n_chunks, partial, count, table_in, table_out,
                alpha, s_carry);
  }
  // the last applier of the tile sets the ticket back to 0: every applier
  // has read it by then
  if (threadIdx.x == 0 && atomicAdd(done + tile, 1u) == static_cast<unsigned int>(in_tile - 1)) {
    tickets[tile] = 0;
    done[tile] = 0;
  }
}

// The partial-sums form's pass: the blocks of `trace_step_kernel` without
// the tickets and appliers.
template <bool kReplacing>
__global__ void __launch_bounds__(kTile, 4)
trace_partials_kernel(float* __restrict__ e, const int* __restrict__ s, const int* __restrict__ a,
                      const float* __restrict__ delta, const uint8_t* __restrict__ cut, float gamma_lam,
                      float cutoff, int num_actions, int batch, int n_cells, int tiles,
                      float* __restrict__ partial, int* __restrict__ count) {
  __shared__ int2 s_env[kChunk];
  const int chunk = blockIdx.x / tiles;
  chunk_pass<kReplacing>(s_env, e, s, a, delta, cut, gamma_lam, cutoff, num_actions, batch, n_cells, chunk,
                         blockIdx.x - chunk * tiles, partial, count);
}

// The partial-sums form's apply: a block of four warps a 32 cells, the
// chunks' sums added in order by `apply_cells`, which also sets the counts
// back to 0.
__global__ void __launch_bounds__(kTile)
trace_apply_kernel(int n_cells, int n_chunks, const float* __restrict__ partial, int* __restrict__ count,
                   const float* __restrict__ table_in, float* __restrict__ table_out, float alpha) {
  __shared__ float s_carry[kWarp];
  apply_cells(blockIdx.x * kWarp, n_cells, n_chunks, partial, count, table_in, table_out, alpha, s_carry);
}

}  // namespace

// One trace step, one launch: `e` (batch, n_cells) is updated in place,
// `table_out` receives the new table. `a` is null for prediction (the cell
// is s alone). `appliers`: blocks a tile that add its partial sums (1, 2 or
// 4; `kernels.trace_pass.appliers`). Scratch
// (`kernels.trace_pass.scratch_words`): `partial`,
// padded_chunks(⌈batch / kChunk⌉) · n_cells floats, the rows past the
// batch's chunks 0; `count`, n_cells ints, and `tickets`, 2 · ⌈n_cells /
// kTile⌉ unsigned ints, both 0 on entry and left 0.
extern "C" int gu_trace_pass(void* e, const void* s, const void* a, const void* delta,
                             const void* cut, const void* table_in, void* table_out,
                             float gamma_lam, float cutoff, float alpha, int replacing,
                             int num_actions, int batch, int n_cells, int appliers, void* partial,
                             void* count, void* tickets, void* stream) {
  const long long n_chunks = (static_cast<long long>(batch) + kChunk - 1) / kChunk;
  const long long tiles = (static_cast<long long>(n_cells) + kTile - 1) / kTile;
  if (batch < 1 || n_cells < 1 || tiles * n_chunks > INT_MAX || padded_chunks(n_chunks) > INT_MAX ||
      (appliers != 1 && appliers != 2 && appliers != kApplyWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = replacing ? trace_step_kernel<true> : trace_step_kernel<false>;
  kernel<<<static_cast<unsigned int>(tiles * n_chunks), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(e), static_cast<const int*>(s), static_cast<const int*>(a),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(cut),
      static_cast<const float*>(table_in), static_cast<float*>(table_out), gamma_lam, cutoff, alpha,
      num_actions, batch, n_cells, static_cast<int>(tiles), static_cast<int>(n_chunks), appliers,
      static_cast<float*>(partial), static_cast<int*>(count), static_cast<unsigned int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// The partial-sums form's pass, one launch: `e` (batch, n_cells) updated in
// place (the cut applied), row c of `partial` (⌈batch / kChunk⌉ rows of
// n_cells floats) receives chunk c's sums and `count` (n_cells ints, 0 on
// entry) the live counts.
extern "C" int gu_trace_partials(void* e, const void* s, const void* a, const void* delta, const void* cut,
                                 float gamma_lam, float cutoff, int replacing, int num_actions, int batch,
                                 int n_cells, void* partial, void* count, void* stream) {
  const long long n_chunks = (static_cast<long long>(batch) + kChunk - 1) / kChunk;
  const long long tiles = (static_cast<long long>(n_cells) + kTile - 1) / kTile;
  if (batch < 1 || n_cells < 1 || tiles * n_chunks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = replacing ? trace_partials_kernel<true> : trace_partials_kernel<false>;
  kernel<<<static_cast<unsigned int>(tiles * n_chunks), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(e), static_cast<const int*>(s), static_cast<const int*>(a),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(cut), gamma_lam, cutoff, num_actions, batch,
      n_cells, static_cast<int>(tiles), static_cast<float*>(partial), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// The partial-sums form's apply, one launch: `partial` holds the gathered
// chunks' sums in its first `n_chunks` rows and zeros up to
// padded_chunks(n_chunks) rows; `count` the all-reduced live counts, set back
// to 0. `table_out` receives table_in + α·num / max(count, 1).
extern "C" int gu_trace_apply(const void* partial, void* count, const void* table_in, void* table_out, float alpha,
                              int n_cells, int n_chunks, void* stream) {
  if (n_cells < 1 || n_chunks < 1 || padded_chunks(n_chunks) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>((n_cells + kWarp - 1) / kWarp);
  trace_apply_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      n_cells, n_chunks, static_cast<const float*>(partial), static_cast<int*>(count),
      static_cast<const float*>(table_in), static_cast<float*>(table_out), alpha);
  return static_cast<int>(cudaGetLastError());
}
