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
// 2·B·K·4 bytes (537 MB, 0.16 ms at 3.35 TB/s, at 65,536 envs × 256 states
// × 4 actions); the per-env inputs and the table are noise beside it.
//
// Design. The first launch has one thread for each (chunk of kChunk envs,
// cell), the chunks on the grid's y dimension; above its 65,535 blocks the
// chunks are launched in groups of that many, one launch a group (a batch
// above 16,776,960 envs). Adjacent threads take adjacent cells, so every row read and write
// is coalesced, and the block stages its chunk's per-env inputs in shared
// memory. The thread walks its chunk's envs in index order, eight loads in
// flight at a time, and writes one partial num and cnt for its chunk. The
// second launch, one thread a cell, adds the chunks' partials in chunk
// order and updates the table. kChunk is a constant of the algorithm, not of
// the card, so the order of the float adds is fixed: within a chunk in env
// order, then the chunks in order. `algos.td_lambda.trace_pass_reference`
// adds in that order, so the kernel equals it bit for bit, and two runs
// give the same bits. Built with -fmad=false: δ·x and the add round
// separately, as the plain version's product and sum do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;  // envs a thread walks; `kernels.trace_pass.CHUNK`
constexpr int kThreads = 256;
constexpr int kInFlight = 8;  // trace loads a thread issues before it uses them
constexpr int kMaxChunks = 65535;  // chunks a launch of the first kernel takes (the grid's y)

__global__ void __launch_bounds__(kThreads)
trace_pass_kernel(float* __restrict__ e, const int* __restrict__ s, const int* __restrict__ a,
                  const float* __restrict__ delta, const uint8_t* __restrict__ cut,
                  float gamma_lam, float cutoff, int replacing, int num_actions, int batch,
                  int n_cells, int chunk0, float* __restrict__ part_num,
                  int* __restrict__ part_cnt) {
  __shared__ int s_hot[kChunk];
  __shared__ float s_delta[kChunk];
  __shared__ uint8_t s_cut[kChunk];
  const int chunk = chunk0 + blockIdx.y;
  const int b0 = chunk * kChunk;
  const int len = batch - b0 < kChunk ? batch - b0 : kChunk;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int b = b0 + i;
    s_hot[i] = a == nullptr ? s[b] : s[b] * num_actions + a[b];
    s_delta[i] = delta[b];
    s_cut[i] = cut[b];
  }
  __syncthreads();

  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_cells) return;
  float* const col = e + static_cast<size_t>(b0) * n_cells + k;
  float num = 0.0f;
  int cnt = 0;
  for (int i0 = 0; i0 < len; i0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      v[j] = i0 + j < len ? col[static_cast<size_t>(i0 + j) * n_cells] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j;
      if (i >= len) break;
      float x = gamma_lam * v[j];
      if (x < cutoff) x = 0.0f;
      if (k == s_hot[i]) x = replacing ? fmaxf(x, 1.0f) : x + 1.0f;
      num = num + s_delta[i] * x;
      cnt += x != 0.0f;
      col[static_cast<size_t>(i) * n_cells] = s_cut[i] ? 0.0f : x;
    }
  }
  part_num[static_cast<size_t>(chunk) * n_cells + k] = num;
  part_cnt[static_cast<size_t>(chunk) * n_cells + k] = cnt;
}

__global__ void __launch_bounds__(kThreads)
trace_apply_kernel(const float* __restrict__ table_in, float* __restrict__ table_out,
                   const float* __restrict__ part_num, const int* __restrict__ part_cnt,
                   int n_chunks, int n_cells, float alpha) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_cells) return;
  float num = 0.0f;
  int cnt = 0;
  for (int c = 0; c < n_chunks; ++c) {  // the chunks in order
    num = num + part_num[static_cast<size_t>(c) * n_cells + k];
    cnt += part_cnt[static_cast<size_t>(c) * n_cells + k];
  }
  const float live = static_cast<float>(cnt);
  table_out[k] = table_in[k] + (alpha * num) / (live > 1.0f ? live : 1.0f);
}

}  // namespace

// One trace step: `e` (batch, n_cells) is updated in place, `table_out`
// receives the new table. `a` is null for prediction (the cell is s alone).
// `part_num`, `part_cnt`: scratch of ⌈batch / kChunk⌉ · n_cells each.
// `*launched` counts the kernels launched: two, and one more for every
// further group of kMaxChunks chunks.
extern "C" int gu_trace_pass(void* e, const void* s, const void* a, const void* delta,
                             const void* cut, const void* table_in, void* table_out,
                             float gamma_lam, float cutoff, float alpha, int replacing,
                             int num_actions, int batch, int n_cells, void* part_num,
                             void* part_cnt, int* launched, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int n_chunks = (batch + kChunk - 1) / kChunk;
  for (int chunk0 = 0; chunk0 < n_chunks; chunk0 += kMaxChunks) {
    const int chunks = n_chunks - chunk0 < kMaxChunks ? n_chunks - chunk0 : kMaxChunks;
    const dim3 grid((n_cells + kThreads - 1) / kThreads, chunks);
    trace_pass_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<float*>(e), static_cast<const int*>(s), static_cast<const int*>(a),
        static_cast<const float*>(delta), static_cast<const uint8_t*>(cut), gamma_lam, cutoff,
        replacing, num_actions, batch, n_cells, chunk0, static_cast<float*>(part_num),
        static_cast<int*>(part_cnt));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    *launched += 1;
  }
  trace_apply_kernel<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(table_in), static_cast<float*>(table_out),
      static_cast<const float*>(part_num), static_cast<const int*>(part_cnt), n_chunks, n_cells,
      alpha);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched += 1;
  return err;
}
