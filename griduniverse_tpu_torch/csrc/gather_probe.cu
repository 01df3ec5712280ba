// gather_probe.cu — P1 `gather_1d` and P2 `take_along_axis1`, the two
// in-kernel gathers the reference probes its TPU toolchain with.
//
// Replaces: tools/pallas_probe.py `probe_gather_1d` (43, `pl.pallas_call` at
// 50) and `probe_take_along_axis` (61, call at 68). On the TPU a vector
// gather inside a kernel does not lower, which is why the reference's env
// step is a select tree over packed words; on this card a gather is one
// indexed load a thread.
//
// Bound on the card: bytes (the indices read once, the output written once,
// the table once); at the probe's shapes a launch. One thread an output
// element; an index outside the table is clamped to its ends, as the
// reference's gathers clamp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_1d_kernel(const int* __restrict__ table, int table_len,
                                 const int* __restrict__ idx, int n,
                                 int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = table[min(max(idx[i], 0), table_len - 1)];
}

__global__ void take_along_axis1_kernel(const int* __restrict__ table, int cols,
                                        const int* __restrict__ idx, int rows, int k,
                                        int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * k) return;
  const int r = i / k;
  out[i] = table[r * cols + min(max(idx[i], 0), cols - 1)];
}

}  // namespace

extern "C" int gu_gather_1d(const void* table, int table_len, const void* idx, int n,
                            void* out, void* stream) {
  gather_1d_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), table_len, static_cast<const int*>(idx), n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gu_take_along_axis1(const void* table, int cols, const void* idx, int rows,
                                   int k, void* out, void* stream) {
  const int n = rows * k;
  take_along_axis1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), cols, static_cast<const int*>(idx), rows, k,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
