// A deliberately racy kernel: the launch checker's write-race fixture.
//
// Counterpart of the TPU fixture repro/analysis/fixtures/racy_kernel.py::
// racy_sum (Pallas body _racy_kernel), whose output BlockSpec sends both
// grid points to output block 0. Here the grid is 2 blocks and block i
// writes out[j] = x[i*n + j] * (i + 1) for every j < n, with nothing to
// order the two blocks: each out[j] ends up as whichever block wrote it
// last, which the card does not define. It is not a kernel of the port and
// lives outside kernels/, so the checker's production registry never sees
// it; analysis/fixtures/racy_kernel.py declares its launch for the checker,
// which must flag it, and chip_smoke.py runs it to show the corruption.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 2;

__global__ void __launch_bounds__(kThreads) racy_sum_kernel(
    const float* __restrict__ x, float* out, int n) {
  const float scale = blockIdx.x + 1.0f;
  const float* xi = x + (long long)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += kThreads) out[j] = xi[j] * scale;
}

}  // namespace

extern "C" {

// Launches the racy sum of x [2n] into out [n] (float) on `stream`. grid_x
// is the wrapper's grid: -2 unless it is this file's 2 blocks. Returns 0 or
// the cudaGetLastError() code.
int racy_sum_launch(const void* x, void* out, int n, int grid_x,
                    void* stream) {
  if (grid_x != kBlocks) return -2;
  if (n == 0) return 0;
  racy_sum_kernel<<<kBlocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* racy_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
