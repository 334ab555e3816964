// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan/ssm_scan.py::ssm_scan
// (Pallas body _ssm_kernel). It computes what the plain version
// kernels/ssm_scan/ref.py::ssm_scan_ref computes, for every batch row b and
// channel d, from h = 0:
//
//   h[n] = exp(dt_t * A[d,n]) * h[n] + (dt_t * u_t) * B_t[n]    (n < N)
//   y_t  = sum_n h[n] * C_t[n]
//
// in f32, with u, dt, y [B,S,di] and B, C [B,S,N] in the input type (float
// or bf16, read with __bfloat162float) and A [di,N] in float. y is written
// in u's type. Like the Pallas kernel, exp(dt*A) is computed at every step:
// the [S,di,N] decay tensor is never stored.
//
// Design: one thread per (b, d) channel holds h[N] and A[d,:] in registers
// and walks the sequence in order; the TPU kernel's sequential chunk axis,
// whose state lived in VMEM scratch, becomes this loop. A block of 64
// threads covers 64 neighbouring channels: small blocks so that at
// falcon-mamba's B = 1, di = 8192 the 128 blocks fill the 132 SMs in one
// wave. The sequence goes in tiles of 32 steps: the block loads the tile's
// u and dt (coalesced across d) and B and C (shared by every channel) into
// shared memory as f32, then each thread runs the 32 steps out of shared
// memory and writes y_t straight out (coalesced across d). Channels past di
// and steps past S load as zero and are not stored.
//
// Arithmetic is f32 on the CUDA cores with the accurate expf; the library
// is built with -O3 --fmad=false (kernels/_build.py), so each product and
// sum is rounded as the plain version rounds it; only the order of the
// sum over n may differ.
//
// Bound on the H100: at falcon-mamba's B 1, S 4096, di 8192, N 16, bf16,
// the bytes are u, dt and y (201 MB) plus B and C: about 60 us at
// 3.35 TB/s; the f32 work (about 7 operations per state element a step,
// 3.8 GFLOP) takes 56 us at 67 TFLOP/s. This first version is bound by the
// latency of its sequential loop instead: two warps a block, one block an
// SM, a dependent exp-multiply-add chain per step. Splitting N across
// threads and double-buffering the tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kT = 32;         // time steps per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, int S, int di) {
  __shared__ float sU[kT][kThreads];
  __shared__ float sDt[kT][kThreads];
  __shared__ float sB[kT][N];
  __shared__ float sC[kT][N];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const long long row0 = (long long)blockIdx.y * S;   // first row of batch b
  const bool active = d < di;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[(long long)d * N + n] : 0.0f;
    h[n] = 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    __syncthreads();   // the last tile's readers are done
    for (int i = tid; i < kT * kThreads; i += kThreads) {
      const int r = i / kThreads, c = i % kThreads;
      const bool ok = r < tn && d0 + c < di;
      const long long off = (row0 + t0 + r) * di + d0 + c;
      sU[r][c] = ok ? to_f32(u[off]) : 0.0f;
      sDt[r][c] = ok ? to_f32(dt[off]) : 0.0f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const bool ok = r < tn;
      const long long off = (row0 + t0 + r) * N + n;
      sB[r][n] = ok ? to_f32(Bm[off]) : 0.0f;
      sC[r][n] = ok ? to_f32(Cm[off]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < tn; ++r) {
      const float dtv = sDt[r][tid];
      const float du = dtv * sU[r][tid];
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + du * sB[r][n];
        acc += h[n] * sC[r][n];
      }
      store(y + (row0 + t0 + r) * di + d, acc);
    }
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int di,
           cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), S, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int N, const void* u, const void* dt, const float* A,
             const void* Bm, const void* Cm, void* y, int B, int S, int di,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(u, dt, A, Bm, Cm, y, B, S, di, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Launches one selective scan of u, dt [B,S,di], A [di,N] (float), B, C
// [B,S,N] into y [B,S,di], on `stream`. is_bf16: 0 for float, 1 for bf16
// (u, dt, B, C and y). Returns the cudaGetLastError() code of the launch
// (0 on success), -1 for an N this file was not instantiated for, or -2 if
// (grid_x, grid_y), the wrapper's grid, is not the one this file's tiling
// needs.
int ssm_scan_launch(const void* u, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int B, int S,
                    int di, int N, int is_bf16, int grid_x, int grid_y,
                    void* stream) {
  if (grid_x != (di + kThreads - 1) / kThreads || grid_y != B) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  if (is_bf16)
    return launch_n<__nv_bfloat16>(N, u, dt, a, Bm, Cm, y, B, S, di, st);
  return launch_n<float>(N, u, dt, a, Bm, Cm, y, B, S, di, st);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
