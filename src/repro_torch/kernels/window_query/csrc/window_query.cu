// The §IV.B.2 multi-containment window query, for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/window_query/window_query.py::
// window_query_batched (Pallas body _batched_query_kernel) and ::window_query
// (body _query_kernel). For every (replica b, device d) row it computes what
// the plain versions kernels/window_query/ref.py compute over the row's T*W
// windows:
//
//   start    = max(t1, q1)
//   feasible = valid && start + dur <= min(t2, deadline)
//   best     = min over the windows of (feasible ? start : big)
//   found    = best < big
//
// The batched form reads q1, deadline and dur per row from [B,Dev] tensors;
// the unbatched form takes them by value, already rounded to f32.
//
// Design: one warp per row. The lanes stride over the row's T*W windows
// (exactly one each at the fleet's T = 2, W = 16), each keeps the smallest
// key it saw, and the warp takes the minimum with __shfl_xor_sync; lane 0
// writes start (f32) and found (i32). A block of 256 threads holds 8 rows
// and rows past B*Dev are masked, so no padding copy is made. The windows
// are read through strides given in elements (replica and device; the
// inner T*W block must be contiguous), so the fleet passes its [B,1,T,W]
// view of win_*[:, d, HP] without a copy. valid is read as the bool
// tensor's bytes.
//
// Min, max and compare are exact and the only add is start + dur
// (__fadd_rn, never contracted), so the result equals the plain version bit
// for bit. A lane with no window contributes +inf, the identity of the min.
// Inputs are NaN-free (window bounds and times).
//
// Bound on the H100: each window is read once, 9 bytes (t1, t2, valid), plus
// 12 bytes of parameters and 8 of outputs a row; a few compares a window do
// not bound it. At the fleet's HP view (B = 8192, one device, 32 windows)
// that is 2.5 MB, 0.75 us at 3.35 TB/s: the launch latency bounds it there.
// At 262,144 devices of 32 windows the kernel streams 75.5 MB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

struct Strides {            // element strides of one [B,Dev,...] tensor
  long long b, d;
  __device__ long long at(long long b_i, long long d_i) const {
    return b_i * b + d_i * d;
  }
};

template <bool kBatched>
__global__ void __launch_bounds__(kThreads) window_query_kernel(
    const float* __restrict__ t1, const float* __restrict__ t2,
    const uint8_t* __restrict__ valid, const float* __restrict__ q1p,
    const float* __restrict__ dlp, const float* __restrict__ durp,
    float q1s, float dls, float durs, float* __restrict__ start,
    int32_t* __restrict__ found, long long n_rows, int n_dev, int tw,
    Strides s_t1, Strides s_t2, Strides s_valid, Strides s_q1, Strides s_dl,
    Strides s_dur, float big) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long b = row / n_dev, d = row % n_dev;
  float q1 = q1s, dl = dls, dur = durs;
  if (kBatched) {
    q1 = q1p[s_q1.at(b, d)];
    dl = dlp[s_dl.at(b, d)];
    dur = durp[s_dur.at(b, d)];
  }
  const float* r1 = t1 + s_t1.at(b, d);
  const float* r2 = t2 + s_t2.at(b, d);
  const uint8_t* rv = valid + s_valid.at(b, d);
  float best = INFINITY;
  for (int i = lane; i < tw; i += 32) {
    const float s = fmaxf(r1[i], q1);
    const bool feasible = rv[i] != 0 && __fadd_rn(s, dur) <= fminf(r2[i], dl);
    best = fminf(best, feasible ? s : big);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) {
    start[row] = best;
    found[row] = best < big ? 1 : 0;
  }
}

int grid_for(long long n_rows) {
  return (int)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" {

// Launches the batched query over t1, t2 [B,Dev,T,W] (float), valid
// (bytes) and q1, deadline, dur [B,Dev] (float) into start [B,Dev] (float)
// and found [B,Dev] (int32, both contiguous), on `stream`. Each input comes
// with its replica and device strides in elements; tw = T*W windows of a
// row lie contiguous. grid_x is the wrapper's grid: -2 if it is not the
// one this file's tiling needs. Returns 0 or the cudaGetLastError() code.
int window_query_batched_launch(
    const void* t1, const void* t2, const void* valid, const void* q1,
    const void* dl, const void* dur, void* start, void* found, int B,
    int n_dev, int tw, long long t1_sb, long long t1_sd, long long t2_sb,
    long long t2_sd, long long valid_sb, long long valid_sd, long long q1_sb,
    long long q1_sd, long long dl_sb, long long dl_sd, long long dur_sb,
    long long dur_sd, float big, int grid_x, void* stream) {
  const long long n_rows = (long long)B * n_dev;
  if (grid_x != grid_for(n_rows)) return -2;
  if (n_rows == 0) return 0;
  window_query_kernel<true><<<grid_x, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t1), static_cast<const float*>(t2),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(q1),
      static_cast<const float*>(dl), static_cast<const float*>(dur), 0.0f,
      0.0f, 0.0f, static_cast<float*>(start), static_cast<int32_t*>(found),
      n_rows, n_dev, tw, Strides{t1_sb, t1_sd}, Strides{t2_sb, t2_sd},
      Strides{valid_sb, valid_sd}, Strides{q1_sb, q1_sd},
      Strides{dl_sb, dl_sd}, Strides{dur_sb, dur_sd}, big);
  return static_cast<int>(cudaGetLastError());
}

// Launches the unbatched query over t1, t2 [Dev,T,W] (float) and valid
// (bytes), each with its device stride in elements, with q1, deadline and
// dur by value, into start [Dev] (float) and found [Dev] (int32). Returns
// as window_query_batched_launch does.
int window_query_launch(const void* t1, const void* t2, const void* valid,
                        void* start, void* found, int n_dev, int tw,
                        long long t1_sd, long long t2_sd, long long valid_sd,
                        float q1, float dl, float dur, float big, int grid_x,
                        void* stream) {
  if (grid_x != grid_for(n_dev)) return -2;
  if (n_dev == 0) return 0;
  const Strides none{0, 0};
  window_query_kernel<false><<<grid_x, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t1), static_cast<const float*>(t2),
      static_cast<const uint8_t*>(valid), nullptr, nullptr, nullptr, q1, dl,
      dur, static_cast<float*>(start), static_cast<int32_t*>(found), n_dev,
      n_dev, tw, Strides{0, t1_sd}, Strides{0, t2_sd}, Strides{0, valid_sd},
      none, none, none, big);
  return static_cast<int>(cudaGetLastError());
}

const char* window_query_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
