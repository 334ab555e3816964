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
// or bf16) and A [di,N] in float. y is written in u's type. Like the Pallas
// kernel, exp(dt*A) is computed at every step: the [S,di,N] decay tensor is
// never stored.
//
// Bound on the H100 SXM (data sheet, 700 W; chip_smoke.py::ssm_terms): at
// falcon-mamba's B 1, S 4096, di 8192, N 16, bf16, the bytes (u, dt, y,
// B, C) take 60 us at 3.35 TB/s; 4 f32 instructions a state element a step
// (dt * A, du * B and two fmaf; half the 67 TFLOP/s rate, an instruction
// each) and dt * u a channel step 65 us; and each of the 537 M state
// elements a step needs one exp, one ex2 on the special-function units
// (16 a clock on each of 132 SMs): 128 us at the 1.98 GHz boost clock.
// The exps bind it.
//
// Design, to keep the special-function units fed:
// - Lanes over the state: kLanes = 8 lanes a channel, 2 states each, so at
//   B 1, di 8192 there are 65,536 threads in place of 8192 (one a channel:
//   two warps an SM). A block is 128 threads, 16 channels: 512 blocks,
//   about 16 warps an SM, 62 registers. 8 lanes were the fastest of 2, 4,
//   8 and 16 at falcon-mamba's shape on an NVIDIA H100 80GB HBM3 at 700 W:
//   604, 394, 298 and 395 us a launch (PERF.md section 6). Two lanes leave
//   four warps an SM; sixteen spend their issue slots on the reduction.
// - The exp is exp2 of dt * (A * log2 e), one ex2.approx.ftz (relative
//   error ~2^-22; A * log2 e is rounded once a state, at the start).
//   h = fmaf(e, h, du * B) and y += fmaf(h, C): explicit fmaf, so two f32
//   instructions fewer an element a step than with every product rounded;
//   the scans stay within chip_smoke.py's rule (1e-4 of the largest |y| in
//   f32, one bf16 ulp of it in bf16).
// - y_t: each lane sums its states' h * C; the kLanes partial sums of
//   kLanes consecutive steps are reduce-scattered across the channel's
//   lanes (log2 kLanes rounds of xor-shuffles, halving the steps each
//   round), so that lane l ends with the whole y of step l of the group:
//   kLanes - 1 shuffles for kLanes steps in place of kLanes log2 kLanes.
// - Tiles of kT = 64 steps come in by cp.async 16-byte copies (u, dt
//   coalesced across the block's channels; B and C, shared by every
//   channel) into a 2-stage ring: tile k + 1 is in flight while tile k
//   runs. A conversion pass turns a landed tile into f32 once for the
//   block, not once a lane: dt and du = dt * u channel-major, so a lane
//   reads a group's steps in 16-byte loads, and B, C interleaved. y goes
//   out through shared memory in 16-byte stores a tile later.
// - Rows past S and channels past di load as zero (dt = 0 leaves h as it
//   is) and are not stored. di * sizeof(T) must be a multiple of 16 (the
//   wrapper checks it), so a 16-byte copy never straddles di.
//
// The library is built with -O3 --fmad=false (kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kLanes = 8;       // lanes a channel
constexpr int kCB = kThreads / kLanes;   // channels a block
constexpr int kT = 64;          // time steps a tile
constexpr int kTS = kT + 4;     // row stride of a channel's dt, du
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of a block, in elements of each array.
template <typename T, int N>
struct Smem {
  static constexpr int RAW = 2 * kT * kCB;      // u or dt, both stages
  static constexpr int RAWN = 2 * kT * N;       // B or C, both stages
  static constexpr size_t bytes =
      sizeof(T) * (2 * RAW + 2 * RAWN + kT * kCB) +
      sizeof(float) * (2 * kCB * kTS + 2 * kT * N);
};

// n consecutive floats from shared memory, 16-byte aligned, n % 4 == 0.
template <int n>
__device__ __forceinline__ void lds(float (&v)[n], const float* p) {
  static_assert(n % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, int S, int di) {
  using L = Smem<T, N>;
  constexpr int SL = N / kLanes;                // states a lane
  constexpr int VEC = 16 / sizeof(T);           // elements a 16-byte copy
  static_assert(N % kLanes == 0 && kCB % VEC == 0 && N % VEC == 0,
                "tiling");
  static_assert(kT % kLanes == 0 && kLanes % 4 == 0, "groups");
  extern __shared__ __align__(16) unsigned char smem[];
  T* rawU = reinterpret_cast<T*>(smem);         // [2][kT][kCB]
  T* rawDt = rawU + L::RAW;                     // [2][kT][kCB]
  T* rawB = rawDt + L::RAW;                     // [2][kT][N]
  T* rawC = rawB + L::RAWN;                     // [2][kT][N]
  T* sY = rawC + L::RAWN;                       // [kT][kCB]
  float* fDt = reinterpret_cast<float*>(sY + kT * kCB);  // [kCB][kTS]
  float* fDu = fDt + kCB * kTS;                 // [kCB][kTS]  dt * u
  float* fBC = fDu + kCB * kTS;                 // [kT][N][B, C]

  const int tid = threadIdx.x;
  const int c = tid / kLanes, l = tid % kLanes;  // channel, lane in it
  const int d0 = blockIdx.x * kCB;
  const int d = d0 + c;
  const long long row0 = (long long)blockIdx.y * S;   // first row of b

  float a2[SL], h[SL];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    a2[s] = d < di ? A[(long long)d * N + l * SL + s] * kLog2e : 0.0f;
    h[s] = 0.0f;
  }

  auto load_tile = [&](int t0, int st) {
    constexpr int CH = kCB / VEC;               // 16-byte copies a row
    for (int i = tid; i < kT * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH;
      const bool ok = t0 + r < S && d0 + ch * VEC < di;
      const long long off = ok ? (row0 + t0 + r) * di + d0 + ch * VEC : 0;
      const int o = (st * kT + r) * kCB + ch * VEC;
      cp_async16(rawU + o, u + off, ok);
      cp_async16(rawDt + o, dt + off, ok);
    }
    constexpr int CHN = N / VEC;
    for (int i = tid; i < kT * CHN; i += kThreads) {
      const int r = i / CHN, ch = i % CHN;
      const bool ok = t0 + r < S;
      const long long off = ok ? (row0 + t0 + r) * N + ch * VEC : 0;
      const int o = (st * kT + r) * N + ch * VEC;
      cp_async16(rawB + o, Bm + off, ok);
      cp_async16(rawC + o, Cm + off, ok);
    }
    cp_async_commit();
  };
  auto store_y = [&](int t0) {
    constexpr int CH = kCB / VEC;
    for (int i = tid; i < kT * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH;
      if (t0 + r < S && d0 + ch * VEC < di)
        *reinterpret_cast<uint4*>(y + (row0 + t0 + r) * di + d0 + ch * VEC) =
            *reinterpret_cast<const uint4*>(sY + r * kCB + ch * VEC);
    }
  };

  const int ntiles = (S + kT - 1) / kT;
  load_tile(0, 0);
  for (int k = 0; k < ntiles; ++k) {
    const int st = k & 1;
    // stage st ^ 1 was last read by the conversion pass of tile k - 1,
    // which every thread finished before that tile's second barrier
    if (k + 1 < ntiles) {
      load_tile((k + 1) * kT, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile k landed; tile k - 1's compute wrote sY
    if (k > 0) store_y((k - 1) * kT);
    for (int i = tid; i < kT * kCB; i += kThreads) {
      const int r = i / kCB, cc = i % kCB;
      const float dv = to_f32(rawDt[st * kT * kCB + i]);
      fDt[cc * kTS + r] = dv;
      fDu[cc * kTS + r] = dv * to_f32(rawU[st * kT * kCB + i]);
    }
    for (int i = tid; i < kT * N; i += kThreads)
      reinterpret_cast<float2*>(fBC)[i] = make_float2(
          to_f32(rawB[st * kT * N + i]), to_f32(rawC[st * kT * N + i]));
    __syncthreads();   // f32 tile ready; sY read out

#pragma unroll 1
    for (int g0 = 0; g0 < kT; g0 += kLanes) {
      float dts[kLanes], dus[kLanes], part[kLanes];
      lds(dts, fDt + c * kTS + g0);
      lds(dus, fDu + c * kTS + g0);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        float bc[2 * SL];
        lds(bc, fBC + ((g0 + j) * N + l * SL) * 2);
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          h[s] = fmaf(ex2(dts[j] * a2[s]), h[s], dus[j] * bc[2 * s]);
          acc = fmaf(h[s], bc[2 * s + 1], acc);
        }
        part[j] = acc;
      }
      // reduce-scatter: after the round of width w, lanes with bit w set
      // hold the upper half of the steps, summed over the pair
#pragma unroll
      for (int round = 1; round < kLanes; round *= 2) {
        const int w = kLanes / (2 * round);
        const bool upper = (l & w) != 0;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = upper ? part[i] : part[i + w];
          const float keep = upper ? part[i + w] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      store(sY + (g0 + l) * kCB + c, part[0]);
    }
  }
  __syncthreads();
  store_y((ntiles - 1) * kT);
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int di,
           cudaStream_t stream) {
  auto kernel = ssm_scan_kernel<T, N>;
  constexpr size_t smem = Smem<T, N>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((di + kCB - 1) / kCB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
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
// [B,S,N] into y [B,S,di], on `stream`. is_bf16: 0 for float, 1 for
// bf16 (u, dt, B, C and y). Returns the cudaGetLastError() code of the
// launch (0 on success), -1 for an N this file was not instantiated for,
// or -2 if (grid_x, grid_y), the wrapper's grid, is not the one this
// file's tiling needs.
int ssm_scan_launch(const void* u, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int B, int S,
                    int di, int N, int is_bf16, int grid_x, int grid_y,
                    void* stream) {
  if (grid_x != (di + kCB - 1) / kCB || grid_y != B) return -2;
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
