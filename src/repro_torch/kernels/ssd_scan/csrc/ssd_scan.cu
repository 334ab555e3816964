// Mamba-2 SSD scan (chunked block form), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_scan
// (Pallas body _ssd_kernel). It computes the function of the plain version
// kernels/ssd_scan/ref.py::ssd_scan_ref, the recurrence
//
//   h_t = exp(dt_t * A_h) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t . h_t
//
// for each batch row b and head h, with x, y [B,S,H,P], dt [B,S,H] float,
// A [H] float, B, C [B,S,N] (x, B, C and y float or bf16) and the state
// h [P,N] in f32 from 0. Like the Pallas kernel it takes the sequence in
// chunks and computes, per chunk of Q rows with L = cumsum(dt * A):
//
//   G = C B^T;  W[t,s] = G[t,s] * exp(L_t - L_s) * dt_s  (s <= t, else 0)
//   y = W x + exp(L) * (C h^T)
//   h <- exp(L_last) h + sum_s exp(L_last - L_s) dt_s x_s B_s^T
//
// The decomposition is exact at any chunk length; only rounding differs
// from the step-by-step recurrence.
//
// Design: one block of 256 threads per (b, head) walks the chunks in order;
// the TPU kernel's sequential chunk grid axis, whose state lived in VMEM
// scratch, becomes this loop, and h stays in shared memory (16 KB at
// P = N = 64). The chunk is 64 rows (not the model's 256): the f32 tiles of
// a 64-row chunk (x, B, C, W and h, 82 KB at P = N = 64) fit in shared
// memory together. Each of the four products is a 64-deep contraction into
// a tile of at most 64 x 64, which the 16 x 16 threads compute as 4 x 4
// register blocks (rows ty + 16 i, columns tx + 16 j); rows of the tiles
// read across lanes are padded by one float so the lanes hit distinct
// banks. The cumulative sum L and the decays run on one thread (64 adds).
// Rows past S load as zero (dt = 0 adds nothing to L, h or y) and are not
// stored. At zamba2's B = 1, H = 112 that is 112 blocks, one wave.
//
// Arithmetic is f32 on the CUDA cores (fmaf products, accurate expf); the
// library is built with -O3 --fmad=false (kernels/_build.py). Tensor cores
// (wgmma) are later work.
//
// Bound on the H100: at zamba2's B 1, S 4096, H 112, P 64, N 64, bf16, the
// bytes are x and y (58.7 MB each), dt (1.8 MB), B and C (1.0 MB): 120 MB,
// 36 us at 3.35 TB/s. The products of the chunked form at 64-row chunks
// (the causal half of G and W x, all of C h and of the state update) are
// 11.3 GFLOP: 11 us at the 989 TFLOP/s bf16 rate. So the bytes bound it;
// this version, on the CUDA cores with one block an SM, is bound by its
// f32 products out of shared memory instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;            // rows a chunk
constexpr int kTX = 16;           // thread columns
constexpr int kTY = 16;           // thread rows
constexpr int kThreads = kTX * kTY;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[i][j] += sum_k A(ty + 16 i, k) * B(k, tx + 16 j), where
// A(r, k) = a[r * a_r + k * a_k] and B(k, c) = b[k * b_k + c * b_c].
template <int RM, int RN, int DEPTH>
__device__ __forceinline__ void tile_mm(float (&acc)[RM][RN],
                                        const float* a, int a_r, int a_k,
                                        const float* b, int b_k, int b_c,
                                        int tx, int ty) {
#pragma unroll 8
  for (int k = 0; k < DEPTH; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty + kTY * i) * a_r + k * a_k];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = b[k * b_k + (tx + kTX * j) * b_c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
}

template <int P, int N>
constexpr size_t smem_floats() {
  return size_t(kQ) * P + 2 * size_t(kQ) * (N + 1) + size_t(kQ) * (kQ + 1) +
         size_t(P) * (N + 1) + 3 * kQ;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, int S, int H) {
  static_assert(P % kTX == 0 && N % kTX == 0, "P and N: multiples of 16");
  constexpr int XS = P;            // row strides of the shared tiles
  constexpr int BS = N + 1;
  constexpr int WS = kQ + 1;
  constexpr int HS = N + 1;
  extern __shared__ float smem[];
  float* sX = smem;                // [kQ][XS]   x of the chunk
  float* sB = sX + kQ * XS;        // [kQ][BS]   B, then decay-weighted B
  float* sC = sB + kQ * BS;        // [kQ][BS]   C
  float* sW = sC + kQ * BS;        // [kQ][WS]   W
  float* sH = sW + kQ * WS;        // [P][HS]    the state h
  float* sDt = sH + P * HS;        // [kQ]
  float* sL = sDt + kQ;            // [kQ]       L = cumsum(dt * A)
  float* sDec = sL + kQ;           // [kQ]       exp(L_last - L_s) * dt_s

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];

  for (int i = tid; i < P * HS; i += kThreads) sH[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int qn = min(kQ, S - t0);
    __syncthreads();   // the last chunk's readers are done
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, c = i % P;
      sX[r * XS + c] =
          r < qn ? to_f32(x[(((long long)b * S + t0 + r) * H + h) * P + c])
                 : 0.0f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, c = i % N;
      const long long off = ((long long)b * S + t0 + r) * N + c;
      sB[r * BS + c] = r < qn ? to_f32(Bm[off]) : 0.0f;
      sC[r * BS + c] = r < qn ? to_f32(Cm[off]) : 0.0f;
    }
    for (int r = tid; r < kQ; r += kThreads)
      sDt[r] = r < qn ? dt[((long long)b * S + t0 + r) * H + h] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float L = 0.0f;
      for (int r = 0; r < kQ; ++r) {
        L += sDt[r] * a_h;
        sL[r] = L;
      }
      const float last = sL[qn - 1];
      for (int r = 0; r < kQ; ++r) sDec[r] = expf(last - sL[r]) * sDt[r];
    }
    __syncthreads();
    const float L_last = sL[qn - 1];

    // W = (C B^T) * exp(L_t - L_s) * dt_s on s <= t
    {
      float g[kQ / kTY][kQ / kTX];
      zero(g);
      tile_mm<kQ / kTY, kQ / kTX, N>(g, sC, BS, 1, sB, 1, BS, tx, ty);
#pragma unroll
      for (int i = 0; i < kQ / kTY; ++i) {
        const int t = ty + kTY * i;
#pragma unroll
        for (int j = 0; j < kQ / kTX; ++j) {
          const int s = tx + kTX * j;
          sW[t * WS + s] =
              s <= t ? g[i][j] * expf(sL[t] - sL[s]) * sDt[s] : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = W x + exp(L_t) * (C h^T); then B <- decay-weighted B
    {
      float yi[kQ / kTY][P / kTX], ye[kQ / kTY][P / kTX];
      zero(yi);
      zero(ye);
      tile_mm<kQ / kTY, P / kTX, kQ>(yi, sW, WS, 1, sX, XS, 1, tx, ty);
      tile_mm<kQ / kTY, P / kTX, N>(ye, sC, BS, 1, sH, 1, HS, tx, ty);
#pragma unroll
      for (int i = 0; i < kQ / kTY; ++i) {
        const int t = ty + kTY * i;
        if (t >= qn) continue;
        const float e = expf(sL[t]);
        T* row = y + (((long long)b * S + t0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < P / kTX; ++j)
          store(row + tx + kTX * j, yi[i][j] + e * ye[i][j]);
      }
      for (int i = tid; i < kQ * N; i += kThreads) {
        const int r = i / N, c = i % N;
        sB[r * BS + c] = sDec[r] * sB[r * BS + c];
      }
    }
    __syncthreads();

    // h <- exp(L_last) h + x^T (decay-weighted B)
    {
      float dh[P / kTY][N / kTX];
      zero(dh);
      tile_mm<P / kTY, N / kTX, kQ>(dh, sX, 1, XS, sB, BS, 1, tx, ty);
      const float e = expf(L_last);
#pragma unroll
      for (int i = 0; i < P / kTY; ++i)
#pragma unroll
        for (int j = 0; j < N / kTX; ++j) {
          float* hp = sH + (ty + kTY * i) * HS + tx + kTX * j;
          *hp = e * *hp + dh[i][j];
        }
    }
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H,
           cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, P, N>;
  constexpr size_t smem = sizeof(float) * smem_floats<P, N>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pn(int P, int N, const void* x, const float* dt, const float* A,
              const void* Bm, const void* Cm, void* y, int B, int S, int H,
              cudaStream_t stream) {
  if (P == 64 && N == 64)
    return launch<T, 64, 64>(x, dt, A, Bm, Cm, y, B, S, H, stream);
  return -1;
}

}  // namespace

extern "C" {

// Launches one SSD scan of x [B,S,H,P], dt [B,S,H] (float), A [H] (float),
// B, C [B,S,N] into y [B,S,H,P], on `stream`. is_bf16: 0 for float, 1 for
// bf16 (x, B, C and y). Returns the cudaGetLastError() code of the launch
// (0 on success), -1 for a (P, N) this file was not instantiated for, or -2
// if (grid_x, grid_y), the wrapper's grid, is not the one this file's
// tiling needs.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int B, int S,
                    int H, int P, int N, int is_bf16, int grid_x, int grid_y,
                    void* stream) {
  if (grid_x != H || grid_y != B) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  if (is_bf16)
    return launch_pn<__nv_bfloat16>(P, N, x, d, a, Bm, Cm, y, B, S, H, st);
  return launch_pn<float>(P, N, x, d, a, Bm, Cm, y, B, S, H, st);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
