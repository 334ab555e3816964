// Causal / sliding-window / soft-capped GQA attention (prefill) in f32 on
// the CUDA cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention (Pallas body _attn_kernel) for f32 inputs; bf16 inputs
// take the tensor-core kernel of flash_attention_wgmma.cu. On the tensor
// cores f32 would run as TF32 (a 10-bit mantissa) and miss the f32
// tolerance (2e-5), so f32 stays here; no model path runs f32 attention on
// the card. It computes what the plain version
// kernels/flash_attention/ref.py::attention_ref computes:
//
//   s   = (q . k) * scale (hd^-0.5 unless the caller gives another), then
//         tanh(s / softcap) * softcap if softcap > 0;
//   s   = NEG_INF (-1e30) where the key is masked: k_pos > q_pos (causal),
//         q_pos - k_pos >= window (window > 0), or k_pos >= Sk (ragged
//         edge);
//   out = softmax(s) v, with f32 accumulation.
//
// q is [B,H,Sq,hd], k and v are [B,K,Sk,hd], all contiguous f32; query head
// h reads kv head h / (H / K); hd in {32, 64, 112, 128, 224, 256}. Query row i
// stands at position q_pos = q_offset + i (0 <= q_offset, q_offset + Sq <=
// Sk), key row j at k_pos = j: a rank that holds the rows [s0, s0 + Sq) of
// a sequence-sharded q passes q_offset = s0 and every key. Without an
// offset Sq = Sk = S.
//
// Design: one block of 256 threads per (b, h, tile of 64 query rows). The
// TPU kernel's sequential k grid axis, whose running max m, normaliser l and
// accumulator acc lived in VMEM scratch, becomes a loop over tiles of 64 keys
// inside the block; m, l and acc live in registers. Only the key tiles that
// the causal and window masks leave partly visible are visited. The block's
// q tile and each k and v tile are staged in shared memory (rows of q and k
// padded by one float, so the 16 lanes that read 16 key rows hit 16 banks);
// a thread holds a 4 x 4 block of the 64 x 64 score tile and a 4 x hd/16
// block of acc. Row max and row sum are reduced across the 16 lanes of a row
// with warp shuffles; p goes through shared memory to the PV product. A
// masked score contributes p = 0, so a row with no visible key in a tile
// leaves its m, l and acc as they were. The final division uses
// max(l, 1e-30), as the reference does. At hd=256 the tiles take 213,760
// bytes of dynamic shared memory (over 48 KB, so the launch raises the
// limit with cudaFuncAttributeMaxDynamicSharedMemorySize). The ragged
// edges are masked in the kernel: key rows past Sk load as zero and are
// masked, query rows past Sq are not stored.
//
// Arithmetic is f32 on the CUDA cores: the dot products are explicit fmaf,
// expf and tanhf are the accurate libdevice versions. The library is built
// with the same flags as every kernel of the port (kernels/_build.py:
// -O3 --fmad=false, never --use_fast_math); --fmad=false only stops the
// compiler from contracting the few separate multiplies and adds of the
// softmax update, which the reference rounds separately too.
//
// Bound on the H100: 4 * hd * (visible score entries) * B * H FLOPs at the
// 67 TFLOP/s f32 rate of the CUDA cores; at the small shapes the f32 checks
// use (S <= 300) the launch latency bounds it. Measured by chip_smoke.py:
// PERF.md section 6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // key rows per tile
constexpr int kTX = 16;             // lanes across a row of the score tile
constexpr int kTY = 16;             // thread rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;    // query rows per thread
constexpr int kCols = kBK / kTX;    // keys per thread in a tile
constexpr float kNegInf = -1e30f;   // NEG_INF of the reference

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (HD + 1) + size_t(kBK) * (HD + 1) + size_t(kBK) * HD +
          size_t(kBQ) * (kBK + 1));
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int group, int Sq, int Sk, int q_offset,
    int causal, int window, float scale, float softcap) {
  constexpr int QS = HD + 1;        // padded row stride of the q and k tiles
  constexpr int PS = kBK + 1;       // padded row stride of the p tile
  constexpr int kDims = HD / kTX;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [kBQ][QS]
  float* sK = sQ + kBQ * QS;        // [kBK][QS]
  float* sV = sK + kBK * QS;        // [kBK][HD]
  float* sP = sV + kBK * HD;        // [kBQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  // the block's first local row, longest rows first
  const int q0 = (n_qt - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long q_base = ((long long)b * H + h) * Sq * HD;
  const long long kv_base =
      ((long long)b * (H / group) + h / group) * Sk * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int row = q0 + r;
    sQ[r * QS + c] =
        row < Sq ? q[q_base + (long long)row * HD + c] : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[i][d] = 0.0f;
  }

  // key tiles with at least one visible entry for some row of this block
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? q_offset + q_last + 1 : Sk;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt_end = (k_end + kBK - 1) / kBK;

  for (int kt = k_begin / kBK; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // q is stored; the last tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const int kpos = k0 + r;
      const long long off = kv_base + (long long)kpos * HD + c;
      sK[r * QS + c] = kpos < Sk ? k[off] : 0.0f;
      sV[r * HD + c] = kpos < Sk ? v[off] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + kTY * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + kTX * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      const int qpos = q_offset + q0 + r;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        s[i][j] = visible(qpos, k0 + tx + kTX * j, Sk, causal, window)
                      ? x : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        const float p = visible(qpos, kpos, Sk, causal, window)
                            ? expf(s[i][j] - m_new) : 0.0f;
        sP[r * PS + tx + kTX * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kDims; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + kTY * i) * PS + kk];
#pragma unroll
      for (int d = 0; d < kDims; ++d) vv[d] = sV[kk * HD + tx + kTX * d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int d = 0; d < kDims; ++d)
          acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + q_base + (long long)r * HD;
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      row[tx + kTX * d] = acc[i][d] / denom;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int Sq, int Sk, int q_offset, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, Sq, Sk,
      q_offset, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int H, int K, int Sq, int Sk, int q_offset, int causal,
              int window, float scale, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                           window, scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                           window, scale, softcap, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                            window, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                            window, scale, softcap, stream);
    case 224:
      return launch<T, 224>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                            window, scale, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                            window, scale, softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Launches one f32 attention of q [B,H,Sq,hd], its rows at positions
// q_offset .. q_offset + Sq - 1, over k and v [B,K,Sk,hd] into o
// [B,H,Sq,hd], on `stream`. Returns the cudaGetLastError() code of the
// launch (0 on success), -1 for an hd this file was not instantiated for,
// or -2 if (grid_x, grid_y, grid_z), the wrapper's grid, is not the one this
// file's tiling needs.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int K, int Sq, int Sk,
                           int q_offset, int hd, int causal, int window,
                           float scale, float softcap, int grid_x,
                           int grid_y, int grid_z, void* stream) {
  if (grid_x != (Sq + kBQ - 1) / kBQ || grid_y != H || grid_z != B)
    return -2;
  return launch_hd<float>(hd, q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                          window, scale, softcap,
                          static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
