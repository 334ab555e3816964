// Flash-decode attention: one query token against a long KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py::
// flash_decode (Pallas body _decode_kernel). It computes what the plain
// version kernels/flash_decode/ref.py::decode_attention_ref computes, for
// each batch row b and query head hq (kv head hq / G, G = H / K):
//
//   s_j = (q . k_j) * scale, then tanh(s_j / softcap) * softcap if softcap > 0;
//   key j is visible iff j <= pos[b] and, when window > 0,
//   pos[b] - j < window; a masked key scores NEG_INF (-1e30), so it adds 0;
//   out = softmax(s) v, with f32 accumulation, written in q's type.
//
// q and out are [B,H,hd]; the caches are [B,S,K,hd], the decode state's own
// layout, so nothing is transposed on the way in (the reference's TPU branch
// transposes the whole cache to [B,K,S,hd] on every call). All contiguous;
// element type float or bf16; hd in {32, 64, 112, 128, 256}.
//
// Design: one block of 8 warps per (b, kv head), with the [G, hd] query
// group resident in shared memory as f32. The TPU kernel's sequential cache
// grid axis, with its online-softmax m, l and acc in VMEM scratch, becomes a
// loop over groups of 32 keys: warp w takes groups w, w + 8, ..., keeping
// its own m, l (shared memory) and acc (registers, stored in shared memory
// between groups) for each query of the group; the 8 partial softmaxes are
// merged at the end. Only the keys in [pos - window + 1, pos] (or [0, pos])
// are visited: a masked key adds exactly 0, so skipping it gives the same
// function with fewer bytes, at any S and any window. Within a group, lane
// d-columns read each key row coalesced (lane + 32 i), 8 rows in flight a
// time; the dot product is summed across lanes with shuffles and lane j
// keeps key j's score; p_j is shuffled back for the p v update.
//
// Arithmetic is f32 on the CUDA cores (fmaf, accurate expf and tanhf); the
// library is built with -O3 --fmad=false (kernels/_build.py).
//
// Bound on the H100: decode reads the visible part of the cache once. At
// zamba2's B 4, K = H = 32, hd 112, bf16, pos near 32768 that is 1.88 GB
// of k and v: 561 us at 3.35 TB/s; its 4 * hd FLOPs a key and head are
// 2 orders below the bf16 rate. With one block an SM (128 blocks) and 8 rows
// a warp in flight this version is expected to reach part of that rate; a
// split of the keys over more blocks plus a combine pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;            // key rows loaded together
constexpr float kNegInf = -1e30f;   // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// [G][hd] query group, [kWarps][G][hd] accumulators, [kWarps][G] m and l;
// kernels/flash_decode/flash_decode.py::smem_bytes mirrors it.
inline size_t smem_bytes(int G, int hd) {
  return sizeof(float) * (size_t(G) * hd * (1 + kWarps) + 2 * kWarps * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, T* __restrict__ o, int S, int K, int G,
    int window, float scale, float softcap) {
  constexpr int kPer = (HD + 31) / 32;   // columns a lane
  extern __shared__ float smem[];
  float* sQ = smem;                      // [G][HD]
  float* sAcc = sQ + G * HD;             // [kWarps][G][HD]
  float* sM = sAcc + kWarps * G * HD;    // [kWarps][G]
  float* sL = sM + kWarps * G;           // [kWarps][G]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int H = K * G;
  const long long q_base = ((long long)b * H + (long long)kh * G) * HD;

  for (int i = tid; i < G * HD; i += kThreads) sQ[i] = to_f32(q[q_base + i]);
  for (int i = tid; i < kWarps * G * HD; i += kThreads) sAcc[i] = 0.0f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }
  __syncthreads();

  const int p = pos[b];
  const int k_hi = min(p, S - 1);
  const int k_lo = window > 0 ? max(0, p - window + 1) : 0;
  const int n_keys = k_hi - k_lo + 1;
  const int n_groups = n_keys > 0 ? (n_keys + 31) / 32 : 0;
  const long long row_stride = (long long)K * HD;
  const T* k_base = k + ((long long)b * S * K + kh) * HD;
  const T* v_base = v + ((long long)b * S * K + kh) * HD;

  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int j0 = k_lo + grp * 32;
    const bool lane_ok = j0 + lane <= k_hi;
    for (int g = 0; g < G; ++g) {
      const float* qg = sQ + g * HD;
      // scores: lane j keeps key j0 + j's
      float s_mine = kNegInf;
      for (int jb = 0; jb < 32; jb += kRows) {
        float kr[kRows][kPer];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int key = j0 + jb + u;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int d = lane + 32 * i;
            kr[u][i] = key <= k_hi && d < HD
                           ? to_f32(k_base[key * row_stride + d]) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int d = lane + 32 * i;
            if (d < HD) part = fmaf(qg[d], kr[u][i], part);
          }
          float s = warp_sum(part) * scale;
          if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
          if (lane == jb + u) s_mine = s;
        }
      }
      // online softmax over the group's visible keys
      const float sm = lane_ok ? s_mine : kNegInf;
      const float m_old = sM[warp * G + g];
      const float l_old = sL[warp * G + g];
      const float m_new = fmaxf(m_old, warp_max(sm));
      const float alpha = expf(m_old - m_new);
      const float pr = lane_ok ? expf(sm - m_new) : 0.0f;
      const float l_new = alpha * l_old + warp_sum(pr);
      __syncwarp();
      if (lane == 0) {
        sM[warp * G + g] = m_new;
        sL[warp * G + g] = l_new;
      }
      __syncwarp();
      // acc <- alpha * acc + sum_j p_j v_j
      float* acc_s = sAcc + (warp * G + g) * HD;
      float acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        acc[i] = d < HD ? acc_s[d] * alpha : 0.0f;
      }
      for (int jb = 0; jb < 32; jb += kRows) {
        float vr[kRows][kPer];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int key = j0 + jb + u;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int d = lane + 32 * i;
            vr[u][i] = key <= k_hi && d < HD
                           ? to_f32(v_base[key * row_stride + d]) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const float pj = __shfl_sync(kFull, pr, jb + u);
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, vr[u][i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc_s[d] = acc[i];
      }
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sM[w * G + g]);
    float l = 0.0f, acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sM[w * G + g] - m);
      l += e * sL[w * G + g];
      acc += e * sAcc[w * G * HD + i];
    }
    store(o + q_base + i, acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int S, int K, int G, int window, float scale,
           float softcap, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, HD>;
  const size_t smem = smem_bytes(G, HD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), S, K, G, window,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* pos, void* o, int B, int S, int K, int G, int window,
              float scale, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, pos, o, B, S, K, G, window, scale,
                           softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, o, B, S, K, G, window, scale,
                           softcap, stream);
    case 112:
      return launch<T, 112>(q, k, v, pos, o, B, S, K, G, window, scale,
                            softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, o, B, S, K, G, window, scale,
                            softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, o, B, S, K, G, window, scale,
                            softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Launches one decode attention of q [B,H,hd] (H = K * G) against the
// caches k, v [B,S,K,hd] up to pos [B] (int32) into o [B,H,hd], on
// `stream`. is_bf16: 0 for float, 1 for bf16. Returns the
// cudaGetLastError() code of the launch (0 on success), -1 for an hd this
// file was not instantiated for, or -2 if (grid_x, grid_y), the wrapper's
// grid, is not the one this file's tiling needs.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* pos, void* o, int B, int S, int K, int G,
                        int hd, int is_bf16, int window, float scale,
                        float softcap, int grid_x, int grid_y, void* stream) {
  if (grid_x != K || grid_y != B) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, p, o, B, S, K, G, window,
                                    scale, softcap, st);
  return launch_hd<float>(hd, q, k, v, p, o, B, S, K, G, window, scale,
                          softcap, st);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
