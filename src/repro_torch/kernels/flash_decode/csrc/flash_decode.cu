// Flash-decode attention: one query token against a long KV cache, for
// Hopper (sm_90a), as a split pass over the cache and a combine pass.
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py::
// flash_decode (Pallas body _decode_kernel). It computes what the plain
// version kernels/flash_decode/ref.py::decode_attention_ref computes, for
// each batch row b and query head hq (kv head hq / G, G = H / K):
//
//   s_j = (q . k_j) * scale, then tanh(s_j / softcap) * softcap if softcap > 0;
//   key j is visible iff j <= pos[b] and, when window > 0,
//   pos[b] - j < window; a masked key adds exactly 0;
//   out = softmax(s) v, with f32 accumulation, written in q's type.
//
// q and out are [B,H,hd]; the caches are [B,S,K,hd], the decode state's own
// layout, so nothing is transposed on the way in (the reference's TPU branch
// transposes the whole cache to [B,K,S,hd] on every call). All contiguous;
// element type float or bf16; hd in {32, 64, 112, 128, 256}; G <= kMaxGroup.
//
// Bound on the H100: decode reads the visible part of the cache once. At
// zamba2's B 4, K = H = 32, hd 112, bf16, pos near 32768 that is 1.88 GB
// of k and v, 561 us at 3.35 TB/s; its 4 * hd FLOPs a key and head are two
// orders below the bf16 rate. What bounds it is how many bytes are in
// flight and how well the reads keep to DRAM pages; the design below keeps
// both high. Earlier designs' times: PERF.md section 6.
//
// Design:
// - Split pass, grid (n_split, ceil(K / 4), B), n_split = ceil(S / chunk):
//   a block of 4 warps takes one chunk of `chunk` keys (512-2048, the
//   wrapper's chunk_size) of one batch row for 4 adjacent kv heads, a warp
//   each with all G query heads of its kv head. The cache is [B,S,K,hd], so
//   the 4 warps' rows of a key lie side by side (896 contiguous bytes at
//   zamba2's hd 112, where one head's rows are 224 bytes, 7 KB apart): the
//   block's reads keep to DRAM pages. A
//   warp reads only its chunk's visible keys (a chunk wholly outside
//   [max(0, pos - window + 1), pos] writes an empty partial, m = -1e30,
//   l = 0, acc = 0), in sub-tiles of TILE keys through its own ring of
//   kStages stages in shared memory filled by cp.async 16-byte copies (keys
//   past its range zero-filled), so only __syncwarp orders a stage. At
//   zamba2's shape: 512 blocks of 2048 keys, two resident an SM with two
//   sub-tiles of k and v in flight a warp, about 115 KB in flight an SM.
// - In a warp, lanes own 16-byte vectors of a row (VL lanes across the
//   row, KP groups of lanes over the keys): a score is the lanes' partial
//   dot products summed by xor-shuffles (the same sum, bit for bit, in every
//   lane of the group), and the p v update reads v with the same lanes. Each
//   lane group keeps its own online softmax (m, l, acc[G][its vectors]) in
//   registers; the groups merge by shuffles, and the warp writes its
//   partial (m, l, acc[G, hd]) in f32 to a workspace the wrapper allocates.
// - Combine pass, grid (K, B): a block weighs each partial by exp(m - max
//   m) (an empty one weighs 0), sums them in chunk order in 4 groups of
//   contiguous chunks added in group order (deterministic), divides by
//   max(l, 1e-30) as the reference does, and writes the G output heads in
//   q's type.
// - The chunk size, so n_split, follows from the shapes, which the host
//   knows, never from pos, which lies on the device: the wrapper never
//   waits for the card.
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): PERF.md.
//
// Arithmetic is f32 (fmaf, accurate expf and tanhf); the library is built
// with -O3 --fmad=false (kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;                     // a warp's ring depth
constexpr int kMaxGroup = 8;                   // query heads a kv head
constexpr int kCombineGroups = 4;             // a combine block's groups
constexpr int kCombineThreads = 64 * kCombineGroups;
constexpr float kNegInf = -1e30f;              // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// Geometry of a split block for element type T and head dim HD.
template <typename T, int HD>
struct Split {
  static constexpr int VEC = 16 / sizeof(T);            // elements a vector
  static constexpr int NV = HD / VEC;                   // vectors a row
  static constexpr int ROWB = HD * sizeof(T);           // bytes a row
  static constexpr int VL = NV > 16 ? 32 : NV > 8 ? 16 : NV > 4 ? 8 : 4;
  static constexpr int KP = 32 / VL;                    // key groups a warp
  static constexpr int VPL = (NV + 31) / 32;            // vectors a lane
  static constexpr int TILE = ROWB <= 256 ? 16 : ROWB <= 512 ? 8 : 4;
  static constexpr int STAGE = 2 * TILE * ROWB;         // k and v rows
  static constexpr int RING = kWarps * kStages * STAGE;
};

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int S, int K, int G, int chunk, int window,
    float scale, float softcap) {
  using L = Split<T, HD>;
  constexpr int VEC = L::VEC, NV = L::NV, VL = L::VL, KP = L::KP;
  constexpr int VPL = L::VPL, TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem[];   // the warps' rings

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y * kWarps + warp;   // a warp a kv head
  if (kh >= K) return;
  const int n_split = gridDim.x;
  const long long part = ((long long)(b * K + kh) * n_split + split) * G;

  // the chunk's visible keys [c_lo, c_hi]
  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int c_lo = max(lo, split * chunk);
  const int c_hi = min(hi, split * chunk + chunk - 1);
  if (c_lo > c_hi) {   // an empty partial: m = -1e30, l = 0, acc = 0
    for (int g = lane; g < G; g += 32) {
      part_ml[(part + g) * 2] = kNegInf;
      part_ml[(part + g) * 2 + 1] = 0.0f;
    }
    for (int i = lane; i < G * HD; i += 32) part_acc[part * HD + i] = 0.0f;
    return;
  }
  const int n_sub = (c_hi - c_lo + TILE) / TILE;

  const int kp = lane / VL;            // this lane's key group
  const int vl = lane % VL;            // and its first vector of a row
  const long long row_stride = (long long)K * HD;
  const T* k_base = k + ((long long)b * S * K + kh) * HD;
  const T* v_base = v + ((long long)b * S * K + kh) * HD;
  uint8_t* ring = smem + warp * kStages * L::STAGE;

  auto issue = [&](int sub) {
    uint8_t* st = ring + (sub % kStages) * L::STAGE;
    const int j0 = c_lo + sub * TILE;
    for (int i = lane; i < TILE * NV; i += 32) {
      const int r = i / NV, c = i % NV;
      const int key = j0 + r;
      const bool ok = key <= c_hi;
      const long long off = ok ? key * row_stride + c * VEC : 0;
      cp_async16(st + r * L::ROWB + c * 16, k_base + off, ok);
      cp_async16(st + TILE * L::ROWB + r * L::ROWB + c * 16, v_base + off,
                 ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_sub) issue(s);
    cp_async_commit();
  }
  // the lane's vectors of each query head, in f32
  float qv[GMAX][VPL][VEC];
  const T* q_base = q + ((long long)b * K * G + (long long)kh * G) * HD;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int vec = vl + 32 * u;
      if (g < G && vec < NV) {
        load_vec(q_base + g * HD + vec * VEC, qv[g][u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[g][u][e] = 0.0f;
      }
    }

  float m[GMAX], l[GMAX], acc[GMAX][VPL][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int u = 0; u < VPL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][u][e] = 0.0f;
  }

  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + kStages - 1 < n_sub) issue(sub + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint8_t* sk = ring + (sub % kStages) * L::STAGE;
    const uint8_t* sv = sk + TILE * L::ROWB;
    const int j0 = c_lo + sub * TILE;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;   // (not break: keeps the loop unrolled)
      // scores of this lane group's keys t * KP + kp
      float sc[TILE / KP];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < TILE / KP; ++t) {
        const int j = t * KP + kp;
        float part_dot = 0.0f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vec = vl + 32 * u;
          if (vec < NV) {
            float kr[VEC];
            load_vec(reinterpret_cast<const T*>(sk + j * L::ROWB) + vec * VEC,
                     kr);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part_dot = fmaf(qv[g][u][e], kr[e], part_dot);
          }
        }
#pragma unroll
        for (int off = 1; off < VL; off <<= 1)
          part_dot += __shfl_xor_sync(kFull, part_dot, off);
        float x = part_dot * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        sc[t] = j0 + j <= c_hi ? x : kNegInf;
        mx = fmaxf(mx, sc[t]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][u][e] *= alpha;
#pragma unroll
      for (int t = 0; t < TILE / KP; ++t) {
        const int j = t * KP + kp;
        if (j0 + j > c_hi) continue;
        const float pj = expf(sc[t] - m_new);
        l[g] += pj;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vec = vl + 32 * u;
          if (vec < NV) {
            float vr[VEC];
            load_vec(reinterpret_cast<const T*>(sv + j * L::ROWB) + vec * VEC,
                     vr);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[g][u][e] = fmaf(pj, vr[e], acc[g][u][e]);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // merge the warp's key groups (lanes kp * VL + vl) into its partial
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int off = VL; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(kFull, m[g], off);
      const float l_o = __shfl_xor_sync(kFull, l[g], off);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), c = expf(m_o - m_new);
      l[g] = a * l[g] + c * l_o;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float o = __shfl_xor_sync(kFull, acc[g][u][e], off);
          acc[g][u][e] = a * acc[g][u][e] + c * o;
        }
      m[g] = m_new;
    }
    if (lane == 0) {
      part_ml[(part + g) * 2] = m[g];
      part_ml[(part + g) * 2 + 1] = l[g];
    }
    if (kp == 0) {
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int vec = vl + 32 * u;
        if (vec < NV) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part_acc[(part + g) * HD + vec * VEC + e] = acc[g][u][e];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) flash_decode_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ o, int K, int G, int hd, int n_split) {
  // [n_split][G] weights, [G] maxima, [G] normalisers, then
  // [kCombineGroups][G][hd] group sums
  extern __shared__ float sw[];
  float* s_max = sw + n_split * G;
  float* s_l = s_max + G;
  float* s_sum = s_l + G;
  const int kh = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)(b * K + kh) * n_split * G;
  const float* ml = part_ml + base * 2;
  for (int g = threadIdx.x; g < G; g += kCombineThreads) {
    float mm = kNegInf;
    for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[(s * G + g) * 2]);
    s_max[g] = mm;
  }
  __syncthreads();
  // an empty partial (m = -1e30, l = 0, acc = 0) weighs 0 beside any other
  for (int i = threadIdx.x; i < n_split * G; i += kCombineThreads)
    sw[i] = expf(ml[i * 2] - s_max[i % G]);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kCombineThreads) {
    float ll = 0.0f;
    for (int s = 0; s < n_split; ++s)
      ll += sw[s * G + g] * ml[(s * G + g) * 2 + 1];
    s_l[g] = ll;
  }
  // group j sums the partials of its contiguous share of the chunks, in
  // chunk order; the group sums are then added in group order
  const int grp = threadIdx.x / 64;
  const int s_lo = grp * n_split / kCombineGroups;
  const int s_hi = (grp + 1) * n_split / kCombineGroups;
  for (int i = threadIdx.x % 64; i < G * hd; i += 64) {
    const int g = i / hd;
    float aa = 0.0f;
#pragma unroll 4
    for (int s = s_lo; s < s_hi; ++s)
      aa += sw[s * G + g] * part_acc[(base + s * G + g) * hd + i % hd];
    s_sum[grp * G * hd + i] = aa;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += kCombineThreads) {
    float aa = 0.0f;
    for (int j = 0; j < kCombineGroups; ++j) aa += s_sum[j * G * hd + i];
    store(o + ((long long)(b * K + kh) * G) * hd + i,
          aa / fmaxf(s_l[i / hd], 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
int launch_split(const void* q, const void* k, const void* v, const int* pos,
                 float* ml, float* acc, int B, int S, int K, int G, int chunk,
                 int window, float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<T, HD, GMAX>;
  constexpr size_t smem = Split<T, HD>::RING;   // 36-96 KB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + chunk - 1) / chunk, (K + kWarps - 1) / kWarps, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, ml, acc, S, K, G, chunk, window, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_group(const void* q, const void* k, const void* v, const int* pos,
                 float* ml, float* acc, int B, int S, int K, int G, int chunk,
                 int window, float scale, float softcap, cudaStream_t stream) {
  if (G == 1)
    return launch_split<T, HD, 1>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                  window, scale, softcap, stream);
  return launch_split<T, HD, kMaxGroup>(q, k, v, pos, ml, acc, B, S, K, G,
                                        chunk, window, scale, softcap,
                                        stream);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* pos, float* ml, float* acc, int B, int S, int K,
              int G, int chunk, int window, float scale, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_group<T, 32>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                 window, scale, softcap, stream);
    case 64:
      return launch_group<T, 64>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                 window, scale, softcap, stream);
    case 112:
      return launch_group<T, 112>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                  window, scale, softcap, stream);
    case 128:
      return launch_group<T, 128>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                  window, scale, softcap, stream);
    case 256:
      return launch_group<T, 256>(q, k, v, pos, ml, acc, B, S, K, G, chunk,
                                  window, scale, softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// The split pass of one decode attention of q [B,H,hd] (H = K * G) against
// the caches k, v [B,S,K,hd] up to pos [B] (int32), in chunks of `chunk`
// keys: each (chunk, kv head)'s partial (m, l) into ml [B,K,n_split,G,2]
// and acc into acc [B,K,n_split,G,hd], f32, on `stream`. is_bf16: 0 for
// float, 1 for bf16. Returns the cudaGetLastError() code of the launch (0 on
// success), -1 for an hd, a group or a chunk this file does not take, or -2
// if (grid_x, grid_y, grid_z), the wrapper's grid, is not the one this
// file's tiling needs.
int flash_decode_split_launch(const void* q, const void* k, const void* v,
                              const void* pos, void* ml, void* acc, int B,
                              int S, int K, int G, int hd, int is_bf16,
                              int chunk, int window, float scale,
                              float softcap, int grid_x, int grid_y,
                              int grid_z, void* stream) {
  if (chunk < 1) return -1;
  if (grid_x != (S + chunk - 1) / chunk ||
      grid_y != (K + kWarps - 1) / kWarps || grid_z != B)
    return -2;
  if (G < 1 || G > kMaxGroup) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* m = static_cast<float*>(ml);
  float* a = static_cast<float*>(acc);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, p, m, a, B, S, K, G, chunk,
                                    window, scale, softcap, st);
  return launch_hd<float>(hd, q, k, v, p, m, a, B, S, K, G, chunk, window,
                          scale, softcap, st);
}

// The combine pass: merges the n_split partials of each (b, kv head) in
// chunk order into o [B,H,hd] (q's type), on `stream`. Returns as the split
// pass does; the grid is (K, B).
int flash_decode_combine_launch(const void* ml, const void* acc, void* o,
                                int B, int K, int G, int hd, int n_split,
                                int is_bf16, int grid_x, int grid_y,
                                void* stream) {
  if (grid_x != K || grid_y != B) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B);
  const size_t smem =
      sizeof(float) *
      (size_t(n_split + 2) * G + size_t(kCombineGroups) * G * hd);
  if (smem > 48 * 1024) return -1;
  const float* m = static_cast<const float*>(ml);
  const float* a = static_cast<const float*>(acc);
  if (is_bf16)
    flash_decode_combine_kernel<__nv_bfloat16><<<grid, kCombineThreads,
                                                 smem, st>>>(
        m, a, static_cast<__nv_bfloat16*>(o), K, G, hd, n_split);
  else
    flash_decode_combine_kernel<float><<<grid, kCombineThreads, smem,
                                        st>>>(
        m, a, static_cast<float*>(o), K, G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
