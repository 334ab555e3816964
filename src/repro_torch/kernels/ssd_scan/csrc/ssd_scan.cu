// Mamba-2 SSD scan (chunked block form), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_scan
// (Pallas body _ssd_kernel). It computes the function of the plain version
// kernels/ssd_scan/ref.py::ssd_scan_ref, the recurrence
//
//   h_t = exp(dt_t * A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
//
// for each batch row b and head h, with x, y [B,S,H,P], dt [B,S,H] float,
// A [H] float, B, C [B,S,G,N] (x, B, C and y float or bf16) and the state
// h [P,N] in f32 from 0. Head h reads state group h / (H / G) of B and C
// (Mamba-2's ngroups; G = 1 is one group for every head). Like the Pallas kernel it takes the sequence in
// chunks and computes, per chunk of kQ rows with L = cumsum(dt * A):
//
//   G = C B^T;  W[t,s] = G[t,s] * exp(L_t - L_s) * dt_s  (s <= t, else 0)
//   y = W x + exp(L) * (C h^T)
//   h <- exp(L_last) h + (x w)^T B,   w_s = exp(L_last - L_s) dt_s
//
// The decomposition is exact at any chunk length; only rounding differs
// from the step-by-step recurrence. Rows past S load as zero (dt = 0 adds
// nothing to L, h or y) and are not stored, so L_last is L of row kQ - 1.
//
// Bound on the H100 SXM (data sheet, 700 W; chip_smoke.py::ssd_bound): at
// zamba2's B 1, S 4096, H 112, P 64, N 64, bf16, the bytes are x and y
// (58.7 MB each), dt (1.8 MB), B and C (1.0 MB): 120 MB, 36 us at
// 3.35 TB/s; the products of the chunked form are 11 us at the bf16
// tensor-core rate. The bytes bind it; this design is held back by the
// sequential chunk loop instead (PERF.md section 6).
//
// Design (both routes): the P-split. Row p of h depends only on column p
// of x, and the decay is one scalar a head, so a block takes kPB = 16
// columns of P: grid (P / kPB, H, B), 448 blocks at zamba2's shape in
// place of 112 (one a head: one block an SM). A block walks its P-slice's
// chunks in order with its slice of h on chip, and recomputes G and L for
// each chunk: B and C (1 MB in all) stay in L2. x and y cross memory once
// and no state goes to memory. Mamba-2's chunk-parallel alternative
// (per-chunk states, a state-passing pass, then the outputs) writes and
// reads f32 states of 16 KB a (head, chunk), as many bytes as x itself.
// L = cumsum(dt * A) is a warp scan (two rows a lane, five shuffles).
//
// bf16 route, ssd_scan_mma_kernel: the four products on the tensor cores
// as mma.sync m16n8k16 (bf16 in, f32 accumulators), fed by ldmatrix from
// shared memory. mma.sync, not wgmma: its 16-row tiles fit one warp's 16
// rows of a 64-row chunk, so each warp keeps its own causal work, W stays
// in registers from G to W x, and no warpgroup-wide ordering is needed
// within a chunk. 4 warps; the warp with row tile rt (rotated by block):
// - G and W for rows 16 rt .. 16 rt + 15, causal column tiles only, W in
//   G's accumulator layout, which is the A-operand layout of W x;
// - y for those rows, W x + exp(L_t) (C h^T), C's A fragments shared by
//   G and C h^T; y goes out through the warp's own rows of C in shared
//   memory, in 16-byte stores;
// - the new h for 0, 1 or 2 pairs of 8 state columns (2, 1, 1, 0 by row
//   tile: 60, 56, 68 and 64 products a chunk), kept in accumulator
//   registers across chunks and written as bf16 terms into a
//   double-buffered shared copy that every warp reads for C h^T.
// Operands exact in bf16 (C, B, x) go in as they are. Operands made in
// f32 go in as sums of bf16 terms, a product each: W as three (with two,
// hi + lo, zamba2's model-level logits moved 2.003e-2 of their max on an
// NVIDIA H100 80GB HBM3 at 700 W, over chip_smoke.py's 2e-2), h and the
// decay-weighted x as two. Off the diagonal W is G times a row factor
// exp(L_t - L_e) and a column factor exp(L_e - L_s) dt_s (e the last row
// of s's 16-row tile, so both are at most 1): two exps a row, not one an
// element. The exps are ex2.approx.ftz of log2-scaled L (relative error
// ~2^-22). Chunks of x, B, C and dt come in by cp.async (16-byte copies;
// dt's 4, it is strided by H) into a 2-stage ring, one barrier a chunk.
// Shared rows are padded (72 bf16 for B, C and h, 24 for x) so that
// ldmatrix reads 8 rows in distinct banks. At 122 registers and 55 KB
// four blocks fit an SM.
//
// f32 route, ssd_scan_simt_kernel: the same P-split and cumsum, the
// products on the CUDA cores (fmaf, accurate expf) out of shared memory in
// 16 x 16 threads' register tiles; TF32 could not hold the f32 rule (1e-4
// of the largest |y|).
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): PERF.md. The
// library is built with -O3 --fmad=false (kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;            // rows a chunk
constexpr int kPB = 16;           // columns of P a block (the P-split)
constexpr int kMmaThreads = 128;  // bf16 route: 4 warps
constexpr int kTermsW = 3;        // bf16 route: bf16 terms of W,
constexpr int kTermsH = 2;        //   of the state h
constexpr int kTermsX = 2;        //   and of the decay-weighted x
constexpr int kTX = 16;           // f32 route: thread columns
constexpr int kTY = 16;           // f32 route: thread rows
constexpr int kSimtThreads = kTX * kTY;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 (or 4) bytes from global to shared memory, or zeros if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (a, b) as K bf16 terms each: term k packs the bf16 of what terms
// 0 .. k-1 left of a (low 16 bits) and of b; the terms sum to a and b
// within 2^-8 of the last one.
template <int K>
__device__ __forceinline__ void split_n(float a, float b, uint32_t (&t)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    t[k] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 back = __bfloat1622float2(v);
    a -= back.x;
    b -= back.y;
  }
}
__device__ __forceinline__ float lo_f32(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// Shared-memory layout of the bf16 route, in bf16 elements.
template <int N>
struct MmaSmem {
  static constexpr int CS = N + 8;       // row stride of C, B and h
  static constexpr int XS = kPB + 8;     // row stride of x
  static constexpr int STAGE = 2 * kQ * CS + kQ * XS + 2 * kQ;  // + dt
  static constexpr int HBUF = kPB * CS;  // one term of one copy of h
  static constexpr size_t bytes = 2 * (2 * STAGE + 2 * kTermsH * HBUF) +
                                  4 * 3 * (kMmaThreads / 32) * kQ;
};

template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads, 4) ssd_scan_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
    int S, int H, int G) {
  static_assert(N == 64 && P % kPB == 0, "4 pairs of 8 state columns");
  using L = MmaSmem<N>;
  constexpr int CS = L::CS, XS = L::XS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sH = stage0 + 2 * L::STAGE;   // [2 copies][term][kPB][CS]
  float* sL = reinterpret_cast<float*>(sH + 2 * kTermsH * L::HBUF);
  float* sCf = sL + (kMmaThreads / 32) * kQ;               // [warp][kQ]
  float* sScale = sCf + (kMmaThreads / 32) * kQ;           // [warp][kQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int pb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p0 = pb * kPB;
  const int sg = h / (H / G);   // the head's state group of B and C
  const float a2 = A[h] * kLog2e;
  // ldmatrix row and column of this lane within a 16 x 16 tile, for the
  // two orders in which the four 8 x 8 matrices are wanted
  const int lr = lane % 8, m1 = (lane / 8) & 1, m2 = lane / 16;
  // The warp's 16-row tile of the chunk. Row tile rt has rt + 1 causal
  // column tiles, so the state columns go the other way: 2 pairs of n8
  // tiles to row tile 0, one to 1 and 2, none to 3. Warps of one index
  // share a scheduler of the SM; the rotation by block spreads the
  // heavier roles over the schedulers.
  const int rt = (warp + blockIdx.x + blockIdx.y) & 3;
  const int npairs = rt == 0 ? 2 : (rt == 3 ? 0 : 1);
  const int pair0 = rt == 0 ? 0 : rt + 1;

  auto stC = [&](int st) { return stage0 + st * L::STAGE; };
  auto stB = [&](int st) { return stage0 + st * L::STAGE + kQ * CS; };
  auto stX = [&](int st) { return stage0 + st * L::STAGE + 2 * kQ * CS; };
  auto stDt = [&](int st) {
    return reinterpret_cast<float*>(stage0 + st * L::STAGE + 2 * kQ * CS +
                                    kQ * XS);
  };

  // this thread's 16-byte copies of a chunk: rows lrow + 16 j of C and B
  // (column vector lvec), row tid / 2 of x (vector tid % 2), row tid of dt
  constexpr int kRowsPass = kMmaThreads / (N / 8);
  static_assert(kQ % kRowsPass == 0 && kQ * (kPB / 8) == kMmaThreads,
                "one x copy a thread");
  const int lrow = tid / (N / 8), lvec = (tid % (N / 8)) * 8;
  const long long row_b = (long long)b * S;
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * kQ;
#pragma unroll
    for (int j = 0; j < kQ / kRowsPass; ++j) {
      const int r = lrow + kRowsPass * j;
      const bool ok = t0 + r < S;
      const long long off = ok ? ((row_b + t0 + r) * G + sg) * N + lvec : 0;
      cp_async16(stC(st) + r * CS + lvec, Cm + off, ok);
      cp_async16(stB(st) + r * CS + lvec, Bm + off, ok);
    }
    {
      const int r = tid / 2, v = (tid % 2) * 8;
      const bool ok = t0 + r < S;
      const long long off = ok ? ((row_b + t0 + r) * H + h) * P + p0 + v : 0;
      cp_async16(stX(st) + r * XS + v, x + off, ok);
    }
    if (tid < kQ) {
      const bool ok = t0 + tid < S;
      cp_async4(stDt(st) + tid, dt + (ok ? (row_b + t0 + tid) * H + h : 0),
                ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < kTermsH * L::HBUF; i += kMmaThreads)   // h = 0
    sH[i] = __float2bfloat16_rn(0.0f);
  float hacc[2][2][4] = {};   // [pair][n8 tile], accumulator layout

  const int nc = (S + kQ - 1) / kQ;
  load_chunk(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int st = c & 1;
    cp_async_wait_all();
    // chunk c landed everywhere; every warp is done with chunk c - 1, so
    // stage st ^ 1 and h copy (c + 1) & 1 are free
    __syncthreads();
    if (c + 1 < nc) load_chunk(c + 1, st ^ 1);
    const __nv_bfloat16* sC = stC(st);
    const __nv_bfloat16* sB = stB(st);
    const __nv_bfloat16* sX = stX(st);
    const float* sDt = stDt(st);
    const __nv_bfloat16* hRead = sH + (c & 1) * kTermsH * L::HBUF;
    __nv_bfloat16* hWrite = sH + ((c + 1) & 1) * kTermsH * L::HBUF;
    const int r0 = 16 * rt;

    // C's A fragments for the warp's rows, over N in 4 k-steps
    uint32_t aC[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(aC[kk], sC + (r0 + lr + 8 * m1) * CS + 16 * kk + 8 * m2);

    // L (log2 units) by a warp scan, two rows a lane, in each warp; with
    // it the column factors exp(L_e - L_s) dt_s (e the last row of s's
    // 16-row tile) and the state update's exp(L_last - L_s) dt_s
    float* wL = sL + warp * kQ;
    float* wCf = sCf + warp * kQ;
    float* wS = sScale + warp * kQ;
    float last;
    {
      const float d0 = sDt[2 * lane], d1 = sDt[2 * lane + 1];
      const float v0 = d0 * a2, v1 = d1 * a2;
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float l0 = excl + v0, l1 = l0 + v1;
      last = __shfl_sync(0xffffffffu, l1, 31);
      const float tend = __shfl_sync(0xffffffffu, l1, lane | 7);
      wL[2 * lane] = l0;
      wL[2 * lane + 1] = l1;
      wCf[2 * lane] = ex2(tend - l0) * d0;
      wCf[2 * lane + 1] = ex2(tend - l1) * d1;
      wS[2 * lane] = ex2(last - l0) * d0;
      wS[2 * lane + 1] = ex2(last - l1) * d1;
      __syncwarp();
    }
    const int t_lo = r0 + grp, t_hi = t_lo + 8;
    const float Lt_lo = wL[t_lo], Lt_hi = wL[t_hi];

    // per causal column tile jp: G = C B^T, W in place, then y_intra +=
    // W x with W as kTermsW bf16 terms (the accumulator layout of G is the
    // A layout of W). Off the diagonal W is G times a row factor
    // exp(L_t - L_e) and the column factor; on it one exp an element, and
    // only where the mask s <= t is not decided by the 8 x 8 quadrant.
    float yi[2][4] = {};
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > rt) continue;
      float w0[4] = {}, w1[4] = {};   // columns 16 jp (+8) + 2 tig (+1)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, sB + (16 * jp + lr + 8 * m2) * CS + 16 * kk + 8 * m1);
        mma(w0, aC[kk], bb[0], bb[1]);
        mma(w1, aC[kk], bb[2], bb[3]);
      }
      const int s0 = 16 * jp + 2 * tig;
      if (jp < rt) {
        const float Le = wL[16 * jp + 15];
        const float f_lo = ex2(Lt_lo - Le), f_hi = ex2(Lt_hi - Le);
        const float2 c0 = *reinterpret_cast<const float2*>(wCf + s0);
        const float2 c1 = *reinterpret_cast<const float2*>(wCf + s0 + 8);
        w0[0] = w0[0] * f_lo * c0.x;  w0[1] = w0[1] * f_lo * c0.y;
        w0[2] = w0[2] * f_hi * c0.x;  w0[3] = w0[3] * f_hi * c0.y;
        w1[0] = w1[0] * f_lo * c1.x;  w1[1] = w1[1] * f_lo * c1.y;
        w1[2] = w1[2] * f_hi * c1.x;  w1[3] = w1[3] * f_hi * c1.y;
      } else {
        const float2 L0 = *reinterpret_cast<const float2*>(wL + s0);
        const float2 d0 = *reinterpret_cast<const float2*>(sDt + s0);
        const float2 L1 = *reinterpret_cast<const float2*>(wL + s0 + 8);
        const float2 d1 = *reinterpret_cast<const float2*>(sDt + s0 + 8);
        // rows t_lo, columns s0 (+1): same quadrant, masked
        w0[0] = s0 <= t_lo ? w0[0] * ex2(Lt_lo - L0.x) * d0.x : 0.0f;
        w0[1] = s0 + 1 <= t_lo ? w0[1] * ex2(Lt_lo - L0.y) * d0.y : 0.0f;
        // rows t_hi, columns s0 (+1): every s < t
        w0[2] = w0[2] * ex2(Lt_hi - L0.x) * d0.x;
        w0[3] = w0[3] * ex2(Lt_hi - L0.y) * d0.y;
        // rows t_lo, columns s0 + 8 (+1): every s > t
        w1[0] = 0.0f;
        w1[1] = 0.0f;
        // rows t_hi, columns s0 + 8 (+1): same quadrant, masked
        w1[2] = s0 + 8 <= t_hi ? w1[2] * ex2(Lt_hi - L1.x) * d1.x : 0.0f;
        w1[3] = s0 + 9 <= t_hi ? w1[3] * ex2(Lt_hi - L1.y) * d1.y : 0.0f;
      }
      uint32_t t0[kTermsW], t1[kTermsW], t2[kTermsW], t3[kTermsW];
      split_n(w0[0], w0[1], t0);
      split_n(w0[2], w0[3], t1);
      split_n(w1[0], w1[1], t2);
      split_n(w1[2], w1[3], t3);
      uint32_t bx[4];
      ldsm_x4_t(bx, sX + (16 * jp + lr + 8 * m1) * XS + 8 * m2);
#pragma unroll
      for (int k = 0; k < kTermsW; ++k) {
        const uint32_t aw[4] = {t0[k], t1[k], t2[k], t3[k]};
        mma(yi[0], aw, bx[0], bx[1]);
        mma(yi[1], aw, bx[2], bx[3]);
      }
    }

    // y_inter = C h^T, h as kTermsH bf16 terms
    float ye[2][4] = {};
#pragma unroll
    for (int half = 0; half < kTermsH; ++half) {
      const __nv_bfloat16* hh = hRead + half * L::HBUF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[4];
        ldsm_x4(bh, hh + (lr + 8 * m2) * CS + 16 * kk + 8 * m1);
        mma(ye[0], aC[kk], bh[0], bh[1]);
        mma(ye[1], aC[kk], bh[2], bh[3]);
      }
    }
    {
      // y through this warp's own 16 rows of C in shared memory (no other
      // warp reads them, and this warp holds them in aC), then out in
      // 16-byte stores, two a row
      const float e_lo = ex2(Lt_lo), e_hi = ex2(Lt_hi);
      __nv_bfloat16* stage = const_cast<__nv_bfloat16*>(sC) + r0 * CS;
      __syncwarp();
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int p = 8 * jt + 2 * tig;
        const __nv_bfloat162 v_lo = __floats2bfloat162_rn(
            yi[jt][0] + e_lo * ye[jt][0], yi[jt][1] + e_lo * ye[jt][1]);
        const __nv_bfloat162 v_hi = __floats2bfloat162_rn(
            yi[jt][2] + e_hi * ye[jt][2], yi[jt][3] + e_hi * ye[jt][3]);
        *reinterpret_cast<__nv_bfloat162*>(stage + grp * CS + p) = v_lo;
        *reinterpret_cast<__nv_bfloat162*>(stage + (grp + 8) * CS + p) = v_hi;
      }
      __syncwarp();
      const int row = lane / 2, t = c * kQ + r0 + row;
      if (t < S)
        *reinterpret_cast<uint4*>(y + ((row_b + t) * H + h) * P + p0 +
                                  8 * (lane % 2)) =
            *reinterpret_cast<const uint4*>(stage + row * CS +
                                            8 * (lane % 2));
    }

    // h <- exp(L_last) h + (x w)^T B on this warp's pairs of state columns
    if (npairs > 0) {
      const float hdec = ex2(last);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int jt = 0; jt < 2; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[q][jt][e] *= hdec;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // x^T's A fragment, each row s of x scaled by w_s and split into
        // kTermsX terms: ax[0], ax[1] hold s = 16 kk + 2 tig (+1), ax[2],
        // ax[3] s + 8 (+9)
        uint32_t ax[4], axt[4][kTermsX];
        ldsm_x4_t(ax, sX + (16 * kk + lr + 8 * m2) * XS + 8 * m1);
        const int s = 16 * kk + 2 * tig;
        const float w0 = wS[s], w1 = wS[s + 1], w8 = wS[s + 8],
                    w9 = wS[s + 9];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool upper = v >= 2;
          split_n(lo_f32(ax[v]) * (upper ? w8 : w0),
                  hi_f32(ax[v]) * (upper ? w9 : w1), axt[v]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= npairs) continue;
          uint32_t bb[4];
          ldsm_x4_t(bb, sB + (16 * kk + lr + 8 * m1) * CS +
                            16 * (pair0 + q) + 8 * m2);
#pragma unroll
          for (int k = 0; k < kTermsX; ++k) {
            const uint32_t a[4] = {axt[0][k], axt[1][k], axt[2][k],
                                   axt[3][k]};
            mma(hacc[q][0], a, bb[0], bb[1]);
            mma(hacc[q][1], a, bb[2], bb[3]);
          }
        }
      }
      // the new h, as bf16 terms, for every warp's C h^T of chunk c + 1
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= npairs) continue;
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int n = 16 * (pair0 + q) + 8 * jt + 2 * tig;
          uint32_t u[kTermsH], w[kTermsH];
          split_n(hacc[q][jt][0], hacc[q][jt][1], u);
          split_n(hacc[q][jt][2], hacc[q][jt][3], w);
#pragma unroll
          for (int k = 0; k < kTermsH; ++k) {
            __nv_bfloat16* hk = hWrite + k * L::HBUF;
            *reinterpret_cast<uint32_t*>(hk + grp * CS + n) = u[k];
            *reinterpret_cast<uint32_t*>(hk + (grp + 8) * CS + n) = w[k];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

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

template <int N>
constexpr size_t simt_smem_floats() {
  return size_t(kQ) * kPB + 2 * size_t(kQ) * (N + 1) +
         size_t(kQ) * (kQ + 1) + size_t(kPB) * (N + 1) + 3 * kQ;
}

template <int P, int N>
__global__ void __launch_bounds__(kSimtThreads) ssd_scan_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, int S, int H,
    int G) {
  static_assert(kPB == kTX && N % kTX == 0, "a thread column a P column");
  constexpr int XS = kPB;          // row strides of the shared tiles
  constexpr int BS = N + 1;
  constexpr int WS = kQ + 1;
  constexpr int HS = N + 1;
  extern __shared__ float smem_f[];
  float* sX = smem_f;              // [kQ][XS]   x of the chunk, this slice
  float* sB = sX + kQ * XS;        // [kQ][BS]   B, then decay-weighted B
  float* sC = sB + kQ * BS;        // [kQ][BS]   C
  float* sW = sC + kQ * BS;        // [kQ][WS]   W
  float* sH = sW + kQ * WS;        // [kPB][HS]  this slice of h
  float* sDt = sH + kPB * HS;      // [kQ]
  float* sL = sDt + kQ;            // [kQ]       L = cumsum(dt * A)
  float* sDec = sL + kQ;           // [kQ]       exp(L_last - L_s) * dt_s

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int sg = h / (H / G);   // the head's state group of B and C
  const float a_h = A[h];

  for (int i = tid; i < kPB * HS; i += kSimtThreads) sH[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int qn = min(kQ, S - t0);
    __syncthreads();   // the last chunk's readers are done
    for (int i = tid; i < kQ * kPB; i += kSimtThreads) {
      const int r = i / kPB, c = i % kPB;
      sX[r * XS + c] =
          r < qn ? x[(((long long)b * S + t0 + r) * H + h) * P + p0 + c]
                 : 0.0f;
    }
    for (int i = tid; i < kQ * N; i += kSimtThreads) {
      const int r = i / N, c = i % N;
      const long long off = (((long long)b * S + t0 + r) * G + sg) * N + c;
      sB[r * BS + c] = r < qn ? Bm[off] : 0.0f;
      sC[r * BS + c] = r < qn ? Cm[off] : 0.0f;
    }
    for (int r = tid; r < kQ; r += kSimtThreads)
      sDt[r] = r < qn ? dt[((long long)b * S + t0 + r) * H + h] : 0.0f;
    __syncthreads();
    if (tid < 32) {   // L by a warp scan, two rows a lane
      const float v0 = sDt[2 * tid] * a_h, v1 = sDt[2 * tid + 1] * a_h;
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      const float l0 = excl + v0, l1 = l0 + v1;
      const float last = __shfl_sync(0xffffffffu, l1, 31);
      sL[2 * tid] = l0;
      sL[2 * tid + 1] = l1;
      sDec[2 * tid] = expf(last - l0) * sDt[2 * tid];
      sDec[2 * tid + 1] = expf(last - l1) * sDt[2 * tid + 1];
    }
    __syncthreads();
    const float L_last = sL[kQ - 1];

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
      float yi[kQ / kTY][1], ye[kQ / kTY][1];
      zero(yi);
      zero(ye);
      tile_mm<kQ / kTY, 1, kQ>(yi, sW, WS, 1, sX, XS, 1, tx, ty);
      tile_mm<kQ / kTY, 1, N>(ye, sC, BS, 1, sH, 1, HS, tx, ty);
#pragma unroll
      for (int i = 0; i < kQ / kTY; ++i) {
        const int t = ty + kTY * i;
        if (t >= qn) continue;
        const float e = expf(sL[t]);
        y[(((long long)b * S + t0 + t) * H + h) * P + p0 + tx] =
            yi[i][0] + e * ye[i][0];
      }
      for (int i = tid; i < kQ * N; i += kSimtThreads) {
        const int r = i / N, c = i % N;
        sB[r * BS + c] = sDec[r] * sB[r * BS + c];
      }
    }
    __syncthreads();

    // h <- exp(L_last) h + x^T (decay-weighted B)
    {
      float dh[kPB / kTY][N / kTX];
      zero(dh);
      tile_mm<kPB / kTY, N / kTX, kQ>(dh, sX, 1, XS, sB, BS, 1, tx, ty);
      const float e = expf(L_last);
#pragma unroll
      for (int j = 0; j < N / kTX; ++j) {
        float* hp = sH + ty * HS + tx + kTX * j;
        *hp = e * *hp + dh[0][j];
      }
    }
  }
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int G, int is_bf16,
           cudaStream_t stream) {
  const dim3 grid(P / kPB, H, B);
  if (is_bf16) {
    auto kernel = ssd_scan_mma_kernel<P, N>;
    constexpr size_t smem = MmaSmem<N>::bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), dt, A,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm),
        static_cast<__nv_bfloat16*>(y), S, H, G);
  } else {
    auto kernel = ssd_scan_simt_kernel<P, N>;
    constexpr size_t smem = sizeof(float) * simt_smem_floats<N>();
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y), S, H, G);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_pn(int P, int N, const void* x, const float* dt, const float* A,
              const void* Bm, const void* Cm, void* y, int B, int S, int H,
              int G, int is_bf16, cudaStream_t stream) {
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dt, A, Bm, Cm, y, B, S, H, G, is_bf16, stream);
  return -1;
}

}  // namespace

extern "C" {

// Launches one SSD scan of x [B,S,H,P], dt [B,S,H] (float), A [H] (float),
// B, C [B,S,G,N] (head h reading group h / (H / G)) into y [B,S,H,P], on
// `stream`. is_bf16: 0 for float (CUDA cores), 1 for bf16 (x, B, C and y;
// tensor cores). Returns the cudaGetLastError() code of the launch (0 on
// success), -1 for a (P, N) this file was not instantiated for or a G
// that does not divide H, or -2 if (grid_x, grid_y, grid_z), the wrapper's
// grid, is not the one this file's tiling needs.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int B, int S,
                    int H, int P, int N, int G, int is_bf16, int grid_x,
                    int grid_y, int grid_z, void* stream) {
  if (P % kPB != 0 || grid_x != P / kPB || grid_y != H || grid_z != B)
    return -2;
  if (G < 1 || H % G != 0) return -1;
  return launch_pn(P, N, x, static_cast<const float*>(dt),
                   static_cast<const float*>(A), Bm, Cm, y, B, S, H, G,
                   is_bf16, static_cast<cudaStream_t>(stream));
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
