// Causal / sliding-window / soft-capped GQA attention (prefill) in bf16 on
// Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention (Pallas body _attn_kernel) for bf16 inputs; f32 inputs
// take the SIMT kernel of flash_attention.cu. It computes what the plain
// version kernels/flash_attention/ref.py::attention_ref computes:
//
//   s   = (q . k) * scale (hd^-0.5 unless the caller gives another), then
//         tanh(s / softcap) * softcap if softcap > 0;
//   s   is masked where k_pos > q_pos (causal), q_pos - k_pos >= window
//         (window > 0) or k_pos >= Sk (ragged edge): p = 0 exactly there;
//   out = softmax(s) v, f32 accumulation, written in bf16.
//
// q is [B,H,Sq,hd], k and v are [B,K,Sk,hd], all contiguous bf16; query
// head h reads kv head h / (H / K); hd in {32, 64, 112, 128, 224, 256}. Query row
// i stands at position q_pos = q_offset + i (0 <= q_offset, q_offset + Sq <=
// Sk), key row j at k_pos = j: a rank that holds the rows [s0, s0 + Sq) of
// a sequence-sharded q passes q_offset = s0 and every key. Without an
// offset Sq = Sk = S.
//
// Bound on the H100: at the long shapes (S 4096-8192) the work is
// 4 * hd * (visible score entries) * B * H FLOPs, 69-278 us at the 989
// TFLOP/s bf16 tensor-core rate; q, k, v and o move in a few us at 3.35
// TB/s. So the products must run on the tensor cores, fed without stalls,
// and the softmax between them (one exp a score, a tanh with softcap) must
// not hold them up.
//
// Design (the shape of a Hopper attention kernel, not the TPU kernel's
// blocks carried over):
// - One block per (b, h, 128 query rows), longest rows first: two consumer
//   warpgroups of 64 rows each (wgmma's M) and one producer warpgroup, 384
//   threads. ptxas gives a block of this size 168 registers a thread, too
//   few for a consumer's O (64 x hd f32 over 128 threads: 128 registers a
//   thread at hd 256) beside its score tile, so setmaxnreg moves them: the
//   producer keeps 24, the consumers get 240. One producer thread issues
//   every copy and does nothing else.
// - Copies are TMA (cp.async.bulk.tensor) over rank-3 tensor maps (hd, Sq
//   or Sk, B * heads) with boxes 64 elements wide and a 128-byte swizzle
//   (a 64-byte one at hd 32, whose rows are 64 bytes). q is loaded once; k
//   and v go through a ring of STAGES stages with a "full" mbarrier for
//   each of k and v (the score product starts before v lands) and an
//   "empty" one for each, which all 256 consumer threads arrive on (k is
//   released as soon as its scores are in, v after its P V). Sq and Sk are
//   dimensions of the maps, so a tile that runs past them reads zeros,
//   never the next head's rows; hd 112 is read as two boxes of 64 columns
//   whose last 16 are zero, computed as 128 and stored as 112, and hd 224
//   as four whose last 32 are zero, computed as 256 and stored as 224.
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory (the
//   k tile [BK, hd] is K-major as it lands). The softmax runs on the
//   accumulator fragment in registers: a row lives in the 4 lanes of a quad,
//   so its max takes two shuffles; its sum is kept per lane and reduced
//   once at the end. With softcap the scores are scaled, then capped with
//   the accurate tanhf; without, the scale is folded into the exponent.
//   Exponentials are exp2f (the library is built without fast math:
//   kernels/_build.py). Masked entries of a tile the masks leave partly
//   visible get p = 0 exactly, so a row that sees no key in a tile keeps
//   its m, l and O; tiles wholly visible skip the mask (a per-element mask
//   on every tile cost more than the exponentials), and tiles invisible to
//   the whole block are never loaded.
// - O += P V is wgmma with P as the A operand from registers (the score
//   fragment is laid out as the A fragment) and v from shared memory
//   through the descriptor's transpose bit (v is MN-major). P goes in as
//   two bf16 halves, hi = bf16(P) and lo = bf16(P - hi), two products into
//   the same accumulator: 1.5x the tensor-core work, but about 16 bits of P
//   where bf16 alone keeps 8. With P rounded once to bf16 the waste
//   pipeline's bf16 logits moved 2.5e-2 of their largest from the plain
//   path's (chip_smoke.py's limit 2e-2); the normaliser l sums the f32 p.
// - In a warpgroup, tile j's score product is issued together with tile
//   j - 1's P V, and tile j's softmax runs while that P V is still on the
//   tensor cores. Each product has its own wgmma.fence, and while one is in
//   flight nothing writes its registers: the softmax works in place on the
//   scores, and O's rescale and P's conversion to the A fragment wait for
//   the P V (else ptxas serializes every wgmma of the kernel).
// - Tiles are BK = 128 keys at hd <= 128 and 64 at hd 224 and 256: q 64 KB
//   + two stages of k and v (32 KB each) = 192 KB of dynamic shared memory
//   there.
// - The epilogue divides by max(l, 1e-30), as the reference does, and
//   stores rows < Sq and columns < hd from registers. The masks and the
//   tile range read a row's position, q_offset + its row.
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W): 0.22 ms at
// qwen2.5-3b's S 4096 (31% of the bound, 309 TFLOP/s; SDPA 0.14 ms), 0.40
// ms at zamba2-7b's hd 112, 0.64 / 0.86 ms at gemma2-2b's S 8192 with
// softcap; at the waste pipeline's S 173-233 a call is host-bound. The lo
// half of P and warpgroups that do not alternate their softmax and products
// are what keeps it from SDPA's time (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                   // query rows per block
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
constexpr int kProducerRegs = 24;          // registers a thread after
constexpr int kConsumerRegs = 240;         //   setmaxnreg (64,512 in all)
constexpr float kNegInf = -1e30f;          // NEG_INF of the reference
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry at head dim HD.
template <int HD>
struct Tiles {
  static constexpr int BW = HD < 64 ? HD : 64;    // box width, elements
  static constexpr int RB = 2 * BW;               // bytes of a box row
  static constexpr int NC = (HD + BW - 1) / BW;   // boxes across hd
  static constexpr int HDP = NC * BW;             // computed width
  static constexpr int BK = HD > 128 ? 64 : 128;  // keys a tile
  static constexpr int STAGES = 2;                // k/v ring depth
  static constexpr int Q_BYTES = NC * kBQ * RB;
  static constexpr int KV_BYTES = NC * BK * RB;   // one k or v stage
  // 1024 bytes of slack to align the swizzled tiles, then the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;  // 128B / 64B swizzle
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a rank-3 tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins wgmma's registers where they stand: every definition before this
// point happens before it, and nothing reads them early. Placed before each
// wgmma.fence, it keeps the compiler from sinking a definition of an input
// register into the pipeline stage (ptxas would then serialize the wgmmas),
// and after each wait, from reading an accumulator before it is written.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


// Whether key kpos is visible to query qpos (bitwise, so no branches).
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return (kpos < Sk) & (!causal | (qpos >= kpos)) &
         ((window <= 0) | (qpos - kpos < window));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The online softmax of one score tile, in place on the accumulator
// fragment. With softcap the scores are scaled and capped first (the
// accurate tanhf); without, the scale is folded into the exponent (scale > 0
// keeps the maxima). On a tile the masks leave partly visible, masked
// scores become -1e30; then the rows' new maxima over their quads, p =
// exp(s - m) in f32, the rows' partial sums, and the factors a0, a1 by
// which O and l are rescaled. A masked score's p is 0 exactly: exp2 of
// -1e30 - m underflows for a row that has a visible key, and a row that has
// none yet (m still -1e30, where that exponent would be 0 and p 1) takes
// m = +inf for the exponent. The softmax runs while the previous tile's
// P V is in flight, so it writes only the score registers, and has no
// branches inside its loops; pack_p turns p into wgmma's A fragment once
// that product is done. p0 and p1 are the positions of the thread's rows.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int p0, int p1, int k0, int col, bool all, int Sk,
    int causal, int window, float scale, float softcap) {
  float sl = scale * kLog2e;             // log2(e) over the scores' unit
  if (softcap > 0.0f) {
    // (s * scale) / softcap as one product: a division a score would cost
    // more than the tanhf
    const float f = scale / softcap;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = tanhf(s[i] * f) * softcap;
    sl = kLog2e;
  }
  if (!all) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool top = (i % 4) < 2;
      const bool ok = visible(top ? p0 : p1, k0 + 8 * (i / 4) + col + (i % 2),
                              Sk, causal, window);
      s[i] = ok ? s[i] : kNegInf;
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if ((i % 4) < 2) mx0 = fmaxf(mx0, s[i]);
    else mx1 = fmaxf(mx1, s[i]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = exp2f((m0 - mn0) * sl);
  a1 = exp2f((m1 - mn1) * sl);
  const float ms0 = mn0 == kNegInf ? INFINITY : mn0 * sl;
  const float ms1 = mn1 == kNegInf ? INFINITY : mn1 * sl;
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if ((i % 4) < 2) {
      s[i] = exp2f(fmaf(s[i], sl, -ms0));
      sum0 += s[i];
    } else {
      s[i] = exp2f(fmaf(s[i], sl, -ms1));
      sum1 += s[i];
    }
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// p (f32, the score fragment) as two bf16 halves laid out as wgmma's A
// fragment, hi = bf16(p) and lo = bf16(p - hi): hi + lo keeps about 16 bits
// of p, where bf16 alone keeps 8. Pairs, for 16 keys kk: {row r0 cols 0-7,
// r1 0-7, r0 8-15, r1 8-15}.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&hi)[BK / 16][4],
                                       uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[i], s[i + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(s[i] - hf.x, s[i + 1] - hf.y);
    hi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    int H, int group, int Sq, int Sk, int q_offset, int causal, int window,
    float scale, float softcap) {
  using T = Tiles<HD>;
  constexpr int BK = T::BK, RB = T::RB, NC = T::NC, HDP = T::HDP;
  constexpr int ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                                  // [NC][kBQ][RB]
  uint8_t* sK = sQ + T::Q_BYTES;                       // [ST][NC][BK][RB]
  uint8_t* sV = sK + ST * T::KV_BYTES;                 // the same
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + ST * T::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int n_qb = gridDim.x;
  // the block's first local row, longest rows first
  const int q0 = (n_qb - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_row = b * (H / group) + h / group;

  // key tiles with at least one visible entry for some row of this block
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? q_offset + q_last + 1 : Sk;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - kt0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumers);
      mbar_init(v_empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, broadcast so ptxas sees it uniform: only then does
  // it give each side the registers its setmaxnreg names
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers / 128) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // thread issues every copy ----------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(q_full, T::Q_BYTES);
    for (int c = 0; c < NC; ++c)
      tma_load(sQ + c * kBQ * RB, &q_map, q_full, c * T::BW, q0, b * H + h);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % ST;
      const uint32_t parity = ((it / ST) - 1) & 1;
      const int k0 = (kt0 + it) * BK;
      if (it >= ST) mbar_wait(k_empty + st, parity);
      mbar_expect_tx(k_full + st, T::KV_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(sK + st * T::KV_BYTES + c * BK * RB, &k_map, k_full + st,
                 c * T::BW, k0, kv_row);
      if (it >= ST) mbar_wait(v_empty + st, parity);
      mbar_expect_tx(v_full + st, T::KV_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(sV + st * T::KV_BYTES + c * BK * RB, &v_map, v_full + st,
                 c * T::BW, k0, kv_row);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each -----------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32;
  const int r_lo = q0 + 64 * wg;                        // the warpgroup's rows
  const int r0 = r_lo + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int r1 = r0 + 8;                                // this thread's rows
  const int pos_lo = q_offset + r_lo;                   // and their positions
  const int pos0 = q_offset + r0, pos1 = q_offset + r1;
  const int col = 2 * (lane % 4);                       // first column in n8

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, a0, a1;
  float s[BK / 2];
  uint32_t p[BK / 16][4], p_lo[BK / 16][4];   // P's bf16 halves

  // the descriptors of the warpgroup's q rows and of stage 0's k and v;
  // a step adds a constant offset (in 16-byte units) to the start address
  const uint64_t q_desc = make_desc(smem_addr(sQ) + 64 * wg * RB, 16, 8 * RB,
                                    T::LAYOUT);
  const uint64_t k_desc = make_desc(smem_addr(sK), 16, 8 * RB, T::LAYOUT);
  const uint64_t v_desc = make_desc(smem_addr(sV), BK * RB, 8 * RB,
                                    T::LAYOUT);
  // S = Q K^T of stage st over the computed width, 16 columns of hd a step
  auto issue_qk = [&](int st) {
    const uint64_t kd = k_desc + st * (T::KV_BYTES >> 4);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int c = kk * 16 / T::BW;
      const int off = (kk * 16 % T::BW) * 2;
      wgmma_ss(s, q_desc + ((c * kBQ * RB + off) >> 4),
               kd + ((c * BK * RB + off) >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of stage st, 16 keys a step, P as its two bf16 halves
  auto issue_pv = [&](int st) {
    const uint64_t vd = v_desc + st * (T::KV_BYTES >> 4);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs(acc, p[kk], vd + ((kk * 16 * RB) >> 4));
      wgmma_rs(acc, p_lo[kk], vd + ((kk * 16 * RB) >> 4));
    }
    wgmma_commit();
  };
  // whether every entry of the tile at k0 is visible to the warpgroup's rows
  auto all_visible = [&](int k0) {
    return k0 + BK <= Sk && (!causal || k0 + BK - 1 <= pos_lo) &&
           (window <= 0 || pos_lo + 63 - k0 < window);
  };

  mbar_wait(q_full, 0);
  // tile 0: its scores and p
  mbar_wait(k_full, 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(k_empty);
  softmax_tile<BK>(s, m0, m1, l0, l1, a0, a1, pos0, pos1, kt0 * BK, col,
                   all_visible(kt0 * BK), Sk, causal, window, scale, softcap);
  pack_p<BK>(s, p, p_lo);

  // tile it's scores on the tensor cores while tile it - 1's P V runs
  // behind them; the softmax of tile it overlaps that P V
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % ST, prev = (it - 1) % ST;
    const int k0 = (kt0 + it) * BK;
    mbar_wait(k_full + st, (it / ST) & 1);
    mbar_wait(v_full + prev, ((it - 1) / ST) & 1);
    fence_regs(s);
    fence_regs(acc);
    fence_regs(p);
    fence_regs(p_lo);
    // each product its own wgmma.fence: the scores' pipeline stage ends at
    // the first wait, so the softmax below may rewrite them while P V runs
    wgmma_fence();
    issue_qk(st);
    wgmma_fence();
    issue_pv(prev);
    wgmma_wait<1>();            // the scores are in; P V may still run
    fence_regs(s);
    mbar_arrive(k_empty + st);
    softmax_tile<BK>(s, m0, m1, l0, l1, a0, a1, pos0, pos1, k0, col,
                     all_visible(k0), Sk, causal, window, scale, softcap);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    fence_regs(p_lo);
    mbar_arrive(v_empty + prev);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i % 4) < 2 ? a0 : a1;
    pack_p<BK>(s, p, p_lo);
  }
  // the last tile's P V
  {
    const int last = (n_tiles - 1) % ST;
    mbar_wait(v_full + last, ((n_tiles - 1) / ST) & 1);
    fence_regs(acc);
    fence_regs(p);
    fence_regs(p_lo);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(v_empty + last);
  }

  // ---- epilogue: O / l in bf16, rows < Sq and columns < hd ---------------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = o + (static_cast<long long>(b) * H + h) * Sq * HD;
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const bool top = (i % 4) < 2;
    const int row = top ? r0 : r1;
    const int c = 8 * (i / 4) + col;
    if (row < Sq && c < HD) {
      const float d = top ? d0 : d1;
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<long long>(row) * HD + c) =
          __floats2bfloat162_rn(acc[i] / d, acc[i + 1] / d);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (so the library needs no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The rank-3 map (hd, S, rows) of a contiguous [rows, S, hd] bf16 tensor,
// boxes of BW columns x box_rows rows. Returns 0, or -3 if the driver
// refuses it.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int S, int rows,
             int box_rows) {
  using T = Tiles<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[3] = {cuuint64_t(HD), cuuint64_t(S),
                              cuuint64_t(rows)};
  const cuuint64_t strides[2] = {cuuint64_t(HD) * 2,
                                 cuuint64_t(S) * HD * 2};
  const cuuint32_t box[3] = {cuuint32_t(T::BW), cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int Sq, int Sk, int q_offset, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  using T = Tiles<HD>;
  static_assert(T::SMEM <= 232448, "tiles exceed the shared memory");
  auto kernel = flash_attention_wgmma_kernel<HD>;
  // the shared-memory limit is raised once a device (a host call a launch
  // would cost the host-bound small shapes)
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set[device] = true;
  }
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map<HD>(&q_map, q, Sq, B * H, kBQ);
  if (rc == 0) rc = make_map<HD>(&k_map, k, Sk, B * K, T::BK);
  if (rc == 0) rc = make_map<HD>(&v_map, v, Sk, B * K, T::BK);
  if (rc != 0) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), H, H / K, Sq, Sk,
      q_offset, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one bf16 attention of q [B,H,Sq,hd], its rows at positions
// q_offset .. q_offset + Sq - 1, over k and v [B,K,Sk,hd] into o
// [B,H,Sq,hd], on `stream`. Returns the cudaGetLastError() code of the
// launch (0 on success), -1 for an hd this file was not instantiated for,
// -2 if (grid_x, grid_y, grid_z), the wrapper's grid, is not the one this
// file's tiling needs, or -3 if the driver refused a TMA tensor map.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int K, int Sq, int Sk,
                                 int q_offset, int hd, int causal, int window,
                                 float scale, float softcap, int grid_x,
                                 int grid_y, int grid_z, void* stream) {
  if (grid_x != (Sq + kBQ - 1) / kBQ || grid_y != H || grid_z != B)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal, window,
                        scale, softcap, st);
    case 64:
      return launch<64>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal, window,
                        scale, softcap, st);
    case 112:
      return launch<112>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                         window, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                         window, scale, softcap, st);
    case 224:
      return launch<224>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                         window, scale, softcap, st);
    case 256:
      return launch<256>(q, k, v, o, B, H, K, Sq, Sk, q_offset, causal,
                         window, scale, softcap, st);
    default:
      return -1;
  }
}

}  // extern "C"
