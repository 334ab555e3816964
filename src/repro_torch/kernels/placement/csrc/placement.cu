// Fused LP placement attempt of the batched fleet engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/placement/placement.py::fused_place
// (Pallas body _placement_kernel). It computes what the plain version
// kernels/placement/ref.py::_fused_place_math computes, for every replica:
//
//   1. the §IV.B.2 multi-containment query on every device, for the
//      preferred config (lp2) and the fallback (lp4): the earliest
//      start = max(t1, q1) of a valid window with start + dur <= min(t2, dl);
//   2. device selection: key = start (BIG if none) minus SRC_PREF on the
//      source device; the smallest key wins, the first device on ties;
//      lp2 is kept when it placed, lp4 is used only when lp2 did not;
//   3. the §IV.A.1 fan-out commit of [start, start + dur) on the selected
//      device, in every config list: the OCC_TABLE[cfg, list] tracks of
//      largest overlap are trimmed, both surviving remainders are kept, a
//      straddle's right piece spills into the first free slot, and pieces
//      that find no slot are counted as dropped.
//
// The commit is made IN PLACE on t1, t2 and valid, as the Pallas kernel does
// through its input/output aliases. Rows with ok == false are not written.
//
// Design: one thread per replica, blocks of 128 threads, the ragged last
// block masked. A replica's 384 windows (Dev=4 x CFG=3 x T=2 x W=16) are
// read straight from global memory; one track (W windows) is held in
// registers while it is trimmed. The overlap of a track is summed lane 0 to
// lane W-1 in sequence, the order the plain version and XLA use: a
// different order can flip a near-tie in the track ranking. There are no
// multiplies; build with --fmad=false and without --use_fast_math anyway, so
// that every f32 result is bit-identical to the plain version.
//
// Bound: a launch reads at least the queried windows of every replica,
// B x 2 configs x Dev x T x W windows of 9 bytes (t1, t2, valid), about
// 19 MB at B=8192, and writes the committed device's 96 windows of each
// placed replica. Its arithmetic is a few compares and adds per window and
// does not bound it. On chip_smoke.py's B=8192 rows that is 27 MB, 8.1 us at
// 3.35 TB/s, and the kernel takes 106 us (NVIDIA H100 80GB HBM3, 700 W):
// replica-per-thread loads are strided 1.5 KB apart across a warp, so they
// coalesce poorly, and 64 blocks leave half the SMs idle. Making it fast (a
// warp per replica, lanes over the 32 (T, W) slots of a config list) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCfg = 3;
constexpr int kThreads = 128;

template <int T, int W>
__global__ void __launch_bounds__(kThreads) fused_place_kernel(
    float* __restrict__ t1, float* __restrict__ t2, uint8_t* __restrict__ valid,
    const float* __restrict__ min_dur, const float* __restrict__ q1,
    const float* __restrict__ dl, const int32_t* __restrict__ src,
    const uint8_t* __restrict__ do_mask, uint8_t* __restrict__ ok_out,
    int32_t* __restrict__ sel_out, float* __restrict__ start_out,
    float* __restrict__ dur_out, uint8_t* __restrict__ use4_out,
    int32_t* __restrict__ drop_out, int n_rows, int n_dev, int cfg_pref,
    int cfg_fallback, int occ_bits, float big, float src_pref) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_rows) return;
  constexpr int TW = T * W;
  const long long dev_stride = (long long)kCfg * TW;
  const long long row = (long long)b * n_dev * dev_stride;
  const int my_src = src[b];

  // -- 1 + 2: query both configs on every device and select one ----------
  bool ok_c[2];
  int sel_c[2];
  float start_c[2], dur_c[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ci = k == 0 ? cfg_pref : cfg_fallback;
    const float dur = min_dur[b * kCfg + ci];
    float kmin = 0.0f, best_sel = 0.0f;
    bool found_sel = false;
    int sel = 0;
    for (int d = 0; d < n_dev; ++d) {
      const long long base = row + d * dev_stride + ci * TW;
      const float qd = q1[b * n_dev + d];
      const float dd = dl[b * n_dev + d];
      float best = big;
#pragma unroll 8
      for (int i = 0; i < TW; ++i) {
        const float startw = fmaxf(t1[base + i], qd);
        const bool feas =
            valid[base + i] && (startw + dur <= fminf(t2[base + i], dd));
        best = fminf(best, feas ? startw : big);
      }
      const bool found = best < big;
      const float key = (found ? best : big) - (d == my_src ? src_pref : 0.0f);
      if (d == 0 || key < kmin) {  // strict: the first device wins ties
        kmin = key;
        sel = d;
        found_sel = found;
        best_sel = best;
      }
    }
    ok_c[k] = found_sel;
    sel_c[k] = sel;
    // the plain version sums a one-hot row (0 + best): same value, and the
    // same +0 for a -0 start
    start_c[k] = 0.0f + best_sel;
    dur_c[k] = dur;
  }
  const bool use4 = !ok_c[0] && ok_c[1];
  const bool ok = (ok_c[0] || ok_c[1]) && do_mask[b] != 0;
  const int sel = use4 ? sel_c[1] : sel_c[0];
  const float start = use4 ? start_c[1] : start_c[0];
  const float dur = use4 ? dur_c[1] : dur_c[0];
  int n_drop = 0;

  // -- 3: fan-out commit of [s, e) on device `sel`, in place --------------
  if (ok) {
    const int cfg_commit = use4 ? cfg_fallback : cfg_pref;
    const float s = start;
    const float e = start + dur;
    for (int li = 0; li < kCfg; ++li) {
      const long long base = row + sel * dev_stride + li * TW;
      float* lt1 = t1 + base;
      float* lt2 = t2 + base;
      uint8_t* lv = valid + base;
      const float md = min_dur[b * kCfg + li];
      // 3-bit fields, row-major over (task config, list config)
      const int occ = (occ_bits >> (3 * (cfg_commit * kCfg + li))) & 7;

      // overlap of every track with [s, e), summed lane 0..W-1 in order
      float ol[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float a1 = lt1[t * W + w], a2 = lt2[t * W + w];
          const bool ov = lv[t * W + w] && a1 < e && s < a2;
          acc = acc + (ov ? fminf(a2, e) - fmaxf(a1, s) : 0.0f);
        }
        ol[t] = acc;
      }

#pragma unroll
      for (int t = 0; t < T; ++t) {
        // descending rank by overlap, the first track wins ties
        int rank = 0;
#pragma unroll
        for (int j = 0; j < T; ++j)
          rank += (ol[j] > ol[t]) || (ol[j] == ol[t] && j < t);
        const bool active = rank < occ && ol[t] > 0.0f;

        float nt1[W], nt2[W];
        bool nv[W], both[W];
        int first_free = W, first_both = W;
        float sp_t1 = 0.0f, sp_t2 = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float a1 = lt1[t * W + w], a2 = lt2[t * W + w];
          const bool v = lv[t * W + w] != 0;
          const bool ov = v && a1 < e && s < a2 && active;
          const float left_t2 = fminf(a2, s);
          const float right_t1 = fmaxf(a1, e);
          const bool left_ok = ov && (left_t2 - a1 >= md);
          const bool right_ok = ov && (a2 - right_t1 >= md);
          both[w] = left_ok && right_ok;
          nv[w] = ov ? (left_ok || right_ok) : v;
          nt1[w] = nv[w] ? ((ov && !left_ok && right_ok) ? right_t1 : a1) : big;
          nt2[w] = nv[w] ? ((ov && left_ok) ? left_t2 : a2) : big;
          if (!nv[w] && first_free == W) first_free = w;
          if (both[w] && first_both == W) {
            first_both = w;
            sp_t1 = 0.0f + right_t1;  // one-hot sum in the plain version
            sp_t2 = 0.0f + a2;
          }
        }
        const bool placed = first_both < W && first_free < W;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          n_drop += both[w] && !(placed && w == first_both);
          const bool place = placed && w == first_free;
          lt1[t * W + w] = place ? sp_t1 : nt1[w];
          lt2[t * W + w] = place ? sp_t2 : nt2[w];
          lv[t * W + w] = (nv[w] || place) ? 1 : 0;
        }
      }
    }
  }
  ok_out[b] = ok ? 1 : 0;
  sel_out[b] = sel;
  start_out[b] = start;
  dur_out[b] = dur;
  use4_out[b] = use4 ? 1 : 0;
  drop_out[b] = n_drop;
}

template <int T, int W>
void launch(void* t1, void* t2, void* valid, const void* min_dur, const void* q1,
            const void* dl, const void* src, const void* do_mask, void* ok,
            void* sel, void* start, void* dur, void* use4, void* n_drop,
            int n_rows, int n_dev, int cfg_pref, int cfg_fallback, int occ_bits,
            float big, float src_pref, cudaStream_t stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  fused_place_kernel<T, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(t1), static_cast<float*>(t2),
      static_cast<uint8_t*>(valid), static_cast<const float*>(min_dur),
      static_cast<const float*>(q1), static_cast<const float*>(dl),
      static_cast<const int32_t*>(src), static_cast<const uint8_t*>(do_mask),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(sel),
      static_cast<float*>(start), static_cast<float*>(dur),
      static_cast<uint8_t*>(use4), static_cast<int32_t*>(n_drop), n_rows, n_dev,
      cfg_pref, cfg_fallback, occ_bits, big, src_pref);
}

}  // namespace

extern "C" {

// Launches one placement attempt on `stream`. Returns 0, the
// cudaGetLastError() code of the launch, -1 for a (T, W) this file was not
// built for (the fleet's T=2 tracks of W=16 windows), or -2 if grid_x, the
// wrapper's grid, is not the one this file's tiling needs. The caller
// checks shapes, types and contiguity.
int fused_place_launch(void* t1, void* t2, void* valid, const void* min_dur,
                       const void* q1, const void* dl, const void* src,
                       const void* do_mask, void* ok, void* sel, void* start,
                       void* dur, void* use4, void* n_drop, int n_rows,
                       int n_dev, int n_tracks, int n_windows, int cfg_pref,
                       int cfg_fallback, int occ_bits, float big,
                       float src_pref, int grid_x, void* stream) {
  if (grid_x != (n_rows + kThreads - 1) / kThreads) return -2;
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FP_ARGS                                                             \
  t1, t2, valid, min_dur, q1, dl, src, do_mask, ok, sel, start, dur, use4, \
      n_drop, n_rows, n_dev, cfg_pref, cfg_fallback, occ_bits, big,        \
      src_pref, st
  if (n_tracks == 2 && n_windows == 16) {
    launch<2, 16>(FP_ARGS);
  } else {
    return -1;
  }
#undef FP_ARGS
  return static_cast<int>(cudaGetLastError());
}

const char* fused_place_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
