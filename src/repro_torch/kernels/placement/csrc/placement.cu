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
// With a counts pointer, the launch also adds its rows attempted (do) and
// committed (ok) to counts[0] and counts[1]: each block counts its replicas
// with __syncthreads_count and adds with one atomic a counter. With a null
// pointer it does nothing more.
//
// Design: one warp per replica, 8 warps (8 replicas) a block. A config list
// of a device is T x W = 32 slots of 9 bytes (t1, t2, valid), contiguous,
// and lane l = t*W + w owns slot (t, w) of every list, so a list is read as
// one 128-byte line of t1, one of t2 and 32 bytes of valid.
//   1-2. The lanes load their slot of the lp2 and lp4 lists of 4 devices at
//        once (24 loads in flight), then each list's earliest start is a
//        butterfly min (__shfl_xor_sync; a min is exact in any order), the
//        8 lists' butterflies step by step so their shuffles overlap. The
//        selection is then computed by every lane alike (warp-uniform), with
//        the strict < that keeps the first device on ties.
//   3.   A track's overlap must be summed lane w = 0 .. W-1 in sequence from
//        0.0f, the order the plain version (tensor_state._seq_sum) and XLA
//        use: a tree order can flip a near-tie in the track ranking and trim
//        another track (the "overlap_sum_order" row of
//        kernels/placement/cases.py). So each lane adds its track's W
//        overlaps in order, read by __shfl_sync, the two tracks' chains side
//        by side. Each lane trims its own window; first_free and first_both
//        of a track are __ffs of a __ballot_sync masked to the track's W
//        bits; the spill pair is read from lane first_both by a shuffle;
//        n_dropped is a __popc of the dropped ballot. Lane 0 writes the
//        per-replica outputs.
// No shuffle sits under a branch: a warp past the last replica runs the last
// one's numbers and stores nothing, and the commit is computed on every row
// and stored only on ok rows, where a branch on ok would be warp-uniform but
// not provably so to the compiler, which then guards every shuffle with a
// divergence check and a slow path (twice the code, and no faster on the
// card). The fleet's 4 devices are a template argument (kDev), so every
// window address is the replica's base plus a constant; another device count
// takes the same code with n_dev read at run time. At n_dev = 4 the run-time
// kernel took 14.1 us warm and 18.2 us cold against 13.0-13.1 and 17.6 for
// kDev = 4 (tools/time_fused_place.py, NVIDIA H100 80GB HBM3, 700 W), hence
// the second instantiation. 4 blocks an SM hold the kernel to 64 registers
// without spills.
// There are no multiplies; the adds are __fadd_rn, and the build uses
// --fmad=false and no --use_fast_math anyway, so that every f32 result is
// bit-identical to the plain version.
//
// Bound: a launch reads at least the queried windows of every replica,
// B x 2 configs x Dev x T x W windows of 9 bytes, and the hp list of each
// placed replica's device, and writes the committed device's 96 windows of
// each placed replica. Its arithmetic is a few compares and adds a window
// and does not bound it. On chip_smoke.py's B = 8192 rows that is 27 MB,
// 8.06 us at 3.35 TB/s. The whole fleet's windows (8192 x 384 x 9 B, 28 MB)
// fit the H100's 50 MB L2, so a launch that finds them there (as the fleet's
// consecutive attempts do) may read them faster than HBM allows. The design
// before this one ran a thread per replica in blocks of 128 and took
// 107.5-108.2 us warm and 111.4 us cold there (device time, 168 registers;
// tools/time_fused_place.py, NVIDIA H100 80GB HBM3, 700 W): neighbouring
// threads read addresses 1.5 KB apart, so no load coalesced, and 64 blocks
// left half of the 132 SMs idle. A warp per replica makes every load a whole
// line and gives 1,024 blocks at B = 8192: 13.0-13.1 us warm and 17.6 us
// cold (46% of the bound), 62 registers, no spills (same script and card).
// What is left is latency: a warp's commit loads wait on its query's
// selection.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCfg = 3;
constexpr int kWarps = 8;               // replicas a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;           // blocks an SM: at most 64 registers
constexpr int kDevChunk = 4;            // devices whose lists load together
constexpr unsigned kFull = 0xffffffffu;

// kDev > 0 fixes the device count at compile time (the fleet's 4), so
// every window address is the replica's base plus a constant; kDev == 0
// reads it from n_dev_arg.
template <int T, int W, int kDev>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_place_kernel(
    float* __restrict__ t1, float* __restrict__ t2, uint8_t* __restrict__ valid,
    const float* __restrict__ min_dur, const float* __restrict__ q1,
    const float* __restrict__ dl, const int32_t* __restrict__ src,
    const uint8_t* __restrict__ do_mask, uint8_t* __restrict__ ok_out,
    int32_t* __restrict__ sel_out, float* __restrict__ start_out,
    float* __restrict__ dur_out, uint8_t* __restrict__ use4_out,
    int32_t* __restrict__ drop_out,
    unsigned long long* __restrict__ counts, int n_rows, int n_dev_arg,
    int cfg_pref, int cfg_fallback, int occ_bits, float big, float src_pref) {
  static_assert(T * W == 32, "one lane a (track, window) slot of a list");
  constexpr int TW = T * W;
  constexpr int kLists = 2 * kDevChunk;   // lp2 and lp4 lists of a chunk
  const int n_dev = kDev > 0 ? kDev : n_dev_arg;
  const int lane = threadIdx.x & 31;
  // A warp past the last replica runs the last one's numbers and stores
  // nothing: no lane leaves early, so every shuffle finds the warp whole.
  const int b_warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = b_warp < n_rows;
  const int b = live ? b_warp : n_rows - 1;
  // this lane's slot in list 0 of device 0 of the replica
  const size_t row = (size_t)b * n_dev * kCfg * TW + lane;
  float* r1 = t1 + row;
  float* r2 = t2 + row;
  uint8_t* rv = valid + row;
  const float* q1b = q1 + (size_t)b * n_dev;
  const float* dlb = dl + (size_t)b * n_dev;
  const int my_src = src[b];
  const int cfg_k[2] = {cfg_pref, cfg_fallback};
  const float dur_k[2] = {min_dur[b * kCfg + cfg_pref],
                          min_dur[b * kCfg + cfg_fallback]};

  // -- 1 + 2: query both configs on every device and select one ----------
  float kmin[2] = {0.0f, 0.0f}, best_sel[2] = {0.0f, 0.0f};
  bool found_sel[2] = {false, false};
  int sel_k[2] = {0, 0};
  for (int d0 = 0; d0 < n_dev; d0 += kDevChunk) {
    // list i = j * 2 + k: device d0 + j (the last device stands in past
    // n_dev), config cfg_k[k]; every load is issued before any reduction
    float v[kLists];
#pragma unroll
    for (int j = 0; j < kDevChunk; ++j) {
      const int d = min(d0 + j, n_dev - 1);
      const float qd = q1b[d], dd = dlb[d];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int at = (d * kCfg + cfg_k[k]) * TW;
        const float startw = fmaxf(r1[at], qd);
        const bool feas = rv[at] != 0 &&
                          __fadd_rn(startw, dur_k[k]) <= fminf(r2[at], dd);
        v[j * 2 + k] = feas ? startw : big;
      }
    }
    // the 8 butterfly mins, step by step, so their shuffles overlap
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kLists; ++i)
        v[i] = fminf(v[i], __shfl_xor_sync(kFull, v[i], o));
    }
#pragma unroll
    for (int j = 0; j < kDevChunk; ++j) {
      const int d = d0 + j;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float best = v[j * 2 + k];
        const bool found = best < big;
        const float key =
            __fsub_rn(found ? best : big, d == my_src ? src_pref : 0.0f);
        // strict: the first device wins ties
        if (d < n_dev && (d == 0 || key < kmin[k])) {
          kmin[k] = key;
          sel_k[k] = d;
          found_sel[k] = found;
          best_sel[k] = best;
        }
      }
    }
  }
  const bool use4 = !found_sel[0] && found_sel[1];
  const bool ok = (found_sel[0] || found_sel[1]) && do_mask[b] != 0;
  const int sel = use4 ? sel_k[1] : sel_k[0];
  // the plain version sums a one-hot row (0 + best): same value, and the
  // same +0 for a -0 start
  const float start = __fadd_rn(0.0f, use4 ? best_sel[1] : best_sel[0]);
  const float dur = use4 ? dur_k[1] : dur_k[0];

  // -- 3: fan-out commit of [s, e) on device `sel`, in place --------------
  // Computed on every row, stored only on ok rows (so no shuffle sits
  // under a branch).
  const int cfg_commit = use4 ? cfg_fallback : cfg_pref;
  const float s = start;
  const float e = __fadd_rn(start, dur);
  const int t = lane / W, w = lane % W;
  const unsigned track_bits = ((1u << W) - 1u) << (t * W);
  const bool store = live && ok;
  float* c1 = r1 + sel * kCfg * TW;
  float* c2 = r2 + sel * kCfg * TW;
  uint8_t* cv = rv + sel * kCfg * TW;
  float a1[kCfg], a2[kCfg];
  bool av[kCfg];
#pragma unroll
  for (int li = 0; li < kCfg; ++li) {
    a1[li] = c1[li * TW];
    a2[li] = c2[li * TW];
    av[li] = cv[li * TW] != 0;
  }
  int n_drop = 0;
#pragma unroll
  for (int li = 0; li < kCfg; ++li) {
    const float md = min_dur[b * kCfg + li];
    // 3-bit fields, row-major over (task config, list config)
    const int occ = (occ_bits >> (3 * (cfg_commit * kCfg + li))) & 7;
    const bool hit = av[li] && a1[li] < e && s < a2[li];
    const float part =
        hit ? __fsub_rn(fminf(a2[li], e), fmaxf(a1[li], s)) : 0.0f;
    // overlap of this lane's track, summed lane 0..W-1 in order
    float ol = 0.0f;
#pragma unroll
    for (int j = 0; j < W; ++j)
      ol = __fadd_rn(ol, __shfl_sync(kFull, part, t * W + j));
    // descending rank by overlap, the first track wins ties
    int rank = 0;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const float olu = __shfl_sync(kFull, ol, u * W);
      rank += (olu > ol) || (olu == ol && u < t);
    }
    const bool active = rank < occ && ol > 0.0f;

    const bool ov = hit && active;
    const float left_t2 = fminf(a2[li], s);
    const float right_t1 = fmaxf(a1[li], e);
    const bool left_ok = ov && __fsub_rn(left_t2, a1[li]) >= md;
    const bool right_ok = ov && __fsub_rn(a2[li], right_t1) >= md;
    const bool both = left_ok && right_ok;
    const bool nv = ov ? (left_ok || right_ok) : av[li];
    const float nt1 =
        nv ? ((ov && !left_ok && right_ok) ? right_t1 : a1[li]) : big;
    const float nt2 = nv ? ((ov && left_ok) ? left_t2 : a2[li]) : big;

    const unsigned free_bits = __ballot_sync(kFull, !nv) & track_bits;
    const unsigned both_bits = __ballot_sync(kFull, both) & track_bits;
    const int first_free = free_bits ? __ffs(free_bits) - 1 - t * W : W;
    const int first_both = both_bits ? __ffs(both_bits) - 1 - t * W : W;
    const bool placed = first_both < W && first_free < W;
    // the straddle's right piece, from lane first_both (one-hot sums in
    // the plain version)
    const int from = t * W + (first_both < W ? first_both : 0);
    const float sp_t1 = __fadd_rn(0.0f, __shfl_sync(kFull, right_t1, from));
    const float sp_t2 = __fadd_rn(0.0f, __shfl_sync(kFull, a2[li], from));
    const bool dropped = both && !(placed && w == first_both);
    n_drop += __popc(__ballot_sync(kFull, dropped));
    const bool place = placed && w == first_free;
    if (store) {
      c1[li * TW] = place ? sp_t1 : nt1;
      c2[li * TW] = place ? sp_t2 : nt2;
      cv[li * TW] = (nv || place) ? 1 : 0;
    }
  }
  if (live && lane == 0) {
    ok_out[b] = ok ? 1 : 0;
    sel_out[b] = sel;
    start_out[b] = start;
    dur_out[b] = dur;
    use4_out[b] = use4 ? 1 : 0;
    drop_out[b] = ok ? n_drop : 0;
  }
  if (counts != nullptr) {  // the same for the whole grid
    // one warp a replica: its lane 0 stands for it
    const bool head = live && lane == 0;
    const int n_do = __syncthreads_count(head && do_mask[b] != 0);
    const int n_ok = __syncthreads_count(head && ok);
    if (threadIdx.x == 0) {
      if (n_do) atomicAdd(counts, (unsigned long long)n_do);
      if (n_ok) atomicAdd(counts + 1, (unsigned long long)n_ok);
    }
  }
}

template <int T, int W>
void launch(void* t1, void* t2, void* valid, const void* min_dur, const void* q1,
            const void* dl, const void* src, const void* do_mask, void* ok,
            void* sel, void* start, void* dur, void* use4, void* n_drop,
            void* counts, int n_rows, int n_dev, int cfg_pref,
            int cfg_fallback, int occ_bits, float big, float src_pref,
            cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  auto kernel = n_dev == 4 ? fused_place_kernel<T, W, 4>
                           : fused_place_kernel<T, W, 0>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(t1), static_cast<float*>(t2),
      static_cast<uint8_t*>(valid), static_cast<const float*>(min_dur),
      static_cast<const float*>(q1), static_cast<const float*>(dl),
      static_cast<const int32_t*>(src), static_cast<const uint8_t*>(do_mask),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(sel),
      static_cast<float*>(start), static_cast<float*>(dur),
      static_cast<uint8_t*>(use4), static_cast<int32_t*>(n_drop),
      static_cast<unsigned long long*>(counts), n_rows, n_dev, cfg_pref,
      cfg_fallback, occ_bits, big, src_pref);
}

}  // namespace

extern "C" {

// Launches one placement attempt on `stream`; `counts`, two int64 counters
// of rows attempted and committed, or null. Returns 0, the
// cudaGetLastError() code of the launch, -1 for a (T, W) this file was not
// built for (the fleet's T=2 tracks of W=16 windows), or -2 if grid_x, the
// wrapper's grid, is not the one this file's tiling needs. The caller
// checks shapes, types and contiguity.
int fused_place_launch(void* t1, void* t2, void* valid, const void* min_dur,
                       const void* q1, const void* dl, const void* src,
                       const void* do_mask, void* ok, void* sel, void* start,
                       void* dur, void* use4, void* n_drop, void* counts,
                       int n_rows, int n_dev, int n_tracks, int n_windows,
                       int cfg_pref, int cfg_fallback, int occ_bits,
                       float big, float src_pref, int grid_x, void* stream) {
  if (grid_x != (n_rows + kWarps - 1) / kWarps) return -2;
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FP_ARGS                                                             \
  t1, t2, valid, min_dur, q1, dl, src, do_mask, ok, sel, start, dur, use4, \
      n_drop, counts, n_rows, n_dev, cfg_pref, cfg_fallback, occ_bits,     \
      big, src_pref, st
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
