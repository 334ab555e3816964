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
// the unbatched form (a row a device) takes them by value, already rounded
// to f32.
//
// Design: a group of G lanes a row, G = ceil(T*W / 4) rounded up to a power
// of two and at most 32 (window_query.py::group_size): 8 lanes at the
// fleet's T = 2, W = 16, so 4 rows a warp. Lane g of a group owns chunks
// g, g + G, ... of 4 consecutive windows (one chunk a lane wherever
// T*W <= 128; spare lanes, as at T = 3, W = 16, own none and hold +inf, the
// identity of the min), and takes the chunk's min, then the group takes its
// min with a butterfly of log2(G) __shfl_xor_sync steps that stays inside
// the group. A block of 8 warps covers one contiguous tile of 8 * (32 / G)
// rows (window_query.py::rows_per_block). There is no grid-stride loop: a
// block's tile is what geometry.py declares to the launch checker. The
// ragged last tile is masked; a group past the last row addresses the last
// row, loads nothing and stores nothing.
//
// Two routes, both this kernel (kVec):
//   vector: a chunk is a 16-byte load of t1, one of t2, and the chunk's 4
//     valid bytes as one 32-bit word (byte k is window k);
//   scalar: the same chunks element by element, for layouts the vector
//     loads cannot take: a row start of t1 or t2 that is not 16-byte
//     aligned or of valid not 4-byte aligned, T*W % 4 != 0, or an outer
//     stride that is not a multiple of 4 elements. A window past T*W loads
//     as not valid; its key is big, which leaves the min as it is, since
//     every row has a window and so a min of at most big.
// The wrapper picks the route (window_query.py::route); the entry points
// refuse the vector route on a layout it cannot load (-1) rather than fault.
// A launch whose windows exceed half the L2 loads them evict-first
// (ld.global.cs; kStreamBytes); a smaller one through the read-only path,
// so that a warm reader (the fleet reads its windows again in the same
// tick) still finds them.
//
// Indices are 32-bit where every element offset a launch makes fits an int
// (the entry points check), else 64-bit (kWide). A device count of 1 is its
// own instantiation (kDev = 1): the fleet's [B,1,T,W] HP view and the
// unbatched form, where a row is a replica (a device) and needs no division;
// other counts divide the row by n_dev at run time. Every group size (1 to
// 32), route, form and index width is instantiated: 72 kernels, 27-40
// registers, no spills. Both special cases pay for themselves on the card
// (tools/time_window_query.py call wq5, each build twice, warm device time,
// NVIDIA H100 80GB HBM3, 700 W): without kDev = 1 the fleet's HP view takes
// 1.97-1.98 us against 1.91-1.92 and 1024 devices 1.69-1.70 against
// 1.62-1.63; with 64-bit indices only, B 8192 x 4 takes 3.49-3.53 against
// 2.93-3.02; the runs of one build differ by 0.01-0.09.
//
// Min, max and compare are exact and the only add is start + dur
// (__fadd_rn, never contracted), so the result equals the plain version bit
// for bit whatever the order of the mins. Inputs are NaN-free (window
// bounds and times).
//
// Bound on the H100: each window is read once, 9 bytes (t1, t2, valid), plus
// 12 bytes of parameters (batched) and 8 of outputs a row; a few compares a
// window do not bound it. At the fleet's HP view (B = 8192, one device, 32
// windows) that is 2.5 MB, 0.75 us at 3.35 TB/s, below the ~1 us of device
// time a near-empty launch takes: latency bounds it there. At 262,144
// devices of 32 windows the kernel streams 77.6 MB, 23.2 us; at B 8192 x
// Dev 4, 10.1 MB, 3.01 us.
//
// Measured (tools/time_window_query.py call wq4: parent, this design, this
// design, parent; device time, cold = after a 64 MB write that evicts L2,
// NVIDIA H100 80GB HBM3, 700 W), parent -> this design: 262,144 devices
// 61.2-61.9 -> 29.9 us cold (77% of the bound); B 8192 x 4 10.8-10.9 ->
// 6.79-6.84 cold, 9.49-9.51 -> 3.00-3.01 warm (100%); the fleet's HP view
// 3.45-3.47 -> 1.91 warm; 1024 devices 1.77-1.78 -> 1.60-1.61 warm; the
// ragged cases 1.35-1.38 warm; every case faster. Cold, the flush leaves L2
// full of dirty lines that a reader's misses write back: a PyTorch sum over
// the same 10.1 MB takes 10.0-10.1 us cold and 6.6-6.7 warm. Two
// rows a lane group, loaded before either is reduced, were slower on every
// case below 10 MB (the grid halves, and with it the warps an SM), and four
// slower still. The design before this one ran a warp a row: a lane read one
// window in three narrow loads behind a 64-bit row / n_dev and a 5-step
// shuffle min, 41% of the bound at 262,144 devices.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarps = 8;                // warps a block
constexpr int kThreads = 32 * kWarps;
// windows (9 bytes each) above which a launch loads them evict-first: half
// the H100's 50 MB L2, a query that would flush most of it anyway
constexpr long long kStreamBytes = 25LL << 20;

// Lanes a row: the row's ceil(tw / 4) chunks rounded up to a power of two,
// at most a warp.
int group_for(int tw) {
  const int chunks = (tw + 3) / 4;
  int g = 1;
  while (g < chunks && g < 32) g *= 2;
  return g;
}

long long rows_per_block(int tw) { return kWarps * (32 / group_for(tw)); }

long long grid_for(long long n_rows, int tw) {
  const long long rows = rows_per_block(tw);
  return (n_rows + rows - 1) / rows;
}

struct Strides {            // element strides of one [B,Dev,...] tensor
  long long b, d;
};

struct Args {
  const float* t1;
  const float* t2;
  const uint8_t* valid;
  const float* q1;          // batched form: [B,Dev] parameters
  const float* dl;
  const float* dur;
  float q1s, dls, durs;     // unbatched form: by value
  float* start;
  int32_t* found;
  long long n_rows;
  int n_dev;
  int tw;
  Strides s_t1, s_t2, s_valid, s_q1, s_dl, s_dur;
  float big;
  bool stream;              // evict-first window loads (see load)
};

// 4 consecutive windows of a row; byte k of valid is window k's flag
struct Chunk {
  float4 t1, t2;
  uint32_t valid;
};

// A window load: evict-first in L2 (ld.global.cs) where the query streams
// more than half the L2, through the read-only path (ld.global.nc) where
// its windows may stay resident for the next reader.
template <typename T>
__device__ __forceinline__ T load(const T* p, bool stream) {
  return stream ? __ldcs(p) : __ldg(p);
}

template <bool kVec>
__device__ __forceinline__ Chunk load_chunk(const float* r1, const float* r2,
                                            const uint8_t* rv, int c, int tw,
                                            bool stream) {
  Chunk x;
  if (kVec) {
    x.t1 = load(reinterpret_cast<const float4*>(r1) + c, stream);
    x.t2 = load(reinterpret_cast<const float4*>(r2) + c, stream);
    x.valid = load(reinterpret_cast<const unsigned int*>(rv) + c, stream);
  } else {
    float a[4], b[4];
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * c + k;
      a[k] = 0.0f;
      b[k] = 0.0f;
      if (i < tw) {
        a[k] = load(r1 + i, stream);
        b[k] = load(r2 + i, stream);
        v |= (uint32_t)load(rv + i, stream) << (8 * k);
      }
    }
    x.t1 = make_float4(a[0], a[1], a[2], a[3]);
    x.t2 = make_float4(b[0], b[1], b[2], b[3]);
    x.valid = v;
  }
  return x;
}

// A window's key: its start where it is feasible, big where it is not
__device__ __forceinline__ float key(float t1, float t2, uint32_t valid,
                                     float q1, float dl, float dur,
                                     float big) {
  const float s = fmaxf(t1, q1);
  return (valid != 0u && __fadd_rn(s, dur) <= fminf(t2, dl)) ? s : big;
}

__device__ __forceinline__ float chunk_min(const Chunk& x, float q1,
                                           float dl, float dur, float big) {
  const float k0 = key(x.t1.x, x.t2.x, x.valid & 0xffu, q1, dl, dur, big);
  const float k1 = key(x.t1.y, x.t2.y, x.valid & 0xff00u, q1, dl, dur, big);
  const float k2 = key(x.t1.z, x.t2.z, x.valid & 0xff0000u, q1, dl, dur, big);
  const float k3 = key(x.t1.w, x.t2.w, x.valid & 0xff000000u, q1, dl, dur,
                       big);
  return fminf(fminf(k0, k1), fminf(k2, k3));
}

template <int kGroup, bool kVec, bool kBatched, int kDev, bool kWide>
__global__ void __launch_bounds__(kThreads) window_query_kernel(const Args a) {
  using Idx = typename std::conditional<kWide, long long, int>::type;
  constexpr int kRowsPerWarp = 32 / kGroup;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const Idx n_rows = (Idx)a.n_rows;
  const Idx row = (Idx)blockIdx.x * (kWarps * kRowsPerWarp) +
                  (Idx)((threadIdx.x >> 5) * kRowsPerWarp + lane / kGroup);
  const bool live = row < n_rows;
  const Idx r = live ? row : n_rows - 1;
  Idx b = r, d = 0;
  if (kDev != 1) {
    b = r / (Idx)a.n_dev;
    d = r - b * (Idx)a.n_dev;
  }
  const float* r1 = a.t1 + (b * (Idx)a.s_t1.b + d * (Idx)a.s_t1.d);
  const float* r2 = a.t2 + (b * (Idx)a.s_t2.b + d * (Idx)a.s_t2.d);
  const uint8_t* rv = a.valid + (b * (Idx)a.s_valid.b + d * (Idx)a.s_valid.d);
  float q1 = a.q1s, dl = a.dls, dur = a.durs;
  if (kBatched) {
    q1 = __ldg(a.q1 + (b * (Idx)a.s_q1.b + d * (Idx)a.s_q1.d));
    dl = __ldg(a.dl + (b * (Idx)a.s_dl.b + d * (Idx)a.s_dl.d));
    dur = __ldg(a.dur + (b * (Idx)a.s_dur.b + d * (Idx)a.s_dur.d));
  }

  // one chunk a lane wherever T*W <= 4 * kGroup
  const int n_chunks = (a.tw + 3) >> 2;
  float best = INFINITY;
  for (int c = g; live && c < n_chunks; c += kGroup)
    best = fminf(best, chunk_min(load_chunk<kVec>(r1, r2, rv, c, a.tw,
                                                  a.stream),
                                 q1, dl, dur, a.big));

#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));

  if (live && g == 0) {
    a.start[row] = best;
    a.found[row] = best < a.big ? 1 : 0;
  }
}

// Whether the vector route can load this layout: T*W a multiple of 4, every
// row start of t1 and t2 16-byte aligned and of valid 4-byte aligned (the
// base pointers, and the strides of every outer dim longer than 1 a
// multiple of 4 elements). window_query.py::route states the same rule.
bool vec_layout(const Args& a, long long B, int n_dev) {
  if (a.tw % 4 != 0) return false;
  if (reinterpret_cast<uintptr_t>(a.t1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.t2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.valid) % 4 != 0)
    return false;
  for (const Strides& s : {a.s_t1, a.s_t2, a.s_valid})
    if ((B > 1 && s.b % 4 != 0) || (n_dev > 1 && s.d % 4 != 0)) return false;
  return true;
}

// Whether every element offset of the launch fits an int, and every row
// index of its tiles: the largest offset a tensor is reached at (B-1, Dev-1)
// plus its span (T*W windows, one parameter).
bool fits_int(const Args& a, long long B, int n_dev, bool batched) {
  auto last = [&](const Strides& s, long long span) {
    return (B - 1) * s.b + (n_dev - 1) * s.d + span;
  };
  long long top = a.n_rows + rows_per_block(a.tw);
  for (const Strides& s : {a.s_t1, a.s_t2, a.s_valid})
    top = top > last(s, a.tw) ? top : last(s, a.tw);
  if (batched)
    for (const Strides& s : {a.s_q1, a.s_dl, a.s_dur})
      top = top > last(s, 1) ? top : last(s, 1);
  return top < INT_MAX;
}

template <bool kVec, bool kBatched, int kDev, bool kWide>
void launch_group(const Args& a, int grid, cudaStream_t stream) {
  switch (group_for(a.tw)) {
#define WQ_GROUP(G)                                                      \
  case G:                                                                \
    window_query_kernel<G, kVec, kBatched, kDev, kWide>                  \
        <<<grid, kThreads, 0, stream>>>(a);                              \
    break;
    WQ_GROUP(1)
    WQ_GROUP(2)
    WQ_GROUP(4)
    WQ_GROUP(8)
    WQ_GROUP(16)
    WQ_GROUP(32)
#undef WQ_GROUP
  }
}

template <bool kBatched, int kDev>
int launch(Args a, long long B, int n_dev, int vec, int grid, void* stream) {
  if (vec && !vec_layout(a, B, n_dev)) return -1;
  a.stream = a.n_rows * a.tw * 9 > kStreamBytes;
  const bool wide = !fits_int(a, B, n_dev, kBatched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (wide) launch_group<true, kBatched, kDev, true>(a, grid, st);
    else launch_group<true, kBatched, kDev, false>(a, grid, st);
  } else {
    if (wide) launch_group<false, kBatched, kDev, true>(a, grid, st);
    else launch_group<false, kBatched, kDev, false>(a, grid, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the batched query over t1, t2 [B,Dev,T,W] (float), valid
// (bytes) and q1, deadline, dur [B,Dev] (float) into start [B,Dev] (float)
// and found [B,Dev] (int32, both contiguous), on `stream`. Each input comes
// with its replica and device strides in elements; tw = T*W windows of a
// row lie contiguous. vec != 0 takes the vector route, 0 the scalar one.
// grid_x is the wrapper's grid. Returns 0, the cudaGetLastError() code,
// -1 for the vector route on a layout it cannot load, or -2 if grid_x is
// not the one this file's tiling needs.
int window_query_batched_launch(
    const void* t1, const void* t2, const void* valid, const void* q1,
    const void* dl, const void* dur, void* start, void* found, int B,
    int n_dev, int tw, long long t1_sb, long long t1_sd, long long t2_sb,
    long long t2_sd, long long valid_sb, long long valid_sd, long long q1_sb,
    long long q1_sd, long long dl_sb, long long dl_sd, long long dur_sb,
    long long dur_sd, float big, int vec, int grid_x, void* stream) {
  const long long n_rows = (long long)B * n_dev;
  if (grid_x != grid_for(n_rows, tw)) return -2;
  if (n_rows == 0) return 0;
  const Args a{static_cast<const float*>(t1), static_cast<const float*>(t2),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(q1), static_cast<const float*>(dl),
               static_cast<const float*>(dur), 0.0f, 0.0f, 0.0f,
               static_cast<float*>(start), static_cast<int32_t*>(found),
               n_rows, n_dev, tw, Strides{t1_sb, t1_sd},
               Strides{t2_sb, t2_sd}, Strides{valid_sb, valid_sd},
               Strides{q1_sb, q1_sd}, Strides{dl_sb, dl_sd},
               Strides{dur_sb, dur_sd}, big};
  return n_dev == 1 ? launch<true, 1>(a, B, n_dev, vec, grid_x, stream)
                    : launch<true, 0>(a, B, n_dev, vec, grid_x, stream);
}

// Launches the unbatched query over t1, t2 [Dev,T,W] (float) and valid
// (bytes), each with its device stride in elements, with q1, deadline and
// dur by value, into start [Dev] (float) and found [Dev] (int32). Returns
// as window_query_batched_launch does.
int window_query_launch(const void* t1, const void* t2, const void* valid,
                        void* start, void* found, int n_dev, int tw,
                        long long t1_sd, long long t2_sd, long long valid_sd,
                        float q1, float dl, float dur, float big, int vec,
                        int grid_x, void* stream) {
  if (grid_x != grid_for(n_dev, tw)) return -2;
  if (n_dev == 0) return 0;
  const Strides none{0, 0};
  const Args a{static_cast<const float*>(t1), static_cast<const float*>(t2),
               static_cast<const uint8_t*>(valid), nullptr, nullptr, nullptr,
               q1, dl, dur, static_cast<float*>(start),
               static_cast<int32_t*>(found), n_dev, 1, tw,
               Strides{t1_sd, 0}, Strides{t2_sd, 0}, Strides{valid_sd, 0},
               none, none, none, big};
  return launch<false, 1>(a, n_dev, 1, vec, grid_x, stream);
}

const char* window_query_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
