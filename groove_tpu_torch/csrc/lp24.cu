// lp24 cascade kernels for Hopper (sm_90a): K3, the single-pass cascade
// with block-rate denominators; K2, the same cascade with its
// defect-correction ("refine") pass; K6, the single-pass cascade with
// per-sample (or static, by-value) denominators. The stream kernels K7 and
// K8 (K3 and K2 with their state carried from call to call) live in
// lp24_stream.cu, one launch per call.
//
// Replaces groove_tpu/ops/pallas_iir.py:
//   K3  _make_kernel_lp24_blk (pallas_call in _lp24_blk_2d)
//   K2  _make_kernel_lp24_refined_blk, state_io=False (pallas_call in
//       _lp24_refined_blk_2d)
//   K6  _make_kernel_lp24 (pallas_call in _lp24_2d)
// The algorithm and its operation order are the reference's; the TPU layout
// ([G, ln, R, cb] folding, row packing, VMEM caps, lane-roll sweeps) is
// not. Two routes share tdf2.cuh's device functions, so they and the plain
// twins (ops/iir_kernels.py) agree bit for bit; the build is -fmad=false,
// every multiply and add separately rounded, except the explicit __fmaf_rn
// of the in-block recurrences (fma32 in the twins): near z = 1 the unfused
// prefix products lose about 12 dB against an f64 reference.
//
//   lp24_refined_tiled  K2, on shared-memory tiles (tiled.cuh), 9 launches:
//       section A   maps (phase 1) -> chain -> defect + correction scan
//                   -> chain -> second combine, writing the section's output
//                   ya and, in the same loop, section B's block maps;
//       section B   chain -> defect + correction scan -> chain -> second
//                   combine, writing y.
//     Every scan re-runs the solve from the staged tile and the entry
//     states, so no prefix row, solve or defect array reaches device
//     memory: the scratch is ya [B, n] and 48 bytes per ln-block (the maps
//     M, C, the entry states S, the correction's offsets R and entry
//     states Sc). The defect's history across tiles is recomputed from a
//     halo block (tiled.cuh), not exported. A long row is cut into up to 8
//     segments of whole tiles and the four chains run as a wavefront along
//     time, each on a stream of its own with its scan behind it: chain j
//     needs chain j - 1 and its scan only up to the block it has reached
//     (see Wave below). The streams fork from the caller's and join it
//     before the call returns.
//   lp24_cascade  K3 and K6; K2's earlier route (14 launches over six
//     [B, npad] scratch arrays), kept callable as the yardstick
//     lp24_refined_tiled is timed against; and the earlier stateful route
//     of the stream cascades, the yardstick of lp24_stream.cu: K3 and K2
//     with ln pinned to 64 and a State, each chain starting from the
//     carried pair and exporting its exit (tdf2::Carry), the refined
//     cascade's defect reading the previous call's z, y0 and coefficient
//     edges (History) and exporting its own (edges_kernel). None of the
//     yardsticks is on a render path. Per section: tdf2::phase1_kernel (a
//     thread per (row, ln-block) walking device memory), tdf2::chain, an
//     elementwise combine; refined adds an elementwise defect pass, an
//     r-only correction scan that reuses p11/p12, a second chain and a
//     second combine. K6 is K3 with the denominators read per sample
//     (tdf2::kSample, through strides) or passed by value (tdf2::kScalar),
//     with the caller's ln = block_for(n, 128).
//
// What bounds it on the H100: the chains (see tdf2.cuh), four per refined
// call and two per single pass, each n / ln dependent steps per row; with
// the two rows of a stereo bus nothing else is serial. One after the other
// the four chains are four times one chain's latency; as a wavefront they
// cost one chain and the pipeline's fill, which is what the tiled route
// does. Its scans run at the card's width from shared memory;
// lp24_cascade's phase 1 and correction scan are latency-bound on their
// strided walks of device memory.

#include "tdf2.cuh"
#include "tiled.cuh"

namespace {

using tdf2::Coef;
using tdf2::Layout;
using tdf2::at;
using tdf2::grid_for;
using tdf2::kBlock;
using tdf2::kThreads;

// Correction's phase 1 (numerator (1, 0, 0)): the maps are the solve's, so
// only the r terms run. Writes the shifted r1 rows to q1 and the block-end
// (r1, r2) to c. Block-rate denominators only (K2).
__global__ void corr_phase1_kernel(const float* __restrict__ d, Coef na1,
                                   Coef na2, Layout l,
                                   float* __restrict__ q1,
                                   float* __restrict__ c,
                                   int B, int64_t npad, int nb, int ln) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nb) return;
  int64_t row = t / nb;
  int64_t blk = t % nb;
  int64_t base = row * npad + blk * ln;
  float R1 = 0.0f, R2 = 0.0f;
  for (int j = 0; j < ln; ++j) {
    int64_t i = base + j;
    q1[i] = R1;
    int64_t k = blk * ln + j;
    float a = at<kBlock>(na1, l, row, k);
    float b = at<kBlock>(na2, l, row, k);
    tdf2::corr_step(a, b, d[i], R1, R2);
  }
  c[t * 2 + 0] = R1;
  c[t * 2 + 1] = R2;
}

// Combine: out = z + ((p11 S1 + p12 S2) + q1), or with the correction's
// defect d: out = z + (((d + p11 S1) + p12 S2) + q1). Writes out[row, k]
// for k < out_len with row stride out_stride.
__global__ void combine_kernel(const float* __restrict__ z,
                               const float* __restrict__ d,
                               const float* __restrict__ p11,
                               const float* __restrict__ p12,
                               const float* __restrict__ q1,
                               const float* __restrict__ s,
                               float* __restrict__ out,
                               int B, int64_t npad, int nb, int ln,
                               int64_t out_stride, int64_t out_len) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * npad) return;
  int64_t row = i / npad;
  int64_t k = i % npad;
  if (k >= out_len) return;
  int64_t st = (row * nb + k / ln) * 2;
  float S1 = s[st];
  float S2 = s[st + 1];
  float v;
  if (d != nullptr) {
    v = d[i] + p11[i] * S1 + p12[i] * S2 + q1[i];
  } else {
    v = p11[i] * S1 + p12[i] * S2 + q1[i];
  }
  out[row * out_stride + k] = z[i] + v;
}

// The history before sample 0 of one section, as the refined stream
// cascade carries it (rows 4-9 of the section's state, ops/iir_kernels.py
// STATE_ROWS): z and the solve's y0 at lags 1 and 2, and the previous
// call's last na1 and na2. Null: zero history (K2).
struct History {
  const float* p;  // z1, z2, y1, y2, na1, na2 at p[row * stride + 0..5]
  int64_t stride;
};

__device__ __forceinline__ float hist(History h, int64_t row, int j) {
  return h.p != nullptr ? h.p[row * h.stride + j] : 0.0f;
}

// Defect of the solve y0 (tdf2::lp24_defect), elementwise, with the carried
// history `h` before sample 0.
__global__ void defect_kernel(const float* __restrict__ z,
                              const float* __restrict__ y0, Coef na1,
                              Coef na2, Layout l, History h,
                              float* __restrict__ d, int B, int64_t npad) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * npad) return;
  int64_t row = i / npad;
  int64_t k = i % npad;
  float z0 = z[i];
  float z1 = k >= 1 ? z[i - 1] : hist(h, row, 0);
  float z2 = k >= 2 ? z[i - 2] : (k == 1 ? hist(h, row, 0) : hist(h, row, 1));
  float y00 = y0[i];
  float y1 = k >= 1 ? y0[i - 1] : hist(h, row, 2);
  float y2 = k >= 2 ? y0[i - 2] : (k == 1 ? hist(h, row, 2) : hist(h, row, 3));
  float a1s = k >= 1 ? at<kBlock>(na1, l, row, k - 1) : hist(h, row, 4);
  float a2s = k >= 2 ? at<kBlock>(na2, l, row, k - 2) : hist(h, row, 5);
  d[i] = tdf2::lp24_defect(z0, z1, z2, y00, y1, y2, a1s, a2s);
}

// The refined stateful route's edge export, one thread per row: the section input z and solve y0
// at the last two samples and the last block's na1, na2 go to
// out[row * stride + 0..5] (the History the next call reads).
__global__ void edges_kernel(const float* __restrict__ z,
                             const float* __restrict__ y0, Coef na1, Coef na2,
                             Layout l, float* __restrict__ out,
                             int64_t stride, int B, int64_t npad) {
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* zr = z + row * npad;
  const float* yr = y0 + row * npad;
  float* o = out + row * stride;
  o[0] = zr[npad - 1];
  o[1] = zr[npad - 2];
  o[2] = yr[npad - 1];
  o[3] = yr[npad - 2];
  o[4] = at<kBlock>(na1, l, row, npad - 1);
  o[5] = at<kBlock>(na2, l, row, npad - 1);
}

// Carried state of the stateful route, row offsets within a state row
// (ops/iir_kernels.py STATE_ROWS): [B, 4] holds each section's solve pair
// at 2 * sec; the refined [B, 20] holds per section, at base 10 * sec, the
// solve pair (+0), the correction pair (+2) and the History (+4..+9).
struct State {
  const float* in;   // null: zero state, no export (K2, K3, K6)
  float* out;
  int64_t stride;    // 4 (single pass) or 20 (refined)
};

template <int M>
void cascade(bool refined, const float* x, const Coef* na1s,
             const Coef* na2s, Layout l, State st, float* y, float* p11,
             float* p12, float* q1, float* ya, float* y0, float* d, float* m,
             float* c, float* s, int B, int64_t n, int64_t npad, int ln,
             cudaStream_t stream) {
  int nb = (int)(npad / ln);
  unsigned g_blk = grid_for((int64_t)B * nb);
  unsigned g_all = grid_for((int64_t)B * npad);
  const Coef none = {nullptr, 0.0f};
  auto carry = [&](int64_t off) {
    return st.in == nullptr
               ? tdf2::kNoCarry
               : tdf2::Carry{st.in + off, st.out + off, st.stride};
  };
  for (int sec = 0; sec < 2; ++sec) {
    const float* z = sec == 0 ? x : ya;
    float* out = sec == 0 ? ya : y;
    int64_t out_stride = sec == 0 ? npad : n;
    int64_t out_len = sec == 0 ? npad : n;
    int64_t base = refined ? 10 * sec : 2 * sec;
    tdf2::phase1_kernel<M, true><<<g_blk, kThreads, 0, stream>>>(
        z, na1s[sec], na2s[sec], none, none, l, p11, p12, q1, m, c, B, npad,
        nb, ln);
    tdf2::chain(m, c, s, nb, B, carry(base), stream);
    if (!refined) {
      combine_kernel<<<g_all, kThreads, 0, stream>>>(
          z, nullptr, p11, p12, q1, s, out, B, npad, nb, ln, out_stride,
          out_len);
      continue;
    }
    combine_kernel<<<g_all, kThreads, 0, stream>>>(
        z, nullptr, p11, p12, q1, s, y0, B, npad, nb, ln, npad, npad);
    const History h = {st.in == nullptr ? nullptr : st.in + base + 4,
                       st.stride};
    defect_kernel<<<g_all, kThreads, 0, stream>>>(
        z, y0, na1s[sec], na2s[sec], l, h, d, B, npad);
    if (st.out != nullptr) {
      edges_kernel<<<grid_for(B), kThreads, 0, stream>>>(
          z, y0, na1s[sec], na2s[sec], l, st.out + base + 4, st.stride, B,
          npad);
    }
    corr_phase1_kernel<<<g_blk, kThreads, 0, stream>>>(
        d, na1s[sec], na2s[sec], l, q1, c, B, npad, nb, ln);
    tdf2::chain(m, c, s, nb, B, carry(base + 2), stream);
    combine_kernel<<<g_all, kThreads, 0, stream>>>(
        y0, d, p11, p12, q1, s, out, B, npad, nb, ln, out_stride, out_len);
  }
}

// K2's four chains (solve and correction of sections A and B) each wait
// for the scan before them, but only up to the block they have reached: a
// long row is cut into segments of whole tiles, every chain gets a lane (a
// stream), and lane j works on segment i while lane j - 1 works on segment
// i + 1. A segment must outlast its launches by far, so short rows stay in
// one segment on the caller's stream.
constexpr int kLanes = 4;
constexpr int kMaxSegments = 8;
constexpr int kMinSegmentTiles = 32;  // about 4,000 chain steps

// The side streams and events of the wavefront, made once per device.
struct Wave {
  bool ready;
  cudaStream_t lane[kLanes];  // lane[0] is the caller's stream
  cudaEvent_t fork;
  cudaEvent_t done[kLanes][kMaxSegments];
};

int wave_of(int dev, Wave*& w) {
  static Wave waves[tiled::kMaxDevices] = {};
  w = &waves[dev];
  if (w->ready) return 0;
  cudaError_t err = cudaEventCreateWithFlags(&w->fork, cudaEventDisableTiming);
  for (int j = 0; j < kLanes && err == cudaSuccess; ++j) {
    if (j > 0)
      err = cudaStreamCreateWithFlags(&w->lane[j], cudaStreamNonBlocking);
    for (int i = 0; i < kMaxSegments && err == cudaSuccess; ++i)
      err = cudaEventCreateWithFlags(&w->done[j][i], cudaEventDisableTiming);
  }
  w->ready = err == cudaSuccess;
  return (int)err;
}

// K2 on shared-memory tiles: section A's phase 1, then per segment and
// section chain, defect + correction scan, chain, second combine (section
// A's also runs section B's phase 1). 9 launches for one segment.
// carries: [4][B][2], the state each chain hands from segment to segment.
template <int kLn>
int refined_tiled(const float* x, const tiled::Lp24* secs, float* y,
                  float* ya, float* m, float* c, float* sa, float* sb,
                  float* r, float* sc, float* carries, int B, int64_t n,
                  cudaStream_t stream) {
  constexpr int M = kBlock;
  constexpr int kBytes = tiled::smem_bytes(kLn);
  constexpr int kPer = tiled::kSlots - 1;  // blocks a tile with a halo covers
  static bool allowed[tiled::kMaxDevices] = {};
  int err = 0;
  const int dev = tiled::device_index(err);
  if (err != 0) return err;
  if (!allowed[dev]) {
    err = tiled::allow(tiled::maps_kernel<M, kLn, tiled::Lp24>, kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::defect_scan_kernel<M, kLn>, kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::refine_kernel<M, kLn, true>, kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::refine_kernel<M, kLn, false>, kBytes);
    if (err != 0) return err;
    allowed[dev] = true;
  }
  const int nb = (int)((n + kLn - 1) / kLn);
  const int tiles = tiled::tiles_of(nb, 1);
  int segments = tiles / kMinSegmentTiles;
  segments = segments < 1 ? 1 : (segments > kMaxSegments ? kMaxSegments
                                                          : segments);
  const int seg_tiles = (tiles + segments - 1) / segments;
  segments = (tiles + seg_tiles - 1) / seg_tiles;
  const bool wave = segments > 1;
  Wave* w = nullptr;
  if (wave && (err = wave_of(dev, w)) != 0) return err;
  cudaStream_t lane[kLanes];
  for (int j = 0; j < kLanes; ++j)
    lane[j] = wave && j > 0 ? w->lane[j] : stream;

  const tiled::Span all = {0, tiled::tiles_of(nb, 0)};
  tiled::maps_kernel<M, kLn, tiled::Lp24>
      <<<(unsigned)B * all.tiles, tiled::kSlots, kBytes, stream>>>(
          x, secs[0], m, c, n, nb, all);
  if (wave) {
    cudaEventRecord(w->fork, stream);
    for (int j = 1; j < kLanes; ++j) cudaStreamWaitEvent(lane[j], w->fork, 0);
  }
  for (int i = 0; i < segments; ++i) {
    const int left = tiles - i * seg_tiles;
    const tiled::Span sp = {i * seg_tiles,
                            left < seg_tiles ? left : seg_tiles};
    const unsigned g = (unsigned)B * sp.tiles;
    const int k0 = sp.tile0 * kPer;
    const int steps = nb - k0 < sp.tiles * kPer ? nb - k0 : sp.tiles * kPer;
    auto carry = [&](int j) {
      float* p = carries + (size_t)j * 2 * B;
      return tdf2::Carry{i == 0 ? nullptr : p, wave ? p : nullptr, 2};
    };
    auto handed = [&](int j) {  // lane j's segment is done: lane j + 1 may go
      if (!wave) return;
      cudaEventRecord(w->done[j][i], lane[j]);
      if (j + 1 < kLanes) cudaStreamWaitEvent(lane[j + 1], w->done[j][i], 0);
    };
    // lane 0: section A's solve chain, then its defect and correction scan
    tdf2::chain(m, c, sa, nb, B, carry(0), lane[0], k0, steps);
    tiled::defect_scan_kernel<M, kLn>
        <<<g, tiled::kSlots, kBytes, lane[0]>>>(x, secs[0], sa, r, n, nb, sp);
    handed(0);
    // lane 1: its correction chain, then its second combine, which writes
    // ya and puts section B's maps where section A's were (spent here)
    tdf2::chain(m, r, sc, nb, B, carry(1), lane[1], k0, steps);
    tiled::refine_kernel<M, kLn, true><<<g, tiled::kSlots, kBytes, lane[1]>>>(
        x, secs[0], secs[1], sa, sc, ya, m, c, n, nb, sp);
    handed(1);
    // lanes 2 and 3: the same for section B, from ya to y. Its solve's
    // entry states have their own array: a later segment's halo still
    // reads section A's.
    tdf2::chain(m, c, sb, nb, B, carry(2), lane[2], k0, steps);
    tiled::defect_scan_kernel<M, kLn>
        <<<g, tiled::kSlots, kBytes, lane[2]>>>(ya, secs[1], sb, r, n, nb,
                                                sp);
    handed(2);
    tdf2::chain(m, r, sc, nb, B, carry(3), lane[3], k0, steps);
    tiled::refine_kernel<M, kLn, false>
        <<<g, tiled::kSlots, kBytes, lane[3]>>>(ya, secs[1], secs[1], sb, sc,
                                                y, nullptr, nullptr, n, nb,
                                                sp);
    handed(3);
  }
  if (wave) {  // every lane joins the caller's stream
    for (int j = 1; j < kLanes; ++j)
      cudaStreamWaitEvent(stream, w->done[j][segments - 1], 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One cascade call over [B, n] rows. x: [B, npad], zero-padded past n;
// y: [B, n]. The negated section denominators na1a, na2a, na1b, na2b are
// read in `mode` (tdf2::Mode): kScalar takes the values v1a, v2a, v1b, v2b;
// kBlock and kSample take the arrays, all four indexed by one layout (row
// stride rs, entry stride ts, count entries per row). refined (K2, K8)
// needs kBlock. state_in/state_out: null for K2, K3 and K6; for the
// earlier route of the stream cascades (refined = 0 or 1) the carried
// state [B, 4] or [B, 20] entering and leaving the call (distinct buffers;
// the caller pins ln = 64 and n = npad, a multiple of 64, so the exit is
// the last real block's). Scratch, all allocated by the caller: p11, p12,
// q1, ya (and y0, d when refined): [B, npad]; m: [B, nb, 4]; c, s:
// [B, nb, 2]. Launches on `stream`, never synchronises, and returns
// cudaGetLastError().
extern "C" int lp24_cascade(int refined, int mode, const float* x,
                            const float* na1a, const float* na2a,
                            const float* na1b, const float* na2b, float v1a,
                            float v2a, float v1b, float v2b, int64_t rs,
                            int64_t ts, int64_t count, const float* state_in,
                            float* state_out, float* y, float* p11,
                            float* p12, float* q1, float* ya, float* y0,
                            float* d, float* m, float* c, float* s, int B,
                            int64_t n, int64_t npad, int ln,
                            void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Coef na1s[2] = {{na1a, v1a}, {na1b, v1b}};
  const Coef na2s[2] = {{na2a, v2a}, {na2b, v2b}};
  const Layout l = {rs, ts, count};
  const State st = {state_in, state_out, refined ? 20 : 4};
  if (refined && mode != kBlock) return (int)cudaErrorInvalidValue;
  if ((state_in == nullptr) != (state_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (state_in != nullptr && (mode != kBlock || n != npad || ln != 64))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case tdf2::kScalar:
      cascade<tdf2::kScalar>(false, x, na1s, na2s, l, st, y, p11, p12, q1,
                             ya, y0, d, m, c, s, B, n, npad, ln, stream);
      break;
    case tdf2::kBlock:
      cascade<tdf2::kBlock>(refined != 0, x, na1s, na2s, l, st, y, p11, p12,
                            q1, ya, y0, d, m, c, s, B, n, npad, ln, stream);
      break;
    case tdf2::kSample:
      cascade<tdf2::kSample>(false, x, na1s, na2s, l, st, y, p11, p12, q1,
                             ya, y0, d, m, c, s, B, n, npad, ln, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2 over [B, n] rows on shared-memory tiles (tiled.cuh). x and y are
// contiguous [B, n]: nothing is padded. The POSITIVE block-rate
// denominators a1a, a2a, a1b, a2b are [B, count] arrays as the caller holds
// them, each read through its own strides (strides[2 i] the row stride and
// strides[2 i + 1] the entry stride of stream i, in elements; 0
// broadcasts) and negated in registers. ln is 64 or 128, with
// nb = ceil(n / ln). Scratch, allocated by the caller: ya [B, n];
// m [B, nb, 4] (16-byte aligned); c, sa, sb, r, sc [B, nb, 2];
// carries [4, B, 2]. Nine launches per segment (one segment below some
// 8,000 ln-blocks a row, up to 8 above), issued on `stream` and, for
// several segments, on three streams of the library's that fork from it
// and join it again before the call returns; never synchronises; returns
// cudaGetLastError().
extern "C" int lp24_refined_tiled(const float* x, const float* a1a,
                                  const float* a2a, const float* a1b,
                                  const float* a2b, const int64_t* strides,
                                  int64_t count, float* y, float* ya,
                                  float* m, float* c, float* sa, float* sb,
                                  float* r, float* sc, float* carries, int B,
                                  int64_t n, int ln, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const float* p[4] = {a1a, a2a, a1b, a2b};
  tiled::Stream st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {{p[i], 0.0f}, {strides[2 * i], strides[2 * i + 1], count}};
  const tiled::Lp24 secs[2] = {{st[0], st[1]}, {st[2], st[3]}};
  if (ln == 64)
    return refined_tiled<64>(x, secs, y, ya, m, c, sa, sb, r, sc, carries, B,
                             n, stream);
  if (ln == 128)
    return refined_tiled<128>(x, secs, y, ya, m, c, sa, sb, r, sc, carries, B,
                              n, stream);
  return (int)cudaErrorInvalidValue;
}
