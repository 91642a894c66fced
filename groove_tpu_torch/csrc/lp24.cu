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
//     halo block (tiled.cuh), not exported.
//   lp24_tiled  K3 (kBlock) and K6 with static (kScalar) or per-sample
//     (kSample) denominators, on the same tiles, 5 launches: section A's
//     maps -> chain -> combine, writing ya and, in the same loop, section
//     B's block maps -> chain -> section B's combine, writing y. The
//     scratch is ya and 32 bytes per ln-block (M, C, S). K6 takes every ln
//     that block_for gives it (16 to 128); K3 takes 64 and 128. Per-sample
//     denominators are staged beside the tile in a ring (tiled::Feed): both
//     sections' in the combine that runs both.
//   Both cut a long row into up to 8 segments of whole tiles and run their
//     chains as a wavefront along time, each stage on a stream of its own:
//     a chain needs the stage before it only up to the block it has
//     reached (see Lanes below). The streams fork from the caller's and
//     join it before the call returns.
//   lp24_cascade  the earlier routes, kept callable as the yardsticks the
//     tiled kernels are timed against: K2's (14 launches over six
//     [B, npad] scratch arrays), K3's, K6's (static and per-sample,
//     tdf2::kSample read through strides), and the earlier stateful route
//     of the stream cascades, the yardstick of lp24_stream.cu: K3 and K2 with ln pinned to 64 and a State, each
//     chain starting from the carried pair and exporting its exit
//     (tdf2::Carry), the refined cascade's defect reading the previous
//     call's z, y0 and coefficient edges (History) and exporting its own
//     (edges_kernel). None of the yardsticks is on a render path. Per
//     section: tdf2::phase1_kernel (a thread per (row, ln-block) walking
//     device memory), tdf2::chain, an elementwise combine; refined adds an
//     elementwise defect pass, an r-only correction scan that reuses
//     p11/p12, a second chain and a second combine.
//
// What bounds it on the H100: the chains (see tdf2.cuh), four per refined
// call and two per single pass, each n / ln dependent steps per row; with
// the two rows of a stereo bus nothing else is serial. One after the other
// the chains are two or four times one chain's latency; as a wavefront
// they cost one chain and the pipeline's fill, which is what the tiled
// routes do. Their scans run at the card's width from shared memory;
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

// The wavefront of the tiled cascades. Each chain, and the scan after it,
// waits for the stage before it only up to the block it has reached: a long
// row is cut into segments of whole tiles, every stage gets a lane (a
// stream), and lane j works on segment i while lane j - 1 works on segment
// i + 1. A segment must outlast its launches by far, so short rows stay in
// one segment on the caller's stream. K2 gives each of its four chains a
// lane with its scan behind it; K3 and K6 give their two chains and two
// combines a lane each, so that neither chain waits for a combine.
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

// One call's lanes over a row of `tiles` tiles of `per` blocks each: the
// segments it is cut into and, for more than one, the library's side
// streams, which fork from the caller's (lane 0) after what was issued there
// first and join it before the call returns.
struct Lanes {
  int segments = 1, seg_tiles = 0, per = 0;
  Wave* w = nullptr;
  cudaStream_t lane[kLanes];

  int plan(int dev, int tiles, int blocks_per_tile, cudaStream_t stream) {
    per = blocks_per_tile;
    segments = tiles / kMinSegmentTiles;
    segments = segments < 1 ? 1 : (segments > kMaxSegments ? kMaxSegments
                                                            : segments);
    seg_tiles = (tiles + segments - 1) / segments;
    segments = (tiles + seg_tiles - 1) / seg_tiles;
    for (int j = 0; j < kLanes; ++j) lane[j] = stream;
    if (!wave()) return 0;
    const int err = wave_of(dev, w);
    for (int j = 1; j < kLanes && err == 0; ++j) lane[j] = w->lane[j];
    return err;
  }

  bool wave() const { return segments > 1; }

  void fork() const {
    if (!wave()) return;
    cudaEventRecord(w->fork, lane[0]);
    for (int j = 1; j < kLanes; ++j) cudaStreamWaitEvent(lane[j], w->fork, 0);
  }

  // The tiles of segment i, and its first block k0 and block count steps.
  tiled::Span span(int i, int tiles, int nb, int& k0, int& steps) const {
    const int left = tiles - i * seg_tiles;
    const tiled::Span sp = {i * seg_tiles, left < seg_tiles ? left : seg_tiles};
    k0 = sp.tile0 * per;
    steps = nb - k0 < sp.tiles * per ? nb - k0 : sp.tiles * per;
    return sp;
  }

  // The state chain j hands from segment to segment in carries [.., B, 2].
  tdf2::Carry carry(float* carries, int B, int j, int i) const {
    float* p = carries + (size_t)j * 2 * B;
    return tdf2::Carry{i == 0 ? nullptr : p, wave() ? p : nullptr, 2};
  }

  // Lane j's segment i is done: lane j + 1 may go.
  void handed(int j, int i) const {
    if (!wave()) return;
    cudaEventRecord(w->done[j][i], lane[j]);
    if (j + 1 < kLanes) cudaStreamWaitEvent(lane[j + 1], w->done[j][i], 0);
  }

  void join() const {
    if (!wave()) return;
    for (int j = 1; j < kLanes; ++j)
      cudaStreamWaitEvent(lane[0], w->done[j][segments - 1], 0);
  }
};

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
  Lanes wave;  // a tile with a halo covers kSlots - 1 blocks
  if ((err = wave.plan(dev, tiles, tiled::kSlots - 1, stream)) != 0)
    return err;
  const tiled::Span all = {0, tiled::tiles_of(nb, 0)};
  tiled::maps_kernel<M, kLn, tiled::Lp24>
      <<<(unsigned)B * all.tiles, tiled::kSlots, kBytes, stream>>>(
          x, secs[0], m, c, n, nb, all);
  wave.fork();
  const cudaStream_t* lane = wave.lane;
  for (int i = 0; i < wave.segments; ++i) {
    int k0, steps;
    const tiled::Span sp = wave.span(i, tiles, nb, k0, steps);
    const unsigned g = (unsigned)B * sp.tiles;
    // lane 0: section A's solve chain, then its defect and correction scan
    tdf2::chain(m, c, sa, nb, B, wave.carry(carries, B, 0, i), lane[0], k0,
                steps);
    tiled::defect_scan_kernel<M, kLn>
        <<<g, tiled::kSlots, kBytes, lane[0]>>>(x, secs[0], sa, r, n, nb, sp);
    wave.handed(0, i);
    // lane 1: its correction chain, then its second combine, which writes
    // ya and puts section B's maps where section A's were (spent here)
    tdf2::chain(m, r, sc, nb, B, wave.carry(carries, B, 1, i), lane[1], k0,
                steps);
    tiled::refine_kernel<M, kLn, true><<<g, tiled::kSlots, kBytes, lane[1]>>>(
        x, secs[0], secs[1], sa, sc, ya, m, c, n, nb, sp);
    wave.handed(1, i);
    // lanes 2 and 3: the same for section B, from ya to y. Its solve's
    // entry states have their own array: a later segment's halo still
    // reads section A's.
    tdf2::chain(m, c, sb, nb, B, wave.carry(carries, B, 2, i), lane[2], k0,
                steps);
    tiled::defect_scan_kernel<M, kLn>
        <<<g, tiled::kSlots, kBytes, lane[2]>>>(ya, secs[1], sb, r, n, nb,
                                                sp);
    wave.handed(2, i);
    tdf2::chain(m, r, sc, nb, B, wave.carry(carries, B, 3, i), lane[3], k0,
                steps);
    tiled::refine_kernel<M, kLn, false>
        <<<g, tiled::kSlots, kBytes, lane[3]>>>(ya, secs[1], secs[1], sb, sc,
                                                y, nullptr, nullptr, n, nb,
                                                sp);
    wave.handed(3, i);
  }
  wave.join();
  return (int)cudaGetLastError();
}

// K3 (kBlock) and K6 (kScalar, kSample) on shared-memory tiles: section
// A's phase 1, then per segment section A's chain, section A's combine
// (which writes ya and, in the same loop, section B's block maps over
// section A's, spent here), section B's chain and section B's combine into
// y: 5 launches for one segment. One array of entry states s serves both chains: section B's
// chain writes a segment's only after section A's combine has read them.
// carries: [2][B][2], the state each chain hands from segment to segment.
template <int M, int kLn>
int single_tiled(const float* x, const tiled::Lp24* secs, float* y,
                 float* ya, float* m, float* c, float* s, float* carries,
                 int B, int64_t n, cudaStream_t stream) {
  // kSample: the ring of the combine that stages both sections
  constexpr int kBytes = tiled::smem_bytes(kLn) +
                         tiled::ring_bytes(M, 2 * tiled::Lp24::kStreams);
  static bool allowed[tiled::kMaxDevices] = {};
  int err = 0;
  const int dev = tiled::device_index(err);
  if (err != 0) return err;
  if (!allowed[dev]) {
    err = tiled::allow(tiled::maps_kernel<M, kLn, tiled::Lp24>, kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::combine_kernel<M, kLn, tiled::Lp24, true>,
                       kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::combine_kernel<M, kLn, tiled::Lp24, false>,
                       kBytes);
    if (err != 0) return err;
    allowed[dev] = true;
  }
  const int nb = (int)((n + kLn - 1) / kLn);
  const int tiles = tiled::tiles_of(nb, 0);
  Lanes wave;
  if ((err = wave.plan(dev, tiles, tiled::kSlots, stream)) != 0) return err;
  tiled::maps_kernel<M, kLn, tiled::Lp24>
      <<<(unsigned)B * tiles, tiled::kSlots, kBytes, stream>>>(
          x, secs[0], m, c, n, nb, tiled::Span{0, tiles});
  wave.fork();
  const cudaStream_t* lane = wave.lane;
  for (int i = 0; i < wave.segments; ++i) {
    int k0, steps;
    const tiled::Span sp = wave.span(i, tiles, nb, k0, steps);
    const unsigned g = (unsigned)B * sp.tiles;
    tdf2::chain(m, c, s, nb, B, wave.carry(carries, B, 0, i), lane[0], k0,
                steps);
    wave.handed(0, i);
    tiled::combine_kernel<M, kLn, tiled::Lp24, true>
        <<<g, tiled::kSlots, kBytes, lane[1]>>>(x, secs[0], secs[1], s, ya,
                                                m, c, n, nb, sp);
    wave.handed(1, i);
    tdf2::chain(m, c, s, nb, B, wave.carry(carries, B, 1, i), lane[2], k0,
                steps);
    wave.handed(2, i);
    tiled::combine_kernel<M, kLn, tiled::Lp24, false>
        <<<g, tiled::kSlots, kBytes, lane[3]>>>(ya, secs[1], secs[1], s, y,
                                                nullptr, nullptr, n, nb, sp);
    wave.handed(3, i);
  }
  wave.join();
  return (int)cudaGetLastError();
}

}  // namespace

// One cascade call over [B, n] rows. x: [B, npad], zero-padded past n;
// y: [B, n]. The negated section denominators na1a, na2a, na1b, na2b are
// read in `mode` (tdf2::Mode): kScalar takes the values v1a, v2a, v1b, v2b;
// kBlock and kSample take the arrays, all four indexed by one layout (row
// stride rs, entry stride ts, count entries per row). refined (K2, K8)
// needs kBlock. state_in/state_out: null for K6 and the earlier routes of
// K2, K3 and static K6; for the earlier route of the stream cascades
// (refined = 0 or 1) the carried state [B, 4] or [B, 20] entering and
// leaving the call (distinct buffers;
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

// K3 (mode kBlock) and K6 with static (mode kScalar) or per-sample (mode
// kSample) denominators over [B, n] rows on shared-memory tiles
// (tiled.cuh). x and y are contiguous [B, n]: nothing is padded. kBlock and
// kSample: the POSITIVE denominators a1a, a2a, a1b, a2b are [B, count]
// arrays as the caller holds them (kBlock: one entry per 64-frame block,
// ln 64 or 128; kSample: one per sample, count = n, ln 16, 32, 64 or 128),
// each read through its own strides (strides[2 i] the row stride and
// strides[2 i + 1] the entry stride of stream i, in elements; 0
// broadcasts). kScalar: the positive values v1a, v2a, v1b, v2b (the arrays,
// strides and count are not read), with ln 16, 32, 64 or 128. Either way
// they are negated in registers, and nb = ceil(n / ln). Scratch, allocated by the caller: ya [B, n];
// m [B, nb, 4] (16-byte aligned); c, s [B, nb, 2]; carries [2, B, 2]. Five
// launches per segment (one segment below some 8,000 ln-blocks a row, up
// to 8 above), issued on `stream` and, for several segments, on three
// streams of the library's that fork from it and join it again before the
// call returns; never synchronises; returns cudaGetLastError().
extern "C" int lp24_tiled(int mode, const float* x, const float* a1a,
                          const float* a2a, const float* a1b,
                          const float* a2b, const int64_t* strides,
                          int64_t count, float v1a, float v2a, float v1b,
                          float v2b, float* y, float* ya, float* m, float* c,
                          float* s, float* carries, int B, int64_t n, int ln,
                          void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const float* p[4] = {a1a, a2a, a1b, a2b};
  const float v[4] = {v1a, v2a, v1b, v2b};
  tiled::Stream st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = {{p[i], v[i]}, {0, 0, 1}};
    if (mode != tdf2::kScalar)
      st[i].l = {strides[2 * i], strides[2 * i + 1], count};
  }
  const tiled::Lp24 secs[2] = {{st[0], st[1]}, {st[2], st[3]}};
  if (mode == kBlock && ln == 64)
    return single_tiled<kBlock, 64>(x, secs, y, ya, m, c, s, carries, B, n,
                                    stream);
  if (mode == kBlock && ln == 128)
    return single_tiled<kBlock, 128>(x, secs, y, ya, m, c, s, carries, B, n,
                                     stream);
  if (mode == tdf2::kSample) {
    switch (ln) {
      case 16:
        return single_tiled<tdf2::kSample, 16>(x, secs, y, ya, m, c, s,
                                               carries, B, n, stream);
      case 32:
        return single_tiled<tdf2::kSample, 32>(x, secs, y, ya, m, c, s,
                                               carries, B, n, stream);
      case 64:
        return single_tiled<tdf2::kSample, 64>(x, secs, y, ya, m, c, s,
                                               carries, B, n, stream);
      case 128:
        return single_tiled<tdf2::kSample, 128>(x, secs, y, ya, m, c, s,
                                                carries, B, n, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (mode != tdf2::kScalar) return (int)cudaErrorInvalidValue;
  switch (ln) {
    case 16:
      return single_tiled<tdf2::kScalar, 16>(x, secs, y, ya, m, c, s,
                                             carries, B, n, stream);
    case 32:
      return single_tiled<tdf2::kScalar, 32>(x, secs, y, ya, m, c, s,
                                             carries, B, n, stream);
    case 64:
      return single_tiled<tdf2::kScalar, 64>(x, secs, y, ya, m, c, s,
                                             carries, B, n, stream);
    case 128:
      return single_tiled<tdf2::kScalar, 128>(x, secs, y, ya, m, c, s,
                                              carries, B, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
