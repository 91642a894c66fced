// Single-section TDF2 biquad kernels for Hopper (sm_90a), one template with
// three coefficient modes (tdf2::Mode):
//   K5  kScalar  static coefficients, by value   (_make_kernel_scalar,
//                pallas_call in _biquad_scalar_2d)
//   K4  kBlock   one set per 64-frame block       (_make_kernel_ps_blk,
//                pallas_call in _biquad_blk_2d)
//   K9  kSample  one set per sample               (_make_kernel_ps,
//                pallas_call in _biquad_ps_2d)
// all in groove_tpu/ops/pallas_iir.py. The recurrence runs on the
// coefficient streams as the reference prepares them, in f32: na1 = -a1,
// na2 = -a2, b1m = b1 - a1 b0, b2m = b2 - a2 b0 (each rounded once), b0.
// The in-block length ln is the caller's: block_for(n, 128) for K5 and K9,
// max(block_for(n, 128), 64) for K4, as in the reference. The TPU's
// [G, ln, R, cb] fold and its SMEM/VMEM staging are not ported.
//
// Two routes, the same arithmetic (tdf2.cuh's device functions; built with
// -fmad=false, the in-block recurrence's explicit __fmaf_rn mirrored by
// fma32 in the plain twins of ops/biquad_kernels.py, so every route and
// the twin agree bit for bit):
//   biquad_tiled  K4 (kBlock), K5 (kScalar) and K9 (kSample). Three
//                 launches: tiled::maps_kernel (phase 1 on shared-memory
//                 tiles, writes only the block maps), tdf2::chain,
//                 tiled::combine_kernel (re-scans the tile beside the entry
//                 states and writes y). x is read twice and y written once;
//                 the scratch is the block maps and entry states, 32 bytes
//                 per ln-block. It takes b0, b1, b2, a1, a2 as the caller
//                 holds them (K4 and K9: arrays, each through its own
//                 strides; K5: five float32 values) and prepares the
//                 streams in registers. K9's per-sample streams are staged
//                 beside the tile, coalesced, in a ring of two stages
//                 (tiled::Feed): its coefficients are read twice too, a
//                 32-byte sector at a time. See tiled.cuh.
//                 biquad_tiled_state (S3, the streamed render's
//                 biquad_stream) is the same at ln = 64 with the chain
//                 seeded by a carried state and exporting it.
//   biquad_scan   the earlier routes of K4, K5 and K9, kept callable as the
//                 yardsticks biquad_tiled is timed against (on no path):
//                 tdf2::phase1_kernel, a thread per (row, ln-block) walking
//                 device memory and storing the prefix rows p11, p12, q1;
//                 tdf2::chain; an elementwise combine
//                 y = b0 x + ((p11 S1 + p12 S2) + q1). The caller prepares
//                 the five streams and pads x to whole ln-blocks.
//
// What bounds it on the H100: the chain (n / ln dependent steps per row,
// see tdf2.cuh) for a few long rows; the bytes of x, y and (K9) the
// coefficients otherwise. The tiled route's scans run from shared memory
// at the card's width and do not store prefix rows; biquad_scan's phase 1
// is latency-bound on its strided walk of device memory and moves eight
// [B, n] arrays.

#include "tdf2.cuh"
#include "tiled.cuh"

namespace {

using tdf2::Coef;
using tdf2::Layout;
using tdf2::at;
using tdf2::grid_for;
using tdf2::kThreads;

// y[row, k] = b0 x + ((p11 S1 + p12 S2) + q1) for k < n.
template <int M>
__global__ void combine_kernel(const float* __restrict__ x, Coef b0, Layout l,
                               const float* __restrict__ p11,
                               const float* __restrict__ p12,
                               const float* __restrict__ q1,
                               const float* __restrict__ s,
                               float* __restrict__ y, int B, int64_t n,
                               int64_t npad, int nb, int ln) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * npad) return;
  int64_t row = i / npad;
  int64_t k = i % npad;
  if (k >= n) return;
  int64_t st = (row * nb + k / ln) * 2;
  float S1 = s[st];
  float S2 = s[st + 1];
  float v = p11[i] * S1 + p12[i] * S2 + q1[i];
  y[row * n + k] = at<M>(b0, l, row, k) * x[i] + v;
}

template <int M>
void scan(const float* x, const Coef* co, Layout l, float* y, float* p11,
          float* p12, float* q1, float* m, float* c, float* s, int B,
          int64_t n, int64_t npad, int ln, cudaStream_t stream) {
  int nb = (int)(npad / ln);
  tdf2::phase1_kernel<M, false><<<grid_for((int64_t)B * nb), kThreads, 0,
                                  stream>>>(x, co[0], co[1], co[2], co[3], l,
                                            p11, p12, q1, m, c, B, npad, nb,
                                            ln);
  tdf2::chain(m, c, s, nb, B, tdf2::kNoCarry, stream);
  combine_kernel<M><<<grid_for((int64_t)B * npad), kThreads, 0, stream>>>(
      x, co[4], l, p11, p12, q1, s, y, B, n, npad, nb, ln);
}

// K4, K5 and K9 on shared-memory tiles: phase 1, chain, combine.
template <int M, int kLn>
int tiled_scan(const float* x, const tiled::Biquad& sec, float* y, float* m,
               float* c, float* s, int B, int64_t n, cudaStream_t stream,
               tdf2::Carry carry = tdf2::kNoCarry) {
  constexpr int kBytes =
      tiled::smem_bytes(kLn) + tiled::ring_bytes(M, tiled::Biquad::kStreams);
  static bool allowed[tiled::kMaxDevices] = {};
  int err = 0;
  const int dev = tiled::device_index(err);
  if (err != 0) return err;
  if (!allowed[dev]) {
    err = tiled::allow(tiled::maps_kernel<M, kLn, tiled::Biquad>, kBytes);
    if (err != 0) return err;
    err = tiled::allow(tiled::combine_kernel<M, kLn, tiled::Biquad, false>,
                       kBytes);
    if (err != 0) return err;
    allowed[dev] = true;
  }
  const int nb = (int)((n + kLn - 1) / kLn);
  const tiled::Span all = {0, tiled::tiles_of(nb, 0)};
  const unsigned g = (unsigned)B * all.tiles;
  tiled::maps_kernel<M, kLn, tiled::Biquad>
      <<<g, tiled::kSlots, kBytes, stream>>>(x, sec, m, c, n, nb, all);
  tdf2::chain(m, c, s, nb, B, carry, stream);
  tiled::combine_kernel<M, kLn, tiled::Biquad, false>
      <<<g, tiled::kSlots, kBytes, stream>>>(x, sec, sec, s, y, nullptr,
                                             nullptr, n, nb, all);
  return (int)cudaGetLastError();
}

}  // namespace

// One biquad call over [B, n] rows. x: [B, npad], zero-padded past n;
// y: [B, n]. Coefficient streams na1, na2, b1m, b2m, b0 in `mode`: kScalar
// takes the values v*, kBlock and kSample the arrays, all five indexed by
// one layout (row stride rs, entry stride ts, count entries per row).
// Scratch, allocated by the caller: p11, p12, q1: [B, npad]; m: [B, nb, 4];
// c, s: [B, nb, 2]. Launches on `stream`, never synchronises, and returns
// cudaGetLastError().
extern "C" int biquad_scan(int mode, const float* x, const float* na1,
                           const float* na2, const float* b1m,
                           const float* b2m, const float* b0, float vna1,
                           float vna2, float vb1m, float vb2m, float vb0,
                           int64_t rs, int64_t ts, int64_t count, float* y,
                           float* p11, float* p12, float* q1, float* m,
                           float* c, float* s, int B, int64_t n, int64_t npad,
                           int ln, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Coef co[5] = {{na1, vna1}, {na2, vna2}, {b1m, vb1m}, {b2m, vb2m},
                      {b0, vb0}};
  const Layout l = {rs, ts, count};
  switch (mode) {
    case tdf2::kScalar:
      scan<tdf2::kScalar>(x, co, l, y, p11, p12, q1, m, c, s, B, n, npad, ln,
                          stream);
      break;
    case tdf2::kBlock:
      scan<tdf2::kBlock>(x, co, l, y, p11, p12, q1, m, c, s, B, n, npad, ln,
                         stream);
      break;
    case tdf2::kSample:
      scan<tdf2::kSample>(x, co, l, y, p11, p12, q1, m, c, s, B, n, npad, ln,
                          stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4 (mode kBlock), K5 (mode kScalar) and K9 (mode kSample) over [B, n]
// rows on shared-memory tiles (tiled.cuh). x and y are contiguous [B, n]:
// nothing is padded. kBlock and kSample: the coefficients b0, b1, b2, a1,
// a2 are [B, count] arrays as the caller holds them (kBlock: one entry per
// 64-frame block, ln 64 or 128; kSample: one per sample, count = n, ln 16,
// 32, 64 or 128), each read through its own strides (strides[2 i] the row
// stride and strides[2 i + 1] the entry stride of stream i, in elements; 0
// broadcasts). kScalar: the values v0, v1, v2, v3, v4 of b0, b1, b2, a1, a2
// (the arrays, strides and count are not read), with ln 16, 32, 64 or 128.
// Either way the kernels derive -a1, -a2, b1 - a1 b0 and b2 - a2 b0
// themselves, and nb = ceil(n / ln). Scratch, allocated by the caller:
// m [B, nb, 4] (16-byte aligned), c and s [B, nb, 2]. Three launches on
// `stream`; never synchronises; returns cudaGetLastError().
extern "C" int biquad_tiled(int mode, const float* x, const float* b0,
                            const float* b1, const float* b2,
                            const float* a1, const float* a2,
                            const int64_t* strides, int64_t count, float v0,
                            float v1, float v2, float v3, float v4, float* y,
                            float* m, float* c, float* s, int B, int64_t n,
                            int ln, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const float* p[5] = {b0, b1, b2, a1, a2};
  const float v[5] = {v0, v1, v2, v3, v4};
  tiled::Stream st[5];
  for (int i = 0; i < 5; ++i) {
    st[i] = {{p[i], v[i]}, {0, 0, 1}};
    if (mode != tdf2::kScalar)
      st[i].l = {strides[2 * i], strides[2 * i + 1], count};
  }
  const tiled::Biquad sec = {st[0], st[1], st[2], st[3], st[4]};
  if (mode == tdf2::kBlock && ln == 64)
    return tiled_scan<tdf2::kBlock, 64>(x, sec, y, m, c, s, B, n, stream);
  if (mode == tdf2::kBlock && ln == 128)
    return tiled_scan<tdf2::kBlock, 128>(x, sec, y, m, c, s, B, n, stream);
  if (mode == tdf2::kSample) {
    switch (ln) {
      case 16:
        return tiled_scan<tdf2::kSample, 16>(x, sec, y, m, c, s, B, n,
                                             stream);
      case 32:
        return tiled_scan<tdf2::kSample, 32>(x, sec, y, m, c, s, B, n,
                                             stream);
      case 64:
        return tiled_scan<tdf2::kSample, 64>(x, sec, y, m, c, s, B, n,
                                             stream);
      case 128:
        return tiled_scan<tdf2::kSample, 128>(x, sec, y, m, c, s, B, n,
                                              stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (mode != tdf2::kScalar) return (int)cudaErrorInvalidValue;
  switch (ln) {
    case 16:
      return tiled_scan<tdf2::kScalar, 16>(x, sec, y, m, c, s, B, n, stream);
    case 32:
      return tiled_scan<tdf2::kScalar, 32>(x, sec, y, m, c, s, B, n, stream);
    case 64:
      return tiled_scan<tdf2::kScalar, 64>(x, sec, y, m, c, s, B, n, stream);
    case 128:
      return tiled_scan<tdf2::kScalar, 128>(x, sec, y, m, c, s, B, n,
                                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// S3: one section over [B, n] rows (n a positive multiple of 64) with its
// TDF2 state carried in and out: groove_tpu/ops/stream.py biquad_stream
// (:44), the reference's iir.biquad(block=64, initial_state,
// return_state), an XLA scan there. It is biquad_tiled at ln = 64 whose
// chain starts from state_in [B, 2] (s1, s2 entering sample 0) and writes
// the state leaving the last block to state_out [B, 2] (tdf2::Carry): every
// ln-block lies on the song's 64-frame grid, so chained calls from the
// carried state give the bits of one call. Modes and arguments as
// biquad_tiled (kScalar: static coefficients by value; kBlock: one set per
// 64-frame block; kSample: one per sample). Three launches on `stream`;
// never synchronises; returns cudaGetLastError().
extern "C" int biquad_tiled_state(int mode, const float* x, const float* b0,
                                  const float* b1, const float* b2,
                                  const float* a1, const float* a2,
                                  const int64_t* strides, int64_t count,
                                  float v0, float v1, float v2, float v3,
                                  float v4, float* y, float* m, float* c,
                                  float* s, const float* state_in,
                                  float* state_out, int B, int64_t n,
                                  void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (B <= 0 || n <= 0 || n % 64 != 0 || state_in == nullptr ||
      state_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* p[5] = {b0, b1, b2, a1, a2};
  const float v[5] = {v0, v1, v2, v3, v4};
  tiled::Stream st[5];
  for (int i = 0; i < 5; ++i) {
    st[i] = {{p[i], v[i]}, {0, 0, 1}};
    if (mode != tdf2::kScalar)
      st[i].l = {strides[2 * i], strides[2 * i + 1], count};
  }
  const tiled::Biquad sec = {st[0], st[1], st[2], st[3], st[4]};
  const tdf2::Carry carry = {state_in, state_out, 2};
  switch (mode) {
    case tdf2::kScalar:
      return tiled_scan<tdf2::kScalar, 64>(x, sec, y, m, c, s, B, n, stream,
                                           carry);
    case tdf2::kBlock:
      return tiled_scan<tdf2::kBlock, 64>(x, sec, y, m, c, s, B, n, stream,
                                          carry);
    case tdf2::kSample:
      return tiled_scan<tdf2::kSample, 64>(x, sec, y, m, c, s, B, n, stream,
                                           carry);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
