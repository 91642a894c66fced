// Single-section TDF2 biquad kernel for Hopper (sm_90a), one template with
// three coefficient modes (tdf2::Mode):
//   K5  kScalar  static coefficients, by value   (_make_kernel_scalar,
//                pallas_call in _biquad_scalar_2d)
//   K4  kBlock   one set per 64-frame block       (_make_kernel_ps_blk,
//                pallas_call in _biquad_blk_2d)
//   K9  kSample  one set per sample               (_make_kernel_ps,
//                pallas_call in _biquad_ps_2d)
// all in groove_tpu/ops/pallas_iir.py. The caller prepares the five
// coefficient streams as the reference does, in f32: na1 = -a1,
// na2 = -a2, b1m = b1 - a1 b0, b2m = b2 - a2 b0 (each rounded once), b0.
//
// Per call: phase 1 (tdf2::phase1_kernel, a thread per (row, ln-block),
// numerator terms b1m x and b2m x), phase 2 (tdf2::phase2_kernel, a thread
// block per row walking the serial cross-block chain), and the combine
//   y = b0 x + ((p11 S1 + p12 S2) + q1).
// The in-block length ln is the caller's: block_for(n, 128) for K5 and K9,
// max(block_for(n, 128), 64) for K4, as in the reference. The TPU's
// [G, ln, R, cb] fold and its SMEM/VMEM staging are not ported.
//
// What bounds it on the H100: as for lp24.cu, the phase-2 chain (n / ln
// dependent steps per row) makes a few-row call latency-bound; phase 1 and
// the combine are memory-bound passes over [B, n]. Built with -fmad=false;
// the in-block recurrence's explicit __fmaf_rn is mirrored by fma32 in the
// plain twins (ops/biquad_kernels.py), so kernel and twin agree bit for
// bit.

#include "tdf2.cuh"

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
  tdf2::phase2_kernel<<<B, kThreads, 0, stream>>>(m, c, s, nb,
                                                  tdf2::kNoCarry);
  combine_kernel<M><<<grid_for((int64_t)B * npad), kThreads, 0, stream>>>(
      x, co[4], l, p11, p12, q1, s, y, B, n, npad, nb, ln);
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
