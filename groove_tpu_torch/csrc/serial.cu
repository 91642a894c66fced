// Per-sample TDF2 biquad scan for Hopper (sm_90a): the "serial" fidelity
// route of groove_tpu/ops/iir.py biquad_serial, which the reference runs as
// XLA's lax.scan (no Pallas kernel). Static deep-corner filters (poles near
// z = 1) take it, because its roundoff follows the filter's own contracting
// dynamics:
//   y[k]  = b0 x[k] + s1
//   s1'   = (b1 x[k] - a1 y[k]) + s2
//   s2'   = b2 x[k] - a2 y[k]
// One thread per row walks all n samples in this operation order, the plain
// twin's (ops/biquad_kernels.py); -fmad=false keeps each multiply and add
// separately rounded. Coefficients are static (tdf2::kScalar, by value) or
// per sample (tdf2::kSample, through strides).
//
// What bounds it on the H100: the dependent chain of four floating-point
// operations per sample (s1 -> y -> a1 y -> subtract -> add s2), n of them
// per row, so a call is latency-bound at a few rows whatever the memory
// rate: 64.1 ms for 3 minutes of stereo at 1980 MHz. The memory traffic
// must stay off that chain. x moves in tiles of kTile samples, loaded as
// float4 into registers one tile ahead of their use, with the lines
// kPrefetchTiles tiles ahead already requested into L2; outputs leave as
// float4 stores. (Loading each 8-sample tile just before its use took 5x
// the chain on an H100; one tile ahead with scalar loads, 3.5x.) Rows start
// 16-byte aligned: the caller pads the row stride to a multiple of 4.

#include "tdf2.cuh"

namespace {

using tdf2::Coef;
using tdf2::Layout;
using tdf2::at;

constexpr int kPrefetchTiles = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kLine = 32;  // floats per 128-byte cache line

template <int M>
__device__ __forceinline__ void step(float xk, Coef b0, Coef b1, Coef b2,
                                     Coef a1, Coef a2, Layout l, int64_t row,
                                     int64_t k, float& s1, float& s2,
                                     float& yk) {
  float yn = at<M>(b0, l, row, k) * xk + s1;
  float s1n = at<M>(b1, l, row, k) * xk - at<M>(a1, l, row, k) * yn + s2;
  float s2n = at<M>(b2, l, row, k) * xk - at<M>(a2, l, row, k) * yn;
  s1 = s1n;
  s2 = s2n;
  yk = yn;
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <int T>
__device__ __forceinline__ void load_tile(const float* __restrict__ p,
                                          float (&v)[T]) {
#pragma unroll
  for (int u = 0; u < T; u += 4) {
    float4 q = *reinterpret_cast<const float4*>(p + u);
    v[u] = q.x;
    v[u + 1] = q.y;
    v[u + 2] = q.z;
    v[u + 3] = q.w;
  }
}

// Per-sample coefficients are read in the step itself (that mode serves no
// render path), so their tiles are shorter, to stay in registers.
template <int M>
__global__ void serial_kernel(const float* __restrict__ x, Coef b0, Coef b1,
                              Coef b2, Coef a1, Coef a2, Layout l,
                              float* __restrict__ y, int B, int64_t n,
                              int64_t stride) {
  constexpr int kTile = M == tdf2::kScalar ? 64 : 16;
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + row * stride;
  float* yr = y + row * stride;
  float s1 = 0.0f, s2 = 0.0f;
  const int64_t full = n / kTile * kTile;
  for (int64_t p = 0; p < kPrefetchTiles * kTile && p < full; p += kLine)
    prefetch_l2(xr + p);
  float xs[kTile], next[kTile], ys[kTile];
  if (full > 0) load_tile<kTile>(xr, xs);
  int64_t k0 = 0;
  for (; k0 < full; k0 += kTile) {
    const bool more = k0 + kTile < full;
#pragma unroll
    for (int p = 0; p < kTile; p += kLine) {
      int64_t ahead = k0 + kPrefetchTiles * kTile + p;
      if (ahead < full) prefetch_l2(xr + ahead);
    }
    if (more) load_tile<kTile>(xr + k0 + kTile, next);
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      step<M>(xs[u], b0, b1, b2, a1, a2, l, row, k0 + u, s1, s2, ys[u]);
#pragma unroll
    for (int u = 0; u < kTile; u += 4)
      *reinterpret_cast<float4*>(yr + k0 + u) =
          make_float4(ys[u], ys[u + 1], ys[u + 2], ys[u + 3]);
    if (more) {
#pragma unroll
      for (int u = 0; u < kTile; ++u) xs[u] = next[u];
    }
  }
  for (; k0 < n; ++k0) {
    float yk;
    step<M>(xr[k0], b0, b1, b2, a1, a2, l, row, k0, s1, s2, yk);
    yr[k0] = yk;
  }
}

}  // namespace

// One serial scan over [B, n] rows. x, y: [B, stride] with stride >= n a
// multiple of 4 and 16-byte aligned rows; y's columns past n are left
// untouched. Coefficients b0, b1, b2, a1, a2 (a0 == 1) in `mode`: kScalar
// takes the values v*, kSample the arrays, all five indexed by one layout
// (row stride rs, entry stride ts, count entries per row). Launches on
// `stream`, never synchronises, and returns cudaGetLastError().
extern "C" int biquad_serial_scan(int mode, const float* x, const float* b0,
                                  const float* b1, const float* b2,
                                  const float* a1, const float* a2, float vb0,
                                  float vb1, float vb2, float va1, float va2,
                                  int64_t rs, int64_t ts, int64_t count,
                                  float* y, int B, int64_t n, int64_t stride,
                                  void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (stride < n || stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = {rs, ts, count};
  const Coef cb0 = {b0, vb0}, cb1 = {b1, vb1}, cb2 = {b2, vb2};
  const Coef ca1 = {a1, va1}, ca2 = {a2, va2};
  unsigned grid = (unsigned)((B + kRowsPerBlock - 1) / kRowsPerBlock);
  switch (mode) {
    case tdf2::kScalar:
      serial_kernel<tdf2::kScalar><<<grid, kRowsPerBlock, 0, stream>>>(
          x, cb0, cb1, cb2, ca1, ca2, l, y, B, n, stride);
      break;
    case tdf2::kSample:
      serial_kernel<tdf2::kSample><<<grid, kRowsPerBlock, 0, stream>>>(
          x, cb0, cb1, cb2, ca1, ca2, l, y, B, n, stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
