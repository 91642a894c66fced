// S2: the reverb's feedback combs and Schroeder all-passes with carried
// delay-line tails, for Hopper (sm_90a): groove_tpu/ops/stream.py
// comb_feedback_stream (:253), comb_feedback_stream_automated (:275) and
// allpass_stream (:302), which the reference runs as a serial lax.scan over
// delay-length chunks whose body is elementwise across the D lanes:
//   comb     y[t] = x[t-D] + g[t] y[t-D]               (kComb)
//   allpass  w[t] = x[t] + g w[t-D]
//            y[t] = (-g) x[t] + (1 - g^2) w[t-D]       (kAllpass)
// Samples before the segment come from the carried tails (the last D
// samples of x and y, or of w). Each output is one multiply and one add of
// values D samples back, so any segmentation that hands over the last D
// samples gives the same bits.
//
// One thread per (row, lane d < D) walks t = d, d + D, d + 2D, ... < S in
// order, keeping the lane's previous x and y (or w) in registers, starting
// from the tails' entry d. Neighbouring lanes touch neighbouring samples,
// so every step's loads and stores are coalesced. When the walk ends, the
// registers hold the lane's last values, which is entry j = (d - S) mod D of
// the new tails (the last D samples of concat(tail, segment) hold one
// sample of every lane), so the kernel writes the tails itself; S need not
// be a multiple of D, nor at least D. The plain twin (ops/stream_kernels.py
// _comb_plain, _allpass_plain) computes the same expressions; -fmad=false
// keeps each multiply and add rounded on its own, so they agree bit for
// bit.
//
// g: the comb's feedback as a value, or per sample as [R, S] through a row
// stride (0 broadcasts; time contiguous: an automated reverb's RT60); the
// all-pass's g, -g and 1 - g^2 as float32 values (the reference's Python
// float64 constants, rounded once). x and y: contiguous [R, S]; tails:
// contiguous [R, D].
//
// What bounds it on the H100: the bytes of x and y; each lane's walk is
// S / D dependent multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
enum Mode { kComb = 0, kAllpass = 1 };

template <bool kPerSample>
__global__ void comb_kernel(const float* __restrict__ x,
                            const float* __restrict__ g, float gv,
                            int64_t grs, const float* __restrict__ hx,
                            const float* __restrict__ hy,
                            float* __restrict__ hx_out,
                            float* __restrict__ hy_out, float* __restrict__ y,
                            int R, int64_t S, int64_t D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * D) return;
  const int64_t row = i / D, d = i % D;
  const float* xr = x + row * S;
  float* yr = y + row * S;
  float xp = hx[i], yp = hy[i];
#pragma unroll 8
  for (int64_t t = d; t < S; t += D) {
    const float gt = kPerSample ? g[row * grs + t] : gv;
    const float yt = xp + gt * yp;
    xp = xr[t];
    yr[t] = yt;
    yp = yt;
  }
  const int64_t j = ((d - S) % D + D) % D;
  hx_out[row * D + j] = xp;
  hy_out[row * D + j] = yp;
}

__global__ void allpass_kernel(const float* __restrict__ x, float g,
                               float ng, float c1,
                               const float* __restrict__ hw,
                               float* __restrict__ hw_out,
                               float* __restrict__ y, int R, int64_t S,
                               int64_t D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * D) return;
  const int64_t row = i / D, d = i % D;
  const float* xr = x + row * S;
  float* yr = y + row * S;
  float wp = hw[i];
#pragma unroll 8
  for (int64_t t = d; t < S; t += D) {
    const float xt = xr[t];
    const float wt = xt + g * wp;
    yr[t] = ng * xt + c1 * wp;
    wp = wt;
  }
  hw_out[row * D + (((d - S) % D + D) % D)] = wp;
}

}  // namespace

// One carried-tail comb (mode 0) or all-pass (mode 1) over [R, S] rows with
// delay D. x, y: contiguous [R, S]. Comb: g per sample (pg non-null, row
// stride grs, time contiguous) or the value gv; tails hx, hy in and hx_out,
// hy_out out, contiguous [R, D]. All-pass: g, ng = -g and c1 = 1 - g^2 as
// values (gv, ng, c1); the w tail in hx, out hx_out (hy, hy_out unused).
// One launch on `stream`; never synchronises; returns cudaGetLastError().
extern "C" int comb_stream(int mode, const float* x, const float* pg,
                           float gv, int64_t grs, float ng, float c1,
                           const float* hx, const float* hy, float* hx_out,
                           float* hy_out, float* y, int R, int64_t S,
                           int64_t D, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (R <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R * D + kThreads - 1) / kThreads);
  if (mode == kComb && pg != nullptr)
    comb_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, pg, 0.0f, grs, hx, hy, hx_out, hy_out, y, R, S, D);
  else if (mode == kComb)
    comb_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, nullptr, gv, 0, hx, hy, hx_out, hy_out, y, R, S, D);
  else if (mode == kAllpass)
    allpass_kernel<<<grid, kThreads, 0, stream>>>(x, gv, ng, c1, hx, hx_out,
                                                  y, R, S, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
