// First-order scans for Hopper (sm_90a): the recurrences that the reference
// runs as XLA associative scans, not as Pallas kernels:
//   kLinear    y[k] = a[k] * y[k-1] + b[k] * x[k]    (iir.one_pole,
//              groove_tpu/ops/iir.py:630: the compressor's attack smoothing
//              and every comb and all-pass of the reverb, in block space)
//   kMaxDecay  y[k] = max(x[k], a[k] * y[k-1])        (dynamics.max_decay,
//              groove_tpu/ops/dynamics.py:46: the release-rate peak hold)
// from a zero state. Each multiply and add rounds on its own (-fmad=false;
// b * x is formed first, as the reference forms bx), in the order of the
// plain twin (ops/scan_kernels.py), which the kernel equals bit for bit.
//
// Layout: lanes x steps. A call sees x as [R, S, D] through strides (rs, ks,
// ds): R * D independent lanes of S steps. The time axis is [R, n, 1] (step
// stride 1); block space [R, nb, D] scans over nb with step stride D and D
// lanes side by side, so that neighbouring threads read neighbouring
// addresses. A coefficient is a value (by value) or a stream read through
// strides of its own (0 where it broadcasts). y is contiguous [R, S, D].
//
// Design: two levels, three launches. (1) One thread per (lane, chunk of C
// steps) scans its chunk from zero and writes the local y and the chunk's
// aggregate: the product of its a and its end value. (2) One warp per lane
// walks the aggregates in order (each 32 loaded at once, broadcast by
// shuffles) and leaves each chunk's carry-in in place of its end value.
// (3) One thread per (lane, chunk >= 1) adds the carry through the running
// product P of a: y += P * carry (kMaxDecay: y = max(y, P * carry), exact
// algebra for the follower's non-negative |x| and a).
//
// What bounds it on the H100: the bytes (x read, y written; per-sample
// coefficients read) at 3.35 TB/s; the recurrence's chain is cut to about
// 2C + 2 S/C + 2C dependent operations. This first design moves more: pass
// 3 reads y and a again and writes y again, and a thread walks C steps of
// its own, so its loads wait on latency unless many threads are in flight.
// The wrapper picks C near sqrt(S / 8) to balance the three passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kLinear = 0, kMaxDecay = 1 };

// A coefficient: p == nullptr means the value v everywhere.
struct Coef {
  const float* p;
  float v;
  int64_t rs, ks, ds;
};

struct Shape {
  int64_t R, S, D, C, nc;  // rows, steps, lanes per row, chunk, chunks
};

__device__ __forceinline__ float at(const Coef& c, int64_t r, int64_t k,
                                    int64_t d) {
  return c.p == nullptr ? c.v : c.p[r * c.rs + k * c.ks + d * c.ds];
}

template <int M>
__device__ __forceinline__ float step(float y, float ak, float bk, float xk) {
  if (M == kLinear) {
    float bx = bk * xk;
    float ay = ak * y;
    return ay + bx;
  }
  return fmaxf(xk, ak * y);
}

template <int M>
__device__ __forceinline__ float join(float y, float p, float carry) {
  float pc = p * carry;
  return M == kLinear ? y + pc : fmaxf(y, pc);
}

// Pass 1: thread t -> chunk t / L, lane t % L (neighbouring lanes side by
// side). agg[l * nc + c] = (product of a, local end value).
template <int M>
__global__ void local_kernel(const float* __restrict__ x, int64_t xrs,
                             int64_t xks, int64_t xds, Coef a, Coef b,
                             float* __restrict__ y, float* __restrict__ aggp,
                             float* __restrict__ aggy, Shape s) {
  const int64_t L = s.R * s.D;
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L * s.nc) return;
  const int64_t c = t / L, l = t % L;
  const int64_t r = l / s.D, d = l % s.D;
  const int64_t k0 = c * s.C;
  const int64_t k1 = k0 + s.C < s.S ? k0 + s.C : s.S;
  const float* xr = x + r * xrs + d * xds;
  float* yr = y + r * s.S * s.D + d;
  float acc = 0.0f, p = 1.0f;
  for (int64_t k = k0; k < k1; ++k) {
    const float ak = at(a, r, k, d);
    acc = step<M>(acc, ak, at(b, r, k, d), xr[k * xks]);
    p = p * ak;
    yr[k * s.D] = acc;
  }
  aggp[l * s.nc + c] = p;
  aggy[l * s.nc + c] = acc;
}

// Pass 2: warp w walks lane w's chunks in order; aggy[l * nc + c] becomes
// the carry into chunk c (0 for chunk 0).
template <int M>
__global__ void carry_kernel(const float* __restrict__ aggp,
                             float* __restrict__ aggy, int64_t L,
                             int64_t nc) {
  const int64_t l = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int q = threadIdx.x & 31;
  if (l >= L) return;  // whole warps leave together
  const float* pr = aggp + l * nc;
  float* yr = aggy + l * nc;
  float carry = 0.0f;
  for (int64_t c0 = 0; c0 < nc; c0 += 32) {
    const int64_t c = c0 + q;
    const float pa = c < nc ? pr[c] : 1.0f;
    const float ya = c < nc ? yr[c] : 0.0f;
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pa, j);
      const float yj = __shfl_sync(0xffffffffu, ya, j);
      if (q == j) mine = carry;
      if (c0 + j < nc) {
        const float pc = pj * carry;
        carry = M == kLinear ? pc + yj : fmaxf(yj, pc);
      }
    }
    if (c < nc) yr[c] = mine;
  }
}

// Pass 3: thread t -> chunk 1 + t / L, lane t % L.
template <int M>
__global__ void fixup_kernel(Coef a, float* __restrict__ y,
                             const float* __restrict__ carry, Shape s) {
  const int64_t L = s.R * s.D;
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L * (s.nc - 1)) return;
  const int64_t c = 1 + t / L, l = t % L;
  const int64_t r = l / s.D, d = l % s.D;
  const int64_t k0 = c * s.C;
  const int64_t k1 = k0 + s.C < s.S ? k0 + s.C : s.S;
  const float cin = carry[l * s.nc + c];
  float* yr = y + r * s.S * s.D + d;
  float p = 1.0f;
  for (int64_t k = k0; k < k1; ++k) {
    p = p * at(a, r, k, d);
    yr[k * s.D] = join<M>(yr[k * s.D], p, cin);
  }
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <int M>
void launch(const float* x, int64_t xrs, int64_t xks, int64_t xds, Coef a,
            Coef b, float* y, float* scratch, Shape s, cudaStream_t st) {
  const int64_t L = s.R * s.D;
  float* aggp = scratch;
  float* aggy = scratch + L * s.nc;
  local_kernel<M><<<blocks_for(L * s.nc), kThreads, 0, st>>>(
      x, xrs, xks, xds, a, b, y, aggp, aggy, s);
  if (s.nc < 2) return;
  carry_kernel<M><<<blocks_for(L * 32), kThreads, 0, st>>>(aggp, aggy, L,
                                                           s.nc);
  fixup_kernel<M><<<blocks_for(L * (s.nc - 1)), kThreads, 0, st>>>(
      a, y, aggy, s);
}

}  // namespace

// One first-order scan of x viewed as [R, S, D] (strides xrs, xks, xds)
// along S, into y (contiguous [R, S, D]). Coefficients a and b (b unused
// in kMaxDecay): a null pointer takes the value va / vb, else the array
// through its strides. scratch holds 2 * R * D * ceil(S / C) floats.
// Launches on `stream`, never synchronises, returns cudaGetLastError().
extern "C" int scan1(int mode, const float* x, int64_t xrs, int64_t xks,
                     int64_t xds, const float* a, float va, int64_t ars,
                     int64_t aks, int64_t ads, const float* b, float vb,
                     int64_t brs, int64_t bks, int64_t bds, float* y,
                     float* scratch, int64_t R, int64_t S, int64_t D,
                     int64_t C, void* stream_handle) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  if (R < 1 || S < 1 || D < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Shape s = {R, S, D, C, (S + C - 1) / C};
  const Coef ca = {a, va, ars, aks, ads};
  const Coef cb = {b, vb, brs, bks, bds};
  switch (mode) {
    case kLinear:
      launch<kLinear>(x, xrs, xks, xds, ca, cb, y, scratch, s, st);
      break;
    case kMaxDecay:
      launch<kMaxDecay>(x, xrs, xks, xds, ca, cb, y, scratch, s, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
