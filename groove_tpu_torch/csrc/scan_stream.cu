// S1: the first-order scans of the segment-streamed render with a carried
// state, for Hopper (sm_90a): groove_tpu/ops/stream.py one_pole_stream
// (:114) and max_decay_stream (:385), which the reference runs as an XLA
// associative_scan inside each 64-sample block and a serial lax.scan
// across blocks (no Pallas kernel):
//   linear     y[k] = a[k] y[k-1] + b[k] x[k]      (kLinear)
//   max_decay  y[k] = max(x[k], a[k] y[k-1])       (kMaxDecay)
// with y[-1] = y0, over [R, S] rows, S a multiple of 64. Every block of 64
// samples sits on the song's grid (a segment starts on a multiple of 64),
// and the in-block prefix, the cross-block chain and the combine depend
// only on the block's own samples and the value entering it, so a song cut
// into any 64-multiple segments gives the same bits as one segment.
//
// Three launches on one stream:
//   block_kernel  a thread per (row, 64-block) folds its block from its
//                 first element: (A, C) <- (a[k] A, a[k] C + b[k] x[k])
//                 (max_decay: (A, V) <- (A a[k], max(x[k], V a[k]))), and
//                 writes the block's (A, C) at its last sample;
//   chain_kernel  a thread per row walks the blocks in order from y0,
//                 storing the value entering each block and
//                 y <- A y + C (max_decay: max(V, A y)), its block maps
//                 loaded a batch ahead; it writes the value leaving the
//                 last block to y_last;
//   out_kernel    a thread per (row, 64-block) folds its block again and
//                 writes y[k] = C_k + A_k e (max_decay: max(V_k, A_k e)),
//                 e the value entering the block.
// Every block adds its carry, the first y0. The plain twin
// (ops/stream_kernels.py _scan_plain) runs the same folds in the same
// order; -fmad=false keeps every multiply and add rounded on its own, so
// kernel and twin agree bit for bit. The reference's in-block order is
// XLA's associative_scan tree instead of this serial fold: against
// groove_tpu the scans are held to a dBFS bar, not bitwise.
//
// Coefficients: a and b are numbers (by value) or [R, S] arrays read
// through a row stride (0 where a row broadcasts), contiguous in time. x is
// [R, S] with a row stride, contiguous in time; y is contiguous [R, S].
//
// What bounds it on the H100: the chain (S / 64 dependent multiply-adds a
// row, a few rows a call) for the few-row follower; the bytes of x, y and
// the coefficients otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kThreads = 128;
enum Mode { kLinear = 0, kMaxDecay = 1 };

struct Coef {
  const float* p;  // null: `v` everywhere
  float v;
  int64_t rs;      // row stride (elements); time is contiguous
  __device__ __forceinline__ float at(int64_t row, int64_t k) const {
    return p == nullptr ? v : p[row * rs + k];
  }
};

// One step of the in-block fold from (A, C): the element's own pair at
// j = 0, its composition after (A, C) else.
template <int M>
__device__ __forceinline__ void fold(float ak, float vk, int j, float& A,
                                     float& C) {
  if (j == 0) {
    A = ak;
    C = vk;
  } else if (M == kLinear) {
    C = ak * C + vk;
    A = ak * A;
  } else {
    C = fmaxf(vk, C * ak);
    A = A * ak;
  }
}

template <int M>
__device__ __forceinline__ float value(const float* x, int64_t xrs, Coef b,
                                       int64_t row, int64_t k) {
  const float xk = x[row * xrs + k];
  return M == kLinear ? b.at(row, k) * xk : xk;
}

template <int M>
__global__ void block_kernel(const float* __restrict__ x, int64_t xrs,
                             Coef a, Coef b, float2* __restrict__ blk, int R,
                             int64_t nb) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * nb) return;
  const int64_t row = i / nb, k0 = (i % nb) * kBlock;
  float A = 1.0f, C = 0.0f;
#pragma unroll 8
  for (int j = 0; j < kBlock; ++j)
    fold<M>(a.at(row, k0 + j), value<M>(x, xrs, b, row, k0 + j), j, A, C);
  blk[i] = make_float2(A, C);
}

template <int M>
__device__ __forceinline__ float chain_step(float2 m, float y) {
  return M == kLinear ? m.x * y + m.y : fmaxf(m.y, m.x * y);
}

// The block maps of a batch are loaded a batch ahead of the arithmetic
// that consumes them, so the chain waits on its multiply and add, not on
// a load.
template <int M>
__global__ void chain_kernel(const float2* __restrict__ blk,
                             float* __restrict__ entry,
                             const float* __restrict__ y0,
                             float* __restrict__ y_last, int R, int64_t nb) {
  constexpr int kBatch = 16;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const float2* br = blk + row * nb;
  float* er = entry + row * nb;
  float y = y0[row];
  int64_t k = 0;
  float2 cur[kBatch], nxt[kBatch];
  if (nb >= kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = br[u];
  }
  for (; k + kBatch <= nb; k += kBatch) {
    const bool more = k + 2 * kBatch <= nb;
    if (more) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) nxt[u] = br[k + kBatch + u];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      er[k + u] = y;
      y = chain_step<M>(cur[u], y);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
    }
  }
  for (; k < nb; ++k) {
    er[k] = y;
    y = chain_step<M>(br[k], y);
  }
  y_last[row] = y;
}

template <int M>
__global__ void out_kernel(const float* __restrict__ x, int64_t xrs, Coef a,
                           Coef b, const float* __restrict__ entry,
                           float* __restrict__ y, int R, int64_t nb) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * nb) return;
  const int64_t row = i / nb, k0 = (i % nb) * kBlock;
  const float e = entry[i];
  float* yr = y + row * nb * kBlock + k0;
  float A = 1.0f, C = 0.0f;
#pragma unroll 8
  for (int j = 0; j < kBlock; ++j) {
    fold<M>(a.at(row, k0 + j), value<M>(x, xrs, b, row, k0 + j), j, A, C);
    yr[j] = M == kLinear ? C + A * e : fmaxf(C, A * e);
  }
}

template <int M>
void run(const float* x, int64_t xrs, Coef a, Coef b, const float* y0,
         float* y_last, float* y, float2* blk, float* entry, int R,
         int64_t nb, cudaStream_t stream) {
  const unsigned g = (unsigned)((R * nb + kThreads - 1) / kThreads);
  block_kernel<M><<<g, kThreads, 0, stream>>>(x, xrs, a, b, blk, R, nb);
  chain_kernel<M><<<(unsigned)((R + 31) / 32), 32, 0, stream>>>(
      blk, entry, y0, y_last, R, nb);
  out_kernel<M><<<g, kThreads, 0, stream>>>(x, xrs, a, b, entry, y, R, nb);
}

}  // namespace

// One carried-state scan over [R, S] rows (S a positive multiple of 64) in
// `mode` (0 linear, 1 max_decay). x: row stride xrs, time contiguous. a, b:
// arrays (pa, pb non-null; row strides ars, brs, 0 to broadcast; time
// contiguous) or values va, vb (max_decay reads no b). y0, y_last: [R].
// y: contiguous [R, S]. Scratch, allocated by the caller: blk [R, S / 64]
// float2 (8-byte aligned), entry [R, S / 64]. Three launches on `stream`;
// never synchronises; returns cudaGetLastError().
extern "C" int scan_stream(int mode, const float* x, int64_t xrs,
                           const float* pa, float va, int64_t ars,
                           const float* pb, float vb, int64_t brs,
                           const float* y0, float* y_last, float* y,
                           float* blk, float* entry, int R, int64_t S,
                           void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (R <= 0 || S <= 0 || S % kBlock != 0 ||
      reinterpret_cast<uintptr_t>(blk) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Coef a = {pa, va, ars}, b = {pb, vb, brs};
  float2* b2 = reinterpret_cast<float2*>(blk);
  const int64_t nb = S / kBlock;
  if (mode == kLinear)
    run<kLinear>(x, xrs, a, b, y0, y_last, y, b2, entry, R, nb, stream);
  else if (mode == kMaxDecay)
    run<kMaxDecay>(x, xrs, a, b, y0, y_last, y, b2, entry, R, nb, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
