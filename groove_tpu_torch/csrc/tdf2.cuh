// Shared pieces of the two-level TDF2 scan for Hopper (sm_90a), used by
// lp24.cu (K2, K3, K6, K7, K8), biquad.cu (K4, K5, K9) and serial.cu.
//
// Every kernel of groove_tpu/ops/pallas_iir.py runs one algorithm per
// section: phase 1, in-block prefix affine maps (a serial scan over ln
// samples per block); phase 2, the serial cross-block chain of the block
// maps; then an elementwise combine. This header holds what the sections
// share: how a coefficient is read, the in-block recurrence step (with its
// one explicit __fmaf_rn per map entry, mirrored by fma32 in the plain
// twins of ops/iir_kernels.py), the phase-1 kernel and the phase-2 chain.
//
// Coefficients come in three modes, the reference's three kernel families:
//   kScalar  one value per call, passed by value (_biquad_scalar_2d's SMEM
//            coefficients; a static lp24's denominators);
//   kBlock   one value per 64-frame control block, entry k >> 6
//            (_biquad_blk_2d, _lp24_blk_2d, _lp24_refined_blk_2d);
//   kSample  one value per sample, entry k (_biquad_ps_2d, _lp24_2d).
// kBlock and kSample read a [rows, count] array through its strides, so a
// coefficient broadcast along rows or time (stride 0) is never
// materialised. Past `count` a coefficient reads as 0, as the reference's
// zero-padded coefficient tiles do; padding never reaches an output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tdf2 {

constexpr int kCBlockShift = 6;   // 64-frame control blocks
constexpr int kChainTile = 1024;  // blocks staged per phase-2 tile
constexpr int kThreads = 256;

enum Mode : int { kScalar = 0, kBlock = 1, kSample = 2 };

struct Coef {
  const float* p;  // kBlock, kSample: the array
  float v;         // kScalar: the value
};

struct Layout {
  int64_t rs;     // row stride in elements (0: one row for all)
  int64_t ts;     // stride between entries (0: one entry for all)
  int64_t count;  // entries per row
};

template <int M>
__device__ __forceinline__ float at(Coef c, Layout l, int64_t row,
                                    int64_t k) {
  if constexpr (M == kScalar) {
    return c.v;
  } else {
    int64_t i = M == kBlock ? (k >> kCBlockShift) : k;
    return i < l.count ? c.p[row * l.rs + i * l.ts] : 0.0f;
  }
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

namespace {

// Phase 1 of one section. z, p11, p12, q1: [B, npad]; m: [B, nb, 4]
// (m11, m12, m21, m22); c: [B, nb, 2]. One thread per (row, ln-block) walks
// its block, storing the SHIFTED prefix rows (identity at j = 0) and the
// whole-block map. The numerator terms are b1m * x and b2m * x, with
// b1m = b1 - a1 b0 and b2m = b2 - a2 b0; kLp24 derives them in-register
// from the denominators of filters004's (1, 2, 1) sections: 2 + na1 and
// 1 + na2.
template <int M, bool kLp24>
__global__ void phase1_kernel(const float* __restrict__ z, Coef na1, Coef na2,
                              Coef b1m, Coef b2m, Layout l,
                              float* __restrict__ p11,
                              float* __restrict__ p12,
                              float* __restrict__ q1, float* __restrict__ m,
                              float* __restrict__ c, int B, int64_t npad,
                              int nb, int ln) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nb) return;
  int64_t row = t / nb;
  int64_t blk = t % nb;
  int64_t base = row * npad + blk * ln;
  float P11 = 1.0f, P12 = 0.0f, P21 = 0.0f, P22 = 1.0f, Q1 = 0.0f, Q2 = 0.0f;
  for (int j = 0; j < ln; ++j) {
    int64_t i = base + j;
    p11[i] = P11;
    p12[i] = P12;
    q1[i] = Q1;
    int64_t k = blk * ln + j;
    float a = at<M>(na1, l, row, k);
    float b = at<M>(na2, l, row, k);
    float xj = z[i];
    float c1 = (kLp24 ? 2.0f + a : at<M>(b1m, l, row, k)) * xj;
    float c2 = (kLp24 ? 1.0f + b : at<M>(b2m, l, row, k)) * xj;
    float n11 = __fmaf_rn(a, P11, P21);
    float n12 = __fmaf_rn(a, P12, P22);
    float n21 = b * P11;
    float n22 = b * P12;
    float r1 = __fmaf_rn(a, Q1, Q2) + c1;
    float r2 = __fmaf_rn(b, Q1, c2);
    P11 = n11; P12 = n12; P21 = n21; P22 = n22; Q1 = r1; Q2 = r2;
  }
  m[t * 4 + 0] = P11;
  m[t * 4 + 1] = P12;
  m[t * 4 + 2] = P21;
  m[t * 4 + 3] = P22;
  c[t * 2 + 0] = Q1;
  c[t * 2 + 1] = Q2;
}

}  // namespace

// A chain's state carried across calls (the stateful stream kernels K7 and
// K8): the pair entering block 0 is read from in[row * stride + {0, 1}]
// (zeros when in is null) and the pair leaving the last block is written
// to out[row * stride + {0, 1}] (skipped when out is null).
struct Carry {
  const float* in;
  float* out;
  int64_t stride;
};

constexpr Carry kNoCarry = {nullptr, nullptr, 0};

namespace {

// Phase 2: one thread block per row. Tiles of block maps are staged in
// shared memory by all threads; thread 0 walks the chain
// S[k+1] = M[k] S[k] + C[k]; all threads write the entry states back.
// s: [B, nb, 2], the state ENTERING block k. The TPU's lane-roll sweeps
// and chunk carries compute exactly this chain; the 2x2 maps are never
// composed associatively (that diverges in f32 near z = 1). `carry` seeds
// the chain and exports its exit (kNoCarry: zero entry, no export).
__global__ void phase2_kernel(const float* __restrict__ m,
                              const float* __restrict__ c,
                              float* __restrict__ s, int nb, Carry carry) {
  __shared__ float sm[kChainTile * 4];
  __shared__ float sc[kChainTile * 2];
  __shared__ float ss[kChainTile * 2];
  int64_t row = blockIdx.x;
  const float* mr = m + row * nb * 4;
  const float* cr = c + row * nb * 2;
  float* sr = s + row * nb * 2;
  float s1 = 0.0f, s2 = 0.0f;  // carried by thread 0
  if (carry.in != nullptr) {
    s1 = carry.in[row * carry.stride];
    s2 = carry.in[row * carry.stride + 1];
  }
  for (int base = 0; base < nb; base += kChainTile) {
    int cnt = min(kChainTile, nb - base);
    for (int i = threadIdx.x; i < cnt * 4; i += blockDim.x)
      sm[i] = mr[(int64_t)base * 4 + i];
    for (int i = threadIdx.x; i < cnt * 2; i += blockDim.x)
      sc[i] = cr[(int64_t)base * 2 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < cnt; ++k) {
        ss[2 * k] = s1;
        ss[2 * k + 1] = s2;
        float n1 = sm[4 * k] * s1 + sm[4 * k + 1] * s2 + sc[2 * k];
        float n2 = sm[4 * k + 2] * s1 + sm[4 * k + 3] * s2 + sc[2 * k + 1];
        s1 = n1;
        s2 = n2;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * 2; i += blockDim.x)
      sr[(int64_t)base * 2 + i] = ss[i];
    __syncthreads();
  }
  if (threadIdx.x == 0 && carry.out != nullptr) {
    carry.out[row * carry.stride] = s1;
    carry.out[row * carry.stride + 1] = s2;
  }
}

}  // namespace
}  // namespace tdf2
