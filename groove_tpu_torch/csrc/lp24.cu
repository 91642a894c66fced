// Block-rate lp24 cascade kernels for Hopper (sm_90a): K3, the single-pass
// cascade, and K2, the cascade with its defect-correction ("refine") pass.
//
// Replaces groove_tpu/ops/pallas_iir.py:
//   K3  _make_kernel_lp24_blk (pallas_call in _lp24_blk_2d)
//   K2  _make_kernel_lp24_refined_blk, state_io=False (pallas_call in
//       _lp24_refined_blk_2d)
// The algorithm and its operation order are the reference's; the TPU
// layout ([G, ln, R, cb] folding, row packing, VMEM caps, lane-roll
// sweeps) is not. Per section:
//   phase 1   one thread per (row, ln-block): serial scan over ln samples
//             writing the shifted prefix rows p11, p12, q1 to global
//             scratch and the block map (M, C);
//   phase 2   one thread block per row: the serial chain
//             S[k+1] = M[k] S[k] + C[k] over all blocks of the row. The
//             TPU's lane-roll sweeps and chunk carries compute exactly this
//             chain; here it is written out. The 2x2 maps are never
//             composed associatively (diverges in f32 near z = 1);
//   combine   elementwise y = x + ((p11 S1 + p12 S2) + q1).
// K2 adds an elementwise defect pass, an r-only correction scan that reuses
// p11/p12, a second phase 2 and a second combine.
//
// What bounds it on the H100: phase 2 is a dependent chain of n / ln steps
// per row (62k steps for a 3-minute song at ln = 128), so with the two rows
// of a stereo bus it is latency-bound, not bandwidth-bound; the design
// keeps each step's loads off the chain by staging tiles of block maps in
// shared memory, cooperatively loaded, while one thread walks the chain.
// Phases 1 and combine are memory-bound passes over [B, n]. Building with
// -fmad=false keeps every multiply and add separately rounded, as in the
// plain twins (ops/iir_kernels.py), except the explicit __fmaf_rn of the
// in-block scans' recurrences: near z = 1 the unfused prefix products lose
// ~12 dB against an f64 reference, and the twins use the same correctly
// rounded fused multiply-add (fma32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCBlockShift = 6;  // 64-frame control blocks
constexpr int kChainTile = 1024;  // blocks staged per phase-2 tile
constexpr int kThreads = 256;

__device__ __forceinline__ float coef(const float* __restrict__ c,
                                      int64_t blk, int nb64) {
  return blk < nb64 ? c[blk] : 0.0f;
}

// Solve's phase 1. z, p11, p12, q1: [B, npad]; na1, na2: [B, nb64];
// m: [B, nb, 4] (m11, m12, m21, m22); c: [B, nb, 2] (c1, c2).
__global__ void phase1_kernel(const float* __restrict__ z,
                              const float* __restrict__ na1,
                              const float* __restrict__ na2,
                              float* __restrict__ p11,
                              float* __restrict__ p12,
                              float* __restrict__ q1,
                              float* __restrict__ m,
                              float* __restrict__ c,
                              int B, int64_t npad, int nb, int ln, int nb64) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nb) return;
  int64_t row = t / nb;
  int64_t blk = t % nb;
  int64_t base = row * npad + blk * ln;
  const float* a1r = na1 + row * nb64;
  const float* a2r = na2 + row * nb64;
  float P11 = 1.0f, P12 = 0.0f, P21 = 0.0f, P22 = 1.0f, Q1 = 0.0f, Q2 = 0.0f;
  for (int j = 0; j < ln; ++j) {
    int64_t i = base + j;
    p11[i] = P11;
    p12[i] = P12;
    q1[i] = Q1;
    int64_t cb = (blk * ln + j) >> kCBlockShift;
    float a = coef(a1r, cb, nb64);
    float b = coef(a2r, cb, nb64);
    float xj = z[i];
    float c1 = (2.0f + a) * xj;
    float c2 = (1.0f + b) * xj;
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

// Correction's phase 1 (numerator (1, 0, 0)): the maps are the solve's, so
// only the r terms run. Writes the shifted r1 rows to q1 and the block-end
// (r1, r2) to c.
__global__ void corr_phase1_kernel(const float* __restrict__ d,
                                   const float* __restrict__ na1,
                                   const float* __restrict__ na2,
                                   float* __restrict__ q1,
                                   float* __restrict__ c,
                                   int B, int64_t npad, int nb, int ln,
                                   int nb64) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nb) return;
  int64_t row = t / nb;
  int64_t blk = t % nb;
  int64_t base = row * npad + blk * ln;
  const float* a1r = na1 + row * nb64;
  const float* a2r = na2 + row * nb64;
  float R1 = 0.0f, R2 = 0.0f;
  for (int j = 0; j < ln; ++j) {
    int64_t i = base + j;
    q1[i] = R1;
    int64_t cb = (blk * ln + j) >> kCBlockShift;
    float a = coef(a1r, cb, nb64);
    float b = coef(a2r, cb, nb64);
    float dj = d[i];
    float r1 = __fmaf_rn(a, R1, R2) + a * dj;
    float r2 = __fmaf_rn(b, R1, b * dj);
    R1 = r1; R2 = r2;
  }
  c[t * 2 + 0] = R1;
  c[t * 2 + 1] = R2;
}

// Phase 2: one thread block per row. Tiles of block maps are staged in
// shared memory by all threads; thread 0 walks the chain; all threads
// write the entry states back. s: [B, nb, 2], the state ENTERING block k.
__global__ void phase2_kernel(const float* __restrict__ m,
                              const float* __restrict__ c,
                              float* __restrict__ s, int nb) {
  __shared__ float sm[kChainTile * 4];
  __shared__ float sc[kChainTile * 2];
  __shared__ float ss[kChainTile * 2];
  int64_t row = blockIdx.x;
  const float* mr = m + row * nb * 4;
  const float* cr = c + row * nb * 2;
  float* sr = s + row * nb * 2;
  float s1 = 0.0f, s2 = 0.0f;  // carried by thread 0
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

// Defect of the solve y0 against the shifted-coefficient TDF2 recurrence of
// the (1, 2, 1) section, epsilon-regrouped (ops/iir.py
// biquad_blockrate_refined in the reference):
//   d = (z + 2 z1 + z2) - ((y0 - y1) - (y1 - y2)) - e1 y1 - e2 y2,
//   e1 = 2 - na1[(i-1) >> 6], e2 = -na2[(i-2) >> 6] - 1,
// with zero history before sample 0.
__global__ void defect_kernel(const float* __restrict__ z,
                              const float* __restrict__ y0,
                              const float* __restrict__ na1,
                              const float* __restrict__ na2,
                              float* __restrict__ d,
                              int B, int64_t npad, int nb64) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * npad) return;
  int64_t row = i / npad;
  int64_t k = i % npad;
  const float* a1r = na1 + row * nb64;
  const float* a2r = na2 + row * nb64;
  float z0 = z[i];
  float z1 = k >= 1 ? z[i - 1] : 0.0f;
  float z2 = k >= 2 ? z[i - 2] : 0.0f;
  float y00 = y0[i];
  float y1 = k >= 1 ? y0[i - 1] : 0.0f;
  float y2 = k >= 2 ? y0[i - 2] : 0.0f;
  float a1s = k >= 1 ? coef(a1r, (k - 1) >> kCBlockShift, nb64) : 0.0f;
  float a2s = k >= 2 ? coef(a2r, (k - 2) >> kCBlockShift, nb64) : 0.0f;
  float e1 = 2.0f - a1s;
  float e2 = -a2s - 1.0f;
  float second = (y00 - y1) - (y1 - y2);
  d[i] = (z0 + 2.0f * z1 + z2) - second - e1 * y1 - e2 * y2;
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// One cascade call over [B, n] rows. x: [B, npad], zero-padded past n;
// na1a/na2a/na1b/na2b: negated section denominators [B, nb64]; y: [B, n].
// Scratch, all allocated by the caller: p11, p12, q1, ya (and y0, d when
// refined): [B, npad]; m: [B, nb, 4]; c, s: [B, nb, 2]. Launches on
// `stream`, never synchronises, and returns cudaGetLastError().
extern "C" int lp24_cascade(int refined, const float* x, const float* na1a,
                            const float* na2a, const float* na1b,
                            const float* na2b, float* y, float* p11,
                            float* p12, float* q1, float* ya, float* y0,
                            float* d, float* m, float* c, float* s, int B,
                            int64_t n, int64_t npad, int ln, int nb64,
                            void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  int nb = (int)(npad / ln);
  unsigned g_blk = grid_for((int64_t)B * nb);
  unsigned g_all = grid_for((int64_t)B * npad);
  const float* na1s[2] = {na1a, na1b};
  const float* na2s[2] = {na2a, na2b};
  for (int sec = 0; sec < 2; ++sec) {
    const float* z = sec == 0 ? x : ya;
    float* out = sec == 0 ? ya : y;
    int64_t out_stride = sec == 0 ? npad : n;
    int64_t out_len = sec == 0 ? npad : n;
    phase1_kernel<<<g_blk, kThreads, 0, stream>>>(
        z, na1s[sec], na2s[sec], p11, p12, q1, m, c, B, npad, nb, ln, nb64);
    phase2_kernel<<<B, kThreads, 0, stream>>>(m, c, s, nb);
    if (!refined) {
      combine_kernel<<<g_all, kThreads, 0, stream>>>(
          z, nullptr, p11, p12, q1, s, out, B, npad, nb, ln, out_stride,
          out_len);
      continue;
    }
    combine_kernel<<<g_all, kThreads, 0, stream>>>(
        z, nullptr, p11, p12, q1, s, y0, B, npad, nb, ln, npad, npad);
    defect_kernel<<<g_all, kThreads, 0, stream>>>(z, y0, na1s[sec],
                                                   na2s[sec], d, B, npad,
                                                   nb64);
    corr_phase1_kernel<<<g_blk, kThreads, 0, stream>>>(
        d, na1s[sec], na2s[sec], q1, c, B, npad, nb, ln, nb64);
    phase2_kernel<<<B, kThreads, 0, stream>>>(m, c, s, nb);
    combine_kernel<<<g_all, kThreads, 0, stream>>>(
        y0, d, p11, p12, q1, s, out, B, npad, nb, ln, out_stride, out_len);
  }
  return (int)cudaGetLastError();
}
