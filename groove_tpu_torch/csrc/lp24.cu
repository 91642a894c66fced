// lp24 cascade kernels for Hopper (sm_90a): K3, the single-pass cascade
// with block-rate denominators; K2, the same cascade with its
// defect-correction ("refine") pass; K6, the single-pass cascade with
// per-sample (or static, by-value) denominators; K7 and K8, K3 and K2 with
// their state carried from call to call (the sliced Welsh voices of the
// streaming renderer).
//
// Replaces groove_tpu/ops/pallas_iir.py:
//   K3  _make_kernel_lp24_blk (pallas_call in _lp24_blk_2d)
//   K2  _make_kernel_lp24_refined_blk, state_io=False (pallas_call in
//       _lp24_refined_blk_2d)
//   K6  _make_kernel_lp24 (pallas_call in _lp24_2d)
//   K7  _make_kernel_lp24_blk_state (pallas_call in _lp24_blk_state_2d)
//   K8  _make_kernel_lp24_refined_blk, state_io=True (pallas_call in
//       _lp24_refined_blk_state_2d)
// K7 and K8 are K3 and K2 with ln pinned to 64 (so that chained calls are
// bitwise one long call) and a State: each phase-2 chain starts from the
// carried pair and exports its exit (tdf2::Carry), and K8's defect reads
// the previous call's z, y0 and coefficient edges before sample 0 (History)
// and exports its own (edges_kernel). n is a multiple of 64, so there is no
// padded block and the exit is the last real block's; the TPU kernels'
// last_lane bookkeeping belongs to their chunk layout and has no
// counterpart here.
// K6 is K3 with the denominators read per sample (tdf2::kSample, through
// strides, so the static cascade's broadcast scalars are never
// materialised) or passed by value (tdf2::kScalar), and its in-block
// length is the caller's ln = block_for(n, 128) instead of
// max(block_for(n, 128), 64). The algorithm and its operation order are
// the reference's; the TPU layout ([G, ln, R, cb] folding, row packing,
// VMEM caps, lane-roll sweeps) is not. Per section:
//   phase 1   one thread per (row, ln-block), tdf2::phase1_kernel;
//   phase 2   one thread block per row walking the chain,
//             tdf2::phase2_kernel;
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

#include "tdf2.cuh"

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
    float dj = d[i];
    float r1 = __fmaf_rn(a, R1, R2) + a * dj;
    float r2 = __fmaf_rn(b, R1, b * dj);
    R1 = r1; R2 = r2;
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

// The history before sample 0 of one section, as the stream kernel K8
// carries it (rows 4-9 of the section's state, ops/iir_kernels.py
// STATE_ROWS): z and the solve's y0 at lags 1 and 2, and the previous
// call's last na1 and na2. Null: zero history (K2).
struct History {
  const float* p;  // z1, z2, y1, y2, na1, na2 at p[row * stride + 0..5]
  int64_t stride;
};

__device__ __forceinline__ float hist(History h, int64_t row, int j) {
  return h.p != nullptr ? h.p[row * h.stride + j] : 0.0f;
}

// Defect of the solve y0 against the shifted-coefficient TDF2 recurrence of
// the (1, 2, 1) section, epsilon-regrouped (ops/iir.py
// biquad_blockrate_refined in the reference):
//   d = (z + 2 z1 + z2) - ((y0 - y1) - (y1 - y2)) - e1 y1 - e2 y2,
//   e1 = 2 - na1[(i-1) >> 6], e2 = -na2[(i-2) >> 6] - 1,
// with the carried history `h` before sample 0.
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
  float e1 = 2.0f - a1s;
  float e2 = -a2s - 1.0f;
  float second = (y00 - y1) - (y1 - y2);
  d[i] = (z0 + 2.0f * z1 + z2) - second - e1 * y1 - e2 * y2;
}

// K8's edge export, one thread per row: the section input z and solve y0
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

// Carried state of the stream kernels, row offsets within a state row
// (ops/iir_kernels.py STATE_ROWS): K7 [B, 4] holds each section's solve
// pair at 2 * sec; K8 [B, 20] holds per section, at base 10 * sec, the
// solve pair (+0), the correction pair (+2) and the History (+4..+9).
struct State {
  const float* in;   // null: zero state, no export (K2, K3, K6)
  float* out;
  int64_t stride;    // 4 (K7) or 20 (K8)
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
    tdf2::phase2_kernel<<<B, kThreads, 0, stream>>>(m, c, s, nb,
                                                    carry(base));
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
    tdf2::phase2_kernel<<<B, kThreads, 0, stream>>>(m, c, s, nb,
                                                    carry(base + 2));
    combine_kernel<<<g_all, kThreads, 0, stream>>>(
        y0, d, p11, p12, q1, s, out, B, npad, nb, ln, out_stride, out_len);
  }
}

}  // namespace

// One cascade call over [B, n] rows. x: [B, npad], zero-padded past n;
// y: [B, n]. The negated section denominators na1a, na2a, na1b, na2b are
// read in `mode` (tdf2::Mode): kScalar takes the values v1a, v2a, v1b, v2b;
// kBlock and kSample take the arrays, all four indexed by one layout (row
// stride rs, entry stride ts, count entries per row). refined (K2, K8)
// needs kBlock. state_in/state_out: null for the stateless kernels; for
// the stream kernels K7 (refined = 0) and K8 (refined = 1) the carried
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
