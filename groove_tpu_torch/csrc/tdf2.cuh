// Shared pieces of the two-level TDF2 scan for Hopper (sm_90a), used by
// lp24.cu (K2, K3, K6), lp24_stream.cu (K7, K8), biquad.cu (K4, K5, K9)
// and serial.cu.
//
// Every kernel of groove_tpu/ops/pallas_iir.py runs one algorithm per
// section: phase 1, in-block prefix affine maps (a serial scan over ln
// samples per block); phase 2, the serial cross-block chain of the block
// maps; then an elementwise combine. This header holds what the sections
// share: how a coefficient is read, the in-block recurrence steps of the
// solve and of the refined cascades' correction (`step` = `step_p` twice
// and `step_q`, `corr_step`: one
// explicit __fmaf_rn per map entry, mirrored by fma32 in the plain twins of
// ops/iir_kernels.py), the refined cascades' defect (`lp24_defect`), the
// phase-1 kernel and the phase-2 chain. The device functions are the only
// copy of that arithmetic: the multi-launch kernels here and in lp24.cu, the
// tiled kernels of tiled.cuh (K4, K2) and the one-launch stream kernel of
// lp24_stream.cu all call them, so they cannot drift apart.
//
// What bounds it on the H100. The chain is the one serial part of every
// kernel that uses this header: n / ln dependent steps per row, each a
// multiply, an add and an add deep (2x2 map times state plus offset, every
// operation rounded separately), so a few-row call waits on one thread's
// arithmetic latency and on nothing else. phase2_kernel therefore gives
// that thread nothing else to do: a second warp of its block moves the
// block maps into shared memory ahead of it and the entry states out
// behind it, through a ring of stages handed over with mbarriers, and the
// walker reads a step's map as one 16-byte and one 8-byte shared load,
// issued a batch of steps ahead of the arithmetic that consumes them, and
// stores one state in eight (the movers re-run the rest). On an H100 a
// step's arithmetic alone takes 14 cycles from one thread (three dependent
// operations of 4 cycles, and the in-order issue of the step's two rows).
// kernels/stage_cycles.py stamps the walker with clock64 and prints its
// cycles per step.
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
constexpr int kThreads = 256;
// The phase-2 chain: a ring of kChainStages stages of kChainTile block maps
// in shared memory; warp 0 holds the walker (its lane 0), warp 1 moves
// data; the walker keeps the maps of kChainBatch steps in registers.
// (On an H100 768 x 2 read 17.0 cycles a step, 512 x 2 19.5, 256 x 4 17.3,
// 896 x 2 17.0, 640 x 3 17.5: kernels/stage_cycles.py with these constants
// edited. 768 x 2 is 39,936 bytes of static shared memory.)
constexpr int kChainTile = 768;
constexpr int kChainStages = 2;
constexpr int kChainThreads = 64;
constexpr int kChainMovers = kChainThreads - 32;
constexpr int kChainBatch = 8;
static_assert(kChainTile % (2 * kChainBatch) == 0, "whole batch pairs");

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

// One sample of a section's in-block prefix scan: the 2x2 map P and the
// offset Q advance by the sample's negated denominators a = -a1, b = -a2
// and its numerator terms c1 = b1m x, c2 = b2m x. The map's two columns
// and the offset are three independent recurrences (step_p twice, step_q),
// which a kernel may give to different threads.
__device__ __forceinline__ void step_p(float a, float b, float& P1,
                                       float& P2) {
  float n1 = __fmaf_rn(a, P1, P2);
  float n2 = b * P1;
  P1 = n1; P2 = n2;
}

__device__ __forceinline__ void step_q(float a, float b, float c1, float c2,
                                       float& Q1, float& Q2) {
  float r1 = __fmaf_rn(a, Q1, Q2) + c1;
  float r2 = __fmaf_rn(b, Q1, c2);
  Q1 = r1; Q2 = r2;
}

__device__ __forceinline__ void step(float a, float b, float c1, float c2,
                                     float& P11, float& P12, float& P21,
                                     float& P22, float& Q1, float& Q2) {
  step_p(a, b, P11, P21);
  step_p(a, b, P12, P22);
  step_q(a, b, c1, c2, Q1, Q2);
}

// One sample of the correction's r-only scan (numerator (1, 0, 0) on the
// defect dj; the maps are the solve's).
__device__ __forceinline__ void corr_step(float a, float b, float dj,
                                          float& R1, float& R2) {
  float r1 = __fmaf_rn(a, R1, R2) + a * dj;
  float r2 = __fmaf_rn(b, R1, b * dj);
  R1 = r1; R2 = r2;
}

// Defect of the solve y0 against the shifted-coefficient TDF2 recurrence of
// a (1, 2, 1) section, epsilon-regrouped (ops/iir.py
// biquad_blockrate_refined in the reference):
//   d = (z + 2 z1 + z2) - ((y0 - y1) - (y1 - y2)) - e1 y1 - e2 y2,
//   e1 = 2 - na1[(i-1) >> 6], e2 = -na2[(i-2) >> 6] - 1.
// z1, z2, y1, y2: the section input and the solve at lags 1 and 2; a1s,
// a2s: the negated denominators at those shifted positions.
__device__ __forceinline__ float lp24_defect(float z0, float z1, float z2,
                                             float y00, float y1, float y2,
                                             float a1s, float a2s) {
  float e1 = 2.0f - a1s;
  float e2 = -a2s - 1.0f;
  float second = (y00 - y1) - (y1 - y2);
  return (z0 + 2.0f * z1 + z2) - second - e1 * y1 - e2 * y2;
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
    step(a, b, c1, c2, P11, P12, P21, P22, Q1, Q2);
  }
  m[t * 4 + 0] = P11;
  m[t * 4 + 1] = P12;
  m[t * 4 + 2] = P21;
  m[t * 4 + 3] = P22;
  c[t * 2 + 0] = Q1;
  c[t * 2 + 1] = Q2;
}

}  // namespace

// A chain's state carried across calls (S3, biquad.cu biquad_tiled_state;
// and the earlier, multi-launch route of the stateful cascades, kept
// beside lp24_stream.cu's kernel as its yardstick): the pair entering
// block 0 is read from in[row * stride + {0, 1}] (zeros when in is null)
// and the pair leaving the last block is written to
// out[row * stride + {0, 1}] (skipped when out is null).
struct Carry {
  const float* in;
  float* out;
  int64_t stride;
};

constexpr Carry kNoCarry = {nullptr, nullptr, 0};

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes of which the first `bytes` come from src and the
// rest are zeros, of 8 bytes, and of 4 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarriers in shared memory: `count` arrivals complete a phase; wait(p)
// returns once the phase of parity p has completed (phases count from 0).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// kSleep: between tries the thread sleeps, so that a warp that waits long
// (a mover, a whole tile's walk) leaves the shared-memory pipe to the
// walker.
template <bool kSleep>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try(bar, parity)) {
    if (kSleep) __nanosleep(100);
  }
}

// One stage of the chain's ring: kChainTile block maps (M as float4, C as
// float2) and, from the walker, the state entering each batch of
// kChainBatch steps. Stores are the dearest instructions the walker
// issues, so it keeps one state in kChainBatch and the movers re-run each
// batch from its kept state (chain_step again: the same bits) when they
// write the entry states out.
struct __align__(16) ChainStage {
  float4 m[kChainTile];
  float2 c[kChainTile];
  float2 keep[kChainTile / kChainBatch];
};

struct ChainBatch {
  float4 m[kChainBatch];      // one map per step
  float4 c[kChainBatch / 2];  // two steps' offsets each
};

__device__ __forceinline__ void chain_load(const ChainStage& st, int k,
                                           ChainBatch& b) {
  const float4* c4 = reinterpret_cast<const float4*>(st.c);
#pragma unroll
  for (int u = 0; u < kChainBatch; ++u) b.m[u] = st.m[k + u];
#pragma unroll
  for (int u = 0; u < kChainBatch / 2; ++u) b.c[u] = c4[k / 2 + u];
}

// One step S' = M S + C, every multiply and add rounded by itself.
__device__ __forceinline__ void chain_step(float4 mk, float c1, float c2,
                                           float& s1, float& s2) {
  float n1 = mk.x * s1 + mk.y * s2 + c1;
  float n2 = mk.z * s1 + mk.w * s2 + c2;
  s1 = n1;
  s2 = n2;
}

// kChainBatch steps from registers.
__device__ __forceinline__ void chain_run(const ChainBatch& b, float& s1,
                                          float& s2) {
#pragma unroll
  for (int u = 0; u < kChainBatch / 2; ++u) {
    chain_step(b.m[2 * u], b.c[u].x, b.c[u].y, s1, s2);
    chain_step(b.m[2 * u + 1], b.c[u].z, b.c[u].w, s1, s2);
  }
}

// The walker's part of one stage: `cnt` steps from (s1, s2), keeping the
// state that enters each batch. Two register batches take turns, each
// loaded while the other runs, so that no step waits for a shared-memory
// load, and a pair's two kept states go out as one 16-byte store. A load
// past cnt stays inside the stage and its values are never used.
__device__ __forceinline__ void chain_walk(ChainStage& st, int cnt, float& s1,
                                           float& s2) {
  constexpr int kPair = 2 * kChainBatch;
  float4* keep4 = reinterpret_cast<float4*>(st.keep);
  ChainBatch a, b;
  chain_load(st, 0, a);
  int k = 0;
  for (; k + kPair <= cnt; k += kPair) {
    chain_load(st, k + kChainBatch, b);
    float4 kept;
    kept.x = s1;
    kept.y = s2;
    chain_run(a, s1, s2);
    kept.z = s1;
    kept.w = s2;
    // stored here, in the middle: at the loop's end the store would have to
    // read the carried pair's registers before the last step may write them
    keep4[k / kPair] = kept;
    chain_load(st, min(k + kPair, kChainTile - kChainBatch), a);
    chain_run(b, s1, s2);
  }
  if (k + kChainBatch <= cnt) {
    st.keep[k / kChainBatch] = make_float2(s1, s2);
    chain_run(a, s1, s2);
    k += kChainBatch;
  }
  if (k < cnt) st.keep[k / kChainBatch] = make_float2(s1, s2);
  for (; k < cnt; ++k) chain_step(st.m[k], st.c[k].x, st.c[k].y, s1, s2);
}

// A mover's part of a walked stage: the entry states of batches p,
// p + kChainMovers, ... of its `cnt` steps, re-run from the kept states
// and written to sr.
__device__ __forceinline__ void chain_expand(const ChainStage& st, int cnt,
                                             int p, float2* __restrict__ sr) {
  for (int g = p; g * kChainBatch < cnt; g += kChainMovers) {
    float2 s = st.keep[g];
    const int end = min((g + 1) * kChainBatch, cnt);
    for (int k = g * kChainBatch; k < end; ++k) {
      sr[k] = s;
      chain_step(st.m[k], st.c[k].x, st.c[k].y, s.x, s.y);
    }
  }
}

// Phase 2: one thread block per row walks the chain
// S[k+1] = M[k] S[k] + C[k]. m: [B, nb, 4] (16-byte aligned), c: [B, nb, 2],
// s: [B, nb, 2], the state ENTERING block k. The TPU's lane-roll sweeps and
// chunk carries compute exactly this chain; the 2x2 maps are never composed
// associatively (that diverges in f32 near z = 1). The kernel walks blocks
// k0 .. k0 + steps - 1 of every row; `carry` seeds the chain (in null: zero
// entry) and exports its exit (out null: no export).
//
// Thread 0 walks. The movers (warp 1) fill stage t % kChainStages with
// tile t's maps by cp.async and arrive on full[stage]; the walker waits
// there, walks, and arrives on empty[stage]; the movers wait there, write
// the tile's entry states to s (chain_expand) and refill the stage with
// tile t + kChainStages (a named barrier of the movers alone sits between
// the two). There is no __syncthreads() after the barriers' set-up.
__global__ void __launch_bounds__(kChainThreads)
    phase2_kernel(const float* __restrict__ m, const float* __restrict__ c,
                  float* __restrict__ s, int nb, int k0, int steps,
                  Carry carry) {
  __shared__ ChainStage stage[kChainStages];
  __shared__ __align__(8) uint64_t full[kChainStages];
  __shared__ __align__(8) uint64_t empty[kChainStages];
  const int64_t row = blockIdx.x;
  const int ntiles = (steps + kChainTile - 1) / kChainTile;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kChainStages; ++b) {
      mbar_init(&full[b], kChainMovers);
      mbar_init(&empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    const int p = threadIdx.x - 32;
    const float4* mr = reinterpret_cast<const float4*>(m) + row * nb + k0;
    const float2* cr = reinterpret_cast<const float2*>(c) + row * nb + k0;
    float2* sr = reinterpret_cast<float2*>(s) + row * nb + k0;
    for (int t = 0; t < ntiles + kChainStages; ++t) {
      const int b = t % kChainStages, use = t / kChainStages;
      if (t >= kChainStages) {  // the tile this stage held has been walked
        mbar_wait<true>(&empty[b], (use - 1) & 1);
        const int base = (t - kChainStages) * kChainTile;
        chain_expand(stage[b], min(kChainTile, steps - base), p, sr + base);
        // every mover is done with the stage's maps before any refills it
        asm volatile("bar.sync 1, %0;\n" ::"n"(kChainMovers) : "memory");
      }
      if (t < ntiles) {
        const int base = t * kChainTile;
        const int cnt = min(kChainTile, steps - base);
        for (int i = p; i < cnt; i += kChainMovers) {
          cp_async16(&stage[b].m[i], mr + base + i);
          cp_async8(&stage[b].c[i], cr + base + i);
        }
        cp_async_wait_all();
        mbar_arrive(&full[b]);
      }
    }
  } else if (threadIdx.x == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    if (carry.in != nullptr) {
      s1 = carry.in[row * carry.stride];
      s2 = carry.in[row * carry.stride + 1];
    }
    for (int t = 0; t < ntiles; ++t) {
      const int b = t % kChainStages, use = t / kChainStages;
      mbar_wait<false>(&full[b], use & 1);
      chain_walk(stage[b], min(kChainTile, steps - t * kChainTile), s1, s2);
      mbar_arrive(&empty[b]);
    }
    if (carry.out != nullptr) {
      carry.out[row * carry.stride] = s1;
      carry.out[row * carry.stride + 1] = s2;
    }
  }
}

// Launch the chains of B rows of nb block maps on `stream`: all of each
// row, or its blocks k0 .. k0 + steps - 1 (a segment of a longer chain,
// which `carry` then joins to its neighbours).
inline void chain(const float* m, const float* c, float* s, int nb, int B,
                  Carry carry, cudaStream_t stream, int k0 = 0,
                  int steps = -1) {
  phase2_kernel<<<B, kChainThreads, 0, stream>>>(
      m, c, s, nb, k0, steps < 0 ? nb - k0 : steps, carry);
}

}  // namespace
}  // namespace tdf2
