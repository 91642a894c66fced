// S1: the first-order scans of the segment-streamed render with a carried
// state, for Hopper (sm_90a): groove_tpu/ops/stream.py one_pole_stream
// (:114) and max_decay_stream (:385), which the reference runs as an XLA
// associative_scan inside each 64-sample block and a serial lax.scan
// across blocks (no Pallas kernel):
//   linear     y[k] = a[k] y[k-1] + b[k] x[k]      (kLinear)
//   max_decay  y[k] = max(x[k], a[k] y[k-1])       (kMaxDecay)
// with y[-1] = y0, over [R, S] rows, S a multiple of 64. Every block of 64
// samples sits on the song's grid (a segment starts on a multiple of 64),
// and the in-block fold, the cross-block chain and the combine depend only
// on the block's own samples and the value entering it, so a song cut into
// any 64-multiple segments gives the same bits as one segment.
//
// The arithmetic, which fixes the bits: each block folds from its first
// element, (A, C) <- (a[k] A, a[k] C + b[k] x[k]) (max_decay: (A, V) <-
// (A a[k], max(x[k], V a[k]))); the blocks chain in order from y0, e <- A e
// + C (max_decay: max(V, A e)), e the value entering each block; then y[k]
// = C_k + A_k e (max_decay: max(V_k, A_k e)) with the block's running
// (A_k, C_k). The plain twin (ops/stream_kernels.py _scan_plain) runs the
// same folds in the same order; -fmad=false keeps every multiply and add
// rounded on its own, so kernel and twin agree bit for bit. Two blocks'
// maps are never composed: that would round differently, and a segment cut
// between them would then change the bits. The chain is therefore S / 64
// steps of two dependent operations a row, whatever the kernel does.
//
// What bounds it on the H100: that chain (124,032 steps a row at 3 minutes,
// 0.50 ms at 4 cycles an operation), far above the bytes (x, y and the
// per-sample coefficients once: 0.057 ms) for the few rows the render
// scans. The design, one launch a call (after a memset of the call's
// ticket and words, csrc/stage.cuh):
//   a thread block owns a span of `span` consecutive 64-blocks of one row,
//   takes its place in the row by an atomic ticket, and stages the span's
//   x (and a, b where they are arrays) in shared memory, one 256-byte TMA
//   bulk copy a 64-block (16-byte cp.async copies, 4-byte where a row is
//   not 16-byte aligned), each 64-block a row of kRow = 68 floats: a
//   thread folding its own block reads float4 q of row j at 17 j + q,
//   eight different bank groups for eight neighbouring threads, where a
//   64-float row would put all 32 threads of a warp on one bank;
//   every thread folds its blocks' maps (A, C) into shared memory;
//   thread 0 waits for the previous span's exit value (y0 for a row's
//   first span), walks the span's maps from shared memory, loading the
//   next 16 in the same straight-line code as the 16 it steps, keeps the
//   value entering each batch of 16 blocks, and publishes its exit (the
//   row's last span writes y_last);
//   every thread re-runs its block's batch from the kept value (the same
//   steps, the same bits), folds its blocks again from the staged inputs
//   and writes y over x in the tile, and the block stores the tile in
//   16-byte pieces, full lines. x, a and b move once from HBM, y once; no
//   block maps or entry values go through global memory.
// The span (ops/stream_kernels.py scan_plan): a span's first staging is
// not hidden (256-byte bulk copies stage about 9 GB/s an SM) and a handoff
// costs little against a span's walk (10-12 cycles a step on an H100:
// kernels/carried_times.py --stages), so a call's spans spread over the
// SMs, one each, from 128 blocks up to kSpanRows / streams (768 with x
// alone, 384 with one coefficient array, 256 with both: the stage
// kStageBytes = 768 x 68 x 4 = 208,896 bytes, one block an SM). A
// 262144-frame segment of a stereo bus is 2 x 32 spans of 128 blocks.
//
// Coefficients: a and b are numbers (by value) or [R, S] arrays read
// through a row stride (0 where a row broadcasts), contiguous in time. x is
// [R, S] with a row stride, contiguous in time; y is contiguous [R, S].

#include "stage.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kRow = 68;  // floats of a staged 64-block (17 float4s)
constexpr int kRow4 = kRow / 4;
constexpr int kThreads = 256;
constexpr int kSpanRows = 768;  // staged 64-blocks a span, x alone
constexpr int kStageBytes = kSpanRows * kRow * 4;
constexpr int kBatch = 16;  // maps the walker loads ahead
static_assert(kStageBytes == 208896, "ops/stream_kernels.py SCAN_STAGE");
static_assert(kStageBytes + kSpanRows * 12 + 16 + 1024 <= 232448,
              "the stage, the maps and entry values, and the runtime's 1 KB");
enum Mode { kLinear = 0, kMaxDecay = 1 };

struct Coef {
  const float* p;  // null: `v` everywhere
  float v;
  int64_t rs;      // row stride (elements); time is contiguous
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
__device__ __forceinline__ float chain_step(float2 m, float e) {
  return M == kLinear ? m.x * e + m.y : fmaxf(m.y, m.x * e);
}

template <int M>
__device__ __forceinline__ float join(float A, float C, float e) {
  return M == kLinear ? C + A * e : fmaxf(C, A * e);
}

// Stage rows [0, n) of 64-blocks from src (block 0 at src) into dst, 17
// float4s a row. kBulk: one 256-byte TMA copy a row, issued by warp 0 and
// counted on bar (src 16-byte aligned); else 16-byte cp.async copies from
// every thread (4-byte where src is not 16-byte aligned).
template <bool kBulk>
__device__ __forceinline__ void stage_rows(float4* dst, const float* src,
                                           int n, uint64_t* bar) {
  if (kBulk) {
    if (threadIdx.x < 32)
      for (int k = threadIdx.x; k < n; k += 32)
        stage::bulk_load(dst + k * kRow4, src + (int64_t)k * kBlock,
                         kBlock * 4, bar);
    return;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int g = threadIdx.x; g < n * 16; g += kThreads) {
    const int k = g >> 4, q = g & 15;
    float4* d = dst + k * kRow4 + q;
    const float* s = src + (int64_t)k * kBlock + 4 * q;
    if (vec) {
      tdf2::cp_async16(d, s);
    } else {
      float* df = reinterpret_cast<float*>(d);
#pragma unroll
      for (int u = 0; u < 4; ++u) tdf2::cp_async4(df + u, s + u);
    }
  }
}

// Fold block k of the tile from its first element; kOut: also write y over
// x with the entry value e.
template <int M, bool kOut>
__device__ __forceinline__ float2 fold_block(float4* xr, const float4* ar,
                                             const float4* br, float va,
                                             float vb, float e) {
  float A = 1.0f, C = 0.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 x4 = xr[q];
    const float4 a4 = ar != nullptr ? ar[q] : make_float4(va, va, va, va);
    const float4 b4 = br != nullptr ? br[q] : make_float4(vb, vb, vb, vb);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    const float as[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
    float ys[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float vk = M == kLinear ? bs[u] * xs[u] : xs[u];
      fold<M>(as[u], vk, 4 * q + u, A, C);
      if (kOut) ys[u] = join<M>(A, C, e);
    }
    if (kOut) xr[q] = make_float4(ys[0], ys[1], ys[2], ys[3]);
  }
  return make_float2(A, C);
}

// The span's blocks staged: x, and a and b where they are arrays.
struct Tile {
  float4* x;
  float4* a;
  float4* b;
};

// Grid: R * spans blocks, by ticket: ticket t is span t / R of row t % R,
// so a row's previous span holds ticket t - R. kBulk: every staged stream's
// rows start 16-byte aligned.
template <int M, bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
    scan_stream_kernel(const float* __restrict__ x, int64_t xrs, Coef a,
                       Coef b, const float* __restrict__ y0,
                       float* __restrict__ y_last, float* __restrict__ y,
                       stage::Chain chain, int R, int64_t nb, int span,
                       int spans) {
  extern __shared__ float4 tile[];
  __shared__ float2 maps[kSpanRows + kBatch];  // the walker reads ahead
  __shared__ float keep[kSpanRows / kBatch];  // entering each batch
  __shared__ uint64_t full;
  __shared__ unsigned tk;
  if (kBulk && threadIdx.x == 0) {
    tdf2::mbar_init(&full, 1);
    stage::fence_mbarrier_init();
  }
  const int64_t t = stage::take_ticket(chain.ticket, &tk);
  STAGE_TIME(t * 8);
  const int64_t row = t % R;
  const int sp = (int)(t / R);
  const int64_t k0 = (int64_t)sp * span;
  const int nk = (int)min((int64_t)span, nb - k0);
  const bool has_a = a.p != nullptr;
  const bool has_b = M == kLinear && b.p != nullptr;
  const int rows = (int)min((int64_t)span, nb);  // the widest span's
  Tile s = {tile, nullptr, nullptr};
  if (has_a) s.a = tile + rows * kRow4;
  if (has_b) s.b = tile + (1 + has_a) * rows * kRow4;

  if (kBulk && threadIdx.x == 0)
    stage::expect_bytes(&full, (1 + has_a + has_b) * nk * kBlock * 4);
  __syncwarp();
  stage_rows<kBulk>(s.x, x + row * xrs + k0 * kBlock, nk, &full);
  if (has_a) stage_rows<kBulk>(s.a, a.p + row * a.rs + k0 * kBlock, nk, &full);
  if (has_b) stage_rows<kBulk>(s.b, b.p + row * b.rs + k0 * kBlock, nk, &full);
  if (kBulk) {
    tdf2::mbar_wait<false>(&full, 0);
  } else {
    stage::cp_async_commit();
    stage::cp_async_wait(0);
    __syncthreads();
  }
  STAGE_TIME(t * 8 + 1);

  for (int k = threadIdx.x; k < nk; k += kThreads)
    maps[k] = fold_block<M, false>(
        s.x + k * kRow4, has_a ? s.a + k * kRow4 : nullptr,
        has_b ? s.b + k * kRow4 : nullptr, a.v, b.v, 0.0f);
  __syncthreads();
  STAGE_TIME(t * 8 + 2);

  // The walker keeps the value entering each batch of kBatch blocks (a
  // store a step would stall the chain); the blocks re-run their batch's
  // steps from it below, the same steps with the same bits. It loads the
  // next batch's maps in the same straight-line code as this batch's
  // steps, so that the loads issue between the chain's operations (the
  // thread issues in order: loads apart from the chain would wait their
  // turn on it), two register batches taking turns.
  if (threadIdx.x == 0) {
    unsigned long long* word = chain.words + row * spans + sp;
    float e = sp == 0 ? y0[row] : stage::await_carry(word - 1);
    STAGE_TIME(t * 8 + 3);
    STAGE_TICK(w0);
    const int whole = nk / kBatch * kBatch;
    float2 ma[kBatch], mb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) ma[u] = maps[u];
    int k = 0;
    while (k < whole) {
      keep[k / kBatch] = e;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        mb[u] = maps[k + kBatch + u];
        e = chain_step<M>(ma[u], e);
      }
      k += kBatch;
      if (k >= whole) break;
      keep[k / kBatch] = e;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ma[u] = maps[k + kBatch + u];
        e = chain_step<M>(mb[u], e);
      }
      k += kBatch;
    }
    if (k < nk) keep[k / kBatch] = e;
    for (; k < nk; ++k) e = chain_step<M>(maps[k], e);
    if (sp + 1 < spans)
      stage::publish(word, e);
    else
      y_last[row] = e;
    STAGE_SUM(t * 8 + 6, w0);
    STAGE_TIME(t * 8 + 4);
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nk; k += kThreads) {
    float e = keep[k / kBatch];
    for (int j = k / kBatch * kBatch; j < k; ++j)
      e = chain_step<M>(maps[j], e);
    fold_block<M, true>(s.x + k * kRow4, has_a ? s.a + k * kRow4 : nullptr,
                        has_b ? s.b + k * kRow4 : nullptr, a.v, b.v, e);
  }
  __syncthreads();

  float* yr = y + row * nb * kBlock + k0 * kBlock;
  for (int g = threadIdx.x; g < nk * 16; g += kThreads) {
    const int k = g >> 4, q = g & 15;
    *reinterpret_cast<float4*>(yr + (int64_t)k * kBlock + 4 * q) =
        s.x[k * kRow4 + q];
  }
  STAGE_TIME(t * 8 + 5);
}

template <int M>
void launch(bool bulk, unsigned grid, unsigned smem, cudaStream_t st,
            const float* x, int64_t xrs, Coef a, Coef b, const float* y0,
            float* y_last, float* y, stage::Chain chain, int R, int64_t nb,
            int span, int spans) {
  if (bulk)
    scan_stream_kernel<M, true><<<grid, kThreads, smem, st>>>(
        x, xrs, a, b, y0, y_last, y, chain, R, nb, span, spans);
  else
    scan_stream_kernel<M, false><<<grid, kThreads, smem, st>>>(
        x, xrs, a, b, y0, y_last, y, chain, R, nb, span, spans);
}

// Whether a stream's rows start 16-byte aligned (a null stream is not
// staged).
bool aligned(const float* p, int64_t rs) {
  return p == nullptr || ((reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                          (rs * 4) % 16 == 0);
}

}  // namespace

// One carried-state scan over [R, S] rows (S a positive multiple of 64) in
// `mode` (0 linear, 1 max_decay). x: row stride xrs, time contiguous. a, b:
// arrays (pa, pb non-null; row strides ars, brs, 0 to broadcast; time
// contiguous) or values va, vb (max_decay reads no b). y0, y_last: [R].
// y: contiguous [R, S], 16-byte aligned. span: 64-blocks a thread block
// owns (ops/stream_kernels.py scan_plan: a multiple of 16, at most
// kSpanRows / streams). scratch: 1 + R * ceil(S / 64 / span) 64-bit words
// of ticket and flags, zeroed on `stream` first. One launch on `stream`;
// never synchronises; returns cudaGetLastError().
extern "C" int scan_stream(int mode, const float* x, int64_t xrs,
                           const float* pa, float va, int64_t ars,
                           const float* pb, float vb, int64_t brs,
                           const float* y0, float* y_last, float* y,
                           void* scratch, int R, int64_t S, int span,
                           void* stream_handle) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  const int streams =
      1 + (pa != nullptr) + (mode == kLinear && pb != nullptr);
  if (R <= 0 || S <= 0 || S % kBlock != 0 ||
      (mode != kLinear && mode != kMaxDecay) || span <= 0 ||
      span % kBatch != 0 || span * streams > kSpanRows ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  static bool done[stage::kMaxDevices] = {};
  const void* kernels[4] = {(const void*)scan_stream_kernel<kLinear, false>,
                            (const void*)scan_stream_kernel<kLinear, true>,
                            (const void*)scan_stream_kernel<kMaxDecay, false>,
                            (const void*)scan_stream_kernel<kMaxDecay, true>};
  int err = stage::allow_smem(done, kernels, 4, kStageBytes);
  if (err != 0) return err;
  const int64_t nb = S / kBlock;
  const int64_t spans = (nb + span - 1) / span;
  if (R * spans > 0x7fffffff) return (int)cudaErrorInvalidValue;
  stage::Chain chain;
  const cudaError_t e = stage::chain_of(scratch, 1 + R * spans, st, &chain);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = nb < span ? nb : span;  // the widest span's blocks
  const unsigned smem = (unsigned)(streams * rows * kRow * 4);
  const Coef a = {pa, va, ars}, b = {pb, vb, brs};
  const unsigned grid = (unsigned)(R * spans);
  const bool bulk = aligned(x, xrs) && aligned(pa, ars) &&
                    (mode != kLinear || aligned(pb, brs));
  if (mode == kLinear)
    launch<kLinear>(bulk, grid, smem, st, x, xrs, a, b, y0, y_last, y, chain,
                    R, nb, span, (int)spans);
  else
    launch<kMaxDecay>(bulk, grid, smem, st, x, xrs, a, b, y0, y_last, y,
                      chain, R, nb, span, (int)spans);
  return (int)cudaGetLastError();
}
