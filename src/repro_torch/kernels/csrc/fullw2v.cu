// FULL-W2V training kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (built by repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fullw2v.py:
//   fullw2v_seq      <- _kernel            (:284-369, via fullw2v_pallas)
//   fullw2v_pipelined<- _kernel_pipelined  (:376-530, fullw2v_pallas with
//                                           pipeline=True)
//   fullw2v_tiled<PlainTable>
//                    <- _kernel_tiled      (:537-855, hot_rows=0,
//                                           prefetch=False, via
//                                           fullw2v_pallas_tiled)
//   fullw2v_tiled<SplitTable>
//                    <- _kernel_tiled      (:537-855, hot_rows>0,
//                                           prefetch=True, via
//                                           fullw2v_pallas_tiled_fused,
//                                           pallas_call at :1078)
//
// What bounds them on this card: latency. The reference orders every
// window of a batch after the previous one (its grid is sequential and
// batch_sgns_ref scans), so one window's few KB of row traffic and few
// thousand FLOPs sit on one dependent chain: global loads, a block-wide
// reduction, the write-back. Neither the 3.35 TB/s of HBM nor the f32 FMA
// peak is near; the time per window is the sum of those latencies.
//
// What the design does about it: it keeps the order (one CTA loops over
// the sentences; a CTA per sentence, Hogwild across SMs, would break parity
// with the reference and is left to a later kernel) and shortens the
// chain. The ring of context rows stays in shared memory for the lifetime
// of each row (loaded once, stored once); output rows are fetched once per
// window (K1), prefetched with cp.async one window ahead (K2), or fetched
// once per tile of T windows and updated in groups of G windows (K3). A
// window's (or a tile's) row loads are issued together, up to kRowBatch in
// flight, so their latencies overlap; each warp reduces several
// (context, output) pairs at once for the same reason.
// window.cuh holds the shared update and the column-ownership rule that
// makes cross-thread fences unnecessary.
//
// K4 is K3's body instantiated on the split working table of a
// vocab-sharded step (SplitTable: hot replica + gathered cold block, routed
// by id < hot), so the step never materializes concat(hot, got) and K4
// equals K3 on that concatenation bit for bit. The reference's cross-tile
// prefetch of the next tile's unique rows (prefetch=True, guarded by
// was_prefetched, fullw2v.py:617-636) is not built: K2's prefetch ran
// slower than K1 on this card, and K4 loads a tile's rows as K3 does.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "window.cuh"

namespace fullw2v {

// ---------------------------------------------------------------------------
// cp.async helpers (K2's prefetch): 4-byte copies, one column per thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Output row j of window t: the target for j = 0, else negative j-1.
__device__ __forceinline__ int out_row(const int* tok, const int* ng, int t,
                                       int j, int n_neg) {
  return j == 0 ? __ldg(tok + t) : __ldg(ng + (size_t)t * n_neg + j - 1);
}

// The ring of one sentence: slot = position mod rows. Table is the input
// table's row accessor (window.cuh); the slot math never sees it.
template <typename Table>
struct Ring {
  float* rows;
  int n;                 // ring rows: 2*w_f+1 sequential, T+2*w_f tiled
  Table w_in;
  const int* tok;
  int d;

  __device__ __forceinline__ void load(int q) const {   // w_in -> slot
    load_row(rows + (size_t)(q % n) * d, w_in.row(__ldg(tok + q)), d);
  }
  __device__ __forceinline__ void store(int p) const {  // slot -> w_in
    store_row(w_in.row(__ldg(tok + p)), rows + (size_t)(p % n) * d, d);
  }
  // Seed-kernel advance for window t: store the r_seq-distance evictee
  // (its windows are complete), then load the leading edge.
  __device__ __forceinline__ void advance(int t, int w_f, int r_seq,
                                          int length) const {
    const int q = t + w_f;
    if (q < length) {
      if (q - r_seq >= 0) store(q - r_seq);
      load(q);
    }
  }
  __device__ __forceinline__ void preload(int w_f, int L, int length) const {
    for (int q = 0; q < min(w_f, L); ++q)
      if (q < length) load(q);
  }
  // Flush surviving positions length-r_seq .. length-1, increasing order.
  __device__ __forceinline__ void flush(int r_seq, int length) const {
    for (int kk = 0; kk < r_seq; ++kk) {
      const int p = length - r_seq + kk;
      if (p >= 0 && p < length) store(p);
    }
  }
};

// One strictly ordered window: gather, fetch the m output rows, update,
// write them back (the reference's _seq_window, fullw2v.py:239-277).
template <typename Table>
__device__ __forceinline__ void seq_window(const Ring<Table>& ring,
                                           const Table& w_out,
                                           const int* ng, float* ctx,
                                           float* out, float* g, int t,
                                           int w_f, int n_neg, int length,
                                           float lr) {
  const int m = n_neg + 1;
  const int d = ring.d;
  gather_ctx(ring.rows, ring.n, ctx, t, w_f, length, d);
  load_rows(out, w_out, m, d,
            [&](int b) { return out_row(ring.tok, ng, t, b, n_neg); });
  window_group_update(ring.rows, ring.n, ctx, out, nullptr, nullptr, g, 1, t,
                      length, w_f, m, d, lr);
  for (int b = 0; b < m; ++b)
    store_row(w_out.row(out_row(ring.tok, ng, t, b, n_neg)),
              out + (size_t)b * d, d);
}

// ---------------------------------------------------------------------------
// K1: sequential, one window per step
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fullw2v_seq(float* w_in_base, float* w_out_base,
            const int* __restrict__ tokens,
            const int* __restrict__ negs, const int* __restrict__ lengths,
            float lr, int S, int L, int n_neg, int d, int w_f) {
  extern __shared__ float smem[];
  const int r = 2 * w_f + 1;
  const int K = 2 * w_f;
  const int m = n_neg + 1;
  float* ring_rows = smem;                       // [r][d]
  float* ctx = ring_rows + (size_t)r * d;        // [K][d]
  float* out = ctx + (size_t)K * d;              // [m][d]
  float* g = out + (size_t)m * d;                // [K*m]
  const PlainTable w_in{w_in_base, d}, w_out{w_out_base, d};

  for (int s = 0; s < S; ++s) {
    const int length = __ldg(lengths + s);
    const int* tok = tokens + (size_t)s * L;
    const int* ng = negs + (size_t)s * L * n_neg;
    const Ring<PlainTable> ring{ring_rows, r, w_in, tok, d};
    ring.preload(w_f, L, length);
    for (int t = 0; t < length; ++t) {
      ring.advance(t, w_f, r, length);
      seq_window(ring, w_out, ng, ctx, out, g, t, w_f, n_neg, length, lr);
    }
    ring.flush(r, length);
  }
}

// ---------------------------------------------------------------------------
// K2: K1 plus prefetch of window t+1's output rows while window t computes
// ---------------------------------------------------------------------------

// Does output row j of window t collide with any output row of window t-1
// (t >= 1)? The reference's conflicts_prev (fullw2v.py:414-421).
__device__ __forceinline__ bool conflicts_prev(const int* tok, const int* ng,
                                               int t, int j, int n_neg) {
  const int idx = out_row(tok, ng, t, j, n_neg);
  bool hit = false;
#pragma unroll 8
  for (int i = 0; i <= n_neg; ++i)
    hit |= idx == out_row(tok, ng, t - 1, i, n_neg);
  return hit;
}

// Begin async loads of window t's non-colliding rows into buffer `buf`.
__device__ __forceinline__ void start_prefetch(float* buf,
                                               const PlainTable& w_out,
                                               const int* tok, const int* ng,
                                               int t, int n_neg, int d) {
  for (int b = 0; b <= n_neg; ++b) {
    if (t > 0 && conflicts_prev(tok, ng, t, b, n_neg)) continue;
    const float* src = w_out.row(out_row(tok, ng, t, b, n_neg));
    float* dst = buf + (size_t)b * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      cp_async4(dst + j, src + j);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
fullw2v_pipelined(float* w_in_base, float* w_out_base,
                  const int* __restrict__ tokens,
                  const int* __restrict__ negs,
                  const int* __restrict__ lengths, float lr, int S, int L,
                  int n_neg, int d, int w_f) {
  extern __shared__ float smem[];
  const int r = 2 * w_f + 1;
  const int K = 2 * w_f;
  const int m = n_neg + 1;
  float* ring_rows = smem;                       // [r][d]
  float* ctx = ring_rows + (size_t)r * d;        // [K][d]
  float* out2 = ctx + (size_t)K * d;             // [2][m][d] double buffer
  float* g = out2 + (size_t)2 * m * d;           // [K*m]
  const PlainTable w_in{w_in_base, d}, w_out{w_out_base, d};

  for (int s = 0; s < S; ++s) {
    const int length = __ldg(lengths + s);
    const int* tok = tokens + (size_t)s * L;
    const int* ng = negs + (size_t)s * L * n_neg;
    const Ring<PlainTable> ring{ring_rows, r, w_in, tok, d};
    ring.preload(w_f, L, length);
    if (length > 0) start_prefetch(out2, w_out, tok, ng, 0, n_neg, d);

    for (int t = 0; t < length; ++t) {
      float* out = out2 + (size_t)(t & 1) * m * d;
      float* nxt = out2 + (size_t)((t + 1) & 1) * m * d;
      ring.advance(t, w_f, r, length);

      // this window's prefetched rows; colliding rows load now, after
      // window t-1's write-back
      cp_async_wait_all();
      if (t > 0)
        for (int b = 0; b < m; ++b)
          if (conflicts_prev(tok, ng, t, b, n_neg))
            load_row(out + (size_t)b * d,
                     w_out.row(out_row(tok, ng, t, b, n_neg)), d);

      // overlap: window t+1's rows stream in while window t computes. The
      // other warps finished reading `nxt` (window t-1) before the last
      // barrier of its update; the fence orders window t-1's write-back
      // before these reads of the same rows
      if (t + 1 < length) {
        __threadfence_block();
        start_prefetch(nxt, w_out, tok, ng, t + 1, n_neg, d);
      }

      gather_ctx(ring.rows, r, ctx, t, w_f, length, d);
      window_group_update(ring.rows, r, ctx, out, nullptr, nullptr, g, 1, t,
                          length, w_f, m, d, lr);
      for (int b = 0; b < m; ++b)
        store_row(w_out.row(out_row(tok, ng, t, b, n_neg)),
                  out + (size_t)b * d, d);
    }
    ring.flush(r, length);
  }
}

// ---------------------------------------------------------------------------
// K3: T windows per step over a ring of T+2*w_f rows, driven by the host
// tile plan (uniq, scatter, ucount, strict). Table = PlainTable is K3,
// Table = SplitTable is K4 (the same body on a split working table).
// ---------------------------------------------------------------------------

template <typename Table>
__global__ void __launch_bounds__(kThreads)
fullw2v_tiled(Table w_in, Table w_out, const int* __restrict__ tokens,
              const int* __restrict__ negs, const int* __restrict__ lengths,
              const int* __restrict__ uniq, const int* __restrict__ scatter,
              const int* __restrict__ ucount, const int* __restrict__ strict,
              float lr, int S, int L, int n_neg, int d, int w_f, int tile,
              int G) {
  extern __shared__ float smem[];
  const int K = 2 * w_f;
  const int m = n_neg + 1;
  const int rt = tile + 2 * w_f;           // ring covering the whole tile
  const int r_seq = 2 * w_f + 1;           // sequential store distance
  const int M = tile * m;                  // output slots per tile
  const int nt = (L + tile - 1) / tile;
  float* ring_rows = smem;                       // [rt][d]
  float* ctx = ring_rows + (size_t)rt * d;       // [G*K][d] (strict: K)
  float* out_uniq = ctx + (size_t)G * K * d;     // [M][d]
  float* exp_rows = out_uniq + (size_t)M * d;    // [G*m][d] (strict: m)
  float* g = exp_rows + (size_t)G * m * d;            // [G*K*m]

  for (int s = 0; s < S; ++s) {
    const int length = __ldg(lengths + s);
    const int* tok = tokens + (size_t)s * L;
    const int* ng = negs + (size_t)s * L * n_neg;
    const Ring<Table> ring{ring_rows, rt, w_in, tok, d};
    ring.preload(w_f, L, length);

    for (int i = 0; i < nt && i * tile < length; ++i) {
      const int t0 = i * tile;
      const size_t plan_row = (size_t)s * nt + i;

      if (__ldg(strict + plan_row)) {
        // exact sequential replay, ring advance per window as in K1
        for (int w = 0; w < tile && t0 + w < length; ++w) {
          ring.advance(t0 + w, w_f, r_seq, length);
          seq_window(ring, w_out, ng, ctx, exp_rows, g, t0 + w, w_f, n_neg,
                     length, lr);
        }
        continue;
      }

      // fused tile: one fetch of the deduplicated rows ...
      const int* uq = uniq + plan_row * M;
      const int* sc = scatter + plan_row * M;
      const int u = __ldg(ucount + plan_row);
      load_rows(out_uniq, w_out, u, d, [&](int c) { return __ldg(uq + c); });

      // ... GEMM groups of G windows, deltas applied between groups ...
      for (int w0 = 0; w0 < tile && t0 + w0 < length; w0 += G) {
        const int wn = min(G, tile - w0);
        const int base = t0 + w0;
        const int nv = min(wn, length - base);   // windows inside the sentence
        // window 0 stores then loads (sequential order); the other loads
        // come first and their evictees are stored after the update
        ring.advance(base, w_f, r_seq, length);
        for (int w = 1; w < wn; ++w)
          if (base + w + w_f < length) ring.load(base + w + w_f);
        for (int w = 0; w < nv; ++w)
          gather_ctx(ring.rows, rt, ctx + (size_t)w * K * d, base + w, w_f,
                     length, d);
        for (int sj = 0; sj < nv * m; ++sj) {
          const int col = __ldg(sc + w0 * m + sj);
          const float* src = out_uniq + (size_t)col * d;
          float* dst = exp_rows + (size_t)sj * d;
          for (int j = threadIdx.x; j < d; j += blockDim.x) dst[j] = src[j];
        }
        window_group_update(ring.rows, rt, ctx, exp_rows, out_uniq, sc + w0 * m,
                            g, nv, base, length, w_f, m, d, lr);
        for (int w = 1; w < wn; ++w) {
          const int q = base + w + w_f;
          if (q < length && q - r_seq >= 0) ring.store(q - r_seq);
        }
      }

      // ... and one write-back per unique row
      for (int c = 0; c < u; ++c)
        store_row(w_out.row(__ldg(uq + c)), out_uniq + (size_t)c * d, d);
    }
    ring.flush(r_seq, length);
  }
}

// Dynamic shared memory per kernel, in bytes.
size_t seq_smem(int d, int w_f, int n_neg, int pipeline) {
  const int r = 2 * w_f + 1, K = 2 * w_f, m = n_neg + 1;
  return sizeof(float) *
         ((size_t)(r + K + (pipeline ? 2 : 1) * m) * d + (size_t)K * m);
}

size_t tiled_smem(int d, int w_f, int n_neg, int tile, int G) {
  const int K = 2 * w_f, m = n_neg + 1, rt = tile + 2 * w_f;
  return sizeof(float) * ((size_t)(rt + G * K + tile * m + G * m) * d +
                          (size_t)G * K * m);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace fullw2v

extern "C" {

// K1 (pipeline = 0) or K2 (pipeline = 1) over one batch, in place.
int fullw2v_seq_launch(void* w_in, void* w_out, const void* tokens,
                       const void* negs, const void* lengths, float lr, int S,
                       int L, int n_neg, int d, int w_f, int pipeline,
                       void* stream) {
  const size_t smem = fullw2v::seq_smem(d, w_f, n_neg, pipeline);
  auto kernel = pipeline ? fullw2v::fullw2v_pipelined : fullw2v::fullw2v_seq;
  cudaError_t err = fullw2v::prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, fullw2v::kThreads, smem, (cudaStream_t)stream>>>(
      (float*)w_in, (float*)w_out, (const int*)tokens, (const int*)negs,
      (const int*)lengths, lr, S, L, n_neg, d, w_f);
  return (int)cudaGetLastError();
}

// K3 over one batch with its tile plan, in place.
int fullw2v_tiled_launch(void* w_in, void* w_out, const void* tokens,
                         const void* negs, const void* lengths,
                         const void* uniq, const void* scatter,
                         const void* ucount, const void* strict, float lr,
                         int S, int L, int n_neg, int d, int w_f, int tile,
                         int G, void* stream) {
  using fullw2v::PlainTable;
  const size_t smem = fullw2v::tiled_smem(d, w_f, n_neg, tile, G);
  auto kernel = fullw2v::fullw2v_tiled<PlainTable>;
  cudaError_t err = fullw2v::prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, fullw2v::kThreads, smem, (cudaStream_t)stream>>>(
      PlainTable{(float*)w_in, d}, PlainTable{(float*)w_out, d},
      (const int*)tokens, (const int*)negs, (const int*)lengths,
      (const int*)uniq, (const int*)scatter, (const int*)ucount,
      (const int*)strict, lr, S, L, n_neg, d, w_f, tile, G);
  return (int)cudaGetLastError();
}

// K4: K3 on the split working table (hot_in/hot_out: n_hot rows,
// got_in/got_out: the gathered cold block), in place. Every id lies in
// [0, n_hot + R); the wrapper checks.
int fullw2v_tiled_fused_launch(void* hot_in, void* hot_out, void* got_in,
                               void* got_out, int n_hot, const void* tokens,
                               const void* negs, const void* lengths,
                               const void* uniq, const void* scatter,
                               const void* ucount, const void* strict,
                               float lr, int S, int L, int n_neg, int d,
                               int w_f, int tile, int G, void* stream) {
  using fullw2v::SplitTable;
  const size_t smem = fullw2v::tiled_smem(d, w_f, n_neg, tile, G);
  auto kernel = fullw2v::fullw2v_tiled<SplitTable>;
  cudaError_t err = fullw2v::prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, fullw2v::kThreads, smem, (cudaStream_t)stream>>>(
      SplitTable{(float*)hot_in, (float*)got_in, n_hot, d},
      SplitTable{(float*)hot_out, (float*)got_out, n_hot, d},
      (const int*)tokens, (const int*)negs, (const int*)lengths,
      (const int*)uniq, (const int*)scatter, (const int*)ucount,
      (const int*)strict, lr, S, L, n_neg, d, w_f, tile, G);
  return (int)cudaGetLastError();
}

const char* fullw2v_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
