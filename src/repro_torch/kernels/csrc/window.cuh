// Shared window machinery of the FULL-W2V kernels for Hopper (sm_90a).
//
// Replaces the building blocks that the Pallas kernels of
// src/repro/kernels/fullw2v.py share: _window_update (:157-182),
// _gather_window_ctx (:192-201), _scatter_window_ctx (:204-213) and the
// label/mask helpers (:216-236), and the _Table row router (:101-155)
// of the split-table kernel (PlainTable/SplitTable).
//
// Who uses it: the tiled kernels K3 and K4 (fullw2v.cu) run
// window_group_update for their arithmetic. The sequential kernels K1 and
// K2, which replace _kernel (:284) and _kernel_pipelined (:376), have their
// own body (seq.cuh) built for the latency of one window; it shares
// kThreads and stable_sigmoid from here and keeps every sum of
// window_group_update in the same order, so K1, K2 and K3 at T=1 agree bit
// for bit wherever their inputs agree.
//
// What bounds it on this card: latency, not bytes or FLOPs. A window moves
// about (2*(N+1) + 2) rows of d floats and does 3*2*K*(N+1)*d FLOPs, a few
// KB and a few thousand FLOPs, and the reference's semantics order every
// window after the previous one (strict sentence order). Each window is a
// chain of dependent global loads, one block-wide reduction and the
// write-back.
//
// What the design does about it: one CTA walks the batch; thread j owns
// columns j, j + blockDim.x, ... of every row. The owner issues every
// global load and store of its columns, so program order inside one thread
// keeps the reference's store-then-load order on repeated tokens with no
// fence across threads. Context ring, gathered context rows and output
// rows live in shared memory (the reference's VMEM scratch). Only the
// K x (N+1) dot products cross columns: each warp takes a subset of the
// pairs, kPairsInFlight at a time, and reduces over d with lanes on
// consecutive columns and a fixed xor-shuffle tree, so the sums are
// deterministic. Arithmetic is plain f32 FMA and expf in the two-branch
// stable sigmoid of core/sgns.py (no tensor cores, no TF32).
#pragma once

#include <cuda_runtime.h>

namespace fullw2v {

constexpr int kThreads = 128;             // 4 warps; columns stride by this
constexpr int kWarps = kThreads / 32;

// Window-relative context offset of slot a: [-w_f..w_f] without 0.
__device__ __forceinline__ int ctx_offset(int a, int w_f) {
  return a < w_f ? a - w_f : a - w_f + 1;
}

__device__ __forceinline__ float stable_sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

// Copy window t's 2*w_f context rows from the ring into ctx (K rows of d);
// positions outside [0, length) read 0. Owner columns only.
__device__ __forceinline__ void gather_ctx(const float* ring, int ring_rows,
                                           float* ctx, int t, int w_f,
                                           int length, int d) {
  const int K = 2 * w_f;
  for (int a = 0; a < K; ++a) {
    const int p = t + ctx_offset(a, w_f);
    const bool ok = p >= 0 && p < length;
    const float* src = ring + (size_t)(ok ? p % ring_rows : 0) * d;
    float* dst = ctx + (size_t)a * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      dst[j] = ok ? src[j] : 0.0f;
  }
}

// Row access of an embedding table: a row pointer for a row id. The plain
// (V, d) table of K1-K3 ...
struct PlainTable {
  float* base;
  int d;
  __device__ __forceinline__ float* row(int id) const {
    return base + (size_t)id * d;
  }
};

// ... and K4's split working table of a vocab-sharded step: ids below hot
// live in the hot replica, the rest in the gathered cold block at id - hot.
// The split changes only where a row lives, never the order of any load,
// FMA or store, so K4 on (hot, got) equals K3 on concat(hot, got) bit for
// bit.
struct SplitTable {
  float* hot;
  float* got;
  int n_hot;
  int d;
  __device__ __forceinline__ float* row(int id) const {
    return id < n_hot ? hot + (size_t)id * d : got + (size_t)(id - n_hot) * d;
  }
};

// Table row -> shared row, owner columns (a plain load: the same thread
// may have stored this row earlier in the batch).
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) dst[j] = src[j];
}

// Table rows row(0) .. row(n-1) -> shared rows 0 .. n-1, owner columns.
// Up to kRowBatch loads are in flight together, so the rows' latencies
// overlap instead of adding up.
constexpr int kRowBatch = 8;

template <typename Table, typename RowIndex>
__device__ __forceinline__ void load_rows(float* dst, const Table& table,
                                          int n, int d, RowIndex row) {
  for (int b0 = 0; b0 < n; b0 += kRowBatch) {
    const float* src[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b)
      src[b] = table.row(b0 + b < n ? row(b0 + b) : 0);
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      float v[kRowBatch];
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b)
        if (b0 + b < n) v[b] = src[b][j];
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b)
        if (b0 + b < n) dst[(size_t)(b0 + b) * d + j] = v[b];
    }
  }
}

// Shared row -> table row, owner columns.
__device__ __forceinline__ void store_row(float* dst, const float* src,
                                          int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) dst[j] = src[j];
}

// The SGNS update of nw consecutive windows base .. base+nw-1 (nw = 1 for
// the sequential kernels, a GEMM group of the tiled one). All windows must
// lie inside the sentence (base + nw <= length).
//
//   ctx  [nw*K][d]   gathered context rows (0 where the position is out)
//   src  [nw*m][d]   the windows' output rows, pre-update values
//   dst, dst_rows    where output deltas land: row dst_rows[w*m+b] of dst,
//                    or row w*m+b of src when dst_rows is null
//   ring             context ring of ring_rows rows, receives d_ctx
//   g                shared scratch of nw*K*m floats
//
// corr = ctx . src^T per window, g = lr*(label - sigmoid(corr)) masked to
// real context positions, d_ctx = g . src into the ring (rows in window,
// then offset order), d_out = g^T . ctx into dst (slot order, so repeated
// rows accumulate in the reference's order). Ends with every thread past
// the reads of ctx/src by other threads. ring, ctx and g overlap no other
// buffer (they are __restrict__).
//
// Each warp reduces kPairsInFlight pairs at once (independent chains, one
// shuffle tree each); every pair's sum keeps one fixed order: lane j adds
// columns j, j+32, ... and the xor tree folds the lanes.
constexpr int kPairsInFlight = 4;

__device__ void window_group_update(float* __restrict__ ring, int ring_rows,
                                    const float* __restrict__ ctx, float* src,
                                    float* dst, const int* dst_rows,
                                    float* __restrict__ g, int nw, int base,
                                    int length, int w_f, int m, int d,
                                    float lr) {
  constexpr int P = kPairsInFlight;
  const int K = 2 * w_f;
  const int pairs = nw * K * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __syncthreads();  // owners' writes of ctx/src visible to every warp

  for (int pr0 = warp * P; pr0 < pairs; pr0 += kWarps * P) {
    const float* x[P];
    const float* y[P];
    bool ok[P];                                // warp-uniform
    float corr[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int pr = pr0 + q;
      const int w = pr / (K * m);
      const int a = (pr / m) % K;
      const int b = pr % m;
      const int p = base + w + ctx_offset(a, w_f);
      ok[q] = pr < pairs && p >= 0 && p < length;
      x[q] = ctx + (size_t)(w * K + a) * d;
      y[q] = src + (size_t)(w * m + b) * d;
      corr[q] = 0.0f;
    }
    for (int j = lane; j < d; j += 32) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (ok[q]) corr[q] = fmaf(x[q][j], y[q][j], corr[q]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        corr[q] += __shfl_xor_sync(0xffffffffu, corr[q], o);
    }
    // lane q finishes pair pr0 + q
    float c = corr[0];
    bool v = ok[0];
#pragma unroll
    for (int q = 1; q < P; ++q)
      if (lane == q) {
        c = corr[q];
        v = ok[q];
      }
    const int pr = pr0 + lane;
    if (lane < P && pr < pairs) {
      const float label = pr % m == 0 ? 1.0f : 0.0f;
      g[pr] = v ? lr * (label - stable_sigmoid(c)) : 0.0f;
    }
  }

  __syncthreads();  // g complete; every read of ctx/src by other warps done

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    // d_ctx = g . src, added into the ring (pre-update src values)
    for (int w = 0; w < nw; ++w) {
      for (int a = 0; a < K; ++a) {
        const int p = base + w + ctx_offset(a, w_f);
        if (p < 0 || p >= length) continue;    // zero gradient
        const float* gr = g + (size_t)(w * K + a) * m;
        float acc = 0.0f;
#pragma unroll 4
        for (int b = 0; b < m; ++b)
          acc = fmaf(gr[b], src[(size_t)(w * m + b) * d + j], acc);
        ring[(size_t)(p % ring_rows) * d + j] += acc;
      }
    }
    // d_out = g^T . ctx, added into the output rows in slot order
    for (int w = 0; w < nw; ++w) {
      for (int b = 0; b < m; ++b) {
        float acc = 0.0f;
#pragma unroll 4
        for (int a = 0; a < K; ++a)
          acc = fmaf(g[(size_t)(w * K + a) * m + b],
                     ctx[(size_t)(w * K + a) * d + j], acc);
        const int slot = w * m + b;
        const int row = dst_rows ? __ldg(dst_rows + slot) : slot;
        float* out = dst_rows ? dst : src;
        out[(size_t)row * d + j] += acc;
      }
    }
  }
}

}  // namespace fullw2v
