// FULL-W2V training kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (built by repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fullw2v.py:
//   seq_kernel<.., PIPELINE=false>  (K1, seq.cuh)
//                    <- _kernel            (:284, via fullw2v_pallas :903)
//   seq_kernel<.., PIPELINE=true>   (K2, seq.cuh)
//                    <- _kernel_pipelined  (:376, fullw2v_pallas with
//                                           pipeline=True)
//   fullw2v_tiled<PlainTable>       (K3)
//                    <- _kernel_tiled      (:537-855, hot_rows=0,
//                                           prefetch=False, via
//                                           fullw2v_pallas_tiled)
//   fullw2v_tiled<SplitTable>       (K4)
//                    <- _kernel_tiled      (:537-855, hot_rows>0,
//                                           prefetch=True, via
//                                           fullw2v_pallas_tiled_fused,
//                                           pallas_call at :1078)
//
// What bounds them on this card: the latency of one ordered chain. The
// reference orders every window of a batch after the previous one (its grid
// is sequential and batch_sgns_ref scans), so one CTA walks them all and a
// window's few KB of rows and ~15K FLOPs cost the sum of the latencies on
// its chain: row loads, the pair reductions, a sigmoid, barriers, the update
// and its stores. Neither the 3.35 TB/s of HBM nor the f32 FMA peak is near.
//
// What the design does about it: it keeps the order (a CTA per sentence,
// Hogwild across SMs, would break parity with the reference and is left to a
// later kernel) and shortens the chain.
// - K1 and K2 are one body, seq.cuh's seq_kernel, compiled for the shapes
//   the project runs (kSeqCompiled below) and once more with runtime shapes
//   for any other. Indices are staged per sentence in shared memory, so a
//   row costs one global round trip; a window's rows are issued together as
//   16-byte cp.async; the ring is indexed by a running head; each thread
//   keeps one column of the window's rows in registers for the update; seven
//   warps reduce all the window's pairs at once while an eighth, the
//   producer, computes the next window's hazard mask from the staged indices
//   by one ballot and (K2) issues its rows while window t computes. seq.cuh's
//   header gives the details and the order of every sum.
// - K3 keeps the ring of context rows in shared memory for the lifetime of
//   each row (loaded once, stored once), fetches a tile of T windows' output
//   rows once and updates them in groups of G windows; window.cuh holds its
//   update and the column-ownership rule that makes cross-thread fences
//   unnecessary.
//
// K4 is K3's body instantiated on the split working table of a
// vocab-sharded step (SplitTable: hot replica + gathered cold block, routed
// by id < hot), so the step never materializes concat(hot, got) and K4
// equals K3 on that concatenation bit for bit. The reference's cross-tile
// prefetch of the next tile's unique rows (prefetch=True, guarded by
// was_prefetched, fullw2v.py:617-636) is not built: K4 loads a tile's rows
// as K3 does.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seq.cuh"
#include "window.cuh"

namespace fullw2v {

// Output row j of window t: the target for j = 0, else negative j-1.
__device__ __forceinline__ int out_row(const int* tok, const int* ng, int t,
                                       int j, int n_neg) {
  return j == 0 ? __ldg(tok + t) : __ldg(ng + (size_t)t * n_neg + j - 1);
}

// K3's ring of one sentence: slot = position mod rows. Table is the input
// table's row accessor (window.cuh); the slot math never sees it.
template <typename Table>
struct Ring {
  float* rows;
  int n;                 // ring rows: T+2*w_f
  Table w_in;
  const int* tok;
  int d;

  __device__ __forceinline__ void load(int q) const {   // w_in -> slot
    load_row(rows + (size_t)(q % n) * d, w_in.row(__ldg(tok + q)), d);
  }
  __device__ __forceinline__ void store(int p) const {  // slot -> w_in
    store_row(w_in.row(__ldg(tok + p)), rows + (size_t)(p % n) * d, d);
  }
  // The sequential advance for window t (r_seq = 2*w_f+1): store the
  // r_seq-distance evictee (its windows are complete), then load the
  // leading edge.
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

// One strictly ordered window of a strict K3 tile: gather, fetch the m
// output rows, update, write them back (the reference's _seq_window,
// fullw2v.py:239-277).
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

// K1/K2 instantiations: the compiled (w_f, N) shapes at d = kSeqD, then the
// runtime-shaped body with indices staged and with indices read in place.
// repro_torch/kernels/fullw2v.py's SEQ_INSTANTIATIONS lists the same, in
// this order.
struct SeqShapeId {
  int w_f, n_neg;
};
constexpr SeqShapeId kSeqCompiled[] = {{2, 3}, {2, 5}, {3, 5}, {5, 5}};
constexpr int kSeqCompiledCount = 4;
constexpr int kSeqRuntime = kSeqCompiledCount;
constexpr int kSeqRuntimeUnstaged = kSeqCompiledCount + 1;

using SeqKernel = void (*)(float*, float*, const int*, const int*,
                           const int*, float, int, int, int, int, int);

template <bool PIPELINE>
SeqKernel seq_kernel_of(int variant) {
  switch (variant) {
    case 0: return seq_kernel<2, 3, PIPELINE, true>;
    case 1: return seq_kernel<2, 5, PIPELINE, true>;
    case 2: return seq_kernel<3, 5, PIPELINE, true>;
    case 3: return seq_kernel<5, 5, PIPELINE, true>;
    case kSeqRuntime: return seq_kernel<0, 0, PIPELINE, true>;
    default: return seq_kernel<0, 0, PIPELINE, false>;
  }
}

// Dynamic shared memory of K1/K2, in bytes: ring [2w_f+2][d], output rows
// [2][N+1][d], g [2w_f(N+1)] padded to 4, 4 words for the hazard mask, and
// when staged two index buffers of pad4(L + L*N + 1) ints.
size_t seq_smem(int d, int w_f, int n_neg, int L, bool staged) {
  const size_t K = 2 * (size_t)w_f, M = (size_t)n_neg + 1, R = K + 2;
  size_t words = R * d + 2 * M * d + ((K * M + 3) & ~(size_t)3) + 4;
  if (staged) words += 2 * (((size_t)L + (size_t)L * n_neg + 1 + 3) &
                            ~(size_t)3);
  return sizeof(float) * words;
}

// The instantiation a launch takes: a compiled shape when (w_f, N) is listed,
// d = kSeqD, both tables 16-byte aligned and the staged layout fits; else the
// runtime-shaped body, staged when that fits.
int seq_variant(const void* w_in, const void* w_out, int d, int w_f,
                int n_neg, int L, size_t limit) {
  const bool aligned = reinterpret_cast<uintptr_t>(w_in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  const bool fits = seq_smem(d, w_f, n_neg, L, true) <= limit;
  if (d == kSeqD && aligned && fits)
    for (int i = 0; i < kSeqCompiledCount; ++i)
      if (kSeqCompiled[i].w_f == w_f && kSeqCompiled[i].n_neg == n_neg)
        return i;
  return fits ? kSeqRuntime : kSeqRuntimeUnstaged;
}

cudaError_t smem_limit(size_t* limit) {
  int dev = 0, value = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&value,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = (size_t)value;
  return err;
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
  size_t limit = 0;
  cudaError_t err = fullw2v::smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int variant =
      fullw2v::seq_variant(w_in, w_out, d, w_f, n_neg, L, limit);
  const size_t smem = fullw2v::seq_smem(
      d, w_f, n_neg, L, variant != fullw2v::kSeqRuntimeUnstaged);
  fullw2v::SeqKernel kernel = pipeline ? fullw2v::seq_kernel_of<true>(variant)
                                       : fullw2v::seq_kernel_of<false>(variant);
  err = fullw2v::prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, fullw2v::kSeqThreads, smem, (cudaStream_t)stream>>>(
      (float*)w_in, (float*)w_out, (const int*)tokens, (const int*)negs,
      (const int*)lengths, lr, S, L, n_neg, d, w_f);
  return (int)cudaGetLastError();
}

// The K1/K2 instantiation fullw2v_seq_launch takes for these arguments (an
// index into the list above kSeqCompiled), or -1 when the device cannot be
// queried.
int fullw2v_seq_variant(const void* w_in, const void* w_out, int d, int w_f,
                        int n_neg, int L) {
  size_t limit = 0;
  if (fullw2v::smem_limit(&limit) != cudaSuccess) return -1;
  return fullw2v::seq_variant(w_in, w_out, d, w_f, n_neg, L, limit);
}

// K1/K2's dynamic shared memory in bytes (staged = 0: indices read in
// place).
long long fullw2v_seq_smem_bytes(int d, int w_f, int n_neg, int L,
                                 int staged) {
  return (long long)fullw2v::seq_smem(d, w_f, n_neg, L, staged != 0);
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
