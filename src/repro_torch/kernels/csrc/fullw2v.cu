// FULL-W2V training kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (built by repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fullw2v.py:
//   seq_kernel<.., PIPELINE=false>      (K1, seq.cuh)
//                    <- _kernel            (:284, via fullw2v_pallas :903)
//   seq_kernel<.., PIPELINE=true>       (K2, seq.cuh)
//                    <- _kernel_pipelined  (:376, fullw2v_pallas with
//                                           pipeline=True)
//   tiled_kernel<.., PlainTable>        (K3, tiled.cuh)
//                    <- _kernel_tiled      (:537, hot_rows=0, via
//                                           fullw2v_pallas_tiled, pallas_call
//                                           at :981)
//   tiled_kernel<.., SplitTable>        (K4, tiled.cuh)
//                    <- _kernel_tiled      (:537, hot_rows>0, prefetch=True,
//                                           via fullw2v_pallas_tiled_fused,
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
// Hogwild across SMs, would break parity with the reference) and shortens
// the chain. Both bodies are compiled for the shapes the project runs
// (kSeqCompiled, kTiledCompiled below) and once more with runtime shapes for
// any other; indices (and K3/K4's tile plan) are staged per sentence in
// shared memory, rows are issued together as 16-byte cp.async, the ring is
// indexed by a running head, each thread keeps one column of the rows it
// updates in registers, seven warps reduce all pairs of a window (K1/K2) or
// of a group of G windows (K3/K4) at once, and an eighth, the producer,
// finds the next step's hazards by ballots and issues its rows while this
// one computes. seq.cuh's and tiled.cuh's headers give the details and the
// order of every sum.
//
// K4 is K3's body instantiated on the split working table of a
// vocab-sharded step (SplitTable: hot replica + gathered cold block, routed
// by id < hot), so the step never materializes concat(hot, got) and K4
// equals K3 on that concatenation bit for bit. Both run the reference's
// cross-tile prefetch of the next tile's unique rows (was_prefetched,
// fullw2v.py:617-636) when the double-buffered layout fits.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "seq.cuh"
#include "tiled.cuh"
#include "window.cuh"

namespace fullw2v {

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

// K3/K4 instantiations: the compiled (w_f, N, T, G) shapes at d = kSeqD,
// then the runtime-shaped body with indices staged and with indices read in
// place. repro_torch/kernels/fullw2v.py's TILED_INSTANTIATIONS lists the
// same, in this order.
struct TiledShapeId {
  int w_f, n_neg, tile, G;
};
constexpr TiledShapeId kTiledCompiled[] = {
    {3, 5, 8, 4}, {2, 3, 1, 1}, {2, 5, 1, 1}, {3, 5, 1, 1}, {5, 5, 1, 1}};
constexpr int kTiledCompiledCount = 5;
constexpr int kTiledRuntime = kTiledCompiledCount;
constexpr int kTiledRuntimeUnstaged = kTiledCompiledCount + 1;

template <typename Table>
using TiledKernel = void (*)(Table, Table, const int*, const int*,
                             const int*, const int*, const int*, const int*,
                             const int*, float, int, int, int, int, int, int,
                             int, int, unsigned long long*);

template <typename Table>
TiledKernel<Table> tiled_kernel_of(int variant) {
  switch (variant) {
    case 0: return tiled_kernel<3, 5, 8, 4, true, Table>;
    case 1: return tiled_kernel<2, 3, 1, 1, true, Table>;
    case 2: return tiled_kernel<2, 5, 1, 1, true, Table>;
    case 3: return tiled_kernel<3, 5, 1, 1, true, Table>;
    case 4: return tiled_kernel<5, 5, 1, 1, true, Table>;
    case kTiledRuntime: return tiled_kernel<0, 0, 1, 1, true, Table>;
    default: return tiled_kernel<0, 0, 1, 1, false, Table>;
  }
}

// Dynamic shared memory of K3/K4 in bytes (tiled.cuh's tiled_layout): ring
// [2G+2w_f][d], out_uniq [1 or 2][T(N+1)][d] (2 when prefetching), a strict
// window's rows [2][N+1][d], the runtime body's column copy [G+2w_f][d], g
// [pad4(G*2w_f*(N+1))], 8 flag words, the prefetch flags [pad4(T(N+1))],
// the list of rows issued ahead [pad4(2(T(N+1)+G+N+1))] and, when staged,
// two buffers of one sentence's indices and tile plan.
size_t tiled_smem(int d, int w_f, int n_neg, int L, int tile, int G, bool pf,
                  bool staged) {
  return sizeof(float) *
         tiled_layout(d, w_f, n_neg, tile, G, L, pf, staged).words;
}

// The instantiation and prefetch a launch takes, as 2 * variant + prefetch:
// a compiled shape when (w_f, N, T, G) is listed, d = kSeqD, the tables are
// 16-byte aligned and the staged layout fits (prefetching when allow_pf);
// else the runtime-shaped body, staged when that fits, prefetching when the
// double-buffered out_uniq fits too.
int tiled_choice(bool aligned, int d, int w_f, int n_neg, int L, int tile,
                 int G, bool allow_pf, size_t limit) {
  auto fits = [&](bool pf, bool staged) {
    return tiled_smem(d, w_f, n_neg, L, tile, G, pf, staged) <= limit;
  };
  if (d == kSeqD && aligned && fits(allow_pf, true))
    for (int i = 0; i < kTiledCompiledCount; ++i)
      if (kTiledCompiled[i].w_f == w_f && kTiledCompiled[i].n_neg == n_neg &&
          kTiledCompiled[i].tile == tile && kTiledCompiled[i].G == G)
        return 2 * i + (allow_pf ? 1 : 0);
  for (int variant : {kTiledRuntime, kTiledRuntimeUnstaged})
    for (bool pf : {allow_pf, false})
      if (fits(pf, variant == kTiledRuntime)) return 2 * variant + (pf ? 1 : 0);
  return 2 * kTiledRuntimeUnstaged;   // fits nowhere: prepare() refuses it
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename Table>
int tiled_launch(Table w_in, Table w_out, bool aligned, const void* tokens,
                 const void* negs, const void* lengths, const void* uniq,
                 const void* scatter, const void* ucount, const void* strict,
                 float lr, int S, int L, int n_neg, int d, int w_f, int tile,
                 int G, int prefetch, void* counters, void* stream) {
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int choice = tiled_choice(aligned, d, w_f, n_neg, L, tile, G,
                                  prefetch != 0, limit);
  const int variant = choice >> 1, pf = choice & 1;
  const size_t smem = tiled_smem(d, w_f, n_neg, L, tile, G, pf != 0,
                                 variant != kTiledRuntimeUnstaged);
  TiledKernel<Table> kernel = tiled_kernel_of<Table>(variant);
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kSeqThreads, smem, (cudaStream_t)stream>>>(
      w_in, w_out, (const int*)tokens, (const int*)negs, (const int*)lengths,
      (const int*)uniq, (const int*)scatter, (const int*)ucount,
      (const int*)strict, lr, S, L, n_neg, d, w_f, tile, G, pf,
      (unsigned long long*)counters);
  return (int)cudaGetLastError();
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

// K3 over one batch with its tile plan, in place. prefetch = 0 turns the
// cross-tile prefetch off (the results do not change); counters, when not
// null, is a device array of two uint64 to which the launch adds its
// prefetched and rejected columns.
int fullw2v_tiled_launch(void* w_in, void* w_out, const void* tokens,
                         const void* negs, const void* lengths,
                         const void* uniq, const void* scatter,
                         const void* ucount, const void* strict, float lr,
                         int S, int L, int n_neg, int d, int w_f, int tile,
                         int G, int prefetch, void* counters, void* stream) {
  using fullw2v::PlainTable;
  return fullw2v::tiled_launch(
      PlainTable{(float*)w_in, d}, PlainTable{(float*)w_out, d},
      fullw2v::aligned16({w_in, w_out}), tokens, negs, lengths, uniq,
      scatter, ucount, strict, lr, S, L, n_neg, d, w_f, tile, G, prefetch,
      counters, stream);
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
                               int w_f, int tile, int G, int prefetch,
                               void* counters, void* stream) {
  using fullw2v::SplitTable;
  return fullw2v::tiled_launch(
      SplitTable{(float*)hot_in, (float*)got_in, n_hot, d},
      SplitTable{(float*)hot_out, (float*)got_out, n_hot, d},
      fullw2v::aligned16({hot_in, hot_out, got_in, got_out}), tokens, negs,
      lengths, uniq, scatter, ucount, strict, lr, S, L, n_neg, d, w_f, tile,
      G, prefetch, counters, stream);
}

// The K3/K4 choice fullw2v_tiled_launch makes for tables at these addresses
// (null: aligned), as 2 * instantiation + prefetch (the instantiation an
// index into the list above kTiledCompiled), or -1 when the device cannot
// be queried.
int fullw2v_tiled_choice(const void* a, const void* b, const void* c,
                         const void* e, int d, int w_f, int n_neg, int L,
                         int tile, int G, int prefetch) {
  size_t limit = 0;
  if (fullw2v::smem_limit(&limit) != cudaSuccess) return -1;
  return fullw2v::tiled_choice(fullw2v::aligned16({a, b, c, e}), d, w_f,
                               n_neg, L, tile, G, prefetch != 0, limit);
}

// K3/K4's dynamic shared memory in bytes.
long long fullw2v_tiled_smem_bytes(int d, int w_f, int n_neg, int L,
                                   int tile, int G, int prefetch,
                                   int staged) {
  return (long long)fullw2v::tiled_smem(d, w_f, n_neg, L, tile, G,
                                        prefetch != 0, staged != 0);
}

const char* fullw2v_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
