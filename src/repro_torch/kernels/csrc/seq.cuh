// The strictly ordered FULL-W2V kernels K1 and K2 for Hopper (sm_90a), as
// one body: seq_kernel<WF, NNEG, PIPELINE, STAGED>.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fullw2v.py
//   PIPELINE = false (K1, backend cuda)           <- _kernel           (:284)
//   PIPELINE = true  (K2, backend cuda_pipelined) <- _kernel_pipelined (:376)
// both entered through fullw2v_pallas (:903). The two compute one function
// and produce the same bits; K2 also streams window t+1's rows in while
// window t computes.
//
// What bounds it on this card: the latency of one ordered chain. The
// reference updates a batch's windows strictly one after another, so one
// CTA walks them all, and a window (a few KB of rows, ~15K FLOPs) costs the
// sum of the latencies on its chain: row loads, the pair dot products and
// their warp reductions, a sigmoid, barriers, the update and its stores.
// Neither HBM bandwidth nor the f32 FMA rate is near.
//
// What the design does about it, part by part:
// - Compile-time shapes. (WF, NNEG) at d = 128 for the shapes the project
//   runs (kSeqCompiled in fullw2v.cu); pair -> (context slot, output slot,
//   label) comes from unrolled loops, every loop trip count is a constant,
//   and the per-window loops hold no integer division by a runtime value.
//   WF = NNEG = 0 is the runtime-shaped instantiation of the same body for
//   any other (w_f, N, d) or unaligned tables: rows stay in shared memory
//   and the update reads them there instead of from registers.
// - Ring slots are a running head index (slot of position t - w_f), never a
//   modulus. The ring has 2*w_f + 2 slots: one more than a window spans, so
//   K2's prefetch of the leading row t+1+w_f lands in its own slot.
// - Indices staged per sentence (STAGED). Sentence s's tokens, negatives and
//   length go into shared memory with cp.async, double-buffered; sentence
//   s+1's are issued when sentence s starts. Every row address is then one
//   shared load away and each row costs one global round trip. When two
//   sentences' indices do not fit (L*(N+1) beyond ~26K ints), the runtime
//   instantiation reads them in place (STAGED = false).
// - Rows in flight together, 16 bytes a thread: a window's leading ring row
//   and its N+1 output rows are all issued before any is consumed, one
//   16-byte cp.async a lane covering a d=128 row (the runtime instantiation
//   copies 4 bytes a thread). K1 issues window t+1's rows when window t ends
//   and waits on them at once; K2 issues them when window t starts.
// - Eight warps, two per scheduler, one of them a producer. Warps 0-6
//   reduce the window's pairs while warp 7 computes window t+1's hazard mask
//   and (K2) issues its copies, so neither sits in front of the pair phase.
// - K2's hazard check reads no global memory. The producer warp computes one
//   bitmask per window from the staged indices with one ballot: lane b < N+1
//   compares window t+1's output row b with window t's N+1 rows (the
//   reference's conflicts_prev, fullw2v.py:414-421), lane N+1 compares the
//   leading ring row's token with the token 2*w_f+1 back, which window t
//   stores when it ends. Flagged rows are not prefetched; they are loaded
//   after window t's stores and a barrier. K1 uses the same mask to skip
//   that barrier when no row of window t+1 needs it.
// - The paper's register caching: each thread keeps one column of the
//   window's K context rows (read in place from the ring through the slot
//   table, 0 where the position lies outside the sentence) and of its N+1
//   output rows in registers, so no context copy is made. Threads 0-127
//   compute d_out and write the output rows back to the table straight from
//   registers; threads 128-255 compute d_ctx into the ring and store
//   position t - w_f, final after window t (the reference's ring store, one
//   window earlier in program order and with the same loads seeing it). Both
//   read the pre-update values, loaded before the barrier that completes g,
//   which also orders the ring's reads before d_ctx writes it.
// - All pairs in flight: a pair warp takes ceil(K(N+1)/7) pairs,
//   accumulates them together and folds them with one transposed xor
//   reduction (NV partials, NV-1 + 5 - log2(NV) shuffles instead of 5 per
//   pair), which leaves each lane one pair's sum; the lanes then run their
//   sigmoids side by side, without the branch of core/sgns.py's
//   stable_sigmoid (same bits).
//
// The bits do not move: every sum keeps one order, the one the tiled
// kernels K3/K4 (tiled.cuh) also keep, so K2 == K1 == K3(T=1):
// - a pair's dot product: lane l adds fmaf over columns l, l+32, ... from
//   0.0f in increasing order, then the lanes fold in the xor order 16, 8, 4,
//   2, 1 (the transposed reduction adds the same two partials at every node
//   of the same tree as the butterfly);
// - g = lr * (label - stable_sigmoid(c)), 0 where the context position is
//   outside the sentence;
// - d_ctx[a]: fmaf over b = 0..N in order from 0.0f, then ring += acc, only
//   for positions inside the sentence;
// - d_out[b]: fmaf over a = 0..K-1 in order from 0.0f, masked terms
//   included, then out += acc, written back in slot order;
// - the ring stores every position once, in increasing order, each before
//   the load of the position 2*w_f+1 later (store-before-load), and flushes
//   the rest when the sentence ends, before the next one's preload.
#pragma once

#include <cuda_runtime.h>

#include "window.cuh"

namespace fullw2v {

constexpr int kSeqThreads = 256;  // 8 warps: two per scheduler
constexpr int kSeqWarps = kSeqThreads / 32;
constexpr int kProducer = kSeqWarps - 1;   // hazards and row copies
constexpr int kPairWarps = kSeqWarps - 1;  // the window's pairs
constexpr int kSeqD = 128;        // compiled row width; columns per half

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
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

// ---------------------------------------------------------------------------
// shapes, slots, indices
// ---------------------------------------------------------------------------

constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int WF, int NNEG>
struct SeqShape {
  static constexpr int K = 2 * WF;                 // context slots
  static constexpr int M = NNEG + 1;               // output rows
  static constexpr int R = 2 * WF + 2;             // ring slots
  static constexpr int P = K * M;                  // pairs
  static constexpr int PW = (P + kPairWarps - 1) / kPairWarps;  // per warp
  static constexpr int NV = pow2_ceil(PW);         // partials reduced at once
  static constexpr int GPAD = (P + 3) / 4 * 4;     // g, padded to float4
  static_assert(PW * kPairWarps >= P && kProducer * PW >= P,
                "the producer warp holds no pair");
  static_assert(NV <= 32, "at most 32 pairs per warp");
  static_assert(M + 1 <= 32, "the hazard ballot covers N+2 rows");
};

__device__ __forceinline__ int wrap(int x, int R) { return x >= R ? x - R : x; }

// Ring offset of context slot a from position t - w_f (slot a skips t).
__device__ __forceinline__ int ctx_pos(int a, int wf) {
  return a < wf ? a : a + 1;
}

// One sentence's indices, staged in shared memory or read in place.
struct SentenceIdx {
  const int* tok;   // [L]
  const int* ng;    // [L][nn]
  int len;
  int nn;
  // output row b of window t: the target for b = 0, else negative b-1
  __device__ __forceinline__ int out_id(int t, int b) const {
    return b == 0 ? tok[t] : ng[t * nn + b - 1];
  }
};

// ---------------------------------------------------------------------------
// the pair reduction: NV partials per lane, one xor tree each
// ---------------------------------------------------------------------------

// Folds v[0..NV) over the warp's lanes. At offset o (16, 8, ...) a lane
// keeps half of its partials (the upper half where lane & o) and adds the
// partner's copy of them; once one is left, the plain butterfly finishes.
// Every partial meets its partners in the order 16, 8, 4, 2, 1, as in
// __shfl_xor_sync butterflies, and each node adds own + partner, so the
// sums carry the butterfly's bits. Lane l ends with pair lane_pair<NV>(l).
template <int NV>
__device__ __forceinline__ float reduce_pairs(float (&v)[NV], int lane) {
  static_assert(NV >= 1 && NV <= 32 && (NV & (NV - 1)) == 0,
                "NV is a power of two up to 32");
#pragma unroll
  for (int o = 16, n = NV; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        if (i < n / 2) {
          const float send = up ? v[i] : v[i + n / 2];
          const float keep = up ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n >>= 1;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

template <int NV>
__device__ __forceinline__ int lane_pair(int lane) {
  int idx = 0;
#pragma unroll
  for (int o = 16, n = NV; n > 1; o >>= 1, n >>= 1)
    if (lane & o) idx += n >> 1;
  return idx;
}

// The lanes that share a pair differ only in their low bits; one writes.
template <int NV>
__device__ __forceinline__ bool lane_leads(int lane) {
  return (lane & (32 / NV - 1)) == 0;
}

// ---------------------------------------------------------------------------
// pair phase: g[a*M + b] for the window's K x M pairs
// ---------------------------------------------------------------------------

// Compile-time shape, warp W: the partials of pairs [W*PW, W*PW + PW) in
// row-major order (0 past the last pair).
template <int WF, int NNEG, int W>
__device__ __forceinline__ void pair_partials(
    float (&v)[SeqShape<WF, NNEG>::NV], const float* ring, int head,
    const float* ob, int amin, int amax, int lane) {
  using Sh = SeqShape<WF, NNEG>;
  constexpr int D = kSeqD, M = Sh::M, NV = Sh::NV;
  constexpr int p0 = W * Sh::PW;
  constexpr int p1 = p0 + Sh::PW < Sh::P ? p0 + Sh::PW : Sh::P;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.0f;
  if constexpr (p0 < Sh::P) {
    constexpr int a0 = p0 / M, a1 = (p1 - 1) / M;
    float y[M][4];
#pragma unroll
    for (int b = 0; b < M; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[b][c] = ob[b * D + lane + 32 * c];
#pragma unroll
    for (int a = a0; a <= a1; ++a) {
      const bool ok = a >= amin && a < amax;
      const float* row = ring + wrap(head + ctx_pos(a, WF), Sh::R) * D;
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = ok ? row[lane + 32 * c] : 0.0f;
#pragma unroll
      for (int b = 0; b < M; ++b) {
        const int i = a * M + b - p0;
        if (i >= 0 && i < p1 - p0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[i] = fmaf(x[c], y[b][c], v[i]);
        }
      }
    }
  }
}

// pair_partials for the calling warp (a uniform branch per warp).
template <int WF, int NNEG, int W = 0>
__device__ __forceinline__ void warp_partials(
    int warp, float (&v)[SeqShape<WF, NNEG>::NV], const float* ring,
    int head, const float* ob, int amin, int amax, int lane) {
  if constexpr (W + 1 < kPairWarps) {
    if (warp != W) {
      warp_partials<WF, NNEG, W + 1>(warp, v, ring, head, ob, amin, amax,
                                     lane);
      return;
    }
  }
  pair_partials<WF, NNEG, W>(v, ring, head, ob, amin, amax, lane);
}

// core/sgns.py's stable_sigmoid, bit for bit, without its branch (1/(1+e^-x)
// for x >= 0, e^x/(1+e^x) else): both branches
// take expf of -|x|, and 1/(1+e) is the correctly rounded quotient either
// way.
__device__ __forceinline__ float sigmoid_nb(float x) {
  const float e = expf(-fabsf(x));
  return (x >= 0.0f ? 1.0f : e) / (1.0f + e);
}

// Runtime shape: rounds of 16 pairs per warp, rows read from shared memory.
__device__ __forceinline__ void pairs_runtime(const float* ring, int head,
                                              const float* ob, float* g,
                                              int amin, int amax, float lr,
                                              int lane, int warp, int wf,
                                              int M, int R, int d) {
  constexpr int NV = 16;
  const int P = 2 * wf * M;
  for (int pr0 = warp * NV; pr0 < P; pr0 += kSeqWarps * NV) {
    float v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = 0.0f;
      const int pr = pr0 + i;
      if (pr < P) {
        const int a = pr / M, b = pr - a * M;
        const bool ok = a >= amin && a < amax;
        const float* x = ring + (size_t)wrap(head + ctx_pos(a, wf), R) * d;
        const float* y = ob + (size_t)b * d;
        for (int j = lane; j < d; j += 32)
          v[i] = fmaf(ok ? x[j] : 0.0f, y[j], v[i]);
      }
    }
    const float c = reduce_pairs<NV>(v, lane);
    const int pr = pr0 + lane_pair<NV>(lane);
    if (lane_leads<NV>(lane) && pr < P) {
      const int a = pr / M;
      const float label = pr - a * M == 0 ? 1.0f : 0.0f;
      g[pr] = a >= amin && a < amax ? lr * (label - sigmoid_nb(c)) : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// update phase: d_out into the table, d_ctx into the ring
// ---------------------------------------------------------------------------

// Compile-time shape, thread tid: column j = tid mod 128 of the window's K
// context rows (0 outside the sentence) and M output rows, and the rows'
// table ids (ids[b]; ids[M]: position t - w_f's token), read into registers
// before the barrier that completes g, so that barrier also orders every
// read of the ring before d_ctx writes it.
template <int WF, int NNEG>
__device__ __forceinline__ void update_regs(
    float (&x)[SeqShape<WF, NNEG>::K], float (&y)[SeqShape<WF, NNEG>::M],
    int (&ids)[SeqShape<WF, NNEG>::M + 1], const float* ring, int head,
    const float* ob, int amin, int amax, const SentenceIdx& I, int t,
    int tid) {
  using Sh = SeqShape<WF, NNEG>;
  constexpr int D = kSeqD;
  const int j = tid & (D - 1);
#pragma unroll
  for (int b = 0; b < Sh::M; ++b) ids[b] = I.out_id(t, b);
  ids[Sh::M] = t >= WF ? I.tok[t - WF] : 0;
#pragma unroll
  for (int a = 0; a < Sh::K; ++a) {
    const float xa = ring[wrap(head + ctx_pos(a, WF), Sh::R) * D + j];
    x[a] = a >= amin && a < amax ? xa : 0.0f;
  }
#pragma unroll
  for (int b = 0; b < Sh::M; ++b) y[b] = ob[b * D + j];
}

// The update from those registers and g. Threads [0, 128): d_out = g^T .
// ctx, out + d_out written back in slot order. Threads [128, 256): d_ctx =
// g . out into the ring, and position t - w_f (slot a = 0), final after
// this window, into w_in.
template <int WF, int NNEG>
__device__ __forceinline__ void update_static(
    const float (&x)[SeqShape<WF, NNEG>::K],
    const float (&y)[SeqShape<WF, NNEG>::M],
    const int (&ids)[SeqShape<WF, NNEG>::M + 1], float* ring, int head,
    const float* g, int amin, int amax, float* w_in, float* w_out,
    int tid) {
  using Sh = SeqShape<WF, NNEG>;
  constexpr int D = kSeqD, K = Sh::K, M = Sh::M, R = Sh::R;
  const int j = tid & (D - 1);
  float gv[Sh::GPAD];
#pragma unroll
  for (int q = 0; q < Sh::GPAD / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(g)[q];
    gv[4 * q] = f.x;
    gv[4 * q + 1] = f.y;
    gv[4 * q + 2] = f.z;
    gv[4 * q + 3] = f.w;
  }
  if (tid < D) {
#pragma unroll
    for (int b = 0; b < M; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < K; ++a) acc = fmaf(gv[a * M + b], x[a], acc);
      w_out[(size_t)ids[b] * D + j] = y[b] + acc;
    }
  } else {
#pragma unroll
    for (int a = 0; a < K; ++a) {
      if (a < amin || a >= amax) continue;     // zero gradient
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < M; ++b) acc = fmaf(gv[a * M + b], y[b], acc);
      const float nv = x[a] + acc;
      ring[wrap(head + ctx_pos(a, WF), R) * D + j] = nv;
      if (a == 0) w_in[(size_t)ids[M] * D + j] = nv;
    }
  }
}

// Runtime shape: the same sums over rows kept in shared memory, by threads
// [0, 128) alone (d_out reads the ring before d_ctx updates it).
__device__ __forceinline__ void update_runtime(float* ring, int head,
                                               const float* ob,
                                               const float* g, int amin,
                                               int amax, const SentenceIdx& I,
                                               int t, float* w_in,
                                               float* w_out, int tid, int wf,
                                               int M, int R, int d) {
  const int K = 2 * wf;
  for (int j = tid; j < d; j += kSeqD) {
    // d_out first: it reads the ring before d_ctx updates it
    for (int b = 0; b < M; ++b) {
      float acc = 0.0f;
      for (int a = 0; a < K; ++a) {
        const float xa = ring[(size_t)wrap(head + ctx_pos(a, wf), R) * d + j];
        acc = fmaf(g[a * M + b], a >= amin && a < amax ? xa : 0.0f, acc);
      }
      w_out[(size_t)I.out_id(t, b) * d + j] = ob[(size_t)b * d + j] + acc;
    }
    for (int a = 0; a < K; ++a) {
      if (a < amin || a >= amax) continue;
      float acc = 0.0f;
      for (int b = 0; b < M; ++b)
        acc = fmaf(g[a * M + b], ob[(size_t)b * d + j], acc);
      float* xa = ring + (size_t)wrap(head + ctx_pos(a, wf), R) * d + j;
      const float nv = *xa + acc;
      *xa = nv;
      if (a == 0) w_in[(size_t)I.tok[t - wf] * d + j] = nv;
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// One CTA walks the batch's S sentences and their windows in order.
// Shared memory: ring [2w_f+2][d], output rows [2][N+1][d] (window t in
// buffer t & 1), g [K(N+1), padded to 4], 4 words for the hazard mask, and
// when STAGED two index buffers of pad4(L + L*N + 1) ints (tokens,
// negatives, length). Warps 0-6 reduce the window's pairs; warp 7, the
// producer, computes the next window's hazards and issues its row copies
// meanwhile (compile-time shapes).
template <int WF, int NNEG, bool PIPELINE, bool STAGED>
__global__ void __launch_bounds__(kSeqThreads)
seq_kernel(float* __restrict__ w_in, float* __restrict__ w_out,
           const int* __restrict__ tokens, const int* __restrict__ negs,
           const int* __restrict__ lengths, float lr, int S, int L,
           int n_neg_rt, int d_rt, int w_f_rt) {
  constexpr bool kStatic = WF > 0;
  const int wf = kStatic ? WF : w_f_rt;
  const int nn = kStatic ? NNEG : n_neg_rt;
  const int d = kStatic ? kSeqD : d_rt;
  const int M = nn + 1, R = 2 * wf + 2, r = 2 * wf + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float seq_shared[];
  float* ring = seq_shared;                            // [R][d]
  float* outb = ring + (size_t)R * d;                  // [2][M][d]
  float* g = outb + (size_t)2 * M * d;                 // [K*M] (+pad)
  unsigned* flags = reinterpret_cast<unsigned*>(g + ((2 * wf * M + 3) & ~3));
  int* stage = reinterpret_cast<int*>(flags + 4);
  const int SI = (L + L * nn + 1 + 3) & ~3;            // ints per buffer

  // the lane's pair after the reduction (compile-time shapes)
  int my_pr = 0, my_a = 0;
  float my_label = 0.0f;
  bool my_writer = false;
  if constexpr (kStatic) {
    using Sh = SeqShape<WF, NNEG>;
    const int i = lane_pair<Sh::NV>(lane);
    my_pr = warp * Sh::PW + i;
    my_a = my_pr / Sh::M;
    my_label = my_pr - my_a * Sh::M == 0 ? 1.0f : 0.0f;
    my_writer = lane_leads<Sh::NV>(lane) && i < Sh::PW && my_pr < Sh::P;
  }

  auto sentence = [&](int s, int buf) {
    SentenceIdx I;
    I.nn = nn;
    if constexpr (STAGED) {
      const int* b = stage + buf * SI;
      I.tok = b;
      I.ng = b + L;
      I.len = b[L + L * nn];
    } else {
      I.tok = tokens + (size_t)s * L;
      I.ng = negs + (size_t)s * L * nn;
      I.len = __ldg(lengths + s);
    }
    return I;
  };
  auto stage_sentence = [&](int s, int buf) {
    int* dst = stage + buf * SI;
    const int* tok = tokens + (size_t)s * L;
    const int* ng = negs + (size_t)s * L * nn;
    for (int i = tid; i < L; i += kSeqThreads) cp_async4(dst + i, tok + i);
    for (int i = tid; i < L * nn; i += kSeqThreads)
      cp_async4(dst + L + i, ng + i);
    if (tid == 0) cp_async4(dst + L + L * nn, lengths + s);
  };

  // Async copies of rows k = 0..n-1 (row(k, dst, src) says where, or false
  // to skip): one warp a row, 16 bytes a lane (all rows by the producer warp
  // when `producer`); 4 bytes a thread at runtime shapes.
  auto issue_rows = [&](int n, auto row, bool producer) {
    if constexpr (kStatic) {
      const int k0 = !producer ? warp : warp == kProducer ? 0 : n;
      for (int k = k0; k < n; k += producer ? 1 : kSeqWarps) {
        float* dst;
        const float* src;
        if (row(k, dst, src)) cp_async16(dst + 4 * lane, src + 4 * lane);
      }
    } else {
      for (int k = 0; k < n; ++k) {
        float* dst;
        const float* src;
        if (row(k, dst, src))
          for (int j = tid; j < d; j += kSeqThreads)
            cp_async4(dst + j, src + j);
      }
    }
  };
  // Row k of window tn: k < M its output row k (buffer tn & 1); k == M its
  // leading context row, position tn + w_f, into its ring slot (none past
  // the sentence's end). head_tn: the slot of position tn - w_f.
  auto window_row = [&](const SentenceIdx& I, int tn, int head_tn, int k,
                        float*& dst, const float*& src) {
    if (k < M) {
      dst = outb + (size_t)((tn & 1) * M + k) * d;
      src = w_out + (size_t)I.out_id(tn, k) * d;
      return true;
    }
    const int q = tn + wf;
    if (q >= I.len) return false;
    dst = ring + (size_t)wrap(head_tn + 2 * wf, R) * d;
    src = w_in + (size_t)I.tok[q] * d;
    return true;
  };
  // Must row k of window tn (>= 1) wait for window tn-1's stores? Output
  // rows: equal to any output row of tn-1. Leading ring row: its token is
  // the one 2w_f+1 back, which window tn-1 stores when it ends.
  auto hazard = [&](const SentenceIdx& I, int tn, int k) {
    if (k < M) {
      const int id = I.out_id(tn, k);
      bool h = false;
      for (int b = 0; b < M; ++b) h |= id == I.out_id(tn - 1, b);
      return h;
    }
    const int q = tn + wf;
    return q < I.len && q >= r && I.tok[q] == I.tok[q - r];
  };

  int buf = 0;
  if constexpr (STAGED) {
    if (S > 0) stage_sentence(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < S; ++s) {
    const SentenceIdx I = sentence(s, buf);
    if constexpr (STAGED)
      if (s + 1 < S) stage_sentence(s + 1, buf ^ 1);
    const int len = I.len;
    int head = 0;                   // slot of position t - w_f; p -> p + w_f
    if (len > 0) {
      // preload positions 0 .. min(w_f, len)-1, then window 0's rows
      issue_rows(min(wf, len), [&](int p, float*& dst, const float*& src) {
        dst = ring + (size_t)(wf + p) * d;
        src = w_in + (size_t)I.tok[p] * d;
        return true;
      }, false);
      issue_rows(M + 1, [&](int k, float*& dst, const float*& src) {
        return window_row(I, 0, 0, k, dst, src);
      }, false);
    }
    cp_async_commit();

    for (int t = 0; t < len; ++t) {
      cp_async_wait_all();
      __syncthreads();              // window t's rows are in shared memory
      const bool more = t + 1 < len;
      const int head1 = wrap(head + 1, R);
      // hazards of window t+1 against window t: bit k for row k (at runtime
      // shapes, any; flagged() then tests each row)
      unsigned hz = 0;
      auto flagged = [&](int k) {
        if constexpr (kStatic) return ((hz >> k) & 1u) != 0;
        else return hazard(I, t + 1, k);
      };
      auto prefetch = [&] {         // K2: window t+1 streams in during t
        issue_rows(M + 1, [&](int k, float*& dst, const float*& src) {
          return !flagged(k) && window_row(I, t + 1, head1, k, dst, src);
        }, true);
        cp_async_commit();
      };

      const int amin = wf - t, amax = wf + len - 1 - t;   // valid slots
      const float* ob = outb + (size_t)(t & 1) * M * d;
      // this thread's column of the rows the update reads (compile-time
      // shapes; dummy sizes at runtime shapes, where they go unused)
      float x[SeqShape<kStatic ? WF : 1, kStatic ? NNEG : 1>::K];
      float y[SeqShape<kStatic ? WF : 1, kStatic ? NNEG : 1>::M];
      int ids[SeqShape<kStatic ? WF : 1, kStatic ? NNEG : 1>::M + 1];
      if constexpr (kStatic) {
        // The update's registers: the producer warp loads them after its
        // work; the pair warps before the pair phase in K1 (their latency
        // overlaps it) and after it in K2 (each measured the faster on the
        // card, PERF.md).
        if (warp == kProducer) {
          if (more)
            hz = __ballot_sync(0xffffffffu,
                               lane <= M && hazard(I, t + 1, lane));
          if (lane == 0) *flags = hz;
          if (PIPELINE && more) prefetch();
          update_regs<WF, NNEG>(x, y, ids, ring, head, ob, amin, amax, I, t,
                                tid);
        } else {
          if constexpr (!PIPELINE)
            update_regs<WF, NNEG>(x, y, ids, ring, head, ob, amin, amax, I,
                                  t, tid);
          using Sh = SeqShape<WF, NNEG>;
          float v[Sh::NV];
          warp_partials<WF, NNEG>(warp, v, ring, head, ob, amin, amax, lane);
          const float c = reduce_pairs<Sh::NV>(v, lane);
          if (my_writer)
            g[my_pr] = my_a >= amin && my_a < amax
                           ? lr * (my_label - sigmoid_nb(c))
                           : 0.0f;
          if constexpr (PIPELINE)
            update_regs<WF, NNEG>(x, y, ids, ring, head, ob, amin, amax, I,
                                  t, tid);
        }
      } else {
        if (more)
          for (int k = 0; k <= M; ++k) hz |= hazard(I, t + 1, k) ? 1u : 0u;
        if (PIPELINE && more) prefetch();
        pairs_runtime(ring, head, ob, g, amin, amax, lr, lane, warp, wf, M, R,
                      d);
      }
      __syncthreads();              // g complete; the ring's reads done
      if constexpr (kStatic) {
        hz = *flags;
        update_static<WF, NNEG>(x, y, ids, ring, head, g, amin, amax, w_in,
                                w_out, tid);
      } else if (tid < kSeqD) {
        update_runtime(ring, head, ob, g, amin, amax, I, t, w_in, w_out, tid,
                       wf, M, R, d);
      }

      if (more) {
        if constexpr (PIPELINE) {   // flagged rows, after window t's stores
          if (hz != 0) {
            __syncthreads();
            issue_rows(M + 1, [&](int k, float*& dst, const float*& src) {
              return flagged(k) && window_row(I, t + 1, head1, k, dst, src);
            }, true);
            cp_async_commit();
          }
        } else {                    // K1: window t+1's rows, now
          if (hz != 0) __syncthreads();
          issue_rows(M + 1, [&](int k, float*& dst, const float*& src) {
            return window_row(I, t + 1, head1, k, dst, src);
          }, false);
          cp_async_commit();
        }
      }
      head = head1;
    }

    // flush positions len-w_f .. len-1 in increasing order (the earlier ones
    // were stored as they left the window) by the threads that update the
    // ring; head is position len - w_f's slot
    const bool ring_owner = kStatic ? tid >= kSeqD : tid < kSeqD;
    for (int j = tid & (kSeqD - 1); ring_owner && j < d; j += kSeqD)
      for (int i = 0; i < wf; ++i) {
        const int p = len - wf + i;
        if (p >= 0)
          w_in[(size_t)I.tok[p] * d + j] =
              ring[(size_t)wrap(head + i, R) * d + j];
      }
    cp_async_wait_all();            // the next sentence's indices
    __syncthreads();                // this sentence's stores before its loads
    buf ^= 1;
  }
}

}  // namespace fullw2v
