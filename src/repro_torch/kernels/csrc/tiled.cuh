// The window-tiled FULL-W2V kernels K3 and K4 for Hopper (sm_90a), as one
// body: tiled_kernel<WF, NNEG, T, G, STAGED, Table>.
//
// Replaces the Pallas TPU kernel _kernel_tiled of
// src/repro/kernels/fullw2v.py (:537), entered through
//   fullw2v_pallas_tiled        (pallas_call :981, hot_rows=0)    -> K3,
//                               Table = PlainTable (backend cuda_tiled)
//   fullw2v_pallas_tiled_fused  (pallas_call :1078, hot_rows>0,
//                               prefetch=True)                    -> K4,
//                               Table = SplitTable (its update_fused)
// K4 routes each row id to the hot replica or the gathered cold block and
// changes nothing else, so it equals K3 on concat(hot, got) bit for bit.
//
// What bounds it on this card: the latency of one ordered chain. The
// reference updates a batch's tiles, and the GEMM groups of G windows in a
// tile, strictly one after another, so one CTA walks them all, and a group
// (a few KB of rows, ~55K FLOPs at G=4) costs the sum of the latencies on
// its chain: row loads, the pair dot products and their reductions, the
// sigmoids, barriers, the update and its stores. Neither HBM bandwidth nor
// the f32 FMA rate is near.
//
// What the design does about it (seq.cuh's machinery for K1/K2, widened
// from one window to a step of G windows):
// - Compile-time shapes. (WF, NNEG, T, G) at d = 128 for the shapes the
//   project runs (kTiledCompiled in fullw2v.cu): every pair's window,
//   context slot, output slot and label come from unrolled loops. WF = 0 is
//   the runtime-shaped instantiation of the same body for any other shape,
//   unaligned tables or a layout that does not fit: there the update reads
//   the rows in shared memory, one thread a column, and every row of the
//   next step is loaded after this step's stores.
// - Indices and the tile plan staged per sentence (STAGED): tokens,
//   negatives, length, uniq, scatter, ucount and strict go into shared
//   memory with cp.async, double-buffered; sentence s+1's are issued when
//   sentence s starts. Every row address is one shared load away. When two
//   sentences' worth does not fit, the runtime instantiation reads them in
//   place (STAGED = false).
// - One loop of steps. A fused tile runs as steps of G windows (its GEMM
//   groups), a strict tile as steps of one window whose N+1 output rows come
//   from the table: the same machinery at G = 1.
// - Rows in flight together, 16 bytes a lane, one warp a row. The ring is
//   indexed by a running head (the slot of position base - w_f), never by a
//   modulus, and has 2G + 2w_f slots, so the next step's leading rows land
//   in slots of their own while this step computes.
// - Eight warps, one of them a producer. While warps 0-6 reduce the step's
//   pairs, warp 7 decides from the staged indices, with one match and a few
//   ballots, which rows of the next step may load now and lists them: (a) a
//   leading ring row waits when its token is one of the positions this step
//   stores when it ends, a strict window's output row when it equals a row
//   this step writes; (b) on a fused tile's first step, the reference's K4
//   prefetch (was_prefetched, fullw2v.py:617-636): tile i+1's unique rows
//   go into the other half of a double-buffered out_uniq, except a row of
//   tile i's write-back set. Right after the barrier that completes g every
//   warp issues a share of the listed rows, so they arrive while the update
//   runs (issuing them from the producer alone put their cost on the
//   chain). Rows that wait are issued after this step's stores and a
//   barrier. Prefetch needs tiles i and i+1 fused and, as in the reference,
//   does not cross a sentence boundary; K3 prefetches too: it changes no
//   value. (At runtime shapes only the prefetch goes ahead.)
// - No copies of context or slot rows. Each thread keeps one column of the
//   step's rows in registers (its 2w_f + G ring positions, 0 outside the
//   sentence, and its G(N+1) slot rows, read through the staged scatter
//   map), loaded before the barrier that completes g, so both halves of the
//   update read the pre-update values. Threads 0-127 compute d_out and add
//   it into out_uniq (fused) or write the row to the table (strict); threads
//   128-255 compute d_ctx into the ring and store the positions this step
//   completes.
// - All pairs in one pass: G * 2w_f * (N+1) = 144 pairs at the main shape
//   over 7 pair warps, 21 each; the transposed reduction (reduce_pairs,
//   NV = 32) leaves each lane one pair's sum in 31 shuffles, and the
//   sigmoids run side by side. Each lane takes column c of every pair
//   before column c+1, and the update's sums run a over the outer loop for
//   d_out and b for d_ctx, so their independent chains interleave (each
//   sum keeps its own order).
//
// The bits do not move. Every sum keeps the order of the body this one
// replaced, which seq.cuh's header writes down:
// - a pair's dot product: lane l adds fmaf over columns l, l+32, ... from
//   0.0f, then the lanes fold in the xor order 16, 8, 4, 2, 1;
// - g = lr * (label - stable_sigmoid(c)), 0 outside the sentence;
// - d_ctx for window w, slot a: fmaf over b = 0..N from 0.0f, added into the
//   ring only inside the sentence, windows in order;
// - d_out for slot (w, b): fmaf over a = 0..K-1 of window w only, from 0.0f,
//   masked terms included, added into out_uniq[scatter[w(N+1)+b]] in slot
//   order, so the tile's shared negative columns take their G adds in window
//   order (a window's N+1 columns, distinct by the kernels' precondition,
//   are read, added and written together; a window with a repeated column
//   takes one add at a time);
// - the ring schedule: window 0 of a group stores the position 2w_f+1 back
//   before its load (here: at the end of the previous step, the same point
//   in the order of table accesses); the other G-1 loads come before the
//   group's update and their evictees are stored after it, so those loads
//   still read the table as it stood before those stores (the reference's
//   widened duplicate-token race, fullw2v.py:645-661); the flush stores the
//   rest in increasing order;
// - the write-back: every unique row once per tile, in column order;
// - strict tiles replay K1's order exactly.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "seq.cuh"
#include "window.cuh"

namespace fullw2v {

// ---------------------------------------------------------------------------
// shapes and the shared-memory layout
// ---------------------------------------------------------------------------

// A step of NW windows at a compile-time shape.
template <int WF, int NNEG, int NW>
struct StepShape {
  static constexpr int K = 2 * WF;                 // context slots a window
  static constexpr int M = NNEG + 1;               // output slots a window
  static constexpr int X = NW + 2 * WF;            // ring positions a step
  static constexpr int KM = K * M;                 // pairs a window
  static constexpr int P = NW * KM;                // pairs a step
  static constexpr int PW = (P + kPairWarps - 1) / kPairWarps;  // per warp
  static constexpr int NV = pow2_ceil(PW);         // partials reduced at once
  static_assert(NV <= 32, "at most 32 pairs per warp");
  static_assert(NW * M <= 32, "a step's slots fit one warp's lanes");
  static_assert(KM % 4 == 0, "a window's g is whole float4s");
};

// Offsets in 4-byte words of dynamic shared memory; the host computes the
// same (fullw2v.cu's launcher, kernels/fullw2v.py's tiled_smem_bytes).
// The row buffers come first, each a multiple of 4 words when d is.
struct TiledLayout {
  int R, MT, nt, SI;        // ring slots, tile slots, tiles, ints a stage
  int o_ng, o_len, o_uq, o_sc, o_uc, o_st;   // offsets inside a stage
  size_t ring, outu, outw, xs, g, flags, pfl, clist, stage, words;
};

__host__ __device__ inline int pad4i(int n) { return (n + 3) & ~3; }

__host__ __device__ inline TiledLayout tiled_layout(int d, int wf, int nn,
                                                    int T, int G, int L,
                                                    bool pf, bool staged) {
  TiledLayout y;
  const int K = 2 * wf, M = nn + 1;
  y.R = 2 * G + 2 * wf;
  y.MT = T * M;
  y.nt = (L + T - 1) / T;
  y.o_ng = L;
  y.o_len = L + L * nn;
  y.o_uq = pad4i(y.o_len + 1);
  y.o_sc = y.o_uq + y.nt * y.MT;
  y.o_uc = y.o_sc + y.nt * y.MT;
  y.o_st = y.o_uc + y.nt;
  y.SI = pad4i(y.o_st + y.nt);
  y.ring = 0;                                          // [R][d]
  y.outu = y.ring + (size_t)y.R * d;                   // [1 or 2][MT][d]
  y.outw = y.outu + (size_t)(pf ? 2 : 1) * y.MT * d;   // [2][M][d]
  y.xs = y.outw + (size_t)2 * M * d;                   // [G + 2w_f][d]
  y.g = y.xs + (size_t)(G + 2 * wf) * d;               // [pad4(G*K*M)]
  y.flags = y.g + pad4i(G * K * M);                    // 8 words
  y.pfl = y.flags + 8;                                 // [pad4(MT)]
  y.clist = y.pfl + pad4i(y.MT);                       // [pad4(2(MT+G+M))]
  y.stage = y.clist + pad4i(2 * (y.MT + G + M));       // [2][SI] ints
  y.words = y.stage + (staged ? (size_t)2 * y.SI : 0);
  return y;
}

// One sentence's indices and tile plan, staged in shared memory or read in
// place.
struct TileIdx {
  const int* tok;   // [L]
  const int* ng;    // [L][nn]
  const int* uq;    // [nt][MT]
  const int* sc;    // [nt][MT]
  const int* uc;    // [nt]
  const int* st;    // [nt]
  int len, nn, MT;
  // output row b of window t: the target for b = 0, else negative b-1
  __device__ __forceinline__ int out_id(int t, int b) const {
    return b == 0 ? tok[t] : ng[t * nn + b - 1];
  }
  __device__ __forceinline__ int uniq(int i, int c) const {
    return uq[i * MT + c];
  }
};

// One step: windows base .. base+wn-1 of tile i (a GEMM group of a fused
// tile, or one window of a strict tile), nv of them inside the sentence.
struct Step {
  int i, base, wn, nv;
  bool strict, first, last;
};

// Is context slot a of the step's window w a position inside the sentence?
__device__ __forceinline__ bool ctx_ok(int base, int w, int a, int wf,
                                       int nv, int len) {
  const int p = base + w + ctx_offset(a, wf);
  return w < nv && p >= 0 && p < len;
}

// ---------------------------------------------------------------------------
// pair phase at compile-time shapes
// ---------------------------------------------------------------------------

// Warp W's partials of the step's pairs [W*PW, W*PW + PW), pair index
// (w*K + a)*M + b (0 past the last pair); yrow(w, b) is slot (w, b)'s row.
template <int WF, int NNEG, int NW, int W, typename YRow>
__device__ __forceinline__ void step_partials(
    float (&v)[StepShape<WF, NNEG, NW>::NV], const float* ring, int head,
    int R, YRow yrow, int lane) {
  using Sh = StepShape<WF, NNEG, NW>;
  constexpr int D = kSeqD, M = Sh::M;
#pragma unroll
  for (int i = 0; i < Sh::NV; ++i) v[i] = 0.0f;
  constexpr int n = W * Sh::PW + Sh::PW <= Sh::P ? Sh::PW
                  : W * Sh::PW < Sh::P ? Sh::P - W * Sh::PW : 0;
  const float* x[n > 0 ? n : 1];
  const float* y[n > 0 ? n : 1];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const int pr = W * Sh::PW + i;
    const int w = pr / Sh::KM, a = (pr / M) % Sh::K, b = pr % M;
    x[i] = ring + wrap(head + w + ctx_pos(a, WF), R) * D + lane;
    y[i] = yrow(w, b) + lane;
  }
  // column c of every pair before column c+1: the pairs' chains interleave
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = fmaf(x[i][32 * c], y[i][32 * c], v[i]);
}

// step_partials for the calling warp (a uniform branch per warp).
template <int WF, int NNEG, int NW, int W = 0, typename YRow>
__device__ __forceinline__ void step_warp_partials(
    int warp, float (&v)[StepShape<WF, NNEG, NW>::NV], const float* ring,
    int head, int R, YRow yrow, int lane) {
  if constexpr (W + 1 < kPairWarps) {
    if (warp != W) {
      step_warp_partials<WF, NNEG, NW, W + 1>(warp, v, ring, head, R, yrow,
                                              lane);
      return;
    }
  }
  step_partials<WF, NNEG, NW, W>(v, ring, head, R, yrow, lane);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// One CTA of 8 warps walks the batch's S sentences, their tiles and the
// tiles' steps in order (the layout: tiled_layout above). counters, when
// not null, receives the prefetched and the rejected columns' counts.
template <int WF, int NNEG, int T, int G, bool STAGED, typename Table>
__global__ void __launch_bounds__(kSeqThreads)
tiled_kernel(Table w_in, Table w_out, const int* __restrict__ tokens,
             const int* __restrict__ negs, const int* __restrict__ lengths,
             const int* __restrict__ uniq, const int* __restrict__ scatter,
             const int* __restrict__ ucount, const int* __restrict__ strict,
             float lr, int S, int L, int n_neg_rt, int d_rt, int w_f_rt,
             int tile_rt, int G_rt, int pf,
             unsigned long long* __restrict__ counters) {
  constexpr bool kStatic = WF > 0;
  static_assert(!kStatic || (T % G == 0 && G <= 16),
                "compiled shapes run whole groups");
  const int wf = kStatic ? WF : w_f_rt;
  const int nn = kStatic ? NNEG : n_neg_rt;
  const int d = kStatic ? kSeqD : d_rt;
  const int TT = kStatic ? T : tile_rt;
  const int GG = kStatic ? G : G_rt;
  const int K = 2 * wf, M = nn + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TiledLayout lay = tiled_layout(d, wf, nn, TT, GG, L, pf != 0,
                                       STAGED);
  const int R = lay.R, MT = lay.MT, nt = lay.nt;

  extern __shared__ __align__(16) float tiled_shared[];
  float* ring = tiled_shared + lay.ring;
  float* outu = tiled_shared + lay.outu;
  float* outw = tiled_shared + lay.outw;
  float* xs = tiled_shared + lay.xs;
  float* g = tiled_shared + lay.g;
  int* flags = reinterpret_cast<int*>(tiled_shared + lay.flags);
  int* pfl = reinterpret_cast<int*>(tiled_shared + lay.pfl);
  int* clist = reinterpret_cast<int*>(tiled_shared + lay.clist);
  int* stage = reinterpret_cast<int*>(tiled_shared + lay.stage);

  auto sentence = [&](int s, int buf) {
    TileIdx I;
    I.nn = nn;
    I.MT = MT;
    if constexpr (STAGED) {
      const int* b = stage + buf * lay.SI;
      I.tok = b;
      I.ng = b + lay.o_ng;
      I.len = b[lay.o_len];
      I.uq = b + lay.o_uq;
      I.sc = b + lay.o_sc;
      I.uc = b + lay.o_uc;
      I.st = b + lay.o_st;
    } else {
      I.tok = tokens + (size_t)s * L;
      I.ng = negs + (size_t)s * L * nn;
      I.len = lengths[s];
      I.uq = uniq + (size_t)s * nt * MT;
      I.sc = scatter + (size_t)s * nt * MT;
      I.uc = ucount + (size_t)s * nt;
      I.st = strict + (size_t)s * nt;
    }
    return I;
  };
  auto stage_sentence = [&](int s, int buf) {
    int* dst = stage + buf * lay.SI;
    auto copy = [&](int off, const int* src, int n) {
      for (int k = tid; k < n; k += kSeqThreads)
        cp_async4(dst + off + k, src + k);
    };
    copy(0, tokens + (size_t)s * L, L);
    copy(lay.o_ng, negs + (size_t)s * L * nn, L * nn);
    copy(lay.o_len, lengths + s, 1);
    copy(lay.o_uq, uniq + (size_t)s * nt * MT, nt * MT);
    copy(lay.o_sc, scatter + (size_t)s * nt * MT, nt * MT);
    copy(lay.o_uc, ucount + (size_t)s * nt, nt);
    copy(lay.o_st, strict + (size_t)s * nt, nt);
  };

  auto make_step = [&](const TileIdx& I, int i, int base) {
    Step st;
    const int t0 = i * TT;
    st.i = i;
    st.base = base;
    st.strict = I.st[i] != 0;
    st.wn = st.strict ? 1 : min(GG, t0 + TT - base);
    st.nv = min(st.wn, I.len - base);
    st.first = base == t0;
    st.last = base + st.wn >= min(t0 + TT, I.len);
    return st;
  };
  auto next_step = [&](const TileIdx& I, const Step& st, Step& nx) {
    const int nb = st.base + st.wn;
    if (nb >= I.len) return false;
    nx = make_step(I, st.last ? st.i + 1 : st.i, nb);
    return true;
  };
  // the half of out_uniq that holds tile i's rows
  auto half = [&](int i) {
    return outu + (size_t)(pf ? (i & 1) : 0) * MT * d;
  };
  // Was column c of fused tile i prefetched during tile i-1? (pfl, written
  // by tile i-1's first step, says which columns it took.)
  auto was_prefetched = [&](const TileIdx& I, int i, int c) {
    return pf && i > 0 && I.st[i - 1] == 0 && pfl[c] != 0;
  };

  // Async copy of one table row into shared memory: the calling warp, 16
  // bytes a lane, at compile-time shapes; else 4 bytes a thread of the
  // block (block) or of the calling warp.
  auto copy_row = [&](float* dst, const float* src, bool block) {
    if constexpr (kStatic) {
      cp_async16(dst + 4 * lane, src + 4 * lane);
    } else if (block) {
      for (int j = tid; j < d; j += kSeqThreads) cp_async4(dst + j, src + j);
    } else {
      for (int j = lane; j < d; j += 32) cp_async4(dst + j, src + j);
    }
  };
  // Rows k = 0..n-1 of a step issued by the whole block (one warp a row at
  // compile-time shapes); row(k, dst, src) says where, or false to skip.
  auto issue_rows = [&](int n, auto row) {
    for (int k = kStatic ? warp : 0; k < n; k += kStatic ? kSeqWarps : 1) {
      float* dst;
      const float* src;
      if (row(k, dst, src)) copy_row(dst, src, true);
    }
  };
  // Row k of step nx (head_nx: the slot of nx.base - w_f): k < wn its
  // leading ring row, position nx.base + k + w_f (none past the sentence's
  // end); then a strict window's N+1 output rows, or on a fused tile's first
  // step the tile's unique rows.
  auto row_count = [&](const TileIdx& I, const Step& nx) {
    return nx.wn + (nx.strict ? M : nx.first ? I.uc[nx.i] : 0);
  };
  auto step_row = [&](const TileIdx& I, const Step& nx, int head_nx, int k,
                      float*& dst, const float*& src) {
    if (k < nx.wn) {
      const int q = nx.base + k + wf;
      if (q >= I.len) return false;
      dst = ring + (size_t)wrap(head_nx + 2 * wf + k, R) * d;
      src = w_in.row(I.tok[q]);
    } else if (nx.strict) {
      dst = outw + (size_t)((nx.base & 1) * M + k - nx.wn) * d;
      src = w_out.row(I.out_id(nx.base, k - nx.wn));
    } else {
      dst = half(nx.i) + (size_t)(k - nx.wn) * d;
      src = w_out.row(I.uniq(nx.i, k - nx.wn));
    }
    return true;
  };
  // Must row k of step nx wait for this step's stores? At compile-time
  // shapes the producer's hazard bits say (hz_ring: bit k for ring row k,
  // hz_out: bit b for a strict window's output row b); at runtime shapes
  // every ring and output row waits. A tile row waits unless prefetched.
  auto late = [&](const TileIdx& I, const Step& nx, int k, unsigned hz_ring,
                  unsigned hz_out) {
    if (k < nx.wn) return !kStatic || ((hz_ring >> k) & 1u) != 0;
    if (nx.strict) return !kStatic || ((hz_out >> (k - nx.wn)) & 1u) != 0;
    return !was_prefetched(I, nx.i, k - nx.wn);
  };

  // Does step st prefetch the next tile's unique rows? (The first step of
  // a fused tile whose successor in the sentence is fused too.)
  auto prefetches = [&](const TileIdx& I, const Step& st) {
    const int i1 = st.i + 1;
    return pf && st.first && !st.strict && i1 < nt && i1 * TT < I.len &&
           I.st[i1] == 0;
  };

  // The producer warp's work during step st (all 32 lanes): it decides,
  // from the staged indices, which rows go ahead and lists them in clist
  // (pairs of a destination offset in shared memory and a row id, -1-id
  // for a w_in row) for every warp to issue after the barrier that
  // completes g. It leaves in flags: [0] hz_ring, [1] hz_out, [2] must any
  // row of step nx wait for this step's stores, [3] the rejected columns of
  // the next tile (written on a fused tile's first step, read on its last),
  // [4] the length of clist.
  auto produce = [&](const TileIdx& I, const Step& st, bool more,
                     const Step& nx, int head_nx) {
    const unsigned full = 0xffffffffu;
    int listed = 0;
    auto list = [&](bool mine, const float* dst, int id) {
      const unsigned m = __ballot_sync(full, mine);
      if (mine) {
        const int e = listed + __popc(m & ((1u << lane) - 1u));
        clist[2 * e] = (int)(dst - tiled_shared);
        clist[2 * e + 1] = id;
      }
      listed += __popc(m);
    };
    // (c) the next tile's unique rows, except tile st.i's write-back set
    if (prefetches(I, st)) {
      const int i1 = st.i + 1;
      const int u0 = I.uc[st.i], u1 = I.uc[i1];
      const float* dst = half(i1);
      if (u0 + u1 <= 32) {
        // one match: lanes [0, u0) hold tile i's ids, [u0, u0+u1) tile
        // i+1's; a tile-i+1 lane matching a lane below u0 is rejected
        const bool in0 = lane < u0, in1 = !in0 && lane < u0 + u1;
        const int id = in0 ? I.uniq(st.i, lane)
                           : in1 ? I.uniq(i1, lane - u0) : -1 - lane;
        const unsigned same = __match_any_sync(full, id);
        const bool take = in1 && (same & ((1u << u0) - 1u)) == 0u;
        if (in1) pfl[lane - u0] = take ? 1 : 0;
        list(take, dst + (size_t)(lane - u0) * d, id);
      } else {
        for (int c0 = 0; c0 < u1; c0 += 32) {
          const int c = c0 + lane;
          bool take = false;
          int id = 0;
          if (c < u1) {
            id = I.uniq(i1, c);
            bool hit = false;
            for (int cc = 0; cc < u0; ++cc) hit |= id == I.uniq(st.i, cc);
            take = !hit;
            pfl[c] = take ? 1 : 0;
          }
          list(take, dst + (size_t)c * d, id);
        }
      }
      if (lane == 0) {
        flags[3] = u1 - listed;
        if (counters != nullptr) {
          atomicAdd(counters, (unsigned long long)listed);
          atomicAdd(counters + 1, (unsigned long long)(u1 - listed));
        }
      }
    }
    if constexpr (kStatic) {
      // (a) the next step's hazards against this step's stores, (b) its
      // other ring and output rows go ahead
      unsigned hz_ring = 0u, hz_out = 0u;
      bool any = false;
      if (more) {
        // one match: lane w-1 < 16 holds the token of the position this
        // step stores for w = 1..wn, lane 16+k the leading row k's token
        int key = -1 - lane;
        const int k = lane - 16, q = nx.base + k + wf;
        const bool lead = k >= 0 && k < nx.wn && q < I.len;
        if (lane < 16) {
          const int p = st.base + lane - wf;      // w = lane + 1
          if (lane < st.wn && p >= 0 && p + 2 * wf + 1 < I.len)
            key = I.tok[p];
        } else if (lead) {
          key = I.tok[q];
        }
        const unsigned same = __match_any_sync(full, key);
        const bool h = lead && (same & 0xffffu) != 0u;
        hz_ring = __ballot_sync(full, h) >> 16;
        list(lead && !h,
             ring + (size_t)wrap(head_nx + 2 * wf + (lead ? k : 0), R) * d,
             -1 - key);
        if (nx.strict) {
          bool ho = false;
          int id = 0;
          if (lane < M) {
            id = I.out_id(nx.base, lane);
            if (st.strict) {
              for (int b = 0; b < M; ++b) ho |= id == I.out_id(st.base, b);
            } else if (st.last) {
              for (int c = 0; c < I.uc[st.i]; ++c)
                ho |= id == I.uniq(st.i, c);
            }
          }
          hz_out = __ballot_sync(full, ho);
          list(lane < M && !ho,
               outw + (size_t)((nx.base & 1) * M + (lane < M ? lane : 0)) * d,
               id);
        }
        // a fused tile's rows wait unless prefetched: all of them after a
        // strict tile or without prefetch, else the rejected ones
        const bool tile_late =
            nx.first && !nx.strict && I.uc[nx.i] > 0 &&
            (!pf || I.st[st.i] != 0 || flags[3] > 0);
        any = hz_ring != 0u || hz_out != 0u || tile_late;
      }
      if (lane == 0) {
        flags[0] = (int)hz_ring;
        flags[1] = (int)hz_out;
        flags[2] = any ? 1 : 0;
      }
    } else if (lane == 0) {
      flags[2] = more ? 1 : 0;     // every row of the next step waits
    }
    if (lane == 0) flags[4] = listed;
  };
  // The rows produce() listed, one warp a row (by every warp, after the
  // barrier that completes g, which makes the list visible).
  auto issue_listed = [&]() {
    const int n = flags[4];
    for (int e = warp; e < n; e += kSeqWarps) {
      const int id = clist[2 * e + 1];
      copy_row(tiled_shared + clist[2 * e],
               id >= 0 ? w_out.row(id) : w_in.row(-1 - id), false);
    }
  };

  // A step at compile-time shapes, NW = G (fused) or 1 (strict, and every
  // step at T = 1): pairs, barrier, update from registers, stores.
  auto step_static = [&](auto nw_tag, const TileIdx& I, const Step& st,
                         int head, float* ou, const float* ow,
                         const int* scs) {
    constexpr int NW = decltype(nw_tag)::value;
    using Sh = StepShape<kStatic ? WF : 1, kStatic ? NNEG : 1, NW>;
    constexpr int D = kSeqD, KK = Sh::K, MM = Sh::M, X = Sh::X, KM = Sh::KM;
    const bool strict_step = NW == 1 && st.strict;
    const int len = I.len;
    auto yrow = [&](int w, int b) -> const float* {
      return strict_step ? ow + b * D : ou + scs[w * MM + b] * D;
    };
    if (warp != kProducer) {
      float v[Sh::NV];
      step_warp_partials<kStatic ? WF : 1, kStatic ? NNEG : 1, NW>(
          warp, v, ring, head, R, yrow, lane);
      const float c = reduce_pairs<Sh::NV>(v, lane);
      const int ip = lane_pair<Sh::NV>(lane);
      const int pr = warp * Sh::PW + ip;
      if (lane_leads<Sh::NV>(lane) && ip < Sh::PW && pr < Sh::P) {
        const int w = pr / KM, a = (pr / MM) % KK, b = pr % MM;
        const float label = b == 0 ? 1.0f : 0.0f;
        g[pr] = ctx_ok(st.base, w, a, WF, st.nv, len)
                    ? lr * (label - sigmoid_nb(c))
                    : 0.0f;
      }
    }
    // this thread's column of the step's rows, pre-update
    const int j = tid & (D - 1);
    float xr[X];
    float yr[NW][MM];
#pragma unroll
    for (int o = 0; o < X; ++o) {
      const int p = st.base - WF + o;
      const float v = ring[wrap(head + o, R) * D + j];
      xr[o] = p >= 0 && p < len ? v : 0.0f;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int b = 0; b < MM; ++b) yr[w][b] = yrow(w, b)[j];
    __syncthreads();                 // g complete; every read of rows done
    issue_listed();

    auto load_g = [&](int w, float (&gw)[KM]) {
#pragma unroll
      for (int q = 0; q < KM / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(g + w * KM)[q];
        gw[4 * q] = f.x;
        gw[4 * q + 1] = f.y;
        gw[4 * q + 2] = f.z;
        gw[4 * q + 3] = f.w;
      }
    };
    if (tid < D) {
      // d_out = g^T . ctx, slot order
      // every window's sums first (no store in between, so the loads of
      // g run ahead), a over the outer loop so the M chains interleave
      float acc[NW][MM];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w >= st.nv) continue;
        float gw[KM];
        load_g(w, gw);
#pragma unroll
        for (int b = 0; b < MM; ++b) acc[w][b] = 0.0f;
#pragma unroll
        for (int a = 0; a < KK; ++a)
#pragma unroll
          for (int b = 0; b < MM; ++b)
            acc[w][b] = fmaf(gw[a * MM + b], xr[w + ctx_pos(a, WF)],
                             acc[w][b]);
      }
      if (strict_step) {
#pragma unroll
        for (int b = 0; b < MM; ++b)
          w_out.row(I.out_id(st.base, b))[j] = yr[0][b] + acc[0][b];
      } else {
        // windows in order; a window's N+1 columns, distinct by the
        // precondition, are read, added and written together (one at a
        // time when the window repeats a column)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (w >= st.nv) continue;
          int cb[MM];
#pragma unroll
          for (int b = 0; b < MM; ++b) cb[b] = scs[w * MM + b];
          bool rep = false;
#pragma unroll
          for (int b = 1; b < MM; ++b)
#pragma unroll
            for (int e = 0; e < b; ++e) rep |= cb[b] == cb[e];
          if (!rep) {
            float cur[MM];
#pragma unroll
            for (int b = 0; b < MM; ++b) cur[b] = ou[cb[b] * D + j];
#pragma unroll
            for (int b = 0; b < MM; ++b) ou[cb[b] * D + j] = cur[b] + acc[w][b];
          } else {
#pragma unroll
            for (int b = 0; b < MM; ++b)
              ou[cb[b] * D + j] = ou[cb[b] * D + j] + acc[w][b];
          }
        }
      }
      if (!strict_step && st.last) {   // the tile's write-back
        const int u = I.uc[st.i];
        const int* uq = I.uq + st.i * MT;
#pragma unroll 4
        for (int c = 0; c < u; ++c) w_out.row(uq[c])[j] = ou[c * D + j];
      }
    } else {
      // d_ctx = g . out into the ring, windows in order
      float xn[X];
#pragma unroll
      for (int o = 0; o < X; ++o) xn[o] = xr[o];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w >= st.nv) continue;
        float gw[KM];
        load_g(w, gw);
        float acc[KK];                 // b over the outer loop: K chains
#pragma unroll
        for (int a = 0; a < KK; ++a) acc[a] = 0.0f;
#pragma unroll
        for (int b = 0; b < MM; ++b)
#pragma unroll
          for (int a = 0; a < KK; ++a)
            acc[a] = fmaf(gw[a * MM + b], yr[w][b], acc[a]);
#pragma unroll
        for (int a = 0; a < KK; ++a)
          if (ctx_ok(st.base, w, a, WF, st.nv, len))
            xn[w + ctx_pos(a, WF)] += acc[a];
      }
#pragma unroll
      for (int o = 0; o < X; ++o) {
        const int p = st.base - WF + o;
        if (p >= 0 && p < len) ring[wrap(head + o, R) * D + j] = xn[o];
      }
      // the positions this step completes, in increasing order
#pragma unroll
      for (int w = 1; w <= NW; ++w) {
        const int p = st.base + w - WF - 1;
        if (st.base + w + WF < len && p >= 0)
          w_in.row(I.tok[p])[j] = xn[w - 1];
      }
    }
  };

  // A step at runtime shapes: the same sums over rows kept in shared
  // memory, updated by threads 0-127 one column at a time (xs keeps the
  // pre-update ring columns for d_out).
  auto step_runtime = [&](const TileIdx& I, const Step& st, int head,
                          float* ou, const float* ow, const int* scs) {
    const int len = I.len, nw = st.wn, nv = st.nv, P = nv * K * M;
    auto yrow = [&](int w, int b) -> const float* {
      return st.strict ? ow + (size_t)b * d : ou + (size_t)scs[w * M + b] * d;
    };
    if (warp != kProducer) {
      constexpr int NV = 16;
      for (int pr0 = warp * NV; pr0 < P; pr0 += kPairWarps * NV) {
        float v[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          v[i] = 0.0f;
          const int pr = pr0 + i;
          if (pr < P) {
            const int w = pr / (K * M), a = (pr / M) % K, b = pr % M;
            const float* x =
                ring + (size_t)wrap(head + w + ctx_pos(a, wf), R) * d;
            const float* y = yrow(w, b);
            for (int j = lane; j < d; j += 32) v[i] = fmaf(x[j], y[j], v[i]);
          }
        }
        const float c = reduce_pairs<NV>(v, lane);
        const int pr = pr0 + lane_pair<NV>(lane);
        if (lane_leads<NV>(lane) && pr < P) {
          const int w = pr / (K * M), a = (pr / M) % K, b = pr % M;
          const float label = b == 0 ? 1.0f : 0.0f;
          g[pr] = ctx_ok(st.base, w, a, wf, nv, len)
                      ? lr * (label - sigmoid_nb(c))
                      : 0.0f;
        }
      }
    }
    __syncthreads();                 // g complete
    issue_listed();
    if (tid >= kSeqD) return;
    const int X = nw + 2 * wf;
    auto slot = [&](int o) { return (size_t)wrap(head + o, R) * d; };
    for (int j = tid; j < d; j += kSeqD) {
      for (int o = 0; o < X; ++o) {
        const int p = st.base - wf + o;
        xs[(size_t)o * d + j] = p >= 0 && p < len ? ring[slot(o) + j] : 0.0f;
      }
      // d_ctx first: the output rows stay pre-update until d_out below
      for (int w = 0; w < nv; ++w)
        for (int a = 0; a < K; ++a) {
          if (!ctx_ok(st.base, w, a, wf, nv, len)) continue;
          float acc = 0.0f;
          for (int b = 0; b < M; ++b)
            acc = fmaf(g[(w * K + a) * M + b], yrow(w, b)[j], acc);
          ring[slot(w + ctx_pos(a, wf)) + j] += acc;
        }
      for (int w = 0; w < nv; ++w)
        for (int b = 0; b < M; ++b) {
          float acc = 0.0f;
          for (int a = 0; a < K; ++a)
            acc = fmaf(g[(w * K + a) * M + b],
                       xs[(size_t)(w + ctx_pos(a, wf)) * d + j], acc);
          if (st.strict)
            w_out.row(I.out_id(st.base, b))[j] = ow[(size_t)b * d + j] + acc;
          else
            ou[(size_t)scs[w * M + b] * d + j] += acc;
        }
      for (int w = 1; w <= nw; ++w) {
        const int p = st.base + w - wf - 1;
        if (st.base + w + wf < len && p >= 0)
          w_in.row(I.tok[p])[j] = ring[slot(w - 1) + j];
      }
      if (!st.strict && st.last)
        for (int c = 0; c < I.uc[st.i]; ++c)
          w_out.row(I.uniq(st.i, c))[j] = ou[(size_t)c * d + j];
    }
  };

  int buf = 0;
  if constexpr (STAGED) {
    if (S > 0) stage_sentence(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < S; ++s) {
    const TileIdx I = sentence(s, buf);
    if constexpr (STAGED)
      if (s + 1 < S) stage_sentence(s + 1, buf ^ 1);
    const int len = I.len;
    int head = 0;                    // slot of position st.base - w_f
    Step st{};
    if (len > 0) {
      st = make_step(I, 0, 0);
      // preload positions 0 .. min(w_f, len)-1, then the first step's rows
      issue_rows(min(wf, len), [&](int p, float*& dst, const float*& src) {
        dst = ring + (size_t)(wf + p) * d;
        src = w_in.row(I.tok[p]);
        return true;
      });
      issue_rows(row_count(I, st), [&](int k, float*& dst,
                                       const float*& src) {
        return step_row(I, st, 0, k, dst, src);
      });
    }
    cp_async_commit();

    for (bool go = len > 0; go;) {
      cp_async_wait_all();
      __syncthreads();               // step st's rows are in shared memory
      Step nx;
      const bool more = next_step(I, st, nx);
      const int head_nx = wrap(head + st.wn, R);
      float* ou = half(st.i);
      const float* ow = outw + (size_t)(st.base & 1) * M * d;
      const int* scs = I.sc + st.i * MT + (st.base - st.i * TT) * M;
      if (warp == kProducer) produce(I, st, more, nx, head_nx);
      if constexpr (kStatic) {
        if (T > 1 && !st.strict)
          step_static(std::integral_constant<int, G>(), I, st, head, ou, ow,
                      scs);
        else
          step_static(std::integral_constant<int, 1>(), I, st, head, ou, ow,
                      scs);
      } else {
        step_runtime(I, st, head, ou, ow, scs);
      }
      go = more;
      if (more) {
        // rows of step nx that wait for this step's stores
        if (flags[2] != 0) {
          const unsigned hz_ring = (unsigned)flags[0];
          const unsigned hz_out = (unsigned)flags[1];
          __syncthreads();           // this step's stores before the loads
          issue_rows(row_count(I, nx), [&](int k, float*& dst,
                                           const float*& src) {
            return late(I, nx, k, hz_ring, hz_out) &&
                   step_row(I, nx, head_nx, k, dst, src);
          });
        }
        cp_async_commit();
        head = head_nx;
        st = nx;
      }
    }

    // flush positions len-2w_f-1 .. len-1 in increasing order (the earlier
    // ones were stored as their windows completed) by the threads that
    // update the ring; head is the slot of st.base - w_f
    const bool ring_owner = kStatic ? tid >= kSeqD : tid < kSeqD;
    for (int j = tid & (kSeqD - 1); ring_owner && len > 0 && j < d;
         j += kSeqD)
      for (int k = 0; k <= 2 * wf; ++k) {
        const int p = len - 2 * wf - 1 + k;
        if (p < 0) continue;
        int sl = head + p - (st.base - wf);   // in [-w_f, 2R)
        sl += sl < 0 ? R : sl >= R ? -R : 0;
        w_in.row(I.tok[p])[j] = ring[(size_t)sl * d + j];
      }
    cp_async_wait_all();             // the next sentence's indices
    __syncthreads();                 // this sentence's stores before its loads
    buf ^= 1;
  }
}

}  // namespace fullw2v
