// Shared window helpers of the FULL-W2V kernels for Hopper (sm_90a).
//
// Replaces the pieces that the Pallas kernels of src/repro/kernels/fullw2v.py
// share outside their bodies: the context-slot offsets of the label/mask
// helpers (:216-236) and the _Table row router (:101-155) of the
// split-table kernel.
//
// Who uses it: every kernel. The sequential kernels K1/K2 (seq.cuh, from
// _kernel :284 and _kernel_pipelined :376) and the window-tiled kernels
// K3/K4 (tiled.cuh, from _kernel_tiled :537) have bodies of their own, each
// built for the latency of one ordered chain; seq.cuh's and tiled.cuh's
// headers give their designs and the fixed order of every sum, which makes
// K2 == K1 == K3(T=1) and K4 == K3 on concat(hot, got) bit for bit.
//
// What bounds the code here: nothing of its own. These are a few integer
// and pointer operations inlined into the kernels' chains. The table
// accessors keep K4's split table from costing more than one select a row.
#pragma once

#include <cuda_runtime.h>

namespace fullw2v {

// Window-relative context offset of slot a: [-w_f..w_f] without 0.
__device__ __forceinline__ int ctx_offset(int a, int w_f) {
  return a < w_f ? a - w_f : a - w_f + 1;
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

}  // namespace fullw2v
