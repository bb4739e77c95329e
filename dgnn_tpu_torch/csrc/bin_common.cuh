// Device helpers shared by the lane-group-per-segment bin kernels
// (bin_gat.cu bin_gat_fwd_kernel / bin_gat_bwd_kernel, bin_gmm.cu
// bin_gmm_fwd_kernel / bin_gmm_bwd_kernel).
//
// BinList: every bin of one adjacency direction, passed by value as a
// kernel parameter (no host-to-device copy per call).  Bin b holds S_b
// segments of W_b slots; segment s of bin b is global segment
// start[b] + s, and its outputs go to that row of [total, ...] outputs:
// the layout of the bins' outputs concatenated in order.  A direction with
// more than kMaxBins bins takes more than one launch (the wrappers in
// ops/bins.py cut it, with the outputs' pointers moved on).
//
// A segment belongs to a group of G lanes (G a power of two, at most 32)
// inside one warp; every cross-lane step stays inside the group
// (group_mask for __shfl_*_sync and __syncwarp), so groups of one warp with
// different slot counts never wait on each other.
//
// Feature rows (the gathered x or g rows and a segment's own x row) are
// stored as float or as bf16 (__nv_bfloat16, the ops' gather_dtype) and
// read as float by ld_row / ld_row4: every sum stays in float32.  A bf16
// value is the high half of the float with the same bits, so the widening
// is a shift and exact.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dgnn {

constexpr int kMaxBins = 8;   // bins per launch (graph.binning's max_bins)
constexpr int kGroupThreads = 256;  // threads a block, before the shared-memory cap
constexpr int kMaxCols = 8;  // feature columns a lane per column tile

struct BinList {
  const int* nbr[kMaxBins];    // [S_b, W_b] slot ids
  const int* row[kMaxBins];    // [S_b] segment row
  const int* count[kMaxBins];  // [S_b] valid slots
  int W[kMaxBins];
  int start[kMaxBins];         // first global segment of bin b
  int nbins;
  int total;                   // segments in all bins
};

__device__ __forceinline__ float ld_row(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld_row(const __nv_bfloat16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(u << 16);
}

// Four consecutive values from an address aligned to four of them (16
// bytes of float, 8 of bf16).
__device__ __forceinline__ float4 ld_row4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld_row4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Whether a lane may load its columns four at a time (ld_row4): at least
// four columns a lane, F % 4 == 0 for F the columns of one head or kernel
// (so that a load's four columns lie in one of them), and the table
// aligned to four of its values.
template <typename T>
inline bool vec_rows(int cpl, int F, const void* table) {
  return cpl >= 4 && F % 4 == 0 &&
         reinterpret_cast<uintptr_t>(table) % (4 * sizeof(T)) == 0;
}

// Segment `s` (global) resolved to its bin's tables.
struct Seg {
  const int* nbr;  // the segment's W slots
  int W;
  int row;
  int count;
};

__device__ __forceinline__ Seg find_seg(const BinList& bl, int s) {
  int b_sel = 0;
#pragma unroll
  for (int b = 1; b < kMaxBins; ++b) {
    if (b < bl.nbins && s >= bl.start[b]) b_sel = b;
  }
  // compile-time indexes only, so the list stays in the parameter bank
  const int* nbr = bl.nbr[0];
  const int* row = bl.row[0];
  const int* count = bl.count[0];
  int W = bl.W[0], start = bl.start[0];
#pragma unroll
  for (int b = 1; b < kMaxBins; ++b) {
    if (b == b_sel) {
      nbr = bl.nbr[b];
      row = bl.row[b];
      count = bl.count[b];
      W = bl.W[b];
      start = bl.start[b];
    }
  }
  const int ls = s - start;
  Seg sg;
  sg.nbr = nbr + static_cast<size_t>(ls) * W;
  sg.W = W;
  sg.row = row[ls];
  sg.count = count[ls];
  return sg;
}

// The lanes of the calling thread's group of G (a power of two <= 32).
__device__ __forceinline__ unsigned group_mask(int G) {
  if (G >= 32) return 0xffffffffu;
  const int first = (threadIdx.x & 31) & ~(G - 1);
  return ((1u << G) - 1u) << first;
}

// Lanes a segment gets for C feature columns: enough for one column a lane
// up to a full warp, and at least 4 so that a narrow row's slots still
// spread over lanes.
inline int group_lanes(int C) {
  int G = 4;
  while (G < C && G < 32) G <<= 1;
  return G;
}

// Columns a lane per tile for C columns over G lanes: the least of 1, 2,
// 4, 8 that covers C in one tile (wider rows walk column tiles of
// kMaxCols * G).  16-byte loads take 4 or 8.
inline int cols_per_lane(int C, int G) {
  int c = 1;
  while (c < kMaxCols && c * G < C) c <<= 1;
  return c;
}

// Fill a BinList from the launcher's host arrays; false if nbins is out of
// range.
inline bool pack_bins(int nbins, void* const* nbr, void* const* row,
                      void* const* count, const int* S, const int* W,
                      BinList* bl) {
  if (nbins < 1 || nbins > kMaxBins) return false;
  int total = 0;
  for (int b = 0; b < kMaxBins; ++b) {
    const bool on = b < nbins;
    bl->nbr[b] = on ? static_cast<const int*>(nbr[b]) : nullptr;
    bl->row[b] = on ? static_cast<const int*>(row[b]) : nullptr;
    bl->count[b] = on ? static_cast<const int*>(count[b]) : nullptr;
    bl->W[b] = on ? W[b] : 0;
    bl->start[b] = total;
    if (on) {
      if (S[b] < 0 || W[b] < 0) return false;
      total += S[b];
    }
  }
  bl->nbins = nbins;
  bl->total = total;
  return true;
}

}  // namespace dgnn
