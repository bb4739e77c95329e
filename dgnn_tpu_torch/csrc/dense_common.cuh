// Device helpers shared by the dense hub-block kernels (dense_gat.cu,
// dense_gmm.cu): the tile geometry of graph/hub.py, the bit-plane mask
// decoder, the bf16 operand rounding and the feature-column dispatch.
//
// The hub block is a tile-sparse [R, C] adjacency between the block's rows
// (row_ids) and columns (col_ids): schedule entry t is a [kRT x kCT] tile of
// row chunk rc[t] and column tile ct[t], stored as a bit-plane packed mask
// (the bit of tile column j of a row lives in byte j % 256 of the row's 256
// bytes, bit j / 256).  The schedule is sorted by row chunk;
// chunk_ptr[i]:chunk_ptr[i+1] are the entries of chunk i.
//
// The design all four dense kernels share (dense_gat_fwd, dense_gat_bwd,
// dense_gmm_fwd, dense_gmm_bwd).  The block is sparse: cora's holds 0.22 %
// of its (row, col) pairs, 4.4 edges a row.  So a kernel's cost is the
// chain of dependent loads a row waits on, not FLOPs or bytes, and the
// design keeps that chain short:
//   - a warp a work item, kWarps items a thread block, no block barrier
//     after the start; an item's sums stay in its warp's registers, so no
//     kernel needs atomics.  K5/K6 (dense_gat.cu) take a block row an
//     item.  K7/K8 (dense_gmm.cu) walk the block's work list where it has
//     one (graph/structure.py work_list): a row is an item where its edges
//     fit the list's budget, and a longer row is cut at tile boundaries
//     into pieces, each written to a row of partials that a merge kernel
//     adds in piece order; without a list, a block row an item;
//   - one pass over a tile row's kRowWords mask words lists its set
//     columns (RowList: one 8-byte load a lane, one popcount scan, columns
//     handed out 32 at a time), so a cora row's edges form one batch and
//     one chain: chunk_ptr -> mask -> col_ids -> the edge's tables and
//     feature row;
//   - the row's own tables are requested before its mask; once a batch's
//     ids are known the feature rows of several edges are requested before
//     the per-edge scalars are computed, each from an address every lane
//     may load (clamped into the row, the value zeroed past it): a load
//     under a branch in the loop over edges made each edge wait for its
//     row in turn;
//   - lane i computes edge i's per-head or per-kernel weights into a
//     warp-private slot in shared memory; then the lanes, spread over the
//     feature columns, add the batch's weighted rows;
//   - template instances sized to the models (heads or Gaussian kernels
//     held, columns a lane; ops/dense.py picks one), with launch bounds
//     that keep a layer's rows resident, chosen by measurement
//     (scripts/dense_variants_torch.py).
// A masked pair contributes exactly 0 in the TPU kernels, so skipping it
// changes nothing but the summation order.
//
// Row spans (utils/profiling.py): every kernel takes the recorder's flag
// word (probe) and a buffer of two stamps a work item (spans: [R, 2], or
// [pieces, 2] for K7/K8 on a work list), both null or both given.  While
// the word is set, lane 0 of an item's warp stores %globaltimer (ns) at
// the item's start, at once (stamp_row_start), and at its end
// (stamp_row_end).  Each stamp reads the word again, and the end stamp
// reads its item and lane afresh from %ctaid and %tid, so nothing is held
// over the edge walk for it: with r and lane taken from the start, K8's
// model instance went from 124 to 128 registers and ran 1.3 % slower on
// the Reddit stand-in (PERF.md §6).  With the probes off a warp pays a
// load of the word and a uniform branch at each of the two stamps.  A
// kernel may keep up to two counts an item beside its two stamps (spans:
// [R, W]), which the end stamp writes (K5: its edges walked a second time,
// and its edges, one register held over the walk).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dgnn {

constexpr int kRT = 256;               // rows per row chunk (DENSE_RT)
constexpr int kCT = 2048;              // columns per tile (DENSE_CT)
constexpr int kRowWords = kCT / 32;    // 64 mask words per tile row
constexpr int kWarps = 4;              // block rows per thread block
constexpr unsigned kFull = 0xffffffffu;

// Round to bf16 (nearest even) and back, as the TPU kernels' matmul operands.
__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Tile column of bit b of mask word w of a tile row: bit b of the
// (little-endian) word is byte 4 w + b / 8, plane b % 8.
__device__ __forceinline__ unsigned short tile_column(int w, int b) {
  return static_cast<unsigned short>((b & 7) * (kCT / 8) + 4 * w + (b >> 3));
}

// The set columns of one tile row, listed in one pass over its kRowWords
// mask words by a warp.  Each lane owns two consecutive words, fetched in
// one 8-byte load, so the row's 256 bytes come in one coalesced request
// (the mask must be 8-byte aligned); one popcount scan over the warp gives
// each lane the list position of its first set bit and the row's total.
// emit(e0, slot) then writes the columns at list positions [e0, e0 + 32)
// to slot[0 .. 32): each lane walks its own bits in order and stops at the
// window's end, so over the batches e0 = 0, 32, 64, ... of a tile row
// every set bit is visited once, and the list needs 32 slots however many
// columns the row sets.
struct RowList {
  uint32_t bits[2];  // this lane's words, the visited bits cleared
  int word0;         // index of the first of them in the row
  int pos;           // list position of this lane's next set bit
  int total;         // set columns in the tile row

  __device__ __forceinline__ void load(const uint32_t* mrow, int lane) {
    word0 = 2 * lane;
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(mrow + word0));
    bits[0] = v.x;
    bits[1] = v.y;
    const int cnt = __popc(bits[0]) + __popc(bits[1]);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    total = __shfl_sync(kFull, incl, 31);
    pos = incl - cnt;
  }

  // Batches must come in order; the caller syncs the warp before reading
  // slot and before the next emit.
  __device__ __forceinline__ void emit(int e0, unsigned short* slot) {
    const int end = e0 + 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      while (bits[i] != 0u && pos < end) {
        const int b = __ffs(bits[i]) - 1;
        bits[i] &= bits[i] - 1u;
        slot[pos - e0] = tile_column(word0 + i, b);
        ++pos;
      }
    }
  }
};

// Sums each of v[0 .. NV) over the 32 lanes of a warp in one interleaved
// butterfly (a reduce-scatter: each of the first log2 NV steps sends half
// of the values still held, then a plain butterfly on the one left):
// NV - 1 + 5 - log2 NV shuffles instead of 5 NV.  Returns the sum of value
// lane / (32 / NV); NV a power of two, at most 32; every lane takes part.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV], int lane) {
#pragma unroll
  for (int n = NV, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = 16 / NV; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Work item r's start into spans[W r], where spans is given and the flag
// word is set; every lane of the warp calls it.
template <int W = 2>
__device__ __forceinline__ void stamp_row_start(
    const int* __restrict__ probe, unsigned long long* __restrict__ spans,
    int r, int lane) {
  if (spans == nullptr || __ldg(probe) == 0) return;
  if (lane == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    spans[W * static_cast<size_t>(r)] = t;
  }
}

// The calling warp's item's end into spans[W r + 1], and its W - 2 counts
// (c0, c1) after it, as stamp_row_start; the item (blockIdx.x * kWarps +
// warp) and the lane read afresh.
template <int W = 2>
__device__ __forceinline__ void stamp_row_end(
    const int* __restrict__ probe, unsigned long long* __restrict__ spans,
    int c0 = 0, int c1 = 0) {
  if (spans == nullptr || __ldg(probe) == 0) return;
  unsigned int cta, tid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  if ((tid & 31) == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* s =
        spans + W * (static_cast<size_t>(cta) * kWarps + (tid >> 5));
    s[1] = t;
    if (W > 2) s[2] = static_cast<unsigned>(c0);
    if (W > 3) s[3] = static_cast<unsigned>(c1);
  }
}

// The largest v over the warp's 32 lanes, every lane taking part: one
// integer reduction over keys that order as the floats do.
__device__ __forceinline__ float warp_max(float v) {
  const int i = __float_as_int(v);
  const int k = __reduce_max_sync(kFull, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The launchers' check of the probe arguments: both null or both given.
inline bool bad_probe(const int* probe, const unsigned long long* spans) {
  return (probe == nullptr) != (spans == nullptr);
}

// Feature columns per lane, rounded up to a power of two (HF <= 1024).
inline int cols_per_lane(int HF) {
  int nc = 1;
  while (32 * nc < HF) nc *= 2;
  return nc;
}

}  // namespace dgnn
