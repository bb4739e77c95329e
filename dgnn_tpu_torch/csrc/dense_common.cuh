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
constexpr int kPassWords = 32;         // mask words compacted per pass
constexpr int kListCap = kPassWords * 32;  // set columns per pass, at most
constexpr unsigned kFull = 0xffffffffu;

// Round to bf16 (nearest even) and back, as the TPU kernels' matmul operands.
__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Compacts the set columns of mask words [w0, w0 + 32) of one tile row into
// cols[0 .. kListCap), in increasing word order; returns how many there are.
// Called by a whole warp; cols is the warp's own list in shared memory.
__device__ __forceinline__ int compact_pass(const uint32_t* mrow, int w0,
                                            int lane, unsigned short* cols) {
  const uint32_t word = mrow[w0 + lane];
  const int cnt = __popc(word);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int at = incl - cnt;
  uint32_t bits = word;
  const int byte0 = (w0 + lane) * 4;
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    // bit b of the (little-endian) word: byte byte0 + b / 8, plane b % 8
    cols[at++] = static_cast<unsigned short>((b & 7) * (kCT / 8) + byte0 +
                                             (b >> 3));
  }
  __syncwarp();
  return total;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Feature columns per lane, rounded up to a power of two (HF <= 1024).
inline int cols_per_lane(int HF) {
  int nc = 1;
  while (32 * nc < HF) nc *= 2;
  return nc;
}

}  // namespace dgnn
