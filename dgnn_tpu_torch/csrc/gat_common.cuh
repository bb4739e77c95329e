// Device helpers shared by the GAT kernels (bin_gat.cu, dense_gat.cu).
//
// The attention-dropout hash re-derives dgnn_tpu/ops/common.py:pair_keep
// bit for bit in uint32 arithmetic:
//   base = mix32(dst * 0x9E3779B9 ^ mix32(src ^ seed * 0x85EBCA6B))
//   z    = mix32(base * H + h),  u = float(z >> 8) * 2^-24
// and a slot is kept iff u > p, kept weights scaled by float32(1 / (1 - p)).
//
// The kernels take the seed as a pointer to a uint32 in device memory and
// load it once, before their walk over the edges, as the TPU kernels read
// it from SMEM (dgnn_tpu/ops/pallas_bins.py): a step replayed from a CUDA
// graph then reads the seed that the step drew on the device, where a
// by-value argument would replay the seed of the capture.  The pointer may
// be null where p == 0.  bin_gat_fwd, bin_gat_bwd and dense_gat_fwd keep
// the seed in a register; dense_gat_bwd keeps it in shared memory and reads
// it at each use, which kept its <4, 2> instance as fast as with the seed
// passed by value (in a register it ran 5 % slower).

#pragma once

#include <stdint.h>

namespace dgnn {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Per-(dst, src) part of the hash, shared by every head of the pair.
__device__ __forceinline__ uint32_t pair_base(uint32_t seed, uint32_t dst,
                                              uint32_t src) {
  return mix32((dst * 0x9E3779B9u) ^ mix32(src ^ (seed * 0x85EBCA6Bu)));
}

// Uniform in [0, 1) for head h of a pair.
__device__ __forceinline__ float pair_u_head(uint32_t base, int H, int h) {
  const uint32_t z = mix32(base * static_cast<uint32_t>(H) +
                           static_cast<uint32_t>(h));
  return static_cast<float>(z >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float pair_u(uint32_t seed, uint32_t dst,
                                        uint32_t src, int H, int h) {
  return pair_u_head(pair_base(seed, dst, src), H, h);
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

}  // namespace dgnn
