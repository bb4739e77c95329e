// Masked neighbour max over dense per-cloud masks for NVIDIA Hopper
// (sm_90a):
//
//   out[b, i, f] = max_j (mask[b, i, j] + hs[b, j, f])
//   idx[b, i, f] = the first j that reaches it            (optional)
//
// Replaces scripts/exp_r5_ec_tiles.py:pallas_tiles (kernel _kern, schedule
// "step1": one candidate column j per inner step) and :pallas_tiles2
// (_kern2, schedule "step8": eight mask values and eight hs rows held in
// registers per step).  It is the function of
// dgnn_tpu/ops/edgeconv.py:_masked_max / _masked_max_argmax, the hot loop
// of every DGCNN layer (wrapper ops/ec_tiles.py masked_max).
//
// A thread block owns kTI rows x kTF feature columns of one cloud and walks
// all of the cloud's candidate columns in tiles of kTJ, staging the mask
// tile (widened to float32, transposed so that a thread's four rows are one
// 16-byte read) and the hs tile in shared memory.  A thread keeps a 4 x 4
// patch of running maxima (and first-winner indices) in registers over the
// whole walk: no atomics, and `out` is written once (the TPU grid re-read
// and re-wrote `out` at every column tile).  The mask is ADDED, in float32,
// never selected on, and the running max starts at -inf, so every row, one
// that admits nothing included, gets exactly max_j(mask + hs).  Any B, P, F:
// the ragged last tiles are bounded inside the kernel.
//
// Bound on the H100: the dense form does P float32 adds and P maxima per
// output element, whatever the mask admits (at P = 1024, k = 40 about 22
// times the admitted candidates), so it is bound by float32 operations on
// the CUDA cores, far above the bytes of mask, hs and out.  Left for later
// PRs: skipping column tiles that admit nothing for the block's rows,
// double-buffered staging (cp.async / TMA), and packed half2 arithmetic.
//
// Plain C interface (ctypes): the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTI = 64;       // rows of a block
constexpr int kTF = 64;       // feature columns of a block
constexpr int kTJ = 64;       // candidate columns staged at a time
constexpr int kThreads = 256; // 16 row groups x 16 feature groups of 4 x 4
constexpr int kMaskStride = kTI + 4;  // floats; keeps 16-byte alignment

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One candidate column: v = mask + hs, a running strictly-greater max.
template <bool kIndex>
__device__ __forceinline__ void candidate(const float4& mk, const float4& hv,
                                          int j, float (&m)[4][4],
                                          int (&ix)[4][4]) {
  const float mr[4] = {mk.x, mk.y, mk.z, mk.w};
  const float hf[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = __fadd_rn(mr[r], hf[c]);
      if (kIndex) {
        if (v > m[r][c]) {
          m[r][c] = v;
          ix[r][c] = j;
        }
      } else {
        m[r][c] = fmaxf(m[r][c], v);
      }
    }
  }
}

template <typename MaskT, int kStep, bool kIndex>
__global__ void __launch_bounds__(kThreads) ec_masked_max_kernel(
    const MaskT* __restrict__ mask,  // [B, P, P]
    const float* __restrict__ hs,    // [B, P, F]
    int P, int F,
    float* __restrict__ out,         // [B, P, F]
    int* __restrict__ idx) {         // [B, P, F] or null
  __shared__ __align__(16) float mask_sh[kTJ * kMaskStride];  // [j][i]
  __shared__ __align__(16) float hs_sh[kTJ * kTF];            // [j][f]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // feature group
  const int ty = tid >> 4;   // row group
  const int f0 = blockIdx.x * kTF;
  const int i0 = blockIdx.y * kTI;
  const size_t b = blockIdx.z;
  const MaskT* mask_b = mask + b * P * P;
  const float* hs_b = hs + b * P * F;

  float m[4][4];
  int ix[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[r][c] = -CUDART_INF_F;
      ix[r][c] = 0;
    }
  }

  for (int j0 = 0; j0 < P; j0 += kTJ) {
    const int nj = min(kTJ, P - j0);
    __syncthreads();  // the previous tile's readers are done
    // mask tile: consecutive threads on consecutive j (coalesced), stored
    // transposed; rows past P read as 0 and are never written out
    for (int e = tid; e < kTI * kTJ; e += kThreads) {
      const int i = e / kTJ;
      const int j = e - i * kTJ;
      float v = 0.f;
      if (i0 + i < P && j < nj)
        v = widen(mask_b[static_cast<size_t>(i0 + i) * P + j0 + j]);
      mask_sh[j * kMaskStride + i] = v;
    }
    for (int e = tid; e < kTJ * kTF; e += kThreads) {
      const int j = e / kTF;
      const int f = e - j * kTF;
      float v = 0.f;
      if (j < nj && f0 + f < F)
        v = hs_b[static_cast<size_t>(j0 + j) * F + f0 + f];
      hs_sh[e] = v;
    }
    __syncthreads();

    const float4* mk4 = reinterpret_cast<const float4*>(mask_sh) + ty;
    const float4* hv4 = reinterpret_cast<const float4*>(hs_sh) + tx;
    int j = 0;
    if (kStep == 8) {
      for (; j + 8 <= nj; j += 8) {
        float4 mk[8], hv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          mk[u] = mk4[(j + u) * (kMaskStride / 4)];
          hv[u] = hv4[(j + u) * (kTF / 4)];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          candidate<kIndex>(mk[u], hv[u], j0 + j + u, m, ix);
      }
    }
    // "step1", and the columns "step8" leaves when nj is no multiple of 8
#pragma unroll 1
    for (; j < nj; ++j) {
      candidate<kIndex>(mk4[j * (kMaskStride / 4)], hv4[j * (kTF / 4)],
                        j0 + j, m, ix);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= P) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + tx * 4 + c;
      if (f >= F) continue;
      const size_t o = (b * P + i) * F + f;
      out[o] = m[r][c];
      if (kIndex) idx[o] = ix[r][c];
    }
  }
}

template <typename MaskT, int kStep>
void launch(const void* mask, const float* hs, int B, int P, int F,
            float* out, int* idx, cudaStream_t stream) {
  const dim3 grid((F + kTF - 1) / kTF, (P + kTI - 1) / kTI, B);
  const MaskT* mk = static_cast<const MaskT*>(mask);
  if (idx != nullptr) {
    ec_masked_max_kernel<MaskT, kStep, true>
        <<<grid, kThreads, 0, stream>>>(mk, hs, P, F, out, idx);
  } else {
    ec_masked_max_kernel<MaskT, kStep, false>
        <<<grid, kThreads, 0, stream>>>(mk, hs, P, F, out, idx);
  }
}

}  // namespace

extern "C" {

// mask_bf16: 1 for a bfloat16 mask, 0 for float32.  step: 1 or 8.  idx may
// be null (no first-winner index).
int dgnn_ec_masked_max(const void* mask, int mask_bf16, const float* hs,
                       int B, int P, int F, int step, float* out, int* idx,
                       void* stream) {
  if (B < 1 || P < 1 || F < 1 || B > 65535 || (P + kTI - 1) / kTI > 65535 ||
      (step != 1 && step != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_bf16) {
    if (step == 8)
      launch<__nv_bfloat16, 8>(mask, hs, B, P, F, out, idx, s);
    else
      launch<__nv_bfloat16, 1>(mask, hs, B, P, F, out, idx, s);
  } else {
    if (step == 8)
      launch<float, 8>(mask, hs, B, P, F, out, idx, s);
    else
      launch<float, 1>(mask, hs, B, P, F, out, idx, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
