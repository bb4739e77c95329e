// The tie-sum backward kernel as it stood before its redesign (the first
// form of dgnn_tpu_torch/csrc/ec_ties.cu: a block a cloud, 32 source
// columns and a 256-feature slab, the mask staged column-wise in 128-row
// chunks, each passing pair's rows of m and g read from L2), kept only
// for scripts/tie_sum_probe_torch.py, which times it beside the redesign.
// kWalk = false keeps the mask scan (staging, filter, ballot) and drops the
// walk over the passing rows: the scan's time alone.  Plain C interface:
// probe_tie_sum(..., walk, stream) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;              // source columns j a block: a warp each
constexpr int kThreads = kCols * 32;
constexpr int kChunk = 128;            // mask rows i staged at a time
constexpr int kStage = kChunk * kCols / kThreads;  // of them a thread
constexpr int kSlab = 256;             // feature columns a block: 8 a lane

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool kBf16>
__device__ __forceinline__ float round_mul(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// grid: (ceil(P / kCols), B, ceil(F / kSlab)).  NV: feature columns a lane
// (a power of two, 32 NV >= the slab's width).  kUnroll: passing rows
// loaded at once (their rows of m and g in flight together).
template <typename MaskT, int NV, bool kBf16, int kUnroll, bool kWalk>
__global__ void __launch_bounds__(kThreads) ec_tie_sum_kernel(
    const MaskT* __restrict__ mask,   // [B, P, P]
    const float* __restrict__ m,      // [B, P, F]
    const float* __restrict__ hs,     // [B, P, F]
    const float* __restrict__ g,      // [B, P, F]
    const float* __restrict__ mmin,   // [B, P]
    int P, int F,
    float* __restrict__ dsrc) {       // [B, P, F]
  __shared__ float mask_sh[kCols][kChunk + 1];
  __shared__ float mmin_sh[kChunk];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + w;
  const bool jok = j < P;
  const size_t cloud = static_cast<size_t>(blockIdx.y) * P;
  const int f0 = blockIdx.z * kSlab + lane;

  // the warp's source row; a lane's columns past F read column F - 1 (a
  // clamped address, never a load behind a branch) and are never stored
  int fc[NV];
  float h[NV], acc[NV];
  float hmax = -CUDART_INF_F;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = f0 + 32 * v;
    fc[v] = min(f, F - 1);
    h[v] = __ldg(hs + (cloud + min(j, P - 1)) * F + fc[v]);
    if (f < F) hmax = fmaxf(hmax, h[v]);
    acc[v] = 0.f;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    hmax = fmaxf(hmax, __shfl_xor_sync(0xffffffffu, hmax, o));

  // a chunk's mask values, kStage a thread: thread t holds column t % 32
  // of rows t / 32 + 32 u; rows and columns past P read -inf (never a pass
  // against the +inf mmin of a row past P).  The next chunk is loaded
  // while the warps walk this one.
  float pre[kStage];
  float pre_min = CUDART_INF_F;
  const int c = threadIdx.x % kCols;
  const int r0t = threadIdx.x / kCols;
  auto fetch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + r0t + u * (kThreads / kCols);
      pre[u] = (i < P && j0 + c < P)
                   ? widen(mask[(cloud + i) * P + j0 + c])
                   : -CUDART_INF_F;
    }
    if (threadIdx.x < kChunk)
      pre_min = i0 + threadIdx.x < P ? __ldg(mmin + cloud + i0 + threadIdx.x)
                                     : CUDART_INF_F;
  };
  fetch(0);

  for (int i0 = 0; i0 < P; i0 += kChunk) {
    __syncthreads();  // every warp is done with the previous chunk
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      mask_sh[c][r0t + u * (kThreads / kCols)] = pre[u];
    if (threadIdx.x < kChunk) mmin_sh[threadIdx.x] = pre_min;
    __syncthreads();
    if (i0 + kChunk < P) fetch(i0 + kChunk);
    if (!jok) continue;  // the whole warp; it still joins the barriers

    for (int r0 = 0; r0 < kChunk && i0 + r0 < P; r0 += 32) {
      const bool pass =
          __fadd_rn(mask_sh[w][r0 + lane], hmax) >= mmin_sh[r0 + lane];
      unsigned bits = __ballot_sync(0xffffffffu, pass);
      if constexpr (!kWalk) {
        acc[0] += static_cast<float>(__popc(bits));
        bits = 0;
      }
      while (bits) {
        int rr[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          live[u] = bits != 0;
          rr[u] = live[u] ? r0 + __ffs(bits) - 1 : rr[0];
          bits &= bits - 1;
        }
        float mv[kUnroll][NV], gv[kUnroll][NV];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t row = (cloud + i0 + rr[u]) * F;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            mv[u][v] = __ldg(m + row + fc[v]);
            gv[u][v] = __ldg(g + row + fc[v]);
          }
        }
        // in ascending i: u = 0 first
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!live[u]) break;  // warp-uniform
          const float mk = mask_sh[w][rr[u]];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const bool hit = __fadd_rn(h[v], mk) == mv[u][v];
            acc[v] += hit ? round_mul<kBf16>(gv[u][v]) : 0.f;
          }
        }
      }
    }
  }
  if (!jok) return;
  float* out = dsrc + (cloud + j) * F;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int f = f0 + 32 * v;
    if (f < F) out[f] = round_mul<kBf16>(acc[v]);
  }
}

template <typename MaskT, int NV, bool kBf16, bool kWalk>
void launch_nv(const void* mask, const float* m, const float* hs,
               const float* g, const float* mmin, int B, int P, int F,
               float* dsrc, cudaStream_t s) {
  // NV * kUnroll (4 to 8) values each of m and g a lane in flight
  constexpr int kUnroll = NV >= 8 ? 1 : (NV >= 4 ? 2 : 4);
  const dim3 grid((P + kCols - 1) / kCols, B, (F + kSlab - 1) / kSlab);
  ec_tie_sum_kernel<MaskT, NV, kBf16, kUnroll, kWalk><<<grid, kThreads, 0, s>>>(
      static_cast<const MaskT*>(mask), m, hs, g, mmin, P, F, dsrc);
}

template <typename MaskT, bool kBf16, bool kWalk>
void launch_any(const void* mask, const float* m, const float* hs,
                const float* g, const float* mmin, int B, int P, int F,
                float* dsrc, cudaStream_t s) {
  const int width = F < kSlab ? F : kSlab;
  if (width <= 32)
    launch_nv<MaskT, 1, kBf16, kWalk>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else if (width <= 64)
    launch_nv<MaskT, 2, kBf16, kWalk>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else if (width <= 128)
    launch_nv<MaskT, 4, kBf16, kWalk>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else
    launch_nv<MaskT, 8, kBf16, kWalk>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
}

}  // namespace

extern "C" {

// mask_bf16 / mul_bf16 as the package's launcher; walk: 0 scans the mask
// only (the sums are then not d_src).
int probe_tie_sum(const void* mask, int mask_bf16, const float* m,
                  const float* hs, const float* g, const float* mmin, int B,
                  int P, int F, int mul_bf16, int walk, float* dsrc,
                  void* stream) {
  if (B < 1 || P < 1 || F < 1 || B > 65535 || (F + kSlab - 1) / kSlab > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mask_bf16 || !mul_bf16)  // the model's case only
    return static_cast<int>(cudaErrorInvalidValue);
  if (walk)
    launch_any<__nv_bfloat16, true, true>(mask, m, hs, g, mmin, B, P, F, dsrc,
                                          s);
  else
    launch_any<__nv_bfloat16, true, false>(mask, m, hs, g, mmin, B, P, F,
                                           dsrc, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
