// Tie-sum backward of the dense EdgeConv max for NVIDIA Hopper (sm_90a):
//
//   d_src[b, j, f] = sum_i gq[b, i, f]
//                    [fl32(h_src[b, j, f] + mask[b, i, j]) == m[b, i, f]]
//
// with m = the forward's max (ops/ec_tiles.py masked_max), gq = g rounded
// to mul_dtype, the sum in float32 rounded once to mul_dtype.  It replaces
// dgnn_tpu/ops/edgeconv.py:_ecd_dsrc_ties, which is an XLA pass (a dense
// [B, Pj, Pi, Fc] indicator multiply), not a Pallas kernel; its plain
// version is ops/edgeconv.py _dsrc_ties (wrapper: tie_sum_bwd), which
// finds the pairs with torch.nonzero, a host sync that no CUDA graph takes.
// This kernel makes no host sync and allocates nothing.
//
// Bound on the H100: bytes.  The function must read the mask once (B P^2
// values) and m, h_src, g and write d_src once (4 B P F floats); a k-NN
// mask admits about k of P pairs a row, so the equality tests it needs are
// a twentieth of what those bytes take to move.
//
// Design.  A block owns one cloud b, a tile of kCols = 32 source columns j
// and a slab of up to kSlab = 256 feature columns: a warp a column j, the
// lanes over f (f = slab + lane + 32 v, v < NV), so that h_src[b, j, slab]
// and the column's NV sums a lane live in registers.  The block stages
// mask[b, i0 : i0 + kChunk, j0 : j0 + 32] (rows of 64 or 128 coalesced
// bytes) into shared memory, transposed and padded so that lane l of warp
// w reads row i0 + l of column w without a bank conflict, beside
// mmin[b, i] = min_f m[b, i, f] (the wrapper's amin); the next chunk's
// values are loaded into registers while the warps walk this one (5 to 23 %
// a call at DGCNN's widths on an H100, against staging after the walk).
// Each warp tests 32 rows i at once, a lane a row, by the plain version's
// filter
//
//     fl32(mask[i, j] + hmax_j) >= mmin[i]
//
// (hmax_j = the largest h_src[b, j, f] of the slab; rounded addition is
// monotone, so a pair that fails it has no hit in any f of the slab), and
// walks the rows that pass in ascending i (a ballot, then its set bits): a
// warp-uniform loop that loads m[b, i, slab] and g[b, i, slab] (from L2: a
// cloud's blocks are neighbours in the grid) and adds gq where the
// recomputed sum, with __fadd_rn (the forward's add, bit for bit), equals
// m.  The walk is dense in i, so a row that admits nothing (its max is
// about neg, and every pair of it ties), a row over masked_max's list cap,
// and any float mask need no special case.
//
// Deterministic: a fixed order (ascending i for each (j, f)), no atomics,
// d_src written once; two calls on the same inputs are equal bit for bit.
// Any B, P, F: the edges of the grid are masked, nothing is padded.
//
// Measured (H100, DGCNN's widths): 8 to 10 times the bytes bound.  Its
// time grows with F by about what the passing pairs' rows of m and g (F
// floats each, some 45 pairs a column) take to read from L2; what holds
// the rest (about 0.45 ms a call at any F) is not resolved.  The F = 256
// instance spills a few registers under the 1024-thread cap.
//
// Plain C interface (ctypes): the launcher returns cudaGetLastError().

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
template <typename MaskT, int NV, bool kBf16, int kUnroll>
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

template <typename MaskT, int NV, bool kBf16>
void launch_nv(const void* mask, const float* m, const float* hs,
               const float* g, const float* mmin, int B, int P, int F,
               float* dsrc, cudaStream_t s) {
  // NV * kUnroll (4 to 8) values each of m and g a lane in flight
  constexpr int kUnroll = NV >= 8 ? 1 : (NV >= 4 ? 2 : 4);
  const dim3 grid((P + kCols - 1) / kCols, B, (F + kSlab - 1) / kSlab);
  ec_tie_sum_kernel<MaskT, NV, kBf16, kUnroll><<<grid, kThreads, 0, s>>>(
      static_cast<const MaskT*>(mask), m, hs, g, mmin, P, F, dsrc);
}

template <typename MaskT, bool kBf16>
void launch_any(const void* mask, const float* m, const float* hs,
                const float* g, const float* mmin, int B, int P, int F,
                float* dsrc, cudaStream_t s) {
  const int width = F < kSlab ? F : kSlab;
  if (width <= 32)
    launch_nv<MaskT, 1, kBf16>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else if (width <= 64)
    launch_nv<MaskT, 2, kBf16>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else if (width <= 128)
    launch_nv<MaskT, 4, kBf16>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  else
    launch_nv<MaskT, 8, kBf16>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
}

}  // namespace

extern "C" {

// mask_bf16: 1 for a bfloat16 mask, 0 for float32.  mul_bf16: 1 rounds g
// and the sums to bfloat16 (mul_dtype bfloat16), 0 keeps float32.  mmin:
// [B, P] float32, the least m[b, i, f] over f.
int dgnn_ec_tie_sum(const void* mask, int mask_bf16, const float* m,
                    const float* hs, const float* g, const float* mmin,
                    int B, int P, int F, int mul_bf16, float* dsrc,
                    void* stream) {
  if (B < 1 || P < 1 || F < 1 || B > 65535 || (F + kSlab - 1) / kSlab > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_bf16) {
    if (mul_bf16)
      launch_any<__nv_bfloat16, true>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
    else
      launch_any<__nv_bfloat16, false>(mask, m, hs, g, mmin, B, P, F, dsrc,
                                       s);
  } else {
    if (mul_bf16)
      launch_any<float, true>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
    else
      launch_any<float, false>(mask, m, hs, g, mmin, B, P, F, dsrc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
