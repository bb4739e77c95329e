// Degree-binned GAT passes for NVIDIA Hopper (sm_90a), float32.
//
// Two kernels, one thread block per segment (one row's <= W neighbour
// slots, `count` of them valid), threads over the H*F feature columns:
//
//   bin_gat_fwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gat_fwd_kernel
//     (wrapper bin_gat_fwd).  Over the CSR bins (rows = destinations): the
//     exact per-head maximum m of s = LeakyReLU(ar[row] + ac[src]), then
//     l = sum exp(s - m) and acc = sum p^ * x[src]; with_pos adds lpos and
//     accpos restricted to raw score ar + ac >= 0.  Attention dropout drops
//     the weight in acc / accpos only, never in l / lpos.  An empty segment
//     gives m = -1e30 and zero partials.
//
//   bin_gat_bwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gat_bwd_kernel
//     (wrapper bin_gat_bwd).  Over the CSC bins (rows = sources j, slots =
//     destinations i): a = exp(s - M[i]) * Linv[i], a^ = dropout(a),
//       dx[j]  = sum a^ * g[i]
//       dac[j] = <x[j], sum a^ d' g[i]> - sum a d' ws[i]     (d' = LeakyReLU')
//
// Unlike the TPU kernels, these gather for themselves: they read x[nbr],
// ac[nbr] (forward) and g / ar / M / Linv / ws [nbr] (backward) straight
// from the node tables given the slot table nbr [S, W]; no pre-gathered
// [W, S, C] block, no concatenated scalar columns, no width cap.
//
// Bound on the H100: the bytes gathered per slot.  Each valid slot reads
// one feature row of H*F floats (1 KB at H=4, F=64) plus H scalars per
// table, from rows scattered over the node table; the arithmetic per byte
// is a few flops.  A block's threads read one row with consecutive threads
// on consecutive columns, so each row read is coalesced.
//
// Left for later PRs: warp-per-segment blocks for narrow bins (a W=4 bin
// leaves most of a 256-thread block idle in the score phase), cp.async /
// TMA prefetch of the next slots' rows, bf16 feature rows, and fusing the
// segment merge (ops/common.py combine_lse / combine_sum) into the kernel.
//
// Dropout re-derives dgnn_tpu/ops/common.py:pair_keep bit for bit
// (gat_common.cuh).  Forward: dst = segment row, src = slot; backward:
// dst = slot, src = segment row.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_common.cuh"

namespace {

using dgnn::leaky;
using dgnn::pair_u;

constexpr int kMaxHeads = 16;    // the wrapper refuses H > kMaxHeads
constexpr int kChunk = 32;       // slots staged in shared memory at a time
constexpr int kMaxThreads = 1024;
constexpr float kNegB = -1e30f;  // finite "-inf": max of an empty segment

__global__ void bin_gat_fwd_kernel(
    const float* __restrict__ x,      // [N, H*F] source features
    const float* __restrict__ ac,     // [N, H]   source coefficients
    const float* __restrict__ ar,     // [Nr, H]  destination coefficients
    const int* __restrict__ nbr,      // [S, W]
    const int* __restrict__ row,      // [S]
    const int* __restrict__ count,    // [S]
    int W, int H, int F, float slope, int with_pos, float p, float inv_keep,
    uint32_t seed,
    float* __restrict__ m_out,        // [S, H]
    float* __restrict__ l_out,        // [S, H]
    float* __restrict__ lpos_out,     // [S, H]    (with_pos)
    float* __restrict__ acc_out,      // [S, H*F]
    float* __restrict__ accpos_out) { // [S, H*F]  (with_pos)
  __shared__ float ar_sh[kMaxHeads];
  __shared__ float m_sh[kMaxHeads];
  __shared__ float l_sh[kMaxHeads];
  __shared__ float lpos_sh[kMaxHeads];
  __shared__ float red[kMaxHeads][kMaxThreads / 32];
  __shared__ int nbr_sh[kChunk];
  __shared__ float p_sh[kChunk * kMaxHeads];    // softmax numerator
  __shared__ float pd_sh[kChunk * kMaxHeads];   // after dropout
  __shared__ unsigned char pos_sh[kChunk * kMaxHeads];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int HF = H * F;
  const int cnt = count[s];
  const int r = row[s];
  const int* nb = nbr + static_cast<size_t>(s) * W;
  const bool drop = p > 0.f;

  if (tid < H) {
    ar_sh[tid] = ar[static_cast<size_t>(r) * H + tid];
    l_sh[tid] = 0.f;
    lpos_sh[tid] = 0.f;
  }
  __syncthreads();

  // Phase 1: exact per-head maximum, threads over slots.
  float mloc[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) mloc[h] = kNegB;
  for (int w = tid; w < cnt; w += nthreads) {
    const float* acj = ac + static_cast<size_t>(nb[w]) * H;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < H) mloc[h] = fmaxf(mloc[h], leaky(ar_sh[h] + acj[h], slope));
    }
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < H) {
      float v = mloc[h];
      for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) red[h][warp] = v;
    }
  }
  __syncthreads();
  if (tid < H) {
    float v = kNegB;
    for (int i = 0; i < nwarps; ++i) v = fmaxf(v, red[tid][i]);
    m_sh[tid] = v;
  }
  __syncthreads();

  // Phase 2: sums and weighted accumulation, threads over columns; slots
  // are staged kChunk at a time with their per-head weights.
  for (int c0 = 0; c0 < HF; c0 += nthreads) {
    const int c = c0 + tid;
    const bool active = c < HF;
    const int hc = active ? c / F : 0;
    float acc = 0.f, accpos = 0.f;
    for (int w0 = 0; w0 < cnt; w0 += kChunk) {
      const int nch = min(kChunk, cnt - w0);
      __syncthreads();  // the previous chunk's readers are done
      if (tid < nch) nbr_sh[tid] = nb[w0 + tid];
      __syncthreads();
      for (int idx = tid; idx < nch * H; idx += nthreads) {
        const int wl = idx / H;
        const int h = idx - wl * H;
        const int j = nbr_sh[wl];
        const float sr = ar_sh[h] + ac[static_cast<size_t>(j) * H + h];
        const float pw = expf(leaky(sr, slope) - m_sh[h]);
        float pd = pw;
        if (drop) {
          const float u = pair_u(seed, static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(j), H, h);
          pd = u > p ? pw * inv_keep : 0.f;
        }
        p_sh[idx] = pw;
        pd_sh[idx] = pd;
        pos_sh[idx] = sr >= 0.f;
      }
      __syncthreads();
      if (c0 == 0 && tid < H) {
        for (int wl = 0; wl < nch; ++wl) {
          const float pw = p_sh[wl * H + tid];
          l_sh[tid] += pw;
          if (pos_sh[wl * H + tid]) lpos_sh[tid] += pw;
        }
      }
      if (active) {
        for (int wl = 0; wl < nch; ++wl) {
          const float xv = x[static_cast<size_t>(nbr_sh[wl]) * HF + c];
          const float t = pd_sh[wl * H + hc] * xv;
          acc += t;
          if (pos_sh[wl * H + hc]) accpos += t;
        }
      }
    }
    if (active) {
      acc_out[static_cast<size_t>(s) * HF + c] = acc;
      if (with_pos) accpos_out[static_cast<size_t>(s) * HF + c] = accpos;
    }
  }
  __syncthreads();
  if (tid < H) {
    const size_t o = static_cast<size_t>(s) * H + tid;
    m_out[o] = m_sh[tid];
    l_out[o] = l_sh[tid];
    if (with_pos) lpos_out[o] = lpos_sh[tid];
  }
}

__global__ void bin_gat_bwd_kernel(
    const float* __restrict__ g,      // [Nd, H*F] grad of the output
    const float* __restrict__ ar,     // [Nd, H]
    const float* __restrict__ Mx,     // [Nd, H]   merged softmax maximum
    const float* __restrict__ Linv,   // [Nd, H]   1 / max(L, 1e-20)
    const float* __restrict__ ws,     // [Nd, H]   <g, out> per destination
    const float* __restrict__ ac,     // [Ns, H]   source coefficients
    const float* __restrict__ x,      // [Ns, H*F] source features
    const int* __restrict__ nbr,      // [S, W]    destination ids
    const int* __restrict__ row,      // [S]       source id
    const int* __restrict__ count,    // [S]
    int W, int H, int F, float slope, float p, float inv_keep, uint32_t seed,
    float* __restrict__ dx_out,       // [S, H*F]
    float* __restrict__ dac_out) {    // [S, H]
  __shared__ float ac_sh[kMaxHeads];
  __shared__ float u2_sh[kMaxHeads];
  __shared__ float dac_sh[kMaxHeads];
  __shared__ int nbr_sh[kChunk];
  __shared__ float ah_sh[kChunk * kMaxHeads];    // a^
  __shared__ float ahd_sh[kChunk * kMaxHeads];   // a^ d'
  __shared__ float u_sh[kChunk * kMaxHeads];     // a d' ws
  __shared__ float xt_sh[kMaxThreads];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int HF = H * F;
  const int cnt = count[s];
  const int r = row[s];
  const int* nb = nbr + static_cast<size_t>(s) * W;
  const bool drop = p > 0.f;

  if (tid < H) {
    ac_sh[tid] = ac[static_cast<size_t>(r) * H + tid];
    u2_sh[tid] = 0.f;
    dac_sh[tid] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < HF; c0 += nthreads) {
    const int c = c0 + tid;
    const bool active = c < HF;
    const int hc = active ? c / F : 0;
    float dx = 0.f, t = 0.f;
    for (int w0 = 0; w0 < cnt; w0 += kChunk) {
      const int nch = min(kChunk, cnt - w0);
      __syncthreads();
      if (tid < nch) nbr_sh[tid] = nb[w0 + tid];
      __syncthreads();
      for (int idx = tid; idx < nch * H; idx += nthreads) {
        const int wl = idx / H;
        const int h = idx - wl * H;
        const size_t ih = static_cast<size_t>(nbr_sh[wl]) * H + h;
        const float sr = ar[ih] + ac_sh[h];
        const float a = expf(leaky(sr, slope) - Mx[ih]) * Linv[ih];
        float ah = a;
        if (drop) {
          const float u = pair_u(seed, static_cast<uint32_t>(nbr_sh[wl]),
                                 static_cast<uint32_t>(r), H, h);
          ah = u > p ? a * inv_keep : 0.f;
        }
        const float dp = sr >= 0.f ? 1.f : slope;
        ah_sh[idx] = ah;
        ahd_sh[idx] = ah * dp;
        u_sh[idx] = a * dp * ws[ih];
      }
      __syncthreads();
      if (c0 == 0 && tid < H) {
        for (int wl = 0; wl < nch; ++wl) u2_sh[tid] += u_sh[wl * H + tid];
      }
      if (active) {
        for (int wl = 0; wl < nch; ++wl) {
          const float gv = g[static_cast<size_t>(nbr_sh[wl]) * HF + c];
          dx += ah_sh[wl * H + hc] * gv;
          t += ahd_sh[wl * H + hc] * gv;
        }
      }
    }
    if (active) {
      dx_out[static_cast<size_t>(s) * HF + c] = dx;
      xt_sh[tid] = x[static_cast<size_t>(r) * HF + c] * t;
    }
    __syncthreads();
    // per-head sum of x * t over this tile's columns of head `tid`
    if (tid < H) {
      const int lo = max(c0, tid * F);
      const int hi = min(min(c0 + nthreads, HF), (tid + 1) * F);
      float acc = 0.f;
      for (int cc = lo; cc < hi; ++cc) acc += xt_sh[cc - c0];
      dac_sh[tid] += acc;
    }
    __syncthreads();
  }
  if (tid < H) dac_out[static_cast<size_t>(s) * H + tid] = dac_sh[tid] - u2_sh[tid];
}

int block_threads(int HF) {
  const int t = ((HF + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

extern "C" {

int dgnn_bin_gat_fwd(const float* x, const float* ac, const float* ar,
                     const int* nbr, const int* row, const int* count, int S,
                     int W, int H, int F, float slope, int with_pos, float p,
                     float inv_keep, uint32_t seed, float* m, float* l,
                     float* lpos, float* acc, float* accpos, void* stream) {
  if (S > 0) {
    bin_gat_fwd_kernel<<<S, block_threads(H * F), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, ac, ar, nbr, row, count, W, H, F, slope, with_pos, p, inv_keep,
        seed, m, l, lpos, acc, accpos);
  }
  return static_cast<int>(cudaGetLastError());
}

int dgnn_bin_gat_bwd(const float* g, const float* ar, const float* M,
                     const float* Linv, const float* ws, const float* ac,
                     const float* x, const int* nbr, const int* row,
                     const int* count, int S, int W, int H, int F, float slope,
                     float p, float inv_keep, uint32_t seed, float* dx,
                     float* dac, void* stream) {
  if (S > 0) {
    bin_gat_bwd_kernel<<<S, block_threads(H * F), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        g, ar, M, Linv, ws, ac, x, nbr, row, count, W, H, F, slope, p,
        inv_keep, seed, dx, dac);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
