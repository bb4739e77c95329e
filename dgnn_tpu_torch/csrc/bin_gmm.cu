// Degree-binned MoNet (GMMConv, node-derived pseudo-coordinates) passes for
// NVIDIA Hopper (sm_90a), float32.
//
// Two kernels, one thread block per segment (one row's <= W neighbour
// slots, `count` of them valid), threads over the K*F feature columns:
//
//   bin_gmm_fwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gmm_fwd_kernel
//     (wrapper bin_gmm_node_fwd).  Over the CSR bins (rows = destinations v,
//     slots = sources u): p_d = [tanh](beta_d[v] + alpha_d[u]), the K
//     Gaussian weights w_k of gmm_common.cuh, and
//       acc[v, k, :] = sum_u w_k x[u, k, :].
//     Plain sums: an empty segment gives zeros.
//
//   bin_gmm_bwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gmm_bwd_kernel
//     (wrapper bin_gmm_node_bwd).  Over the CSC bins (rows = sources u,
//     slots = destinations v):
//       dx[u, k, :] = sum_v w_k g[v, k, :]
//     and, with c_k = w_k <x[u, k, :], g[v, k, :]>, the per-segment stat row
//       [0, KD)            sum c_k t_kd
//       [KD, 2KD)          sum c_k t_kd (p_d - mu_kd)
//       [2KD, +D)          sum dpre_d
//       [.., +D*Dd)        sum dpre_d dfeat_i[v]        (index d * Dd + i)
//       [.., +D*Ds)        sum dpre_d sfeat_i[u]        (index d * Ds + i)
//     where dp_d = -sum_k c_k t_kd isig_kd and dpre_d = dp_d (1 - p_d^2)
//     under tanh (dp_d without).  The caller reduces the rows over segments
//     into the gradients of mu, inv_sigma and the pseudo projection.
//
// Every stat is linear in the dot products <x, g_v>, so the kernel never
// reduces a dot product per slot: each column thread accumulates
//   A_a[c] = sum_v coef_a[v, k(c)] g[v, c]
// for the NA = 3D + D*Dd coefficient sets
//   w t_d | w t_d (p_d - mu_d) | e_d = -w t_d isig_d (1 - p_d^2) | e_d dfeat_i
// and the segment's own row x[u] is multiplied in once at the end:
//   stat_a[k] = sum_{c in kernel k} x[u, c] A_a[c],
// summed over k for the dpre columns.  The sfeat block is the dpre block
// times the segment's own sfeat[u].
//
// Like bin_gat.cu these kernels gather for themselves from the node tables
// given the slot table nbr [S, W]: no pre-gathered [W, S, C] block, no
// concatenated alpha / beta / dfeat columns, no width cap, and the weight of
// kernel k is broadcast over its F columns (no expander matmul).
//
// Bound on the H100: the bytes gathered per slot, one row of K*F floats
// (768 B at K=3, F=64) from rows scattered over the node table, read with
// consecutive threads on consecutive columns; the backward adds NA
// multiply-adds per gathered float.  Left for later PRs: warp-per-segment
// blocks for narrow bins, prefetch of the next slots' rows, and fusing the
// segment merge (ops/common.py combine_sum).
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_common.cuh"

namespace {

using dgnn::gmm_coords;
using dgnn::gmm_weight;
using dgnn::kGmmMaxD;
using dgnn::kGmmMaxDd;
using dgnn::kGmmMaxK;
using dgnn::kGmmMaxKD;

constexpr int kChunk = 32;       // slots staged in shared memory at a time
constexpr int kMaxThreads = 1024;  // the wrapper refuses K*F > kMaxThreads
// Coefficient sets per thread, NA = 3D + D*Dd: 8 at the models' D = 2,
// Dd = 1.  The wrapper refuses more.
constexpr int kMaxCoef = 8;

__global__ void __launch_bounds__(kMaxThreads) bin_gmm_fwd_kernel(
    const float* __restrict__ x,      // [N, K*F] source features
    const float* __restrict__ alpha,  // [N, D]   source-side projection
    const float* __restrict__ beta,   // [Nr, D]  destination-side projection
    const int* __restrict__ nbr,      // [S, W]
    const int* __restrict__ row,      // [S]
    const int* __restrict__ count,    // [S]
    const float* __restrict__ mu,     // [K, D]
    const float* __restrict__ isig,   // [K, D]
    int W, int K, int D, int F, int use_tanh,
    float* __restrict__ acc_out) {    // [S, K*F]
  __shared__ float mu_sh[kGmmMaxKD];
  __shared__ float isig_sh[kGmmMaxKD];
  __shared__ float beta_sh[kGmmMaxD];
  __shared__ int nbr_sh[kChunk];
  __shared__ float w_sh[kChunk * kGmmMaxK];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int KF = K * F;
  const int cnt = count[s];
  const int r = row[s];
  const int* nb = nbr + static_cast<size_t>(s) * W;
  const bool active = tid < KF;
  const int kc = active ? tid / F : 0;

  if (tid < K * D) {
    mu_sh[tid] = mu[tid];
    isig_sh[tid] = isig[tid];
  }
  if (tid < D) beta_sh[tid] = beta[static_cast<size_t>(r) * D + tid];

  float acc = 0.f;
  for (int w0 = 0; w0 < cnt; w0 += kChunk) {
    const int nch = min(kChunk, cnt - w0);
    __syncthreads();  // the previous chunk's readers are done
    if (tid < nch) nbr_sh[tid] = nb[w0 + tid];
    __syncthreads();
    // one (slot, kernel) pair per thread: the Gaussian weight
    for (int idx = tid; idx < nch * K; idx += nthreads) {
      const int wl = idx / K;
      const int k = idx - wl * K;
      float p[kGmmMaxD], diff[kGmmMaxD], t[kGmmMaxD];
      gmm_coords(beta_sh, alpha + static_cast<size_t>(nbr_sh[wl]) * D, D,
                 use_tanh != 0, p);
      w_sh[idx] = gmm_weight(p, mu_sh + k * D, isig_sh + k * D, D, diff, t);
    }
    __syncthreads();
    if (active) {
      for (int wl = 0; wl < nch; ++wl) {
        acc += w_sh[wl * K + kc] *
               x[static_cast<size_t>(nbr_sh[wl]) * KF + tid];
      }
    }
  }
  if (active) acc_out[static_cast<size_t>(s) * KF + tid] = acc;
}

__global__ void __launch_bounds__(kMaxThreads) bin_gmm_bwd_kernel(
    const float* __restrict__ g,      // [Nd, K*F] grad of the output
    const float* __restrict__ beta,   // [Nd, D]   destination-side projection
    const float* __restrict__ dfeat,  // [Nd, Dd]  raw destination scalars
    const float* __restrict__ alpha,  // [Ns, D]   source-side projection
    const float* __restrict__ x,      // [Ns, K*F] source features
    const float* __restrict__ sfeat,  // [Ns, Ds]  raw source scalars
    const int* __restrict__ nbr,      // [S, W]    destination ids
    const int* __restrict__ row,      // [S]       source id
    const int* __restrict__ count,    // [S]
    const float* __restrict__ mu,     // [K, D]
    const float* __restrict__ isig,   // [K, D]
    int W, int K, int D, int Dd, int Ds, int F, int use_tanh,
    float* __restrict__ dx_out,       // [S, K*F]
    float* __restrict__ st_out) {     // [S, 2KD + D + D*Dd + D*Ds]
  __shared__ float mu_sh[kGmmMaxKD];
  __shared__ float isig_sh[kGmmMaxKD];
  __shared__ float alpha_sh[kGmmMaxD];
  __shared__ int nbr_sh[kChunk];
  __shared__ float w_sh[kChunk * kGmmMaxK];
  __shared__ float cf_sh[kChunk * kGmmMaxK * kMaxCoef];  // [slot][k][a]
  __shared__ float xt_sh[kMaxThreads];
  __shared__ float part_sh[kMaxCoef * kGmmMaxK];         // [a][k]

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int KF = K * F;
  const int KD = K * D;
  const int NA = 3 * D + D * Dd;
  const int cnt = count[s];
  const int r = row[s];
  const int* nb = nbr + static_cast<size_t>(s) * W;
  const bool active = tid < KF;
  const int kc = active ? tid / F : 0;
  const bool tanh_on = use_tanh != 0;

  if (tid < KD) {
    mu_sh[tid] = mu[tid];
    isig_sh[tid] = isig[tid];
  }
  if (tid < D) alpha_sh[tid] = alpha[static_cast<size_t>(r) * D + tid];

  float dx = 0.f;
  float A[kMaxCoef];
#pragma unroll
  for (int a = 0; a < kMaxCoef; ++a) A[a] = 0.f;

  for (int w0 = 0; w0 < cnt; w0 += kChunk) {
    const int nch = min(kChunk, cnt - w0);
    __syncthreads();  // the previous chunk's readers are done
    if (tid < nch) nbr_sh[tid] = nb[w0 + tid];
    __syncthreads();
    // one (slot, kernel) pair per thread: its weight and coefficient sets
    for (int idx = tid; idx < nch * K; idx += nthreads) {
      const int wl = idx / K;
      const int k = idx - wl * K;
      const size_t j = static_cast<size_t>(nbr_sh[wl]);
      float p[kGmmMaxD], diff[kGmmMaxD], t[kGmmMaxD];
      gmm_coords(alpha_sh, beta + j * D, D, tanh_on, p);
      const float w =
          gmm_weight(p, mu_sh + k * D, isig_sh + k * D, D, diff, t);
      w_sh[idx] = w;
      float* cf = cf_sh + idx * NA;
#pragma unroll
      for (int d = 0; d < kGmmMaxD; ++d) {
        if (d < D) {
          const float wt = w * t[d];
          cf[d] = wt;
          cf[D + d] = wt * diff[d];
          float e = -wt * isig_sh[k * D + d];
          if (tanh_on) e *= 1.f - p[d] * p[d];
          cf[2 * D + d] = e;
          for (int i = 0; i < Dd; ++i) {
            cf[3 * D + d * Dd + i] = e * dfeat[j * Dd + i];
          }
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int wl = 0; wl < nch; ++wl) {
        const float gv = g[static_cast<size_t>(nbr_sh[wl]) * KF + tid];
        dx += w_sh[wl * K + kc] * gv;
        const float* cf = cf_sh + (wl * K + kc) * NA;
#pragma unroll
        for (int a = 0; a < kMaxCoef; ++a) {
          if (a < NA) A[a] += cf[a] * gv;
        }
      }
    }
  }

  float xv = 0.f;
  if (active) {
    dx_out[static_cast<size_t>(s) * KF + tid] = dx;
    xv = x[static_cast<size_t>(r) * KF + tid];
  }
  // part[a][k] = sum over kernel k's columns of x * A_a: one warp per k
#pragma unroll
  for (int a = 0; a < kMaxCoef; ++a) {
    if (a < NA) {  // uniform over the block, so the barriers are too
      __syncthreads();
      xt_sh[tid] = xv * A[a];
      __syncthreads();
      for (int k = warp; k < K; k += nwarps) {
        float v = 0.f;
        for (int f = lane; f < F; f += 32) v += xt_sh[k * F + f];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part_sh[a * kGmmMaxK + k] = v;
      }
    }
  }
  __syncthreads();

  const int NS = 2 * KD + D + D * Dd + D * Ds;
  float* st = st_out + static_cast<size_t>(s) * NS;
  for (int i = tid; i < NS; i += nthreads) {
    float v;
    if (i < 2 * KD) {
      // c t (first KD) and c t (p - mu) (second KD), index k * D + d
      const int half = i < KD ? 0 : 1;
      const int kd = i - half * KD;
      const int k = kd / D;
      const int d = kd - k * D;
      v = part_sh[(half * D + d) * kGmmMaxK + k];
    } else {
      // sums over the kernels: dpre, dpre * dfeat, dpre * sfeat
      const int j = i - 2 * KD;
      int a;
      float scale = 1.f;
      if (j < D) {
        a = 2 * D + j;
      } else if (j < D + D * Dd) {
        a = 3 * D + (j - D);
      } else {
        const int ds = j - D - D * Dd;
        const int d = ds / Ds;
        a = 2 * D + d;
        scale = sfeat[static_cast<size_t>(r) * Ds + (ds - d * Ds)];
      }
      v = 0.f;
      for (int k = 0; k < K; ++k) v += part_sh[a * kGmmMaxK + k];
      v *= scale;
    }
    st[i] = v;
  }
}

int block_threads(int KF) {
  const int t = ((KF + 31) / 32) * 32;
  return t < 32 ? 32 : t;
}

}  // namespace

extern "C" {

int dgnn_bin_gmm_fwd(const float* x, const float* alpha, const float* beta,
                     const int* nbr, const int* row, const int* count,
                     const float* mu, const float* isig, int S, int W, int K,
                     int D, int F, int use_tanh, float* acc, void* stream) {
  if (K < 1 || K > kGmmMaxK || D < 1 || D > kGmmMaxD || F < 1 ||
      K * F > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    bin_gmm_fwd_kernel<<<S, block_threads(K * F), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, alpha, beta, nbr, row, count, mu, isig, W, K, D, F, use_tanh, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

int dgnn_bin_gmm_bwd(const float* g, const float* beta, const float* dfeat,
                     const float* alpha, const float* x, const float* sfeat,
                     const int* nbr, const int* row, const int* count,
                     const float* mu, const float* isig, int S, int W, int K,
                     int D, int Dd, int Ds, int F, int use_tanh, float* dx,
                     float* st, void* stream) {
  if (K < 1 || K > kGmmMaxK || D < 1 || D > kGmmMaxD || Dd < 1 ||
      Dd > kGmmMaxDd || 3 * D + D * Dd > kMaxCoef || Ds < 1 || F < 1 ||
      K * F > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    bin_gmm_bwd_kernel<<<S, block_threads(K * F), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        g, beta, dfeat, alpha, x, sfeat, nbr, row, count, mu, isig, W, K, D,
        Dd, Ds, F, use_tanh, dx, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
