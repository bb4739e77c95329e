// Dense hub-block MoNet (GMMConv, node-derived pseudo-coordinates) passes
// for NVIDIA Hopper (sm_90a).
//
// The hub block (graph/hub.py, tile geometry and mask format in
// dense_common.cuh) is a tile-sparse [R, C] adjacency between the block's
// rows (row_ids) and columns (col_ids).
//
//   dense_gmm_fwd_kernel  replaces dgnn_tpu/ops/pallas_dense.py:dense_gmm_fwd
//     (kernel _gmm_fwd_kernel).  Rows = destinations v, columns = sources u.
//     Per set pair: p_d = [tanh](beta_d[v] + alpha_d[u]), the K Gaussian
//     weights w_k of gmm_common.cuh, and
//       acc[v, k, :] = sum_u w_k x[u, k, :].
//
//   dense_gmm_bwd_kernel  replaces dgnn_tpu/ops/pallas_dense.py:dense_gmm_bwd
//     (kernel _gmm_bwd_kernel).  The backward block is transposed: rows =
//     sources u, columns = destinations v, read straight from the node
//     tables by id (no transposed [D, C], [Dd, C], [K*F, C] copies, and the
//     full row-chunk schedule instead of the half-height one):
//       dx[u, k, :] = sum_v w_k g[v, k, :]
//     and, with gw_k = <x[u, k, :], g[v, k, :]> and c_k = gw_k w_k, the
//     per-row stat row
//       [0, KD)       sum c_k t_kd
//       [KD, 2KD)     sum c_k t_kd (p_d - mu_kd)
//       [2KD, +D)     sum dpre_d
//       [.., +D*Dd)   sum dpre_d dfeat_i[v]            (index d * Dd + i)
//     where dp_d = -sum_k c_k t_kd isig_kd and dpre_d = dp_d (1 - p_d^2)
//     under tanh (dp_d without).
//
// bf16 mode (dense_dtype "bfloat16", the JAX model's default): the TPU
// kernels feed their matmuls bf16 operands and accumulate in f32.  These
// kernels round the same operands to bf16 (round to nearest even) and
// multiply and add in f32: forward w_k and x; backward w_k and g for dx, x
// and g for gw.  c_k = gw_k w_k and every stat use the unrounded w_k.
//
// Design, as dense_gat.cu: one warp per block row, four rows per thread
// block; a warp walks its row chunk's schedule entries, compacts each tile
// row's set columns from the mask words and takes the edges 32 at a time,
// so the work is proportional to edges, not to (row, column) pairs.  A
// masked pair contributes exactly 0 in the TPU kernel, so skipping it
// changes only the summation order.  Per batch of 32 edges: lane i computes
// edge i's coordinates and weights; then the lanes, spread over the K*F
// columns, add the edges' weighted rows (and, in the backward, reduce
// <x, g_v> per kernel with warp shuffles); then lane i adds edge i's terms
// to its own stat accumulators, which are summed over the warp once at the
// end of the row.  Neither kernel needs atomics.
//
// Bound on the H100: for cora-size blocks, the latency of the dependent
// loads per edge (mask word -> col_ids -> alpha / beta -> feature row); the
// bytes are one row of K*F floats per edge (768 B at K=3, F=64), mostly
// served from L2.  Left for later PRs: splitting long hub rows over
// several warps and tensor-core tiles for dense hub tiles.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dense_common.cuh"
#include "gmm_common.cuh"

namespace {

using dgnn::cols_per_lane;
using dgnn::compact_pass;
using dgnn::gmm_coords;
using dgnn::gmm_weight;
using dgnn::kCT;
using dgnn::kFull;
using dgnn::kGmmMaxD;
using dgnn::kGmmMaxDd;
using dgnn::kGmmMaxK;
using dgnn::kGmmMaxKD;
using dgnn::kListCap;
using dgnn::kPassWords;
using dgnn::kRT;
using dgnn::kRowWords;
using dgnn::kWarps;
using dgnn::rnd;
using dgnn::warp_sum;

// Per-warp staging in shared memory.
struct WarpStage {
  unsigned short cols[kListCap];   // set tile columns of this pass
  float w[32][kGmmMaxK];           // per edge and kernel: w_k (rounded)
  float gw[32][kGmmMaxK];          // bwd: <x, g_v> per edge and kernel
};

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) dense_gmm_fwd_kernel(
    const float* __restrict__ x,         // [N, K*F] source features
    const float* __restrict__ alpha,     // [N, D]   source-side projection
    const float* __restrict__ beta,      // [Nr, D]  destination-side projection
    const int* __restrict__ row_ids,     // [R]
    const int* __restrict__ col_ids,     // [C]
    const uint32_t* __restrict__ mask,   // [T, kRT, kRowWords]
    const int* __restrict__ ct,          // [T]
    const int* __restrict__ chunk_ptr,   // [R / kRT + 1]
    const float* __restrict__ mu,        // [K, D]
    const float* __restrict__ isig,      // [K, D]
    int R, int K, int D, int F, int use_tanh, int bf16,
    float* __restrict__ acc_out) {       // [R, K*F]
  __shared__ WarpStage stage[kWarps];
  __shared__ float mu_sh[kGmmMaxKD];
  __shared__ float isig_sh[kGmmMaxKD];
  if (threadIdx.x < K * D) {
    mu_sh[threadIdx.x] = mu[threadIdx.x];
    isig_sh[threadIdx.x] = isig[threadIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  WarpStage& st = stage[warp];
  const int KF = K * F;
  const bool use_bf = bf16 != 0;
  const bool tanh_on = use_tanh != 0;
  const int chunk = r / kRT;
  const size_t rid = static_cast<size_t>(row_ids[r]);

  float b[kGmmMaxD];
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) b[d] = d < D ? beta[rid * D + d] : 0.f;

  float acc[NC];
  int kcol[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    acc[j] = 0.f;
    kcol[j] = c < KF ? c / F : 0;
  }

  for (int t = chunk_ptr[chunk]; t < chunk_ptr[chunk + 1]; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* cid_tile = col_ids + static_cast<size_t>(ct[t]) * kCT;
    for (int w0 = 0; w0 < kRowWords; w0 += kPassWords) {
      const int total = compact_pass(mrow, w0, lane, st.cols);
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int n = min(32, total - e0);
        // lane i: edge e0 + i's Gaussian weights
        uint32_t cid = 0;
        if (lane < n) {
          cid = static_cast<uint32_t>(cid_tile[st.cols[e0 + lane]]);
          float p[kGmmMaxD], diff[kGmmMaxD], tt[kGmmMaxD];
          gmm_coords(b, alpha + static_cast<size_t>(cid) * D, D, tanh_on, p);
#pragma unroll
          for (int k = 0; k < kGmmMaxK; ++k) {
            if (k < K) {
              st.w[lane][k] = rnd(
                  gmm_weight(p, mu_sh + k * D, isig_sh + k * D, D, diff, tt),
                  use_bf);
            }
          }
        }
        __syncwarp();
        // lanes over feature columns: the n edges' weighted rows
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint32_t cj = __shfl_sync(kFull, cid, i);
          const float* xr = x + static_cast<size_t>(cj) * KF;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = lane + 32 * j;
            if (c < KF) acc[j] += st.w[i][kcol[j]] * rnd(xr[c], use_bf);
          }
        }
        __syncwarp();  // before the next batch overwrites the staging
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < KF) acc_out[static_cast<size_t>(r) * KF + c] = acc[j];
  }
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) dense_gmm_bwd_kernel(
    const float* __restrict__ g,         // [Nd, K*F] grad of the output
    const float* __restrict__ beta,      // [Nd, D]   destination-side projection
    const float* __restrict__ dfeat,     // [Nd, Dd]  raw destination scalars
    const float* __restrict__ alpha,     // [Ns, D]   source-side projection
    const float* __restrict__ x,         // [Ns, K*F] source features
    const int* __restrict__ row_ids,     // [R] source ids
    const int* __restrict__ col_ids,     // [C] destination ids
    const uint32_t* __restrict__ mask,   // [T, kRT, kRowWords]
    const int* __restrict__ ct,          // [T]
    const int* __restrict__ chunk_ptr,   // [R / kRT + 1]
    const float* __restrict__ mu,        // [K, D]
    const float* __restrict__ isig,      // [K, D]
    int R, int K, int D, int Dd, int F, int use_tanh, int bf16,
    float* __restrict__ dx_out,          // [R, K*F]
    float* __restrict__ st_out) {        // [R, 2KD + D + D*Dd]
  __shared__ WarpStage stage[kWarps];
  __shared__ float mu_sh[kGmmMaxKD];
  __shared__ float isig_sh[kGmmMaxKD];
  if (threadIdx.x < K * D) {
    mu_sh[threadIdx.x] = mu[threadIdx.x];
    isig_sh[threadIdx.x] = isig[threadIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  WarpStage& st = stage[warp];
  const int KF = K * F;
  const int KD = K * D;
  const bool use_bf = bf16 != 0;
  const bool tanh_on = use_tanh != 0;
  const int chunk = r / kRT;
  const size_t sid = static_cast<size_t>(row_ids[r]);

  float a[kGmmMaxD];
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) a[d] = d < D ? alpha[sid * D + d] : 0.f;

  // this lane's edges' stat sums
  float s_ct[kGmmMaxKD], s_ctd[kGmmMaxKD];  // index k * kGmmMaxD + d
  float s_dpre[kGmmMaxD], s_df[kGmmMaxD * kGmmMaxDd];
#pragma unroll
  for (int i = 0; i < kGmmMaxKD; ++i) s_ct[i] = s_ctd[i] = 0.f;
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) s_dpre[d] = 0.f;
#pragma unroll
  for (int i = 0; i < kGmmMaxD * kGmmMaxDd; ++i) s_df[i] = 0.f;

  float dx[NC], xr[NC];  // sum w g per column; the row's own x (rounded)
  int kcol[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    dx[j] = 0.f;
    kcol[j] = c < KF ? c / F : -1;
    xr[j] = c < KF ? rnd(x[sid * KF + c], use_bf) : 0.f;
  }

  for (int t = chunk_ptr[chunk]; t < chunk_ptr[chunk + 1]; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* did_tile = col_ids + static_cast<size_t>(ct[t]) * kCT;
    for (int w0 = 0; w0 < kRowWords; w0 += kPassWords) {
      const int total = compact_pass(mrow, w0, lane, st.cols);
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int n = min(32, total - e0);
        // lane i: edge e0 + i's coordinates and weights
        uint32_t did = 0;
        float p[kGmmMaxD], wk[kGmmMaxK];
        if (lane < n) {
          did = static_cast<uint32_t>(did_tile[st.cols[e0 + lane]]);
          float diff[kGmmMaxD], tt[kGmmMaxD];
          gmm_coords(a, beta + static_cast<size_t>(did) * D, D, tanh_on, p);
#pragma unroll
          for (int k = 0; k < kGmmMaxK; ++k) {
            if (k < K) {
              wk[k] =
                  gmm_weight(p, mu_sh + k * D, isig_sh + k * D, D, diff, tt);
              st.w[lane][k] = rnd(wk[k], use_bf);
            }
          }
        }
        __syncwarp();
        // lanes over feature columns: dx and the per-kernel <x, g_v>
#pragma unroll 2
        for (int i = 0; i < n; ++i) {
          const uint32_t di = __shfl_sync(kFull, did, i);
          const float* gr = g + static_cast<size_t>(di) * KF;
          float prod[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = lane + 32 * j;
            const float gv = c < KF ? rnd(gr[c], use_bf) : 0.f;
            if (c < KF) dx[j] += st.w[i][kcol[j]] * gv;
            prod[j] = xr[j] * gv;
          }
#pragma unroll
          for (int k = 0; k < kGmmMaxK; ++k) {
            if (k < K) {
              float v = 0.f;
#pragma unroll
              for (int j = 0; j < NC; ++j) {
                if (kcol[j] == k) v += prod[j];
              }
              v = warp_sum(v);
              if (lane == 0) st.gw[i][k] = v;
            }
          }
        }
        __syncwarp();
        // lane i: edge i's terms of the stat row
        if (lane < n) {
          float dp[kGmmMaxD];
#pragma unroll
          for (int d = 0; d < kGmmMaxD; ++d) dp[d] = 0.f;
#pragma unroll
          for (int k = 0; k < kGmmMaxK; ++k) {
            if (k < K) {
              const float c = st.gw[lane][k] * wk[k];
#pragma unroll
              for (int d = 0; d < kGmmMaxD; ++d) {
                if (d < D) {
                  const float df = p[d] - mu_sh[k * D + d];
                  const float is = isig_sh[k * D + d];
                  const float ctd = c * (df * is);
                  s_ct[k * kGmmMaxD + d] += ctd;
                  s_ctd[k * kGmmMaxD + d] += ctd * df;
                  dp[d] -= ctd * is;
                }
              }
            }
          }
#pragma unroll
          for (int d = 0; d < kGmmMaxD; ++d) {
            if (d < D) {
              const float dpre = tanh_on ? dp[d] * (1.f - p[d] * p[d]) : dp[d];
              s_dpre[d] += dpre;
#pragma unroll
              for (int i = 0; i < kGmmMaxDd; ++i) {
                if (i < Dd) {
                  s_df[d * kGmmMaxDd + i] +=
                      dpre * dfeat[static_cast<size_t>(did) * Dd + i];
                }
              }
            }
          }
        }
        __syncwarp();  // before the next batch overwrites the staging
      }
    }
  }

  const size_t ro = static_cast<size_t>(r);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < KF) dx_out[ro * KF + c] = dx[j];
  }
  float* srow = st_out + ro * (2 * KD + D + D * Dd);
#pragma unroll
  for (int k = 0; k < kGmmMaxK; ++k) {
#pragma unroll
    for (int d = 0; d < kGmmMaxD; ++d) {
      if (k < K && d < D) {
        const float v1 = warp_sum(s_ct[k * kGmmMaxD + d]);
        const float v2 = warp_sum(s_ctd[k * kGmmMaxD + d]);
        if (lane == 0) {
          srow[k * D + d] = v1;
          srow[KD + k * D + d] = v2;
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) {
    if (d < D) {
      const float v = warp_sum(s_dpre[d]);
      if (lane == 0) srow[2 * KD + d] = v;
#pragma unroll
      for (int i = 0; i < kGmmMaxDd; ++i) {
        if (i < Dd) {
          const float u = warp_sum(s_df[d * kGmmMaxDd + i]);
          if (lane == 0) srow[2 * KD + D + d * Dd + i] = u;
        }
      }
    }
  }
}

// Three instances per kernel keep the build short: K*F <= 32 takes one
// column per lane, K*F <= 256 eight, K*F <= 1024 thirty-two.
template <typename Launch>
int dispatch_nc(int KF, Launch&& launch) {
  const int nc = cols_per_lane(KF);
  if (nc <= 1) {
    launch(std::integral_constant<int, 1>{});
  } else if (nc <= 8) {
    launch(std::integral_constant<int, 8>{});
  } else if (nc <= 32) {
    launch(std::integral_constant<int, 32>{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

bool bad_dims(int K, int D, int Dd, int F) {
  return K < 1 || K > kGmmMaxK || D < 1 || D > kGmmMaxD || Dd < 1 ||
         Dd > kGmmMaxDd || F < 1;
}

}  // namespace

extern "C" {

int dgnn_dense_gmm_fwd(const float* x, const float* alpha, const float* beta,
                       const int* row_ids, const int* col_ids,
                       const void* mask, const int* ct, const int* chunk_ptr,
                       const float* mu, const float* isig, int R, int K, int D,
                       int F, int use_tanh, int bf16, float* acc,
                       void* stream) {
  if (bad_dims(K, D, 1, F)) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const int bad = dispatch_nc(K * F, [&](auto nc) {
    dense_gmm_fwd_kernel<decltype(nc)::value>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            x, alpha, beta, row_ids, col_ids,
            static_cast<const uint32_t*>(mask), ct, chunk_ptr, mu, isig, R, K,
            D, F, use_tanh, bf16, acc);
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

int dgnn_dense_gmm_bwd(const float* g, const float* beta, const float* dfeat,
                       const float* alpha, const float* x, const int* row_ids,
                       const int* col_ids, const void* mask, const int* ct,
                       const int* chunk_ptr, const float* mu,
                       const float* isig, int R, int K, int D, int Dd, int F,
                       int use_tanh, int bf16, float* dx, float* st,
                       void* stream) {
  if (bad_dims(K, D, Dd, F)) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const int bad = dispatch_nc(K * F, [&](auto nc) {
    dense_gmm_bwd_kernel<decltype(nc)::value>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            g, beta, dfeat, alpha, x, row_ids, col_ids,
            static_cast<const uint32_t*>(mask), ct, chunk_ptr, mu, isig, R, K,
            D, Dd, F, use_tanh, bf16, dx, st);
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
