// Degree-binned MoNet (GMMConv, node-derived pseudo-coordinates) passes for
// NVIDIA Hopper (sm_90a): float32 sums over feature rows stored as float32
// or bf16.
//
//   bin_gmm_fwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gmm_fwd_kernel
//     (wrappers bin_gmm_node_fwd, bin_gmm_node_fwd_list).  Over the CSR bins
//     (rows = destinations v, slots = sources u): p_d = [tanh](beta_d[v] +
//     alpha_d[u]), the K Gaussian weights w_k of gmm_common.cuh, and
//       acc[v, k, :] = sum_u w_k x[u, k, :].
//     Plain sums: an empty segment gives zeros.
//
//   bin_gmm_bwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gmm_bwd_kernel
//     (wrappers bin_gmm_node_bwd, bin_gmm_node_bwd_list).  Over the CSC bins
//     (rows = sources u, slots = destinations v):
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
// Every stat is linear in the dot products <x, g_v>, so the backward never
// reduces a dot product per slot: each column lane accumulates
//   A_a[c] = sum_v coef_a[v, k(c)] g[v, c]
// for the NA = 3D + D*Dd coefficient sets
//   w t_d | w t_d (p_d - mu_d) | e_d = -w t_d isig_d (1 - p_d^2) | e_d dfeat_i
// and the segment's own row x[u] is multiplied in once at the end:
//   stat_a[k] = sum_{c in kernel k} x[u, c] A_a[c],
// summed over k for the dpre columns.  The sfeat block is the dpre block
// times the segment's own sfeat[u].
//
// These kernels gather for themselves from the node tables given the slot
// table nbr [S, W]: no pre-gathered [W, S, C] block, no concatenated
// alpha / beta / dfeat columns, no width cap, and the weight of kernel k is
// broadcast over its F columns (no expander matmul).
//
// Bound on the H100: the bytes gathered per slot, one row of K*F floats
// (768 B at K=3, F=64) from rows scattered over the node table; the
// backward adds NA multiply-adds per gathered float.  Latency, not bytes,
// held both back as a block per segment (pubmed's segments hold 3 to 10
// slots; barriers around every chunk, and 16 in the backward's stat tail
// alone), so each is a group of lanes per segment (bin_common.cuh): a full
// warp at K*F >= 32 (the hidden layer's 192 columns), 16 lanes at the
// output layer's 9, several segments a block, no block barrier, one launch
// over every bin of the direction (BinList).  One lane per slot loads the
// slot's id and its pseudo halves and computes the slot's scalars into a
// warp-private slab (__syncwarp); the first slots' ids are requested with
// the segment's row and count.  Then lanes work over columns, up to eight
// a lane (dgnn::cols_per_lane; loads of four values where F % 4 = 0 and
// the tables are aligned): each slot of the chunk in ascending order, all sums
// in registers.  Rows wider than 8 G columns are walked in column tiles.
//
//   Forward: the segment's beta[v] sits in registers; the slot lane
//   computes the K weights, with gmm_common.cuh's roundings, into a [G][K]
//   slab, and each column lane adds w[k(c)] x[u, c].
//   Backward: the slot lane computes K weights and K x NA coefficients;
//   column lanes keep dx and the NA accumulators, and the segment's own
//   row x[u] is read after the walk, when its registers are free.  The stat
//   tail is, for each kernel k, a per-lane partial of x[u, c] A_a[c] over
//   the lane's columns of k for every set a, reduced by one interleaved
//   shuffle butterfly; lane 0 keeps the sums in the slab across column
//   tiles, and the group writes the stat row (the dpre sets summed over k).
//
// Feature rows (x in the forward; g and the segment's own x in the
// backward) are float32 or bf16, one template instance each (T), widened
// to float32 as they are loaded (bin_common.cuh ld_row / ld_row4), as
// bin_gat.cu reads them.  alpha, beta and the raw pseudo scalars stay
// float32 tables; where the ops round them to bf16 they hand over the
// rounded values.
//
// Left for later PRs: prefetch of the next slots' rows, and fusing the
// segment merge (ops/common.py combine_sum).
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bin_common.cuh"
#include "gmm_common.cuh"

namespace {

using dgnn::BinList;
using dgnn::find_seg;
using dgnn::gmm_coords;
using dgnn::gmm_weight;
using dgnn::group_mask;
using dgnn::kGmmMaxD;
using dgnn::ld_row;
using dgnn::ld_row4;
using dgnn::kGmmMaxDd;
using dgnn::kGmmMaxK;
using dgnn::Seg;

constexpr int kMaxKF = 1024;  // feature columns; the wrappers refuse more
// Coefficient sets per column, NA = 3D + D*Dd: 8 at the models' D = 2,
// Dd = 1.  The wrapper refuses more.
constexpr int kMaxCoef = 8;
constexpr int kStat = kMaxCoef * kGmmMaxK;  // a group's stat sums [a][k]

// T: the feature rows' storage (float or __nv_bfloat16); VEC: loads of
// four values of x; CPL: feature columns a lane per tile of CPL * G
// (dgnn::cols_per_lane).  Dynamic shared memory, per group
// (gmm_fwd_group_floats): G slot ids, [G][K] weights.  Blocks of
// dgnn::kGroupThreads an SM kept by the launch bounds: four (at most 64
// registers a thread; a lane holds at most eight sums).
constexpr int kGmmFwdMinBlocks = 4;

__host__ __device__ inline int gmm_fwd_group_floats(int G, int K) {
  return G + G * K;
}

template <typename T, bool VEC, int CPL>
__global__ void __launch_bounds__(dgnn::kGroupThreads, kGmmFwdMinBlocks)
bin_gmm_fwd_kernel(
    const T* __restrict__ x,          // [N, K*F] source features
    const float* __restrict__ alpha,  // [N, D]   source-side projection
    const float* __restrict__ beta,   // [Nr, D]  destination-side projection
    const BinList bl,                 // nbr: source ids; row: destination id
    const float* __restrict__ mu,     // [K, D]
    const float* __restrict__ isig,   // [K, D]
    int G, int K, int D, int F, int use_tanh,
    float* __restrict__ acc_out) {    // [total, K*F]
  extern __shared__ float smem[];
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int gl = threadIdx.x - grp * G;  // lane within the group
  const int s = blockIdx.x * gpb + grp;
  if (s >= bl.total) return;  // the whole group leaves together
  const unsigned gmask = group_mask(G);
  const Seg sg = find_seg(bl, s);
  // the first slot ids are requested with row and count
  const int j0 = gl < sg.W ? __ldg(sg.nbr + gl) : 0;
  const int cnt = sg.count;
  const int r = sg.row;
  const int KF = K * F;
  const bool tanh_on = use_tanh != 0;
  float* slab = smem + grp * gmm_fwd_group_floats(G, K);
  int* sj = reinterpret_cast<int*>(slab);  // the chunk's slot ids
  float* sw = slab + G;                    // [G][K] weights

  float bv[kGmmMaxD];  // the segment's beta[v]
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d)
    bv[d] = d < D ? __ldg(beta + static_cast<size_t>(r) * D + d) : 0.f;

  constexpr int NQ = VEC ? CPL / 4 : CPL;  // loads a lane per slot
  for (int c0 = 0; c0 < KF; c0 += CPL * G) {
    int col[NQ], kc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      col[q] = c0 + (VEC ? 4 * (gl + G * q) : gl + G * q);
      kc[q] = col[q] < KF ? col[q] / F : 0;
    }
    float acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
    for (int w0 = 0; w0 < cnt; w0 += G) {
      const int nch = min(G, cnt - w0);
      if (gl < nch) {
        // one lane a slot: its K weights, with gmm_common.cuh's roundings
        const int j = w0 == 0 ? j0 : __ldg(sg.nbr + w0 + gl);
        // alpha[u] as beta[v] above: gmm_row's clamped loads of all
        // kGmmMaxD values measured slower here, where D < kGmmMaxD
        float aj[kGmmMaxD], pj[kGmmMaxD], diff[kGmmMaxD], tk[kGmmMaxD];
#pragma unroll
        for (int d = 0; d < kGmmMaxD; ++d)
          aj[d] = d < D ? __ldg(alpha + static_cast<size_t>(j) * D + d) : 0.f;
        gmm_coords(bv, aj, D, tanh_on, pj);
        for (int k = 0; k < K; ++k)
          sw[gl * K + k] = gmm_weight(pj, mu + k * D, isig + k * D, D, diff, tk);
        sj[gl] = j;
      }
      __syncwarp(gmask);
      // lanes over columns: every slot of the chunk in ascending order
#pragma unroll 2
      for (int wl = 0; wl < nch; ++wl) {
        const T* xr = x + static_cast<size_t>(sj[wl]) * KF;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col[q] < KF) {
            const float w = sw[wl * K + kc[q]];
            if constexpr (VEC) {
              const float4 v = ld_row4(xr + col[q]);
              acc[4 * q] += w * v.x;
              acc[4 * q + 1] += w * v.y;
              acc[4 * q + 2] += w * v.z;
              acc[4 * q + 3] += w * v.w;
            } else {
              acc[q] += w * ld_row(xr + col[q]);
            }
          }
        }
      }
      __syncwarp(gmask);  // the slab is rewritten by the next chunk
    }
    float* ao = acc_out + static_cast<size_t>(s) * KF;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (col[q] < KF) {
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(ao + col[q]) = make_float4(
              acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
        } else {
          ao[col[q]] = acc[q];
        }
      }
    }
  }
}

// Floats of dynamic shared memory a group of G lanes needs.
__host__ __device__ inline int gmm_bwd_group_floats(int G, int K) {
  return G + G * K + G * K * kMaxCoef + kStat;
}

// T: the feature rows' storage; VEC: loads of four values of g and x; CPL:
// feature columns a lane per tile of CPL * G (dgnn::cols_per_lane).  Dynamic shared memory, per group
// (gmm_bwd_group_floats): G slot ids, [G][K] weights, [G][K][kMaxCoef]
// coefficients (zero past NA), [kMaxCoef][kGmmMaxK] stat sums.
// Blocks of dgnn::kGroupThreads an SM kept by the launch bounds: two (at
// most 128 registers a thread) where a lane's dx and NA accumulators take
// up to 72; three (85) at one column a lane.
constexpr int gmm_bwd_min_blocks(int cpl) { return cpl == 1 ? 3 : 2; }

template <typename T, bool VEC, int CPL>
__global__ void __launch_bounds__(dgnn::kGroupThreads,
                                  gmm_bwd_min_blocks(CPL))
bin_gmm_bwd_kernel(
    const T* __restrict__ g,          // [Nd, K*F] grad of the output
    const float* __restrict__ beta,   // [Nd, D]   destination-side projection
    const float* __restrict__ dfeat,  // [Nd, Dd]  raw destination scalars
    const float* __restrict__ alpha,  // [Ns, D]   source-side projection
    const T* __restrict__ x,          // [Ns, K*F] source features
    const float* __restrict__ sfeat,  // [Ns, Ds]  raw source scalars
    const BinList bl,                 // nbr: destination ids; row: source id
    const float* __restrict__ mu,     // [K, D]
    const float* __restrict__ isig,   // [K, D]
    int G, int K, int D, int Dd, int Ds, int F, int use_tanh,
    float* __restrict__ dx_out,       // [total, K*F]
    float* __restrict__ st_out) {     // [total, 2KD + D + D*Dd + D*Ds]
  extern __shared__ float smem[];
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int gl = threadIdx.x - grp * G;  // lane within the group
  const int s = blockIdx.x * gpb + grp;
  if (s >= bl.total) return;  // the whole group leaves together
  const unsigned gmask = group_mask(G);
  const Seg sg = find_seg(bl, s);
  // the first slot ids are requested with row and count
  const int j0 = gl < sg.W ? __ldg(sg.nbr + gl) : 0;
  const int cnt = sg.count;
  const int r = sg.row;
  const int KF = K * F;
  const int KD = K * D;
  const int NA = 3 * D + D * Dd;
  const bool tanh_on = use_tanh != 0;
  float* slab = smem + grp * gmm_bwd_group_floats(G, K);
  int* sj = reinterpret_cast<int*>(slab);  // the chunk's slot ids
  float* sw = slab + G;                    // [G][K] weights
  float* scf = sw + G * K;                 // [G][K][kMaxCoef] coefficients
  float* sst = scf + G * K * kMaxCoef;     // [kMaxCoef][kGmmMaxK] stat sums
  for (int i = gl; i < kStat; i += G) sst[i] = 0.f;

  constexpr int NQ = VEC ? CPL / 4 : CPL;  // loads a lane per slot
  constexpr int QW = VEC ? 4 : 1;              // columns a load
  for (int c0 = 0; c0 < KF; c0 += CPL * G) {
    int col[NQ], kc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      col[q] = c0 + (VEC ? 4 * (gl + G * q) : gl + G * q);
      kc[q] = col[q] < KF ? col[q] / F : 0;
    }
    float dx[CPL];
    float A[kMaxCoef][CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      dx[i] = 0.f;
#pragma unroll
      for (int a = 0; a < kMaxCoef; ++a) A[a][i] = 0.f;
    }

    for (int w0 = 0; w0 < cnt; w0 += G) {
      const int nch = min(G, cnt - w0);
      if (gl < nch) {
        // one lane a slot: its K weights and K x NA coefficient sets, with
        // gmm_common.cuh's roundings; few temporaries, as the column
        // accumulators are live throughout
        const int j = w0 == 0 ? j0 : __ldg(sg.nbr + w0 + gl);
        float pj[kGmmMaxD];
#pragma unroll
        for (int d = 0; d < kGmmMaxD; ++d) {
          if (d < D) {
            // alpha[u] is read here, not kept: an L1 hit beside registers
            // the column accumulators need
            const float pre =
                __fadd_rn(__ldg(alpha + static_cast<size_t>(r) * D + d),
                          __ldg(beta + static_cast<size_t>(j) * D + d));
            pj[d] = tanh_on ? tanhf(pre) : pre;
          }
        }
        for (int k = 0; k < K; ++k) {
          float q = 0.f;
#pragma unroll
          for (int d = 0; d < kGmmMaxD; ++d) {
            if (d < D) {
              const float t = __fmul_rn(__fsub_rn(pj[d], __ldg(mu + k * D + d)),
                                        __ldg(isig + k * D + d));
              const float tt = __fmul_rn(t, t);
              q = d == 0 ? tt : __fadd_rn(q, tt);
            }
          }
          const float w = expf(__fmul_rn(-0.5f, q));
          sw[gl * K + k] = w;
          float* cf = scf + (gl * K + k) * kMaxCoef;
#pragma unroll
          for (int d = 0; d < kGmmMaxD; ++d) {
            if (d < D) {
              const float is = __ldg(isig + k * D + d);
              const float diff = __fsub_rn(pj[d], __ldg(mu + k * D + d));
              const float wt = w * __fmul_rn(diff, is);
              cf[d] = wt;
              cf[D + d] = wt * diff;
              float e = -wt * is;
              if (tanh_on) e *= 1.f - pj[d] * pj[d];
              cf[2 * D + d] = e;
              for (int i = 0; i < Dd; ++i)
                cf[3 * D + d * Dd + i] =
                    e * __ldg(dfeat + static_cast<size_t>(j) * Dd + i);
            }
          }
          for (int a = NA; a < kMaxCoef; ++a) cf[a] = 0.f;
        }
        sj[gl] = j;
      }
      __syncwarp(gmask);
      // lanes over columns: every slot of the chunk in ascending order
#pragma unroll 2
      for (int wl = 0; wl < nch; ++wl) {
        const T* gr = g + static_cast<size_t>(sj[wl]) * KF;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col[q] < KF) {
            float gv[QW];
            if constexpr (VEC) {
              const float4 v = ld_row4(gr + col[q]);
              gv[0] = v.x;
              gv[1] = v.y;
              gv[2] = v.z;
              gv[3] = v.w;
            } else {
              gv[0] = ld_row(gr + col[q]);
            }
            const float w = sw[wl * K + kc[q]];
            const float* cf = scf + (wl * K + kc[q]) * kMaxCoef;
#pragma unroll
            for (int e = 0; e < QW; ++e) dx[QW * q + e] += w * gv[e];
#pragma unroll
            for (int a = 0; a < kMaxCoef; ++a) {
              const float c = cf[a];
#pragma unroll
              for (int e = 0; e < QW; ++e) A[a][QW * q + e] += c * gv[e];
            }
          }
        }
      }
      __syncwarp(gmask);  // the slab is rewritten by the next chunk
    }

    float* dxo = dx_out + static_cast<size_t>(s) * KF;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (col[q] < KF) {
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(dxo + col[q]) =
              make_float4(dx[4 * q], dx[4 * q + 1], dx[4 * q + 2], dx[4 * q + 3]);
        } else {
          dxo[col[q]] = dx[q];
        }
      }
    }
    // the segment's own row, read after the walk so that its registers are
    // free during it (a row of the node table, mostly in L2 by then)
    float xv[CPL];
    const T* xr = x + static_cast<size_t>(r) * KF;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col[q] < KF) v = ld_row4(xr + col[q]);
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      } else {
        xv[q] = col[q] < KF ? ld_row(xr + col[q]) : 0.f;
      }
    }
    // stat partials: per kernel k, the sums of x[u, c] A_a[c] over this
    // tile's columns of k, all kMaxCoef sets reduced in one interleaved
    // butterfly
    for (int k = 0; k < K; ++k) {
      float v[kMaxCoef];
#pragma unroll
      for (int a = 0; a < kMaxCoef; ++a) {
        v[a] = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col[q] < KF && kc[q] == k) {
#pragma unroll
            for (int e = 0; e < QW; ++e) v[a] += xv[QW * q + e] * A[a][QW * q + e];
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < kMaxCoef; ++a) v[a] += __shfl_xor_sync(gmask, v[a], o);
      }
      if (gl == 0) {
#pragma unroll
        for (int a = 0; a < kMaxCoef; ++a) sst[a * kGmmMaxK + k] += v[a];
      }
    }
  }
  __syncwarp(gmask);

  const int NS = 2 * KD + D + D * Dd + D * Ds;
  float* st = st_out + static_cast<size_t>(s) * NS;
  for (int i = gl; i < NS; i += G) {
    float v;
    if (i < 2 * KD) {
      // c t (first KD) and c t (p - mu) (second KD), index k * D + d
      const int half = i < KD ? 0 : 1;
      const int kd = i - half * KD;
      const int k = kd / D;
      const int d = kd - k * D;
      v = sst[(half * D + d) * kGmmMaxK + k];
    } else {
      // sums over the kernels: dpre, dpre * dfeat, dpre * sfeat
      const int jj = i - 2 * KD;
      int a;
      float scale = 1.f;
      if (jj < D) {
        a = 2 * D + jj;
      } else if (jj < D + D * Dd) {
        a = 3 * D + jj - D;
      } else {
        const int ds = jj - D - D * Dd;
        const int d = ds / Ds;
        a = 2 * D + d;
        scale = __ldg(sfeat + static_cast<size_t>(r) * Ds + (ds - d * Ds));
      }
      v = 0.f;
      for (int k = 0; k < K; ++k) v += sst[a * kGmmMaxK + k];
      v *= scale;
    }
    st[i] = v;
  }
}

// Groups a block: kGroupThreads / G, fewer where a block's dynamic shared
// memory would pass the default 48 KB.
int groups_per_block(int G, size_t per) {
  int gpb = dgnn::kGroupThreads / G;
  while (gpb > 1 && gpb * per > 48 * 1024) --gpb;
  return gpb;
}

// Every bin of one direction in one launch, feature rows of type T.
template <typename T>
int run_gmm_fwd(const T* x, const float* alpha, const float* beta, int nbins,
                void* const* nbr, void* const* row, void* const* count,
                const int* S, const int* W, const float* mu,
                const float* isig, int K, int D, int F, int use_tanh,
                float* acc, void* stream) {
  BinList bl;
  if (!dgnn::pack_bins(nbins, nbr, row, count, S, W, &bl) || K < 1 ||
      K > kGmmMaxK || D < 1 || D > kGmmMaxD || F < 1 || K * F > kMaxKF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bl.total > 0) {
    const int G = dgnn::group_lanes(K * F);
    const size_t per =
        static_cast<size_t>(gmm_fwd_group_floats(G, K)) * sizeof(float);
    const int gpb = groups_per_block(G, per);  // at most 9.2 KB: all 8 groups
    const int blocks = (bl.total + gpb - 1) / gpb;
    const int cpl = dgnn::cols_per_lane(K * F, G);
    const bool vec = dgnn::vec_rows<T>(cpl, F, x);
    cudaStream_t stm = static_cast<cudaStream_t>(stream);
#define DGNN_GMM_FWD(V, C)                                                  \
  bin_gmm_fwd_kernel<T, V, C><<<blocks, gpb * G, gpb * per, stm>>>(         \
      x, alpha, beta, bl, mu, isig, G, K, D, F, use_tanh, acc)
    if (vec && cpl == 8) DGNN_GMM_FWD(true, 8);
    else if (vec) DGNN_GMM_FWD(true, 4);
    else if (cpl == 8) DGNN_GMM_FWD(false, 8);
    else if (cpl == 4) DGNN_GMM_FWD(false, 4);
    else if (cpl == 2) DGNN_GMM_FWD(false, 2);
    else DGNN_GMM_FWD(false, 1);
#undef DGNN_GMM_FWD
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_gmm_bwd(const T* g, const float* beta, const float* dfeat,
                const float* alpha, const T* x, const float* sfeat, int nbins,
                void* const* nbr, void* const* row, void* const* count,
                const int* S, const int* W, const float* mu,
                const float* isig, int K, int D, int Dd, int Ds, int F,
                int use_tanh, float* dx, float* st, void* stream) {
  BinList bl;
  if (!dgnn::pack_bins(nbins, nbr, row, count, S, W, &bl) || K < 1 ||
      K > kGmmMaxK || D < 1 || D > kGmmMaxD || Dd < 1 || Dd > kGmmMaxDd ||
      3 * D + D * Dd > kMaxCoef || Ds < 1 || F < 1 || K * F > kMaxKF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bl.total > 0) {
    const int G = dgnn::group_lanes(K * F);
    const size_t per =
        static_cast<size_t>(gmm_bwd_group_floats(G, K)) * sizeof(float);
    const int gpb = groups_per_block(G, per);  // at most 9.4 KB a group (K = 8)
    const int blocks = (bl.total + gpb - 1) / gpb;
    const int cpl = dgnn::cols_per_lane(K * F, G);
    const bool vec =
        dgnn::vec_rows<T>(cpl, F, g) && dgnn::vec_rows<T>(cpl, F, x);
    cudaStream_t stm = static_cast<cudaStream_t>(stream);
#define DGNN_GMM_BWD(V, C)                                                  \
  bin_gmm_bwd_kernel<T, V, C><<<blocks, gpb * G, gpb * per, stm>>>(         \
      g, beta, dfeat, alpha, x, sfeat, bl, mu, isig, G, K, D, Dd, Ds, F,    \
      use_tanh, dx, st)
    if (vec && cpl == 8) DGNN_GMM_BWD(true, 8);
    else if (vec) DGNN_GMM_BWD(true, 4);
    else if (cpl == 8) DGNN_GMM_BWD(false, 8);
    else if (cpl == 4) DGNN_GMM_BWD(false, 4);
    else if (cpl == 2) DGNN_GMM_BWD(false, 2);
    else DGNN_GMM_BWD(false, 1);
#undef DGNN_GMM_BWD
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every bin of one direction in one launch: nbins <= dgnn::kMaxBins bins,
// bin b with S[b] segments of W[b] slots (nbr[b], row[b], count[b] device
// pointers); the outputs hold sum S[b] rows in bin order.  x holds float32
// values, or bf16 where bf16 is 1.
int dgnn_bin_gmm_fwd(const void* x, const float* alpha, const float* beta,
                     int nbins, void* const* nbr, void* const* row,
                     void* const* count, const int* S, const int* W,
                     const float* mu, const float* isig, int K, int D, int F,
                     int use_tanh, int bf16, float* acc, void* stream) {
  if (bf16)
    return run_gmm_fwd(static_cast<const __nv_bfloat16*>(x), alpha, beta,
                       nbins, nbr, row, count, S, W, mu, isig, K, D, F,
                       use_tanh, acc, stream);
  return run_gmm_fwd(static_cast<const float*>(x), alpha, beta, nbins, nbr,
                     row, count, S, W, mu, isig, K, D, F, use_tanh, acc,
                     stream);
}

// The backward over every bin of one direction, as dgnn_bin_gmm_fwd; g and
// x hold float32 values, or both bf16 where bf16 is 1.
int dgnn_bin_gmm_bwd(const void* g, const float* beta, const float* dfeat,
                     const float* alpha, const void* x, const float* sfeat,
                     int nbins, void* const* nbr, void* const* row,
                     void* const* count, const int* S, const int* W,
                     const float* mu, const float* isig, int K, int D, int Dd,
                     int Ds, int F, int use_tanh, int bf16, float* dx,
                     float* st, void* stream) {
  if (bf16)
    return run_gmm_bwd(static_cast<const __nv_bfloat16*>(g), beta, dfeat,
                       alpha, static_cast<const __nv_bfloat16*>(x), sfeat,
                       nbins, nbr, row, count, S, W, mu, isig, K, D, Dd, Ds,
                       F, use_tanh, dx, st, stream);
  return run_gmm_bwd(static_cast<const float*>(g), beta, dfeat, alpha,
                     static_cast<const float*>(x), sfeat, nbins, nbr, row,
                     count, S, W, mu, isig, K, D, Dd, Ds, F, use_tanh, dx, st,
                     stream);
}

}  // extern "C"
