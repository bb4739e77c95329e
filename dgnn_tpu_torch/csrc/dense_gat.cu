// Dense hub-block GAT passes for NVIDIA Hopper (sm_90a).
//
// The hub block (graph/hub.py, tile geometry and mask format in
// dense_common.cuh) is a tile-sparse [R, C] adjacency between the block's
// rows (row_ids) and columns (col_ids).
//
//   dense_gat_fwd_kernel  replaces dgnn_tpu/ops/pallas_dense.py:dense_gat_fwd
//     (kernel _gat_fwd_kernel).  Rows = destinations, columns = sources.
//     Per row r and head h, with s_raw = ar[row_ids[r]] + ac[col_ids[c]]:
//       m    = bound_r = LeakyReLU(ar_r + max_c ac_c)  (an upper bound of
//              every score of the row, not the exact maximum)
//       p    = exp(LeakyReLU(s_raw) - bound_r) where the mask bit is set
//       l    = sum p,      acc    = sum p^ x[col_ids[c]]
//       lpos = sum_{s_raw >= 0} p,  accpos = sum_{s_raw >= 0} p^ x
//     with p^ = p after attention dropout.  A row with no set bit gives
//     m = bound and zero partials; the log-sum-exp combine takes both.
//
//   dense_gat_bwd_kernel  replaces dgnn_tpu/ops/pallas_dense.py:dense_gat_bwd
//     (kernel _gat_bwd_kernel).  The backward block is transposed: rows =
//     sources j, columns = destinations i, read straight from the node
//     tables by id (no [4H, C] transposed stats table):
//       a = exp(LeakyReLU(ar_i + ac_j) - M_i) * Linv_i,  a^ = dropout(a)
//       dx[j]  = sum_i a^ g_i
//       dac[j] = sum_i (a^ <x_j, g_i> - a ws_i) d'   (d' = LeakyReLU')
//     computed as <x_j, sum_i a^ d' g_i> - sum_i a d' ws_i, as bin_gat.cu
//     does.
//
// bf16 mode (dense_dtype "bfloat16", the JAX model's default): the TPU
// kernels feed their matmuls bf16 operands and accumulate in f32.  These
// kernels round the same operands to bf16 (round to nearest even) and
// multiply and add in f32: forward p^ (and its sign-split copy) and x;
// backward a^, g and x.  Everything else stays f32, including the a^ inside
// dac's first term.  One detail: without dropout the TPU kernel's l and
// lpos ride the matmul's ones column, so they are sums of bf16-rounded p;
// with dropout they are f32 sums of unrounded p.  Both cases are matched.
//
// Design.  One warp per block row, four rows per thread block; a warp
// walks its row chunk's schedule entries, so each row's sums live in one
// warp's registers and neither kernel needs atomics.  The block is sparse
// (cora's hub block holds 11,350 edges in 5.2M (row, col) pairs, 0.22 %),
// so the kernels skip empty pairs instead of computing every pair of a
// tile: a warp reads its row's 256 mask bytes, compacts the set columns
// into a list in shared memory (a ballot-free prefix sum of popcounts),
// then takes the edges 32 at a time.  Each lane computes one edge's
// per-head weights (the score, exp and dropout hash) into shared memory;
// then the lanes, spread over the H*F feature columns, accumulate the 32
// edges' feature rows.  A masked pair contributes exactly 0 in the TPU
// kernel, so skipping it changes nothing but the summation order.
//
// Bound on the H100: for cora-size blocks, the latency of the dependent
// loads per edge (mask word -> col_ids -> ac / node tables -> feature
// row); per edge the work is H exps and hashes and H*F multiply-adds, and
// the bytes are one feature row (1 KB at H=4, F=64) mostly served from L2.
// Taking 32 edges per step puts 32 independent row loads in flight per
// warp.  Left for later PRs: balancing hub rows with thousands of edges
// over several warps, and tensor-core tiles for dense hub tiles.
//
// Dropout re-derives pair_keep bit for bit (gat_common.cuh) on the global
// ids: forward dst = row_ids[r], src = col_ids[c]; backward dst =
// col_ids[c], src = row_ids[r].
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dense_common.cuh"
#include "gat_common.cuh"

namespace {

using dgnn::cols_per_lane;
using dgnn::compact_pass;
using dgnn::kCT;
using dgnn::kFull;
using dgnn::kListCap;
using dgnn::kPassWords;
using dgnn::kRT;
using dgnn::kRowWords;
using dgnn::kWarps;
using dgnn::leaky;
using dgnn::pair_base;
using dgnn::pair_u_head;
using dgnn::rnd;
using dgnn::warp_sum;

constexpr int kMaxHeads = 16;          // the wrapper refuses H > kMaxHeads

// Per-warp staging in shared memory.
struct WarpStage {
  unsigned short cols[kListCap];   // set tile columns of this pass
  float w0[32][kMaxHeads];         // per edge and head: fwd p^, bwd a^
  float w1[32][kMaxHeads];         // bwd: a^ d' (fwd: unused)
  uint32_t pos[32];                // fwd: bit h set iff s_raw >= 0
  float head0[kMaxHeads];          // fwd: ar of the row; bwd: ac of the row
  float head1[kMaxHeads];          // fwd: the row's bound
};

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) dense_gat_fwd_kernel(
    const float* __restrict__ x,         // [N, H*F] source features
    const float* __restrict__ ac,        // [N, H]   source coefficients
    const float* __restrict__ ar,        // [Nr, H]  destination coefficients
    const float* __restrict__ acmax,     // [H] max of ac over the block's columns
    const int* __restrict__ row_ids,     // [R]
    const int* __restrict__ col_ids,     // [C]
    const uint32_t* __restrict__ mask,   // [T, kRT, kRowWords]
    const int* __restrict__ ct,          // [T]
    const int* __restrict__ chunk_ptr,   // [R / kRT + 1]
    int R, int H, int F, float slope, int with_pos, float p, float inv_keep,
    uint32_t seed, int bf16,
    float* __restrict__ m_out,           // [R, H]
    float* __restrict__ l_out,           // [R, H]
    float* __restrict__ lpos_out,        // [R, H]    (with_pos)
    float* __restrict__ acc_out,         // [R, H*F]
    float* __restrict__ accpos_out) {    // [R, H*F]  (with_pos)
  __shared__ WarpStage stage[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  WarpStage& st = stage[warp];
  const int HF = H * F;
  const bool drop = p > 0.f;
  const bool use_bf = bf16 != 0;
  const int chunk = r / kRT;
  const uint32_t rid = static_cast<uint32_t>(row_ids[r]);

  if (lane < H) {
    const float a = ar[static_cast<size_t>(rid) * H + lane];
    st.head0[lane] = a;
    st.head1[lane] = leaky(a + acmax[lane], slope);
  }
  __syncwarp();

  float l[kMaxHeads], lp[kMaxHeads];  // this lane's edges' sums
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) l[h] = lp[h] = 0.f;
  float acc[NC], accp[NC];
  int hcol[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    acc[k] = accp[k] = 0.f;
    hcol[k] = c < HF ? c / F : 0;
  }

  for (int t = chunk_ptr[chunk]; t < chunk_ptr[chunk + 1]; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* cid_tile = col_ids + static_cast<size_t>(ct[t]) * kCT;
    for (int w0 = 0; w0 < kRowWords; w0 += kPassWords) {
      const int total = compact_pass(mrow, w0, lane, st.cols);
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int n = min(32, total - e0);
        // lane i: edge e0 + i's per-head weights
        uint32_t cid = 0;
        if (lane < n) {
          cid = static_cast<uint32_t>(cid_tile[st.cols[e0 + lane]]);
          const uint32_t base = drop ? pair_base(seed, rid, cid) : 0u;
          const float* acj = ac + static_cast<size_t>(cid) * H;
          uint32_t pos = 0;
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) {
            if (h < H) {
              const float sr = st.head0[h] + acj[h];
              const float pw = expf(leaky(sr, slope) - st.head1[h]);
              float pd = pw;
              if (drop) pd = pair_u_head(base, H, h) > p ? pw * inv_keep : 0.f;
              pd = rnd(pd, use_bf);
              // l: bf16-rounded p without dropout, f32 p with it (header)
              const float lw = drop ? pw : pd;
              st.w0[lane][h] = pd;
              l[h] += lw;
              if (sr >= 0.f) {
                pos |= 1u << h;
                lp[h] += lw;
              }
            }
          }
          st.pos[lane] = pos;
        }
        __syncwarp();
        // lanes over feature columns: the n edges' weighted rows
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint32_t cj = __shfl_sync(kFull, cid, i);
          const float* xr = x + static_cast<size_t>(cj) * HF;
          const uint32_t pos = st.pos[i];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int c = lane + 32 * k;
            if (c < HF) {
              const float v = st.w0[i][hcol[k]] * rnd(xr[c], use_bf);
              acc[k] += v;
              if ((pos >> hcol[k]) & 1u) accp[k] += v;
            }
          }
        }
        __syncwarp();  // before the next batch overwrites the staging
      }
    }
  }

  const size_t ro = static_cast<size_t>(r);
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < H) {
      const float lh = warp_sum(l[h]);
      const float lph = warp_sum(lp[h]);
      if (lane == h) {
        m_out[ro * H + h] = st.head1[h];
        l_out[ro * H + h] = lh;
        if (with_pos) lpos_out[ro * H + h] = lph;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < HF) {
      acc_out[ro * HF + c] = acc[k];
      if (with_pos) accpos_out[ro * HF + c] = accp[k];
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) dense_gat_bwd_kernel(
    const float* __restrict__ g,         // [Nd, H*F] grad of the output
    const float* __restrict__ ar,        // [Nd, H]
    const float* __restrict__ Mx,        // [Nd, H]   merged softmax maximum
    const float* __restrict__ Linv,      // [Nd, H]   1 / max(L, 1e-20)
    const float* __restrict__ ws,        // [Nd, H]   <g, out> per destination
    const float* __restrict__ ac,        // [Ns, H]   source coefficients
    const float* __restrict__ x,         // [Ns, H*F] source features
    const int* __restrict__ row_ids,     // [R] source ids
    const int* __restrict__ col_ids,     // [C] destination ids
    const uint32_t* __restrict__ mask,   // [T, kRT, kRowWords]
    const int* __restrict__ ct,          // [T]
    const int* __restrict__ chunk_ptr,   // [R / kRT + 1]
    int R, int H, int F, float slope, float p, float inv_keep, uint32_t seed,
    int bf16,
    float* __restrict__ dx_out,          // [R, H*F]
    float* __restrict__ dac_out) {       // [R, H]
  __shared__ WarpStage stage[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  WarpStage& st = stage[warp];
  const int HF = H * F;
  const bool drop = p > 0.f;
  const bool use_bf = bf16 != 0;
  const int chunk = r / kRT;
  const uint32_t sid = static_cast<uint32_t>(row_ids[r]);

  if (lane < H) st.head0[lane] = ac[static_cast<size_t>(sid) * H + lane];
  __syncwarp();

  float u2[kMaxHeads];  // this lane's edges' sum of a d' ws
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) u2[h] = 0.f;
  float dx[NC], tt[NC];  // sum a^ g and sum a^ d' g per column
  int hcol[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    dx[k] = tt[k] = 0.f;
    hcol[k] = c < HF ? c / F : 0;
  }

  for (int t = chunk_ptr[chunk]; t < chunk_ptr[chunk + 1]; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* did_tile = col_ids + static_cast<size_t>(ct[t]) * kCT;
    for (int w0 = 0; w0 < kRowWords; w0 += kPassWords) {
      const int total = compact_pass(mrow, w0, lane, st.cols);
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int n = min(32, total - e0);
        uint32_t did = 0;
        if (lane < n) {
          did = static_cast<uint32_t>(did_tile[st.cols[e0 + lane]]);
          const uint32_t base = drop ? pair_base(seed, did, sid) : 0u;
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) {
            if (h < H) {
              const size_t ih = static_cast<size_t>(did) * H + h;
              const float sr = ar[ih] + st.head0[h];
              const float a = expf(leaky(sr, slope) - Mx[ih]) * Linv[ih];
              float ah = a;
              if (drop) ah = pair_u_head(base, H, h) > p ? a * inv_keep : 0.f;
              const float dp = sr >= 0.f ? 1.f : slope;
              u2[h] += a * dp * ws[ih];
              st.w0[lane][h] = rnd(ah, use_bf);
              st.w1[lane][h] = ah * dp;
            }
          }
        }
        __syncwarp();
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint32_t di = __shfl_sync(kFull, did, i);
          const float* gr = g + static_cast<size_t>(di) * HF;
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int c = lane + 32 * k;
            if (c < HF) {
              const float gv = rnd(gr[c], use_bf);
              dx[k] += st.w0[i][hcol[k]] * gv;
              tt[k] += st.w1[i][hcol[k]] * gv;
            }
          }
        }
        __syncwarp();
      }
    }
  }

  const size_t ro = static_cast<size_t>(r);
  const float* xr = x + static_cast<size_t>(sid) * HF;
  float xt[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    xt[k] = c < HF ? rnd(xr[c], use_bf) * tt[k] : 0.f;
    if (c < HF) dx_out[ro * HF + c] = dx[k];
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < H) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (hcol[k] == h && lane + 32 * k < HF) v += xt[k];
      }
      v = warp_sum(v);
      const float u = warp_sum(u2[h]);
      if (lane == h) dac_out[ro * H + h] = v - u;
    }
  }
}

template <typename Launch>
int dispatch_nc(int HF, Launch&& launch) {
  switch (cols_per_lane(HF)) {
    case 1: launch(std::integral_constant<int, 1>{}); break;
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    case 8: launch(std::integral_constant<int, 8>{}); break;
    case 16: launch(std::integral_constant<int, 16>{}); break;
    case 32: launch(std::integral_constant<int, 32>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

int dgnn_dense_gat_fwd(const float* x, const float* ac, const float* ar,
                       const float* acmax, const int* row_ids,
                       const int* col_ids, const void* mask, const int* ct,
                       const int* chunk_ptr, int R, int H, int F, float slope,
                       int with_pos, float p, float inv_keep, uint32_t seed,
                       int bf16, float* m, float* l, float* lpos, float* acc,
                       float* accpos, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const int bad = dispatch_nc(H * F, [&](auto nc) {
    dense_gat_fwd_kernel<decltype(nc)::value>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            x, ac, ar, acmax, row_ids, col_ids,
            static_cast<const uint32_t*>(mask), ct, chunk_ptr, R, H, F, slope,
            with_pos, p, inv_keep, seed, bf16, m, l, lpos, acc, accpos);
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

int dgnn_dense_gat_bwd(const float* g, const float* ar, const float* M,
                       const float* Linv, const float* ws, const float* ac,
                       const float* x, const int* row_ids, const int* col_ids,
                       const void* mask, const int* ct, const int* chunk_ptr,
                       int R, int H, int F, float slope, float p,
                       float inv_keep, uint32_t seed, int bf16, float* dx,
                       float* dac, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const int bad = dispatch_nc(H * F, [&](auto nc) {
    dense_gat_bwd_kernel<decltype(nc)::value>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            g, ar, M, Linv, ws, ac, x, row_ids, col_ids,
            static_cast<const uint32_t*>(mask), ct, chunk_ptr, R, H, F, slope,
            p, inv_keep, seed, bf16, dx, dac);
  });
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
