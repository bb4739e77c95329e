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
// Design: dense_common.cuh's, which all four dense kernels share.  Each
// kernel has instances by the sizes held in registers (the models' or the
// general limits) and NC feature columns a lane (1, 8 or 32), picked by
// ops/dense.py dense_gmm_fwd_instance / dense_gmm_bwd_instance; the
// launchers refuse any other.
//
//   Forward: the row's beta is requested before its mask; lane i computes
//   edge i's D coordinates and K weights (KM kernels, DM dimensions held:
//   the models' K <= 4, D <= 2, or kGmmMaxK, kGmmMaxD) into its slot while
//   the first edges' rows of x are in flight.  Launch bounds cap the
//   registers (gmm_fwd_min_blocks).
//   Backward: the row's own alpha and x are requested before its mask.
//   Per edge the K dot products <x, g_v> take one interleaved butterfly
//   over the K values (reduce_scatter) instead of K warp sums.  Lane i
//   keeps edge i's stat terms in registers sized to the instance (the
//   models' K <= 4, D <= 2, Dd <= 2, or the general limits); after the
//   walk each lane that held an edge writes its sums to a warp-private
//   slab in shared memory and lane c adds column c over those lanes only,
//   instead of a warp sum per stat column.  Launch bounds cap the
//   registers (gmm_bwd_min_blocks).
//
//   Work list (graph/structure.py work_list, WorkList; ops/dense.py
//   gmm_work makes a block's at its first launch): a warp a block row let
//   one row set a launch's length.  On the Reddit stand-in block
//   row 0 (92,679 edges) walked alone for two thirds of K7's 48 ms and
//   K8's 69 ms, after every other row had ended (the kernels' row spans,
//   PERF.md §6).  Where a block has rows over the list's budget, a warp walks a
//   piece instead: a block row and a range [first, end) of its chunk's
//   schedule entries, at most the budget's edges unless one entry alone;
//   pieces in row order, so the longest rows' pieces start first.  A piece
//   of a cut row writes its sums (K8: its dx, then its stat row, its lanes'
//   slabs added as a whole row's are) into its row of the partials, and
//   dense_rows_merge_kernel adds each cut row's pieces in piece order into
//   the output row after the launch: no atomics, so a replay gives the same
//   bits, and only the order of a cut row's float32 sums changes.  The
//   budget (graph/structure.py split_budget) is the block's edges over
//   PIECES_PER_WARP times the warps these kernels keep resident on the card
//   (dgnn_dense_gmm_resident_warps, by the occupancy calculator), at least
//   one tile row's 2,048 edges, so blocks of short rows (cora's) keep a
//   warp a row and launch no merge.  Measured on the stand-in's blocks
//   (H100, 700 W, bf16, K = 2, F = 64, eager, medians of two sets of three;
//   76.5 M edges a block, 2,640 resident warps): a warp a row K7 50.0 ms,
//   K8 74.3 ms a launch; PIECES_PER_WARP 1: 18.6 / 33.0, 2: 16.1 / 32.1,
//   3: 16.2 / 32.9, 4: 16.0 / 31.9 (988 rows cut into 2,666 pieces of at
//   most 7,248 edges), 6: 16.2 / 33.1, 8: 16.4 / 33.1; the merge 3.5-4 us.
//   Holding a piece's slot over the walk took K7's model instance from 96
//   to more registers and four blocks an SM: 18.5 ms at its best.
//
// Bound on the H100: for cora-size blocks, the latency of the dependent
// loads per edge; the bytes are one row of K*F floats per edge (768 B at
// K=3, F=64), mostly served from L2.  Left for later PRs: tensor-core
// tiles for dense hub tiles.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"
#include "gmm_common.cuh"

namespace {

using dgnn::cols_per_lane;
using dgnn::gmm_coords;
using dgnn::gmm_row;
using dgnn::gmm_weight;
using dgnn::kCT;
using dgnn::kFull;
using dgnn::kGmmMaxD;
using dgnn::kGmmMaxDd;
using dgnn::kGmmMaxK;
using dgnn::kRT;
using dgnn::kRowWords;
using dgnn::kWarps;
using dgnn::rnd;
using dgnn::RowList;
using dgnn::stamp_row_end;
using dgnn::stamp_row_start;

// One warp's work item: block row and schedule entries [first, end).
// Without a work list, warp w walks block row w whole.
struct Piece {
  int row, first, end;
};

__device__ __forceinline__ Piece piece(const int4* __restrict__ work,
                                       const int* __restrict__ chunk_ptr,
                                       int w) {
  if (work != nullptr) {
    const int4 v = __ldg(work + w);
    return Piece{v.x, v.y, v.z};
  }
  const int chunk = w / kRT;
  return Piece{w, chunk_ptr[chunk], chunk_ptr[chunk + 1]};
}

// The calling warp's row of the partials, or -1 where its item is a whole
// row (or there is no list): read from the list after the walk, the item
// taken afresh from %ctaid and %tid, so that nothing is held over the walk
// for it (held from the start, it took K7's model instance past the 96
// registers that keep five blocks an SM).
__device__ __forceinline__ int piece_slot(const int4* __restrict__ work) {
  if (work == nullptr) return -1;
  unsigned int cta, tid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int* v = reinterpret_cast<const int*>(
      work + static_cast<size_t>(cta) * kWarps + (tid >> 5));
  return __ldg(v + 3);
}

// The forward's instances: KM kernels and DM dimensions held, the models'
// (4, 2) or the general (kGmmMaxK, kGmmMaxD), each at 1, 8 or 32 columns a
// lane (ops/dense.py dense_gmm_fwd_instance picks one).  The models'
// instances at up to 8 columns a lane are capped by their launch bounds at
// kGmmFwdMinBlocks blocks of kWarps rows an SM (at most 128 registers).
// ptxas gives the hidden layer's 92, so five blocks still fit and cora's
// 2,560 block rows are resident at once on 132 SMs; of the caps measured
// this one was fastest (a cap of five gave 89 registers and a slower
// schedule of the same loop).
constexpr int kGmmFwdMinBlocks = 4;
constexpr int gmm_fwd_min_blocks(int km, int nc) {
  return km <= 4 && nc <= 8 ? kGmmFwdMinBlocks : 1;
}
// Edges whose rows of x are requested together: as many as keep
// kGmmFwdPrefetch values a lane in flight, at most 8 edges.
constexpr int kGmmFwdPrefetch = 8;
__host__ __device__ constexpr int gmm_fwd_prefetch(int nc) {
  return nc >= kGmmFwdPrefetch ? 1 : kGmmFwdPrefetch / nc;
}

template <int KM, int DM, int NC>
__global__ void __launch_bounds__(kWarps * 32, gmm_fwd_min_blocks(KM, NC))
dense_gmm_fwd_kernel(
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
    const int4* __restrict__ work,       // [P] pieces, or null: a row each
    int P,
    float* __restrict__ acc_out,         // [R, K*F]
    float* __restrict__ part,            // [slots, K*F] cut rows' partials
    const int* __restrict__ probe,       // spans (dense_common.cuh)
    unsigned long long* __restrict__ spans) {  // [pieces, 2]
  constexpr int kSlot = KM | 1;  // floats a lane; odd: no bank conflicts
  constexpr int PF = gmm_fwd_prefetch(NC);
  __shared__ unsigned short cols[kWarps][32];  // per lane: its edge's column
  __shared__ float slot[kWarps][32 * kSlot];   // per lane: its edge's w_k
  __shared__ float mu_sh[KM * DM];             // index k * DM + d
  __shared__ float isig_sh[KM * DM];
  for (int i = threadIdx.x; i < KM * DM; i += blockDim.x) {
    const int k = i / DM, d = i % DM;
    const bool on = k < K && d < D;
    mu_sh[i] = on ? mu[k * D + d] : 0.f;
    isig_sh[i] = on ? isig[k * D + d] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= (work != nullptr ? P : R)) return;  // whole warps only
  stamp_row_start(probe, spans, w, lane);
  const Piece pc = piece(work, chunk_ptr, w);
  const int r = pc.row;
  const int KF = K * F;
  const bool use_bf = bf16 != 0;
  const bool tanh_on = use_tanh != 0;
  const int chunk = r / kRT;
  // the row's own beta is requested before its mask
  const size_t rid = static_cast<size_t>(row_ids[r]);
  const int t_end = pc.end;
  float b[DM];
  gmm_row<DM>(beta + rid * D, D, b);

  float acc[NC];
  int kcol[NC];  // the column's kernel (0 past K*F)
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    acc[j] = 0.f;
    kcol[j] = c < KF ? c / F : 0;
  }

  for (int t = pc.first; t < t_end; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* cid_tile = col_ids + static_cast<size_t>(__ldg(ct + t)) * kCT;
    RowList rl;
    rl.load(mrow, lane);
    for (int e0 = 0; e0 < rl.total; e0 += 32) {
      const int n = min(32, rl.total - e0);
      rl.emit(e0, cols[warp]);
      __syncwarp();
      // lane i: edge e0 + i's source (lanes past n: the last edge's)
      const uint32_t cid =
          static_cast<uint32_t>(__ldg(cid_tile + cols[warp][min(lane, n - 1)]));
      // rows of x for PF edges at a time, every lane loading an address in
      // the row and zeroing what lies past K*F; the first PF edges' rows
      // are requested before the Gaussian weights
      float xv[PF][NC];
      auto request = [&](int i0) {
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          const uint32_t cj = __shfl_sync(kFull, cid, min(i0 + u, n - 1));
          const float* xr = x + static_cast<size_t>(cj) * KF;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = lane + 32 * j;
            const float raw = __ldg(xr + min(c, KF - 1));
            xv[u][j] = c < KF ? rnd(raw, use_bf) : 0.f;
          }
        }
      };
      request(0);
      {
        // lane i: edge i's Gaussian weights (lanes past n compute the last
        // edge's again into a slot nobody reads)
        float a[DM], pc[DM], diff[DM], tk[DM];
        gmm_row<DM>(alpha + static_cast<size_t>(cid) * D, D, a);
        gmm_coords<DM>(b, a, D, tanh_on, pc);
        float* sl = slot[warp] + lane * kSlot;
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k < K) {
            sl[k] = rnd(gmm_weight<DM>(pc, mu_sh + k * DM, isig_sh + k * DM,
                                       D, diff, tk),
                        use_bf);
          }
        }
      }
      __syncwarp();
      // lanes over feature columns: the n edges' weighted rows
      for (int i0 = 0;;) {
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          if (i0 + u < n) {
            const float* sl = slot[warp] + (i0 + u) * kSlot;
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[j] += sl[kcol[j]] * xv[u][j];
          }
        }
        i0 += PF;
        if (i0 >= n) break;
        request(i0);
      }
      __syncwarp();  // before the next batch overwrites the staging
    }
  }

  const int ps = piece_slot(work);
  float* out = ps < 0 ? acc_out + static_cast<size_t>(r) * KF
                      : part + static_cast<size_t>(ps) * KF;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < KF) out[c] = acc[j];
  }
  stamp_row_end(probe, spans);
}

// The backward's instances: stat sizes held in registers (KM kernels, DM
// projected dimensions, DDM raw destination scalars), the models' (K <= 4,
// D <= 2, Dd <= 2: 2 * 4 * 2 + 2 + 4 = 22 sums a lane) and the general
// (kGmmMaxK, kGmmMaxD, kGmmMaxDd: 84), each at 1, 8 or 32 columns a lane
// (ops/dense.py dense_gmm_bwd_instance picks one).  The models' instances
// at up to 8 columns a lane keep kGmmBwdMinBlocks blocks of kWarps rows an
// SM by their launch bounds (at most 128 registers a thread: 2,112 of
// cora's 2,560 block rows resident at once on 132 SMs).  Of the caps
// measured on cora's hidden layer this one was fastest with nothing
// spilled: five blocks (102 registers) spilled and ran slower.
constexpr int kGmmBwdMinBlocks = 4;
constexpr int gmm_bwd_min_blocks(int km, int nc) {
  return km <= 4 && nc <= 8 ? kGmmBwdMinBlocks : 1;
}

template <int KM, int DM, int DDM>
struct BwdStage {
  static constexpr int kStat = 2 * KM * DM + DM + DM * DDM;  // sums a lane
  static constexpr int kSlab = kStat | 1;  // odd stride: no bank conflicts
  unsigned short cols[32];  // the batch's tile columns
  union {
    struct {
      float w[32][KM];   // per edge and kernel: w_k (rounded)
      float gw[32][KM];  // per edge and kernel: <x, g_v>
    } e;
    float slab[32 * kSlab];  // after the walk: each lane's stat sums
  } u;
};

template <int KM, int DM, int DDM, int NC>
__global__ void __launch_bounds__(kWarps * 32, gmm_bwd_min_blocks(KM, NC))
dense_gmm_bwd_kernel(
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
    const int4* __restrict__ work,       // [P] pieces, or null: a row each
    int P,
    float* __restrict__ dx_out,          // [R, K*F]
    float* __restrict__ st_out,          // [R, 2KD + D + D*Dd]
    float* __restrict__ part,            // [slots, K*F + 2KD + D + D*Dd]
    const int* __restrict__ probe,       // spans (dense_common.cuh)
    unsigned long long* __restrict__ spans) {  // [pieces, 2]
  using Stage = BwdStage<KM, DM, DDM>;
  __shared__ Stage stage[kWarps];
  __shared__ float mu_sh[KM * DM];    // index k * DM + d
  __shared__ float isig_sh[KM * DM];
  for (int i = threadIdx.x; i < KM * DM; i += blockDim.x) {
    const int k = i / DM, d = i % DM;
    const bool on = k < K && d < D;
    mu_sh[i] = on ? mu[k * D + d] : 0.f;
    isig_sh[i] = on ? isig[k * D + d] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= (work != nullptr ? P : R)) return;  // whole warps only
  stamp_row_start(probe, spans, w, lane);
  const Piece pc = piece(work, chunk_ptr, w);
  const int r = pc.row;
  Stage& st = stage[warp];
  const int KF = K * F;
  const int KD = K * D;
  const bool use_bf = bf16 != 0;
  const bool tanh_on = use_tanh != 0;
  const int chunk = r / kRT;
  // the row's own tables are requested before its mask
  const size_t sid = static_cast<size_t>(row_ids[r]);
  const int t_end = pc.end;
  float a[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) a[d] = d < D ? __ldg(alpha + sid * D + d) : 0.f;
  float dx[NC], xr[NC];  // sum w g per column; the row's own x (rounded)
  int kcol[NC];          // the column's kernel (0 past the row's end)
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    dx[j] = 0.f;
    kcol[j] = c < KF ? c / F : 0;
    xr[j] = c < KF ? rnd(__ldg(x + sid * KF + c), use_bf) : 0.f;
  }

  // this lane's edges' stat sums
  float s_ct[KM * DM], s_ctd[KM * DM];  // index k * DM + d
  float s_dpre[DM], s_df[DM * DDM];     // index d * DDM + i
#pragma unroll
  for (int i = 0; i < KM * DM; ++i) s_ct[i] = s_ctd[i] = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) s_dpre[d] = 0.f;
#pragma unroll
  for (int i = 0; i < DM * DDM; ++i) s_df[i] = 0.f;
  int held = 0;  // lanes that held an edge: min(32, the longest tile row)

  for (int t = pc.first; t < t_end; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* did_tile = col_ids + static_cast<size_t>(__ldg(ct + t)) * kCT;
    RowList rl;
    rl.load(mrow, lane);
    held = max(held, min(32, rl.total));
    for (int e0 = 0; e0 < rl.total; e0 += 32) {
      const int n = min(32, rl.total - e0);
      rl.emit(e0, st.cols);
      __syncwarp();
      // lane i: edge e0 + i's tables, coordinates and weights
      uint32_t did = 0;
      float p[DM], wk[KM], dfe[DDM];
      if (lane < n) {
        did = static_cast<uint32_t>(did_tile[st.cols[lane]]);
        float b[DM];
#pragma unroll
        for (int d = 0; d < DM; ++d)
          b[d] = d < D ? __ldg(beta + static_cast<size_t>(did) * D + d) : 0.f;
#pragma unroll
        for (int i = 0; i < DDM; ++i)
          dfe[i] = i < Dd ? __ldg(dfeat + static_cast<size_t>(did) * Dd + i)
                          : 0.f;
        float diff[DM], tt[DM];
        gmm_coords<DM>(a, b, D, tanh_on, p);
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k < K) {
            wk[k] = gmm_weight<DM>(p, mu_sh + k * DM, isig_sh + k * DM, D,
                                   diff, tt);
            st.u.e.w[lane][k] = rnd(wk[k], use_bf);
          }
        }
      }
      __syncwarp();
      // lanes over feature columns: dx and, per edge, the K dot products
      // <x, g_v> in one reduce-scatter.  Every lane loads an address in
      // the row (a branch around a load and its use made each edge wait
      // for its row in turn) and zeroes what lies past K*F.  Two edges at a time at one column a lane; at eight, one edge
      // at a time fits the registers and measured faster.
#pragma unroll(NC == 1 ? 2 : 1)
      for (int i = 0; i < n; ++i) {
        const uint32_t di = __shfl_sync(kFull, did, i);
        const float* gr = g + static_cast<size_t>(di) * KF;
        float gv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j)
          gv[j] = __ldg(gr + min(lane + 32 * j, KF - 1));
        float v[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) v[k] = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float gq = lane + 32 * j < KF ? rnd(gv[j], use_bf) : 0.f;
          dx[j] += st.u.e.w[i][kcol[j]] * gq;
          const float pr = xr[j] * gq;
#pragma unroll
          for (int k = 0; k < KM; ++k) v[k] += kcol[j] == k ? pr : 0.f;
        }
        const float s = dgnn::reduce_scatter<KM>(v, lane);
        const int k = lane / (32 / KM);
        if ((lane & (32 / KM - 1)) == 0 && k < K) st.u.e.gw[i][k] = s;
      }
      __syncwarp();
      // lane i: edge i's terms of the stat row
      if (lane < n) {
        float dp[DM];
#pragma unroll
        for (int d = 0; d < DM; ++d) dp[d] = 0.f;
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k < K) {
            const float c = st.u.e.gw[lane][k] * wk[k];
#pragma unroll
            for (int d = 0; d < DM; ++d) {
              if (d < D) {
                const float df = p[d] - mu_sh[k * DM + d];
                const float is = isig_sh[k * DM + d];
                const float ctd = c * (df * is);
                s_ct[k * DM + d] += ctd;
                s_ctd[k * DM + d] += ctd * df;
                dp[d] -= ctd * is;
              }
            }
          }
        }
#pragma unroll
        for (int d = 0; d < DM; ++d) {
          if (d < D) {
            const float dpre = tanh_on ? dp[d] * (1.f - p[d] * p[d]) : dp[d];
            s_dpre[d] += dpre;
#pragma unroll
            for (int i = 0; i < DDM; ++i) {
              if (i < Dd) s_df[d * DDM + i] += dpre * dfe[i];
            }
          }
        }
      }
      __syncwarp();  // before the next batch overwrites the staging
    }
  }

  const int ns = 2 * KD + D + D * Dd;
  // a piece of a cut row writes its dx and stat row side by side into its
  // row of the partials
  const int ps = piece_slot(work);
  float* dxo = ps < 0 ? dx_out + static_cast<size_t>(r) * KF
                      : part + static_cast<size_t>(ps) * (KF + ns);
  float* sto = ps < 0 ? st_out + static_cast<size_t>(r) * ns : dxo + KF;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < KF) dxo[c] = dx[j];
  }
  // the stat row: each lane that held an edge puts its sums in its row of
  // the slab; lane c adds column c over those lanes only
  if (lane < held) {
    float* slab = st.u.slab + lane * Stage::kSlab;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (k < K && d < D) {
          slab[k * D + d] = s_ct[k * DM + d];
          slab[KD + k * D + d] = s_ctd[k * DM + d];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (d < D) {
        slab[2 * KD + d] = s_dpre[d];
#pragma unroll
        for (int i = 0; i < DDM; ++i) {
          if (i < Dd) slab[2 * KD + D + d * Dd + i] = s_df[d * DDM + i];
        }
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < ns; c += 32) {
    float v = 0.f;
    for (int l = 0; l < held; ++l) v += st.u.slab[l * Stage::kSlab + c];
    sto[c] = v;
  }
  stamp_row_end(probe, spans);
}

// The rows cut into pieces: row merge_rows[i] of out_a ([R, wa]) and out_b
// ([R, wb], or none at wb = 0) is the sum of its pieces' rows of the
// partials, slots merge_ptr[i]:merge_ptr[i + 1] ([slots, wa + wb]: out_a's
// columns, then out_b's), added in slot order, so a replay gives the same
// bits.  A thread block a cut row, a thread a column.
__global__ void __launch_bounds__(128)
dense_rows_merge_kernel(const float* __restrict__ part,
                        const int* __restrict__ merge_rows,
                        const int* __restrict__ merge_ptr, int wa, int wb,
                        float* __restrict__ out_a, float* __restrict__ out_b) {
  const int i = blockIdx.x;
  const size_t r = static_cast<size_t>(merge_rows[i]);
  const int p0 = merge_ptr[i], p1 = merge_ptr[i + 1];
  const int width = wa + wb;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float v = 0.f;
    for (int p = p0; p < p1; ++p) v += part[static_cast<size_t>(p) * width + c];
    if (c < wa) out_a[r * wa + c] = v;
    else out_b[r * wb + (c - wa)] = v;
  }
}

bool bad_dims(int K, int D, int Dd, int F) {
  return K < 1 || K > kGmmMaxK || D < 1 || D > kGmmMaxD || Dd < 1 ||
         Dd > kGmmMaxDd || F < 1;
}

// Both kernels' instances take 1, 8 or 32 columns a lane of a warp: the
// fewest that cover K*F (at most 1024).
bool bad_cols(int KF, int nc) {
  return KF > 32 * 32 || nc != (KF <= 32 ? 1 : KF <= 8 * 32 ? 8 : 32);
}

}  // namespace

extern "C" {

// work: [P] int4 pieces (graph/structure.py work_list), or null: a warp a
// block row.  With a list, the S rows cut into pieces (merge_rows,
// merge_ptr) are summed from part into their output rows by
// dense_rows_merge_kernel, launched after the kernel on the same stream.
int dgnn_dense_gmm_fwd(const float* x, const float* alpha, const float* beta,
                       const int* row_ids, const int* col_ids,
                       const void* mask, const int* ct, const int* chunk_ptr,
                       const float* mu, const float* isig, int R, int K, int D,
                       int F, int use_tanh, int bf16, int general, int nc,
                       const void* work, int P, const int* merge_rows,
                       const int* merge_ptr, int S, float* acc, float* part,
                       const int* probe, unsigned long long* spans,
                       void* stream) {
  // the instance ops/dense.py dense_gmm_fwd_instance chose, checked
  const bool fits = general ? true : K <= 4 && D <= 2;
  if (bad_dims(K, D, 1, F) || !fits || bad_cols(K * F, nc) ||
      dgnn::bad_probe(probe, spans) ||
      (work != nullptr && (P <= 0 || S <= 0 || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int items = work != nullptr ? P : R;
  const int blocks = (items + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  const int4* wl = static_cast<const int4*>(work);
#define DGNN_GMM_FWD(KM, DM, NC)                                         \
  dense_gmm_fwd_kernel<KM, DM, NC><<<blocks, kWarps * 32, 0, s>>>(        \
      x, alpha, beta, row_ids, col_ids, m, ct, chunk_ptr, mu, isig, R, K, \
      D, F, use_tanh, bf16, wl, P, acc, part, probe, spans)
  if (!general) {
    if (nc == 1) DGNN_GMM_FWD(4, 2, 1);
    else if (nc == 8) DGNN_GMM_FWD(4, 2, 8);
    else DGNN_GMM_FWD(4, 2, 32);
  } else {
    if (nc == 1) DGNN_GMM_FWD(kGmmMaxK, kGmmMaxD, 1);
    else if (nc == 8) DGNN_GMM_FWD(kGmmMaxK, kGmmMaxD, 8);
    else DGNN_GMM_FWD(kGmmMaxK, kGmmMaxD, 32);
  }
#undef DGNN_GMM_FWD
  if (work != nullptr) {
    dense_rows_merge_kernel<<<S, 128, 0, s>>>(part, merge_rows, merge_ptr,
                                              K * F, 0, acc, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int dgnn_dense_gmm_bwd(const float* g, const float* beta, const float* dfeat,
                       const float* alpha, const float* x, const int* row_ids,
                       const int* col_ids, const void* mask, const int* ct,
                       const int* chunk_ptr, const float* mu,
                       const float* isig, int R, int K, int D, int Dd, int F,
                       int use_tanh, int bf16, int general, int nc,
                       const void* work, int P, const int* merge_rows,
                       const int* merge_ptr, int S, float* dx, float* st,
                       float* part, const int* probe,
                       unsigned long long* spans, void* stream) {
  // the instance ops/dense.py dense_gmm_bwd_instance chose, checked
  const bool fits = general ? true : K <= 4 && D <= 2 && Dd <= 2;
  if (bad_dims(K, D, Dd, F) || !fits || bad_cols(K * F, nc) ||
      dgnn::bad_probe(probe, spans) ||
      (work != nullptr && (P <= 0 || S <= 0 || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int items = work != nullptr ? P : R;
  const int blocks = (items + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  const int4* wl = static_cast<const int4*>(work);
#define DGNN_GMM_BWD(KM, DM, DDM, NC)                                        \
  dense_gmm_bwd_kernel<KM, DM, DDM, NC><<<blocks, kWarps * 32, 0, s>>>(      \
      g, beta, dfeat, alpha, x, row_ids, col_ids, m, ct, chunk_ptr, mu, isig, \
      R, K, D, Dd, F, use_tanh, bf16, wl, P, dx, st, part, probe, spans)
  if (!general) {
    if (nc == 1) DGNN_GMM_BWD(4, 2, 2, 1);
    else if (nc == 8) DGNN_GMM_BWD(4, 2, 2, 8);
    else DGNN_GMM_BWD(4, 2, 2, 32);
  } else {
    if (nc == 1) DGNN_GMM_BWD(kGmmMaxK, kGmmMaxD, kGmmMaxDd, 1);
    else if (nc == 8) DGNN_GMM_BWD(kGmmMaxK, kGmmMaxD, kGmmMaxDd, 8);
    else DGNN_GMM_BWD(kGmmMaxK, kGmmMaxD, kGmmMaxDd, 32);
  }
#undef DGNN_GMM_BWD
  if (work != nullptr) {
    dense_rows_merge_kernel<<<S, 128, 0, s>>>(part, merge_rows, merge_ptr,
                                              K * F, 2 * K * D + D + D * Dd,
                                              dx, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most warps that the forward's and the backward's instances holding
// the models' sizes at 8 columns a lane (the hidden layers') keep resident
// on the current device: thread blocks an SM by the occupancy calculator,
// times the SMs and kWarps.  The work list's budget divides by it.
int dgnn_dense_gmm_resident_warps(int* warps) {
  int dev = 0, sms = 0, fwd = 0, bwd = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fwd, dense_gmm_fwd_kernel<4, 2, 8>, kWarps * 32, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bwd, dense_gmm_bwd_kernel<4, 2, 2, 8>, kWarps * 32, 0);
  *warps = (fwd > bwd ? fwd : bwd) * sms * kWarps;
  return static_cast<int>(e);
}

}  // extern "C"
