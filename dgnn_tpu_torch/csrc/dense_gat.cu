// Dense hub-block GAT passes for NVIDIA Hopper (sm_90a).
//
// The hub block (graph/hub.py, tile geometry and mask format in
// dense_common.cuh) is a tile-sparse [R, C] adjacency between the block's
// rows (row_ids) and columns (col_ids).
//
//   dense_gat_fwd_kernel  replaces dgnn_tpu/ops/pallas_dense.py:dense_gat_fwd
//     (kernel _gat_fwd_kernel).  Rows = destinations, columns = sources.
//     Per row r and head h, with s_raw = ar[row_ids[r]] + ac[col_ids[c]]:
//       m    = max LeakyReLU(s_raw) over the row's set bits (exact)
//       p    = exp(LeakyReLU(s_raw) - m) where the mask bit is set
//       l    = sum p,      acc    = sum p^ x[col_ids[c]]
//       lpos = sum_{s_raw >= 0} p,  accpos = sum_{s_raw >= 0} p^ x
//     with p^ = p after attention dropout.  A row with no set bit gives
//     m = -1e30 (an empty segment, as the bins') and zero partials.  The
//     TPU kernel returns as m a bound, bound_r = LeakyReLU(ar_r + max ac
//     over all the block's columns) (acmax), and its partials relative to
//     it: where a row's scores lie more than about 46 under it, L falls
//     under the combine's 1e-20 clamp, and past 87 exp(s - bound)
//     underflows, so the row's output shrinks or vanishes.  Here a warp
//     walks its row first as the TPU kernel does, at the bound, keeping
//     each lane's largest score; then one reduction gives m.  Where m lies
//     at most kBoundGap under the bound the sums are restated at m (one
//     multiply each); else a second launch of the kernel walks the row
//     again at m (a row that needs none ends there at once).  So the
//     first walk rounds p^ in bf16 mode exactly as the TPU kernel does,
//     and a second walk is paid only where the bound is too loose.
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
// backward a^, g and x (the forward's p^ at the bound's scale, as the TPU
// kernel's, on a row's first walk; at m on a second).  Everything else
// stays f32, including the a^ inside dac's first term.  One detail:
// without dropout the TPU kernel's l and lpos ride the matmul's ones
// column, so they are sums of bf16-rounded p; with dropout they are f32
// sums of unrounded p.  Both cases are matched.
//
// Design: dense_common.cuh's, which all four dense kernels share.  Each
// has instances by (HMAX heads held, 4 or kMaxHeads; NC feature columns a
// lane, 1 to 32), picked by ops/dense.py dense_gat_fwd_instance /
// dense_gat_bwd_instance; the launchers refuse any other.
//
//   Forward: the row's ar and the walk's reference (the bound, then m) sit
//   in shared memory; l and lpos are per-lane sums that a slab in shared
//   memory gathers at the end over the lanes that held an edge; each lane
//   keeps its edges' largest score in its slot's free half.  A group of
//   8 lanes a row at the output layer (4 rows a warp) measured slower than
//   a warp a row.  Keeping m exact online instead (a batch's maximum and a
//   rescale of the sums wherever it rose) measured 2-10 % slower on the
//   Reddit stand-in, whether the batch's maximum was reduced every batch
//   or only after a vote.
//   Backward: the row's ac is requested before its mask and its x row
//   after the walk; lane i requests edge i's ar, M, Linv and ws rows
//   together, HMAX values each.  dac's two terms, <x_j, sum a^ d' g> over
//   the columns and sum a d' ws over the edges, meet in one reduce-scatter
//   over the warp (HMAX - 1 + 5 - log2 HMAX shuffles, not 2 H warp sums).
//
// Bound on the H100: for cora-size blocks, the latency of the dependent
// loads per edge; per edge the work is H exps and hashes and H*F
// multiply-adds, and the bytes are one feature row (1 KB at H=4, F=64)
// mostly served from L2.  Left for later PRs: balancing hub rows with
// thousands of edges over several warps, and tensor-core tiles for dense
// hub tiles.
//
// Dropout re-derives pair_keep bit for bit (gat_common.cuh) on the global
// ids: forward dst = row_ids[r], src = col_ids[c]; backward dst =
// col_ids[c], src = row_ids[r].  On a graph shard (parallel/partition.py)
// the block's ids are local and extended ids, and the launcher is given
// the shard's table of global ids (ext_gids, `gid`): the hash reads both
// ids through it, so the mask is the single-device graph's, while the
// gathers keep the block's own ids.  Without a table (null) the ids are
// hashed as they are.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"
#include "gat_common.cuh"

namespace {

using dgnn::cols_per_lane;
using dgnn::kCT;
using dgnn::kFull;
using dgnn::kRT;
using dgnn::kRowWords;
using dgnn::kWarps;
using dgnn::leaky;
using dgnn::pair_base;
using dgnn::pair_u_head;
using dgnn::reduce_scatter;
using dgnn::rnd;
using dgnn::RowList;
using dgnn::stamp_row_end;
using dgnn::stamp_row_start;

constexpr int kMaxHeads = 16;          // the wrapper refuses H > kMaxHeads
constexpr float kNegB = -1e30f;  // finite "-inf": max of an empty segment
// The widest gap between a row's bound and its largest score at which the
// first walk's sums, weighed at the bound, are kept (ops/dense.py
// BOUND_GAP; tests/test_torch_hub_max.py holds the two equal): their
// largest term is then at least exp(-40), and a term that underflows lies
// e^-47 under it.
constexpr float kBoundGap = 40.f;
// The forward's row probe: two stamps, then the row's edges walked again
// and its edges (utils/profiling.py row_raises).
constexpr int kGatFwdProbe = 4;

// The forward's instances: HMAX heads held (4 or kMaxHeads), NC columns a
// lane (ops/dense.py dense_gat_fwd_instance picks one).  Those with 4 heads
// and up to 8 columns a lane keep kGatFwdMinBlocks blocks of kWarps rows an
// SM by their launch bounds (at most 102 registers a thread): cora's 2,560
// block rows are then resident at once on 132 SMs.  Those of 1 or 2
// columns a lane (the output layers) keep kGatFwdNarrowMinBlocks (at most
// 73): the exact maximum's bookkeeping took the 2-column instance from 72
// to 79 registers and six blocks an SM, 4 % slower on the Reddit
// stand-in's output layer than the bound alone (2 % at 72).
constexpr int kGatFwdMinBlocks = 5;
constexpr int kGatFwdNarrowMinBlocks = 7;
constexpr int gat_fwd_min_blocks(int hmax, int nc) {
  return hmax > 4 ? 1 : nc <= 2 ? kGatFwdNarrowMinBlocks
                                : nc <= 8 ? kGatFwdMinBlocks : 1;
}
// Edges whose feature rows are requested together: as many as keep
// kGatFwdPrefetch values a lane in flight, at most 8 edges.
constexpr int kGatFwdPrefetch = 8;
__host__ __device__ constexpr int gat_fwd_prefetch(int nc) {
  return nc >= kGatFwdPrefetch ? 1 : kGatFwdPrefetch / nc;
}

template <int HMAX, int NC>
__global__ void __launch_bounds__(kWarps * 32, gat_fwd_min_blocks(HMAX, NC))
dense_gat_fwd_kernel(
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
    const uint32_t* __restrict__ seed_p, const int* __restrict__ gid,
    int bf16, int again,                 // again: the second launch
    int* __restrict__ far_rows,          // [1] rows the second walks (zeroed)
    float* __restrict__ m_out,           // [R, H]: written, or read (again)
    float* __restrict__ l_out,           // [R, H]
    float* __restrict__ lpos_out,        // [R, H]    (with_pos)
    float* __restrict__ acc_out,         // [R, H*F]
    float* __restrict__ accpos_out,      // [R, H*F]  (with_pos)
    const int* __restrict__ probe,       // row spans (dense_common.cuh)
    unsigned long long* __restrict__ spans) {  // [R, kGatFwdProbe]
  constexpr int kSlot = 2 * HMAX + 1;  // floats a lane; odd: no bank conflicts
  constexpr int PF = gat_fwd_prefetch(NC);
  __shared__ unsigned short cols[kWarps][32];  // per lane: its edge's column
  __shared__ uint32_t posb[kWarps][32];        // its edge's bit h: s_raw >= 0
  // per lane: its edge's p^ a head, and its edges' largest score a head
  // (first walk); after the walks, its l and lpos sums
  __shared__ float slot[kWarps][32 * kSlot];
  __shared__ float head[kWarps][2 * HMAX];  // the row's ar and reference
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  // the second launch ends at once where the first found no far row
  if (again && *static_cast<volatile int*>(far_rows) == 0) return;
  stamp_row_start<kGatFwdProbe>(probe, spans, r, lane);
  const int HF = H * F;
  const bool drop = p > 0.f;
  // the dropout seed (gat_common.cuh): one load before the walk
  const uint32_t seed = drop ? __ldg(seed_p) : 0u;
  const bool use_bf = bf16 != 0;
  const int chunk = r / kRT;
  const uint32_t rid = static_cast<uint32_t>(row_ids[r]);
  // the ids the dropout hash takes: global ids where a table is given
  // (graph shards); the gathers keep the block's own ids
  const uint32_t hrid = drop && gid ? static_cast<uint32_t>(__ldg(gid + rid))
                                    : rid;
  const int t_end = chunk_ptr[chunk + 1];
  float* hd = head[warp];
  // the walk's reference: the bound (the first launch), or the row's m
  // where that lies more than kBoundGap under the bound (the second: any
  // other row ends here)
  bool far = false;
  if (lane < H) {
    const float a = __ldg(ar + static_cast<size_t>(rid) * H + lane);
    const float b = leaky(a + __ldg(acmax + lane), slope);
    const float m = again ? m_out[static_cast<size_t>(r) * H + lane] : b;
    far = m > kNegB && b - m > kBoundGap;
    hd[lane] = a;
    hd[HMAX + lane] = m;
  }
  if (again && !__any_sync(kFull, far)) return;
  {  // this lane's edges' largest scores, in its slot's free half
    float* top = slot[warp] + lane * kSlot + HMAX;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) top[h] = kNegB;
  }
  __syncwarp();

  float lsum[HMAX], lpsum[HMAX];  // this lane's edges' sums
#pragma unroll
  for (int h = 0; h < HMAX; ++h) lsum[h] = lpsum[h] = 0.f;
  float acc[NC], accp[NC];
  int hcol[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    acc[k] = accp[k] = 0.f;
    hcol[k] = c < HF ? c / F : 0;
  }
  int held = 0;  // lanes that held an edge: min(32, the longest tile row)
  int edges = 0;  // the row's edges

  {
    for (int t = chunk_ptr[chunk]; t < t_end; ++t) {
      const uint32_t* mrow =
          mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
      const int* cid_tile = col_ids + static_cast<size_t>(__ldg(ct + t)) * kCT;
      RowList rl;
      rl.load(mrow, lane);
      held = max(held, min(32, rl.total));
      edges += rl.total;
      for (int e0 = 0; e0 < rl.total; e0 += 32) {
        const int n = min(32, rl.total - e0);
        rl.emit(e0, cols[warp]);
        __syncwarp();
        // lane i: edge e0 + i's per-head weights
        uint32_t cid = 0;
        if (lane < n) {
          cid = static_cast<uint32_t>(cid_tile[cols[warp][lane]]);
          const float* acj = ac + static_cast<size_t>(cid) * H;
          const uint32_t pb =
              drop ? pair_base(seed, hrid, gid ? __ldg(gid + cid) : cid) : 0u;
          float* sl = slot[warp] + lane * kSlot;
          uint32_t pos = 0;
#pragma unroll
          for (int h = 0; h < HMAX; ++h) {
            if (h < H) {
              const float sr = hd[h] + __ldg(acj + h);
              const float sv = leaky(sr, slope);
              sl[HMAX + h] = fmaxf(sl[HMAX + h], sv);  // the largest
              const float pw = expf(sv - hd[HMAX + h]);
              float pd = pw;
              if (drop) pd = pair_u_head(pb, H, h) > p ? pw * inv_keep : 0.f;
              pd = rnd(pd, use_bf);
              // l: bf16-rounded p without dropout, f32 p with it (header)
              const float lw = drop ? pw : pd;
              sl[h] = pd;
              lsum[h] += lw;
              if (sr >= 0.f) {
                pos |= 1u << h;
                lpsum[h] += lw;
              }
            }
          }
          posb[warp][lane] = pos;
        }
        __syncwarp();
        // lanes over feature columns: the n edges' weighted rows, PF edges'
        // rows requested before any of them is used (left to itself, the
        // compiler waits on each edge's loads in turn); every lane loads an
        // address in the row and zeroes what lies past H*F
        for (int i0 = 0; i0 < n; i0 += PF) {
          float xv[PF][NC];
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            const uint32_t cj = __shfl_sync(kFull, cid, min(i0 + u, n - 1));
            const float* xr = x + static_cast<size_t>(cj) * HF;
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const int c = lane + 32 * k;
              const float raw = __ldg(xr + min(c, HF - 1));
              xv[u][k] = c < HF ? raw : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < PF; ++u) {
            if (i0 + u < n) {
              const float* sl = slot[warp] + (i0 + u) * kSlot;
              const uint32_t pos = posb[warp][i0 + u];
#pragma unroll
              for (int k = 0; k < NC; ++k) {
                const float v = sl[hcol[k]] * rnd(xv[u][k], use_bf);
                acc[k] += v;
                if ((pos >> hcol[k]) & 1u) accp[k] += v;
              }
            }
          }
        }
        __syncwarp();  // before the next batch overwrites the staging
      }
    }
  }
  if (!again) {
    // the row's largest score a head (kNegB: no edge): its m; the sums,
    // weighed at the bound, restated at m where it lies at most
    // kBoundGap under it (else the second launch walks the row again)
    float mh = kNegB;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) {
        const float m =
            dgnn::warp_max(slot[warp][lane * kSlot + HMAX + h]);
        far |= m > kNegB && hd[HMAX + h] - m > kBoundGap;
        if (lane == h) mh = m;
      }
    }
    // the scale a head passes through the first slots
    float* scale = slot[warp];
    __syncwarp();  // every lane has read the bounds and its slot
    if (lane < H) {
      scale[lane] = mh > kNegB && !far ? expf(hd[HMAX + lane] - mh) : 1.f;
      m_out[static_cast<size_t>(r) * H + lane] = mh;
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) {
        lsum[h] *= scale[h];
        lpsum[h] *= scale[h];
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float sc = scale[hcol[k]];
      acc[k] *= sc;
      accp[k] *= sc;
    }
    __syncwarp();  // before the sums take the slots
    if (far && lane == 0) atomicAdd(far_rows, 1);  // a count; no result
  }

  const size_t ro = static_cast<size_t>(r);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < HF) {
      acc_out[ro * HF + c] = acc[k];
      if (with_pos) accpos_out[ro * HF + c] = accp[k];
    }
  }
  // l and lpos: each lane that held an edge puts its sums in its slot;
  // lane h adds head h over those lanes only
  if (lane < held) {
    float* sl = slot[warp] + lane * kSlot;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) {
        sl[h] = lsum[h];
        sl[HMAX + h] = lpsum[h];
      }
    }
  }
  __syncwarp();
  if (lane < H) {
    float lh = 0.f, lph = 0.f;
    for (int i = 0; i < held; ++i) {
      lh += slot[warp][i * kSlot + lane];
      lph += slot[warp][i * kSlot + HMAX + lane];
    }
    l_out[ro * H + lane] = lh;
    if (with_pos) lpos_out[ro * H + lane] = lph;
  }
  stamp_row_end<kGatFwdProbe>(probe, spans, far ? edges : 0, edges);
}

// The backward's instances, as the forward's: HMAX heads held, NC columns
// a lane (ops/dense.py dense_gat_bwd_instance).  Those with 4 heads and up
// to 8 columns a lane keep kGatBwdMinBlocks blocks of kWarps rows an SM by
// their launch bounds (at most 96 registers, none spilled): cora's 2,560
// block rows are then resident at once on 132 SMs.  Without the cap (158
// registers) and at four blocks (128) the hidden layer measured slower.
// The row's own x is read after the walk: requested before the mask, its
// NC values a lane spilled at this cap and gained nothing.
constexpr int kGatBwdMinBlocks = 5;
constexpr int gat_bwd_min_blocks(int hmax, int nc) {
  return hmax <= 4 && nc <= 8 ? kGatBwdMinBlocks : 1;
}
// Edges whose rows of g are requested together: as many as keep
// kGatBwdPrefetch values a lane in flight, at most 8 edges.
constexpr int kGatBwdPrefetch = 8;
__host__ __device__ constexpr int gat_bwd_prefetch(int nc) {
  return nc >= kGatBwdPrefetch ? 1 : kGatBwdPrefetch / nc;
}

// v[h] = tab[node * H + min(h, H - 1)] for h < HMAX: a node's row of an
// [N, H] table, its last value repeated past H, from addresses every lane
// may load.  (One 16-byte load a row at H = 4 measured no faster and cost
// registers.)
template <int HMAX>
__device__ __forceinline__ void head_row(const float* __restrict__ tab,
                                         uint32_t node, int H,
                                         float (&v)[HMAX]) {
  const float* row = tab + static_cast<size_t>(node) * H;
#pragma unroll
  for (int h = 0; h < HMAX; ++h) v[h] = __ldg(row + min(h, H - 1));
}

template <int HMAX, int NC>
__global__ void __launch_bounds__(kWarps * 32, gat_bwd_min_blocks(HMAX, NC))
dense_gat_bwd_kernel(
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
    int R, int H, int F, float slope, float p, float inv_keep,
    const uint32_t* __restrict__ seed_p,
    const int* __restrict__ gid, int bf16,
    float* __restrict__ dx_out,          // [R, H*F]
    float* __restrict__ dac_out,         // [R, H]
    const int* __restrict__ probe,       // row spans (dense_common.cuh)
    unsigned long long* __restrict__ spans) {  // [R, 2]
  constexpr int kSlot = 2 * HMAX + 1;  // floats a lane; odd: no bank conflicts
  constexpr int PF = gat_bwd_prefetch(NC);
  __shared__ unsigned short cols[kWarps][32];  // per lane: its edge's column
  // per lane: its edge's a^ (rounded) and a^ d' a head
  __shared__ float slot[kWarps][32 * kSlot];
  // each warp's dropout seed (gat_common.cuh), read here at each use: held
  // in a register across the walk, the <4, 2> instance (reddit's output
  // layer) ran 5 % slower than with the seed passed by value
  __shared__ uint32_t seed[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps only; no block-wide barrier follows
  stamp_row_start(probe, spans, r, lane);
  const int HF = H * F;
  const bool drop = p > 0.f;
  // one load before the walk
  if (lane == 0) seed[warp] = drop ? __ldg(seed_p) : 0u;
  __syncwarp();
  const bool use_bf = bf16 != 0;
  const int chunk = r / kRT;
  // the row's own ac is requested before its mask (its x after the walk)
  const uint32_t sid = static_cast<uint32_t>(row_ids[r]);
  // the ids the dropout hash takes: global ids where a table is given
  // (graph shards); the gathers keep the block's own ids
  const uint32_t hsid = drop && gid ? static_cast<uint32_t>(__ldg(gid + sid))
                                    : sid;
  const int t_end = chunk_ptr[chunk + 1];
  float acs[HMAX];  // ac of the row, a head
  head_row<HMAX>(ac, sid, H, acs);
  float dx[NC], tt[NC];  // sum a^ g and sum a^ d' g per column
  int hcol[NC];          // the column's head (0 past H*F)
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    dx[k] = tt[k] = 0.f;
    hcol[k] = c < HF ? c / F : 0;
  }
  float u2[HMAX];  // this lane's edges' sum of a d' ws
#pragma unroll
  for (int h = 0; h < HMAX; ++h) u2[h] = 0.f;

  for (int t = chunk_ptr[chunk]; t < t_end; ++t) {
    const uint32_t* mrow =
        mask + (static_cast<size_t>(t) * kRT + (r - chunk * kRT)) * kRowWords;
    const int* did_tile = col_ids + static_cast<size_t>(__ldg(ct + t)) * kCT;
    RowList rl;
    rl.load(mrow, lane);
    for (int e0 = 0; e0 < rl.total; e0 += 32) {
      const int n = min(32, rl.total - e0);
      rl.emit(e0, cols[warp]);
      __syncwarp();
      // lane i: edge e0 + i's destination (lanes past n: the last edge's)
      const uint32_t did =
          static_cast<uint32_t>(__ldg(did_tile + cols[warp][min(lane, n - 1)]));
      // rows of g for PF edges at a time, every lane loading an address in
      // the row and zeroing what lies past H*F; the first PF edges' rows
      // are requested before the per-edge scalars
      float gv[PF][NC];
      auto request = [&](int i0) {
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          const uint32_t di = __shfl_sync(kFull, did, min(i0 + u, n - 1));
          const float* gr = g + static_cast<size_t>(di) * HF;
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int c = lane + 32 * k;
            const float raw = __ldg(gr + min(c, HF - 1));
            gv[u][k] = c < HF ? rnd(raw, use_bf) : 0.f;
          }
        }
      };
      request(0);
      {
        // lane i: edge i's per-head weights (lanes past n compute the last
        // edge's again and keep none of it)
        float arv[HMAX], mxv[HMAX], liv[HMAX], wsv[HMAX];
        head_row<HMAX>(ar, did, H, arv);
        head_row<HMAX>(Mx, did, H, mxv);
        head_row<HMAX>(Linv, did, H, liv);
        head_row<HMAX>(ws, did, H, wsv);
        const uint32_t pb =
            drop ? pair_base(seed[warp], gid ? __ldg(gid + did) : did, hsid)
                 : 0u;
        const bool live = lane < n;
        float* sl = slot[warp] + lane * kSlot;
#pragma unroll
        for (int h = 0; h < HMAX; ++h) {
          if (h < H) {
            const float sr = arv[h] + acs[h];
            const float a = expf(leaky(sr, slope) - mxv[h]) * liv[h];
            float ah = a;
            if (drop) ah = pair_u_head(pb, H, h) > p ? a * inv_keep : 0.f;
            const float dp = sr >= 0.f ? 1.f : slope;
            u2[h] += live ? a * dp * wsv[h] : 0.f;
            sl[h] = rnd(ah, use_bf);
            sl[HMAX + h] = ah * dp;
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
            for (int k = 0; k < NC; ++k) {
              dx[k] += sl[hcol[k]] * gv[u][k];
              tt[k] += sl[HMAX + hcol[k]] * gv[u][k];
            }
          }
        }
        i0 += PF;
        if (i0 >= n) break;
        request(i0);
      }
      __syncwarp();  // before the next batch overwrites the staging
    }
  }

  const size_t ro = static_cast<size_t>(r);
  // dac[h] = sum over the columns of head h of x t, less sum a d' ws: each
  // lane's share of both, then one reduce-scatter over the warp
  const float* xrow = x + static_cast<size_t>(sid) * HF;
  float v[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) v[h] = -u2[h];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < HF) dx_out[ro * HF + c] = dx[k];
    const float raw = __ldg(xrow + min(c, HF - 1));
    const float xt = c < HF ? rnd(raw, use_bf) * tt[k] : 0.f;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) v[h] += hcol[k] == h ? xt : 0.f;
  }
  const float s = reduce_scatter<HMAX>(v, lane);
  const int h = lane / (32 / HMAX);
  if ((lane & (32 / HMAX - 1)) == 0 && h < H) dac_out[ro * H + h] = s;
  stamp_row_end(probe, spans);
}

// Both kernels' instances: heads held 4 or kMaxHeads (at least H), the
// fewest columns a lane (a power of two) that cover H*F.
bool bad_instance(int H, int F, int hmax, int nc) {
  return H < 1 || F < 1 || H > hmax || (hmax != 4 && hmax != kMaxHeads) ||
         cols_per_lane(H * F) != nc || nc > 32;
}

// Launches LAUNCH(HM, nc) at the nc the launcher checked.
#define DGNN_GAT_NC(LAUNCH, HM)            \
  if (nc == 1) LAUNCH(HM, 1);              \
  else if (nc == 2) LAUNCH(HM, 2);         \
  else if (nc == 4) LAUNCH(HM, 4);         \
  else if (nc == 8) LAUNCH(HM, 8);         \
  else if (nc == 16) LAUNCH(HM, 16);       \
  else LAUNCH(HM, 32)

}  // namespace

extern "C" {

int dgnn_dense_gat_fwd(const float* x, const float* ac, const float* ar,
                       const float* acmax, const int* row_ids,
                       const int* col_ids, const void* mask, const int* ct,
                       const int* chunk_ptr, int R, int H, int F, float slope,
                       int with_pos, float p, float inv_keep, const uint32_t* seed,
                       const int* gid, int bf16, int hmax, int nc, float* m,
                       float* l,
                       float* lpos, float* acc, float* accpos, int* far_rows,
                       const int* probe, unsigned long long* spans,
                       void* stream) {
  // the instance ops/dense.py dense_gat_fwd_instance chose, checked
  if (bad_instance(H, F, hmax, nc) || dgnn::bad_probe(probe, spans)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* msk = static_cast<const uint32_t*>(mask);
  // the row walk, then the second walk of the rows whose m lies more than
  // kBoundGap under the bound (the others end at once; no row spans)
  cudaMemsetAsync(far_rows, 0, sizeof(int), s);
  for (int again = 0; again < 2; ++again) {
    const int* pr = again ? nullptr : probe;
    unsigned long long* sp = again ? nullptr : spans;
#define DGNN_GAT_FWD(HM, NCC)                                               \
  dense_gat_fwd_kernel<HM, NCC><<<blocks, kWarps * 32, 0, s>>>(              \
      x, ac, ar, acmax, row_ids, col_ids, msk, ct, chunk_ptr, R, H, F, slope, \
      with_pos, p, inv_keep, seed, gid, bf16, again, far_rows, m, l, lpos,   \
      acc, accpos,                                                          \
      pr, sp)
    if (hmax == 4) {
      DGNN_GAT_NC(DGNN_GAT_FWD, 4);
    } else {
      DGNN_GAT_NC(DGNN_GAT_FWD, kMaxHeads);
    }
#undef DGNN_GAT_FWD
  }
  return static_cast<int>(cudaGetLastError());
}

int dgnn_dense_gat_bwd(const float* g, const float* ar, const float* M,
                       const float* Linv, const float* ws, const float* ac,
                       const float* x, const int* row_ids, const int* col_ids,
                       const void* mask, const int* ct, const int* chunk_ptr,
                       int R, int H, int F, float slope, float p,
                       float inv_keep, const uint32_t* seed, const int* gid,
                       int bf16, int hmax, int nc, float* dx, float* dac,
                       const int* probe, unsigned long long* spans,
                       void* stream) {
  // the instance ops/dense.py dense_gat_bwd_instance chose, checked
  if (bad_instance(H, F, hmax, nc) || dgnn::bad_probe(probe, spans)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (R + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* msk = static_cast<const uint32_t*>(mask);
#define DGNN_GAT_BWD(HM, NCC)                                                \
  dense_gat_bwd_kernel<HM, NCC><<<blocks, kWarps * 32, 0, s>>>(               \
      g, ar, M, Linv, ws, ac, x, row_ids, col_ids, msk, ct, chunk_ptr, R, H, \
      F, slope, p, inv_keep, seed, gid, bf16, dx, dac, probe, spans)
  if (hmax == 4) {
    DGNN_GAT_NC(DGNN_GAT_BWD, 4);
  } else {
    DGNN_GAT_NC(DGNN_GAT_BWD, kMaxHeads);
  }
#undef DGNN_GAT_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
