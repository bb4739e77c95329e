// Degree-binned GAT passes for NVIDIA Hopper (sm_90a): float32 sums over
// feature rows stored as float32 or bf16.
//
//   bin_gat_fwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gat_fwd_kernel
//     (wrappers bin_gat_fwd, bin_gat_fwd_list).  Over the CSR bins (rows =
//     destinations): the exact per-head maximum m of s = LeakyReLU(ar[row] +
//     ac[src]), then l = sum exp(s - m) and acc = sum p^ * x[src]; with_pos
//     adds lpos and accpos restricted to raw score ar + ac >= 0.  Attention
//     dropout drops the weight in acc / accpos only, never in l / lpos.  An
//     empty segment gives m = -1e30 and zero partials.
//
//   bin_gat_bwd_kernel  replaces dgnn_tpu/ops/pallas_bins.py:_bin_gat_bwd_kernel
//     (wrappers bin_gat_bwd, bin_gat_bwd_list).  Over the CSC bins (rows =
//     sources j, slots = destinations i): a = exp(s - M[i]) * Linv[i],
//     a^ = dropout(a),
//       dx[j]  = sum a^ * g[i]
//       dac[j] = <x[j], sum a^ d' g[i]> - sum a d' ws[i]     (d' = LeakyReLU')
//     An empty segment gives zeros.
//
// Unlike the TPU kernels, these gather for themselves: they read x[nbr],
// ac[nbr] (forward) and g / ar / M / Linv / ws [nbr] (backward) straight
// from the node tables given the slot table nbr [S, W]; no pre-gathered
// [W, S, C] block, no concatenated scalar columns, no width cap.
//
// Bound on the H100: the bytes gathered per slot.  Each valid slot reads
// one feature row of H*F floats (1 KB at H=4, F=64) plus H scalars per
// table, from rows scattered over the node table; the arithmetic per byte
// is a few flops.  What held the kernels back was not bytes but latency:
// a segment of pubmed's bins holds 3 to 10 slots, and a block per segment
// spent its time on barriers and dependent loads.
//
// Both passes are a group of lanes per segment (bin_common.cuh): a full
// warp at H*F >= 32 (the models' hidden layer, 256 columns), 4 or 16 lanes
// for the output layer's 3 to 9 columns, several segments to a block, no
// block barrier.  One launch takes every bin of a direction (BinList).
// Lanes work over slots for the per-slot scalars: each lane loads one
// slot's id and its H coefficients and writes the slot's weights to a
// warp-private slab behind __syncwarp; the first slots' ids are requested
// with the segment's row and count.  Then lanes work over columns, up to
// eight a lane (dgnn::cols_per_lane; loads of four values where F % 4 = 0
// and the feature tables are aligned, else scalar loads): every slot of the chunk
// in ascending order, reading the weights from the slab and the row
// x[nbr] / g[nbr] coalesced.  Rows wider than 8 G columns are walked in
// column tiles.
//
//   Forward: the group takes the exact max by shuffles first (two walks
//   over the slots when a segment holds more than G); the slab holds the
//   dropped weight and its sign-split copy a head; l / lpos are per-lane
//   sums over the lane's slots and a shuffle reduction.
//   Backward: the slab holds a^ and a^ d' a head; column lanes keep dx[c]
//   and t[c] = sum a^ d' g[i, c] in registers; sum a d' ws is a per-lane
//   sum over the lane's slots.  After the walk the segment's own row x[j]
//   is read (its registers are free then), each lane forms a per-head
//   partial of x[j, c] t[c] over its columns, less its slots' a d' ws, and
//   one interleaved shuffle butterfly over every head gives dac.
//
// Feature rows (x in the forward; g and the segment's own x in the
// backward) are float32 or bf16, one template instance each (T): a bf16
// row is half the bytes of the gather, widened to float32 as it is loaded
// (bin_common.cuh ld_row / ld_row4), so the arithmetic is the float32
// kernel's on bf16-rounded values, as the TPU kernels upcast the gathered
// block.  The per-node scalars (ac, ar, M, Linv, ws) stay float32 tables;
// where the ops round them to bf16 they hand over the rounded values.
//
// Left for later PRs: cp.async / TMA prefetch of the next slots' rows, and
// fusing the segment merge (ops/common.py combine_lse / combine_sum) into
// the kernel.
//
// Dropout re-derives dgnn_tpu/ops/common.py:pair_keep bit for bit
// (gat_common.cuh).  Forward: dst = segment row, src = slot; backward:
// dst = slot, src = segment row.  On a graph shard (parallel/partition.py)
// rows are local ids and slots extended ids, and the launcher is given the
// shard's table of global ids (ext_gids, `gid`): the hash reads both ids
// through it, so the mask is the single-device graph's, while the gathers
// keep the shard's ids.  Without a table (null) the ids are hashed as they
// are.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bin_common.cuh"
#include "gat_common.cuh"

namespace {

using dgnn::BinList;
using dgnn::find_seg;
using dgnn::group_mask;
using dgnn::ld_row;
using dgnn::ld_row4;
using dgnn::leaky;
using dgnn::pair_base;
using dgnn::pair_u_head;
using dgnn::Seg;

constexpr int kMaxHeads = 16;    // the wrapper refuses H > kMaxHeads
constexpr float kNegB = -1e30f;  // finite "-inf": max of an empty segment

// T: the feature rows' storage (float or __nv_bfloat16); HMAX: heads held
// in registers (4 or kMaxHeads); VEC: loads of four values of x (16 bytes
// of float, 8 of bf16);
// CPL: feature columns a lane per tile of CPL * G (dgnn::cols_per_lane).
// Dynamic shared memory: per group G slot ids, then per group 2 G H floats.
// Blocks of dgnn::kGroupThreads an SM keeps by the launch bounds: three
// (at most 85 registers a thread) where 4 heads sit in registers; one for
// 16 heads, whose row state would spill under a cap.
constexpr int gat_fwd_min_blocks(int hmax) { return hmax <= 4 ? 3 : 1; }

template <typename T, int HMAX, bool VEC, int CPL>
__global__ void __launch_bounds__(dgnn::kGroupThreads,
                                  gat_fwd_min_blocks(HMAX))
bin_gat_fwd_kernel(
    const T* __restrict__ x,          // [N, H*F] source features
    const float* __restrict__ ac,     // [N, H]   source coefficients
    const float* __restrict__ ar,     // [Nr, H]  destination coefficients
    const BinList bl, int G, int H, int F, float slope, int with_pos,
    float p, float inv_keep, const uint32_t* __restrict__ seed_p,
    const int* gid,
    float* __restrict__ m_out,        // [total, H]
    float* __restrict__ l_out,        // [total, H]
    float* __restrict__ lpos_out,     // [total, H]    (with_pos)
    float* __restrict__ acc_out,      // [total, H*F]
    float* __restrict__ accpos_out) { // [total, H*F]  (with_pos)
  extern __shared__ float smem[];
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int gl = threadIdx.x - grp * G;  // lane within the group
  const int s = blockIdx.x * gpb + grp;
  if (s >= bl.total) return;  // the whole group leaves together
  const unsigned gmask = group_mask(G);
  const Seg sg = find_seg(bl, s);
  // the first slot ids are requested with row and count
  int j0 = gl < sg.W ? __ldg(sg.nbr + gl) : 0;
  const int cnt = sg.count;
  const int r = sg.row;
  const int HF = H * F;
  const bool drop = p > 0.f;
  // the dropout seed (gat_common.cuh): one load before the walk
  const uint32_t seed = drop ? __ldg(seed_p) : 0u;
  // the segment row's id in the dropout hash: its global id where a table
  // is given (graph shards), read only when dropping
  const uint32_t hr = drop && gid ? static_cast<uint32_t>(__ldg(gid + r))
                                  : static_cast<uint32_t>(r);
  int* sj = reinterpret_cast<int*>(smem) + grp * G;  // the chunk's slot ids
  float* spd = smem + gpb * G + grp * 2 * G * H;     // [G][H] dropped weight
  float* spp = spd + G * H;                          // the same where sr >= 0

  float arr[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h)
    arr[h] = h < H ? __ldg(ar + static_cast<size_t>(r) * H + h) : 0.f;

  // Phase 1: the exact per-head maximum, lanes over slots.  The first
  // chunk's ids and raw scores stay in registers for phase 2.
  float mx[HMAX], sr0[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    mx[h] = kNegB;
    sr0[h] = 0.f;
  }
  if (gl < cnt) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) {
        sr0[h] = arr[h] + __ldg(ac + static_cast<size_t>(j0) * H + h);
        mx[h] = leaky(sr0[h], slope);
      }
    }
  }
  for (int w0 = G; w0 < cnt; w0 += G) {  // slots past the first G
    if (w0 + gl < cnt) {
      const int j = __ldg(sg.nbr + w0 + gl);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        if (h < H) {
          mx[h] = fmaxf(mx[h], leaky(arr[h] + __ldg(ac + static_cast<size_t>(
                                                        j) * H + h), slope));
        }
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {  // every head in one butterfly
#pragma unroll
    for (int h = 0; h < HMAX; ++h)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(gmask, mx[h], o));
  }

  // Phase 2: weights by lanes over slots into the slab, then the weighted
  // sums by lanes over columns, CPL a lane per tile of CPL * G.
  constexpr int NQ = VEC ? CPL / 4 : CPL;  // loads a lane per slot
  float lsum[HMAX], lpsum[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    lsum[h] = 0.f;
    lpsum[h] = 0.f;
  }
  for (int c0 = 0; c0 < HF; c0 += CPL * G) {
    int col[NQ], hc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      col[q] = c0 + (VEC ? 4 * (gl + G * q) : gl + G * q);
      hc[q] = col[q] < HF ? col[q] / F : 0;
    }
    float acc[CPL], accp[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      acc[i] = 0.f;
      accp[i] = 0.f;
    }
    for (int w0 = 0; w0 < cnt; w0 += G) {
      const int nch = min(G, cnt - w0);
      if (gl < nch) {
        int j = j0;
        float sr[HMAX];
#pragma unroll
        for (int h = 0; h < HMAX; ++h) sr[h] = sr0[h];
        if (w0 > 0) {
          j = __ldg(sg.nbr + w0 + gl);
#pragma unroll
          for (int h = 0; h < HMAX; ++h) {
            if (h < H) sr[h] = arr[h] + __ldg(ac + static_cast<size_t>(j) * H + h);
          }
        }
        const uint32_t base =
            drop ? pair_base(seed, hr, gid ? __ldg(gid + j)
                                           : static_cast<uint32_t>(j))
                 : 0u;
#pragma unroll
        for (int h = 0; h < HMAX; ++h) {
          if (h < H) {
            const float pw = expf(leaky(sr[h], slope) - mx[h]);
            float pd = pw;
            if (drop) pd = pair_u_head(base, H, h) > p ? pw * inv_keep : 0.f;
            const bool pos = sr[h] >= 0.f;
            if (c0 == 0) {
              lsum[h] += pw;
              if (pos) lpsum[h] += pw;
            }
            spd[gl * H + h] = pd;
            spp[gl * H + h] = pos ? pd : 0.f;
          }
        }
        sj[gl] = j;
      }
      __syncwarp(gmask);
#pragma unroll 2
      for (int wl = 0; wl < nch; ++wl) {
        const T* xr = x + static_cast<size_t>(sj[wl]) * HF;
        const float* wd = spd + wl * H;
        const float* wp = spp + wl * H;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col[q] < HF) {
            const float a = wd[hc[q]];
            const float b = wp[hc[q]];
            if constexpr (VEC) {
              const float4 v = ld_row4(xr + col[q]);
              acc[4 * q] += a * v.x;
              acc[4 * q + 1] += a * v.y;
              acc[4 * q + 2] += a * v.z;
              acc[4 * q + 3] += a * v.w;
              accp[4 * q] += b * v.x;
              accp[4 * q + 1] += b * v.y;
              accp[4 * q + 2] += b * v.z;
              accp[4 * q + 3] += b * v.w;
            } else {
              const float v = ld_row(xr + col[q]);
              acc[q] += a * v;
              accp[q] += b * v;
            }
          }
        }
      }
      __syncwarp(gmask);  // the slab is rewritten by the next chunk
    }
    float* ao = acc_out + static_cast<size_t>(s) * HF;
    float* po = with_pos ? accpos_out + static_cast<size_t>(s) * HF : nullptr;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (col[q] < HF) {
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(ao + col[q]) = make_float4(
              acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
          if (with_pos) {
            *reinterpret_cast<float4*>(po + col[q]) = make_float4(
                accp[4 * q], accp[4 * q + 1], accp[4 * q + 2], accp[4 * q + 3]);
          }
        } else {
          ao[col[q]] = acc[q];
          if (with_pos) po[col[q]] = accp[q];
        }
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      lsum[h] += __shfl_xor_sync(gmask, lsum[h], o);
      lpsum[h] += __shfl_xor_sync(gmask, lpsum[h], o);
    }
  }
  if (gl == 0) {
    const size_t o = static_cast<size_t>(s) * H;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) {
        m_out[o + h] = mx[h];
        l_out[o + h] = lsum[h];
        if (with_pos) lpos_out[o + h] = lpsum[h];
      }
    }
  }
}

template <typename T, int HMAX, bool VEC, int CPL>
void launch_gat_fwd(const BinList& bl, int G, size_t shm, cudaStream_t st,
                    const T* x, const float* ac, const float* ar, int H,
                    int F, float slope, int with_pos, float p, float inv_keep,
                    const uint32_t* seed,
                    const int* gid, float* m, float* l, float* lpos, float* acc,
                    float* accpos) {
  const int gpb = dgnn::kGroupThreads / G;
  const int blocks = (bl.total + gpb - 1) / gpb;
  bin_gat_fwd_kernel<T, HMAX, VEC, CPL><<<blocks, gpb * G, shm, st>>>(
      x, ac, ar, bl, G, H, F, slope, with_pos, p, inv_keep, seed,
      gid, m, l, lpos,
      acc, accpos);
}

// The instance for (vec, cpl): vector loads at 4 or 8 columns a lane.
template <typename T, int HMAX>
void dispatch_gat_fwd(bool vec, int cpl, const BinList& bl, int G,
                      size_t shm, cudaStream_t st, const T* x,
                      const float* ac, const float* ar, int H, int F,
                      float slope, int with_pos, float p, float inv_keep,
                      const uint32_t* seed,
                      const int* gid, float* m, float* l, float* lpos,
                      float* acc, float* accpos) {
#define DGNN_GAT_FWD(V, C)                                                  \
  launch_gat_fwd<T, HMAX, V, C>(bl, G, shm, st, x, ac, ar, H, F, slope,     \
                             with_pos, p, inv_keep, seed, gid, m, l, lpos,  \
                             acc, accpos)
  if (vec && cpl == 8) DGNN_GAT_FWD(true, 8);
  else if (vec) DGNN_GAT_FWD(true, 4);
  else if (cpl == 8) DGNN_GAT_FWD(false, 8);
  else if (cpl == 4) DGNN_GAT_FWD(false, 4);
  else if (cpl == 2) DGNN_GAT_FWD(false, 2);
  else DGNN_GAT_FWD(false, 1);
#undef DGNN_GAT_FWD
}

// Backward, by the forward's design.  Dynamic shared memory: per group G
// slot ids, then per group 2 G H floats (a^ and a^ d' a head).  Blocks of
// dgnn::kGroupThreads an SM kept by the launch bounds: four (at most 64
// registers a thread) where 4 heads sit in registers, which paid more than
// requesting x[j] before the walk with three; one for 16 heads.
constexpr int gat_bwd_min_blocks(int hmax) { return hmax <= 4 ? 4 : 1; }

template <typename T, int HMAX, bool VEC, int CPL>
__global__ void __launch_bounds__(dgnn::kGroupThreads,
                                  gat_bwd_min_blocks(HMAX))
bin_gat_bwd_kernel(
    const T* __restrict__ g,          // [Nd, H*F] grad of the output
    const float* __restrict__ ar,     // [Nd, H]
    const float* __restrict__ Mx,     // [Nd, H]   merged softmax maximum
    const float* __restrict__ Linv,   // [Nd, H]   1 / max(L, 1e-20)
    const float* __restrict__ ws,     // [Nd, H]   <g, out> per destination
    const float* __restrict__ ac,     // [Ns, H]   source coefficients
    const T* __restrict__ x,          // [Ns, H*F] source features
    const BinList bl,                 // nbr: destination ids; row: source id
    int G, int H, int F, float slope, float p, float inv_keep,
    const uint32_t* __restrict__ seed_p, const int* gid,
    float* __restrict__ dx_out,       // [total, H*F]
    float* __restrict__ dac_out) {    // [total, H]
  extern __shared__ float smem[];
  const int gpb = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int gl = threadIdx.x - grp * G;  // lane within the group
  const int s = blockIdx.x * gpb + grp;
  if (s >= bl.total) return;  // the whole group leaves together
  const unsigned gmask = group_mask(G);
  const Seg sg = find_seg(bl, s);
  // the first slot ids are requested with row and count
  const int i0 = gl < sg.W ? __ldg(sg.nbr + gl) : 0;
  const int cnt = sg.count;
  const int r = sg.row;
  const int HF = H * F;
  const bool drop = p > 0.f;
  // the dropout seed (gat_common.cuh): one load before the walk
  const uint32_t seed = drop ? __ldg(seed_p) : 0u;
  // the segment row's id in the dropout hash: its global id where a table
  // is given (graph shards), read only when dropping
  const uint32_t hr = drop && gid ? static_cast<uint32_t>(__ldg(gid + r))
                                  : static_cast<uint32_t>(r);
  int* si = reinterpret_cast<int*>(smem) + grp * G;  // the chunk's slot ids
  float* sah = smem + gpb * G + grp * 2 * G * H;     // [G][H] a^
  float* sahd = sah + G * H;                         // [G][H] a^ d'

  // this lane's share of dac: x[j, c] t[c] over its columns, less a d' ws
  // over its slots
  float dac[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) dac[h] = 0.f;

  constexpr int NQ = VEC ? CPL / 4 : CPL;  // loads a lane per slot
  for (int c0 = 0; c0 < HF; c0 += CPL * G) {
    int col[NQ], hc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      col[q] = c0 + (VEC ? 4 * (gl + G * q) : gl + G * q);
      hc[q] = col[q] < HF ? col[q] / F : 0;
    }
    float dx[CPL], t[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      dx[c] = 0.f;
      t[c] = 0.f;
    }
    for (int w0 = 0; w0 < cnt; w0 += G) {
      const int nch = min(G, cnt - w0);
      if (gl < nch) {
        // one lane a slot: its H weights into the slab
        const int i = w0 == 0 ? i0 : __ldg(sg.nbr + w0 + gl);
        const size_t ih = static_cast<size_t>(i) * H;
        const uint32_t base =
            drop ? pair_base(seed, gid ? __ldg(gid + i)
                                       : static_cast<uint32_t>(i), hr)
                 : 0u;
#pragma unroll
        for (int h = 0; h < HMAX; ++h) {
          if (h < H) {
            // ac[j] is read here, not kept: an L1 hit beside the registers
            // the column sums need
            const float sr = __ldg(ar + ih + h) +
                             __ldg(ac + static_cast<size_t>(r) * H + h);
            const float a = expf(leaky(sr, slope) - __ldg(Mx + ih + h)) *
                            __ldg(Linv + ih + h);
            float ah = a;
            if (drop) ah = pair_u_head(base, H, h) > p ? a * inv_keep : 0.f;
            const float dp = sr >= 0.f ? 1.f : slope;
            sah[gl * H + h] = ah;
            sahd[gl * H + h] = ah * dp;
            if (c0 == 0) dac[h] -= a * dp * __ldg(ws + ih + h);
          }
        }
        si[gl] = i;
      }
      __syncwarp(gmask);
      // lanes over columns: every slot of the chunk in ascending order
#pragma unroll 2
      for (int wl = 0; wl < nch; ++wl) {
        const T* gr = g + static_cast<size_t>(si[wl]) * HF;
        const float* wa = sah + wl * H;
        const float* wb = sahd + wl * H;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (col[q] < HF) {
            const float a = wa[hc[q]];
            const float b = wb[hc[q]];
            if constexpr (VEC) {
              const float4 v = ld_row4(gr + col[q]);
              dx[4 * q] += a * v.x;
              dx[4 * q + 1] += a * v.y;
              dx[4 * q + 2] += a * v.z;
              dx[4 * q + 3] += a * v.w;
              t[4 * q] += b * v.x;
              t[4 * q + 1] += b * v.y;
              t[4 * q + 2] += b * v.z;
              t[4 * q + 3] += b * v.w;
            } else {
              const float v = ld_row(gr + col[q]);
              dx[q] += a * v;
              t[q] += b * v;
            }
          }
        }
      }
      __syncwarp(gmask);  // the slab is rewritten by the next chunk
    }
    float* dxo = dx_out + static_cast<size_t>(s) * HF;
    const T* xr = x + static_cast<size_t>(r) * HF;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (col[q] < HF) {
        // the segment's own row, read after the walk
        float v;
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(dxo + col[q]) = make_float4(
              dx[4 * q], dx[4 * q + 1], dx[4 * q + 2], dx[4 * q + 3]);
          const float4 xv = ld_row4(xr + col[q]);
          v = xv.x * t[4 * q] + xv.y * t[4 * q + 1] + xv.z * t[4 * q + 2] +
              xv.w * t[4 * q + 3];
        } else {
          dxo[col[q]] = dx[q];
          v = ld_row(xr + col[q]) * t[q];
        }
        // a load's columns lie in one head (F % 4 = 0 where VEC)
#pragma unroll
        for (int h = 0; h < HMAX; ++h) {
          if (h == hc[q]) dac[h] += v;
        }
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {  // every head in one butterfly
#pragma unroll
    for (int h = 0; h < HMAX; ++h)
      dac[h] += __shfl_xor_sync(gmask, dac[h], o);
  }
  if (gl == 0) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < H) dac_out[static_cast<size_t>(s) * H + h] = dac[h];
    }
  }
}

template <typename T, int HMAX, bool VEC, int CPL>
void launch_gat_bwd(const BinList& bl, int G, size_t shm, cudaStream_t st,
                    const T* g, const float* ar, const float* M,
                    const float* Linv, const float* ws, const float* ac,
                    const T* x, int H, int F, float slope, float p,
                    float inv_keep, const uint32_t* seed,
                    const int* gid, float* dx, float* dac) {
  const int gpb = dgnn::kGroupThreads / G;
  const int blocks = (bl.total + gpb - 1) / gpb;
  bin_gat_bwd_kernel<T, HMAX, VEC, CPL><<<blocks, gpb * G, shm, st>>>(
      g, ar, M, Linv, ws, ac, x, bl, G, H, F, slope, p, inv_keep, seed, gid, dx,
      dac);
}

// The instance for (vec, cpl), as dispatch_gat_fwd.
template <typename T, int HMAX>
void dispatch_gat_bwd(bool vec, int cpl, const BinList& bl, int G,
                      size_t shm, cudaStream_t st, const T* g,
                      const float* ar, const float* M, const float* Linv,
                      const float* ws, const float* ac, const T* x, int H,
                      int F, float slope, float p, float inv_keep,
                      const uint32_t* seed, const int* gid, float* dx,
                      float* dac) {
#define DGNN_GAT_BWD(V, C)                                                  \
  launch_gat_bwd<T, HMAX, V, C>(bl, G, shm, st, g, ar, M, Linv, ws, ac, x, \
                                H, F, slope, p, inv_keep, seed, gid, dx, dac)
  if (vec && cpl == 8) DGNN_GAT_BWD(true, 8);
  else if (vec) DGNN_GAT_BWD(true, 4);
  else if (cpl == 8) DGNN_GAT_BWD(false, 8);
  else if (cpl == 4) DGNN_GAT_BWD(false, 4);
  else if (cpl == 2) DGNN_GAT_BWD(false, 2);
  else DGNN_GAT_BWD(false, 1);
#undef DGNN_GAT_BWD
}

// Dynamic shared memory of a block of groups of G lanes: per group G slot
// ids and 2 G H floats.  At most 8 groups of 32 lanes x 16 heads: 33 KB,
// under the default 48.
size_t gat_shm(int G, int H) {
  return static_cast<size_t>(dgnn::kGroupThreads / G) * G *
         (sizeof(int) + 2 * H * sizeof(float));
}

// Every bin of one direction in one launch, feature rows of type T.
template <typename T>
int run_gat_fwd(const T* x, const float* ac, const float* ar, int nbins,
                void* const* nbr, void* const* row, void* const* count,
                const int* S, const int* W, int H, int F, float slope,
                int with_pos, float p, float inv_keep, const uint32_t* seed,
                const int* gid, float* m,
                float* l, float* lpos, float* acc, float* accpos,
                void* stream) {
  BinList bl;
  if (!dgnn::pack_bins(nbins, nbr, row, count, S, W, &bl) || H < 1 ||
      H > kMaxHeads || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bl.total > 0) {
    const int G = dgnn::group_lanes(H * F);
    const size_t shm = gat_shm(G, H);
    const int cpl = dgnn::cols_per_lane(H * F, G);
    const bool vec = dgnn::vec_rows<T>(cpl, F, x);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (H <= 4)
      dispatch_gat_fwd<T, 4>(vec, cpl, bl, G, shm, st, x, ac, ar, H, F,
                             slope, with_pos, p, inv_keep, seed,
                             gid, m, l, lpos,
                             acc, accpos);
    else
      dispatch_gat_fwd<T, kMaxHeads>(vec, cpl, bl, G, shm, st, x, ac, ar, H,
                                     F, slope, with_pos, p, inv_keep, seed,
                                     gid, m,
                                     l, lpos, acc, accpos);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_gat_bwd(const T* g, const float* ar, const float* M,
                const float* Linv, const float* ws, const float* ac,
                const T* x, int nbins, void* const* nbr, void* const* row,
                void* const* count, const int* S, const int* W, int H, int F,
                float slope, float p, float inv_keep, const uint32_t* seed,
                const int* gid,
                float* dx, float* dac, void* stream) {
  BinList bl;
  if (!dgnn::pack_bins(nbins, nbr, row, count, S, W, &bl) || H < 1 ||
      H > kMaxHeads || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bl.total > 0) {
    const int G = dgnn::group_lanes(H * F);
    const size_t shm = gat_shm(G, H);
    const int cpl = dgnn::cols_per_lane(H * F, G);
    const bool vec =
        dgnn::vec_rows<T>(cpl, F, g) && dgnn::vec_rows<T>(cpl, F, x);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (H <= 4)
      dispatch_gat_bwd<T, 4>(vec, cpl, bl, G, shm, st, g, ar, M, Linv, ws,
                             ac, x, H, F, slope, p, inv_keep, seed,
                             gid, dx, dac);
    else
      dispatch_gat_bwd<T, kMaxHeads>(vec, cpl, bl, G, shm, st, g, ar, M,
                                     Linv, ws, ac, x, H, F, slope, p,
                                     inv_keep, seed, gid, dx, dac);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every bin of one direction in one launch: nbins <= dgnn::kMaxBins bins,
// bin b with S[b] segments of W[b] slots (nbr[b], row[b], count[b] device
// pointers); the outputs hold sum S[b] rows in bin order.  x holds float32
// values, or bf16 where bf16 is 1.
int dgnn_bin_gat_fwd(const void* x, const float* ac, const float* ar,
                     int nbins, void* const* nbr, void* const* row,
                     void* const* count, const int* S, const int* W, int H,
                     int F, int bf16, float slope, int with_pos, float p,
                     float inv_keep, const uint32_t* seed,
                     const int* gid, float* m, float* l,
                     float* lpos, float* acc, float* accpos, void* stream) {
  if (bf16)
    return run_gat_fwd(static_cast<const __nv_bfloat16*>(x), ac, ar, nbins,
                       nbr, row, count, S, W, H, F, slope, with_pos, p,
                       inv_keep, seed, gid, m, l, lpos, acc, accpos, stream);
  return run_gat_fwd(static_cast<const float*>(x), ac, ar, nbins, nbr, row,
                     count, S, W, H, F, slope, with_pos, p, inv_keep, seed,
                     gid, m,
                     l, lpos, acc, accpos, stream);
}

// The backward over every bin of one direction, as dgnn_bin_gat_fwd; g and
// x hold float32 values, or both bf16 where bf16 is 1.
int dgnn_bin_gat_bwd(const void* g, const float* ar, const float* M,
                     const float* Linv, const float* ws, const float* ac,
                     const void* x, int nbins, void* const* nbr,
                     void* const* row, void* const* count, const int* S,
                     const int* W, int H, int F, int bf16, float slope,
                     float p, float inv_keep, const uint32_t* seed,
                     const int* gid, float* dx,
                     float* dac, void* stream) {
  if (bf16)
    return run_gat_bwd(static_cast<const __nv_bfloat16*>(g), ar, M, Linv, ws,
                       ac, static_cast<const __nv_bfloat16*>(x), nbins, nbr,
                       row, count, S, W, H, F, slope, p, inv_keep, seed,
                       gid, dx,
                       dac, stream);
  return run_gat_bwd(static_cast<const float*>(g), ar, M, Linv, ws, ac,
                     static_cast<const float*>(x), nbins, nbr, row, count, S,
                     W, H, F, slope, p, inv_keep, seed, gid, dx, dac, stream);
}

}  // extern "C"
