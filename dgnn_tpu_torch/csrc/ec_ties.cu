// Tie-sum backward of the dense EdgeConv max for NVIDIA Hopper (sm_90a):
//
//   d_src[b, j, f] = sum_i gq[b, i, f]
//                    [fl32(h_src[b, j, f] + mask[b, i, j]) == m[b, i, f]]
//
// with m = the forward's max (ops/ec_tiles.py masked_max), gq = g rounded
// to mul_dtype, the sum in float32 over ascending i, rounded once to
// mul_dtype.  It replaces dgnn_tpu/ops/edgeconv.py:_ecd_dsrc_ties, which is
// an XLA pass (a dense [B, Pj, Pi, Fc] indicator multiply), not a Pallas
// kernel; its plain version is ops/edgeconv.py _dsrc_ties (wrapper:
// tie_sum_bwd), which finds the pairs with torch.nonzero, a host sync that
// no CUDA graph takes.  These kernels make no host sync, use no atomics and
// allocate nothing; the wrapper allocates their outputs at sizes set by the
// shapes alone.
//
// Bound on the H100: bytes.  The function must read the mask once (B P^2
// values) and m, h_src, g and write d_src once (4 B P F floats); a k-NN
// mask admits about k of P pairs a row, so the equality tests it needs are
// a twentieth of what those bytes take to move.
//
// Three kernels, two calls (dgnn_ec_tie_lists, then dgnn_ec_tie_sum):
//
//   ec_tie_bounds_kernel  hmax[b, j] = max_f h_src[b, j, f] and
//     mmin[b, i] = min_f m[b, i, f] (NaN if any is, as torch's amax and
//     amin): a warp a row, one 16-byte read of h_src and m at a time.
//   ec_tie_list_kernel  reads the mask once, row after row, a warp on 64
//     adjacent columns (a lane two: one 4- or 8-byte load a row, 128 or 256
//     coalesced bytes a warp, two batches of 32 or 16 rows in flight), and
//     writes each column's list: the rows i, in ascending order, that pass
//     the plain version's filter
//
//         fl32(mask[i, j] + hmax[j]) >= mmin[i]
//
//     (rounded addition is monotone, so a pair that fails it has no hit in
//     any f), with their mask values: entries[b, j, :kCap] and count[b, j],
//     the number of rows that pass (above kCap the list is incomplete).  A
//     batch's tests are straight-line code that sets a bit a passing row;
//     the few rows that pass are written four at a time as whole 32-byte
//     sectors (faster on the card than one 8-byte write an entry).
//   ec_tie_sum_kernel  a block owns one cloud b and a slab of kSlab = 16
//     feature columns: it stages m[b, :, slab] and gq[b, :, slab] in shared
//     memory as (m, gq) pairs (128 bytes a row, 128 KB at P = 1024), so that
//     each row of m and g is read from device memory once a slab, not once a
//     passing pair from L2 as in the kernel's first form.  A warp takes four
//     source columns at a time, a quarter-warp each, a lane two features:
//     h_src[b, j, f] and the sums live in registers.  The block first orders
//     its columns by their lists' lengths (in classes of 16), so that a warp's
//     four lists end about together (the model's k-NN masks in feature space
//     give some columns four times the mean).  A quarter walks its column's
//     list in ascending i, kUnroll entries at a time (two a 16-byte load):
//     their loads, their 16-byte shared reads, then for each an add with
//     __fadd_rn (the forward's add, bit for bit), a compare and a select, with
//     no branch.  kCap = 256 holds the longest lists of the DGCNN model's
//     masks (under 256 of 1024 rows); a column whose list overflowed is walked
//     densely (with the other columns of its warp: the dense walk tests the
//     same filter, so it finds the same rows in the same order), 8 rows at a
//     time straight from the mask.  Rows past kChunk are staged chunk after
//     chunk, the float32 sums kept in d_src between them (rounded after the
//     last), so any P works.
//
// What holds it, by timing variants of these kernels on an H100: not the
// bytes.  The list pass reads the mask at about the card's rate when it
// only loads; its tests and writes, at eight warps an SM (the grid has no
// more at DGCNN's size), take the rest.  The sum issues about fifteen
// instructions a list entry and lane, and is held by the warps an SM
// holds (one block, for its 128 KB of shared memory; half as many warps
// ran slower); without its shared reads it ran no faster.
//
// Deterministic: a fixed order (ascending i for each (j, f)), no atomics,
// d_src written by one thread an element; two calls on the same inputs are
// equal bit for bit, and equal to _dsrc_ties, which sums the same pairs in
// the same order.  Any B, P, F: the edges are masked, nothing is padded.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCap = 256;             // entries of a column's list
constexpr int kBoundsThreads = 256;   // a warp a row
constexpr int kListThreads = 128;     // 4 warps, 64 columns each
constexpr int kListCols = 2 * kListThreads;  // columns a list block
constexpr int kSlab = 16;             // feature columns a sum block
constexpr int kSumThreads = 1024;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kChunk = 1024;          // rows of (m, gq) staged at a time
constexpr int kClasses = 8;           // list lengths 16 a class, the last open
static_assert(kSumWarps == 32 && kChunk <= kSumThreads, "the ordering");

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

// Two adjacent mask values as read: one 32-bit word of two bfloat16, or a
// float2; widen2 makes them floats.
template <typename MaskT>
struct PairOf {
  using T = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using T = __nv_bfloat162;
};

__device__ __forceinline__ float2 widen2(float2 v) { return v; }
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// row[j0], row[j1]; kVec: one aligned read of both (j1 == j0 + 1)
template <bool kVec>
__device__ __forceinline__ __nv_bfloat162 load_pair(
    const __nv_bfloat16* row, int j0, int j1) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const __nv_bfloat162*>(row + j0));
  } else {
    __nv_bfloat162 v;
    v.x = row[j0];
    v.y = row[j1];
    return v;
  }
}
template <bool kVec>
__device__ __forceinline__ float2 load_pair(const float* row, int j0,
                                            int j1) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float2*>(row + j0));
  } else {
    return make_float2(__ldg(row + j0), __ldg(row + j1));
  }
}

// grid: ceil(rows / 8).  hmax, mmin: [rows].  kVec: F % 4 == 0 and both
// arrays 16-byte aligned (16-byte reads).
template <bool kVec>
__global__ void __launch_bounds__(kBoundsThreads) ec_tie_bounds_kernel(
    const float* __restrict__ hs, const float* __restrict__ m,
    long long rows, int F, float* __restrict__ hmax,
    float* __restrict__ mmin) {
  const long long r = static_cast<long long>(blockIdx.x) *
                          (kBoundsThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const float* h = hs + r * F;
  const float* mr = m + r * F;
  float hx = -CUDART_INF_F, mn = CUDART_INF_F;
  bool hnan = false, mnan = false;
  auto take = [&](float a, float c) {
    hx = fmaxf(hx, a);
    mn = fminf(mn, c);
    hnan |= a != a;
    mnan |= c != c;
  };
  if constexpr (kVec) {
    const float4* h4 = reinterpret_cast<const float4*>(h);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
#pragma unroll 2
    for (int f = lane; f < F / 4; f += 32) {
      const float4 a = __ldg(h4 + f), c = __ldg(m4 + f);
      take(a.x, c.x);
      take(a.y, c.y);
      take(a.z, c.z);
      take(a.w, c.w);
    }
  } else {
    for (int f = lane; f < F; f += 32) take(__ldg(h + f), __ldg(mr + f));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
  }
  hnan = __any_sync(kFull, hnan);
  mnan = __any_sync(kFull, mnan);
  if (lane == 0) {
    hmax[r] = hnan ? CUDART_NAN_F : hx;
    mmin[r] = mnan ? CUDART_NAN_F : mn;
  }
}

// Entry n of a column's list joins its queue of four (slot n % 4, by
// selects: no indexed registers); the fourth writes the queue to slots
// n - 3 .. n as one 32-byte sector, if they lie within the cap.
__device__ __forceinline__ void flush(const int2 (&q)[4], int2* at) {
  int4* s = reinterpret_cast<int4*>(at);
  s[0] = make_int4(q[0].x, q[0].y, q[1].x, q[1].y);
  s[1] = make_int4(q[2].x, q[2].y, q[3].x, q[3].y);
}
__device__ __forceinline__ void queue(int2 (&q)[4], int n, int2 e,
                                      int2* list) {
  const int s = n & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = s == k ? e : q[k];
  if (s == 3 && n < kCap) flush(q, list + (n - 3));
}

// grid: (ceil(P / kListCols), B).  kVec: P even and the mask aligned to
// two values, so a lane's two columns are one aligned read.  A lane holds
// kRows rows of its pair (32 bfloat16 or 16 float32 words) and loads the
// next kRows while it tests these: two batches in flight.  The tests of a
// batch are straight-line code that sets a bit a passing row; the few rows
// that pass are then queued in ascending order, their values read again
// (from L1 or L2: the batch was just read).
template <typename MaskT, bool kVec>
__global__ void __launch_bounds__(kListThreads) ec_tie_list_kernel(
    const MaskT* __restrict__ mask,   // [B, P, P]
    const float* __restrict__ hmax,   // [B, P] over j
    const float* __restrict__ mmin,   // [B, P] over i
    int P,
    int2* __restrict__ entries,       // [B, P, kCap]: (i, the value's bits)
    int* __restrict__ count) {        // [B, P]
  using Raw = typename PairOf<MaskT>::T;
  constexpr int kRows = sizeof(MaskT) == 2 ? 32 : 16;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kListCols + 2 * threadIdx.x;
  if (j - 2 * lane >= P) return;  // the whole warp is past P
  const size_t cloud = static_cast<size_t>(blockIdx.y) * P;
  const bool ok0 = j < P, ok1 = j + 1 < P;
  // clamped columns: an aligned pair inside the row (P even) for kVec
  const int j0 = kVec ? min(j, P - 2) : min(j, P - 1);
  const int j1 = min(j + 1, P - 1);
  const int jc = min(j, P - 1);
  const float hx0 = __ldg(hmax + cloud + jc);
  const float hx1 = __ldg(hmax + cloud + j1);
  int2* e0 = entries + (cloud + jc) * kCap;
  int2* e1 = entries + (cloud + j1) * kCap;
  int n0 = 0, n1 = 0;
  int2 q0[4] = {}, q1[4] = {};  // each column's entries not yet written
  // a batch: kRows rows from i0 (past P: row P - 1, never kept), and their
  // mmin, lane u holding row i0 + u
  Raw cur[kRows], nxt[kRows];
  float mm_cur, mm_nxt = 0.f;
  const MaskT* col = mask + cloud * P + j0;  // (i, j0) at col[i * P]
  const int dj = j1 - j0;
  // rows i0 .. i0 + kRows - 1, clamped to P - 1 only in the last batch
  auto fetch = [&](int i0, Raw (&v)[kRows], float& mm) {
    const MaskT* r = col + static_cast<size_t>(i0) * P;
    if (i0 + kRows <= P) {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        v[u] = load_pair<kVec>(r + static_cast<size_t>(u) * P, 0, dj);
    } else {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        v[u] = load_pair<kVec>(
            r + static_cast<size_t>(min(u, P - 1 - i0)) * P, 0, dj);
    }
    mm = __ldg(mmin + cloud + min(i0 + lane % kRows, P - 1));
  };
  fetch(0, cur, mm_cur);
  for (int i0 = 0; i0 < P; i0 += kRows) {
    if (i0 + kRows < P) fetch(i0 + kRows, nxt, mm_nxt);  // warp-uniform
    unsigned b0 = 0, b1 = 0;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float mi = __shfl_sync(kFull, mm_cur, u);
      const float2 v = widen2(cur[u]);
      b0 |= static_cast<unsigned>(__fadd_rn(v.x, hx0) >= mi) << u;
      b1 |= static_cast<unsigned>(__fadd_rn(v.y, hx1) >= mi) << u;
    }
    const unsigned keep = P - i0 < kRows ? (1u << (P - i0)) - 1u : ~0u;
    b0 = ok0 ? b0 & keep : 0u;
    b1 = ok1 ? b1 & keep : 0u;
    // the passing rows, four of each column at a time: their values read
    // again together, then queued in ascending order; every fourth entry
    // writes its queue's four as one 32-byte sector (no partial sector)
    while (b0 | b1) {
      int u0[4], u1[4];
      float v0[4], v1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u0[k] = __ffs(b0) - 1;  // -1: no more rows
        u1[k] = __ffs(b1) - 1;
        b0 &= b0 - 1;
        b1 &= b1 - 1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v0[k] = u0[k] >= 0 ? widen(mask[(cloud + i0 + u0[k]) * P + jc]) : 0.f;
        v1[k] = u1[k] >= 0 ? widen(mask[(cloud + i0 + u1[k]) * P + j1]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (u0[k] >= 0) {
          queue(q0, n0, make_int2(i0 + u0[k], __float_as_int(v0[k])), e0);
          ++n0;
        }
        if (u1[k] >= 0) {
          queue(q1, n1, make_int2(i0 + u1[k], __float_as_int(v1[k])), e1);
          ++n1;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) cur[u] = nxt[u];
    mm_cur = mm_nxt;
  }
  // the last, partial sectors (within the cap; the slots after a count
  // are left as they fall)
  if ((n0 & 3) && n0 < kCap) flush(q0, e0 + (n0 & ~3));
  if ((n1 & 3) && n1 < kCap) flush(q1, e1 + (n1 & ~3));
  if (ok0) count[cloud + j] = n0;
  if (ok1) count[cloud + j + 1] = n1;
}

// grid: (ceil(F / kSlab), B); dynamic shared memory min(P, kChunk) rows of
// kSlab (m, gq) pairs.  A warp takes four source columns at a time, a
// quarter-warp (8 lanes) each, a lane two features (one 16-byte shared
// read a row); it loads the next four columns' h_src and counts while it
// walks these, and walks a list kUnroll entries at a time: their loads,
// then their shared reads (clamped rows), then their sums in order.
// kVec4: F % 4 == 0 and m, g 16-byte aligned; kOne: P <= kChunk.
template <typename MaskT, bool kBf16, bool kVec4, bool kOne>
__global__ void __launch_bounds__(kSumThreads) ec_tie_sum_kernel(
    const MaskT* __restrict__ mask,   // [B, P, P]
    const float* __restrict__ m,      // [B, P, F]
    const float* __restrict__ hs,     // [B, P, F]
    const float* __restrict__ g,      // [B, P, F]
    const float* __restrict__ hmax,   // [B, P]
    const float* __restrict__ mmin,   // [B, P]
    const int2* __restrict__ entries, // [B, P, kCap]
    const int* __restrict__ count,    // [B, P]
    int P, int F,
    float* __restrict__ dsrc) {       // [B, P, F]
  constexpr int kUnroll = 4;  // even, and a divisor of kCap
  static_assert(kUnroll % 2 == 0 && kCap % kUnroll == 0, "kUnroll");
  // [rows][kSlab]: (m, gq) a feature; as float4, (m, gq) of two features
  extern __shared__ float4 mg4[];
  float2* mg = reinterpret_cast<float2*>(mg4);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ql = lane & 7;            // the lane in its quarter
  const int qb = lane & 24;           // the quarter's first lane
  const size_t cloud = static_cast<size_t>(blockIdx.y) * P;
  const int s0 = blockIdx.x * kSlab;
  const int f0 = s0 + 2 * ql;         // the lane's features f0, f0 + 1
  const bool fok0 = f0 < F, fok1 = f0 + 1 < F;
  const int fc0 = min(f0, F - 1), fc1 = min(f0 + 1, F - 1);
  // kOne: the columns in order of their list's length class, so that the
  // four lists a warp walks together are about as long (a column a
  // thread: ranks by ballot within a warp, the warps' offsets by one
  // warp's scan; no atomics, and the order is fixed by the counts)
  __shared__ int order[kOne ? kChunk : 1];
  __shared__ int offs[kSumWarps][kClasses];
  if constexpr (kOne) {
    const int t = threadIdx.x;
    const int cls = t < P ? min(__ldg(count + cloud + t) >> 4, kClasses - 1)
                          : kClasses;
    int rank = 0;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      const unsigned in = __ballot_sync(kFull, cls == c);
      if (cls == c) rank = __popc(in & ((1u << lane) - 1u));
      if (lane == 0) offs[w][c] = __popc(in);
    }
    __syncthreads();
    if (w == 0) {  // lane v: warp v's offset in each class
      int base = 0;
      for (int c = 0; c < kClasses; ++c) {
        const int mine = offs[lane][c];
        int inc = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += y;
        }
        offs[lane][c] = base + inc - mine;
        base += __shfl_sync(kFull, inc, 31);
      }
    }
    __syncthreads();
    if (t < P) order[offs[w][cls] + rank] = t;
    __syncthreads();
  }
  // the quarter's column at slot s of the walk
  auto column_at = [&](int s) {
    if constexpr (kOne) {
      return s < P ? order[s] : P - 1;
    } else {
      return min(s, P - 1);
    }
  };
  for (int c0 = 0; c0 < P; c0 += kChunk) {
    const int rows = min(kChunk, P - c0);
    const int c1 = c0 + rows;
    if (c0) __syncthreads();  // every warp is done with the last chunk
    if constexpr (kVec4) {
      for (int t = threadIdx.x; t < rows * (kSlab / 4); t += kSumThreads) {
        const int r = t / (kSlab / 4), q = t % (kSlab / 4);
        const int fq = s0 + 4 * q;
        float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), gv = mv;
        if (fq < F) {
          const size_t o = (cloud + c0 + r) * F + fq;
          mv = __ldg(reinterpret_cast<const float4*>(m + o));
          gv = __ldg(reinterpret_cast<const float4*>(g + o));
        }
        float4* d = mg4 + r * (kSlab / 2) + 2 * q;
        d[0] = make_float4(mv.x, round_mul<kBf16>(gv.x), mv.y,
                           round_mul<kBf16>(gv.y));
        d[1] = make_float4(mv.z, round_mul<kBf16>(gv.z), mv.w,
                           round_mul<kBf16>(gv.w));
      }
    } else {
      for (int t = threadIdx.x; t < rows * kSlab; t += kSumThreads) {
        const int r = t / kSlab, fq = s0 + t % kSlab;
        float2 x = make_float2(0.f, 0.f);
        if (fq < F) {
          const size_t o = (cloud + c0 + r) * F + fq;
          x = make_float2(__ldg(m + o), round_mul<kBf16>(__ldg(g + o)));
        }
        mg[t] = x;
      }
    }
    __syncthreads();
    // the quarter's column, at slot 4 p + quarter of the walk: its h_src
    // and count, loaded one round ahead
    auto column = [&](int p, float& h0, float& h1, int& n) {
      const int slot = 4 * p + (lane >> 3);
      const int jc = column_at(slot);
      const size_t row = (cloud + jc) * F;
      h0 = __ldg(hs + row + fc0);
      h1 = __ldg(hs + row + fc1);
      n = slot < P ? __ldg(count + cloud + jc) : 0;
    };
    float h0, h1, h0n = 0.f, h1n = 0.f;
    int n, nn = 0;
    column(w, h0, h1, n);
    for (int p = w; 4 * p < P; p += kSumWarps) {
      if (4 * (p + kSumWarps) < P) column(p + kSumWarps, h0n, h1n, nn);
      const int slot = 4 * p + (lane >> 3);
      const bool jok = slot < P;
      const int jc = column_at(slot);
      const size_t row = (cloud + jc) * F;
      float acc0 = 0.f, acc1 = 0.f;
      if (c0 && jok) {  // the float32 sums of the rows before this chunk
        if (fok0) acc0 = dsrc[row + f0];
        if (fok1) acc1 = dsrc[row + f0 + 1];
      }
      if (!__any_sync(kFull, n > kCap)) {
        // the column's list until the warp's longest list ends, kUnroll
        // entries at a time (two a 16-byte load; slots past the count are
        // read from inside the list and added as nothing): the loads, then
        // every shared read (rows clamped into the chunk), then the sums in
        // order
        const int4* lst = reinterpret_cast<const int4*>(
            entries + (cloud + jc) * kCap);
        const float4* mq = mg4 + ql;  // the lane's two features, row 0
        int nmax = max(n, __shfl_xor_sync(kFull, n, 8));
        nmax = max(nmax, __shfl_xor_sync(kFull, nmax, 16));
        for (int t = 0; t < nmax; t += kUnroll) {
          int2 e[kUnroll];
          float4 x[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; k += 2) {
            const int4 two = __ldg(lst + (t + k) / 2);
            e[k] = make_int2(two.x, two.y);
            e[k + 1] = make_int2(two.z, two.w);
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int i = kOne ? e[k].x : e[k].x - c0;
            const unsigned r =
                min(static_cast<unsigned>(i), static_cast<unsigned>(rows - 1));
            x[k] = mq[r * (kSlab / 2)];
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            // bitwise: no branch an entry
            const bool act =
                (t + k < n) & (kOne | ((e[k].x >= c0) & (e[k].x < c1)));
            const float v = __int_as_float(e[k].y);
            const bool hit0 = act & (__fadd_rn(h0, v) == x[k].x);
            const bool hit1 = act & (__fadd_rn(h1, v) == x[k].z);
            acc0 += hit0 ? x[k].y : 0.f;
            acc1 += hit1 ? x[k].w : 0.f;
          }
        }
      } else {
        // over a list's cap: this chunk's rows straight from the mask,
        // 8 at a time, through the same filter
        const float hx = __ldg(hmax + cloud + jc);
        for (int r0 = c0; r0 < c1; r0 += 8) {
          const int i = r0 + ql;
          const int ic = min(i, P - 1);
          const float v = widen(mask[(cloud + ic) * P + jc]);
          const float mi = __ldg(mmin + cloud + ic);
          const bool pass = jok && i < c1 && __fadd_rn(v, hx) >= mi;
          unsigned bits = (__ballot_sync(kFull, pass) >> qb) & 0xffu;
          int nb = __popc(bits);
          nb = max(nb, __shfl_xor_sync(kFull, nb, 8));
          nb = max(nb, __shfl_xor_sync(kFull, nb, 16));
          for (int t = 0; t < nb; ++t) {  // warp-uniform
            const int k = __ffs(bits) - 1;  // -1: this quarter is done
            bits &= bits - 1;
            const float vk = __shfl_sync(kFull, v, qb | max(k, 0));
            if (k >= 0) {
              const float4 x = mg4[(r0 + k - c0) * (kSlab / 2) + ql];
              acc0 += __fadd_rn(h0, vk) == x.x ? x.y : 0.f;
              acc1 += __fadd_rn(h1, vk) == x.z ? x.w : 0.f;
            }
          }
        }
      }
      const bool done = c1 >= P;
      if (jok && fok0)
        dsrc[row + f0] = done ? round_mul<kBf16>(acc0) : acc0;
      if (jok && fok1)
        dsrc[row + f0 + 1] = done ? round_mul<kBf16>(acc1) : acc1;
      h0 = h0n;
      h1 = h1n;
      n = nn;
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

bool shapes_ok(int B, int P, int F, int cap) {
  return B >= 1 && P >= 1 && F >= 1 && cap == kCap && B <= 65535 &&
         static_cast<long long>(B) * P < (1LL << 31) &&
         (F + kSlab - 1) / kSlab <= 65535 &&
         (P + kListCols - 1) / kListCols <= 65535;
}

template <typename MaskT>
void launch_lists(const void* mask, const float* hs, const float* m, int B,
                  int P, int F, float* bounds, int2* entries, int* count,
                  cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * P;
  float* hmax = bounds;
  float* mmin = bounds + rows;
  const unsigned nb = static_cast<unsigned>(
      (rows + kBoundsThreads / 32 - 1) / (kBoundsThreads / 32));
  if (F % 4 == 0 && aligned(hs, 16) && aligned(m, 16))
    ec_tie_bounds_kernel<true><<<nb, kBoundsThreads, 0, s>>>(hs, m, rows, F,
                                                             hmax, mmin);
  else
    ec_tie_bounds_kernel<false><<<nb, kBoundsThreads, 0, s>>>(hs, m, rows, F,
                                                              hmax, mmin);
  const MaskT* mk = static_cast<const MaskT*>(mask);
  const dim3 grid((P + kListCols - 1) / kListCols, B);
  if (P % 2 == 0 && aligned(mask, 2 * sizeof(MaskT)))
    ec_tie_list_kernel<MaskT, true><<<grid, kListThreads, 0, s>>>(
        mk, hmax, mmin, P, entries, count);
  else
    ec_tie_list_kernel<MaskT, false><<<grid, kListThreads, 0, s>>>(
        mk, hmax, mmin, P, entries, count);
}

template <typename MaskT, bool kBf16, bool kVec4>
cudaError_t launch_sum_as(const void* mask, const float* m, const float* hs,
                          const float* g, const float* bounds,
                          const int2* entries, const int* count, int B, int P,
                          int F, float* dsrc, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(P < kChunk ? P : kChunk) * kSlab *
                      sizeof(float2);
  auto kernel = P <= kChunk ? ec_tie_sum_kernel<MaskT, kBf16, kVec4, true>
                            : ec_tie_sum_kernel<MaskT, kBf16, kVec4, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const float* hmax = bounds;
  const float* mmin = bounds + static_cast<size_t>(B) * P;
  const dim3 grid((F + kSlab - 1) / kSlab, B);
  kernel<<<grid, kSumThreads, smem, s>>>(static_cast<const MaskT*>(mask), m,
                                         hs, g, hmax, mmin, entries, count, P,
                                         F, dsrc);
  return cudaSuccess;
}

template <typename MaskT, bool kBf16>
cudaError_t launch_sum(const void* mask, const float* m, const float* hs,
                       const float* g, const float* bounds,
                       const int2* entries, const int* count, int B, int P,
                       int F, float* dsrc, cudaStream_t s) {
  if (F % 4 == 0 && aligned(m, 16) && aligned(g, 16))
    return launch_sum_as<MaskT, kBf16, true>(mask, m, hs, g, bounds, entries,
                                             count, B, P, F, dsrc, s);
  return launch_sum_as<MaskT, kBf16, false>(mask, m, hs, g, bounds, entries,
                                            count, B, P, F, dsrc, s);
}

}  // namespace

extern "C" {

// The list pass.  mask_bf16: 1 for a bfloat16 mask, 0 for float32.
// bounds: [2, B, P] float32 (hmax over j, then mmin over i); entries:
// [B, P, cap, 2] int32; count: [B, P] int32.  cap must be kCap.
int dgnn_ec_tie_lists(const void* mask, int mask_bf16, const float* hs,
                      const float* m, int B, int P, int F, int cap,
                      float* bounds, int* entries, int* count, void* stream) {
  if (!shapes_ok(B, P, F, cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* en = reinterpret_cast<int2*>(entries);
  if (mask_bf16)
    launch_lists<__nv_bfloat16>(mask, hs, m, B, P, F, bounds, en, count, s);
  else
    launch_lists<float>(mask, hs, m, B, P, F, bounds, en, count, s);
  return static_cast<int>(cudaGetLastError());
}

// The sum over the lists dgnn_ec_tie_lists made of the same inputs.
// mul_bf16: 1 rounds g and the sums to bfloat16 (mul_dtype bfloat16), 0
// keeps float32.
int dgnn_ec_tie_sum(const void* mask, int mask_bf16, const float* m,
                    const float* hs, const float* g, const float* bounds,
                    const int* entries, const int* count, int B, int P, int F,
                    int cap, int mul_bf16, float* dsrc, void* stream) {
  if (!shapes_ok(B, P, F, cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* en = reinterpret_cast<const int2*>(entries);
  cudaError_t e;
  if (mask_bf16) {
    e = mul_bf16 ? launch_sum<__nv_bfloat16, true>(mask, m, hs, g, bounds, en,
                                                   count, B, P, F, dsrc, s)
                 : launch_sum<__nv_bfloat16, false>(mask, m, hs, g, bounds,
                                                    en, count, B, P, F, dsrc,
                                                    s);
  } else {
    e = mul_bf16 ? launch_sum<float, true>(mask, m, hs, g, bounds, en, count,
                                           B, P, F, dsrc, s)
                 : launch_sum<float, false>(mask, m, hs, g, bounds, en, count,
                                            B, P, F, dsrc, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
