// Masked neighbour max over dense per-cloud masks for NVIDIA Hopper
// (sm_90a):
//
//   out[b, i, f] = max_j (mask[b, i, j] + hs[b, j, f])
//   idx[b, i, f] = the first j that reaches it            (optional)
//
// Replaces scripts/exp_r5_ec_tiles.py:pallas_tiles (kernel _kern, schedule
// "step1": one candidate column j per inner step) and :pallas_tiles2
// (_kern2, schedule "step8": eight mask values and eight hs rows held in
// registers per step).  It is the function of
// dgnn_tpu/ops/edgeconv.py:_masked_max / _masked_max_argmax, the hot loop
// of every DGCNN layer (wrapper ops/ec_tiles.py masked_max).
//
// Bound on the H100: bytes (mask, hs and out once each); the candidates a
// k-NN mask admits need a twentieth of the operations that those bytes take
// to move.  The TPU kernels walk all P candidate columns of every row, which
// on this card is P adds and P maxima per output element whatever the mask
// admits.  Here the walk is over the LIVE candidates of a row only, found by
// a rule that is exact for every float mask, in three kernels:
//
//   ec_hs_range_kernel   lo_b, hi_b: the least and largest hs value of cloud
//     b, as partial ranges per chunk of the cloud (no atomics; pass 1 folds
//     them).
//   ec_live_list_kernel  (pass 1; reads the mask once, 16 bytes a lane).  A
//     warp owns row (b, i): it reduces M_i = max_j mask[i, j], then writes,
//     in ascending j, every column with
//         !(fadd(mask[i, j], hi_b) < fadd(M_i, lo_b))
//     and its mask value to the row's list (kCap entries of 8 bytes) and the
//     number of them to count[b, i].  Float32 round-to-nearest addition is
//     monotone in each operand, so a column that fails the test is strictly
//     below the column of M_i in every channel: it can neither win nor tie,
//     and dropping it changes neither out nor the first-winner idx.  On a
//     {0, neg} mask with |neg| far above |hs| the live columns are exactly
//     the admitted ones.  A row with more than kCap live columns (a row that
//     admits nothing, an all-zero mask, a neg that is small beside hs) gets
//     count -1, keeps (fadd(M_i, lo_b), hi_b) in its list's first slot, and
//     is walked densely by pass 2.
//   ec_masked_max_kernel (pass 2).  A block owns 256 / tpr rows of one cloud
//     x a slab of up to 256 feature columns; a thread owns one 16-byte
//     feature group of one row.  The rows' lists are staged in shared
//     memory; the thread walks its row's list in ascending j, reads
//     hs[b, j, f..f+3] as one float4 through the read-only path (a cloud's
//     hs is L2-resident while its blocks, neighbours in the grid, run), adds
//     the entry's own mask value with __fadd_rn (the same add as the dense
//     form's, bit for bit) and keeps a strictly-greater running max from
//     -inf, so ties go to the least j.  "step1" takes one entry per inner
//     step; "step8" loads eight entries and eight hs vectors into registers
//     before the eight updates.  A dense row (count -1) walks all P columns
//     in the same launch, with the mask read from device memory and pass
//     1's test repeated, so that only its live columns fetch hs.  kCap is
//     256 because a k-NN mask of k = 40 has a tail: trained DGCNN features
//     admit up to 192 columns in a row (bfloat16 distance ties), and a
//     dense row costs its block the time of some ten listed ones.
//
// No atomics, `out` is written once, nothing is padded: any B, P, F (a
// ragged F, or tensors that are not 16-byte aligned, take scalar loads).
// Measured and not kept: pass 2 with a [P, 32] slab of hs staged in shared
// memory (one 1024-thread block per cloud and slab) was 6 to 18 % faster a
// call at DGCNN's shapes on an H100, but takes only P <= 1600 and F a multiple
// of 4, so it would stand beside this kernel, not in its place.  Left for
// later: the list pass runs at twice its bytes bound (its compaction runs
// about as long as its reads take); handing the lists to the tie-sum
// backward.
//
// Plain C interface (ctypes): the launchers return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCap = 256;          // a row's list (ops/ec_tiles.py LIVE_CAP)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRangeChunk = 8192;  // floats of hs a block of the range kernel
constexpr int kMaxChunks = 32;     // partial ranges of a cloud: a lane each
constexpr int kMinTPR = 16;        // threads per row of pass 2, a power of two
constexpr int kMaxTPR = 64;        // 64 float4 groups: a slab of 256 columns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid: (chunks of a cloud, B).  part[b, chunk] = (min, max) of the chunk.
__global__ void __launch_bounds__(kThreads) ec_hs_range_kernel(
    const float* __restrict__ hs,  // [B, n]
    long long n, int nchunk, int vec,
    float2* __restrict__ part) {   // [B, nchunk]
  const int tid = threadIdx.x;
  const float* base = hs + static_cast<size_t>(blockIdx.y) * n;
  // a multiple of 4 floats, so that every chunk starts 16-byte aligned
  const long long len = ((n + nchunk - 1) / nchunk + 3) & ~3LL;
  const long long s = blockIdx.x * len;
  const long long e = min(n, s + len);
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (vec) {  // n is a multiple of 4 and hs is 16-byte aligned
    const float4* p = reinterpret_cast<const float4*>(base);
#pragma unroll 4
    for (long long k = s / 4 + tid; k < e / 4; k += kThreads) {
      const float4 v = __ldg(p + k);
      lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
      hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
  } else {
    for (long long k = s + tid; k < e; k += kThreads) {
      const float v = __ldg(base + k);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ float lo_sh[kWarps], hi_sh[kWarps];
  if ((tid & 31) == 0) {
    lo_sh[tid >> 5] = lo;
    hi_sh[tid >> 5] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, lo_sh[w]);
      hi = fmaxf(hi, hi_sh[w]);
    }
    part[static_cast<size_t>(blockIdx.y) * nchunk + blockIdx.x] =
        make_float2(lo, hi);
  }
}

// E consecutive mask values from row[j], widened.  E > 1: one 16-byte read
// (the row is 16-byte aligned and j a multiple of E).
template <int E>
__device__ __forceinline__ void load_chunk(const float* row, int j,
                                           float (&v)[E]) {
  if constexpr (E == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + j));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(row + j);
  }
}
template <int E>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int j,
                                           float (&v)[E]) {
  // a bfloat16 is the upper half of its float32
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  if constexpr (E == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(r + j));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[2 * u] = __uint_as_float(w[u] << 16);
      v[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(static_cast<uint32_t>(__ldg(r + j)) << 16);
  }
}

// Pass 1.  One warp per row (b, i); grid: ceil(B * P / kWarps) blocks.
template <typename MaskT, bool kVec>
__global__ void __launch_bounds__(kThreads) ec_live_list_kernel(
    const MaskT* __restrict__ mask,    // [B, P, P]
    const float2* __restrict__ part,   // [B, nchunk]
    int nchunk, int P, long long rows,
    int2* __restrict__ entries,        // [B, P, kCap] (j, mask value's bits)
    int* __restrict__ count) {         // [B, P]; -1: walk the row densely
  constexpr int E = kVec ? 16 / static_cast<int>(sizeof(MaskT)) : 1;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp; no block-wide barrier below
  const long long b = row / P;

  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (lane < nchunk) {
    const float2 t = part[b * nchunk + lane];
    lo = t.x;
    hi = t.y;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }

  const MaskT* mrow = mask + row * P;
  float big = -CUDART_INF_F;  // M_i
#pragma unroll 4
  for (int j = lane * E; j < P; j += 32 * E) {
    float v[E];
    load_chunk<E>(mrow, j, v);
#pragma unroll
    for (int u = 0; u < E; ++u) big = fmaxf(big, v[u]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));
  const float floor_i = __fadd_rn(big, lo);

  // the row again (from L1 / L2), compacted in ascending j: lane l holds
  // columns j0 + l * E ... + E - 1 of a step
  int2* dst = entries + row * kCap;
  int base = 0;
  for (int j0 = 0; j0 < P && base <= kCap; j0 += 32 * E) {
    const int j = j0 + lane * E;
    float v[E];
#pragma unroll
    for (int u = 0; u < E; ++u) v[u] = 0.f;
    unsigned live = 0;
    if (j < P) {
      load_chunk<E>(mrow, j, v);
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (!(__fadd_rn(v[u], hi) < floor_i)) live |= 1u << u;
    }
    const int n = __popc(live);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    int pos = base + incl - n;
#pragma unroll
    for (int u = 0; u < E; ++u) {
      if (live >> u & 1u) {
        if (pos < kCap) dst[pos] = make_int2(j + u, __float_as_int(v[u]));
        ++pos;
      }
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();  // the entries are written before slot 0 is written over
  if (lane == 0) {
    count[row] = base <= kCap ? base : -1;
    // a row that overflows its list keeps what pass 2 needs to repeat the
    // test while it walks all P columns
    if (base > kCap)
      dst[0] = make_int2(__float_as_int(floor_i), __float_as_int(hi));
  }
}

// Four hs values from p; kVec: one 16-byte read, else the first nv of them.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int nv) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x = __ldg(p);
    if (nv > 1) r.y = __ldg(p + 1);
    if (nv > 2) r.z = __ldg(p + 2);
    if (nv > 3) r.w = __ldg(p + 3);
    return r;
  }
}

// One candidate column: v = mask + hs, a running strictly-greater max.
template <bool kIndex>
__device__ __forceinline__ void candidate(float mv, const float4& hv, int j,
                                          float (&m)[4], int (&ix)[4]) {
  const float hf[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float v = __fadd_rn(mv, hf[c]);
    if (kIndex) {
      if (v > m[c]) {
        m[c] = v;
        ix[c] = j;
      }
    } else {
      m[c] = fmaxf(m[c], v);
    }
  }
}

// Pass 2.  blockIdx.x = ((b * row blocks) + row block) * nslab + slab, so a
// cloud's blocks are neighbours.  Dynamic shared memory: (kThreads / tpr)
// lists of kCap entries.
template <typename MaskT, int kStep, bool kIndex, bool kVec>
__global__ void __launch_bounds__(kThreads) ec_masked_max_kernel(
    const MaskT* __restrict__ mask,      // [B, P, P]
    const float* __restrict__ hs,        // [B, P, F]
    const int2* __restrict__ entries,    // [B, P, kCap]
    const int* __restrict__ count,       // [B, P]
    int P, int F, int tpr, int nslab,
    float* __restrict__ out,             // [B, P, F]
    int* __restrict__ idx) {             // [B, P, F] or null
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* list_sh = reinterpret_cast<int2*>(smem_raw);  // [block's rows][kCap]

  const int tid = threadIdx.x;
  const int rpb = kThreads / tpr;
  const int nrb = (P + rpb - 1) / rpb;
  const int slab = blockIdx.x % nslab;
  const int rest = blockIdx.x / nslab;
  const size_t b = rest / nrb;
  const int rl = tid / tpr;
  const int gl = tid - rl * tpr;
  const int i = (rest % nrb) * rpb + rl;
  const int f = (slab * kMaxTPR + gl) * 4;
  const size_t row = b * P + i;

  const int cnt = i < P ? count[row] : 0;
  int2* my = list_sh + rl * kCap;
  if (cnt > 0) {
    const int2* src = entries + row * kCap;
    for (int c = gl; c < cnt; c += tpr) my[c] = src[c];
  }
  __syncthreads();
  if (i >= P || f >= F) return;

  const float* hs_f = hs + b * P * F + f;  // column group f of the cloud
  const int nv = min(4, F - f);
  float m[4];
  int ix[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m[c] = -CUDART_INF_F;
    ix[c] = 0;
  }

  if (cnt >= 0) {
    int c = 0;
    if (kStep == 8) {
      for (; c + 8 <= cnt; c += 8) {
        int2 en[8];
        float4 hv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          en[u] = my[c + u];
          hv[u] = load4<kVec>(hs_f + static_cast<size_t>(en[u].x) * F, nv);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          candidate<kIndex>(__int_as_float(en[u].y), hv[u], en[u].x, m, ix);
      }
    }
    // "step1", and the entries "step8" leaves when cnt is no multiple of 8
#pragma unroll 1
    for (; c < cnt; ++c) {
      const int2 en = my[c];
      candidate<kIndex>(__int_as_float(en.y),
                        load4<kVec>(hs_f + static_cast<size_t>(en.x) * F, nv),
                        en.x, m, ix);
    }
  } else {
    // more live columns than a list holds: all P columns, the mask re-read
    // and pass 1's test repeated, so that only live columns fetch hs
    const int2 t = entries[row * kCap];
    const float floor_i = __int_as_float(t.x);
    const float hi = __int_as_float(t.y);
    const MaskT* mrow = mask + row * P;
    for (int j = 0; j < P; ++j) {
      const float mv = widen(mrow[j]);
      if (__fadd_rn(mv, hi) < floor_i) continue;
      candidate<kIndex>(mv, load4<kVec>(hs_f + static_cast<size_t>(j) * F, nv),
                        j, m, ix);
    }
  }

  const size_t o = row * F + f;
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(out + o) = make_float4(m[0], m[1], m[2], m[3]);
    if (kIndex)
      *reinterpret_cast<int4*>(idx + o) = make_int4(ix[0], ix[1], ix[2], ix[3]);
  } else {
    for (int c = 0; c < nv; ++c) {
      out[o + c] = m[c];
      if (kIndex) idx[o + c] = ix[c];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename MaskT>
void launch_lists(const void* mask, const float2* part, int nchunk, int B,
                  int P, int2* entries, int* count, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * P;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const MaskT* mk = static_cast<const MaskT*>(mask);
  constexpr int E = 16 / static_cast<int>(sizeof(MaskT));
  if (P % E == 0 && aligned16(mask)) {
    ec_live_list_kernel<MaskT, true><<<blocks, kThreads, 0, stream>>>(
        mk, part, nchunk, P, rows, entries, count);
  } else {
    ec_live_list_kernel<MaskT, false><<<blocks, kThreads, 0, stream>>>(
        mk, part, nchunk, P, rows, entries, count);
  }
}

template <typename MaskT, int kStep, bool kIndex>
void launch_max(const void* mask, const float* hs, const int2* entries,
                const int* count, int B, int P, int F, float* out, int* idx,
                cudaStream_t stream) {
  const int groups = (F + 3) / 4;
  int tpr = kMinTPR;
  while (tpr < groups && tpr < kMaxTPR) tpr <<= 1;
  const int nslab = (groups + kMaxTPR - 1) / kMaxTPR;
  const int rpb = kThreads / tpr;
  const long long blocks =
      static_cast<long long>(B) * ((P + rpb - 1) / rpb) * nslab;
  const size_t smem = static_cast<size_t>(rpb) * kCap * sizeof(int2);
  const MaskT* mk = static_cast<const MaskT*>(mask);
  const bool vec = F % 4 == 0 && aligned16(hs) && aligned16(out) &&
                   (idx == nullptr || aligned16(idx));
  if (vec) {
    ec_masked_max_kernel<MaskT, kStep, kIndex, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            mk, hs, entries, count, P, F, tpr, nslab, out, idx);
  } else {
    ec_masked_max_kernel<MaskT, kStep, kIndex, false>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            mk, hs, entries, count, P, F, tpr, nslab, out, idx);
  }
}

template <typename MaskT>
void launch_max_any(const void* mask, const float* hs, const int2* entries,
                    const int* count, int B, int P, int F, int step,
                    float* out, int* idx, cudaStream_t s) {
  if (step == 8) {
    if (idx != nullptr)
      launch_max<MaskT, 8, true>(mask, hs, entries, count, B, P, F, out, idx, s);
    else
      launch_max<MaskT, 8, false>(mask, hs, entries, count, B, P, F, out, idx, s);
  } else {
    if (idx != nullptr)
      launch_max<MaskT, 1, true>(mask, hs, entries, count, B, P, F, out, idx, s);
    else
      launch_max<MaskT, 1, false>(mask, hs, entries, count, B, P, F, out, idx, s);
  }
}

bool shapes_ok(int B, int P, int F, int cap) {
  // pass 2's grid is B * ceil(P / rows of a block) * slabs blocks
  return B >= 1 && P >= 1 && F >= 1 && cap == kCap && B <= 65535 &&
         static_cast<long long>(B) * P * ((F + 255) / 256) < (1LL << 31);
}

}  // namespace

extern "C" {

// The hs ranges and pass 1.  mask_bf16: 1 for a bfloat16 mask, 0 for
// float32.  cap must be kCap.  range: [B, 32, 2] floats of scratch; entries:
// [B, P, cap, 2] int32; count: [B, P] int32.
int dgnn_ec_live_lists(const void* mask, int mask_bf16, const float* hs,
                       int B, int P, int F, int cap, float* range,
                       int* entries, int* count, void* stream) {
  if (!shapes_ok(B, P, F, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(P) * F;
  int nchunk = static_cast<int>((n + kRangeChunk - 1) / kRangeChunk);
  nchunk = max(1, min(nchunk, kMaxChunks));
  float2* part = reinterpret_cast<float2*>(range);
  ec_hs_range_kernel<<<dim3(nchunk, B), kThreads, 0, s>>>(
      hs, n, nchunk, n % 4 == 0 && aligned16(hs), part);
  int2* en = reinterpret_cast<int2*>(entries);
  if (mask_bf16)
    launch_lists<__nv_bfloat16>(mask, part, nchunk, B, P, en, count, s);
  else
    launch_lists<float>(mask, part, nchunk, B, P, en, count, s);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the lists that dgnn_ec_live_lists made of the same mask and
// hs.  step: 1 or 8.  idx may be null (no first-winner index).
int dgnn_ec_masked_max(const void* mask, int mask_bf16, const float* hs,
                       int B, int P, int F, int step, int cap,
                       const int* entries, const int* count, float* out,
                       int* idx, void* stream) {
  if (!shapes_ok(B, P, F, cap) || (step != 1 && step != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* en = reinterpret_cast<const int2*>(entries);
  if (mask_bf16)
    launch_max_any<__nv_bfloat16>(mask, hs, en, count, B, P, F, step, out,
                                  idx, s);
  else
    launch_max_any<float>(mask, hs, en, count, B, P, F, step, out, idx, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
