// Two neighbour-gather strategies for NVIDIA Hopper (sm_90a), float32:
// the kernels of scripts/microbench_gather.py, a study of how fast rows can
// be gathered, which no model of the package calls.
//
//   gather_rows_sum_kernel  replaces microbench_gather.py:bench_dma_gather
//     (kernel _dma_kernel; wrapper ops/gather.py gather_rows_sum):
//       out[s, :] = sum_j feat[nbr[s, j], :]
//     Bound on the H100: bytes, of which the function must move the
//     table's distinct named rows once, the ids and the output.  At the
//     study's shapes every row is named about 16 times, and the 268 MB
//     table does not stay in the 50 MB L2, so fetching whole rows in
//     segment order reads nearly every named row from device memory again
//     (the design before this one: 1.29 ms a call, 13 times the bound).
//     The function's columns are independent (an SpMM of a 0/1 matrix with
//     the table), so the kernel walks the table one column slice at a time:
//     kRowsSlice4 16-byte groups of every row (32 floats, one 128-byte
//     line), the last slice ragged where the row is no multiple of it.
//     Work items are (slice, segment), a warp each, numbered slice-major;
//     blocks start in about ascending index, so the warps in flight read
//     one slice, or two at a boundary (N x 128 bytes: 8.4 MB at the study's
//     65,536 rows): each line of a row comes from device memory about once
//     and its repeats are L2 hits.  Slicing by row ranges instead would
//     write every output row and read every id once a range.  Past the
//     bytes, what holds the kernel back is the L2's rate for these gathers
//     while every repeat is read again; chip_smoke.py times the same call
//     on a table the L2 holds whole beside it.
//     A lane takes one 16-byte group of a row, so one load instruction
//     covers 32 / kRowsSlice4 rows.  The warp loads the segment's ids 32 at
//     a time, coalesced (the next 32 while the current ones are used),
//     hands them out by shuffle, keeps kRowsUnroll rows a lane in flight
//     straight into registers (no block reads a row twice, so staging
//     through shared memory buys nothing), sums in float32, combines its
//     row groups by __shfl_xor, and stores 16 bytes a lane by a streaming
//     store, so that the output does not push the slice out of L2.  A row
//     past the segment's end loads the segment's last row and adds zero,
//     and a column past the row's end loads the row's last 16 bytes and is
//     not stored: no load waits behind a branch.
//     On an H100 80GB HBM3 at 700 W (scripts/gather_variants_torch.py,
//     each tree twice in turns in one call), 2^20 ids in segments of 64
//     into 65,536 rows of 4 KB: 0.557 ms a call against 1.30 for the
//     design before; the same ids into 4,096 rows, which the L2 holds
//     whole, 0.35 ms.  Measured there and not kept: slices of 64 floats
//     (0.556 against 0.551 in that call) and of 128 (0.607; at W = 256
//     0.783 against 0.559); 4 rows a lane in flight instead of 8, and an
//     L2 evict_last hint on the table loads, each within 0.5 % of the
//     built kernel in one call and on either side of it in the other.
//
//   gather_lanes_kernel  replaces microbench_gather.py:bench_vmem_dynamic_gather
//     (kernel _dg_kernel; wrapper gather_lanes):
//       out[r, q] = tab[idx[r, q % L], q]
//     Bound on the H100: the bytes of idx, out and the table.  What holds a
//     kernel back is the table read: every lane of a warp names its own
//     table row, and a load that touches 32 cache lines is taken a line at
//     a time, so a gather straight from the L2-resident table (measured on
//     an H100: no faster than torch.gather) delivers a third of what the
//     same gather from shared memory does, where 32 lanes on distinct banks
//     are one access.  So, like the TPU kernel, the table is resident in
//     fast memory, by column slab since a block has 227 KB: a block of 1024
//     threads (one per SM) copies tab[:, slab] (w <= 32 columns, c * w * 4
//     bytes <= kLaneSlabBytes) by 16-byte asynchronous copies, all in flight
//     together, and loads its first ids meanwhile; then each thread walks
//     its rows of idx eight at a time: eight gathers from the slab, the next
//     eight ids requested, eight streaming stores (the output is not read
//     again, so it does not displace idx or the table in L2).  Banks: a slab
//     row is w floats, so at w = 32 the lanes of a warp read distinct banks
//     whatever their rows; at w = 16 (8) a warp covers 2 (4) rows of idx
//     whose table rows collide when their ids agree mod 2 (4): 2-way (up to
//     4-way) conflicts, still an order above the L2 gather.  A slab of 8
//     columns moves idx and out in 32-byte pieces.  Any L and width: a last
//     slab that overhangs the table is bounded in the kernel; a width that
//     is no multiple of 4 (or an unaligned table) loads its slab by 4-byte
//     reads.
//
// gather_rows_sum reads its ids unchecked, so its launcher first runs
// check_ids_kernel over them on the same stream: an id outside the table
// traps there (a CUDA error at the next synchronisation) and the gather
// behind it never runs.  gather_lanes checks each id where it has loaded it
// (measured cheaper than the pass of its own, which the gather waits for):
// an id outside the table reads row 0 of the slab instead and the thread
// traps behind its loop.  Either way the launch fails and nothing outside
// the table is read.
//
// Plain C interface (ctypes): each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsThreads = 256;  // 8 warps, a work item each
constexpr int kRowsSlice4 = 8;     // 16-byte groups of a column slice
constexpr int kRowsUnroll = 8;     // rows a lane has in flight
constexpr int kLaneSlabBytes = 200 * 1024;
constexpr int kLaneThreads = 1024;
constexpr int kLaneRows = 8;  // rows of one thread in flight together
constexpr int kCheckThreads = 256;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Traps unless every one of the n ids lies in [0, limit).
__global__ void __launch_bounds__(kCheckThreads) check_ids_kernel(
    const int* __restrict__ ids, size_t n, int limit) {
  bool bad = false;
  const size_t stride = static_cast<size_t>(gridDim.x) * kCheckThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kCheckThreads +
                  threadIdx.x;
       e < n; e += stride) {
    bad |= static_cast<unsigned>(ids[e]) >= static_cast<unsigned>(limit);
  }
  if (bad) __trap();
}

void check_ids(const int* ids, size_t n, int limit, cudaStream_t stream) {
  size_t blocks = (n + kCheckThreads * 8 - 1) / (kCheckThreads * 8);
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  check_ids_kernel<<<static_cast<unsigned>(blocks), kCheckThreads, 0,
                     stream>>>(ids, n, limit);
}

// A warp a work item: column slice k of every row (the last one may be
// ragged) and segment s, numbered slice-major: item = k * S + s.
__global__ void __launch_bounds__(kRowsThreads) gather_rows_sum_kernel(
    const float4* __restrict__ feat,  // [N, row4]
    const int* __restrict__ nbr,      // [S, W]
    int S, int W, int row4, long long items,
    float4* __restrict__ out) {       // [S, row4]
  constexpr int kR = 32 / kRowsSlice4;  // rows one load instruction covers
  constexpr int kSteps = 32 / kR;       // instructions for 32 ids
  static_assert(32 % kRowsSlice4 == 0 && kSteps % kRowsUnroll == 0,
                "a slice must divide a warp and the unroll the steps");
  const long long item =
      static_cast<long long>(blockIdx.x) * (kRowsThreads / 32) +
      (threadIdx.x >> 5);
  if (item >= items) return;  // warp-uniform; no block barrier below
  const int lane = threadIdx.x & 31;
  const int k = static_cast<int>(item / S);
  const int s = static_cast<int>(item - static_cast<long long>(k) * S);
  const int c4 = k * kRowsSlice4 + lane % kRowsSlice4;  // this lane's group
  const bool col_ok = c4 < row4;
  const float4* src = feat + min(c4, row4 - 1);
  const int r = lane / kRowsSlice4;   // this lane's row within a step
  const int* ids = nbr + static_cast<size_t>(s) * W;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int id_next = __ldg(ids + min(lane, W - 1));
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int id_lane = id_next;
    id_next = __ldg(ids + min(j0 + 32 + lane, W - 1));
    const int n = W - j0;             // rows of the segment from j0 on
#pragma unroll
    for (int u0 = 0; u0 < kSteps; u0 += kRowsUnroll) {
      if (u0 * kR >= n) break;        // warp-uniform
      float4 v[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        const int id = __shfl_sync(0xffffffffu, id_lane, (u0 + u) * kR + r);
        v[u] = __ldg(src + static_cast<size_t>(id) * row4);
      }
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        const bool ok = (u0 + u) * kR + r < n;
        acc.x += ok ? v[u].x : 0.f;
        acc.y += ok ? v[u].y : 0.f;
        acc.z += ok ? v[u].z : 0.f;
        acc.w += ok ? v[u].w : 0.f;
      }
    }
  }
#pragma unroll
  for (int o = kRowsSlice4; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
  if (r == 0 && col_ok) __stcs(out + static_cast<size_t>(s) * row4 + c4, acc);
}

// grid: (column slabs of w, row chunks).  Threads: kLaneThreads / w rows x w
// columns at a time.  Dynamic shared memory: the [c, w] slab.  kVec: w and
// width multiples of 4 and tab 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kLaneThreads) gather_lanes_kernel(
    const float* __restrict__ tab,  // [c, width]
    const int* __restrict__ idx,    // [R, L]
    int c, int width, int R, int L, int w, int rows_per_block,
    float* __restrict__ out) {      // [R, width]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slab = reinterpret_cast<float*>(smem_raw);  // [c][w]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * w;
  if constexpr (kVec) {
    const int w4 = w / 4;
    for (int e = tid; e < c * w4; e += kLaneThreads) {
      const int row = e / w4;
      const int x = (e - row * w4) * 4;
      if (q0 + x < width)
        cp_async_16(slab + row * w + x,
                    tab + static_cast<size_t>(row) * width + q0 + x);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < c * w; e += kLaneThreads) {
      const int row = e / w;
      const int x = e - row * w;
      if (q0 + x < width)
        slab[e] = __ldg(tab + static_cast<size_t>(row) * width + q0 + x);
    }
  }
  const int x = tid % w;
  const int q = q0 + x;
  const bool col_ok = q < width;
  const int lane = q % L;
  const int step = kLaneThreads / w;
  const int r_end = min(R, (blockIdx.y + 1) * rows_per_block);
  int r = blockIdx.y * rows_per_block + tid / w;
  bool bad = false;
  int id[kLaneRows];
  // the first ids travel while the slab does
#pragma unroll
  for (int u = 0; u < kLaneRows; ++u) {
    const int ru = r + u * step;
    id[u] = (col_ok && ru < r_end)
                ? __ldg(idx + static_cast<size_t>(ru) * L + lane) : 0;
  }
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();
  for (; r < r_end; r += kLaneRows * step) {
    float val[kLaneRows];
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      const bool ok = static_cast<unsigned>(id[u]) < static_cast<unsigned>(c);
      bad |= !ok;
      val[u] = slab[(ok ? id[u] : 0) * w + x];
    }
    // the next ids before this step's stores
    int nid[kLaneRows];
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      const int ru = r + (kLaneRows + u) * step;
      nid[u] = (col_ok && ru < r_end)
                   ? __ldg(idx + static_cast<size_t>(ru) * L + lane) : 0;
    }
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      const int ru = r + u * step;
      if (col_ok && ru < r_end)
        __stcs(out + static_cast<size_t>(ru) * width + q, val[u]);
      id[u] = nid[u];
    }
  }
  if (bad) __trap();
}

// SMs of the current device, asked once.
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

}  // namespace

extern "C" {

// N: table rows; row: floats per table row, a multiple of 4.
int dgnn_gather_rows_sum(const float* feat, const int* nbr, int N, int S,
                         int W, int row, float* out, void* stream) {
  if (N < 1 || S < 0 || W < 1 || row < 4 || row % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const int row4 = row / 4;
  const long long items = static_cast<long long>(S) *
                          ((row4 + kRowsSlice4 - 1) / kRowsSlice4);
  constexpr int kWarps = kRowsThreads / 32;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  check_ids(nbr, static_cast<size_t>(S) * W, N, s);
  gather_rows_sum_kernel<<<static_cast<unsigned>(blocks), kRowsThreads, 0,
                           s>>>(reinterpret_cast<const float4*>(feat), nbr,
                                S, W, row4, items,
                                reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// w: slab columns, a power of two <= 32 with c * w * 4 <= kLaneSlabBytes
// (ops/gather.py lane_slab_width).
int dgnn_gather_lanes(const float* tab, const int* idx, int c, int width,
                      int R, int L, int w, float* out, void* stream) {
  if (c < 1 || L < 1 || width < 1 || width % L || w < 1 || w > 32 ||
      (w & (w - 1)) || R < 0 ||
      static_cast<size_t>(c) * w * 4 > kLaneSlabBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(c) * w * 4;
  const bool vec = w % 4 == 0 && width % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(tab) & 15u) == 0;
  cudaError_t e = cudaFuncSetAttribute(
      vec ? gather_lanes_kernel<true> : gather_lanes_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // one block per SM: each block re-reads its slab of the table, so more
  // blocks buy parallelism with table traffic
  const int sms = sm_count();
  const int slabs = (width + w - 1) / w;
  const int chunks = max(1, min(sms / slabs, R));
  const int rows_per_block = (R + chunks - 1) / chunks;
  const dim3 grid(slabs, (R + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_lanes_kernel<true><<<grid, kLaneThreads, smem, s>>>(
        tab, idx, c, width, R, L, w, rows_per_block, out);
  else
    gather_lanes_kernel<false><<<grid, kLaneThreads, smem, s>>>(
        tab, idx, c, width, R, L, w, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
