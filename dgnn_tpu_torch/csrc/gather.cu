// Two neighbour-gather strategies for NVIDIA Hopper (sm_90a), float32:
// the kernels of scripts/microbench_gather.py, a study of how fast rows can
// be gathered, which no model of the package calls.
//
//   gather_rows_sum_kernel  replaces microbench_gather.py:bench_dma_gather
//     (kernel _dma_kernel; wrapper ops/gather.py gather_rows_sum):
//       out[s, :] = sum_j feat[nbr[s, j], :]
//     Rows travel from device memory to shared memory by asynchronous
//     copies (cp.async, 16 bytes each), two stages deep: while a stage is
//     summed, the next one is in flight.  The TPU kernel kept two whole
//     segments (2 x W x row) in its scratch; a Hopper block has at most
//     227 KB of shared memory, so a stage holds kStageBytes of a segment's
//     rows (8 rows of 4 KB) and the segment's sum is carried in registers
//     across its stages.  A thread owns one 16-byte column group of the
//     row: it copies that group of every row of a stage and later sums
//     exactly what it copied, so cp.async.wait_group is the only
//     synchronisation the pipeline needs.  A block walks kSegsPerBlock
//     consecutive segments without draining the pipeline between them
//     (the TPU kernel's 8 segments per grid step).
//     Bound on the H100: bytes, of which the function must move the
//     table's distinct named rows once, the ids and the output.  The copies
//     themselves fetch every named row, repeats included (cp.async.cg: from
//     the L2 where it still holds the row, else from device memory).  Left
//     for later PRs: cp.async.bulk with an mbarrier (one copy per row
//     instead of one per 16 bytes), deeper stages, reuse of repeated rows.
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

constexpr int kMaxThreads = 1024;
constexpr int kStageBytes = 32 * 1024;  // of one stage; two are resident
constexpr int kMaxStageRows = 32;
constexpr int kSegsPerBlock = 8;
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

// grid: (segment groups, column slabs of blockDim.x 16-byte groups).
__global__ void __launch_bounds__(kMaxThreads) gather_rows_sum_kernel(
    const float4* __restrict__ feat,  // [N, row4]
    const int* __restrict__ nbr,      // [S, W]
    int S, int W, int row4, int stage_rows,
    float4* __restrict__ out) {       // [S, row4]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* buf = reinterpret_cast<float4*>(smem_raw);  // [2][stage_rows][T]

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * T + tid;
  if (col >= row4) return;  // no block-wide barrier below
  const int s0 = blockIdx.x * kSegsPerBlock;
  const int nseg = min(kSegsPerBlock, S - s0);
  const int per_seg = (W + stage_rows - 1) / stage_rows;
  const int nstage = nseg * per_seg;

  // stage t covers rows [j0, j0 + n) of segment s0 + t / per_seg
  auto fetch = [&](int t) {
    const int seg = t / per_seg;
    const int j0 = (t - seg * per_seg) * stage_rows;
    const int n = min(stage_rows, W - j0);
    const int* ids = nbr + static_cast<size_t>(s0 + seg) * W + j0;
    float4* dst = buf + static_cast<size_t>(t & 1) * stage_rows * T + tid;
    for (int r = 0; r < n; ++r) {
      cp_async_16(dst + static_cast<size_t>(r) * T,
                  feat + static_cast<size_t>(ids[r]) * row4 + col);
    }
    cp_async_commit();
  };

  fetch(0);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < nstage; ++t) {
    if (t + 1 < nstage) {
      fetch(t + 1);
      cp_async_wait<1>();  // stage t has landed; t + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    const int seg = t / per_seg;
    const int j0 = (t - seg * per_seg) * stage_rows;
    const int n = min(stage_rows, W - j0);
    const float4* src =
        buf + static_cast<size_t>(t & 1) * stage_rows * T + tid;
    for (int r = 0; r < n; ++r) {
      const float4 v = src[static_cast<size_t>(r) * T];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    if (j0 + n == W) {  // the segment's last stage
      out[static_cast<size_t>(s0 + seg) * row4 + col] = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
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
  int T = ((min(row4, kMaxThreads) + 31) / 32) * 32;
  int stage_rows = kStageBytes / (T * 16);
  stage_rows = max(1, min(min(stage_rows, kMaxStageRows), W));
  const size_t smem = static_cast<size_t>(2) * stage_rows * T * 16;
  cudaError_t e = cudaFuncSetAttribute(
      gather_rows_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kSegsPerBlock - 1) / kSegsPerBlock,
                  (row4 + T - 1) / T);
  check_ids(nbr, static_cast<size_t>(S) * W, N,
            static_cast<cudaStream_t>(stream));
  gather_rows_sum_kernel<<<grid, T, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(feat), nbr, S, W, row4, stage_rows,
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
