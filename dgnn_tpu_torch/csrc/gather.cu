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
//     The TPU kernel kept the whole table in fast memory.  The tables here
//     (512 KB to 4 MB) do not fit a block's shared memory, so residency is
//     by column slab: a block loads tab[:, slab] (w columns, c * w * 4
//     bytes <= kLaneSlabBytes) once, then walks its share of the rows of
//     idx, each thread reading its own idx[r, q % L] and gathering from
//     the slab.  Bound: bytes of idx, out and the table.  Shared-memory
//     banks: a slab row is w floats, so at w >= 32 the threads of a warp
//     read distinct banks whatever their rows; at w = 16 (8) a warp covers
//     2 (4) rows of idx whose table rows collide on a bank when their ids
//     agree mod 2 (4): up to 2-way (4-way) conflicts, left as they are.
//
// Both kernels read their ids unchecked, so each launcher first runs
// check_ids_kernel over them on the same stream: an id outside the table
// traps there (a CUDA error at the next synchronisation) and the gather
// behind it never runs, so nothing outside the table is read.  The check is
// a pass of its own because inside the gathers' loops it cost gather_lanes
// up to 2.6 times its time (a trap in the loop) or 1.8 times (a flag tested
// behind the loop) on an H100 at a 4096-row table.
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
constexpr int kLaneThreads = 256;
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

// grid: (column slabs, row chunks).  Threads: kLaneThreads / w rows x w
// columns at a time.
__global__ void __launch_bounds__(kLaneThreads) gather_lanes_kernel(
    const float* __restrict__ tab,  // [c, width]
    const int* __restrict__ idx,    // [R, L]
    int c, int width, int R, int L, int w, int rows_per_block,
    float* __restrict__ out) {      // [R, width]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slab = reinterpret_cast<float*>(smem_raw);  // [c][w]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * w;
  for (int e = tid; e < c * w; e += kLaneThreads) {
    const int row = e / w;
    const int x = e - row * w;
    slab[e] = tab[static_cast<size_t>(row) * width + q0 + x];
  }
  __syncthreads();

  const int x = tid % w;
  const int q = q0 + x;
  const int lane = q % L;
  const int r_end = min(R, (blockIdx.y + 1) * rows_per_block);
  for (int r = blockIdx.y * rows_per_block + tid / w; r < r_end;
       r += kLaneThreads / w) {
    const int id = idx[static_cast<size_t>(r) * L + lane];
    out[static_cast<size_t>(r) * width + q] = slab[id * w + x];
  }
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

// w: slab columns, a power of two <= kLaneThreads that divides width, with
// c * w * 4 <= kLaneSlabBytes (ops/gather.py lane_slab_width).
int dgnn_gather_lanes(const float* tab, const int* idx, int c, int width,
                      int R, int L, int w, float* out, void* stream) {
  if (c < 1 || L < 1 || width < 1 || width % L || w < 1 ||
      w > kLaneThreads || (w & (w - 1)) || width % w || R < 0 ||
      static_cast<size_t>(c) * w * 4 > kLaneSlabBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(c) * w * 4;
  cudaError_t e = cudaFuncSetAttribute(
      gather_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about one block per SM: each block re-reads its slab of the table, so
  // more blocks buy parallelism with table traffic
  const int slabs = width / w;
  const int chunks = max(1, min((sms + slabs - 1) / slabs, R));
  const int rows_per_block = (R + chunks - 1) / chunks;
  const dim3 grid(slabs, (R + rows_per_block - 1) / rows_per_block);
  check_ids(idx, static_cast<size_t>(R) * L, c,
            static_cast<cudaStream_t>(stream));
  gather_lanes_kernel<<<grid, kLaneThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      tab, idx, c, width, R, L, w, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
