// Device helpers shared by the MoNet (GMMConv) kernels (bin_gmm.cu,
// dense_gmm.cu): the projected pseudo-coordinate of an edge and its Gaussian
// kernel weights, as dgnn_tpu/ops/gmm.py defines them in node-pseudo mode:
//
//   p_d  = alpha_d[src] + beta_d[dst]          (tanh'd when use_tanh)
//   t_kd = (p_d - mu_kd) * isig_kd
//   w_k  = exp(-0.5 * sum_d t_kd^2)
//
// The sums use __fadd_rn / __fmul_rn so that nvcc contracts nothing into an
// fma: the plain PyTorch versions compute the same products and sums as
// separate roundings, and in bf16 mode an ulp in w_k can flip a rounding.

#pragma once

#include <cuda_runtime.h>

namespace dgnn {

constexpr int kGmmMaxK = 8;    // Gaussian kernels; the wrappers refuse more
constexpr int kGmmMaxD = 4;    // projected pseudo dimensions
constexpr int kGmmMaxDd = 4;   // raw destination-side pseudo scalars
constexpr int kGmmMaxKD = kGmmMaxK * kGmmMaxD;

// p[d] for d < D from the two endpoints' projections.
__device__ __forceinline__ void gmm_coords(const float* a, const float* b,
                                           int D, bool use_tanh, float* p) {
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) {
    if (d < D) {
      const float pre = __fadd_rn(a[d], b[d]);
      p[d] = use_tanh ? tanhf(pre) : pre;
    }
  }
}

// w_k of one kernel; also leaves diff[d] = p_d - mu_kd and t[d] = t_kd.
__device__ __forceinline__ float gmm_weight(const float* p, const float* mu_k,
                                            const float* isig_k, int D,
                                            float* diff, float* t) {
  float q = 0.f;
#pragma unroll
  for (int d = 0; d < kGmmMaxD; ++d) {
    if (d < D) {
      diff[d] = __fsub_rn(p[d], mu_k[d]);
      t[d] = __fmul_rn(diff[d], isig_k[d]);
      const float tt = __fmul_rn(t[d], t[d]);
      q = d == 0 ? tt : __fadd_rn(q, tt);
    }
  }
  return expf(__fmul_rn(-0.5f, q));
}

}  // namespace dgnn
