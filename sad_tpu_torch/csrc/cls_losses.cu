// The RetinaNet classification losses of the SAD step, forward and backward,
// over the dense (rows, C) grid of one FPN level.
//
// Replaces the four TPU kernels of sad_tpu/ops/pallas_losses.py:
//   _fwd_kernel, _fwd_kernel_aligned  (launched by _raw_fwd_impl)
//   _bwd_kernel, _bwd_kernel_aligned  (launched by _raw_bwd)
// What those do only because of the TPU is not carried over: the PACK=8 lane
// packing, _expand_labels' 0/1 matmul, the SMEM (2, G) scale table and the
// masked/aligned split. Here one forward and one backward kernel take any
// row count and any number of groups.
//
// Forward, per group g of the rows (rows are group-major: group g owns rows
// [g*rpg, (g+1)*rpg)), the raw sums
//   focal_raw[g]   = sum of the sigmoid focal loss, alpha folded, no 1/Np
//   distill_raw[g] = sum of the adaptive distillation loss, no 1/Np
//   powsum[g]      = sum of pt^power (the PowSum normalizer), when wanted
// Backward: dx = focal' * g_focal[g] + distill' * g_distill[g], with the
// published CUDA backwards' factoring, as _bwd_kernel (pallas_losses.py:240-259)
// writes it. The per-element terms follow _elementwise_terms
// (pallas_losses.py:104-127): one expf(-|x|), one logf(1 + e) and one
// expf(-D) cover sigmoid, log p, log(1-p), D and q; powf(pt, power) only for
// PowSum; integer gammas 0..4 are multiplies, as _ipow_or_pow does.
//
// Numerics: full-precision expf/logf/powf, never the __expf intrinsics, and
// the library is built with --fmad=false (ops/_build.py), so the terms round
// as the plain PyTorch twin (ops/fused_losses.py) rounds them.
// Determinism: no atomics. A block never straddles a group; each block
// writes one (focal, distill, powsum) partial, summed in double inside the
// block, and a second kernel sums the partials of each group in a fixed
// order. Two runs give the same bits.
//
// What bounds it on the H100: bytes. The forward reads 8 B per element
// (logit + teacher prob) and 4 B per row (label); the backward reads the same
// and writes 4 B per element. The transcendental work, ~5 MUFU-class
// operations an element, stays below that at the flagship shapes. Layout: one
// warp per row, lane l on columns l, l+32, l+64: each row of 80 floats is
// read as 320 contiguous bytes, and the label is one load per warp.
// What a later version could do: 16-byte vector loads over row pairs, keep
// the 80-column tail lanes busy, and fuse the backward into the forward of
// the next step's loss (it needs only the per-group cotangents).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kLogFltMin = -87.33654475f;  // logf(FLT_MIN)

struct Params {
  float gamma_f, alpha_f;
  float gamma_d, alpha_d, beta_d;
  float power;
  int igamma_f;   // gamma_f when it is an integer in 0..4, else -1
  int igamma_d;   // likewise for gamma_d
  int igamma_d1;  // likewise for gamma_d - 1
  int ignored_label;
  int want_powsum;
};

// x**gamma, integer gammas 0..4 as ((x*x)*x)*x, as _ipow_or_pow does
__device__ __forceinline__ float ipow_or_pow(float x, float gamma, int igamma) {
  if (igamma < 0) return powf(x, gamma);
  float out = 1.0f;
  if (igamma > 0) {
    out = x;
    for (int i = 1; i < igamma; ++i) out = out * x;
  }
  return out;
}

struct Terms {
  float p, log_p, log_1mp, q, exp_neg_d;
};

__device__ __forceinline__ Terms elementwise_terms(float x, float pt, const Params& P) {
  Terms t;
  const float ge = x >= 0.0f ? 1.0f : 0.0f;
  const float e = expf(-fabsf(x));  // exp(x - 2*x*ge), exactly
  const float log1pe = logf(1.0f + e);
  t.p = (ge + (1.0f - ge) * e) / (1.0f + e);
  t.log_1mp = -x * ge - log1pe;
  t.log_p = fmaxf(x + t.log_1mp, kLogFltMin);
  float d = -x * (pt - ge) + log1pe;
  if (P.beta_d != 0.0f) {
    const float c = fminf(fmaxf(pt, kFltMin), 1.0f - 1e-7f);
    d = d + P.beta_d * (c * logf(c) + (1.0f - c) * logf(1.0f - c));
  }
  t.exp_neg_d = expf(-d);
  t.q = 1.0f - t.exp_neg_d;
  return t;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (blocks_per_group, G); block b of group g takes rows
// g*rpg + b*kWarps + w + k*(blocks_per_group*kWarps), one warp per row
__global__ void __launch_bounds__(kThreads)
cls_losses_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pt,
                      const int32_t* __restrict__ labels, double* __restrict__ partial,
                      long long rows_per_group, int c, Params P) {
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  double focal = 0.0, distill = 0.0, pows = 0.0;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows_per_group; r += stride) {
    const long long row = (long long)g * rows_per_group + r;
    const int t = labels[row];
    const float dmask = t != P.ignored_label ? 1.0f : 0.0f;
    const float* xr = x + row * c;
    const float* pr = pt + row * c;
    float f_row = 0.0f, d_row = 0.0f, p_row = 0.0f;
    for (int k = lane; k < c; k += 32) {
      const float xv = xr[k];
      const float pv = pr[k];
      const Terms s = elementwise_terms(xv, pv, P);
      const float c1 = t == k + 1 ? 1.0f : 0.0f;
      const float c2 = (t != -1 && t != k + 1) ? 1.0f : 0.0f;
      f_row += -c1 * P.alpha_f * ipow_or_pow(1.0f - s.p, P.gamma_f, P.igamma_f) * s.log_p
               - c2 * (1.0f - P.alpha_f) * ipow_or_pow(s.p, P.gamma_f, P.igamma_f) * s.log_1mp;
      d_row += -ipow_or_pow(s.q, P.gamma_d, P.igamma_d)
               * (P.alpha_d * pv * s.log_p + (1.0f - P.alpha_d) * (1.0f - pv) * s.log_1mp)
               * dmask;
      if (P.want_powsum) p_row += powf(pv, P.power);
    }
    focal += f_row;
    distill += d_row;
    pows += p_row;
  }
  __shared__ double red[3][kWarps];
  focal = warp_sum(focal);
  distill = warp_sum(distill);
  pows = warp_sum(pows);
  if (lane == 0) {
    red[0][warp] = focal;
    red[1][warp] = distill;
    red[2][warp] = pows;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
    partial[((size_t)g * gridDim.x + blockIdx.x) * 3 + threadIdx.x] = s;
  }
}

// one block per group: out[g] = sum over the group's partials, fixed order
__global__ void __launch_bounds__(kThreads)
cls_losses_sum_kernel(const double* __restrict__ partial, float* __restrict__ out,
                      int blocks_per_group) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double s[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < blocks_per_group; b += kThreads)
    for (int j = 0; j < 3; ++j) s[j] += partial[((size_t)g * blocks_per_group + b) * 3 + j];
  __shared__ double red[3][kWarps];
  for (int j = 0; j < 3; ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[threadIdx.x][w];
    out[g * 3 + threadIdx.x] = (float)v;
  }
}

__global__ void __launch_bounds__(kThreads)
cls_losses_bwd_kernel(const float* __restrict__ x, const float* __restrict__ pt,
                      const int32_t* __restrict__ labels, const float* __restrict__ g_focal,
                      const float* __restrict__ g_distill, float* __restrict__ dx,
                      long long rows_per_group, int c, Params P) {
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  const float gf = g_focal[g];
  const float gd = g_distill[g];
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < rows_per_group; r += stride) {
    const long long row = (long long)g * rows_per_group + r;
    const int t = labels[row];
    const float dmask = t != P.ignored_label ? 1.0f : 0.0f;
    const float* xr = x + row * c;
    const float* pr = pt + row * c;
    float* dr = dx + row * c;
    for (int k = lane; k < c; k += 32) {
      const float xv = xr[k];
      const float pv = pr[k];
      const Terms s = elementwise_terms(xv, pv, P);
      const float c1 = t == k + 1 ? 1.0f : 0.0f;
      const float c2 = (t != -1 && t != k + 1) ? 1.0f : 0.0f;
      // focal backward (sigmoid_focal_loss_op.cu:94-107), alpha folded
      const float term1 = ipow_or_pow(1.0f - s.p, P.gamma_f, P.igamma_f)
                          * (1.0f - s.p - s.p * P.gamma_f * s.log_p);
      const float term2 = ipow_or_pow(s.p, P.gamma_f, P.igamma_f)
                          * (s.log_1mp * (1.0f - s.p) * P.gamma_f - s.p);
      const float dx_f = (-c1 * P.alpha_f * term1 - c2 * (1.0f - P.alpha_f) * term2) * gf;
      // distill backward (sigmoid_adaptive_distillation_loss_op.cu:69-105),
      // the published factoring, verbatim
      const float d_loss_term = P.alpha_d * pv * s.log_p
                                + (1.0f - P.alpha_d) * (1.0f - pv) * s.log_1mp;
      const float dx_d =
          -(-(pv - s.p) * P.gamma_d * ipow_or_pow(s.q, P.gamma_d - 1.0f, P.igamma_d1)
                * s.exp_neg_d * d_loss_term
            + ipow_or_pow(s.q, P.gamma_d, P.igamma_d)
                  * (P.alpha_d * (pv - s.p) - (1.0f - 2.0f * P.alpha_d) * (1.0f - pv) * s.p))
          * dmask * gd;
      dr[k] = dx_f + dx_d;
    }
  }
}

Params make_params(float gamma_f, float alpha_f, float gamma_d, float alpha_d, float beta_d,
                   float power, int igamma_f, int igamma_d, int igamma_d1, int ignored_label,
                   int want_powsum) {
  Params P;
  P.gamma_f = gamma_f;
  P.alpha_f = alpha_f;
  P.gamma_d = gamma_d;
  P.alpha_d = alpha_d;
  P.beta_d = beta_d;
  P.power = power;
  P.igamma_f = igamma_f;
  P.igamma_d = igamma_d;
  P.igamma_d1 = igamma_d1;
  P.ignored_label = ignored_label;
  P.want_powsum = want_powsum;
  return P;
}

}  // namespace

// x, pt: (G * rows_per_group, c) float32; labels: (G * rows_per_group,)
// int32; partial: (G, blocks_per_group, 3) float64 scratch; out: (G, 3)
// float32 = (focal_raw, distill_raw, powsum) per group.
extern "C" int sad_cls_losses_fwd(const float* x, const float* pt, const int32_t* labels,
                                  double* partial, float* out, int n_groups,
                                  long long rows_per_group, int c, int blocks_per_group,
                                  float gamma_f, float alpha_f, float gamma_d, float alpha_d,
                                  float beta_d, float power, int igamma_f, int igamma_d,
                                  int igamma_d1, int ignored_label, int want_powsum,
                                  cudaStream_t stream) {
  const Params P = make_params(gamma_f, alpha_f, gamma_d, alpha_d, beta_d, power, igamma_f,
                               igamma_d, igamma_d1, ignored_label, want_powsum);
  if (n_groups > 0) {
    cls_losses_fwd_kernel<<<dim3(blocks_per_group, n_groups), kThreads, 0, stream>>>(
        x, pt, labels, partial, rows_per_group, c, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cls_losses_sum_kernel<<<n_groups, kThreads, 0, stream>>>(partial, out, blocks_per_group);
  }
  return (int)cudaGetLastError();
}

// g_focal, g_distill: (G,) float32 cotangents of focal_raw and distill_raw;
// dx: (G * rows_per_group, c) float32.
extern "C" int sad_cls_losses_bwd(const float* x, const float* pt, const int32_t* labels,
                                  const float* g_focal, const float* g_distill, float* dx,
                                  int n_groups, long long rows_per_group, int c,
                                  int blocks_per_group, float gamma_f, float alpha_f,
                                  float gamma_d, float alpha_d, float beta_d, int igamma_f,
                                  int igamma_d, int igamma_d1, int ignored_label,
                                  cudaStream_t stream) {
  const Params P = make_params(gamma_f, alpha_f, gamma_d, alpha_d, beta_d, 1.0f, igamma_f,
                               igamma_d, igamma_d1, ignored_label, 0);
  if (n_groups > 0) {
    cls_losses_bwd_kernel<<<dim3(blocks_per_group, n_groups), kThreads, 0, stream>>>(
        x, pt, labels, g_focal, g_distill, dx, rows_per_group, c, P);
  }
  return (int)cudaGetLastError();
}
