// The RetinaNet classification losses of the SAD step, forward and backward,
// over the dense (rows, C) grid of one FPN level.
//
// Replaces the four TPU kernels of sad_tpu/ops/pallas_losses.py:
//   _fwd_kernel, _fwd_kernel_aligned  (launched by _raw_fwd_impl)
//   _bwd_kernel, _bwd_kernel_aligned  (launched by _raw_bwd)
// What those do only because of the TPU is not carried over: the PACK=8 lane
// packing, _expand_labels' 0/1 matmul, the SMEM (2, G) scale table and the
// masked/aligned split. Here one forward and one backward kernel take any
// row count, any C and any number of groups.
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
// expf(-D) cover sigmoid, log p, log(1-p), D and q.
//
// What bounds it on the H100 (sad_tpu_torch/tools/profile_cls_losses.py, at
// P3 of a bs 8 step: 59 M elements, 4 groups). The bytes (8 B an element in,
// 12 B with dx out) take 0.142 / 0.212 ms at 3.35 TB/s. The first design (one
// warp a row of 80, lanes on columns l, l+32, l+64, 4-byte loads, a runtime
// column loop) ran at 5.4x / 3.2x that: its loads waited behind each pass's
// dependent chain. On this design's mapping its arithmetic (powf, runtime
// gamma/beta branches, an IEEE division) took 160 / 138 SASS instructions an
// element; the gamma-2 instances issue 97 / 104:
// - the forward is bound by issue slots: 97 instructions an element at 128
//   lanes a clock on 132 SMs take 0.17 ms at its 1.97 GHz, and it takes 0.195
//   (two reductions over the same bytes take 0.159). The generic instance
//   (8x the static SASS) takes 5x as long on the same bytes;
// - the backward is bound by bytes: 0.245 ms against 0.230 for torch.add over
//   the same 12 B an element; its issue floor is ~0.2 ms at the 1.8-1.9 GHz
//   the 700 W limit leaves it.
// The design:
// - A flat element mapping. Group g is the contiguous block of rpg*C floats
//   at g*rpg*C; a block's threads walk it in chunks of VEC floats (VEC = 4:
//   16-byte loads of x and pt, and a float4 store of dx). With C % 4 == 0 a
//   chunk never straddles a row, so row = e / C (a multiply-high by a magic
//   number, e < 2^31) and the chunk's label is one load that its neighbours
//   share. Every lane is busy. A thread loads all its chunks of an iteration
//   (16 elements: 4 float4 of x and 4 of pt) before any arithmetic. The grid
//   is ~2 waves of blocks (the wrapper's launch_geometry).
// - C % 4 != 0, or x / pt not 16-byte aligned: the VEC = 1 instance of the
//   same kernel (16 scalar loads a thread an iteration). The wrapper picks.
// - Compile-time instances: gamma_f = gamma_d = 2 with beta_d = 0 (the
//   flagship), the forward with PowSum on and off, and a generic instance
//   with runtime gammas, beta and PowSum that keeps the first design's
//   arithmetic (powf, IEEE division, integer gammas as multiplies). The
//   gamma-2 instances select where the generic one branches (the label's
//   class or not, ignored or not), write the chains with fmaf (the library is
//   built with --fmad=false for the exactness of nms.cu and roi_align.cu),
//   take 1 / (1 + e) as the MUFU reciprocal with one Newton step (within an
//   ulp of the division, without its range check and branch), and pt^power
//   as the MUFU ex2(power * lg2(pt)) (~3e-6 relative at pt = 1e-3, ~3e-7
//   at 0.5: inside the 1e-5 of the sums; full-precision exp2f and log2f
//   are polynomials that cost 36 instructions an element).
// - expf and logf stay the full-precision library functions, never __expf.
// Determinism: no atomics. A block never straddles a group; each thread sums
// an iteration's 16 terms in float into double accumulators, the block sums
// its threads in a fixed tree into one (focal, distill, powsum) partial, and
// cls_losses_sum_kernel sums each group's partials in a fixed order. The
// mapping depends on the shape only, so two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElems = 16;  // elements a thread takes an iteration
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kLogFltMin = -87.33654475f;  // logf(FLT_MIN)

// instances (the wrapper's `spec`)
constexpr int kGamma2Pow = 0;    // gamma_f = gamma_d = 2, beta_d = 0, PowSum on
constexpr int kGamma2NoPow = 1;  // the same, PowSum off
constexpr int kGeneric = 2;      // runtime gammas, beta and PowSum

struct Params {
  float gamma_f, alpha_f;
  float gamma_d, alpha_d, beta_d;
  float power;
  int igamma_f;   // gamma_f when it is an integer in 0..4, else -1
  int igamma_d;   // likewise for gamma_d
  int igamma_d1;  // likewise for gamma_d - 1
  int ignored_label;
  int want_powsum;
  int c;              // columns
  unsigned div_mul;   // e / c = umulhi(e, div_mul) >> div_shr for e < 2^31 (c > 1)
  int div_shr;
};

__device__ __forceinline__ int row_of(int e, const Params& P) {
  return P.c == 1 ? e : (int)(__umulhi((unsigned)e, P.div_mul) >> P.div_shr);
}

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

// The MUFU unit's reciprocal (1 ulp), base-2 logarithm and exponential
// (~2^-22 relative). ex2/lg2 serve the PowSum term of the gamma-2 forward
// only, which the wrapper picks for a power >= 1: flushing subnormals to 0
// then moves a term by less than FLT_MIN. The reciprocal, refined by one
// Newton step, serves the sigmoid.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kSpec>
__device__ __forceinline__ Terms elementwise_terms(float x, float pt, const Params& P) {
  Terms t;
  const bool pos = x >= 0.0f;
  const float e = expf(-fabsf(x));  // exp(x - 2*x*ge), exactly
  const float one_pe = 1.0f + e;
  const float log1pe = logf(one_pe);
  float d;
  if (kSpec == kGeneric) {
    t.p = (pos ? 1.0f : e) / one_pe;  // (ge + (1 - ge) * e) / (1 + e)
    d = -x * (pt - (pos ? 1.0f : 0.0f)) + log1pe;
    if (P.beta_d != 0.0f) {
      const float c = fminf(fmaxf(pt, kFltMin), 1.0f - 1e-7f);
      d = d + P.beta_d * (c * logf(c) + (1.0f - c) * logf(1.0f - c));
    }
  } else {
    // 1 / (1 + e), 1 + e in [1, 2]: within an ulp of the IEEE quotient,
    // without the division's range check and its branch
    float r = rcp_approx(one_pe);
    r = fmaf(r, fmaf(-one_pe, r, 1.0f), r);
    t.p = pos ? r : e * r;
    d = fmaf(-x, pt - (pos ? 1.0f : 0.0f), log1pe);
  }
  t.log_1mp = (pos ? -x : 0.0f) - log1pe;  // -x * ge - log1pe
  t.log_p = fmaxf(x + t.log_1mp, kLogFltMin);
  t.exp_neg_d = expf(-d);
  t.q = 1.0f - t.exp_neg_d;
  return t;
}

// alpha_d * pt * log p + (1 - alpha_d) * (1 - pt) * log(1 - p)
template <int kSpec>
__device__ __forceinline__ float distill_loss_term(const Terms& s, float pt, const Params& P) {
  if (kSpec == kGeneric)
    return P.alpha_d * pt * s.log_p + (1.0f - P.alpha_d) * (1.0f - pt) * s.log_1mp;
  return fmaf(P.alpha_d * pt, s.log_p, ((1.0f - P.alpha_d) * (1.0f - pt)) * s.log_1mp);
}

// The forward's terms of one element with label t in class k1 = column + 1:
// focal (alpha folded), distill and PowSum. The gamma-2 instances select
// where the generic one branches: (-alpha * (1-p)^2) * log p for the label's
// class, -((1 - alpha) * p^2) * log(1-p) for the others, 0 for t == -1.
template <int kSpec>
__device__ __forceinline__ void fwd_terms(float x, float pt, int t, int k1, const Params& P,
                                          float& focal, float& distill, float& pows) {
  const Terms s = elementwise_terms<kSpec>(x, pt, P);
  const bool c1 = t == k1;
  float f, wq;
  if (kSpec == kGeneric) {
    f = 0.0f;
    if (c1)
      f = (-P.alpha_f * ipow_or_pow(1.0f - s.p, P.gamma_f, P.igamma_f)) * s.log_p;
    else if (t != -1)
      f = -(((1.0f - P.alpha_f) * ipow_or_pow(s.p, P.gamma_f, P.igamma_f)) * s.log_1mp);
    wq = ipow_or_pow(s.q, P.gamma_d, P.igamma_d);
  } else {
    const float w = c1 ? 1.0f - s.p : s.p;
    const float coef = c1 ? -P.alpha_f : -(1.0f - P.alpha_f);
    f = t != -1 ? (coef * (w * w)) * (c1 ? s.log_p : s.log_1mp) : 0.0f;
    wq = s.q * s.q;
  }
  focal += f;
  const float dl = -(wq * distill_loss_term<kSpec>(s, pt, P));
  distill += t != P.ignored_label ? dl : 0.0f;
  if (kSpec == kGamma2Pow)
    pows += ex2_approx(P.power * lg2_approx(pt));  // pt^power
  else if (kSpec == kGeneric && P.want_powsum)
    pows += powf(pt, P.power);
}

// dx of one element, the published factoring
template <int kSpec>
__device__ __forceinline__ float dx_term(float x, float pt, int t, int k1, float gf, float gd,
                                         const Params& P) {
  const Terms s = elementwise_terms<kSpec>(x, pt, P);
  const float omp = 1.0f - s.p;
  const float pmp = pt - s.p;
  const float dlt = distill_loss_term<kSpec>(s, pt, P);
  float dx_f = 0.0f, dx_d;
  // focal backward (sigmoid_focal_loss_op.cu:94-107), alpha folded: for the
  // label's class (-alpha * term1) * g, for the others -((1 - alpha) * term2) * g
  if (kSpec == kGeneric) {
    if (t == k1)
      dx_f = (-P.alpha_f * (ipow_or_pow(omp, P.gamma_f, P.igamma_f)
                            * (omp - s.p * P.gamma_f * s.log_p))) * gf;
    else if (t != -1)
      dx_f = -((1.0f - P.alpha_f) * (ipow_or_pow(s.p, P.gamma_f, P.igamma_f)
                                     * (s.log_1mp * omp * P.gamma_f - s.p))) * gf;
    // distill backward (sigmoid_adaptive_distillation_loss_op.cu:69-105), the
    // published factoring
    dx_d = -(-pmp * P.gamma_d * ipow_or_pow(s.q, P.gamma_d - 1.0f, P.igamma_d1) * s.exp_neg_d
                 * dlt
             + ipow_or_pow(s.q, P.gamma_d, P.igamma_d)
                   * (P.alpha_d * pmp - (1.0f - 2.0f * P.alpha_d) * (1.0f - pt) * s.p));
  } else {
    const bool c1 = t == k1;
    const float w = c1 ? omp : s.p;
    const float inner = c1 ? omp - (s.p * 2.0f) * s.log_p : (s.log_1mp * omp) * 2.0f - s.p;
    const float coef = c1 ? -P.alpha_f : -(1.0f - P.alpha_f);
    dx_f = t != -1 ? (coef * ((w * w) * inner)) * gf : 0.0f;
    const float a = (-pmp * 2.0f) * s.q * s.exp_neg_d * dlt;
    const float b = fmaf(P.alpha_d, pmp, -((1.0f - 2.0f * P.alpha_d) * (1.0f - pt)) * s.p);
    dx_d = -fmaf(s.q * s.q, b, a);
  }
  return t != P.ignored_label ? dx_f + dx_d * gd : dx_f;
}

template <int VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (blocks_per_group, G). Group g's n = rpg*C/VEC chunks; block b takes,
// in its iteration i, chunks j0 + u*kThreads (u < kElems/VEC) with
// j0 = (b + i*blocks_per_group) * kTile + threadIdx.x.
template <int VEC, int kSpec>
__global__ void __launch_bounds__(kThreads)
cls_losses_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pt,
                      const int32_t* __restrict__ labels, double* __restrict__ partial,
                      int rows_per_group, Params P) {
  constexpr int U = kElems / VEC;
  constexpr unsigned kTile = U * kThreads;
  const int g = blockIdx.y;
  const unsigned n = (unsigned)(rows_per_group * P.c) / VEC;
  const size_t base = (size_t)g * rows_per_group * P.c;
  const float* __restrict__ xg = x + base;
  const float* __restrict__ pg = pt + base;
  const int32_t* __restrict__ lg = labels + (size_t)g * rows_per_group;
  double focal = 0.0, distill = 0.0, pows = 0.0;
  for (unsigned j0 = blockIdx.x * kTile + threadIdx.x; j0 < n; j0 += gridDim.x * kTile) {
    float xv[U][VEC], pv[U][VEC];
    int t[U], col[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned j = j0 + u * kThreads;
      if (j < n) {
        const int e = (int)j * VEC;
        const int r = row_of(e, P);
        col[u] = e - r * P.c;
        load_chunk<VEC>(xg + e, xv[u]);
        load_chunk<VEC>(pg + e, pv[u]);
        t[u] = __ldg(lg + r);
      }
    }
    float f_it = 0.0f, d_it = 0.0f, p_it = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u * kThreads < n) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          fwd_terms<kSpec>(xv[u][v], pv[u][v], t[u], col[u] + v + 1, P, f_it, d_it, p_it);
      }
    }
    focal += f_it;
    distill += d_it;
    pows += p_it;
  }
  __shared__ double red[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

template <int VEC, int kSpec>
__global__ void __launch_bounds__(kThreads)
cls_losses_bwd_kernel(const float* __restrict__ x, const float* __restrict__ pt,
                      const int32_t* __restrict__ labels, const float* __restrict__ g_focal,
                      const float* __restrict__ g_distill, float* __restrict__ dx,
                      int rows_per_group, Params P) {
  constexpr int U = kElems / VEC;
  constexpr unsigned kTile = U * kThreads;
  const int g = blockIdx.y;
  const unsigned n = (unsigned)(rows_per_group * P.c) / VEC;
  const size_t base = (size_t)g * rows_per_group * P.c;
  const float* __restrict__ xg = x + base;
  const float* __restrict__ pg = pt + base;
  float* __restrict__ dg = dx + base;
  const int32_t* __restrict__ lg = labels + (size_t)g * rows_per_group;
  const float gf = g_focal[g];
  const float gd = g_distill[g];
  for (unsigned j0 = blockIdx.x * kTile + threadIdx.x; j0 < n; j0 += gridDim.x * kTile) {
    float xv[U][VEC], pv[U][VEC];
    int t[U], col[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned j = j0 + u * kThreads;
      if (j < n) {
        const int e = (int)j * VEC;
        const int r = row_of(e, P);
        col[u] = e - r * P.c;
        load_chunk<VEC>(xg + e, xv[u]);
        load_chunk<VEC>(pg + e, pv[u]);
        t[u] = __ldg(lg + r);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned j = j0 + u * kThreads;
      if (j < n) {
        float out[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          out[v] = dx_term<kSpec>(xv[u][v], pv[u][v], t[u], col[u] + v + 1, gf, gd, P);
        store_chunk<VEC>(dg + (int)j * VEC, out);
      }
    }
  }
}

// e / d = umulhi(e, mul) >> shr for 0 <= e < 2^31 (d > 1), as CUTLASS's
// FastDivmod: p = 31 + ceil(log2 d), mul = ceil(2^p / d), shr = p - 32
void find_divisor(int d, unsigned* mul, int* shr) {
  if (d <= 1) {
    *mul = 0;
    *shr = 0;
    return;
  }
  int l = 0;
  while ((1ll << l) < d) ++l;
  const int p = 31 + l;
  *mul = (unsigned)(((1ull << p) + (unsigned long long)d - 1) / (unsigned long long)d);
  *shr = p - 32;
}

Params make_params(int c, float gamma_f, float alpha_f, float gamma_d, float alpha_d,
                   float beta_d, float power, int igamma_f, int igamma_d, int igamma_d1,
                   int ignored_label, int want_powsum) {
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
  P.c = c;
  find_divisor(c, &P.div_mul, &P.div_shr);
  return P;
}

// vec 4 loads and stores float4: it needs C % 4 == 0 (a chunk in one row, a
// group's block 16-byte aligned) and 16-byte aligned tensors
bool bad_instance(int vec, int spec, int c, const void* a, const void* b, const void* d) {
  if ((vec != 1 && vec != 4) || spec < kGamma2Pow || spec > kGeneric) return true;
  return vec == 4 && (c % 4 != 0 || ((uintptr_t)a | (uintptr_t)b | (uintptr_t)d) % 16 != 0);
}

template <int VEC>
void launch_fwd(int spec, dim3 grid, cudaStream_t stream, const float* x, const float* pt,
                const int32_t* labels, double* partial, int rpg, const Params& P) {
  if (spec == kGamma2Pow)
    cls_losses_fwd_kernel<VEC, kGamma2Pow>
        <<<grid, kThreads, 0, stream>>>(x, pt, labels, partial, rpg, P);
  else if (spec == kGamma2NoPow)
    cls_losses_fwd_kernel<VEC, kGamma2NoPow>
        <<<grid, kThreads, 0, stream>>>(x, pt, labels, partial, rpg, P);
  else
    cls_losses_fwd_kernel<VEC, kGeneric>
        <<<grid, kThreads, 0, stream>>>(x, pt, labels, partial, rpg, P);
}

template <int VEC>
void launch_bwd(int spec, dim3 grid, cudaStream_t stream, const float* x, const float* pt,
                const int32_t* labels, const float* gf, const float* gd, float* dx, int rpg,
                const Params& P) {
  if (spec == kGeneric)
    cls_losses_bwd_kernel<VEC, kGeneric>
        <<<grid, kThreads, 0, stream>>>(x, pt, labels, gf, gd, dx, rpg, P);
  else  // the backward has no PowSum: both gamma-2 specs take one instance
    cls_losses_bwd_kernel<VEC, kGamma2Pow>
        <<<grid, kThreads, 0, stream>>>(x, pt, labels, gf, gd, dx, rpg, P);
}

}  // namespace

// x, pt: (G * rows_per_group, c) float32; labels: (G * rows_per_group,)
// int32; partial: (G, blocks_per_group, 3) float64 scratch; out: (G, 3)
// float32 = (focal_raw, distill_raw, powsum) per group. vec: 4 (c % 4 == 0,
// x and pt 16-byte aligned) or 1; spec: kGamma2Pow, kGamma2NoPow or
// kGeneric; anything else returns cudaErrorInvalidValue and launches
// nothing. rows_per_group * c < 2^31.
extern "C" int sad_cls_losses_fwd(const float* x, const float* pt, const int32_t* labels,
                                  double* partial, float* out, int n_groups, int rows_per_group,
                                  int c, int blocks_per_group, int vec, int spec,
                                  float gamma_f, float alpha_f, float gamma_d, float alpha_d,
                                  float beta_d, float power, int igamma_f, int igamma_d,
                                  int igamma_d1, int ignored_label, int want_powsum,
                                  cudaStream_t stream) {
  if (bad_instance(vec, spec, c, x, pt, x)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(c, gamma_f, alpha_f, gamma_d, alpha_d, beta_d, power, igamma_f,
                               igamma_d, igamma_d1, ignored_label, want_powsum);
  if (n_groups > 0) {
    const dim3 grid(blocks_per_group, n_groups);
    if (vec == 4)
      launch_fwd<4>(spec, grid, stream, x, pt, labels, partial, rows_per_group, P);
    else
      launch_fwd<1>(spec, grid, stream, x, pt, labels, partial, rows_per_group, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cls_losses_sum_kernel<<<n_groups, kThreads, 0, stream>>>(partial, out, blocks_per_group);
  }
  return (int)cudaGetLastError();
}

// g_focal, g_distill: (G,) float32 cotangents of focal_raw and distill_raw;
// dx: (G * rows_per_group, c) float32, 16-byte aligned when vec == 4, as
// x and pt are.
extern "C" int sad_cls_losses_bwd(const float* x, const float* pt, const int32_t* labels,
                                  const float* g_focal, const float* g_distill, float* dx,
                                  int n_groups, int rows_per_group, int c, int blocks_per_group,
                                  int vec, int spec, float gamma_f, float alpha_f,
                                  float gamma_d, float alpha_d, float beta_d, int igamma_f,
                                  int igamma_d, int igamma_d1, int ignored_label,
                                  cudaStream_t stream) {
  if (bad_instance(vec, spec, c, x, pt, dx)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(c, gamma_f, alpha_f, gamma_d, alpha_d, beta_d, 1.0f, igamma_f,
                               igamma_d, igamma_d1, ignored_label, 0);
  if (n_groups > 0) {
    const dim3 grid(blocks_per_group, n_groups);
    if (vec == 4)
      launch_bwd<4>(spec, grid, stream, x, pt, labels, g_focal, g_distill, dx, rows_per_group, P);
    else
      launch_bwd<1>(spec, grid, stream, x, pt, labels, g_focal, g_distill, dx, rows_per_group, P);
  }
  return (int)cudaGetLastError();
}
