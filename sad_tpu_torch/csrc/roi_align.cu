// Multilevel RoIAlign, forward and backward: every roi is pooled from its own
// FPN level, and the backward scatters the cotangent back through the same
// taps (the second half of this file).
//
// The forward replaces the TPU kernel _mlra_kernel of
// sad_tpu/ops/pallas_roi_align.py (launched by _windowed_forward, with the
// per-roi descriptors of _build_meta). That kernel turns RoIAlign into windowed tent-weight matrix
// products with double-buffered copies, because a gather is slow on a TPU.
// Here the gather is the natural form, so none of that is carried over: no
// windows or tiles, no roi descriptors built ahead of the launch, no padding
// of R, C or the level widths, no limit on R, and levels of any size (a 1x2
// level works).
//
// Semantics (pallas_roi_align.py:209-231 and :382-502; those of Detectron's
// roi_align_op.cu:89-160). For roi r = [batch, x1, y1, x2, y2] on level l:
//   scale = 1 / 2^l;  x1..y2 *= scale, no rounding
//   bin_w = max(x2 - x1, 1) / res,  bin_h = max(y2 - y1, 1) / res
//   sample (p, i) of an axis:  s = start + p * bin + (i + 0.5) * (bin / sr)
//   a sample with s < -1 or s > n contributes nothing; else s is clamped to
//   [0, n - 1] and weighs the two cells around it by max(0, 1 - |s - cell|)
//   out[r, p, q, :] = sum over the sr x sr samples of the bilinear value,
//                     divided by sr on each axis
// Sums are kept in float32 whatever the feature type, and the result is
// rounded once to the feature type. An invalid roi writes zeros and reads
// nothing. A level outside the table or a batch index outside the batch is
// clamped into range, so no address is ever out of bounds.
// Build with --fmad=false so that the sample positions are computed exactly
// as written (the plain PyTorch twin in ops/roi_align.py does the same
// arithmetic in the same order).
//
// Layout: features are (B, H_l, W_l, C) with C contiguous, the output is
// (R, res, res, C). One block pools one row of bins (roi r, bin row p): its
// threads first fill a table of the res * sr x-samples and the sr y-samples
// in shared memory, then each thread owns (bin q, a run of V channels) and
// walks the sr x sr samples x 4 taps. Neighbouring threads read neighbouring
// channels, so every tap is one contiguous read of C values; with C a
// multiple of the vector width the loads are 16 bytes a thread.
//
// What bounds it: bytes. Each output element costs 4 * sr * sr multiply-adds
// (0.05 ms of float32 work at 8000 rois, res 7, C = 256) against an output of
// 200 MB in bf16 and up to 366 MB of feature maps; neighbouring bins and rois
// reread the same cells, which the 50 MB L2 absorbs only in part.
// What a later version could do: stage a roi's window in shared memory (TMA)
// so each cell is read once per roi, sort rois by level and image for L2
// locality, or pool several bin rows per block to reuse the x table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct LevelTable {
  const void* feat[kMaxLevels];  // (B, h, w, C), C contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n_levels;
  int lvl_min;
};

// one sample of one axis: the two cells it touches and their weights, each
// already divided by sr; both weights are 0 for a sample outside [-1, n]
struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Tap make_tap(float start, float bin, int p, int i, int sr, int n) {
  const float s = start + (float)p * bin + ((float)i + 0.5f) * (bin / (float)sr);
  const bool inside = s >= -1.0f && s <= (float)n;
  const float s_eff = fminf(fmaxf(s, 0.0f), (float)(n - 1));
  const float fl = floorf(s_eff);
  Tap t;
  t.lo = (int)fl;
  const bool has_hi = t.lo + 1 <= n - 1;
  t.hi = has_hi ? t.lo + 1 : t.lo;
  const float scale = inside ? 1.0f / (float)sr : 0.0f;
  t.w_lo = (1.0f - (s_eff - fl)) * scale;
  t.w_hi = has_hi ? (1.0f - ((fl + 1.0f) - s_eff)) * scale : 0.0f;
  return t;
}

template <typename T, int V> struct Pack;

template <> struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
};

template <> struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <> struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // a bf16 is the high half of a float32
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(LevelTable lv,
                     const float* __restrict__ rois,      // (R, 5)
                     const int32_t* __restrict__ levels,  // (R,) absolute FPN level
                     const bool* __restrict__ valid,      // (R,)
                     T* __restrict__ out,                 // (R, res, res, C)
                     int batch, int c, int res, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tap* xtap = reinterpret_cast<Tap*>(smem_raw);  // res * sr
  Tap* ytap = xtap + res * sr;                   // sr

  const int r = blockIdx.x / res;
  const int p = blockIdx.x - r * res;
  const int cv = c / V;
  T* orow = out + ((size_t)r * res + p) * res * c;

  if (!valid[r]) {
    float zero[V];
#pragma unroll
    for (int k = 0; k < V; ++k) zero[k] = 0.0f;
    for (int e = threadIdx.x; e < res * cv; e += kThreads) Pack<T, V>::store(orow + (size_t)e * V, zero);
    return;
  }

  int li = levels[r] - lv.lvl_min;
  li = min(max(li, 0), lv.n_levels - 1);
  const int h = lv.h[li], w = lv.w[li];
  const float scale = 1.0f / (float)(1 << (li + lv.lvl_min));
  const float* roi = rois + (size_t)r * 5;
  int b = (int)roi[0];
  b = min(max(b, 0), batch - 1);
  const float x1 = roi[1] * scale, y1 = roi[2] * scale;
  const float x2 = roi[3] * scale, y2 = roi[4] * scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / (float)res;
  const float bin_h = fmaxf(y2 - y1, 1.0f) / (float)res;

  for (int t = threadIdx.x; t < res * sr; t += kThreads) {
    xtap[t] = make_tap(x1, bin_w, t / sr, t % sr, sr, w);
  }
  if (threadIdx.x < sr) ytap[threadIdx.x] = make_tap(y1, bin_h, p, threadIdx.x, sr, h);
  __syncthreads();

  const T* fmap = static_cast<const T*>(lv.feat[li]) + (size_t)b * h * w * c;
  for (int e = threadIdx.x; e < res * cv; e += kThreads) {
    const int q = e / cv;
    const int cc = (e - q * cv) * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int i = 0; i < sr; ++i) {
      const Tap ty = ytap[i];
      const T* row_lo = fmap + (size_t)ty.lo * w * c + cc;
      const T* row_hi = fmap + (size_t)ty.hi * w * c + cc;
      for (int j = 0; j < sr; ++j) {
        const Tap tx = xtap[q * sr + j];
        const T* src[4] = {row_lo + (size_t)tx.lo * c, row_lo + (size_t)tx.hi * c,
                           row_hi + (size_t)tx.lo * c, row_hi + (size_t)tx.hi * c};
        const float wt[4] = {ty.w_lo * tx.w_lo, ty.w_lo * tx.w_hi,
                             ty.w_hi * tx.w_lo, ty.w_hi * tx.w_hi};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[V];
          Pack<T, V>::load(src[t], v);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = acc[k] + v[k] * wt[t];
        }
      }
    }
    Pack<T, V>::store(orow + (size_t)q * c + cc, acc);
  }
}

template <typename T, int V>
void launch(const LevelTable& lv, const float* rois, const int32_t* levels, const bool* valid,
            void* out, int n_rois, int batch, int c, int res, int sr, cudaStream_t stream) {
  const size_t smem = (size_t)(res * sr + sr) * sizeof(Tap);
  roi_align_fwd_kernel<T, V><<<(unsigned)(n_rois * res), kThreads, smem, stream>>>(
      lv, rois, levels, valid, static_cast<T*>(out), batch, c, res, sr);
}


// ---------------------------------------------------------------------------
// Backward: dF_l[b, y, x, :] += w_y * w_x * g[r, p, q, :] for every valid roi,
// bin (p, q), sample (i, j) and each of its four taps, with exactly the
// forward's taps (make_tap above: the position, the [-1, n] rule, the clamp,
// the weights already divided by sr). No gradient goes to the rois.
//
// Replaces the TPU kernel _mlra_bwd_kernel of sad_tpu/ops/pallas_roi_align.py
// (launched by _windowed_backward). That kernel walks the rois one after
// another and reads, updates and writes back 32x32 windows of the gradient,
// which is right only because a TPU grid runs in order on one core. Blocks run
// in parallel here, so the sum is Detectron's scatter (roi_align_op.cu
// RoIAlignBackwardFeature): float32 atomicAdd into float32 gradient maps that
// the launch function zeroes on the same stream. All levels lie in one
// allocation; the wrapper casts it once to the feature type, so the sum is
// float32 whatever the features are. Nothing of the TPU kernel's windows,
// staging buffer, width padding or roi limit is carried over.
//
// Atomics land in no fixed order, so two runs differ in the last bits of a
// cell that several taps hit, and the kernel is held to its plain version by
// a tolerance, not bit for bit.
//
// Layout: the forward's. One block takes (roi r, bin row p), fills the same
// tap tables in shared memory, and each thread owns (bin q, a run of V
// channels): it loads its V cotangent values once (16 bytes when V > 1) and
// adds them per tap with one 16-byte vector atomic per four channels
// (atomicAdd(float4*), Hopper's red.global.add.v4.f32; scalar atomics when C
// or a pointer forbids vectors); neighbouring threads hit neighbouring
// channels of one cell, so a warp's atomics fall into whole cache lines.
// An invalid roi returns before it touches anything; level and batch index
// are clamped as in the forward, so no address is out of bounds.
//
// What bounds it: bytes by the count of the roofline (the cotangent read once
// and the gradient maps written once), but in practice the 4 * sr * sr
// atomics per cotangent element at the L2, and their collisions where many
// rois cover the same cells. What a later version could do: merge the taps of
// a bin row that fall on the same cell before going to memory (a roi spans
// 7..14 cells of its FPN level, so its footprint is several times smaller
// than its 4 * sr * sr * res taps a bin row), or rois sorted by level and
// image.

struct GradTable {
  float* grad[kMaxLevels];  // (B, h, w, C) float32, zeroed before the launch
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n_levels;
  int lvl_min;
};

// dst[0..V) += g[0..V) * wt; V a multiple of 4 means dst is 16-byte aligned
template <int V>
__device__ __forceinline__ void atomic_add_run(float* dst, const float* g, float wt) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + k),
                make_float4(g[k] * wt, g[k + 1] * wt, g[k + 2] * wt, g[k + 3] * wt));
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(dst + k, g[k] * wt);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(GradTable lv,
                     const float* __restrict__ rois,      // (R, 5)
                     const int32_t* __restrict__ levels,  // (R,) absolute FPN level
                     const bool* __restrict__ valid,      // (R,)
                     const T* __restrict__ gout,          // (R, res, res, C) cotangent
                     int batch, int c, int res, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tap* xtap = reinterpret_cast<Tap*>(smem_raw);  // res * sr
  Tap* ytap = xtap + res * sr;                   // sr

  const int r = blockIdx.x / res;
  const int p = blockIdx.x - r * res;
  if (!valid[r]) return;
  const int cv = c / V;

  int li = levels[r] - lv.lvl_min;
  li = min(max(li, 0), lv.n_levels - 1);
  const int h = lv.h[li], w = lv.w[li];
  const float scale = 1.0f / (float)(1 << (li + lv.lvl_min));
  const float* roi = rois + (size_t)r * 5;
  int b = (int)roi[0];
  b = min(max(b, 0), batch - 1);
  const float x1 = roi[1] * scale, y1 = roi[2] * scale;
  const float x2 = roi[3] * scale, y2 = roi[4] * scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / (float)res;
  const float bin_h = fmaxf(y2 - y1, 1.0f) / (float)res;

  for (int t = threadIdx.x; t < res * sr; t += kThreads) {
    xtap[t] = make_tap(x1, bin_w, t / sr, t % sr, sr, w);
  }
  if (threadIdx.x < sr) ytap[threadIdx.x] = make_tap(y1, bin_h, p, threadIdx.x, sr, h);
  __syncthreads();

  float* gmap = lv.grad[li] + (size_t)b * h * w * c;
  const T* grow = gout + ((size_t)r * res + p) * res * c;
  for (int e = threadIdx.x; e < res * cv; e += kThreads) {
    const int q = e / cv;
    const int cc = (e - q * cv) * V;
    float g[V];
    Pack<T, V>::load(grow + (size_t)q * c + cc, g);
    for (int i = 0; i < sr; ++i) {
      const Tap ty = ytap[i];
      float* row_lo = gmap + (size_t)ty.lo * w * c + cc;
      float* row_hi = gmap + (size_t)ty.hi * w * c + cc;
      for (int j = 0; j < sr; ++j) {
        const Tap tx = xtap[q * sr + j];
        float* dst[4] = {row_lo + (size_t)tx.lo * c, row_lo + (size_t)tx.hi * c,
                         row_hi + (size_t)tx.lo * c, row_hi + (size_t)tx.hi * c};
        const float wt[4] = {ty.w_lo * tx.w_lo, ty.w_lo * tx.w_hi,
                             ty.w_hi * tx.w_lo, ty.w_hi * tx.w_hi};
#pragma unroll
        for (int t = 0; t < 4; ++t) atomic_add_run<V>(dst[t], g, wt[t]);
      }
    }
  }
}

template <typename T, int V>
void launch_bwd(const GradTable& lv, const float* rois, const int32_t* levels,
                const bool* valid, const void* gout, int n_rois, int batch, int c, int res,
                int sr, cudaStream_t stream) {
  const size_t smem = (size_t)(res * sr + sr) * sizeof(Tap);
  roi_align_bwd_kernel<T, V><<<(unsigned)(n_rois * res), kThreads, smem, stream>>>(
      lv, rois, levels, valid, static_cast<const T*>(gout), batch, c, res, sr);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when C is a multiple of the
// 16-byte vector width of the type and every pointer is 16-byte aligned.
extern "C" int sad_roi_align_fwd_launch(const void* const* feats, const int* hs, const int* ws,
                                        int n_levels, int lvl_min, const float* rois,
                                        const int32_t* levels, const bool* valid, void* out,
                                        int n_rois, int batch, int c, int res, int sr,
                                        int dtype, int vec, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || lvl_min < 0 || lvl_min + n_levels > 31 ||
      n_rois < 0 || batch < 1 || c < 1 || res < 1 || sr < 1 || (dtype != 0 && dtype != 1) ||
      (long long)n_rois * res > 2147483647LL ||
      (size_t)(res * sr + sr) * sizeof(Tap) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rois == 0) return (int)cudaSuccess;
  LevelTable lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.feat[i] = i < n_levels ? feats[i] : nullptr;
    lv.h[i] = i < n_levels ? hs[i] : 0;
    lv.w[i] = i < n_levels ? ws[i] : 0;
  }
  lv.n_levels = n_levels;
  lv.lvl_min = lvl_min;
  if (dtype == 0) {
    if (vec && c % 4 == 0) {
      launch<float, 4>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr, stream);
    } else {
      launch<float, 1>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr, stream);
    }
  } else {
    if (vec && c % 8 == 0) {
      launch<__nv_bfloat16, 8>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr, stream);
    } else {
      launch<__nv_bfloat16, 1>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr, stream);
    }
  }
  return (int)cudaGetLastError();
}

// The backward. ``grads`` are the per-level float32 gradient maps, all inside
// the one allocation [grad_base, grad_base + grad_bytes), which is zeroed here
// on ``stream`` before the kernel adds into it. dtype is the cotangent's
// (0 = float32, 1 = bfloat16); vec: 1 when C is a multiple of its 16-byte
// vector width and ``gout`` and every gradient map are 16-byte aligned.
extern "C" int sad_roi_align_bwd_launch(float* const* grads, const int* hs, const int* ws,
                                        int n_levels, int lvl_min, const float* rois,
                                        const int32_t* levels, const bool* valid,
                                        const void* gout, void* grad_base, size_t grad_bytes,
                                        int n_rois, int batch, int c, int res, int sr,
                                        int dtype, int vec, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || lvl_min < 0 || lvl_min + n_levels > 31 ||
      n_rois < 0 || batch < 1 || c < 1 || res < 1 || sr < 1 || (dtype != 0 && dtype != 1) ||
      (long long)n_rois * res > 2147483647LL ||
      (size_t)(res * sr + sr) * sizeof(Tap) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaMemsetAsync(grad_base, 0, grad_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_rois == 0) return (int)cudaSuccess;
  GradTable lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.grad[i] = i < n_levels ? grads[i] : nullptr;
    lv.h[i] = i < n_levels ? hs[i] : 0;
    lv.w[i] = i < n_levels ? ws[i] : 0;
  }
  lv.n_levels = n_levels;
  lv.lvl_min = lvl_min;
  if (dtype == 0) {
    if (vec && c % 4 == 0) {
      launch_bwd<float, 4>(lv, rois, levels, valid, gout, n_rois, batch, c, res, sr, stream);
    } else {
      launch_bwd<float, 1>(lv, rois, levels, valid, gout, n_rois, batch, c, res, sr, stream);
    }
  } else {
    if (vec && c % 8 == 0) {
      launch_bwd<__nv_bfloat16, 8>(lv, rois, levels, valid, gout, n_rois, batch, c, res, sr,
                                   stream);
    } else {
      launch_bwd<__nv_bfloat16, 1>(lv, rois, levels, valid, gout, n_rois, batch, c, res, sr,
                                   stream);
    }
  }
  return (int)cudaGetLastError();
}
