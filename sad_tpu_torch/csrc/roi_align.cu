// Multilevel RoIAlign, forward and backward: every roi is pooled from its own
// FPN level, and the backward gathers the cotangent back onto the maps
// through the same taps (the second half of this file).
//
// The forward replaces the TPU kernel _mlra_kernel of
// sad_tpu/ops/pallas_roi_align.py (launched by _windowed_forward, with the
// per-roi descriptors of _build_meta). That kernel turns RoIAlign into windowed tent-weight matrix
// products with double-buffered copies, because a gather is slow on a TPU.
// Here the gather is the natural form, so none of that is carried over: no
// windows or tiles of the map, no roi descriptors built ahead of the launch,
// no padding of R, C or the level widths, no limit on R, and levels of any
// size (a 1x2 level works).
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
// as written: each output element adds acc = acc + v * (wy * wx) over sample
// i, sample j, then the (lo, lo), (lo, hi), (hi, lo), (hi, hi) cells, as the
// plain PyTorch twin in ops/roi_align.py does, so the two are bit-equal.
//
// Layout: features are (B, H_l, W_l, C) with C contiguous, the output is
// (R, res, res, C). One block takes one roi and a group of its channel
// slices of L lanes x V channels (V = 16 bytes of the type, or 1 for the
// scalar instances): all its slices where R gives kMinBlocks blocks or more
// (the serving and training box shapes), else fewer, down to one.
//   1. the roi's record is read in one round trip; warp 0 builds its
//      res * sr x taps and warp 1 its y taps, once for the block's slices,
//      in shared memory. A running count over each axis's taps ranks the
//      distinct cells they reach (the sample positions grow along an axis,
//      so a tap adds a cell only beyond the last tap's hi cell), and each tap
//      keeps the slots of its two cells in that compact list (at most
//      2 * res * sr an axis, whatever the roi's width on its map). Where the
//      positions pass ~2^19 (maps wider or taller than ~half a million cells)
//      float rounding can step one back a cell; every tap of such an axis
//      keeps two slots of its own.
//   2. for each slice, the distinct rows x distinct columns of the roi are
//      copied into a shared buffer of ``cap`` cells (kStageBytes) with
//      cp.async (16-byte copies that skip L1; 4-byte ones for float scalars,
//      plain copies for bf16 scalars): every tapped cell once a slice. A roi
//      that fits the buffer is one tile; a larger one is walked in column
//      chunks no wider than cap / (2 sr) slots and, in each, bands of bin
//      rows that fit. The SM's other resident blocks sum while the copies fly.
//   3. the threads take the tile's (bin, lane) items, lane fastest, each
//      thread keeping one lane: 16 reads of V channels from shared memory an
//      item at sr 2, the sums in float32 registers, one store. The block has
//      as many warps as make the fewest idle lanes over a slice's
//      res * res * L items (at most 256 threads), so a small C (one lane,
//      L = 1: the mask-target crop, C = 1 at res 28) still gives every thread
//      an item.
// Instances: <T, 16-byte V, L = 8> for C a multiple of V with C / V >= 8 and
// 16-byte aligned pointers (the main paths: bf16, C = 256, 4 slices a roi),
// <T, 1, 1> for every other C (the mask-target crop: C = 1); each with sr = 2
// fixed at compile time (the loops unrolled) and with sr at run time.
// Limit: a block's shared memory, fwd_smem (48 bytes a tap of res * sr, then
// the buffer: kStageBytes, or one bin's 4 sr^2 cells where that is more), is
// at most kMaxSmem. With the kStageBytes buffer (any sr for the scalar
// instance, sr <= 9 for the 16-byte ones) that is res * sr <= kMaxTaps.
//
// What bounds it: issue slots and each block's chain of latencies, not bytes
// (tools/profile_roi_align.py; PERF.md section 6). At the serving box shape
// (R = 8000, res 7, C = 256, bf16) an item of 8 channels costs ~530 SASS
// instructions (16 multiplies and 16 adds a channel, bf16 unpacks, shared
// loads, addresses), ~0.2 ms of the card's issue rate, and the staged cells
// (each roi's distinct cells, 1.18 GB, 2.3x the byte bound's bytes) come from
// L2 at ~5 TB/s; the byte bound is 0.15 ms. A block a (roi, slice) spent
// 0.13 ms on its roi load, tables and barriers alone, which a block a roi
// cuts to ~0.08. The earlier kernel (a block a bin row, 16 global loads an
// element) spent 0.357 of its 0.464 ms there even with every tap on one 2x2
// block of cells.
// What a later version could do: hide the per-roi chain behind the previous
// roi's sums without halving the buffer (the persistent, double-buffered
// variants tried lost more to smaller tiles and barriers than they hid), and
// cut the instructions an item (the bf16 unpacks are a quarter of them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // most threads a forward block
constexpr int kStageBytes = 49152;  // a forward block's staging buffer: 4 blocks an SM
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may have on sm_90
// the most taps an axis: their tables (fwd_tables_bytes) and the buffer fit kMaxSmem
constexpr int kMaxTaps = (kMaxSmem - kStageBytes - 8) / 48;
constexpr int kMinBlocks = 4096;    // ~8 waves of 4 resident forward blocks on 132 SMs
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V values of T: Raw is their bits, unpack turns them into float32, stage
// copies them from the map into shared memory, load and store go to global
// memory
template <typename T, int V> struct Pack;

template <> struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(Raw x, float* v) { v[0] = x; }
  static __device__ __forceinline__ void stage(Raw* dst, const float* src) { cp_async4(dst, src); }
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
};

template <> struct Pack<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& x, float* v) {
    v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
    v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
  }
  static __device__ __forceinline__ void stage(Raw* dst, const float* src) { cp_async16(dst, src); }
  static __device__ __forceinline__ void load(const float* p, float* v) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Pack<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  // a bf16 is the high half of a float32
  static __device__ __forceinline__ void unpack(Raw x, float* v) {
    v[0] = __uint_as_float((uint32_t)x << 16);
  }
  static __device__ __forceinline__ void stage(Raw* dst, const __nv_bfloat16* src) {
    *dst = __ldg(reinterpret_cast<const unsigned short*>(src));  // no 2-byte cp.async
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <> struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& x, float* v) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void stage(Raw* dst, const __nv_bfloat16* src) {
    cp_async16(dst, src);
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

// a tap in slot form: the slots of its two cells in the axis's list of
// distinct cells, and its weights (one 16-byte shared load)
struct __align__(16) SlotTap {
  int lo, hi;
  float w_lo, w_hi;
};

// bytes of a forward block's tap tables (two SlotTaps and four ints a tap,
// two counts), rounded up to 16 so that the staging buffer after them is
// 16-byte aligned
__host__ __device__ constexpr int fwd_tables_bytes(int n) { return (48 * n + 8 + 15) & ~15; }

// a / d for 0 <= a < 2^22 and d >= 1, with inv = 1.0f / d: (a + 0.5) / d
// lies at least 0.5 / d from an integer, more than the product's rounding
__device__ __forceinline__ int div_small(int a, float inv) {
  return (int)(((float)a + 0.5f) * inv);
}

// one warp: the n = res * sr taps of one axis in slot form, the cell of each
// slot, and the count of slots
__device__ void build_axis(float start, float bin, int res, int sr, int len, SlotTap* tab,
                           int* cell, int* count, int lane) {
  const int n = res * sr;
  int prev_lo = -1, prev_hi = -1, total = 0;
  bool grows = true;
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool on = k < n;
    const Tap t = make_tap(start, bin, k / sr, k % sr, sr, len);
    int plo = __shfl_up_sync(0xffffffffu, t.lo, 1);
    int phi = __shfl_up_sync(0xffffffffu, t.hi, 1);
    if (lane == 0) {
      plo = prev_lo;
      phi = prev_hi;
    }
    grows = __all_sync(0xffffffffu, !on || t.lo >= plo) && grows;
    const int nlo = on && t.lo > phi;
    const int nhi = on && t.hi != t.lo && t.hi > phi;
    int incl = nlo + nhi;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const int s_hi = total + incl - 1;
    const int s_lo = s_hi - (t.hi != t.lo);
    if (on) {
      tab[k] = SlotTap{s_lo, s_hi, t.w_lo, t.w_hi};
      if (nlo) cell[s_lo] = t.lo;
      if (nhi) cell[s_hi] = t.hi;
    }
    total += __shfl_sync(0xffffffffu, incl, 31);
    prev_lo = __shfl_sync(0xffffffffu, t.lo, 31);
    prev_hi = __shfl_sync(0xffffffffu, t.hi, 31);
  }
  if (!grows) {  // the same for the whole warp; only past ~2^19 cells of an axis
    for (int k = lane; k < n; k += 32) {
      const Tap t = make_tap(start, bin, k / sr, k % sr, sr, len);
      tab[k] = SlotTap{2 * k, 2 * k + 1, t.w_lo, t.w_hi};
      cell[2 * k] = t.lo;
      cell[2 * k + 1] = t.hi;
    }
    total = 2 * n;
  }
  if (lane == 0) *count = total;
}

// a tile: bin rows [p0, p1) x bin columns [q0, q1), which read the slots
// [ra, ra + rows) x [ca, ca + cols)
struct FwdTile {
  int p0, p1, q0, q1, ra, rows, ca, cols;
};

// the tiles of a roi in order; every thread of the block computes the same
// ones from the tap tables
struct TileWalk {
  const SlotTap* xt;
  const SlotTap* yt;
  int res, sr, cap;

  __device__ int xa(int q) const { return xt[q * sr].lo; }
  __device__ int xb(int q) const { return xt[q * sr + sr - 1].hi; }
  __device__ int ya(int p) const { return yt[p * sr].lo; }
  __device__ int yb(int p) const { return yt[p * sr + sr - 1].hi; }

  __device__ FwdTile band(int p0, int q0, int q1) const {
    const int cols = xb(q1 - 1) - xa(q0) + 1;
    int p1 = p0 + 1;
    while (p1 < res && (yb(p1) - ya(p0) + 1) * cols <= cap) ++p1;
    return FwdTile{p0, p1, q0, q1, ya(p0), yb(p1 - 1) - ya(p0) + 1, xa(q0), cols};
  }
  __device__ FwdTile chunk(int q0) const {  // columns no wider than cap / (2 sr) slots
    int q1 = q0 + 1;
    while (q1 < res && (xb(q1) - xa(q0) + 1) * 2 * sr <= cap) ++q1;
    return band(0, q0, q1);
  }
  __device__ FwdTile first(int nrows, int ncols) const {
    return nrows * ncols <= cap ? FwdTile{0, res, 0, res, 0, nrows, 0, ncols} : chunk(0);
  }
  __device__ bool next(const FwdTile& t, FwdTile* n) const {
    if (t.p1 < res) {
      *n = band(t.p1, t.q0, t.q1);
      return true;
    }
    if (t.q1 < res) {
      *n = chunk(t.q1);
      return true;
    }
    return false;
  }
};

template <typename T, int V, int L, int SR>  // SR 0: sr at run time
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(LevelTable lv,
                     const float* __restrict__ rois,      // (R, 5)
                     const int32_t* __restrict__ levels,  // (R,) absolute FPN level
                     const bool* __restrict__ valid,      // (R,)
                     T* __restrict__ out,                 // (R, res, res, C)
                     int batch, int c, int res, int sr_arg, int cap, int group) {
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  const int sr = SR ? SR : sr_arg;
  const int n = res * sr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SlotTap* xt = reinterpret_cast<SlotTap*>(smem_raw);  // n
  SlotTap* yt = xt + n;                                 // n
  int* xcell = reinterpret_cast<int*>(yt + n);          // 2n: the map column of each x slot
  int* ycell = xcell + 2 * n;                           // 2n: the map row of each y slot
  int* count = ycell + 2 * n;                           // x slots, y slots
  Raw* stage = reinterpret_cast<Raw*>(smem_raw + fwd_tables_bytes(n));

  const int r = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % L;  // the same in every pass: nthreads is a multiple of L
  // the block's slices: [s0, s1), lane's first channel of each at s * L * V + lane * V
  const int s0 = blockIdx.y * group;
  const int s1 = min(s0 + group, ((c + V - 1) / V + L - 1) / L);
  T* const oroi = out + (size_t)r * res * res * c + lane * V;

  // the roi's record in one round trip
  const float* roi = rois + (size_t)r * 5;
  const float bx = roi[0], rx1 = roi[1], ry1 = roi[2], rx2 = roi[3], ry2 = roi[4];
  const int level = levels[r];
  if (!valid[r]) {
    float zero[V];
#pragma unroll
    for (int k = 0; k < V; ++k) zero[k] = 0.0f;
    for (int s = s0; s < s1 && s * (L * V) + lane * V < c; ++s) {
      for (int bin = tid / L; bin < res * res; bin += nthreads / L) {
        P::store(oroi + (size_t)bin * c + s * (L * V), zero);
      }
    }
    return;
  }

  const int li = min(max(level - lv.lvl_min, 0), lv.n_levels - 1);
  const int h = lv.h[li], w = lv.w[li];
  const float scale = 1.0f / (float)(1 << (li + lv.lvl_min));
  const int b = min(max((int)bx, 0), batch - 1);
  const float x1 = rx1 * scale, y1 = ry1 * scale;
  const float x2 = rx2 * scale, y2 = ry2 * scale;
  if (tid < 32) {
    build_axis(x1, fmaxf(x2 - x1, 1.0f) / (float)res, res, sr, w, xt, xcell, count, tid);
  } else if (tid < 64) {
    build_axis(y1, fmaxf(y2 - y1, 1.0f) / (float)res, res, sr, h, yt, ycell, count + 1, tid - 32);
  }
  __syncthreads();

  const T* const fmap = static_cast<const T*>(lv.feat[li]) + (size_t)b * h * w * c + lane * V;
  const TileWalk walk{xt, yt, res, sr, cap};
  // tile t of slice s into the buffer, a 16-byte lane of a cell a copy
  auto copy_tile = [&](const FwdTile& t, int s) {
    if (s * (L * V) + lane * V >= c) return;
    const T* src = fmap + s * (L * V);
    const float inv = 1.0f / (float)t.cols;
    for (int e = tid / L; e < t.rows * t.cols; e += nthreads / L) {
      const int rr = div_small(e, inv);
      const int cc = e - rr * t.cols;
      P::stage(stage + e * L + lane, src + ((size_t)ycell[t.ra + rr] * w + xcell[t.ca + cc]) * c);
    }
  };
  // the bins of tile t of slice s
  auto sum_tile = [&](const FwdTile& t, int s) {
    if (s * (L * V) + lane * V >= c) return;
    T* o = oroi + s * (L * V);
    const Raw* buf = stage + lane;
    const int nq = t.q1 - t.q0;
    const float inv = 1.0f / (float)nq;
    for (int bin = tid / L; bin < (t.p1 - t.p0) * nq; bin += nthreads / L) {
      const int pp = div_small(bin, inv);
      const int p = t.p0 + pp, q = t.q0 + bin - pp * nq;
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < sr; ++i) {  // unrolled where sr is the compile-time 2
        const SlotTap ty = yt[p * sr + i];
        const Raw* rlo = buf + ((ty.lo - t.ra) * t.cols - t.ca) * L;
        const Raw* rhi = buf + ((ty.hi - t.ra) * t.cols - t.ca) * L;
#pragma unroll
        for (int j = 0; j < sr; ++j) {
          const SlotTap tx = xt[q * sr + j];
          const Raw* src[4] = {rlo + tx.lo * L, rlo + tx.hi * L, rhi + tx.lo * L,
                               rhi + tx.hi * L};
          const float wt[4] = {ty.w_lo * tx.w_lo, ty.w_lo * tx.w_hi,
                               ty.w_hi * tx.w_lo, ty.w_hi * tx.w_hi};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float v[V];
            P::unpack(*src[u], v);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = acc[k] + v[k] * wt[u];
          }
        }
      }
      P::store(o + ((size_t)p * res + q) * c, acc);
    }
  };

  // each slice's tiles in turn
  for (int s = s0; s < s1; ++s) {
    FwdTile t = walk.first(count[1], count[0]);
    while (true) {
      copy_tile(t, s);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      sum_tile(t, s);
      FwdTile nt;
      const bool more = walk.next(t, &nt);
      __syncthreads();  // every thread is done with the buffer before it is refilled
      if (!more) break;
      t = nt;
    }
  }
}

// shared memory of a forward block: the tap tables, then a buffer of cap
// cells of L * V values
template <typename T, int V, int L>
size_t fwd_smem(int res, int sr, int cap) {
  return (size_t)fwd_tables_bytes(res * sr) + (size_t)cap * L * V * sizeof(T);
}

// opts a forward instance into kMaxSmem of dynamic shared memory, once a
// device (the attribute belongs to the device's copy of the kernel)
template <typename T, int V, int L, int SR>
cudaError_t fwd_opt_in() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(roi_align_fwd_kernel<T, V, L, SR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int V, int L>
int launch(const LevelTable& lv, const float* rois, const int32_t* levels, const bool* valid,
           void* out, int n_rois, int batch, int c, int res, int sr, cudaStream_t stream) {
  const int cell_bytes = L * V * (int)sizeof(T);
  const int fit = kStageBytes / cell_bytes;
  const int cap = fit > 4 * sr * sr ? fit : 4 * sr * sr;  // a bin row of a chunk always fits
  const size_t smem = fwd_smem<T, V, L>(res, sr, cap);
  const int slices = ((c + V - 1) / V + L - 1) / L;
  if (smem > kMaxSmem || cap >= (1 << 22) || res * res >= (1 << 22)) {
    return (int)cudaErrorInvalidValue;
  }
  // a block takes `group` slices of its roi (one roi load and one table build
  // for all of them), as many as leave kMinBlocks blocks or more
  int group = slices;
  while (group > 1 && (long long)n_rois * ((slices + group - 1) / group) < kMinBlocks) {
    group = (group + 1) / 2;
  }
  const int groups = (slices + group - 1) / group;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  // the fewest threads (a multiple of 32, at least the two warps of the tap
  // tables) that take a slice's res * res * L items in as few passes as
  // kThreads do
  const int items = res * res * L;
  const int passes = (items + kThreads - 1) / kThreads;
  const int per_pass = ((items + passes - 1) / passes + 31) / 32 * 32;
  const int threads = per_pass > 64 ? per_pass : 64;
  auto kernel = sr == 2 ? &roi_align_fwd_kernel<T, V, L, 2> : &roi_align_fwd_kernel<T, V, L, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = sr == 2 ? fwd_opt_in<T, V, L, 2>() : fwd_opt_in<T, V, L, 0>();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n_rois, (unsigned)groups);
  kernel<<<grid, threads, smem, stream>>>(lv, rois, levels, valid, static_cast<T*>(out), batch, c,
                                          res, sr, cap, group);
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// Backward: the gradient of the forward with respect to the per-level maps,
// with exactly the forward's taps (make_tap above: the position, the [-1, n]
// rule, the clamp, the weights already divided by sr). No gradient goes to
// the rois; an invalid roi adds nothing; level and batch index are clamped.
//
// Replaces the TPU kernel _mlra_bwd_kernel of sad_tpu/ops/pallas_roi_align.py
// (launched by _windowed_backward). That kernel walks the rois one after
// another and reads, updates and writes back 32x32 windows of the gradient
// with tent-weight matrix products, which is right only because a TPU grid
// runs in order on one core. Read for what they compute, those products say
// that a roi's weights factor into a y part and an x part (the Tap tables
// hold them per axis), so its gradient over its footprint is
//   dF[y, x, :] = sum_p Ay[p, y] * sum_q Ax[q, x] * G[p, q, :]
// with Ay (res x h) and Ax (res x w) the summed tap weights of bin row p and
// bin column q on each cell.
//
// Here the owner computes: every cell of every map is written by one block,
// once, in the cotangent's type, and there are no atomics on the maps, no
// float32 staging maps, no memset of them and no cast.
//   1. count (a warp a roi): the map tiles of 8 x 8 cells of its (level,
//      image) that its taps touch; one integer atomic a (roi, tile).
//   2. scan (one block): exclusive offsets of the per-tile counts.
//   3. fill (a warp a roi): the per-tile roi lists.
//   4. gather, grid (tile, channel slice of 32 lanes x V channels): the block
//      sorts its list by roi index (lists of up to kSortCap rois, so the sum
//      order is fixed and two runs give the same bits), then takes the rois
//      kRoiBatch at a time: its threads build each roi's Ay and Ax restricted
//      to the tile's 8 rows and 8 columns in shared memory, and warp x (tile
//      column x) accumulates, lane by lane over V channels,
//      t = sum_q Ax[q, x] G[r, p, q, c] for each bin row p that weighs on the
//      tile, a batch of loads in flight, and then
//      acc[y] += Ay[p, y] * t for the 8 rows, in float32 registers. It writes
//      its 8 x 8 cells once, zeros where no roi reached them.
// The rest of the forward's layout holds: the cotangent is (R, res, res, C)
// with C contiguous, so a warp's loads of one bin are one contiguous run of
// 32 * V channels, and so are its stores of one cell.
//
// What bounds it: latency. The byte bound counts the dense gradient maps
// written once (366 MB in bf16 at the training step's four levels) and the
// cotangent read once; with no roi valid the launch takes what a memset of
// the maps takes, so the rest is the tiles that rois reach: each is a chain
// of dependent loads (its offsets, its list, the rois' corners, then the
// cotangent, one round trip a roi) with four blocks of 256 threads an SM.
// What a later version could do: copy the cotangent of the next batch of
// rois into shared memory (cp.async or TMA) while the block sums the
// current one; carry each roi's corners in the lists; make coarse levels'
// tiles larger, so that a roi reaches fewer of them.

template <> struct Pack<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
  }
};

constexpr int kBwdTile = 8;         // map tiles of 8 x 8 cells of one (level, image)
constexpr int kBwdThreads = 256;    // 8 warps: warp x owns column x of the tile
constexpr int kBinThreads = 256;    // count and fill: a warp a roi
constexpr int kRoiBatch = 8;        // rois whose tables a gather block builds at once
constexpr int kMaxBwdRes = 32;
constexpr int kSortCap = 1024;      // longer lists are summed in the order they were filled
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;

struct BwdTable {
  void* grad[kMaxLevels];  // (B, h, w, C) in the cotangent's type, every cell written once
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_y[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tile_base[kMaxLevels];  // the level's first tile; image-major, then row-major
  int n_levels;
  int lvl_min;
};

// the roi's level (clamped), image (clamped) and the tiles its taps touch,
// reduced over the warp: every lane gets the same answer
struct Footprint {
  int li, b, ty0, ty1, tx0, tx1;
};

__device__ __forceinline__ Footprint roi_footprint(const BwdTable& t, const float* rois,
                                                   const int32_t* levels, int r, int batch,
                                                   int res, int sr, int lane) {
  Footprint f;
  f.li = min(max(levels[r] - t.lvl_min, 0), t.n_levels - 1);
  const int h = t.h[f.li], w = t.w[f.li];
  const float scale = 1.0f / (float)(1 << (f.li + t.lvl_min));
  const float* roi = rois + (size_t)r * 5;
  f.b = min(max((int)roi[0], 0), batch - 1);
  const float x1 = roi[1] * scale, y1 = roi[2] * scale;
  const float x2 = roi[3] * scale, y2 = roi[4] * scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / (float)res;
  const float bin_h = fmaxf(y2 - y1, 1.0f) / (float)res;
  int ylo = INT32_MAX, yhi = -1, xlo = INT32_MAX, xhi = -1;
  for (int e = lane; e < res * sr; e += 32) {
    const Tap ty = make_tap(y1, bin_h, e / sr, e % sr, sr, h);
    const Tap tx = make_tap(x1, bin_w, e / sr, e % sr, sr, w);
    ylo = min(ylo, ty.lo); yhi = max(yhi, ty.hi);
    xlo = min(xlo, tx.lo); xhi = max(xhi, tx.hi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
    xlo = min(xlo, __shfl_xor_sync(0xffffffffu, xlo, off));
    xhi = max(xhi, __shfl_xor_sync(0xffffffffu, xhi, off));
  }
  f.ty0 = ylo / kBwdTile; f.ty1 = yhi / kBwdTile;
  f.tx0 = xlo / kBwdTile; f.tx1 = xhi / kBwdTile;
  return f;
}

__device__ __forceinline__ int tile_of(const BwdTable& t, const Footprint& f, int e) {
  const int ntx = f.tx1 - f.tx0 + 1;
  const int ty = f.ty0 + e / ntx, tx = f.tx0 + e % ntx;
  return t.tile_base[f.li] + (f.b * t.tiles_y[f.li] + ty) * t.tiles_x[f.li] + tx;
}

// 1. and 3.: with ``list`` null, count each valid roi's tiles; else write the
// roi into the list of each of its tiles at ``cursor``
__global__ void __launch_bounds__(kBinThreads)
roi_bwd_bin_kernel(BwdTable t, const float* __restrict__ rois,
                   const int32_t* __restrict__ levels, const bool* __restrict__ valid,
                   int32_t* __restrict__ cursor, int32_t* __restrict__ list, int n_rois,
                   int batch, int res, int sr) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kBinThreads / 32) + (threadIdx.x >> 5);
  if (r >= n_rois || !valid[r]) return;  // the same for the whole warp
  const Footprint f = roi_footprint(t, rois, levels, r, batch, res, sr, lane);
  const int n = (f.ty1 - f.ty0 + 1) * (f.tx1 - f.tx0 + 1);
  for (int e = lane; e < n; e += 32) {
    const int slot = atomicAdd(cursor + tile_of(t, f, e), 1);
    if (list) list[slot] = r;
  }
}

// 2. offsets[i] = counts[0] + ... + counts[i - 1] for i <= n_tiles, and the
// fill's cursors start at the offsets
__global__ void __launch_bounds__(kScanThreads)
roi_bwd_scan_kernel(const int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
                    int32_t* __restrict__ cursor, int n_tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;  // the same in every thread
  for (int base = 0; base < n_tiles; base += kScanThreads * kScanItems) {
    const int start = base + tid * kScanItems;
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = start + k < n_tiles ? counts[start + k] : 0;
      sum += v[k];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, ws, off);
        if (lane >= off) ws += o;
      }
      warp_sums[lane] = ws;
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (start + k < n_tiles) {
        offsets[start + k] = run;
        cursor[start + k] = run;
      }
      run += v[k];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is read before the next chunk writes it
  }
  if (tid == 0) offsets[n_tiles] = carry;
}

// 4. gather: one block per (tile, channel slice)
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, 4)
roi_align_bwd_gather_kernel(BwdTable t, const float* __restrict__ rois,
                            const int32_t* __restrict__ levels,
                            const T* __restrict__ gout,           // (R, res, res, C)
                            const int32_t* __restrict__ offsets,  // (n_tiles + 1,)
                            const int32_t* __restrict__ list, int c, int res, int sr) {
  __shared__ float tab[2][kRoiBatch][kMaxBwdRes][kBwdTile];  // [y, x][roi][bin][cell]
  __shared__ int s_raw[kSortCap];
  __shared__ int s_sorted[kSortCap];

  const int tile = blockIdx.x;
  int li = t.n_levels - 1;
  while (li > 0 && tile < t.tile_base[li]) --li;
  const int per_img = t.tiles_y[li] * t.tiles_x[li];
  const int local = tile - t.tile_base[li];
  const int b = local / per_img;
  const int ty = (local - b * per_img) / t.tiles_x[li];
  const int tx = local - b * per_img - ty * t.tiles_x[li];
  const int h = t.h[li], w = t.w[li];
  const int y0 = ty * kBwdTile, x0 = tx * kBwdTile;
  const float scale = 1.0f / (float)(1 << (li + t.lvl_min));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = (blockIdx.y * 32 + lane) * V;  // this lane's first channel
  const bool lane_on = c0 < c;
  const int x = x0 + warp;  // this warp's column of the map

  float acc[kBwdTile][V];
#pragma unroll
  for (int y = 0; y < kBwdTile; ++y) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[y][k] = 0.0f;
  }

  const int beg = offsets[tile];
  const int n = offsets[tile + 1] - beg;
  const int32_t* rl = list + beg;
  if (n > 1 && n <= kSortCap) {
    // rank sort by roi index: a roi is on a list once, so ranks are distinct
    for (int i = tid; i < n; i += kBwdThreads) s_raw[i] = rl[i];
    __syncthreads();
    for (int i = tid; i < n; i += kBwdThreads) {
      const int me = s_raw[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += s_raw[j] < me;
      s_sorted[rank] = me;
    }
    __syncthreads();
    rl = s_sorted;
  }

  for (int k0 = 0; k0 < n; k0 += kRoiBatch) {
    const int nb = min(kRoiBatch, n - k0);
    // each roi's Ay and Ax restricted to the tile's rows and columns
    for (int e = tid; e < nb * 2 * res; e += kBwdThreads) {
      const int k = e / (2 * res);
      const int axis = (e - k * 2 * res) / res;  // 0: y, 1: x
      const int p = e - k * 2 * res - axis * res;
      const float* roi = rois + (size_t)rl[k0 + k] * 5;
      const float start = roi[2 - axis] * scale, end = roi[4 - axis] * scale;
      const float bin = fmaxf(end - start, 1.0f) / (float)res;
      const int len = axis ? w : h, origin = axis ? x0 : y0;
      float wt[kBwdTile];
#pragma unroll
      for (int u = 0; u < kBwdTile; ++u) wt[u] = 0.0f;
      for (int i = 0; i < sr; ++i) {
        const Tap tp = make_tap(start, bin, p, i, sr, len);
        const int dl = tp.lo - origin, dh = tp.hi - origin;
#pragma unroll
        for (int u = 0; u < kBwdTile; ++u) {
          wt[u] = wt[u] + ((dl == u ? tp.w_lo : 0.0f) + (dh == u ? tp.w_hi : 0.0f));
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdTile; ++u) tab[axis][k][p][u] = wt[u];
    }
    __syncthreads();
    if (x < w) {  // the same for the whole warp
      for (int k = 0; k < nb; ++k) {
        // the bin columns that weigh on this warp's column and the bin rows
        // that weigh on any row of the tile, one lane a bin; both runs are
        // contiguous, since the taps move monotonically with the bin
        bool row_on = false;
        if (lane < res) {
#pragma unroll
          for (int y = 0; y < kBwdTile; ++y) row_on = row_on || tab[0][k][lane][y] != 0.0f;
        }
        const unsigned qm = __ballot_sync(0xffffffffu, lane < res && tab[1][k][lane][warp] != 0.0f);
        const unsigned pm = __ballot_sync(0xffffffffu, row_on);
        if (!qm || !pm) continue;  // the same for the whole warp
        const int qa = __ffs(qm) - 1, qb = 31 - __clz(qm);
        const int pa = __ffs(pm) - 1, items = (32 - __clz(pm) - pa) * (qb - qa + 1);
        const T* g = gout + (size_t)rl[k0 + k] * res * res * c + c0;
        // the (p, q) bins row by row, a batch of loads in flight, then their
        // sums: s = sum_q Ax[q, x] G[p, q] over the row, acc += Ay[p] s at its end
        constexpr int kLoadBatch = sizeof(T) == 2 ? 8 : 4;  // loads a lane keeps in flight
        float s[V];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = 0.0f;
        int lp = pa, lq = qa;  // the next bin to load
        int ap = pa, aq = qa;  // the next bin to add
        for (int e0 = 0; e0 < items; e0 += kLoadBatch) {
          float gv[kLoadBatch][V];
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            if (e0 + u < items && lane_on) {
              Pack<T, V>::load(g + (size_t)(lp * res + lq) * c, gv[u]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) gv[u][v] = 0.0f;
            }
            if (++lq > qb) { lq = qa; ++lp; }
          }
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            if (e0 + u < items) {
              const float ax = tab[1][k][aq][warp];
#pragma unroll
              for (int v = 0; v < V; ++v) s[v] = s[v] + ax * gv[u][v];
              if (++aq > qb) {  // the row is summed
#pragma unroll
                for (int y = 0; y < kBwdTile; ++y) {
                  const float ay = tab[0][k][ap][y];
#pragma unroll
                  for (int v = 0; v < V; ++v) acc[y][v] = acc[y][v] + ay * s[v];
                }
#pragma unroll
                for (int v = 0; v < V; ++v) s[v] = 0.0f;
                aq = qa;
                ++ap;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the tables are read before the next batch rebuilds them
  }

  if (x < w && lane_on) {
    T* out = static_cast<T*>(t.grad[li]) + ((size_t)b * h * w + x) * c + c0;
#pragma unroll
    for (int y = 0; y < kBwdTile; ++y) {
      if (y0 + y < h) Pack<T, V>::store(out + (size_t)(y0 + y) * w * c, acc[y]);
    }
  }
}

template <typename T, int V>
void launch_bwd_gather(const BwdTable& t, const float* rois, const int32_t* levels,
                       const void* gout, const int32_t* offsets, const int32_t* list,
                       int n_tiles, int c, int res, int sr, cudaStream_t stream) {
  const dim3 grid((unsigned)n_tiles, (unsigned)((c + 32 * V - 1) / (32 * V)));
  roi_align_bwd_gather_kernel<T, V><<<grid, kBwdThreads, 0, stream>>>(
      t, rois, levels, static_cast<const T*>(gout), offsets, list, c, res, sr);
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
      (long long)res * sr > kMaxTaps) {
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
  int err;
  if (dtype == 0) {
    if (vec && c % 4 == 0 && c / 4 >= 8) {
      err = launch<float, 4, 8>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr,
                                stream);
    } else {
      err = launch<float, 1, 1>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr,
                                stream);
    }
  } else {
    if (vec && c % 8 == 0 && c / 8 >= 8) {
      err = launch<__nv_bfloat16, 8, 8>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr,
                                        stream);
    } else {
      err = launch<__nv_bfloat16, 1, 1>(lv, rois, levels, valid, out, n_rois, batch, c, res, sr,
                                        stream);
    }
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

// The backward. ``grads`` are the per-level gradient maps in the cotangent's
// type (dtype: 0 = float32, 1 = bfloat16), written whole by the launch.
// ``scratch`` holds ``scratch_ints`` int32: the per-tile counts, offsets
// (n_tiles + 1) and cursors, then the roi lists, which need room for
// n_rois * (the most tiles an image has on one level). vec: 1 when C is a
// multiple of 4 and ``gout`` and every map are 16-byte aligned.
extern "C" int sad_roi_align_bwd_launch(void* const* grads, const int* hs, const int* ws,
                                        int n_levels, int lvl_min, const float* rois,
                                        const int32_t* levels, const bool* valid,
                                        const void* gout, int32_t* scratch,
                                        long long scratch_ints, int n_rois, int batch, int c,
                                        int res, int sr, int dtype, int vec,
                                        cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || lvl_min < 0 || lvl_min + n_levels > 31 ||
      n_rois < 0 || batch < 1 || c < 1 || res < 1 || res > kMaxBwdRes || sr < 1 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdTable t;
  long long n_tiles = 0, most = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    const bool on = i < n_levels;
    t.grad[i] = on ? grads[i] : nullptr;
    t.h[i] = on ? hs[i] : 0;
    t.w[i] = on ? ws[i] : 0;
    t.tiles_y[i] = on ? (hs[i] + kBwdTile - 1) / kBwdTile : 0;
    t.tiles_x[i] = on ? (ws[i] + kBwdTile - 1) / kBwdTile : 0;
    t.tile_base[i] = (int)n_tiles;
    if (on) {
      if (hs[i] < 1 || ws[i] < 1) return (int)cudaErrorInvalidValue;
      const long long per_img = (long long)t.tiles_y[i] * t.tiles_x[i];
      n_tiles += per_img * batch;
      most = per_img > most ? per_img : most;
    }
  }
  t.n_levels = n_levels;
  t.lvl_min = lvl_min;
  if (n_tiles >= 2147483647LL || 3 * n_tiles + 1 + (long long)n_rois * most > scratch_ints ||
      3 * n_tiles + 1 + (long long)n_rois * most >= 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  int32_t* counts = scratch;
  int32_t* offsets = counts + n_tiles;
  int32_t* cursor = offsets + n_tiles + 1;
  int32_t* list = cursor + n_tiles;
  const cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n_tiles * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned bin_blocks = (unsigned)((n_rois + kBinThreads / 32 - 1) / (kBinThreads / 32));
  if (n_rois > 0) {
    roi_bwd_bin_kernel<<<bin_blocks, kBinThreads, 0, stream>>>(
        t, rois, levels, valid, counts, nullptr, n_rois, batch, res, sr);
  }
  roi_bwd_scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, offsets, cursor, (int)n_tiles);
  if (n_rois > 0) {
    roi_bwd_bin_kernel<<<bin_blocks, kBinThreads, 0, stream>>>(
        t, rois, levels, valid, cursor, list, n_rois, batch, res, sr);
  }
  const int nt = (int)n_tiles;
  if (dtype == 0) {
    if (vec && c % 4 == 0) {
      launch_bwd_gather<float, 4>(t, rois, levels, gout, offsets, list, nt, c, res, sr, stream);
    } else {
      launch_bwd_gather<float, 1>(t, rois, levels, gout, offsets, list, nt, c, res, sr, stream);
    }
  } else {
    if (vec && c % 4 == 0) {
      launch_bwd_gather<__nv_bfloat16, 4>(t, rois, levels, gout, offsets, list, nt, c, res, sr,
                                          stream);
    } else {
      launch_bwd_gather<__nv_bfloat16, 1>(t, rois, levels, gout, offsets, list, nt, c, res, sr,
                                          stream);
    }
  }
  return (int)cudaGetLastError();
}
