// Multilevel RoIAlign, forward and backward: every roi is pooled from its own
// FPN level, and the backward gathers the cotangent back onto the maps
// through the same taps (the second half of this file).
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
