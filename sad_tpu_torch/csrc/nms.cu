// Greedy NMS over N independent problems: sort, IoU bitmask, short sweep.
//
// Replaces the two TPU kernels of sad_tpu/ops/pallas_nms.py:
//   _nms_kernel          (launched by nms_fixed_pallas, the N = 1 case)
//   _nms_kernel_batched  (launched by nms_batched_pallas, 8 problems per
//                         program in the TPU's sublanes)
// The TPU kernels run max_out steps of "argmax over all K, suppress over all
// K". Nothing of their layout is carried over: no sublane packing, no MAX_K
// fallbacks, no (8, 128) padding.
//
// Semantics, bit for bit those of the Pallas kernels (pallas_nms.py:45-93):
// each of max_out steps picks the first index among the highest live
// scores, emits (idx, valid = score > -1e30), and suppresses every live
// candidate whose IoU with the pick exceeds thr, together with the pick.
// An invalid pick emits idx 0 and valid false, and so does every later slot.
// IoU uses the legacy +1 extents in exactly the kernel's order, the pick as
// the first operand:
//   areas = (x2 - x1 + 1) * (y2 - y1 + 1)
//   iw = max(min(px2, x2) - max(px1, x1) + 1, 0), ih likewise
//   inter = iw * ih;  iou = inter / (parea + areas - inter)
// Build with --fmad=false: a contracted FMA in `parea + areas - inter` or in
// the areas would flip decisions at the threshold. Never --use_fast_math.
//
// The greedy argmax sequence is a sweep in sorted order, so the work is three
// stages, kernels launched one after another on the caller's stream:
//   1. order (one block per problem): compact the valid candidates
//      (score > -1e30), sort them by a 64-bit key, the order-preserving bits
//      of the score descending and then the index ascending (-0.0 keyed as
//      +0.0, which the argmax treats as equal), with a bitonic sort in shared
//      memory; write the sorted indices, the sorted boxes and the count V.
//   2. mask (tiles of 64 x 64 over the upper triangle of the V x V sorted
//      order, spread over the whole grid): bit j of row i, j > i, is set iff
//      the IoU with sorted box i as the pick exceeds thr. Tiles past V exit.
//      The IoU test takes a 2-ulp quotient and falls back to the IEEE
//      division only within 1e-5 of thr, so its answer is the division's.
//   3. sweep (one block per problem): per word of 64 candidates, one thread
//      resolves the 64 against the removed bits and the tile's own mask
//      words; the block emits the kept ones and ORs their rows into the
//      removed bits of the later words. It stops at max_out keeps or at V
//      and fills the rest with (0, false).
// Stages 2 and 3 go in chunks of row tiles (kChunkEnds: the first 128 sorted
// candidates, then up to 1024, then the rest); the sweep keeps its state in
// global scratch between chunks, and a problem it has finished is skipped by
// every later chunk, so a decode that keeps its max_out = 100 among the first
// few hundred candidates builds only those rows of the mask.
// A problem with more than kOrderCap valid candidates does not fit the order
// stage's shared memory: the order stage writes its V all the same, the mask
// and sweep stages skip it, and the last kernel, the argmax loop (one block
// of 1024 threads a problem, max_out dependent steps of a block-wide argmax
// and a suppression pass over all K), takes it; it returns at once for every
// other problem. No host sync decides between them.
//
// What bounds it: latency, not bytes or operations. The order stage is one
// block a problem (8 or 40 of 132 SMs): the compaction reads K scores, the
// sort makes log2(P) (log2(P) + 1) / 2 passes over P = V rounded up to a power
// of two, with a block barrier only where a pass crosses warps. The sweep's
// chain is one bit test a candidate and, a word of 64, one barrier-separated
// round of OR-ed rows. The mask is O(V^2) IoUs spread over the whole card;
// where max_out is K (the RPN) it is built whole. Its scratch is
// N * min(K, kOrderCap)^2 / 8 bytes (64 MB at 8 x 80,000 candidates).
// What a later version could do: sort in registers and warp shuffles, so
// that the passes stop going through shared memory; split a problem's sort
// over a cluster of blocks; take the over-cap problems with a cluster too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr int kOrderCap = 8192;      // valid candidates a problem the order stage sorts
constexpr int kTile = 64;            // mask tile: 64 rows x 64 columns, one word a row
constexpr int kSweepThreads = 512;
// the mask and the sweep go in chunks of row tiles, so that a problem whose
// max_out keeps lie early in its sorted list needs no more of the mask
constexpr int kChunkEnds[] = {2, 16, kOrderCap / kTile};

// (score, index) order of the pick: higher score, then lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// iou > thr with the pick (px1..py2, parea) as the first operand, decided by
// a 2-ulp quotient unless it lies within 1e-5 of thr, and only then by the
// IEEE division: the division's answer for a third of the work
__device__ __forceinline__ bool suppresses(float px1, float py1, float px2, float py2,
                                           float parea, float4 b, float thr) {
  const float area = (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
  const float iw = fmaxf(fminf(px2, b.z) - fmaxf(px1, b.x) + 1.0f, 0.0f);
  const float ih = fmaxf(fminf(py2, b.w) - fmaxf(py1, b.y) + 1.0f, 0.0f);
  const float inter = iw * ih;
  const float den = parea + area - inter;
  if (den >= 1.0f && den <= 1e30f) {
    const float q = __fdividef(inter, den);
    if (fabsf(q - thr) > 1e-5f * fmaxf(fabsf(q), fabsf(thr))) return q > thr;
  }
  return inter / den > thr;
}

// ascending 64-bit key: score descending, then index ascending
__device__ __forceinline__ uint64_t sort_key(float s, int j) {
  uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);  // -0.0 == +0.0 for the argmax
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
  return ((uint64_t)(~u) << 32) | (uint32_t)j;
}

// 1. order: compact, sort, gather the boxes
__global__ void __launch_bounds__(kThreads)
nms_order_kernel(const float* __restrict__ boxes,   // (N, K, 4)
                 const float* __restrict__ scores,  // (N, K)
                 int32_t* __restrict__ sorted_idx,  // (N, cap)
                 float4* __restrict__ sorted_box,   // (N, cap)
                 int32_t* __restrict__ count,       // (N,) valid candidates
                 int k, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_raw);  // next power of two >= cap
  __shared__ int s_n;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s_n = 0;
  __syncthreads();
  const float* sc = scores + (size_t)n * k;
  constexpr int kLoads = 4;  // score loads a thread keeps in flight
  for (int base = 0; base < k; base += kLoads * kThreads) {
    float s[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + u * kThreads + tid;
      s[u] = j < k ? sc[j] : kNeg;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + u * kThreads + tid;
      const bool ok = s[u] > kNeg;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      int slot = 0;
      if (lane == 0 && m) slot = atomicAdd(&s_n, __popc(m));
      slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(m & ((1u << lane) - 1u));
      if (ok && slot < cap) keys[slot] = sort_key(s[u], j);
    }
  }
  __syncthreads();
  const int v = s_n;
  if (tid == 0) count[n] = v;
  if (v > cap || v == 0) return;  // too many for the sort: the argmax loop takes it
  int p = 1;
  while (p < v) p <<= 1;
  for (int j = v + tid; j < p; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (p >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      // with stride <= 32 a warp's pairs stay in its own runs of 64 keys, the
      // same runs at every such stride: only the warp need wait for them
      if (stride > 32 || stride == 1) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)n * k;
  for (int i = tid; i < v; i += kThreads) {
    const int j = (int)(uint32_t)keys[i];
    sorted_idx[(size_t)n * cap + i] = j;
    sorted_box[(size_t)n * cap + i] = bx[j];
  }
}

// 2. mask: grid (N, blocks a problem); each block walks the tiles of row
// tiles [rt_lo, rt_hi) x column tiles [row tile, ceil(V / 64)) of its problem.
// A problem that an earlier sweep finished (done) or that the sort could not
// hold is skipped.
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ sorted_box,  // (N, cap)
                const int32_t* __restrict__ count,      // (N,)
                const int32_t* __restrict__ done,       // (N,) or null for the first rows
                uint64_t* __restrict__ mask,            // (N, cap, words)
                int cap, int words, int rt_lo, int rt_hi, float thr) {
  __shared__ float4 cols[kTile];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int v = count[n];
  if (v > cap || v == 0 || (done && done[n])) return;
  const int vt = (v + kTile - 1) / kTile;
  const int r_hi = min(rt_hi, vt);
  if (rt_lo >= r_hi) return;
  const float4* sb = sorted_box + (size_t)n * cap;
  for (int e = blockIdx.y; e < (r_hi - rt_lo) * vt; e += gridDim.y) {
    const int rt = rt_lo + e / vt, ct = e % vt;
    if (ct < rt) continue;  // the same for the whole block
    __syncthreads();        // the previous tile is done with `cols`
    const int c0 = ct * kTile;
    if (c0 + tid < v) cols[tid] = sb[c0 + tid];
    __syncthreads();
    const int i = rt * kTile + tid;
    if (i >= v) continue;
    const float4 pb = sb[i];
    const float parea = (pb.z - pb.x + 1.0f) * (pb.w - pb.y + 1.0f);
    const int jmax = min(kTile, v - c0);
    uint64_t bits = 0;
    for (int jj = (rt == ct) ? tid + 1 : 0; jj < jmax; ++jj) {
      if (suppresses(pb.x, pb.y, pb.z, pb.w, parea, cols[jj], thr)) bits |= 1ull << jj;
    }
    mask[((size_t)n * cap + i) * words + ct] = bits;
  }
}

// 3. sweep: one block a problem over the words [w_lo, w_hi) of its sorted
// list, resuming from the removed bits and keep count that the launch before
// left in `removed_g` and `kept_g`. It marks the problem done, and fills the
// remaining slots, at max_out keeps or at the end of the list.
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const int32_t* __restrict__ sorted_idx,  // (N, cap)
                 const uint64_t* __restrict__ mask,       // (N, cap, words)
                 const int32_t* __restrict__ count,       // (N,)
                 uint64_t* __restrict__ removed_g,        // (N, kOrderCap / 64)
                 int32_t* __restrict__ kept_g,            // (N,)
                 int32_t* __restrict__ done,              // (N,)
                 int32_t* __restrict__ out_idx,           // (N, max_out)
                 bool* __restrict__ out_valid,            // (N, max_out)
                 int cap, int words, int max_out, int w_lo, int w_hi) {
  __shared__ uint64_t removed[kOrderCap / kTile];
  __shared__ uint64_t diag[kTile];
  __shared__ int pos[kTile];
  __shared__ uint64_t s_kept;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int v = count[n];
  if (v > cap) return;  // the argmax loop writes this problem
  if (w_lo > 0 && done[n]) return;
  const int nw = (v + kTile - 1) / kTile;
  const uint64_t* mk = mask + (size_t)n * cap * words;
  uint64_t* rg = removed_g + (size_t)n * (kOrderCap / kTile);
  for (int w = w_lo + tid; w < nw; w += kSweepThreads) removed[w] = w_lo ? rg[w] : 0ull;
  int nk = w_lo ? kept_g[n] : 0;  // keeps so far, the same in every thread
  int32_t* oi = out_idx + (size_t)n * max_out;
  bool* ov = out_valid + (size_t)n * max_out;
  const int w_end = min(w_hi, nw);
  int w = w_lo;
  for (; w < w_end && nk < max_out; ++w) {
    const int i0 = w * kTile;
    const int lim = min(kTile, v - i0);
    if (tid < kTile) diag[tid] = tid < lim ? mk[(size_t)(i0 + tid) * words + w] : 0ull;
    __syncthreads();  // diag and removed[w] are in place
    if (tid == 0) {
      // the 64 candidates of the word in order: a candidate not yet removed
      // is kept and removes what its row of the tile marks
      uint64_t rw = removed[w] | (lim < kTile ? ~0ull << lim : 0ull), kept = 0;
#pragma unroll 16
      for (int b = 0; b < kTile; ++b) {
        const uint64_t bit = 1ull << b;
        const bool keep = !(rw & bit);
        kept |= keep ? bit : 0ull;
        rw |= keep ? diag[b] : 0ull;
      }
      for (int extra = __popcll(kept) - (max_out - nk); extra > 0; --extra) {
        kept &= ~(1ull << (63 - __clzll((long long)kept)));  // past max_out: not emitted
      }
      s_kept = kept;
    }
    __syncthreads();
    const uint64_t kept = s_kept;
    if (tid < kTile && ((kept >> tid) & 1ull)) {
      const int rank = __popcll(kept & ((1ull << tid) - 1ull));
      pos[rank] = tid;
      oi[nk + rank] = sorted_idx[(size_t)n * cap + i0 + tid];
      ov[nk + rank] = true;
    }
    nk += __popcll(kept);
    __syncthreads();  // pos is in place
    if (nk < max_out) {
      // OR the kept rows into the later words: (kept row, word) pairs over
      // the block, four loads in flight a thread
      const int nrem = nw - w - 1, items = __popcll(kept) * nrem;
      for (int e0 = tid; e0 < items; e0 += 4 * kSweepThreads) {
        uint64_t got[4];
        int at[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kSweepThreads;
          at[u] = e < items ? w + 1 + e % nrem : -1;
          got[u] = e < items ? mk[(size_t)(i0 + pos[e / nrem]) * words + at[u]] : 0ull;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (got[u]) atomicOr(reinterpret_cast<unsigned long long*>(&removed[at[u]]), got[u]);
        }
      }
    }
    __syncthreads();  // removed is updated; diag and pos may be overwritten
  }
  const bool finished = nk >= max_out || w >= nw;
  if (finished) {
    for (int s = nk + tid; s < max_out; s += kSweepThreads) {
      oi[s] = 0;
      ov[s] = false;
    }
  } else {
    for (int ww = w + tid; ww < nw; ww += kSweepThreads) rg[ww] = removed[ww];
  }
  if (tid == 0) {
    kept_g[n] = nk;
    done[n] = finished;
  }
}

// 4. the argmax loop, for the problems the order stage could not hold
__global__ void __launch_bounds__(kThreads)
nms_argmax_kernel(const float* __restrict__ boxes,   // (N, K, 4) x1, y1, x2, y2
                  const float* __restrict__ scores,  // (N, K), invalid <= -1e30
                  const int32_t* __restrict__ count, // (N,) from the order stage
                  float* __restrict__ live,          // (N, K) scratch
                  int32_t* __restrict__ out_idx,     // (N, max_out)
                  bool* __restrict__ out_valid,      // (N, max_out)
                  int k, int cap, int max_out, float thr) {
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float pick_box[4];
  __shared__ int pick_idx;
  __shared__ int pick_valid;

  const int n = blockIdx.x;
  if (count[n] <= cap) return;  // sorted and swept
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)n * k;
  float* lv = live + (size_t)n * k;
  int32_t* oi = out_idx + (size_t)n * max_out;
  bool* ov = out_valid + (size_t)n * max_out;

  for (int j = tid; j < k; j += kThreads) lv[j] = scores[(size_t)n * k + j];

  for (int step = 0; step < max_out; ++step) {
    // 1. this thread's best (score, lowest index)
    float bs = -INFINITY;
    int bi = INT32_MAX;
    for (int j = tid; j < k; j += kThreads) {
      const float s = lv[j];
      if (s > bs) { bs = s; bi = j; }  // j rises, so ties keep the first
    }
    // 2. warp, then block reduction
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi_, bs, bi)) { bs = os; bi = oi_; }
    }
    if (lane == 0) { red_s[warp] = bs; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(os, oi_, bs, bi)) { bs = os; bi = oi_; }
      }
      // 3. emit, 4. broadcast the picked box
      if (lane == 0) {
        const int valid = bs > kNeg;
        pick_valid = valid;
        pick_idx = bi;
        oi[step] = valid ? bi : 0;
        ov[step] = valid;
        if (valid) {
          const float4 p = bx[bi];
          pick_box[0] = p.x; pick_box[1] = p.y; pick_box[2] = p.z; pick_box[3] = p.w;
        }
      }
    }
    __syncthreads();
    if (!pick_valid) {
      // nothing live is left: the remaining steps are all invalid
      for (int s = step + 1 + tid; s < max_out; s += kThreads) {
        oi[s] = 0;
        ov[s] = false;
      }
      return;
    }
    // 5. suppress this thread's candidates against the pick
    const int pi = pick_idx;
    const float px1 = pick_box[0], py1 = pick_box[1];
    const float px2 = pick_box[2], py2 = pick_box[3];
    const float parea = (px2 - px1 + 1.0f) * (py2 - py1 + 1.0f);
    for (int j = tid; j < k; j += kThreads) {
      if (suppresses(px1, py1, px2, py2, parea, bx[j], thr) || j == pi) lv[j] = kNeg;
    }
    // No barrier here: the next scan reads only this thread's own
    // candidates, and pick_* is rewritten only after the next step's first
    // __syncthreads, which every thread reaches after reading it.
  }
}

}  // namespace

// ``cap`` = min(K, kOrderCap) sizes the scratch, all allocated by the caller:
// sorted_idx (N, cap) int32, sorted_box (N, cap) float4, mask (N, cap,
// ceil(cap / 64)) uint64, removed (N, kOrderCap / 64) uint64, state (3, N)
// int32 (count, keeps, done) and live (N, K) float32.
extern "C" int sad_nms_launch(const float* boxes, const float* scores, float* live,
                              int32_t* sorted_idx, void* sorted_box, void* mask, void* removed,
                              int32_t* state, int32_t* out_idx, bool* out_valid, int n, int k,
                              int cap, int max_out, float thr, cudaStream_t stream) {
  if (n < 0 || k < 0 || max_out < 0 || cap != (k < kOrderCap ? k : kOrderCap)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || max_out == 0) return (int)cudaSuccess;
  int32_t* count = state;
  int32_t* kept = state + n;
  int32_t* done = state + 2 * n;
  const int words = (cap + kTile - 1) / kTile;
  int p = 1;
  while (p < cap) p <<= 1;
  const size_t smem = (size_t)p * sizeof(uint64_t);
  if (smem > 48 * 1024) {  // above 48 KB only once the function allows it
    const cudaError_t e = cudaFuncSetAttribute(
        nms_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_order_kernel<<<n, kThreads, smem, stream>>>(boxes, scores, sorted_idx,
                                                  static_cast<float4*>(sorted_box), count, k, cap);
  int rt_lo = 0;
  for (const int rt_hi : kChunkEnds) {
    if (rt_lo >= words) break;
    // about 16 blocks of 64 threads an SM over all problems, at most one a tile
    const int tiles = (min(rt_hi, words) - rt_lo) * words;
    const int gy = max(1, min(min((132 * 16 + n - 1) / n, tiles), 65535));
    nms_mask_kernel<<<dim3(n, gy), kTile, 0, stream>>>(
        static_cast<const float4*>(sorted_box), count, rt_lo ? done : nullptr,
        static_cast<uint64_t*>(mask), cap, words, rt_lo, rt_hi, thr);
    nms_sweep_kernel<<<n, kSweepThreads, 0, stream>>>(
        sorted_idx, static_cast<const uint64_t*>(mask), count, static_cast<uint64_t*>(removed),
        kept, done, out_idx, out_valid, cap, words, max_out, rt_lo, rt_hi);
    rt_lo = rt_hi;
  }
  if (words == 0) {  // no candidates at all: the sweep writes (0, false) everywhere
    nms_sweep_kernel<<<n, kSweepThreads, 0, stream>>>(
        sorted_idx, static_cast<const uint64_t*>(mask), count, static_cast<uint64_t*>(removed),
        kept, done, out_idx, out_valid, cap, words, max_out, 0, 0);
  }
  nms_argmax_kernel<<<n, kThreads, 0, stream>>>(boxes, scores, count, live, out_idx, out_valid, k,
                                                cap, max_out, thr);
  return (int)cudaGetLastError();
}
