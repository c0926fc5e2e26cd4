// Greedy NMS over N independent problems: sort, then sweep in sorted order.
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
// The greedy argmax sequence is a sweep in sorted order: candidate i of the
// sorted list is kept iff no earlier kept candidate suppresses it. Every
// problem is sorted and swept, by kernels launched one after another on the
// caller's stream; no host sync decides anything. A problem of at most
// kOrderCap valid candidates takes stages 1-3:
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
// stage's shared memory: stage 1 writes its V all the same, stages 2 and 3
// skip it, and stages 4-6 take it. They are launched only where K > kOrderCap,
// and return at once for every problem that stages 1-3 took:
//   4. run sort (a block a run of kRun input slots of a problem): compact the
//      run's valid candidates and sort their keys in shared memory, as stage 1
//      does, into the problem's row of run keys.
//   5. merge (a thread a run key): a key's place in the problem's order is its
//      place in its run plus, in every other run, the count of smaller keys (a
//      binary search). The keys are unique (the index is in them), so the
//      places are a permutation of 0..V-1. It writes the sorted indices and
//      boxes.
//   6. kept-list sweep (a cluster of kCluster = 8 blocks of 1024 threads a
//      problem): tiles of 64 sorted candidates. Kept box m belongs to block
//      m % 8, in its shared memory for the first kSlice = 1024 a block (8192
//      a problem), later ones written back in place to the front of the
//      sorted boxes. Each block tests the tile's candidates against its own
//      kept boxes, 16 threads a candidate, a warp stopping once its 32
//      candidates are all suppressed, and stores the bits it found into its
//      slot of block 0's shared memory. Block 0 builds the tile's own 64 x 64
//      mask meanwhile, and one thread of it resolves the tile's survivors as
//      stage 3 resolves a word; every block reads the keeps back, block 0
//      emits them, and the block each belongs to appends it. Two cluster
//      barriers a tile. It stops at max_out keeps or at V and fills the rest
//      with (0, false).
// No argmax loop is left: a problem of any V up to K is sorted and swept.
//
// What bounds it: latency, not bytes or operations. The order stage is one
// block a problem (8 or 40 of 132 SMs): the compaction reads K scores, the
// sort makes log2(P) (log2(P) + 1) / 2 passes over P = V rounded up to a power
// of two, with a block barrier only where a pass crosses warps. The sweep's
// chain is one bit test a candidate and, a word of 64, one barrier-separated
// round of OR-ed rows. The mask is O(V^2) IoUs spread over the whole card;
// where max_out is K (the RPN) it is built whole. Its scratch is
// N * min(K, kOrderCap)^2 / 8 bytes (64 MB at 8 x 80,000 candidates).
// Past the cap, the runs sort in parallel (8 x 3 blocks at 8 x 12,000), the
// merge is a chain of binary searches through L2, and the kept-list sweep
// does at most V x kept IoUs, an eighth of them in each block of a problem's
// cluster (8 problems fill 64 of 132 SMs), with two block and two cluster
// barriers and a resolve by one thread a tile of 64. Its scratch grows
// linearly in K: 28 N K + 4 N ceil(K / kRun) bytes, no V x V mask.
// What a later version could do: sort in registers and warp shuffles, so
// that the passes stop going through shared memory; split a problem's sort
// over a cluster of blocks; test a tile against the kept list while the
// tile before is resolved, so that a tile's barriers stop waiting on the
// resolve; merge by merge path where the runs are many.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr float kNeg = -1e30f;
constexpr int kOrderCap = 8192;      // valid candidates a problem the order stage sorts
constexpr int kTile = 64;            // mask tile: 64 rows x 64 columns, one word a row
constexpr int kSweepThreads = 512;
// the mask and the sweep go in chunks of row tiles, so that a problem whose
// max_out keeps lie early in its sorted list needs no more of the mask
constexpr int kChunkEnds[] = {2, 16, kOrderCap / kTile};
constexpr int kRun = 4096;           // input slots a run-sort block compacts and sorts (32 KB)
constexpr int kCluster = 8;          // blocks of the kept-list sweep a problem, one cluster
constexpr int kSlice = 1024;         // kept boxes a block of it holds in shared memory
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

// iou > thr with the pick (px1..py2, parea) as the first operand and b's
// area, box_area(b), given; decided by a 2-ulp quotient unless it lies
// within 1e-5 of thr, and only then by the IEEE division: the division's
// answer for a third of the work
__device__ __forceinline__ bool suppresses_area(float px1, float py1, float px2, float py2,
                                                float parea, float4 b, float area, float thr) {
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

// the same, b's area computed here
__device__ __forceinline__ bool suppresses(float px1, float py1, float px2, float py2,
                                           float parea, float4 b, float thr) {
  return suppresses_area(px1, py1, px2, py2, parea, b, box_area(b), thr);
}

// ascending 64-bit key: score descending, then index ascending
__device__ __forceinline__ uint64_t sort_key(float s, int j) {
  uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);  // -0.0 == +0.0 for the argmax
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
  return ((uint64_t)(~u) << 32) | (uint32_t)j;
}

// the valid candidates (score > -1e30) among sc[lo, hi) of one problem, keyed
// with their index, into keys[0, cap) in no order; returns their count, also
// past cap, to every thread of the block (kThreads threads)
__device__ __forceinline__ int compact_keys(const float* __restrict__ sc, int lo, int hi,
                                            uint64_t* keys, int* s_n, int cap) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) *s_n = 0;
  __syncthreads();
  constexpr int kLoads = 4;  // score loads a thread keeps in flight
  for (int base = lo; base < hi; base += kLoads * kThreads) {
    float s[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + u * kThreads + tid;
      s[u] = j < hi ? sc[j] : kNeg;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + u * kThreads + tid;
      const bool ok = s[u] > kNeg;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      int slot = 0;
      if (lane == 0 && m) slot = atomicAdd(s_n, __popc(m));
      slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(m & ((1u << lane) - 1u));
      if (ok && slot < cap) keys[slot] = sort_key(s[u], j);
    }
  }
  __syncthreads();
  return *s_n;
}

// keys[0, p) ascending, p a power of two, by the block's kThreads threads;
// the keys are in place for every thread when it returns
__device__ __forceinline__ void bitonic_sort(uint64_t* keys, int p) {
  const int tid = threadIdx.x;
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
  const int v = compact_keys(scores + (size_t)n * k, 0, k, keys, &s_n, cap);
  if (tid == 0) count[n] = v;
  if (v > cap || v == 0) return;  // too many for this sort: stages 4-6 take it
  int p = 1;
  while (p < v) p <<= 1;
  for (int j = v + tid; j < p; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, p);
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
  if (v > cap) return;  // the kept-list sweep writes this problem
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

// 4. run sort: grid (N, blocks); block (n, r) compacts the valid candidates
// of input slots [r kRun, min(K, (r + 1) kRun)) of an over-cap problem, sorts
// their keys, and writes them to run_keys[n][r kRun, r kRun + c) and their
// count c to run_count[n][r]
__global__ void __launch_bounds__(kThreads)
nms_run_sort_kernel(const float* __restrict__ scores,   // (N, K)
                    const int32_t* __restrict__ count,  // (N,) from the order stage
                    uint64_t* __restrict__ run_keys,    // (N, K)
                    int32_t* __restrict__ run_count,    // (N, runs)
                    int k, int runs, int cap) {
  __shared__ uint64_t keys[kRun];
  __shared__ int s_n;
  const int n = blockIdx.x;
  if (count[n] <= cap) return;  // stages 1-3 took it
  const int tid = threadIdx.x;
  const float* sc = scores + (size_t)n * k;
  for (int r = blockIdx.y; r < runs; r += gridDim.y) {
    const int lo = r * kRun;
    __syncthreads();  // the run before is done with keys and s_n
    const int c = compact_keys(sc, lo, min(k, lo + kRun), keys, &s_n, kRun);
    if (tid == 0) run_count[(size_t)n * runs + r] = c;
    if (c == 0) continue;
    int p = 1;
    while (p < c) p <<= 1;
    for (int j = c + tid; j < p; j += kThreads) keys[j] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, p);
    uint64_t* out = run_keys + (size_t)n * k + lo;
    for (int i = tid; i < c; i += kThreads) out[i] = keys[i];
  }
}

// 5. merge: grid (N, blocks); a thread a run key of an over-cap problem
// writes its index and box at the key's place in the problem's order
__global__ void __launch_bounds__(kMergeThreads)
nms_merge_kernel(const float4* __restrict__ boxes,       // (N, K)
                 const int32_t* __restrict__ count,      // (N,)
                 const uint64_t* __restrict__ run_keys,  // (N, K)
                 const int32_t* __restrict__ run_count,  // (N, runs)
                 int32_t* __restrict__ over_idx,         // (N, K) sorted indices
                 float4* __restrict__ over_box,          // (N, K) sorted boxes
                 int k, int runs, int cap) {
  const int n = blockIdx.x;
  if (count[n] <= cap) return;
  const uint64_t* rk = run_keys + (size_t)n * k;
  const int32_t* rc = run_count + (size_t)n * runs;
  for (int t = blockIdx.y * kMergeThreads + threadIdx.x; t < k;
       t += gridDim.y * kMergeThreads) {
    const int r = t / kRun, i = t - r * kRun;
    if (i >= rc[r]) continue;
    const uint64_t key = rk[t];
    int pos = i;
    for (int q = 0; q < runs; ++q) {
      if (q == r) continue;
      const uint64_t* a = rk + (size_t)q * kRun;
      int lo = 0, hi = rc[q];  // the count of keys of run q below key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      pos += lo;
    }
    const int j = (int)(uint32_t)key;
    over_idx[(size_t)n * k + pos] = j;
    over_box[(size_t)n * k + pos] = boxes[(size_t)n * k + j];
  }
}

// 6. kept-list sweep: a cluster of kCluster blocks a problem over its V
// sorted candidates, a tile of 64 at a time. Kept box m lives in block
// m % kCluster (in shared memory at slot m / kCluster while that is below
// kSlice, else written back in place to over_box[m]), so the blocks split the
// kept-list test; each block stores the bits of the candidates it found
// suppressed into its slot of block 0 (the leader), which builds the tile's
// own mask, resolves the tile and writes the outputs. The blocks exchange
// through plain loads and stores of the leader's shared memory only, ordered
// by the cluster barriers; no atomic crosses a block. In a block,
// thread (warp, lane) tests candidate (warp & 1) * 32 + lane against the
// block's kept boxes warp / 2, warp / 2 + 16, ...; in the leader, thread tid
// builds row tid / 16 of the tile's mask over columns tid % 16, + 16, ...
struct KeptSweepSmem {
  float4 tb[kTile];      // the tile's boxes
  uint64_t diag[kTile];  // the tile's own mask (leader)
  uint64_t sup;          // candidates this block's kept boxes suppress
  uint64_t sups[kCluster];  // every block's sup (leader)
  uint64_t kept;         // the tile's keeps (leader)
  int tix[kTile];        // the tile's indices
  float4 kbox[kSlice];   // this block's kept boxes
  float karea[kSlice];   // and their areas
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms_kept_sweep_kernel(const int32_t* __restrict__ count,     // (N,)
                      const int32_t* __restrict__ over_idx,  // (N, K)
                      float4* __restrict__ over_box,         // (N, K); kept boxes past the
                                                             // blocks' slices go to its front
                      int32_t* __restrict__ out_idx,         // (N, max_out)
                      bool* __restrict__ out_valid,          // (N, max_out)
                      int k, int cap, int max_out, float thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KeptSweepSmem& S = *reinterpret_cast<KeptSweepSmem*>(smem_raw);
  const cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int n = blockIdx.x / kCluster;
  const int v = count[n];
  if (v <= cap) return;  // stages 1-3 took it (the whole cluster returns)
  KeptSweepSmem& L = *cluster.map_shared_rank(&S, 0);  // the leader's
  const bool leader = r == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = (warp & 1) * 32 + lane;  // the candidate this thread tests
  const int g = warp >> 1;               // its share of the block's kept boxes, 1 in 16
  const int ti = tid >> 4, tj = tid & 15;
  float4* ob = over_box + (size_t)n * k;
  const int32_t* ox = over_idx + (size_t)n * k;
  int32_t* oi = out_idx + (size_t)n * max_out;
  bool* ov = out_valid + (size_t)n * max_out;
  float4 nb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the next tile, threads < 64
  int nx = 0;
  if (tid < kTile && tid < v) {
    nb = ob[tid];
    nx = ox[tid];
  }
  if (tid == 0) S.sup = 0ull;
  cluster.sync();  // every block runs before any reads or writes another's memory
  int nk = 0;  // keeps so far, the same in every thread of the cluster
  for (int i0 = 0; i0 < v && nk < max_out; i0 += kTile) {
    const int lim = min(kTile, v - i0);
    if (tid < kTile) {
      S.tb[tid] = nb;
      S.tix[tid] = nx;
      S.diag[tid] = 0ull;
    }
    __syncthreads();  // the tile is in place
    // the next tile's loads go out now: a kept box written back lands at or
    // before its own place, never in the next tile
    if (tid < kTile && i0 + kTile + tid < v) {
      nb = ob[i0 + kTile + tid];
      nx = ox[i0 + kTile + tid];
    }
    const float4 cb = S.tb[c];
    const float carea = box_area(cb);
    bool sup = c >= lim;
    const int own = (nk - r + kCluster - 1) / kCluster;  // kept m < nk with m % kCluster == r
    const int ns = min(own, kSlice);
    for (int j = g; j < ns; j += 16) {
      if (__all_sync(0xffffffffu, sup)) break;
      if (!sup) {
        const float4 p = S.kbox[j];
        sup = suppresses_area(p.x, p.y, p.z, p.w, S.karea[j], cb, carea, thr);
      }
    }
    for (int j = kSlice + g; j < own; j += 16) {
      if (__all_sync(0xffffffffu, sup)) break;
      if (!sup) {
        const float4 p = ob[(size_t)j * kCluster + r];
        sup = suppresses_area(p.x, p.y, p.z, p.w, box_area(p), cb, carea, thr);
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, sup && c < lim);
    if (lane == 0 && m) {
      atomicOr(reinterpret_cast<unsigned long long*>(&S.sup),
               (unsigned long long)m << ((warp & 1) * 32));
    }
    if (leader && ti < lim) {
      const float4 pb = S.tb[ti];
      const float parea = box_area(pb);
      uint64_t bits = 0;
      for (int jj = tj; jj < lim; jj += 16) {
        if (jj > ti && suppresses(pb.x, pb.y, pb.z, pb.w, parea, S.tb[jj], thr)) {
          bits |= 1ull << jj;
        }
      }
      if (bits) atomicOr(reinterpret_cast<unsigned long long*>(&S.diag[ti]), bits);
    }
    __syncthreads();  // this block's sup is complete
    if (tid == 0) {
      L.sups[r] = S.sup;
      S.sup = 0ull;
    }
    cluster.sync();  // every block's sup is in the leader, its diag is complete
    if (leader && tid == 0) {
      // the survivors of the kept list in order: the first one left is kept
      // and removes what its row of the tile marks
      uint64_t sup_all = 0;
      for (int b = 0; b < kCluster; ++b) sup_all |= S.sups[b];
      uint64_t left = ~sup_all & (lim < kTile ? (1ull << lim) - 1ull : ~0ull), kept = 0;
      while (left) {
        const int b = __ffsll((long long)left) - 1;
        kept |= 1ull << b;
        left &= ~(S.diag[b] | (1ull << b));
      }
      for (int extra = __popcll(kept) - (max_out - nk); extra > 0; --extra) {
        kept &= ~(1ull << (63 - __clzll((long long)kept)));  // past max_out: not emitted
      }
      S.kept = kept;
    }
    cluster.sync();  // the leader's kept is in place
    const uint64_t kept = L.kept;
    if (tid < kTile && ((kept >> tid) & 1ull)) {
      const int at = nk + __popcll(kept & ((1ull << tid) - 1ull));
      if (leader) {
        oi[at] = S.tix[tid];
        ov[at] = true;
      }
      if (at % kCluster == r) {
        const float4 b = S.tb[tid];
        const int slot = at / kCluster;
        if (slot < kSlice) {
          S.kbox[slot] = b;
          S.karea[slot] = box_area(b);
        } else {
          ob[at] = b;  // at <= i0 + tid: this tile's boxes are in tb already
        }
      }
    }
    nk += __popcll(kept);
    // no barrier: the next tile's first one orders these writes before any
    // read, and the leader's kept is rewritten only after the next cluster sync
  }
  if (leader) {
    for (int s = nk + tid; s < max_out; s += kThreads) {
      oi[s] = 0;
      ov[s] = false;
    }
  }
  cluster.sync();  // no block leaves while another may still read the leader's memory
}

}  // namespace

// ``cap`` = min(K, kOrderCap) sizes the scratch, all allocated by the caller:
// sorted_idx (N, cap) int32, sorted_box (N, cap) float4, mask (N, cap,
// ceil(cap / 64)) uint64, removed (N, kOrderCap / 64) uint64, state (3, N)
// int32 (count, keeps, done); and, only where K > kOrderCap (null otherwise),
// the over-cap stages' run_keys (N, K) uint64, run_count (N, ceil(K / kRun))
// int32, over_idx (N, K) int32 and over_box (N, K) float4.
extern "C" int sad_nms_launch(const float* boxes, const float* scores, int32_t* sorted_idx,
                              void* sorted_box, void* mask, void* removed, int32_t* state,
                              void* run_keys, int32_t* run_count, int32_t* over_idx,
                              void* over_box, int32_t* out_idx, bool* out_valid, int n, int k,
                              int cap, int max_out, float thr, cudaStream_t stream) {
  if (n < 0 || k < 0 || max_out < 0 || cap != (k < kOrderCap ? k : kOrderCap)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool over = k > kOrderCap;
  if (over && !(run_keys && run_count && over_idx && over_box)) return (int)cudaErrorInvalidValue;
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
  if (over) {
    const int runs = (k + kRun - 1) / kRun;
    nms_run_sort_kernel<<<dim3(n, min(runs, 65535)), kThreads, 0, stream>>>(
        scores, count, static_cast<uint64_t*>(run_keys), run_count, k, runs, cap);
    const int mb = min((k + kMergeThreads - 1) / kMergeThreads, 65535);
    nms_merge_kernel<<<dim3(n, mb), kMergeThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(boxes), count, static_cast<const uint64_t*>(run_keys),
        run_count, over_idx, static_cast<float4*>(over_box), k, runs, cap);
    nms_kept_sweep_kernel<<<n * kCluster, kThreads, sizeof(KeptSweepSmem), stream>>>(
        count, over_idx, static_cast<float4*>(over_box), out_idx, out_valid, k, cap, max_out, thr);
  }
  return (int)cudaGetLastError();
}
