// Greedy NMS over N independent problems, one thread block per problem.
//
// Replaces the two TPU kernels of sad_tpu/ops/pallas_nms.py:
//   _nms_kernel          (launched by nms_fixed_pallas, the N = 1 case)
//   _nms_kernel_batched  (launched by nms_batched_pallas, 8 problems per
//                         program in the TPU's sublanes)
// Here the problems are blocks of the grid, so there is no packing and no
// ceiling on K: the TPU's MAX_K fallbacks and its (8, 128) padding are not
// carried over.
//
// Semantics, bit for bit those of the Pallas kernels (pallas_nms.py:45-93):
// each of max_out steps picks the first index among the highest live
// scores, emits (idx, valid = score > -1e30), and suppresses every live
// candidate whose IoU with the pick exceeds thr, together with the pick.
// An invalid pick changes nothing, and its idx is written as 0; once a pick
// is invalid every later one is too, so the block fills the rest and stops.
// IoU uses the legacy +1 extents in exactly the kernel's order:
//   areas = (x2 - x1 + 1) * (y2 - y1 + 1)
//   iw = max(min(px2, x2) - max(px1, x1) + 1, 0), ih likewise
//   inter = iw * ih;  iou = inter / (parea + areas - inter)
// Build with --fmad=false: a contracted FMA in `parea + areas - inter` or in
// the areas would flip decisions at the threshold. Never --use_fast_math.
//
// What bounds it: latency, not bytes or flops. Each step is one block-wide
// argmax reduction (warp shuffles, then shared memory) followed by one pass
// of IoU arithmetic, and the max_out = 100 steps depend on each other. At
// the decode shape (N = 8 images, K = 5000 candidates) only 8 of the 132 SMs
// have work. Each thread owns the candidates j = tid, tid + blockDim, ...,
// both in the argmax scan and in suppression, so the live scores need no
// synchronisation beyond the reduction; boxes (80 KB a problem) stay in
// L1/L2 across steps.
//
// What a later version could do: split one problem over a thread-block
// cluster (distributed shared memory for the reduction) to use more SMs;
// keep boxes and live scores in shared memory or registers when K fits;
// sort candidates once and suppress with a bitmask, as the IoU-matrix NMS
// kernels do, trading O(K^2) IoUs for a short serial tail.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

// (score, index) order of the pick: higher score, then lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes,   // (N, K, 4) x1, y1, x2, y2
           const float* __restrict__ scores,  // (N, K), invalid <= -1e30
           float* __restrict__ live,          // (N, K) scratch
           int32_t* __restrict__ out_idx,     // (N, max_out)
           bool* __restrict__ out_valid,      // (N, max_out)
           int k, int max_out, float thr) {
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float pick_box[4];
  __shared__ int pick_idx;
  __shared__ int pick_valid;

  const int n = blockIdx.x;
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
      const float4 b = bx[j];
      const float area = (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
      const float iw = fmaxf(fminf(px2, b.z) - fmaxf(px1, b.x) + 1.0f, 0.0f);
      const float ih = fmaxf(fminf(py2, b.w) - fmaxf(py1, b.y) + 1.0f, 0.0f);
      const float inter = iw * ih;
      const float iou = inter / (parea + area - inter);
      if (iou > thr || j == pi) lv[j] = kNeg;
    }
    // No barrier here: the next scan reads only this thread's own
    // candidates, and pick_* is rewritten only after the next step's first
    // __syncthreads, which every thread reaches after reading it.
  }
}

}  // namespace

extern "C" int sad_nms_launch(const float* boxes, const float* scores, float* live,
                              int32_t* out_idx, bool* out_valid, int n, int k,
                              int max_out, float thr, cudaStream_t stream) {
  if (n > 0 && max_out > 0) {
    nms_kernel<<<n, kThreads, 0, stream>>>(boxes, scores, live, out_idx, out_valid,
                                           k, max_out, thr);
  }
  return (int)cudaGetLastError();
}
