// Native host kernels of sad_tpu_torch: box IoU, the fused anchor->gt
// assignment pass, greedy NMS and soft-NMS.
//
// A copy of sad_tpu/native/host_kernels.cpp. They replace the reference's
// Cython extensions (the host-side hot loops):
//   - detectron/lib/utils/cython_bbox.pyx  (bbox_overlaps)
//   - detectron/lib/utils/cython_nms.pyx   (nms, soft_nms)
// Label assignment (data/anchors.py, data/rpn_minibatch.py) runs in the loader
// processes through them, in float32 as the reference's cython_bbox does. The
// card runs its own kernels (sad_tpu_torch/csrc); these serve the host.
//
// Built as a plain C ABI shared library by g++ with -ffp-contract=off (no
// fused multiply-adds, so native/plain.py's numpy float32 twin gives the
// same bits); loaded via ctypes -- see sad_tpu_torch/native/__init__.py.
// All boxes use the legacy "+1" pixel-extent convention.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// IoU matrix: boxes (n,4) x query (k,4) -> out (n,k), row-major float32.
void sad_bbox_overlaps(const float* boxes, int64_t n, const float* query,
                       int64_t k, float* out) {
  for (int64_t j = 0; j < k; ++j) {
    const float qx1 = query[j * 4 + 0], qy1 = query[j * 4 + 1];
    const float qx2 = query[j * 4 + 2], qy2 = query[j * 4 + 3];
    const float q_area = (qx2 - qx1 + 1.f) * (qy2 - qy1 + 1.f);
    for (int64_t i = 0; i < n; ++i) {
      const float bx1 = boxes[i * 4 + 0], by1 = boxes[i * 4 + 1];
      const float bx2 = boxes[i * 4 + 2], by2 = boxes[i * 4 + 3];
      const float iw = std::min(bx2, qx2) - std::max(bx1, qx1) + 1.f;
      float v = 0.f;
      if (iw > 0.f) {
        const float ih = std::min(by2, qy2) - std::max(by1, qy1) + 1.f;
        if (ih > 0.f) {
          const float b_area = (bx2 - bx1 + 1.f) * (by2 - by1 + 1.f);
          const float inter = iw * ih;
          v = inter / (b_area + q_area - inter);
        }
      }
      out[i * k + j] = v;
    }
  }
}

// Greedy NMS over score-sorted candidates. dets = (n,5) [x1,y1,x2,y2,score].
// keep_out must hold n int64; returns number kept.
int64_t sad_nms(const float* dets, int64_t n, float thresh, int64_t* keep_out) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<uint8_t> suppressed(n, 0);
  int64_t n_keep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float ix1 = dets[i * 5], iy1 = dets[i * 5 + 1];
    const float ix2 = dets[i * 5 + 2], iy2 = dets[i * 5 + 3];
    const float iarea = (ix2 - ix1 + 1.f) * (iy2 - iy1 + 1.f);
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float xx1 = std::max(ix1, dets[j * 5]);
      const float yy1 = std::max(iy1, dets[j * 5 + 1]);
      const float xx2 = std::min(ix2, dets[j * 5 + 2]);
      const float yy2 = std::min(iy2, dets[j * 5 + 3]);
      const float w = std::max(0.f, xx2 - xx1 + 1.f);
      const float h = std::max(0.f, yy2 - yy1 + 1.f);
      const float inter = w * h;
      const float jarea = (dets[j * 5 + 2] - dets[j * 5] + 1.f) *
                          (dets[j * 5 + 3] - dets[j * 5 + 1] + 1.f);
      if (inter / (iarea + jarea - inter) > thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// Fused anchor->gt assignment pass (the loader-thread hot loop that the
// reference ran through cython_bbox.bbox_overlaps + several numpy reduction
// passes, roi_data/retinanet.py:198-250). One kernel computes, per anchor:
//   a2g_max[i]    = max_j IoU(anchor i, gt j)
//   a2g_argmax[i] = argmax_j (first max, numpy argmax tie convention)
//   tie[i]        = 1 iff IoU(i, j) == max_i' IoU(i', j) for ANY j
//                   (the "every anchor tied at a gt's best overlap" rule)
// without materializing the (n, k) matrix for the numpy passes.
void sad_assign_overlaps(const float* anchors, int64_t n, const float* gt,
                         int64_t k, float* a2g_max, int32_t* a2g_argmax,
                         uint8_t* tie) {
  std::vector<float> g_area(k), g2a_max(k, 0.f);
  for (int64_t j = 0; j < k; ++j) {
    g_area[j] = (gt[j * 4 + 2] - gt[j * 4] + 1.f) *
                (gt[j * 4 + 3] - gt[j * 4 + 1] + 1.f);
  }
  std::vector<float> row(k);
  // pass 1: per-anchor max/argmax and per-gt column max
  for (int64_t i = 0; i < n; ++i) {
    const float bx1 = anchors[i * 4 + 0], by1 = anchors[i * 4 + 1];
    const float bx2 = anchors[i * 4 + 2], by2 = anchors[i * 4 + 3];
    const float b_area = (bx2 - bx1 + 1.f) * (by2 - by1 + 1.f);
    float best = -1.f;
    int32_t best_j = 0;
    for (int64_t j = 0; j < k; ++j) {
      const float iw = std::min(bx2, gt[j * 4 + 2]) -
                       std::max(bx1, gt[j * 4 + 0]) + 1.f;
      float v = 0.f;
      if (iw > 0.f) {
        const float ih = std::min(by2, gt[j * 4 + 3]) -
                         std::max(by1, gt[j * 4 + 1]) + 1.f;
        if (ih > 0.f) {
          const float inter = iw * ih;
          v = inter / (b_area + g_area[j] - inter);
        }
      }
      if (v > best) { best = v; best_j = (int32_t)j; }
      if (v > g2a_max[j]) g2a_max[j] = v;
    }
    a2g_max[i] = best;
    a2g_argmax[i] = best_j;
  }
  // pass 2: tie mask (recompute IoU rows; k is small)
  for (int64_t i = 0; i < n; ++i) {
    const float bx1 = anchors[i * 4 + 0], by1 = anchors[i * 4 + 1];
    const float bx2 = anchors[i * 4 + 2], by2 = anchors[i * 4 + 3];
    const float b_area = (bx2 - bx1 + 1.f) * (by2 - by1 + 1.f);
    uint8_t t = 0;
    for (int64_t j = 0; j < k; ++j) {
      const float iw = std::min(bx2, gt[j * 4 + 2]) -
                       std::max(bx1, gt[j * 4 + 0]) + 1.f;
      float v = 0.f;
      if (iw > 0.f) {
        const float ih = std::min(by2, gt[j * 4 + 3]) -
                         std::max(by1, gt[j * 4 + 1]) + 1.f;
        if (ih > 0.f) {
          const float inter = iw * ih;
          v = inter / (b_area + g_area[j] - inter);
        }
      }
      if (v == g2a_max[j]) { t = 1; break; }
    }
    tie[i] = t;
  }
}

// Soft-NMS (Bodla et al.), methods: 0=hard, 1=linear, 2=gaussian.
// dets (n,5) is rescored in place; keep_out gets surviving indices in pick
// order; returns count.
int64_t sad_soft_nms(float* dets, int64_t n, float sigma, float overlap_thresh,
                     float score_thresh, int32_t method, int64_t* keep_out) {
  std::vector<uint8_t> used(n, 0);
  int64_t n_keep = 0;
  for (;;) {
    int64_t best = -1;
    float best_score = score_thresh;
    for (int64_t i = 0; i < n; ++i) {
      if (!used[i] && dets[i * 5 + 4] > best_score) {
        best_score = dets[i * 5 + 4];
        best = i;
      }
    }
    if (best < 0) break;
    used[best] = 1;
    keep_out[n_keep++] = best;
    const float ix1 = dets[best * 5], iy1 = dets[best * 5 + 1];
    const float ix2 = dets[best * 5 + 2], iy2 = dets[best * 5 + 3];
    const float iarea = (ix2 - ix1 + 1.f) * (iy2 - iy1 + 1.f);
    for (int64_t j = 0; j < n; ++j) {
      if (used[j]) continue;
      const float xx1 = std::max(ix1, dets[j * 5]);
      const float yy1 = std::max(iy1, dets[j * 5 + 1]);
      const float xx2 = std::min(ix2, dets[j * 5 + 2]);
      const float yy2 = std::min(iy2, dets[j * 5 + 3]);
      const float w = std::max(0.f, xx2 - xx1 + 1.f);
      const float h = std::max(0.f, yy2 - yy1 + 1.f);
      const float inter = w * h;
      const float jarea = (dets[j * 5 + 2] - dets[j * 5] + 1.f) *
                          (dets[j * 5 + 3] - dets[j * 5 + 1] + 1.f);
      const float ov = inter / (iarea + jarea - inter);
      float weight = 1.f;
      if (method == 1) {  // linear
        if (ov > overlap_thresh) weight = 1.f - ov;
      } else if (method == 2) {  // gaussian
        weight = std::exp(-(ov * ov) / sigma);
      } else {  // hard
        if (ov > overlap_thresh) weight = 0.f;
      }
      dets[j * 5 + 4] *= weight;
    }
  }
  return n_keep;
}

}  // extern "C"
