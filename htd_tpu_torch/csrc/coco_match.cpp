// COCO detection matching for one (image, category) on the host: the
// per-(image, category) greedy matching across IoU thresholds that
// pycocotools' C backend does for the reference (COCOeval.evaluateImg),
// which dominates evaluation time when run in Python. The protocol: dets
// sorted by score, descending (stable); gts sorted ignore-last (stable); a
// det takes the unmatched gt of highest IoU at or above the threshold, a
// crowd gt matched by IoF (intersection over the det's area) and re-usable;
// once a det holds a gt that is not ignored, the ignored gts after it are
// not tried; an unmatched det outside the area range is ignored.
//
// The port's copy of the matching core of htd_tpu/native/coco_match.cpp,
// with a plain C interface for ctypes instead of a CPython module.
// `data/coco_eval.py::_evaluate_img_cat_plain` is its numpy twin.

#include <stdint.h>

#include <algorithm>
#include <new>
#include <numeric>
#include <vector>

namespace {

struct Box {
  double x1, y1, x2, y2;
  double area() const { return (x2 - x1) * (y2 - y1); }
};

double iou(const Box& d, const Box& g, bool crowd) {
  const double ix1 = std::max(d.x1, g.x1), iy1 = std::max(d.y1, g.y1);
  const double ix2 = std::min(d.x2, g.x2), iy2 = std::min(d.y2, g.y2);
  const double iw = std::max(0.0, ix2 - ix1), ih = std::max(0.0, iy2 - iy1);
  const double inter = iw * ih;
  const double uni = crowd ? d.area() : d.area() + g.area() - inter;
  if (uni <= 0.0) return 0.0;
  return inter / uni;
}

}  // namespace

// dt_boxes (D, 4) xyxy and dt_scores (D,), gt_boxes (G, 4) and gt_crowd (G,),
// all float64 but gt_crowd (uint8); the area range [area_min, area_max] and
// iou_thrs (T,). Writes dt_matched and dt_ignore (T, D) uint8 in the dets'
// sorted order and that order, dt_order (D,). Returns the count of gts not
// ignored, or -1 if memory runs out.
extern "C" int64_t htd_coco_match(const double* dt_boxes, const double* dt_scores, int64_t D,
                                  const double* gt_boxes, const uint8_t* gt_crowd, int64_t G,
                                  double area_min, double area_max, const double* iou_thrs,
                                  int64_t T, uint8_t* dt_matched, uint8_t* dt_ignore,
                                  int64_t* dt_order) {
  try {
    std::vector<Box> dbox(D), gbox(G);
    for (int64_t i = 0; i < D; ++i)
      dbox[i] = {dt_boxes[i * 4], dt_boxes[i * 4 + 1], dt_boxes[i * 4 + 2], dt_boxes[i * 4 + 3]};
    for (int64_t i = 0; i < G; ++i)
      gbox[i] = {gt_boxes[i * 4], gt_boxes[i * 4 + 1], gt_boxes[i * 4 + 2], gt_boxes[i * 4 + 3]};

    std::vector<uint8_t> gig(G);  // ignored gts
    for (int64_t i = 0; i < G; ++i) {
      const double a = gbox[i].area();
      gig[i] = gt_crowd[i] || a < area_min || a > area_max;
    }
    std::vector<int64_t> gord(G);
    std::iota(gord.begin(), gord.end(), 0);
    std::stable_sort(gord.begin(), gord.end(),
                     [&](int64_t a, int64_t b) { return gig[a] < gig[b]; });
    std::iota(dt_order, dt_order + D, 0);
    std::stable_sort(dt_order, dt_order + D,
                     [&](int64_t a, int64_t b) { return dt_scores[a] > dt_scores[b]; });

    std::vector<double> ious((size_t)D * G);  // (sorted det) x (sorted gt)
    for (int64_t di = 0; di < D; ++di)
      for (int64_t gi = 0; gi < G; ++gi)
        ious[di * G + gi] = iou(dbox[dt_order[di]], gbox[gord[gi]], gt_crowd[gord[gi]] != 0);

    std::fill(dt_matched, dt_matched + T * D, 0);
    std::fill(dt_ignore, dt_ignore + T * D, 0);
    std::vector<int64_t> gmatch(G);
    for (int64_t ti = 0; ti < T; ++ti) {
      const double thr = iou_thrs[ti];
      std::fill(gmatch.begin(), gmatch.end(), -1);
      for (int64_t di = 0; di < D; ++di) {
        double best = std::min(thr, 1.0 - 1e-10);
        int64_t bestg = -1;
        for (int64_t gi = 0; gi < G; ++gi) {
          const int64_t gidx = gord[gi];
          if (gmatch[gi] >= 0 && !gt_crowd[gidx]) continue;
          if (bestg >= 0 && !gig[gord[bestg]] && gig[gidx]) break;
          const double v = ious[di * G + gi];
          if (v < best) continue;
          best = v;
          bestg = gi;
        }
        if (bestg >= 0) {
          gmatch[bestg] = di;
          const bool ig = gig[gord[bestg]] != 0;
          dt_matched[ti * D + di] = ig ? 0 : 1;
          dt_ignore[ti * D + di] = ig ? 1 : 0;
        } else {
          const double a = dbox[dt_order[di]].area();
          if (a < area_min || a > area_max) dt_ignore[ti * D + di] = 1;
        }
      }
    }
    int64_t num_gt = 0;
    for (int64_t i = 0; i < G; ++i) num_gt += !gig[i];
    return num_gt;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}
