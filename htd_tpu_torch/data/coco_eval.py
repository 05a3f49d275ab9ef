"""COCO-protocol detection evaluation (numpy, no pycocotools dependency).

The port's copy of `htd_tpu/data/coco_eval.py` (mmdet CocoDataset.evaluate
-> pycocotools COCOeval): greedy score-ordered matching per (image,
class), crowd regions matched as IoF and treated as ignore, 101-point
interpolated precision averaged over IoU 0.50:0.95, area ranges
(all/small/medium/large), maxDets=100. The matcher is the JAX package's
numpy one; its optional C++ speed-up (`htd_tpu/native/coco_match.cpp`) is
not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; IoF (intersection over det area) for crowd gts."""
    d_area = (dts[:, 2] - dts[:, 0]) * (dts[:, 3] - dts[:, 1])
    g_area = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    lt = np.maximum(dts[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dts[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = d_area[:, None] + g_area[None, :] - inter
    union = np.where(iscrowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclass
class _ImgCatEval:
    dt_scores: np.ndarray   # (D,)
    dt_matched: np.ndarray  # (D,) bool — matched a non-ignore gt
    dt_ignore: np.ndarray   # (D,) bool
    num_gt: int             # non-ignored gts


def _evaluate_img_cat(
    dt_boxes: np.ndarray,
    dt_scores: np.ndarray,
    gt_boxes: np.ndarray,
    gt_crowd: np.ndarray,
    area_rng: Tuple[float, float],
    iou_thrs: np.ndarray,
) -> Optional[List[_ImgCatEval]]:
    """Match one image/category at every IoU threshold."""
    if len(dt_boxes) == 0 and len(gt_boxes) == 0:
        return None

    g_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    gt_ignore = gt_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
    # sort gts ignore-last, dts score-desc (mergesort = stable, like pycocotools)
    g_ord = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[g_ord]
    gt_ig = gt_ignore[g_ord]
    crowd = gt_crowd[g_ord]
    d_ord = np.argsort(-dt_scores, kind="mergesort")
    dt_boxes = dt_boxes[d_ord]
    dt_scores = dt_scores[d_ord]

    ious = (
        _iou_matrix(dt_boxes, gt_boxes, crowd)
        if len(dt_boxes) and len(gt_boxes)
        else np.zeros((len(dt_boxes), len(gt_boxes)))
    )
    d_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1])
    dt_out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])

    out = []
    for thr in iou_thrs:
        gt_m = np.full(len(gt_boxes), -1)
        dt_m = np.full(len(dt_boxes), -1)
        for di in range(len(dt_boxes)):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for gi in range(len(gt_boxes)):
                if gt_m[gi] >= 0 and not crowd[gi]:
                    continue
                # gts are ignore-last: once we have a real match, stop at ignores
                if best_g >= 0 and not gt_ig[best_g] and gt_ig[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                gt_m[best_g] = di
                dt_m[di] = best_g
        matched_ignore = np.array(
            [gt_ig[g] if g >= 0 else False for g in dt_m], bool
        )
        # unmatched dts outside the area range are ignored too
        dt_ignore = matched_ignore | ((dt_m == -1) & dt_out_of_range)
        out.append(
            _ImgCatEval(
                dt_scores=dt_scores,
                dt_matched=(dt_m >= 0) & ~matched_ignore,
                dt_ignore=dt_ignore,
                num_gt=int((~gt_ig).sum()),
            )
        )
    return out


def _accumulate_curve(
    per_img: List[List[_ImgCatEval]], max_dets: int, iou_thrs: np.ndarray
) -> np.ndarray:
    """-> (T, R) precision at REC_THRS for one (cat, area) cell; -1 if no gt
    (pycocotools eval['precision'] fill convention)."""
    t = len(iou_thrs)
    curves = np.full((t, len(REC_THRS)), -1.0)
    if not per_img:
        return curves
    for ti in range(t):
        evals = [e[ti] for e in per_img]
        scores = np.concatenate([e.dt_scores[:max_dets] for e in evals])
        matched = np.concatenate([e.dt_matched[:max_dets] for e in evals])
        ignored = np.concatenate([e.dt_ignore[:max_dets] for e in evals])
        num_gt = sum(e.num_gt for e in evals)
        if num_gt == 0:
            continue
        order = np.argsort(-scores, kind="mergesort")
        matched = matched[order]
        ignored = ignored[order]
        keep = ~ignored
        tp = np.cumsum(matched[keep])
        fp = np.cumsum(~matched[keep])
        recall = tp / num_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        inds = np.searchsorted(recall, REC_THRS, side="left")
        q = np.zeros(len(REC_THRS))
        valid = inds < len(precision)
        q[valid] = precision[inds[valid]]
        curves[ti] = q
    return curves


def _accumulate(per_img: List[List[_ImgCatEval]], max_dets: int) -> np.ndarray:
    """-> (T,) AP per IoU threshold for one (cat, area) cell (the mean of
    its 101-point precision curve); nan if no gt."""
    curves = _accumulate_curve(per_img, max_dets, IOU_THRS)
    return np.where(curves[:, 0] < 0, np.nan, curves.mean(axis=1))


def precision_curves(
    detections: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    groundtruth: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    cats: Sequence[int],
    iou_thrs: Optional[np.ndarray] = None,
    max_dets: int = 100,
) -> np.ndarray:
    """Precision-recall curves per (iou_thr, cat, area).

    Returns (T, R=101, K=len(cats), A=4) with areas ordered
    (all, small, medium, large) — the layout of pycocotools
    eval['precision'][..., m] that tools/coco_error_analysis.py consumes;
    cells with no ground truth hold -1. Same matching core as
    evaluate_coco_map."""
    thrs = IOU_THRS if iou_thrs is None else np.asarray(iou_thrs, np.float64)
    img_ids = sorted(groundtruth.keys())
    out = np.full((len(thrs), len(REC_THRS), len(cats), len(AREA_RANGES)), -1.0)
    for ki, cat in enumerate(cats):
        for ai, (name, rng_) in enumerate(AREA_RANGES.items()):
            per_img: List[List[_ImgCatEval]] = []
            for img in img_ids:
                gb, gl, gc = groundtruth[img]
                sel_g = gl == cat
                db, ds, dl = detections.get(
                    img, (np.zeros((0, 4)), np.zeros(0), np.zeros(0))
                )
                sel_d = dl == cat
                ev = _evaluate_img_cat(
                    db[sel_d], ds[sel_d], gb[sel_g], gc[sel_g].astype(bool),
                    rng_, thrs,
                )
                if ev is not None:
                    per_img.append(ev)
            out[:, :, ki, ai] = _accumulate_curve(per_img, max_dets, thrs)
    return out


def evaluate_coco_map(
    detections: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    groundtruth: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    num_classes: int,
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox mAP.

    Args:
      detections: img_id -> (boxes (D,4) xyxy, scores (D,), labels (D,)).
      groundtruth: img_id -> (boxes (G,4) xyxy, labels (G,), iscrowd (G,) bool).
    Returns dict with mAP, mAP_50, mAP_75, mAP_s/m/l, AR@100.
    """
    img_ids = sorted(groundtruth.keys())
    results: Dict[str, List[np.ndarray]] = {k: [] for k in AREA_RANGES}
    recalls_all = []

    for cat in range(num_classes):
        per_area: Dict[str, List[List[_ImgCatEval]]] = {k: [] for k in AREA_RANGES}
        for img in img_ids:
            gb, gl, gc = groundtruth[img]
            sel_g = gl == cat
            db, ds, dl = detections.get(img, (np.zeros((0, 4)), np.zeros(0), np.zeros(0)))
            sel_d = dl == cat
            for name, rng_ in AREA_RANGES.items():
                ev = _evaluate_img_cat(
                    db[sel_d], ds[sel_d], gb[sel_g], gc[sel_g].astype(bool),
                    rng_, IOU_THRS,
                )
                if ev is not None:
                    per_area[name].append(ev)
        for name in AREA_RANGES:
            results[name].append(_accumulate(per_area[name], max_dets))
        # recall for AR@100 ('all' area): max recall per IoU
        rec_t = []
        for ti in range(len(IOU_THRS)):
            evals = [e[ti] for e in per_area["all"]]
            num_gt = sum(e.num_gt for e in evals)
            if num_gt == 0 or not evals:
                rec_t.append(np.nan)
                continue
            scores = np.concatenate([e.dt_scores[:max_dets] for e in evals])
            matched = np.concatenate([e.dt_matched[:max_dets] for e in evals])
            ignored = np.concatenate([e.dt_ignore[:max_dets] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            m = matched[order][~ignored[order]]
            rec_t.append(m.sum() / num_gt if len(m) else 0.0)
        recalls_all.append(np.asarray(rec_t))

    def mean_ap(aps: List[np.ndarray], thr_idx=None) -> float:
        a = np.stack(aps)  # (C, T)
        if thr_idx is not None:
            a = a[:, thr_idx : thr_idx + 1]
        return float(np.nanmean(a)) if not np.all(np.isnan(a)) else float("nan")

    aps_all = results["all"]
    return {
        "mAP": mean_ap(aps_all),
        "mAP_50": mean_ap(aps_all, 0),
        "mAP_75": mean_ap(aps_all, 5),
        "mAP_s": mean_ap(results["small"]),
        "mAP_m": mean_ap(results["medium"]),
        "mAP_l": mean_ap(results["large"]),
        "AR@100": float(np.nanmean(np.stack(recalls_all)))
        if recalls_all
        else float("nan"),
    }
