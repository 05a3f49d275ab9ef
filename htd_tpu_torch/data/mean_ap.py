"""VOC-style mean AP and proposal recall (numpy).

The port's copy of `htd_tpu/data/mean_ap.py` (mmdet core/evaluation
mean_ap.py `eval_map` with 'area' / '11points' modes and ignore handling;
recall.py `eval_recalls`, proposal recall at IoU thresholds).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from htd_tpu_torch.data.coco_eval import _iou_matrix


def tpfp_default(
    det_boxes: np.ndarray,   # (D, 5) x1y1x2y2score
    gt_boxes: np.ndarray,    # (G, 4)
    gt_ignore: np.ndarray,   # (G,) bool
    iou_thr: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image tp/fp flags over score-desc sorted dets."""
    d = len(det_boxes)
    tp = np.zeros(d)
    fp = np.zeros(d)
    if len(gt_boxes) == 0:
        fp[:] = 1
        return tp, fp
    ious = _iou_matrix(det_boxes[:, :4], gt_boxes, np.zeros(len(gt_boxes), bool))
    order = np.argsort(-det_boxes[:, 4], kind="mergesort")
    matched = np.zeros(len(gt_boxes), bool)
    for di in order:
        gi = int(np.argmax(ious[di]))
        if ious[di, gi] >= iou_thr:
            if gt_ignore[gi]:
                continue  # neither tp nor fp
            if not matched[gi]:
                matched[gi] = True
                tp[di] = 1
            else:
                fp[di] = 1
        else:
            fp[di] = 1
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray, mode="area"):
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    elif mode == "11points":
        ap = 0.0
        for t in np.arange(0, 1.01, 0.1):
            mask = recalls >= t
            p = precisions[mask].max() if mask.any() else 0.0
            ap += p / 11.0
        return float(ap)
    raise ValueError(mode)


def eval_map(
    det_results: Sequence[Sequence[np.ndarray]],  # [img][cls] -> (D, 5)
    annotations: Sequence[Dict[str, np.ndarray]],  # per img: bboxes, labels,
                                                   # optional bboxes_ignore
    iou_thr: float = 0.5,
    mode: str = "area",
) -> Tuple[float, List[Dict]]:
    """Returns (mAP, per-class results)."""
    num_classes = len(det_results[0])
    results = []
    for cls in range(num_classes):
        tps, fps, scores = [], [], []
        num_gts = 0
        for dets, ann in zip(det_results, annotations):
            cls_det = np.asarray(dets[cls], np.float64).reshape(-1, 5)
            sel = ann["labels"] == cls
            gt = ann["bboxes"][sel]
            ig = np.zeros(len(gt), bool)
            if "bboxes_ignore" in ann and len(ann["bboxes_ignore"]):
                gt = np.concatenate([gt, ann["bboxes_ignore"]])
                ig = np.concatenate([ig, np.ones(len(ann["bboxes_ignore"]), bool)])
            tp, fp = tpfp_default(cls_det, gt, ig, iou_thr)
            tps.append(tp)
            fps.append(fp)
            scores.append(cls_det[:, 4])
            num_gts += int((~ig).sum())
        scores = np.concatenate(scores)
        order = np.argsort(-scores, kind="mergesort")
        tp = np.cumsum(np.concatenate(tps)[order])
        fp = np.cumsum(np.concatenate(fps)[order])
        recalls = tp / max(num_gts, 1)
        precisions = tp / np.maximum(tp + fp, 1e-12)
        ap = average_precision(recalls, precisions, mode) if num_gts > 0 else 0.0
        results.append(
            dict(num_gts=num_gts, num_dets=len(scores), ap=ap,
                 recall=recalls[-1] if len(recalls) else 0.0)
        )
    valid = [r["ap"] for r in results if r["num_gts"] > 0]
    return (float(np.mean(valid)) if valid else 0.0), results


def eval_recalls(
    gts: Sequence[np.ndarray],        # per image (G, 4)
    proposals: Sequence[np.ndarray],  # per image (P, 4) or (P, 5)
    proposal_nums: Sequence[int] = (100, 300, 1000),
    iou_thrs: Sequence[float] = (0.5,),
) -> np.ndarray:
    """Proposal recall matrix (len(nums), len(thrs))."""
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(g) for g in gts)
    if total_gt == 0:
        return recalls
    for ni, n in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for gt, props in zip(gts, proposals):
                if len(gt) == 0:
                    continue
                p = np.asarray(props)
                if p.shape[1] == 5:
                    p = p[np.argsort(-p[:, 4], kind="mergesort")][:, :4]
                p = p[:n]
                if len(p) == 0:
                    continue
                ious = _iou_matrix(gt, p, np.zeros(len(p), bool))
                # greedy max-matching as in the reference recall eval
                ious = ious.copy()
                for _ in range(min(len(gt), len(p))):
                    g, d = np.unravel_index(np.argmax(ious), ious.shape)
                    if ious[g, d] < thr:
                        break
                    hit += 1
                    ious[g, :] = -1
                    ious[:, d] = -1
            recalls[ni, ti] = hit / total_gt
    return recalls
