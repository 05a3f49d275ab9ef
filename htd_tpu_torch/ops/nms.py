"""Static-capacity NMS on torch tensors.

Counterpart of `htd_tpu/ops/nms.py` (mmcv `nms` / `batched_nms` semantics
and mmdet `multiclass_nms`): greedy hard NMS over score-sorted boxes,
suppressing IoU > thr, ties broken by original index (a stable descending
sort). Outputs have static capacities; absent slots carry score -inf in
`nms` and are flagged by validity masks.

The greedy pass is resolved on the device without a host loop over boxes,
as `nms_blocked` does on the TPU, with the whole input as one tile: with
`sup[j, i]` = "j precedes i and IoU(j, i) > thr", the greedy keep set is
the unique fixpoint of `keep = valid & ~any_j(sup[j, i] & keep[j])` (the
value at i depends only on earlier boxes, so it is fixed once they are).
Iterating from `keep = valid` reaches it in as many steps as the longest
chain of suppressions; convergence is checked every few steps, which is
the only host synchronisation.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = float("-inf")
_STEPS_PER_CHECK = 8


def _sorted_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(N, N) IoU with the JAX package's eps and operation order."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area[:, None] + area[None, :] - inter).clamp(min=1e-6)
    return inter / union


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy NMS over padded inputs.

    boxes (N, 4); scores (N,) with -inf marking absent entries. Returns
    keep_idx (max_out,) int64 (0 where invalid), keep_score (max_out,)
    (-inf where invalid) and keep_valid (max_out,) bool, in keep order.
    """
    n = boxes.shape[0]
    dev = boxes.device
    scores = scores.to(torch.float32)
    order = torch.sort(scores, descending=True, stable=True).indices
    sboxes = boxes[order].to(torch.float32)
    sscores = scores[order]
    valid = sscores > NEG_INF
    pos = torch.arange(n, device=dev)
    sup = (_sorted_iou(sboxes) > iou_threshold) & (pos[:, None] < pos[None, :])
    supf = sup.to(torch.float32)
    keep = valid
    while True:
        prev = keep
        for _ in range(_STEPS_PER_CHECK):
            hit = (keep.to(torch.float32)[None, :] @ supf)[0] > 0
            keep = valid & ~hit
        if torch.equal(keep, prev):
            break

    # kept boxes in sorted order are the greedy output order: place each
    # at its rank among the kept
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < max_out), rank, torch.full_like(rank, max_out))
    keep_idx = torch.zeros(max_out + 1, dtype=torch.int64, device=dev)
    keep_score = torch.full((max_out + 1,), NEG_INF, dtype=torch.float32, device=dev)
    keep_idx.scatter_(0, slot, order)
    keep_score.scatter_(0, slot, sscores)
    keep_idx, keep_score = keep_idx[:max_out], keep_score[:max_out]
    keep_valid = keep_score > NEG_INF
    return torch.where(keep_valid, keep_idx, 0), keep_score, keep_valid


def _offset_by_ids(boxes, scores, ids):
    finite = torch.isfinite(scores)[:, None]
    max_coord = torch.where(finite, boxes, torch.zeros_like(boxes)).max()
    return boxes + ids.to(boxes.dtype)[:, None] * (max_coord + 1.0)


def batched_nms(boxes, scores, ids, iou_threshold: float, max_out: int):
    """Category/level-aware NMS via the coordinate-offset trick: boxes with
    different `ids` never suppress each other. Same contract as `nms`."""
    return nms(_offset_by_ids(boxes, scores, ids), scores, iou_threshold, max_out)


def multiclass_nms(boxes, scores, score_thr: float, iou_threshold: float,
                   max_per_img: int, candidate_cap: int = 2048,
                   use_soft_nms: bool = False, soft_min_score: float = 0.05):
    """Multi-class NMS over class-agnostic boxes (mmdet bbox_nms.py:7-71).

    boxes (N, 4); scores (N, C+1) with the background column last.
    Candidates are the top `candidate_cap` (roi, class) scores above
    `score_thr`, ties by flat index. Returns det_boxes (max_per_img, 4),
    det_scores, det_labels (int32) and det_valid, zero-padded.
    """
    if use_soft_nms:
        raise NotImplementedError(
            "soft-NMS (the R-101 test cfg) is not ported yet; see ROADMAP.md")
    n, c1 = scores.shape
    num_classes = c1 - 1
    flat = scores[:, :num_classes].reshape(-1).to(torch.float32)
    flat = torch.where(flat > score_thr, flat, torch.full_like(flat, NEG_INF))
    cap = min(candidate_cap, n * num_classes)
    top = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = top.values[:cap], top.indices[:cap]
    roi_idx = torch.div(top_idx, num_classes, rounding_mode="floor")
    cls_idx = (top_idx % num_classes).to(torch.int32)
    cand_boxes = boxes[roi_idx]
    keep, keep_score, keep_valid = batched_nms(
        cand_boxes, top_scores, cls_idx, iou_threshold, max_per_img)
    det_boxes = torch.where(keep_valid[:, None], cand_boxes[keep], 0.0)
    det_scores = torch.where(keep_valid, keep_score, 0.0)
    det_labels = torch.where(keep_valid, cls_idx[keep], 0)
    return det_boxes, det_scores, det_labels, keep_valid
