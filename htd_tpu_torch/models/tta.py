"""Test-time augmentation (MultiScaleFlipAug) merging.

Counterpart of `htd_tpu/models/tta.py` (mmdet test_time_aug.py and
merge_augs.py, htd_roi_head.aug_test): per-aug proposals mapped back to
the original frame and merged by NMS; per-aug cascade results mapped back
and averaged; then the test config's multiclass NMS (linear soft-NMS for
the R-101 and DCN presets).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from htd_tpu_torch.config import ProposalConfig, RCNNTestConfig
from htd_tpu_torch.ops.boxes import bbox_mapping, bbox_mapping_back
from htd_tpu_torch.ops.nms import NEG_INF, multiclass_nms, nms


def map_back(boxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """Aug frame -> original frame (bbox_mapping_back)."""
    return bbox_mapping_back(boxes, img_shape, scale_factor, flip)


def map_into(boxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """Original frame -> aug frame (bbox_mapping)."""
    return bbox_mapping(boxes, img_shape, scale_factor, flip)


def merge_aug_proposals(aug_boxes: Sequence[torch.Tensor], aug_scores: Sequence[torch.Tensor],
                        aug_valid: Sequence[torch.Tensor], cfg: ProposalConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per aug (P, 4) boxes in the original frame, (P,) scores and
    validity -> NMS over all of them, `cfg.max_num` slots: boxes (zero where
    invalid), scores (zero where invalid), validity."""
    boxes = torch.cat(list(aug_boxes), dim=0)
    scores = torch.cat(list(aug_scores), dim=0).to(torch.float32)
    valid = torch.cat(list(aug_valid), dim=0)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    keep_idx, keep_score, keep_valid = nms(boxes, scores, cfg.nms_thr, cfg.max_num)
    out_boxes = torch.where(keep_valid[:, None], boxes[keep_idx], 0.0)
    return out_boxes, torch.where(keep_valid, keep_score, 0.0), keep_valid


def merge_aug_bboxes(aug_boxes: Sequence[torch.Tensor], aug_scores: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean over augs of decoded (P, 4) boxes (original frame) and of
    (P, C+1) softmax scores."""
    return torch.stack(list(aug_boxes)).mean(0), torch.stack(list(aug_scores)).mean(0)


def final_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              cfg: RCNNTestConfig):
    """The test config's multiclass NMS over the merged rois (invalid rows
    scored zero): (boxes, scores, labels, valid), `max_per_img` slots."""
    scores = torch.where(valid[:, None], scores, 0.0)
    return multiclass_nms(boxes, scores, cfg.score_thr, cfg.nms_iou, cfg.max_per_img,
                          use_soft_nms=cfg.use_soft_nms, soft_min_score=cfg.soft_min_score)
