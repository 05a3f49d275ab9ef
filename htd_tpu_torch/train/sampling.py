"""Max-IoU assignment and fixed-size sampling of rois.

Counterpart of `htd_tpu/train/sampling.py` (mmdet max_iou_assigner.py,
random_sampler.py): every shape is static. Candidates are padded with
validity masks, and the sampled block has a fixed size `num` whose first
`pos_cap` slots hold (up to) the positives, then the negatives; the
stage-1 head relies on that positives-first layout. Randomness comes from
uniform keys drawn from an explicit `torch.Generator`, so the sampled
subsets have the JAX package's distribution but not its draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from htd_tpu_torch.config import AssignerConfig, SamplerConfig
from htd_tpu_torch.ops.boxes import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor     # (N,) int64: -1 ignore / 0 negative / g+1 positive
    max_iou: torch.Tensor     # (N,) float32
    labels: torch.Tensor      # (N,) int64 gt class for positives, -1 otherwise


def assign_max_iou(boxes: torch.Tensor, box_valid: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, gt_labels: torch.Tensor,
                   cfg: AssignerConfig) -> AssignResult:
    """Per box: -1 (ignore), 0 (negative, max IoU < neg_iou_thr) or g+1
    (positive, max IoU >= pos_iou_thr, the first gt of largest IoU); with
    low-quality matching each gt also takes its largest-IoU boxes, ties
    included, later gts overriding earlier ones. Masked (gt, box) pairs
    count as IoU 0."""
    n = boxes.shape[0]
    g = gt_boxes.shape[0]
    iou = bbox_overlaps(gt_boxes, boxes)                         # (G, N)
    pair_valid = gt_valid[:, None] & box_valid[None, :]
    iou = torch.where(pair_valid, iou, torch.zeros_like(iou))

    max_iou = torch.clamp(iou.max(dim=0).values, min=0.0)
    argmax_gt = torch.argmax(iou, dim=0)
    minus = torch.full((n,), -1, dtype=torch.int64, device=boxes.device)
    assigned = torch.where((max_iou >= 0) & (max_iou < cfg.neg_iou_thr),
                           torch.zeros_like(minus), minus)
    assigned = torch.where(max_iou >= cfg.pos_iou_thr, argmax_gt + 1, assigned)

    if cfg.match_low_quality:
        gt_max = iou.max(dim=1).values                          # (G,)
        ok = (gt_max >= cfg.min_pos_iou) & gt_valid
        hit = (iou == gt_max[:, None]) & ok[:, None]             # (G, N), ties included
        any_hit = hit.any(dim=0)
        # later gts override earlier ones: the last hit is the first of the flip
        last_g = g - 1 - torch.argmax(torch.flip(hit, [0]).to(torch.uint8), dim=0)
        assigned = torch.where(any_hit, last_g + 1, assigned)

    assigned = torch.where(box_valid, assigned, minus)
    pos = assigned > 0
    labels = torch.where(pos, gt_labels.to(torch.int64)[torch.clamp(assigned - 1, min=0)],
                         minus)
    return AssignResult(assigned, max_iou, labels)


class SampleResult(NamedTuple):
    """Fixed-size sample of `num` rois, positives occupying the first slots."""

    rois: torch.Tensor          # (num, 4)
    valid: torch.Tensor         # (num,) bool: slot holds a real sample
    is_pos: torch.Tensor        # (num,) bool
    is_gt: torch.Tensor         # (num,) bool: positive that came from a prepended gt
    gt_inds: torch.Tensor       # (num,) int64 0-based matched gt (0 where not pos)
    labels: torch.Tensor        # (num,) int64 gt label for pos, num_classes for neg
    pos_gt_boxes: torch.Tensor  # (num, 4) matched gt box (0 where not pos)


def _uniform(shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform [0, 1) draws from `generator` (on its device), on `device`."""
    gen_dev = generator.device if generator is not None else device
    return torch.rand(shape, generator=generator, device=gen_dev).to(device)


def _select_k(mask: torch.Tensor, k: int,
              generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly pick up to k True positions of `mask`: (idx (k,), ok (k,)).
    Picked positions come first; the rest of `idx` is unspecified."""
    keys = torch.where(mask, _uniform(mask.shape, mask.device, generator),
                       torch.full(mask.shape, -1.0, device=mask.device))
    top, idx = torch.topk(keys, k)
    return idx, top >= 0.0


def sample_from_injection(cand_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_labels: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                          is_pos: torch.Tensor, is_gt: torch.Tensor, gt_inds: torch.Tensor,
                          num_classes: int) -> SampleResult:
    """A SampleResult from externally chosen indices into `cand_boxes`
    (positives first). The parity hook that gives the port and the JAX
    package identical samples."""
    idx = idx.to(torch.int64)
    gt_inds = gt_inds.to(torch.int64)
    rois = cand_boxes[idx]
    labels = torch.where(is_pos, gt_labels.to(torch.int64)[gt_inds],
                         torch.full_like(gt_inds, num_classes))
    pos_gt_boxes = torch.where(is_pos[:, None], gt_boxes[gt_inds],
                               torch.zeros_like(rois))
    return SampleResult(rois=rois, valid=valid, is_pos=is_pos, is_gt=is_gt,
                        gt_inds=torch.where(is_pos, gt_inds, torch.zeros_like(gt_inds)),
                        labels=labels, pos_gt_boxes=pos_gt_boxes)


def sample_random(boxes: torch.Tensor, box_valid: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, gt_labels: torch.Tensor,
                  assigner_cfg: AssignerConfig, cfg: SamplerConfig, pos_cap: int,
                  num_classes: int,
                  generator: Optional[torch.Generator] = None) -> SampleResult:
    """Assign and sample one image's proposals into a fixed (num,) block:
    gts prepended as proposals when the sampler says so, up to `pos_cap`
    positives drawn uniformly, then negatives drawn uniformly."""
    if cfg.add_gt_as_proposals:
        cand_boxes = torch.cat([gt_boxes, boxes], dim=0)
        cand_valid = torch.cat([gt_valid, box_valid], dim=0)
    else:
        cand_boxes, cand_valid = boxes, box_valid

    ar = assign_max_iou(cand_boxes, cand_valid, gt_boxes, gt_valid, gt_labels, assigner_cfg)
    gt_inds = ar.gt_inds
    if cfg.add_gt_as_proposals:
        # prepended gts self-assign (gt row g -> gt g), provided valid
        g = gt_boxes.shape[0]
        self_idx = torch.arange(1, g + 1, dtype=torch.int64, device=gt_inds.device)
        gt_inds = torch.cat([torch.where(gt_valid, self_idx, torch.full_like(self_idx, -1)),
                             gt_inds[g:]])
        is_gt_row = torch.cat([gt_valid, torch.zeros_like(box_valid)])
    else:
        is_gt_row = torch.zeros_like(cand_valid)

    pos_idx, pos_ok = _select_k(gt_inds > 0, pos_cap, generator)
    neg_idx, neg_ok = _select_k(gt_inds == 0, cfg.num, generator)

    npos = pos_ok.sum()
    slot = torch.arange(cfg.num, device=gt_inds.device)
    in_pos = slot < npos
    neg_slot = torch.clamp(slot - npos, 0, cfg.num - 1)
    pos_slot = torch.clamp(slot, max=pos_cap - 1)
    idx = torch.where(in_pos, pos_idx[pos_slot], neg_idx[neg_slot])
    valid = in_pos | neg_ok[neg_slot]

    rois = cand_boxes[idx]
    sel_gt = torch.clamp(gt_inds[idx] - 1, min=0)
    is_pos = in_pos & valid
    labels = torch.where(is_pos, gt_labels.to(torch.int64)[sel_gt],
                         torch.full_like(sel_gt, num_classes))
    pos_gt_boxes = torch.where(is_pos[:, None], gt_boxes[sel_gt], torch.zeros_like(rois))
    return SampleResult(rois=rois, valid=valid, is_pos=is_pos, is_gt=is_pos & is_gt_row[idx],
                        gt_inds=torch.where(is_pos, sel_gt, torch.zeros_like(sel_gt)),
                        labels=labels, pos_gt_boxes=pos_gt_boxes)
