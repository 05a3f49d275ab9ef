"""Loss functions.

Counterpart of `htd_tpu/train/losses.py` (mmdet cross_entropy_loss.py,
smooth_l1_loss.py, accuracy.py and the averaging rules of bbox_head.py /
anchor_head.py): float32 math, sums divided by max(avg_factor, 1).
  * RPN cls: per-anchor sigmoid BCE, sum / number of sampled anchors;
  * RCNN cls: softmax CE, sum / number of sampled rois;
  * box regression: smooth-L1 on positives, sum / number of samples;
  * SFA: multi-label BCE-with-logits, mean over (B, C+1), x loss_weight.
"""

from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32


def _mean_over(total: torch.Tensor, avg_factor) -> torch.Tensor:
    """total / max(avg_factor, 1), dividing by a tensor (on CUDA, PyTorch
    divides by a Python scalar as a multiply by its reciprocal)."""
    avg = torch.as_tensor(avg_factor, dtype=_F32, device=total.device)
    return total / torch.clamp(avg, min=1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
               avg_factor) -> torch.Tensor:
    """Weighted softmax cross-entropy, summed and divided by avg_factor."""
    logp = torch.log_softmax(logits.to(_F32), dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return _mean_over(torch.sum(nll * weights), avg_factor)


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.to(_F32)
    targets = targets.to(_F32)
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                avg_factor) -> torch.Tensor:
    """Weighted per-element sigmoid BCE, summed / avg_factor."""
    loss = _bce(logits, targets)
    return _mean_over(torch.sum(loss * weights), avg_factor)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                   beta: float, avg_factor) -> torch.Tensor:
    """Weighted smooth-L1 (weights broadcast over the last dim)."""
    loss = smooth_l1(pred.to(_F32), target.to(_F32), beta)
    return _mean_over(torch.sum(loss * weights), avg_factor)


def multilabel_bce(logits: torch.Tensor, targets: torch.Tensor,
                   loss_weight: float) -> torch.Tensor:
    """BCEWithLogitsLoss(mean) * loss_weight, the SFA image-level loss."""
    return loss_weight * torch.mean(_bce(logits, targets))


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    correct = (torch.argmax(logits, dim=-1) == labels).to(_F32)
    if weights is None:
        return torch.mean(correct)
    return _mean_over(torch.sum(correct * weights), torch.sum(weights))
