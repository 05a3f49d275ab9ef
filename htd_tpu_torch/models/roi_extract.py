"""RoI feature extractors, read from the shared packed pyramid.

Counterpart of `htd_tpu/models/roi_extract.py`:
  * `single_roi_extract_batched`: RoIAlign of each roi on its FPN level,
    floor(log2(sqrt(area) / 56)) (mmdet SingleRoIExtractor);
  * `AdptRoIExtractor` (the BA extractor): RoIAlign on every level at the
    cheaper `adpt_max_samples` clamp, the roi's own-level row replaced by
    its exact single-level features, per-level scalar attention (GAP ->
    1x1 conv 256->128 -> tanh -> 1x1 conv 128->1), softmax over levels,
    weighted sum, plus the finest level's border ring.
These follow the JAX package where it differs from mmdet (the sample
clamp, the own-level reuse, fixed-capacity rois with validity masks).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from htd_tpu_torch.config import RoIExtractorConfig
from htd_tpu_torch.models.layers import ring_mask
from htd_tpu_torch.ops.boxes import map_roi_levels
from htd_tpu_torch.ops.pyramid import Pyramid
from htd_tpu_torch.ops.roi_align import roi_align_levels, roi_align_pyramid


# the JAX package's RoIAlign implementations (`htd_tpu/models/roi_extract.py`):
# each computes the same function, so every name maps onto the one RoIAlign
# here, K2 on CUDA tensors and its plain version on CPU tensors
ROI_ALIGN_IMPLS = ("auto", "pallas", "pallas_v3", "pallas_v4", "gather")


def single_roi_extract_batched(pyr: Pyramid, rois: torch.Tensor,
                               cfg: RoIExtractorConfig) -> torch.Tensor:
    """Level-mapped RoIAlign: rois (B, R, 4) -> (B, R, 7, 7, C)."""
    if cfg.impl not in ROI_ALIGN_IMPLS:
        raise ValueError(f"unknown roi extractor impl {cfg.impl!r}; expected one of "
                         f"{'/'.join(ROI_ALIGN_IMPLS)}")
    lvls = map_roi_levels(rois, len(cfg.featmap_strides), cfg.finest_scale)
    return roi_align_pyramid(pyr, rois, lvls, cfg.featmap_strides, cfg.out_size,
                             cfg.sampling_ratio, cfg.max_samples)


class SingleRoIExtractor(nn.Module):
    """mmdet's `bbox_roi_extractor.0` (no parameters)."""

    def __init__(self, cfg: RoIExtractorConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, pyr: Pyramid, rois: torch.Tensor) -> torch.Tensor:
        return single_roi_extract_batched(pyr, rois, self.cfg)


class AdptRoIExtractor(nn.Module):
    """BA extractor: attention-weighted all-level fusion + border ring."""

    def __init__(self, cfg: RoIExtractorConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(in_channels, 128, 1)
        self.conv2 = nn.Conv2d(128, 1, 1)

    def forward(self, pyr: Pyramid, rois: torch.Tensor,
                target_feats: Optional[torch.Tensor] = None,
                target_lvls: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rois (B, R, 4) -> (B, R, 7, 7, C). `target_feats` (B, R, 7, 7, C)
        and `target_lvls` (B, R), when given, replace each roi's own-level
        row of the all-level stack."""
        cfg = self.cfg
        aligned = roi_align_levels(pyr, rois, cfg.featmap_strides, cfg.out_size,
                                   cfg.sampling_ratio, cfg.adpt_max_samples)
        num_levels = aligned.shape[0]
        if target_feats is not None:
            lv = torch.arange(num_levels, device=rois.device)[:, None, None]
            sel = (target_lvls[None] == lv)[..., None, None, None]
            aligned = torch.where(sel, target_feats.to(aligned.dtype)[None], aligned)
        pooled = aligned.mean(dim=(3, 4))                       # (L, B, R, C)
        w1 = self.conv1.weight.flatten(1).to(pooled.dtype)
        w2 = self.conv2.weight.flatten(1).to(pooled.dtype)
        a = F.linear(torch.tanh(F.linear(pooled, w1, self.conv1.bias.to(pooled.dtype))),
                     w2, self.conv2.bias.to(pooled.dtype))[..., 0]  # (L, B, R)
        att = torch.softmax(a, dim=0).to(aligned.dtype)
        fused = torch.einsum("lbrhwc,lbr->brhwc", aligned, att)
        keep = ring_mask(cfg.adpt_edge, cfg.out_size, rois.device)
        ring = aligned[0] * keep[None, None, :, :, None].to(aligned.dtype)
        return fused + ring
