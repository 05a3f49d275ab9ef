"""The HTD detector: Faster R-CNN shell + two-stage heterogeneous RoI head.

Counterpart of `htd_tpu/models/detector.py` (inference: `simple_test`,
`stages_forward`). Module names follow the mmdet
FasterRCNN(HTDRoIHead) state dict, so an mmdet checkpoint loads with
`load_state_dict`. Public inputs and outputs use the JAX package's
layouts: images (B, H, W, 3), levels (B, H, W, C), rois (B, R, 4) and the
padded `Detections`. Internally the convolutions run NCHW in
`torch.channels_last` memory format, whose NHWC views cost no copy.

The packed pyramid (kernel K1) is built once per forward and shared by
stage 0, stage 1 and the BA extractor (kernel K2 reads it three times).
Each layer of the forward runs inside a `record_function` span named
`htd.<layer>`, which a `torch.profiler` trace reports with its host and
device time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from htd_tpu_torch.config import HTDConfig
from htd_tpu_torch.models.fpn import FPN
from htd_tpu_torch.models.heads import GlobalContextHead, HTDBBoxHead, Shared2FCBBoxHead
from htd_tpu_torch.models.resnet import ResNet
from htd_tpu_torch.models.roi_extract import AdptRoIExtractor, SingleRoIExtractor
from htd_tpu_torch.models.rpn import RPNHead, gen_proposals
from htd_tpu_torch.ops.anchors import AnchorGenerator
from htd_tpu_torch.ops.boxes import delta2bbox, map_roi_levels
from htd_tpu_torch.ops.nms import multiclass_nms
from htd_tpu_torch.ops.pyramid import Pyramid, pack_pyramid


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, max_per_img, 4) in original-image coords
    scores: torch.Tensor   # (B, max_per_img)
    labels: torch.Tensor   # (B, max_per_img) int32
    valid: torch.Tensor    # (B, max_per_img) bool


class HTDRoIHead(nn.Module):
    """Holds the RoI-head modules under their mmdet names."""

    def __init__(self, cfg: HTDConfig):
        super().__init__()
        num_levels = len(cfg.roi_extractor.featmap_strides)
        if cfg.with_global:
            self.glbctx_head = GlobalContextHead(cfg.global_ctx, cfg.num_classes + 1)
        s0 = cfg.stage0_head
        self.bbox_head = nn.ModuleList([
            Shared2FCBBoxHead(s0.in_channels, s0.roi_feat_size, s0.fc_out_channels,
                              cfg.num_classes),
            HTDBBoxHead(cfg.stage1_head, num_levels),
        ])
        self.bbox_roi_extractor = nn.ModuleList([
            SingleRoIExtractor(cfg.roi_extractor),
            AdptRoIExtractor(cfg.roi_extractor, cfg.fpn.out_channels),
        ])


class HTDDetector(nn.Module):
    def __init__(self, cfg: HTDConfig):
        super().__init__()
        bb = cfg.backbone
        if bb.groups != 1 or any(bb.stage_with_dcn):
            raise NotImplementedError(
                "ResNeXt and DCN backbones are not ported yet; see ROADMAP.md")
        self.cfg = cfg
        self.backbone = ResNet(bb.depth, bb.out_indices, bb.base_planes)
        self.neck = FPN(cfg.fpn.in_channels, cfg.fpn.out_channels, cfg.fpn.num_outs)
        a = cfg.rpn.anchor
        self.anchor_gen = AnchorGenerator(strides=a.strides, ratios=a.ratios,
                                          scales=a.scales)
        self.rpn_head = RPNHead(cfg.rpn.in_channels, cfg.rpn.feat_channels,
                                self.anchor_gen.num_base_anchors)
        self.roi_head = HTDRoIHead(cfg)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32

    @property
    def device(self) -> torch.device:
        return self.backbone.conv1.weight.device

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def _features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) images -> FPN levels, NCHW in channels_last format."""
        x = images.to(device=self.device, dtype=self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        return self.neck(self.backbone(x))

    def extract_feats(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) normalized images -> FPN levels (B, H, W, C)."""
        return tuple(f.permute(0, 2, 3, 1) for f in self._features(images))

    def _pyramid(self, feats) -> Pyramid:
        n = len(self.cfg.roi_extractor.featmap_strides)
        return pack_pyramid([f.permute(0, 2, 3, 1).contiguous() for f in feats[:n]])

    def _global(self, feats) -> Optional[torch.Tensor]:
        if not self.cfg.with_global:
            return None
        _, feat = self.roi_head.glbctx_head(feats[-1])
        return feat

    def _proposals(self, feats, img_shapes):
        scores, deltas = self.rpn_head(feats)
        return gen_proposals(scores, deltas, self.anchor_gen, img_shapes,
                             self.cfg.proposal_test)

    def _stage0(self, pyr: Pyramid, rois, global_feat):
        roi_feats = self.roi_head.bbox_roi_extractor[0](pyr, rois)
        if global_feat is not None:
            roi_feats = roi_feats + global_feat[:, None, None, None, :].to(roi_feats.dtype)
        cls, reg = self.roi_head.bbox_head[0](roi_feats)
        return cls.float(), reg.float()

    def _refine(self, rois, bbox_pred, img_shapes):
        """Class-agnostic refinement of rois by the stage-0 regression."""
        c = self.cfg.stage0_head.coder
        return delta2bbox(rois, bbox_pred, c.means, c.stds, max_shape=img_shapes[:, None, :])

    def _stage1(self, pyr: Pyramid, rois, roi_valid, global_feat):
        cfg = self.cfg.roi_extractor
        x_cls = self.roi_head.bbox_roi_extractor[0](pyr, rois)
        # the BA extractor reuses each roi's exact mapped-level features for
        # its own-level row; only the other levels are sampled again
        tgt_lvls = map_roi_levels(rois, len(cfg.featmap_strides), cfg.finest_scale)
        enhanced = self.roi_head.bbox_roi_extractor[1](pyr, rois, x_cls, tgt_lvls)
        w0, b0 = self.roi_head.bbox_head[0].cls_params()
        cls, reg = self.roi_head.bbox_head[1](x_cls, x_cls, rois, roi_valid, w0, b0,
                                              enhanced, global_feat)
        return cls.float(), reg.float()

    def _cascade(self, feats, img_shapes, rois, roi_valid):
        """Both stages on (B, R, 4) rois: refined rois, averaged logits and
        the stage-1 regression."""
        with record_function("htd.pyramid"):
            pyr = self._pyramid(feats)
        with record_function("htd.global"):
            global_feat = self._global(feats)
        with record_function("htd.stage0"):
            s0_cls, s0_reg = self._stage0(pyr, rois, global_feat)
            rois1 = self._refine(rois, s0_reg, img_shapes)
        with record_function("htd.stage1"):
            s1_cls, s1_reg = self._stage1(pyr, rois1, roi_valid, global_feat)
        return rois1, (s0_cls + s1_cls) / 2.0, s1_reg

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def forward(self, images, img_shapes, scale_factors) -> Detections:
        return self.simple_test(images, img_shapes, scale_factors)

    def simple_test(self, images: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: torch.Tensor) -> Detections:
        """images (B, H, W, 3) normalized and bucket-padded; img_shapes
        (B, 2) resized (h, w); scale_factors (B, 4) (w, h, w, h)."""
        c = self.cfg
        dev = self.device
        img_shapes = img_shapes.to(device=dev, dtype=torch.float32)
        scale_factors = scale_factors.to(device=dev, dtype=torch.float32)
        with record_function("htd.backbone_fpn"):
            feats = self._features(images)
        with record_function("htd.rpn_proposals"):
            props, _, prop_valid = self._proposals(feats, img_shapes)
        rois1, cls_score, s1_reg = self._cascade(feats, img_shapes, props, prop_valid)

        with record_function("htd.post"):
            coder = c.stage1_head.coder
            probs = torch.softmax(cls_score, dim=-1)
            probs = torch.where(prop_valid[..., None], probs, 0.0)
            boxes = delta2bbox(rois1, s1_reg, coder.means, coder.stds,
                               max_shape=img_shapes[:, None, :])
            boxes = boxes / scale_factors[:, None, :]
            r = c.rcnn_test
            dets = [multiclass_nms(boxes[i], probs[i], r.score_thr, r.nms_iou,
                                   r.max_per_img, use_soft_nms=r.use_soft_nms,
                                   soft_min_score=r.soft_min_score)
                    for i in range(boxes.shape[0])]
            return Detections(*(torch.stack(t) for t in zip(*dets)))

    def stages_forward(self, images, img_shapes, rois, roi_valid):
        """Both cascade stages on given proposals. Returns decoded boxes
        (B, P, 4) clipped to the image and softmax scores (B, P, C+1)
        averaged over the two stages."""
        dev = self.device
        img_shapes = img_shapes.to(device=dev, dtype=torch.float32)
        rois = rois.to(device=dev, dtype=torch.float32)
        roi_valid = roi_valid.to(dev)
        feats = self._features(images)
        rois1, cls_score, s1_reg = self._cascade(feats, img_shapes, rois, roi_valid)
        coder = self.cfg.stage1_head.coder
        boxes = delta2bbox(rois1, s1_reg, coder.means, coder.stds,
                           max_shape=img_shapes[:, None, :])
        scores = torch.softmax(cls_score, dim=-1)
        return boxes, torch.where(roi_valid[..., None], scores, 0.0)
