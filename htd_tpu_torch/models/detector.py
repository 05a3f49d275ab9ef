"""The HTD detector: Faster R-CNN shell + two-stage heterogeneous RoI head.

Counterpart of `htd_tpu/models/detector.py` (inference: `simple_test`,
`stages_forward`; training: `forward_train`). Module names follow the mmdet
FasterRCNN(HTDRoIHead) state dict, so an mmdet checkpoint loads with
`load_state_dict`. Public inputs and outputs use the JAX package's
layouts: images (B, H, W, 3), levels (B, H, W, C), rois (B, R, 4) and the
padded `Detections`. Internally the convolutions run NCHW in
`torch.channels_last` memory format, whose NHWC views cost no copy.

The packed pyramid (kernel K1) is built once per forward and shared by
stage 0, stage 1 and the BA extractor (kernel K2 reads it three times;
in training, K4 adds each of the three reads' gradients into it).
In the DCN presets the backbone's deformable convs run kernel K3.
Each layer of the forward runs inside a `record_function` span named
`htd.<layer>`, which a `torch.profiler` trace reports with its host and
device time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from htd_tpu_torch.config import BoxCoderConfig, HTDConfig, StageTrainConfig
from htd_tpu_torch.models.fpn import FPN
from htd_tpu_torch.models.heads import GlobalContextHead, HTDBBoxHead, Shared2FCBBoxHead
from htd_tpu_torch.models.resnet import ResNet
from htd_tpu_torch.models.roi_extract import AdptRoIExtractor, SingleRoIExtractor
from htd_tpu_torch.models.rpn import RPNHead, gen_proposals
from htd_tpu_torch.ops.anchors import AnchorGenerator, anchor_inside_flags
from htd_tpu_torch.ops.boxes import bbox2delta, delta2bbox, map_roi_levels
from htd_tpu_torch.ops.nms import multiclass_nms
from htd_tpu_torch.ops.pyramid import Pyramid, pack_pyramid
from htd_tpu_torch.train import losses as L
from htd_tpu_torch.train.sampling import (SampleResult, _select_k, assign_max_iou,
                                          sample_from_injection, sample_random)


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
        self.cfg = cfg
        self.backbone = ResNet(bb.depth, bb.out_indices, bb.base_planes, bb.stage_with_dcn,
                               bb.groups, bb.base_width, bb.dcn_deform_groups)
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

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def loss_keys(self) -> Tuple[str, ...]:
        """The keys of `forward_train`'s dict, in its order; a train step
        sums the values whose key contains `loss`."""
        keys = ["loss_rpn_cls", "loss_rpn_bbox"]
        if self.cfg.with_global:
            keys.append("loss_global")
        for s in ("s0", "s1"):
            keys += [f"{s}.loss_cls", f"{s}.loss_bbox", f"{s}.acc"]
        return tuple(keys)

    def forward_train(self, images: torch.Tensor, img_shapes: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      overrides: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Training losses: images (B, H, W, 3), img_shapes (B, 2), padded
        gts (B, G, 4) / (B, G) / (B, G). Random sampling draws from
        `generator` (on any device).

        `overrides` is the JAX package's parity hook, with the same keys:
        "proposals"/"proposal_valid" (B, P) replace the RPN's proposals;
        "rpn_keep_pos"/"rpn_keep_neg"/"rpn_matched_gt" (B, A) replace the
        RPN's anchor sampling; "{s}_idx"/"{s}_valid"/"{s}_is_pos"/"{s}_is_gt"/
        "{s}_gt_inds" (B, num), s in {s0, s1}, replace a stage's sampling,
        indexing concat([gt, candidates]). Given identical overrides, both
        packages consume the same samples."""
        c = self.cfg
        tc = c.train
        dev = self.device
        f32 = torch.float32
        ov = {k: v.to(dev) for k, v in (overrides or {}).items()}
        img_shapes = img_shapes.to(device=dev, dtype=f32)
        gt_boxes = gt_boxes.to(device=dev, dtype=f32)
        gt_labels = gt_labels.to(device=dev, dtype=torch.int64)
        gt_valid = gt_valid.to(device=dev, dtype=torch.bool)
        losses: Dict[str, torch.Tensor] = {}

        with record_function("htd.backbone_fpn"):
            feats = self._features(images)
        with record_function("htd.rpn_loss"):
            rpn_scores, rpn_deltas = self.rpn_head(feats)
            inj = None
            if "rpn_keep_pos" in ov:
                inj = (ov["rpn_keep_pos"], ov["rpn_keep_neg"], ov["rpn_matched_gt"])
            losses["loss_rpn_cls"], losses["loss_rpn_bbox"] = self._rpn_loss(
                rpn_scores, rpn_deltas, img_shapes, gt_boxes, gt_valid, generator, inj)
        with record_function("htd.rpn_proposals"):
            if "proposals" in ov:
                props, prop_valid = ov["proposals"].to(f32), ov["proposal_valid"].bool()
            else:
                with torch.no_grad():
                    props, _, prop_valid = gen_proposals(
                        [s.detach() for s in rpn_scores], [d.detach() for d in rpn_deltas],
                        self.anchor_gen, img_shapes, tc.rpn_proposal)
        with record_function("htd.pyramid"):
            pyr = self._pyramid(feats)
        global_feat = None
        if c.with_global:
            with record_function("htd.global"):
                glb_logits, global_feat = self.roi_head.glbctx_head(feats[-1])
                onehot = F.one_hot(gt_labels, c.num_classes + 1).to(f32) * gt_valid[..., None]
                targets = (onehot.sum(dim=1) > 0).to(f32)
                losses["loss_global"] = L.multilabel_bce(glb_logits, targets,
                                                         c.global_ctx.loss_weight)

        with record_function("htd.stage0"):
            samp0 = self._sample("s0", ov, props, prop_valid, gt_boxes, gt_valid, gt_labels,
                                 tc.rcnn[0], generator)
            s0_cls, s0_reg = self._stage0(pyr, samp0.rois, global_feat)
            lw0 = tc.stage_loss_weights[0]
            l_cls0, l_bbox0, acc0 = self._bbox_head_loss(
                s0_cls, s0_reg, samp0, c.stage0_head.coder, c.stage0_head.loss_bbox_beta)
            losses["s0.loss_cls"] = l_cls0 * lw0
            losses["s0.loss_bbox"] = l_bbox0 * lw0
            losses["s0.acc"] = acc0
            # stage-1 candidates: the refined rois without gradient, gt rows dropped
            refined = self._refine(samp0.rois, s0_reg, img_shapes).detach()
            refined_valid = samp0.valid & ~samp0.is_gt

        with record_function("htd.stage1"):
            samp1 = self._sample("s1", ov, refined, refined_valid, gt_boxes, gt_valid,
                                 gt_labels, tc.rcnn[1], generator)
            pos_cap = tc.rcnn_pos_cap
            x_cls1 = self.roi_head.bbox_roi_extractor[0](pyr, samp1.rois)
            x_reg1 = x_cls1[:, :pos_cap]
            # the BA extractor samples every level of the positive block
            # itself (no own-level reuse in training, as the JAX package)
            enhanced = self.roi_head.bbox_roi_extractor[1](pyr, samp1.rois[:, :pos_cap])
            w0, b0 = self.roi_head.bbox_head[0].cls_params()
            s1_cls, s1_reg_pos = self.roi_head.bbox_head[1](
                x_cls1, x_reg1, samp1.rois, samp1.valid, w0, b0, enhanced, global_feat)
            # positive-block predictions scattered into a zero (B, num, 4) block
            b, num = samp1.rois.shape[:2]
            s1_reg = torch.cat([s1_reg_pos.to(f32),
                                torch.zeros((b, num - pos_cap, 4), dtype=f32, device=dev)], 1)
            lw1 = tc.stage_loss_weights[1]
            l_cls1, l_bbox1, acc1 = self._bbox_head_loss(
                s1_cls.to(f32), s1_reg, samp1, c.stage1_head.coder, c.stage1_head.loss_bbox_beta)
            losses["s1.loss_cls"] = l_cls1 * lw1
            losses["s1.loss_bbox"] = l_bbox1 * lw1
            losses["s1.acc"] = acc1
        return losses

    def _sample(self, s: str, ov, candidates, cand_valid, gt_boxes, gt_valid, gt_labels,
                stage: StageTrainConfig, generator) -> SampleResult:
        """The stage's (B, num) sample: injected, or assigned and drawn per image."""
        if f"{s}_idx" in ov:
            return self._injected_sample(ov, s, candidates, gt_boxes, gt_labels)
        per_img = [sample_random(candidates[i], cand_valid[i], gt_boxes[i], gt_valid[i],
                                 gt_labels[i], stage.assigner, stage.sampler,
                                 self.cfg.train.rcnn_pos_cap, self.cfg.num_classes, generator)
                   for i in range(candidates.shape[0])]
        return SampleResult(*(torch.stack(t) for t in zip(*per_img)))

    def _injected_sample(self, ov, s: str, candidates, gt_boxes, gt_labels) -> SampleResult:
        """Batched `sample_from_injection` over the ov[f"{s}_*"] arrays."""
        cand = torch.cat([gt_boxes, candidates], dim=1)
        per_img = [sample_from_injection(
            cand[i], gt_boxes[i], gt_labels[i], ov[f"{s}_idx"][i], ov[f"{s}_valid"][i].bool(),
            ov[f"{s}_is_pos"][i].bool(), ov[f"{s}_is_gt"][i].bool(), ov[f"{s}_gt_inds"][i],
            self.cfg.num_classes) for i in range(cand.shape[0])]
        return SampleResult(*(torch.stack(t) for t in zip(*per_img)))

    def _rpn_loss(self, level_scores, level_deltas, img_shapes, gt_boxes, gt_valid,
                  generator=None, inj=None):
        """Assign and sample anchors and compute the RPN losses, flat over
        levels (mmdet anchor_head.py, RPN allowed_border 0). `inj` injects
        (keep_pos, keep_neg, matched_gt) (B, A) in place of assign/sample."""
        c = self.cfg
        tc = c.train
        dev = level_scores[0].device
        f32 = torch.float32
        sizes = [tuple(s.shape[1:3]) for s in level_scores]
        anchors = torch.cat([self.anchor_gen.grid_anchors_level(i, fs, dev)
                             for i, fs in enumerate(sizes)])
        b = level_scores[0].shape[0]
        flat_scores = torch.cat([s.reshape(b, -1) for s in level_scores], 1).to(f32)
        flat_deltas = torch.cat([d.reshape(b, -1, 4) for d in level_deltas], 1).to(f32)
        means, stds, beta = c.rpn.coder.means, c.rpn.coder.stds, c.rpn.loss_bbox_beta

        if inj is not None:
            keep_pos, keep_neg = inj[0].bool(), inj[1].bool()
            matched = inj[2].to(torch.int64)
            gt_for = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
            gt_for = torch.where(keep_pos[..., None], gt_for, anchors[None])
            tgt = bbox2delta(anchors[None].expand_as(gt_for), gt_for, means, stds)
            cls_w = (keep_pos | keep_neg).to(f32)
            num_total = cls_w.sum()
            loss_cls = L.sigmoid_bce(flat_scores, keep_pos.to(f32), cls_w, num_total)
            loss_bbox = L.smooth_l1_loss(flat_deltas, tgt, keep_pos.to(f32)[..., None], beta,
                                         num_total)
            return loss_cls, loss_bbox

        sampler = tc.rpn_sampler
        pos_cap = int(sampler.num * sampler.pos_fraction)
        pad_shape = torch.ceil(img_shapes / 32.0) * 32.0
        valid = torch.cat([self.anchor_gen.valid_flags_level(i, fs, pad_shape)
                           for i, fs in enumerate(sizes)], dim=-1)       # (B, A)
        no_labels = torch.zeros(gt_boxes.shape[1], dtype=torch.int64, device=dev)
        cls_t, cls_w, box_t, box_w, pos_idx = [], [], [], [], []
        with torch.no_grad():
            for i in range(b):
                inside = anchor_inside_flags(anchors, valid[i], img_shapes[i],
                                             tc.rpn_allowed_border)
                ar = assign_max_iou(anchors, inside, gt_boxes[i], gt_valid[i], no_labels,
                                    tc.rpn_assigner)
                p_idx, p_ok = _select_k(ar.gt_inds > 0, pos_cap, generator)
                n_idx, n_ok = _select_k(ar.gt_inds == 0, sampler.num, generator)
                rank = torch.arange(sampler.num, device=dev)
                n_ok = n_ok & (rank < sampler.num - p_ok.sum())
                keep_pos = torch.zeros(anchors.shape[0], dtype=torch.bool, device=dev)
                keep_neg = torch.zeros_like(keep_pos)
                keep_pos[p_idx] = p_ok
                keep_neg[n_idx] = n_ok
                # compact box targets: only the kept positives carry box-loss weight
                p_anchors = anchors[p_idx]
                w = p_ok & (ar.gt_inds[p_idx] > 0)
                p_gt = gt_boxes[i][torch.clamp(ar.gt_inds[p_idx] - 1, min=0)]
                safe_gt = torch.where(w[:, None], p_gt, p_anchors)
                cls_t.append(keep_pos.to(f32))
                cls_w.append((keep_pos | keep_neg).to(f32))
                box_t.append(bbox2delta(p_anchors, safe_gt, means, stds))
                box_w.append(w.to(f32))
                pos_idx.append(p_idx)
        cls_w_t = torch.stack(cls_w)
        num_total = cls_w_t.sum()
        loss_cls = L.sigmoid_bce(flat_scores, torch.stack(cls_t), cls_w_t, num_total)
        idx = torch.stack(pos_idx)
        deltas_pos = torch.gather(flat_deltas, 1, idx[..., None].expand(-1, -1, 4))
        loss_bbox = L.smooth_l1_loss(deltas_pos, torch.stack(box_t),
                                     torch.stack(box_w)[..., None], beta, num_total)
        return loss_cls, loss_bbox

    def _bbox_head_loss(self, cls_score, bbox_pred, samp: SampleResult,
                        coder: BoxCoderConfig, beta: float):
        """Softmax CE over all sampled rois and smooth-L1 on the positives,
        both divided by the number of sampled rois (mmdet bbox_head.py)."""
        f32 = torch.float32
        labels = samp.labels
        label_w = samp.valid.to(f32)
        avg = label_w.sum()
        l_cls = L.softmax_ce(cls_score, labels, label_w, avg)
        # non-positive slots encode a unit box against itself (no NaN)
        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=f32, device=samp.rois.device)
        pos3 = samp.is_pos[..., None]
        tgt = bbox2delta(torch.where(pos3, samp.rois, unit),
                         torch.where(pos3, samp.pos_gt_boxes, unit), coder.means, coder.stds)
        l_bbox = L.smooth_l1_loss(bbox_pred, tgt, samp.is_pos.to(f32)[..., None], beta, avg)
        return l_cls, l_bbox, L.accuracy(cls_score, labels, label_w)
