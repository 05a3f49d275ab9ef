"""RPN head and static-capacity proposal generation.

Counterpart of `htd_tpu/models/rpn.py` (mmdet rpn_head.py): a shared 3x3
conv with 1x1 objectness and box heads on every level, then per level the
`nms_pre` best anchors inside the image's pad region (ceil32 of its
resized shape), delta decode clipped to the image, level-aware batched
NMS and the `nms_post` cap. Outputs have fixed capacity with validity
masks. Top-k ties break by anchor index (a stable sort), as the JAX
package's `top_k` does. With `HTD_RPN_FENCE=1` each level entering the head
is fenced (kernel K8 on CUDA), as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from htd_tpu_torch.config import ProposalConfig
from htd_tpu_torch.ops.anchors import AnchorGenerator
from htd_tpu_torch.ops.boxes import delta2bbox
from htd_tpu_torch.ops.fence import fenced
from htd_tpu_torch.ops.nms import NEG_INF, batched_nms


class RPNHead(nn.Module):
    """Shared conv tower applied to every FPN level."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW levels -> per level (B, H, W, A) logits and (B, H, W, 4A)
        deltas, float32, in the JAX package's layout."""
        scores, deltas = [], []
        for f in feats:
            t = F.relu(self.rpn_conv(fenced(f, "HTD_RPN_FENCE")))
            scores.append(self.rpn_cls(t).permute(0, 2, 3, 1).float())
            deltas.append(self.rpn_reg(t).permute(0, 2, 3, 1).float())
        return scores, deltas


def gen_proposals(level_scores: Sequence[torch.Tensor],
                  level_deltas: Sequence[torch.Tensor],
                  generator: AnchorGenerator, img_shapes: torch.Tensor,
                  cfg: ProposalConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched proposals: per level (B, H, W, A) / (B, H, W, 4A), img_shapes
    (B, 2). Returns boxes (B, P, 4), scores (B, P), valid (B, P) with
    P = cfg.nms_post, in score order."""
    b = level_scores[0].shape[0]
    dev = level_scores[0].device
    img_shapes = img_shapes.to(device=dev, dtype=torch.float32)
    pad_shape = torch.ceil(img_shapes / 32.0) * 32.0
    cand_scores: List[torch.Tensor] = []
    cand_boxes: List[torch.Tensor] = []
    cand_ids: List[torch.Tensor] = []
    for lvl, (s, d) in enumerate(zip(level_scores, level_deltas)):
        fh, fw = int(s.shape[1]), int(s.shape[2])
        anchors = generator.grid_anchors_level(lvl, (fh, fw), dev)
        prob = torch.sigmoid(s.reshape(b, -1).float())
        valid = generator.valid_flags_level(lvl, (fh, fw), pad_shape)
        prob = torch.where(valid, prob, torch.full_like(prob, NEG_INF))
        k = min(cfg.nms_pre, prob.shape[1])
        top = torch.sort(prob, dim=1, descending=True, stable=True)
        top_s, top_i = top.values[:, :k], top.indices[:, :k]
        flat_d = d.reshape(b, -1, 4).float()
        deltas = torch.gather(flat_d, 1, top_i[..., None].expand(b, k, 4))
        boxes = delta2bbox(anchors[top_i], deltas, max_shape=img_shapes[:, None, :])
        cand_scores.append(top_s)
        cand_boxes.append(boxes)
        cand_ids.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
    scores = torch.cat(cand_scores, dim=1)
    boxes = torch.cat(cand_boxes, dim=1)
    ids = torch.cat(cand_ids)
    if cfg.min_bbox_size > 0:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        ok = (w >= cfg.min_bbox_size) & (h >= cfg.min_bbox_size)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))

    out_b, out_s, out_v = [], [], []
    for i in range(b):
        keep, keep_score, keep_valid = batched_nms(boxes[i], scores[i], ids,
                                                   cfg.nms_thr, cfg.nms_post)
        out_b.append(torch.where(keep_valid[:, None], boxes[i][keep], 0.0))
        out_s.append(torch.where(keep_valid, keep_score, 0.0))
        out_v.append(keep_valid)
    return torch.stack(out_b), torch.stack(out_s), torch.stack(out_v)
