"""RoI heads: the SFA global-context head, the stage-0 Shared2FC head and
the stage-1 HTD head (PGraph classification + BA regression).

Counterpart of `htd_tpu/models/heads.py`. Inputs and outputs use the JAX
package's layouts ((B, R, 7, 7, C) roi features); parameters keep the
mmdet names and torch layouts, so the two flatten-consuming FCs
(`shared_fcs.0`, `fcs.0`) take a CHW flatten of each roi.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from htd_tpu_torch.config import GlobalContextConfig, HTDHeadConfig
from htd_tpu_torch.models.layers import ConvModule, ring_mask
from htd_tpu_torch.ops.boxes import bbox_overlaps, map_roi_levels


def _flatten_chw(roi_feats: torch.Tensor) -> torch.Tensor:
    """(..., 7, 7, C) -> (..., C*7*7), torch's CHW flatten order."""
    lead = roi_feats.shape[:-3]
    return roi_feats.movedim(-1, -3).reshape(lead + (-1,))


class GlobalContextHead(nn.Module):
    """SFA head: (B, C, H, W) top level -> logits (B, C+1), feature (B, C)."""

    def __init__(self, cfg: GlobalContextConfig, num_classes_p1: int = 81):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(cfg.in_channels if i == 0 else cfg.conv_out_channels,
                       cfg.conv_out_channels, 3)
            for i in range(cfg.num_convs)
        ])
        self.fc = nn.Linear(cfg.conv_out_channels, num_classes_p1)

    def forward(self, top_feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = top_feat
        for c in self.convs:
            x = F.relu(c(x))
        pooled = x.mean(dim=(2, 3))
        return self.fc(pooled), pooled


class Shared2FCBBoxHead(nn.Module):
    """Stage-0 head: CHW flatten -> 2x FC+ReLU -> cls (C+1) / reg (4)."""

    def __init__(self, in_channels: int = 256, roi_size: int = 7, fc_out: int = 1024,
                 num_classes: int = 80):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_out),
            nn.Linear(fc_out, fc_out),
        ])
        self.fc_cls = nn.Linear(fc_out, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out, 4)

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _flatten_chw(roi_feats)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

    def cls_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The classifier's (C+1, F) weight and (C+1,) bias."""
        return self.fc_cls.weight, self.fc_cls.bias


def pgraph(x_feat, sam, rois, lvls, valid):
    """Graph mixing for a batch: A_global @ (A_local @ x_feat), (B, R, F).

    x_feat (B, R, F); sam (B, R, S); rois (B, R, 4); lvls (B, R); valid
    (B, R). The (image, level) blocks of the reference's loop are disjoint,
    so adjacency and softmax are masked to each roi's (same level, valid)
    group and computed as one (R x R) product per image.
    """
    r = rois.shape[1]
    f32 = torch.float32
    eye = torch.eye(r, dtype=torch.bool, device=rois.device)
    group = (lvls[:, :, None] == lvls[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    group = group | eye
    iou = bbox_overlaps(rois.to(f32), rois.to(f32))
    adj = ((iou > 0) | eye) & group
    deg = adj.to(f32).sum(-1)
    dinv = torch.rsqrt(deg.clamp(min=1e-12))
    a_local = adj.to(f32) * dinv[:, :, None] * dinv[:, None, :]
    mixed = a_local.to(x_feat.dtype) @ x_feat
    sim = (sam @ sam.transpose(1, 2)).to(f32)
    score = torch.where(adj, torch.zeros_like(sim), sim)
    score = torch.where(group, score, torch.full_like(sim, float("-inf")))
    a_global = torch.softmax(score, dim=-1)
    return a_global.to(mixed.dtype) @ mixed


class HTDBBoxHead(nn.Module):
    """Stage-1 heterogeneous head (PGraph cls + BA reg)."""

    def __init__(self, cfg: HTDHeadConfig, num_levels: int = 4):
        super().__init__()
        self.cfg = cfg
        self.num_levels = num_levels
        c = cfg
        f = c.fc_out_channels
        self.fcs = nn.Sequential(
            nn.Linear(c.in_channels * c.roi_feat_size ** 2, f), nn.ReLU(),
            nn.Linear(f, f), nn.ReLU())
        self.fc_cls = nn.Linear(f, c.num_classes + 1)
        self.fc_reg = nn.Linear(c.reg_out_channels, 4)
        for lvl in range(num_levels):
            setattr(self, f"graph_lvl{lvl}_cls", nn.Linear(f, f))
        convs = []
        for i in range(c.num_reg_convs):
            cin = c.in_channels if i == 0 else c.reg_mid_channels
            last = i == c.num_reg_convs - 1
            convs.append(ConvModule(
                cin, c.reg_out_channels if last else c.reg_mid_channels, 3, bias=False,
                gn_groups=None if last else c.gn_groups))
        self.convs = nn.ModuleList(convs)

    def _reg_branch(self, x_reg, enhanced, global_feat):
        c = self.cfg
        o = c.roi_feat_size
        if global_feat is not None:
            x_reg = x_reg + global_feat[:, None, None, None, :].to(x_reg.dtype)
        ring = ring_mask(c.edge, o, x_reg.device)[None, None, :, :, None]
        if c.replace_mode:
            x_reg = x_reg * (~ring).to(x_reg.dtype) + c.alpha * enhanced
        elif c.average_mode:
            ys = torch.arange(o, device=x_reg.device)
            border = (ys < c.edge) | (ys >= o - c.edge)
            half = torch.tensor(0.5, device=x_reg.device)
            one = torch.tensor(1.0, device=x_reg.device)
            fac = torch.where(border[:, None], half, one) * torch.where(border[None, :], half, one)
            extreme = (ys == 0) | (ys == o - 1)
            fac = torch.where(extreme[:, None] & extreme[None, :], fac * 2.0, fac)
            x_reg = x_reg * fac[None, None, :, :, None].to(x_reg.dtype) + 0.5 * enhanced
        else:
            x_reg = x_reg + c.alpha * enhanced
        lead = x_reg.shape[:2]
        # GroupNorm statistics are per roi: rois are the batch axis here
        t = x_reg.reshape((-1,) + x_reg.shape[2:]).permute(0, 3, 1, 2)
        t = t.contiguous(memory_format=torch.channels_last)
        for m in self.convs:
            t = F.relu(m(t))
        t = t.mean(dim=(2, 3)).reshape(lead + (-1,))
        return self.fc_reg(t)

    def forward(self, x_cls, x_reg, rois, roi_valid, stage0_cls_weight, stage0_cls_bias,
                enhanced_feat, global_feat: Optional[torch.Tensor] = None):
        """x_cls (B, R, 7, 7, C); x_reg and enhanced_feat (B, P, 7, 7, C);
        rois (B, R, 4); roi_valid (B, R). Returns cls (B, R, C+1) and
        bbox_pred (B, P, 4)."""
        bbox_pred = self._reg_branch(x_reg, enhanced_feat, global_feat)

        x_plain = self.fcs(_flatten_chw(x_cls))
        if global_feat is not None:
            fused = x_cls + global_feat[:, None, None, None, :].to(x_cls.dtype)
            x_base = self.fcs(_flatten_chw(fused))
        else:
            x_base = x_plain
        w0 = stage0_cls_weight.to(x_plain.dtype)
        b0 = stage0_cls_bias.to(x_plain.dtype)
        prototype = torch.cat([w0, b0[:, None]], dim=1).detach()  # (C+1, F+1)
        p = torch.softmax(F.linear(x_plain, w0, b0), dim=-1)
        sam = p @ prototype
        lvls = map_roi_levels(rois, self.num_levels)
        mixed = pgraph(x_plain, sam, rois, lvls, roi_valid)

        weight = torch.stack([getattr(self, f"graph_lvl{k}_cls").weight
                              for k in range(self.num_levels)])   # (L, G, F)
        bias = torch.stack([getattr(self, f"graph_lvl{k}_cls").bias
                            for k in range(self.num_levels)])     # (L, G)
        gcn = F.relu(torch.einsum("brf,lgf->brlg", mixed, weight.to(mixed.dtype))
                     + bias.to(mixed.dtype))
        idx = lvls.to(torch.int64)[:, :, None, None].expand(-1, -1, 1, gcn.shape[-1])
        refined = torch.gather(gcn, 2, idx)[:, :, 0]
        refined = refined * roi_valid[..., None].to(refined.dtype)
        return self.fc_cls(x_base + refined), bbox_pred
