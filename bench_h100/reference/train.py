"""The plain reference of HTD's training step: mmdet's losses over the
published train settings (RPN anchor assignment and sampling, the SFA
image-level loss, both RoI stages' assignment, sampling, softmax CE and
smooth-L1), autograd through the plain operations, and SGD with momentum
and weight decay at the schedule's learning rate, over the trainable
tensors of a state dict (the stem and the first `frozen_stages` stages
frozen, BN statistics fixed).

Random sampling draws uniform keys from the `torch.Generator` it is
given, in the order the published sampler draws them (per image: the
RPN's positives then negatives; then each stage's), picking the up-to-k
largest keys among the candidates; a caller that hands the program and
the reference generators of one seed gets the same draws from both.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import ops
from bench_h100.reference.detector import Reference, trainable
from bench_h100.reference.ops import F32


class Batch(NamedTuple):
    images: torch.Tensor      # (B, H, W, 3) normalized, padded
    hws: List[Tuple[int, int]]
    gt_boxes: torch.Tensor    # (B, G, 4)
    gt_labels: torch.Tensor   # (B, G)
    gt_valid: torch.Tensor    # (B, G)


def make_batch(imgs: Sequence[np.ndarray], boxes: Sequence[np.ndarray],
               labels: Sequence[np.ndarray], flips: Sequence[bool], scale, bucket,
               max_gt: int, device) -> Batch:
    """mmdet's train pipeline on uint8 BGR images and their (x1, y1, x2, y2)
    boxes: keep-ratio resize, boxes scaled and clipped, flip, normalize,
    pad, gts padded to max_gt."""
    out_i, hws, gb, gl, gv = [], [], [], [], []
    for img, b, lab, fl in zip(imgs, boxes, labels, flips):
        image, (nh, nw), sf = ops.preprocess(img, scale, bucket, device, flip=fl)
        bx = torch.as_tensor(b, dtype=F32, device=device).reshape(-1, 4) * \
            torch.tensor(sf, dtype=F32, device=device)
        bx = torch.stack([bx[:, 0].clamp(0, nw), bx[:, 1].clamp(0, nh),
                          bx[:, 2].clamp(0, nw), bx[:, 3].clamp(0, nh)], -1)
        if fl:
            bx = torch.stack([nw - bx[:, 2], bx[:, 1], nw - bx[:, 0], bx[:, 3]], -1)
        n = min(len(bx), max_gt)
        pb = torch.zeros((max_gt, 4), dtype=F32, device=device)
        pl = torch.zeros((max_gt,), dtype=torch.int64, device=device)
        pv = torch.zeros((max_gt,), dtype=torch.bool, device=device)
        pb[:n], pl[:n], pv[:n] = bx[:n], torch.as_tensor(lab[:n], device=device), True
        out_i.append(image)
        hws.append((nh, nw))
        gb.append(pb)
        gl.append(pl)
        gv.append(pv)
    return Batch(torch.stack(out_i), hws, torch.stack(gb), torch.stack(gl), torch.stack(gv))


# -- assignment and sampling -----------------------------------------------------


def assign(boxes, box_valid, gt, gt_valid, a: dict):
    """mmdet MaxIoUAssigner: -1 ignore, 0 negative, g + 1 positive (first gt
    of largest IoU); low-quality matches give each gt its best boxes, ties
    included, later gts last."""
    iou = ops.box_iou(gt, boxes)                                     # (G, N)
    iou = torch.where(gt_valid[:, None] & box_valid[None, :], iou, torch.zeros_like(iou))
    max_iou = iou.max(dim=0).values.clamp(min=0.0)
    arg = torch.argmax(iou, dim=0)
    out = torch.full_like(arg, -1)
    out = torch.where((max_iou >= 0) & (max_iou < a["neg_iou_thr"]), torch.zeros_like(arg), out)
    out = torch.where(max_iou >= a["pos_iou_thr"], arg + 1, out)
    if a["match_low_quality"]:
        gmax = iou.max(dim=1).values
        hit = (iou == gmax[:, None]) & ((gmax >= a["min_pos_iou"]) & gt_valid)[:, None]
        last = gt.shape[0] - 1 - torch.argmax(torch.flip(hit, [0]).to(torch.uint8), dim=0)
        out = torch.where(hit.any(dim=0), last + 1, out)
    return torch.where(box_valid, out, torch.full_like(out, -1))


def pick(mask, k: int, gen: Optional[torch.Generator]):
    """Up to k True positions of `mask` chosen uniformly: the k largest
    uniform keys among them -> (idx (k,), ok (k,))."""
    dev = gen.device if gen is not None else mask.device
    u = torch.rand(mask.shape, generator=gen, device=dev).to(mask.device)
    keys = torch.where(mask, u, torch.full(mask.shape, -1.0, device=mask.device))
    top, idx = torch.topk(keys, k)
    return idx, top >= 0.0


class Sample(NamedTuple):
    rois: torch.Tensor
    valid: torch.Tensor
    is_pos: torch.Tensor
    is_gt: torch.Tensor
    labels: torch.Tensor
    pos_gt: torch.Tensor


def sample(boxes, box_valid, gt, gt_valid, gt_labels, stage: dict, pos_cap: int,
           num_classes: int, gen) -> Sample:
    """mmdet RandomSampler with the gts added as proposals: a fixed block of
    `num` rois, up to pos_cap positives first, then negatives."""
    s = stage["sampler"]
    g = gt.shape[0]
    if s["add_gt_as_proposals"]:
        cand = torch.cat([gt, boxes])
        cvalid = torch.cat([gt_valid, box_valid])
    else:
        cand, cvalid = boxes, box_valid
    inds = assign(cand, cvalid, gt, gt_valid, stage["assigner"])
    if s["add_gt_as_proposals"]:
        own = torch.arange(1, g + 1, device=gt.device)
        inds = torch.cat([torch.where(gt_valid, own, torch.full_like(own, -1)), inds[g:]])
        is_gt_row = torch.cat([gt_valid, torch.zeros_like(box_valid)])
    else:
        is_gt_row = torch.zeros_like(cvalid)
    p_idx, p_ok = pick(inds > 0, pos_cap, gen)
    n_idx, n_ok = pick(inds == 0, s["num"], gen)
    npos = p_ok.sum()
    slot = torch.arange(s["num"], device=gt.device)
    in_pos = slot < npos
    idx = torch.where(in_pos, p_idx[slot.clamp(max=pos_cap - 1)],
                      n_idx[(slot - npos).clamp(0, s["num"] - 1)])
    valid = in_pos | n_ok[(slot - npos).clamp(0, s["num"] - 1)]
    sel = (inds[idx] - 1).clamp(min=0)
    is_pos = in_pos & valid
    labels = torch.where(is_pos, gt_labels[sel].long(), torch.full_like(sel, num_classes))
    pos_gt = torch.where(is_pos[:, None], gt[sel], torch.zeros_like(cand[idx]))
    return Sample(cand[idx], valid, is_pos, is_pos & is_gt_row[idx], labels, pos_gt)


# -- losses ----------------------------------------------------------------------------


def _avg(total, n):
    return total / torch.clamp(torch.as_tensor(n, dtype=F32, device=total.device), min=1.0)


def bce(logits, targets):
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(pred, target, beta):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


class TrainReference(Reference):
    """The reference detector whose trainable tensors are autograd leaves,
    with mmdet's training losses and an SGD step."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], precision: str = "float32"):
        leaves = {k: v.detach().clone().requires_grad_(trainable(k, cfg)) for k, v in sd.items()}
        super().__init__(cfg, leaves, precision)
        self.momentum: Dict[str, torch.Tensor] = {}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.sd.items() if v.requires_grad}

    def rpn_loss(self, feats, scores, deltas, batch: Batch, gen):
        c, t = self.cfg, self.cfg["train"]
        a = c["rpn"]["anchor"]
        na = len(a["ratios"]) * len(a["scales"])
        anchors = torch.cat(self.anchors(feats))
        b = batch.images.shape[0]
        flat_s = torch.cat([s.reshape(b, -1) for s in scores], 1)
        flat_d = torch.cat([d.reshape(b, -1, 4) for d in deltas], 1)
        smp = t["rpn_sampler"]
        pos_cap = int(smp["num"] * smp["pos_fraction"])
        coder = c["rpn"]["coder"]
        cls_t, cls_w, box_t, box_w, pos_idx = [], [], [], [], []
        with torch.no_grad():
            for i in range(b):
                ph, pw = ops.ceil32(batch.hws[i][0]), ops.ceil32(batch.hws[i][1])
                valid = torch.cat([ops.anchor_valid(st, f.shape[-2], f.shape[-1], na, ph, pw,
                                                    anchors.device)
                                   for st, f in zip(a["strides"], feats)])
                h, w = batch.hws[i]
                border = t["rpn_allowed_border"]
                inside = valid if border < 0 else valid & (
                    (anchors[:, 0] >= -border) & (anchors[:, 1] >= -border)
                    & (anchors[:, 2] < w + border) & (anchors[:, 3] < h + border))
                inds = assign(anchors, inside, batch.gt_boxes[i], batch.gt_valid[i],
                              t["rpn_assigner"])
                p_idx, p_ok = pick(inds > 0, pos_cap, gen)
                n_idx, n_ok = pick(inds == 0, smp["num"], gen)
                n_ok = n_ok & (torch.arange(smp["num"], device=anchors.device)
                               < smp["num"] - p_ok.sum())
                keep_pos = torch.zeros(anchors.shape[0], dtype=torch.bool, device=anchors.device)
                keep_neg = torch.zeros_like(keep_pos)
                keep_pos[p_idx] = p_ok
                keep_neg[n_idx] = n_ok
                wpos = p_ok & (inds[p_idx] > 0)
                p_gt = batch.gt_boxes[i][(inds[p_idx] - 1).clamp(min=0)]
                safe = torch.where(wpos[:, None], p_gt, anchors[p_idx])
                cls_t.append(keep_pos.to(F32))
                cls_w.append((keep_pos | keep_neg).to(F32))
                box_t.append(ops.bbox2delta(anchors[p_idx], safe, coder["means"], coder["stds"]))
                box_w.append(wpos.to(F32))
                pos_idx.append(p_idx)
        w = torch.stack(cls_w)
        n = w.sum()
        l_cls = _avg((bce(flat_s, torch.stack(cls_t)) * w).sum(), n)
        d_pos = torch.gather(flat_d, 1, torch.stack(pos_idx)[..., None].expand(-1, -1, 4))
        l_box = _avg((smooth_l1(d_pos, torch.stack(box_t), c["rpn"]["loss_bbox_beta"])
                      * torch.stack(box_w)[..., None]).sum(), n)
        return l_cls, l_box

    def head_loss(self, cls, reg, smp: Sample, coder: dict, beta: float):
        w = smp.valid.to(F32)
        avg = w.sum()
        logp = torch.log_softmax(cls, -1)
        nll = -torch.gather(logp, -1, smp.labels[..., None])[..., 0]
        l_cls = _avg((nll * w).sum(), avg)
        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=reg.device)
        pos = smp.is_pos[..., None]
        tgt = ops.bbox2delta(torch.where(pos, smp.rois, unit), torch.where(pos, smp.pos_gt, unit),
                             coder["means"], coder["stds"])
        l_box = _avg((smooth_l1(reg, tgt, beta) * smp.is_pos.to(F32)[..., None]).sum(), avg)
        return l_cls, l_box

    def losses(self, batch: Batch, gen) -> Dict[str, torch.Tensor]:
        c, t = self.cfg, self.cfg["train"]
        feats = self.neck(self.backbone(batch.images.permute(0, 3, 1, 2).contiguous()))
        scores, deltas = self.rpn_head(feats)
        out: Dict[str, torch.Tensor] = {}
        out["loss_rpn_cls"], out["loss_rpn_bbox"] = self.rpn_loss(feats, scores, deltas, batch,
                                                                  gen)
        b = batch.images.shape[0]
        anchors = self.anchors(feats)
        props, pvalid = [], []
        with torch.no_grad():
            for i in range(b):
                p, v = self.proposals([s[i].detach() for s in scores],
                                      [d[i].detach() for d in deltas], anchors, batch.hws[i],
                                      t["rpn_proposal"])
                props.append(p)
                pvalid.append(v)
        n = len(c["roi_extractor"]["featmap_strides"])
        glb_logits, glb = self.global_ctx(feats[-1]) if c["with_global"] else (None, None)
        if c["with_global"]:
            onehot = F.one_hot(batch.gt_labels, c["num_classes"] + 1).to(F32) * \
                batch.gt_valid[..., None]
            targets = (onehot.sum(1) > 0).to(F32)
            out["loss_global"] = c["global_ctx"]["loss_weight"] * bce(glb_logits, targets).mean()
        nc, cap = c["num_classes"], t["rcnn_pos_cap"]
        coder0, coder1 = c["stage0_head"]["coder"], c["stage1_head"]["coder"]
        s0 = [sample(props[i], pvalid[i], batch.gt_boxes[i], batch.gt_valid[i],
                     batch.gt_labels[i], t["rcnn"][0], cap, nc, gen) for i in range(b)]
        cls0, reg0, refined = [], [], []
        for i in range(b):
            levels = [f[i].permute(1, 2, 0) for f in feats[:n]]
            cl, rg = self.stage0(self.single_extract(levels, s0[i].rois),
                                 glb[i] if glb is not None else None)
            cls0.append(cl)
            reg0.append(rg)
            hw = batch.hws[i]
            refined.append(ops.delta2bbox(s0[i].rois, rg, coder0["means"], coder0["stds"],
                                          hw).detach())
        s0b = Sample(*(torch.stack(x) for x in zip(*s0)))
        lw = t["stage_loss_weights"]
        l0c, l0b = self.head_loss(torch.stack(cls0), torch.stack(reg0), s0b, coder0,
                                  c["stage0_head"]["loss_bbox_beta"])
        out["s0.loss_cls"], out["s0.loss_bbox"] = l0c * lw[0], l0b * lw[0]
        s1 = [sample(refined[i], s0[i].valid & ~s0[i].is_gt, batch.gt_boxes[i],
                     batch.gt_valid[i], batch.gt_labels[i], t["rcnn"][1], cap, nc, gen)
              for i in range(b)]
        cls1, reg1 = [], []
        for i in range(b):
            levels = [f[i].permute(1, 2, 0) for f in feats[:n]]
            x_cls = self.single_extract(levels, s1[i].rois)
            enhanced = self.ba_extract(levels, s1[i].rois[:cap])
            cl, rg = self.stage1(x_cls, x_cls[:cap], s1[i].rois, s1[i].valid, enhanced,
                                 glb[i] if glb is not None else None)
            cls1.append(cl)
            reg1.append(torch.cat([rg, torch.zeros((cl.shape[0] - cap, 4), device=rg.device)]))
        s1b = Sample(*(torch.stack(x) for x in zip(*s1)))
        l1c, l1b = self.head_loss(torch.stack(cls1), torch.stack(reg1), s1b, coder1,
                                  c["stage1_head"]["loss_bbox_beta"])
        out["s1.loss_cls"], out["s1.loss_bbox"] = l1c * lw[1], l1b * lw[1]
        return out

    def lr(self, step: int, steps_per_epoch: int) -> float:
        """Linear warm-up from warmup_ratio, then x0.1 at each lr_steps epoch,
        in float32 at the step count before the update."""
        t = self.cfg["train"]
        f32 = np.float32
        s = f32(step)
        frac = np.clip(s / f32(max(t["warmup_iters"], 1)), f32(0.0), f32(1.0))
        lr = f32(t["lr"]) * (f32(t["warmup_ratio"]) + f32(1 - t["warmup_ratio"]) * frac)
        for e in t["lr_steps"]:
            lr = lr * (f32(0.1) if s >= e * steps_per_epoch else f32(1.0))
        return float(lr)

    def step_mean(self, batches: Sequence[Batch], gens, step: int, steps_per_epoch: int):
        """One SGD step on the mean of the batches' losses (data parallel:
        one batch and generator per rank); returns (the mean loss terms and
        "loss", {name: mean gradient})."""
        for p in self.params().values():
            p.grad = None
        terms: Dict[str, torch.Tensor] = {}
        for b, g in zip(batches, gens):
            part = self.losses(b, g)
            total = sum(v for k, v in part.items() if "loss" in k)
            (total / len(batches)).backward()
            part["loss"] = total
            for k, v in part.items():
                terms[k] = terms.get(k, 0.0) + v.detach() / len(batches)
        t = self.cfg["train"]
        lr = self.lr(step, steps_per_epoch)
        grads = {}
        with torch.no_grad():
            for k, p in self.params().items():
                if p.grad is None:              # as torch's SGD, which skips such tensors
                    continue
                g = p.grad
                grads[k] = g.clone()
                d = g + t["weight_decay"] * p
                buf = self.momentum.get(k)
                buf = d.clone() if buf is None else buf.mul_(t["momentum"]).add_(d)
                self.momentum[k] = buf
                p.sub_(lr * buf)
        return terms, grads
