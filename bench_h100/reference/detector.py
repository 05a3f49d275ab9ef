"""The plain reference of HTD (CityU-AIM-Group/HTD): a two-stage detector
with a ResNet(-DCN)-FPN backbone, an RPN, the SFA global-context head, a
Shared2FC stage 0, and stage 1's PGraph classification and BA regression.

Written from the published configs and the mmdet/mmcv semantics in
float32 PyTorch, over a state dict under mmdet's names; no kernel, no
cache, no batching (one image at a time). It imports nothing of the
program under test. `param_shapes(cfg)` lists every tensor the
architecture holds, which is what the benchmark draws its weights for.

The configuration is the plain dict of the benchmark's configuration file
(`config`): the published sizes and test and train settings.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import ops
from bench_h100.reference.ops import F32, Precision

BLOCKS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _bottleneck_width(cfg, planes: int) -> int:
    bb = cfg["backbone"]
    g = bb["groups"]
    return planes if g == 1 else planes * bb["base_width"] * g // 64


def dcn_convs(cfg) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, stride, stage) of every deformable conv, in order."""
    bb = cfg["backbone"]
    out, planes = [], bb["base_planes"]
    for s, n in enumerate(BLOCKS[bb["depth"]]):
        for i in range(n):
            if bb["stage_with_dcn"][s]:
                stride = (1 if s == 0 else 2) if i == 0 else 1
                out.append((f"backbone.layer{s + 1}.{i}.conv2", _bottleneck_width(cfg, planes),
                            stride, s))
        planes *= 2
    return out


def param_shapes(cfg) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """name -> (shape, kind) for every tensor of the architecture. Kinds:
    conv (kaiming fan-out), dcn_offset, linear (xavier uniform), small
    (normal 0.01), tiny (normal 0.001), zero, one, bn_scale, bn3_scale."""
    bb, c = cfg["backbone"], cfg
    sd: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()

    def bn(p, ch, last=False):
        sd[p + ".weight"] = ((ch,), "bn3_scale" if last else "one")
        sd[p + ".bias"] = ((ch,), "zero")
        sd[p + ".running_mean"] = ((ch,), "zero")
        sd[p + ".running_var"] = ((ch,), "one")

    base = bb["base_planes"]
    sd["backbone.conv1.weight"] = ((base, 3, 7, 7), "conv")
    bn("backbone.bn1", base)
    cin, planes = base, base
    for s, n in enumerate(BLOCKS[bb["depth"]]):
        for i in range(n):
            p = f"backbone.layer{s + 1}.{i}"
            width, cout = _bottleneck_width(cfg, planes), planes * 4
            sd[p + ".conv1.weight"] = ((width, cin, 1, 1), "conv")
            bn(p + ".bn1", width)
            sd[p + ".conv2.weight"] = ((width, width // bb["groups"], 3, 3), "conv")
            if bb["stage_with_dcn"][s]:
                sd[p + ".conv2.conv_offset.weight"] = ((bb["dcn_deform_groups"] * 18, width, 3, 3),
                                                       "dcn_offset")
                sd[p + ".conv2.conv_offset.bias"] = ((bb["dcn_deform_groups"] * 18,), "zero")
            bn(p + ".bn2", width)
            sd[p + ".conv3.weight"] = ((cout, width, 1, 1), "conv")
            bn(p + ".bn3", cout, last=True)
            if i == 0:
                sd[p + ".downsample.0.weight"] = ((cout, cin, 1, 1), "conv")
                bn(p + ".downsample.1", cout)
            cin = cout
        planes *= 2
    fo = c["fpn"]["out_channels"]
    for i, ch in enumerate(c["fpn"]["in_channels"]):
        sd[f"neck.lateral_convs.{i}.conv.weight"] = ((fo, ch, 1, 1), "conv")
        sd[f"neck.lateral_convs.{i}.conv.bias"] = ((fo,), "zero")
        sd[f"neck.fpn_convs.{i}.conv.weight"] = ((fo, fo, 3, 3), "conv")
        sd[f"neck.fpn_convs.{i}.conv.bias"] = ((fo,), "zero")
    r = c["rpn"]
    na = len(r["anchor"]["ratios"]) * len(r["anchor"]["scales"])
    sd["rpn_head.rpn_conv.weight"] = ((r["feat_channels"], r["in_channels"], 3, 3), "small")
    sd["rpn_head.rpn_conv.bias"] = ((r["feat_channels"],), "zero")
    sd["rpn_head.rpn_cls.weight"] = ((na, r["feat_channels"], 1, 1), "small")
    sd["rpn_head.rpn_cls.bias"] = ((na,), "zero")
    sd["rpn_head.rpn_reg.weight"] = ((4 * na, r["feat_channels"], 1, 1), "small")
    sd["rpn_head.rpn_reg.bias"] = ((4 * na,), "zero")
    nc1 = c["num_classes"] + 1
    if c["with_global"]:
        g = c["global_ctx"]
        for i in range(g["num_convs"]):
            ci = g["in_channels"] if i == 0 else g["conv_out_channels"]
            sd[f"roi_head.glbctx_head.convs.{i}.conv.weight"] = (
                (g["conv_out_channels"], ci, 3, 3), "conv")
            sd[f"roi_head.glbctx_head.convs.{i}.conv.bias"] = ((g["conv_out_channels"],), "zero")
        sd["roi_head.glbctx_head.fc.weight"] = ((nc1, g["conv_out_channels"]), "small")
        sd["roi_head.glbctx_head.fc.bias"] = ((nc1,), "zero")
    h0 = c["stage0_head"]
    flat = h0["in_channels"] * h0["roi_feat_size"] ** 2
    f0 = h0["fc_out_channels"]

    def fc(p, o, i, kind="linear"):
        sd[p + ".weight"] = ((o, i), kind)
        sd[p + ".bias"] = ((o,), "zero")

    fc("roi_head.bbox_head.0.shared_fcs.0", f0, flat)
    fc("roi_head.bbox_head.0.shared_fcs.1", f0, f0)
    fc("roi_head.bbox_head.0.fc_cls", nc1, f0, "small")
    fc("roi_head.bbox_head.0.fc_reg", 4, f0, "tiny")
    h1 = c["stage1_head"]
    f1 = h1["fc_out_channels"]
    fc("roi_head.bbox_head.1.fcs.0", f1, h1["in_channels"] * h1["roi_feat_size"] ** 2)
    fc("roi_head.bbox_head.1.fcs.2", f1, f1)
    fc("roi_head.bbox_head.1.fc_cls", nc1, f1, "small")
    fc("roi_head.bbox_head.1.fc_reg", 4, h1["reg_out_channels"], "tiny")
    for k in range(len(c["roi_extractor"]["featmap_strides"])):
        fc(f"roi_head.bbox_head.1.graph_lvl{k}_cls", f1, f1)
    for i in range(h1["num_reg_convs"]):
        ci = h1["in_channels"] if i == 0 else h1["reg_mid_channels"]
        last = i == h1["num_reg_convs"] - 1
        co = h1["reg_out_channels"] if last else h1["reg_mid_channels"]
        sd[f"roi_head.bbox_head.1.convs.{i}.conv.weight"] = ((co, ci, 3, 3), "conv")
        if not last:
            sd[f"roi_head.bbox_head.1.convs.{i}.gn.weight"] = ((co,), "one")
            sd[f"roi_head.bbox_head.1.convs.{i}.gn.bias"] = ((co,), "zero")
    sd["roi_head.bbox_roi_extractor.1.conv1.weight"] = ((128, fo, 1, 1), "conv")
    sd["roi_head.bbox_roi_extractor.1.conv1.bias"] = ((128,), "zero")
    sd["roi_head.bbox_roi_extractor.1.conv2.weight"] = ((1, 128, 1, 1), "conv")
    sd["roi_head.bbox_roi_extractor.1.conv2.bias"] = ((1,), "zero")
    return sd


def trainable(name: str, cfg) -> bool:
    """mmdet frozen_stages: the stem and stages [0, frozen_stages) are frozen;
    BN statistics are buffers."""
    if name.endswith(("running_mean", "running_var")):
        return False
    frozen = ["backbone.conv1.", "backbone.bn1."] + [
        f"backbone.layer{s + 1}." for s in range(cfg["backbone"]["frozen_stages"])]
    return not name.startswith(tuple(frozen))


class Reference:
    """HTD over a state dict `sd` (float32 tensors on one device), in
    `precision` ("float32" is the reference; see `ops.Precision`)."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], precision: str = "float32"):
        self.cfg = cfg
        self.sd = sd
        self.prec = Precision(precision)

    # -- building blocks ---------------------------------------------------

    def _conv(self, x, name, stride=1, padding=None, groups=1):
        w = self.sd[name + ".weight"]
        b = self.sd.get(name + ".bias")
        pad = (w.shape[-1] - 1) // 2 if padding is None else padding
        return ops.conv2d(x, w, b, self.prec, stride, pad, groups)

    def _bn(self, x, name):
        sd = self.sd
        mul = sd[name + ".weight"] * torch.rsqrt(sd[name + ".running_var"] + 1e-5)
        add = sd[name + ".bias"] - sd[name + ".running_mean"] * mul
        return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)

    def _linear(self, x, name):
        return ops.linear(x, self.sd[name + ".weight"], self.sd[name + ".bias"], self.prec)

    # -- backbone, neck, RPN -------------------------------------------------

    def backbone(self, x):
        """(N, 3, H, W) -> C2..C5."""
        bb = self.cfg["backbone"]
        x = F.relu(self._bn(self._conv(x, "backbone.conv1", 2, 3), "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s, n in enumerate(BLOCKS[bb["depth"]]):
            for i in range(n):
                p = f"backbone.layer{s + 1}.{i}"
                stride = (1 if s == 0 else 2) if i == 0 else 1
                y = F.relu(self._bn(self._conv(x, p + ".conv1"), p + ".bn1"))
                if bb["stage_with_dcn"][s]:
                    off = self._conv(y, p + ".conv2.conv_offset", stride)
                    y = ops.deform_conv(y, off, self.sd[p + ".conv2.weight"], stride, self.prec,
                                        bb["groups"], bb["dcn_deform_groups"])
                else:
                    y = self._conv(y, p + ".conv2", stride, 1, bb["groups"])
                y = F.relu(self._bn(y, p + ".bn2"))
                y = self._bn(self._conv(y, p + ".conv3"), p + ".bn3")
                idn = x if i else self._bn(self._conv(x, p + ".downsample.0", stride),
                                           p + ".downsample.1")
                x = F.relu(y + idn)
            outs.append(x)
        return outs

    def neck(self, cs):
        lat = [self._conv(x, f"neck.lateral_convs.{i}.conv") for i, x in enumerate(cs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[-2:],
                                                    mode="nearest-exact")
        outs = [self._conv(x, f"neck.fpn_convs.{i}.conv") for i, x in enumerate(lat)]
        for _ in range(self.cfg["fpn"]["num_outs"] - len(outs)):
            outs.append(F.max_pool2d(outs[-1], 1, 2, 0))
        return outs

    def rpn_head(self, feats):
        scores, deltas = [], []
        for f in feats:
            t = F.relu(self._conv(f, "rpn_head.rpn_conv"))
            scores.append(self._conv(t, "rpn_head.rpn_cls").permute(0, 2, 3, 1))
            deltas.append(self._conv(t, "rpn_head.rpn_reg").permute(0, 2, 3, 1))
        return scores, deltas

    def anchors(self, feats):
        a = self.cfg["rpn"]["anchor"]
        return [ops.grid_anchors(st, a["ratios"], a["scales"], f.shape[-2], f.shape[-1], f.device)
                for st, f in zip(a["strides"], feats)]

    def proposals(self, scores, deltas, anchors, hw, pcfg):
        """One image's proposals: per level the nms_pre best anchors in the
        pad region, decoded and clipped, then level-aware NMS -> (P, 4)
        boxes and (P,) validity, P = nms_post."""
        a = self.cfg["rpn"]["anchor"]
        na = len(a["ratios"]) * len(a["scales"])
        pad_h, pad_w = ops.ceil32(hw[0]), ops.ceil32(hw[1])
        cb, cs, ci = [], [], []
        for lvl, (s, d, anc) in enumerate(zip(scores, deltas, anchors)):
            fh, fw = s.shape[0], s.shape[1]
            prob = torch.sigmoid(s.reshape(-1))
            ok = ops.anchor_valid(a["strides"][lvl], fh, fw, na, pad_h, pad_w, s.device)
            prob = torch.where(ok, prob, torch.full_like(prob, ops.NEG_INF))
            k = min(pcfg["nms_pre"], prob.shape[0])
            top = torch.sort(prob, descending=True, stable=True)
            ts, ti = top.values[:k], top.indices[:k]
            boxes = ops.delta2bbox(anc[ti], d.reshape(-1, 4)[ti], max_hw=hw)
            cb.append(boxes)
            cs.append(ts)
            ci.append(torch.full((k,), lvl, device=s.device))
        boxes, sc, ids = torch.cat(cb), torch.cat(cs), torch.cat(ci)
        if pcfg["min_bbox_size"] > 0:
            wh_ok = ((boxes[:, 2] - boxes[:, 0]) >= pcfg["min_bbox_size"]) & \
                ((boxes[:, 3] - boxes[:, 1]) >= pcfg["min_bbox_size"])
            sc = torch.where(wh_ok, sc, torch.full_like(sc, ops.NEG_INF))
        keep, _, valid = ops.nms(ops.offset_by_class(boxes, sc, ids), sc, pcfg["nms_thr"],
                                 pcfg["nms_post"])
        return torch.where(valid[:, None], boxes[keep], 0.0), valid

    # -- RoI heads -------------------------------------------------------------

    def global_ctx(self, top):
        g = self.cfg["global_ctx"]
        x = top
        for i in range(g["num_convs"]):
            x = F.relu(self._conv(x, f"roi_head.glbctx_head.convs.{i}.conv"))
        pooled = x.mean(dim=(2, 3))
        return self._linear(pooled, "roi_head.glbctx_head.fc"), pooled

    def _levels_hwc(self, feats):
        n = len(self.cfg["roi_extractor"]["featmap_strides"])
        return [f[0].permute(1, 2, 0) for f in feats[:n]]

    def single_extract(self, levels, rois):
        e = self.cfg["roi_extractor"]
        lv = ops.roi_levels(rois, len(e["featmap_strides"]), e["finest_scale"])
        return ops.roi_align_mapped(levels, rois, lv, e["featmap_strides"], e["out_size"],
                                    e["max_samples"])

    def ba_extract(self, levels, rois, own_feats=None):
        """The BA extractor: every level at adpt_max_samples (each roi's own
        level replaced by `own_feats` when given), level attention, the
        weighted sum plus the finest level's border ring."""
        e = self.cfg["roi_extractor"]
        aligned = torch.stack([ops.roi_align(f, rois, st, e["out_size"], e["adpt_max_samples"])
                               for f, st in zip(levels, e["featmap_strides"])])
        if own_feats is not None:
            lv = ops.roi_levels(rois, len(levels), e["finest_scale"])
            sel = lv[None] == torch.arange(len(levels), device=rois.device)[:, None]
            aligned = torch.where(sel[..., None, None, None], own_feats[None], aligned)
        pooled = aligned.mean(dim=(2, 3))                                  # (L, R, C)
        sd = self.sd
        h = torch.tanh(ops.linear(pooled, sd["roi_head.bbox_roi_extractor.1.conv1.weight"]
                                  .flatten(1), sd["roi_head.bbox_roi_extractor.1.conv1.bias"],
                                  self.prec))
        a = ops.linear(h, sd["roi_head.bbox_roi_extractor.1.conv2.weight"].flatten(1),
                       sd["roi_head.bbox_roi_extractor.1.conv2.bias"], self.prec)[..., 0]
        att = torch.softmax(a, dim=0)
        fused = torch.einsum("lrhwc,lr->rhwc", aligned, att)
        return fused + aligned[0] * self._ring(e["adpt_edge"], e["out_size"], rois.device)

    @staticmethod
    def _ring(edge, size, device):
        ys = torch.arange(size, device=device)
        b = (ys < edge) | (ys >= size - edge)
        return (b[:, None] | b[None, :]).to(F32)[None, :, :, None]

    @staticmethod
    def _flat(x):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)   # CHW flatten per roi

    def stage0(self, roi_feats, glb):
        if glb is not None:
            roi_feats = roi_feats + glb[None, None, None, :]
        x = self._flat(roi_feats)
        x = F.relu(self._linear(x, "roi_head.bbox_head.0.shared_fcs.0"))
        x = F.relu(self._linear(x, "roi_head.bbox_head.0.shared_fcs.1"))
        return self._linear(x, "roi_head.bbox_head.0.fc_cls"), \
            self._linear(x, "roi_head.bbox_head.0.fc_reg")

    def _fcs1(self, x):
        x = F.relu(self._linear(self._flat(x), "roi_head.bbox_head.1.fcs.0"))
        return F.relu(self._linear(x, "roi_head.bbox_head.1.fcs.2"))

    def stage1(self, x_cls, x_reg, rois, valid, enhanced, glb):
        """PGraph classification over all rois and BA regression over the
        rois of x_reg: -> (R, C+1) logits, (P, 4) deltas."""
        h = self.cfg["stage1_head"]
        sd, p = self.sd, "roi_head.bbox_head.1"
        o = h["roi_feat_size"]
        # regression: context, border-enhanced features, GN conv stack, pooling
        xr = x_reg if glb is None else x_reg + glb[None, None, None, :]
        if h["replace_mode"]:
            xr = xr * (1.0 - self._ring(h["edge"], o, rois.device)) + h["alpha"] * enhanced
        elif h["average_mode"]:
            raise NotImplementedError("average_mode is not in the published configs")
        else:
            xr = xr + h["alpha"] * enhanced
        t = xr.permute(0, 3, 1, 2)
        for i in range(h["num_reg_convs"]):
            t = self._conv(t, f"{p}.convs.{i}.conv")
            if f"{p}.convs.{i}.gn.weight" in sd:
                t = F.group_norm(t, h["gn_groups"], sd[f"{p}.convs.{i}.gn.weight"],
                                 sd[f"{p}.convs.{i}.gn.bias"], 1e-5)
            t = F.relu(t)
        deltas = self._linear(t.mean(dim=(2, 3)), f"{p}.fc_reg")
        # classification: PGraph over the rois of each level
        x_plain = self._fcs1(x_cls)
        x_base = x_plain if glb is None else self._fcs1(x_cls + glb[None, None, None, :])
        w0, b0 = sd["roi_head.bbox_head.0.fc_cls.weight"], sd["roi_head.bbox_head.0.fc_cls.bias"]
        proto = torch.cat([w0, b0[:, None]], 1).detach()
        sam = ops.matmul(torch.softmax(ops.linear(x_plain, w0, b0, self.prec), -1), proto,
                         self.prec)
        lv = ops.roi_levels(rois, len(self.cfg["roi_extractor"]["featmap_strides"]))
        r = rois.shape[0]
        eye = torch.eye(r, dtype=torch.bool, device=rois.device)
        group = ((lv[:, None] == lv[None, :]) & valid[:, None] & valid[None, :]) | eye
        adj = ((ops.box_iou(rois, rois) > 0) | eye) & group
        deg = adj.to(F32).sum(-1)
        dinv = torch.rsqrt(deg.clamp(min=1e-12))
        a_local = adj.to(F32) * dinv[:, None] * dinv[None, :]
        mixed = ops.matmul(a_local, x_plain, self.prec)
        sim = ops.matmul(sam, sam.t(), self.prec)
        score = torch.where(adj, torch.zeros_like(sim), sim)
        score = torch.where(group, score, torch.full_like(sim, ops.NEG_INF))
        mixed = ops.matmul(torch.softmax(score, -1), mixed, self.prec)
        refined = torch.zeros_like(mixed)
        for k in range(len(self.cfg["roi_extractor"]["featmap_strides"])):
            sel = torch.nonzero(lv == k)[:, 0]
            if sel.numel():
                y = F.relu(self._linear(mixed[sel], f"{p}.graph_lvl{k}_cls"))
                refined = refined.index_put((sel,), y)
        refined = refined * valid[:, None].to(F32)
        return self._linear(x_base + refined, f"{p}.fc_cls"), deltas

    # -- inference ------------------------------------------------------------

    def features(self, image_hwc: torch.Tensor):
        x = image_hwc.permute(2, 0, 1)[None].contiguous()
        return self.neck(self.backbone(x))

    @torch.no_grad()
    def detect(self, img_bgr: np.ndarray):
        """One image -> its detections with the config's test settings and
        with `relaxed` ones (half score_thr, three times max_per_img), each
        (boxes (k, 4), scores (k,), labels (k,)) numpy in the original
        image's frame."""
        c = self.cfg
        dev = next(iter(self.sd.values())).device
        scale = c["test_scale"]
        landscape = img_bgr.shape[1] >= img_bgr.shape[0]
        image, hw, sf = ops.preprocess(img_bgr, scale, ops.bucket_shape(scale, landscape), dev)
        feats = self.features(image)
        scores, deltas = self.rpn_head(feats)
        props, valid = self.proposals([s[0] for s in scores], [d[0] for d in deltas],
                                      self.anchors(feats), hw, c["proposal_test"])
        levels = self._levels_hwc(feats)
        glb = self.global_ctx(feats[-1])[1][0] if c["with_global"] else None
        s0_cls, s0_reg = self.stage0(self.single_extract(levels, props), glb)
        coder0 = c["stage0_head"]["coder"]
        rois1 = ops.delta2bbox(props, s0_reg, coder0["means"], coder0["stds"], hw)
        x_cls = self.single_extract(levels, rois1)
        enhanced = self.ba_extract(levels, rois1, x_cls)
        s1_cls, s1_reg = self.stage1(x_cls, x_cls, rois1, valid, enhanced, glb)
        probs = torch.softmax((s0_cls + s1_cls) / 2.0, -1)
        probs = torch.where(valid[:, None], probs, 0.0)
        coder1 = c["stage1_head"]["coder"]
        boxes = ops.delta2bbox(rois1, s1_reg, coder1["means"], coder1["stds"], hw)
        boxes = boxes / torch.tensor(sf, dtype=F32, device=dev)
        t = c["rcnn_test"]
        out = []
        for thr, cap in ((t["score_thr"], t["max_per_img"]),
                         (t["score_thr"] / 2, 3 * t["max_per_img"])):
            b, s, lab = ops.multiclass_nms(boxes, probs, thr, t["nms_iou"], cap,
                                           t["use_soft_nms"], t["soft_min_score"])
            out.append((b.cpu().numpy(), s.cpu().numpy(), lab.cpu().numpy()))
        return tuple(out)

    def dcn_input_rms(self, img_bgr: np.ndarray) -> List[float]:
        """The rms of each deformable conv's input on one image (the offset
        calibration of the configuration file's `assumed` stds)."""
        c = self.cfg
        dev = next(iter(self.sd.values())).device
        image, _, _ = ops.preprocess(img_bgr, c["test_scale"],
                                     ops.bucket_shape(c["test_scale"], True), dev)
        rms = []
        orig = ops.deform_conv

        def spy(x, *args, **kw):
            rms.append(float(x.square().mean().sqrt()))
            return orig(x, *args, **kw)

        ops.deform_conv = spy
        try:
            with torch.no_grad():
                self.backbone(image.permute(2, 0, 1)[None].contiguous())
        finally:
            ops.deform_conv = orig
        return rms
