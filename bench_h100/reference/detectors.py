"""The plain reference of DetectoRS ResNet-50 under HTD's heads: the
backbone and neck of mmdetection v2.7.0's DetectoRS (Qiao, Chen and Yuille,
arXiv:2006.02334; `configs/detectors/detectors_cascade_rcnn_r50_1x_coco.py`:
`DetectoRS_ResNet` and the `RFP` neck, mmcv 1.2's `ConvAWS2d` and
`SAConv2d`) with HTD R-50 1x's RPN, heads and test settings, which
`detector.Reference` computes.

Float32 PyTorch over a state dict under mmdet's names; no kernel, no cache,
one image at a time. It imports nothing of the program under test. Its
equations (NCHW; `mean_hw` the mean over H and W):

    ConvAWS (every conv of both backbones but SAC's):
      w_hat = gamma * (w - mean_o(w)) / sqrt(var_o(w) + 1e-5) + beta,
      per output channel over Cin * kh * kw entries, unbiased variance
    SAC (conv2 of every bottleneck of the stages in stage_with_sac):
      x = x + pre_context(mean_hw(x));  a = avg_pool5x5(reflect_pad2(x))
      s = switch(a)                     (1x1 C -> 1, the conv's stride, no sigmoid)
      y = s * dcn(x, offset_s(a), w_hat, dil 1) + (1 - s) * dcn(x, offset_l(a),
          w_hat + weight_diff, dil 3, pad 3)
      y = y + post_context(mean_hw(y))
    bottleneck: relu(bn3(conv3(...)) + identity [+ rfp_conv(r) in block 0 of
      layer2-4 of a further backbone])
    ASPP(P): cat[relu(c1x1(P)), relu(c3x3 d3(P)), relu(c3x3 d6(P)),
      relu(c1x1(mean_hw(P))) broadcast]
    RFP, rfp_steps 2: F = FPN(B1(img)); r = ASPP(P3), ASPP(P4), ASPP(P5);
      F2 = FPN(B2(img, r)), the same FPN weights; out_l = g * F2_l + (1 - g) * F_l,
      g = sigmoid(rfp_weight(F2_l)) on all five levels.

Departures from mmdet, shared with the program: the means over H and W
(SAC's contexts, ASPP's image branch, as HTD's SFA head's) are taken over
the whole padded bucket, not mmdet's pad to 32; ASPP(P6), which mmdet
computes and nothing reads, is not computed.

`param_shapes(cfg)` lists every tensor the architecture holds.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import detector, ops
from bench_h100.reference.detector import BLOCKS, Reference
from bench_h100.reference.ops import F32, Precision


ASPP_OUT = 64                  # mmdet RFP's ASPP as DetectoRS sets it: 4 x 64 channels
ASPP_DILATIONS = (1, 3, 6, 1)


def backbones(cfg) -> List[str]:
    """The state-dict prefixes of the backbones, in the order they run."""
    return ["backbone"] + [f"neck.rfp_modules.{k}" for k in range(cfg["fpn"]["rfp_steps"] - 1)]


def sac_convs(cfg) -> List[Tuple[str, int, int]]:
    """(name, channels, stride) of every switchable atrous conv, in the
    order they run: the first backbone's, then each further one's."""
    bb = cfg["backbone"]
    out = []
    for prefix in backbones(cfg):
        planes = bb["base_planes"]
        for s, n in enumerate(BLOCKS[bb["depth"]]):
            for i in range(n):
                if bb["stage_with_sac"][s]:
                    stride = (1 if s == 0 else 2) if i == 0 else 1
                    out.append((f"{prefix}.layer{s + 1}.{i}.conv2", planes, stride))
            planes *= 2
    return out


def aws_convs(shapes) -> List[str]:
    """The convs of the backbones among `shapes` that ConvAWS may
    standardise: all but the `rfp_conv`s and the convs inside a SAC."""
    out = []
    for name, (shape, _) in shapes.items():
        if not name.endswith(".weight") or len(shape) != 4:
            continue
        if not name.startswith(("backbone.", "neck.rfp_modules.")):
            continue
        conv = name[:-len(".weight")]
        if conv.endswith(("rfp_conv", "switch", "pre_context", "post_context", "offset_s",
                          "offset_l")):
            continue
        out.append(conv)
    return out


def param_shapes(cfg) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """name -> (shape, kind) for every tensor. The kinds of
    `detector.param_shapes` (HTD R-50: the first backbone, FPN, RPN, heads),
    and: aws_gamma / aws_beta (ConvAWS's buffers), sac_diff, sac_switch,
    sac_switch_bias, context (SAC's pre and post contexts), sac_offset,
    rfp_conv, rfp_weight; a further backbone's tensors take the first
    one's kinds."""
    bb, fo = cfg["backbone"], cfg["fpn"]["out_channels"]
    base = detector.param_shapes(cfg)
    sd: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()
    sd.update(base)
    first = [(k, v) for k, v in base.items() if k.startswith("backbone.")]
    fed = len(ASPP_DILATIONS) * ASPP_OUT
    for prefix in backbones(cfg)[1:]:
        for k, v in first:
            sd[prefix + k[len("backbone"):]] = v
        planes = bb["base_planes"] * 2
        for s in (1, 2, 3):
            sd[f"{prefix}.layer{s + 1}.0.rfp_conv.weight"] = ((planes * 4, fed, 1, 1), "rfp_conv")
            sd[f"{prefix}.layer{s + 1}.0.rfp_conv.bias"] = ((planes * 4,), "zero")
            planes *= 2
    for name, c, _ in sac_convs(cfg):
        sd[name + ".weight_diff"] = ((c, c, 3, 3), "sac_diff")
        sd[name + ".switch.weight"] = ((1, c, 1, 1), "sac_switch")
        sd[name + ".switch.bias"] = ((1,), "sac_switch_bias")
        for ctx in ("pre_context", "post_context"):
            sd[f"{name}.{ctx}.weight"] = ((c, c, 1, 1), "context")
            sd[f"{name}.{ctx}.bias"] = ((c,), "zero")
        for off in ("offset_s", "offset_l"):
            sd[f"{name}.{off}.weight"] = ((18, c, 3, 3), "sac_offset")
            sd[f"{name}.{off}.bias"] = ((18,), "zero")
    sac = {name for name, _, _ in sac_convs(cfg)}
    for conv in aws_convs(sd):
        if bb["conv_aws"] or conv in sac:                # a SAC conv is a ConvAWS conv
            cout = sd[conv + ".weight"][0][0]
            sd[conv + ".weight_gamma"] = ((cout, 1, 1, 1), "aws_gamma")
            sd[conv + ".weight_beta"] = ((cout, 1, 1, 1), "aws_beta")
    if cfg["fpn"]["rfp_steps"] > 1:
        for i, d in enumerate(ASPP_DILATIONS):
            k = 3 if d > 1 else 1
            sd[f"neck.rfp_aspp.aspp.{i}.weight"] = ((ASPP_OUT, fo, k, k), "conv")
            sd[f"neck.rfp_aspp.aspp.{i}.bias"] = ((ASPP_OUT,), "zero")
        sd["neck.rfp_weight.weight"] = ((1, fo, 1, 1), "rfp_weight")
        sd["neck.rfp_weight.bias"] = ((1,), "zero")
    return sd


def conv2d(x, w, b, prec: Precision, stride: int = 1, padding: int = 0, dilation: int = 1):
    """`ops.conv2d` with a dilation."""
    y = F.conv2d(prec.operand(x), prec.operand(w), b, stride=stride, padding=padding,
                 dilation=dilation)
    return prec.result(y)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, stride: int,
                dilation: int, prec: Precision) -> torch.Tensor:
    """mmcv's deform_conv2d (DCNv1), 3x3, one group and one deform group,
    padding = dilation: x (N, C, H, W), offsets (N, 18, Ho, Wo) ordered
    [tap][(y, x)], weight (Cout, C, 3, 3) -> (N, Cout, Ho, Wo). Tap (ky, kx)
    of output (i, j) samples base (i * stride - dilation + ky * dilation,
    j * stride - dilation + kx * dilation) plus its offset, bilinear with
    zero outside the map (a sample counts when -1 < y < H and -1 < x < W,
    each corner only inside)."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    ho, wo = offsets.shape[2], offsets.shape[3]
    dev = x.device
    off = offsets.permute(0, 2, 3, 1).reshape(n, ho, wo, 9, 2).to(F32)
    iy = torch.arange(ho, device=dev) * stride - dilation
    ix = torch.arange(wo, device=dev) * stride - dilation
    k = torch.arange(3, device=dev) * dilation
    by = (iy.view(ho, 1, 1, 1) + k.view(1, 1, 3, 1)).expand(ho, wo, 3, 3).reshape(1, ho, wo, 9)
    bx = (ix.view(1, wo, 1, 1) + k.view(1, 1, 1, 3)).expand(ho, wo, 3, 3).reshape(1, ho, wo, 9)
    ys = by.to(F32) + off[..., 0]
    xs = bx.to(F32) + off[..., 1]
    feat = x.permute(0, 2, 3, 1).reshape(n, h * w, cin)
    img = torch.arange(n, device=dev).view(n, 1)
    inside = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    col = 0
    for cy in (0, 1):
        for cx in (0, 1):
            yi, xi = y0.long() + cy, x0.long() + cx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & inside
            wgt = torch.where(ok, (ly if cy else 1 - ly) * (lx if cx else 1 - lx),
                              torch.zeros_like(ly))
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
            v = feat[img, idx].reshape(n, ho, wo, 9, cin)
            col = col + v * wgt[..., None]
    wk = weight.reshape(cout, cin, 9).permute(2, 1, 0)                  # (9, Cin, Cout)
    res = torch.einsum("nhwkc,kco->nhwo", prec.operand(col), prec.operand(wk))
    return prec.result(res).permute(0, 3, 1, 2)


class DetectorsReference(Reference):
    """HTD with DetectoRS's backbones and RFP neck over a state dict `sd`
    (float32 tensors on one device), in `precision` (see `ops.Precision`).
    Where `sac_rms` is a list, each SAC conv appends the rms of its 5x5
    average `a` (what its offset convs and switch read) in turn."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], precision: str = "float32"):
        super().__init__(cfg, sd, precision)
        self.sac_rms: Optional[List[float]] = None

    # -- building blocks ---------------------------------------------------

    def aws_weight(self, name: str) -> torch.Tensor:
        sd = self.sd
        w = sd[name + ".weight"]
        if name + ".weight_gamma" not in sd:
            return w
        flat = w.flatten(1)
        mean = flat.mean(1).view(-1, 1, 1, 1)
        std = torch.sqrt(flat.var(1) + 1e-5).view(-1, 1, 1, 1)
        return sd[name + ".weight_gamma"] * (w - mean) / std + sd[name + ".weight_beta"]

    def _conv_aws(self, x, name, stride=1):
        w = self.aws_weight(name)
        return ops.conv2d(x, w, None, self.prec, stride, (w.shape[-1] - 1) // 2)

    def sac(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        x = x + self._conv(x.mean((2, 3), keepdim=True), name + ".pre_context")
        a = F.avg_pool2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), 5, 1)
        if self.sac_rms is not None:
            self.sac_rms.append(float(a.square().mean().sqrt()))
        switch = self._conv(a, name + ".switch", stride)
        w_s = self.aws_weight(name)
        w_l = w_s + self.sd[name + ".weight_diff"]
        out_s = deform_conv(x, self._conv(a, name + ".offset_s", stride), w_s, stride, 1,
                            self.prec)
        out_l = deform_conv(x, self._conv(a, name + ".offset_l", stride), w_l, stride, 3,
                            self.prec)
        y = switch * out_s + (1 - switch) * out_l
        return y + self._conv(y.mean((2, 3), keepdim=True), name + ".post_context")

    def resnet(self, x: torch.Tensor, prefix: str,
               fed: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """(N, 3, H, W) -> C2..C5 of the backbone under `prefix`; `fed`, the
        features fed back to layer2-4's block 0 (`rfp_forward`)."""
        bb = self.cfg["backbone"]
        x = F.relu(self._bn(self._conv_aws(x, prefix + ".conv1", 2), prefix + ".bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s, n in enumerate(BLOCKS[bb["depth"]]):
            for i in range(n):
                p = f"{prefix}.layer{s + 1}.{i}"
                stride = (1 if s == 0 else 2) if i == 0 else 1
                y = F.relu(self._bn(self._conv_aws(x, p + ".conv1"), p + ".bn1"))
                if bb["stage_with_sac"][s]:
                    y = self.sac(y, p + ".conv2", stride)
                else:
                    y = self._conv_aws(y, p + ".conv2", stride)
                y = F.relu(self._bn(y, p + ".bn2"))
                y = self._bn(self._conv_aws(y, p + ".conv3"), p + ".bn3")
                idn = x if i else self._bn(self._conv_aws(x, p + ".downsample.0", stride),
                                           p + ".downsample.1")
                out = y + idn
                if fed is not None and s and not i:
                    out = out + self._conv(fed[s - 1], p + ".rfp_conv")
                x = F.relu(out)
            outs.append(x)
        return outs

    def aspp(self, p: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, d in enumerate(ASPP_DILATIONS):
            name = f"neck.rfp_aspp.aspp.{i}"
            inp = p.mean((2, 3), keepdim=True) if i == len(ASPP_DILATIONS) - 1 else p
            outs.append(F.relu(conv2d(inp, self.sd[name + ".weight"], self.sd[name + ".bias"],
                                      self.prec, 1, d if d > 1 else 0, d)))
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, 1)

    def rfp(self, cs: List[torch.Tensor], img: torch.Tensor) -> List[torch.Tensor]:
        """The recursive feature pyramid over the first backbone's C2..C5."""
        f = self.neck(cs)
        for prefix in backbones(self.cfg)[1:]:
            fed = [self.aspp(f[i]) for i in (1, 2, 3)]
            f2 = self.neck(self.resnet(img, prefix, fed))
            gates = [torch.sigmoid(self._conv(t, "neck.rfp_weight")) for t in f2]
            f = [g * new + (1 - g) * old for g, new, old in zip(gates, f2, f)]
        return f

    # -- inference ------------------------------------------------------------

    def backbone(self, x):
        return self.resnet(x, "backbone")

    def features(self, image_hwc: torch.Tensor):
        x = image_hwc.permute(2, 0, 1)[None].contiguous()
        return self.rfp(self.backbone(x), x)

    def sac_input_rms(self, img_bgr: np.ndarray) -> List[float]:
        """The rms of each SAC conv's 5x5 average on one image at the test
        scale (the calibration of the configuration file's `assumed`
        offset and switch stds)."""
        c = self.cfg
        dev = next(iter(self.sd.values())).device
        image, _, _ = ops.preprocess(img_bgr, c["test_scale"],
                                     ops.bucket_shape(c["test_scale"], True), dev)
        self.sac_rms = []
        try:
            with torch.no_grad():
                self.features(image)
            return self.sac_rms
        finally:
            self.sac_rms = None
