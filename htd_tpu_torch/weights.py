"""Weights for the port: the JAX package's variables as an mmdet-named
state dict, and seeded random initialisation.

`state_dict_from_flax` inverts the JAX package's
`convert_mmdet_state_dict` (`htd_tpu/train/checkpoint.py`): HWIO conv
kernels become OIHW (grouped (3, 3, Cin/g, Cout) kernels, DCN or not,
become (Cout, Cin/g, 3, 3)), a DCN conv2's `conv_offset` becomes
`conv2.conv_offset`, `(I, O)` dense kernels become `(O, I)`, the two
flatten-consuming FCs go back from an HWC to a CHW input flatten, and
`batch_stats` become `running_mean` / `running_var`. It takes a
`{'params', 'batch_stats'}` tree of numpy arrays and needs no JAX.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from htd_tpu_torch.config import HTDConfig
from htd_tpu_torch.models.layers import ConvAWS2d, FrozenBatchNorm2d
from htd_tpu_torch.models.resnet import ARCH_BLOCKS, SAConv2d
from htd_tpu_torch.ops.dcn import DeformConv2d


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(k) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _fc(k) -> torch.Tensor:
    """(I, O) -> (O, I)."""
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _fc_hwc_to_chw(k, c: int, h: int, w: int) -> torch.Tensor:
    """(H*W*C, O) dense over an HWC flatten -> (O, C*H*W) over CHW."""
    o = np.asarray(k).shape[1]
    k = np.asarray(k).T.reshape(o, h, w, c).transpose(0, 3, 1, 2)
    return _t(k.reshape(o, c * h * w))


def state_dict_from_flax(variables: Dict[str, Any], cfg: HTDConfig) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's `{'params', 'batch_stats'}` tree -> the port's
    (mmdet-named) state dict."""
    p, st = variables["params"], variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def bn(prefix, params, stats):
        sd[prefix + ".weight"] = _t(params["scale"])
        sd[prefix + ".bias"] = _t(params["bias"])
        sd[prefix + ".running_mean"] = _t(stats["mean"])
        sd[prefix + ".running_var"] = _t(stats["var"])

    def conv(prefix, params):
        sd[prefix + ".weight"] = _conv(params["kernel"])
        if "bias" in params:
            sd[prefix + ".bias"] = _t(params["bias"])

    def fc(prefix, params, chw=None):
        sd[prefix + ".weight"] = (_fc_hwc_to_chw(params["kernel"], *chw) if chw
                                  else _fc(params["kernel"]))
        sd[prefix + ".bias"] = _t(params["bias"])

    # backbone
    bp, bs = p["backbone"], st["backbone"]
    conv("backbone.conv1", bp["conv1"])
    bn("backbone.bn1", bp["bn1"], bs["bn1"])
    for s, n in enumerate(ARCH_BLOCKS[cfg.backbone.depth]):
        for i in range(n):
            tp, fp = f"backbone.layer{s + 1}.{i}", f"layer{s + 1}_{i}"
            for j in (1, 2, 3):
                conv(f"{tp}.conv{j}", bp[fp][f"conv{j}"])
                bn(f"{tp}.bn{j}", bp[fp][f"bn{j}"], bs[fp][f"bn{j}"])
            if "conv_offset" in bp[fp]["conv2"]:
                conv(f"{tp}.conv2.conv_offset", bp[fp]["conv2"]["conv_offset"])
            if i == 0:
                conv(f"{tp}.downsample.0", bp[fp]["downsample_conv"])
                bn(f"{tp}.downsample.1", bp[fp]["downsample_bn"], bs[fp]["downsample_bn"])

    # FPN, RPN
    for i in range(len(cfg.fpn.in_channels)):
        conv(f"neck.lateral_convs.{i}.conv", p["neck"][f"lateral_{i}"])
        conv(f"neck.fpn_convs.{i}.conv", p["neck"][f"fpn_{i}"])
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        conv(f"rpn_head.{name}", p["rpn_head"][name])

    # SFA global context head
    if cfg.with_global:
        g = p["glbctx_head"]
        for i in range(cfg.global_ctx.num_convs):
            conv(f"roi_head.glbctx_head.convs.{i}.conv", g[f"conv{i}"])
        fc("roi_head.glbctx_head.fc", g["fc"])

    # stage-0 Shared2FC head
    rf = cfg.roi_extractor.out_size
    chw = (cfg.stage0_head.in_channels, rf, rf)
    h0 = p["stage0_head"]
    fc("roi_head.bbox_head.0.shared_fcs.0", h0["fc1"], chw)
    fc("roi_head.bbox_head.0.shared_fcs.1", h0["fc2"])
    sd["roi_head.bbox_head.0.fc_cls.weight"] = _fc(h0["fc_cls_kernel"])
    sd["roi_head.bbox_head.0.fc_cls.bias"] = _t(h0["fc_cls_bias"])
    fc("roi_head.bbox_head.0.fc_reg", h0["fc_reg"])

    # stage-1 HTD head
    h1 = p["stage1_head"]
    fc("roi_head.bbox_head.1.fcs.0", h1["fcs1"], chw)
    fc("roi_head.bbox_head.1.fcs.2", h1["fcs2"])
    fc("roi_head.bbox_head.1.fc_cls", h1["fc_cls"])
    fc("roi_head.bbox_head.1.fc_reg", h1["fc_reg"])
    gk, gb = np.asarray(h1["graph_kernel"]), np.asarray(h1["graph_bias"])
    for k in range(gk.shape[0]):
        sd[f"roi_head.bbox_head.1.graph_lvl{k}_cls.weight"] = _fc(gk[k])
        sd[f"roi_head.bbox_head.1.graph_lvl{k}_cls.bias"] = _t(gb[k])
    for i in range(cfg.stage1_head.num_reg_convs):
        sd[f"roi_head.bbox_head.1.convs.{i}.conv.weight"] = _conv(h1[f"reg_conv{i}"]["kernel"])
        if f"reg_gn{i}" in h1:
            sd[f"roi_head.bbox_head.1.convs.{i}.gn.weight"] = _t(h1[f"reg_gn{i}"]["scale"])
            sd[f"roi_head.bbox_head.1.convs.{i}.gn.bias"] = _t(h1[f"reg_gn{i}"]["bias"])

    # BA extractor attention: 1x1 convs stored as dense kernels
    a = p["adpt_extractor"]
    for name in ("conv1", "conv2"):
        sd[f"roi_head.bbox_roi_extractor.1.{name}.weight"] = _fc(a[f"att_{name}"]["kernel"])[..., None, None]
        sd[f"roi_head.bbox_roi_extractor.1.{name}.bias"] = _t(a[f"att_{name}"]["bias"])
    return sd


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights for the no-checkpoint case, drawn from one
    `torch.Generator` in module order: convs kaiming-normal (fan_out),
    linears xavier-uniform, the RPN convs and classifiers normal(0.01),
    box regressors normal(0.001), zero biases; frozen BN and GroupNorm at
    identity, except each bottleneck's last BN scale at zero (mmdet's
    `zero_init_residual`), which keeps random activations from growing
    block by block. A deformable conv's weight is drawn like a conv's;
    its `conv_offset` starts at zero, as mmcv's does, so an untrained DCN
    samples at its taps. DetectoRS's added paths start as mmcv and mmdet
    start them: a switchable atrous conv's `weight_diff`, contexts and
    offset convs at zero and its switch at 1 (the dilation-1 branch alone),
    `rfp_conv` and `rfp_weight` at zero; `weight_gamma` at one and
    `weight_beta` at zero."""
    g = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("conv_offset", "offset_s", "offset_l", "pre_context", "post_context",
                    "rfp_conv", "rfp_weight", "switch"):
            m.weight.zero_()
            m.bias.fill_(1.0 if leaf == "switch" else 0.0)
        elif isinstance(m, DeformConv2d):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(torch.empty(m.weight.shape).normal_(
                0.0, math.sqrt(2.0 / fan_out), generator=g))
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            if leaf in ("rpn_conv", "rpn_cls", "rpn_reg", "fc_cls") or name.endswith("glbctx_head.fc"):
                w.normal_(0.0, 0.01, generator=g)
            elif leaf == "fc_reg":
                w.normal_(0.0, 0.001, generator=g)
            elif isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            else:
                bound = math.sqrt(6.0 / (m.weight.shape[0] + m.weight.shape[1]))
                w.uniform_(-bound, bound, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, SAConv2d):
                m.weight_diff.zero_()
            if isinstance(m, ConvAWS2d):
                m.weight_gamma.fill_(1.0)
                m.weight_beta.zero_()
        elif isinstance(m, (FrozenBatchNorm2d, nn.GroupNorm)):
            m.weight.fill_(0.0 if name.endswith(".bn3") else 1.0)
            m.bias.zero_()
            if isinstance(m, FrozenBatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
