"""Seeded weights under mmdet's names, made on the device in a few calls.

Both the program and the reference are handed this one state dict. The
draws follow mmdet's init for a detector without a checkpoint: convs
kaiming-normal (fan out), linears xavier-uniform, the RPN convs and the
classifiers normal(0.01), box regressors normal(0.001), biases zero,
frozen BN and GN at identity. Three assumptions of the configuration
file (`assumed`) change it where random weights would leave a layer's
work out of the result: each bottleneck's last BN scale is
`residual_scale` rather than mmdet's zero (else the residual branches,
the deformable convs among them, add nothing and get no gradient), both
classifiers are scaled by `score_scale` (so that a trained model's count
of detections clears `score_thr`), and each deformable conv's offset conv
is drawn with the std of `offset_weight_std` (about `offset_px` px of
offset at that conv's input: trained offsets are not zero).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.detector import dcn_convs, param_shapes


def make_state_dict(cfg: dict, assumed: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    offset_std = dict(zip((n for n, *_ in dcn_convs(cfg)), assumed.get("offset_weight_std", [])))
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":
            t = z * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
        elif kind == "dcn_offset":
            t = z * offset_std[name[:-len(".conv_offset.weight")]]
        elif kind == "linear":
            t = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind == "small":
            t = z * 0.01
        elif kind == "tiny":
            t = z * 0.001
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "bn3_scale":
            t = torch.full(shape, float(assumed["residual_scale"]), device=device)
        else:
            raise ValueError(kind)
        if name.endswith("fc_cls.weight") and "bbox_head" in name:
            t = t * float(assumed["score_scale"])
        sd[name] = t.contiguous()
    return sd
