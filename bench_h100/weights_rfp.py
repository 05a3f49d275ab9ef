"""Seeded weights of DetectoRS R-50 under HTD's heads, under mmdet's names,
made on the device in a few calls.

The program and the reference (`reference/detectors.py`) are handed this
one state dict. What HTD R-50 holds (the first backbone, the FPN, the RPN
and the heads) is `weights.make_state_dict`'s draw for the seed, the same
tensors an HTD R-50 cell draws; the further backbone of the recursive
feature pyramid is that function's backbone for a second stream of the
seed. The rest is drawn here, from a third stream, where mmcv and mmdet
would start it at zero or at one (which would leave it out of the result):

- ConvAWS's `weight_gamma`, per output channel, the conv's kaiming std
  times 1 + `aws_gamma_spread` * U(-1, 1) (mmcv sets it to the std of a
  loaded checkpoint's weight), and `weight_beta` `aws_beta_scale` times
  that std over the square root of the fan-in, times N(0, 1) (the mean);
- SAC's `weight_diff` N(0, 1) times `weight_diff_scale` times the kaiming
  std; its switch's bias `switch_bias` and weight N(0, 1) times the
  conv's `switch_weight_std`, so that both branches count; its offset
  convs N(0, 1) times the conv's `offset_weight_std` (about `offset_px`
  px of offset; `calibrate_rfp.py`); its contexts N(0, 1) times
  `context_scale` over the square root of the channels;
- `rfp_conv` and `rfp_weight` N(0, 1) times `rfp_conv_scale` and
  `rfp_weight_scale` over the square root of their input channels.

Biases stay at zero.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.detectors import backbones, param_shapes, sac_convs
from bench_h100.weights import make_state_dict as make_htd_state_dict

STREAMS = 2**40           # the further backbone's and the added tensors' seeds: seed + k * STREAMS


def _kaiming(shape) -> float:
    return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))


def make_state_dict(cfg: dict, assumed: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    sd = make_htd_state_dict(cfg, assumed, seed, device)
    shapes = param_shapes(cfg)
    for k, prefix in enumerate(backbones(cfg)[1:]):
        again = make_htd_state_dict(cfg, assumed, seed + (k + 1) * STREAMS, device)
        sd.update({prefix + n[len("backbone"):]: t for n, t in again.items()
                   if n.startswith("backbone.")})
        del again
    rest = [(n, s, kind) for n, (s, kind) in shapes.items() if n not in sd]
    total = sum(math.prod(s) for _, s, _ in rest)
    gen = torch.Generator(device=device).manual_seed(seed + 3 * STREAMS)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    per_sac = {name: i for i, (name, _, _) in enumerate(sac_convs(cfg))}
    at = 0
    for name, shape, kind in rest:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        conv = name.rsplit(".", 1)[0]
        if kind in ("aws_gamma", "aws_beta"):
            w = shapes[conv + ".weight"][0]
            std = _kaiming(w)
            if kind == "aws_gamma":
                t = std * (1.0 + assumed["aws_gamma_spread"] * u)
            else:
                t = z * (assumed["aws_beta_scale"] * std / math.sqrt(math.prod(w[1:])))
        elif kind == "sac_diff":
            t = z * (assumed["weight_diff_scale"] * _kaiming(shape))
        elif kind == "sac_switch":
            t = z * assumed["switch_weight_std"][per_sac[conv.rsplit(".", 1)[0]]]
        elif kind == "sac_switch_bias":
            t = torch.full(shape, float(assumed["switch_bias"]), device=device)
        elif kind == "sac_offset":
            t = z * assumed["offset_weight_std"][per_sac[conv.rsplit(".", 1)[0]]]
        elif kind == "context":
            t = z * (assumed["context_scale"] / math.sqrt(shape[1]))
        elif kind in ("rfp_conv", "rfp_weight"):
            t = z * (assumed[kind + "_scale"] / math.sqrt(shape[1]))
        elif kind == "conv":
            t = z * _kaiming(shape)
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: kind {kind}")
        sd[name] = t.contiguous()
    return sd

