"""SGD, its learning-rate schedule and the frozen stages.

Counterpart of `htd_tpu/train/optim.py`: the HTD schedules (SGD lr 0.02,
momentum 0.9, weight decay 1e-4, linear warmup over 500 iterations from a
third of the lr, x0.1 at each `lr_steps` epoch) and mmdet's
`frozen_stages=1`, which freezes the backbone stem and layer1. The JAX
package chains optax's decayed weights, trace and -lr(step);
`torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)`
computes the same update: buf = momentum * buf + (g + wd * p), p -= lr *
buf, with the first buf = g + wd * p.

Every HTD config sets `grad_clip=None`; an l2 global-norm clip is an
explicit opt-in through `TrainConfig.grad_clip_norm`.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn as nn

from htd_tpu_torch.config import TrainConfig


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup then step decay, evaluated at the step count before
    the update (optax's `scale_by_schedule`), in float32 as the JAX
    package computes it."""
    boundaries = [e * steps_per_epoch for e in cfg.lr_steps]
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        frac = np.clip(s / f32(max(cfg.warmup_iters, 1)), f32(0.0), f32(1.0))
        warm = f32(cfg.lr) * (f32(cfg.warmup_ratio) + f32(1 - cfg.warmup_ratio) * frac)
        decay = f32(1.0)
        for b in boundaries:
            decay = decay * (f32(0.1) if s >= b else f32(1.0))
        return float(warm * decay)

    return fn


def frozen_prefixes(frozen_stages: int = 1) -> List[str]:
    """Parameter-name prefixes of the frozen backbone stem and stages."""
    return ["backbone.conv1.", "backbone.bn1."] + [
        f"backbone.layer{s + 1}." for s in range(frozen_stages)]


def trainable_mask(model: nn.Module, frozen_stages: int = 1) -> Dict[str, bool]:
    """Marks the stem and stages [0, frozen_stages) `requires_grad=False`;
    returns {parameter name: trainable}."""
    frozen = tuple(frozen_prefixes(frozen_stages))
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = not name.startswith(frozen)
        p.requires_grad_(mask[name])
    return mask


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters (`trainable_mask` applied). The
    train step writes the scheduled lr into the param group before each
    step."""
    trainable_mask(model)
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0, nesterov=False)


def clip_gradients(cfg: TrainConfig, optimizer: torch.optim.Optimizer) -> None:
    """The opt-in global-norm clip of the raw gradients, before the step."""
    if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
        params = [p for grp in optimizer.param_groups for p in grp["params"]]
        torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip_norm)
