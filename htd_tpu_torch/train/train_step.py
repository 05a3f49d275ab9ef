"""Train state and the train step.

Counterpart of `htd_tpu/train/train_step.py` (`create_train_state`,
`train_step`; mmdet's runner and OptimizerHook): one step runs the
training forward, sums the loss terms whose key contains `loss` (mmdet
`_parse_losses`), backpropagates, and takes one SGD step at the scheduled
learning rate. Parameters and the SGD state stay float32; the forward
computes in `cfg.compute_dtype` under `torch.autocast`, as the JAX package
casts its float32 parameters per op, so the kernels see bfloat16 features
while the losses stay float32. Every preset trains: a step runs K1
(pyramid pack) once, K2 (RoIAlign) and its backward K4 three times each
and, with deformable convs (R-101-DCN, X-101-DCN: 30 of them in layer2-4),
K3 forward and K5 + K6 backward once per deformable conv. The multi-device
path (DDP) is not ported yet.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from htd_tpu_torch.apis import resolve_device
from htd_tpu_torch.config import HTDConfig
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.train.checkpoint import load_torch_checkpoint, merge_pretrained
from htd_tpu_torch.train.optim import clip_gradients, lr_schedule, make_optimizer
from htd_tpu_torch.weights import init_random


class TrainBatch(NamedTuple):
    images: torch.Tensor        # (B, H, W, 3) normalized, bucket-padded
    img_shapes: torch.Tensor    # (B, 2) resized (h, w)
    gt_boxes: torch.Tensor      # (B, G, 4) padded
    gt_labels: torch.Tensor     # (B, G)
    gt_valid: torch.Tensor      # (B, G) bool


@dataclass
class TrainState:
    model: HTDDetector
    optimizer: torch.optim.SGD
    step: int = 0
    steps_per_epoch: int = 7330


def create_train_state(cfg: HTDConfig, device=None, seed: int = 0,
                       steps_per_epoch: int = 7330, checkpoint: Optional[str] = None,
                       pretrained: Optional[str] = None) -> TrainState:
    """The detector in float32 on `device` (CUDA unless the caller asks for
    the CPU), from an mmdet `.pth` when given, else with random weights
    from `seed`, then overlaid with the matching tensors of the `pretrained`
    `.pth` (a backbone, say; `merge_pretrained`, the names it leaves
    missing or finds unexpected logged on stderr); the stem and layer1
    frozen; SGD over the rest."""
    dev = resolve_device(device)
    model = HTDDetector(cfg)
    if checkpoint:
        model.load_state_dict(load_torch_checkpoint(checkpoint))
    else:
        init_random(model, seed)
    if pretrained:
        sd = load_torch_checkpoint(pretrained)
        missing, unexpected = merge_pretrained(model, sd)
        print(f"[pretrained] {pretrained}: {len(sd) - len(unexpected)} tensors loaded; "
              f"missing {len(missing)}: {', '.join(missing)}; unexpected {len(unexpected)}: "
              f"{', '.join(unexpected)}", file=sys.stderr)
    model = model.to(device=dev).to(memory_format=torch.channels_last)
    # frozen BatchNorm and GroupNorm behave the same in both modes
    model.eval()
    return TrainState(model, make_optimizer(cfg.train, model), 0, steps_per_epoch)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of step `step` of a run seeded `seed`, on
    `device`: a function of the two numbers alone, as the JAX package folds
    the step into its key, so that a resumed run draws the uninterrupted
    run's samples without saving a generator's state."""
    entropy = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(entropy))


def train_step(state: TrainState, batch: TrainBatch,
               generator: Optional[torch.Generator] = None,
               overrides: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One SGD step on `batch`; advances `state` in place and returns the
    detached loss terms and their total under "loss". `generator` drives
    the random sampling; `overrides` is `forward_train`'s parity hook."""
    model, opt = state.model, state.optimizer
    cfg = model.cfg
    lr = lr_schedule(cfg.train, state.steps_per_epoch)(state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    dev = model.device
    with torch.autocast(dev.type, dtype=torch.bfloat16,
                        enabled=cfg.compute_dtype == "bfloat16"):
        losses = model.forward_train(batch.images, batch.img_shapes, batch.gt_boxes,
                                     batch.gt_labels, batch.gt_valid, overrides=overrides,
                                     generator=generator)
    total = sum(v for k, v in losses.items() if "loss" in k)
    total.backward()
    clip_gradients(cfg.train, opt)
    opt.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    return metrics
