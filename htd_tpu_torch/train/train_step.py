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
K3 forward and K5 + K6 backward once per deformable conv.

Data parallel (the JAX package's meshed step): with a process group,
every rank runs the forward and backward on its own slice of the global
batch, then packs the gradients of the optimizer's parameters (in the
optimizer's order) and the loss terms into one float32 vector, crosses the
ranks with one `all_reduce` (`parallel.all_reduce_mean_packed`), and takes
the clip and the SGD step on the mean, as optax applies its chain to the
mean gradient; every rank then holds the same parameters.
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
from htd_tpu_torch.parallel.dist import all_reduce_mean_packed
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


def step_generator(seed: int, step: int, device, rank: int = 0,
                   world_size: int = 1) -> torch.Generator:
    """The sampling generator of step `step` of a run seeded `seed`, on
    `device`: a function of the numbers alone, as the JAX package folds
    the step into its key, so that a resumed run draws the uninterrupted
    run's samples without saving a generator's state. With several ranks
    each draws its own stream, as the JAX package folds in the device's
    index on the 'data' axis."""
    words = [seed, step, rank] if world_size > 1 else [seed, step]
    entropy = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(entropy))


def train_step(state: TrainState, batch: TrainBatch,
               generator: Optional[torch.Generator] = None,
               overrides: Optional[Dict[str, torch.Tensor]] = None,
               group=None) -> Dict[str, torch.Tensor]:
    """One SGD step on `batch`; advances `state` in place and returns the
    detached loss terms and their total under "loss". `generator` drives
    the random sampling; `overrides` is `forward_train`'s parity hook. With
    a process `group`, `batch` is this rank's slice of the global batch,
    and the step and the returned terms are the means over the group's
    ranks (one `all_reduce`)."""
    model, opt = state.model, state.optimizer
    cfg = model.cfg
    lr = lr_schedule(cfg.train, state.steps_per_epoch)(state.step)
    for pg in opt.param_groups:
        pg["lr"] = lr
    opt.zero_grad(set_to_none=True)
    dev = model.device
    with torch.autocast(dev.type, dtype=torch.bfloat16,
                        enabled=cfg.compute_dtype == "bfloat16"):
        losses = model.forward_train(batch.images, batch.img_shapes, batch.gt_boxes,
                                     batch.gt_labels, batch.gt_valid, overrides=overrides,
                                     generator=generator)
    total = sum(v for k, v in losses.items() if "loss" in k)
    total.backward()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    if group is not None:
        metrics = _all_reduce_step(opt, metrics, group)
    clip_gradients(cfg.train, opt)
    opt.step()
    state.step += 1
    return metrics


def _all_reduce_step(opt: torch.optim.Optimizer, metrics: Dict[str, torch.Tensor],
                     group) -> Dict[str, torch.Tensor]:
    """Replace each gradient of `opt`'s parameters by its mean over the
    group's ranks, and return the means of the loss terms: one vector of
    the gradients in the optimizer's order (a parameter without a
    gradient packs as zeros, so that every rank packs the same layout),
    the total loss and the terms by sorted key, one `all_reduce`."""
    params = [p for grp in opt.param_groups for p in grp["params"]]
    keys = sorted(k for k in metrics if k != "loss")
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    scalars = [metrics["loss"]] + [metrics[k] for k in keys]
    reduced = all_reduce_mean_packed(grads + scalars, group)
    for p, g in zip(params, reduced):
        if p.grad is None:
            p.grad = torch.empty_like(p)
        p.grad.copy_(g)
    out = dict(zip(["loss"] + keys, reduced[len(params):]))
    return {k: out[k] for k in metrics}
