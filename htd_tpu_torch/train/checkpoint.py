"""Checkpoints: a training state saved and restored as a torch `.pth` in
mmcv's layout, mmdet state dicts loaded, a partial state dict merged over
a fresh model.

Counterpart of `htd_tpu/train/checkpoint.py`. The JAX package saves its
train state with orbax and converts mmdet `.pth` files into its variable
tree; the port keeps mmdet's state-dict names, so one file format serves
both: `save_checkpoint` writes {"meta", "state_dict", "optimizer"} as
mmcv's `save_checkpoint` does, `init_detector` and `load_torch_checkpoint`
read its "state_dict" as they read an mmdet file's, and so does the JAX
package's `load_torch_checkpoint`.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from htd_tpu_torch.config import dump_config


def save_checkpoint(path: str, state, meta: Optional[dict] = None) -> None:
    """Write the `TrainState` `state` to `path`: "meta" {step,
    steps_per_epoch, epoch (completed, step // steps_per_epoch), config
    (`dump_config`)} updated with `meta`, "state_dict" the model's tensors
    on the CPU, "optimizer" the SGD state (its momentum buffers). The file
    is written beside `path` and then renamed, so a cut run leaves no
    partial checkpoint."""
    info = {"step": state.step, "steps_per_epoch": state.steps_per_epoch,
            "epoch": state.step // state.steps_per_epoch,
            "config": dump_config(state.model.cfg)}
    info.update(meta or {})
    sd = OrderedDict((k, v.detach().cpu()) for k, v in state.model.state_dict().items())
    tmp = f"{path}.tmp"
    torch.save({"meta": info, "state_dict": sd, "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state):
    """Load a file written by `save_checkpoint` into the `TrainState`
    `state` in place: the model's tensors, the SGD state, `step` and
    `steps_per_epoch`. Returns `state`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["meta"]["step"])
    state.steps_per_epoch = int(ckpt["meta"]["steps_per_epoch"])
    return state


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of an mmdet `.pth` (its "state_dict", or the file's
    dict itself) or of a file written by `save_checkpoint`, on the CPU,
    without BatchNorm's `num_batches_tracked` counters (the port's frozen
    BatchNorm keeps none)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def merge_pretrained(model: nn.Module, state_dict: Dict[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Copy into `model` the entries of `state_dict` whose names it has,
    leaving the others at their current values: mmdet's
    `load_checkpoint(strict=False)`, as the JAX package's `merge_pretrained`
    overlays the leaves it finds (a backbone-only file leaves the heads at
    their fresh values). Returns (missing, unexpected): the model's names
    that the dict lacks and the dict's names that the model lacks, for the
    caller to log. An entry whose shape differs from the model's raises
    `ValueError` before anything is copied."""
    own = model.state_dict()
    bad = [f"{k} {tuple(v.shape)} (the model's {tuple(own[k].shape)})"
           for k, v in state_dict.items() if k in own and own[k].shape != v.shape]
    if bad:
        raise ValueError("pretrained shapes differ from the model's: " + ", ".join(bad))
    for k, v in state_dict.items():
        if k in own:
            own[k].copy_(v)
    return ([k for k in own if k not in state_dict],
            [k for k in state_dict if k not in own])
