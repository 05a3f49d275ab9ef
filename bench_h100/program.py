"""The system under test, built through its own API from the benchmark's
state dict: `htd_tpu_torch`'s detector for inference and its train state
for training. Nothing else of the program is taken."""

from __future__ import annotations

from typing import Dict

import torch


def build_detector(cfg, sd: Dict[str, torch.Tensor], device):
    """The detector as `init_detector` leaves it (the config's compute
    dtype, channels_last, eval), with the given weights and no random init."""
    from htd_tpu_torch.models.detector import HTDDetector

    with torch.device("meta"):
        model = HTDDetector(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    model = model.to(device=device, dtype=model.compute_dtype)
    return model.to(memory_format=torch.channels_last).eval()


def build_train_state(cfg, sd: Dict[str, torch.Tensor], device, steps_per_epoch: int = 7330):
    """The train state as `create_train_state` leaves it (float32
    parameters, channels_last, frozen stem and layer1, SGD), with the
    given weights and no random init."""
    from htd_tpu_torch.models.detector import HTDDetector
    from htd_tpu_torch.train.optim import make_optimizer
    from htd_tpu_torch.train.train_step import TrainState

    with torch.device("meta"):
        model = HTDDetector(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    model = model.to(device=device).to(memory_format=torch.channels_last)
    model.eval()
    return TrainState(model, make_optimizer(cfg.train, model), 0, steps_per_epoch)
