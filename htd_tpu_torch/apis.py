"""Entry points: build a detector and run single-image inference.

Counterpart of `htd_tpu/apis.py` (`init_detector`, `inference_detector`;
mmdet apis/inference.py). The model runs on CUDA unless the caller asks
for the CPU with `device="cpu"`; with no device given and no GPU present
the entry points raise rather than fall back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from htd_tpu_torch.config import HTDConfig
from htd_tpu_torch.data.pipeline import bucket_shape, preprocess
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.weights import init_random


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when none is given; raises when CUDA is missing."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return dev


def _load_checkpoint(model: HTDDetector, path: str) -> None:
    """Load an mmdet `.pth` (its `state_dict`, or the dict itself)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)


def init_detector(cfg: HTDConfig, checkpoint: Optional[str] = None, device=None,
                  seed: int = 0) -> HTDDetector:
    """Build the detector on `device` in `cfg.compute_dtype`, from an mmdet
    `.pth` when given, else with random weights drawn from `seed`."""
    dev = resolve_device(device)
    model = HTDDetector(cfg)
    if checkpoint:
        _load_checkpoint(model, checkpoint)
    else:
        init_random(model, seed)
    model = model.to(device=dev, dtype=model.compute_dtype)
    model = model.to(memory_format=torch.channels_last)
    return model.eval()


@torch.inference_mode()
def inference_detector(model: HTDDetector, img_bgr: np.ndarray,
                       scale: Optional[Tuple[int, int]] = None):
    """Single-image inference. Returns (boxes (k, 4), scores (k,), labels
    (k,)) numpy arrays in original-image coordinates.

    `scale` defaults to the config's test scale; the image is padded into
    its orientation's static bucket."""
    scale = scale or model.cfg.test_scale
    landscape = img_bgr.shape[1] >= img_bgr.shape[0]
    p = preprocess(img_bgr, scale=scale, bucket=bucket_shape(scale, landscape),
                   device=model.device)
    dets = model.simple_test(p.image[None], p.img_shape[None], p.scale_factor[None])
    v = dets.valid[0].cpu().numpy()
    return (dets.boxes[0].cpu().numpy()[v], dets.scores[0].cpu().numpy()[v],
            dets.labels[0].cpu().numpy()[v])
