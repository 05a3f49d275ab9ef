"""Box utilities on torch tensors.

Counterpart of `htd_tpu/ops/boxes.py`: the same arithmetic in the same
order, so that float32 results agree with the JAX package to the last few
ulps. Boxes are `[..., 4]` in (x1, y1, x2, y2) order; box math stays
float32.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch.profiler import record_function

_DEFAULT_WH_RATIO_CLIP = 16.0 / 1000.0

# (values, dtype, device) -> the coder's constants, kept for the life of the
# process: a captured CUDA graph reads them by address, so none is replaced
_CODER_CONSTS: Dict[Tuple, torch.Tensor] = {}


def _coder_consts(vals: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """The coder's means or stds in `like`'s dtype on its device, made at
    their first use and kept: that first use copies them from the host,
    which blocks until the device's queue has drained
    (`htd.sync.box_coder`); later ones copy nothing. Made outside inference
    mode, so that autograd may save them for a backward pass."""
    key = (tuple(float(v) for v in vals), like.dtype, like.device)
    consts = _CODER_CONSTS.get(key)
    if consts is None:
        with record_function("htd.sync.box_coder"), torch.inference_mode(False):
            consts = _CODER_CONSTS[key] = torch.tensor(vals, dtype=like.dtype,
                                                       device=like.device)
    return consts


def bbox2delta(proposals, gt, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)):
    """Encode `gt` boxes relative to `proposals` as (dx, dy, dw, dh)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack(
        [(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)],
        dim=-1,
    )
    return (deltas - _coder_consts(means, deltas)) / _coder_consts(stds, deltas)


def delta2bbox(
    rois,
    deltas,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
    max_shape=None,
    wh_ratio_clip: float = _DEFAULT_WH_RATIO_CLIP,
):
    """Decode (dx, dy, dw, dh) deltas on top of `rois`.

    `max_shape` is an (h, w) pair or a tensor whose `[..., 0]` / `[..., 1]`
    broadcast against `rois[..., 0]` (e.g. `(B, 1, 2)` for `(B, R, 4)`
    rois); the decoded boxes are clipped to it.
    """
    denorm = deltas * _coder_consts(stds, deltas) + _coder_consts(means, deltas)
    dx, dy, dw, dh = denorm.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack(
        [gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1
    )
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def clip_boxes(boxes, img_shape):
    """Clip boxes to `[0, w] x [0, h]`; `img_shape` as in `delta2bbox`."""
    if isinstance(img_shape, torch.Tensor):
        h = img_shape[..., 0].to(boxes.dtype)
        w = img_shape[..., 1].to(boxes.dtype)
    else:
        h = torch.tensor(float(img_shape[0]), dtype=boxes.dtype, device=boxes.device)
        w = torch.tensor(float(img_shape[1]), dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_overlaps(bboxes1, bboxes2, mode: str = "iou", is_aligned: bool = False,
                  eps: float = 1e-6):
    """Pairwise IoU / IoF between `[..., M, 4]` and `[..., N, 4]` boxes."""
    if mode not in ("iou", "iof"):
        raise ValueError(mode)
    area1 = bbox_area(bboxes1)
    area2 = bbox_area(bboxes2)
    if not is_aligned:
        b1 = bboxes1[..., :, None, :]
        b2 = bboxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]
    else:
        b1, b2 = bboxes1, bboxes2
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - overlap if mode == "iou" else area1
    return overlap / union.clamp(min=eps)


def bbox_flip(boxes, img_shape, direction: str = "horizontal"):
    """Flip boxes inside an image of `img_shape` = (h, w) (a pair or a
    tensor)."""
    h = torch.as_tensor(img_shape[0], dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(img_shape[1], dtype=boxes.dtype, device=boxes.device)
    if direction == "horizontal":
        return torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]],
                           dim=-1)
    if direction == "vertical":
        return torch.stack([boxes[..., 0], h - boxes[..., 3], boxes[..., 2], h - boxes[..., 1]],
                           dim=-1)
    raise ValueError(direction)


def bbox_mapping(boxes, img_shape, scale_factor, flip: bool,
                 flip_direction: str = "horizontal"):
    """Original image frame -> an augmented frame: scale, then flip."""
    new = boxes * torch.as_tensor(scale_factor, dtype=boxes.dtype, device=boxes.device)
    return bbox_flip(new, img_shape, flip_direction) if flip else new


def bbox_mapping_back(boxes, img_shape, scale_factor, flip: bool,
                      flip_direction: str = "horizontal"):
    """An augmented frame -> the original image frame: unflip, then unscale."""
    new = bbox_flip(boxes, img_shape, flip_direction) if flip else boxes
    return new / torch.as_tensor(scale_factor, dtype=boxes.dtype, device=boxes.device)


def map_roi_levels(boxes, num_levels: int, finest_scale: float = 56.0):
    """FPN level per roi: floor(log2(sqrt(area)/finest + 1e-6)), int32."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    scale = torch.sqrt((w * h).clamp(min=0))
    # a tensor divisor keeps the division correctly rounded on CUDA (see
    # ops/roi_align.py), so levels match the JAX package's at boundaries
    lvl = torch.floor(torch.log2(scale / torch.full_like(scale, finest_scale) + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)
