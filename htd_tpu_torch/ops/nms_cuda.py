"""Launchers for the NMS kernels: hard NMS (`csrc/nms.cu`, a mask launch
and a scan launch) and linear soft-NMS (`csrc/soft_nms.cu`, every round in
one launch).

Each checks what its kernel takes (shape, device; soft-NMS also dtype and
contiguity) and raises on anything else, allocates the outputs and scratch
(hard NMS's mask; past 9,216 entries, soft-NMS's workspace), launches on
PyTorch's current stream, and raises when the launch reports an error.
Neither synchronises with the host, so both may run inside a CUDA graph's
capture.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises. The public wrappers that pick between a kernel and its plain
version by device are `ops.nms.nms` and `ops.nms.soft_nms`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from htd_tpu_torch.ops._build import check_launch, launch_stream

_MAX_ENTRIES = 1 << 30   # the soft-NMS kernel indexes entries with 32-bit integers
_SHARED_ENTRIES = 9216   # the soft-NMS kernel's kSharedEntries: more entries take a workspace
_MAX_HARD_ENTRIES = 2048 * 64   # the hard-NMS scan's kMaxWords mask words of 64 boxes


def launch_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes (N, 4) and scores (N,) CUDA tensors on one device, N <= 131,072,
    max_out >= 1 -> keep_idx (max_out,) int64 (0 where invalid), keep_score
    (max_out,) float32 (-inf where invalid) and keep_valid (max_out,) bool, in
    keep order: `nms.nms_plain`'s outputs, bit for bit. The scores are sorted
    (descending, stable) and the boxes gathered in that order as
    `nms_plain` does; then the mask launch and the scan launch."""
    from htd_tpu_torch.ops._build import load

    n = boxes.shape[0] if boxes.dim() == 2 else -1
    if boxes.dim() != 2 or boxes.shape[1] != 4 or tuple(scores.shape) != (n,):
        raise ValueError(f"hard NMS takes boxes (N, 4) and scores (N,), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if n > _MAX_HARD_ENTRIES or max_out < 1:
        raise ValueError(f"hard NMS takes at most {_MAX_HARD_ENTRIES} boxes and max_out >= 1, "
                         f"got {n} boxes and max_out {max_out}")
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"launch_nms takes CUDA tensors on one device, not {boxes.device} "
                         f"and {scores.device}")
    dev = boxes.device
    scores = scores.to(torch.float32)
    order = torch.sort(scores, descending=True, stable=True).indices
    sboxes = boxes[order].to(torch.float32).contiguous()
    sscores = scores[order].contiguous()
    words = -(-n // 64)
    mask = torch.empty((n, words), dtype=torch.int64, device=dev)
    keep_idx = torch.empty(max_out, dtype=torch.int64, device=dev)
    keep_score = torch.empty(max_out, dtype=torch.float32, device=dev)
    keep_valid = torch.empty(max_out, dtype=torch.bool, device=dev)
    lib, _ = load()
    err = lib.htd_nms(sboxes.data_ptr(), sscores.data_ptr(), order.data_ptr(), n, iou_threshold,
                      max_out, mask.data_ptr(), keep_idx.data_ptr(), keep_score.data_ptr(),
                      keep_valid.data_ptr(), launch_stream())
    check_launch(err, "nms")
    return keep_idx, keep_score, keep_valid


def launch_soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                    min_score: float, max_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes (N, 4) and scores (N,), contiguous float32 CUDA tensors on one
    device, 1 <= N <= 2**30, max_out >= 1 -> keep_idx (max_out,) int64 (0
    where invalid), keep_score (max_out,) float32 (-inf where invalid) and
    keep_valid (max_out,) bool, in emission order: `nms.soft_nms_plain`'s
    outputs, bit for bit."""
    from htd_tpu_torch.ops._build import load

    n = boxes.shape[0] if boxes.dim() == 2 else -1
    if boxes.dim() != 2 or boxes.shape[1] != 4 or tuple(scores.shape) != (n,):
        raise ValueError(f"soft-NMS takes boxes (N, 4) and scores (N,), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if not 1 <= n <= _MAX_ENTRIES or max_out < 1:
        raise ValueError(f"soft-NMS takes 1 to 2**30 boxes and max_out >= 1, got {n} boxes and "
                         f"max_out {max_out}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"soft-NMS takes float32 boxes and scores, not {boxes.dtype} and "
                         f"{scores.dtype}")
    if not boxes.is_contiguous() or not scores.is_contiguous():
        raise ValueError("soft-NMS takes contiguous boxes and scores")
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"launch_soft_nms takes CUDA tensors on one device, not {boxes.device} "
                         f"and {scores.device}")
    dev = boxes.device
    keep_idx = torch.empty(max_out, dtype=torch.int64, device=dev)
    keep_score = torch.empty(max_out, dtype=torch.float32, device=dev)
    keep_valid = torch.empty(max_out, dtype=torch.bool, device=dev)
    # boxes, areas and live scores: in shared memory up to _SHARED_ENTRIES
    workspace = torch.empty(6 * n, dtype=torch.float32, device=dev) \
        if n > _SHARED_ENTRIES else None
    lib, _ = load()
    err = lib.htd_soft_nms(boxes.data_ptr(), scores.data_ptr(), n, iou_threshold, min_score,
                           max_out, None if workspace is None else workspace.data_ptr(),
                           keep_idx.data_ptr(), keep_score.data_ptr(), keep_valid.data_ptr(),
                           launch_stream())
    check_launch(err, "soft_nms")
    return keep_idx, keep_score, keep_valid
