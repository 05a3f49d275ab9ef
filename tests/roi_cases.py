"""Roi sets for the RoIAlign kernels' tests (K2, K4), shared by the CPU
tests and the card's (tests/test_torch_cuda.py, which imports no JAX)."""

import numpy as np


def special_rois(rng, b, r, img_h, img_w):
    """(B, R >= 12, 4) rois for the fold: random ones, and in every image
    - bins under one pixel on P2, so that neighbouring bins' samples share
      corners (rows 0-1);
    - rois crossing every border, with samples in [-1, 0) and in
      (size - 1, size] (rows 2-4; on a 128 x 192 image row 2 maps to P3,
      rows 3-4 to P2);
    - a roi wider than every level (row 5, on P2 when level-mapped);
    - zero-width and zero-height rois: grid 0, count 1, a zero output
      (rows 6-7)."""
    out = np.zeros((b, r, 4), np.float32)
    for i in range(b):
        xy = rng.uniform(-8, [img_w * 0.8, img_h * 0.8], (r, 2))
        wh = rng.uniform(2, [img_w * 0.6, img_h * 0.6], (r, 2))
        out[i] = np.concatenate([xy, xy + wh], 1)
        out[i, 0] = [50, 40, 58, 46]                                # bins 0.29 x 0.21 px
        out[i, 1] = [21.5, 33.5, 27.0, 37.0]                        # bins 0.20 x 0.13 px
        out[i, 2] = [-2.5, -3, img_w + 2.5, img_h + 3]              # P3: -0.375 .. size - 0.75
        out[i, 3] = [-3, -2, 30, 28]                                # P2: from -0.96
        out[i, 4] = [img_w - 20, img_h - 18, img_w + 1.5, img_h + 1]  # P2: to size - 0.6
        out[i, 5] = [-60, 10, img_w + 70, 40]                       # wider than every level
        out[i, 6] = [40, 20, 40, 60]                                # zero width
        out[i, 7] = [30, 50, 90, 50]                                # zero height
    return out


def crowded_rois(rng, b, r, img_h, img_w):
    """(B, R, 4) rois as a training step samples them: a quarter jittered
    around a few ground-truth boxes (many rois on the same pixels), the
    rest random from 8 to 600 px, the last 8 of each image zero-area
    padding."""
    out = np.zeros((b, r, 4), np.float32)
    for i in range(b):
        gts = np.stack([rng.uniform(0, img_w * 0.6, 4), rng.uniform(0, img_h * 0.6, 4)], 1)
        gts = np.concatenate([gts, gts + rng.uniform(24, 400, (4, 2))], 1)
        pos = r // 4
        box = gts[rng.randint(0, 4, pos)]
        size = np.repeat(box[:, 2:] - box[:, :2], 2, 1)
        out[i, :pos] = box + rng.uniform(-0.15, 0.15, (pos, 4)) * size
        xy = rng.uniform(-8, [img_w * 0.9, img_h * 0.9], (r - pos, 2))
        out[i, pos:] = np.concatenate([xy, xy + rng.uniform(8, 600, (r - pos, 2))], 1)
        out[i, -8:] = 0.0
    return out
