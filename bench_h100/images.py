"""Synthetic inputs made from the seed: uint8 BGR images of a size mix and
their ground truth. Every seed gets the same multiset of sizes (the
mix's shares rounded to counts over the pool); the seed orders them and
draws the pixels and the boxes."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pool_sizes(tp: dict) -> List[Tuple[int, int]]:
    """The pool's (h, w) sizes in a fixed order: each of `sizes` in its
    share `size_shares` of the pool, rounded to counts."""
    n = tp["pool"]
    counts = np.round(np.asarray(tp["size_shares"], float) * n).astype(int)
    counts[-1] = n - counts[:-1].sum()
    return [tuple(hw) for hw, c in zip(tp["sizes"], counts) for _ in range(c)]


def make_pool(tp: dict, seed) -> List[np.ndarray]:
    """The pool of the seed (an int or a list of ints, a stream of it)."""
    rng = np.random.default_rng(seed)
    sizes = pool_sizes(tp)
    order = rng.permutation(len(sizes))
    return [rng.integers(0, 256, sizes[i] + (3,), dtype=np.uint8) for i in order]


def make_boxes(img_hw: Tuple[int, int], rng: np.random.Generator, gts: Tuple[int, int],
               num_classes: int):
    """Between gts[0] and gts[1] boxes (x1, y1, x2, y2) inside the image,
    sides log-uniform from 1/20 to 3/4 of the image's, and their labels."""
    h, w = img_hw
    n = int(rng.integers(gts[0], gts[1] + 1))
    bw = w * np.exp(rng.uniform(np.log(0.05), np.log(0.75), n))
    bh = h * np.exp(rng.uniform(np.log(0.05), np.log(0.75), n))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    return boxes, rng.integers(0, num_classes, n).astype(np.int32)
