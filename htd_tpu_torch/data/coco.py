"""COCO dataset: annotation parsing, filtering, grouped batching.

The port's copy of `htd_tpu/data/coco.py` (mmdet datasets/coco.py and
custom.py over the json, no pycocotools): xywh -> xyxy clipped to the
image, category ids -> contiguous labels, crowd boxes kept apart as
ignore regions, train filtering (images under `min_size` px or without a
gt dropped), orientation-homogeneous batches. The batch functions run the
port's `preprocess` on `device` and return tensors there. Images are read
on the host by the port's own decoders, PNG by `data/png.py` and JPEG by
`data/jpeg.py`, each bit-equal to OpenCV's `imread(IMREAD_COLOR)`, so COCO
sets need no OpenCV.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from htd_tpu_torch.data import jpeg, png
from htd_tpu_torch.data.pipeline import bucket_shape, pad_gt, preprocess
from htd_tpu_torch.train.train_step import TrainBatch


@dataclasses.dataclass
class ImageRecord:
    img_id: int
    file_name: str
    height: int
    width: int
    boxes: np.ndarray        # (N, 4) xyxy, non-crowd
    labels: np.ndarray       # (N,) contiguous [0, C)
    crowd_boxes: np.ndarray  # (M, 4) xyxy iscrowd regions (ignore)

    @property
    def landscape(self) -> bool:
        return self.width >= self.height


class CocoDataset:
    def __init__(self, ann_file: str, img_root: str = "", test_mode: bool = False,
                 min_size: int = 32):
        self.img_root = img_root
        with open(ann_file) as f:
            data = json.load(f)
        cats = data.get("categories", [])
        self.cat_ids = [c["id"] for c in cats]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.classes = [c["name"] for c in cats]

        anns_by_img: Dict[int, List[dict]] = {}
        for a in data.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.records: List[ImageRecord] = []
        for img in data["images"]:
            boxes, labels, crowds = [], [], []
            for a in anns_by_img.get(img["id"], []):
                if a.get("ignore", False):
                    continue
                x, y, w, h = a["bbox"]
                x1, y1 = max(x, 0), max(y, 0)
                x2, y2 = min(x + w, img["width"]), min(y + h, img["height"])
                if x2 <= x1 or y2 <= y1 or a.get("area", w * h) <= 0:
                    continue
                if a.get("iscrowd", 0):
                    crowds.append([x1, y1, x2, y2])
                else:
                    boxes.append([x1, y1, x2, y2])
                    labels.append(self.cat2label[a["category_id"]])
            rec = ImageRecord(
                img_id=img["id"], file_name=img["file_name"], height=img["height"],
                width=img["width"], boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                crowd_boxes=np.asarray(crowds, np.float32).reshape(-1, 4))
            if not test_mode and (min(img["width"], img["height"]) < min_size
                                  or len(rec.boxes) == 0):
                continue
            self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def groundtruth(self) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """img_id -> (boxes, labels, iscrowd) for the evaluator."""
        out = {}
        for r in self.records:
            boxes = np.concatenate([r.boxes, r.crowd_boxes], axis=0)
            labels = np.concatenate([r.labels, np.zeros(len(r.crowd_boxes), np.int32)])
            crowd = np.concatenate([np.zeros(len(r.boxes), bool),
                                    np.ones(len(r.crowd_boxes), bool)])
            out[r.img_id] = (boxes, labels, crowd)
        return out

    def load_image(self, rec: ImageRecord) -> np.ndarray:
        """The record's image, (H, W, 3) uint8 BGR, decoded by its file's
        signature: PNG by `data.png.read_png`, JPEG by `data.jpeg.read_jpeg`,
        each as `cv2.imread` reads it. Other formats (which the JAX package
        reads through OpenCV) raise `ValueError` naming the file: the port
        reads no file through OpenCV, installed or not."""
        path = os.path.join(self.img_root, rec.file_name)
        with open(path, "rb") as f:
            signature = f.read(len(png.SIGNATURE))
        if signature == png.SIGNATURE:
            return png.read_png(path)
        if signature.startswith(jpeg.SIGNATURE):
            return jpeg.read_jpeg(path)
        raise ValueError(f"{path} is neither a PNG nor a JPEG file, the two formats the port "
                         f"reads")


def grouped_batches(dataset: CocoDataset, batch_size: int, shuffle: bool, seed: int = 0,
                    drop_last: bool = False) -> Iterator[List[ImageRecord]]:
    """Aspect-ratio-homogeneous batches (mmdet GroupSampler): every batch
    holds only landscape or only portrait images, so each maps to one
    static bucket."""
    rng = np.random.RandomState(seed)
    groups: Dict[bool, List[int]] = {True: [], False: []}
    for i, r in enumerate(dataset.records):
        groups[r.landscape].append(i)
    order: List[List[int]] = []
    for idxs in groups.values():
        idxs = list(idxs)
        if shuffle:
            rng.shuffle(idxs)
        for i in range(0, len(idxs), batch_size):
            chunk = idxs[i:i + batch_size]
            if drop_last and len(chunk) < batch_size:
                continue
            order.append(chunk)
    if shuffle:
        rng.shuffle(order)
    for chunk in order:
        yield [dataset.records[i] for i in chunk]


def make_test_batch(dataset: CocoDataset, records: Sequence[ImageRecord],
                    scale: Tuple[int, int] = (1333, 800), batch_size: Optional[int] = None,
                    device="cpu"):
    """Load and preprocess a test batch on `device`: (images (B, H, W, 3),
    img_shapes (B, 2), scale_factors (B, 4), img_ids (B,) int64 numpy).
    Short batches repeat the last image, with id -1."""
    bucket = bucket_shape(scale, records[0].landscape)
    procs = [preprocess(dataset.load_image(rec), scale=scale, bucket=bucket, device=device)
             for rec in records]
    ids = [rec.img_id for rec in records]
    n = batch_size or len(records)
    procs += [procs[-1]] * (n - len(procs))
    ids += [-1] * (n - len(ids))
    return (torch.stack([p.image for p in procs]), torch.stack([p.img_shape for p in procs]),
            torch.stack([p.scale_factor for p in procs]), np.asarray(ids, np.int64))


def sample_mstrain_scale(rng: np.random.RandomState,
                         scale_range: Tuple[Tuple[int, int], Tuple[int, int]],
                         step: int = 32) -> Tuple[int, int]:
    """Multi-scale train sampling (mmdet Resize multiscale_mode='range'):
    the short side uniform between the two scales' short sides, quantized
    to `step` so that the number of buckets stays bounded."""
    (l1, s1), (l2, s2) = scale_range
    lo, hi = min(s1, s2), max(s1, s2)
    short = int(rng.randint(lo, hi + 1))
    short = int(np.clip(round(short / step) * step, lo, hi))
    return (max(l1, l2), short)


def make_train_batch(dataset: CocoDataset, records: Sequence[ImageRecord],
                     scale: Tuple[int, int] = (1333, 800), max_gt: int = 100,
                     flip_prob: float = 0.5, rng: Optional[np.random.RandomState] = None,
                     flips: Optional[Sequence[bool]] = None, device="cpu") -> TrainBatch:
    """Load, flip (each image with `flip_prob` from `rng`, or as `flips`
    says) and pad a train batch on `device`, one scale for the batch."""
    rng = rng or np.random.RandomState(0)
    bucket = bucket_shape(scale, records[0].landscape)
    imgs, shapes, gtb, gtl, gtv = [], [], [], [], []
    for i, rec in enumerate(records):
        flip = bool(flips[i]) if flips is not None else bool(rng.rand() < flip_prob)
        p = preprocess(dataset.load_image(rec), scale=scale, bucket=bucket, device=device,
                       flip=flip, boxes=rec.boxes, labels=rec.labels)
        b, lab, v = pad_gt(p.boxes, p.labels, max_gt)
        imgs.append(p.image)
        shapes.append(p.img_shape)
        gtb.append(b)
        gtl.append(lab)
        gtv.append(v)
    return TrainBatch(*(torch.stack(t) for t in (imgs, shapes, gtb, gtl, gtv)))
