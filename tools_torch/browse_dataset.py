#!/usr/bin/env python
"""Visualize the train pipeline's output images and gt boxes with the
PyTorch port (after tools/browse_dataset.py).

Each image goes through the train pipeline minus Normalize (the
reference's default --skip-type): the port's `preprocess` (resize, flip,
normalise, pad) runs on --device, is un-normalised on the host as the JAX
tool does, and the transformed gt boxes are drawn on it. With --raw the
pipeline is skipped: the original image and the annotation boxes. Images
are written to --output-dir under their dataset file names, `.jpg` as
`cv2.imwrite` writes it (quality 95, the same bytes) and `.png` with the
same pixels; no OpenCV is needed. The labels are drawn as OpenCV 5's
`putText` draws them.

Usage:
  python tools_torch/browse_dataset.py --ann instances_train2017.json \\
      --img-root train2017 --output-dir /tmp/browse --max-images 20
  (add --device cpu where there is no CUDA device)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    """Run the tool; return the paths of the files it wrote, in order."""
    p = argparse.ArgumentParser()
    p.add_argument("--ann", required=True)
    p.add_argument("--img-root", default="")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--config", default="htd_r50_1x",
                   help="config preset supplying the train scale")
    p.add_argument("--scale", default=None, help="override train scale as WxH")
    p.add_argument("--raw", action="store_true",
                   help="skip the pipeline: original image + gt boxes")
    p.add_argument("--flip-prob", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument(
        "--corruption", default=None,
        help="optionally view a corruption (htd_tpu_torch.data.corruptions name)",
    )
    p.add_argument("--severity", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device of the pipeline (default: CUDA, which must be "
                        "present); 'cpu' runs it on the CPU")
    args = p.parse_args(argv)

    from htd_tpu_torch import config as C
    from htd_tpu_torch.apis import resolve_device
    from htd_tpu_torch.data.coco import CocoDataset
    from htd_tpu_torch.data.pipeline import MEAN_RGB, STD_RGB, preprocess
    from htd_tpu_torch.utils.visualize import draw_detections

    device = resolve_device(args.device)
    cfg = getattr(C, args.config)()
    scale = (
        tuple(int(v) for v in args.scale.split("x"))
        if args.scale else cfg.train.img_scale
    )
    dataset = CocoDataset(args.ann, args.img_root, test_mode=False)
    if args.corruption:
        from htd_tpu_torch.data.corruptions import CorruptedDataset

        dataset = CorruptedDataset(dataset, args.corruption, args.severity)
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    mean = np.asarray(MEAN_RGB, np.float32)
    std = np.asarray(STD_RGB, np.float32)

    written = []
    n = len(dataset.records)
    for i, rec in enumerate(dataset.records):
        if args.max_images is not None and i >= args.max_images:
            break
        img = dataset.load_image(rec)
        if args.raw:
            vis, boxes, labels = img, rec.boxes, rec.labels
        else:
            pr = preprocess(
                img, scale=scale, bucket=None, device=device,
                flip=bool(rng.rand() < args.flip_prob),
                boxes=rec.boxes, labels=rec.labels,
            )
            # un-normalise back to displayable BGR (= skipping Normalize,
            # like the reference's --skip-type default), in float32 on the
            # host as the JAX tool does; astype truncates
            rgb = pr.image.cpu().numpy() * std + mean
            vis = np.clip(rgb[..., ::-1], 0, 255).astype(np.uint8)
            vis = np.ascontiguousarray(vis)
            boxes, labels = pr.boxes.cpu().numpy(), rec.labels
        out_file = os.path.join(args.output_dir, os.path.basename(rec.file_name))
        draw_detections(
            vis, boxes, np.ones(len(boxes), np.float32), labels,
            class_names=dataset.classes, score_thr=0.0, out_file=out_file,
        )
        written.append(out_file)
        if (i + 1) % 50 == 0 or i + 1 == n:
            print(f"[browse] {i + 1}/{n}")
    return written


if __name__ == "__main__":
    main()
