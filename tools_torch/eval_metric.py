#!/usr/bin/env python
"""Offline evaluation of dumped detections with the PyTorch port's COCO
evaluator (after tools/eval_metric.py).

Detections file: json {img_id: {"boxes": [[x1, y1, x2, y2], ...], "scores":
[...], "labels": [...]}}, the format that tools_torch/test.py --dump writes.

Usage: python tools_torch/eval_metric.py dets.json --ann instances_val2017.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dets")
    p.add_argument("--ann", required=True)
    args = p.parse_args(argv)
    import numpy as np

    from htd_tpu_torch.data.coco import CocoDataset
    from htd_tpu_torch.data.coco_eval import evaluate_coco_map

    ds = CocoDataset(args.ann, test_mode=True)
    with open(args.dets) as f:
        raw = json.load(f)
    dets = {int(k): (np.asarray(v["boxes"], np.float64).reshape(-1, 4),
                     np.asarray(v["scores"], np.float64), np.asarray(v["labels"], np.int64))
            for k, v in raw.items()}
    gt = {k: v for k, v in ds.groundtruth().items() if k in dets}
    metrics = evaluate_coco_map(dets, gt, num_classes=len(ds.cat_ids) or 80)
    out = {k: round(v, 4) for k, v in metrics.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
