#!/usr/bin/env python
"""Training smoke of the PyTorch port: N full-resolution train steps on
synthetic data (after tools/train_smoke.py); prints the loss curve and
whether it fell below 0.7 of its first value.

Usage: python tools_torch/train_smoke.py [--steps 300] [--batch 2] [--bf16]

Runs on CUDA; `--device cpu` runs on the CPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Returns the JSON records it printed."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--config", default="htd_r50_1x")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset's lr")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs "
                        "on the CPU")
    args = p.parse_args(argv)
    import dataclasses

    import numpy as np
    import torch

    from htd_tpu_torch import config as C
    from htd_tpu_torch.train.train_step import (TrainBatch, create_train_state, step_generator,
                                                train_step)

    cfg = getattr(C, args.config)()
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16")
    if args.lr is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=args.lr))
    state = create_train_state(cfg, device=args.device, seed=0, steps_per_epoch=1000)
    dev = state.model.device

    rng = np.random.RandomState(0)
    b, h, w = args.batch, args.height, args.width
    max_gt = cfg.train.max_gt

    def make_batch():
        images = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
        gt_boxes = np.zeros((b, max_gt, 4), np.float32)
        gt_labels = np.zeros((b, max_gt), np.int32)
        gt_valid = np.zeros((b, max_gt), bool)
        for i in range(b):
            for g in range(min(6, max_gt)):
                bw, bh = rng.uniform(w / 30, w / 12), rng.uniform(h / 20, h / 7)
                x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                gt_boxes[i, g] = [x1, y1, x1 + bw, y1 + bh]
                gt_labels[i, g] = rng.randint(0, cfg.num_classes)
                gt_valid[i, g] = True
                # paint the object so that there is a signal to fit
                images[i, int(y1):int(y1 + bh), int(x1):int(x1 + bw)] += 0.5 + 0.1 * gt_labels[i, g]
        shapes = np.tile([[h - 18.0, w - 11.0]], (b, 1)).astype(np.float32)
        return TrainBatch(*(torch.from_numpy(a).to(dev)
                            for a in (images, shapes, gt_boxes, gt_labels, gt_valid)))

    pool = [make_batch() for _ in range(4)]   # a small pool of fixed batches
    records = []
    t0 = time.time()
    first = last = None
    for it in range(args.steps):
        metrics = train_step(state, pool[it % len(pool)], step_generator(1, state.step, dev))
        if it % args.log_every == 0 or it == args.steps - 1:
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {it}: {loss}")
            first = loss if first is None else first
            last = loss
            records.append({"iter": it, "loss": round(loss, 4),
                            "s0.acc": round(float(metrics["s0.acc"]), 4),
                            "rpn_cls": round(float(metrics["loss_rpn_cls"]), 4),
                            "s1_cls": round(float(metrics["s1.loss_cls"]), 4),
                            "elapsed_s": round(time.time() - t0, 1)})
            print(json.dumps(records[-1]), flush=True)
    records.append({"first": first, "last": last, "converged": bool(last < 0.7 * first)})
    print(json.dumps(records[-1]))
    return records


if __name__ == "__main__":
    main()
