#!/usr/bin/env python
"""Evaluate a checkpoint on a COCO-format dataset with the PyTorch port
(after tools/test.py).

Usage:
  python tools_torch/test.py --config htd_r50_1x --checkpoint epoch_12.pth \
      --ann annotations/instances_val2017.json --img-root val2017 [--bf16]

Prints one JSON line of metrics (COCO bbox mAP, or the RPN's recalls with
`--eval proposal`). Runs on CUDA; `--device cpu` runs on the CPU.

The bbox evaluation also runs over several processes (the reference's
multi_gpu_test, the JAX tool's `--chips` mesh): `--chips N` starts N local
ranks, rank r on cuda:r mod the card count, each with a batch of
`--batch-size / N` images; under torchrun, `--distributed` joins its
processes instead. The ranks run every N-th batch and gather the
detections; rank 0 prints and writes the dumps.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="htd_r50_1x")
    p.add_argument("--checkpoint", default=None,
                   help="mmdet .pth or one written by tools_torch/train.py; without it, "
                        "random weights from seed 0")
    p.add_argument("--ann", required=True)
    p.add_argument("--img-root", default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--dump", default=None, help="write detections json here")
    p.add_argument("--coco-dump", default=None,
                   help="write a COCO results json (list of {image_id, category_id, bbox "
                        "xywh, score}), the reference's --format-only")
    p.add_argument("--aug", action="store_true",
                   help="multi-scale and flip TTA per image (aug_inference_detector)")
    p.add_argument("--aug-scales", nargs="+", default=None,
                   help="TTA scales as WxH, e.g. 1600x800 1600x1000 (default: the test scale)")
    p.add_argument("--set", dest="cfg_options", nargs="+", default=[],
                   help="config overrides as dotted.path=value, e.g. --set "
                        "rcnn_test.score_thr=0.01")
    p.add_argument("--scale", default=None,
                   help="test img_scale as WxH (default: the config's test_scale)")
    p.add_argument("--eval", default="bbox", choices=["bbox", "proposal"],
                   help="'bbox' = COCO mAP; 'proposal' = the RPN's AR@{100,300,1000}")
    p.add_argument("--fast", action="store_true",
                   help="keep the serving RoIAlign preset (max_samples=4); by default this "
                        "accuracy tool runs the exact mmcv sampling_ratio=0 grid "
                        "(max_samples=8)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs "
                        "on the CPU")
    p.add_argument("--chips", type=int, default=1,
                   help="evaluate over N local processes, each with --batch-size / N images "
                        "per batch (the bbox evaluation only)")
    p.add_argument("--distributed", action="store_true",
                   help="evaluate over the processes torchrun starts (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each with --batch-size images "
                        "per batch")
    p.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of --chips and --distributed: nccl (one "
                        "card per rank) or gloo (the CPU, or ranks that share a card)")
    return p.parse_args(argv)


def coco_results(dataset, dets):
    """COCO results (xywh boxes, category ids) of img_id -> (boxes, scores,
    labels) detections, and the count of detections skipped because their
    label lies past the dataset's categories."""
    n_cats = len(dataset.cat_ids)
    skipped, results = 0, []
    for img_id, (boxes, scores, labels) in dets.items():
        for b, s, lab in zip(boxes, scores, labels):
            if int(lab) >= n_cats:
                skipped += 1
                continue
            results.append(dict(image_id=int(img_id), category_id=int(dataset.cat_ids[int(lab)]),
                                bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                                      float(b[3] - b[1])],
                                score=float(s)))
    return results, skipped


def main(argv=None):
    args = parse_args(argv)
    if (args.chips > 1 or args.distributed) and (args.aug or args.eval != "bbox"):
        raise ValueError("--chips and --distributed cover the bbox evaluation only, not "
                         "--aug or --eval proposal")
    if args.chips > 1:
        if args.distributed:
            raise ValueError("--chips starts its own ranks: leave out --distributed")
        if args.batch_size % args.chips:
            raise ValueError(f"--batch-size {args.batch_size} is not divisible by --chips "
                             f"{args.chips}")
        return _spawn_ranks(args)
    group, device = None, args.device
    if args.distributed:
        import torch.distributed as dist

        from htd_tpu_torch.parallel import init_distributed

        device = init_distributed(args.dist_backend, device=args.device)
        group = dist.group.WORLD
    try:
        return evaluate(args, device, group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _spawn_ranks(args):
    """`--chips N`: N spawned local ranks meeting at a file in a temporary
    directory; rank 0 prints the metrics and leaves them there."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    # ranks on the CPU share this process's threads
    threads = max(1, torch.get_num_threads() // args.chips)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(args, tmp, threads), nprocs=args.chips, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "metrics.json")) as f:
            return json.load(f)


def _rank_main(rank, args, tmp, threads):
    import torch
    import torch.distributed as dist

    from htd_tpu_torch.parallel import init_distributed

    torch.set_num_threads(threads)
    device = init_distributed(args.dist_backend, f"file://{tmp}/rendezvous", rank=rank,
                              world_size=args.chips, local_rank=rank, device=args.device)
    sub = argparse.Namespace(**{**vars(args), "batch_size": args.batch_size // args.chips})
    try:
        out = evaluate(sub, device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(out, f)


def evaluate(args, device, group=None):
    """The evaluation `args` ask for on `device`, over the process `group`
    when given (then only rank 0 prints and dumps); returns the metrics
    it printed."""
    import numpy as np

    from htd_tpu_torch import config as C
    from htd_tpu_torch.apis import (aug_inference_detector, evaluate_dataset,
                                    evaluate_proposals, init_detector)
    from htd_tpu_torch.data.coco import CocoDataset
    from htd_tpu_torch.data.coco_eval import evaluate_coco_map
    from htd_tpu_torch.parallel import world

    rank = world(group)[0] if group is not None else 0
    cfg = getattr(C, args.config)()
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16")
    if args.cfg_options:
        cfg = C.apply_overrides(cfg, args.cfg_options)
    user_set_ms = any(o.split("=")[0].strip() == "roi_extractor.max_samples"
                      for o in args.cfg_options)
    if not args.fast and not user_set_ms:
        cfg = C.apply_overrides(cfg, ["roi_extractor.max_samples=8"])
        if rank == 0:
            print("[test] exact RoIAlign grid (max_samples=8); pass --fast for the serving "
                  "preset", file=sys.stderr)
    scale = tuple(int(v) for v in args.scale.split("x")) if args.scale else cfg.test_scale
    dataset = CocoDataset(args.ann, args.img_root, test_mode=True)
    model = init_detector(cfg, args.checkpoint, device=device)

    if args.eval == "proposal":
        metrics = evaluate_proposals(model, dataset, batch_size=args.batch_size, scale=scale,
                                     max_images=args.max_images)
    elif args.aug:
        scales = ([tuple(int(v) for v in s.split("x")) for s in args.aug_scales]
                  if args.aug_scales else [scale])
        dets = {}
        for i, rec in enumerate(dataset.records):
            if args.max_images and i >= args.max_images:
                break
            b, s_, lab = aug_inference_detector(model, dataset.load_image(rec), scales=scales,
                                                flip=True)
            dets[rec.img_id] = (b.astype(np.float64), s_.astype(np.float64), lab)
        gt = {k: v for k, v in dataset.groundtruth().items() if k in dets}
        metrics = evaluate_coco_map(dets, gt, num_classes=len(dataset.cat_ids) or 80)
    else:
        metrics, dets = evaluate_dataset(model, dataset, batch_size=args.batch_size, scale=scale,
                                         max_images=args.max_images, return_detections=True,
                                         log_every=50 if rank == 0 else 0, group=group)
        if args.dump and rank == 0:
            with open(args.dump, "w") as f:
                json.dump({str(k): dict(boxes=v[0].tolist(), scores=v[1].tolist(),
                                        labels=v[2].tolist()) for k, v in dets.items()}, f)
        if args.coco_dump and rank == 0:
            results, skipped = coco_results(dataset, dets)
            if skipped:
                print(f"[coco-dump] skipped {skipped} detections with labels >= "
                      f"{len(dataset.cat_ids)} dataset categories", file=sys.stderr)
            with open(args.coco_dump, "w") as f:
                json.dump(results, f)
    out = {k: round(v, 4) for k, v in metrics.items()}
    if rank == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
