#!/usr/bin/env python
"""Train HTD on a COCO-format dataset with the PyTorch port (after
tools/train.py: epoch loop, json-line log, a checkpoint and the validation
mAP after each epoch), in one process or data-parallel over torchrun's
processes.

Usage:
  python tools_torch/train.py --config htd_r50_1x \
      --train-ann annotations/instances_train2017.json --train-img train2017 \
      --val-ann annotations/instances_val2017.json --val-img val2017 \
      --work-dir work_dirs/htd_r50 [--pretrained backbone.pth] [--bf16]
  torchrun --standalone --nproc_per_node 8 tools_torch/train.py --distributed \
      --dist-backend nccl --batch-size 16 ...

Runs on CUDA; `--device cpu` runs on the CPU. A run resumed with
`--resume-from epoch_k.pth` continues as the uninterrupted run would: the
epoch follows from the saved step, each epoch's augmentation stream and
batch order from the seed and the epoch, and each step's sampling from the
seed and the step (and, with several ranks, the rank).

With `--distributed` every process forms the same global batch of
`--batch-size` images, loads its contiguous slice of it (the flips drawn
for the whole batch first) and joins one all-reduce per step; rank 0
writes the log, the checkpoints and runs the validation.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="htd_r50_1x")
    p.add_argument("--train-ann", required=True)
    p.add_argument("--train-img", default="")
    p.add_argument("--val-ann", default=None)
    p.add_argument("--val-img", default="")
    p.add_argument("--work-dir", default="work_dirs/htd")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pretrained", default=None,
                   help="mmdet .pth whose matching tensors (a backbone, say) overlay the "
                        "fresh model")
    p.add_argument("--resume-from", default=None, help="epoch_k.pth of an earlier run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--set", dest="cfg_options", nargs="+", default=[],
                   help="config overrides as dotted.path=value, e.g. --set train.lr=0.01")
    p.add_argument("--mstrain", action="store_true",
                   help="multi-scale training (short side uniform in [400, 1400], long side "
                        "1600) even where the preset has no range")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs "
                        "on the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the processes torchrun starts (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); --batch-size stays the global "
                        "batch; each rank on cuda:LOCAL_RANK unless --device cpu")
    p.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend with --distributed: nccl (one card per "
                        "rank) or gloo (the CPU, or ranks that share a card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the JSON records it printed: the log lines, then each
    epoch's validation metrics (rank 0's; the other ranks' are empty)."""
    args = parse_args(argv)
    import numpy as np
    import torch.distributed as dist

    from htd_tpu_torch import config as C
    from htd_tpu_torch.apis import evaluate_dataset, init_detector
    from htd_tpu_torch.data.coco import (CocoDataset, grouped_batches, make_train_batch,
                                         sample_mstrain_scale)
    from htd_tpu_torch.parallel import broadcast_parameters, host_slice, init_distributed
    from htd_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from htd_tpu_torch.train.train_step import create_train_state, step_generator, train_step
    from htd_tpu_torch.utils import collect_env, get_root_logger

    device, group, rank, world_size = args.device, None, 0, 1
    if args.distributed:
        device = init_distributed(args.dist_backend, device=args.device)
        group, rank, world_size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        if args.batch_size % world_size:
            raise ValueError(f"--batch-size {args.batch_size} is not divisible by the "
                             f"{world_size} ranks")
    cfg = getattr(C, args.config)()
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16")
    if args.cfg_options:
        cfg = C.apply_overrides(cfg, args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(args.work_dir, "train.log"))
    if rank == 0:
        with open(os.path.join(args.work_dir, "config.json"), "w") as f:
            f.write(C.dump_config(cfg))
        logger.info(f"environment: {json.dumps(collect_env())}")

    dataset = CocoDataset(args.train_ann, args.train_img, test_mode=False)
    # the batches an epoch runs: each orientation's remainder is dropped
    steps_per_epoch = sum(1 for _ in grouped_batches(dataset, args.batch_size, shuffle=False,
                                                     drop_last=True))
    if steps_per_epoch == 0:
        raise ValueError(f"no full batch of {args.batch_size} images of one orientation")
    logger.info(f"train images: {len(dataset)}, steps/epoch: {steps_per_epoch}, ranks: "
                f"{world_size}")
    state = create_train_state(cfg, device=device, seed=args.seed,
                               steps_per_epoch=steps_per_epoch, pretrained=args.pretrained)
    dev = state.model.device
    start_epoch = 0
    if args.resume_from:
        restore_checkpoint(args.resume_from, state)
        if state.steps_per_epoch != steps_per_epoch:
            raise ValueError(f"{args.resume_from} ran {state.steps_per_epoch} steps per epoch; "
                             f"this dataset and batch size give {steps_per_epoch}")
        start_epoch = state.step // steps_per_epoch
        logger.info(f"resumed at step {state.step} -> epoch {start_epoch}")
    if group is not None:
        broadcast_parameters(state.model, 0, group)

    mstrain_range = cfg.train.mstrain_range
    if args.mstrain and mstrain_range is None:
        mstrain_range = ((1600, 400), (1600, 1400))
    log_path = os.path.join(args.work_dir, "train.log.json")
    records = []
    t0 = time.time()
    for epoch in range(start_epoch, cfg.train.total_epochs):
        # per-epoch-seeded augmentation stream (scales, flips): a run resumed
        # at epoch k draws the uninterrupted run's schedule
        rng = np.random.RandomState(args.seed * 100003 + epoch)
        for it, recs in enumerate(grouped_batches(dataset, args.batch_size, shuffle=True,
                                                  seed=args.seed + epoch, drop_last=True)):
            scale = (sample_mstrain_scale(rng, mstrain_range) if mstrain_range is not None
                     else cfg.train.img_scale)
            # flips drawn for the global batch, then each rank loads its
            # slice: every rank follows the one-process run's schedule
            flips = rng.rand(len(recs)) < 0.5
            batch = make_train_batch(dataset, host_slice(recs, rank, world_size),
                                     scale=scale, max_gt=cfg.train.max_gt,
                                     flips=host_slice(flips, rank, world_size), device=dev)
            gen = step_generator(args.seed, state.step, dev, rank, world_size)
            metrics = train_step(state, batch, gen, group=group)
            if (it + 1) % args.log_interval == 0 and rank == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                m.update(epoch=epoch + 1, iter=it + 1, time=round(time.time() - t0, 1))
                print(json.dumps(m))
                records.append(m)
                with open(log_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
        ckpt = os.path.join(args.work_dir, f"epoch_{epoch + 1}.pth")
        if rank == 0:
            save_checkpoint(ckpt, state, meta={"epoch": epoch + 1})
            logger.info(f"saved {ckpt}")
        if args.val_ann and rank == 0:
            val = CocoDataset(args.val_ann, args.val_img, test_mode=True)
            model = init_detector(cfg, ckpt, device=dev)
            metrics = evaluate_dataset(model, val, batch_size=args.batch_size)
            del model
            m = {"epoch": epoch + 1, **{k: round(v, 4) for k, v in metrics.items()}}
            print(json.dumps(m))
            records.append(m)
        if group is not None:
            dist.barrier()
    if group is not None:
        dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
