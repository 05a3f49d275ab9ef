#!/usr/bin/env python
"""Corruption-robustness benchmark with the PyTorch port (after
tools/test_robustness.py; the reference's tools/test_robustness.py).

Evaluates a checkpoint on a COCO-format set under the ImageNet-C
corruption grid (corruption x severity; severity 0 = clean, evaluated once
and reused for every corruption) and writes the aggregated results json
that tools_torch/robustness_eval.py reads (P / mPC / rPC). The corruption
is applied to the raw image before Resize (`CorruptedDataset`, the
reference's Corrupt step inserted at position 1 of the test pipeline).

Every requested name is checked before any evaluation: one that is neither
a corruption nor a group fails at once. All 19 corruptions of the reference
are ported (`htd_tpu_torch.data.corruptions`). Runs on CUDA; `--device cpu`
runs on the CPU.

Usage:
  python tools_torch/test_robustness.py --config htd_r50_1x --checkpoint ckpt \
      --ann instances_val2017.json --img-root val2017 \
      --out work_dir/robustness.json --corruptions noise fog contrast
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
    p.add_argument("--out", required=True, help="aggregated results json path")
    p.add_argument(
        "--corruptions", nargs="+", default=["benchmark"],
        help="corruption names or groups (all/benchmark/noise/blur/weather/"
             "digital/holdout/None)",
    )
    p.add_argument("--severities", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0, help="corruption RNG seed")
    p.add_argument("--scale", default=None, help="test img_scale as WxH")
    p.add_argument(
        "--summaries", action="store_true",
        help="print the metric dict for every (corruption, severity)",
    )
    p.add_argument(
        "--final-prints", nargs="+", default=["mPC"],
        choices=["P", "mPC", "rPC"],
    )
    p.add_argument(
        "--final-prints-aggregate", default="benchmark",
        choices=["all", "benchmark"],
    )
    p.add_argument(
        "--set", dest="cfg_options", nargs="+", default=[],
        help="config overrides as dotted.path=value",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs "
                        "on the CPU")
    return p, p.parse_args(argv)


def main(argv=None):
    """Runs the grid; returns what robustness_eval.get_results printed."""
    p, args = parse_args(argv)
    from htd_tpu_torch import config as C
    from htd_tpu_torch.apis import evaluate_dataset, init_detector
    from htd_tpu_torch.data.coco import CocoDataset
    from htd_tpu_torch.data.corruptions import ALL_CORRUPTIONS, GROUPS, CorruptedDataset
    from tools_torch.robustness_eval import get_results

    corruptions, severities = [], args.severities
    for name in args.corruptions:
        if name == "None":
            corruptions, severities = ["None"], [0]
            break
        for c in GROUPS.get(name, [name]):
            if c not in ALL_CORRUPTIONS:
                p.error(f"unknown corruption {c!r}")
            if c not in corruptions:
                corruptions.append(c)

    cfg = getattr(C, args.config)()
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16")
    if args.cfg_options:
        cfg = C.apply_overrides(cfg, args.cfg_options)
    scale = (
        tuple(int(v) for v in args.scale.split("x"))
        if args.scale else cfg.test_scale
    )
    model = init_detector(cfg, args.checkpoint, device=args.device)
    dataset = CocoDataset(args.ann, args.img_root, test_mode=True)

    aggregated = {}
    for ci, corruption in enumerate(corruptions):
        aggregated[corruption] = {}
        for severity in severities:
            # severity 0 (clean) is corruption-independent: evaluate once
            # (reference test_robustness.py:243-247)
            if ci > 0 and severity == 0:
                aggregated[corruption]["0"] = aggregated[corruptions[0]]["0"]
                continue
            print(f"\n[robustness] {corruption} severity {severity}")
            ds = (
                dataset
                if severity == 0 or corruption == "None"
                else CorruptedDataset(dataset, corruption, severity, seed=args.seed)
            )
            metrics = evaluate_dataset(
                model, ds, batch_size=args.batch_size, scale=scale,
                max_images=args.max_images,
            )
            # NaN (empty area range) -> null: keep the dump strict JSON
            metrics = {k: (None if v != v else v) for k, v in metrics.items()}
            aggregated[corruption][str(severity)] = {"bbox": metrics}
            if args.summaries:
                print(json.dumps({k: None if v is None else round(v, 4)
                                  for k, v in metrics.items()}))
            # checkpoint the aggregate after every cell (long runs)
            with open(args.out, "w") as f:
                json.dump(aggregated, f, indent=1)

    return get_results(args.out, prints=args.final_prints,
                       aggregate=args.final_prints_aggregate)


if __name__ == "__main__":
    main()
