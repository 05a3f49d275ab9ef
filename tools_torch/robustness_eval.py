#!/usr/bin/env python
"""Corruption benchmark aggregation: P / mPC / rPC, with the PyTorch port
(after tools/robustness_eval.py; the reference's robustness_eval.py:34-108,
get_coco_style_results).

Reads the aggregated json written by tools_torch/test_robustness.py
({corruption: {severity: {"bbox": {metric: value}}}}) and reports

  P    — performance on clean data (severity 0 of the first corruption),
  mPC  — mean performance under corruption (severities 1..5, averaged over
         corruptions; the 'benchmark' aggregate restricts to the 15
         ImageNet-C benchmark corruptions),
  rPC  — relative: mPC / P.

Usage: python tools_torch/robustness_eval.py robustness.json --prints P mPC rPC
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from htd_tpu_torch.data.corruptions import BENCHMARK_CORRUPTIONS  # noqa: E402

METRICS = ["mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l", "AR@100"]


def get_results(filename, task="bbox", metric=None, prints="mPC",
                aggregate="benchmark"):
    """Compute and print P/mPC/rPC; returns {print_name: {metric: value}}."""
    if aggregate not in ("benchmark", "all"):
        raise ValueError(f"aggregate must be 'benchmark' or 'all', got {aggregate!r}")
    if prints == "all":
        prints = ["P", "mPC", "rPC"]
    elif isinstance(prints, str):
        prints = [prints]
    for pr in prints:
        if pr not in ("P", "mPC", "rPC"):
            raise ValueError(f"unknown print {pr!r}")
    metrics = METRICS if metric is None else (
        metric if isinstance(metric, list) else [metric]
    )

    with open(filename) as f:
        eval_output = json.load(f)

    corruptions = list(eval_output.keys())
    first = corruptions[0]
    if "0" not in eval_output[first]:
        raise ValueError(
            "severity 0 (clean) missing from the results json; rerun "
            "test_robustness.py with 0 in --severities"
        )

    def _get(res, m):
        v = res.get(m, np.nan)
        return np.nan if v is None else v

    p_vec = np.array(
        [_get(eval_output[first]["0"][task], m) for m in metrics], np.float64
    )

    rows = []
    for corr in corruptions:
        if aggregate == "benchmark" and corr not in BENCHMARK_CORRUPTIONS:
            continue
        for sev, res in eval_output[corr].items():
            if int(sev) == 0:
                continue
            rows.append([_get(res[task], m) for m in metrics])
    if rows:
        mpc_vec = np.nanmean(np.asarray(rows, np.float64), axis=0)
    else:
        mpc_vec = np.full(len(metrics), np.nan)
    rpc_vec = mpc_vec / np.where(p_vec > 0, p_vec, np.nan)

    out = {}
    print(f"\nmodel: {os.path.basename(filename)}")
    named = {
        "P": ("Performance on Clean Data [P]", p_vec, "{:0.3f}"),
        "mPC": ("Mean Performance under Corruption [mPC]", mpc_vec, "{:0.3f}"),
        "rPC": ("Relative Performance under Corruption [rPC]", rpc_vec, "{:0.1%}"),
    }
    for pr in prints:
        title, vec, fmt = named[pr]
        print(f"{title} ({task})")
        out[pr] = {}
        for m, v in zip(metrics, vec):
            print(f"  {m:7} = {fmt.format(v)}")
            out[pr][m] = float(v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Corruption result analysis")
    p.add_argument("filename", help="aggregated results json")
    p.add_argument("--task", default="bbox", choices=["bbox"])
    p.add_argument("--metric", nargs="+", default=None, choices=METRICS)
    p.add_argument("--prints", nargs="+", default=["mPC"],
                   choices=["P", "mPC", "rPC"])
    p.add_argument("--aggregate", default="benchmark",
                   choices=["all", "benchmark"])
    args = p.parse_args(argv)
    return get_results(
        args.filename, task=args.task, metric=args.metric,
        prints=args.prints, aggregate=args.aggregate,
    )


if __name__ == "__main__":
    main()
