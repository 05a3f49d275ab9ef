#!/usr/bin/env python
"""Plot loss and metric curves from a train.log.json (after
tools/analyze_logs.py); without matplotlib, print first, min and last of
each key.

Usage: python tools_torch/analyze_logs.py work_dirs/htd/train.log.json --keys loss s0.loss_cls
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("log")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    with open(args.log) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    lines = []
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        for k in args.keys:
            ax.plot(range(len(rows)), [r.get(k) for r in rows], label=k)
        ax.legend()
        ax.set_xlabel("log step")
        out = args.out or args.log + ".png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        lines.append(f"saved {out}")
    except ImportError:
        for k in args.keys:
            ys = [r[k] for r in rows if k in r]
            if ys:
                lines.append(f"{k}: first={ys[0]} min={min(ys)} last={ys[-1]}")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
