#!/usr/bin/env python
"""Strip a training checkpoint to publishable weights and name it by its
content hash (after tools/publish_model.py and mmdet's).

Keeps "state_dict" (the model's tensors, BatchNorm buffers included) and
"meta", drops "optimizer", and renames the output `<out>-<first 8 hex
digits of its sha256>.pth`.

Usage: python tools_torch/publish_model.py work_dirs/htd/epoch_12.pth htd_r50.pth
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("in_file", help="checkpoint written by tools_torch/train.py")
    p.add_argument("out_file", help="output .pth; '-<hash8>' is inserted before .pth")
    args = p.parse_args(argv)
    import torch

    ckpt = torch.load(args.in_file, map_location="cpu", weights_only=True)
    out = {"state_dict": ckpt["state_dict"], "meta": ckpt.get("meta", {})}
    stem = args.out_file[:-4] if args.out_file.endswith(".pth") else args.out_file
    tmp = stem + ".pth.tmp"
    torch.save(out, tmp)
    h = hashlib.sha256()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    final = f"{stem}-{h.hexdigest()[:8]}.pth"
    os.replace(tmp, final)
    print(final)
    return final


if __name__ == "__main__":
    main()
