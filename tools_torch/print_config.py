#!/usr/bin/env python
"""Print a resolved config of the PyTorch port (after tools/print_config.py).

Usage: python tools_torch/print_config.py [htd_r50_1x]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default="htd_r50_1x")
    args = p.parse_args(argv)

    from htd_tpu_torch import config as C

    text = C.dump_config(getattr(C, args.config)())
    print(text)
    return text


if __name__ == "__main__":
    main()
