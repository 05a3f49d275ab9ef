"""The offset convs' stds of a deformable configuration: for each
deformable conv, the std of its seeded `conv_offset` weight that gives
offsets of about `offset_px` px at that conv's input,
offset_px / (sqrt(9 * Cin) * rms(input)), the rms read by the float32
reference with zero offsets on one seeded image of the test scale.

    python3 bench_h100/calibrate_offsets.py htd_r101_dcn_2x [--write]

Prints the list; `--write` stores it under `assumed.offset_weight_std` of
the configuration file.
"""

import argparse
import json
import math
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)   # the checkout, not bench_h100/

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100.reference.detector import Reference, dcn_convs  # noqa: E402
from bench_h100.weights import make_state_dict  # noqa: E402


def stds(doc: dict, device, seed: int = 0):
    assumed = dict(doc["assumed"], offset_weight_std=[0.0] * len(dcn_convs(doc["config"])))
    ref = Reference(doc["config"], make_state_dict(doc["config"], assumed, seed, device))
    img = np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    rms = ref.dcn_input_rms(img)
    return [doc["assumed"]["offset_px"] / (math.sqrt(9 * cin) * r)
            for (_, cin, _, _), r in zip(dcn_convs(doc["config"]), rms)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    path = Path(__file__).resolve().parent / "configs" / f"{args.config}.json"
    doc = json.loads(path.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = stds(doc, "cuda" if torch.cuda.is_available() else "cpu")
    print(json.dumps(got))
    if args.write:
        doc["assumed"]["offset_weight_std"] = got
        path.write_text(json.dumps(doc, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
