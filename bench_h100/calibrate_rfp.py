"""The offset convs' and switches' stds of a configuration with
switchable atrous convs: for each SAC conv, the std of its seeded
`offset_s` / `offset_l` weights that gives offsets of about `offset_px` px,
offset_px / (sqrt(9 * C) * rms(a)), and of its switch's weight that spreads
the switch by about `switch_spread` around its bias, switch_spread /
(sqrt(C) * rms(a)), with rms(a) the rms of the conv's 5x5 average (what
both read), read by the float32 reference with zero offsets and a
constant switch on one seeded image of the test scale.

    python3 bench_h100/calibrate_rfp.py htd_detectors_r50_1x [--write]

Prints the two lists; `--write` stores them under `assumed` of the
configuration file.
"""

import argparse
import json
import math
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)   # the checkout, not bench_h100/

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100.reference.detectors import DetectorsReference, sac_convs  # noqa: E402
from bench_h100.weights_rfp import make_state_dict  # noqa: E402


def stds(doc: dict, device, seed: int = 0):
    convs = sac_convs(doc["config"])
    assumed = dict(doc["assumed"], offset_weight_std=[0.0] * len(convs),
                   switch_weight_std=[0.0] * len(convs))
    ref = DetectorsReference(doc["config"], make_state_dict(doc["config"], assumed, seed, device))
    img = np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    rms = ref.sac_input_rms(img)
    a = doc["assumed"]
    return ([a["offset_px"] / (math.sqrt(9 * c) * r) for (_, c, _), r in zip(convs, rms)],
            [a["switch_spread"] / (math.sqrt(c) * r) for (_, c, _), r in zip(convs, rms)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    path = Path(__file__).resolve().parent / "configs" / f"{args.config}.json"
    doc = json.loads(path.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    offsets, switches = stds(doc, "cuda" if torch.cuda.is_available() else "cpu")
    print(json.dumps({"offset_weight_std": offsets, "switch_weight_std": switches}))
    if args.write:
        doc["assumed"]["offset_weight_std"] = offsets
        doc["assumed"]["switch_weight_std"] = switches
        path.write_text(json.dumps(doc, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
