"""The stand-ins' readings for the limits of DetectoRS R-50's cell
(`detectors_r50.infer`), on the card: DetectoRS's plain reference
(`reference/detectors.py`) computed in the next precision below the
configuration's (fp8 e4m3 for bfloat16: `reference.ops.Precision`), and in
bfloat16 as a diagnostic, put in the program's place on the first
`check_requests` requests of each seed's order and judged against the
float32 reference as every run is judged. The program's own readings and
those of the planted faults come from `control.py --sides program
[--fault ...]`, which runs the cell's generator.

    python3 bench_h100/control_rfp.py --workload detectors_r50.infer --seeds 11 12 \
        [--sides fp8 bfloat16] [--dump DIR]

Prints one JSON line per seed and side. The benchmark's own runs never
run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)   # the checkout, not bench_h100/

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100 import harness  # noqa: E402


def control_pairs(cell, seed: int, device: str, precisions=("fp8", "bfloat16")):
    """For each of `precisions`: (stand-in, strict, relaxed) detections of
    the reference in that precision standing in for the program on the
    first `check_requests` requests of the seed's order."""
    from bench_h100.images import make_pool
    from bench_h100.reference.detectors import DetectorsReference
    from bench_h100.weights_rfp import make_state_dict

    doc, tp = cell.config, cell.traffic
    pool = make_pool(tp, seed)
    order = np.random.default_rng(seed + 1).permutation(len(pool))
    imgs = [pool[int(order[j])] for j in range(tp["check_requests"])]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = make_state_dict(doc["config"], doc["assumed"], seed, device)
    ref = DetectorsReference(doc["config"], sd)
    truth = [ref.detect(img) for img in imgs]
    return {prec: [(DetectorsReference(doc["config"], sd, prec).detect(img)[0],) + t
                   for img, t in zip(imgs, truth)] for prec in precisions}


def main(argv=None) -> int:
    from bench_h100.reference.judge import detection_numbers

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="detectors_r50.infer")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["fp8", "bfloat16"])
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)
    harness.pin_caches()
    cell = harness.load_cell(args.workload)
    harness.card(cell.chips)
    for seed in args.seeds:
        t = time.perf_counter()
        sides = control_pairs(cell, seed, "cuda", tuple(args.sides))
        for prec, pairs in sides.items():
            print(json.dumps({"seed": seed, "side": prec, "numbers": detection_numbers(pairs),
                              "seconds": time.perf_counter() - t}), flush=True)
        if args.dump:
            args.dump.mkdir(parents=True, exist_ok=True)
            with open(args.dump / f"{args.workload}.{seed}.stand_ins.pkl", "wb") as f:
                pickle.dump(sides, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
