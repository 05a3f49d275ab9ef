"""The readings that a cell's limits are set from, on the card:

- the program's: full runs of the cell (a short window at the cell's own
  load) on each seed, judged as every run is judged;
- the control's: the reference computed in the next precision below the
  configuration's (fp8 e4m3 for bfloat16: `reference.ops.Precision`) put
  in the program's place, judged the same way on as many requests;
- a diagnostic: the reference in bfloat16, judged the same way;
- with `--fault NAME ...`, the program's readings with each fault of
  `bench_h100/faults.py` planted in its timed path in turn, in place of
  the sound program's.

For a training cell the stand-ins follow the run's first steps on the
same batches and draws, and are held to the float32 reference's.

    python3 bench_h100/control.py --workload r50.infer --seeds 11 12 13 --seconds 4 \
        [--dump DIR] [--fault NAME ...] [--sides program fp8 bfloat16]

Prints one JSON line per seed and side; `--dump` also writes what was
compared, one pickle per seed. The benchmark's own runs never run it.
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
    from bench_h100.reference.detector import Reference
    from bench_h100.weights import make_state_dict

    doc, tp = cell.config, cell.traffic
    pool = make_pool(tp, seed)
    order = np.random.default_rng(seed + 1).permutation(len(pool))
    imgs = [pool[int(order[j])] for j in range(tp["check_requests"])]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = make_state_dict(doc["config"], doc["assumed"], seed, device)
    ref = Reference(doc["config"], sd)
    truth = [ref.detect(img) for img in imgs]
    return {prec: [(Reference(doc["config"], sd, prec).detect(img)[0],) + t
                   for img, t in zip(imgs, truth)] for prec in precisions}


def train_control(cell, seed: int, device: str, precisions=("fp8", "bfloat16")):
    """For each of `precisions`: the readings of the training reference in
    that precision over the run's first steps, and the float32
    reference's under "float32"."""
    from bench_h100.generators import train_steps as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feed = T.Feed(cell.config["config"], cell.traffic, seed)
    out = {"float32": T.reference_steps(cell.config, feed, seed, device)}
    for p in precisions:
        out[p] = T.reference_steps(cell.config, feed, seed, device, p)
    return out


def main(argv=None) -> int:
    from bench_h100 import faults
    from bench_h100.reference.judge import detection_numbers

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--dump", type=Path)
    ap.add_argument("--fault", nargs="+", default=[])
    ap.add_argument("--sides", nargs="+", default=["program", "fp8", "bfloat16"])
    args = ap.parse_args(argv)
    harness.pin_caches()
    cell = harness.load_cell(args.workload)
    harness.card(cell.chips)
    gen = harness.load_module("generators", cell.traffic["generator"])
    programs = [(f, getattr(faults, f)) for f in args.fault] or [("program", None)]
    stand_ins = tuple(p for p in args.sides if p != "program")
    training = cell.traffic["generator"] == "train_steps"
    for seed in args.seeds:
        sides = {}
        for name, program in programs if "program" in args.sides else ():
            t = time.perf_counter()
            out = gen.run(harness.Context(cell, seed, args.seconds, False, t, program=program,
                                          keep_pairs=True))
            print(json.dumps({"seed": seed, "side": name, "numbers": out.numbers, "e2e": out.e2e,
                              "attempted": out.attempted, "failed": out.failed,
                              "notes": out.notes}), flush=True)
            sides[name] = out.info.get("pairs") or out.info.get("readings")
        t = time.perf_counter()
        if training and stand_ins:
            from bench_h100.generators.train_steps import compare, dcn_leaf_names

            readings = train_control(cell, seed, "cuda", stand_ins)
            sides.update(readings)
            for prec in stand_ins:
                print(json.dumps({"seed": seed, "side": prec,
                                  "numbers": compare(readings[prec], readings["float32"],
                                                     dcn_leaf_names(cell.config["config"])),
                                  "seconds": time.perf_counter() - t}), flush=True)
        elif stand_ins:
            for prec, pairs in control_pairs(cell, seed, "cuda", stand_ins).items():
                sides[prec] = pairs
                print(json.dumps({"seed": seed, "side": prec,
                                  "numbers": detection_numbers(pairs),
                                  "seconds": time.perf_counter() - t}), flush=True)
        if args.dump:
            args.dump.mkdir(parents=True, exist_ok=True)
            with open(args.dump / f"{args.workload}.{seed}.pkl", "wb") as f:
                pickle.dump(sides, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
