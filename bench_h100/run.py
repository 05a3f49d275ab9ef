"""One run of one cell of the port's benchmark (`BENCHMARK.json`).

    python3 bench_h100/run.py --workload r50.infer --seed 7 --seconds 30 --trace 0

Set-up builds `htd_tpu_torch`'s system under test with weights drawn on
the card from the seed, makes the cell's inputs and warms up every shape
they use; then the window runs for `--seconds`. With `--trace 1` a fixed
stretch after the window is profiled and the line carries the cell's
per-layer metrics instead of its end-to-end ones. After the window the
program's state is freed and the plain reference judges a seeded sample
of the window's outputs; each number compared is printed beside its limit
on standard error and, last, in the result's line. The last line of
standard output is the result: one JSON object.

No card, too few cards, or a module of JAX or of the JAX package loaded
once the window has closed: a message on standard error, no result, and a
non-zero exit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)   # the checkout, not bench_h100/

from bench_h100 import harness  # noqa: E402
from bench_h100.harness import log  # noqa: E402


def per_layer_values(cell, outcome):
    """Each per-layer metric's reader over the traced stretch; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = harness.load_module("metrics", m["name"]).read(outcome.trace, outcome.info)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(tr):
    """The 10 device ops that took most time, and the 10 longest idle gaps
    of the stretch by the htd.* span (or the entry) open on the host."""
    from bench_h100.trace import gaps

    per = {}
    for name, a, b, _ in tr.device:
        per[name] = per.get(name, 0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    idle = []
    for a, b in gaps(((a, b) for _, a, b, _ in tr.device), tr.start, tr.end):
        open_span = next((n for n, s, e in tr.spans if s <= a < e), "entry")
        idle.append((open_span, (b - a) / 1e9))
    idle.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": [list(g) for g in idle[:10]]}


def execute(cell, ctx, device: dict):
    """Everything of a run after the look for the card: the window, the
    import check, the metrics and the judgement. Returns (exit code,
    result or None); prints the earlier lines."""
    gen = harness.load_module("generators", cell.traffic["generator"])
    outcome = gen.run(ctx)

    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 4, None
    print(f"import check: no module whose top-level name is one of "
          f"{', '.join(harness.FORBIDDEN)} is loaded")
    for note in outcome.notes:
        print(note)

    if ctx.trace:
        tr = outcome.trace
        print(f"traced stretch: {len(tr.units)} units over {(tr.end - tr.start) / 1e9:.6f} s, "
              f"{len(tr.device)} device records, {tr.lost} launches lost their kernel record")
        metrics = per_layer_values(cell, outcome)
        from bench_h100.trace import busy_ns

        device["busy_s"] = busy_ns(tr) / 1e9
        device["window_s"] = (tr.end - tr.start) / 1e9
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device["memory_peak_bytes"] = outcome.memory_peak_bytes

    from bench_h100.reference.judge import held

    ok, rows = held(outcome.numbers, cell.limits["numbers"], outcome.failed)
    print("judged: " + ", ".join(f"{k} {v!r}" for k, v in outcome.numbers.items()))
    for name, value, limit in rows:
        log(f"{name} {value!r} limit {limit!r}")
    result = {"correct": bool(ok), "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        result["breakdown"] = breakdown(outcome.trace)
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    if not all(math.isfinite(v["value"]) for v in metrics.values()):
        log("a metric is not finite")
        return 5, None
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.pin_caches()
    cell = harness.load_cell(args.workload)
    device = harness.card(cell.chips)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), T0)
    rc, result = execute(cell, ctx, device)
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
