"""The whole request's share of the card's bf16 peak, in %: the frozen
model operations of each request's bucket (counts/model.infer_flops) times
the requests per second of the traced run's unprofiled window, over
989 TFLOP/s."""

from bench_h100.counts import BF16_FLOP_PER_S
from bench_h100.counts.model import infer_flops


def read(tr, info):
    flops = [infer_flops(info["config"], hw) for hw in info["window_buckets"]]
    if not flops:
        return None
    return 100.0 * sum(flops) / len(flops) * info["units_per_s"] / BF16_FLOP_PER_S
