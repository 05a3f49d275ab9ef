"""The whole train step's share of the card's bf16 peak, in %: the frozen
training operations per image of each step's bucket
(counts/model.train_flops) times the images per second of the traced
run's unprofiled window on one card, over 989 TFLOP/s."""

from bench_h100.counts import BF16_FLOP_PER_S
from bench_h100.counts.model import train_flops


def read(tr, info):
    buckets = info["window_buckets"]
    if not buckets:
        return None
    per_image = sum(train_flops(info["config"], hw) for hw in buckets) / len(buckets)
    return 100.0 * per_image * info["units_per_s"] * info["batch"] / BF16_FLOP_PER_S
