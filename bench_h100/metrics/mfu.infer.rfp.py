"""DetectoRS R-50 under HTD's heads: the whole request's share of the
card's bf16 peak, in %: the frozen operations of each request's bucket
(counts/detectors.infer_flops: both backbones, SAC, ASPP, the FPN twice,
the RPN and the heads) times the requests per second of the traced run's
unprofiled window, over 989 TFLOP/s."""

from bench_h100.counts import BF16_FLOP_PER_S
from bench_h100.counts.detectors import infer_flops


def read(tr, info):
    flops = [infer_flops(info["config"], hw) for hw in info["window_buckets"]]
    if not flops:
        return None
    return 100.0 * sum(flops) / len(flops) * info["units_per_s"] / BF16_FLOP_PER_S
