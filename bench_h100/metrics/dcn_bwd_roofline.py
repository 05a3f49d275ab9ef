"""The deformable convs' backward (K5's d_x and d_col, K6's d_offsets and
d_weight, and whatever later replaces them) against its roofline, in %:
the frozen least time of a step's deformable-conv backwards at its bucket
and batch (counts/model.dcn_bwd_least_s) over the device time of the ops
whose name holds `deform_conv_bwd`, per step."""

from bench_h100.counts.model import dcn_bwd_least_s
from bench_h100.trace import device_ms_named


def read(tr, info):
    ms, n = device_ms_named(tr, "deform_conv_bwd")
    buckets = info["unit_buckets"]
    least = sum(dcn_bwd_least_s(info["config"], hw, info["batch"]) for hw in buckets) / \
        max(len(buckets), 1)
    if not n or least == 0:
        return None
    return 100.0 * least * 1e3 / ms
