"""The deformable convs' forward (K3) against its roofline, in %: the
frozen least time of a request's deformable-conv forwards at its bucket
(counts/model.dcn_fwd_least_s) over the device time of the ops whose
name holds `deform_conv_fwd`, per request. None where the trace holds no
such op or the configuration has no deformable conv."""

from bench_h100.counts.model import dcn_fwd_least_s
from bench_h100.trace import device_ms_named


def read(tr, info):
    ms, n = device_ms_named(tr, "deform_conv_fwd")
    least = sum(dcn_fwd_least_s(info["config"], hw) for hw in info["unit_buckets"]) / \
        max(len(info["unit_buckets"]), 1)
    if not n or least == 0:
        return None
    return 100.0 * least * 1e3 / ms
