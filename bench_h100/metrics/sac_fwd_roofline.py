"""The switchable atrous convs' deformable convs (K3, two a SAC conv, at
dilation 1 and 3, in both backbones of DetectoRS) against their roofline,
in %: the frozen least time of a request's SAC deformable convs at its
bucket (counts/detectors.sac_fwd_least_s) over the device time of the ops
whose name holds `deform_conv_fwd`, per request. None where the trace
holds no such op or the configuration has no SAC conv."""

from bench_h100.counts.detectors import sac_fwd_least_s
from bench_h100.trace import device_ms_named


def read(tr, info):
    ms, n = device_ms_named(tr, "deform_conv_fwd")
    if not n or not any(info["config"]["backbone"].get("stage_with_sac", ())):
        return None
    least = sum(sac_fwd_least_s(info["config"], hw) for hw in info["unit_buckets"]) / \
        max(len(info["unit_buckets"]), 1)
    return 100.0 * least * 1e3 / ms
