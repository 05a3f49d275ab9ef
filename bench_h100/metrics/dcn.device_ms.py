"""Device ms per request of the ops launched inside the program's `htd.dcn`
spans: each deformable conv's offset conv, its casts and its K3 launch
(ops/dcn.DeformConv2d), nested in `htd.backbone_fpn`. None where the
trace holds no such span."""

from bench_h100.trace import device_ms_launched_in


def read(tr, info):
    return device_ms_launched_in(tr, ("htd.dcn",))
