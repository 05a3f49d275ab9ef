"""Device ms per request of the ops launched inside `htd.backbone_fpn`
(models/resnet, models/fpn, K7, and K3 in the DCN configurations)."""

from bench_h100.trace import device_ms_launched_in


def read(tr, info):
    return device_ms_launched_in(tr, ("htd.backbone_fpn",))
