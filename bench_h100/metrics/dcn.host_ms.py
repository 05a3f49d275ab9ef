"""Host ms per request inside the program's `htd.dcn` spans: the dispatch
of each deformable conv's offset conv, casts and K3 launch
(ops/dcn.DeformConv2d), nested in `htd.backbone_fpn`. None where the
trace holds no such span."""

from bench_h100.trace import span_ms_per_unit


def read(tr, info):
    return span_ms_per_unit(tr, ("htd.dcn",))
