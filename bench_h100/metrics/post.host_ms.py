"""Host ms per request inside `htd.post` (ops/nms.multiclass_nms, hard or soft)."""

from bench_h100.trace import span_ms_per_unit


def read(tr, info):
    return span_ms_per_unit(tr, ("htd.post",))
