"""Host ms per request inside `htd.rpn_proposals` (models/rpn, ops/nms)."""

from bench_h100.trace import span_ms_per_unit


def read(tr, info):
    return span_ms_per_unit(tr, ("htd.rpn_proposals",))
