"""Host ms per train step inside `forward_train`'s htd.* spans (backbone
and FPN, RPN loss and proposals, pyramid, SFA, both stages with their
sampling and losses)."""

from bench_h100.trace import span_ms_per_unit


def read(tr, info):
    return span_ms_per_unit(tr, None)
