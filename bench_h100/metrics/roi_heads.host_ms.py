"""Host ms per request inside the RoI-head spans: `htd.pyramid` (K1),
`htd.global` (SFA), `htd.stage0` and `htd.stage1` (RoIAlign K2, the heads)."""

from bench_h100.trace import span_ms_per_unit

SPANS = ("htd.pyramid", "htd.global", "htd.stage0", "htd.stage1")


def read(tr, info):
    return span_ms_per_unit(tr, SPANS)
