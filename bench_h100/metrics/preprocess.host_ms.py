"""Host ms per request inside `htd.preprocess` (`data/pipeline.preprocess`:
the image's upload, the resize tables, normalisation and padding)."""

from bench_h100.trace import span_ms_per_unit


def read(tr, info):
    return span_ms_per_unit(tr, ("htd.preprocess",))
