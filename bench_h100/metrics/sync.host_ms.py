"""Host ms per request inside the union of the program's `htd.sync.*`
spans: the calls that block the host until the device catches up (the
uploads of preprocess, the hard NMS's convergence checks, the box coder's
constants, the copies of the detections to the host). None where the trace
holds no such span."""

from bench_h100.trace import span_ms_per_unit

PREFIX = "htd.sync."


def read(tr, info):
    names = sorted({n for n, _, _ in tr.spans if n.startswith(PREFIX)})
    return span_ms_per_unit(tr, names) if names else None
