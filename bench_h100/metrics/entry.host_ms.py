"""Host ms per request outside every htd.* span: `apis.inference_detector`,
`data/pipeline.preprocess` and the copies of the detections to the host
(the request's `bench.unit` span less the union of the program's spans)."""

from bench_h100.trace import unit_self_ms


def read(tr, info):
    return unit_self_ms(tr) if tr.spans else None
