"""Device ms per request of the ops launched inside the RoI-head spans
(`htd.pyramid`, `htd.global`, `htd.stage0`, `htd.stage1`)."""

from bench_h100.trace import device_ms_launched_in

SPANS = ("htd.pyramid", "htd.global", "htd.stage0", "htd.stage1")


def read(tr, info):
    return device_ms_launched_in(tr, SPANS)
