"""The share of the traced stretch, in %, that no kernel, copy or set on
the device covers (the union of their intervals, not a sum)."""

from bench_h100.trace import busy_ns


def read(tr, info):
    span = tr.end - tr.start
    return 100.0 * (1.0 - busy_ns(tr) / span) if span > 0 and tr.device else None
