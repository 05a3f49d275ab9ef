"""`htd.sync.*` spans per request: the program opens one around each call
that blocks the host until the device catches up, so this counts the
request's host-device synchronisations. None where the trace holds no such
span."""

from bench_h100.trace import top_spans

PREFIX = "htd.sync."


def read(tr, info):
    names = {n for n, _, _ in tr.spans if n.startswith(PREFIX)}
    if not tr.units or not names:
        return None
    return sum(len(top_spans(tr, u, names)) for u in tr.units) / len(tr.units)
