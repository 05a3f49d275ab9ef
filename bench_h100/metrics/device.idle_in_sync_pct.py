"""Of the traced stretch's device-idle time (no kernel, copy or set on the
device), the share in % during which the host was inside an `htd.sync.*`
span: idle while the host waits on the device, as against idle while it
dispatches or computes. None where the trace holds no such span or no
device record, or the device never idles."""

from bench_h100.trace import gaps

PREFIX = "htd.sync."


def merged(intervals):
    """Sorted, disjoint [a, b) intervals covering the same points."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def overlap(xs, ys) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(tr, info):
    syncs = merged((a, b) for n, a, b in tr.spans if n.startswith(PREFIX))
    if not syncs or not tr.device:
        return None
    idle = gaps(((a, b) for _, a, b, _ in tr.device), tr.start, tr.end)
    total = sum(b - a for a, b in idle)
    return 100.0 * overlap(idle, syncs) / total if total > 0 else None
