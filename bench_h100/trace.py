"""The traced stretch of a run, reduced from `torch.profiler`'s events in
memory, and the interval arithmetic the per-layer readers share.

A `Trace` holds, in nanoseconds on the profiler's one clock:
- `units`: the host intervals of the benchmark's own `bench.unit` spans,
  one per request or train step of the stretch;
- `spans`: (name, start, end) of the program's `htd.*` host spans;
- `device`: (name, start, end, launch) of every kernel, copy and set on
  the device, `launch` the host time of the runtime call that issued it
  (None where the trace holds no such call);
- `lost`: kernel launches of the stretch whose kernel record is missing
  (the profiler loses some on the H100);
- `start`, `end`: the stretch.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

UNIT = "bench.unit"
LAUNCH_CALLS = ("LaunchKernel", "cuLaunch", "MemcpyAsync", "MemsetAsync", "cudaMemcpy",
                "cudaMemset")


class Trace(NamedTuple):
    units: List[Tuple[int, int]]
    spans: List[Tuple[str, int, int]]
    device: List[Tuple[str, int, int, Optional[int]]]
    lost: int
    start: int
    end: int


def union_length(intervals: Iterable[Tuple[int, int]], lo: Optional[int] = None,
                 hi: Optional[int] = None) -> int:
    """Length of the union of [a, b) intervals, clipped to [lo, hi]."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def self_time(parent: Tuple[int, int], children: Iterable[Tuple[int, int]]) -> int:
    """A span's duration less the part of it that its child spans cover."""
    return (parent[1] - parent[0]) - union_length(children, parent[0], parent[1])


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def from_profiler(prof) -> Trace:
    """Reduce a finished `torch.profiler.profile` to a Trace whose stretch
    runs from the first `bench.unit` span's start to the last one's end."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    units, spans, device, launches = [], [], [], {}
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if name.startswith(("htd.", "bench.")) or e.is_user_annotation():
                continue
            device.append((name, a, b, e.correlation_id()))
        elif name == UNIT:
            units.append((a, b))
        elif name.startswith("htd."):
            spans.append((name, a, b))
        elif any(k in name for k in LAUNCH_CALLS):
            launches[e.correlation_id()] = (name, a)
    seen = {c for *_, c in device}
    lost = sum(1 for c, (name, _) in launches.items() if "Launch" in name and c not in seen)
    device = [(n, a, b, launches[c][1] if c in launches else None) for n, a, b, c in device]
    start = min((a for a, _ in units), default=0)
    end = max((b for _, b in units), default=0)
    return Trace(sorted(units), sorted(spans, key=lambda s: s[1]),
                 sorted(device, key=lambda d: d[1]), lost, start, end)


# -- what the readers ask of a trace -------------------------------------------


def busy_ns(tr: Trace) -> int:
    return union_length(((a, b) for _, a, b, _ in tr.device), tr.start, tr.end)


def top_spans(tr: Trace, unit: Tuple[int, int], names: Optional[Sequence[str]] = None):
    """The htd.* spans inside a unit (of `names` when given)."""
    return [(a, b) for n, a, b in tr.spans
            if a >= unit[0] and b <= unit[1] and (names is None or n in names)]


def span_ms_per_unit(tr: Trace, names: Optional[Sequence[str]]) -> Optional[float]:
    """Host ms per unit of the union of the named spans (of every htd.*
    span for None); None without units or without any such span."""
    if not tr.units:
        return None
    per = [union_length(top_spans(tr, u, names)) for u in tr.units]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6


def unit_self_ms(tr: Trace) -> Optional[float]:
    """Host ms per unit outside every htd.* span (the entry's own time)."""
    if not tr.units:
        return None
    return sum(self_time(u, top_spans(tr, u)) for u in tr.units) / len(tr.units) / 1e6


def device_ms_launched_in(tr: Trace, names: Sequence[str]) -> Optional[float]:
    """Device ms per unit of the ops launched inside the named spans; None
    where the trace holds none."""
    ivs = sorted((a, b) for n, a, b in tr.spans if n in names)
    if not tr.units or not ivs:
        return None
    starts = [a for a, _ in ivs]
    total, found = 0, 0
    for _, a, b, launch in tr.device:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and ivs[i][0] <= launch < ivs[i][1]:
            total += b - a
            found += 1
    return total / len(tr.units) / 1e6 if found else None


def device_ms_named(tr: Trace, pattern: str) -> Tuple[float, int]:
    """Device ms per unit of the ops whose name contains `pattern`, and
    their count over the stretch."""
    ops = [(b - a) for n, a, b, _ in tr.device if pattern in n]
    return (sum(ops) / max(len(tr.units), 1) / 1e6, len(ops))
