"""Device kernels, copies and sets per request whose launch (the runtime
call the profiler records with it) lies inside the request's unit. Records
with no launch call in the trace are not counted; None without units or
without any counted record."""

import bisect


def read(tr, info):
    if not tr.units:
        return None
    starts = [a for a, _ in tr.units]
    n = 0
    for _, _, _, launch in tr.device:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch < tr.units[i][1]:
            n += 1
    return n / len(tr.units) if n else None
