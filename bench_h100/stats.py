"""End-to-end arithmetic over a window: every request or step counts."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def window_stats(latencies_s: Sequence[float], window_s: float) -> Dict[str, float]:
    """Latency percentiles (ms) over every request of the window, a failed
    one counting as infinitely late, and completed requests per second
    over the whole window."""
    lat = np.asarray(latencies_s, np.float64) * 1e3
    done = int(np.isfinite(lat).sum())
    out = {f"p{q}": float(np.percentile(lat, q, method="higher")) if len(lat) else float("inf")
           for q in (50, 90, 95, 99)}
    out["max"] = float(lat.max()) if len(lat) else float("inf")
    out["rate"] = done / window_s
    out["done"] = done
    return out
