"""Timing and tracing (after `htd_tpu/utils/profiling.py`; mmdet's
utils/profiling.py): `profile_time` times a region on the host clock,
waiting for the card's work to end; `trace_to` records a `torch.profiler`
trace and exports it as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_time(name: str, stream=None, sync: bool = True):
    """Print the wall time of the region in ms; with `sync`, the card's
    pending work is drained before the clock is read at each end (on the
    card only: the CPU has nothing to drain)."""
    drain = sync and torch.cuda.is_available() and torch.cuda.is_initialized()
    if drain:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    yield
    if drain:
        torch.cuda.synchronize()
    print(f"{name} elapsed: {(time.monotonic() - t0) * 1e3:.2f} ms", file=stream)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Trace the region with `torch.profiler` (the CPU, and the card's
    kernels when there is one) and write it to `logdir/trace.json` in
    Chrome's trace format (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
