"""Timing and tracing (after `htd_tpu/utils/profiling.py`; mmdet's
utils/profiling.py): `profile_time` times a region on the host clock,
waiting for the card's work to end; `trace_to` records a `torch.profiler`
trace and exports it as a Chrome trace; `kernel_counts` counts the port's
hand-written kernels that a call runs, by name in a trace."""

from __future__ import annotations

import collections
import contextlib
import os
import re
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, TypeVar

import torch

T = TypeVar("T")

# the `__global__` kernels of `htd_tpu_torch/csrc/*.cu`, as a trace's device
# records name them. Each path of K3, K5 and K6 is a kernel of its own
# (`_tc`: the tensor cores, `_grouped_tc` K3's for grouped weights; else
# the CUDA cores), and a K6 call runs `deform_conv_bwd_offset_kernel` and
# one of the two d_weight kernels.
KERNELS = frozenset({
    "pyramid_pack_kernel", "roi_align_fwd_kernel", "roi_align_bwd_kernel",
    "deform_conv_fwd_kernel", "deform_conv_fwd_tc_kernel", "deform_conv_fwd_grouped_tc_kernel",
    "deform_conv_bwd_input_kernel", "deform_conv_bwd_input_tc_kernel",
    "deform_conv_bwd_offset_kernel", "deform_conv_bwd_weight_kernel",
    "deform_conv_bwd_weight_tc_kernel", "upsample_add_kernel", "layout_fence_kernel",
    "soft_nms_kernel", "nms_mask_kernel", "nms_scan_kernel"})
# traces `kernel_counts` takes before it fails on a short count
KERNEL_TRACES = 3
# throwaway kernels at the start of each of its traces
TRACE_PAD_KERNELS = 8

_IDENTIFIER = re.compile(r"[A-Za-z_]\w*")


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


def count_kernels(names: Iterable[str]) -> Dict[str, int]:
    """{kernel: records} over device records named `names` (demangled, as
    `void (anonymous namespace)::deform_conv_fwd_tc_kernel<128>(...)`), for
    each kernel of KERNELS that one of them names as a whole identifier, so
    that `deform_conv_fwd_kernel` never counts a `deform_conv_fwd_tc_kernel`."""
    counts = collections.Counter()
    for name in names:
        kernel = next((w for w in _IDENTIFIER.findall(name) if w in KERNELS), None)
        if kernel is not None:
            counts[kernel] += 1
    return dict(counts)


def kernel_counts(fn: Callable[[], T], expect: Optional[Mapping[str, int]] = None
                  ) -> Tuple[T, Dict[str, int]]:
    """fn() under `torch.profiler` with CUDA activity only, the card
    synchronised before it and before the trace ends; returns its result
    and `count_kernels` of the trace's device records (a CUDA graph's
    replayed kernels among them). Late in a process that has traced
    before, a trace on the H100 lost its first one or two device records,
    so each trace starts with TRACE_PAD_KERNELS throwaway kernels. The
    profiler may lose other records, and adds none: while the trace holds
    fewer of a kernel than `expect` ({kernel: n}) says, fn() runs again
    under a new trace, KERNEL_TRACES traces in all, and then the call
    raises."""
    from torch.profiler import ProfilerActivity, profile

    expect = dict(expect or {})
    unknown = set(expect) - KERNELS
    if unknown:
        raise ValueError(f"not kernels of htd_tpu_torch/csrc: {sorted(unknown)}")
    for _ in range(KERNEL_TRACES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD_KERNELS):
                torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        got = count_kernels(e.name for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
        if all(got.get(k, 0) >= n for k, n in expect.items()):
            return out, got
    raise RuntimeError(f"{KERNEL_TRACES} traces held kernels {got}, fewer than {expect}")
