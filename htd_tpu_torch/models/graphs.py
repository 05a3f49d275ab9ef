"""CUDA graphs of the detector's fixed-shape front: the backbone, the FPN,
the RPN head and its proposals.

On an inference call the front takes a bucket-padded batch whose shape the
bucket fixes, and the images' resized shapes; it decides nothing on the
host and blocks on nothing (the box coder's constants stay on the device,
hard NMS is one kernel call), so its launches (the backbone's and FPN's
800-1,800 with K3, K7 and K8 among them, then the RPN's with the hard-NMS
kernels) can be captured once per input key and replayed as one
`cudaGraphLaunch` (`torch.cuda.CUDAGraph`). `HTDDetector`
keeps one `FeatureGraph` per key and decides which calls may replay
(`HTDDetector._levels`).

A capture warms the function up once, eagerly, on a side stream (cuDNN's
choices and workspaces, the kernels' builds), then records it into a
private memory pool of its own, in the pattern that `torch.cuda.graphs`
documents; the capture's own device synchronisation runs in an
`htd.sync.capture` span. A replay copies the inputs into the graph's
static inputs and launches the graph, inside an `htd.graph.replay` span
(a capture inside `htd.graph.capture`). The tensors a replay returns are
the graph's static outputs, which the next replay of that graph
overwrites: a caller must be done with them by then, or clone them.

A replay runs no Python, so its kernels show only in a device trace
(`utils.profiling.kernel_counts`); a capture's warm-up runs each kernel
once and the capture itself none. `graph_counts` counts captures, replays
and the eager runs of the calls that could not replay.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from htd_tpu_torch.ops.fence import switched_on

# graphs captured, graphs replayed, and eager runs of a call that could
# not replay, since the last reset
graph_counts: Dict[str, int] = {"capture": 0, "replay": 0, "eager": 0}

# the switches that decide which launches the captured region makes
# (`ops.fence.fenced` on the FPN sums, on every deformable conv's input and
# on each level entering the RPN head)
FENCE_SWITCHES = ("HTD_FPN_FENCE", "HTD_DCN_FENCE", "HTD_RPN_FENCE")


def reset_graph_counts() -> None:
    for k in graph_counts:
        graph_counts[k] = 0


def graph_key(images: torch.Tensor, compute_dtype: torch.dtype) -> Tuple:
    """What fixes the launches of the captured front on `images`: its
    shape (batch, height, width), dtype and device, the compute dtype, the
    fence switches, cuDNN's TF32 and determinism flags (which pick its
    algorithms), and whether inference mode is on (the tensors a graph
    holds are inference tensors or not)."""
    return (tuple(images.shape), images.dtype, images.device, compute_dtype,
            tuple(switched_on(s) for s in FENCE_SWITCHES),
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
            torch.is_inference_mode_enabled())


class _Capture(torch.cuda.graph):
    """`torch.cuda.graph`, whose entry (a device synchronisation, then the
    start of the capture) runs inside an `htd.sync.capture` span."""

    def __enter__(self):
        with record_function("htd.sync.capture"):
            return super().__enter__()


class FeatureGraph:
    """`fn` captured on inputs like `inputs`: `replay(*xs)` returns what
    `fn(*xs)` returns, in the graph's static output tensors."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]], *inputs: torch.Tensor):
        with record_function("htd.graph.capture"):
            self.static_in = tuple(x.clone(memory_format=torch.contiguous_format)
                                   for x in inputs)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(inputs[0].device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(*self.static_in)
                with _Capture(self.graph, stream=side):
                    self.outputs = fn(*self.static_in)
                torch.cuda.current_stream().wait_stream(side)
        graph_counts["capture"] += 1

    def replay(self, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with record_function("htd.graph.replay"):
            for static, x in zip(self.static_in, inputs):
                static.copy_(x)
            self.graph.replay()
        graph_counts["replay"] += 1
        return self.outputs
