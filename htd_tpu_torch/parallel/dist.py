"""Process groups, the rank's device and the collectives of data-parallel
training and evaluation.

Counterpart of `htd_tpu/parallel/mesh.py`. The JAX package shards the
batch over a 'data' mesh and packs every gradient and loss scalar into one
vector, so that each step crosses the devices with exactly one `psum`;
the reference trains with mmdet's `MMDistributedDataParallel`. The port
runs one process per rank over `torch.distributed` and keeps the JAX
design: one `all_reduce` per step of one packed float32 vector
(`all_reduce_mean_packed`). Each rank loads its own contiguous slice of the
global batch (`host_slice`), and evaluation gathers fixed-size padded
detections (`gather_detections`).

The caller names the backend: NCCL for CUDA tensors, one card per rank;
gloo for the CPU, or for CUDA tensors when ranks share a card (its
`all_reduce` and `broadcast` take CUDA tensors and go through the host;
its `all_gather` is given CPU tensors, the only kind older releases
take). Nothing picks a backend or a
device on the caller's behalf.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device of the rank with this `local_rank`: `cuda:(local_rank %
    device_count)` (or the CUDA device `device` names), made the current
    CUDA device (NCCL needs it set before its first call); the CPU only
    when `device` asks for it."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run a rank on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, device=None) -> torch.device:
    """Join the default process group over `backend` ('nccl' or 'gloo') and
    return this rank's device (`rank_device`). The rank, world size and
    local rank default to torchrun's `RANK`, `WORLD_SIZE` and `LOCAL_RANK`;
    without `init_method` the group meets at torchrun's `MASTER_ADDR` and
    `MASTER_PORT` ('env://'). NCCL takes CUDA devices only."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    env = os.environ

    def from_env(value, key):
        if value is not None:
            return int(value)
        if key not in env:
            raise RuntimeError(f"{key} is not set: launch with torchrun, or pass it")
        return int(env[key])

    rank = from_env(rank, "RANK")
    world_size = from_env(world_size, "WORLD_SIZE")
    local_rank = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", rank))
    if init_method is None:
        for key in ("MASTER_ADDR", "MASTER_PORT"):
            if key not in env:
                raise RuntimeError(f"{key} is not set: launch with torchrun, or pass "
                                   f"init_method")
        init_method = "env://"
    dev = rank_device(local_rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL takes CUDA tensors; rank {rank} was given {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return dev


def world(group=None) -> Tuple[int, int]:
    """(rank, size) in `group` (the default group when None), or (0, 1)
    when no process group is set up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def group_device(group=None) -> torch.device:
    """The device whose tensors the group's collectives take: the current
    CUDA device under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_slice(items, process_id: Optional[int] = None,
               process_count: Optional[int] = None):
    """This process's contiguous slice of a global per-step record list.

    DistributedGroupSampler semantics adapted to static shapes: batches are
    formed group-homogeneous at GLOBAL batch size (orientation must agree
    across ranks so that every rank's batch has one bucket), then
    rank-sliced, with the epoch seed applied by the caller."""
    pid, pc = world()
    pc = process_count if process_count is not None else pc
    pid = process_id if process_id is not None else pid
    n = len(items)
    assert n % pc == 0, f"global batch {n} not divisible by {pc} processes"
    per = n // pc
    return items[pid * per:(pid + 1) * per]


def broadcast_parameters(model: torch.nn.Module, src: int = 0, group=None) -> None:
    """Overwrite every parameter and floating buffer of `model` with rank
    `src`'s, packed into one vector per dtype and one `broadcast` each."""
    tensors = [t for t in list(model.parameters()) + list(model.buffers())
               if t.is_floating_point()]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src, group=group)
        with torch.no_grad():
            for t, v in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(v.view(t.shape))


def all_reduce_mean_packed(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over the group's ranks of each of `tensors` (one device),
    through one float32 vector and one `all_reduce`: views of the reduced
    vector, shaped like the inputs, in their order. NCCL averages inside
    the collective (`ReduceOp.AVG`; at one rank it elides an in-place SUM
    and launches no kernel at all); gloo has no AVG, so it sums and the
    vector is divided by the world size after."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group))
    return [v.view(t.shape) for t, v in zip(tensors, flat.split([t.numel() for t in tensors]))]


def gather_detections(boxes, scores, labels, valid, img_ids, group=None):
    """All-gather fixed-size per-rank detection arrays across the group.

    Equivalent of the reference's padded GPU result collection
    (apis/test.py:160-190). Inputs are numpy arrays with leading dim = the
    rank's image count, equal on every rank; returns the ranks' arrays
    concatenated in rank order, or the inputs as they are at world size 1.
    The gather runs on the device the group's backend takes."""
    _, size = world(group)
    if size == 1:
        return boxes, scores, labels, valid, img_ids
    dev = group_device(group)
    out = []
    for arr in (boxes, scores, labels, valid, img_ids):
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.cat(parts).cpu().numpy())
    return tuple(out)


def max_over_ranks(value: int, group=None) -> int:
    """The largest of each rank's `value`."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=group_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
