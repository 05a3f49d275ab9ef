"""Data parallelism over `torch.distributed` (the port of
`htd_tpu/parallel`)."""

from htd_tpu_torch.parallel.dist import (all_reduce_mean_packed,  # noqa: F401
                                         broadcast_parameters, gather_detections,
                                         host_slice, init_distributed, rank_device, world)
