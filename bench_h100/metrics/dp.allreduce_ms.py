"""Device ms per train step of NCCL's all-reduce kernels (the packed
gradient exchange of `parallel/dist.all_reduce_mean_packed`), the mean
over the ranks, each read from its own traced stretch."""


def read(tr, info):
    per_rank = [ms for ms in info.get("allreduce_ms") or [] if ms]
    return sum(per_rank) / len(per_rank) if per_rank else None
