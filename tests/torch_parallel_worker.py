"""One rank of tests/test_torch_parallel.py's 2-rank gloo run on the CPU.

Spawned by the test's fixture (`torch.multiprocessing`, spawn): it imports
torch and the port only, joins the group at a file in the fixture's
directory, and leaves what it computed there as `rank{r}.pt`.
"""

import os

import torch
import torch.distributed as dist


def flat_parameters(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def identical_across_ranks(x: torch.Tensor) -> bool:
    """Whether every rank holds bit-for-bit rank 0's `x` (on all ranks)."""
    ref = x.clone()
    dist.broadcast(ref, 0)
    same = torch.tensor([int(torch.equal(ref, x))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def none_grad_case(rank: int) -> dict:
    """A parameter without a gradient on rank 1 packs as zeros there: every
    rank gets rank 0's gradient halved, the others the mean."""
    from htd_tpu_torch.train.train_step import _all_reduce_step

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, float(rank + 1 + i))
    if rank == 1:
        model[0].weight.grad = None
    metrics = _all_reduce_step(opt, {"loss": torch.tensor(2.0 * rank), "b": torch.tensor(1.0)},
                               dist.group.WORLD)
    return {"grads": [p.grad.clone() for p in model.parameters()], "metrics": metrics}


def rank_main(rank: int, root: str, job: dict) -> None:
    from htd_tpu_torch.apis import evaluate_dataset, init_detector
    from htd_tpu_torch.data.coco import CocoDataset
    from htd_tpu_torch.parallel import broadcast_parameters, init_distributed
    from htd_tpu_torch.train import train_step as ts
    from htd_tpu_torch.utils import get_root_logger

    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{root}/rendezvous", rank=rank, world_size=2,
                     device="cpu")
    group = dist.group.WORLD
    out = {}
    os.makedirs(f"{root}/logs", exist_ok=True)
    get_root_logger(f"{root}/logs/rank{rank}.log").info(f"rank {rank} joined")

    # a float32 step on this rank's half with its injected samples; the
    # packed vector's input recorded, for the local loss terms
    state = ts.create_train_state(job["cfg"], device="cpu", checkpoint=job["train_ckpt"])
    broadcast_parameters(state.model, 0, group)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    packed, reduce = [], ts.all_reduce_mean_packed

    def recording(tensors, group=None):
        packed.append([t.clone() for t in tensors])
        return reduce(tensors, group)

    ts.all_reduce_mean_packed = recording
    try:
        batch = ts.TrainBatch(*(torch.from_numpy(a) for a in job["batches"][rank]))
        ov = {k: torch.from_numpy(v) for k, v in job["overrides"][rank].items()}
        metrics = ts.train_step(state, batch, overrides=ov, group=group)
    finally:
        ts.all_reduce_mean_packed = reduce
    keys = sorted(k for k in metrics if k != "loss")
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["local"] = {k: float(v) for k, v in zip(["loss"] + keys, packed[0][-1 - len(keys):])}
    out["packed_size"] = sum(t.numel() for t in packed[0])
    out["grads"] = {n: p.grad.clone() for n, p in state.model.named_parameters()
                    if p.grad is not None}
    out["before"] = before
    out["after"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    # two sampled steps, each rank on its own half: the parameters stay
    # bit-identical across the ranks
    out["identical"] = []
    for _ in range(2):
        gen = ts.step_generator(0, state.step, "cpu", rank, 2)
        ts.train_step(state, batch, gen, group=group)
        out["identical"].append(identical_across_ranks(flat_parameters(state.model)))
    del state
    out["none_grad"] = none_grad_case(rank)

    model = init_detector(job["eval_cfg"], job["eval_ckpt"], device="cpu")
    dataset = CocoDataset(job["ann"], job["img_root"], test_mode=True)
    out["eval"] = evaluate_dataset(model, dataset, batch_size=2, scale=(96, 64), log_every=0,
                                   return_detections=True, group=group)
    torch.save(out, f"{root}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
