"""Data-parallel training steps: one process per card, joined over NCCL
(gloo on the CPU), each running `htd_tpu_torch.train.train_step(group=)`
on its own images; the program all-reduces the packed gradients and
every rank steps on their mean.

Traffic parameters: those of `train_steps` (per rank: `batch`, the pool
and its ground truth, `flip_prob`, `scales`), and `ranks`. Rank r draws
its images, boxes, flips and sampling from the stream [seed, r].

The run starts its ranks itself and waits for all of them; NCCL's set-up
counts in `setup_s`. Each rank's set-up runs one step of every (scale,
orientation) pair, at least three: the first three are the steps the
reference follows. The window ends when rank 0's clock passes
`--seconds` (a one-element all-reduce per step carries the decision to
every rank) and after `torch.cuda.synchronize()` on every rank. After
the window every rank's parameters are held to rank 0's (`rank_gap`,
an exact comparison), and each rank looks for JAX or the JAX package
among its own modules, as run.py does in its process: a rank that finds
one fails the run; then the ranks exit, and the reference follows the
three steps on the global batch: each rank's batch through the float32
reference with that rank's draws, the mean of their losses and
gradients, one SGD step.
"""

from __future__ import annotations

import gc
import os
import socket
import time
from typing import Dict, List

import torch

from bench_h100.generators import train_steps as T
from bench_h100.harness import (Context, Outcome, forbidden_modules, log, port_config,
                                steady_window)
from bench_h100.weights import make_state_dict

JOIN_S = 330


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _allreduce_ms(tr) -> float:
    from bench_h100.trace import device_ms_named

    return device_ms_named(tr, "AllReduce")[0]


def _rank(rank: int, world: int, port: int, cell, seed: int, seconds: float, trace: bool,
          t0_wall: float, device: str, program, queue) -> None:
    """One rank: set-up, the checked first steps, the window, the traced
    stretch, the cross-rank check; its results go to `queue`."""
    import torch.distributed as dist
    from htd_tpu_torch.data.coco import make_train_batch
    from htd_tpu_torch.train.train_step import train_step

    from bench_h100.program import build_train_state

    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device("cpu")
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        group = dist.group.WORLD
        doc, tp = cell.config, cell.traffic
        cfg = port_config(doc)
        feed = T.Feed(doc["config"], tp, seed, stream=rank)
        data = T._Records(feed)
        state = build_train_state(cfg, make_state_dict(doc["config"], doc["assumed"], seed, dev),
                                  dev)
        params = dict(state.model.named_parameters())
        step_fn = program or train_step

        def step(k):
            scale, ids, flips = feed.step(k)
            b = make_train_batch(data, [data.record(i) for i in ids], scale=scale,
                                 max_gt=doc["config"]["train"]["max_gt"], flips=flips, device=dev)
            return step_fn(state, b, generator=feed.generator(k, dev), group=group)

        losses, first, change = [], {}, {}
        n_setup = max(len(feed.pairs), T.CHECKED_STEPS)
        for k in range(n_setup):
            out = step(k)
            if k < T.CHECKED_STEPS:
                losses.append({name: float(v) for name, v in out.items()})
            if k == 0:
                first = T.leaf_norms({n: p.grad for n, p in params.items() if p.grad is not None})
            if k == T.CHECKED_STEPS - 1:
                p0 = make_state_dict(doc["config"], doc["assumed"], seed, dev)
                change = T.leaf_norms({n: p.detach() - p0[n] for n, p in params.items()
                                       if p.requires_grad})
                del p0
        T.sync(dev)
        dist.barrier()

        go = torch.ones(1, device=dev)
        k, steps = n_setup, 0
        with steady_window():
            setup_s = time.time() - t0_wall
            start = time.perf_counter()
            while True:
                go.fill_(1.0 if rank != 0 or time.perf_counter() - start < seconds else 0.0)
                dist.all_reduce(go, op=dist.ReduceOp.MIN, group=group)
                if go.item() == 0.0:
                    break
                step(k)
                k += 1
                steps += 1
            T.sync(dev)
            dist.barrier()
            window = time.perf_counter() - start

        tr, unit_buckets = None, []
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from bench_h100.trace import from_profiler

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            with profile(activities=acts) as prof:
                for j in range(k, k + tp["trace_units"]):
                    with torch.profiler.record_function("bench.unit"):
                        step(j)
                        T.sync(dev)
            tr = from_profiler(prof)
            unit_buckets = [T.bucket(feed, j) for j in range(k, k + tp["trace_units"])]
        # every rank's parameters against rank 0's, exactly
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=group)
        gap = torch.tensor([float((flat - ref).abs().max())], device=dev)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=group)
        peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                             if dev.type == "cuda" else 0.0], device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        queue.put({"rank": rank, "losses": losses, "first": first, "change": change,
                   "setup_s": setup_s, "window": window, "steps": steps,
                   "images": steps * tp["batch"], "rank_gap": float(gap.item()),
                   "peak": int(peak.item()), "trace": tr,
                   "allreduce_ms": _allreduce_ms(tr) if tr is not None else None,
                   "window_buckets": [T.bucket(feed, j) for j in range(n_setup, n_setup + steps)],
                   "unit_buckets": unit_buckets, "forbidden": forbidden_modules()})
        del state, params, flat, ref
        dist.destroy_process_group()
    except BaseException as exc:           # the parent reports it and fails the run
        queue.put({"rank": rank, "error": repr(exc)})
        raise


def run(ctx: Context) -> Outcome:
    import torch.multiprocessing as mp

    cell, tp = ctx.cell, ctx.cell.traffic
    world = tp["ranks"]
    mpc = mp.get_context("spawn")
    queue = mpc.Queue()
    port = _free_port()
    t0_wall = time.time() - (time.perf_counter() - ctx.t0)
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    procs = [mpc.Process(target=_rank, args=(r, world, port, cell, ctx.seed, ctx.seconds,
                                            ctx.trace, t0_wall, ctx.device, ctx.program, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, dict] = {}
    deadline = time.time() + JOIN_S
    try:
        while len(results) < world and time.time() < deadline:
            try:
                got = queue.get(timeout=5)
            except Exception:                  # queue.Empty: see whether a rank died
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            results[got["rank"]] = got
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r["error"] for r in results.values() if "error" in r]
    if len(results) < world or errors:
        raise RuntimeError(f"ranks failed: {errors or 'no result from every rank'}")
    found = sorted({m for r in results.values() for m in r["forbidden"]})
    if found:
        log(f"a rank loaded modules of JAX or the JAX package: {', '.join(found)}")
        raise SystemExit(4)
    r0 = results[0]
    window = max(r["window"] for r in results.values())
    images = sum(r["images"] for r in results.values())
    info = {}
    if ctx.trace:
        info = {"config": cell.config["config"], "units_per_s": r0["steps"] / window,
                "batch": tp["batch"], "window_buckets": r0["window_buckets"],
                "unit_buckets": r0["unit_buckets"],
                "allreduce_ms": [r["allreduce_ms"] for r in results.values()]}
    gc.collect()
    dev = torch.device("cuda", 0) if ctx.device == "cuda" else torch.device("cpu")
    numbers = judge(ctx, r0, max(r["rank_gap"] for r in results.values()), dev)
    notes = [f"ranks {world} steps {r0['steps']} images {images} in {window:.6f} s; set-up "
             f"{max(r['setup_s'] for r in results.values()):.3f} s; first losses "
             f"{[t['loss'] for t in r0['losses']]}"]
    return Outcome({"train_images_per_s": images / window,
                    "setup_s": max(r["setup_s"] for r in results.values())},
                   attempted=r0["steps"], failed=0,
                   memory_peak_bytes=max(r["peak"] for r in results.values()),
                   numbers=numbers, trace=r0["trace"], info=info, notes=notes)


def reference_steps(doc: dict, tp: dict, seed: int, world: int, dev, precision="float32"):
    """The reference's first CHECKED_STEPS data-parallel steps: every rank's
    batch and draws, the mean of the ranks' losses and gradients."""
    from bench_h100.reference.ops import bucket_shape
    from bench_h100.reference.train import TrainReference, make_batch

    feeds = [T.Feed(doc["config"], tp, seed, stream=r) for r in range(world)]
    ref = TrainReference(doc["config"], make_state_dict(doc["config"], doc["assumed"], seed,
                                                        dev), precision)
    p0 = {k: v.detach().clone() for k, v in ref.params().items()}
    losses: List[Dict[str, float]] = []
    first: Dict[str, float] = {}
    for k in range(T.CHECKED_STEPS):
        batches, gens = [], []
        for feed in feeds:
            scale, ids, flips = feed.step(k)
            land = feed.pool[ids[0]].shape[1] >= feed.pool[ids[0]].shape[0]
            batches.append(make_batch([feed.pool[i] for i in ids], [feed.gts[i][0] for i in ids],
                                      [feed.gts[i][1] for i in ids], flips, scale,
                                      bucket_shape(scale, land), doc["config"]["train"]["max_gt"],
                                      dev))
            gens.append(feed.generator(k, dev))
        terms, grads = ref.step_mean(batches, gens, k, T.STEPS_PER_EPOCH)
        losses.append({name: float(v) for name, v in terms.items()})
        if k == 0:
            first = T.leaf_norms(grads)
    change = T.leaf_norms({k: v.detach() - p0[k] for k, v in ref.params().items()})
    return losses, first, change


def judge(ctx: Context, r0: dict, rank_gap: float, dev) -> Dict[str, float]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = reference_steps(ctx.cell.config, ctx.cell.traffic, ctx.seed, ctx.cell.traffic["ranks"],
                           dev)
    numbers = T.compare((r0["losses"], r0["first"], r0["change"]), want,
                        T.dcn_leaf_names(ctx.cell.config["config"]))
    numbers["rank_gap"] = rank_gap
    return numbers
