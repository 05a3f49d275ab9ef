"""Closed-loop single-image inference on DetectoRS R-50 under HTD's heads:
`closed_loop_infer`'s traffic, window and judgement, with the state dict
of `weights_rfp` and the plain reference of `reference/detectors.py`.

Traffic parameters are `closed_loop_infer`'s (`pool`, `sizes`,
`size_shares`, `trace_units`, `check_requests`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_h100.generators.closed_loop_infer import bucket, sample_requests, sync
from bench_h100.harness import Context, Outcome, log, port_config, steady_window
from bench_h100.images import make_pool
from bench_h100.reference.detectors import DetectorsReference
from bench_h100.reference.judge import detection_numbers
from bench_h100.stats import window_stats
from bench_h100.weights_rfp import make_state_dict


def run(ctx: Context) -> Outcome:
    from htd_tpu_torch.apis import inference_detector

    cell, tp = ctx.cell, ctx.cell.traffic
    cfg_doc = cell.config
    cfg = port_config(cfg_doc)
    dev = torch.device(ctx.device)
    infer = ctx.program or inference_detector

    sd = make_state_dict(cfg_doc["config"], cfg_doc["assumed"], ctx.seed, dev)
    from bench_h100.program import build_detector

    model = build_detector(cfg, sd, dev)
    del sd
    pool = make_pool(tp, ctx.seed)
    order = np.random.default_rng(ctx.seed + 1).permutation(len(pool))
    # warm up every size of the pool once: both buckets, each resize shape
    seen = set()
    for img in pool:
        if img.shape not in seen:
            seen.add(img.shape)
            infer(model, img)
    sync(dev)

    lat, outputs, fails = [], [], 0
    k = 0
    with steady_window():
        setup_s = time.perf_counter() - ctx.t0
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            i = int(order[k % len(order)])
            k += 1
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("bench.unit"):
                    dets = infer(model, pool[i])
            except Exception as exc:                 # a failed request counts as missing
                fails += 1
                lat.append(float("inf"))
                log(f"request {k} failed: {exc!r}")
                continue
            lat.append(time.perf_counter() - t)
            outputs.append((i, dets))
        end = time.perf_counter()
    window = end - start
    done = len(outputs)

    tr, info = None, {}
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        from bench_h100.trace import from_profiler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        traced = [pool[int(order[(k + j) % len(order)])] for j in range(tp["trace_units"])]
        with profile(activities=acts) as prof:
            for img in traced:
                with torch.profiler.record_function("bench.unit"):
                    infer(model, img)
            sync(dev)
        tr = from_profiler(prof)
        info = {"config": cfg_doc["config"], "units_per_s": done / window,
                "window_buckets": [bucket(cfg, pool[i]) for i, _ in outputs],
                "unit_buckets": [bucket(cfg, img) for img in traced]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    st = window_stats(lat, window)
    notes = [f"requests {len(lat)} completed {done} failed {fails} in {window:.6f} s; latency ms "
             f"p50 {st['p50']:.3f} p90 {st['p90']:.3f} p95 {st['p95']:.3f} p99 {st['p99']:.3f} "
             f"max {st['max']:.3f}; set-up {setup_s:.3f} s"]
    numbers, pairs = judge(ctx, cfg_doc, pool, outputs, dev)
    if ctx.keep_pairs:
        info["pairs"] = pairs
    return Outcome({"latency_p95_ms": st["p95"], "images_per_s": st["rate"], "setup_s": setup_s},
                   attempted=len(lat), failed=fails, memory_peak_bytes=int(peak),
                   numbers=numbers, trace=tr, info=info, notes=notes)


def judge(ctx: Context, cfg_doc: dict, pool, outputs, dev):
    """The reference over a seeded sample of the window's requests, in
    float32 with TF32 off, after the program's state is freed."""
    if not outputs:
        return {k: float("inf") for k in ctx.cell.limits["numbers"]}, []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = make_state_dict(cfg_doc["config"], cfg_doc["assumed"], ctx.seed, dev)
    ref = DetectorsReference(cfg_doc["config"], sd)
    pairs = []
    for j in sample_requests(outputs, pool, ctx.cell.traffic["check_requests"], ctx.seed):
        i, dets = outputs[j]
        strict, relaxed = ref.detect(pool[i])
        pairs.append((dets, strict, relaxed))
    return detection_numbers(pairs), pairs
