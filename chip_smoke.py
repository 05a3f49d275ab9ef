"""Smoke test of the PyTorch/CUDA port (htd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure raises and the
script exits non-zero without its final line:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels compiled from htd_tpu_torch/csrc with nvcc;
  3. main path: HTD R-50 (full depth and width, bfloat16, random weights
     from a seed) through `init_detector` / `inference_detector` on
     synthetic images in the 800x1344 landscape bucket, with each kernel's
     launch count for the run and per request;
  4. reference: the same detector in float32 on the card (kernels, cuDNN
     with TF32 off) against the CPU (plain versions) on a small input, and
     one full-size float32 request;
  5. kernels: each kernel held to its plain version on the main path's own
     levels and proposals of the first request, in bfloat16 and float32;
  6. timings: warm per-image latency, per-kernel times beside their bounds,
     a device-time profile of one request.
It needs CUDA: with no GPU, or run outside the repository, it fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SCORE_SCALE = 4.0          # seeded fc_cls std 0.01 -> 0.04, see phase 3
REQUEST_SHAPES = [(480, 640), (600, 800), (427, 640), (720, 1280)]
TIMED_REQUESTS = 20


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def images(seed: int = 0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in REQUEST_SHAPES]


def scale_scores(model) -> None:
    with torch.no_grad():
        for head in model.roi_head.bbox_head:
            head.fc_cls.weight.mul_(SCORE_SCALE)


def check_detections(boxes, scores, labels, img, cfg) -> None:
    h, w = img.shape[:2]
    if boxes.ndim != 2 or boxes.shape[1] != 4 or len(scores) != len(boxes):
        fail(f"bad detection shapes {boxes.shape} {scores.shape}")
    if len(scores) == 0 or len(scores) > cfg.rcnn_test.max_per_img:
        fail(f"{len(scores)} detections")
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        fail("non-finite detections")
    if scores.min() <= cfg.rcnn_test.score_thr or scores.max() > 1.0:
        fail(f"scores outside ({cfg.rcnn_test.score_thr}, 1]")
    if labels.min() < 0 or labels.max() >= cfg.num_classes:
        fail("labels out of range")
    if (boxes[:, 2] < boxes[:, 0]).any() or boxes[:, 2].max() > w + 1e-2 or \
            boxes[:, 3].max() > h + 1e-2 or boxes.min() < 0:
        fail("boxes outside the image")


def first_request_state(model, img):
    """The main path's intermediate tensors for one request: levels,
    pyramid, proposals and refined rois (the detector's own steps)."""
    from htd_tpu_torch.data.pipeline import bucket_shape, preprocess

    cfg = model.cfg
    p = preprocess(img, cfg.test_scale, bucket_shape(cfg.test_scale, True), model.device)
    feats = model._features(p.image[None])
    shapes = p.img_shape[None]
    props, _, valid = model._proposals(feats, shapes)
    pyr = model._pyramid(feats)
    _, s0_reg = model._stage0(pyr, props, model._global(feats))
    rois1 = model._refine(props, s0_reg, shapes)
    levels = [f.permute(0, 2, 3, 1).contiguous() for f in feats[:4]]
    return levels, pyr, props, valid, rois1


def k2_bound(pyr, rois, lvls, strides, max_samples, all_levels: bool):
    """(bytes, operations) the K2 call must move and do on this data: rois
    and levels read, outputs written, each distinct feature pixel with a
    non-zero bilinear weight read once; 4 multiply-adds per channel per
    live sample corner."""
    from htd_tpu_torch.ops.roi_align import _level_tables, _sample_geometry

    buf, g = pyr
    esize = buf.element_size()
    b, r = rois.shape[:2]
    n = b * r
    flat = rois.reshape(n, 4).float()
    scale_t, hs, ws, offs = _level_tables(g, strides, buf.device)
    img = torch.arange(b, device=buf.device).repeat_interleave(r)
    level_sets = range(len(strides)) if all_levels else [None]
    pixels, ops, out_elems = [], 0, 0
    for lvl in level_sets:
        lv = (torch.full((n,), lvl, device=buf.device) if lvl is not None
              else lvls.reshape(n).long())
        (xl, xh, lx, hx, mx, xin, yl, yh, ly, hy, my, yin, _, _) = _sample_geometry(
            flat, scale_t[lv], hs[lv], ws[lv], 7, 0, max_samples)
        base = (img * g.img_rows + offs[lv])[:, None, None, None, None]
        live = ((my & yin)[:, :, None, :, None] & (mx & xin)[:, None, :, None, :])
        for yi, wy in ((yl, hy), (yh, ly)):
            for xi, wx in ((xl, hx), (xh, lx)):
                w = wy[:, :, None, :, None] * wx[:, None, :, None, :]
                keep = live & (w > 0)
                pix = ((base + yi[:, :, None, :, None]) * g.w_pad + xi[:, None, :, None, :])
                pixels.append(pix[keep])
                ops += 2 * int(keep.sum()) * g.channels
        out_elems += n * 49 * g.channels
    distinct = int(torch.unique(torch.cat(pixels)).numel())
    nbytes = n * 16 + (0 if all_levels else n * 4) + out_elems * esize \
        + distinct * g.channels * esize
    return nbytes, ops


def k1_library(levels, geom):
    """The pyramid from library calls only: one zeroed buffer and a `copy_`
    per (image, level). A yardstick for K1; the port never calls it."""
    pyr = torch.zeros((geom.rows_pad, geom.w_pad, geom.channels), dtype=levels[0].dtype,
                      device=levels[0].device)
    for f, off, h, w in zip(levels, geom.row_offsets, geom.heights, geom.widths):
        for b in range(geom.batch):
            r0 = b * geom.img_rows + off
            pyr[r0:r0 + h, :w].copy_(f[b])
    return pyr


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    from htd_tpu_torch import htd_r50_1x, inference_detector, init_detector
    from htd_tpu_torch.ops import _build
    from htd_tpu_torch.ops.pyramid import pack_pyramid, pack_pyramid_plain
    from htd_tpu_torch.ops.roi_align import (roi_align_levels, roi_align_plain,
                                             roi_align_pyramid)
    from htd_tpu_torch.ops.boxes import map_roi_levels
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    phase("1 device")
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")

    phase("2 build")
    info = _build.build()
    print(f"kernels built from htd_tpu_torch/csrc with nvcc for sm_90a in "
          f"{info.seconds:.2f} s (fresh build: {info.built}) -> {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    _build.load()

    phase("3 main path: HTD R-50, bfloat16, 800x1344 bucket")
    torch.backends.cudnn.benchmark = True
    cfg = htd_r50_1x(compute_dtype="bfloat16")
    model = init_detector(cfg, seed=0)
    scale_scores(model)
    print(f"init_detector(htd_r50_1x(compute_dtype='bfloat16'), seed=0); fc_cls of both "
          f"stages scaled x{SCORE_SCALE} (std 0.01 -> 0.04) so that random-weight scores "
          f"clear score_thr {cfg.rcnn_test.score_thr}")
    imgs = images()
    torch.cuda.synchronize()
    reset_launch_counts()
    per_request = []
    for img in imgs:
        before = dict(launch_counts)
        boxes, scores, labels = inference_detector(model, img)
        counts = {k: launch_counts[k] - before[k] for k in launch_counts}
        check_detections(boxes, scores, labels, img, cfg)
        if min(counts.values()) <= 0:
            fail(f"a kernel was not launched on request {img.shape}: {counts}")
        per_request.append(counts)
        print(f"request {img.shape[1]}x{img.shape[0]}: {len(scores)} detections, "
              f"top scores {np.round(scores[:3], 4).tolist()}, labels "
              f"{labels[:3].tolist()}, first box {np.round(boxes[0], 1).tolist()}, "
              f"launches {counts}")
    torch.cuda.synchronize()
    main_counts = dict(launch_counts)
    print(f"main path launches over {len(imgs)} requests: {main_counts}")
    for name in ("pyramid_pack", "roi_align"):
        if main_counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")

    phase("4 reference: float32 on the card (kernels) vs the CPU (plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_cfg = htd_r50_1x()
    gpu32 = init_detector(ref_cfg, device="cuda", seed=0)
    cpu32 = init_detector(ref_cfg, device="cpu", seed=0)
    scale_scores(gpu32)
    scale_scores(cpu32)
    rng = np.random.RandomState(1)
    small = rng.normal(0, 1, (1, 192, 288, 3)).astype(np.float32)
    shape = torch.tensor([[180.0, 270.0]])
    props = np.zeros((1, 64, 4), np.float32)
    k = 0
    while k < 64:  # keep sqrt(area) away from the level boundaries 56 and 112
        x, y = rng.uniform(0, 200), rng.uniform(0, 110)
        w, h = rng.uniform(8, 70), rng.uniform(8, 70)
        if min(abs(np.sqrt(w * h) - 56), abs(np.sqrt(w * h) - 112)) > 4:
            props[0, k] = [x, y, x + w, y + h]
            k += 1
    valid = torch.ones(1, 64, dtype=torch.bool)
    with torch.inference_mode():
        gb, gs = gpu32.stages_forward(torch.from_numpy(small), shape, torch.from_numpy(props),
                                      valid)
        cb, cs = cpu32.stages_forward(torch.from_numpy(small), shape, torch.from_numpy(props),
                                      valid)
    box_err = (gb.cpu() - cb).abs().max().item()
    score_err = (gs.cpu() - cs).abs().max().item()
    print(f"stages_forward on 64 fixed proposals at 192x288: max box err {box_err:.3g} px "
          f"(limit 1e-2), max score err {score_err:.3g} (limit 1e-3)")
    if not (box_err <= 1e-2 and score_err <= 1e-3):
        fail("the card disagrees with the CPU reference")
    before = dict(launch_counts)
    boxes, scores, labels = inference_detector(gpu32, imgs[0])
    check_detections(boxes, scores, labels, imgs[0], ref_cfg)
    counts = {k: launch_counts[k] - before[k] for k in launch_counts}
    if min(counts.values()) <= 0:
        fail(f"a kernel was not launched on the float32 request: {counts}")
    print(f"float32 request {imgs[0].shape[1]}x{imgs[0].shape[0]} at full size: "
          f"{len(scores)} detections, launches {counts}")
    del gpu32, cpu32

    phase("5 kernels vs plain versions on the main path's first request")
    levels, pyr, props, prop_valid, rois1 = first_request_state(model, imgs[0])
    strides = cfg.roi_extractor.featmap_strides
    lv0 = map_roi_levels(props, 4)
    lv1 = map_roi_levels(rois1, 4)
    print(f"levels {[tuple(f.shape) for f in levels]}, pyramid {tuple(pyr.buf.shape)}, "
          f"{int(prop_valid.sum())} valid of {props.shape[1]} proposals, roi levels "
          f"{torch.bincount(lv0.flatten().long(), minlength=4).tolist()}")
    k1_err, k2_err = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        lv = [f.to(dtype) for f in levels]
        reset_launch_counts()
        kp = pack_pyramid(lv)
        equal = torch.equal(kp.buf, pack_pyramid_plain(lv, kp.geom))
        k1_err[dtype] = (kp.buf.float() - pack_pyramid_plain(lv, kp.geom).float()).abs().max().item()
        if not equal:
            fail(f"K1 differs from its plain version in {dtype}")
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        errs = []
        for rois, lvl, s in ((props, lv0, 4), (rois1, lv1, 4)):
            k = roi_align_pyramid(kp, rois, lvl, strides, 7, 0, s).float()
            p = roi_align_plain(kp, rois, lvl, strides, 7, 0, s).float()
            errs.append(((k - p).abs().max().item(), p.abs().max().item()))
        k = roi_align_levels(kp, rois1, strides, 7, 0, 1).float()
        for lvl in range(4):
            p = roi_align_plain(kp, rois1, torch.full_like(lv1, lvl), strides, 7, 0, 1).float()
            errs.append(((k[lvl] - p).abs().max().item(), p.abs().max().item()))
        k2_err[dtype] = max(e for e, _ in errs)
        rel = max(e / max(1.0, m) for e, m in errs)
        print(f"{str(dtype)[6:]}: K1 bit-equal; K2 max abs err {k2_err[dtype]:.3g}, max "
              f"err relative to max |plain| {rel:.3g} (limit {tol}) over stage-0, stage-1 "
              f"and 4 all-level calls")
        if rel > tol:
            fail(f"K2 disagrees with its plain version in {dtype}")
        torch.cuda.synchronize()

    phase("6 timings")
    lat = []
    for i in range(TIMED_REQUESTS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_detector(model, imgs[i % len(imgs)])
        torch.cuda.synchronize()
        if i >= 2:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    med = statistics.median(lat)
    print(f"warm latency per image, inference_detector incl. preprocessing, "
          f"{len(lat)} requests: median {med:.2f} ms, p90 {lat[int(0.9 * len(lat)) - 1]:.2f} "
          f"ms, min {lat[0]:.2f} ms ({card})")

    geom = pyr.geom
    k1_ms = cuda_ms(lambda: pack_pyramid(levels))
    k1_plain = cuda_ms(lambda: pack_pyramid_plain(levels, geom))
    k1_lib = cuda_ms(lambda: k1_library(levels, geom))
    k1_bytes = sum(f.numel() for f in levels) * 2 + pyr.buf.numel() * 2
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 pyramid_pack: {k1_ms * 1e3:.1f} us; plain {k1_plain * 1e3:.1f} us; zeros+copy_ "
          f"{k1_lib * 1e3:.1f} us; bound {k1_bound * 1e3:.1f} us ({k1_bytes / 1e6:.1f} MB "
          f"at 3.35 TB/s) ({card})")

    calls = [("stage-0 level-mapped S=4", props, lv0, 4, False),
             ("stage-1 level-mapped S=4", rois1, lv1, 4, False),
             ("BA all-level S=1", rois1, None, 1, True)]
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, rois, lvl, s, all_lv in calls:
        if all_lv:
            ms = cuda_ms(lambda: roi_align_levels(pyr, rois, strides, 7, 0, s))
            plain = cuda_ms(lambda: [roi_align_plain(pyr, rois, torch.full_like(lv1, q),
                                                     strides, 7, 0, s) for q in range(4)],
                            iters=3, warmup=1)
        else:
            ms = cuda_ms(lambda: roi_align_pyramid(pyr, rois, lvl, strides, 7, 0, s))
            plain = cuda_ms(lambda: roi_align_plain(pyr, rois, lvl, strides, 7, 0, s),
                            iters=3, warmup=1)
        nbytes, ops = k2_bound(pyr, rois, lvl, strides, s, all_lv)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        for key, v in (("ms", ms), ("plain_ms", plain), ("bytes_ms", b_ms), ("ops_ms", o_ms)):
            k2[key] += v
        print(f"K2 roi_align {name}: {ms * 1e3:.1f} us; plain {plain * 1e3:.1f} us; bound "
              f"{max(b_ms, o_ms) * 1e3:.1f} us ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP) "
              f"({card})")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_detector(model, imgs[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device activity: the device-side events (kernels, copies, sets); the
    # htd.* spans appear as host ranges and as device ranges with idle gaps
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("htd.")]
    dev_us = sum(e.self_device_time_total for e in on_device)
    print(f"profiled request: wall {wall:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / wall:.1f}% of the wall time; profiling inflates the "
          f"host side)")
    spans = {}
    for e in events:
        if e.key.startswith("htd."):
            host, dev = spans.get(e.key, (0.0, 0.0))
            spans[e.key] = (host + e.cpu_time_total, dev + e.device_time_total)
    for key, (host, dev) in spans.items():
        print(f"  layer {key[4:]:<14s} host {host / 1e3:7.2f} ms, device range "
              f"{dev / 1e3:7.2f} ms")
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")

    n_img = len(imgs)
    kernels = [
        {"name": "pyramid_pack", "route": "cuda", "source": "htd_tpu_torch/csrc/pyramid_pack.cu",
         "replaces": "htd_tpu/ops/roi_align_pallas.py:196",
         "launches": main_counts["pyramid_pack"], "max_abs_err": k1_err[torch.bfloat16],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": "bytes",
         "library_ms": k1_lib},
        {"name": "roi_align", "route": "cuda", "source": "htd_tpu_torch/csrc/roi_align.cu",
         "replaces": "htd_tpu/ops/roi_align_pallas.py:1438",
         "launches": main_counts["roi_align"], "max_abs_err": k2_err[torch.bfloat16],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2["bytes_ms"], k2["ops_ms"]),
         "bound_by": "bytes" if k2["bytes_ms"] >= k2["ops_ms"] else "operations",
         "library_ms": None},
    ]
    print(f"kernel times are per image (K2: the sum of its 3 calls per request); "
          f"launches are over the {n_img} main-path requests; max_abs_err is bfloat16 vs "
          f"the plain version; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    with torch.inference_mode():
        main()
