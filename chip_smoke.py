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
     levels and proposals of the first request, in bfloat16 and float32
     (K2's stage calls at S=4, one also at S=2, the BA call at S=1);
  6. timings: warm per-image latency, per-kernel times beside their bounds
     (K1 and K2 also by device time; K2 per call and per image, and probed
     with every sample outside the image), a device-time profile of one
     request;
  7. main path: HTD R-101-DCN (full depth and width, bfloat16, seeded
     non-zero offset convs) on the same requests, with K3's launches per
     request (30, every one on the tensor-core path) and the offsets'
     statistics;
  8. K3 held to its plain version on the main path's own activations (one
     stride-2 and one stride-1 deformable conv of each DCN stage), in
     bfloat16 and float32, and with two deform groups (the offsets and
     their negation; the offsets tiled, bit-equal to one group);
  9. reference: R-101-DCN in float32 on the card against the CPU;
 10. HTD X-101-64x4d-DCN: one bfloat16 request at its test scale, with K3
     on grouped convs (the CUDA-core path) held to its plain version;
 11. R-101-DCN timings: warm per-image latency, K3 per stage and per image
     by device time and by events beside its bound, its plain version and
     cuDNN's regular conv of the same shapes (context only), a device-time
     profile of one request;
 12. main path: HTD R-50 training (full depth and width, bfloat16 under
     autocast, float32 parameters, random weights from a seed) through
     `create_train_state` / `train_step` on a batch of 2 synthetic images
     in the 800x1344 bucket with seeded gts: finite losses, stem and layer1
     bit-unchanged, layer2+ and the heads updated, K1 1, K2 3 and K4 3
     launches per step;
 13. K4 held to its plain version on a training step's own pyramid,
     sampled rois and cotangents (stage 0, stage 1, the BA pass), in
     bfloat16 and float32, run twice for its run-to-run spread;
 14. reference: one float32 train step on the card against the CPU on a
     small batch with injected samples (loss terms, the gradient of every
     parameter, the parameters after the SGD step);
 15. training timings: median and p90 per step, images/s, K4 per call and
     per step (by events and by device time: the kernel, its buffer's
     zeroing and the cast after it apart, and probed with every sample
     outside the image; its 16-byte atomics folded and unfolded) beside its
     bound and its plain version, a device-time profile of one step;
 16. main path: HTD R-101-DCN training (full depth and width, bfloat16,
     bn3 scales opened from zero and seeded offset convs) on phase 12's
     batch: finite losses, stem and layer1 bit-unchanged, every DCN weight
     and offset conv with a non-zero gradient, K1 1, K2 3, K3 30, K4 3, K5
     30 and K6 30 launches per step, every K3, K5 and K6 launch on the
     tensor-core path;
 17. K5 and K6 held to their plain version on a training step's own
     inputs (one stride-2 and one stride-1 deformable conv of each stage),
     with one and (bfloat16) two deform groups, and on X-101-64x4d-DCN's
     grouped shapes, in bfloat16 and float32, each run twice (bfloat16 K6
     on the tensor cores within 1e-4 of max |plain| plus one bfloat16
     ulp);
 18. reference: one float32 R-101-DCN train step on the card against the
     CPU (loss terms, every gradient, the DCN leaves and the backbone's
     other leaves held as groups of their own, and the parameters after
     the step), with a control: the same comparison against CPU steps
     with a fault planted in K5's and in K6's plain version must fail;
 19. R-101-DCN training timings: median and p90 per step, images/s, K5 and
     K6 per launch and per step by events and by device time beside their
     bounds (K6's d_off and d_w grids apart, per stage and per step, with
     d_w's TFLOP/s), their plain version, cuDNN's regular-conv backward of
     the same shapes (context only), probes of K5 and K6 with every sample
     outside the image, a device-time profile of one step;
 20. K7 (the FPN upsample-add) and K8 (the layout fence) held to their
     plain versions, bit for bit, on the main path's own laterals (phase 3's
     first request, the three top-down pairs) in bfloat16 and float32, K7's
     channels_last output and autograd function; K7's times per image
     beside its bound, its plain version and `lat + F.interpolate`;
 21. main path: one R-101-DCN bfloat16 request with HTD_FPN_FENCE,
     HTD_RPN_FENCE and HTD_DCN_FENCE set: detections bit-identical to the
     unfenced request, K8 launched 3 + 5 + 30 times; K8's time on the
     largest fenced tensor and on the largest deformable-conv input beside
     its bound, its plain version and `clone()` (K8 and `clone()` timed in
     turns in one loop, L2 flushed before each call, medians of their
     device times);
 22. main path: `aug_inference_detector` on R-101-DCN bfloat16, two scales
     with flip (4 augs, K7 6 times and K3 60 times per aug); one aug at the
     test scale against `inference_detector` in float32; warm latency;
 23. main path: `evaluate_dataset` and `evaluate_proposals` of R-50
     bfloat16 at batch 8 on a synthetic mini-COCO of 16 seeded images; the
     evaluator's self-check (the ground truth as detections scores mAP 1);
     images/s.
 24. main path: the command-line tools of tools_torch/ in process on phase
     23's mini-COCO written as PNG files (read back bit-equal through
     `CocoDataset.load_image`, which needs no OpenCV for them):
     train.py (R-50 bf16, batch 2 at the preset's scale, two epochs on 8
     images: config.json, train.log.json, epoch_1.pth, epoch_2.pth, finite
     losses; K1 1, K2 3, K4 3, K7 3 launches per step), the same run resumed
     from epoch_1.pth with --val-ann (its first logged losses against the
     uninterrupted run's at that step), test.py on epoch_2.pth with --dump
     and --coco-dump (K1, K2, K7 per batch as phase 23) and eval_metric.py
     on the dump (the same metrics), --eval proposal, --aug on 2 images,
     test.py on R-101-DCN (K3 30 launches, tensor cores), publish_model.py
     (the published file's detections bit-identical to the checkpoint's);
     each step's wall time.
 25. data parallel (`htd_tpu_torch.parallel`): (a) R-50 bf16 training on
     phase 12's batch over NCCL at world size 1 in this process (K1 1,
     K2 3, K4 3, K7 3 launches per step; one all-reduce and NCCL's kernel
     in a profiled step; warm steps with and without the group; a float32
     step with injected samples within phase 14's limits of the step
     without a group), and two NCCL ranks on one card refused by NCCL;
     (b) two gloo ranks spawned on the card, batch 2 each: 4 steps with
     the launches checked, the parameters bit-identical across the ranks
     after each, step medians, the packed vector's size and its
     all-reduce's time by events (gloo's host path); a float32 step per
     rank with its own injected samples within phase 14's limits of the
     mean of the two halves' gradients and the SGD step computed here;
     (c) `evaluate_dataset` over two gloo ranks on phase 23's mini-COCO
     at batch 8 per rank: metrics and gathered detections bit-identical
     to one fresh process's at batch 8 (spawned as the ranks are, cuDNN's
     heuristics and deterministic algorithms in all three), against phase
     23's autotuned metrics too; (d) `torchrun --standalone
     --nproc_per_node 2 tools_torch/train.py --distributed --dist-backend
     gloo` (one epoch; one checkpoint and one log, by rank 0, no line
     twice) and tools_torch/test.py --chips 2 against --chips 1 at the
     same per-rank batch (metrics within one unit of the 4th place).
 26. JPEG and robustness: (a) the JPEG fixtures of tests/data/jpeg read by
     the port's host decoder (csrc/jpeg_decode.cpp, built by the host's
     C++ compiler) bit-equal to cv2.imread's pixels (the manifest's
     SHA-256): baseline, progressive, CMYK and cut-short files, and the
     host decode time of the photo-sized ones, the progressive photo apart
     from the baseline ones; (b) tools_torch/test.py --eval bbox on a
     mini-COCO of the five photo-sized JPEG files, the progressive one
     among them (K1 1, K2 3, K7 3 per batch); (c)
     tools_torch/test_robustness.py, R-50 bf16 at batch 8, on phase 24's
     PNG mini-COCO with all 19 corruptions at severities 0, 1, 3 and 5:
     every cell in its json, K1 1, K2 3, K7 3 launches per batch in every
     cell, severity 0's detections bit-identical to `evaluate_dataset`'s on
     the clean set with the same model, then robustness_eval.py's P, mPC and
     rPC; (d) all 19 corruptions at severities 1-5 on two seeded probe
     images against the SHA-256 of the JAX package's outputs
     (tests/data/jpeg/corruptions.json), and each corruption's host time
     per megapixel.
 27. production-scale evaluation and the last tools: (a) the arithmetic-coded
     and lossless fixtures of tests/data/jpeg against the manifest, and the
     host decode rate of the photo-sized baseline, arithmetic and lossless
     (written here, decoded to its source pixels) files; (b)
     tools_torch/drill_production.py --images 100 at 1333x800 (its test.py and
     coco_error_analysis.py in this process: K1 1, K2 3, K7 3 launches per
     batch of 4; the card's float32 detections against the port's float32
     on the CPU for a subset; the COCO matcher's host seconds, native and
     its numpy twin, on test.py's dump); (c) tools_torch/ab_fidelity.py in
     both modes at 768x1344 bf16 (5 rungs each, K2 3 launches per call, ms
     per image by CUDA events); (d) tools_torch/get_flops.py for R-50 and
     R-101-DCN at 768x1344 bf16; (e) tools_torch/dist_test.sh with one chip
     against test.py, and dist_train.sh under torchrun with one NCCL rank
     for 2 steps; each part's wall time.
Every forward launches K7 3 times (one per FPN top-down add), whatever its
batch. It needs CUDA: with no GPU, or run outside the repository, it fails.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SCORE_SCALE = 4.0          # seeded fc_cls std 0.01 -> 0.04, see phase 3
REQUEST_SHAPES = [(480, 640), (600, 800), (427, 640), (720, 1280)]
TIMED_REQUESTS = 20
# seeded offset convs give offsets of about this std (px) at each DCN
# conv's input scale, so that samples leave their taps (phase 7)
OFFSET_PX = 2.0
TPU_FB_CAP = 128           # the TPU kernel's exactly corrected pixels per image and conv
DCN_CHECKED = ("layer2.0", "layer2.1", "layer3.0", "layer3.1", "layer4.0", "layer4.1")
TRAIN_STEPS = 3            # phases 12 and 16: counted main-path steps
# phase 16's bottleneck bn3 scales, from mmdet's zero init, so that the
# deformable convs get a gradient in the first step
RESIDUAL_SCALE = 0.1
# phase 16's watched DCN leaves: stride 2 and stride 1, weights and offset convs
DCN_WATCHED = ("backbone.layer2.0.conv2.weight", "backbone.layer2.1.conv2.conv_offset.weight",
               "backbone.layer3.0.conv2.weight", "backbone.layer3.0.conv2.conv_offset.weight",
               "backbone.layer3.5.conv2.weight", "backbone.layer3.5.conv2.conv_offset.weight",
               "backbone.layer4.0.conv2.conv_offset.bias", "backbone.layer4.2.conv2.weight")
# phase 17's X-101-64x4d-DCN convs: (name, input height, width, channels,
# stride) at batch 2 in the 800x1344 bucket
X101_CONVS = (("layer2.0", 200, 336, 512, 2), ("layer3.1", 50, 84, 1024, 1),
              ("layer4.1", 25, 42, 2048, 1))
TIMED_STEPS = 10           # phase 15's warm steps
# phases 6 and 15's probes move every roi this far (px) past the image, so
# that every sample of K2 and K4 lies outside it
OUTSIDE_PX = 1e5
TTA_SCALES = ((1333, 800), (1600, 1000))   # phase 22, each with and without flip
TTA_TIMED = 5              # phase 22's warm TTA calls
INTERLEAVED = 60           # phase 21's calls of K8 and clone(), each
MINI_COCO_IMAGES = 16      # phase 23's seeded images, half landscape
TOOLS_TRAIN_IMAGES = 8     # phase 24 trains on this many of them, half landscape
# phase 24: the resumed run's first logged losses (4 places) against the
# uninterrupted run's at the same step
RESUME_LIMIT = 1e-3
GLOO_STEPS = 4             # phase 25 (b): train steps per rank, the first cold
# phase 25: the tools print metrics to 4 places; two runs agree within one unit
METRIC_LIMIT = 1e-4
RANK_JOIN_S = 600          # phase 25: the longest a group of spawned ranks may take
TRAIN_BUCKET = (800, 1344)
JPEG_DIR = "tests/data/jpeg"     # phase 26's fixtures and manifests
PHOTO_DECODES = 5          # phase 26 (a): timed decodes of each photo-sized fixture
ROBUST_SEVERITIES = (0, 1, 3, 5)   # phase 26 (c)
ARITH_PHOTO = "photo5_arith.jpg"   # phase 27 (a): the photo-sized arithmetic fixture
DRILL_IMAGES = 100         # phase 27 (b): tools_torch/drill_production.py --images
DRILL_MIRROR = 5           # its --mirror-images (each a float32 forward on the host's CPU)
DRILL_SCALE = (1333, 800)
DEVICE_TIME_TRACES = 3      # traces `device_times` takes before it fails on a launch count
SMALL_STEP_HW = (192, 288)  # phases 14, 18 and 25: the float32 reference step's batch
TRAIN_IMG_SHAPES = [(800, 1333), (750, 1344)]
# seeded gts of the training batch: (x1, y1, w, h) in px, several scales
TRAIN_GTS = [[(100, 80, 420, 380), (600, 150, 160, 220), (900, 500, 60, 45),
              (300, 600, 90, 110), (1100, 100, 200, 600), (40, 700, 28, 36)],
             [(50, 50, 700, 500), (800, 300, 300, 250), (400, 620, 48, 64),
              (1200, 650, 100, 80), (700, 100, 32, 24)]]


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


def device_times(fn, keys=None, iters: int = 20, cold: bool = False) -> dict:
    """Device time of one fn() in ms from a `torch.profiler` trace of
    `iters` runs: of all the kernels and copies it launches ("all"), and of
    those whose names contain each key of `keys` ({key: launches per fn()
    call}). Unlike `cuda_ms` it leaves out the host's dispatch, which sets
    the pace of a short call launched from Python.

    The profiler loses some launches' records (on the H100 late in this
    script: one K4 call of 10 in every trace, whatever the spins around
    the loop; once a whole trace of 115 K3 launches; a quarter of K5's
    launches in three traces running), so each kernel's time is its mean
    over the launches the trace holds, times its launches per call: the
    count `keys` gives for a key that one kernel name matches, when the
    trace holds at least one and at most that many of its launches per
    run; else its count over `iters`, rounded. A trace that so gives a key
    other launches per call than `keys` says (none held, more than
    launched, or a key over several names that lost records) is taken
    again, and after DEVICE_TIME_TRACES such traces the call fails;
    records lost are reported. With `cold`, a 256 MB `bitwise_not_`
    before each run evicts the 50 MB L2 cache, so that a byte-bound call
    reads its inputs from device memory; its own kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    keys = keys or {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TIME_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("htd.") and "bitwise_not" not in e.key]
        per_call = {e.key: round(e.count / iters) for e in events}
        for k, n in keys.items():
            named = [e for e in events if k in e.key]
            if len(named) == 1 and 0 < named[0].count <= iters * n:
                per_call[named[0].key] = n      # records are lost, never added
        got = {k: sum(n for name, n in per_call.items() if k in name) for k in keys}
        if got == keys:
            break
        print(f"  device_times: the trace gives {got} launches per call, not {keys}; traced again")
    else:
        fail(f"device_times: {DEVICE_TIME_TRACES} traces gave {got} launches per call, not {keys}")
    caught = {k: sum(e.count for e in events if k in e.key) for k in keys}
    if any(caught[k] != iters * n for k, n in keys.items()):
        print(f"  device_times: the trace holds {caught} of {iters} x {keys} launches; means over "
              f"the launches it holds")
    ms = {e.key: e.device_time_total / e.count * per_call[e.key] / 1e3 for e in events}
    out = {"all": sum(ms.values())}
    for key in keys:
        out[key] = sum(v for name, v in ms.items() if key in name)
    return out


def device_ms(fn, iters: int = 20, cold: bool = False) -> float:
    """`device_times(fn)["all"]`: the device time of one fn() in ms."""
    return device_times(fn, None, iters, cold)["all"]


def interleaved_ms(fns: dict, iters: int = INTERLEAVED):
    """Median device time in ms of each of `fns` (name -> (callable, key)),
    the callables timed in turns in one loop (so that clocks and
    neighbours drift alike for all): before each call a 256 MB
    `bitwise_not_` evicts the 50 MB L2 cache, and a profiler trace gives
    each device op its own time, the host's dispatch left out. An op is
    the first name's whose key its trace name contains (key "" takes every
    op). Returns the medians and the number of ops traced per name."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn, _ in fns.values():
                flush.bitwise_not_()
                fn()
        torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or "bitwise_not" in e.name:
            continue
        name = next(k for k, (_, key) in fns.items() if key in e.name)
        times[name].append(e.device_time_total)
    counts = {k: len(v) for k, v in times.items()}
    if min(counts.values()) < iters // 2:
        fail(f"the trace holds too few of the {iters} calls each: {counts}")
    return {k: statistics.median(v) / 1e3 for k, v in times.items()}, counts


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


def small_inputs():
    """A small image and 64 fixed proposals for the card-vs-CPU check."""
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
    return torch.from_numpy(small), shape, torch.from_numpy(props), torch.ones(1, 64, dtype=torch.bool)


def card_vs_cpu(gpu32, cpu32) -> None:
    """`stages_forward` of the float32 detector on the card (kernels, cuDNN
    without TF32) against the CPU (plain versions) on `small_inputs`."""
    small, shape, props, valid = small_inputs()
    with torch.inference_mode():
        gb, gs = gpu32.stages_forward(small, shape, props, valid)
        cb, cs = cpu32.stages_forward(small, shape, props, valid)
    box_err = (gb.cpu() - cb).abs().max().item()
    score_err = (gs.cpu() - cs).abs().max().item()
    print(f"stages_forward on 64 fixed proposals at 192x288: max box err {box_err:.3g} px "
          f"(limit 1e-2), max score err {score_err:.3g} (limit 1e-3)")
    if not (box_err <= 1e-2 and score_err <= 1e-3):
        fail("the card disagrees with the CPU reference")


def warm_latency(model, imgs, card):
    """Prints the median and p90 (ms) of `inference_detector` over
    TIMED_REQUESTS warm requests, host clock around work that ends in a
    synchronize."""
    from htd_tpu_torch import inference_detector

    lat = []
    for i in range(TIMED_REQUESTS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_detector(model, imgs[i % len(imgs)])
        torch.cuda.synchronize()
        if i >= 2:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    med, p90 = statistics.median(lat), lat[int(0.9 * len(lat)) - 1]
    print(f"warm latency per image, inference_detector incl. preprocessing, "
          f"{len(lat)} requests: median {med:.2f} ms, p90 {p90:.2f} ms, min {lat[0]:.2f} ms "
          f"({card})")


def profile_request(model, img) -> None:
    """Device busy share, host and device time per `htd.*` layer span, and
    the largest device entries of one profiled request."""
    from torch.profiler import ProfilerActivity, profile

    from htd_tpu_torch import inference_detector

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_detector(model, img)
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


def dcn_convs(model):
    """(name, module) of every deformable conv in forward order, named
    `layer{s}.{i}`."""
    from htd_tpu_torch.ops.dcn import DeformConv2d

    return [(n[len("backbone."):-len(".conv2")], m) for n, m in model.named_modules()
            if isinstance(m, DeformConv2d)]


def offset_stds(model, img):
    """Per deformable conv, the `conv_offset` weight std that gives offsets
    of std about OFFSET_PX at that conv's input: OFFSET_PX / (sqrt(9 Cin)
    rms(input)), the rms measured on one request with mmcv's zero offsets."""
    from htd_tpu_torch import inference_detector

    rms = {}
    convs = dcn_convs(model)
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: rms.__setitem__(name, args[0].float().square().mean().sqrt()))
        for name, m in convs]
    inference_detector(model, img)
    for h in hooks:
        h.remove()
    return [OFFSET_PX / (math.sqrt(9 * m.conv_offset.in_channels) * rms[name].item())
            for name, m in convs]


def set_offsets(model, stds, seed: int = 0) -> None:
    """Seeded normal `conv_offset` weights with the given stds and zero
    bias, drawn on the CPU: models given the same stds get the same
    offset convs."""
    g = torch.Generator().manual_seed(seed)
    for (_, m), std in zip(dcn_convs(model), stds):
        w = m.conv_offset.weight
        w.copy_(torch.empty(w.shape).normal_(0.0, std, generator=g))
        m.conv_offset.bias.zero_()


class OffsetStats:
    """Over the deformable convs of the requests it watches: the offsets'
    rms; the samples more than 1 px from their tap; the samples outside
    the image; the samples the TPU kernel's window (floor displacement in
    [-1, 1] on each axis) flags for its capped correction pass, and the
    convs in which more than TPU_FB_CAP pixels of an image are flagged
    (the TPU kernel sets the samples beyond its cap to zero). Counts stay
    on the device until `report`."""

    def __init__(self, model):
        self.sums = torch.zeros(6, dtype=torch.float64, device=model.device)
        self.max_px = torch.zeros((), dtype=torch.int64, device=model.device)
        self.hooks = [m.conv_offset.register_forward_hook(self._hook)
                      for _, m in dcn_convs(model)]

    @torch.no_grad()
    def _hook(self, conv, args, out):
        h, w = args[0].shape[-2:]
        n, _, ho, wo = out.shape
        dev = out.device
        off = out.float().permute(0, 2, 3, 1).reshape(n, ho, wo, 9, 2)
        tap = torch.arange(9, device=dev)
        s = conv.stride[0]
        by = (torch.arange(ho, device=dev) * s - 1).view(1, ho, 1, 1) + (tap // 3).view(1, 1, 1, 9)
        bx = (torch.arange(wo, device=dev) * s - 1).view(1, 1, wo, 1) + (tap % 3).view(1, 1, 1, 9)
        ys, xs = by + off[..., 0], bx + off[..., 1]
        inside = (ys > -1) & (ys < h) & (xs > -1) & (xs < w)
        dy, dx = torch.floor(ys) - by, torch.floor(xs) - bx
        flagged = inside & ((dy < -1) | (dy > 1) | (dx < -1) | (dx > 1))
        px = flagged.any(-1).flatten(1).sum(1)
        far = torch.maximum(off[..., 0].abs(), off[..., 1].abs()) > 1
        self.sums += torch.stack([
            torch.full((), float(inside.numel()), device=dev), off.square().sum() / 2,
            far.sum(), (~inside).sum(), flagged.sum(), (px > TPU_FB_CAP).sum()]).double()
        self.max_px = torch.maximum(self.max_px, px.max())

    def report(self, pairs: int) -> dict:
        for hk in self.hooks:
            hk.remove()
        n, sq, far, out, flag, over = self.sums.tolist()
        st = {"offset_rms_px": math.sqrt(sq / n), "far": far / n, "outside": out / n,
              "flagged": flag / n, "over_cap": int(over), "max_px": int(self.max_px)}
        print(f"offsets over {pairs} (deformable conv, image) pairs: rms "
              f"{st['offset_rms_px']:.2f} px; {100 * st['far']:.1f}% of samples more than 1 px "
              f"from their tap; {100 * st['outside']:.1f}% outside the image; "
              f"{100 * st['flagged']:.1f}% outside the TPU kernel's window; in {st['over_cap']} "
              f"of {pairs} pairs more than {TPU_FB_CAP} pixels of an image were flagged (max "
              f"{st['max_px']}), whose samples beyond the cap the TPU kernel sets to zero; K3 "
              f"computes all of them exactly")
        return st


def capture_dcn(model, img):
    """(name, module, x, offsets) of every deformable conv on one request:
    the NHWC views the module hands K3."""
    from htd_tpu_torch import inference_detector

    got = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda conv, args, out, name=name, m=m: got.append(
            (name, m, args[0].permute(0, 2, 3, 1), out.permute(0, 2, 3, 1))))
        for name, m in dcn_convs(model)]
    inference_detector(model, img)
    for h in hooks:
        h.remove()
    if not all(x.is_contiguous() and o.is_contiguous() for _, _, x, o in got):
        fail("a deformable conv's NHWC input or offsets view is not contiguous")
    return got


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at the magnitude `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def check_k3(captured, names):
    """K3 against its plain version on captured activations, in bfloat16
    and float32. Both compute the same samples (blended in float32, in
    bfloat16 rounded once) and sum their products in float32 in another
    order, so the limit is 1e-4 of max |plain|, plus one bfloat16 ulp of
    it where the output is rounded to bfloat16. Returns the bfloat16 max
    abs error."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst_abs = worst_rel = worst_lim = 0.0
        for name, m, x, off in captured:
            if name not in names:
                continue
            args = (x.to(dtype), off.to(dtype), m.hwio_weight().to(dtype), m.stride, 1, 1,
                    m.groups)
            k = deform_conv2d(*args).float()
            p = deform_conv2d_plain(*args).float()
            e, scale = (k - p).abs().max().item(), p.abs().max().item()
            lim = 1e-4 + (bf16_ulp(scale) / scale if dtype == torch.bfloat16 else 0.0)
            if e > lim * scale:
                fail(f"K3 {name} disagrees with its plain version in {dtype}: max abs err "
                     f"{e:.3g}, limit {lim * scale:.3g}")
            worst_abs, worst_rel, worst_lim = max(worst_abs, e), max(worst_rel, e / scale), \
                max(worst_lim, lim)
        torch.cuda.synchronize()
        errs[dtype] = worst_abs
        print(f"{str(dtype)[6:]}: K3 vs plain over {', '.join(names)} (groups "
              f"{captured[0][1].groups}): max abs err {worst_abs:.3g}, max err relative to "
              f"max |plain| {worst_rel:.3g} (limit 1e-4"
              f"{' + one bfloat16 ulp, at most ' + format(worst_lim, '.3g') if dtype == torch.bfloat16 else ''})")
    return errs[torch.bfloat16]


def check_k3_deform_groups(captured, names):
    """K3 with two deform groups on captured bfloat16 activations: the
    captured offsets for the first group and their negation for the second,
    against the plain version (the limit of `check_k3`); and the captured
    offsets tiled over both groups, which must give K3's one-group output
    bit for bit (the same samples, contracted in the same order)."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain
    from htd_tpu_torch.ops.roi_align_cuda import path_counts, reset_launch_counts

    worst = 0.0
    reset_launch_counts()
    for name, m, x, off in captured:
        if name not in names:
            continue
        w = m.hwio_weight()
        two = torch.cat([off, -off], -1).contiguous()
        k = deform_conv2d(x, two, w, m.stride, 1, 2, m.groups).float()
        p = deform_conv2d_plain(x, two, w, m.stride, 1, 2, m.groups).float()
        e, scale = (k - p).abs().max().item(), p.abs().max().item()
        if e > 1e-4 * scale + bf16_ulp(scale):
            fail(f"K3 {name} with two deform groups: max abs err {e:.3g} (max |plain| "
                 f"{scale:.3g})")
        tiled = deform_conv2d(x, off.repeat(1, 1, 1, 2).contiguous(), w, m.stride, 1, 2, m.groups)
        if not torch.equal(tiled, deform_conv2d(x, off, w, m.stride, 1, 1, m.groups)):
            fail(f"K3 {name}: offsets tiled over two deform groups differ from one group")
        worst = max(worst, e / scale)
    torch.cuda.synchronize()
    print(f"bfloat16: K3 with two deform groups (offsets and their negation) vs plain over "
          f"{', '.join(names)}: max err {worst:.3g} of max |plain| (limit 1e-4 + one bfloat16 "
          f"ulp); tiled offsets bit-equal to one group; paths {dict(path_counts)}")


def run_requests(model, imgs, cfg, per_request_k3: int, k3_path: str = "tc"):
    """The main path: `inference_detector` on each image with the launch
    counts set to 0 just before and read just after; every request must
    launch K1 and K2, K7 3 times and, with deformable convs, K3
    `per_request_k3` times, each on `k3_path` ("tc": the tensor cores,
    "cc": the CUDA cores)."""
    from htd_tpu_torch import inference_detector
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, path_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    for img in imgs:
        before, paths = dict(launch_counts), dict(path_counts)
        boxes, scores, labels = inference_detector(model, img)
        counts = {k: launch_counts[k] - before[k] for k in launch_counts}
        on_path = path_counts[f"deform_conv_{k3_path}"] - paths[f"deform_conv_{k3_path}"]
        check_detections(boxes, scores, labels, img, cfg)
        if counts["pyramid_pack"] <= 0 or counts["roi_align"] <= 0 \
                or counts["deform_conv"] != per_request_k3 or counts["upsample_add"] != 3:
            fail(f"unexpected launches on request {img.shape}: {counts}")
        if on_path != per_request_k3:
            fail(f"{on_path} of {per_request_k3} K3 launches on request {img.shape} took the "
                 f"{k3_path} path: {dict(path_counts)}")
        print(f"request {img.shape[1]}x{img.shape[0]}: {len(scores)} detections, "
              f"top scores {np.round(scores[:3], 4).tolist()}, labels "
              f"{labels[:3].tolist()}, first box {np.round(boxes[0], 1).tolist()}, "
              f"launches {counts}")
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    print(f"main path launches over {len(imgs)} requests: {counts}; K3 paths {dict(path_counts)}")
    return counts


def k3_work(x, off, w, groups, stride):
    """(bytes, operations) of one K3 call: x, offsets, weight read once and
    the output written once; 2 * Ho * Wo * 9 * Cin * Cout / groups."""
    n, ho, wo = off.shape[:3]
    cout = w.shape[-1]
    esize = x.element_size()
    nbytes = (x.numel() + off.numel() + w.numel() + n * ho * wo * cout) * esize
    return nbytes, 2 * n * ho * wo * 9 * x.shape[-1] * cout // groups


def dcn_phases(imgs, card):
    """Phases 7-11 (R-101-DCN, X-101-DCN); returns K3's kernel record."""
    import torch.nn.functional as F

    from htd_tpu_torch import htd_r101_dcn_2x, htd_x101_dcn_2x, init_detector
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    phase("7 main path: HTD R-101-DCN, bfloat16, 800x1344 bucket")
    cfg = htd_r101_dcn_2x(compute_dtype="bfloat16")
    model = init_detector(cfg, seed=0)
    scale_scores(model)
    stds = offset_stds(model, imgs[0])
    set_offsets(model, stds, seed=0)
    n_dcn = len(dcn_convs(model))
    print(f"init_detector(htd_r101_dcn_2x(compute_dtype='bfloat16'), seed=0); fc_cls x"
          f"{SCORE_SCALE}; {n_dcn} deformable convs; conv_offset weights seeded normal with "
          f"std {min(stds):.2e}-{max(stds):.2e} (zero bias), for offsets of about "
          f"{OFFSET_PX} px std; soft-NMS {cfg.rcnn_test.use_soft_nms}")
    stats = OffsetStats(model)
    counts = run_requests(model, imgs, cfg, per_request_k3=30)
    st = stats.report(n_dcn * len(imgs))
    if st["far"] < 0.05 or st["outside"] <= 0.0:
        fail("the seeded offsets do not move samples off their taps and out of the image")

    phase("8 K3 vs its plain version on the main path's own activations")
    captured = capture_dcn(model, imgs[0])
    stages = [name.split(".")[0] for name, _, _, _ in captured]
    split = {st: stages.count(st) for st in dict.fromkeys(stages)}
    n_s2 = sum(m.stride == 2 for _, m, _, _ in captured)
    print(f"captured {len(captured)} deformable convs of request "
          f"{imgs[0].shape[1]}x{imgs[0].shape[0]} ({split}, {n_s2} of stride 2); NHWC views "
          f"contiguous: True")
    if split != {"layer2": 4, "layer3": 23, "layer4": 3} or n_s2 != 3:
        fail("R-101-DCN's deformable convs are not 4 + 23 + 3 with 3 of stride 2")
    k3_err = check_k3(captured, DCN_CHECKED)
    check_k3_deform_groups(captured, DCN_CHECKED)

    phase("9 reference: R-101-DCN float32 on the card vs the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_cfg = htd_r101_dcn_2x()
    gpu32 = init_detector(ref_cfg, device="cuda", seed=0)
    cpu32 = init_detector(ref_cfg, device="cpu", seed=0)
    for m in (gpu32, cpu32):
        scale_scores(m)
        set_offsets(m, stds, seed=0)
    card_vs_cpu(gpu32, cpu32)
    del gpu32, cpu32

    phase("10 HTD X-101-64x4d-DCN, bfloat16, one request at its test scale")
    xcfg = htd_x101_dcn_2x(compute_dtype="bfloat16")
    xm = init_detector(xcfg, seed=0)
    scale_scores(xm)
    set_offsets(xm, offset_stds(xm, imgs[0]), seed=0)
    print(f"init_detector(htd_x101_dcn_2x(compute_dtype='bfloat16'), seed=0), test scale "
          f"{xcfg.test_scale}, groups {xcfg.backbone.groups}")
    xstats = OffsetStats(xm)
    run_requests(xm, imgs[:1], xcfg, per_request_k3=30, k3_path="cc")
    xstats.report(len(dcn_convs(xm)))
    xcap = capture_dcn(xm, imgs[0])
    check_k3(xcap, ("layer2.0", "layer3.1", "layer4.1"))
    del xm, xcap

    phase("11 R-101-DCN timings")
    warm_latency(model, imgs, card)
    k3 = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    per_stage = {}
    for name, m, x, off in captured:
        w = m.hwio_weight()
        args = (x, off, w, m.stride, 1, 1, m.groups)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), m.weight
        ms = cuda_ms(lambda: deform_conv2d(*args))
        k3["ms"] += ms
        nbytes, ops = k3_work(x, off, w, m.groups, m.stride)
        stage = per_stage.setdefault(name.split(".")[0], {"n": 0, "ms": 0.0, "ops": 0, "args": []})
        stage["n"] += 1
        stage["ms"] += ms
        stage["ops"] += ops
        stage["args"].append(args)
        k3["plain_ms"] += cuda_ms(lambda: deform_conv2d_plain(*args), iters=2, warmup=1)
        k3["cudnn_ms"] += cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, stride=m.stride, padding=1,
                                                   groups=m.groups))
        k3["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k3["ops_ms"] += ops / BF16_FLOP_PER_S * 1e3
        if name in ("layer2.0", "layer2.1", "layer3.1", "layer4.1"):
            print(f"K3 {name} (stride {m.stride}, {x.shape[-1]} ch, {x.shape[1]}x{x.shape[2]} -> "
                  f"{off.shape[1]}x{off.shape[2]}): {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB")
    # device time by stage: one profile over each stage's launches, the
    # host's dispatch left out
    k3["device_ms"] = 0.0
    for st, d in per_stage.items():
        d["device_ms"] = device_times(lambda: [deform_conv2d(*a) for a in d["args"]],
                                      {"deform_conv_fwd": len(d["args"])},
                                      iters=5)["deform_conv_fwd"]
        k3["device_ms"] += d["device_ms"]
    # what bounds K3: the same launches with every sample outside the image
    # (all corner weights 0, so no corner is loaded) leave the weight tiles,
    # the tensor cores and the corner tables
    for st, d in per_stage.items():
        far = [(a[0], torch.full_like(a[1], 1e4)) + a[2:] for a in d["args"]]
        d["no_sampling_ms"] = device_times(lambda: [deform_conv2d(*a) for a in far],
                                           {"deform_conv_fwd": len(far)},
                                           iters=5)["deform_conv_fwd"]
        del far
    print("K3 per stage: " + "; ".join(
        f"{st} {d['n']} launches, device {d['device_ms']:.3f} ms ({d['device_ms'] / d['n'] * 1e3:.1f} "
        f"us each, {d['ops'] / d['device_ms'] / 1e9:.1f} TFLOP/s), events {d['ms']:.3f} ms, "
        f"device with every sample outside the image (no corner loads) "
        f"{d['no_sampling_ms']:.3f} ms" for st, d in per_stage.items()))
    bound = max(k3["bytes_ms"], k3["ops_ms"])
    print(f"K3 per image ({len(captured)} launches, bf16, tensor-core path): device "
          f"{k3['device_ms']:.3f} ms ({100 * bound / k3['device_ms']:.1f}% of its bound), by events "
          f"{k3['ms']:.3f} ms ({k3['ms'] / len(captured) * 1e3:.1f} us per launch, the host's "
          f"dispatch included); bound {bound:.4f} ms (operations at 989 TFLOP/s bf16 "
          f"{k3['ops_ms']:.4f} ms, bytes at 3.35 TB/s {k3['bytes_ms']:.4f} ms); plain version "
          f"{k3['plain_ms']:.3f} ms; context: cuDNN regular conv of the same shapes "
          f"{k3['cudnn_ms']:.3f} ms ({card})")
    profile_request(model, imgs[0])
    return {"name": "deform_conv", "route": "cuda", "source": "htd_tpu_torch/csrc/deform_conv.cu",
            "replaces": "htd_tpu/ops/dcn_pallas.py:131", "launches": counts["deform_conv"],
            "path": "tensor cores (mma.sync bf16)", "max_abs_err": k3_err, "ms": k3["ms"],
            "device_ms": k3["device_ms"], "plain_ms": k3["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if k3["bytes_ms"] >= k3["ops_ms"] else "operations",
            "library_ms": None}


def train_batch(cfg, seed: int = 0):
    """Two normalized synthetic images in the 800x1344 bucket with the
    seeded TRAIN_GTS (labels from `seed`), padded to `max_gt`."""
    from htd_tpu_torch.train.train_step import TrainBatch

    rng = np.random.RandomState(seed)
    g = cfg.train.max_gt
    boxes = np.zeros((2, g, 4), np.float32)
    valid = np.zeros((2, g), bool)
    for i, gts in enumerate(TRAIN_GTS):
        for k, (x, y, w, h) in enumerate(gts):
            boxes[i, k] = [x, y, x + w, y + h]
            valid[i, k] = True
    return TrainBatch(torch.from_numpy(rng.normal(0, 1, (2,) + TRAIN_BUCKET + (3,))
                                       .astype(np.float32)),
                      torch.tensor(TRAIN_IMG_SHAPES, dtype=torch.float32),
                      torch.from_numpy(boxes),
                      torch.from_numpy(rng.randint(0, cfg.num_classes, (2, g)).astype(np.int32)),
                      torch.from_numpy(valid))


def record_roi_align_calls(state, batch, gen):
    """One train step with K2's and K4's launchers wrapped (each still
    launches its kernel once per call): the forward calls' rois in order
    (stage 0, stage 1, BA) and each K4 call's arguments, labelled by the
    forward call it differentiates."""
    from htd_tpu_torch.ops import roi_align_cuda as rac
    from htd_tpu_torch.train.train_step import train_step

    fwd, bwd = [], []
    orig_fwd, orig_bwd = rac.launch_roi_align, rac.launch_roi_align_bwd

    def rec_fwd(pyr, rois, *args):
        fwd.append(rois.clone())
        return orig_fwd(pyr, rois, *args)

    def rec_bwd(geom, rois, lvls, g, *args):
        bwd.append((geom, rois.clone(), None if lvls is None else lvls.clone(), g.clone(), args))
        return orig_bwd(geom, rois, lvls, g, *args)

    rac.launch_roi_align, rac.launch_roi_align_bwd = rec_fwd, rec_bwd
    try:
        train_step(state, batch, gen)
    finally:
        rac.launch_roi_align, rac.launch_roi_align_bwd = orig_fwd, orig_bwd
    names = ["stage-0 level-mapped", "stage-1 level-mapped", "BA all-level"]
    labelled = {}
    for call in bwd:
        k = next(i for i, r in enumerate(fwd) if r.shape == call[1].shape and torch.equal(r, call[1])
                 and (call[2] is None) == (i == 2))
        labelled[names[k]] = call
    if sorted(labelled) != sorted(names):
        fail(f"expected one K4 call per K2 call, got {sorted(labelled)}")
    return [(name, labelled[name]) for name in names]


def k4_work(geom, rois, lvls, g, strides, s):
    """(bytes, operations, unfolded atomics, folded atomics, distinct
    pixels) of one K4 call on this data: g and the rois read once, the
    float32 buffer zeroed, and each distinct pixel that a non-zero-weight
    corner of a bin with a non-zero cotangent touches read and written once
    in float32; one multiply and one add per channel of each such corner.
    Unfolded, a kernel makes one 16-byte atomic per such corner and 4
    channels; K4 folds them into one per distinct pixel of each roi (of
    each (roi, level) in the all-level mode) and 4 channels."""
    from htd_tpu_torch.ops.roi_align import _level_tables, _sample_geometry

    b, r = rois.shape[:2]
    n, c = b * r, geom.channels
    dev = rois.device
    flat = rois.reshape(n, 4).float()
    scale_t, hs, ws, offs = _level_tables(geom, strides, dev)
    img = torch.arange(b, device=dev).repeat_interleave(r)
    roi_id = torch.arange(n, device=dev)[:, None, None, None, None]
    pixels, per_roi, corners = [], [], 0
    levels = range(len(strides)) if lvls is None else [None]
    for q in levels:
        lv = torch.full((n,), q, device=dev) if q is not None else lvls.reshape(n).long()
        gq = (g[q] if q is not None else g).reshape(n, 7, 7, c)
        live_bin = (gq != 0).any(-1)[:, :, :, None, None]
        (xl, xh, lx, hx, mx, xin, yl, yh, ly, hy, my, yin, _, _) = _sample_geometry(
            flat, scale_t[lv], hs[lv], ws[lv], 7, 0, s)
        base = (img * geom.img_rows + offs[lv])[:, None, None, None, None]
        live = (my & yin)[:, :, None, :, None] & (mx & xin)[:, None, :, None, :] & live_bin
        for yi, wy in ((yl, hy), (yh, ly)):
            for xi, wx in ((xl, hx), (xh, lx)):
                keep = live & (wy[:, :, None, :, None] * wx[:, None, :, None, :] > 0)
                pix = (base + yi[:, :, None, :, None]) * geom.w_pad + xi[:, None, :, None, :]
                pixels.append(pix[keep])
                key = ((0 if q is None else q) * n + roi_id) * (geom.rows_pad * geom.w_pad) + pix
                per_roi.append(key.expand_as(keep)[keep])
                corners += int(keep.sum())
    distinct = int(torch.unique(torch.cat(pixels)).numel())
    folded = int(torch.unique(torch.cat(per_roi)).numel())
    nbytes = (g.numel() * g.element_size() + geom.rows_pad * geom.w_pad * c * 4
              + distinct * c * 4 * 2 + n * 16 + (0 if lvls is None else n * 4))
    return nbytes, 2 * corners * c, corners * c // 4, folded * c // 4, distinct


def injected_overrides(cfg, n_anchors: int, img_shape, seed: int = 0):
    """Seeded samples for `forward_train`'s `overrides` hook on a batch of
    2 with 3 gts per image: RPN anchors, proposals and both stages' blocks
    (gts and a few candidates positive, then negatives)."""
    rng = np.random.RandomState(seed)
    tc = cfg.train
    h, w = img_shape
    ov = {"rpn_keep_pos": np.zeros((2, n_anchors), bool),
          "rpn_keep_neg": np.zeros((2, n_anchors), bool),
          "rpn_matched_gt": rng.randint(0, 3, (2, n_anchors)).astype(np.int32)}
    for i in range(2):
        perm = rng.permutation(n_anchors)
        ov["rpn_keep_pos"][i, perm[:40]] = True
        ov["rpn_keep_neg"][i, perm[40:200]] = True
    n_prop = tc.rpn_proposal.nms_post
    wh = rng.uniform(8, [w * 0.7, h * 0.7], (2, n_prop, 2))
    xy = rng.uniform(0, 1, (2, n_prop, 2)) * ([w, h] - wh)
    ov["proposals"] = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    ov["proposal_valid"] = np.ones((2, n_prop), bool)
    num = tc.rcnn[0].sampler.num
    for s, n_cand in (("s0", n_prop), ("s1", num)):
        blk = {k: np.zeros((2, num), d) for k, d in (("idx", np.int32), ("valid", bool),
                                                     ("is_pos", bool), ("is_gt", bool),
                                                     ("gt_inds", np.int32))}
        for i in range(2):
            cand = rng.permutation(n_cand)[:num // 2] + tc.max_gt
            pos = [0, 1, 2] + list(cand[:5])
            rows = pos + list(cand[5:])
            blk["idx"][i, :len(rows)] = rows
            blk["valid"][i, :len(rows)] = True
            blk["is_pos"][i, :len(pos)] = True
            blk["is_gt"][i, :3] = True
            blk["gt_inds"][i, :len(pos)] = [0, 1, 2] + list(rng.randint(0, 3, 5))
        for k, v in blk.items():
            ov[f"{s}_{k}"] = v
    return {k: torch.from_numpy(v) for k, v in ov.items()}


def small_step_inputs(preset, seed: int = 3, ov_seed: int = 0):
    """Phase 14's float32 step at full depth and width: `preset()` with the
    sampler blocks cut to 128 rois (so that a CPU step stays short), a 2 x
    192x288 batch drawn from `seed` and injected samples from `ov_seed`.
    Returns (cfg, batch, overrides)."""
    import dataclasses

    from htd_tpu_torch.config import ProposalConfig, SamplerConfig
    from htd_tpu_torch.train.train_step import TrainBatch

    base = preset()
    tc = dataclasses.replace(
        base.train, rpn_proposal=ProposalConfig(300, 300, 300), rcnn_pos_cap=32,
        rcnn=tuple(dataclasses.replace(st, sampler=SamplerConfig(128, 0.25, True))
                   for st in base.train.rcnn))
    cfg = base.replace(train=tc)
    rng = np.random.RandomState(seed)
    h, w = SMALL_STEP_HW
    boxes = np.zeros((2, tc.max_gt, 4), np.float32)
    boxes[:, :3] = [[10, 12, 70, 90], [120, 40, 250, 170], [200, 140, 236, 180]]
    valid = np.zeros((2, tc.max_gt), bool)
    valid[:, :3] = True
    batch = TrainBatch(torch.from_numpy(rng.normal(0, 1, (2, h, w, 3)).astype(np.float32)),
                       torch.tensor([[h, w], [180.0, 270.0]]), torch.from_numpy(boxes),
                       torch.from_numpy(rng.randint(0, 80, (2, tc.max_gt)).astype(np.int32)),
                       torch.from_numpy(valid))
    cells = sum(-(-h // st) * -(-w // st) for st in (4, 8, 16, 32)) + -(-h // 64) * -(-w // 64)
    return cfg, batch, injected_overrides(cfg, 3 * cells, (h, w), seed=ov_seed)


def leaf_errors(a, b, refs, slack):
    """Per leaf, the error beyond `slack` relative to the leaf's largest
    reference value (floored at 1e-4 of the largest over all leaves)."""
    scale = max(float(v.abs().max()) for v in refs.values())
    return {n: float(((a[n] - b[n]).abs() - slack(b[n])).clamp(min=0).max())
            / max(float(refs[n].abs().max()), 1e-4 * scale) for n in refs}


def error_summary(errs, group):
    """A line with, per group (`group(name)` gives a leaf's group and its
    limit), its largest error, the worst leaf and the limit; the leaves
    over their group's limit."""
    worst = {}
    for n, e in errs.items():
        key = group(n)
        if e >= worst.get(key, (-1.0, ""))[0]:
            worst[key] = (e, n)
    line = "; ".join(f"{name} ({sum(group(n)[0] == name for n in errs)} leaves) {e:.3g} "
                     f"at {leaf} (limit {limit:g})"
                     for (name, limit), (e, leaf) in sorted(worst.items()))
    return line, [n for n in errs if errs[n] > group(n)[1]]


def hold_step(got, ref, before, group):
    """Phase 14's comparison of a float32 train step `got` = (loss terms,
    gradients, parameters after) with `ref`, from the parameters `before`:
    the loss terms' largest relative error (limit 1e-4), and per group of
    leaves the gradients (relative to the leaf's largest gradient) and the
    parameters after the SGD step (beyond two float32 ulps of the
    parameter, relative to the leaf's largest update; a parameter moves by
    about 1e-6 of itself in one step). Returns (loss error, gradient line,
    update line, leaves over their limit)."""
    (mg, gg, pg), (mc, gc, pc) = got, ref
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
    if set(gg) != set(gc) or not gg:
        fail("the two steps trained different parameters")
    g_line, g_over = error_summary(leaf_errors(gg, gc, gc, torch.zeros_like), group)
    ulps = lambda v: 2 * (torch.nextafter(v.abs(), torch.tensor(math.inf)) - v.abs())  # noqa: E731
    steps = {n: pc[n] - before[n] for n in gc}
    d_line, d_over = error_summary(leaf_errors(pg, pc, steps, ulps), group)
    return loss_err, g_line, d_line, g_over + d_over


def r50_group(n):
    return ("backbone", 1e-3) if n.startswith("backbone.") else ("rest", 1e-3)


def train_card_vs_cpu(preset, prepare=None, backbone_limit: float = 1e-3,
                      dcn_limit: float = 1e-3, faults=()) -> None:
    """One float32 train step (TF32 off) of `preset()` at full depth and
    width on the card and on the CPU, the same seeded weights (then
    `prepare(model)` on both), `small_step_inputs`' batch and injected
    samples. Deformable convs run K3 / K5 / K6 on the card and the plain
    versions on the CPU. Gradients and updates are held to 1e-3 of each
    leaf's scale (`hold_step`); the deformable convs' leaves to `dcn_limit`
    and the backbone's other leaves to `backbone_limit`, each group
    reported on its own. `faults`: (name, context manager) pairs, each a
    fault planted in the CPU step; the card's gradients are held against
    the CPU's under each fault too, and the check fails unless every fault
    takes some leaves over their limit (a control that the limits still
    catch such a fault at this size)."""
    from htd_tpu_torch.train.train_step import create_train_state, train_step

    cfg, batch, ov = small_step_inputs(preset)
    h, w = SMALL_STEP_HW
    dcn_leaves = set()

    def step(dev):
        """(loss terms, gradients, parameters before and after) on `dev`."""
        t0 = time.perf_counter()
        state = create_train_state(cfg, device=dev, seed=0)
        if prepare is not None:
            prepare(state.model)
        dcn_leaves.update(f"backbone.{name}.conv2.{leaf}" for name, _ in dcn_convs(state.model)
                          for leaf in ("weight", "conv_offset.weight", "conv_offset.bias"))
        before = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
        metrics = train_step(state, batch, overrides=ov)
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        after = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
        print(f"  {dev} step: {time.perf_counter() - t0:.1f} s")
        return {k: float(v) for k, v in metrics.items()}, grads, before, after

    mg, gg, _, pg = step("cuda")
    mc, gc, before, pc = step("cpu")
    if set(gg) != set(gc) or not gg:
        fail("the card and the CPU trained different parameters")
    zero = [n for n in dcn_leaves if n not in gc or not gc[n].abs().max() > 0]
    if zero:
        fail(f"DCN leaves without a non-zero gradient on the CPU: {zero[:4]}")

    def group(n):
        if n in dcn_leaves:
            return "DCN", dcn_limit
        return ("backbone", backbone_limit) if n.startswith("backbone.") else ("rest", 1e-3)

    loss_err, g_line, d_line, over = hold_step((mg, gg, pg), (mc, gc, pc), before, group)
    print(f"float32 train step, card vs CPU, 2 x {h}x{w}, injected samples: loss terms max rel "
          f"err {loss_err:.3g} (limit 1e-4; total {mc['loss']:.5f}); gradients of {len(gc)} "
          f"parameters, max err relative to the leaf's max |grad| by group: {g_line}; "
          f"parameters after the SGD step, max difference beyond two float32 ulps relative to "
          f"the leaf's largest update: {d_line}")
    if loss_err > 1e-4 or over:
        fail(f"the card's float32 train step disagrees with the CPU's: {over[:4]}")
    for name, fault in faults:
        with fault:
            _, gf, _, _ = step("cpu")
        f_line, f_over = error_summary(leaf_errors(gg, gf, gf, torch.zeros_like), group)
        counts = {k: sum(group(n)[0] == k for n in f_over) for k in ("DCN", "backbone", "rest")}
        print(f"control, {name}: the card's gradients vs that CPU step's, by group: {f_line}; "
              f"leaves over their limit: {counts}")
        if not f_over:
            fail(f"the planted fault ({name}) stays within every limit")


@contextlib.contextmanager
def dropped_corner(plain_name: str):
    """A planted fault for phase 18's control: while active, the plain
    version `plain_name` in `htd_tpu_torch.ops.dcn` (K5's or K6's) runs
    without each sample's last bilinear corner, as a kernel that skipped
    that corner would; the CPU step's DCN backward goes through it."""
    from htd_tpu_torch.ops import dcn

    plain, corners = getattr(dcn, plain_name), dcn._corners

    def faulty(*args):
        dcn._corners = lambda *a: corners(*a)[:3]
        try:
            return plain(*args)
        finally:
            dcn._corners = corners

    setattr(dcn, plain_name, faulty)
    try:
        yield
    finally:
        setattr(dcn, plain_name, plain)


def profile_step(state, batch, gen) -> None:
    """Device busy share, host and device time per `htd.*` forward span, and
    the largest device entries of one profiled train step."""
    from torch.profiler import ProfilerActivity, profile

    from htd_tpu_torch.train.train_step import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device ops only: the `htd.*` spans and the optimizer's own annotation
    # (`Optimizer.step#SGD.step`) are ranges over ops counted already
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith(("htd.", "Optimizer."))]
    dev_us = sum(e.self_device_time_total for e in on_device)
    print(f"profiled train step: wall {wall:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / wall:.1f}% of the wall time; profiling inflates the host side)")
    spans = {}
    for e in events:
        if e.key.startswith("htd."):
            host, dev = spans.get(e.key, (0.0, 0.0))
            spans[e.key] = (host + e.cpu_time_total, dev + e.device_time_total)
    for key, (host, dev) in spans.items():
        print(f"  forward span {key[4:]:<14s} host {host / 1e3:7.2f} ms, device range "
              f"{dev / 1e3:7.2f} ms")
    print(f"  forward spans together: host {sum(h for h, _ in spans.values()) / 1e3:.2f} ms; "
          f"the rest of the wall is the backward, the SGD step and the loss sum")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


def counted_steps(state, batch, gen, n_dcn: int, group=None) -> dict:
    """A training path's main path: TRAIN_STEPS train steps (over the
    process `group` when given) with the launch counts set to 0 just
    before and read just after; every step must give finite losses and
    launch each kernel as `step_launches(n_dcn)` says. Returns the counts
    over the steps."""
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, path_counts, reset_launch_counts
    from htd_tpu_torch.train.train_step import train_step

    torch.cuda.synchronize()
    reset_launch_counts()
    # bfloat16 autocast, one weight group: every K3, K5 and K6 launch on the tensor cores
    want_paths = {"deform_conv_tc": n_dcn, "deform_conv_cc": 0, "deform_conv_bwd_input_tc": n_dcn,
                  "deform_conv_bwd_input_cc": 0, "deform_conv_bwd_offset_weight_tc": n_dcn,
                  "deform_conv_bwd_offset_weight_cc": 0}
    for i in range(TRAIN_STEPS):
        start, start_paths = dict(launch_counts), dict(path_counts)
        metrics = train_step(state, batch, gen, group=group)
        torch.cuda.synchronize()
        counts = {k: launch_counts[k] - start[k] for k in launch_counts}
        paths = {k: path_counts[k] - start_paths[k] for k in path_counts}
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"non-finite losses at step {i}: {vals}")
        if counts != step_launches(n_dcn):
            fail(f"unexpected launches at step {i}: {counts}")
        if paths != want_paths:
            fail(f"unexpected K3 / K5 / K6 paths at step {i}: {paths}")
        print(f"step {i} (lr {state.optimizer.param_groups[0]['lr']:.5f}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()) + f"; launches {counts}")
    train_counts = dict(launch_counts)
    print(f"main path launches over {TRAIN_STEPS} train steps: {train_counts}; K3 / K5 / K6 "
          f"paths {dict(path_counts)}")
    return train_counts


def check_updates(before, after, watched) -> str:
    """Fails unless the stem and layer1 are bit-unchanged and every watched
    parameter changed; returns a line that says so."""
    from htd_tpu_torch.train.optim import frozen_prefixes

    frozen = tuple(frozen_prefixes())
    moved = [n for n in before if n.startswith(frozen) and not torch.equal(before[n], after[n])]
    if moved:
        fail(f"frozen parameters changed: {moved[:5]}")
    still = [n for n in watched if torch.equal(before[n], after[n])]
    if still:
        fail(f"trainable parameters did not change: {still}")
    return (f"{sum(n.startswith(frozen) for n in before)} stem and layer1 parameters "
            f"bit-unchanged; changed: {', '.join(watched)}")


def time_steps(state, batch, gen, label: str, card: str) -> None:
    """Median and p90 (host clock, synchronised) of TIMED_STEPS warm train
    steps, images/s and the peak device memory of the steps."""
    from htd_tpu_torch.train.train_step import train_step

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    med, p90 = statistics.median(times), times[int(0.9 * len(times)) - 1]
    print(f"{label} train step, batch 2 at 800x1344 bf16, {len(times)} warm steps: median "
          f"{med:.2f} ms, p90 {p90:.2f} ms, min {times[0]:.2f} ms; {2e3 / med:.2f} images/s "
          f"(peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) ({card})")


def train_phases(card):
    """Phases 12-15 (R-50 training); returns K4's kernel record."""
    from htd_tpu_torch import htd_r50_1x
    from htd_tpu_torch.ops.roi_align import roi_align_backward_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_roi_align_bwd
    from htd_tpu_torch.train.train_step import create_train_state

    phase("12 main path: HTD R-50 training, bfloat16, batch 2 in the 800x1344 bucket")
    cfg = htd_r50_1x(compute_dtype="bfloat16")
    state = create_train_state(cfg, seed=0)
    model = state.model
    batch = train_batch(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tc = cfg.train
    print(f"create_train_state(htd_r50_1x(compute_dtype='bfloat16'), seed=0): RPN "
          f"{tc.rpn_sampler.num} anchors per image, {tc.rcnn[0].sampler.num} rois per stage "
          f"per image, rcnn_pos_cap {tc.rcnn_pos_cap}, rpn_proposal "
          f"{tc.rpn_proposal.nms_pre}/{tc.rpn_proposal.nms_post}, max_gt {tc.max_gt}; gts per "
          f"image {[len(g) for g in TRAIN_GTS]}; "
          f"{sum(p.numel() for p in model.parameters() if p.requires_grad) / 1e6:.2f}M trainable "
          f"parameters (float32)")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_counts = counted_steps(state, batch, gen, 0)
    print(check_updates(before, dict(model.named_parameters()), (
        "backbone.layer2.0.bn1.weight", "backbone.layer2.0.bn3.weight",
        "backbone.layer4.0.conv2.weight", "neck.fpn_convs.0.conv.weight",
        "rpn_head.rpn_cls.weight", "roi_head.bbox_head.0.fc_cls.weight",
        "roi_head.bbox_head.1.convs.0.conv.weight", "roi_head.glbctx_head.fc.weight",
        "roi_head.bbox_roi_extractor.1.conv1.weight")))
    del before

    phase("13 K4 vs its plain version on a training step's own inputs")
    calls = record_roi_align_calls(state, batch, gen)
    k4_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst_abs = worst_rel = spread = 0.0
        for name, (geom, rois, lvls, g, args) in calls:
            gd = g.to(dtype)
            k1 = launch_roi_align_bwd(geom, rois, lvls, gd, *args)
            k2 = launch_roi_align_bwd(geom, rois, lvls, gd, *args)
            p = roi_align_backward_plain(geom, rois, lvls, gd, *args)
            e = (k1 - p).abs().max().item()
            rel = e / p.abs().max().item()
            sp = (k1 - k2).abs().max().item()
            worst_abs, worst_rel, spread = max(worst_abs, e), max(worst_rel, rel), max(spread, sp)
            print(f"  {str(dtype)[6:]} {name} S={args[-1]} ({tuple(g.shape[:-3])} rois): K4 vs "
                  f"plain max abs err {e:.3g}, relative to max |plain| {rel:.3g}; two K4 runs "
                  f"differ by at most {sp:.3g} (max |grad| {p.abs().max().item():.3g})")
            del k1, k2, p
        torch.cuda.synchronize()
        k4_err[dtype] = worst_abs
        print(f"{str(dtype)[6:]}: K4 max abs err {worst_abs:.3g}, relative {worst_rel:.3g} "
              f"(limit 1e-5: both add the same float32 products, K4 in an order that changes "
              f"from run to run); run-to-run spread {spread:.3g}")
        if worst_rel > 1e-5:
            fail(f"K4 disagrees with its plain version in {dtype}")

    phase("14 reference: float32 train step on the card vs the CPU")
    train_card_vs_cpu(htd_r50_1x)

    phase("15 training timings")
    time_steps(state, batch, gen, "R-50", card)
    k4 = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "device_ms": 0.0,
          "kernel_ms": 0.0, "zero_ms": 0.0, "cast_ms": 0.0, "zero_ev_ms": 0.0, "cast_ev_ms": 0.0,
          "outside_ms": 0.0}
    for name, (geom, rois, lvls, g, args) in calls:
        def call(rois=rois, lvls=lvls, g=g, args=args):
            return launch_roi_align_bwd(geom, rois, lvls, g, *args)

        ms = cuda_ms(call)
        plain = cuda_ms(lambda: roi_align_backward_plain(geom, rois, lvls, g, *args),
                        iters=3, warmup=1)
        dev = device_times(call, {"roi_align_bwd": 1}, iters=10)
        d = call()
        # the buffer's zeroing and `_RoIAlign.backward`'s cast, also by events:
        # each takes far longer than its dispatch
        zero_ev = cuda_ms(lambda: torch.zeros_like(d))
        cast = device_ms(lambda: d.to(g.dtype), iters=10)
        cast_ev = cuda_ms(lambda: d.to(g.dtype))
        del d
        # probe: every sample outside the image (g read, tables built, no atomics)
        outside = device_times(lambda: call(rois + OUTSIDE_PX), {"roi_align_bwd": 1},
                               iters=10)
        nbytes, ops, atomics, folded, distinct = k4_work(geom, rois, lvls, g, args[0], args[-1])
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        kern = dev["roi_align_bwd"]
        for key, v in (("ms", ms), ("plain_ms", plain), ("bytes_ms", b_ms), ("ops_ms", o_ms),
                       ("device_ms", dev["all"]), ("kernel_ms", kern),
                       ("zero_ms", dev["all"] - kern), ("cast_ms", cast),
                       ("zero_ev_ms", zero_ev), ("cast_ev_ms", cast_ev),
                       ("outside_ms", outside["roi_align_bwd"])):
            k4[key] += v
        print(f"K4 roi_align_bwd {name} S={args[-1]}: {ms * 1e3:.1f} us by events, device "
              f"{dev['all'] * 1e3:.1f} us = kernel {kern * 1e3:.1f} us + float32 buffer zeroing "
              f"{(dev['all'] - kern) * 1e3:.1f} us ({zero_ev * 1e3:.1f} us by events); then the "
              f"cast to {str(g.dtype)[6:]} {cast * 1e3:.1f} us ({cast_ev * 1e3:.1f} us by events); "
              f"every sample outside the image: kernel "
              f"{outside['roi_align_bwd'] * 1e3:.1f} us; plain {plain * 1e3:.1f} us; bound "
              f"{max(b_ms, o_ms) * 1e3:.1f} us ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP; "
              f"{distinct} distinct pixels); 16-byte atomics: {folded / 1e6:.2f}M folded "
              f"(distinct pixels per roi x C/4) against {atomics / 1e6:.2f}M unfolded (live "
              f"corners x C/4) ({card})")
    print(f"K4 per step (3 calls): {k4['ms']:.3f} ms by events, device {k4['device_ms']:.3f} ms "
          f"(kernels {k4['kernel_ms']:.3f} ms, zeroing {k4['zero_ms']:.3f} ms; the casts after it "
          f"{k4['cast_ms']:.3f} ms; by events zeroing {k4['zero_ev_ms']:.3f} ms, casts "
          f"{k4['cast_ev_ms']:.3f} ms; kernels with every sample outside the image "
          f"{k4['outside_ms']:.3f} ms); plain {k4['plain_ms']:.3f} ms; bound "
          f"{max(k4['bytes_ms'], k4['ops_ms']):.3f} ms "
          f"({100 * max(k4['bytes_ms'], k4['ops_ms']) / k4['device_ms']:.1f}% of it by device "
          f"time); no single PyTorch call computes it (library: none) ({card})")
    profile_step(state, batch, gen)
    return {"name": "roi_align_bwd", "route": "cuda",
            "source": "htd_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "htd_tpu/ops/roi_align_pallas.py:1986",
            "launches": train_counts["roi_align_bwd"], "max_abs_err": k4_err[torch.bfloat16],
            "ms": k4["ms"], "device_ms": k4["device_ms"], "plain_ms": k4["plain_ms"],
            "bound_ms": max(k4["bytes_ms"], k4["ops_ms"]),
            "bound_by": "bytes" if k4["bytes_ms"] >= k4["ops_ms"] else "operations",
            "library_ms": None}


def step_launches(dcn: int) -> dict:
    """Each kernel's launches in one train step with `dcn` deformable
    convs: K1 once, K2 and K4 three times, K3, K5 and K6 once per DCN, K7
    three times (the FPN's top-down adds; their backward is plain torch),
    K8 never (the fence switches are off)."""
    return {"pyramid_pack": 1, "roi_align": 3, "deform_conv": dcn, "roi_align_bwd": 3,
            "deform_conv_bwd_input": dcn, "deform_conv_bwd_offset_weight": dcn,
            "upsample_add": 3, "layout_fence": 0}


def open_residuals(model) -> None:
    """Each bottleneck's last BN scale from its zero init (mmdet's
    `zero_init_residual`) to RESIDUAL_SCALE: at zero the residual branches,
    the deformable convs among them, get no gradient in the first step."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bn3.weight"):
                p.fill_(RESIDUAL_SCALE)


def set_exact_offsets(model, seed: int = 0) -> None:
    """Offset convs whose output is the same on every device, bit for bit:
    zero weights and a seeded bias per (tap, axis) whose fractional part
    lies in [0.15, 0.85], so every sample sits at least 0.15 px from an
    integer. d_offsets jumps where a sample crosses an integer (the floor
    cell changes), and per-pixel offsets from cuDNN's and the CPU's offset
    conv differ in their last float32 bits, enough to move a few samples
    of a step into another cell on one device only."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, m in dcn_convs(model):
            b = m.conv_offset.bias
            whole = torch.randint(-2, 2, b.shape, generator=g).float()
            frac = torch.empty(b.shape).uniform_(0.15, 0.85, generator=g)
            m.conv_offset.weight.zero_()
            b.copy_(whole + frac)


def record_dcn_bwd_calls(state, batch, gen):
    """One train step with K5's and K6's launchers wrapped (each still
    launches its kernel once per call): per deformable conv, in forward
    order, (name, x, offsets, weight, g, stride, groups), cloned. The
    backward runs the convs in the reverse of their forward order."""
    from htd_tpu_torch.ops import dcn_cuda
    from htd_tpu_torch.train.train_step import train_step

    k5, k6 = [], []
    orig5 = dcn_cuda.launch_deform_conv_bwd_input
    orig6 = dcn_cuda.launch_deform_conv_bwd_offset_weight

    def rec5(x_shape, offsets, weight, g, *args):
        k5.append((weight.clone(), g.clone()))
        return orig5(x_shape, offsets, weight, g, *args)

    def rec6(x, offsets, g, d_col, w_shape, stride, dilation, dg, groups):
        k6.append((x.clone(), offsets.clone(), stride, groups))
        return orig6(x, offsets, g, d_col, w_shape, stride, dilation, dg, groups)

    dcn_cuda.launch_deform_conv_bwd_input = rec5
    dcn_cuda.launch_deform_conv_bwd_offset_weight = rec6
    try:
        train_step(state, batch, gen)
    finally:
        dcn_cuda.launch_deform_conv_bwd_input = orig5
        dcn_cuda.launch_deform_conv_bwd_offset_weight = orig6
    convs = dcn_convs(state.model)
    if len(k5) != len(convs) or len(k6) != len(convs):
        fail(f"expected one K5 and one K6 call per deformable conv, got {len(k5)}, {len(k6)}")
    calls = []
    for (name, m), (w, g), (x, off, stride, groups) in zip(convs, k5[::-1], k6[::-1]):
        if stride != m.stride or x.shape[-1] != m.weight.shape[1] * m.groups:
            fail(f"K5/K6 call for {name} does not fit its conv")
        calls.append((name, x, off, w, g, stride, groups))
    return calls


def x101_dcn_inputs(seed: int = 0):
    """Seeded inputs at X-101-64x4d-DCN's grouped shapes in the 800x1344
    bucket at batch 2, one conv per stage (64 groups; Cin/groups 8, 16,
    32): (name, x, offsets of about OFFSET_PX std, weight in K3's memory
    order, g, stride, groups), float32 on the card."""
    rng = np.random.RandomState(seed)
    out = []
    for name, h, w, c, stride in X101_CONVS:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        arrs = [rng.normal(0, 1, (2, h, w, c)), rng.normal(0, OFFSET_PX, (2, ho, wo, 18)),
                rng.normal(0, (9 * c / 64) ** -0.5, (c, 3, 3, c // 64)),
                rng.normal(0, 1, (2, ho, wo, c))]
        x, off, wt, g = (torch.from_numpy(a.astype(np.float32)).cuda() for a in arrs)
        out.append((name, x, off, wt.permute(1, 2, 3, 0), g, stride, 64))
    return out


def check_k5_k6(calls, names, label, deform_groups: int = 1,
                dtypes=(torch.bfloat16, torch.float32)):
    """K5 (d_x) and K6 (d_offsets, d_weight) against
    `deform_conv2d_backward_plain` on `calls` named in `names`, in each of
    `dtypes`, each kernel run twice. Limit: 1e-5 of max |plain| (float32
    sums in another order, K5's and K6's atomics in a run-dependent one;
    K5's bfloat16 d_col products on the tensor cores), 1e-4 for bfloat16
    K6 (the limit of K3 and K5 on `mma.sync`: the same bfloat16-rounded
    samples, float32 sums over up to 33600 pixels in tiles and ranges),
    plus one bfloat16 ulp of max |plain| where the output is rounded to
    bfloat16. Returns the first dtype's max abs errors of K5 and K6."""
    from htd_tpu_torch.ops.dcn import deform_conv2d_backward_plain
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)
    from htd_tpu_torch.ops.roi_align_cuda import path_counts, reset_launch_counts

    errs = {}
    dg = deform_groups
    for dtype in dtypes:
        worst = {"d_x": [0.0, 0.0], "d_off": [0.0, 0.0], "d_w": [0.0, 0.0]}
        spread = 0.0
        reset_launch_counts()
        for name, x, off, w, g, stride, groups in calls:
            if name not in names:
                continue
            x, off, w, g = (t.to(dtype) for t in (x, off, w, g))
            ref = deform_conv2d_backward_plain(x, off, w, g, stride, 1, dg, groups)
            runs = []
            for _ in range(2):
                d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, w, g, stride, 1, dg,
                                                          groups)
                d_off, d_w = launch_deform_conv_bwd_offset_weight(x, off, g, d_col, w.shape,
                                                                  stride, 1, dg, groups)
                runs.append((d_x, d_off, d_w.to(dtype)))
                del d_col
            line = []
            for i, key in enumerate(("d_x", "d_off", "d_w")):
                p = ref[i].float()
                scale = p.abs().max().item()
                ulp = 0.0 if dtype == torch.float32 else bf16_ulp(scale)
                rel = 1e-4 if dtype == torch.bfloat16 and key != "d_x" else 1e-5
                e = max((r[i].float() - p).abs().max().item() for r in runs)
                spread = max(spread, (runs[0][i].float() - runs[1][i].float()).abs().max().item()
                             / scale)
                if e > rel * scale + ulp:
                    fail(f"{label} {name} {key} in {dtype}: max abs err {e:.3g}, limit "
                         f"{rel * scale + ulp:.3g} (max |plain| {scale:.3g})")
                worst[key] = [max(worst[key][0], e), max(worst[key][1], e / scale)]
                line.append(f"{key} {e:.3g} ({e / scale:.2g} of max |plain| {scale:.3g})")
            print(f"  {str(dtype)[6:]} {label} {name} (stride {stride}, {x.shape[-1]} ch, groups "
                  f"{groups}, deform groups {dg}): " + "; ".join(line))
            del runs, ref
        torch.cuda.synchronize()
        errs[dtype] = (worst["d_x"][0], max(worst["d_off"][0], worst["d_w"][0]))
        limits = "1e-5" if dtype == torch.float32 else \
            "K5 1e-5, K6 1e-4, each + one bfloat16 ulp"
        k6_paths = {k: v for k, v in path_counts.items() if k.startswith("deform_conv_bwd_off")}
        print(f"{str(dtype)[6:]} {label}, deform groups {dg}: K5 d_x max err "
              f"{worst['d_x'][1]:.3g}, K6 d_off "
              f"{worst['d_off'][1]:.3g}, d_w {worst['d_w'][1]:.3g} of max |plain| (limit "
              f"{limits}); two runs differ by at most {spread:.3g} of max |plain|; K6 paths "
              f"{k6_paths}")
    return errs[dtypes[0]]


def dcn_bwd_work(x, off, w_shape, g, stride, groups):
    """(K5 bytes, K5 tensor-core ops, K5 float32 ops, K6 bytes, K6
    tensor-core ops, K6 float32 ops, corners) of one deformable conv's
    backward on this data, counted for the functions of the TPU kernels
    that K5 and K6 replace. K5: g, W and the offsets read, d_x written;
    d_col = g . W^T is 2 N Ho Wo 9 Cin/groups Cout operations, and the
    scatter 2 per channel of each non-zero-weight corner. K6: x, the
    offsets, g and W read, d_off and the float32 d_w written; d_col (which
    its function forms from g and W) and d_w = samples^T . g are 2 N Ho Wo
    9 Cin/groups Cout each, the samples 2 per channel of each non-zero
    corner, d_off 4 per channel of each corner with a non-zero derivative
    and 4 per (pixel, tap, channel) for the products with d_col. The
    float32 d_col that K5 writes and K6 reads back is the kernels' own
    intermediate, which neither function needs, so it is not counted."""
    from htd_tpu_torch.ops.dcn import _corners, _sample_positions

    n, h, w, cin = x.shape
    ho, wo, cout = g.shape[1], g.shape[2], g.shape[3]
    es = x.element_size()
    ys, xs = _sample_positions(n, ho, wo, 3, 3, stride, 1, off, 1)
    live_w = live_d = 0
    for _, wgt, dwy, dwx in _corners(h, w, ys, xs):
        live_w += int((wgt != 0).sum())
        live_d += int(((dwy != 0) | (dwx != 0)).sum())
    gemm = 2 * n * ho * wo * 9 * (cin // groups) * cout
    col = n * ho * wo * 9 * cin
    w_elems = 9 * (cin // groups) * cout
    k5_bytes = (g.numel() + w_elems + off.numel() + x.numel()) * es
    k6_bytes = (x.numel() + off.numel() + g.numel() + w_elems + off.numel()) * es + w_elems * 4
    return (k5_bytes, gemm, 2 * live_w * cin, k6_bytes, 2 * gemm,
            2 * live_w * cin + 4 * live_d * cin + 4 * col, live_w)


def dcn_train_phases(card, imgs):
    """Phases 16-19 (R-101-DCN training); returns the kernel records of K5
    and K6."""
    from htd_tpu_torch import htd_r101_dcn_2x
    from htd_tpu_torch.ops.dcn import (deform_conv2d_backward_input_plain,
                                       deform_conv2d_backward_offset_weight_plain)
    from htd_tpu_torch.ops._build import load
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)
    from htd_tpu_torch.ops.roi_align_cuda import _DTYPE_CODE
    from htd_tpu_torch.train.train_step import create_train_state

    phase("16 main path: HTD R-101-DCN training, bfloat16, batch 2 in the 800x1344 bucket")
    cfg = htd_r101_dcn_2x(compute_dtype="bfloat16")
    state = create_train_state(cfg, seed=0)
    model = state.model
    open_residuals(model)
    with torch.autocast(model.device.type, dtype=torch.bfloat16):
        stds = offset_stds(model, imgs[0])
    with torch.no_grad():
        set_offsets(model, stds, seed=0)
    batch = train_batch(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_dcn = len(dcn_convs(model))
    print(f"create_train_state(htd_r101_dcn_2x(compute_dtype='bfloat16'), seed=0); bn3 scales "
          f"{RESIDUAL_SCALE} (from zero); {n_dcn} deformable convs, conv_offset weights seeded "
          f"normal with std {min(stds):.2e}-{max(stds):.2e} (zero bias) for offsets of about "
          f"{OFFSET_PX} px std; "
          f"{sum(p.numel() for p in model.parameters() if p.requires_grad) / 1e6:.2f}M trainable "
          f"parameters (float32); the batch and sampler settings of phase 12")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = OffsetStats(model)
    train_counts = counted_steps(state, batch, gen, n_dcn)
    st = stats.report(n_dcn * TRAIN_STEPS * len(TRAIN_GTS))
    if st["far"] < 0.05 or st["outside"] <= 0.0:
        fail("the seeded offsets do not move samples off their taps and out of the image")
    after = dict(model.named_parameters())
    dcn_leaves = [f"backbone.{name}.conv2.{leaf}" for name, _ in dcn_convs(model)
                  for leaf in ("weight", "conv_offset.weight", "conv_offset.bias")]
    no_grad = [n for n in dcn_leaves if after[n].grad is None
               or not (torch.isfinite(after[n].grad).all() and after[n].grad.abs().max() > 0)]
    if no_grad:
        fail(f"DCN leaves without a finite non-zero gradient in the last step: {no_grad[:4]}")
    print(f"all {len(dcn_leaves)} DCN leaves (weight, conv_offset weight and bias) have a "
          f"finite non-zero gradient in the last step; " + check_updates(
              before, after, DCN_WATCHED + ("neck.fpn_convs.0.conv.weight",
                                            "rpn_head.rpn_cls.weight",
                                            "roi_head.bbox_head.1.fc_cls.weight")))
    del before

    phase("17 K5 and K6 vs their plain version on a training step's own inputs")
    calls = record_dcn_bwd_calls(state, batch, gen)
    print(f"captured the {len(calls)} deformable convs' backward inputs of one step; checked: "
          f"{', '.join(DCN_CHECKED)} (stride 2 and 1 of each stage)")
    k5_err, k6_err = check_k5_k6(calls, DCN_CHECKED, "R-101-DCN")
    # two deform groups: the step's offsets for the first, their negation
    # for the second
    check_k5_k6([(name, x, torch.cat([off, -off], -1).contiguous(), w, g, stride, groups)
                 for name, x, off, w, g, stride, groups in calls], DCN_CHECKED, "R-101-DCN",
                deform_groups=2, dtypes=(torch.bfloat16,))
    xcalls = x101_dcn_inputs()
    check_k5_k6(xcalls, [c[0] for c in xcalls], "X-101-64x4d-DCN")
    del xcalls

    phase("18 reference: float32 R-101-DCN train step on the card vs the CPU")

    def prepare(m):
        open_residuals(m)
        set_exact_offsets(m)

    # With the residual branches open, float32 gradients through R-101's 33
    # active blocks flip ReLUs whose pre-activation sits at rounding level
    # on one device only, and at 192x288 a layer4 channel sums only 108
    # pixels, so a single flip shows in a leaf's relative error. The
    # backbone's limits sit between the sound run's errors and those of the
    # planted faults below, both measured in this phase (PERF.md).
    train_card_vs_cpu(htd_r101_dcn_2x, prepare, backbone_limit=1e-2, dcn_limit=1e-2, faults=(
        ("K5's plain version drops each sample's last corner from d_x",
         dropped_corner("deform_conv2d_backward_input_plain")),
        ("K6's plain version drops each sample's last corner from d_off and d_w",
         dropped_corner("deform_conv2d_backward_offset_weight_plain"))))

    phase("19 R-101-DCN training timings")
    time_steps(state, batch, gen, "R-101-DCN", card)
    tot = {k: 0.0 for k in ("k5", "k6", "k5_plain", "k6_plain", "cudnn", "k5_b", "k5_o", "k6_b",
                            "k6_o")}
    per_stage = {}
    for name, x, off, w, g, stride, groups in calls:
        d_col = launch_deform_conv_bwd_input(x.shape, off, w, g, stride, 1, 1, groups)[1]
        k5 = cuda_ms(lambda: launch_deform_conv_bwd_input(x.shape, off, w, g, stride, 1, 1, groups))
        k6 = cuda_ms(lambda: launch_deform_conv_bwd_offset_weight(x, off, g, d_col, w.shape,
                                                                  stride, 1, 1, groups))
        k5_plain = cuda_ms(lambda: deform_conv2d_backward_input_plain(
            x.shape, off, w, g, stride, 1, 1, groups), iters=1, warmup=1)
        k6_plain = cuda_ms(lambda: deform_conv2d_backward_offset_weight_plain(
            x, off, g, d_col, w.shape, stride, 1, 1, groups), iters=1, warmup=1)
        x_nchw, w_oihw, g_nchw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)
        cudnn = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            g_nchw, x_nchw, w_oihw, None, [stride, stride], [1, 1], [1, 1], False, [0, 0], groups,
            [True, True, False]))
        k5_b, k5_g, k5_f, k6_b, k6_g, k6_f, corners = dcn_bwd_work(x, off, w.shape, g, stride,
                                                                   groups)
        k5_o = k5_g / BF16_FLOP_PER_S * 1e3 + k5_f / FP32_FLOP_PER_S * 1e3
        k6_o = k6_g / BF16_FLOP_PER_S * 1e3 + k6_f / FP32_FLOP_PER_S * 1e3
        for key, v in (("k5", k5), ("k6", k6), ("k5_plain", k5_plain), ("k6_plain", k6_plain),
                       ("cudnn", cudnn), ("k5_b", k5_b / HBM_BYTES_PER_S * 1e3), ("k5_o", k5_o),
                       ("k6_b", k6_b / HBM_BYTES_PER_S * 1e3), ("k6_o", k6_o)):
            tot[key] += v
        # per stage: launches, K5 and K6 ms by events, the calls, d_w's
        # operations, the bytes of K5's float32 d_col that K6's d_off reads
        stage = per_stage.setdefault(name.split(".")[0], [0, 0.0, 0.0, [], 0, 0])
        for i, v in ((0, 1), (1, k5), (2, k6), (4, k5_g), (5, d_col.numel() * 4)):
            stage[i] += v
        stage[3].append((x, off, w, g, stride, groups))
        if name in ("layer2.0", "layer2.1", "layer3.1", "layer4.1"):
            partials = load()[0].htd_deform_conv_bwd_dw_partials(
                g.shape[0], g.shape[1], g.shape[2], x.shape[-1], g.shape[-1], groups,
                _DTYPE_CODE[x.dtype])
            vec = 2 if x.dtype == torch.bfloat16 and groups == 1 else 4  # tensor cores: float2
            print(f"{name} (stride {stride}, {x.shape[-1]} ch, {x.shape[1]}x{x.shape[2]} -> "
                  f"{g.shape[1]}x{g.shape[2]}): K5 {k5 * 1e3:.1f} us (bound "
                  f"{max(k5_b / HBM_BYTES_PER_S * 1e3, k5_o) * 1e3:.1f}: {k5_b / 1e6:.1f} MB, "
                  f"{k5_g / 1e9:.2f} GFLOP d_col, {corners / 1e6:.2f}M live corners -> "
                  f"{corners * x.shape[-1] / 4 / 1e6:.1f}M 16-byte atomics); K6 {k6 * 1e3:.1f} us "
                  f"(bound {max(k6_b / HBM_BYTES_PER_S * 1e3, k6_o) * 1e3:.1f}: {k6_b / 1e6:.1f} "
                  f"MB, {k6_g / 1e9:.2f} GFLOP d_col and d_w, d_w in {partials} partials, "
                  f"{partials * w.numel() / vec / 1e6:.2f}M {4 * vec}-byte atomics); cuDNN conv "
                  f"backward (d_x, d_w) {cudnn * 1e3:.1f} us; plain K5 {k5_plain:.2f} ms, K6 "
                  f"{k6_plain:.2f} ms")
        del d_col
    print("per stage (launches, K5 ms, K6 ms, by events): " + "; ".join(
        f"{st} {v[0]} {v[1]:.3f} {v[2]:.3f}" for st, v in per_stage.items()))

    def stage_backward(args):
        for x, off, w, g, stride, groups in args:
            d_col = launch_deform_conv_bwd_input(x.shape, off, w, g, stride, 1, 1, groups)[1]
            launch_deform_conv_bwd_offset_weight(x, off, g, d_col, w.shape, stride, 1, 1, groups)

    # device time by stage: one profile over each stage's K5 and K6 calls;
    # K6's d_w against its product at the bf16 tensor-core rate, its d_off
    # against reading K5's float32 d_col once
    keys = ("deform_conv_bwd_input", "deform_conv_bwd_offset", "deform_conv_bwd_weight")
    dev = {k: 0.0 for k in keys + ("all", "gemm", "dcol_bytes")}
    for st, (n, _, _, args, gemm, dcol_bytes) in per_stage.items():
        t = device_times(lambda: stage_backward(args), dict.fromkeys(keys, len(args)),
                         iters=3)
        t["gemm"], t["dcol_bytes"] = gemm, dcol_bytes
        for k in dev:
            dev[k] += t[k]
        print(f"  {st} ({n} convs) device: K5 kernel {t[keys[0]]:.3f} ms; K6 d_off "
              f"{t[keys[1]]:.3f} ms (reading K5's float32 d_col, {dcol_bytes / 1e6:.0f} MB, takes "
              f"{dcol_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s), d_w {t[keys[2]]:.3f} ms "
              f"({gemm / 1e9:.1f} GFLOP, {gemm / t[keys[2]] / 1e9:.1f} TFLOP/s; the product at "
              f"989 TFLOP/s bf16 {gemm / BF16_FLOP_PER_S * 1e3:.3f} ms); the calls' other device "
              f"work (zeroing d_x and d_w, the d_x cast) "
              f"{t['all'] - sum(t[k] for k in keys):.3f} ms ({card})")
    # what bounds K5 and K6: their launches with every sample outside the
    # image (no corner loads or atomics: K5's product and d_col write, K6's
    # d_w product, g tiles and atomics) and with zero offsets (integer
    # positions: one corner of weight 1), beside the step's own offsets
    probe = {(label, k): 0.0 for label in ("far", "zero") for k in keys}
    for st, (n, _, _, args, _, _) in per_stage.items():
        for label, fill in (("far", 1e4), ("zero", 0.0)):
            moved = [(x, torch.full_like(off, fill), w, g, stride, groups)
                     for x, off, w, g, stride, groups in args]
            t = device_times(lambda: stage_backward(moved), dict.fromkeys(keys, len(moved)),
                             iters=3)
            for k in keys:
                probe[label, k] += t[k]
            del moved
    print(f"K5 per step by device time: {dev[keys[0]]:.3f} ms with the step's offsets (up to four "
          f"corner atomics per sample); {probe['zero', keys[0]]:.3f} ms with zero offsets (one); "
          f"{probe['far', keys[0]]:.3f} ms with every sample outside the image (none: the d_col "
          f"product and its float32 write)")
    print(f"K6 d_w per step by device time: {dev[keys[2]]:.3f} ms with the step's offsets (up to "
          f"four corner loads per sample); {probe['zero', keys[2]]:.3f} ms with zero offsets (one); "
          f"{probe['far', keys[2]]:.3f} ms with every sample outside the image (none: the "
          f"product, the g tiles and the atomics); d_off {dev[keys[1]]:.3f} / "
          f"{probe['zero', keys[1]]:.3f} / {probe['far', keys[1]]:.3f} ms")
    k6_dev = dev[keys[1]] + dev[keys[2]]
    k5_bound, k6_bound = max(tot["k5_b"], tot["k5_o"]), max(tot["k6_b"], tot["k6_o"])
    print(f"K5 per step ({len(calls)} launches, bf16, tensor-core path): device "
          f"{dev[keys[0]]:.3f} ms ({100 * k5_bound / dev[keys[0]]:.1f}% of its bound), by events "
          f"{tot['k5']:.3f} ms (d_x zeroing and cast and the host's dispatch included); bound "
          f"{k5_bound:.4f} ms (bytes at 3.35 TB/s {tot['k5_b']:.4f} ms, operations "
          f"{tot['k5_o']:.4f} ms: d_col at 989 TFLOP/s bf16, the scatter at 67 TFLOP/s float32)")
    print(f"K6 per step ({len(calls)} launches, bf16, d_w on the tensor cores): device "
          f"{k6_dev:.3f} ms ({100 * max(tot['k6_b'], tot['k6_o']) / k6_dev:.1f}% of its bound): "
          f"d_off {dev[keys[1]]:.3f} ms (K5's float32 d_col read once "
          f"{dev['dcol_bytes'] / HBM_BYTES_PER_S * 1e3:.3f} ms), d_w {dev[keys[2]]:.3f} ms "
          f"({dev['gemm'] / 1e9:.1f} GFLOP, {dev['gemm'] / dev[keys[2]] / 1e9:.1f} TFLOP/s; the "
          f"product at 989 TFLOP/s bf16 {dev['gemm'] / BF16_FLOP_PER_S * 1e3:.3f} ms) ({card})")
    print(f"K6 per step ({len(calls)} launches): {tot['k6']:.3f} ms; bound {k6_bound:.4f} ms "
          f"(bytes {tot['k6_b']:.4f} ms, operations {tot['k6_o']:.4f} ms: d_col and d_w at 989 "
          f"TFLOP/s bf16, sampling and d_off at 67 TFLOP/s float32); neither bound counts the "
          f"float32 d_col that K5 writes and K6 reads back")
    print(f"plain versions per step: K5's {tot['k5_plain']:.3f} ms, K6's {tot['k6_plain']:.3f} "
          f"ms; no single PyTorch call computes either (library: none); context: cuDNN's "
          f"regular-conv backward (d_x, d_w) of the same shapes {tot['cudnn']:.3f} ms per step, "
          f"not the same function ({card})")
    profile_step(state, batch, gen)
    return [
        {"name": "deform_conv_bwd_input", "route": "cuda",
         "source": "htd_tpu_torch/csrc/deform_conv_bwd_input.cu",
         "replaces": "htd_tpu/ops/dcn_pallas.py:313",
         "launches": train_counts["deform_conv_bwd_input"], "path": "tensor cores (mma.sync bf16)",
         "max_abs_err": k5_err, "ms": tot["k5"], "device_ms": dev[keys[0]],
         "plain_ms": tot["k5_plain"], "bound_ms": k5_bound,
         "bound_by": "bytes" if tot["k5_b"] >= tot["k5_o"] else "operations",
         "library_ms": None},
        {"name": "deform_conv_bwd_offset_weight", "route": "cuda",
         "source": "htd_tpu_torch/csrc/deform_conv_bwd_offset_weight.cu",
         "replaces": "htd_tpu/ops/dcn_pallas.py:478",
         "launches": train_counts["deform_conv_bwd_offset_weight"],
         "path": "d_w on the tensor cores (mma.sync bf16), d_off on the CUDA cores",
         "max_abs_err": k6_err, "ms": tot["k6"], "device_ms": k6_dev, "d_off_device_ms": dev[keys[1]],
         "d_w_device_ms": dev[keys[2]], "plain_ms": tot["k6_plain"], "bound_ms": k6_bound,
         "bound_by": "bytes" if tot["k6_b"] >= tot["k6_o"] else "operations",
         "library_ms": None},
    ]


@contextlib.contextmanager
def recording(module, name: str, keep):
    """While active, `module.name` (a kernel launcher) is wrapped: each call
    first hands its arguments to `keep`, then launches as before."""
    orig = getattr(module, name)

    def rec(*args):
        keep(*args)
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_laterals(model, img):
    """The three (low, lat) pairs that K7 gets on one request, cloned."""
    from htd_tpu_torch import inference_detector
    from htd_tpu_torch.ops import elementwise_cuda

    pairs = []
    with recording(elementwise_cuda, "launch_upsample_add",
                   lambda low, lat: pairs.append((low.clone(), lat.clone()))):
        inference_detector(model, img)
    if len(pairs) != 3:
        fail(f"expected 3 K7 calls per request, got {len(pairs)}")
    return pairs


def k7_phase(pairs, card):
    """Phase 20; returns the max abs errors of K7 and K8 (bfloat16) and
    K7's times per image."""
    import torch.nn.functional as F

    from htd_tpu_torch.ops.fence import layout_fence, layout_fence_plain
    from htd_tpu_torch.ops.upsample import pool2x2_sum, upsample2x_add, upsample2x_add_plain

    phase("20 K7 and K8 vs their plain versions on the main path's own laterals")
    print("top-down pairs of phase 3's first request (low -> lat, NHWC): "
          + ", ".join(f"{tuple(lo.shape[1:3])} -> {tuple(la.shape[1:3])}" for lo, la in pairs)
          + f", {pairs[0][0].shape[-1]} channels, {pairs[0][0].dtype}")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for low, lat in pairs:
            low, lat = low.to(dtype), lat.to(dtype)
            k, p = upsample2x_add(low, lat), upsample2x_add_plain(low, lat)
            if not k.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last):
                fail("K7's output is not channels_last as NCHW")
            f = layout_fence(lat)
            if not (torch.equal(k, p) and torch.equal(f, layout_fence_plain(lat))
                    and f.stride() == lat.stride()):
                fail(f"K7 or K8 differs from its plain version in {dtype}")
            worst = max(worst, (k.float() - p.float()).abs().max().item())
            # the autograd function: d_lat = g, d_low = 2x2 sum-pool of g
            a, b = low.clone().requires_grad_(True), lat.clone().requires_grad_(True)
            with torch.enable_grad():
                out = upsample2x_add(a, b)
                if type(out.grad_fn).__name__ != "_Upsample2xAddBackward":
                    fail(f"K7's output has grad_fn {out.grad_fn}")
                g = torch.randn_like(out)
                out.backward(g)
            if not (torch.equal(b.grad, g) and torch.equal(a.grad, pool2x2_sum(g))):
                fail(f"K7's gradients differ from the plain backward in {dtype}")
        torch.cuda.synchronize()
        errs[dtype] = worst
        print(f"{str(dtype)[6:]}: K7 and K8 bit-equal to their plain versions on the 3 pairs "
              f"(K7 max abs err {worst:.3g}); K7's output channels_last as NCHW; grad_fn "
              f"_Upsample2xAddBackward with d_lat = g and d_low = the 2x2 sum-pool of g")
    # device time (profiler) and time per call (events, host dispatch included)
    t = {"ms": 0.0, "plain_ms": 0.0, "two_call_ms": 0.0, "call_ms": 0.0, "bytes": 0}
    for low, lat in pairs:
        low_nchw, lat_nchw = low.permute(0, 3, 1, 2), lat.permute(0, 3, 1, 2)
        fns = {"ms": lambda: upsample2x_add(low, lat),
               "plain_ms": lambda: upsample2x_add_plain(low, lat),
               "two_call_ms": lambda: lat_nchw + F.interpolate(low_nchw, scale_factor=2,
                                                               mode="nearest")}
        got = {k: device_ms(fn, iters=50, cold=True) for k, fn in fns.items()}
        got["call_ms"] = cuda_ms(fns["ms"], iters=50)
        got["bytes"] = (low.numel() + 2 * lat.numel()) * lat.element_size()
        for key, v in got.items():
            t[key] += v
        print(f"K7 {tuple(low.shape[1:3])} -> {tuple(lat.shape[1:3])}: device {got['ms'] * 1e3:.1f} "
              f"us, L2 flushed (per call with host dispatch {got['call_ms'] * 1e3:.1f} us); plain "
              f"{got['plain_ms'] * 1e3:.1f} us; lat + F.interpolate {got['two_call_ms'] * 1e3:.1f} "
              f"us; bound {got['bytes'] / HBM_BYTES_PER_S * 1e6:.1f} us "
              f"({got['bytes'] / 1e6:.2f} MB)")
    t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"K7 per image (3 launches): device {t['ms'] * 1e3:.1f} us, "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound {t['bound_ms'] * 1e3:.1f} us "
          f"({t['bytes'] / 1e6:.2f} MB: low and lat read, out written, at 3.35 TB/s); per call "
          f"with host dispatch {t['call_ms'] * 1e3:.1f} us; plain (device) "
          f"{t['plain_ms'] * 1e3:.1f} us; context: lat + F.interpolate(low, scale_factor=2, "
          f"mode='nearest'), two PyTorch calls, device {t['two_call_ms'] * 1e3:.1f} us ({card})")
    return errs[torch.bfloat16], t


def fence_phase(model, img, cfg, card):
    """Phase 21; returns K8's launches on the fenced request and its
    timings."""
    import os

    from htd_tpu_torch import inference_detector
    from htd_tpu_torch.ops import elementwise_cuda
    from htd_tpu_torch.ops.fence import layout_fence, layout_fence_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    phase("21 main path: R-101-DCN bfloat16 request with the three layout fences on")
    switches = ("HTD_FPN_FENCE", "HTD_RPN_FENCE", "HTD_DCN_FENCE")
    base = inference_detector(model, img)
    fenced = []
    saved = {k: os.environ.get(k) for k in switches}
    try:
        os.environ.update({k: "1" for k in switches})
        torch.cuda.synchronize()
        reset_launch_counts()
        with recording(elementwise_cuda, "launch_layout_fence", fenced.append):
            dets = inference_detector(model, img)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n_dcn = len(dcn_convs(model))
    want = 3 + len(cfg.rpn.anchor.strides) + n_dcn
    print(f"{', '.join(switches)} = 1 for one request {img.shape[1]}x{img.shape[0]}, then "
          f"restored: launches {counts}; K8 {counts['layout_fence']} (expected 3 FPN sums + "
          f"{len(cfg.rpn.anchor.strides)} RPN levels + {n_dcn} deformable-conv inputs = {want})")
    if counts["layout_fence"] != want or counts["upsample_add"] != 3 \
            or counts["deform_conv"] != n_dcn:
        fail(f"unexpected launches on the fenced request: {counts}")
    same = all(np.array_equal(a, b) for a, b in zip(base, dets))
    print(f"detections of the fenced request bit-identical to the unfenced one: {same} "
          f"({len(dets[1])} detections)")
    if not same or len(dets[1]) == 0:
        fail("the fenced request's detections differ from the unfenced request's")
    # the deformable convs' inputs are fenced first, in the backbone
    largest = max(fenced, key=lambda f: f.numel())
    dcn_input = max(fenced[:n_dcn], key=lambda f: f.numel())
    for label, x in (("the largest fenced tensor", largest),
                     ("the largest deformable-conv input", dcn_input)):
        t, traced = interleaved_ms({"K8": (lambda: layout_fence(x), "layout_fence"),
                                    "clone": (lambda: x.clone(), "")})
        plain = device_ms(lambda: layout_fence_plain(x), iters=50, cold=True)
        call = cuda_ms(lambda: layout_fence(x), iters=50)
        nbytes = 2 * x.numel() * x.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"K8 on {label} {tuple(x.shape)} {x.dtype} strides {x.stride()}: K8 and clone() "
              f"in turns, {INTERLEAVED} calls each ({traced} traced), L2 flushed, median device "
              f"time: K8 {t['K8'] * 1e3:.2f} us ({100 * bound / t['K8']:.1f}% of its bound "
              f"{bound * 1e3:.1f} us, {nbytes / 1e6:.2f} MB read and written at 3.35 TB/s), "
              f"clone() {t['clone'] * 1e3:.2f} us; K8 / clone() {t['K8'] / t['clone']:.3f}; plain "
              f"(empty_like + copy_, timed apart) {plain * 1e3:.2f} us; per K8 call with host "
              f"dispatch {call * 1e3:.1f} us ({card})")
        if x is largest:
            k8 = {"ms": t["K8"], "plain_ms": plain, "bound_ms": bound, "library_ms": t["clone"]}
    return counts["layout_fence"], k8


def match_detections(ref, got, box_tol: float = 1e-2, score_tol: float = 1e-3):
    """Rows of `got` (boxes, scores, labels) without a counterpart in `ref`
    of the same label, boxes within `box_tol` px and score within
    `score_tol`, each counterpart used once; and the largest box and score
    differences of the matched rows."""
    used = np.zeros(len(ref[1]), bool)
    unmatched, box_err, score_err = 0, 0.0, 0.0
    for b, s, lab in zip(*got):
        d = np.abs(ref[0] - b).max(axis=1) + 1e9 * (used | (ref[2] != lab))
        j = int(np.argmin(d)) if len(d) else -1
        if j >= 0 and d[j] <= box_tol and abs(ref[1][j] - s) <= score_tol:
            used[j] = True
            box_err, score_err = max(box_err, float(d[j])), max(score_err, abs(ref[1][j] - s))
        else:
            unmatched += 1
    return unmatched, box_err, score_err


def tta_phase(model, stds, imgs, card):
    """Phase 22."""
    from htd_tpu_torch import (aug_inference_detector, htd_r101_dcn_2x, inference_detector,
                               init_detector)
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    phase("22 main path: aug_inference_detector, R-101-DCN bfloat16, 2 scales x flip")
    cfg = model.cfg
    img = imgs[0]
    torch.cuda.synchronize()
    reset_launch_counts()
    boxes, scores, labels = aug_inference_detector(model, img, scales=TTA_SCALES, flip=True)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    n_augs = 2 * len(TTA_SCALES)
    check_detections(boxes, scores, labels, img, cfg)
    want = {"upsample_add": 6 * n_augs, "deform_conv": 2 * len(dcn_convs(model)) * n_augs,
            "pyramid_pack": n_augs, "roi_align": 3 * n_augs}
    print(f"scales {TTA_SCALES} x [no flip, flip] = {n_augs} augs on {img.shape[1]}x"
          f"{img.shape[0]}: {len(scores)} detections (max_per_img {cfg.rcnn_test.max_per_img}), "
          f"top scores {np.round(scores[:3], 4).tolist()}, labels {labels[:3].tolist()}; "
          f"launches {counts}")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"expected launches {want} (K7 6 per aug: the proposal and cascade passes)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m32 = init_detector(htd_r101_dcn_2x(), seed=0)
    scale_scores(m32)
    set_offsets(m32, stds, seed=0)
    ref = inference_detector(m32, img)
    one = aug_inference_detector(m32, img, scales=(m32.cfg.test_scale,), flip=False)
    unmatched, box_err, score_err = match_detections(ref, one)
    print(f"float32, one aug at the test scale without flip vs inference_detector: {len(one[1])} "
          f"vs {len(ref[1])} detections, {unmatched} without a counterpart; matched rows max box "
          f"err {box_err:.3g} px (limit 1e-2), max score err {score_err:.3g} (limit 1e-3)")
    if unmatched or len(one[1]) != len(ref[1]) or len(ref[1]) == 0:
        fail("the identity aug disagrees with inference_detector")
    del m32

    lat = []
    for i in range(TTA_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug_inference_detector(model, imgs[i % len(imgs)], scales=TTA_SCALES, flip=True)
        torch.cuda.synchronize()
        if i:
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"warm TTA latency per image ({n_augs} augs, preprocessing included), {len(lat)} "
          f"requests: median {statistics.median(lat):.2f} ms, min {min(lat):.2f} ms ({card})")


class SeededCoco:
    """A mini-COCO of MINI_COCO_IMAGES seeded images: the annotation file in
    a temporary directory, the pixels drawn from the seed by `load_image`
    (the card's machine has no OpenCV)."""

    def __init__(self, root: str, seed: int = 0):
        from htd_tpu_torch.data.coco import CocoDataset

        rng = np.random.RandomState(seed)
        images, anns = [], []
        for i in range(MINI_COCO_IMAGES):
            long_side, short_side = int(rng.randint(640, 1281)), int(rng.randint(480, 641))
            h, w = (short_side, long_side) if i % 2 == 0 else (long_side, short_side)
            images.append(dict(id=i + 1, file_name=f"{i}.jpg", height=h, width=w))
            for _ in range(rng.randint(2, 7)):
                bw, bh = rng.uniform(24, w / 2), rng.uniform(24, h / 2)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                                 category_id=int(rng.choice([1, 2, 3])),
                                 bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
        path = f"{root}/ann.json"
        with open(path, "w") as f:
            json.dump(dict(images=images, annotations=anns, categories=[
                dict(id=k, name=f"c{k}") for k in (1, 2, 3)]), f)
        seed_of = {im["id"]: seed * 1000 + im["id"] for im in images}

        class Dataset(CocoDataset):
            def load_image(self, rec):
                r = np.random.RandomState(seed_of[rec.img_id])
                return r.randint(0, 256, (rec.height, rec.width, 3)).astype(np.uint8)

        self.dataset = Dataset(path, test_mode=True)


def finite_metrics(label: str, metrics: dict) -> None:
    """COCO metrics are finite, but for the area ranges without gts."""
    if not metrics or not all(math.isfinite(v) or (math.isnan(v) and k in
                                                   ("mAP_s", "mAP_m", "mAP_l"))
                              for k, v in metrics.items()):
        fail(f"{label}: non-finite metrics {metrics}")


def eval_phase(card):
    """Phase 23; returns evaluate_dataset's metrics (the warm run's)."""
    import tempfile

    from htd_tpu_torch import evaluate_dataset, evaluate_proposals, htd_r50_1x, init_detector
    from htd_tpu_torch.data.coco_eval import evaluate_coco_map
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    phase("23 main path: evaluate_dataset and evaluate_proposals, R-50 bfloat16, batch 8")
    model = init_detector(htd_r50_1x(compute_dtype="bfloat16"), seed=0)
    scale_scores(model)
    with tempfile.TemporaryDirectory() as root:
        ds = SeededCoco(root).dataset
    n_land = sum(r.landscape for r in ds.records)
    gt = ds.groundtruth()
    print(f"mini-COCO: {len(ds)} seeded images ({n_land} landscape, {len(ds) - n_land} portrait, "
          f"sides {min(min(r.height, r.width) for r in ds.records)}-"
          f"{max(max(r.height, r.width) for r in ds.records)} px), "
          f"{sum(len(r.boxes) for r in ds.records)} gt boxes over {len(ds.cat_ids)} categories")
    perfect = {k: (b, np.ones(len(b), np.float32), lab) for k, (b, lab, _) in gt.items()}
    self_check = evaluate_coco_map(perfect, gt, len(ds.cat_ids))
    print(f"evaluator self-check, the ground truth as detections (score 1): mAP "
          f"{self_check['mAP']}, AR@100 {self_check['AR@100']}")
    if self_check["mAP"] != 1.0:
        fail("the COCO evaluator does not give mAP 1 on the ground truth")
    n_batches = -(-n_land // 8) + -(-(len(ds) - n_land) // 8)
    for run in ("first", "warm"):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = evaluate_dataset(model, ds, batch_size=8, log_every=0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(launch_counts)
        print(f"evaluate_dataset ({run}): {len(ds) / dt:.2f} images/s ({dt:.2f} s, {n_batches} "
              f"batches of 8); launches {counts}; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in metrics.items()) + f" ({card})")
        if counts["upsample_add"] != 3 * n_batches or counts["pyramid_pack"] != n_batches:
            fail(f"expected K7 3 and K1 1 launches per batch, got {counts}")
        finite_metrics(f"evaluate_dataset ({run})", metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ar = evaluate_proposals(model, ds, batch_size=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"evaluate_proposals: {len(ds) / dt:.2f} images/s; " + ", ".join(
        f"{k} {v:.4f}" for k, v in ar.items()))
    if not all(0.0 <= v <= 1.0 for v in ar.values()):
        fail(f"proposal recall outside [0, 1]: {ar}")
    return metrics


def png_coco(root: str):
    """Phase 23's seeded mini-COCO written to `root` as PNG files:
    val.json names all MINI_COCO_IMAGES images, train.json the first
    TOOLS_TRAIN_IMAGES / 2 of each orientation. Returns (train.json,
    val.json, the pixels by image id)."""
    from htd_tpu_torch.data.png import write_png

    src = SeededCoco(root).dataset
    with open(f"{root}/ann.json") as f:
        ann = json.load(f)
    pixels = {}
    for im in ann["images"]:
        rec = next(r for r in src.records if r.img_id == im["id"])
        pixels[im["id"]] = src.load_image(rec)
        im["file_name"] = f"{im['id']}.png"
        write_png(f"{root}/{im['file_name']}", pixels[im["id"]])
    land = [im["id"] for im in ann["images"] if im["width"] >= im["height"]]
    port = [im["id"] for im in ann["images"] if im["width"] < im["height"]]
    train_ids = set(land[:TOOLS_TRAIN_IMAGES // 2] + port[:TOOLS_TRAIN_IMAGES // 2])
    paths = []
    for name, ids in (("train", train_ids), ("val", {im["id"] for im in ann["images"]})):
        part = dict(ann, images=[im for im in ann["images"] if im["id"] in ids],
                    annotations=[a for a in ann["annotations"] if a["image_id"] in ids])
        paths.append(f"{root}/{name}.json")
        with open(paths[-1], "w") as f:
            json.dump(part, f)
    return paths[0], paths[1], pixels


def tool_run(label: str, fn, card: str):
    """Run one tool in process with the launch counts set to 0 just
    before; returns (its result, the counts). Prints the wall time."""
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, path_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in {**launch_counts, **path_counts}.items() if v}
    print(f"[{label}] {dt:.2f} s; launches {counts} ({card})")
    return out, counts


def expect_launches(label: str, counts: dict, want: dict) -> None:
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        fail(f"{label}: expected launches {want}, got {got}")


def tools_phase(card):
    """Phase 24: the command-line tools of tools_torch/ on files on disk."""
    import re
    import tempfile

    from htd_tpu_torch import config as C
    from htd_tpu_torch import inference_detector, init_detector
    from htd_tpu_torch.data.coco import CocoDataset
    from tools_torch import eval_metric, publish_model
    from tools_torch import test as test_tool
    from tools_torch import train as train_tool

    phase("24 main path: the tools (train, resume, test, eval_metric, publish) on PNG files")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        train_ann, val_ann, pixels = png_coco(root)
        val = CocoDataset(val_ann, root, test_mode=True)
        for rec in val.records:
            if not np.array_equal(val.load_image(rec), pixels[rec.img_id]):
                fail(f"CocoDataset.load_image of {rec.file_name} differs from the pixels written")
        n_land = sum(r.landscape for r in val.records)
        print(f"[png] {len(val)} seeded images written as PNG (data.png.write_png: rows "
              f"filtered None, Sub, Up, Average, Paeth in turn) and read back bit-equal "
              f"through CocoDataset.load_image in {time.perf_counter() - t0:.2f} s; train.json "
              f"{TOOLS_TRAIN_IMAGES} of them, val.json all ({card})")

        steps = TOOLS_TRAIN_IMAGES // 2     # batches of 2, each orientation apart
        common = ["--config", "htd_r50_1x", "--bf16", "--batch-size", "2", "--train-ann",
                  train_ann, "--train-img", root, "--log-interval", "1", "--seed", "0",
                  "--set", "train.total_epochs=2"]
        full, counts = tool_run("train.py, 2 epochs", lambda: train_tool.main(
            common + ["--work-dir", f"{root}/full"]), card)
        expect_launches("train.py", counts, {"pyramid_pack": 2 * steps, "roi_align": 6 * steps,
                                             "roi_align_bwd": 6 * steps,
                                             "upsample_add": 6 * steps})
        for name in ("config.json", "train.log.json", "epoch_1.pth", "epoch_2.pth"):
            if not os.path.exists(f"{root}/full/{name}"):
                fail(f"train.py wrote no {name}")
        losses = [r["loss"] for r in full]
        if len(full) != 2 * steps or not all(math.isfinite(v) for r in full for v in r.values()):
            fail(f"train.py logged {full}")
        print(f"train.py: R-50 bf16, batch 2 at {C.htd_r50_1x().train.img_scale}, {steps} steps "
              f"per epoch; losses {losses}")
        meta = torch.load(f"{root}/full/epoch_1.pth", map_location="cpu",
                          weights_only=True)["meta"]
        if (meta["step"], meta["steps_per_epoch"], meta["epoch"]) != (steps, steps, 1):
            fail(f"epoch_1.pth meta {meta}")

        resumed, counts = tool_run("train.py --resume-from epoch_1.pth --val-ann", lambda:
                                   train_tool.main(common + [
                                       "--work-dir", f"{root}/resumed", "--resume-from",
                                       f"{root}/full/epoch_1.pth", "--val-ann", val_ann,
                                       "--val-img", root]), card)
        expect_launches("resumed train.py", counts, {"roi_align_bwd": 3 * steps})
        first, ref = resumed[0], full[steps]
        if (first["epoch"], first["iter"], ref["epoch"], ref["iter"]) != (2, 1, 2, 1):
            fail(f"the resumed run starts at {first}, not at epoch 2 iteration 1")
        dev = max(abs(first[k] - ref[k]) for k in ref if k not in ("epoch", "iter", "time"))
        print(f"resumed at step {meta['step']} (= steps per epoch): its first logged losses vs "
              f"the uninterrupted run's at the same step, as logged (4 places): max abs "
              f"deviation {dev:.4g} (limit {RESUME_LIMIT}: that step's forward has no atomics "
              f"and draws the same samples; the atomics of K4 and K5 make later steps differ)")
        if dev > RESUME_LIMIT:
            fail("the resumed run's first losses differ from the uninterrupted run's")
        finite_metrics("validation", resumed[-1])
        print(f"validation after the resumed epoch: {resumed[-1]}")
        a = torch.load(f"{root}/full/epoch_2.pth", map_location="cpu", weights_only=True)
        b = torch.load(f"{root}/resumed/epoch_2.pth", map_location="cpu", weights_only=True)
        drift = max((x.float() - b["state_dict"][k].float()).abs().max().item()
                    for k, x in a["state_dict"].items())
        print(f"epoch_2.pth, uninterrupted vs resumed: max abs parameter difference {drift:.3g} "
              f"(not held: atomics)")
        del a, b
        os.remove(f"{root}/full/epoch_1.pth")
        shutil.rmtree(f"{root}/resumed")

        ckpt = f"{root}/full/epoch_2.pth"
        test_args = ["--config", "htd_r50_1x", "--bf16", "--checkpoint", ckpt, "--ann", val_ann,
                     "--img-root", root, "--set", "rcnn_test.score_thr=0.0"]
        n_batches = -(-n_land // 8) + -(-(len(val) - n_land) // 8)
        metrics, counts = tool_run("test.py --dump --coco-dump", lambda: test_tool.main(
            test_args + ["--dump", f"{root}/dets.json", "--coco-dump", f"{root}/coco.json"]), card)
        finite_metrics("test.py", metrics)
        expect_launches("test.py", counts, {"pyramid_pack": n_batches, "roi_align": 3 * n_batches,
                                            "upsample_add": 3 * n_batches})
        offline, _ = tool_run("eval_metric.py", lambda: eval_metric.main(
            [f"{root}/dets.json", "--ann", val_ann]), card)
        with open(f"{root}/coco.json") as f:
            n_coco = len(json.load(f))
        print(f"test.py on epoch_2.pth (exact grid, score_thr 0): {metrics}; eval_metric.py on "
              f"its dump: {offline}; {n_coco} detections of the dataset's categories in the COCO "
              f"dump")
        if json.dumps(offline) != json.dumps(metrics):
            fail("eval_metric.py does not reproduce test.py's metrics")
        recall, counts = tool_run("test.py --eval proposal", lambda: test_tool.main(
            test_args + ["--eval", "proposal"]), card)
        expect_launches("test.py --eval proposal", counts, {"pyramid_pack": 0, "roi_align": 0,
                                                            "upsample_add": 3 * n_batches})
        if not all(0.0 <= v <= 1.0 for v in recall.values()):
            fail(f"proposal recall outside [0, 1]: {recall}")
        aug, counts = tool_run("test.py --aug --max-images 2", lambda: test_tool.main(
            test_args + ["--aug", "--max-images", "2"]), card)
        finite_metrics("test.py --aug", aug)
        expect_launches("test.py --aug", counts, {"pyramid_pack": 4, "roi_align": 12,
                                                  "upsample_add": 24})
        print(f"proposal recall {recall}; TTA (test scale x flip) on 2 images {aug}")

        dcn, counts = tool_run("test.py --config htd_r101_dcn_2x", lambda: test_tool.main(
            ["--config", "htd_r101_dcn_2x", "--bf16", "--max-images", "2", "--batch-size", "2",
             "--ann", val_ann, "--img-root", root]), card)
        finite_metrics("R-101-DCN test.py", dcn)
        expect_launches("R-101-DCN test.py", counts, {"deform_conv": 30, "deform_conv_tc": 30})
        print(f"R-101-DCN bf16, random weights, 2 images: {dcn}")

        published, _ = tool_run("publish_model.py", lambda: publish_model.main(
            [ckpt, f"{root}/htd_r50.pth"]), card)
        if not re.fullmatch(re.escape(root) + r"/htd_r50-[0-9a-f]{8}\.pth", published):
            fail(f"publish_model.py wrote {published}")
        keys = set(torch.load(published, map_location="cpu", weights_only=True))
        cfg = C.apply_overrides(C.htd_r50_1x(compute_dtype="bfloat16"),
                                ["rcnn_test.score_thr=0.0"])
        img = pixels[val.records[0].img_id]
        with torch.inference_mode():
            got = inference_detector(init_detector(cfg, published), img)
            ref = inference_detector(init_detector(cfg, ckpt), img)
        same = all(np.array_equal(x, y) for x, y in zip(got, ref))
        print(f"publish_model.py -> {os.path.basename(published)} with {sorted(keys)}; "
              f"init_detector + inference_detector on one image: {len(got[1])} detections, "
              f"bit-identical to the unpublished file's: {same}")
        if keys != {"meta", "state_dict"} or not same or len(got[1]) == 0:
            fail("the published model differs from the unpublished one")
    print(f"phase 24: {time.perf_counter() - t_phase:.2f} s in all ({card})")


def spawn_ranks(fn, nprocs: int, *args) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes and wait for all;
    a rank's exception fails the phase, and so does a group that takes
    longer than RANK_JOIN_S (its processes are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.perf_counter() + RANK_JOIN_S
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"{fn.__name__}: the ranks did not end within {RANK_JOIN_S} s")


def spawned_setup() -> None:
    """A process spawned by phase 25: the kernels loaded (phase 2 built
    them), the parent's TF32 settings (off since phase 4)."""
    from htd_tpu_torch.ops import _build

    torch.set_num_threads(2)
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def join_group(rank: int, world_size: int, rendezvous: str, backend: str = "gloo"):
    """A spawned rank of phase 25 (`spawned_setup`), the default process
    group joined at the file `rendezvous`, rank r on cuda:(r mod the card
    count)."""
    from htd_tpu_torch.parallel import init_distributed

    spawned_setup()
    return init_distributed(backend, f"file://{rendezvous}", rank=rank, world_size=world_size,
                            local_rank=rank)


def identical_across_ranks(model) -> bool:
    """Whether every rank holds rank 0's parameters bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    same = torch.tensor([int(torch.equal(ref, flat))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def float32_step(state, batch, ov, group=None):
    """One train step with injected samples: (loss terms, gradients,
    parameters after) on the CPU, and the parameters before."""
    from htd_tpu_torch.train.train_step import train_step

    before = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    metrics = train_step(state, batch, overrides=ov, group=group)
    grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
             if p.grad is not None}
    after = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, grads, after), before


def nccl_refusal_rank(rank: int, root: str) -> None:
    """Phase 25 (a): two NCCL ranks on one card; records the error that
    NCCL raises at the first collective (the refusal is the expected
    outcome: the parent fails the phase if no rank saw one)."""
    import torch.distributed as dist

    join_group(rank, 2, f"{root}/nccl2", "nccl")
    x = torch.ones(8, device="cuda")
    error = None
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the outcome under test
        error = f"{type(e).__name__}: {str(e).splitlines()[0]}; " + " ".join(
            line for line in str(e).splitlines() if "Duplicate GPU" in line)
    dist.destroy_process_group()
    with open(f"{root}/nccl2_{rank}.json", "w") as f:
        json.dump({"error": error}, f)


def nccl_phase(card: str, root: str) -> None:
    """Phase 25 (a): the data-parallel step over NCCL at world size 1 in
    this process; NCCL refusing two ranks on one card."""
    import torch.distributed as dist

    from htd_tpu_torch.parallel import init_distributed

    print("(a) NCCL at world size 1, this process, R-50 bf16, phase 12's batch")
    init_distributed("nccl", f"file://{root}/nccl1", rank=0, world_size=1, local_rank=0)
    try:
        nccl_world_of_one(card, dist.group.WORLD)
    finally:
        # a live NCCL group holds the process at exit for minutes
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    spawn_ranks(nccl_refusal_rank, 2, root)
    errors = []
    for r in range(2):
        with open(f"{root}/nccl2_{r}.json") as f:
            errors.append(json.load(f)["error"])
    print(f"two NCCL ranks on one card: {errors}")
    if not all(errors):
        fail("NCCL ran a collective of two ranks on one card")


def nccl_world_of_one(card: str, group) -> None:
    """Phase 25 (a) in this process's NCCL group of one: the counted bf16
    steps, a profiled step, warm step times with and without the group,
    and a float32 step held to the step without a group."""
    from torch.profiler import ProfilerActivity, profile

    from htd_tpu_torch import htd_r50_1x
    from htd_tpu_torch.parallel import broadcast_parameters
    from htd_tpu_torch.train.train_step import create_train_state, train_step

    torch.backends.cudnn.benchmark = True
    cfg = htd_r50_1x(compute_dtype="bfloat16")
    state = create_train_state(cfg, seed=0)
    broadcast_parameters(state.model, 0, group)
    batch = train_batch(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    counted_steps(state, batch, gen, 0, group=group)
    # the profiler may lose the kernel's one record (see `device_times`):
    # a step whose trace holds none is profiled again
    for _ in range(DEVICE_TIME_TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_step(state, batch, gen, group=group)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the host's record of the collective; NCCL's kernel (at one rank its
        # one-rank reduction, `onerank.cu`)
        host = sum(e.count for e in events if e.key == "nccl:all_reduce"
                   and e.device_type == torch.autograd.DeviceType.CPU)
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("nccl:")
                   and ("nccl" in e.key.lower() or "onerank" in e.key.lower())]
        print(f"profile of one step: nccl:all_reduce x{host} on the host; NCCL's kernels: "
              + "; ".join(f"{e.key[:90]} x{e.count} device {e.device_time_total / 1e3:.3f} ms"
                          for e in kernels) + f" ({card})")
        if kernels or host != 1:
            break
    if host != 1 or sum(e.count for e in kernels) != 1:
        fail("the profiled step holds not one NCCL all-reduce and its kernel")
    times = {}
    for label, grp in (("with the group", group), ("without a group", None),
                       ("with the group", group), ("without a group", None)):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, gen, group=grp)
            torch.cuda.synchronize()
            times.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
    print("warm step medians, in turns of 3: " + "; ".join(
        f"{k} {statistics.median(v):.2f} ms" for k, v in times.items()) + f" ({card})")
    del state
    torch.cuda.empty_cache()

    cfg32, batch32, ov = small_step_inputs(htd_r50_1x)
    got, before = float32_step(create_train_state(cfg32, seed=0), batch32, ov, group)
    ref, _ = float32_step(create_train_state(cfg32, seed=0), batch32, ov)
    loss_err, g_line, d_line, over = hold_step(got, ref, before, r50_group)
    print(f"float32 step with injected samples, NCCL group of one vs no group: loss terms max "
          f"rel err {loss_err:.3g} (limit 1e-4); gradients: {g_line}; parameters after the "
          f"step: {d_line}")
    if loss_err > 1e-4 or over:
        fail(f"the step over NCCL disagrees with the step without a group: {over[:4]}")


def gloo_train_rank(rank: int, root: str) -> None:
    """Phase 25 (b): one of two gloo ranks on the card. GLOO_STEPS bf16
    R-50 steps on its own batch of 2 (launches checked per step, the
    parameters bit-identical across the ranks after each), then a float32
    step with its own injected samples; leaves its record in `root`."""
    import torch.distributed as dist

    from htd_tpu_torch import htd_r50_1x
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts
    from htd_tpu_torch.parallel import broadcast_parameters
    from htd_tpu_torch.train import train_step as ts

    join_group(rank, 2, f"{root}/gloo_train")
    torch.backends.cudnn.benchmark = True
    group = dist.group.WORLD
    cfg = htd_r50_1x(compute_dtype="bfloat16")
    state = ts.create_train_state(cfg, seed=0)
    broadcast_parameters(state.model, 0, group)
    batch = train_batch(cfg, seed=rank)
    reduce = ts.all_reduce_mean_packed
    rec = {"step_ms": [], "identical": [], "reduce_ms": [], "packed": []}

    def timed(tensors, group=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = reduce(tensors, group)
        end.record()
        end.synchronize()
        rec["reduce_ms"].append(start.elapsed_time(end))
        rec["packed"].append(sum(t.numel() for t in tensors))
        return out

    ts.all_reduce_mean_packed = timed
    for i in range(GLOO_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = ts.train_step(state, batch, ts.step_generator(0, state.step, "cuda", rank, 2),
                                group=group)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        counts = dict(launch_counts)
        if counts != step_launches(0):
            fail(f"rank {rank}: unexpected launches at step {i}: {counts}")
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            fail(f"rank {rank}: non-finite losses at step {i}")
        rec["identical"].append(identical_across_ranks(state.model))
    rec["loss"] = float(metrics["loss"])
    ts.all_reduce_mean_packed = reduce
    del state
    torch.cuda.empty_cache()

    cfg32, batch32, ov = small_step_inputs(htd_r50_1x, seed=3 + rank, ov_seed=rank)
    state = ts.create_train_state(cfg32, seed=0)
    broadcast_parameters(state.model, 0, group)
    got, _ = float32_step(state, batch32, ov, group)
    rec["f32_identical"] = identical_across_ranks(state.model)
    if rank == 0:
        torch.save(got, f"{root}/gloo_f32.pt")
    with open(f"{root}/gloo_train{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def mean_of_halves_step(preset):
    """Phase 25 (b)'s reference in this process: the float32 step of
    `small_step_inputs` on the two ranks' halves, each rank's gradient
    and loss terms apart, their mean, then the clip and the SGD step.
    Returns ((loss terms, gradients, parameters after), parameters
    before)."""
    from htd_tpu_torch.train.optim import clip_gradients, lr_schedule
    from htd_tpu_torch.train.train_step import create_train_state

    halves = [small_step_inputs(preset, seed=3 + r, ov_seed=r) for r in range(2)]
    cfg = halves[0][0]
    state = create_train_state(cfg, seed=0)
    model, opt = state.model, state.optimizer
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    grads, terms = [], []
    for _, batch, ov in halves:
        opt.zero_grad(set_to_none=True)
        losses = model.forward_train(batch.images, batch.img_shapes, batch.gt_boxes,
                                     batch.gt_labels, batch.gt_valid, overrides=ov)
        total = sum(v for k, v in losses.items() if "loss" in k)
        total.backward()
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        terms.append({"loss": total.item(), **{k: v.item() for k, v in losses.items()}})
    for n, p in model.named_parameters():
        if n in grads[0]:
            p.grad = (grads[0][n] + grads[1][n]) / 2
    clip_gradients(cfg.train, opt)
    for pg in opt.param_groups:
        pg["lr"] = lr_schedule(cfg.train, state.steps_per_epoch)(0)
    opt.step()
    metrics = {k: (terms[0][k] + terms[1][k]) / 2 for k in terms[0]}
    mean = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    after = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return (metrics, mean, after), before


def gloo_train_phase(card: str, root: str) -> None:
    """Phase 25 (b): two gloo ranks on the one card."""
    from htd_tpu_torch import htd_r50_1x

    print(f"(b) two gloo ranks on the card (spawned, file rendezvous), R-50 bf16, batch 2 per "
          f"rank, {GLOO_STEPS} steps")
    spawn_ranks(gloo_train_rank, 2, root)
    recs = []
    for r in range(2):
        with open(f"{root}/gloo_train{r}.json") as f:
            recs.append(json.load(f))
        rec = recs[-1]
        print(f"rank {r}: step median {statistics.median(rec['step_ms'][1:]):.2f} ms over steps "
              f"2-{GLOO_STEPS} (first {rec['step_ms'][0]:.2f} ms); packed vector "
              f"{rec['packed'][0]} float32 values ({rec['packed'][0] * 4 / 1e6:.1f} MB); its "
              f"all-reduce by events, gloo's host path (copies to and from the host, the sum on "
              f"the CPU; not NCCL's time): median {statistics.median(rec['reduce_ms']):.1f} ms "
              f"({', '.join(f'{v:.1f}' for v in rec['reduce_ms'])}); launches per step as "
              f"phase 12's; parameters bit-identical across the ranks after each step: "
              f"{rec['identical']}, after the float32 step: {rec['f32_identical']} ({card})")
        if not all(rec["identical"]) or not rec["f32_identical"]:
            fail(f"rank {r}'s parameters differ from rank 0's")
    if recs[0]["loss"] != recs[1]["loss"]:
        fail("the ranks report different mean losses")
    got = torch.load(f"{root}/gloo_f32.pt", weights_only=False)
    ref, before = mean_of_halves_step(htd_r50_1x)
    loss_err, g_line, d_line, over = hold_step(got, ref, before, r50_group)
    print(f"float32 step, each rank its own half and injected samples, vs this process's mean "
          f"of the two halves' gradients then the SGD step: loss terms max rel err "
          f"{loss_err:.3g} (limit 1e-4); gradients: {g_line}; parameters after the step: "
          f"{d_line}")
    if loss_err > 1e-4 or over:
        fail(f"the two-rank step disagrees with the mean of the halves: {over[:4]}")
    torch.cuda.empty_cache()


def spawned_evaluation(root: str, tag: str, group=None) -> None:
    """Phase 25 (c) in a spawned process: `evaluate_dataset` of R-50 bf16
    on phase 23's mini-COCO at batch 8 with cuDNN's heuristics restricted
    to deterministic algorithms, over `group` (None: this process alone),
    saved to {root}/gloo_eval{tag}.pt."""
    from htd_tpu_torch import evaluate_dataset, htd_r50_1x, init_detector
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    model = init_detector(htd_r50_1x(compute_dtype="bfloat16"), seed=0)
    scale_scores(model)
    os.makedirs(f"{root}/coco{tag}")
    ds = SeededCoco(f"{root}/coco{tag}").dataset
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics, dets = evaluate_dataset(model, ds, batch_size=8, log_every=0,
                                     return_detections=True, group=group)
    torch.cuda.synchronize()
    torch.save({"metrics": metrics, "dets": dets, "launches": dict(launch_counts)},
               f"{root}/gloo_eval{tag}.pt")


def gloo_eval_rank(rank: int, root: str) -> None:
    """Phase 25 (c): one of two gloo ranks running `spawned_evaluation`."""
    import torch.distributed as dist

    join_group(rank, 2, f"{root}/gloo_eval")
    spawned_evaluation(root, str(rank), dist.group.WORLD)
    dist.barrier()
    dist.destroy_process_group()


def one_process_eval(rank: int, root: str) -> None:
    """Phase 25 (c)'s reference: `spawned_evaluation` in one fresh process
    set up as a rank is, with no group."""
    spawned_setup()
    spawned_evaluation(root, "ref")


def gloo_eval_phase(card: str, root: str, eval_metrics: dict) -> None:
    """Phase 25 (c): `evaluate_dataset` over two gloo ranks against one
    fresh process."""
    print("(c) evaluate_dataset over two gloo ranks, R-50 bf16, batch 8 per rank, phase 23's "
          "mini-COCO")
    # The reference is a fresh process too: cuDNN's autotuner (on here since
    # phase 3) and, through the free memory it sees, its heuristics may pick
    # other algorithms in this long-lived process than in a new one.
    spawn_ranks(one_process_eval, 1, root)
    one = torch.load(f"{root}/gloo_evalref.pt", weights_only=False)
    ref, ref_dets = one["metrics"], one["dets"]
    spawn_ranks(gloo_eval_rank, 2, root)
    for r in range(2):
        out = torch.load(f"{root}/gloo_eval{r}.pt", weights_only=False)
        same = (list(out["dets"]) == list(ref_dets) and all(
            np.array_equal(x, y) for k in ref_dets for x, y in zip(ref_dets[k], out["dets"][k])))
        n = sum(len(v[1]) for v in out["dets"].values())
        print(f"rank {r}: launches {out['launches']}; metrics {out['metrics']}; {n} gathered "
              f"detections of {len(out['dets'])} images, bit-identical to one fresh process's "
              f"(same batches, cuDNN's heuristics in both): {same}")
        if json.dumps(out["metrics"]) != json.dumps(ref) or not same:
            fail(f"rank {r}'s evaluation differs from one process's")
        expect_launches(f"rank {r}", out["launches"], {"pyramid_pack": 1, "roi_align": 3,
                                                       "upsample_add": 3})
    diff = max(abs(ref[k] - eval_metrics[k]) for k in ref
               if math.isfinite(ref[k]) and math.isfinite(eval_metrics[k]))
    print(f"one fresh process with cuDNN's heuristics {ref}; phase 23 (autotuned) {eval_metrics}: "
          f"largest difference {diff:.3g} (not held: other conv algorithms)")


def tool_process(label: str, args, card: str):
    """Run `args` (a command in this directory) as its own process; fails
    on a non-zero exit. Returns its standard output."""
    t0 = time.perf_counter()
    done = subprocess.run(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=RANK_JOIN_S)
    print(f"[{label}] {time.perf_counter() - t0:.2f} s, exit {done.returncode} ({card})")
    if done.returncode != 0:
        fail(f"{label} failed:\n{done.stdout[-2000:]}\n{done.stderr[-4000:]}")
    return done.stdout


def metrics_close(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        abs(a[k] - b[k]) <= METRIC_LIMIT or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def torchrun_phase(card: str, root: str) -> None:
    """Phase 25 (d): train.py under torchrun over two gloo ranks, test.py
    with --chips 2 against --chips 1."""
    import sys

    print("(d) the tools: torchrun train.py over two gloo ranks, test.py --chips 2 vs --chips 1")
    root = f"{root}/tools"
    os.makedirs(root)
    train_ann, val_ann, _ = png_coco(root)
    work = f"{root}/dist"
    out = tool_process("torchrun --standalone --nproc_per_node 2 train.py", [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "tools_torch/train.py", "--distributed", "--dist-backend", "gloo", "--config",
        "htd_r50_1x", "--bf16", "--batch-size", "4", "--train-ann", train_ann, "--train-img", root,
        "--work-dir", work, "--log-interval", "1", "--seed", "0", "--set",
        "train.total_epochs=1"], card)
    files = sorted(os.listdir(work))
    with open(f"{work}/train.log.json") as f:
        records = [json.loads(line) for line in f]
    with open(f"{work}/train.log") as f:
        log = f.read().splitlines()
    printed = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    steps = TOOLS_TRAIN_IMAGES // 4
    print(f"train.py: files {files}; {len(records)} log records (global batch 4, 2 per rank), "
          f"printed once each: {printed == records}; losses {[r['loss'] for r in records]}; "
          f"train.log {len(log)} lines, {len(set(log))} distinct")
    if files != ["config.json", "epoch_1.pth", "train.log", "train.log.json"]:
        fail(f"train.py under torchrun wrote {files}")
    if [(r["epoch"], r["iter"]) for r in records] != [(1, i + 1) for i in range(steps)] \
            or printed != records or len(log) != len(set(log)) \
            or not all(math.isfinite(v) for r in records for v in r.values()):
        fail(f"train.py under torchrun logged {records} and printed {printed}")
    meta = torch.load(f"{work}/epoch_1.pth", map_location="cpu", weights_only=True)["meta"]
    if (meta["step"], meta["epoch"]) != (steps, 1):
        fail(f"epoch_1.pth meta {meta}")

    test = [sys.executable, "tools_torch/test.py", "--config", "htd_r50_1x", "--bf16",
            "--checkpoint", f"{work}/epoch_1.pth", "--ann", val_ann, "--img-root", root,
            "--set", "rcnn_test.score_thr=0.0"]
    two = json.loads(tool_process("test.py --chips 2 --batch-size 8", test + [
        "--chips", "2", "--dist-backend", "gloo", "--batch-size", "8", "--dump",
        f"{root}/two.json"], card).splitlines()[-1])
    one = json.loads(tool_process("test.py --batch-size 4", test + [
        "--batch-size", "4", "--dump", f"{root}/one.json"], card).splitlines()[-1])
    with open(f"{root}/one.json") as f, open(f"{root}/two.json") as g:
        same = f.read() == g.read()
    print(f"test.py --chips 2 (4 images per rank and batch) {two}; --chips 1 at batch 4 {one}; "
          f"dumps identical: {same}")
    finite_metrics("test.py --chips 2", two)
    if not metrics_close(two, one):
        fail("test.py --chips 2 and --chips 1 disagree")


def parallel_phase(card: str, eval_metrics: dict) -> None:
    """Phase 25: data parallelism over torch.distributed."""
    import tempfile

    phase("25 data parallel: NCCL at world size 1, two gloo ranks on the card (training, "
          "evaluation), the tools under torchrun")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        for part, fn in (("a", lambda: nccl_phase(card, root)),
                         ("b", lambda: gloo_train_phase(card, root)),
                         ("c", lambda: gloo_eval_phase(card, root, eval_metrics)),
                         ("d", lambda: torchrun_phase(card, root))):
            t0 = time.perf_counter()
            fn()
            print(f"phase 25 ({part}): {time.perf_counter() - t0:.2f} s")
    print(f"phase 25: {time.perf_counter() - t_phase:.2f} s in all ({card})")


def probe_image(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded (h, w, 3) uint8 BGR image on which phase 26 (d) holds the
    corruptions to their manifest: integer gradients and `RandomState`
    noise, the same on every machine."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y * 2) % 256, (y * 3 + 40) % 256, (x * 2 + y * 7 + 90) % 256], -1)
    return np.clip(base + r.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def jpeg_coco(root: str, photos):
    """A mini-COCO over the photo-sized fixtures: ann.json in `root` with
    seeded boxes over categories 1-3, the images read from JPEG_DIR."""
    rng = np.random.RandomState(1)
    images, anns = [], []
    for i, (name, (h, w)) in enumerate(photos):
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for _ in range(rng.randint(2, 6)):
            bw, bh = rng.uniform(24, w / 2), rng.uniform(24, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.choice([1, 2, 3])),
                             bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
    path = f"{root}/jpeg_ann.json"
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=k, name=f"c{k}") for k in (1, 2, 3)]), f)
    return path


class RecordedEvaluations:
    """Wraps `htd_tpu_torch.apis.evaluate_dataset` (the tools import it at
    call time): each call runs with `return_detections=True` and the
    launch counts set to 0 just before; records (model, dataset,
    detections, counts, seconds) and returns the metrics alone."""

    def __init__(self):
        import htd_tpu_torch.apis as apis

        self.apis, self.original, self.calls = apis, apis.evaluate_dataset, []

    def __enter__(self):
        from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

        def recorded(model, dataset, **kwargs):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            metrics, dets = self.original(model, dataset, return_detections=True, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((model, dataset, dets, dict(launch_counts),
                               time.perf_counter() - t0))
            return metrics

        self.apis.evaluate_dataset = recorded
        return self

    def __exit__(self, *exc):
        self.apis.evaluate_dataset = self.original


def same_detections(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        all(np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in a)


def robustness_phase(card: str) -> None:
    """Phase 26: JPEG files read on the host, and corruption robustness."""
    import tempfile

    from htd_tpu_torch.data import corruptions as corr
    from htd_tpu_torch.data.jpeg import read_jpeg
    from htd_tpu_torch.ops import _build
    from tools_torch import robustness_eval
    from tools_torch import test as test_tool
    from tools_torch import test_robustness

    phase("26 main path: JPEG decoding on the host, and R-50 evaluation under corruption")
    t_phase = time.perf_counter()
    host = _build.build_host()
    print(f"host library built from htd_tpu_torch/csrc/*.cpp in {host.seconds:.2f} s (fresh "
          f"build: {host.built}) -> {host.path.parent.name}")

    # (a) the fixtures against cv2.imread's pixels (the manifest's hashes)
    jdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_DIR)
    with open(f"{jdir}/manifest.json") as f:
        manifest = json.load(f)
    for name, want in manifest.items():
        img = read_jpeg(f"{jdir}/{name}")
        if list(img.shape) != want["shape"] or sha256(img) != want["sha256"]:
            fail(f"{name}: decoded {img.shape}, not cv2.imread's pixels {want}")
    photos = sorted(n for n in manifest if n.startswith("photo"))
    kinds = {n: "progressive" if "progressive" in n else "baseline" for n in photos}
    decode = {}
    for kind in ("baseline", "progressive"):
        names = [n for n in photos if kinds[n] == kind]
        t0 = time.perf_counter()
        for _ in range(PHOTO_DECODES):
            for name in names:
                read_jpeg(f"{jdir}/{name}")
        dt = time.perf_counter() - t0
        pixels = PHOTO_DECODES * sum(manifest[n]["shape"][0] * manifest[n]["shape"][1]
                                     for n in names)
        decode[kind] = (f"{1e3 * dt / (PHOTO_DECODES * len(names)):.2f} ms per image, "
                        f"{pixels / dt / 1e6:.2f} MP/s")
    print(f"[jpeg] {len(manifest)} fixtures bit-equal to cv2.imread's pixels (SHA-256 of the "
          f"manifest; progressive, CMYK and cut-short ones among them); host decode of the "
          f"photo-sized files (x{PHOTO_DECODES}): {len(photos) - 1} baseline "
          f"{decode['baseline']}, 1 progressive {decode['progressive']} ({card})")

    with tempfile.TemporaryDirectory() as root:
        # (b) test.py on a JPEG mini-COCO
        ann = jpeg_coco(root, [(n, tuple(manifest[n]["shape"][:2])) for n in photos])
        land = sum(manifest[n]["shape"][1] >= manifest[n]["shape"][0] for n in photos)
        n_batches = -(-land // 8) + -(-(len(photos) - land) // 8)
        metrics, counts = tool_run("test.py --eval bbox on the JPEG mini-COCO", lambda:
                                   test_tool.main(["--config", "htd_r50_1x", "--bf16", "--ann",
                                                   ann, "--img-root", jdir, "--eval", "bbox",
                                                   "--set", "rcnn_test.score_thr=0.0"]), card)
        finite_metrics("test.py on JPEG files", metrics)
        expect_launches("test.py on JPEG files", counts, {
            "pyramid_pack": n_batches, "roi_align": 3 * n_batches,
            "upsample_add": 3 * n_batches})
        print(f"test.py, R-50 bf16, {len(photos)} JPEG files in {n_batches} batches: {metrics}")

        # (c) test_robustness.py on phase 24's PNG mini-COCO
        _, val_ann, _ = png_coco(root)
        out = f"{root}/robustness.json"
        with RecordedEvaluations() as rec:
            _, counts = tool_run("test_robustness.py", lambda: test_robustness.main([
                "--config", "htd_r50_1x", "--bf16", "--ann", val_ann, "--img-root", root,
                "--out", out, "--corruptions", *corr.ALL_CORRUPTIONS, "--severities",
                *map(str, ROBUST_SEVERITIES), "--set", "rcnn_test.score_thr=0.0"]), card)
        with open(out) as f:
            cells = json.load(f)
        missing = [(c, s) for c in corr.ALL_CORRUPTIONS for s in ROBUST_SEVERITIES
                   if str(s) not in cells.get(c, {})]
        if missing:
            fail(f"test_robustness.py wrote no cell for {missing}")
        model, clean, clean_dets, _, clean_s = rec.calls[0]
        n_land = sum(r.landscape for r in clean.records)
        n_batches = -(-n_land // 8) + -(-(len(clean) - n_land) // 8)
        want = {"pyramid_pack": n_batches, "roi_align": 3 * n_batches,
                "upsample_add": 3 * n_batches}
        for i, (_, ds, _, c, _) in enumerate(rec.calls):
            expect_launches(f"test_robustness.py cell {i} ({getattr(ds, 'corruption', 'clean')}"
                            f" {getattr(ds, 'severity', 0)})", c, want)
        n_cells = 1 + len(corr.ALL_CORRUPTIONS) * (len(ROBUST_SEVERITIES) - 1)
        if len(rec.calls) != n_cells:
            fail(f"test_robustness.py evaluated {len(rec.calls)} cells, not {n_cells}")
        from htd_tpu_torch.apis import evaluate_dataset

        _, dets = evaluate_dataset(model, clean, batch_size=8, log_every=0,
                                   return_detections=True)
        n_dets = sum(len(v[1]) for v in dets.values())
        if not same_detections(dets, clean_dets) or n_dets == 0:
            fail("severity 0's detections differ from evaluate_dataset's on the clean set")
        print(f"{n_cells} cells ({len(corr.ALL_CORRUPTIONS)} corruptions x severities "
              f"{ROBUST_SEVERITIES[1:]}, severity 0 once), {len(clean)} PNG images at batch 8, "
              f"K1 {n_batches}, K2 {3 * n_batches}, K7 {3 * n_batches} launches per cell; "
              f"severity 0: {n_dets} detections bit-identical to evaluate_dataset's on the "
              f"clean set with the same model")
        t0 = time.perf_counter()
        megapixels = sum(clean.load_image(r).size for r in clean.records) / 3e6
        decode_s = time.perf_counter() - t0
        by_name = {}
        for _, ds, _, _, sec in rec.calls[1:]:
            by_name.setdefault(ds.corruption, []).append(round(sec, 2))
        print(f"cell wall s (host clock, evaluate_dataset with its image loads): clean "
              f"{clean_s:.2f}, of which {decode_s:.2f} s decode the {len(clean)} PNG files "
              f"({megapixels:.2f} MP) on the host; per corruption at severities "
              f"{ROBUST_SEVERITIES[1:]}: {by_name} ({card})")
        printed, _ = tool_run("robustness_eval.py", lambda: robustness_eval.main(
            [out, "--prints", "P", "mPC", "rPC", "--aggregate", "all"]), card)
        for key in ("P", "mPC"):
            finite_metrics(f"robustness_eval.py {key}", printed[key])
        print(f"robustness_eval.py: P {printed['P']}; mPC {printed['mPC']}; rPC "
              f"{printed['rPC']} (random weights: NaN where P is 0)")

    # (d) the corruptions on this host against the JAX package's outputs
    with open(f"{jdir}/corruptions.json") as f:
        ref = json.load(f)
    probes = [probe_image(*p) for p in ref["probes"]]
    bad = [(name, sev, i) for name, by_sev in ref["sha256"].items()
           for sev, hashes in by_sev.items() for i, (img, h) in enumerate(zip(probes, hashes))
           if sha256(corr.corrupt(img, name, int(sev), seed=ref["seed"])) != h]
    if bad or sorted(ref["sha256"]) != sorted(corr.ALL_CORRUPTIONS):
        fail(f"corruptions differ from the JAX package's outputs: {bad}")
    imgs = [read_jpeg(f"{jdir}/{n}") for n in photos]
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    times = {}
    for name in corr.ALL_CORRUPTIONS:
        t0 = time.perf_counter()
        for k, im in enumerate(imgs):
            corr.corrupt(im, name, 3, seed=k)
        times[name] = round(1e3 * (time.perf_counter() - t0) / mp, 1)
    print(f"[corruptions] {len(ref['sha256'])} corruptions x severities 1-5 x {len(probes)} "
          f"probe images ({', '.join(f'{h}x{w}' for _, h, w in ref['probes'])}) bit-equal to "
          f"the JAX package's outputs (SHA-256 of the manifest); host ms per MP at severity 3 "
          f"on the photo-sized fixtures: {times} ({card})")
    print(f"phase 26: {time.perf_counter() - t_phase:.2f} s in all ({card})")


def in_process(cmd, env=None):
    """tools_torch/drill_production.py's `_run` in this process: the tool
    that `cmd` names run by its `main(argv)`, its standard output captured
    (this process's TF32 switches stand in for `env`'s
    NVIDIA_TF32_OVERRIDE); returns (the output, wall seconds)."""
    import io

    from tools_torch import coco_error_analysis
    from tools_torch import test as test_tool

    module = {"test.py": test_tool,
              "coco_error_analysis.py": coco_error_analysis}[os.path.basename(cmd[1])]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(cmd[2:])
    return buf.getvalue(), time.perf_counter() - t0


def jpeg_decode_rates(card: str, root: str) -> None:
    """Phase 27 (a): the arithmetic and lossless fixtures against the
    manifest, and the host's decode rate of photo-sized files of each kind:
    the baseline photos, the arithmetic one, and a lossless RGB one written
    here (tests/jpeg_writers.py's coder), which must decode to its source."""
    from htd_tpu_torch.data.jpeg import read_jpeg
    from tests import jpeg_writers

    jdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_DIR)
    with open(f"{jdir}/manifest.json") as f:
        manifest = json.load(f)
    new = [n for n in manifest if "arith" in n or n.startswith("lossless")]
    for name in new:
        img = read_jpeg(f"{jdir}/{name}")
        if list(img.shape) != manifest[name]["shape"] or sha256(img) != manifest[name]["sha256"]:
            fail(f"{name}: decoded {img.shape}, not cv2.imread's pixels {manifest[name]}")
    src = jpeg_writers.photo(6, 427, 640)
    lossless = f"{root}/lossless_photo.jpg"
    with open(lossless, "wb") as f:
        f.write(jpeg_writers.lossless_jpeg(jpeg_writers.lossless_planes(src, "rgb"), 1,
                                           app=jpeg_writers.ADOBE_RGB))
    if not np.array_equal(read_jpeg(lossless), src):
        fail("the photo-sized lossless RGB file does not decode to its source pixels")
    rates = {}
    for kind, paths in (("baseline", [f"{jdir}/photo{i}.jpg" for i in range(4)]),
                        ("arithmetic", [f"{jdir}/{ARITH_PHOTO}"]), ("lossless", [lossless])):
        t0 = time.perf_counter()
        for _ in range(PHOTO_DECODES):
            imgs = [read_jpeg(path) for path in paths]
        dt = time.perf_counter() - t0
        px = PHOTO_DECODES * sum(im.shape[0] * im.shape[1] for im in imgs)
        rates[kind] = (f"{1e3 * dt / (PHOTO_DECODES * len(paths)):.2f} ms per image, "
                       f"{px / dt / 1e6:.2f} MP/s")
    size = os.path.getsize(lossless)
    print(f"[jpeg] {len(new)} arithmetic-coded and lossless fixtures bit-equal to cv2.imread's "
          f"pixels (the manifest's SHA-256; SOF9 and SOF10, DAC conditioning, a restart "
          f"interval, two cut short, lossless RGB at predictors 1 and 7, Pt 2, CMYK); a "
          f"640x427 lossless RGB file ({size} bytes) decodes to its source; host decode "
          f"(x{PHOTO_DECODES}, host clock): 4 baseline photos {rates['baseline']}, arithmetic "
          f"{rates['arithmetic']}, lossless {rates['lossless']} ({card})")


def drill_run(card: str, root: str) -> str:
    """Phase 27 (b): tools_torch/drill_production.py at production scale,
    its tools run in this process (`in_process`) with the launch counts
    set to 0 just before; returns the drill's checkpoint."""
    from tools_torch import drill_production as drill

    out = f"{root}/drill"
    argv = ["--images", str(DRILL_IMAGES), "--mirror-images", str(DRILL_MIRROR), "--scale",
            "x".join(map(str, DRILL_SCALE)), "--out", out]
    saved, drill._run = drill._run, in_process
    try:
        summary, counts = tool_run(f"drill_production.py {' '.join(argv[:6])}",
                                   lambda: drill.main(argv), card)
    finally:
        drill._run = saved
    with open(f"{out}/ann.json") as f:
        images = json.load(f)["images"]
    land = sum(im["width"] >= im["height"] for im in images)
    n_batches = -(-land // 4) + -(-(len(images) - land) // 4)
    expect_launches("drill_production.py's test.py", counts, {
        "pyramid_pack": n_batches, "roi_align": 3 * n_batches, "upsample_add": 3 * n_batches})
    finite_metrics("the drill's test.py", summary["full_set_metrics"])
    print(f"test.py (R-50 float32, TF32 off, exact grid, {DRILL_SCALE[0]}x{DRILL_SCALE[1]}, "
          f"batch 4, {len(images)} PNG images in {n_batches} batches; K1 {n_batches}, K2 "
          f"{3 * n_batches}, K7 {3 * n_batches} launches): {summary['test_images_per_s']} "
          f"images/s as test.py logs it (model build and cuDNN's first calls in the first "
          f"batches), {summary['test_wall_s']} s in all; evaluate_coco_map on its dump over 80 "
          f"categories (host clock): native matcher {summary['matcher_s']} s of "
          f"{summary['eval_s']} s, numpy twin {summary['matcher_plain_s']} s of "
          f"{summary['eval_plain_s']} s, metrics equal ({card})")
    return f"{out}/drill.pth"


def fidelity_run(card: str, pre_nms: bool) -> None:
    """Phase 27 (c): tools_torch/ab_fidelity.py, R-50 bf16 at 768x1344."""
    from tools_torch import ab_fidelity

    argv = ["--dtype", "bfloat16", "--height", "768", "--width", "1344"] + \
        (["--pre-nms"] if pre_nms else [])
    with contextlib.redirect_stderr(open(os.devnull, "w")):
        out, counts = tool_run(f"ab_fidelity.py{' --pre-nms' if pre_nms else ''}",
                               lambda: ab_fidelity.main(argv), card)
    rungs = out["rungs"]
    calls = len(rungs) * (1 + ab_fidelity.WARMUP_CALLS + ab_fidelity.TIMED_CALLS)
    expect_launches("ab_fidelity.py", counts, {"roi_align": 3 * calls})
    if len(rungs) != 5 or not all(math.isfinite(v) for r in rungs.values() for v in r.values()):
        fail(f"ab_fidelity.py wrote {out}")
    print(f"ab_fidelity.py{' --pre-nms' if pre_nms else ''}: {json.dumps(out)}")
    print(f"ms per image by rung (CUDA events over 8 warm calls, bf16, 768x1344; K2 "
          f"{3 * calls} launches, 3 per call): "
          f"{ {k: v['ms_per_img'] for k, v in rungs.items()} } ({card})")


def flops_run(card: str) -> None:
    """Phase 27 (d): tools_torch/get_flops.py for R-50 and R-101-DCN."""
    from tools_torch import get_flops

    for config, n_dcn in (("htd_r50_1x", 0), ("htd_r101_dcn_2x", 30)):
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            out, _ = tool_run(f"get_flops.py --config {config}", lambda: get_flops.main(
                ["--config", config, "--height", "768", "--width", "1344", "--dtype",
                 "bfloat16"]), card)
        if out["calls"] != {"deform_conv": n_dcn, "roi_align": 3} or not out["total"] > 0:
            fail(f"get_flops.py {config}: {out}")
        print(f"get_flops.py {config} 768x1344 bf16: params {out['params'] / 1e6:.2f} M; "
              f"FlopCounterMode {out['aten_total'] / 1e9:.2f} GFLOPs "
              f"({', '.join(f'{k} {v / 1e9:.2f}' for k, v in sorted(out['aten'].items()))}); "
              f"K3 by formula {out['deform_conv'] / 1e9:.2f}, K2 by formula "
              f"{out['roi_align'] / 1e9:.2f}; total {out['total'] / 1e9:.2f} GFLOPs")


def launchers_run(card: str, root: str, ckpt: str) -> None:
    """Phase 27 (e): tools_torch/dist_test.sh with one process and
    dist_train.sh (torchrun, one NCCL rank) for 2 steps, on phase 24's
    PNG mini-COCO."""
    import sys

    root = f"{root}/launch"
    os.makedirs(root)
    train_ann, val_ann, _ = png_coco(root)
    env = dict(os.environ, PYTHON=sys.executable)
    test_args = ["--ann", val_ann, "--img-root", root, "--bf16", "--set",
                 "rcnn_test.score_thr=0.0"]
    t0 = time.perf_counter()
    done = subprocess.run(["bash", "tools_torch/dist_test.sh", "htd_r50_1x", ckpt, "1",
                           "--dist-backend", "nccl", *test_args, "--dump", f"{root}/launched.json"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=RANK_JOIN_S)
    if done.returncode:
        fail(f"dist_test.sh failed:\n{done.stdout[-2000:]}\n{done.stderr[-3000:]}")
    launched = json.loads(done.stdout.splitlines()[-1])
    finite_metrics("dist_test.sh", launched)
    launched_s = time.perf_counter() - t0
    direct = json.loads(tool_process("test.py", [
        sys.executable, "tools_torch/test.py", "--checkpoint", ckpt, *test_args, "--dump",
        f"{root}/direct.json"], card).splitlines()[-1])
    with open(f"{root}/launched.json") as f, open(f"{root}/direct.json") as g:
        raw = f.read(), g.read()
    dets = json.loads(raw[0])
    n_dets = sum(len(d["scores"]) for d in dets.values())
    print(f"[dist_test.sh htd_r50_1x drill.pth 1 --dist-backend nccl] {launched_s:.2f} s: "
          f"{launched}; test.py as its own process {direct}; raw detections ({n_dets} over "
          f"{len(dets)} images) bit-identical: {raw[0] == raw[1]}. One chip: test.py --chips 1 "
          f"evaluates in its own process and forms no NCCL group; the group at world size 1 is "
          f"phase 25 (a), dist_train.sh's below ({card})")
    if raw[0] != raw[1] or not n_dets or launched != direct:
        fail("dist_test.sh and test.py disagree")
    work = f"{root}/dist_train"
    t0 = time.perf_counter()
    done = subprocess.run(["bash", "tools_torch/dist_train.sh", "htd_r50_1x", work,
                           "--train-ann", train_ann, "--train-img", root, "--bf16",
                           "--batch-size", "4", "--log-interval", "1", "--seed", "0",
                           "--set", "train.total_epochs=1"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env=dict(env, NPROC="1"), capture_output=True, text=True,
                          timeout=RANK_JOIN_S)
    if done.returncode:
        fail(f"dist_train.sh failed:\n{done.stdout[-2000:]}\n{done.stderr[-3000:]}")
    with open(f"{work}/train.log.json") as f:
        records = [json.loads(line) for line in f]
    steps = TOOLS_TRAIN_IMAGES // 4
    if [(r["epoch"], r["iter"]) for r in records] != [(1, i + 1) for i in range(steps)] \
            or not all(math.isfinite(v) for r in records for v in r.values()) \
            or not os.path.exists(f"{work}/epoch_1.pth"):
        fail(f"dist_train.sh logged {records}")
    print(f"[NPROC=1 dist_train.sh htd_r50_1x] {time.perf_counter() - t0:.2f} s: torchrun, one "
          f"NCCL rank, train.py --distributed, {steps} steps at global batch 4, losses "
          f"{[r['loss'] for r in records]}, epoch_1.pth written ({card})")


def drill_phase(card: str) -> None:
    """Phase 27: production-scale evaluation (the drill), the fidelity
    ladder, the FLOP counts, the launchers, and the new JPEG kinds."""
    import tempfile

    phase("27 main path: arithmetic and lossless JPEG on the host, the production drill, the "
          "fidelity ladder, FLOP counts and the torchrun launchers")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ckpt = None
        for part, fn in (("a", lambda: jpeg_decode_rates(card, root)),
                         ("b", lambda: drill_run(card, root)),
                         ("c", lambda: fidelity_run(card, pre_nms=False)),
                         ("c", lambda: fidelity_run(card, pre_nms=True)),
                         ("d", lambda: flops_run(card)),
                         ("e", lambda: launchers_run(card, root, ckpt))):
            t0 = time.perf_counter()
            out = fn()
            ckpt = out if part == "b" else ckpt
            print(f"phase 27 ({part}): {time.perf_counter() - t0:.2f} s ({card})")
    print(f"phase 27: {time.perf_counter() - t_phase:.2f} s in all ({card})")


def tta_eval_phases(card, pairs, k7_launches, imgs):
    """Phases 20-23; returns the kernel records of K7 and K8, and phase
    23's metrics."""
    from htd_tpu_torch import htd_r101_dcn_2x, init_detector

    k7_err, k7 = k7_phase(pairs, card)    # with autograd, for K7's gradients
    with torch.inference_mode():
        cfg = htd_r101_dcn_2x(compute_dtype="bfloat16")
        model = init_detector(cfg, seed=0)
        scale_scores(model)
        stds = offset_stds(model, imgs[0])
        set_offsets(model, stds, seed=0)
        k8_launches, k8 = fence_phase(model, imgs[0], cfg, card)
        tta_phase(model, stds, imgs, card)
        del model
        eval_metrics = eval_phase(card)
    return eval_metrics, [
        {"name": "upsample_add", "route": "cuda", "source": "htd_tpu_torch/csrc/upsample_add.cu",
         "replaces": "htd_tpu/ops/upsample.py:70", "launches": k7_launches,
         "max_abs_err": k7_err, "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": "bytes", "library_ms": None},
        {"name": "layout_fence", "route": "cuda", "source": "htd_tpu_torch/csrc/layout_fence.cu",
         "replaces": "htd_tpu/ops/fence.py:31", "launches": k8_launches, "max_abs_err": 0.0,
         "ms": k8["ms"], "plain_ms": k8["plain_ms"], "bound_ms": k8["bound_ms"],
         "bound_by": "bytes", "library_ms": k8["library_ms"]},
    ]


def main():
    """Phases 1-11 (inference); returns the card's lines, the kernel records,
    K7's launches on the main path and the laterals of its first request."""
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
    main_counts = run_requests(model, imgs, cfg, per_request_k3=0)

    phase("4 reference: float32 on the card (kernels) vs the CPU (plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_cfg = htd_r50_1x()
    gpu32 = init_detector(ref_cfg, device="cuda", seed=0)
    cpu32 = init_detector(ref_cfg, device="cpu", seed=0)
    scale_scores(gpu32)
    scale_scores(cpu32)
    card_vs_cpu(gpu32, cpu32)
    before = dict(launch_counts)
    boxes, scores, labels = inference_detector(gpu32, imgs[0])
    check_detections(boxes, scores, labels, imgs[0], ref_cfg)
    counts = {k: launch_counts[k] - before[k] for k in launch_counts}
    if counts["pyramid_pack"] <= 0 or counts["roi_align"] <= 0 or counts["upsample_add"] != 3:
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
        for rois, lvl, s in ((props, lv0, 4), (rois1, lv1, 4), (rois1, lv1, 2)):
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
              f"err relative to max |plain| {rel:.3g} (limit {tol}) over stage-0 (S=4), "
              f"stage-1 (S=4 and S=2) and 4 all-level (S=1) calls")
        if rel > tol:
            fail(f"K2 disagrees with its plain version in {dtype}")
        torch.cuda.synchronize()

    phase("6 timings")
    warm_latency(model, imgs, card)

    geom = pyr.geom
    k1_ms = cuda_ms(lambda: pack_pyramid(levels))
    k1_plain = cuda_ms(lambda: pack_pyramid_plain(levels, geom))
    k1_lib = cuda_ms(lambda: k1_library(levels, geom))
    k1_bytes = sum(f.numel() for f in levels) * 2 + pyr.buf.numel() * 2
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 pyramid_pack: {k1_ms * 1e3:.1f} us; plain {k1_plain * 1e3:.1f} us; zeros+copy_ "
          f"{k1_lib * 1e3:.1f} us; bound {k1_bound * 1e3:.1f} us ({k1_bytes / 1e6:.1f} MB "
          f"at 3.35 TB/s) ({card})")
    print(f"K1 device time (profiler, host dispatch left out): "
          f"{device_ms(lambda: pack_pyramid(levels)) * 1e3:.1f} us; zeros+copy_ "
          f"{device_ms(lambda: k1_library(levels, geom)) * 1e3:.1f} us ({card})")

    calls = [("stage-0 level-mapped S=4", props, lv0, 4, False),
             ("stage-1 level-mapped S=4", rois1, lv1, 4, False),
             ("BA all-level S=1", rois1, None, 1, True)]
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "device_ms": 0.0,
          "kernel_ms": 0.0, "outside_ms": 0.0}
    for name, rois, lvl, s, all_lv in calls:
        def call(rois=rois, lvl=lvl, s=s, all_lv=all_lv):
            if all_lv:
                return roi_align_levels(pyr, rois, strides, 7, 0, s)
            return roi_align_pyramid(pyr, rois, lvl, strides, 7, 0, s)

        ms = cuda_ms(call)
        if all_lv:
            plain = cuda_ms(lambda: [roi_align_plain(pyr, rois, torch.full_like(lv1, q),
                                                     strides, 7, 0, s) for q in range(4)],
                            iters=3, warmup=1)
        else:
            plain = cuda_ms(lambda: roi_align_plain(pyr, rois, lvl, strides, 7, 0, s),
                            iters=3, warmup=1)
        dev = device_times(call, {"roi_align_fwd": 1})
        # probe: the same rois moved past the image, so that every sample is
        # outside it: the geometry and the output writes alone
        outside = device_times(lambda: call(rois + OUTSIDE_PX), {"roi_align_fwd": 1})
        nbytes, ops = k2_bound(pyr, rois, lvl, strides, s, all_lv)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        for key, v in (("ms", ms), ("plain_ms", plain), ("bytes_ms", b_ms), ("ops_ms", o_ms),
                       ("device_ms", dev["all"]), ("kernel_ms", dev["roi_align_fwd"]),
                       ("outside_ms", outside["roi_align_fwd"])):
            k2[key] += v
        print(f"K2 roi_align {name}: {ms * 1e3:.1f} us by events, device {dev['all'] * 1e3:.1f} us "
              f"(the kernel {dev['roi_align_fwd'] * 1e3:.1f} us; "
              f"{100 * max(b_ms, o_ms) / dev['roi_align_fwd']:.1f}% of the bound); every "
              f"sample outside the image: {outside['roi_align_fwd'] * 1e3:.1f} us; plain "
              f"{plain * 1e3:.1f} us; bound {max(b_ms, o_ms) * 1e3:.1f} us ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP) ({card})")

    print(f"K2 per image (3 calls): {k2['ms'] * 1e3:.1f} us by events, device "
          f"{k2['device_ms'] * 1e3:.1f} us (kernels {k2['kernel_ms'] * 1e3:.1f} us, "
          f"{100 * max(k2['bytes_ms'], k2['ops_ms']) / k2['kernel_ms']:.1f}% of the bound; every "
          f"sample outside the image {k2['outside_ms'] * 1e3:.1f} us); bound "
          f"{max(k2['bytes_ms'], k2['ops_ms']) * 1e3:.1f} us ({card})")
    profile_request(model, imgs[0])
    pairs = capture_laterals(model, imgs[0])    # for phase 20
    del model, levels, pyr, props, rois1
    k3 = dcn_phases(imgs, card)

    kernels = [
        {"name": "pyramid_pack", "route": "cuda", "source": "htd_tpu_torch/csrc/pyramid_pack.cu",
         "replaces": "htd_tpu/ops/roi_align_pallas.py:196",
         "launches": main_counts["pyramid_pack"], "max_abs_err": k1_err[torch.bfloat16],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": "bytes",
         "library_ms": k1_lib},
        {"name": "roi_align", "route": "cuda", "source": "htd_tpu_torch/csrc/roi_align.cu",
         "replaces": "htd_tpu/ops/roi_align_pallas.py:1438",
         "launches": main_counts["roi_align"], "max_abs_err": k2_err[torch.bfloat16],
         "ms": k2["ms"], "device_ms": k2["device_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2["bytes_ms"], k2["ops_ms"]),
         "bound_by": "bytes" if k2["bytes_ms"] >= k2["ops_ms"] else "operations",
         "library_ms": None},
        k3,
    ]
    return card, kind, kernels, t_start, main_counts["upsample_add"], pairs


def run() -> None:
    """The inference phases 1-11 under `torch.inference_mode`, then the
    training phases 12-19 with autograd (models built in inference mode
    hold inference tensors, which autograd rejects), then phases 20-23
    (TTA and evaluation), 24 (the tools), 25 (data parallel), 26 (JPEG
    and robustness) and 27 (production-scale evaluation and the last
    tools), then the result."""
    with torch.inference_mode():
        card, kind, kernels, t_start, k7_launches, pairs = main()
    kernels.append(train_phases(card))
    kernels.extend(dcn_train_phases(card, images()))
    eval_metrics, records = tta_eval_phases(card, [(lo.clone(), la.clone()) for lo, la in pairs],
                                            k7_launches, images())
    kernels.extend(records)
    tools_phase(card)
    parallel_phase(card, eval_metrics)
    robustness_phase(card)
    drill_phase(card)
    print(f"kernel times are per image (K2: the sum of its 3 calls per request; K3: of its "
          f"30 launches per R-101-DCN request; K7: of its 3 launches per R-50 request; K8: one "
          f"launch on the largest fenced tensor) and per train step (K4: its 3 calls, R-50; K5, "
          f"K6: their 30 launches each, R-101-DCN); launches are over the {len(REQUEST_SHAPES)} "
          f"main-path requests (K1, K2, K7: R-50; K3: R-101-DCN), the {TRAIN_STEPS} main-path "
          f"train steps of each training path (K4: R-50; K5, K6: R-101-DCN) and the fenced "
          f"request (K8: R-101-DCN); max_abs_err is bfloat16 vs the plain version; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    run()
