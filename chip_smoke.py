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
     a device-time profile of one request;
  7. main path: HTD R-101-DCN (full depth and width, bfloat16, seeded
     non-zero offset convs) on the same requests, with K3's launches per
     request (30) and the offsets' statistics;
  8. K3 held to its plain version on the main path's own activations (one
     stride-2 and one stride-1 deformable conv of each DCN stage), in
     bfloat16 and float32;
  9. reference: R-101-DCN in float32 on the card against the CPU;
 10. HTD X-101-64x4d-DCN: one bfloat16 request at its test scale, with K3
     on grouped convs held to its plain version;
 11. R-101-DCN timings: warm per-image latency, K3 per launch and per image
     beside its bound, its plain version and cuDNN's regular conv of the
     same shapes (context only), a device-time profile of one request.
It needs CUDA: with no GPU, or run outside the repository, it fails.
"""

from __future__ import annotations

import json
import math
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

    def report(self, convs: int) -> dict:
        for hk in self.hooks:
            hk.remove()
        n, sq, far, out, flag, over = self.sums.tolist()
        st = {"offset_rms_px": math.sqrt(sq / n), "far": far / n, "outside": out / n,
              "flagged": flag / n, "over_cap": int(over), "max_px": int(self.max_px)}
        print(f"offsets over {convs} deformable convs: rms {st['offset_rms_px']:.2f} px; "
              f"{100 * st['far']:.1f}% of samples more than 1 px from their tap; "
              f"{100 * st['outside']:.1f}% outside the image; {100 * st['flagged']:.1f}% "
              f"outside the TPU kernel's window; in {st['over_cap']} of {convs} convs more than "
              f"{TPU_FB_CAP} pixels of an image were flagged (max {st['max_px']}), whose samples "
              f"beyond the cap the TPU kernel sets to zero; K3 computes all of them exactly")
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


def check_k3(captured, names):
    """K3 against its plain version on captured activations, in bfloat16
    (limit 1e-2) and float32 (limit 1e-4) relative to max |plain|. Returns
    the bfloat16 max abs error."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    errs = {}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        worst_abs = worst_rel = 0.0
        for name, m, x, off in captured:
            if name not in names:
                continue
            args = (x.to(dtype), off.to(dtype), m.hwio_weight().to(dtype), m.stride, 1, 1,
                    m.groups)
            k = deform_conv2d(*args).float()
            p = deform_conv2d_plain(*args).float()
            e = (k - p).abs().max().item()
            worst_abs = max(worst_abs, e)
            worst_rel = max(worst_rel, e / p.abs().max().item())
        torch.cuda.synchronize()
        errs[dtype] = worst_abs
        print(f"{str(dtype)[6:]}: K3 vs plain over {', '.join(names)} (groups "
              f"{captured[0][1].groups}): max abs err {worst_abs:.3g}, max err relative to "
              f"max |plain| {worst_rel:.3g} (limit {tol})")
        if worst_rel > tol:
            fail(f"K3 disagrees with its plain version in {dtype}")
    return errs[torch.bfloat16]


def run_requests(model, imgs, cfg, per_request_k3: int):
    """The main path: `inference_detector` on each image with the launch
    counts set to 0 just before and read just after; every request must
    launch K1 and K2 and, with deformable convs, K3 `per_request_k3` times."""
    from htd_tpu_torch import inference_detector
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    for img in imgs:
        before = dict(launch_counts)
        boxes, scores, labels = inference_detector(model, img)
        counts = {k: launch_counts[k] - before[k] for k in launch_counts}
        check_detections(boxes, scores, labels, img, cfg)
        if counts["pyramid_pack"] <= 0 or counts["roi_align"] <= 0 \
                or counts["deform_conv"] != per_request_k3:
            fail(f"unexpected launches on request {img.shape}: {counts}")
        print(f"request {img.shape[1]}x{img.shape[0]}: {len(scores)} detections, "
              f"top scores {np.round(scores[:3], 4).tolist()}, labels "
              f"{labels[:3].tolist()}, first box {np.round(boxes[0], 1).tolist()}, "
              f"launches {counts}")
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    print(f"main path launches over {len(imgs)} requests: {counts}")
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
    run_requests(xm, imgs[:1], xcfg, per_request_k3=30)
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
        stage = per_stage.setdefault(name.split(".")[0], [0, 0.0])
        stage[0] += 1
        stage[1] += ms
        k3["plain_ms"] += cuda_ms(lambda: deform_conv2d_plain(*args), iters=2, warmup=1)
        k3["cudnn_ms"] += cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, stride=m.stride, padding=1,
                                                   groups=m.groups))
        nbytes, ops = k3_work(x, off, w, m.groups, m.stride)
        k3["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k3["ops_ms"] += ops / BF16_FLOP_PER_S * 1e3
        if name in ("layer2.0", "layer2.1", "layer3.1", "layer4.1"):
            print(f"K3 {name} (stride {m.stride}, {x.shape[-1]} ch, {x.shape[1]}x{x.shape[2]} -> "
                  f"{off.shape[1]}x{off.shape[2]}): {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB")
    print("K3 per stage: " + "; ".join(f"{st} {n} launches {ms:.3f} ms ({ms / n * 1e3:.1f} us "
                                        f"each)" for st, (n, ms) in per_stage.items()))
    bound = max(k3["bytes_ms"], k3["ops_ms"])
    print(f"K3 per image ({len(captured)} launches): {k3['ms']:.3f} ms ({k3['ms'] / len(captured) * 1e3:.1f} "
          f"us per launch); bound {bound:.4f} ms (operations at 989 TFLOP/s bf16 "
          f"{k3['ops_ms']:.4f} ms, bytes at 3.35 TB/s {k3['bytes_ms']:.4f} ms); plain version "
          f"{k3['plain_ms']:.3f} ms; context: cuDNN regular conv of the same shapes "
          f"{k3['cudnn_ms']:.3f} ms ({card})")
    profile_request(model, imgs[0])
    return {"name": "deform_conv", "route": "cuda", "source": "htd_tpu_torch/csrc/deform_conv.cu",
            "replaces": "htd_tpu/ops/dcn_pallas.py:131", "launches": counts["deform_conv"],
            "max_abs_err": k3_err, "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if k3["bytes_ms"] >= k3["ops_ms"] else "operations",
            "library_ms": None}


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
    if counts["pyramid_pack"] <= 0 or counts["roi_align"] <= 0:
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

    profile_request(model, imgs[0])
    del model, levels, pyr, props, rois1
    k3 = dcn_phases(imgs, card)

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
        k3,
    ]
    print(f"kernel times are per image (K2: the sum of its 3 calls per request; K3: of its "
          f"30 launches per R-101-DCN request); launches are over the {n_img} main-path "
          f"requests (K1, K2: R-50; K3: R-101-DCN); max_abs_err is bfloat16 vs the plain "
          f"version; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    with torch.inference_mode():
        main()
