#!/usr/bin/env python
"""RoIAlign sampling-fidelity A/B of the PyTorch port (after
tools/ab_fidelity.py).

The production presets clamp RoIAlign's adaptive sampling_ratio=0 grid
(config.py: max_samples=4 for the level-mapped extractor, adpt_max_samples=1
for the BA extractor's all-level pass, where mmcv's grid would take up to
~48 samples per axis). K2 computes every rung exactly, so the ladder
measures the presets' clamp, not the kernel: the same random-init weights
(`init_random`, seed 1), the same 768x1344 image (`RandomState(0)`), the
same RPN proposals at every rung (the RPN is upstream of both extractors);
only the sampling grid varies. Both stages' classifiers are drawn with std
CLS_STD (init_random's 0.01 rescaled), so that random-weight scores clear
`--score-thr`, as the JAX tool's spread classifiers do.

Ladder: (max_samples, adpt_max_samples) from the production (4, 1) up to
(8, 8). Each rung's detections are compared with the highest rung's
(matched by label and IoU >= 0.5; score and box deltas over the matches),
and each rung is timed: ms per image by CUDA events around a loop of warm
calls (the host clock with --device cpu). `--pre-nms` compares the stages'
boxes and scores on fixed synthetic proposals (`stages_forward`), the
clean materiality measure, split by roi aspect ratio.

Usage: python tools_torch/ab_fidelity.py [--dtype bfloat16] [--height 768 ...]
    [--pre-nms] [--device cpu]
Prints one JSON object (indented) with the JAX tool's keys, and returns it.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LADDER = [(4, 1), (4, 2), (4, 4), (8, 4), (8, 8)]
PRE_NMS_LADDER = [(4, 1), (6, 1), (8, 1), (4, 4), (8, 8)]
PRE_NMS_ROIS = 1000        # the pre-NMS probe's synthetic proposals
CLS_STD = 0.04             # both classifiers' init std (init_random draws 0.01)
WARMUP_CALLS, TIMED_CALLS = 2, 8


def iou_matrix(a, b):
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def compare(ref, cur):
    """Greedy label-aware match of two detection sets; a summary dict."""
    rb, rs, rl = ref
    cb, cs, cl = cur
    used = np.zeros(len(cb), bool)
    ds, db = [], []
    unmatched = 0
    for i in range(len(rb)):
        cand = np.nonzero((cl == rl[i]) & ~used)[0]
        if len(cand) == 0:
            unmatched += 1
            continue
        ious = iou_matrix(rb[i:i + 1], cb[cand])[0]
        j = cand[np.argmax(ious)]
        if ious.max() < 0.5:
            unmatched += 1
            continue
        used[j] = True
        ds.append(abs(rs[i] - cs[j]))
        db.append(np.abs(rb[i] - cb[j]).max())
    return {
        "n_ref": len(rb), "n_cur": len(cb),
        "matched": len(ds), "ref_only": unmatched,
        "cur_only": int((~used).sum()),
        "score_mad": float(np.mean(ds)) if ds else 0.0,
        "score_max": float(np.max(ds)) if ds else 0.0,
        "box_mad_px": float(np.mean(db)) if db else 0.0,
        "box_max_px": float(np.max(db)) if db else 0.0,
    }


def synth_proposals(n, h, w, seed=5):
    """Fixed proposals spanning all levels and aspects 0.33-3 (the anchor
    ratios' decoded range): the pre-NMS probe's roi population."""
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        scale = rng.uniform(16, 500)
        ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3)))
        bw = scale * np.sqrt(ar)
        bh = scale / np.sqrt(ar)
        if bw >= w - 2 or bh >= h - 2:
            continue
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        out.append([x1, y1, x1 + bw, y1 + bh])
    return np.asarray(out, np.float32)


def ms_per_call(fn, device) -> float:
    """Mean ms per call of `fn` over TIMED_CALLS calls after WARMUP_CALLS:
    CUDA events around the loop on the card, the host clock on the CPU."""
    import torch

    iters = TIMED_CALLS
    for _ in range(WARMUP_CALLS):
        fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--score-thr", type=float, default=0.05)
    p.add_argument("--pre-nms", action="store_true",
                   help="compare pre-NMS boxes and scores on FIXED injected proposals "
                        "(stages_forward): no NMS flips amplify the deltas; reports them split "
                        "by roi aspect ratio")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs on "
                        "the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from htd_tpu_torch import config as C
    from htd_tpu_torch.apis import init_detector

    h, w = args.height, args.width
    ladder = PRE_NMS_LADDER if args.pre_nms else LADDER
    img_np = np.random.RandomState(0).normal(0, 1, (1, h, w, 3)).astype(np.float32)
    props = synth_proposals(PRE_NMS_ROIS, h - 18.0, w - 11.0)
    aspect = (props[:, 2] - props[:, 0]) / (props[:, 3] - props[:, 1])
    elong = np.maximum(aspect, 1.0 / aspect) > 2.0
    results, timings = {}, {}
    for ms, ams in ladder:
        cfg = C.htd_r50_1x().replace(compute_dtype=args.dtype)
        cfg = cfg.replace(roi_extractor=dataclasses.replace(
            cfg.roi_extractor, max_samples=ms, adpt_max_samples=ams))
        model = init_detector(cfg, device=args.device, seed=1)
        with torch.no_grad():
            for head in model.roi_head.bbox_head:
                head.fc_cls.weight.mul_(CLS_STD / 0.01)
        dev = model.device
        img = torch.from_numpy(img_np).to(dev, model.compute_dtype)
        shapes = torch.tensor([[h - 18.0, w - 11.0]], device=dev)
        sfs = torch.ones((1, 4), device=dev)
        with torch.inference_mode():
            if args.pre_nms:
                rois = torch.from_numpy(props[None]).to(dev)
                valid = torch.ones((1, len(props)), dtype=torch.bool, device=dev)

                def run():
                    return model.stages_forward(img, shapes, rois, valid)

                boxes, scores = run()
                results[(ms, ams)] = (boxes[0].double().cpu().numpy(),
                                      scores[0].double().cpu().numpy())
            else:
                def run():
                    return model.simple_test(img, shapes, sfs)

                dets = run()
                v = (dets.valid[0] & (dets.scores[0] >= args.score_thr)).cpu().numpy()
                results[(ms, ams)] = (dets.boxes[0].double().cpu().numpy()[v],
                                      dets.scores[0].double().cpu().numpy()[v],
                                      dets.labels[0].cpu().numpy()[v])
            timings[(ms, ams)] = ms_per_call(run, dev)
        print(f"({ms},{ams}): {timings[(ms, ams)]:.2f} ms/img", file=sys.stderr)
        del model

    ref_key = sorted(results)[-1]
    if args.pre_nms:
        rb, rs = results[ref_key]
        out = {"mode": "pre_nms", "reference_rung": list(ref_key), "dtype": args.dtype,
               "n_rois": int(props.shape[0]), "n_elongated_gt2": int(elong.sum()), "rungs": {}}
        for k, (cb, cs) in results.items():
            dsc = np.abs(cs - rs).max(axis=1)       # per-roi max class-score delta
            dbx = np.abs(cb - rb).max(axis=1)       # per-roi max corner delta, px
            out["rungs"][f"{k[0]},{k[1]}"] = {
                "score_mad": float(dsc.mean()),
                "score_p99": float(np.percentile(dsc, 99)),
                "score_max": float(dsc.max()),
                "box_mad_px": float(dbx.mean()),
                "box_p99_px": float(np.percentile(dbx, 99)),
                "box_max_px": float(dbx.max()),
                "score_mad_elongated": float(dsc[elong].mean()),
                "score_mad_square": float(dsc[~elong].mean()),
                "ms_per_img": round(timings[k], 2),
            }
    else:
        out = {"reference_rung": list(ref_key), "dtype": args.dtype, "rungs": {}}
        for k, dets in results.items():
            out["rungs"][f"{k[0]},{k[1]}"] = dict(compare(results[ref_key], dets),
                                                  ms_per_img=round(timings[k], 2))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
